# Copied from or_cdchomp_tpu/client.py (host Python; shared copy pending de-duplication).
"""Python client shim: kwargs → command strings → ``SendCommand``.

The reference's Python API (pythonsrc/orcdchomp/orcdchomp.py) is a set
of serializer functions that turn keyword arguments into shell-quoted
command strings for the module's SendCommand transport, monkey-patched
onto the module object by ``bind(mod)`` (orcdchomp.py:27-37), plus the
``runchomp`` create+iterate+gettraj+destroy convenience wrapper
(orcdchomp.py:204-219).

This module provides the same client surface against the port's
string transport (transport.send_command): the same function names,
keyword names (including ``lambda_`` → ``lambda`` on the wire), quoting
(``shquot``, orcdchomp.py:39-40), and flag semantics — so client code
written for the reference keeps working after swapping the import.  The
serialization here is table-driven rather than hand-unrolled; the wire
format is identical.

Use either style:

    from or_cdchomp_tpu_torch import client
    mod = client.SendCommandModule(chomp_module)
    client.bind(mod)
    h = mod.create(robot="wam", adofgoal=[...], lambda_=100.0)
"""

from __future__ import annotations

import json
import types

import numpy as np

from or_cdchomp_tpu_torch.transport import send_command


def shquot(s: str) -> str:
    """POSIX single-quote escaping (orcdchomp.py:39-40 semantics)."""
    return "'" + str(s).replace("'", "'\\''") + "'"


class SendCommandModule:
    """Minimal stand-in for an OpenRAVE module handle: routes
    SendCommand strings to a CHOMPModule through the transport."""

    def __init__(self, chomp_module):
        self.module = chomp_module

    def SendCommand(self, cmd: str, releasegil: bool = False) -> str:
        del releasegil  # accepted for signature parity; no GIL dance
        return send_command(self.module, cmd)


def _name_of(obj) -> str:
    return obj.GetName() if hasattr(obj, "GetName") else str(obj)


def _vec(v) -> str:
    return " ".join(str(float(x)) for x in np.asarray(v).ravel())


def _emit(cmd, parts):
    """parts: (key, kind, value); value None is skipped, false flags
    are skipped (reference behavior: absent keyword = default)."""
    out = [cmd]
    for key, kind, val in parts:
        if val is None:
            continue
        if kind == "flag":
            if val:
                out.append(key)
        elif kind == "name":
            out += [key, shquot(_name_of(val))]
        elif kind == "vec":
            out += [key, shquot(_vec(val))]
        elif kind == "int":
            out += [key, str(int(val))]
        elif kind == "float":
            out += [key, repr(float(val))]
        elif kind == "str":
            out += [key, shquot(str(val))]
        elif kind == "tsr":
            out += [key, shquot(val.serialize()
                                if hasattr(val, "serialize") else str(val))]
        else:  # pragma: no cover
            raise ValueError(kind)
    return " ".join(out)


def viewspheres(mod, robot=None, releasegil=False):
    return mod.SendCommand(_emit("viewspheres", [("robot", "name", robot)]),
                           releasegil)


def computedistancefield(mod, kinbody=None, cube_extent=None,
                         aabb_padding=None, cache_filename=None,
                         require_cache=None, releasegil=False):
    return mod.SendCommand(_emit("computedistancefield", [
        ("kinbody", "name", kinbody),
        ("cube_extent", "float", cube_extent),
        ("aabb_padding", "float", aabb_padding),
        ("cache_filename", "str", cache_filename),
        ("require_cache", "flag", require_cache),
    ]), releasegil)


def addfield_fromobsarray(mod, kinbody=None, obsarray=None, sizes=None,
                          lengths=None, pose=None, releasegil=False):
    return mod.SendCommand(_emit("addfield_fromobsarray", [
        ("kinbody", "name", kinbody),
        # differs from the reference by design: a .npy path or an
        # inline 0/1 list instead of a raw C pointer (%p string)
        ("obsarray", "str", obsarray),
        ("sizes", "vec", sizes),
        ("lengths", "vec", lengths),
        ("pose", "vec", pose),
    ]), releasegil)


def viewfields(mod, releasegil=False):
    return mod.SendCommand("viewfields", releasegil)


def removefield(mod, kinbody=None, releasegil=False):
    return mod.SendCommand(_emit("removefield",
                                 [("kinbody", "name", kinbody)]), releasegil)


def create(mod, robot=None, adofgoal=None, basegoal=None, floating_base=None,
           lambda_=None, starttraj=None, n_points=None, con_tsr=None,
           con_tsrs=None, start_tsr=None, start_cost=None, everyn_tsr=None,
           use_momentum=None, use_hmc=None, hmc_resample_lambda=None,
           seed=None, epsilon=None, epsilon_self=None, obs_factor=None,
           obs_factor_self=None, no_report_cost=None, dat_filename=None,
           releasegil=False, derivative=None, **kwargs):
    cmd = _emit("create", [
        ("robot", "name", robot),
        ("adofgoal", "vec", adofgoal),
        ("basegoal", "vec", basegoal),
        ("floating_base", "flag", floating_base),
        ("lambda", "float", lambda_),
    ])
    if starttraj is not None:
        data = (starttraj.serialize(0) if hasattr(starttraj, "serialize")
                else json.dumps(np.asarray(starttraj).tolist()))
        cmd += " starttraj %s" % shquot(data)
    all_con_tsrs = list(con_tsrs or [])
    if con_tsr is not None:
        all_con_tsrs.append(con_tsr)
    for ctype, tsr in all_con_tsrs:
        ser = tsr.serialize() if hasattr(tsr, "serialize") else str(tsr)
        cmd += " con_tsr %s %s" % (shquot(str(ctype)), shquot(ser))
    cmd += " " + _emit("", [
        ("n_points", "int", n_points),
        ("derivative", "int", derivative),
        ("start_tsr", "tsr", start_tsr),
        ("everyn_tsr", "tsr", everyn_tsr),
        ("start_cost", "str", start_cost),
        ("use_momentum", "flag", use_momentum),
        ("use_hmc", "flag", use_hmc),
        ("hmc_resample_lambda", "float", hmc_resample_lambda),
        ("seed", "int", seed),
        ("epsilon", "float", epsilon),
        ("epsilon_self", "float", epsilon_self),
        ("obs_factor", "float", obs_factor),
        ("obs_factor_self", "float", obs_factor_self),
        ("no_report_cost", "flag", no_report_cost),
        ("dat_filename", "str", dat_filename),
    ]).strip()
    if kwargs:
        raise ValueError(f"unknown create arguments: {sorted(kwargs)}")
    return mod.SendCommand(cmd.strip(), releasegil)


def iterate(mod, run=None, n_iter=None, max_time=None,
            trajs_fileformstr=None, cost=None, releasegil=False):
    out = mod.SendCommand(_emit("iterate", [
        ("run", "str", run),
        ("n_iter", "int", n_iter),
        ("max_time", "float", max_time),
        ("trajs_fileformstr", "str", trajs_fileformstr),
    ]), releasegil)
    if cost is not None:
        # out-parameter convention of the reference (orcdchomp.py:181-182)
        cost[0] = float(out)
    return out


def gettraj(mod, run=None, no_collision_check=None,
            no_collision_exception=None, no_collision_details=None,
            releasegil=False):
    return mod.SendCommand(_emit("gettraj", [
        ("run", "str", run),
        ("no_collision_check", "flag", no_collision_check),
        ("no_collision_exception", "flag", no_collision_exception),
        ("no_collision_details", "flag", no_collision_details),
    ]), releasegil)


def destroy(mod, run=None, releasegil=False):
    return mod.SendCommand(_emit("destroy", [("run", "str", run)]),
                           releasegil)


def runchomp(mod, n_iter=None, max_time=None, trajs_fileformstr=None,
             cost=None, no_collision_check=None, no_collision_exception=None,
             no_collision_details=None, releasegil=False, **kwargs):
    """create + iterate + gettraj + destroy (orcdchomp.py:204-219)."""
    run = create(mod, releasegil=releasegil, **kwargs)
    iterate(mod, run=run, n_iter=n_iter, max_time=max_time,
            trajs_fileformstr=trajs_fileformstr, cost=cost,
            releasegil=releasegil)
    traj = gettraj(mod, run=run, no_collision_check=no_collision_check,
                   no_collision_exception=no_collision_exception,
                   no_collision_details=no_collision_details,
                   releasegil=releasegil)
    destroy(mod, run=run, releasegil=releasegil)
    return traj


def bind(mod) -> None:
    """Attach the ten client methods to a module handle
    (orcdchomp.py:27-37)."""
    for fn in (viewspheres, computedistancefield, addfield_fromobsarray,
               viewfields, removefield, create, iterate, gettraj, destroy,
               runchomp):
        setattr(mod, fn.__name__, types.MethodType(fn, mod))
