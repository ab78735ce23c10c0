"""The port's public signatures against the JAX package's.

An AST walk of both packages, as tests/test_torch_coverage.py walks
their names: for every public function, and every public method (and
``__init__``) of a class, that both packages define in modules of the
same path (the two Pallas modules map to the port's kernel wrappers),

- every JAX parameter is a parameter of the port's, by name;
- JAX's positional parameters are a prefix of the port's, in order;
- the port requires no parameter that JAX lacks;
- where both give a default, the two are equal (as source text), except
  for ``dtype`` and ``device`` (torch's types, and the port's device).
  A parameter JAX requires may have a default in the port.

ALLOWED names, each with its reason, the contracts that differ by
design; an allowed entry that no longer differs fails.  Then the five
signatures repaired to JAX's are called positionally, float64 on the
CPU, against the JAX package."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.api import Robot as JaxRobot
from or_cdchomp_tpu.chomp import metric as jmm
from or_cdchomp_tpu.chomp.solver import ChompEngine as JaxEngine
from or_cdchomp_tpu.models.robot import CompiledFK as JaxFK
from or_cdchomp_tpu.ops import grid as jg
from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp.constraints import TSRConstraintSet
from or_cdchomp_tpu_torch.chomp.problem import ChompSpec
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
from or_cdchomp_tpu_torch.convert import fields_from_numpy
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.ops import grid as tg
from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

from torch_parity import (GOAL, START, close, config1_module, jax_batch,
                          port_probs)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "or_cdchomp_tpu"
PORT = ROOT / "or_cdchomp_tpu_torch"
RENAMED = {"ops/pallas_sdf.py": "ops/sdf_lookup.py",
           "ops/pallas_selfcol.py": "ops/selfcol.py"}
ANY_DEFAULT = ("dtype", "device")
MATH_RTOL = 1e-12
STEP_RTOL = 1e-9

# "module:function" or "module:Class.method", with its reason
ALLOWED = {
    "ops/pallas_sdf.py:sdf_cell_lookup":
        "``interpret`` runs the Pallas kernel in interpret mode; a CUDA "
        "kernel has none, and a CPU tensor runs the plain version.",
    "ops/pallas_selfcol.py:selfcol_pairs":
        "takes the allowed pairs as compacted ordered lists (pair_i, "
        "pair_j) instead of an (Sa, So) mask, and has no Pallas "
        "``interpret`` or ``dense`` layout switch.",
    "chomp/constraints.py:project_constraints":
        "takes the ProjectionOps built once per engine (``ops``) instead "
        "of the engine, whose metric-inverse entries they hold.",
    "chomp/cost_soa.py:total_cost_grad_batched":
        "takes the engine's compacted pair table (``pairs``) instead of "
        "the same-link mask and the radii of every sphere.",
    "utils/profiling.py:format_phase_report":
        "reports device milliseconds per phase (``ms``), not XLA's "
        "compiler cycle estimates (``cycles``).",
    "api.py:CHOMPModule.gettraj_batch":
        "``device_chunk=None``: an upper bound on the chunk that "
        "api.check_chunk sizes by memory, not a fixed chunk of 2048.",
}


def _functions(path):
    """{"function" or "Class.method": FunctionDef} of a file's top level."""
    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{b.name}"] = b
    return out


def _public(name):
    parts = name.split(".")
    return (not any(p.startswith("_") for p in parts[:-1])
            and (not parts[-1].startswith("_") or parts[-1] == "__init__"))


def _params(fn):
    """[(name, default source or None, positional?)] of a def."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, None if d is None else ast.unparse(d), True)
           for p, d in zip(pos, defaults)]
    out += [(p.arg, None if d is None else ast.unparse(d), False)
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return out


def _differences(jfn, pfn):
    """What keeps the port's def from taking every call JAX's takes."""
    jp, pp = _params(jfn), _params(pfn)
    port = {n: d for n, d, _ in pp}
    jax_names = {n for n, _, _ in jp}
    out = [f"no parameter {n}" for n, _, _ in jp if n not in port]
    out += [f"default of {n}: {d} in JAX, {port[n]} here"
            for n, d, _ in jp if n in port and n not in ANY_DEFAULT
            and d is not None and port[n] != d]
    jpos = [n for n, _, p in jp if p]
    ppos = [n for n, _, p in pp if p]
    if ppos[:len(jpos)] != jpos:
        out.append(f"positional order {jpos} in JAX, {ppos} here")
    out += [f"requires {n}, which JAX lacks" for n, d, _ in pp
            if n not in jax_names and d is None]
    return out


def _pairs():
    """Every (key, JAX def, port def) defined in both packages."""
    out = []
    for path in sorted(JAX.rglob("*.py")):
        module = str(path.relative_to(JAX))
        port = PORT / RENAMED.get(module, module)
        if not port.exists():
            continue
        jf, pf = _functions(path), _functions(port)
        out += [(f"{module}:{n}", jf[n], pf[n])
                for n in sorted(set(jf) & set(pf)) if _public(n)]
    return out


PAIRS = _pairs()


@pytest.mark.parametrize("key, jfn, pfn", PAIRS,
                         ids=[k for k, _, _ in PAIRS])
def test_signature_takes_jax_calls(key, jfn, pfn):
    diff = _differences(jfn, pfn)
    if key in ALLOWED:
        assert diff, f"{key} is allowed to differ but no longer does"
    else:
        assert not diff, f"{key}: {diff}"


def test_allowed_entries_exist():
    assert set(ALLOWED) <= {k for k, _, _ in PAIRS}
    assert len(PAIRS) > 200


def test_rule_catches_each_difference():
    def fn(src):
        return ast.parse(src).body[0]

    jax_def = fn("def f(a, b, c=1, dtype=None): pass")
    assert not _differences(jax_def, fn(
        "def f(a, b=0, c=1, dtype=2, device='cuda', *, e=3): pass"))
    assert _differences(fn("def f(a, *, c=1): pass"),
                        fn("def f(a, **kw): pass")) == ["no parameter c"]
    assert _differences(jax_def, fn("def f(a, b, c=2, dtype=None): pass")
                        ) == ["default of c: 1 in JAX, 2 here"]
    assert _differences(jax_def, fn(
        "def f(a, b, dtype=None, c=1): pass")) == [
        "positional order ['a', 'b', 'c', 'dtype'] in JAX, "
        "['a', 'b', 'dtype', 'c'] here"]
    assert _differences(jax_def, fn(
        "def f(a, b, c=1, dtype=None, *, e): pass")) == [
        "requires e, which JAX lacks"]


# ---- the repaired signatures, called positionally, against JAX --------------

def test_grid_create_positional_matches_jax():
    lengths = np.array([0.6, 0.8, 1.0])
    t = tg.Grid3D.create((3, 4, 5), lengths, 0.25, torch.float64, "cpu")
    j = jg.Grid3D.create((3, 4, 5), lengths, 0.25, jnp.float64)
    assert t.data.dtype == torch.float64 and t.sizes == tuple(j.sizes)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    assert float(t.data[0, 0, 0]) == 0.25


def test_compiled_fk_positional_matches_jax():
    subset = np.array([5, 0, 9, 3])
    t = CompiledFK(pt.wam7(), torch.float64, subset, "cpu")
    j = JaxFK(oc.wam7(), jnp.float64, subset)
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.sphere_subset, j.sphere_subset)
    pose = np.array([0.1, -0.2, 0.3, 0.0, 0.0, 0.38268343, 0.92387953])
    pose[3:] /= np.linalg.norm(pose[3:])
    close(t.sphere_positions_jit(torch.as_tensor(START), torch.as_tensor(
        pose)), j.sphere_positions_jit(jnp.asarray(START), jnp.asarray(pose)),
        MATH_RTOL)


def test_sphere_world_fk_matches_jax():
    """``sphere_world(fk)``: the positions through the given FK and the
    radii of its sphere subset, as JAX api.py:232-238 has them."""
    subset = np.array([2, 7, 1])
    pose = np.array([0.2, 0.1, 0.5, 0.0, 0.0, 0.0, 1.0])
    tr = pt.Robot("wam", pt.wam7(), pose=pose.copy(), q_active=START.copy())
    jr = JaxRobot("wam", oc.wam7(), pose=pose.copy(), q_active=START.copy())
    tx, trad = tr.sphere_world(CompiledFK(tr.model, torch.float64, subset,
                                          "cpu"))
    jx, jrad = jr.sphere_world(JaxFK(jr.model, jnp.float64, subset))
    assert tx.shape == (3, 3)
    close(tx, jx, MATH_RTOL)
    np.testing.assert_array_equal(trad, jrad)
    ax, arad = tr.sphere_world()                 # every sphere, host FK
    close(ax[subset], tx, MATH_RTOL)
    np.testing.assert_array_equal(arad[subset], trad)


@pytest.fixture(scope="module")
def world():
    mod = config1_module(oc, dtype=jnp.float64)
    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                              obs_factor=500.0, n_points=9)]
    return run, jax_batch(run, 4, seed=3)


def test_batch_solver_positional_matches_jax(world):
    """``BatchSolver(engine, mesh, axis, chunk, min_chunks)``: both knobs
    kept; chunk 2 of B = 4 makes JAX's scan a lax.map over two chunks,
    and the port's rows step alike."""
    run, jprobs = world
    js = JaxBatchSolver(run.engine, None, "dp", 2, 2)
    ts = BatchSolver(_port_engine(run.engine), None, "dp", 2, 2)
    assert (ts.chunk, ts.min_chunks) == (js.chunk, js.min_chunks) == (2, 2)
    assert BatchSolver(ts.engine).chunk == JaxBatchSolver(
        run.engine).chunk == 128
    jout, jcosts = js.iterate(jprobs, 4)
    tout, tcosts = ts.iterate(port_probs(jprobs), 4)
    close(tout.traj, jout.traj, STEP_RTOL)
    close(tcosts, jcosts, STEP_RTOL)


def _port_engine(jeng, *given):
    f = jeng.fields
    fields = fields_from_numpy(np.asarray(f.data), np.asarray(f.sizes),
                               np.asarray(f.lengths), device="cpu",
                               dtype=torch.float64)
    cons = TSRConstraintSet.build(())
    return ChompEngine(ChompSpec(*jeng.spec), pt.wam7(), fields,
                       *(given or (None, None)), cons, None, torch.float64,
                       None, "auto", "cpu")


def test_engine_given_metric_matches_jax(world):
    """``ChompEngine(spec, model, fields, A, Ainv, ...)``: a given metric
    (the built one with a stiffer diagonal) replaces the built one in
    both packages; steps on it agree within 1e-9, and differ from steps
    on the built metric."""
    run, jprobs = world
    je = run.engine
    ops = jmm.build_metric(je.spec.m, je.spec.dt, D=je.spec.D)
    A = np.asarray(ops.A) + 40.0 * np.eye(je.spec.m)
    Ainv = np.linalg.inv(A)
    jeng = JaxEngine(je.spec, oc.wam7(), je.fields, A, Ainv, None, None,
                     jnp.float64)
    teng = _port_engine(je, torch.as_tensor(A), Ainv)
    close(teng.A, jeng.A, MATH_RTOL)
    close(teng.Ainv, jeng.Ainv, MATH_RTOL)
    pts = np.array([0, 3, 6])
    close(teng.ainv_block(pts), jeng.ainv_block(pts), MATH_RTOL)
    close(teng.ainv_cols(pts), jeng.ainv_cols(pts), MATH_RTOL)
    jout, jcosts = jeng.iterate_batch(jprobs, 3)
    tout, tcosts = teng.iterate_batched(port_probs(jprobs), 3)
    close(tout.traj, jout.traj, STEP_RTOL)
    close(tcosts, jcosts, STEP_RTOL)
    plain, _ = _port_engine(je).iterate_batched(port_probs(jprobs), 3)
    assert float((plain.traj - tout.traj).abs().max()) > 1e-6
