"""The port covers the JAX package's public surface.

An AST walk of both packages, as tests/test_torch_imports.py walks the
port: every public module-level name (a function, a class or an
assignment, not an import) of each module of ``or_cdchomp_tpu/``, and
every public method or field of each class that both packages define,
has a counterpart of the same name in the port's module of the same path
(the two Pallas modules map to the port's kernel wrappers).  A method's
counterpart may be an attribute that the port's class sets on ``self``.
The only exceptions are ALLOWED, which must equal ROADMAP.md's "Not
ported, by decision" list, entry for entry and word for word, and must
name only what the port indeed lacks."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "or_cdchomp_tpu"
PORT = ROOT / "or_cdchomp_tpu_torch"

# the port's module for a JAX module of another name: the Pallas
# kernels' contracts live beside their CUDA kernels' wrappers
RENAMED = {"ops/pallas_sdf.py": "ops/sdf_lookup.py",
           "ops/pallas_selfcol.py": "ops/selfcol.py"}

# "module" (the whole module), "module:Name" or "module:Class.member",
# with the one-line reason that ROADMAP.md gives each entry
ALLOWED = [
    (("chomp/cost.py", "chomp/constraints.py:eval_tsr_all",
      "chomp/solver.py:ChompEngine.iterate_masked"),
     "the per-problem (AoS) cost layout; the port's step, iterate and "
     "costs_only are its batch step at B = 1, and start_tsr / "
     "start_cost run on that step."),
    (("chomp/cost_soa.py:stack_pose_aos",),
     "serves only the CDX_TSR_EVAL=aos knob of the JAX step."),
    (("chomp/problem.py:HmcState", "chomp/problem.py:ChompProblem.hmc"),
     "a jax.random key state; the port's HmcDraw and SeededDraw draw "
     "instead, and a problem carries hmc_seed."),
    (("chomp/solver.py:ChompEngine.batch_native_ok",
      "chomp/solver.py:ChompEngine.costs_only_jit",
      "chomp/solver.py:ChompEngine.iterate_batch",
      "chomp/solver.py:ChompEngine.iterate_batched_nojit",
      "chomp/solver.py:ChompEngine.iterate_nojit"),
     "XLA compile variants of calls the port has (step_batched, "
     "iterate_batched, costs_only, final_costs_batch)."),
    (("native/__init__.py",),
     "the JAX package's host C++ SDF pipeline (cdx_native.cc); every "
     "grid builds on the card."),
    (("ops/grid.py:ONEHOT_MAX_CELLS",),
     "the size limit of the one-hot lookups, which are not ported; the "
     "port keeps one lookup per device."),
    (("ops/pallas_sdf.py:MAX_CELLS",),
     "the Pallas lookup's VMEM limit; K1 reads the stack from global "
     "memory and splits a call only past sdf_lookup.MAX_QUERIES."),
    (("utils/profiling.py:phase_cycle_report",),
     "parses XLA HLO text; phase_device_report is its counterpart."),
]
ALLOWED_KEYS = {k for keys, _ in ALLOWED for k in keys}


def _public_names(path):
    """(module-level public names, {class: public members}) of a file,
    imports not counted."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, classes = set(), {}

    def targets(node):
        if isinstance(node, ast.Assign):
            return [t.id for t in node.targets if isinstance(t, ast.Name)]
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            return [node.target.id]
        return []

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        names.update(targets(node))
        if isinstance(node, ast.ClassDef):
            members = set()
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(b.name)
                members.update(targets(b))
            classes[node.name] = members
    return ({n for n in names if not n.startswith("_")},
            {c: {m for m in ms if not m.startswith("_")}
             for c, ms in classes.items()})


def _self_attributes(path):
    """{class: names the class's methods assign on self}."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out[node.name] = {
                t.attr for n in ast.walk(node) if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"}
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_covered(module):
    port = PORT / RENAMED.get(module, module)
    if module in ALLOWED_KEYS:
        assert not port.exists(), f"{module} is allowed out but exists"
        return
    assert port.exists(), f"no port of {module}"
    jnames, jclasses = _public_names(JAX / module)
    pnames, pclasses = _public_names(port)
    attrs = _self_attributes(port)
    missing = sorted(n for n in jnames - pnames
                     if f"{module}:{n}" not in ALLOWED_KEYS)
    for cls, members in jclasses.items():
        if cls not in pclasses:
            continue
        have = pclasses[cls] | attrs.get(cls, set())
        missing += sorted(f"{cls}.{m}" for m in members - have
                          if f"{module}:{cls}.{m}" not in ALLOWED_KEYS)
    assert not missing, f"{module}: not in the port: {missing}"


@pytest.mark.parametrize("key", sorted(ALLOWED_KEYS))
def test_allowed_names_are_absent(key):
    """An allowed name is one the port lacks: a stale entry fails."""
    module, _, name = key.partition(":")
    port = PORT / RENAMED.get(module, module)
    if not name:
        assert not port.exists()
        return
    pnames, pclasses = _public_names(port)
    cls, _, member = name.partition(".")
    if member:
        have = pclasses.get(cls, set()) | _self_attributes(port).get(cls,
                                                                     set())
        assert member not in have
    else:
        assert cls not in pnames


def _roadmap_list():
    """ROADMAP.md's "Not ported, by decision" bullets as (keys, reason),
    whitespace collapsed."""
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Not ported, by decision.**")
    section = text[start:text.index("\n#", start)]
    bullets = re.findall(r"^- (.*?)(?=^- |^\s*$)", section,
                         flags=re.M | re.S)
    out = []
    for b in bullets:
        b = " ".join(b.split())
        m = re.fullmatch(r"((?:`[^`]+`(?:, )?)+): (.*)", b)
        assert m, f"ROADMAP bullet not of the form `key`, ...: reason: {b}"
        out.append((tuple(re.findall(r"`([^`]+)`", m.group(1))),
                    m.group(2)))
    return out


def test_allow_list_is_roadmaps():
    assert _roadmap_list() == ALLOWED
