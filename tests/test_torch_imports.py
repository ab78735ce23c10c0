"""The PyTorch port and its scripts (chip_smoke.py, ab_obstacle.py, the
two-process test's child) import neither JAX nor the JAX package: the
machine with the card has no JAX.  An AST walk, because a subprocess
check would see a JAX that this environment pre-imports."""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "or_cdchomp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "or_cdchomp_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [
        PKG.parent / "chip_smoke.py", PKG.parent / "ab_obstacle.py",
        PKG.parent / "tests" / "torch_multiproc_child.py"],
    ids=lambda p: str(p.relative_to(PKG)) if PKG in p.parents else p.name)
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_rule_catches_jax_and_package():
    tree = ast.parse("import jax.numpy as jnp\n"
                     "from or_cdchomp_tpu.ops import soa\n"
                     "import or_cdchomp_tpu_torch.ops\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "jax.numpy", "or_cdchomp_tpu.ops"]


# host modules the port keeps as copies of the JAX package's: each is
# walked above and names its source in its first line
COPIES = ["transport", "client", "utils/shparse", "models/kdata",
          "models/orxml", "models/urdf", "models/wam7", "tsr",
          "utils/np_pose", "chomp/metric"]


@pytest.mark.parametrize("name", COPIES)
def test_copies_walked_and_headed(name):
    path = PKG / f"{name}.py"
    assert path in set(PKG.rglob("*.py"))
    first = path.read_text().splitlines()[0]
    assert first.startswith(f"# Copied from or_cdchomp_tpu/{name}.py")


def test_front_door_exports():
    """The loaders and the transport from the package, as
    or_cdchomp_tpu/__init__.py:16-17 exports them."""
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch import client, transport
    from or_cdchomp_tpu_torch.models import orxml, urdf

    assert pt.parse_robot_xml is orxml.parse_robot_xml
    assert (pt.parse_urdf, pt.load_urdf) == (urdf.parse_urdf, urdf.load_urdf)
    assert client.send_command is transport.send_command
    assert callable(pt.CHOMPModule.SendCommand)
