"""The PyTorch port and its scripts (chip_smoke.py, ab_obstacle.py) import
neither JAX nor the JAX package: the machine with the card has no JAX.
An AST walk, because a subprocess check would see a JAX that this
environment pre-imports."""

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
    "path", sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py",
                                         PKG.parent / "ab_obstacle.py"],
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
