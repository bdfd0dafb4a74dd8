"""Nothing the benchmark runs imports JAX or the JAX package; the plain
references import nothing of the program either.  Top-level module names
are compared whole: ``radix_sort_tpu_torch`` is not ``radix_sort_tpu``."""

import ast
from pathlib import Path

import pytest

from portbench import result

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "radix_sort_tpu"}


def imported(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "numpy", "torch"}


def test_forbidden_modules_compares_whole_names():
    mods = {"radix_sort_tpu_torch": 1, "radix_sort_tpu_torch.ops": 1,
            "jaxtyping": 1, "torch": 1}
    assert result.forbidden_modules(mods) == []
    mods.update({"radix_sort_tpu.ops": 1, "jax.numpy": 1, "flax": 1})
    assert result.forbidden_modules(mods) == ["flax", "jax.numpy",
                                              "radix_sort_tpu.ops"]
