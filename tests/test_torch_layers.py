"""The port's layers import one way: operators -> sort / partition ->
stream (the plane format) -> cuda_radix / cuda_merge (the kernels).

Read from the modules' source (every ``import`` statement, those inside
functions included), so an import made only when a function runs counts
as much as one at the top of the module."""

import ast
import pathlib

import pytest

import radix_sort_tpu_torch

PKG = pathlib.Path(radix_sort_tpu_torch.__file__).parent
OPS = PKG / "ops"


def _imports(path: pathlib.Path):
    """(ops modules, package modules) that ``path`` (a module of ops/)
    imports anywhere in its source."""
    ops, pkg = set(), set()

    def add(parts, names):
        # parts: the module path below the package, names: what is taken
        if parts[:1] == ["ops"]:
            ops.update(parts[1:2] or names)
        elif parts:
            pkg.add(parts[0])
        else:
            pkg.update(names)

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            mod = (node.module or "").split(".") if node.module else []
            names = [a.name for a in node.names]
            if node.level == 1:         # from . / from .x: inside ops/
                add(["ops"] + mod, names)
            elif node.level == 2:       # from .. / from ..x: the package
                add(mod, names)
            elif mod[:1] == ["radix_sort_tpu_torch"]:
                add(mod[1:], names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                mod = a.name.split(".")
                if mod[:1] == ["radix_sort_tpu_torch"]:
                    add(mod[1:], [])
    return ops, pkg


def test_the_import_reader_sees_function_level_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("from . import ranking\nfrom .. import dtypes\n"
                   "def f():\n    from . import stream\n"
                   "    from ..parallel import exchange\n"
                   "    import radix_sort_tpu_torch.ops.sort\n")
    assert _imports(src) == ({"ranking", "stream", "sort"},
                             {"dtypes", "parallel"})


@pytest.mark.parametrize("module", ["cuda_radix", "cuda_merge"])
def test_kernel_modules_import_no_layer_above(module):
    """The kernel modules take planes: of ops/ they import only
    ``ranking`` (the plain versions' ranks) and ``cuda_radix``."""
    ops, _ = _imports(OPS / f"{module}.py")
    assert ops <= {"ranking", "cuda_radix"}, ops


def test_stream_imports_no_operator_query_or_parallel():
    """The plane format sits between the sort entry and the kernels: it
    imports none of sort, partition, the operators, query or parallel."""
    ops, pkg = _imports(OPS / "stream.py")
    above = {p.stem for p in OPS.glob("*.py")} - {
        "__init__", "stream", "cuda_radix", "cuda_merge", "ranking"}
    assert {"sort", "partition", "aggregate", "join", "window"} <= above
    assert not ops & above, ops & above
    assert not pkg & {"query", "parallel"}, pkg
