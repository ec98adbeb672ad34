"""What the benchmark's modules import: never JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference nothing of the program."""

import ast

import pytest
from conftest import ROOT

BENCH = ROOT / "camr_bench"
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_top_levels(path))


def test_the_check_compares_names_whole():
    from camr_bench import bench
    import sys
    sys.modules.setdefault("repro_torch_lookalike_for_test", object())
    try:
        assert "repro" not in bench.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike_for_test"]
