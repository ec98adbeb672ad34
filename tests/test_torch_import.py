"""The PyTorch port stands alone: ``import repro_torch`` (and every module
of it) never loads jax or ``ml_dtypes``, no port file imports jax, the
JAX package or ``ml_dtypes`` (the card's machine has none: the bf16 grad-
sync lane hands the numpy engines bit patterns), and the numpy modules
the port keeps its own copies of stay source-identical to their
originals apart from import lines."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
REF = os.path.join(ROOT, "src", "repro")

_IMPORT_ALL = textwrap.dedent("""
    import pkgutil, sys
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        __import__(name)
    assert len(names) >= 20, names
    assert "repro_torch.kernels.ops" in names, names
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
    assert not bad, bad
    print("OK", len(names))
""")


def test_import_repro_torch_never_loads_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")


def test_chip_smoke_refuses_without_a_card():
    """With no CUDA card the smoke exits nonzero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run in full")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    assert "no CUDA device" in res.stderr


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    ex = os.path.join(ROOT, "examples", "torch")
    out += [os.path.join(ex, f) for f in os.listdir(ex) if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    bad = {}
    files = _port_files()
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}
        if roots:
            bad[os.path.relpath(path, ROOT)] = sorted(roots)
    assert not bad, bad


def _strip_imports(path):
    """Source lines with import statements (any indentation) removed."""
    out = []
    for line in open(path).read().splitlines():
        s = line.strip()
        if s.startswith("import ") or s.startswith("from "):
            continue
        out.append(line)
    return out


def test_no_port_file_imports_ml_dtypes():
    """numpy has no bf16 without ``ml_dtypes``; the port and the smoke
    carry bf16 as torch tensors or as ``uint16`` bit patterns."""
    bad = [os.path.relpath(path, ROOT) for path in _port_files()
           if "ml_dtypes" in set(_imported_roots(path))]
    assert not bad, bad


@pytest.mark.parametrize("rel", ["core/designs.py", "core/placement.py",
                                 "core/schedule.py", "core/loads.py",
                                 "data/pipeline.py", "core/shuffle.py",
                                 "core/engine.py", "core/baselines.py",
                                 "runtime/jobstream.py",
                                 "configs/paper_wordcount.py"])
def test_numpy_copies_source_identical(rel):
    assert _strip_imports(os.path.join(PORT, rel)) == \
        _strip_imports(os.path.join(REF, rel))


#: the top-level names of ``runtime/fault.py`` written for the port (the
#: host interpreter takes a ``combine``, the executor is torch's)
_FAULT_OWN = {"degraded_shuffle_host", "build_degraded_executor"}


def _top_level(path):
    """Top-level statements of a file by name (functions, classes and
    assignments; imports and the module docstring left out), as AST
    dumps."""
    tree = ast.parse(open(path).read(), filename=path)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                out[ast.unparse(t)] = ast.dump(node)
    return out


def test_fault_numpy_part_source_identical():
    """``runtime/fault.py`` is the JAX file's numpy code for every
    top-level name but the two written for the port; the file as a whole
    is not identical, so the names are compared one by one."""
    port = _top_level(os.path.join(PORT, "runtime", "fault.py"))
    ref = _top_level(os.path.join(REF, "runtime", "fault.py"))
    assert sorted(port) == sorted(ref)
    assert _FAULT_OWN <= set(ref)
    assert len(ref) > 10, sorted(ref)
    differ = {name for name in ref if port[name] != ref[name]}
    assert differ <= _FAULT_OWN, sorted(differ - _FAULT_OWN)
