"""The six examples of ``examples/torch/``, the PyTorch port's twins of
``examples/*.py``, each run in this process through its ``main()``: the
numpy-only ones print the JAX examples' lines exactly; the model ones
run on the CPU with ``--device cpu`` (the ~100M-parameter
``train_lm.py`` with its model cut to a tiny width) and print ``OK``;
without ``--device cpu`` and without a card each raises."""

import importlib.util
import os
import sys

import pytest
import torch

from repro_torch.configs import get_config, reduced

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "matvec_jobs", "fault_tolerance",
            "multimodel_camr", "serve_lm", "train_lm")


def _main(rel, argv, monkeypatch, capsys, **patch):
    """Load ``rel`` as a module, set ``patch`` on it and ``sys.argv`` to
    ``argv``, run its ``main()``; the lines it printed."""
    path = os.path.join(ROOT, rel)
    name = "example_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, value in patch.items():
        monkeypatch.setattr(mod, key, value)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", ["quickstart", "matvec_jobs",
                                  "fault_tolerance"])
def test_numpy_example_prints_the_jax_lines(name, monkeypatch, capsys):
    jax = _main(f"examples/{name}.py", [], monkeypatch, capsys)
    port = _main(f"examples/torch/{name}.py", ["--device", "cpu"],
                 monkeypatch, capsys)
    assert port == jax
    assert port[-1] == "OK"


@pytest.mark.parametrize("args", [
    ["--steps", "1"],
    ["--steps", "1", "--modes", "camr,camr_spmd",
     "--grad-sync-dtype", "bfloat16"]])
def test_multimodel_example_on_the_cpu(args, monkeypatch, capsys):
    """The three wires (or the engine and the device lane on the bf16
    wire) bitwise, and the coded bytes a third fewer."""
    lines = _main("examples/torch/multimodel_camr.py", args + ["--device",
                                                              "cpu"],
                  monkeypatch, capsys)
    assert lines[-1] == "OK"
    assert any("parameters and losses BIT-IDENTICAL" in ln for ln in lines)
    if "--modes" not in args:
        assert any("33.3% fewer bytes" in ln for ln in lines)


def test_serve_example_on_the_cpu(monkeypatch, capsys):
    lines = _main("examples/torch/serve_lm.py", ["--device", "cpu"],
                  monkeypatch, capsys)
    assert "OK (teacher-forcing consistency verified)" in lines
    assert lines[-1] == "OK (engine == host-loop oracle, token for token)"


class _Tiny:
    """Stands for ``get_config("granite_3_2b")`` in ``train_lm.py``: its
    ``replace`` keeps the example's dtype and tied embeddings at the
    reduced granite's widths."""

    def replace(self, **kw):
        return reduced(get_config("granite_3_2b")).replace(
            n_layers=2, dtype=kw["dtype"], loss_chunk=16,
            tie_embeddings=kw["tie_embeddings"])


def test_train_example_on_the_cpu_at_a_tiny_width(monkeypatch, capsys,
                                                   tmp_path):
    """``train_lm.py`` end to end on a tiny granite (its own arguments,
    pipeline and trainer; 20 steps, its first logged step after step 1):
    the loss falls and it prints ``OK``."""
    lines = _main("examples/torch/train_lm.py",
                  ["--steps", "20", "--ckpt-dir", str(tmp_path / "ckpt"),
                   "--device", "cpu"], monkeypatch, capsys,
                  get_config=lambda name: _Tiny())
    assert lines[0].startswith("model: ") and lines[-1] == "OK"
    assert any(ln.startswith("loss ") and "over 20 steps" in ln
               for ln in lines)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run")
    with pytest.raises(RuntimeError, match="is_available\\(\\) is False"):
        _main(f"examples/torch/{name}.py", [], monkeypatch, capsys)
    assert "OK" not in capsys.readouterr().out
