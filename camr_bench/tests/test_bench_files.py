"""The benchmark's files: ``BENCHMARK.json`` and what it names."""

import json
import re

import pytest
from conftest import ROOT

BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    names += CELLS + [c["name"] for c in BM["configs"]]
    names += [w["traffic"] for w in BM["workloads"]]
    names += [k for c in BM["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in BM["end_to_end"] + BM["per_layer"])) \
        == len(BM["end_to_end"]) + len(BM["per_layer"])
    units = [m["unit"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert all(UNIT.match(u) for u in units), units


def test_metrics_have_readers():
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert (ROOT / "camr_bench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["better"] in ("lower", "higher")
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BM["end_to_end"])
    layers = {m["layer"] for m in BM["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
    for m in BM["per_layer"]:
        assert m["moves"] in {e["name"] for e in BM["end_to_end"]}
        assert set(m.get("workloads", [])) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse_and_name_a_ported_arch(cell):
    from camr_bench import bench
    from repro_torch.configs import ARCHS
    c = bench.load_cell(cell)
    assert c.chips == 1
    assert c.config["arch"] in ARCHS
    assert c.config["family"] == bench.port_config(c.config).family
    assert set(c.config["reduced"]) <= set(c.config["published"])
    from camr_bench.check import NUMBERS
    assert c.workload["limits"] and set(c.workload["limits"]) <= set(NUMBERS)
    entry = next(w for w in BM["workloads"] if w["name"] == cell)
    conf = next(x for x in BM["configs"] if x["name"] == entry["config"])
    assert conf["source"] == c.config["source"]
    assert conf["reduced"] == c.config["reduced"]
    assert len(entry["why"]) <= 200


@pytest.mark.parametrize("config", [c["name"] for c in BM["configs"]])
def test_port_config_is_the_file(config):
    """The port's config of a file holds every width the file states."""
    from camr_bench import bench
    cfg = json.loads((ROOT / "camr_bench" / "configs"
                      / f"{config}.json").read_text())
    pc = bench.port_config(cfg)
    for key in ("n_layers", "d_model", "vocab", "dtype", "grad_sync_dtype",
                "n_heads", "n_kv_heads", "d_ff", "ssm_state", "ssm_heads",
                "ssm_d_inner", "tie_embeddings"):
        if key in cfg:
            assert getattr(pc, key) == cfg[key], key
    assert pc.vocab_padded == cfg["vocab_rows"]
    if "head_dim" in cfg:
        assert pc.hd == cfg["head_dim"]
