"""The span recorder of the port (``repro_torch.core.spans``) in the
multi-model training step: the keys of each step's ``phase_ms``, spans
nested in their phases, nothing recorded (and the same bits) outside a
recorder, the process lane's ``process_stats`` from the same spans, and
each span as a host event of a ``torch.profiler`` trace."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced
from repro_torch.core import spans
from repro_torch.core.collective import camr_shuffle, make_plan
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.launch.mesh import make_camr_mesh
from repro_torch.optim import AdamWState, adamw_update
from repro_torch.runtime import MultiModelCAMRTrainer
from repro_torch.runtime.train_loop import PHASES, SPANS

PHASE_NAMES = ["map", "aggregate", "shuffle", "update"]
SPAN_NAMES = ["map.feed", "map.upload", "map.forward", "map.backward",
              "map.row", "aggregate.upload", "aggregate.stack",
              "aggregate.kernel", "shuffle.wire", "shuffle.encode",
              "shuffle.exchange", "shuffle.decode", "shuffle.stage3",
              "shuffle.assemble", "update.gather", "update.clip",
              "update.adamw"]
#: the keys of every step's ``phase_ms``, in order: the phases, then each
#: span's device ms and host ms
PHASE_KEYS = PHASE_NAMES + [key for name in SPAN_NAMES
                            for key in (name, name + ":host")]
#: calls of each span in one camr_spmd step at q = 2, k = 3: J x N = 12
#: map calls, one combiner launch for each of K = 6 workers, two coded
#: stages
CALLS = {"map": 1, "map.feed": 1, "map.upload": 12, "map.forward": 12,
         "map.backward": 12, "map.row": 12, "aggregate": 1,
         "aggregate.upload": 6, "aggregate.stack": 6, "aggregate.kernel": 6,
         "shuffle": 1, "shuffle.wire": 1, "shuffle.encode": 2,
         "shuffle.exchange": 2, "shuffle.decode": 2, "shuffle.stage3": 1,
         "shuffle.assemble": 1, "update": 1, "update.gather": 1,
         "update.clip": 1, "update.adamw": 1}
TINY = dict(n_layers=2, vocab=64, d_model=32, d_ff=64, n_heads=2,
            n_kv_heads=1, head_dim=16, loss_chunk=8, remat="none")
MODES = ["camr_spmd", "camr", "uncoded"]
#: spans that run in the host modes (the engines replace the rest)
HOST_MODE_SPANS = {"map.feed", "map.upload", "map.forward", "map.backward",
                   "map.row", "update.gather", "update.clip", "update.adamw"}


def _trainer(lane="float32"):
    cfg = reduced(get_config("granite_3_2b")).replace(**TINY)
    return MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", seed=6,
                                 grad_sync_dtype=lane)


def _pipe():
    return ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)


def test_documented_names():
    assert list(PHASES) == PHASE_NAMES and list(SPANS) == SPAN_NAMES
    assert set(CALLS) == set(PHASE_NAMES + SPAN_NAMES)
    assert not any(n.startswith("cu") for n in CALLS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_phase_ms_keys_and_nesting(lane, mode):
    """Every step's dict has exactly the documented keys in order, each
    finite and non-negative; the spans that run in the mode read above
    0, the others 0.0; on the host clock a phase's child spans sum to no
    more than the phase plus 1%."""
    tr = _trainer(lane)
    rep = tr.train_steps(_pipe(), 2, mode=mode)
    assert [list(ms) for ms in rep.phase_ms] == [PHASE_KEYS] * 2
    ran = set(SPAN_NAMES) if mode == "camr_spmd" else HOST_MODE_SPANS
    for ms in rep.phase_ms:
        assert all(math.isfinite(v) and v >= 0 for v in ms.values()), ms
        for name in SPAN_NAMES:
            for key in (name, name + ":host"):
                assert (ms[key] > 0) == (name in ran), (key, ms[key])
        for phase in PHASE_NAMES:
            kids = [n for n in SPAN_NAMES if n.startswith(phase + ".")]
            for suffix in ("", ":host"):
                assert sum(ms[n + suffix] for n in kids) \
                    <= 1.01 * ms[phase], (phase, suffix, ms)


def _contribs(plan, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (plan.K, plan.J_own, plan.k - 1, plan.K, plan.d)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("codec", ["fused", "multipass"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_recorder_records_nothing(dtype, codec):
    """With no recorder open, ``span`` is one shared null context; the
    shuffle and AdamW give bitwise what they give inside a recorder, and
    a closed recorder gets no call; inside one, each part is one call."""
    assert spans.current() is None and spans.span("a") is spans.span("b")
    plan = make_plan(2, 3, 12)
    x = _contribs(plan, dtype)
    closed = spans.Recorder("cpu")
    with closed:
        pass
    out = camr_shuffle(plan, x, codec=codec)
    p0 = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    g0 = torch.randn(4, 64, generator=torch.Generator().manual_seed(2))
    run = []
    for _ in range(2):
        p, g = p0.clone(), g0.clone()
        st = AdamWState(step=torch.zeros(4, dtype=torch.int32),
                        mu=torch.zeros_like(p), nu=torch.zeros_like(p))
        run.append((p, st))
    adamw_update(run[0][0], g0.clone(), run[0][1], lr=1e-2)
    assert not closed.calls
    with spans.Recorder("cpu") as rec:
        got = camr_shuffle(plan, x, codec=codec)
        adamw_update(run[1][0], g0.clone(), run[1][1], lr=1e-2)
    assert spans.current() is None
    assert torch.equal(out.view(torch.int16 if dtype.itemsize == 2
                                else torch.int32),
                       got.view(torch.int16 if dtype.itemsize == 2
                                else torch.int32))
    for a, b in ((run[0][0], run[1][0]), (run[0][1].mu, run[1][1].mu),
                 (run[0][1].nu, run[1][1].nu)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    times = rec.read()
    assert {n: sum(c.name == n for c in rec.calls) for n in times} == {
        n: c for n, c in CALLS.items()
        if n.startswith(("shuffle.", "update.")) and n != "update.gather"}


def test_process_lane_stats_from_spans():
    """The process lane (one process: every worker local) fills
    ``process_stats``' ms from its spans: at once with no recorder open,
    at the caller's read inside one; its bits are the stacked
    executor's."""
    plan = make_plan(2, 3, 12)
    x = _contribs(plan)
    mesh = make_camr_mesh(plan.K, device="cpu")
    want = camr_shuffle(plan, x)
    out = camr_shuffle(plan, x, mesh=mesh)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    ms_keys = {"stage1": ("encode_ms", "exchange_ms", "decode_ms"),
               "stage2": ("encode_ms", "exchange_ms", "decode_ms"),
               "stage3": ("ms",)}
    st = plan.process_stats
    for name, keys in ms_keys.items():
        assert all(st[name][k] >= 0 for k in keys), st
    with spans.Recorder("cpu") as rec:
        out = camr_shuffle(plan, x, mesh=mesh)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    st = plan.process_stats
    assert "encode_ms" not in st["stage1"] and "ms" not in st["stage3"]
    times = rec.read()
    calls = {n: [c.device_ms for c in rec.calls if c.name == n]
             for n in times}
    assert {n: len(c) for n, c in calls.items()} == {
        n: c for n, c in CALLS.items() if n.startswith("shuffle.")}
    for i, stage in enumerate(("stage1", "stage2")):
        assert st[stage]["encode_ms"] == calls["shuffle.encode"][i]
        assert st[stage]["exchange_ms"] == calls["shuffle.exchange"][i]
        assert st[stage]["decode_ms"] == calls["shuffle.decode"][i]
    assert st["stage3"]["ms"] == (calls["shuffle.stage3"][0]
                                  + calls["shuffle.assemble"][0])
    assert st["stage1"]["exchanges"] == 0 and st["stage3"]["rows"] == 0


def test_spans_in_a_profiler_trace():
    """One step under ``torch.profiler`` on the CPU: each span, once a
    call, is a host event ``camr.<name>``, not a user annotation, inside
    its phase's event (the phases one event each)."""
    tr = _trainer()
    pipe = _pipe()
    tr.train_steps(pipe, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_steps(pipe, 1)
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("camr.")]
    assert not any(e.is_user_annotation() for e in evs)
    got = {}
    for e in evs:
        name = e.name().removeprefix("camr.")
        got.setdefault(name, []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert {n: len(v) for n, v in got.items()} == CALLS
    for name, ivs in got.items():
        phase = name.split(".")[0]
        (lo, hi), = got[phase]
        assert all(lo <= a <= b <= hi for a, b in ivs), name
    # phases in order, one after another
    bounds = [got[p][0] for p in PHASE_NAMES]
    assert all(a[1] <= b[0] for a, b in zip(bounds, bounds[1:]))


def test_recorder_nests_and_reads_once():
    """A recorder opened inside another takes the spans until it closes;
    a phase starts at the previous phase's end mark; a second read gives
    the same sums."""
    with spans.Recorder("cpu") as outer:
        with outer.phase("a"):
            with spans.span("a.x"):
                pass
        with spans.Recorder("cpu") as inner:
            with spans.span("b.y"):
                pass
        assert spans.current() is outer
        with outer.phase("b"):
            pass
    assert spans.current() is None
    assert [c.name for c in outer.calls] == ["a", "a.x", "b"]
    assert [c.name for c in inner.calls] == ["b.y"]
    assert outer.calls[2].start is outer.calls[0].end
    first = outer.read()
    assert outer.read() == first
    assert np.isclose(first["a"][0], first["a"][1])
