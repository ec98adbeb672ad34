"""The port's copies of the numpy engines against the JAX package's: the
CAMR engine on the paper's word-count example, the uncoded and CCDC
baselines, the JobStream runtime, and the bf16 combiner the trainer
hands the engines in place of ``ml_dtypes``.

Tolerances, and why: every comparison is exact. The engines are the
same numpy source (``tests/test_torch_import.py`` holds the copies
source-identical), the XOR transport is lossless, and the bf16 combiner
is an f32 add rounded to nearest even, as ``np.add`` on
``ml_dtypes.bfloat16`` arrays computes it. NaN inputs are left out:
their bf16 bits differ between libraries (ROADMAP.md, Queue 3).
"""

import ml_dtypes
import numpy as np
import pytest

from repro.configs import paper_wordcount as jwordcount
from repro.core import baselines as jbaselines
from repro.core import engine as jengine
from repro.runtime import jobstream as jjobstream
from repro_torch.configs import paper_wordcount
from repro_torch.core import baselines, engine, loads
from repro_torch.runtime import jobstream
from repro_torch.runtime.train_loop import bf16_add


def _results_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))


@pytest.mark.parametrize("q,k,gamma", [(2, 3, 2), (3, 3, 1), (4, 3, 1)])
def test_wordcount_example_matches_jax_and_the_closed_form(q, k, gamma):
    """The paper's Example 1 through both engine copies: the same counts
    at every server, the same wire bytes, and the loads of the closed
    form (k = 3: an 8-byte count splits into k - 1 packets with no
    padding, the paper's divisibility assumption)."""
    eng, res, L = engine.run_wordcount_example(q=q, k=k, gamma=gamma)
    jeng, jres, jL = jengine.run_wordcount_example(q=q, k=k, gamma=gamma)
    _results_equal(jres, res)
    assert L == jL
    assert eng.trace.total_bytes() == jeng.trace.total_bytes()
    assert L["L_total_bus"] == pytest.approx(loads.camr_load(q, k))
    assert L["L_total_p2p"] == pytest.approx(loads.camr_load_p2p(q, k))
    for st, want in enumerate(loads.camr_stage_loads(q, k), start=1):
        assert L[f"L_stage{st}_bus"] == pytest.approx(want)


def test_paper_wordcount_config_is_the_jax_one():
    assert paper_wordcount.CAMR_PARAMS == jwordcount.CAMR_PARAMS == \
        dict(q=2, k=3, gamma=2)
    eng, _, L = engine.run_wordcount_example(**paper_wordcount.CAMR_PARAMS)
    assert eng.cfg.J == 4 and eng.cfg.K == 6
    assert L["L_total_bus"] == pytest.approx(1.0)


def _vector_corpus(q, k, gamma, d, seed, dtype=np.float32):
    cfg = engine.CAMRConfig(q=q, k=k, gamma=gamma)
    rng = np.random.default_rng(seed)
    Q = cfg.num_functions()
    return cfg, [[rng.standard_normal((Q, d)).astype(dtype)
                  for _ in range(cfg.N)] for _ in range(cfg.J)]


def _identity(job, sf):
    return sf


@pytest.mark.parametrize("q,k,gamma", [(2, 3, 2), (3, 3, 1)])
def test_uncoded_baseline_matches_jax(q, k, gamma):
    """The unicast baseline: bitwise the JAX copy's results (and, in the
    engine's canonical combine order, the coded engine's), its load the
    closed form (2K - k) / K."""
    cfg, ds = _vector_corpus(q, k, gamma, 5, seed=q * 10 + k)
    un = baselines.UncodedAggregatedEngine(q, k, gamma, _identity)
    jun = jbaselines.UncodedAggregatedEngine(q, k, gamma, _identity)
    res, jres = un.run(ds), jun.run(ds)
    _results_equal(jres, res)
    assert un.measured_load() == jun.measured_load() == pytest.approx(
        loads.uncoded_aggregated_load(q, k))
    coded = engine.CAMREngine(cfg, _identity).run(ds)
    for s, r in enumerate(res):
        for key, v in r.items():
            np.testing.assert_array_equal(v, coded[s][key])


def test_ccdc_engine_matches_jax():
    K, r = 5, 2
    eng = baselines.CCDCEngine(K, r, _identity)
    jeng = jbaselines.CCDCEngine(K, r, _identity)
    rng = np.random.default_rng(7)
    ds = [[rng.standard_normal((r + 1, 3)).astype(np.float32)
           for _ in range(r + 1)] for _ in range(eng.J)]
    res, jres = eng.run(ds), jeng.run(ds)
    eng.verify(ds, res)
    _results_equal(jres, res)
    assert eng.measured_load() == jeng.measured_load() == pytest.approx(
        1 / r)


@pytest.mark.parametrize("kw", [dict(), dict(pipeline=False),
                                dict(batching=False), dict(wave_batch=2)])
def test_jobstream_matches_jax_and_the_serial_engine(kw):
    """Mixed-shape waves through both JobStream copies: the same results
    in submission order, bitwise the serial engine's, and the same
    batching report."""
    specs, jspecs, waves = [], [], []
    for w, (q, k, d) in enumerate([(2, 3, 4), (3, 3, 6), (2, 3, 4),
                                   (2, 3, 4), (3, 3, 6)]):
        cfg, ds = _vector_corpus(q, k, 1, d, seed=w)
        jcfg = jengine.CAMRConfig(q=q, k=k, gamma=1)
        specs.append(jobstream.JobSpec(cfg, _identity, ds, name=f"w{w}"))
        jspecs.append(jjobstream.JobSpec(jcfg, _identity, ds, name=f"w{w}"))
        waves.append((cfg, ds))
    stream, jstream = jobstream.JobStream(**kw), jjobstream.JobStream(**kw)
    got, want = stream.run(specs), jstream.run(jspecs)
    for (cfg, ds), g, w in zip(waves, got, want):
        _results_equal(w, g)
        _results_equal(engine.CAMREngine(cfg, _identity).run(ds), g)
    rep, jrep = stream.last_report, jstream.last_report
    assert (rep.waves, rep.batches, rep.pipelined) == \
        (jrep.waves, jrep.batches, jrep.pipelined)
    assert [e.trace.total_bytes() for e in stream.last_engines] == \
        [e.trace.total_bytes() for e in jstream.last_engines]


def _bf16_cases():
    """bf16 bit patterns: random finite values over the whole exponent
    range, +-0, subnormals, the largest finite values (sums overflow to
    inf), and pairs whose f32 sum lies exactly halfway between two bf16
    values (ties, both parities)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, 200_000, dtype=np.uint32).astype(np.uint16)
    finite = bits[(bits & 0x7F80) != 0x7F80]
    special = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F,
                        0x0080, 0x8080, 0x7F7F, 0xFF7F, 0x3F80, 0xBF80],
                       np.uint16)
    sub = rng.integers(0, 0x80, 2000).astype(np.uint16) | \
        (rng.integers(0, 2, 2000).astype(np.uint16) << 15)
    a = np.concatenate([finite[:len(finite) // 2], np.repeat(special, 12),
                        sub[:1000]])
    b = np.concatenate([finite[len(finite) // 2:][:len(finite) // 2],
                        np.tile(special, 12), sub[1000:]])
    # ties: 1 + 2^-8 is halfway between bf16 1 and 1 + 2^-7, 1 + 3 * 2^-8
    # between 1 + 2^-7 and 1 + 2^-6 (round down, then up, to even)
    one = np.float32(1.0)
    tie_a = np.array([one, one, 2 * one, -one], np.float32)
    tie_b = np.array([2 ** -8, 3 * 2 ** -8, 2 ** -7, -(3 * 2 ** -8)],
                     np.float32)
    to16 = lambda x: (x.view(np.uint32) >> 16).astype(np.uint16)
    assert (to16(tie_b).astype(np.uint32) << 16).view(np.float32).tolist() \
        == tie_b.tolist()
    n = min(len(a), len(b))
    return (np.concatenate([a[:n], to16(tie_a)]),
            np.concatenate([b[:n], to16(tie_b)]))


def test_bf16_combine_is_ml_dtypes_add_bitwise():
    a, b = _bf16_cases()
    with np.errstate(over="ignore"):      # the largest values overflow
        want = np.add(a.view(ml_dtypes.bfloat16),
                      b.view(ml_dtypes.bfloat16))
        got = bf16_add(a, b)
    assert got.dtype == np.uint16 and got.shape == a.shape
    np.testing.assert_array_equal(got, want.view(np.uint16))
    f = (want.astype(np.float32))
    assert np.isinf(f).any() and (f == 0).any() and \
        (np.abs(f[f != 0]) < 2.0 ** -126).any()
    assert (got[-4:] == want[-4:].view(np.uint16)).all()


def test_engine_on_bf16_bits_equals_the_jax_engine_on_ml_dtypes():
    """The trainer's bf16 lane: the engines on uint16 bit patterns with
    ``bf16_add`` give the bits the JAX engines give on ml_dtypes bf16
    values with ``np.add`` (gamma 2: the per-batch combine runs too)."""
    cfg, ds = _vector_corpus(2, 3, 2, 6, seed=5)
    jcfg = jengine.CAMRConfig(q=2, k=3, gamma=2)
    bits = [[v.astype(ml_dtypes.bfloat16).view(np.uint16) for v in job]
            for job in ds]
    vals = [[v.view(ml_dtypes.bfloat16) for v in job] for job in bits]
    res = engine.CAMREngine(cfg, _identity, combine=bf16_add).run(bits)
    jres = jengine.CAMREngine(jcfg, _identity).run(vals)
    un = baselines.UncodedAggregatedEngine(2, 3, 2, _identity,
                                           combine=bf16_add).run(bits)
    for r, u, j in zip(res, un, jres):
        assert r.keys() == j.keys() == u.keys()
        for key in r:
            assert r[key].dtype == np.uint16
            np.testing.assert_array_equal(r[key], j[key].view(np.uint16))
            np.testing.assert_array_equal(u[key], r[key])
    spec = jobstream.JobSpec(cfg, _identity, bits, combine=bf16_add,
                             value_dtype=np.uint16)
    _results_equal(res, jobstream.JobStream(pipeline=False).run([spec])[0])
