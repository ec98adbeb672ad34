"""The port's kernels: plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode, as tests/test_kernels.py runs them), one
virtual-device slice at a time. The CUDA kernels against their plain
versions on a card: tests/test_torch_cuda.py.

Tolerances: the XOR gathers are bit movers, so everything is compared
BITWISE (on u32 words, NaN / -0.0 / denormal patterns included).
``aggregate`` is bitwise when every segment holds one row (an exact
gather in both implementations); with several rows per segment the
Pallas one-hot product and the port's ascending f32 adds round in
different orders, hence rtol 1e-6. XLA on the CPU flushes f32 denormals
to zero inside these sums; the port's adds keep them, as the numpy
engine's do, so the cross-package aggregate cases use normal values and
a separate case pins the port's denormal behaviour.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.aggregate import aggregate as jax_aggregate
from repro.kernels.xor_code import xor_decode_gather as jax_decode_gather
from repro.kernels.xor_code import xor_encode_gather as jax_encode_gather
from repro_torch.kernels import (aggregate, launch_counts, ref,
                                 reset_launch_counts, xor_decode_gather,
                                 xor_encode_gather)

# f32 bit patterns the codec must carry untouched
SPECIAL = np.array([0x7FC00000, 0xFFC00001, 0x80000000, 0x00000001,
                    0x807FFFFF, 0x7F800000, 0xFF800000, 0x00000000],
                   dtype=np.uint32)


def _codec_inputs(K, P, pk, n, m, seed):
    rng = np.random.default_rng(seed)
    chunks = rng.integers(0, 2**32, size=(K, P, pk), dtype=np.uint32)
    chunks.reshape(-1)[:len(SPECIAL)] = SPECIAL[:chunks.size]
    idx = rng.integers(0, P, size=(K, n, m)).astype(np.int32)
    mask = rng.integers(0, 2, size=(K, n, m)).astype(bool)
    mask[:, 0] = False                       # a fully masked row...
    idx[~mask] = 0                           # ...whose indices alias row 0
    recv = rng.integers(0, 2**32, size=(K, n, pk), dtype=np.uint32)
    recv.reshape(-1)[-len(SPECIAL):] = SPECIAL[:recv.size]
    rsel = np.stack([rng.permutation(n) for _ in range(K)]).astype(np.int32)
    return chunks, idx, mask, recv, rsel


def _t(a):
    """numpy -> torch (u32 as its int32 view)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


CODEC_SHAPES = [(2, 5, 7, 3, 3), (3, 9, 130, 4, 2), (1, 4, 1, 2, 4)]


@pytest.mark.parametrize("K,P,pk,n,m", CODEC_SHAPES)
def test_encode_gather_plain_matches_pallas(K, P, pk, n, m):
    chunks, idx, mask, _, _ = _codec_inputs(K, P, pk, n, m, K + P + pk)
    got = ref.xor_encode_gather_ref(_t(chunks), _t(idx), _t(mask))
    assert got.shape == (K, n, pk)
    got = got.numpy().view(np.uint32)
    for v in range(K):
        want = jax_encode_gather(jnp.asarray(chunks[v]), jnp.asarray(idx[v]),
                                 jnp.asarray(mask[v]), interpret=True)
        np.testing.assert_array_equal(got[v], np.asarray(want))
    assert (got[:, 0] == 0).all()            # masked row: XOR identity


@pytest.mark.parametrize("K,P,pk,n,m", CODEC_SHAPES)
def test_decode_gather_plain_matches_pallas(K, P, pk, n, m):
    chunks, idx, mask, recv, rsel = _codec_inputs(K, P, pk, n, m, 3 * K + pk)
    got = ref.xor_decode_gather_ref(_t(recv), _t(chunks), _t(rsel), _t(idx),
                                    _t(mask)).numpy().view(np.uint32)
    for v in range(K):
        want = jax_decode_gather(jnp.asarray(recv[v]), jnp.asarray(chunks[v]),
                                 jnp.asarray(rsel[v]), jnp.asarray(idx[v]),
                                 jnp.asarray(mask[v]), interpret=True)
        np.testing.assert_array_equal(got[v], np.asarray(want))
    np.testing.assert_array_equal(got[:, 0], recv[np.arange(K), rsel[:, 0]])


def _agg_inputs(n, d, S, seed, one_per_segment):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    vals[:, 0] = -0.0                        # signed zeros sum to +0.0
    if one_per_segment:
        ids = np.full(n, -1, np.int32)       # padding rows drop
        ids[rng.permutation(n)[:S]] = np.arange(S)
    else:
        ids = rng.integers(-1, S, size=n).astype(np.int32)
    return vals, ids


@pytest.mark.parametrize("n,d,S", [(6, 64, 4), (4, 37, 4), (9, 5, 2)])
def test_aggregate_plain_matches_pallas_one_row_per_segment(n, d, S):
    vals, ids = _agg_inputs(n, d, S, n + d, one_per_segment=True)
    got = ref.aggregate_ref(_t(vals), _t(ids), S).numpy()
    want = np.asarray(jax_aggregate(jnp.asarray(vals), jnp.asarray(ids), S,
                                    interpret=True))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,d,S", [(16, 8, 4), (33, 64, 5)])
def test_aggregate_plain_matches_pallas_several_rows(n, d, S):
    vals, ids = _agg_inputs(n, d, S, 7 * n + d, one_per_segment=False)
    got = ref.aggregate_ref(_t(vals), _t(ids), S).numpy()
    want = np.asarray(jax_aggregate(jnp.asarray(vals), jnp.asarray(ids), S,
                                    interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_aggregate_keeps_denormals_like_the_engine():
    vals = np.array([[1e-40, -3e-39, 2.0], [5e-41, 0.0, -1.0]], np.float32)
    ids = np.array([1, 0], np.int32)
    got = ref.aggregate_ref(_t(vals), _t(ids), 2).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  vals[::-1].view(np.uint32))


def test_wrappers_take_plain_version_on_cpu():
    chunks, idx, mask, recv, rsel = _codec_inputs(2, 5, 9, 3, 3, 11)
    reset_launch_counts()
    c, i, m_ = _t(chunks), _t(idx), _t(mask)
    assert torch.equal(xor_encode_gather(c, i, m_),
                       ref.xor_encode_gather_ref(c, i, m_))
    # uint32 words go through as their int32 view and come back uint32
    enc_u = xor_encode_gather(c.view(torch.uint32), i, m_)
    assert enc_u.dtype == torch.uint32
    assert torch.equal(enc_u.view(torch.int32),
                       ref.xor_encode_gather_ref(c, i, m_))
    r, s = _t(recv), _t(rsel)
    assert torch.equal(xor_decode_gather(r, c, s, i, m_),
                       ref.xor_decode_gather_ref(r, c, s, i, m_))
    vals, ids = _agg_inputs(5, 12, 3, 1, one_per_segment=False)
    out = torch.empty((3, 12))
    got = aggregate(_t(vals), _t(ids), 3, out=out)
    assert got is out and torch.equal(out, ref.aggregate_ref(_t(vals),
                                                            _t(ids), 3))
    assert launch_counts() == {"xor_encode_gather": 0,
                               "xor_decode_gather": 0, "aggregate": 0}


def test_wrappers_reject_bad_inputs():
    c = torch.zeros((2, 4, 8), dtype=torch.int32)
    i = torch.zeros((2, 3, 2), dtype=torch.int32)
    m = torch.ones((2, 3, 2), dtype=torch.bool)
    with pytest.raises(TypeError):
        xor_encode_gather(c.float(), i, m)
    with pytest.raises(ValueError):
        xor_encode_gather(c, i, m[:, :, :1])
    with pytest.raises(ValueError):
        xor_encode_gather(c, i.long(), m)
    with pytest.raises(ValueError):
        xor_decode_gather(torch.zeros((2, 3, 7), dtype=torch.int32), c,
                          torch.zeros((2, 3), dtype=torch.int32), i, m)
    with pytest.raises(ValueError):
        xor_decode_gather(torch.zeros((2, 3, 8), dtype=torch.int32), c,
                          torch.zeros((2, 4), dtype=torch.int32), i, m)
    with pytest.raises(ValueError):
        aggregate(torch.zeros((3, 4)), torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        aggregate(torch.zeros((3, 4)), torch.zeros(3, dtype=torch.int32), 2,
                  out=torch.zeros((3, 4)))
