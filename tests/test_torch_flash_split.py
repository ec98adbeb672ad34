"""The f32 body's key splits, on the CPU: the plan
(``flash_attention.split_plan``) and a torch emulation of what the
kernel computes from it: each split's partial ``m``, ``l`` and
unnormalized ``acc`` over its keys, merged in split order (m = max m_s,
l = sum l_s e^(m_s - m), o = sum acc_s e^(m_s - m) / l; a row whose
splits saw no key written as 0).

The emulation is held to the JAX reference (``repro.kernels.ref.
flash_attention_ref``) and to the Pallas kernel in interpret mode
within 2e-5, the f32 limit of ``tests/test_kernels.py``: the splits sum
in another order than the materialized softmax, and the merge rescales
each partial once more.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels.flash_attention import (F32_ROWS, SPLIT_KEYS,
                                                 _f32_split, split_plan)

NEG = -1e30                     # the kernel's kNeg: a masked score

# (Tq, Tk, causal, window): the encoder, seamless's cross prefill and
# decode, a ragged causal decode, a window, Tq > Tk, many tiles
PLAN_CASES = [(1000, 1000, False, None), (4, 1000, False, None),
              (1, 1000, False, None), (513, 257, False, None),
              (31, 300, True, None), (1, 5000, True, 4096),
              (64, 5000, True, 4096), (200, 1000, True, None),
              (130, 130, True, None), (64, 600, True, 100),
              (200, 150, False, None), (8, 72, True, 24)]


def _visible(Tq, Tk, causal, window):
    """[Tq, Tk] mask of the keys each query sees (right-aligned)."""
    qpos = np.arange(Tq)[:, None] + (Tk - Tq)
    kpos = np.arange(Tk)[None, :]
    mask = np.ones((Tq, Tk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


@pytest.mark.parametrize("Tq,Tk,causal,window", PLAN_CASES)
def test_plan_covers_each_visible_key_once_in_order(Tq, Tk, causal, window):
    plan = split_plan(Tq, Tk, causal, window)
    mask = _visible(Tq, Tk, causal, window)
    assert len(plan) == -(-Tq // F32_ROWS)
    assert len({len(ranges) for ranges in plan}) == 1     # one n_splits
    for t, ranges in enumerate(plan):
        seen = np.flatnonzero(mask[t * F32_ROWS:(t + 1) * F32_ROWS].any(0))
        keys = [j for lo, hi in ranges for j in range(lo, hi)]
        assert keys == list(seen)           # each visible key once, in order
        for lo, hi in ranges[:-1]:          # whole chunks but the last
            assert (hi - lo) % SPLIT_KEYS == 0 or hi == seen[-1] + 1


def test_plan_splits_few_query_tiles_only():
    """One split at the encoder's 1000 x 1000 (16 query tiles) and at 513
    x 257; several at seamless's cross prefill and decode over 1000
    frames."""
    assert len(split_plan(1000, 1000, False, None)[0]) == 1
    assert len(split_plan(513, 257, False, None)[0]) == 1
    assert len(split_plan(1, 1000, False, None)[0]) > 1
    assert len(split_plan(4, 1000, False, None)[0]) > 1


@pytest.mark.parametrize("Tq,Tk,causal,window", PLAN_CASES[:6])
def test_plan_does_not_depend_on_batch_or_heads(Tq, Tk, causal, window):
    """The wrapper's plan and split count are the same for any B, Hq and
    Hkv (and never read the card); only the workspace follows B * Hq."""
    D = 16
    ref_n, ref_plan = None, None
    for B, Hq, Hkv in ((1, 16, 16), (4, 16, 16), (2, 8, 2), (3, 6, 1)):
        q = torch.zeros((B, Hq, Tq, D))
        k = torch.zeros((B, Hkv, Tk, D))
        n, plan, acc, ml = _f32_split(q, k, causal, window)
        if ref_plan is None:
            ref_n, ref_plan = n, plan
            assert plan.tolist() == [
                [list(r) for r in ranges]
                for ranges in split_plan(Tq, Tk, causal, window)]
        assert n == ref_n and torch.equal(plan, ref_plan)
        assert plan.dtype == torch.int32 and plan.shape == (
            -(-Tq // F32_ROWS), n, 2)
        if n == 1:
            assert acc is None and ml is None
        else:
            assert acc.shape == (B * Hq, n, Tq, D) and acc.dtype == \
                torch.float32
            assert ml.shape == (B * Hq, n, Tq, 2)


def _partial(q, k, v, rows, lo, hi, Tk, causal, window, softcap):
    """One split's m, l and unnormalized acc for the query ``rows`` (q
    already scaled) over keys ``[lo, hi)``: masked scores at NEG, m the
    max (NEG when no key is visible), p = e^(s - m) on visible keys."""
    Tq = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows], k[:, :, lo:hi])
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(rows.start, rows.stop)[:, None] + (Tk - Tq)
    kpos = torch.arange(lo, hi)[None, :]
    ok = torch.ones(qpos.shape[0], hi - lo, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = torch.where(ok, s, torch.tensor(NEG))
    m = s.amax(-1) if hi > lo else torch.full(s.shape[:-1], NEG)
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.tensor(0.0))
    return m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, lo:hi])


def _merge(parts):
    """The fixed-order merge of the splits' partials."""
    m = parts[0][0]
    for ms, _, _ in parts[1:]:
        m = torch.maximum(m, ms)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for ms, ls, accs in parts:
        w = torch.exp(ms - m)
        l = l + ls * w
        acc = acc + accs * w[..., None]
    return acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]


def emulate_split(q, k, v, *, causal, window=None, softcap=None):
    """The f32 body's arithmetic at the split level, in f32 on the CPU:
    q [B, Hq, Tq, D], k/v [B, Hkv, Tk, D] -> [B, Hq, Tq, D]."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    qs = q * D ** -0.5
    out = torch.empty_like(q)
    for t, ranges in enumerate(split_plan(Tq, Tk, causal, window)):
        rows = slice(t * F32_ROWS, min((t + 1) * F32_ROWS, Tq))
        out[:, :, rows] = _merge([
            _partial(qs, k, v, rows, lo, hi, Tk, causal, window, softcap)
            for lo, hi in ranges])
    return out


# B, Hq, Hkv, Tq, Tk, D, causal, window, softcap: a causal right-aligned
# decode and prefill (one with a split that the first rows see nothing
# of), a window (the last split fully masked for the tile's first
# rows), softcap, GQA, Tq > Tk without a mask (two query tiles, two
# splits), seamless's cross decode at D 64
SPLIT_CASES = [
    (1, 4, 2, 31, 300, 16, True, None, None),
    (1, 2, 2, 64, 140, 16, True, None, None),
    (1, 2, 1, 64, 600, 16, True, 100, None),
    (2, 2, 2, 5, 400, 32, False, None, 30.0),
    (1, 8, 2, 1, 520, 16, True, 300, None),
    (1, 2, 2, 200, 150, 16, False, None, None),
    (2, 4, 4, 1, 1000, 64, False, None, None),
]


def _inputs(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap",
                         SPLIT_CASES)
def test_split_emulation_matches_jax_ref(B, Hq, Hkv, Tq, Tk, D, causal,
                                         window, softcap):
    assert len(split_plan(Tq, Tk, causal, window)[0]) > 1   # split at all
    q, k, v = _inputs(B, Hq, Hkv, Tq, Tk, D, seed=Tq + Tk)
    got = emulate_split(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window,
                        softcap=softcap)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap",
                         SPLIT_CASES[:3])
def test_split_emulation_matches_pallas_interpret(B, Hq, Hkv, Tq, Tk, D,
                                                  causal, window, softcap):
    q, k, v = _inputs(B, Hq, Hkv, Tq, Tk, D, seed=Tq * 3 + Tk)
    got = emulate_split(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window,
                        softcap=softcap)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, softcap=softcap,
                        block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_fully_masked_splits_add_nothing():
    """A window tile whose last split the first rows see no key of: that
    split's partial is (NEG, 0, 0) for those rows, and the merge with it
    equals, bitwise, the merge without it."""
    Tq, Tk, window = 64, 600, 100
    ranges = split_plan(Tq, Tk, True, window)[0]
    assert len(ranges) == 2
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, Tq, Tk, 16, 1))
    qs = q * 16 ** -0.5
    rows = slice(0, Tq)
    parts = [_partial(qs, k, v, rows, lo, hi, Tk, True, window, None)
             for lo, hi in ranges]
    blind = (torch.arange(Tq) + Tk - Tq) < ranges[1][0]   # see none of it
    assert blind.any() and not blind.all()
    m1, l1, acc1 = parts[1]
    assert (m1[:, :, blind] == NEG).all() and (l1[:, :, blind] == 0).all()
    assert (acc1[:, :, blind] == 0).all()
    both = _merge(parts)[:, :, blind]
    alone = _merge(parts[:1])[:, :, blind]
    assert torch.equal(both, alone)


def test_a_row_with_no_visible_key_is_written_as_zero():
    """Every split of the row masked (m = NEG, l = 0): o = 0, the Pallas
    kernel's l == 0 guard, not NaN."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 4, 40, 16, 2))
    # keys 20 .. 40 of a causal row at position 0 (Tk = Tq): none visible
    rows = slice(0, 1)
    parts = [_partial(q, k, v, rows, lo, hi, 4, True, None, None)
             for lo, hi in ((20, 30), (30, 40), (40, 40))]
    for m, l, acc in parts:
        assert (m == NEG).all() and (l == 0).all() and (acc == 0).all()
    out = _merge(parts)
    assert torch.equal(out, torch.zeros_like(out))
