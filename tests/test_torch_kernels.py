"""The port's kernels: plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode, as tests/test_kernels.py runs them), one
virtual-device slice at a time for the gathers, whole tables for the
dense folds of the multipass codec. The CUDA kernels against their plain
versions on a card: tests/test_torch_cuda.py.

Tolerances: the XOR gathers and folds are bit movers, so everything is
compared BITWISE (on u32 words or u16 lanes, NaN / -0.0 / denormal
patterns included).
``aggregate`` is bitwise when every segment holds one row (an exact
gather in both implementations); with several rows per segment the
Pallas one-hot product and the port's ascending f32 adds round in
different orders, hence rtol 1e-6. XLA on the CPU flushes f32 denormals
to zero inside these sums; the port's adds keep them, as the numpy
engine's do, so the cross-package aggregate cases use normal values and
a separate case pins the port's denormal behaviour. On bf16 values the
combiner sums in f32 and rounds once: bitwise with one row per segment,
within one bf16 ulp with several (f32 sums in another order may round to
the neighbouring bf16 value).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jax_ops
from repro.kernels.aggregate import aggregate as jax_aggregate
from repro.kernels.xor_code import xor_decode as jax_decode
from repro.kernels.xor_code import xor_encode as jax_encode
from repro.kernels.xor_code import xor_fold as jax_fold
from repro.kernels.xor_code import xor_decode_gather as jax_decode_gather
from repro.kernels.xor_code import xor_encode_gather as jax_encode_gather
from repro.kernels.xor_code import xor_decode_gather16 as jax_decode_gather16
from repro.kernels.xor_code import xor_encode_gather16 as jax_encode_gather16
from repro_torch.kernels import (KERNELS, aggregate, aggregate_bf16,
                                 launch_counts, ops, ref, reset_launch_counts,
                                 xor_code,
                                 xor_decode, xor_decode_gather,
                                 xor_decode_gather16, xor_encode,
                                 xor_encode_gather, xor_encode_gather16,
                                 xor_fold)

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


# bf16 lane patterns: quiet/signalling NaNs with payloads, +/-inf, +/-0,
# subnormals (min and max), min/max normals
SPECIAL16 = np.array([0x7FC0, 0xFFC0, 0x7F81, 0x7F80, 0xFF80, 0x0000, 0x8000,
                      0x0001, 0x8001, 0x007F, 0x0080, 0x7F7F, 0xFF7F],
                     dtype=np.uint16)


def _codec16_inputs(K, P, lanes, n, m, seed):
    """The 16-bit lane's inputs: u16 chunks / recv with the specials
    sprinkled in, and the same table rules as :func:`_codec_inputs`."""
    chunks, idx, mask, recv, rsel = _codec_inputs(K, P, 1, n, m, seed)
    rng = np.random.default_rng(seed + 1)
    chunks = rng.integers(0, 2**16, size=(K, P, lanes), dtype=np.uint16)
    chunks.reshape(-1)[:len(SPECIAL16)] = SPECIAL16[:chunks.size]
    recv = rng.integers(0, 2**16, size=(K, n, lanes), dtype=np.uint16)
    recv.reshape(-1)[-len(SPECIAL16):] = SPECIAL16[-recv.size:]
    return chunks, idx, mask, recv, rsel


def _t(a):
    """numpy -> torch (u32 / u16 as their int32 / int16 views)."""
    a = np.ascontiguousarray(a)
    view = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
    return torch.from_numpy(a.view(view.get(a.dtype, a.dtype)))


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


CODEC16_SHAPES = [(2, 5, 2, 3, 3), (3, 9, 6, 4, 2), (1, 4, 2002, 2, 4)]


@pytest.mark.parametrize("K,P,lanes,n,m", CODEC16_SHAPES)
def test_encode_gather16_plain_matches_pallas(K, P, lanes, n, m):
    chunks, idx, mask, _, _ = _codec16_inputs(K, P, lanes, n, m, K + lanes)
    got = ref.xor_encode_gather16_ref(_t(chunks), _t(idx), _t(mask))
    assert got.shape == (K, n, lanes) and got.dtype == torch.int16
    got = got.numpy().view(np.uint16)
    for v in range(K):
        want = jax_encode_gather16(jnp.asarray(chunks[v]),
                                   jnp.asarray(idx[v]), jnp.asarray(mask[v]),
                                   interpret=True)
        np.testing.assert_array_equal(got[v], np.asarray(want))
    assert (got[:, 0] == 0).all()            # masked row: XOR identity


@pytest.mark.parametrize("K,P,lanes,n,m", CODEC16_SHAPES)
def test_decode_gather16_plain_matches_pallas(K, P, lanes, n, m):
    chunks, idx, mask, recv, rsel = _codec16_inputs(K, P, lanes, n, m,
                                                    5 * K + lanes)
    got = ref.xor_decode_gather16_ref(_t(recv), _t(chunks), _t(rsel),
                                      _t(idx), _t(mask)).numpy()
    got = got.view(np.uint16)
    for v in range(K):
        want = jax_decode_gather16(jnp.asarray(recv[v]),
                                   jnp.asarray(chunks[v]),
                                   jnp.asarray(rsel[v]), jnp.asarray(idx[v]),
                                   jnp.asarray(mask[v]), interpret=True)
        np.testing.assert_array_equal(got[v], np.asarray(want))
    np.testing.assert_array_equal(got[:, 0], recv[np.arange(K), rsel[:, 0]])


def test_gather16_is_the_word_gather_on_lane_pairs():
    """XOR commutes with the split of a word into two lanes: the 16-bit
    gathers give the bits of the word gathers on the same buffers."""
    chunks, idx, mask, recv, rsel = _codec16_inputs(2, 6, 8, 4, 3, 17)
    c, r = _t(chunks), _t(recv)
    i, mk, s = _t(idx), _t(mask), _t(rsel)
    assert torch.equal(
        ref.xor_encode_gather16_ref(c, i, mk).view(torch.int32),
        ref.xor_encode_gather_ref(c.view(torch.int32), i, mk))
    assert torch.equal(
        ref.xor_decode_gather16_ref(r, c, s, i, mk).view(torch.int32),
        ref.xor_decode_gather_ref(r.view(torch.int32), c.view(torch.int32),
                                  s, i, mk))


# --------------------------------------------------------------------- #
# the 16-bit body of csrc/xor_gather.cu (gather16_kernel), modelled in
# numpy over a byte-addressed memory: a warp at a time, the shuffle as a
# roll over its 32 lanes. Garbage bytes fill the memory around the
# tensors, so a byte read from outside its row would show in the output.
# --------------------------------------------------------------------- #
G16_THREADS, G16_UNITS = 256, 4        # kThreads, kUnits of the kernel
G16_TILE = G16_THREADS * G16_UNITS
STEP_LANES = 18_547_542                # a bf16 packet row at the smoke cell


def _g16_window(a, b, delta):
    """``window``: bytes ``[delta, delta + 16)`` of ``a:b`` (u32 words
    ``[..., 4]`` each), cut as the kernel cuts them: the words from
    ``delta >> 2``, funnel-shifted right by ``8 * (delta & 3)`` bits."""
    w = np.concatenate([a, b], axis=-1).astype(np.uint64)
    q, sh = delta >> 2, np.uint64(8 * (delta & 3))
    return (((w[..., q + 1:q + 5] << np.uint64(32)) | w[..., q:q + 4])
            >> sh).astype(np.uint32)


class _G16Memory:
    """Bytes of one address space: tensors placed at chosen byte
    addresses, garbage elsewhere; 16-byte loads checked to hold a byte of
    the row they were issued for."""

    def __init__(self, size, rng):
        self.mem = rng.integers(0, 256, size=size, dtype=np.uint8)

    def put(self, addr, lanes16):
        raw = np.ascontiguousarray(lanes16).view(np.uint8).reshape(-1)
        self.mem[addr:addr + raw.size] = raw

    def get(self, addr, nbytes):
        return self.mem[addr:addr + nbytes]

    def load16(self, addrs, row, row_bytes):
        """``ldg16`` at 16-byte-aligned ``addrs`` (any shape)."""
        assert (addrs % 16 == 0).all()
        assert ((addrs + 16 > row) & (addrs < row + row_bytes)).all()
        words = self.mem.view(np.uint32)
        return words[(addrs // 4)[..., None] + np.arange(4)]

    def store16(self, addrs, vals):
        words = self.mem.view(np.uint32)
        words[(addrs // 4)[..., None] + np.arange(4)] = vals


def _g16_row(memory, srcs, orow, row_bytes, kalign, seen):
    """One output row of ``gather16_kernel``: every block of the row's
    tiles, each warp's kUnits units a lane, ``srcs`` the compacted valid
    source rows (byte addresses, recv first)."""
    head = min((16 - orow % 16) % 16, row_bytes)
    nunits = (row_bytes - head) // 16
    assert head % kalign == 0 and 16 * nunits + head <= row_bytes
    seen.update((orow % 16, src % 16) for src in srcs)
    lane = np.arange(32)
    for tile in range(max(1, -(-(row_bytes // 16) // G16_TILE))):
        for warp in range(G16_THREADS // 32):
            u0 = tile * G16_TILE + warp * 32 * G16_UNITS + lane
            units = u0 + 32 * np.arange(G16_UNITS)[:, None]     # [k, lane]
            valid = units < nunits
            if not valid.any():
                continue
            # the unit whose next aligned vector no neighbour lane loads
            last = valid & ((units + 1 == nunits)
                            | ((lane == 31)
                               & (np.arange(G16_UNITS) == G16_UNITS - 1)
                               [:, None]))
            assert (last.sum(0) <= 1).all()
            acc = np.zeros(units.shape + (4,), np.uint32)
            for src in srcs:
                delta = (src - orow) % 16
                assert delta % kalign == 0
                a = src + head - delta
                v = np.where(valid[..., None],
                             memory.load16(a + 16 * np.where(valid, units, 0),
                                           src, row_bytes), 0)
                if delta == 0:
                    acc ^= v
                    continue
                send = v.copy()                  # lane 0 sends unit k+1
                send[:-1, 0] = v[1:, 0]
                nxt = np.roll(send, -1, axis=1)  # lane L reads lane L+1
                ex = memory.load16(a + 16 * (units[last] + 1), src,
                                   row_bytes)
                nxt[last] = ex
                acc ^= _g16_window(v, nxt, delta)
            memory.store16(orow + head + 16 * units[valid], acc[valid])
    # head and tail lanes, one u16 each
    for b in [*range(0, head, 2), *range(head + 16 * nunits, row_bytes, 2)]:
        x = np.uint16(0)
        for src in srcs:
            x ^= memory.get(src + b, 2).view(np.uint16)[0]
        memory.put(orow + b, np.array([x], np.uint16))


def _g16_model(chunks, idx, mask, recv=None, rsel=None, *, starts, seen):
    """``gather16_kernel`` over the model memory: ``chunks``, ``recv`` and
    the output placed ``starts`` lanes past a 16-byte boundary each; the
    instantiation as the wrapper picks it from the base pointers."""
    K, P, lanes = chunks.shape
    n = idx.shape[1]
    rb = 2 * lanes
    tensors = [("chunks", K * P * rb), ("out", K * n * rb)]
    if recv is not None:
        tensors.append(("recv", recv.shape[0] * recv.shape[1] * rb))
    base, at = 64, {}
    for name, size in tensors:
        at[name] = base + 2 * starts[name]
        base = -(-(at[name] + size + 48) // 16) * 16
    memory = _G16Memory(base + 64, np.random.default_rng(len(seen) + base))
    memory.put(at["chunks"], chunks)
    if recv is not None:
        memory.put(at["recv"], recv)
    kalign = 2 * _vec_model(lanes, [at[name] for name, _ in tensors])
    for v in range(K):
        for i in range(n):
            srcs = [] if recv is None else [
                at["recv"] + (v * recv.shape[1] + int(rsel[v, i])) * rb]
            srcs += [at["chunks"] + (v * P + int(idx[v, i, j])) * rb
                     for j in range(idx.shape[2]) if mask[v, i, j]]
            _g16_row(memory, srcs, at["out"] + (v * n + i) * rb, rb, kalign,
                     seen)
    return memory.get(at["out"], K * n * rb).view(np.uint16).reshape(
        K, n, lanes)


def _vec_model(lanes, addrs):
    """The wrapper's pick (``xor_code._vec`` over ``_HALF_LANE``'s widths)
    for tensors at byte addresses ``addrs``."""
    return xor_code._vec(lanes, xor_code._HALF_LANE[1],
                         *(_AtAddress(a) for a in addrs))


class _AtAddress:
    """A stand-in tensor: 16-bit elements at a given byte address."""

    def __init__(self, addr):
        self.addr = addr

    def element_size(self):
        return 2

    def data_ptr(self):
        return self.addr


G16_LANES = [2, 6, 1002, 2004, 4094, 4096]


def _g16_cases(lanes, decode):
    """Every pair of start offsets (0-7 lanes past a 16-byte boundary) of
    the chunks and the output (recv at a third), at one row length."""
    K, P, n, m = 2, 8, 6, 3
    rng = np.random.default_rng(lanes + decode)
    chunks = rng.integers(0, 2**16, size=(K, P, lanes), dtype=np.uint16)
    chunks.reshape(-1)[:len(SPECIAL16)] = SPECIAL16[:chunks.size]
    idx = rng.integers(0, P, size=(K, n, m)).astype(np.int32)
    mask = rng.integers(0, 2, size=(K, n, m)).astype(bool)
    mask[:, 0] = False                       # a row with no valid source
    mask[:, 1] = True                        # and one with every source
    idx[~mask] = 0
    recv = rng.integers(0, 2**16, size=(K, n, lanes), dtype=np.uint16)
    rsel = np.stack([rng.permutation(n) for _ in range(K)]).astype(np.int32)
    for cs in range(8):
        for os_ in range(8):
            yield (chunks, idx, mask, recv, rsel,
                   dict(chunks=cs, out=os_, recv=(3 * cs + os_) % 8))


@pytest.mark.parametrize("lanes", G16_LANES)
def test_gather16_body_model_encodes_at_every_phase(lanes):
    """The 16-bit body's index arithmetic (16-byte output units from the
    row's first boundary, head and tail lanes, each source's delta, the
    neighbour-lane shuffle, the loads of the units no neighbour holds) is
    the plain encode bit for bit, at every pair of output and source
    16-byte phase."""
    seen = set()
    for chunks, idx, mask, _, _, starts in _g16_cases(lanes, False):
        got = _g16_model(chunks, idx, mask, starts=starts, seen=seen)
        want = ref.xor_encode_gather16_ref(_t(chunks), _t(idx), _t(mask))
        np.testing.assert_array_equal(got, want.numpy().view(np.uint16))
    assert seen == {(o, s) for o in range(0, 16, 2) for s in range(0, 16, 2)}


@pytest.mark.parametrize("lanes", G16_LANES)
def test_gather16_body_model_decodes_at_every_phase(lanes):
    """As the encode case, with the recv row as one more source (at its
    own phase)."""
    seen = set()
    for chunks, idx, mask, recv, rsel, starts in _g16_cases(lanes, True):
        got = _g16_model(chunks, idx, mask, recv, rsel, starts=starts,
                         seen=seen)
        want = ref.xor_decode_gather16_ref(_t(recv), _t(chunks), _t(rsel),
                                           _t(idx), _t(mask))
        np.testing.assert_array_equal(got, want.numpy().view(np.uint16))
    assert seen == {(o, s) for o in range(0, 16, 2) for s in range(0, 16, 2)}


def test_step_rows_take_the_four_byte_body():
    """The training step's 16-bit rows (18,547,542 lanes, 12 mod 16 bytes,
    bases from the allocator) take the body's 4-byte instantiation, with
    every source's delta and every head a multiple of 4 bytes; a tensor
    one lane off its buffer takes the 2-byte one."""
    assert (2 * STEP_LANES) % 16 == 12
    flat = torch.empty(2 * 3 * STEP_LANES + 1, dtype=torch.int16)
    rows = flat[:-1].view(2, 3, STEP_LANES)
    off = flat[1:].view(2, 3, STEP_LANES)
    assert rows.data_ptr() % 4 == 0
    assert xor_code._vec(STEP_LANES, xor_code._HALF_LANE[1], rows, rows) == 2
    assert xor_code._vec(STEP_LANES, xor_code._HALF_LANE[1], rows, off) == 1
    rb = 2 * STEP_LANES
    phases = {(p * rb) % 16 for p in range(48)}
    assert phases == {0, 4, 8, 12}
    for o in phases:
        head = (16 - o) % 16
        assert head % 4 == 0 and (rb - head) // 16 * 16 + head <= rb
        assert {(s - o) % 16 for s in phases} == {0, 4, 8, 12}


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


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _ordered16(bits):
    """u16 bf16 patterns -> integers in value order (+0 and -0 both 0),
    so neighbouring bf16 values differ by one."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b & 0x7FFF)


@pytest.mark.parametrize("n,d,S", [(6, 64, 4), (4, 37, 4)])
def test_aggregate_bf16_plain_matches_pallas_one_row_per_segment(n, d, S):
    vals, ids = _agg_inputs(n, d, S, 3 * n + d, one_per_segment=True)
    vals = _bf16(vals)
    got = ref.aggregate_ref(_t(vals.view(np.uint16)).view(torch.bfloat16),
                            _t(ids), S)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_aggregate(jnp.asarray(vals), jnp.asarray(ids), S,
                                    interpret=True))
    assert want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("n,d,S", [(16, 8, 4), (33, 64, 5)])
def test_aggregate_bf16_plain_within_one_ulp_of_pallas(n, d, S):
    """Several rows per segment: both sum in f32 and round once, in other
    orders, so a result may land on the neighbouring bf16 value."""
    vals, ids = _agg_inputs(n, d, S, 11 * n + d, one_per_segment=False)
    vals = _bf16(vals)
    got = ref.aggregate_ref(_t(vals.view(np.uint16)).view(torch.bfloat16),
                            _t(ids), S).view(torch.int16).numpy()
    want = np.asarray(jax_aggregate(jnp.asarray(vals), jnp.asarray(ids), S,
                                    interpret=True))
    diff = np.abs(_ordered16(got.view(np.uint16))
                  - _ordered16(want.view(np.uint16)))
    assert diff.max() <= 1, diff.max()


def test_nan_rounding_to_bf16_differs_from_ml_dtypes():
    """Pinned difference (ROADMAP.md, Queue 3): an f32 NaN rounds to the
    bf16 NaN 0xFFFF in torch and to 0x7FC0 / 0xFFC0 in ml_dtypes (the JAX
    trainer's memo cast); finite values round to the same bits. So the
    bf16 memo differs from JAX only for NaN gradients."""
    f = np.array([0x7FC00000, 0x7FC00001, 0x7F800001, 0xFFC00000],
                 np.uint32).view(np.float32)
    got = torch.from_numpy(f).bfloat16().view(torch.int16).numpy()
    assert (got.view(np.uint16) == 0xFFFF).all()
    with np.errstate(invalid="ignore"):
        jax_bits = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert list(jax_bits) == [0x7FC0, 0x7FC0, 0x7FC0, 0xFFC0]
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32)
    x[:4] = [0.0, -0.0, 1e-40, 3.4e38]
    np.testing.assert_array_equal(
        torch.from_numpy(x).bfloat16().view(torch.int16).numpy()
        .view(np.uint16), x.astype(ml_dtypes.bfloat16).view(np.uint16))


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
    chunks, idx, mask, recv, rsel = _codec16_inputs(2, 5, 6, 3, 3, 12)
    c, i, m_, r, s = (_t(a) for a in (chunks, idx, mask, recv, rsel))
    assert torch.equal(xor_encode_gather16(c, i, m_),
                       ref.xor_encode_gather16_ref(c, i, m_))
    enc_u = xor_encode_gather16(c.view(torch.uint16), i, m_)
    assert enc_u.dtype == torch.uint16
    assert torch.equal(xor_decode_gather16(r, c, s, i, m_),
                       ref.xor_decode_gather16_ref(r, c, s, i, m_))
    vb = _t(vals).bfloat16()
    outb = torch.empty((3, 12), dtype=torch.bfloat16)
    assert aggregate_bf16(vb, _t(ids), 3, out=outb) is outb
    assert torch.equal(outb, ref.aggregate_ref(vb, _t(ids), 3))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert list(KERNELS) == ["xor_encode_gather", "xor_decode_gather",
                             "aggregate", "xor_encode_gather16",
                             "xor_decode_gather16", "aggregate_bf16",
                             "xor_fold", "xor_decode", "xor_encode",
                             "flash_attention", "ssd_scan"]


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
    c16 = torch.zeros((2, 4, 8), dtype=torch.int16)
    with pytest.raises(TypeError):
        xor_encode_gather16(c, i, m)                 # 32-bit words
    with pytest.raises(ValueError, match="even"):
        xor_encode_gather16(c16[..., :7], i, m)
    with pytest.raises(ValueError, match="even"):
        ref.xor_decode_gather16_ref(c16[..., :7], c16[..., :7],
                                    torch.zeros((2, 3), dtype=torch.int32),
                                    i, m)
    with pytest.raises(ValueError):
        xor_decode_gather16(c16[..., :6], c16,
                            torch.zeros((2, 3), dtype=torch.int32), i, m)
    with pytest.raises(TypeError):
        aggregate_bf16(torch.zeros((3, 4)), torch.zeros(3, dtype=torch.int32),
                       2)


# --------------------------------------------------------------------- #
# the dense folds of the multipass codec (xor_fold / xor_decode /
# xor_encode): ragged n (1, 2 and 3 mod 4 words, and whole blocks), m
# from 1 to 4, masks mixed, with whole rows off
# --------------------------------------------------------------------- #
FOLD_SHAPES = [(3, 1, 5), (2, 2, 130), (4, 3, 1027), (1, 4, 7), (5, 3, 1024)]


def _fold_inputs(R, m, n, seed):
    rng = np.random.default_rng(seed)
    packets = rng.integers(0, 2**32, size=(R, m, n), dtype=np.uint32)
    packets.reshape(-1)[:len(SPECIAL)] = SPECIAL[:packets.size]
    recv = rng.integers(0, 2**32, size=(R, n), dtype=np.uint32)
    mask = rng.integers(0, 2, size=(R, m)).astype(bool)
    mask[0] = False                          # a row with every packet off
    if R > 1:
        mask[-1] = True                      # and one with every packet on
    return packets, recv, mask


@pytest.mark.parametrize("R,m,n", FOLD_SHAPES)
def test_fold_plain_matches_pallas(R, m, n):
    packets, _, _ = _fold_inputs(R, m, n, 31 * R + n)
    got = ref.xor_fold_ref(_t(packets))
    assert got.shape == (R, n) and got.dtype == torch.int32
    want = jax_fold(jnp.asarray(packets), interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("R,m,n", FOLD_SHAPES)
def test_decode_plain_matches_pallas(R, m, n):
    packets, recv, mask = _fold_inputs(R, m, n, 37 * R + n)
    got = ref.xor_decode_ref(_t(recv), _t(packets), _t(mask)).numpy()
    want = jax_decode(jnp.asarray(recv), jnp.asarray(packets),
                      jnp.asarray(mask), interpret=True)
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want))
    np.testing.assert_array_equal(got[0].view(np.uint32), recv[0])


@pytest.mark.parametrize("m,n", [(1, 5), (2, 130), (3, 1027), (4, 7)])
def test_encode_plain_matches_pallas(m, n):
    packets, _, _ = _fold_inputs(1, m, n, 41 * m + n)
    got = ref.xor_encode_ref(_t(packets[0]))
    assert got.shape == (n,)
    want = jax_encode(jnp.asarray(packets[0]), interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    # the ops dispatch of both packages (the Algorithm-2 Δ encoder)
    np.testing.assert_array_equal(
        ops.xor_fold(_t(packets[0])).numpy().view(np.uint32),
        np.asarray(jax_ops.xor_fold(jnp.asarray(packets[0]),
                                    use_pallas=True)))


def test_fold_is_the_masked_gather_fold_of_a_dense_table():
    """The multipass folds and the fused gathers compute one function: a
    gather whose sources are every row of a dense table is the fold."""
    packets, recv, mask = _fold_inputs(4, 3, 9, 43)
    p = _t(packets)
    idx = torch.arange(12, dtype=torch.int32).view(1, 4, 3)
    flat = p.view(1, 12, 9)
    assert torch.equal(ref.xor_fold_ref(p)[None],
                       ref.xor_encode_gather_ref(flat, idx,
                                                 torch.ones_like(idx).bool()))
    rsel = torch.arange(4, dtype=torch.int32)[None]
    assert torch.equal(
        ref.xor_decode_ref(_t(recv), p, _t(mask))[None],
        ref.xor_decode_gather_ref(_t(recv)[None], flat, rsel, idx,
                                  _t(mask)[None]))


def test_fold_wrappers_take_plain_version_on_cpu():
    packets, recv, mask = _fold_inputs(3, 3, 11, 47)
    p, r, mk = _t(packets), _t(recv), _t(mask)
    reset_launch_counts()
    assert torch.equal(xor_fold(p), ref.xor_fold_ref(p))
    fold_u = xor_fold(p.view(torch.uint32))     # uint32 in, uint32 out
    assert fold_u.dtype == torch.uint32
    assert torch.equal(fold_u.view(torch.int32), ref.xor_fold_ref(p))
    assert torch.equal(xor_decode(r, p, mk), ref.xor_decode_ref(r, p, mk))
    assert torch.equal(xor_encode(p[0]), ref.xor_encode_ref(p[0]))
    assert torch.equal(ops.xor_fold(p[1]), ref.xor_encode_ref(p[1]))
    vals, ids = _agg_inputs(5, 12, 3, 2, one_per_segment=False)
    assert torch.equal(ops.combine_aggregates(_t(vals), _t(ids), 3),
                       ref.aggregate_ref(_t(vals), _t(ids), 3))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_fold_wrappers_reject_bad_inputs():
    p = torch.zeros((2, 3, 8), dtype=torch.int32)
    r = torch.zeros((2, 8), dtype=torch.int32)
    m = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(TypeError):
        xor_fold(p.float())
    with pytest.raises(ValueError):
        xor_fold(p[0])                               # not [R, m, n]
    with pytest.raises(ValueError, match="at least one packet"):
        xor_fold(p[:, :0])
    with pytest.raises(ValueError, match="recv shape"):
        xor_decode(r[:, :7], p, m)
    with pytest.raises(ValueError, match="mask"):
        xor_decode(r, p, m[:, :2])
    with pytest.raises(ValueError, match="mask"):
        xor_decode(r, p, m.int())
    with pytest.raises(TypeError):
        xor_decode(r.float(), p, m)
    with pytest.raises(ValueError):
        xor_encode(p)                                # not [m, n]
    with pytest.raises(ValueError, match="at least one packet"):
        xor_encode(p[0, :0])
