"""The port's SSM family (Mamba2) against the JAX package, on the CPU: the
plain ``ssd_chunked`` / ``ssd_scan_ref`` (the ``ssd_scan`` kernel's plain
version and the oracle) against the Pallas ``ssd_scan`` in interpret mode
and against ``repro.kernels.ref``; the wrapper's checks and the routing
of ``ops.ssd``; ``ssm_block``, ``lm.prefill`` and ``lm.decode_step`` of
the reduced ``mamba2_1p3b`` against JAX's; and inside the port the
twins of ``tests/test_serve.py``'s mamba cases.

Both packages start from the same parameters (``repro.models.lm.
init_params`` exported through ``repro_torch.weights.params_from_jax``)
and the same numpy inputs.

Tolerances, and why:

* the SSD scans 2e-4 (rtol and atol), that of ``tests/test_kernels.py``:
  the chunked form sums the recurrence in another order than the
  sequential one (and XLA and PyTorch sum each product in their own
  order); chunk invariance 2e-5, as ``test_ssd_scan_chunk_invariance``;
* ``ssm_block`` and the logits 1e-4, as ``test_torch_serve.py``: the same
  f32 math summed in other orders by XLA and by PyTorch's CPU kernels;
* greedy tokens of the engine bitwise the port's ``generate`` (a decode
  step runs at one fixed width, so a row's bits do not depend on the
  batch); the softplus within 4 f32 ulps of JAX's (the two libraries
  approximate exp and log1p each their own way).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import KERNELS, launch_counts, ops, ssd_scan
from repro_torch.kernels.ref import ssd_chunked, ssd_scan_ref
from repro_torch.kernels.ssd_scan import CHUNK
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, lm
from repro_torch.runtime.serve import (DecodeEngine, Request, ServeStream,
                                       WaveCrashError, generate,
                                       serve_legacy)
from repro_torch.weights import params_from_jax

from chip_smoke_module import chip_smoke

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_kernels.py's SSD_CASES: B, T, H, P, S, chunk
SSD_CASES = [
    (1, 32, 2, 8, 4, 8),
    (2, 64, 1, 16, 8, 16),
    (1, 100, 2, 8, 4, 32),   # non-divisible T
    (1, 16, 3, 4, 16, 16),   # chunk == T
]


def _ssd_inputs(B, T, H, P, S, *, shared, seed):
    """x, a, b, c as numpy f32, as tests/test_kernels.py draws them;
    ``shared``: b and c group-shared ``[B, T, S]``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, T, H))) * 0.1).astype(np.float32)
    bs = (B, T, S) if shared else (B, T, H, S)
    b = rng.standard_normal(bs).astype(np.float32) * 0.5
    c = rng.standard_normal(bs).astype(np.float32) * 0.5
    return x, a, b, c


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _heads(b, H):
    return np.broadcast_to(b[:, :, None], (*b.shape[:2], H, b.shape[-1]))


# --------------------------------------------------------------------- #
# the scan: plain versions against the Pallas kernel and JAX's refs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,T,H,P,S,chunk", SSD_CASES)
@pytest.mark.parametrize("shared", [False, True])
def test_plain_ssd_matches_pallas_interpret(B, T, H, P, S, chunk, shared):
    """The plain chunked scan (at the case's chunk and at the kernel's 64)
    and the sequential oracle against the Pallas kernel in interpret mode
    and JAX's sequential oracle; group-shared b/c against JAX's chunked
    XLA lane too."""
    x, a, b, c = _ssd_inputs(B, T, H, P, S, shared=shared, seed=T + P)
    bh, ch = (_heads(b, H), _heads(c, H)) if shared else (b, c)
    jx = [jnp.asarray(v) for v in (x, a, bh, ch)]
    want = np.asarray(pallas_ssd(*jx, chunk=chunk))
    oracle = np.asarray(jref.ssd_scan_ref(*jx))
    tx, ta, tb, tc = _t(x, a, b, c)
    for got in (ssd_chunked(tx, ta, tb, tc, chunk=chunk),
                ssd_chunked(tx, ta, tb, tc),
                ssd_scan_ref(tx, ta, tb, tc)):
        assert got.dtype == torch.float32 and got.shape == (B, T, H, P)
        np.testing.assert_allclose(got.numpy(), want, **SSD_TOL)
        np.testing.assert_allclose(got.numpy(), oracle, **SSD_TOL)
    if shared:
        xla = np.asarray(jref.ssd_chunked(*(jnp.asarray(v)
                                            for v in (x, a, b, c)),
                                          chunk=chunk))
        np.testing.assert_allclose(
            ssd_chunked(tx, ta, tb, tc, chunk=chunk).numpy(), xla, **SSD_TOL)


def test_plain_ssd_chunk_invariance():
    """As ``tests/test_kernels.py::test_ssd_scan_chunk_invariance``, on the
    plain chunked scan, at a length no chunk divides."""
    x, a, b, c = _t(*_ssd_inputs(1, 100, 2, 8, 4, shared=False, seed=5))
    outs = [ssd_chunked(x, a, b, c, chunk=ch).numpy()
            for ch in (8, 16, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, rtol=2e-5, atol=2e-5)


def test_plain_ssd_never_overflows_past_the_diagonal():
    """Strong decay (a = -60 a step): ``exp(cum_t - cum_s)`` for s > t
    would be inf; the plain version masks the exponent, so the output
    stays finite and equals the oracle's."""
    x, a, b, c = _t(*_ssd_inputs(1, 40, 2, 4, 4, shared=True, seed=9))
    a = torch.full_like(a, -60.0)
    got = ssd_chunked(x, a, b, c, chunk=32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ssd_scan_ref(x, a, b, c).numpy(),
                               **SSD_TOL)


def test_plain_ssd_bf16_keeps_dtype():
    x, a, b, c = _t(*_ssd_inputs(1, 70, 2, 8, 16, shared=True, seed=3))
    xb, bb, cb = (v.bfloat16() for v in (x, b, c))
    got = ssd_chunked(xb, a, bb, cb)
    want = ssd_chunked(xb.float(), a, bb.float(), cb.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


# --------------------------------------------------------------------- #
# the wrapper and ops.ssd on the CPU
# --------------------------------------------------------------------- #
def test_ops_ssd_takes_the_plain_version_on_cpu():
    x, a, b, c = _t(*_ssd_inputs(1, 77, 2, 8, 16, shared=True, seed=4))
    before = launch_counts()
    got = ops.ssd(x, a, b, c)
    assert torch.equal(got, ssd_chunked(x, a, b, c, chunk=64))
    assert launch_counts() == before and ssd_scan.launches == before[
        "ssd_scan"]
    assert KERNELS["ssd_scan"] is ssd_scan and len(KERNELS) == 11
    # per-head b/c take the same route
    H = x.shape[2]
    bh, ch = (v[:, :, None].expand(-1, -1, H, -1) for v in (b, c))
    torch.testing.assert_close(ops.ssd(x, a, bh, ch), got, rtol=0, atol=0)


def test_ssd_wrapper_checks_raise():
    x, a, b, c = _t(*_ssd_inputs(1, 8, 2, 4, 4, shared=True, seed=0))
    with pytest.raises(ValueError):
        ssd_scan(x[0], a, b, c)                       # x not 4-d
    with pytest.raises(ValueError):
        ssd_scan(x, a[:, :4], b, c)                   # a's length
    with pytest.raises(ValueError):
        ssd_scan(x, a, b, c[..., :2])                 # b, c differ
    with pytest.raises(ValueError):
        ssd_scan(x, a, torch.zeros(1, 8, 3, 4), torch.zeros(1, 8, 3, 4))
    with pytest.raises(TypeError):
        ssd_scan(x.half(), a, b.half(), c.half())     # f16
    with pytest.raises(TypeError):
        ssd_scan(x, a.bfloat16(), b, c)               # a must be f32
    with pytest.raises(TypeError):
        ssd_scan(x, a, b.bfloat16(), c)               # mixed dtypes
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x.requires_grad_(), a, b, c)
    # meta takes the cost twin (no launch); any other device is refused
    y = ssd_scan(*(v.to("meta") for v in (x.detach(), a, b, c)))
    assert y.device.type == "meta" and y.shape == x.shape
    with pytest.raises(RuntimeError, match="CPU"):
        ssd_scan(*(v.detach().as_subclass(_Elsewhere) for v in (x, a, b, c)))
    assert ssd_scan.launches == 0


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device the kernel wrappers do not
    take."""
    @property
    def device(self):
        return torch.device("xpu")


def test_ssd_aligned_pads_with_zeros_and_keeps_values():
    """The bf16 body's TMA maps need 16-byte-aligned bases and strides: the
    wrapper passes an aligned tensor through and copies any other into a
    buffer whose last axis is zero-padded to 16 bytes, seen through a view
    with the same values."""
    from repro_torch.kernels.ssd_scan import _aligned
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, 3, 12)).astype(np.float32)).bfloat16()
    ok = torch.zeros((2, 5, 3, 16), dtype=torch.bfloat16)
    assert _aligned(ok) is ok and _aligned(ok[..., :8]) is not ok
    for t in (x, x[..., 4:], x[..., :5], x.transpose(1, 2)):
        got = _aligned(t)
        assert torch.equal(got, t) and got.stride(-1) == 1
        assert all(s * 2 % 16 == 0 for s in got.stride()[:-1])
        width = got.stride(-2)
        full = got.as_strided((*got.shape[:-1], width), got.stride())
        assert width % 8 == 0 and not full[..., t.shape[-1]:].any()


def _parts(v, n):
    """v as the sum of n bf16 parts, each the leading 8 significant bits
    of what the parts before it left (the kernel's truncating split)."""
    out, rest = torch.zeros_like(v), v
    for _ in range(n):
        part = (rest.view(torch.int32) & -65536).view(torch.float32)
        out, rest = out + part, rest - part
    return out


def _tc_model(x, a, b, c, parts):
    """The arithmetic of the bf16 ``ssd_scan`` body on the CPU, for
    group-shared b/c: chunks of 64; c, b and x exact bf16 operands;
    ``G = c b^T``, ``c h``, ``M x`` and ``b^T (w x)`` summed in f32; M, h
    and ``w x`` (f32 values) as ``parts`` bf16 parts; y rounded once."""
    B, T, H, P = x.shape
    xf, bf, cf = x.float(), b.float(), c.float()
    h = torch.zeros((B, H, b.shape[-1], P))
    ys = []
    for t0 in range(0, T, CHUNK):
        xc, bc, cc = (v[:, t0:t0 + CHUNK] for v in (xf, bf, cf))
        C = xc.shape[1]
        cum = torch.cumsum(a[:, t0:t0 + CHUNK], dim=1)          # [B, C, H]
        tri = torch.ones((C, C), dtype=torch.bool).tril()[None, :, :, None]
        expo = torch.where(tri, cum[:, :, None] - cum[:, None], -torch.inf)
        g = torch.einsum("bts,bus->btu", cc, bc)
        m = _parts(g[..., None] * torch.exp(expo), parts)      # [B, C, C, H]
        ys.append(torch.exp(cum)[..., None]
                  * torch.einsum("bts,bhsp->bthp", cc, _parts(h, parts))
                  + torch.einsum("btuh,buhp->bthp", m, xc))
        w = torch.exp(cum[:, -1:] - cum)
        wx = _parts(w[..., None] * xc, parts)
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + torch.einsum("bus,buhp->bhsp", bc, wx))
    return torch.cat(ys, dim=1).bfloat16()


def _share(got, want, rtol, atol):
    """The worst element's share of its limit ``atol + rtol |want|``."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def test_ssd_precision_plan_holds_the_serving_limit():
    """The bf16 body's precision plan, modelled on the CPU: M, h and w x in
    three bf16 parts (all 24 bits of the f32 values) hold the chip smoke's
    serving limit (64 heads of P 64, S 128, T 256, group-shared b/c, the
    model's decay ``-softplus(.)``) and the card tests' bf16 limit (rtol
    2**-6, atol 1e-4) at their mamba2 1024-token case. One part (8 bits)
    misses the serving limit; two parts (16 bits) miss the card tests'."""
    smoke = chip_smoke()
    rtol, rel = smoke.SSD_SERVE_RTOL, 2 * smoke.SSD_F32_REL
    B, T, H, P, S = 1, 256, 64, 64, 128
    rng = np.random.default_rng(0)
    x, b, c = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .bfloat16() for sh in ((B, T, H, P), (B, T, S), (B, T, S)))
    a = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, T, H)).astype(np.float32)))
    want = ssd_chunked(x, a, b, c)
    atol = rel * float(ssd_chunked(*(v.double() for v in (x, a, b, c)))
                       .abs().max())
    assert _share(_tc_model(x, a, b, c, 3), want, rtol, atol) <= 1
    assert _share(_tc_model(x, a, b, c, 1), want, rtol, atol) > 1
    # tests/test_torch_cuda.py's inputs at (1, 1024, 64, 64, 128), chunk 64
    B, T = 1, 1024
    rng = np.random.default_rng(T * 7 + S)
    x, b, c = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .bfloat16() for sh in ((B, T, H, P), (B, T, S), (B, T, S)))
    a = torch.from_numpy(-np.abs(rng.standard_normal((B, T, H))).astype(
        np.float32) * 0.5)
    want = ssd_chunked(x, a, b, c)
    assert _share(_tc_model(x, a, b, c, 3), want, 2 ** -6, 1e-4) <= 1
    assert _share(_tc_model(x, a, b, c, 2), want, 2 ** -6, 1e-4) > 1


def _split_model(x, a, b, c):
    """The split evaluation of the f32 ``ssd_scan`` body on the CPU, in
    f32: first the state entering every chunk (the recurrence kernel:
    ``h <- exp(cum_end) h + b^T (w x)``, the last chunk's update not run),
    then each chunk's outputs from the state entering it alone (the output
    kernel: ``y = exp(cum_t) (c h_in) + M x``). Per-head or group-shared
    b/c; chunks of 64, the last one ragged. Its products are ``einsum``s,
    whose sums run in BLAS's order, not the kernels' in-order FMA chains:
    this models the split, not the order of each sum."""
    B, T, H, P = x.shape
    if b.dim() == 3:
        b, c = (v[:, :, None].expand(-1, -1, H, -1) for v in (b, c))
    starts = range(0, T, CHUNK)
    cums = [torch.cumsum(a[:, t0:t0 + CHUNK], dim=1) for t0 in starts]
    h = torch.zeros((B, H, b.shape[-1], P))
    h_in = []
    for t0, cum in zip(starts, cums):
        h_in.append(h)
        xc, bc = x[:, t0:t0 + CHUNK], b[:, t0:t0 + CHUNK]
        wx = torch.exp(cum[:, -1:] - cum)[..., None] * xc
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + torch.einsum("buhs,buhp->bhsp", bc, wx))
    ys = []
    for t0, cum, hc in zip(starts, cums, h_in):
        xc, bc, cc = (v[:, t0:t0 + CHUNK] for v in (x, b, c))
        C = xc.shape[1]
        tri = torch.ones((C, C), dtype=torch.bool).tril()[None, :, :, None]
        expo = torch.where(tri, cum[:, :, None] - cum[:, None], -torch.inf)
        m = torch.einsum("bths,buhs->btuh", cc, bc) * torch.exp(expo)
        ys.append(torch.exp(cum)[..., None]
                  * torch.einsum("bths,bhsp->bthp", cc, hc)
                  + torch.einsum("btuh,buhp->bthp", m, xc))
    return torch.cat(ys, dim=1)


@pytest.mark.parametrize("B,T,H,P,S,chunk", SSD_CASES)
@pytest.mark.parametrize("shared", [False, True])
def test_ssd_split_order_matches_jax(B, T, H, P, S, chunk, shared):
    """The f32 body's split (states first, then outputs) against JAX's
    sequential oracle and the Pallas kernel in interpret mode, within the
    scans' 2e-4, with per-head and group-shared b/c."""
    x, a, b, c = _ssd_inputs(B, T, H, P, S, shared=shared, seed=T + P + 1)
    bh, ch = (_heads(b, H), _heads(c, H)) if shared else (b, c)
    jx = [jnp.asarray(v) for v in (x, a, bh, ch)]
    got = _split_model(*_t(x, a, b, c))
    assert got.dtype == torch.float32 and got.shape == (B, T, H, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.ssd_scan_ref(*jx)),
                               **SSD_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pallas_ssd(*jx, chunk=chunk)),
                               **SSD_TOL)


def test_ssd_split_order_holds_the_f64_limit():
    """At a reduced mamba2-like shape (4 heads of P 64, S 128, 277 steps:
    four whole chunks and a ragged tail, group-shared b/c, the model's
    decay ``-softplus(.)``) the f32 body's split is within the chip
    smoke's ``SSD_F32_REL`` x max|y| of an f64 evaluation, as the plain
    version is: the split itself keeps the f32 contract."""
    B, T, H, P, S = 1, 277, 4, 64, 128
    rng = np.random.default_rng(1)
    x, b, c = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((B, T, H, P), (B, T, S), (B, T, S)))
    a = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, T, H)).astype(np.float32)))
    exact = ssd_chunked(*(v.double() for v in (x, a, b, c)))
    limit = chip_smoke().SSD_F32_REL * float(exact.abs().max())
    for got in (_split_model(x, a, b, c), ssd_chunked(x, a, b, c)):
        assert float((got.double() - exact).abs().max()) <= limit


@pytest.mark.parametrize("T", [1, 64, 129, 1024])
def test_chip_smoke_ssd_bound_counts_the_needed_work(T):
    """The chip smoke's ``ssd_scan`` bound counts, step by step, the
    multiply-adds the function needs with group-shared b/c: c b^T once
    and M x per head over the pairs s <= t of a chunk, c h past the first
    chunk and the state update before the last, per head; its bytes are
    ``cost.ssd_scan``'s, and its FLOPs never exceed that count."""
    from repro_torch.kernels import cost
    B, H, P, S = 2, 3, 8, 16
    pairs = chained = updated = 0
    for t in range(T):
        pairs += t % CHUNK + 1
        chained += t >= CHUNK
        updated += t < (T - 1) // CHUNK * CHUNK
    want = 2 * B * (pairs * (S + H * P) + H * S * P * (chained + updated))
    flops, nbytes = chip_smoke()._ssd_work(B, T, H, P, S, itemsize=4)
    jax_flops, jax_bytes = cost.ssd_scan(B, T, H, P, S, 4, False)
    assert (flops, nbytes) == (want, jax_bytes) and flops <= jax_flops


def test_chip_smoke_counts_the_f32_serving_scans():
    """The chip smoke's f32 serving run (mamba2 at 4 layers, two requests)
    expects one ``ssd_scan`` launch per layer and prefill, all of them on
    the f32 body, and no attention launch; a bf16 run expects none on the
    f32 bodies."""
    smoke = chip_smoke()
    run = smoke.SERVE_F32_RUN
    cfg = get_config(run["arch"]).replace(n_layers=run["n_layers"],
                                          dtype=run["dtype"])
    assert smoke.serve_kernels(cfg, len(run["lens"])) == {
        "flash_attention": 0, "ssd_scan": 8, "flash_attention_f32": 0,
        "ssd_scan_f32": 8}
    bf16 = smoke.serve_kernels(get_config("zamba2_2p7b"), 8)
    assert bf16["ssd_scan_f32"] == bf16["flash_attention_f32"] == 0
    assert bf16["ssd_scan"] == 360 and bf16["flash_attention"] == 72


# --------------------------------------------------------------------- #
# the model against JAX
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mamba_pair():
    jcfg = jax_reduced(jax_get_config("mamba2_1p3b"))
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("mamba2_1p3b"))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def mamba(mamba_pair):
    return mamba_pair[2], mamba_pair[3]


def test_mamba2_config_matches_jax():
    """The port's config (full and reduced) field by field against the
    JAX package's (``ssm_chunk`` is an XLA knob the port has none of:
    the chunk is the kernel's constant, 64)."""
    assert "mamba2_1p3b" in ARCHS
    for want, got in ((jax_get_config("mamba2_1p3b"),
                       get_config("mamba2_1p3b")),
                      (jax_reduced(jax_get_config("mamba2_1p3b")),
                       reduced(get_config("mamba2_1p3b")))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim", "pattern",
                  "ssm_state", "ssm_heads", "ssm_d_inner", "tie_embeddings",
                  "scale_embed", "dtype", "loss_chunk", "vocab_padded",
                  "microbatches", "grad_sync_dtype",
                  "repeats"):
            assert getattr(got, f) == getattr(want, f), f
        assert want.ssm_chunk == CHUNK
    full = get_config("mamba2_1p3b")
    assert (full.n_layers, full.d_model, full.ssm_d_inner // full.ssm_heads,
            full.vocab_padded) == (48, 2048, 64, 50304)


def test_softplus_matches_jax():
    """JAX's formula (``max(x, 0) + log1p(exp(-|x|))``) at every input:
    within 4 f32 ulps of ``jax.nn.softplus`` (XLA and PyTorch's CPU
    kernels approximate exp and log1p each their own way; outputs stay
    normal numbers, as XLA on the CPU flushes denormals), and ``x``
    itself from 20 up, where ``torch.nn.functional.softplus`` switches."""
    xs = np.concatenate([np.linspace(-40, 40, 8001),
                         np.random.default_rng(0).standard_normal(5000) * 8,
                         [0.0, -0.0, 19.99, 20.0, 20.01, 88.0, -80.0]]
                        ).astype(np.float32)
    got = layers.softplus(torch.from_numpy(xs)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(xs)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 4
    big = xs >= 20
    assert np.array_equal(got[big], xs[big]) and np.array_equal(
        want[big], xs[big])


@pytest.mark.parametrize("T", [1, 9, 77])
def test_ssm_block_matches_jax(mamba_pair, T):
    """Prefill with ``return_state`` (the closed-form state) and a decode
    step from that state, layer 0 of the reduced mamba2."""
    jcfg, jp, cfg, p = mamba_pair
    jblk = jax.tree.map(lambda v: v[0], jp["blocks"]["0_ssm"]["ssm"])
    blk = {k: v[0] for k, v in p["blocks"]["0_ssm"]["ssm"].items()}
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jy, jst = jlayers.ssm_block(jblk, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = layers.ssm_block(blk, torch.from_numpy(x), cfg,
                               return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy1, jst1 = jlayers.ssm_block(jblk, jnp.asarray(x1), jcfg, state=jst)
    state = tst.clone()
    ty1, tst1 = layers.ssm_block(blk, torch.from_numpy(x1), cfg, state=state,
                                 rows=[T, T])
    assert tst1 is state
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), **TOL)
    np.testing.assert_allclose(tst1.numpy(), np.asarray(jst1), **TOL)


def test_prefill_and_decode_logits_match_jax(mamba_pair):
    """Contiguous cache: prefill then two decode steps; paged cache: two
    slots admitted from B=1 prefills (their state rows land bitwise),
    then decode steps with a finished (-1) row, which keeps its state
    (the JAX step updates every row: tokens are unaffected)."""
    jcfg, jp, cfg, p = mamba_pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jl, jc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         max_len=12)
    tl, tc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks)},
                        max_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i, col in ((9, toks[:, :1]), (10, toks[:, 1:2])):
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(col),
                                 jnp.int32(i))
        tl, tc = lm.decode_step(cfg, p, tc, torch.from_numpy(col), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in lm.slot_names(cfg):
        np.testing.assert_allclose(tc[name]["state"].numpy(),
                                   np.asarray(jc[name]["state"]), **TOL)

    pages = [np.array([1, 2, 3], np.int32), np.array([4, 5, 6], np.int32)]
    jpg = jlm.init_paged_cache(jcfg, 2, 7, 4, 3)
    tpg = lm.init_paged_cache(cfg, 2, 7, 4, 3, device="cpu")
    assert all(set(e) == {"state"} for e in tpg.values())
    for s, T in enumerate([5, 7]):
        pr = toks[s:s + 1, :T]
        _, jpc = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(pr)},
                             max_len=8)
        _, tpc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(pr)},
                            max_len=8)
        jpg = jlm.admit_prefill(jcfg, jpg, jpc, jnp.asarray(pages[s]),
                                jnp.int32(s))
        lm.admit_prefill(cfg, tpg, tpc, torch.from_numpy(pages[s]), s)
        for name in lm.slot_names(cfg):
            assert torch.equal(tpg[name]["state"][:, s],
                               tpc[name]["state"][:, 0])
    for name in lm.slot_names(cfg):
        np.testing.assert_allclose(tpg[name]["state"].numpy(),
                                   np.asarray(jpg[name]["state"]), **TOL)
    for step, ci in enumerate(([5, 7], [6, -1])):
        col = toks[:, step:step + 1]
        kept = {n: e["state"][:, 1].clone() for n, e in tpg.items()}
        jl, jpg = jlm.decode_step(jcfg, jp, jpg, jnp.asarray(col),
                                  jnp.asarray(ci, jnp.int32))
        tl, tpg = lm.decode_step(cfg, p, tpg, torch.from_numpy(col), ci)
        live = [b for b, i in enumerate(ci) if i >= 0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        for name in lm.slot_names(cfg):
            np.testing.assert_allclose(
                tpg[name]["state"][:, live].numpy(),
                np.asarray(jpg[name]["state"])[:, live], **TOL)
            if -1 in ci:
                assert torch.equal(tpg[name]["state"][:, 1], kept[name])


def test_prefill_matches_jax_with_the_pallas_kernel(mamba_pair):
    """The JAX prefill with ``use_pallas=True`` runs the Pallas
    ``ssd_scan`` in interpret mode inside the model (chunk 64, a ragged
    last chunk)."""
    jcfg, jp, cfg, p = mamba_pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 100)) \
        .astype(np.int32)
    jl, jc = jlm.prefill(jcfg.replace(use_pallas=True), jp,
                         {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in lm.slot_names(cfg):
        np.testing.assert_allclose(tc[name]["state"].numpy(),
                                   np.asarray(jc[name]["state"]), **TOL)


def test_training_the_ssm_family_is_refused(mamba, monkeypatch):
    """What stays refused is the kernel's backward: ``ssd_scan`` refuses an
    input that requires grad, so training takes the plain differentiable
    scan by its mode. ``train_loss`` runs on the SSM family, its gradient
    reaches every SSM leaf, and it never calls ``ops.ssd_scan`` (patched
    to raise); a prefill calls it once per layer."""
    cfg, p = mamba
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 128)).astype(np.int32))
    x = torch.zeros((1, 8, 2, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, torch.zeros((1, 8, 2)), torch.zeros((1, 8, 4)),
                 torch.zeros((1, 8, 4)))

    def refuse(*args, **kw):
        raise AssertionError("ssd_scan called in training")

    monkeypatch.setattr(ops, "ssd_scan", refuse)
    blocks = {n: {"norm": e["norm"], "ssm": {
        k: v.detach().clone().requires_grad_(True)
        for k, v in e["ssm"].items()}} for n, e in p["blocks"].items()}
    loss, _ = lm.train_loss(cfg, {**p, "blocks": blocks},
                            {"tokens": toks, "labels": toks})
    loss.backward()
    assert torch.isfinite(loss)
    for e in blocks.values():
        for k, v in e["ssm"].items():
            assert v.grad is not None and torch.isfinite(v.grad).all(), k
            assert v.grad.abs().sum() > 0, k
    calls = []
    monkeypatch.setattr(ops, "ssd_scan",
                        lambda *a: calls.append(1) or ssd_chunked(*a))
    lm.prefill(cfg, p, {"tokens": toks})
    assert len(calls) == cfg.n_layers


# --------------------------------------------------------------------- #
# decode rows do not depend on the batch
# --------------------------------------------------------------------- #
def _clone(cache):
    return {n: {"state": e["state"].clone()} for n, e in cache.items()}


@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_rows_do_not_depend_on_batch(mamba, paged):
    """A row's logits and new state are bitwise the same in a step of
    three rows and in a step of its own (the recurrence runs at the fixed
    ``lm.DECODE_ROWS`` width, whatever the row count)."""
    cfg, p = mamba
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 9)) \
        .astype(np.int32)
    col = torch.from_numpy(toks[:, :1])
    lens = [9, 5, 7] if paged else [9, 9, 9]
    if paged:
        cache = lm.init_paged_cache(cfg, 3, 10, 4, 3, device="cpu")
        for s, T in enumerate(lens):
            _, pc = lm.prefill(cfg, p, {"tokens": torch.from_numpy(
                toks[s:s + 1, :T])}, max_len=12)
            lm.admit_prefill(cfg, cache, pc, torch.tensor(
                [3 * s + 1, 3 * s + 2, 3 * s + 3], dtype=torch.int32), s)
        singles = [{n: {"state": e["state"][:, s:s + 1].clone()}
                    for n, e in cache.items()} for s in range(3)]
        batch_cache = _clone(cache)
        batch, _ = lm.decode_step(cfg, p, batch_cache, col, lens)
    else:
        singles = [lm.prefill(cfg, p, {"tokens": torch.from_numpy(
            toks[s:s + 1])}, max_len=10)[1] for s in range(3)]
        batch_cache = {n: {"state": torch.cat(
            [c[n]["state"] for c in singles], dim=1)} for n in singles[0]}
        batch, _ = lm.decode_step(cfg, p, batch_cache, col, 9)
    for s, T in enumerate(lens):
        one = _clone(singles[s])
        row, _ = lm.decode_step(cfg, p, one, col[s:s + 1],
                                [T] if paged else T)
        assert torch.equal(batch[s], row[0])
        for n in one:
            assert torch.equal(batch_cache[n]["state"][:, s],
                               one[n]["state"][:, 0])


# --------------------------------------------------------------------- #
# twins of tests/test_serve.py's mamba cases (inside the port)
# --------------------------------------------------------------------- #
def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32) for t in lens]


def _oracle_gen(cfg, params, req):
    res = generate(cfg, params, np.asarray(req.prompt)[None],
                   max_new=req.max_new, eos=req.eos,
                   temperature=req.temperature, seed=req.seed,
                   pad=req.pad, device="cpu")
    return res.tokens[0, len(req.prompt):]


def test_engine_parity_ssm_arch(mamba):
    cfg, params = mamba
    reqs = [Request(prompt=p, max_new=6)
            for p in _prompts(cfg, [5, 9, 3], seed=5)]
    eng = DecodeEngine(cfg, params, slots=2, page_size=4, max_ctx=16,
                       max_new_cap=6, device="cpu")
    results = ServeStream(eng, wave_len=3).run(reqs)
    for req, res in zip(reqs, results):
        assert res.status == "ok"
        assert np.array_equal(res.generated, _oracle_gen(cfg, params, req))
    eng.pool.check_invariants()
    assert eng.pool.free_pages == eng.n_pages - 1


def test_engine_matches_jax_engine_greedy(mamba_pair):
    """The port's engine against the JAX package's on the same
    parameters and ragged requests (greedy tokens exact)."""
    from repro.runtime import serve as jserve
    jcfg, jp, cfg, p = mamba_pair
    prompts = _prompts(cfg, [3, 11, 6, 9, 1], seed=21)
    jeng = jserve.DecodeEngine(jcfg, jp, slots=2, page_size=4, max_ctx=20,
                               max_new_cap=6)
    want = jserve.ServeStream(jeng, wave_len=3).run(
        [jserve.Request(prompt=pr, max_new=6) for pr in prompts])
    eng = DecodeEngine(cfg, p, slots=2, page_size=4, max_ctx=20,
                       max_new_cap=6, device="cpu")
    got = ServeStream(eng, wave_len=3).run(
        [Request(prompt=pr, max_new=6) for pr in prompts])
    for g, w in zip(got, want):
        assert g.status == "ok"
        assert np.array_equal(g.generated, np.asarray(w.generated))


def test_engine_multi_tenant_stream(mamba):
    gcfg = reduced(get_config("gemma2_2b"))
    jp = jlm.init_params(jax_reduced(jax_get_config("gemma2_2b")),
                         jax.random.PRNGKey(0))
    gparams = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    mcfg, mparams = mamba
    engines = {
        "gemma": DecodeEngine(gcfg, gparams, slots=2, page_size=4,
                              max_ctx=16, max_new_cap=5, name="gemma",
                              device="cpu"),
        "mamba": DecodeEngine(mcfg, mparams, slots=2, page_size=4,
                              max_ctx=16, max_new_cap=5, name="mamba",
                              device="cpu")}
    jobs = [("gemma", Request(prompt=p, max_new=5))
            for p in _prompts(gcfg, [4, 7, 5], seed=10)]
    jobs += [("mamba", Request(prompt=p, max_new=5))
             for p in _prompts(mcfg, [6, 3, 8], seed=11)]
    results = ServeStream(engines, wave_len=3).run(jobs)
    for (name, req), res in zip(jobs, results):
        assert res.model == name and res.status == "ok"
        cfg, params = ((gcfg, gparams) if name == "gemma"
                       else (mcfg, mparams))
        assert np.array_equal(res.generated, _oracle_gen(cfg, params, req))


def test_serve_legacy_and_temperature_parity(mamba):
    """``serve_legacy`` tokens bitwise ``generate``'s; sampled engine
    tokens bitwise ``generate``'s with the same seed."""
    cfg, params = mamba
    reqs = [Request(prompt=p, max_new=5, temperature=0.8, seed=40 + i)
            for i, p in enumerate(_prompts(cfg, [4, 7, 6], seed=4))]
    for res, req in zip(serve_legacy(cfg, params, reqs, device="cpu"), reqs):
        assert res.status == "ok"
        assert np.array_equal(res.generated, _oracle_gen(cfg, params, req))
    eng = DecodeEngine(cfg, params, slots=2, page_size=4, max_ctx=16,
                       max_new_cap=5, device="cpu")
    for res, req in zip(ServeStream(eng, wave_len=2).run(reqs), reqs):
        assert np.array_equal(res.generated, _oracle_gen(cfg, params, req))


def test_snapshot_rollback_restores_the_state_bitwise(mamba):
    """A wave advances the SSM state rows in place; a rollback copies the
    snapshot back, bitwise, and a replayed wave gives the same bits."""
    cfg, params = mamba
    eng = DecodeEngine(cfg, params, slots=2, page_size=4, max_ctx=16,
                       max_new_cap=6, device="cpu")
    for p in _prompts(cfg, [5, 8], seed=13):
        assert eng.admit(Request(prompt=p, max_new=6)) is not None
    eng.run_wave(2)                    # past the first boundary
    name = lm.slot_names(cfg)[0]
    before = eng.st["cache"][name]["state"].clone()
    eng.run_wave(3)
    after = eng.st["cache"][name]["state"].clone()
    assert not torch.equal(before, after)
    eng.rollback()
    assert torch.equal(eng.st["cache"][name]["state"], before)
    eng.run_wave(3)
    assert torch.equal(eng.st["cache"][name]["state"], after)
    fresh = DecodeEngine(cfg, params, slots=1, page_size=4, max_ctx=8,
                         max_new_cap=2, device="cpu")
    with pytest.raises(WaveCrashError):
        fresh.rollback()


def test_launcher_serves_mamba(capsys):
    launch_serve.main(["--archs", "mamba2_1p3b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--max-new", "4",
                       "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "engine: 3 reqs / 12 tokens" in out and "status: ok=3" in out
    launch_serve.main(["--archs", "mamba2_1p3b,gemma2_2b", "--reduced",
                       "--device", "cpu", "--legacy", "--requests", "2",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "legacy: 12 tokens" in out and "status: ok=4" in out
