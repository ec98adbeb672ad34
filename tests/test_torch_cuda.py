"""The port on a card: each CUDA kernel against its plain version, the
stacked shuffle and a training step against the same code on the CPU.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances: XOR gathers (u32 words and u16 lanes), the dense folds of
the multipass codec, ``aggregate`` with one row per segment and the
shuffle (f32 and packed bf16/f16, every mode and codec, the two-level
and verified lanes) are bitwise (bit movers, exact sums); ``aggregate``
with several rows per segment is rtol 1e-6 in f32 and one bf16 ulp in
bf16, as stated for the kernel (it is in fact the same ascending f32
sum); the tiny trainer's
loss on the card is within rtol 1e-4 of the CPU's (cuBLAS and the CPU's
BLAS sum products in other orders, TF32 off), on both grad-sync lanes.
``flash_attention`` is within 2e-5 (f32) / 2e-2 (bf16) of its plain
version, the tolerances of ``tests/test_kernels.py`` (online softmax
against the materialized one); ``ssd_scan`` within 2e-4 of its plain
version in f32 (that file's tolerance: chunked sums in another order;
also at ragged lengths, B 2, state sizes 16 to 256 and P 32 and 80)
and within two bf16 ulps of each output (rtol 2**-6, atol 1e-4) in bf16,
and at ``chip_smoke.py``'s serving shapes bitwise repeatable (both
bodies), within its serving limit in bf16 (rtol 2**-6 + 2e-5 x max|y|)
and within 1e-5 x max|y| of an f64 evaluation in f32; the serving
engine's tokens (dense, SSM and hybrid models) and the enc-dec and ViT
models' ``serve_legacy`` tokens are bitwise the port's ``generate`` on
the card; ``ops.attention`` on bf16 queries over f32 k/v is within one
bf16 ulp of each plain output plus the f32 body's 2e-5 (f32 math
rounded once on both sides).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.collective import (camr_shuffle, make_plan,
                                         scatter_contributions)
from repro_torch.core.schedule import Topology, payload_words
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.kernels import (aggregate, aggregate_bf16, flash_attention,
                                 launch_counts, ops, ref, ssd_scan,
                                 xor_decode,
                                 xor_decode_gather,
                                 xor_decode_gather16, xor_encode,
                                 xor_encode_gather, xor_encode_gather16,
                                 xor_fold)
from repro_torch.models import lm
from repro_torch.runtime import MultiModelCAMRTrainer
from repro_torch.runtime.serve import (DecodeEngine, Request, ServeStream,
                                       generate, serve_legacy)

from chip_smoke_module import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _words(rng, shape):
    return torch.from_numpy(
        rng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("pk", [1, 7, 1002, 4096])
def test_cuda_gathers_match_plain(cuda_device, pk):
    rng = np.random.default_rng(pk)
    K, P, n, m = 3, 6, 5, 4
    c = _words(rng, (K, P, pk)).to(cuda_device)
    mask = torch.from_numpy(rng.integers(0, 2, size=(K, n, m)).astype(bool))
    idx = torch.from_numpy(rng.integers(0, P, size=(K, n, m)).astype(np.int32))
    idx[~mask] = 0
    i, mk = idx.to(cuda_device), mask.to(cuda_device)
    r = _words(rng, (K, n, pk)).to(cuda_device)
    s = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(K)])
                         .astype(np.int32)).to(cuda_device)
    before = launch_counts()
    assert torch.equal(xor_encode_gather(c, i, mk),
                       ref.xor_encode_gather_ref(c, i, mk))
    assert torch.equal(xor_decode_gather(r, c, s, i, mk),
                       ref.xor_decode_gather_ref(r, c, s, i, mk))
    after = launch_counts()
    assert after["xor_encode_gather"] == before["xor_encode_gather"] + 1
    assert after["xor_decode_gather"] == before["xor_decode_gather"] + 1


@pytest.mark.parametrize("n,d,S,one", [(4, 1000, 4, True), (6, 1001, 4, True),
                                       (33, 4096, 11, False)])
def test_cuda_aggregate_matches_plain(cuda_device, n, d, S, one):
    rng = np.random.default_rng(d)
    vals = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    if one:
        ids = np.full(n, -1, np.int32)
        ids[rng.permutation(n)[:S]] = np.arange(S)
    else:
        ids = rng.integers(-1, S, size=n).astype(np.int32)
    v, i = vals.to(cuda_device), torch.from_numpy(ids).to(cuda_device)
    got, want = aggregate(v, i, S), ref.aggregate_ref(v, i, S)
    if one:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


#: (lanes, offset, m): rows of 0, 2, 4 and 6 mod 8 lanes (16-byte phases
#: stepping by 0, 4, 8 and 12 bytes a row), bases 0-7 lanes off a 16-byte
#: boundary (odd offsets: the 2-byte instantiation), 1 to 64 sources, and
#: rows of several 16-KB tiles
GATHER16_CASES = [(2, 0, 4), (6, 0, 4), (1002, 0, 4), (4096, 0, 4),
                  (4096, 1, 4),
                  (1002, 2, 1), (1002, 3, 3), (1002, 5, 64), (2004, 4, 3),
                  (2004, 6, 1), (2004, 7, 64), (4094, 2, 64), (4094, 5, 3),
                  (4094, 6, 1), (50002, 0, 3), (50002, 3, 3),
                  (20004, 2, 64)]


@pytest.mark.parametrize("lanes,offset,m", GATHER16_CASES)
def test_cuda_gathers16_match_plain(cuda_device, lanes, offset, m):
    """16-bit lanes: the phase-aware body at every 16-byte phase of the
    rows and of the bases (4-byte instantiation at even offsets, 2-byte at
    odd ones; recv at another offset than chunks), with a row that has no
    valid source and one whose every source is valid."""
    rng = np.random.default_rng(lanes + offset + m)
    K, P, n = 3, 6, 5

    def lanes_(shape, off):
        flat = torch.from_numpy(rng.integers(
            0, 2**16, size=int(np.prod(shape)) + off,
            dtype=np.uint16).view(np.int16)).to(cuda_device)
        return flat[off:].view(shape)

    c = lanes_((K, P, lanes), offset)
    mask = torch.from_numpy(rng.integers(0, 2, size=(K, n, m)).astype(bool))
    mask[:, 0] = False
    mask[:, 1] = True
    idx = torch.from_numpy(rng.integers(0, P, size=(K, n, m)).astype(np.int32))
    idx[~mask] = 0
    i, mk = idx.to(cuda_device), mask.to(cuda_device)
    r = lanes_((K, n, lanes), (3 * offset + 1) % 8)
    s = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(K)])
                         .astype(np.int32)).to(cuda_device)
    before = launch_counts()
    assert torch.equal(xor_encode_gather16(c, i, mk),
                       ref.xor_encode_gather16_ref(c, i, mk))
    assert torch.equal(xor_decode_gather16(r, c, s, i, mk),
                       ref.xor_decode_gather16_ref(r, c, s, i, mk))
    after = launch_counts()
    assert after["xor_encode_gather16"] == before["xor_encode_gather16"] + 1
    assert after["xor_decode_gather16"] == before["xor_decode_gather16"] + 1
    assert after["xor_encode_gather"] == before["xor_encode_gather"]


def test_cuda_gathers16_match_plain_at_the_step_tables(cuda_device):
    """Stage 1's tables of ``make_plan(2, 3, d)`` (rows with two valid
    sources and rows with none; decode rows with one) at a ``d`` whose
    bf16 packet row is 12 mod 16 bytes, as at the training cell, and two
    16-KB tiles long."""
    from repro_torch.core.collective import _device_tables
    from repro_torch.core.schedule import payload_words
    q, k, d = 2, 3, 20012
    lanes = 2 * (payload_words(d, 2, k) // (k - 1))
    assert (2 * lanes) % 16 == 12 and 2 * lanes > 16 * 1024
    plan = make_plan(q, k, d)
    st = _device_tables(plan, cuda_device, "all_to_all")["stages"][1]
    K, P = plan.K, plan.J_own * (k - 1) * plan.K * (k - 1)
    rng = np.random.default_rng(d)

    def lanes_(shape):
        return torch.from_numpy(rng.integers(
            0, 2**16, size=shape, dtype=np.uint16).view(np.int16)).to(
                cuda_device)

    c = lanes_((K, P, lanes))
    r = lanes_((K, st["dec_recv"].shape[1], lanes))
    eargs = (c, st["enc_src"], st["src_ok"])
    dargs = (r, c, st["dec_recv"], st["dec_src"], st["dec_mask"])
    before = launch_counts()
    assert torch.equal(xor_encode_gather16(*eargs),
                       ref.xor_encode_gather16_ref(*eargs))
    assert torch.equal(xor_decode_gather16(*dargs),
                       ref.xor_decode_gather16_ref(*dargs))
    after = launch_counts()
    assert after["xor_encode_gather16"] == before["xor_encode_gather16"] + 1
    assert after["xor_decode_gather16"] == before["xor_decode_gather16"] + 1


@pytest.mark.parametrize("n,d,S,one", [(4, 1000, 4, True), (6, 1001, 4, True),
                                       (33, 4096, 11, False)])
def test_cuda_aggregate_bf16_matches_plain(cuda_device, n, d, S, one):
    rng = np.random.default_rng(d + 1)
    vals = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    if one:
        ids = np.full(n, -1, np.int32)
        ids[rng.permutation(n)[:S]] = np.arange(S)
    else:
        ids = rng.integers(-1, S, size=n).astype(np.int32)
    v = vals.bfloat16().to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    before = launch_counts()
    got, want = aggregate(v, i, S), ref.aggregate_ref(v, i, S)
    assert got.dtype == torch.bfloat16
    after = launch_counts()
    assert after["aggregate_bf16"] == before["aggregate_bf16"] + 1
    assert after["aggregate"] == before["aggregate"]
    gb, wb = got.view(torch.int16).long(), want.view(torch.int16).long()
    if one:
        assert torch.equal(gb, wb)
    else:   # neighbouring bf16 values of one sign differ by 1 in bits
        assert (gb - wb).abs().max() <= 1
    assert torch.equal(aggregate_bf16(v, i, S), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("router", ["all_to_all", "ppermute"])
@pytest.mark.parametrize("q,k", [(2, 3), (3, 3), (2, 4)])
def test_cuda_packed_shuffle_bitwise_equals_cpu(cuda_device, q, k, router,
                                                dtype):
    d = (k - 1) * 1001                      # odd lane counts for k = 4
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(q * k + 7)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    c = torch.from_numpy(scatter_contributions(plan, bg)).to(dtype)
    got = camr_shuffle(plan, c.to(cuda_device), router=router).cpu()
    want = camr_shuffle(plan, c, router=router)
    words = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(words), want.view(words))


@pytest.mark.parametrize("router", ["all_to_all", "ppermute"])
@pytest.mark.parametrize("q,k", [(2, 3), (3, 3), (2, 4)])
def test_cuda_shuffle_bitwise_equals_cpu(cuda_device, q, k, router):
    d = (k - 1) * 1001
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(q * k)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    c = torch.from_numpy(scatter_contributions(plan, bg))
    got = camr_shuffle(plan, c.to(cuda_device), router=router).cpu()
    want = camr_shuffle(plan, c, router=router)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("q,k,hosts", [(2, 4, 2), (3, 4, 2), (2, 6, 3)])
def test_cuda_two_level_and_verified_wire_equal_cpu(cuda_device, q, k,
                                                    hosts, dtype):
    """The two-level shuffle (both routers) and the verified wire (clean
    and with one corrupted checksum word at ``bits=0x80000000``) on the
    card: bitwise the same code on the CPU, mismatch counts included."""
    d = (k - 1) * 1001
    plan = make_plan(q, k, d)
    two = make_plan(q, k, d, Topology.two_level(hosts))
    rng = np.random.default_rng(q * k + hosts)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    c = torch.from_numpy(scatter_contributions(plan, bg)).to(dtype)
    cd = c.to(cuda_device)
    words = torch.int32 if dtype == torch.float32 else torch.int16
    want = camr_shuffle(plan, c)
    for router in ("all_to_all", "ppermute"):
        got = camr_shuffle(two, cd, router=router).cpu()
        assert torch.equal(got.view(words), want.view(words)), router
    pk = payload_words(d, c.element_size(), k) // (k - 1)
    row = int(np.flatnonzero(two.program.stage_tables(2).valid[1])[0])
    for spec in (None, (2, 1, row, pk, 0x80000000)):
        got, bad = camr_shuffle(two, cd, verify_wire=True, corrupt=spec)
        ref, ref_bad = camr_shuffle(two, c, verify_wire=True, corrupt=spec)
        assert torch.equal(got.cpu().view(words), ref.view(words)), spec
        assert torch.equal(bad.cpu(), ref_bad), spec
        assert int(ref_bad.sum()) == (0 if spec is None else k - 1)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("n,offset", [(1, 0), (2, 0), (7, 0), (1001, 0),
                                      (4096, 0), (4096, 1)])
def test_cuda_folds_match_plain(cuda_device, n, offset, m):
    """The dense folds: n of 1, 2 and 3 mod 4 words and whole 16-byte
    rows (the 4-, 8- and 16-byte paths), one word off alignment, masks
    with a row wholly off and one wholly on."""
    rng = np.random.default_rng(10 * n + m + offset)
    R = 5

    def words(shape):
        flat = _words(rng, (int(np.prod(shape)) + offset,)).to(cuda_device)
        return flat[offset:].view(shape)

    p, r = words((R, m, n)), words((R, n))
    mask = torch.from_numpy(rng.integers(0, 2, size=(R, m)).astype(bool))
    mask[0], mask[1] = False, True
    mk = mask.to(cuda_device)
    before = launch_counts()
    assert torch.equal(xor_fold(p), ref.xor_fold_ref(p))
    assert torch.equal(xor_decode(r, p, mk), ref.xor_decode_ref(r, p, mk))
    assert torch.equal(xor_encode(p[2]), ref.xor_encode_ref(p[2]))
    assert torch.equal(ops.xor_fold(p[3]), ref.xor_encode_ref(p[3]))
    after = launch_counts()
    assert after["xor_fold"] == before["xor_fold"] + 1
    assert after["xor_decode"] == before["xor_decode"] + 1
    assert after["xor_encode"] == before["xor_encode"] + 2


@pytest.mark.parametrize("mode,codec", [("batched", "multipass"),
                                        ("looped", "fused"),
                                        ("looped", "multipass")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("q,k", [(2, 3), (3, 3), (2, 4)])
def test_cuda_modes_and_codecs_equal_fused(cuda_device, q, k, dtype, mode,
                                           codec):
    d = (k - 1) * 1001
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(q * k + 11)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    c = torch.from_numpy(scatter_contributions(plan, bg)).to(dtype)
    cc = c.to(cuda_device)
    want = camr_shuffle(plan, cc)
    words = torch.int32 if dtype == torch.float32 else torch.int16
    for router in ("all_to_all", "ppermute"):
        got = camr_shuffle(plan, cc, mode=mode, codec=codec, router=router)
        assert torch.equal(got.view(words), want.view(words))
        cpu = camr_shuffle(plan, c, mode=mode, codec=codec, router=router)
        assert torch.equal(got.cpu().view(words), cpu.view(words))


def _trainer_step_on_card_and_cpu(cuda_device, grad_sync_dtype,
                                  codec="fused", arch="granite_3_2b"):
    cfg = reduced(get_config(arch)).replace(vocab=64, loss_chunk=8)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    cpu = MultiModelCAMRTrainer(cfg, q=2, k=3, device="cpu", seed=3,
                                grad_sync_dtype=grad_sync_dtype, codec=codec)
    params = [{k: v for k, v in p.items()} for p in cpu.params]
    card = MultiModelCAMRTrainer(cfg, q=2, k=3, device=cuda_device,
                                 params=params,
                                 grad_sync_dtype=grad_sync_dtype, codec=codec)
    assert torch.equal(card.flat.cpu(), cpu.flat)
    before = launch_counts()
    rc, rg = cpu.train_steps(pipe, 1), card.train_steps(pipe, 1)
    after = launch_counts()
    np.testing.assert_allclose(rg.losses, rc.losses, rtol=1e-4)
    assert rg.bytes_total == rc.bytes_total
    return card, {name: after[name] - before[name] for name in after}


def test_cuda_trainer_step_matches_cpu(cuda_device):
    card, runs = _trainer_step_on_card_and_cpu(cuda_device, "float32")
    assert runs == {"xor_encode_gather": 2, "xor_decode_gather": 2,
                    "aggregate": card.K, "xor_encode_gather16": 0,
                    "xor_decode_gather16": 0, "aggregate_bf16": 0,
                    "xor_fold": 0, "xor_decode": 0, "xor_encode": 0,
                    "flash_attention": 0, "ssd_scan": 0}


def test_cuda_bf16_trainer_step_matches_cpu(cuda_device):
    card, runs = _trainer_step_on_card_and_cpu(cuda_device, "bfloat16")
    assert runs == {"xor_encode_gather": 0, "xor_decode_gather": 0,
                    "aggregate": 0, "xor_encode_gather16": 2,
                    "xor_decode_gather16": 2, "aggregate_bf16": card.K,
                    "xor_fold": 0, "xor_decode": 0, "xor_encode": 0,
                    "flash_attention": 0, "ssd_scan": 0}


def test_cuda_multipass_trainer_step_matches_cpu(cuda_device):
    card, runs = _trainer_step_on_card_and_cpu(cuda_device, "float32",
                                               codec="multipass")
    assert runs == {"xor_encode_gather": 0, "xor_decode_gather": 0,
                    "aggregate": card.K, "xor_encode_gather16": 0,
                    "xor_decode_gather16": 0, "aggregate_bf16": 0,
                    "xor_fold": 2, "xor_decode": 2, "xor_encode": 0,
                    "flash_attention": 0, "ssd_scan": 0}


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b"])
def test_cuda_ssm_and_hybrid_trainer_step_matches_cpu(cuda_device, arch):
    """The SSM and hybrid families train on the card through the plain
    differentiable scan: the f32 lane's codec kernels run, neither
    prefill kernel does."""
    card, runs = _trainer_step_on_card_and_cpu(cuda_device, "float32",
                                               arch=arch)
    assert runs == {"xor_encode_gather": 2, "xor_decode_gather": 2,
                    "aggregate": card.K, "xor_encode_gather16": 0,
                    "xor_decode_gather16": 0, "aggregate_bf16": 0,
                    "xor_fold": 0, "xor_decode": 0, "xor_encode": 0,
                    "flash_attention": 0, "ssd_scan": 0}


def test_cuda_chunked_lane_matches_materialized(cuda_device):
    """``chip_smoke.py``'s chunked-lane gate at a reduced width: one
    subfile's loss and flat gradient at 2048 tokens through the chunked
    attention (taken once per layer) against the materialized one on the
    card, f32 with TF32 off, at the dense tolerances of
    tests/test_torch_train.py (loss rtol 1e-5, gradient rtol 1e-4 /
    atol 1e-6)."""
    from repro_torch.runtime.train_loop import _full_f32
    from repro_torch.weights import flat_spec, ravel, unravel
    cfg = reduced(get_config("granite_3_2b")).replace(loss_chunk=512)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = lm.init_params(cfg, gen)
    spec = flat_spec(params)
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in
             ShardedTokenPipeline(vocab=cfg.vocab, seq_len=2048,
                                  global_batch=1).batch(0).items()}
    out = []
    real = ops.flash_attention_chunked
    for threshold in (ops.CHUNK_THRESHOLD, float("inf")):
        calls = []
        mp = pytest.MonkeyPatch()
        mp.setattr(ops, "CHUNK_THRESHOLD", threshold)
        mp.setattr(ops, "flash_attention_chunked",
                   lambda *a, **kw: calls.append(1) or real(*a, **kw))
        try:
            with _full_f32(cuda_device):
                row = ravel(params).requires_grad_(True)
                loss, _ = lm.train_loss(cfg, unravel(row, spec), batch)
                grad, = torch.autograd.grad(loss, row)
        finally:
            mp.undo()
        assert len(calls) == (cfg.n_layers if threshold < 2 ** 22 else 0)
        out.append((float(loss.detach()), grad.cpu().numpy()))
    (l1, g1), (l2, g2) = out
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_cuda_three_modes_are_bitwise_equal(cuda_device, lane):
    """``chip_smoke.py``'s three-mode gate at a tiny size: camr_spmd, camr
    and uncoded trainers from one seed on the card give bitwise the same
    parameters and losses after 2 steps; only camr_spmd launches the
    lane's codec kernels."""
    cfg = reduced(get_config("granite_3_2b")).replace(vocab=64, loss_chunk=8)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=8, global_batch=2)
    runs = {}
    for mode in ("camr_spmd", "camr", "uncoded"):
        tr = MultiModelCAMRTrainer(cfg, q=2, k=3, device=cuda_device, seed=2,
                                   grad_sync_dtype=lane)
        before = launch_counts()
        rep = tr.train_steps(pipe, 2, mode=mode)
        after = launch_counts()
        runs[mode] = (tr.flat.cpu(), rep,
                      sum(after[n] - before[n] for n in after))
    flat0, rep0, n0 = runs["camr_spmd"]
    assert n0 == 2 * (2 + 2 + 6)
    for mode in ("camr", "uncoded"):
        flat, rep, n = runs[mode]
        assert n == 0
        assert torch.equal(flat.view(torch.int32), flat0.view(torch.int32))
        assert rep.losses == rep0.losses
    # 2 steps of the paper's load 1: J * Q values of d_shard each
    d_shard = flat0.shape[1] // 6
    width = {"float32": 4, "bfloat16": 2}[lane]
    assert runs["camr"][1].bytes_total == 2 * 4 * 6 * d_shard * width

# B, Hq, Hkv, Tq, Tk, D, causal, window, softcap: tests/test_kernels.py's
# ATTN_CASES, granite's prefill (32/8 heads, D 64), gemma2's (8/4 heads,
# D 256, softcap 50, window 4096; a window that binds at 300), zamba2's
# (32/32 heads, D 80, at 77 and 129 tokens a ragged last query and key
# tile) and a ragged D 80 case, and a window over Tq < Tk with Tk not a
# multiple of the bf16 body's 64-key tile; seamless's non-causal
# cross-attention with more queries than keys (Tq > Tk), at its shape and
# at a ragged one; then shapes whose few query tiles split their keys in
# the f32 body (flash_attention.split_plan): seamless's cross decode and
# prefill over 1000 frames, Tq 1, 4, 31 and 64 over 257-5000 keys, causal
# with a window that binds, softcap, GQA, D 80 and 256
FLASH_CASES = [
    (1, 2, 2, 64, 64, 16, True, None, None),
    (2, 4, 2, 32, 32, 32, True, None, None),
    (1, 2, 1, 128, 128, 16, True, 32, None),
    (1, 2, 2, 64, 64, 16, True, None, 50.0),
    (1, 4, 4, 48, 48, 16, False, None, None),
    (1, 2, 1, 1, 96, 16, True, None, None),
    (1, 2, 2, 100, 100, 16, True, None, None),
    (1, 8, 2, 8, 72, 16, True, 24, None),
    (1, 32, 8, 129, 129, 64, True, None, None),
    (1, 32, 8, 1000, 1000, 64, True, None, None),
    (1, 8, 4, 1000, 1000, 256, True, 4096, 50.0),
    (1, 8, 4, 700, 700, 256, True, 300, 50.0),
    (2, 4, 2, 33, 70, 128, False, None, None),
    (1, 32, 32, 1024, 1024, 80, True, None, None),
    (1, 32, 32, 77, 77, 80, True, None, None),
    (1, 32, 32, 129, 129, 80, True, None, None),
    (1, 4, 2, 40, 90, 80, True, None, None),
    (1, 4, 2, 70, 150, 64, True, 40, None),
    (1, 16, 16, 129, 129, 128, True, None, None),
    (1, 32, 8, 300, 300, 128, True, 128, None),
    (1, 48, 8, 77, 77, 128, True, None, None),
    (1, 16, 16, 513, 257, 64, False, None, None),
    (2, 4, 2, 100, 33, 64, False, None, None),
    (1, 16, 16, 1, 1000, 64, False, None, None),
    (2, 16, 16, 4, 1000, 64, False, None, None),
    (2, 8, 2, 1, 5000, 128, True, 4096, None),
    (1, 4, 2, 31, 257, 80, True, None, None),
    (1, 4, 4, 64, 300, 80, False, None, None),
    (1, 8, 4, 64, 3000, 256, True, 1000, 50.0),
    (2, 4, 1, 4, 777, 256, False, None, 30.0),
    (1, 8, 2, 31, 2000, 64, True, 700, 50.0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    B, Hq, Hkv, Tq, Tk, D, causal, window, softcap = case
    rng = np.random.default_rng(Tq * 31 + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype)
               for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # strided views (a [B, T, H, D] projection seen as [B, H, T, D])
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(flash_attention(qs, k, v, **kw), got,
                               rtol=0, atol=0)


def _serving_shapes():
    """``chip_smoke.py``'s ``FLASH_SHAPES``: the bf16 prefills of granite,
    gemma2, zamba2, moonshot, mixtral and internlm2."""
    return chip_smoke().FLASH_SHAPES


def test_cuda_flash_attention_is_deterministic(cuda_device):
    """Two calls at each bf16 serving shape give the same bits: a race
    between the producer's loads and the consumers' reads of a ring slot
    would show as a difference."""
    for B, Hq, Hkv, Tq, Tk, D, causal, window, softcap in _serving_shapes():
        rng = np.random.default_rng(Tq + D)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(cuda_device, torch.bfloat16)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        first = flash_attention(q, k, v, **kw)
        second = flash_attention(q, k, v, **kw)
        assert torch.equal(first.view(torch.int16),
                           second.view(torch.int16)), (B, Hq, Hkv, Tq, Tk, D)


def test_cuda_flash_attention_f32_is_deterministic(cuda_device):
    """Two calls of the f32 body at each of seamless's shapes
    (``ENCDEC_SHAPES``: the encoder in one split, the cross prefill and
    decode split across blocks and merged) give the same bits."""
    for B, Hq, Hkv, Tq, Tk, D, causal, window, softcap in \
            chip_smoke().ENCDEC_SHAPES:
        rng = np.random.default_rng(Tq + Tk)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to(cuda_device)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        first = flash_attention(q, k, v, **kw)
        second = flash_attention(q, k, v, **kw)
        assert torch.equal(first.view(torch.int32),
                           second.view(torch.int32)), (Tq, Tk)


@pytest.mark.parametrize("mixed", [False, True])
def test_cuda_decode_row_cross_attention_does_not_depend_on_batch(
        cuda_device, mixed):
    """A seamless decode row's cross-attention (one query over 1000 f32
    frames, 16 heads, split across blocks) gives the same bits alone and
    as one of a batch of 4 rows: the split plan reads no batch size. Also
    through ``ops.attention`` with bf16 queries (``mixed``), as a bf16
    model over f32 frames calls it."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device)
               for s in ((4, 16, 1, 64), (4, 16, 1000, 64), (4, 16, 1000, 64)))
    if mixed:
        q = q.bfloat16()
    batch = ops.attention(q, k, v, causal=False)
    for b in range(4):
        row = ops.attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=False)
        assert torch.equal(batch[b:b + 1], row), b


@pytest.mark.parametrize("Tq,Tk", [(1, 1000), (513, 257)])
def test_cuda_mixed_dtype_attention_matches_plain(cuda_device, Tq, Tk):
    """``ops.attention`` on bf16 queries over f32 k/v (an enc-dec model's
    cross-attention over f32 frames): one launch of the f32 body, the
    output in bf16 within one bf16 ulp of each plain output (2**-7 of
    it: f32 math rounded once on both sides) plus the f32 body's 2e-5
    (an output near 0 has ulps far below the f32 sums' differences)."""
    rng = np.random.default_rng(Tq)
    q = torch.from_numpy(rng.standard_normal((1, 16, Tq, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((1, 16, Tk, 64)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    before = flash_attention.launches
    got = ops.attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=False)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2e-5)


def test_cuda_flash_attention_refuses_grad_and_bad_dims(cuda_device):
    q = torch.zeros((1, 2, 4, 64), device=cuda_device, requires_grad=True)
    k = torch.zeros((1, 2, 4, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    odd = torch.zeros((1, 2, 4, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(odd, odd, odd)
    with pytest.raises(TypeError):
        flash_attention(k.half(), k.half(), k.half())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_engine_tokens_equal_generate(cuda_device, dtype):
    """The reduced gemma2 served on the card: engine tokens bitwise the
    port's ``generate``, one ``flash_attention`` launch per layer and
    prefill."""
    cfg = reduced(get_config("gemma2_2b")).replace(dtype=dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (t,)).astype(np.int32),
                    max_new=6, temperature=0.7 * (i % 2), seed=i)
            for i, t in enumerate([5, 40, 17, 9, 33])]
    eng = DecodeEngine(cfg, params, slots=2, page_size=8, max_ctx=48,
                       max_new_cap=6, device=cuda_device)
    before = flash_attention.launches
    res = ServeStream(eng, wave_len=3).run(reqs)
    assert flash_attention.launches - before == cfg.n_layers * len(reqs)
    for req, r in zip(reqs, res):
        want = generate(cfg, params, req.prompt[None], max_new=6,
                        temperature=req.temperature, seed=req.seed,
                        device=cuda_device).tokens[0, len(req.prompt):]
        assert r.status == "ok" and np.array_equal(r.generated, want)


@pytest.mark.parametrize("frames", ["float32", "bfloat16"])
def test_cuda_encdec_serve_legacy_equals_generate(cuda_device, frames):
    """The reduced seamless in bf16 served on the card with f32 or bf16
    frames: ``serve_legacy`` tokens bitwise ``generate``'s, and one
    ``flash_attention`` launch per encoder layer, self-attention and
    cross-attention in each prefill, and per cross-attention in each
    decode step (f32 frames: the f32 body on the encoder and the cross-
    attention, which take bf16 queries over f32 k/v)."""
    cfg = reduced(get_config("seamless_m4t_large_v2")).replace(
        dtype="bfloat16")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(3)
    ex = {"frames": torch.from_numpy(rng.standard_normal(
        (1, 70, cfg.frontend_dim)).astype(np.float32)).to(
        getattr(torch, frames))}
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (t,)).astype(np.int32),
                    max_new=6) for t in (5, 100, 33)]
    before = flash_attention.launches
    res = serve_legacy(cfg, params, reqs, extras=ex, device=cuda_device)
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    assert flash_attention.launches - before == len(reqs) * (
        per_prefill + 5 * cfg.n_layers)
    for req, r in zip(reqs, res):
        want = generate(cfg, params, req.prompt[None], max_new=6, extras=ex,
                        device=cuda_device).tokens[0, len(req.prompt):]
        assert r.status == "ok" and np.array_equal(r.generated, want)


def test_cuda_vit_serve_legacy_equals_generate(cuda_device):
    """The reduced internvl2 in bf16 served on the card with f32 patches:
    ``serve_legacy`` tokens bitwise ``generate``'s, one ``flash_attention``
    launch per layer and prefill, none in decode."""
    cfg = reduced(get_config("internvl2_26b")).replace(dtype="bfloat16")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(4)
    ex = {"patches": rng.standard_normal(
        (1, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (t,)).astype(np.int32),
                    max_new=6) for t in (8, 100, 33)]
    before = flash_attention.launches
    res = serve_legacy(cfg, params, reqs, extras=ex, device=cuda_device)
    assert flash_attention.launches - before == len(reqs) * cfg.n_layers
    for req, r in zip(reqs, res):
        want = generate(cfg, params, req.prompt[None], max_new=6, extras=ex,
                        device=cuda_device).tokens[0, len(req.prompt):]
        assert r.status == "ok" and np.array_equal(r.generated, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_step_rows_do_not_depend_on_batch(cuda_device, dtype):
    """On the card, a row's logits in a step of three rows are bitwise
    those of its own step (the fixed ``lm.DECODE_ROWS`` width)."""
    cfg = reduced(get_config("granite_3_2b")).replace(dtype=dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 12)).astype(np.int32)).to(cuda_device)
    caches = [lm.prefill(cfg, params, {"tokens": toks[s:s + 1]},
                         max_len=13)[1] for s in range(3)]
    stacked = {n: {"self": {k: torch.cat([c[n]["self"][k] for c in caches],
                                         dim=1) for k in ("k", "v")}}
               for n in caches[0]}
    batch, _ = lm.decode_step(cfg, params, stacked, toks[:, :1], 12)
    for s in range(3):
        row, _ = lm.decode_step(cfg, params, caches[s], toks[s:s + 1, :1], 12)
        assert torch.equal(batch[s], row[0])


# B, T, H, P, S: tests/test_kernels.py's SSD_CASES (its chunks are the
# plain version's), a ragged T over two P tiles, mamba2's serving prefill
# (64 heads of P 64, S 128) at a ragged length, at 1024 and at 2048
# tokens, and zamba2's (80 heads of P 64, S 64) at 1024 tokens and at
# 77 and 129 (a ragged last chunk)
SSD_CASES = [(1, 32, 2, 8, 4, 8), (2, 64, 1, 16, 8, 16),
             (1, 100, 2, 8, 4, 32), (1, 16, 3, 4, 16, 16),
             (2, 130, 3, 40, 24, 64), (1, 1000, 64, 64, 128, 64),
             (1, 1024, 64, 64, 128, 64), (1, 2048, 64, 64, 128, 64),
             (1, 1024, 80, 64, 64, 64), (1, 77, 80, 64, 64, 64),
             (1, 129, 80, 64, 64, 64)]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
def test_cuda_ssd_scan_matches_plain(cuda_device, case, dtype, shared):
    B, T, H, P, S, chunk = case
    rng = np.random.default_rng(T * 7 + S)
    bs = (B, T, S) if shared else (B, T, H, S)
    x, b, c = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(cuda_device, dtype) for sh in ((B, T, H, P), bs, bs))
    a = torch.from_numpy(-np.abs(rng.standard_normal((B, T, H))).astype(
        np.float32) * 0.5).to(cuda_device)
    before = ssd_scan.launches
    got = ssd_scan(x, a, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want = ref.ssd_chunked(x, a, b, c, chunk=chunk)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                                   atol=1e-4)
    # b/c as column slices of one projection, as the model passes them
    bc = torch.cat([b, c], dim=-1)
    torch.testing.assert_close(ssd_scan(x, a, bc[..., :S], bc[..., S:]), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("T", [1, 63, 65, 77, 129])
@pytest.mark.parametrize("S", [16, 64, 128, 256])
@pytest.mark.parametrize("P", [32, 80])
def test_cuda_ssd_scan_f32_ragged_shapes(cuda_device, T, S, P):
    """The f32 body (the recurrence kernel, then the output kernel) at
    B = 2, lengths around the chunk of 64 (one step, a chunk short of one,
    one past, ragged tails), every state size up to 256 (one to four row
    tiles of the recurrence, slices of 32 in the output kernel) and P 80,
    not a multiple of either kernel's column tile: within 2e-4 of the
    plain version with per-head and with group-shared b/c, one launch a
    call, and the same bits for b/c as column slices of one projection
    (16-byte aligned when S is: read in place)."""
    B, H = 2, 3
    rng = np.random.default_rng(T * 31 + S + P)
    for shared in (False, True):
        bs = (B, T, S) if shared else (B, T, H, S)
        x, b, c = (torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to(cuda_device) for sh in ((B, T, H, P), bs, bs))
        a = torch.from_numpy(-np.abs(rng.standard_normal((B, T, H))).astype(
            np.float32) * 0.5).to(cuda_device)
        before = ssd_scan.launches_by_dtype["float32"]
        got = ssd_scan(x, a, b, c)
        torch.cuda.synchronize()
        assert ssd_scan.launches_by_dtype["float32"] == before + 1
        want = ref.ssd_chunked(x, a, b, c)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        bc = torch.cat([b, c], dim=-1)
        assert torch.equal(ssd_scan(x, a, bc[..., :S], bc[..., S:]), got)


def _ssd_serving_inputs(shape, device, dtype=torch.bfloat16):
    """x, b, c (group-shared) in ``dtype`` and the model's f32 log-decay
    ``-softplus(.)`` at a serving shape of ``chip_smoke.SSD_SHAPES``."""
    B, T, H, P, S = shape
    rng = np.random.default_rng(T + H + S)
    x, b, c = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(device, dtype)
               for sh in ((B, T, H, P), (B, T, S), (B, T, S)))
    a = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, T, H)).astype(np.float32))).to(device)
    return x, a, b, c


def test_cuda_ssd_scan_f32_is_deterministic(cuda_device):
    """Two f32 calls at each serving shape give the same bits (a race on a
    ring slot of either kernel, or between the recurrence's stores of the
    states and the output kernel's reads, would show as a difference), and
    each is within ``SSD_F32_REL`` x max|y| of an f64 evaluation."""
    smoke = chip_smoke()
    for shape in smoke.SSD_SHAPES:
        args = _ssd_serving_inputs(shape, cuda_device, torch.float32)
        first, second = ssd_scan(*args), ssd_scan(*args)
        assert torch.equal(first.view(torch.int32),
                           second.view(torch.int32)), shape
        exact = ref.ssd_chunked(*(t.double() for t in args))
        err = float((first.double() - exact).abs().max())
        assert err <= smoke.SSD_F32_REL * float(exact.abs().max()), shape


def test_cuda_ssd_scan_is_deterministic(cuda_device):
    """Two calls at each bf16 serving shape give the same bits: a race
    between the producer's loads and the consumers' reads of a ring slot,
    or between the consumers' writes of an operand and the products that
    read it, would show as a difference."""
    for shape in chip_smoke().SSD_SHAPES:
        args = _ssd_serving_inputs(shape, cuda_device)
        first, second = ssd_scan(*args), ssd_scan(*args)
        assert torch.equal(first.view(torch.int16),
                           second.view(torch.int16)), shape


def test_cuda_ssd_scan_holds_the_serving_limit(cuda_device):
    """At each bf16 serving shape the kernel is within the chip smoke's
    serving limit of the plain version: ``SSD_SERVE_RTOL`` of each output
    plus twice ``SSD_F32_REL`` x max|y| (each rounds its f32 result once
    to bf16; both f32 results are off by a few 1e-6 x max|y|)."""
    smoke = chip_smoke()
    for shape in smoke.SSD_SHAPES:
        args = _ssd_serving_inputs(shape, cuda_device)
        got = ssd_scan(*args).float()
        want = ref.ssd_chunked(*args).float()
        limit = (2 * smoke.SSD_F32_REL * float(want.abs().max())
                 + smoke.SSD_SERVE_RTOL * want.abs())
        assert torch.isfinite(got).all(), shape
        assert float(((got - want).abs() / limit).max()) <= 1, shape


def test_cuda_ssd_scan_refuses_grad_and_bad_inputs(cuda_device):
    x = torch.zeros((1, 8, 2, 4), device=cuda_device, requires_grad=True)
    a = torch.zeros((1, 8, 2), device=cuda_device)
    b = torch.zeros((1, 8, 4), device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, a, b, b)
    with pytest.raises(TypeError):
        ssd_scan(x.detach().half(), a, b.half(), b.half())
    big = torch.zeros((1, 8, 300), device=cuda_device)
    with pytest.raises(ValueError, match="state size"):
        ssd_scan(x.detach(), a, big, big)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_engine_tokens_equal_generate(cuda_device, dtype):
    """The reduced mamba2 served on the card: engine tokens bitwise the
    port's ``generate``, one ``ssd_scan`` launch per layer and prefill,
    no ``flash_attention``."""
    cfg = reduced(get_config("mamba2_1p3b")).replace(dtype=dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (t,)).astype(np.int32),
                    max_new=6, temperature=0.7 * (i % 2), seed=i)
            for i, t in enumerate([5, 70, 17, 130, 64])]
    eng = DecodeEngine(cfg, params, slots=2, page_size=8, max_ctx=144,
                       max_new_cap=6, device=cuda_device)
    before = launch_counts()
    res = ServeStream(eng, wave_len=3).run(reqs)
    after = launch_counts()
    assert after["ssd_scan"] - before["ssd_scan"] == cfg.n_layers * len(reqs)
    assert after["flash_attention"] == before["flash_attention"]
    for req, r in zip(reqs, res):
        want = generate(cfg, params, req.prompt[None], max_new=6,
                        temperature=req.temperature, seed=req.seed,
                        device=cuda_device).tokens[0, len(req.prompt):]
        assert r.status == "ok" and np.array_equal(r.generated, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_hybrid_engine_tokens_equal_generate(cuda_device, dtype):
    """zamba2 at full width (head dim 80, 80 SSM heads of P 64, state 64)
    cut to two pattern units, served on the card: engine tokens bitwise
    the port's ``generate``, one ``ssd_scan`` per SSM sublayer and one
    ``flash_attention`` per occurrence of the shared block, per
    prefill."""
    cfg = get_config("zamba2_2p7b").replace(n_layers=12, dtype=dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(6)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (t,)).astype(np.int32),
                    max_new=6, temperature=0.7 * (i % 2), seed=i)
            for i, t in enumerate([5, 77, 129, 64, 17])]
    eng = DecodeEngine(cfg, params, slots=2, page_size=16, max_ctx=144,
                       max_new_cap=6, device=cuda_device)
    before = launch_counts()
    res = ServeStream(eng, wave_len=3).run(reqs)
    after = launch_counts()
    assert after["ssd_scan"] - before["ssd_scan"] == 10 * len(reqs)
    assert after["flash_attention"] - before["flash_attention"] == \
        2 * len(reqs)
    for req, r in zip(reqs, res):
        want = generate(cfg, params, req.prompt[None], max_new=6,
                        temperature=req.temperature, seed=req.seed,
                        device=cuda_device).tokens[0, len(req.prompt):]
        assert r.status == "ok" and np.array_equal(r.generated, want)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "mixtral_8x7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_engine_tokens_equal_generate(cuda_device, arch, dtype):
    """A reduced MoE model (4 experts, top-2) served on the card at
    capacity 1.0, where prefills drop assignments: engine tokens bitwise
    the port's ``generate``, one ``flash_attention`` launch per layer and
    prefill."""
    cfg = reduced(get_config(arch)).replace(dtype=dtype,
                                            moe_capacity_factor=1.0)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (t,)).astype(np.int32),
                    max_new=6, temperature=0.7 * (i % 2), seed=i)
            for i, t in enumerate([5, 40, 17, 9, 33])]
    eng = DecodeEngine(cfg, params, slots=4, page_size=8, max_ctx=48,
                       max_new_cap=6, device=cuda_device)
    before = flash_attention.launches
    res = ServeStream(eng, wave_len=3).run(reqs)
    assert flash_attention.launches - before == cfg.n_layers * len(reqs)
    for req, r in zip(reqs, res):
        want = generate(cfg, params, req.prompt[None], max_new=6,
                        temperature=req.temperature, seed=req.seed,
                        device=cuda_device).tokens[0, len(req.prompt):]
        assert r.status == "ok" and np.array_equal(r.generated, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_decode_step_rows_do_not_depend_on_batch(cuda_device,
                                                          dtype):
    """On the card, an MoE row's logits in a step of three rows are
    bitwise those of its own step: its routing runs at the fixed width and
    its expert products at one shape, whichever slots it takes."""
    cfg = reduced(get_config("moonshot_v1_16b_a3b")).replace(dtype=dtype)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = lm.init_params(cfg, gen)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 12)).astype(np.int32)).to(cuda_device)
    caches = [lm.prefill(cfg, params, {"tokens": toks[s:s + 1]},
                         max_len=13)[1] for s in range(3)]
    stacked = {n: {"self": {k: torch.cat([c[n]["self"][k] for c in caches],
                                         dim=1) for k in ("k", "v")}}
               for n in caches[0]}
    batch, _ = lm.decode_step(cfg, params, stacked, toks[:, :1], 12)
    for s in range(3):
        row, _ = lm.decode_step(cfg, params, caches[s], toks[s:s + 1, :1], 12)
        assert torch.equal(batch[s], row[0])


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "mixtral_8x7b"])
def test_cuda_moe_trainer_step_matches_cpu(cuda_device, arch):
    """A reduced MoE model (4 experts, top-2) trains on the card: losses
    within rtol 1e-4 of the CPU's from the same parameters, the f32
    lane's codec kernels and no prefill kernel."""
    card, runs = _trainer_step_on_card_and_cpu(cuda_device, "float32",
                                               arch=arch)
    assert runs == {"xor_encode_gather": 2, "xor_decode_gather": 2,
                    "aggregate": card.K, "xor_encode_gather16": 0,
                    "xor_decode_gather16": 0, "aggregate_bf16": 0,
                    "xor_fold": 0, "xor_decode": 0, "xor_encode": 0,
                    "flash_attention": 0, "ssd_scan": 0}


def test_cuda_checkpoint_roundtrip_and_crash_resume(cuda_device, tmp_path):
    """Tensors on the card save and load bitwise (f32, bf16, int32), back
    onto the card; the single-model ``Trainer`` on the card resumes from
    its step-2 checkpoint bitwise and continues bitwise its own
    uninterrupted run."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.runtime import Trainer
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    tree = {"w": torch.randn((5, 7), generator=gen, device=cuda_device),
            "h": torch.randn((9,), generator=gen, device=cuda_device)
            .to(torch.bfloat16),
            "n": torch.arange(4, dtype=torch.int32, device=cuda_device)}
    save_checkpoint(str(tmp_path / "t"), tree, step=1)
    got, meta = load_checkpoint(str(tmp_path / "t"),
                                {k: torch.zeros_like(v)
                                 for k, v in tree.items()})
    assert meta["step"] == 1
    for k, v in tree.items():
        assert got[k].device == v.device and got[k].dtype == v.dtype
        assert torch.equal(got[k].view(torch.int16 if v.element_size() == 2
                                       else torch.int32),
                           v.view(torch.int16 if v.element_size() == 2
                                  else torch.int32))
    cfg = reduced(get_config("granite_3_2b")).replace(n_layers=2, vocab=64,
                                                      loss_chunk=16)
    pipe = ShardedTokenPipeline(vocab=64, seq_len=16, global_batch=4)
    straight = Trainer(cfg, seed=2, device=cuda_device)
    straight.run(pipe, 4)
    a = Trainer(cfg, seed=2, device=cuda_device,
                ckpt_dir=str(tmp_path / "tr"))
    a.run(pipe, 3, ckpt_every=2)
    b = Trainer(cfg, seed=5, device=cuda_device,
                ckpt_dir=str(tmp_path / "tr"))
    assert b.resume() and b.step == 2
    b.run(pipe, 2)
    for x, y in ((b.flat, straight.flat), (b.opt.mu, straight.opt.mu),
                 (b.opt.nu, straight.opt.nu)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


_PG_CHILD = """
import sys
import numpy as np
import torch
from repro_torch.core.collective import (camr_shuffle, make_plan,
                                         scatter_contributions)
from repro_torch.launch.mesh import (detect_topology, init_distributed,
                                     make_camr_mesh)
rank, port = int(sys.argv[1]), int(sys.argv[2])
assert init_distributed(coordinator=f"localhost:{port}", num_processes=2,
                        process_id=rank)
q, k, d = 2, 4, 4098
mesh = make_camr_mesh(q * k)
assert mesh.device.type == "cuda"
plan0 = make_plan(q, k, d)
bg = np.random.default_rng(1).standard_normal(
    (plan0.J, k, q * k, d)).astype(np.float32)
full = torch.from_numpy(scatter_contributions(plan0, bg)).to(mesh.device)
for plan in (plan0, make_plan(q, k, d, detect_topology(k))):
    for dt in (torch.float32, torch.bfloat16):
        for router in ("all_to_all", "ppermute"):
            for codec in ("fused", "multipass"):
                c = full.to(dt)
                want = camr_shuffle(plan, c, router=router, codec=codec)
                got = camr_shuffle(plan, c[mesh.lo:mesh.hi].contiguous(),
                                   router=router, codec=codec, mesh=mesh)
                v = torch.int16 if dt == torch.bfloat16 else torch.int32
                assert torch.equal(got.view(v),
                                   want[mesh.lo:mesh.hi].view(v)), \\
                    (plan.topology, dt, router, codec)
# the lane's other modes on the f32 flat plan
mine = full[mesh.lo:mesh.hi].contiguous()
for kw in (dict(mode="looped"), dict(verify_wire=True), dict(debug=True),
           dict(verify_wire=True, corrupt=(1, 1, 0, 1, 1))):
    want = camr_shuffle(plan0, full, **kw)
    got = camr_shuffle(plan0, mine, mesh=mesh, **kw)
    if isinstance(want, dict):
        want, got = [want[n] for n in sorted(want)], [got[n] for n in
                                                      sorted(got)]
    elif not isinstance(want, tuple):
        want, got = [want], [got]
    for g, w in zip(got, want):
        assert torch.equal(g, w[mesh.lo:mesh.hi]), kw
torch.distributed.destroy_process_group()
print("OK", rank)
"""


def test_cuda_process_lane_two_children_on_one_card(cuda_device):
    """Two processes on the one card over gloo, 4 of the 8 workers each at
    (2, 4): flat and two-level, both lanes, routers and codecs, then the
    looped, verified, corrupted and debug modes on the f32 flat plan,
    every process's rows bitwise the single-process shuffle's on the
    card."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _PG_CHILD, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {r}" in out, err[-3000:]


@pytest.mark.parametrize("q,k,d,hosts", [(2, 3, 64, None), (3, 3, 8, None),
                                         (2, 4, 9, 2)])
def test_cuda_compare_ledger_equals_cpu(cuda_device, q, k, d, hosts):
    """``camr_compare.lower_schedules`` on the card gives the CPU's dict:
    the ledger's counts depend on shapes only."""
    from repro_torch.launch.camr_compare import lower_schedules
    topo = None if hosts is None else Topology.two_level(hosts)
    assert lower_schedules(q, k, d, topology=topo, device=cuda_device) == \
        lower_schedules(q, k, d, topology=topo, device="cpu")


@pytest.mark.parametrize("arch", ["granite_3_2b", "mamba2_1p3b"])
def test_cuda_prefill_counts_equal_meta(cuda_device, arch):
    """One prefill through ``flash_attention`` (granite) or ``ssd_scan``
    (mamba2) on the card counts the FLOPs and kernel work the dry run's
    ``meta`` trace of the same step counts (the kernels' formulas charged
    by both routes, the aten products by ``FlopCounterMode``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import cost
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_step
    cfg = reduced(get_config(arch))
    shape = ShapeSpec("prefill_small", 128, 2, "prefill")
    meta = dryrun.trace_step(build_step(cfg, shape, device="meta"))
    bundle = build_step(cfg, shape, device=cuda_device)
    with cost.counting() as kc, FlopCounterMode(display=False) as fc:
        bundle.fn(*bundle.args)
    assert kc.by_kernel and kc.by_kernel == meta["kernels"]
    assert fc.get_total_flops() + kc.flops == meta["cost"]["flops"]
