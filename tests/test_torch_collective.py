"""The port's stacked-device coded shuffle on the CPU (plain codec
versions) against the references: BITWISE equal to the numpy
``CAMREngine``'s reduce results for five (q, k), both routers and odd
and even packet widths, on the f32 lane and on the packed 16-bit lane
(bf16 and f16, with and without trailing pad lanes), and for three
(q, k) in every mode (batched, looped) and codec (fused, multipass);
bitwise equal to the JAX ``camr_shuffle`` with its Pallas kernels
(interpret mode) on a 6-device CPU mesh, on both lanes, its ``debug``
dict included; the collective counts and the byte accounting equal to
the JAX package's. No tolerance anywhere but the uncoded baseline's
(rtol 1e-6: the port sums over the device axis in another order than
``psum``): XOR delivery is lossless and assembly folds in the engine's
order, in the payload dtype."""

import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import collective as jcoll
from repro.core.engine import CAMRConfig, CAMREngine
from repro_torch.core.collective import (ShuffleStream, _wire_buffer,
                                         camr_collective_bytes, camr_shuffle,
                                         camr_shuffle_reference,
                                         expected_collective_calls, make_plan,
                                         scatter_contributions,
                                         uncoded_reduce_scatter)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QK = [(2, 3), (3, 3), (2, 4), (4, 3), (3, 4)]


def _engine_results(q, k, bg):
    eng = CAMREngine(CAMRConfig(q=q, k=k, gamma=1), lambda job, sf: sf)
    J = q ** (k - 1)
    return eng.run([[bg[j, t] for t in range(k)] for j in range(J)])


@pytest.mark.parametrize("router", ["all_to_all", "ppermute"])
@pytest.mark.parametrize("pk", [3, 4])
@pytest.mark.parametrize("q,k", QK)
def test_shuffle_bitwise_equals_engine(q, k, pk, router):
    d = (k - 1) * pk
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(100 * q + 10 * k + pk)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    results = _engine_results(q, k, bg)
    out = camr_shuffle(plan, torch.from_numpy(scatter_contributions(plan, bg)),
                       router=router)
    assert out.shape == (plan.K, plan.J, d) and out.dtype == torch.float32
    out = out.numpy()
    for s in range(plan.K):
        for j in range(plan.J):
            np.testing.assert_array_equal(
                out[s, j].view(np.uint32), results[s][(j, s)].view(np.uint32),
                err_msg=f"device {s} job {j}")
    np.testing.assert_allclose(out, camr_shuffle_reference(plan, bg),
                               rtol=2e-5, atol=2e-6)


def test_shuffle_moves_uint32_words():
    """u32 payloads: the same transport, adds wrapping like u32."""
    q, k, d = 2, 3, 6
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(5)
    bg = rng.integers(0, 2**32, size=(plan.J, k, plan.K, d), dtype=np.uint32)
    out = camr_shuffle(plan, torch.from_numpy(
        scatter_contributions(plan, bg).view(np.int32)).view(torch.uint32))
    assert out.dtype == torch.uint32
    # numpy sums u32 in u64; the wire's sums wrap modulo 2**32
    want = camr_shuffle_reference(plan, bg).astype(np.uint32)
    np.testing.assert_array_equal(out.view(torch.int32).numpy()
                                  .view(np.uint32), want)


#: packed-lane widths per k: d filling whole wire words, and d that
#: leaves trailing pad lanes (odd for k = 4; with k = 3, (k-1) | d makes
#: d even, and d = 6 pads 6 lanes to 8)
PACKED_D = {3: {"whole": 8, "padded": 6}, 4: {"whole": 12, "padded": 9}}
NP16 = {torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16}


def _packed_contribs(plan, bg, dtype):
    """numpy 16-bit batch gradients -> the port's contributions tensor."""
    c = scatter_contributions(plan, bg)
    return torch.from_numpy(c.view(np.int16)).view(dtype)


@pytest.mark.parametrize("width", ["whole", "padded"])
@pytest.mark.parametrize("router", ["all_to_all", "ppermute"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("q,k", QK)
def test_packed_shuffle_bitwise_equals_engine(q, k, dtype, router, width):
    d = PACKED_D[k][width]
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(1000 * q + 100 * k + d)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    bg = bg.astype(NP16[dtype])
    results = _engine_results(q, k, bg)
    out = camr_shuffle(plan, _packed_contribs(plan, bg, dtype), router=router)
    assert out.shape == (plan.K, plan.J, d) and out.dtype == dtype
    out = out.view(torch.int16).numpy().view(np.uint16)
    for s in range(plan.K):
        for j in range(plan.J):
            np.testing.assert_array_equal(
                out[s, j], results[s][(j, s)].view(np.uint16),
                err_msg=f"device {s} job {j}")


@pytest.mark.parametrize("router", ["all_to_all", "ppermute"])
@pytest.mark.parametrize("mode,codec", [("batched", "multipass"),
                                        ("looped", "fused"),
                                        ("looped", "multipass")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("q,k", [(2, 3), (3, 3), (2, 4)])
def test_modes_and_codecs_bitwise_equal_engine(q, k, dtype, mode, codec,
                                               router):
    """The multipass oracle and the looped exchange give the engine's
    bits, as the fused batched lane does (above); the 16-bit lanes with
    trailing pad lanes, which the multipass codec packs into u32 words."""
    d = (k - 1) * 3 if dtype == torch.float32 else PACKED_D[k]["padded"]
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(10000 * q + 100 * k + d)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    if dtype == torch.float32:
        c, bits = torch.from_numpy(scatter_contributions(plan, bg)), np.uint32
    else:
        bg = bg.astype(NP16[dtype])
        c, bits = _packed_contribs(plan, bg, dtype), np.uint16
    results = _engine_results(q, k, bg)
    out = camr_shuffle(plan, c, mode=mode, router=router, codec=codec)
    assert out.shape == (plan.K, plan.J, d) and out.dtype == dtype
    words = torch.int32 if bits == np.uint32 else torch.int16
    out = out.view(words).numpy().view(bits)
    for s in range(plan.K):
        for j in range(plan.J):
            np.testing.assert_array_equal(
                out[s, j], results[s][(j, s)].view(bits),
                err_msg=f"device {s} job {j}")


def test_multipass_packs_lane_pairs_into_words_in_place():
    """The multipass lane's u32 wire words are a view of the padded int16
    lanes, lane 2i the low half of word i (JAX ``_u16_pairs_to_u32``):
    no lane is reordered, the pad lane included."""
    lanes = torch.arange(1, 2 * 3 * 6 + 1, dtype=torch.int16).view(2, 3, 6)
    lanes[..., -1] = -1                              # sign bits survive
    x = lanes.view(torch.bfloat16)[..., :5]          # d = 5 lanes -> pad 1
    fused = _wire_buffer(x.contiguous(), 3, "fused")
    words = _wire_buffer(x.contiguous(), 3, "multipass")
    assert fused.dtype == torch.int16 and words.dtype == torch.int32
    assert words.shape == (2, 3, 3)
    u16 = fused.numpy().view(np.uint16).astype(np.uint32)
    want = u16[..., 0::2] | (u16[..., 1::2] << 16)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    assert (u16[..., 5] == 0).all()                  # the pad lane is zero
    np.testing.assert_array_equal(u16[..., :5], lanes[..., :5].numpy()
                                  .view(np.uint16))


@pytest.mark.parametrize("router", ["all_to_all", "ppermute"])
@pytest.mark.parametrize("mode", ["batched", "looped"])
@pytest.mark.parametrize("q,k", QK)
def test_collective_calls_match_reference(q, k, mode, router):
    """``expected_collective_calls`` is the JAX package's, and the port's
    executor runs that many permutations in the looped exchange and in
    stage 3 (the batched exchange is one routed row gather)."""
    d = (k - 1) * 2
    port, ref = make_plan(q, k, d), jcoll.make_plan(q, k, d)
    want = jcoll.expected_collective_calls(ref, mode, router)
    assert expected_collective_calls(port, mode, router) == want
    c = torch.zeros((port.K, port.J_own, k - 1, port.K, d))
    for codec in ("fused", "multipass"):
        before = dict(port.permutations)
        camr_shuffle(port, c, mode=mode, router=router, codec=codec)
        ran = {key: port.permutations[key] - before[key] for key in before}
        s12 = want["stage12"] if mode == "looped" else 0
        assert ran == {"stage12": s12, "stage3": want["stage3"]}


def test_uncoded_reduce_scatter_matches_reference():
    for q, k in ((2, 3), (3, 3), (2, 4)):
        d = (k - 1) * 5
        plan = make_plan(q, k, d)
        rng = np.random.default_rng(7 * q + k)
        bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
        out = uncoded_reduce_scatter(
            torch.from_numpy(scatter_contributions(plan, bg)), plan=plan)
        assert out.shape == (plan.K, plan.J, d)
        np.testing.assert_allclose(out.numpy(),
                                   camr_shuffle_reference(plan, bg),
                                   rtol=1e-6, atol=1e-6)


def test_shuffle_rejects_unported_lanes_and_bad_shapes():
    plan = make_plan(2, 3, 4)
    c = torch.zeros((6, 2, 2, 6, 4))
    for dtype in (torch.float64, torch.int16):
        with pytest.raises(TypeError, match="supported payload dtypes"):
            camr_shuffle(plan, c.to(dtype))
    with pytest.raises(ValueError, match="router"):
        camr_shuffle(plan, c, router="nope")
    with pytest.raises(ValueError, match="mode"):
        camr_shuffle(plan, c, mode="nope")
    with pytest.raises(ValueError, match="codec"):
        camr_shuffle(plan, c, codec="nope")
    for kw in (dict(mode="nope"), dict(codec="nope"), dict(router="nope")):
        with pytest.raises(ValueError, match=next(iter(kw))):
            ShuffleStream(2, 3, 4, device="cpu", **kw)
    with pytest.raises(TypeError):
        camr_shuffle(plan, c.double())
    with pytest.raises(ValueError):
        camr_shuffle(plan, c[..., :2])
    with pytest.raises(ValueError):
        make_plan(2, 3, 5)


@pytest.mark.parametrize("q,k", QK)
def test_collective_bytes_match_reference(q, k):
    d = (k - 1) * 6
    port, ref = make_plan(q, k, d), jcoll.make_plan(q, k, d)
    assert camr_collective_bytes(port) == jcoll.camr_collective_bytes(ref)
    assert (camr_collective_bytes(port, dtype=torch.bfloat16)
            == jcoll.camr_collective_bytes(ref, dtype="bfloat16"))


def test_shuffle_stream_reuses_one_executor():
    """One stream serves both wire lanes: the device tables count packet
    rows, not lanes, so a bf16 wave reuses the f32 waves' executor."""
    q, k, d = 3, 3, 6
    stream = ShuffleStream(q, k, d, device="cpu", router="ppermute")
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(9)
    for _ in range(3):
        bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
        c = torch.from_numpy(scatter_contributions(plan, bg))
        got = stream.sync(c)
        assert torch.equal(got.view(torch.int32),
                           camr_shuffle(plan, c).view(torch.int32))
    cb = c.bfloat16()
    got = stream.sync(cb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       camr_shuffle(plan, cb, router="ppermute")
                       .view(torch.int16))
    st = stream.stats()
    assert st["dispatches"] == 4 and st["compiles"] == 1, st
    with pytest.raises(ValueError):
        stream.sync(c[..., :2])
    # a stream in another mode and codec runs them, to the same bits
    looped = ShuffleStream(q, k, d, device="cpu", mode="looped",
                           codec="multipass")
    assert torch.equal(looped.sync(cb).view(torch.int16),
                       got.view(torch.int16))
    assert looped.stats()["mode"] == "looped"
    assert looped.stats()["codec"] == "multipass"
    assert looped._executor().permutations["stage12"] == \
        expected_collective_calls(plan, "looped")["stage12"]


def test_tables_are_built_for_the_lanes_a_shuffle_runs():
    """The fused batched shuffle builds no multipass or looped tables;
    another codec or mode adds its own to the same cached set."""
    plan = make_plan(2, 3, 4)
    c = torch.zeros((plan.K, plan.J_own, 2, plan.K, 4))
    camr_shuffle(plan, c)
    (tabs,) = plan._tables.values()
    st = tabs["stages"][1]
    assert st["parts"] == {"fused", "batched"}
    assert "cancel_mask" not in st and "loop_src" not in st
    camr_shuffle(plan, c, mode="looped", codec="multipass")
    assert list(plan._tables.values()) == [tabs]
    assert st["parts"] == {"fused", "batched", "multipass", "looped"}
    assert "cancel_mask" in st and "loop_src" in st


def test_shuffle_stream_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShuffleStream(2, 3, 4)


# the JAX executor with its Pallas codec kernels (interpret mode) on a
# 6-device CPU mesh, against the port on the same contributions
_RUN_JAX = textwrap.dedent("""
    import numpy as np, jax
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.core.collective import make_plan, camr_shuffle, \\
        scatter_contributions
    import ml_dtypes
    q, k, d = 2, 3, {d}
    plan = make_plan(q, k, d); K = plan.K
    bg = np.load({path!r})
    if {packed}:
        bg = bg.astype(ml_dtypes.bfloat16)
    contribs = scatter_contributions(plan, bg)
    mesh = make_mesh((K,), ('camr',))
    outs = []
    for router in ('all_to_all', 'ppermute'):
        f = jax.jit(shard_map(
            lambda c: camr_shuffle(plan, c[0], axis_name='camr',
                                   router=router, use_kernels=True)[None],
            mesh=mesh, in_specs=P('camr'), out_specs=P('camr')))
        outs.append(np.asarray(f(contribs)))
    outs = np.stack(outs)
    if {packed}:            # saved as u16 bits (np.save drops bfloat16)
        assert outs.dtype == ml_dtypes.bfloat16, outs.dtype
        outs = outs.view(np.uint16)
    np.save({out!r}, outs)
    print('OK')
""")


def _jax_mesh_shuffle(tmp_path, bg, packed):
    """Both routers' outputs of the JAX executor on ``bg`` (f32 normal
    values; cast to bf16 there when ``packed``)."""
    np.save(tmp_path / "bg.npy", bg)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=6")
    code = _RUN_JAX.format(d=bg.shape[-1], path=str(tmp_path / "bg.npy"),
                           out=str(tmp_path / "out.npy"), packed=packed)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return np.load(tmp_path / "out.npy")


@pytest.mark.parametrize("d", [14])
def test_shuffle_bitwise_equals_jax_pallas_mesh(tmp_path, d):
    q, k = 2, 3
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(23)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    jax_out = _jax_mesh_shuffle(tmp_path, bg, packed=False)
    c = torch.from_numpy(scatter_contributions(plan, bg))
    for i, router in enumerate(("all_to_all", "ppermute")):
        got = camr_shuffle(plan, c, router=router).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      jax_out[i].view(np.uint32))


def test_packed_shuffle_bitwise_equals_jax_pallas_mesh(tmp_path):
    """bf16 at (2, 3) with trailing pad lanes (d = 6: 6 lanes per shard
    padded to 8), through the JAX executor's 16-bit Pallas kernels."""
    q, k, d = 2, 3, 6
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(29)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    jax_out = _jax_mesh_shuffle(tmp_path, bg, packed=True)   # u16 bits
    c = _packed_contribs(plan, bg.astype(ml_dtypes.bfloat16), torch.bfloat16)
    for i, router in enumerate(("all_to_all", "ppermute")):
        got = camr_shuffle(plan, c, router=router)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16), jax_out[i])


# the JAX executor's debug dict (Pallas codec kernels, interpret mode) in
# two lanes, and its uncoded baseline, on a 6-device CPU mesh
_RUN_JAX_DEBUG = textwrap.dedent("""
    import numpy as np, jax
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.core.collective import make_plan, camr_shuffle, \\
        scatter_contributions, uncoded_reduce_scatter
    q, k, d = 2, 3, {d}
    plan = make_plan(q, k, d); K = plan.K
    contribs = scatter_contributions(plan, np.load({path!r}))
    mesh = make_mesh((K,), ('camr',))
    out = {{}}
    for mode, codec in {lanes!r}:
        f = jax.jit(shard_map(
            lambda c: {{key: v[None] for key, v in camr_shuffle(
                plan, c[0], axis_name='camr', mode=mode, codec=codec,
                use_kernels=True, debug=True).items()}},
            mesh=mesh, in_specs=P('camr'), out_specs=P('camr')))
        for key, v in f(contribs).items():
            out[f'{{mode}}-{{codec}}-{{key}}'] = np.asarray(v)
    g = jax.jit(shard_map(
        lambda c: uncoded_reduce_scatter(c[0], axis_name='camr',
                                         plan=plan)[None],
        mesh=mesh, in_specs=P('camr'), out_specs=P('camr')))
    out['uncoded'] = np.asarray(g(contribs))
    np.savez({out!r}, **out)
    print('OK')
""")

DEBUG_LANES = (("batched", "multipass"), ("looped", "fused"))


def test_debug_and_uncoded_match_jax_mesh(tmp_path):
    """Every entry of the debug dict, the rows each device does not own
    included, bitwise; the uncoded baseline within rtol 1e-6."""
    q, k, d = 2, 3, 10
    plan = make_plan(q, k, d)
    rng = np.random.default_rng(31)
    bg = rng.standard_normal((plan.J, k, plan.K, d)).astype(np.float32)
    np.save(tmp_path / "bg.npy", bg)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=6")
    code = _RUN_JAX_DEBUG.format(d=d, path=str(tmp_path / "bg.npy"),
                                 out=str(tmp_path / "out.npz"),
                                 lanes=DEBUG_LANES)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    c = torch.from_numpy(scatter_contributions(plan, bg))
    for mode, codec in DEBUG_LANES:
        got = camr_shuffle(plan, c, mode=mode, codec=codec, debug=True)
        assert sorted(got) == ["is_own", "out", "own_sum", "stage1",
                               "stage2", "stage3"]
        for key, v in got.items():
            w = want[f"{mode}-{codec}-{key}"]
            assert tuple(v.shape) == w.shape, key
            if key == "is_own":
                np.testing.assert_array_equal(v.numpy(), w)
            else:
                np.testing.assert_array_equal(
                    v.numpy().view(np.uint32), w.view(np.uint32),
                    err_msg=f"{mode} {codec} {key}")
    np.testing.assert_allclose(uncoded_reduce_scatter(c, plan=plan).numpy(),
                               want["uncoded"], rtol=1e-6, atol=1e-7)
