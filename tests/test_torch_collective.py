"""The port's stacked-device coded shuffle on the CPU (plain codec
versions) against the references: BITWISE equal to the numpy
``CAMREngine``'s reduce results for five (q, k), both routers and odd
and even packet widths, on the f32 lane and on the packed 16-bit lane
(bf16 and f16, with and without trailing pad lanes); bitwise equal to
the JAX ``camr_shuffle`` with its Pallas kernels (interpret mode) on a
6-device CPU mesh, on both lanes; and the byte accounting equal to the
JAX package's. No tolerance anywhere: XOR delivery is lossless and
assembly folds in the engine's order, in the payload dtype."""

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
from repro_torch.core.collective import (ShuffleStream, camr_collective_bytes,
                                         camr_shuffle, camr_shuffle_reference,
                                         make_plan, scatter_contributions)

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


def test_shuffle_rejects_unported_lanes_and_bad_shapes():
    plan = make_plan(2, 3, 4)
    c = torch.zeros((6, 2, 2, 6, 4))
    for dtype in (torch.float64, torch.int16):
        with pytest.raises(TypeError, match="supported payload dtypes"):
            camr_shuffle(plan, c.to(dtype))
    with pytest.raises(ValueError, match="router"):
        camr_shuffle(plan, c, router="nope")
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
