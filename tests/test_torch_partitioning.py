"""The port's partitioning layer (``repro_torch.launch.partitioning``, the
production meshes of ``launch/mesh.py``, the spec trees of
``models/{layers,lm}.py`` and the sharded step builders of
``launch/steps.py``) against the JAX package's, on the CPU.

* ``lm.param_specs`` / ``lm.cache_specs`` equal JAX's for every arch:
  the same tree, the same logical-axis tuples.
* ``logical_to_parts`` equals JAX's ``logical_to_spec`` under
  ``DEFAULT_RULES``, ``no_seq_parallel_rules`` and the multipod data
  axes; the DTensor placements of ``logical_to_spec`` are JAX's
  ``PartitionSpec`` read mesh dimension by mesh dimension, the axes that
  do not divide dropped; ``constrain`` is a no-op on a plain tensor and
  without a context.
* On a (2, 2) mesh simulated in one process
  (``torch.distributed._local_tensor.LocalTensorMode`` over a fake
  group), the sharded train step's loss and ``gnorm`` equal the
  one-device step's (rtol 1e-5), and the prefill logits and cache and a
  decode step's logits and cache too (rtol 1e-5, atol 1e-5 and 5e-5 for
  the SSM state, summed in another order), at reduced granite, mixtral
  (``tp`` experts), moonshot (``ep``; at capacity factor 1.0, so that
  tokens drop, against the virtual-mesh lane ``lm.*(mesh=(2, 2))``,
  since the capacity is per local token block) and mamba2. Each leaf's
  gradient is held in the moments after the first step (``mu = 0.1 g``,
  ``nu = 0.05 g^2`` from zero; within 2e-5 of the leaf's largest
  element); the updated parameters within 6e-5 everywhere and 1e-6
  where the gradient is settled (AdamW moves an element by ``lr *
  sign(g)``, so an element whose gradient is rounding noise moves by up
  to the learning rate 3e-4 either way).
* One JAX subprocess on 4 host devices compiles JAX's ``build_step`` on
  a (2, 2) mesh for the same four arches and three kinds and runs each
  on the port's arguments: the port's sharded step gives JAX's loss
  (rtol 1e-5), ``gnorm`` (rtol 1e-4), moments and updated parameters (as
  above, and within twice the learning rate where the gradient is
  noise), logits and caches (rtol / atol 1e-4, as
  ``test_torch_dryrun.py::test_step_matches_jax``). The subprocess
  starts with the module and runs beside the port's tests.
* The same compiles' ``memory_analysis()``: the port's per-device
  argument, output and alias bytes (its ``meta`` trace of rank 0 over a
  fake group) equal JAX's with the one offset ``test_torch_dryrun.py``
  names (XLA's 8-byte result-tuple pointer per output); the per-device
  dot FLOPs of granite's and mixtral's train step and granite's decode
  step equal the HLO's; mamba2's differ in two products a layer pass
  that XLA splits over the model axis and the port does not (pinned
  product by product, with the SSD scan replaced by a dot-free stand-in
  in both packages).
* A reduced cell traces on the fake 256- and 512-device meshes:
  ``devices`` 256 / 512, and its per-device argument bytes equal the sum
  of the local shard sizes, computed from JAX's specs and rules.
"""

import contextlib
import copy
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import partitioning as jpt
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.launch import dryrun, partitioning as pt, steps
from repro_torch.launch.mesh import data_axes, fake_group, mesh_devices
from repro_torch.models import layers, lm
from repro_torch.optim import AdamWState, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: reduced steps: (seq_len, global_batch)
T, B = 64, 4
#: the position a reduced decode step writes and attends up to
DECODE_AT = 40
#: (port, JAX) per-device dot FLOPs of reduced mamba2's train step on the
#: (2, 2) mesh with the SSD scan replaced by a dot-free stand-in in both:
#: XLA computes the block's two projections whose outputs the model axis
#: does not split (w_bc [d, 2S] and w_dt [d, H], JAX spec (EMBED, None))
#: on each model shard's half of the sequence-split residual stream and
#: gathers their small outputs; the port gathers the stream first (the
#: all-gather that opens a Megatron-SP block) and computes them whole on
#: each model shard: 3 products (forward, two backward) a projection a
#: layer, each twice XLA's
MAMBA2_MESH_DOTS = (28_704_768, 26_935_296)
#: the same step with the scan: the rest is the chunked SSD scan, which
#: differs on one device too (``test_torch_dryrun.py``)
MAMBA2_MESH_DOTS_SCAN = (39_714_816, 36_929_536)
#: per-device collective result bytes by kind of reduced granite's train
#: step on the (2, 2) mesh, (port, JAX): two plans. The port's are JAX's
#: constraints read as Megatron-SP (a block's input all-gathered over the
#: sequence, a row-parallel output reduce-scattered back, each FSDP
#: weight all-gathered over data and its gradient reduce-scattered);
#: XLA's partitioner all-reduces the gradients and the row-parallel
#: outputs instead and reshards q / k / v between sequence and heads by
#: all-to-alls and permutes
GRANITE_MESH_COLLECTIVES = (
    {"all-gather": 541_184, "reduce-scatter": 287_488, "all-reduce": 3_096},
    {"all-gather": 1_163_776, "all-reduce": 870_992, "all-to-all": 98_304,
     "collective-permute": 49_152})


def _spec_items(tree, path=()):
    """{path: axes tuple} of a spec tree (JAX's leaves are tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_spec_items(tree[k], path + (k,)))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_and_cache_specs_match_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert _spec_items(lm.param_specs(cfg)) == \
        _spec_items(jlm.param_specs(jcfg))
    assert _spec_items(lm.cache_specs(cfg)) == \
        _spec_items(jlm.cache_specs(jcfg))
    # the same tree as the parameters and the cache themselves
    assert set(_spec_items(lm.param_specs(cfg))) == set(
        _spec_items(lm.init_params(cfg, None, device="meta")))
    cache = lm.init_cache(cfg, 2, 8, device="meta")
    assert set(_spec_items(lm.cache_specs(cfg))) == set(_spec_items(cache))


#: activation axes the models constrain to, beside every spec leaf
ACTIVATIONS = [("batch", "seq", "embed"), ("batch", "heads", None, None),
               ("batch", None, "seq_kv", None), ("batch", None, "vocab"),
               ("batch", "ssm_heads", None, None), ("batch", None, "embed"),
               (None, "batch", "ssm_heads", None, None), ()]


def _all_axes():
    out = set(ACTIVATIONS)
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        out |= set(_spec_items(lm.param_specs(cfg)).values())
        out |= set(_spec_items(lm.cache_specs(cfg)).values())
    return sorted(out, key=repr)


def _small_mesh(shape):
    """A production mesh's axis names over ``shape``'s devices (the
    (2, 2) and (2, 2, 2) twins of the (16, 16) and (2, 16, 16) meshes) on
    the default group, which must hold that many ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    names = ("pod", "data", "model")[-len(shape):]
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


@contextlib.contextmanager
def _mesh(shape):
    """A fake group of the mesh's size (torn down after) and the mesh."""
    with fake_group(math.prod(shape)):
        yield _small_mesh(shape)


def _placements_of(spec: P, mesh, shape) -> tuple:
    """JAX's PartitionSpec as one placement per mesh dimension: ``Shard(d)``
    where tensor dim ``d`` names that axis (and divides the axes it
    names), written independently of the port's reading."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = [Replicate()] * mesh.ndim
    for d, p in enumerate(tuple(spec)):
        names = () if p is None else (p if isinstance(p, tuple) else (p,))
        if names and shape[d] % math.prod(sizes[a] for a in names) == 0:
            for a in names:
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


@pytest.mark.parametrize("rules", ["default", "no_seq_parallel", "multipod"])
def test_logical_to_spec_matches_jax(rules):
    multi = rules == "multipod"
    shape = (2, 2, 2) if multi else (2, 2)
    daxes = ("pod", "data") if multi else ("data",)
    rs = (jpt.no_seq_parallel_rules() if rules == "no_seq_parallel"
          else None)
    prs = pt.no_seq_parallel_rules() if rules == "no_seq_parallel" else None
    rng = np.random.default_rng(0)
    with _mesh(shape) as mesh:
        assert data_axes(mesh) == daxes
        assert mesh_devices(mesh) == math.prod(shape)
        for axes in _all_axes():
            with jpt.axis_rules(None, rs, data_axes=daxes):
                want = jpt.logical_to_spec(axes)
            with pt.axis_rules(mesh, prs, data_axes=daxes):
                assert pt.logical_to_parts(axes) == tuple(want), axes
                # placements, whole and with a dimension that does not
                # divide (an odd size) dropped
                dims = tuple(int(rng.choice([4, 8, 3])) for _ in axes)
                assert pt.logical_to_spec(axes, dims) == \
                    _placements_of(want, mesh, dims), (axes, dims)
                if axes:
                    assert pt.named_sharding(axes) == _placements_of(
                        want, mesh, (8,) * len(axes))
        with pt.axis_rules(mesh, prs, data_axes=daxes):
            tree = pt.tree_shardings(lm.param_specs(configs.reduced(
                configs.get_config("granite_3_2b"))))
            assert tree["norm_f"] == tuple(pt.logical_to_spec((None,)))
    # no context: JAX's empty spec, and constrain is a no-op
    assert pt.logical_to_spec(("batch",)) == () and pt.current_mesh() is None
    x = torch.randn(4, 8)
    assert pt.constrain(x, ("batch", "seq")) is x


def test_constrain_is_a_no_op_on_plain_tensors_inside_a_context():
    with _mesh((2, 2)) as mesh:
        x = torch.randn(4, 8, 2)
        with pt.axis_rules(mesh):
            assert pt.constrain(x, ("batch", "seq", "embed")) is x
            assert pt.gather_data(x) is x and pt.like(x, x) is x


# --------------------------------------------------------------------- #
# the sharded steps on a simulated (2, 2) mesh, and JAX's
# --------------------------------------------------------------------- #
#: (arch, config overrides) of the sharded-step comparisons
STEP_ARCHS = [("granite_3_2b", {}), ("mixtral_8x7b", {}),
              ("moonshot_v1_16b_a3b", {"moe_capacity_factor": 1.0}),
              ("mamba2_1p3b", {})]
KINDS = ("train", "prefill", "decode")
TOL = dict(rtol=1e-5, atol=1e-5)
#: the port against JAX: ``test_torch_dryrun.py::test_step_matches_jax``'s
#: tolerances (the same f32 math summed in other orders)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
#: the moments after the first step from zero, ``mu = (1 - b1) g`` and
#: ``nu = (1 - b2) g^2`` of the clipped gradient ``g``: each leaf's
#: gradient, element by element, within this share of the leaf's largest
#: element (its sums run in other orders: at most 6e-6 measured)
MOMENT_RTOL = 2e-5
#: the learning rate of the steps
LR = 3e-4
#: updated parameters where the gradient is settled (its element above
#: twice the moments' tolerance, so that its sign is the reference's):
#: AdamW moves each such element by ``lr * sign(g)`` plus the decay
SETTLED_ATOL = 1e-6
#: updated parameters against the one-device step everywhere: AdamW
#: normalises each element of the gradient, so an element whose gradient
#: is rounding noise moves by up to the learning rate either way
PARAM_ATOL = 6e-5


def _local_mode(world):
    from torch.distributed._local_tensor import LocalTensorMode
    return LocalTensorMode(world)


def _per_rank(tree, world):
    """Whole tensors made one copy a simulated rank (a tensor that all
    ranks share would take a rank's in-place update once per rank)."""
    from torch.distributed._local_tensor import LocalTensor
    if isinstance(tree, AdamWState):
        return AdamWState(step=_per_rank(tree.step, world),
                          mu=_per_rank(tree.mu, world),
                          nu=_per_rank(tree.nu, world))
    if isinstance(tree, dict):
        return {k: _per_rank(v, world) for k, v in tree.items()}
    return LocalTensor({r: tree.clone() for r in range(world)})


def _whole(t):
    """A DTensor of the simulated ranks as rank 0's whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t._local_tensors[0] if hasattr(t, "_local_tensors") else t


def _cfg(arch):
    kw = dict(STEP_ARCHS)[arch]
    return configs.reduced(configs.get_config(arch)).replace(remat="none",
                                                            **kw)


@functools.lru_cache(maxsize=None)
def _args(arch, kind):
    """A reduced step's shape, its one-device bundle and arguments (every
    user copies them: the steps update their arguments in place)."""
    cfg = _cfg(arch)
    shape = configs.ShapeSpec(f"{kind}_small", T, B, kind)
    one = steps.build_step(cfg, shape, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(3)
    ids = lambda *s: torch.randint(0, cfg.vocab, s, generator=gen,   # noqa
                                   dtype=torch.int32)
    if kind == "decode":
        cache = one.args[1]
        for t in tree_leaves(cache):
            t.normal_(generator=gen)
        args = (one.args[0], cache, ids(B, 1),
                torch.tensor(DECODE_AT, dtype=torch.int32))
    else:
        batch = {k: ids(B, T) for k in one.args[-1]}
        args = (*one.args[:-1], batch)
    return shape, one, args


def _reference(arch, kind):
    """The one-device step on a copy of the arguments; moonshot's expert
    blocks on the virtual (2, 2) mesh (``lm.*(mesh=)``), since its
    capacity is per local token block."""
    cfg = _cfg(arch)
    shape, one, args = _args(arch, kind)
    args = copy.deepcopy(args)
    if arch != "moonshot_v1_16b_a3b":
        return one.fn(*args)
    saved = (lm.train_loss, lm.prefill, lm.decode_step)
    lm.train_loss = lambda c, p, b: saved[0](c, p, b, mesh=(2, 2))
    lm.prefill = lambda c, p, b: saved[1](c, p, b, mesh=(2, 2))
    lm.decode_step = lambda c, p, ca, t, i: saved[2](c, p, ca, t, i,
                                                     mesh=(2, 2))
    try:
        return steps.build_step(cfg, shape, device="cpu").fn(*args)
    finally:
        lm.train_loss, lm.prefill, lm.decode_step = saved


def _np(tree):
    return [np.asarray(_whole(t)) for t in tree_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _sharded(arch, kind) -> dict:
    """The port's sharded step on a (2, 2) mesh simulated in one process,
    its outputs as whole numpy arrays (leaves in ``tree_leaves`` order),
    each output's placements checked against the specs first."""
    cfg = _cfg(arch)
    shape, _, args = _args(arch, kind)
    with fake_group(4), _local_mode(4):
        mesh = _small_mesh((2, 2))
        sharded = steps.shard_args(cfg, shape, mesh, tuple(
            _per_rank(a, 4) for a in copy.deepcopy(args)))
        bundle = steps.build_step(cfg, shape, device="cpu", mesh=mesh)
        assert bundle.mesh is mesh
        got = bundle.fn(*sharded)
        with steps._rules(mesh):
            if kind == "train":
                for p, s in zip(tree_leaves(got[0]),
                                tree_leaves(lm.param_specs(cfg))):
                    assert tuple(p.placements) == pt.placements_for(
                        s, p.shape)
                return dict(loss=_np(got[2]["loss"])[0],
                            gnorm=_np(got[2]["gnorm"])[0],
                            params=_np(got[0]), mu=_np(got[1].mu),
                            nu=_np(got[1].nu))
            logits, cache = got
            assert tuple(logits.placements) == pt.placements_for(
                ("batch", None, "vocab"), logits.shape)
            return dict(logits=_np(logits)[0], cache=_np(cache))


def _train_close(got: dict, params, mu, nu):
    """The port's updated parameters and moments against a reference's
    (leaf lists): the moments (each gradient) within ``MOMENT_RTOL`` of
    each leaf's largest element, the parameters within ``SETTLED_ATOL``
    where the reference's gradient is settled and within ``2 * LR`` (a
    noise gradient's sign either way) where it is not."""
    for g, w in zip(got["mu"] + got["nu"], mu + nu):
        np.testing.assert_allclose(g, w, rtol=MOMENT_RTOL,
                                   atol=MOMENT_RTOL * np.abs(w).max())
    for g, w, m in zip(got["params"], params, mu):
        settled = np.abs(m) > 2 * MOMENT_RTOL * np.abs(m).max()
        assert settled.any()
        np.testing.assert_allclose(g[settled], w[settled], rtol=0,
                                   atol=SETTLED_ATOL)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR + SETTLED_ATOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch,kw", STEP_ARCHS, ids=[a for a, _ in STEP_ARCHS])
def test_sharded_step_matches_one_device(arch, kw, kind):
    got, want = _sharded(arch, kind), _reference(arch, kind)
    if kind == "train":
        np.testing.assert_allclose(got["loss"], want[2]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], want[2]["gnorm"],
                                   rtol=1e-5)
        for p, w in zip(got["params"], _np(want[0])):
            np.testing.assert_allclose(p, w, rtol=1e-5, atol=PARAM_ATOL)
        _train_close(got, _np(want[0]), _np(want[1].mu), _np(want[1].nu))
        return
    np.testing.assert_allclose(got["logits"], want[0], **TOL)
    for c, w in zip(got["cache"], _np(want[1])):
        np.testing.assert_allclose(c, w, rtol=1e-5,
                                   atol=5e-5 if c.ndim == 5
                                   and arch == "mamba2_1p3b" else 1e-5)


# --------------------------------------------------------------------- #
# JAX's sharded steps on a (2, 2) mesh: values, bytes, FLOPs
# --------------------------------------------------------------------- #
#: (arch, kind) of the (2, 2) compiles whose bytes and dots are compared
MEM_CELLS = [("granite_3_2b", "train"), ("granite_3_2b", "prefill"),
             ("granite_3_2b", "decode"), ("mixtral_8x7b", "train"),
             ("mamba2_1p3b", "train")]

_JAX_MESH = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.nice(10)             # the port's tests run meanwhile in the parent
    sys.path[:0] = [sys.argv[1], sys.argv[2]]
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro import configs as jc
    from repro.launch.hlo_stats import collective_stats
    from repro.launch.steps import build_step
    from repro.models import layers as jlayers
    from repro.optim import AdamWState
    from test_torch_dryrun import hlo_dot_flops_each
    T, B, AT, archs, mem_cells = json.loads(sys.argv[3])
    inputs = dict(np.load(sys.argv[4]))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))

    def tree(prefix):
        out = {}
        for key, v in inputs.items():
            if key.startswith(prefix):
                *path, leaf = key[len(prefix):].split("/")
                t = out
                for k in path:
                    t = t.setdefault(k, {})
                t[leaf] = v
        return out

    values = {}

    def keep(name, t):
        if isinstance(t, dict):
            for k, v in t.items():
                keep(name + "/" + k, v)
        else:
            values[name] = np.asarray(t)

    def compile_(arch, kind, kw):
        cfg = jc.reduced(jc.get_config(arch)).replace(
            scan_unroll=True, remat="none", **kw)
        b = build_step(cfg, mesh, jc.ShapeSpec("s", T, B, kind))
        with mesh:
            return b.fn.lower(*b.args).compile()

    stats = {}
    for arch, kw in archs:
        for kind in ("train", "prefill", "decode"):
            name = arch + "-" + kind
            c = compile_(arch, kind, kw)
            if [arch, kind] in mem_cells:
                m = c.memory_analysis()
                stats[name] = dict(
                    arg=m.argument_size_in_bytes,
                    out=m.output_size_in_bytes,
                    alias=m.alias_size_in_bytes,
                    dots=sorted(hlo_dot_flops_each(c.as_text()).items()),
                    coll=collective_stats(c.as_text()).bytes_by_kind)
            params = tree(name + "/params/")
            with mesh:
                if kind == "train":
                    zeros = jax.tree.map(np.zeros_like, params)
                    p, opt, m = c(params, AdamWState(
                        step=np.int32(0), mu=zeros, nu=zeros),
                        tree(name + "/batch/"))
                    keep(name + "/params", p)
                    keep(name + "/mu", opt.mu)
                    keep(name + "/nu", opt.nu)
                    keep(name + "/loss", m["loss"])
                    keep(name + "/gnorm", m["gnorm"])
                    continue
                if kind == "prefill":
                    logits, cache = c(params, tree(name + "/batch/"))
                else:
                    logits, cache = c(params, tree(name + "/cache/"),
                                      inputs[name + "/tokens"], np.int32(AT))
            keep(name + "/logits", logits)
            keep(name + "/cache", cache)

    def stand_in(x, a, b, c, **kw):
        return x * (a[..., None] + jnp.sum(c, -1)[:, :, None, None]
                    ).astype(x.dtype)
    jlayers.ops.ssd = stand_in
    stats["mamba2-stand-in"] = sorted(hlo_dot_flops_each(
        compile_("mamba2_1p3b", "train", {}).as_text()).items())
    np.savez(sys.argv[5], **values)
    print(json.dumps(stats))
""")


def _flat(out: dict, name: str, tree):
    """The leaves of a tree of tensors into ``out`` under ``name/path``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(out, f"{name}/{k}", v)
    else:
        out[name] = tree.numpy()


def _unflat(values: dict, prefix: str) -> dict:
    out = {}
    for key, v in values.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            t = out
            for k in path:
                t = t.setdefault(k, {})
            t[leaf] = v
    return out


class _JaxRun:
    """JAX's (2, 2) compiles and steps in a subprocess on 4 host
    devices, fed the port's arguments (``_args``) and started when the
    module's first test starts; ``result()`` waits for its stats and
    outputs."""

    def __init__(self, tmp):
        inputs = {}
        for arch, _ in STEP_ARCHS:
            for kind in KINDS:
                name, (_, _, args) = f"{arch}-{kind}", _args(arch, kind)
                _flat(inputs, name + "/params", args[0])
                if kind == "decode":
                    _flat(inputs, name + "/cache", args[1])
                    inputs[name + "/tokens"] = args[2].numpy()
                else:
                    _flat(inputs, name + "/batch", args[-1])
        src, self.out = os.path.join(tmp, "in.npz"), os.path.join(tmp,
                                                                  "out.npz")
        np.savez(src, **inputs)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_MESH, os.path.join(ROOT, "src"),
             os.path.join(ROOT, "tests"),
             json.dumps([T, B, DECODE_AT, STEP_ARCHS, MEM_CELLS]), src,
             self.out], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=""))
        self._res = None

    def result(self):
        if self._res is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            self._res = (json.loads(out.strip().splitlines()[-1]),
                         dict(np.load(self.out)))
        return self._res

    def stats(self, name):
        return self.result()[0][name]

    def values(self, name) -> dict:
        return _unflat(self.result()[1], name + "/")


@pytest.fixture(scope="module", autouse=True)
def jax_mesh22(tmp_path_factory):
    run = _JaxRun(str(tmp_path_factory.mktemp("jax_mesh22")))
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", [a for a, _ in STEP_ARCHS])
def test_sharded_step_matches_jax(jax_mesh22, arch, kind):
    """The port's sharded step against JAX's ``build_step`` on a (2, 2)
    mesh, the same arguments through both: loss, gnorm, updated
    parameters and each leaf's gradient (in the moments), or the logits
    and the cache. moonshot's ``ep`` dispatch runs at capacity factor
    1.0, so tokens drop by each local block's capacity in both."""
    got, want = _sharded(arch, kind), jax_mesh22.values(f"{arch}-{kind}")
    if kind == "train":
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-4)
        _train_close(got, *(tree_leaves(want[k])
                            for k in ("params", "mu", "nu")))
        return
    np.testing.assert_allclose(got["logits"], want["logits"], **JAX_TOL)
    want_c = tree_leaves(want["cache"])
    assert len(got["cache"]) == len(want_c)
    for c, w in zip(got["cache"], want_c):
        np.testing.assert_allclose(c, w, **JAX_TOL)


class _Products(dryrun.StepTracer):
    """The tracer, keeping each local product's FLOPs as a multiset."""

    def __init__(self, args=()):
        super().__init__(args)
        self.each = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and self.flops != before:
            n = self.flops - before
            self.each[n] = self.each.get(n, 0) + 1
        return out


def _port_mesh_trace(arch, kind, stand_in=False):
    cfg = configs.reduced(configs.get_config(arch)).replace(remat="none")
    shape = configs.ShapeSpec("s", T, B, kind)
    saved = layers.ssd_chunked
    if stand_in:
        layers.ssd_chunked = (lambda x, a, b, c, **kw: x * (
            a[..., None] + c.sum(-1)[:, :, None, None]).to(x.dtype))
    try:
        with _mesh((2, 2)) as mesh:
            bundle = steps.build_step(cfg, shape, device="meta", mesh=mesh)
            res = dryrun.trace_step(bundle)
            prods = _Products(bundle.args)
            with prods:
                bundle.fn(*steps.build_step(cfg, shape, device="meta",
                                            mesh=mesh).args)
    finally:
        layers.ssd_chunked = saved
    return res, prods.each


@pytest.mark.parametrize("cell", MEM_CELLS, ids="-".join)
def test_mesh_bytes_and_dots_match_jax_memory_analysis(jax_mesh22, cell):
    arch, kind = cell
    want = jax_mesh22.stats(f"{arch}-{kind}")
    res, each = _port_mesh_trace(arch, kind)
    mem = res["memory"]
    n_out = len(dryrun._tensors(res["out"]))
    assert mem["argument_bytes"] == want["arg"]
    assert mem["output_bytes"] + 8 * n_out == want["out"]
    assert mem["alias_bytes"] == want["alias"]
    dots = dict((int(k), v) for k, v in want["dots"])
    if arch == "mamba2_1p3b":
        got = (res["aten_flops"], sum(k * v for k, v in dots.items()))
        assert got == MAMBA2_MESH_DOTS_SCAN
    elif kind != "prefill":       # a prefill's attention is the kernel's
        assert res["aten_flops"] == sum(k * v for k, v in dots.items())
        assert each == dots
    assert res["collectives"]["total_bytes"] > 0
    assert set(res["collectives"]["wire_bytes_by_link"]) == {"nvlink"}


def test_mesh_meta_trace_counts_what_a_device_trace_counts():
    """Rank 0's train step on the (2, 2) mesh traced on ``meta`` and on
    real CPU tensors: the same argument, output, alias, temporary and
    peak bytes, FLOPs and collectives (a collective's ``wait_tensor``
    and autograd wrapper return their input on a device and an empty
    copy on ``meta``; the tracer counts neither copy)."""
    cfg = configs.reduced(configs.get_config("granite_3_2b")).replace(
        remat="none")
    shape = configs.ShapeSpec("s", T, B, "train")
    with _mesh((2, 2)) as mesh:
        got = {dev: dryrun.trace_step(steps.build_step(
            cfg, shape, device=dev, mesh=mesh)) for dev in ("meta", "cpu")}
    keys = lambda r: (r["memory"], r["cost"]["flops"],  # noqa
                      r["collectives"])
    assert keys(got["meta"]) == keys(got["cpu"])


def test_mesh_collectives_differ_from_xla_plan(jax_mesh22):
    res, _ = _port_mesh_trace("granite_3_2b", "train")
    got = (res["collectives"]["bytes_by_kind"],
           jax_mesh22.stats("granite_3_2b-train")["coll"])
    assert got == GRANITE_MESH_COLLECTIVES


def test_mamba2_mesh_dots_differ_in_the_unsplit_projections(jax_mesh22):
    _, each = _port_mesh_trace("mamba2_1p3b", "train", stand_in=True)
    want = dict((int(k), v) for k, v in jax_mesh22.stats("mamba2-stand-in"))
    got = (sum(k * v for k, v in each.items()),
           sum(k * v for k, v in want.items()))
    assert got == MAMBA2_MESH_DOTS
    port_only = {k: v - want.get(k, 0) for k, v in each.items()
                 if v > want.get(k, 0)}
    jax_only = {k: v - each.get(k, 0) for k, v in want.items()
                if v > each.get(k, 0)}
    # each product the port computes alone is twice one JAX computes
    # alone (the model axis is 2): w_bc's and w_dt's, three a layer
    assert port_only == {524_288: 6, 65_536: 6}
    assert {2 * k: v for k, v in jax_only.items()} == port_only


# --------------------------------------------------------------------- #
# the 256- and 512-device meshes
# --------------------------------------------------------------------- #
def _local_numel(shape, spec, sizes, rules, daxes) -> int:
    """A leaf's shard size by JAX's rules (``logical_to_spec`` under
    ``axis_rules``), each non-dividing axis dropped."""
    with jpt.axis_rules(None, rules, data_axes=daxes):
        parts = tuple(jpt.logical_to_spec(tuple(spec)))
    n = 1
    for d, dim in enumerate(shape):
        p = parts[d] if d < len(parts) else None
        names = () if p is None else (p if isinstance(p, tuple) else (p,))
        k = math.prod(sizes[a] for a in names)
        n *= dim // k if names and dim % k == 0 else dim
    return n


@pytest.mark.parametrize("mesh_kind,kind", [("single", "train"),
                                            ("multipod", "train"),
                                            ("multipod", "prefill")])
def test_reduced_cell_on_the_production_meshes(mesh_kind, kind):
    """Rank 0's trace of a reduced granite cell on the fake 256- and
    512-device meshes: 16 query heads split over model, 8 kv heads
    repeated to 16 (they cannot split); on multipod the batch splits
    over (pod, data) and the parameters only over data."""
    multi = mesh_kind == "multipod"
    over = dict(n_layers=1, d_model=256, n_heads=16, n_kv_heads=8,
                head_dim=16, d_ff=512, vocab=4096, loss_chunk=64,
                microbatches=1, remat="none")
    shape = configs.ShapeSpec(f"{kind}_small", 64, 32 if multi else 16,
                              kind)
    res = dryrun.run_cell("granite_3_2b", shape, mesh_kind, overrides=over)
    assert res["status"] == "ok" and res["mesh"] == mesh_kind
    assert res["devices"] == (512 if multi else 256)
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi
             else {"data": 16, "model": 16})
    daxes = ("pod", "data") if multi else ("data",)
    cfg = configs.get_config("granite_3_2b").replace(**over)
    leaves = _leaf_meta(lm.init_params(cfg, None, device="meta"))
    specs = _spec_items(lm.param_specs(cfg))
    local = {k: _local_numel(leaves[k][0], specs[k], sizes, None, daxes)
             for k in specs}
    args = sum(n * leaves[k][1] for k, n in local.items())
    if kind == "train":      # mu and nu (f32), the step (i32), labels
        args += 8 * sum(local.values()) + 4
    rows = shape.global_batch // math.prod(sizes[a] for a in daxes)
    n_ids = 2 if kind == "train" else 1      # tokens (i32) and labels
    args += n_ids * rows * shape.seq_len * 4
    assert res["memory"]["argument_bytes"] == args
    assert res["fits"] and res["collectives"]["wire_bytes_by_link"] == {
        "network": res["collectives"]["wire_bytes"]}
    if kind == "prefill":
        assert res["kernels"]["flash_attention"]["calls"] == 1


def _leaf_meta(tree, path=()):
    """{path: (shape, bytes an element)} of a parameter tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaf_meta(tree[k], path + (k,)))
        return out
    return {path: (tuple(tree.shape), tree.element_size())}
