"""Architecture configs of the port: a :class:`ModelConfig` twin of the
JAX package's ``repro.configs.ModelConfig`` without jax.

``torch_dtype`` takes the place of ``jdtype``; ``reduced(cfg)`` derives
the small same-family variant the CPU tests use. The architecture
fields are the JAX package's, and so are the two that set what the
train step of :mod:`repro_torch.launch.steps` computes:
``microbatches`` (gradient accumulation) and ``grad_sync_dtype`` (the
cast of f32 gradients before the update; the trainer's grad-sync lane).
``remat`` is JAX's too, with JAX's values and default: ``"block"``
(every config trains with it) checkpoints each pattern unit, each
encoder unit and each loss chunk of a training forward, whose backward
recomputes them (:mod:`repro_torch.models.lm`); ``"none"`` keeps every
activation. Switch it with ``cfg.replace(remat=...)``. The other XLA
execution knobs (``use_pallas``, ``scan_unroll``, ``attn_block``,
``ssm_chunk``, ``grad_sync``) have no counterpart here (the device
picks the kernel; the SSD chunk is the ``ssd_scan`` kernel's constant,
64, mamba2's and zamba2's ``ssm_chunk``). ``moe_shard_mode`` stays: on
one card it selects the lane of
:func:`repro_torch.models.layers.moe_block` over a virtual ``(n_data,
n_model)`` mesh and nothing else. The port ships every arch
of the JAX zoo (:data:`ARCHS`): the dense ``granite_3_2b``,
``gemma2_2b``, ``internlm2_20b`` and ``mistral_large_123b``, the MoE
``mixtral_8x7b`` and ``moonshot_v1_16b_a3b``, the SSM ``mamba2_1p3b``
and the hybrid ``zamba2_2p7b``, each served and trained, and the
enc-dec ``seamless_m4t_large_v2`` (audio frames) and the ViT-frontend
``internvl2_26b`` (patches), served through the legacy host loop only,
as in the JAX package, whose token pipeline carries no frames or
patches to train them on. :data:`SHAPES` are the JAX package's four
step shapes; :func:`input_specs` builds a step's inputs on a device
(``"meta"``: shapes and dtypes only, nothing allocated: the dry run's
stand-ins).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

import torch

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCHS", "REMAT_MODES",
           "get_config", "reduced", "list_archs", "shape_supported",
           "input_specs"]

#: the values of ``ModelConfig.remat``
REMAT_MODES = ("none", "block")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int               # total sublayers (pattern * repeats)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # layer stacking: `pattern` is the repeating unit of sublayer kinds
    #   'attn'        causal (optionally windowed) attention + MLP/MoE
    #   'local'       sliding-window attention + MLP (gemma2 alternation)
    #   'ssm'         Mamba2 SSD block
    #   'shared_attn' attention block with weights SHARED across repeats
    pattern: tuple = ("attn",)
    rope_theta: float = 1e4
    window: int | None = None           # SWA width for 'attn' layers
    local_window: int | None = None     # width for 'local' layers
    attn_softcap: float | None = None
    final_softcap: float | None = None
    mlp_act: str = "swiglu"             # swiglu | geglu
    tie_embeddings: bool = False
    scale_embed: bool = False           # gemma2 sqrt(d) embedding scale
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    #: ep | tp: how ``layers.moe_block`` splits the experts over the
    #: model axis of a virtual mesh (experts, or each expert's d_ff)
    moe_shard_mode: str = "ep"
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_inner: int = 0
    # enc-dec
    n_enc_layers: int = 0
    # modality frontend stub
    frontend: str | None = None         # vit | audio
    frontend_dim: int = 0               # precomputed feature dim
    frontend_len: int = 0               # prefix length (vlm patches)
    # numerics
    dtype: str = "bfloat16"
    remat: str = "block"                # none | block
    loss_chunk: int = 1024              # vocab-logit seq chunking
    microbatches: int = 1               # grad accumulation in the train step
    grad_sync_dtype: str = "float32"    # float32 | bfloat16 (packed lane)

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"{self.name}: remat {self.remat!r} (choose "
                             f"from {', '.join(REMAT_MODES)})")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding/logit table padded to 128; logits beyond ``vocab``
        are masked in the loss."""
        return -(-self.vocab // 128) * 128

    @property
    def repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not a multiple of "
            f"pattern {self.pattern}")
        return self.n_layers // len(self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """The JAX config's closed-form parameter count (the examples
        print it); ``active_only`` counts an MoE layer's routed experts
        only."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        mlp = 3 * d * f
        if self.n_experts:
            e = self.experts_per_token if active_only else self.n_experts
            mlp = 3 * d * f * e + d * self.n_experts  # experts + router
        di, H, S = self.ssm_d_inner, self.ssm_heads, self.ssm_state
        ssm = 2 * d * di + d * 2 * S + d * H + di * d  # B/C group-shared
        per = {"attn": attn + mlp, "local": attn + mlp,
               "shared_attn": attn + mlp, "ssm": ssm + d}
        reps = self.repeats
        total = 0
        for kind in self.pattern:
            n = reps if kind != "shared_attn" else 1  # shared weights
            total += per[kind] * n
        total += self.n_enc_layers * (attn + 3 * d * f)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCHS = [
    "internvl2_26b", "mixtral_8x7b", "moonshot_v1_16b_a3b", "internlm2_20b",
    "gemma2_2b", "mistral_large_123b", "granite_3_2b", "zamba2_2p7b",
    "mamba2_1p3b", "seamless_m4t_large_v2",
]


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r} (choose from "
                         f"{', '.join(ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


def shape_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (DESIGN.md §6)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("full/global-attention arch: 500k ctx needs a "
                       "per-layer 500k KV cache + quadratic prefill "
                       "(see DESIGN.md §6)")
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family variant: few layers, tiny widths/tables."""
    kw = dict(
        n_layers=2 * len(cfg.pattern), d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, dtype="float32", loss_chunk=64,
        microbatches=1,
    )
    if cfg.n_experts:
        # capacity 8x: no token drops -> deterministic consistency tests
        kw.update(n_experts=4, experts_per_token=2,
                  moe_capacity_factor=8.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_heads=4, ssm_d_inner=128)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2)
    if cfg.frontend:
        kw.update(frontend_dim=24, frontend_len=8)
    if cfg.local_window:
        kw.update(local_window=32)
    if cfg.window:
        kw.update(window=32)
    return cfg.replace(**kw)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, device,
                gen: torch.Generator | None = None) -> dict:
    """Every input of the step of ``(cfg, shape)`` beside its parameters,
    as tensors of the JAX package's shapes and dtypes on ``device``:
    ``{"batch": {"tokens", "labels"}}`` for a train step (``labels`` left
    out of a prefill), with ``patches [B, frontend_len, frontend_dim]``
    for a ViT model and ``frames [B, T, frontend_dim]`` for an enc-dec
    one in the model dtype; for a decode step ``{"tokens": i32[B, 1],
    "cache": lm.init_cache(cfg, B, T), "cache_index": i32[]}``.

    On ``"meta"`` nothing is allocated. On a real device the cache is
    zero and ``cache_index`` is ``T - 1`` (the new token at the last
    position of a full-length cache); tokens, labels, frames and patches
    are zero, or drawn from ``gen`` (on ``device``) when it is given.
    """
    from ..models import lm     # late import: lm imports this module

    B, T = shape.global_batch, shape.seq_len
    dev = torch.device(device)
    meta = dev.type == "meta"
    i32, f = torch.int32, cfg.torch_dtype

    def ids(*shp):
        if meta:
            return torch.empty(shp, dtype=i32, device=dev)
        if gen is None:
            return torch.zeros(shp, dtype=i32, device=dev)
        return torch.randint(0, cfg.vocab, shp, generator=gen, device=dev,
                             dtype=i32)

    def feats(*shp):
        if meta:
            return torch.empty(shp, dtype=f, device=dev)
        if gen is None:
            return torch.zeros(shp, dtype=f, device=dev)
        return torch.randn(shp, generator=gen, device=dev, dtype=f)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": ids(B, T)}
        if shape.kind == "train":
            batch["labels"] = ids(B, T)
        if cfg.frontend == "vit":
            batch["patches"] = feats(B, cfg.frontend_len, cfg.frontend_dim)
        if cfg.frontend == "audio":
            batch["frames"] = feats(B, T, cfg.frontend_dim)
        return {"batch": batch}
    if shape.kind != "decode":
        raise ValueError(f"unknown step kind {shape.kind!r}")
    index = (torch.empty((), dtype=i32, device=dev) if meta
             else torch.full((), T - 1, dtype=i32, device=dev))
    return {"tokens": ids(B, 1), "cache": lm.init_cache(cfg, B, T,
                                                        device=dev),
            "cache_index": index}
