"""Architecture configs of the port: a :class:`ModelConfig` twin of the
JAX package's ``repro.configs.ModelConfig`` without jax.

``torch_dtype`` takes the place of ``jdtype``; ``reduced(cfg)`` derives
the small same-family variant the CPU tests use. The architecture
fields are the JAX package's; its XLA execution knobs (``use_pallas``,
``remat``, ``scan_unroll``, ``attn_block``, ``ssm_chunk``,
``microbatches``, ``grad_sync``) have no counterpart here (the SSD chunk
is the ``ssd_scan`` kernel's constant, 64, mamba2's and zamba2's
``ssm_chunk``). ``moe_shard_mode`` stays: on one card it selects the
lane of :func:`repro_torch.models.layers.moe_block` over a virtual
``(n_data, n_model)`` mesh and nothing else. The port ships every arch
of the JAX zoo (:data:`ARCHS`): the dense ``granite_3_2b``,
``gemma2_2b``, ``internlm2_20b`` and ``mistral_large_123b``, the MoE
``mixtral_8x7b`` and ``moonshot_v1_16b_a3b``, the SSM ``mamba2_1p3b``
and the hybrid ``zamba2_2p7b``, each served and trained, and the
enc-dec ``seamless_m4t_large_v2`` (audio frames) and the ViT-frontend
``internvl2_26b`` (patches), served through the legacy host loop only,
as in the JAX package, whose token pipeline carries no frames or
patches to train them on.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

import torch

__all__ = ["ModelConfig", "ARCHS", "get_config", "reduced"]


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
    loss_chunk: int = 1024              # vocab-logit seq chunking
    grad_sync_dtype: str = "float32"    # float32 | bfloat16 (packed lane)

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


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family variant: few layers, tiny widths/tables."""
    kw = dict(
        n_layers=2 * len(cfg.pattern), d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, dtype="float32", loss_chunk=64,
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
