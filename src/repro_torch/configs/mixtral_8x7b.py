"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].

The JAX package's ``src/repro/configs/mixtral_8x7b.py``. 8 experts are fewer than a wide model axis, so
they are tensor-parallel (``moe_shard_mode="tp"``: each model shard of
a mesh holds a d_ff slice of all 8 experts). In bf16 one layer is 2.90
GB, 93.4 GB at 32 layers: one card serves it cut in depth.
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    window=4096,               # SWA
    pattern=("attn",),
    n_experts=8,
    experts_per_token=2,
    moe_shard_mode="tp",
    microbatches=2,
)
