"""moonshot-v1-16b-a3b [moe] (kimi/moonlight): 48L d_model=2048 16H
(kv=16) d_ff=1408 (per expert) vocab=163840, MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

The JAX package's ``src/repro/configs/moonshot_v1_16b_a3b.py``. 64
experts split over a model axis (``moe_shard_mode="ep"``: E/n experts a
shard). In bf16 it is 28.06 B parameters, 56.1 GB: one card serves it
at full width and full depth.
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    rope_theta=5e4,
    pattern=("attn",),
    n_experts=64,
    experts_per_token=6,
    moe_shard_mode="ep",
)
