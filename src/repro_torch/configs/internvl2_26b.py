"""internvl2-26b [vlm]: InternViT frontend (stub) + InternLM2 backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]. The JAX package's
``src/repro/configs/internvl2_26b.py``. The ViT frontend is a stub: the model takes
precomputed patch embeddings (1024-dim InternViT features after
pixel-shuffle), which ``params["front"]`` projects into the first
``frontend_len`` positions of the sequence. 39.7 GB in bf16 at full
depth.
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    rope_theta=1e6,
    pattern=("attn",),
    frontend="vit",
    frontend_dim=1024,
    frontend_len=256,          # patch tokens prepended to the sequence
    microbatches=2,
)
