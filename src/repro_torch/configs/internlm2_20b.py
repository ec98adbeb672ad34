"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297; hf].

The JAX package's ``src/repro/configs/internlm2_20b.py``; 39.7 GB in
bf16 at full depth.
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    rope_theta=1e6,
    pattern=("attn",),
    microbatches=2,
)
