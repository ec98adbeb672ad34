"""seamless-m4t-large-v2 [audio]: enc-dec, 24L (each side) d_model=1024
16H (kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf].

The JAX package's ``src/repro/configs/seamless_m4t_large_v2.py``. The
speech frontend is a stub: the model takes precomputed 80-dim filterbank
frames, which ``params["front"]`` projects into the encoder; decoder
layers carry cross-attention to the encoder memory, and a decode step
reads both the self and the cross k/v caches. 3.9 GB in bf16 at full
depth.
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,               # decoder sublayers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    pattern=("attn",),
    frontend="audio",
    frontend_dim=80,
)
