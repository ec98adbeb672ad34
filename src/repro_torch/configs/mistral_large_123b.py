"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]. The largest arch of the zoo.

The JAX package's ``src/repro/configs/mistral_large_123b.py``; 2.77 GB a
layer in bf16, so one card runs it only cut in depth. Its train step
accumulates gradients over 8 microbatches, as JAX's does.
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    rope_theta=1e6,
    pattern=("attn",),
    microbatches=8,
)
