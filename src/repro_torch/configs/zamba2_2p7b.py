"""zamba2-2.7b [hybrid]: 54 sublayers d_model=2560 32H (kv=32) x 80
d_ff=10240 vocab=32000, ssm_state=64, 80 SSM heads of 64 (d_inner 5120)
— a Mamba2 backbone with one SHARED attention block interleaved
[arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

The JAX package's ``src/repro/configs/zamba2_2p7b.py`` without its XLA
knob ``ssm_chunk`` (64 is the ``ssd_scan`` kernel's constant here).
Pattern: 5 Mamba2 sublayers and
the ``shared_attn`` block, repeated 9 times; the 9 occurrences of the
block reuse ONE parameter set (``params["shared"]``) and each keeps its
own KV cache. Its prefills run both hand-written kernels:
``flash_attention`` at head dim 80 and ``ssd_scan`` at state 64.
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "shared_attn"),
    ssm_state=64,
    ssm_heads=80,              # d_inner 5120 / headdim 64
    ssm_d_inner=5120,
    microbatches=2,
)
