"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free vocab=50280,
ssm_state=128, 64 SSM heads of 64 (d_inner 4096) — SSD (state-space
duality) [arXiv:2405.21060; hf:state-spaces/mamba2-1.3b].

The JAX package's ``src/repro/configs/mamba2_1p3b.py`` without its XLA
knob ``ssm_chunk`` (64 is the ``ssd_scan`` kernel's constant here). As
there, the depthwise conv1d of
the reference implementation is omitted; the SSD core is the
``ssd_scan`` kernel (``repro_torch/kernels/csrc/ssd_scan.cu``).
"""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,                 # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_heads=64,              # d_inner 4096 / headdim 64
    ssm_d_inner=4096,
    microbatches=2,
)
