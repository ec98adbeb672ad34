"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local/global alternating attention, logit softcaps,
GeGLU, tied + scaled embeddings [arXiv:2408.00118; hf]."""

from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    pattern=("local", "attn"),     # alternating local/global
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="geglu",
    tie_embeddings=True,
    scale_embed=True,
    microbatches=2,
)
