"""The port's measured cell, defined once.

``granite_3_2b`` (hf:ibm-granite/granite-3.0-2b-base) at full width,
depth cut from 40 to 2 layers, q=2, k=3 (K=6 virtual workers, J=4
models), trained on ``ShardedTokenPipeline(seq_len=512,
global_batch=1)`` from seed 0, on the f32 or the bf16 grad-sync lane,
with the fused codec or the multipass oracle. ``arch`` and ``n_layers``
put another ported config at full width in its place, at the same q, k
and pipeline (``chip_smoke.py``'s SSM-family run: ``mamba2_1p3b`` at 2
layers), ``seq_len`` another sequence length (the smoke's chunked
attention run: 2048 tokens), and further fields a width cut (the
smoke's MoE run: ``moonshot_v1_16b_a3b`` with its d_ff and vocab cut).
``chip_smoke.py`` and :mod:`repro_torch.launch.profile` both build it
here.
"""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.runtime import MultiModelCAMRTrainer

ARCH = "granite_3_2b"
N_LAYERS = 2
Q, K = 2, 3
SEQ_LEN = 512
GLOBAL_BATCH = 1


def make_cell(device=None, grad_sync_dtype="float32", codec="fused", *,
              arch=ARCH, n_layers=N_LAYERS, seq_len=SEQ_LEN, **cut):
    """The cell's ``(trainer, pipeline)``; ``device=None`` is the current
    CUDA device, ``grad_sync_dtype`` the lane (``"float32"`` or
    ``"bfloat16"``), ``codec`` the shuffle's XOR codec (``"fused"`` or
    ``"multipass"``), ``arch`` at full width cut to ``n_layers``
    sublayers, on sequences of ``seq_len`` tokens; ``cut`` replaces
    other config fields (a width cut, e.g. ``d_ff=``, ``vocab=``)."""
    cfg = get_config(arch).replace(n_layers=n_layers, **cut)
    tr = MultiModelCAMRTrainer(cfg, q=Q, k=K, seed=0, device=device,
                               grad_sync_dtype=grad_sync_dtype, codec=codec)
    pipe = ShardedTokenPipeline(vocab=cfg.vocab, seq_len=seq_len,
                                global_batch=GLOBAL_BATCH)
    return tr, pipe
