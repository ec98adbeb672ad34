"""The benchmark of the PyTorch and CUDA port of CAMR (``repro_torch``):
the coded multi-model training step on one card. See ``README.md``."""
