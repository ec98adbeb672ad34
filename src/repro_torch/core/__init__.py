"""Core CAMR library of the port: the numpy schedule and engines (copies
of the JAX package's numpy-only modules) and the stacked-device shuffle
executor."""
