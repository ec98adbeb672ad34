"""CAMR on PyTorch and CUDA: the port of the JAX package ``repro``.

A second package beside the JAX reference, with the same layout
(``core/``, ``kernels/``, ``configs/``, ``models/``, ``optim/``,
``data/``, ``runtime/``, ``launch/``). It imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``; the numpy-only modules it needs
are its own copies (``core/{designs,placement,schedule,loads}.py``, the
engines ``core/{shuffle,engine,baselines}.py``, ``runtime/jobstream.py``,
``data/pipeline.py`` and ``configs/paper_wordcount.py``), held
source-identical to the originals by the tests. Entry points run on the current CUDA device unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
