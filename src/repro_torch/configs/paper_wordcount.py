"""The paper's own Example-1 workload as a config: J=4 word-count jobs on
K=6 servers (q=2, k=3, gamma=2). Used by examples/quickstart.py and the
benchmark harness; not an LM architecture."""

CAMR_PARAMS = dict(q=2, k=3, gamma=2)
