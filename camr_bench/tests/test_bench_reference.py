"""The plain reference against the port's trainer: one camr_spmd step at
a tiny width on the CPU, in float32, for each family: the losses, the
synced gradient of every job (the sum of its subfiles' gradients) and
the parameters after the step."""

import pytest
import torch
from conftest import tiny_cell

from camr_bench import bench, check
from camr_bench.feed import TokenFeed
from camr_bench.params import make_weights, offsets
from camr_bench.reference.common import Numerics, _subfile_grad, train_steps

CELLS = ["granite_l2_f32.sync_4x1024", "mamba2_l2_bf16.map_32x512"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("sync", ["float32", "bfloat16"])
def test_one_step_matches_the_trainer(name, sync, monkeypatch):
    monkeypatch.setattr(check, "STEPS", 1)
    cell = tiny_cell(name, dtype="float32", grad_sync_dtype=sync)
    synced = []

    def capture(tr):
        apply = tr._apply

        def keep(gsync):
            synced.append(gsync.transpose(0, 1).reshape(tr.J, -1).float())
            return apply(gsync)

        tr._apply = keep

    tr, _, prog, _ = bench.start_program(cell, 11, "cpu", capture)
    init = make_weights(cell.leaves, cell.J, 11, "cpu")
    ref = train_steps(cell.family, cell.config, init,
                      TokenFeed(cell.traffic, cell.config["vocab"], 11), 1,
                      keep=True)
    assert prog.losses[0] == pytest.approx(ref.losses[0], rel=1e-5)
    # a bf16 sync rounds each subfile's gradient and each partial sum (in
    # another order than the reference): a sum that cancels may differ
    # by a few ulps of its largest term
    rel = 1e-4 if sync == "float32" else 2e-2
    feed = TokenFeed(cell.traffic, cell.config["vocab"], 11)
    for j in range(cell.J):
        params = [p.float().requires_grad_(True) for p in init[j]]
        want = [torch.zeros_like(p) for p in params]
        for n in range(cell.N):
            b = {k: torch.as_tensor(v) for k, v in
                 feed.batch(j * cell.N + n).items()}
            for acc, g in zip(want, _subfile_grad(
                    cell.family, cell.config, params, b,
                    Numerics("float32"), 1)[1]):
                acc.add_(Numerics(sync).act(g))
        for leaf, off, w in zip(cell.leaves, offsets(cell.leaves), want):
            got = synced[0][j, off:off + leaf.size].view(leaf.shape)
            torch.testing.assert_close(got, w, rtol=rel,
                                       atol=rel * float(w.abs().max()))
        # AdamW's first step is about lr * g / (|g| + eps): an element
        # whose gradient is near eps, or near 0 and rounded, moves apart
        ptol = dict(rtol=1e-5, atol=1e-4) if sync == "float32" else dict(
            rtol=0, atol=2 * cell.config["optimizer"]["lr"])
        for leaf, off, w in zip(cell.leaves, offsets(cell.leaves),
                                ref.params[j]):
            got = tr.flat[j, off:off + leaf.size].view(leaf.shape)
            torch.testing.assert_close(got, w, **ptol)
