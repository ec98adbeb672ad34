"""The yardstick's arithmetic: model FLOPs, parameter counts and the
gradient sync's least bytes, against the figures worked out by hand."""

import pytest

from camr_bench import bench


@pytest.mark.parametrize("cell,flop_per_token,tokens", [
    # 6 x 222,304,256 + 6 x 1024 x 2048 x 2 layers of causal attention
    ("granite_l2_f32.sync_4x1024", 1_358_991_360, 49152),
    # the same at 4,096 tokens
    ("granite_l2_f32.map_2x4096", 1_434_488_832, 98304),
    # 6 x 154,615,808, the SSD recurrence left out
    ("mamba2_l2_bf16.map_32x512", 927_694_848, 196608),
])
def test_model_flops(cell, flop_per_token, tokens):
    c = bench.load_cell(cell)
    assert c.tokens_per_step == tokens
    assert c.step_flops == flop_per_token * tokens


@pytest.mark.parametrize("cell,D,least_gb", [
    # 12 f32 gradient rows + master and moments read and written: 32.05 GB
    ("granite_l2_f32.sync_4x1024", 222_570_496, 32.0502),
    # 12 bf16 gradient rows + the same f32 state
    ("mamba2_l2_bf16.map_32x512", 257_693_952, 30.9233),
])
def test_parameters_and_least_sync_bytes(cell, D, least_gb):
    c = bench.load_cell(cell)
    assert sum(leaf.size for leaf in c.leaves) == D
    assert c.sync_least_bytes / 1e9 == pytest.approx(least_gb, abs=1e-4)


def test_matmul_parameters_leave_the_embedding_out():
    c = bench.load_cell("granite_l2_f32.sync_4x1024")
    # 2 layers x (attention 10,485,760 + MLP 50,331,648) + head 49,155 x 2048
    assert c.family.matmul_params(c.config) == 2 * 60_817_408 + 100_669_440
