"""The int8 implicit GEMM's N tiling as the port names it, and the turns
tool's bookkeeping, on the CPU.

``ops/int8_conv.py::n_tiling`` mirrors ``csrc/int8_conv.cu::tile_n``, which
picks the kernel instance (``igemm_kernel<T, width>``) a conv runs on; the
card's rows (``chip_smoke.int8_instance``, ``tools/int8_turns.py``) name it
by the mirror. ``tools/int8_turns.py`` sums each geometry's readings over
one forward, each geometry weighted by its count of convs.
"""

import re
from pathlib import Path

import pytest
import torch

from fami_pose_torch.ops import int8_conv as q
from fami_pose_torch.tools import int8_turns

CSRC = Path(q.__file__).parent / "cuda" / "csrc" / "int8_conv.cu"


def test_the_mirror_has_the_sources_widths_and_budget():
    src = CSRC.read_text()
    widths = re.search(r"kWidths\[\] = \{([\d, ]+)\}", src).group(1)
    assert tuple(int(v) for v in widths.split(",")) == q.WIDTHS
    budget = re.search(r"kWeightBudget = (\d+) \* (\d+);", src)
    assert int(budget.group(1)) * int(budget.group(2)) == q.WEIGHT_BUDGET


@pytest.mark.parametrize("n, c, k, want", [
    (384, 384, 3, (32, 12)),  # K = 3456: twelve N tiles of 32
    (192, 192, 3, (64, 3)),   # K = 1728: three of 64
    (96, 96, 3, (96, 1)),
    (48, 48, 3, (48, 1)),
    (256, 64, 1, (256, 1)),   # layer1's 1x1 to 256: one tile of 256
    (300, 16, 1, (192, 2)),   # Np 304 in two tiles of 192
    (24, 40, 1, (32, 1)),     # the ragged 1x1's Np 32
    (64, 3, 3, (64, 1)),      # the stem: Cp 16, K = 144 padded to 160
    (32, 512, 3, (0, 0)),     # 32 rows of K = 4608 are past the budget
])
def test_n_tiling_names_the_kernels_instance(n, c, k, want):
    kp = q.packed_shape(n, c, k)[1]
    assert q.n_tiling(n, kp) == want
    width, tiles = want
    if width:
        assert width * kp <= q.WEIGHT_BUDGET and width * tiles >= n


def test_check_conv_refuses_what_n_tiling_cannot_cut():
    """The wrapper's refusal and the mirror agree: no width fits exactly
    where ``check_conv`` refuses K."""
    for c in (256, 384, 512, 768):
        wq, _ = q.quantize_weight(torch.randn(32, c, 3, 3))
        wp = q.pack_weight(wq, c, 3)
        fits = q.n_tiling(32, wp.shape[1]) != (0, 0)
        try:
            q.check_conv((2, c, 12, 9), wq, wp, 3, 1, 1, 1, "hrnet.conv")
            refused = False
        except ValueError:
            refused = True
        assert fits != refused, c


def _row(count, stride, old, tree):
    return dict(convs_per_forward=count, stride=stride, old_ms=old,
                tree_ms=tree, old_cold_ms=[2 * v for v in old],
                tree_cold_ms=[2 * v for v in tree], int_mm_ms=0.5,
                cudnn_bf16_conv_ms=1.0)


def test_per_forward_weights_each_geometry_by_its_convs():
    rows = [_row(64, 1, [1.0, 2.0, 3.0, 4.0], [0.5, 0.5, 0.5, 0.5]),
            _row(3, 2, [10.0, 10.0, 10.0, 10.0], [20.0, 20.0, 20.0, 20.0])]
    sums = int8_turns.per_forward(rows)
    assert sums["old_ms"] == [94.0, 158.0, 222.0, 286.0]
    assert sums["tree_ms"] == [92.0] * 4
    assert sums["tree_cold_ms"] == [184.0] * 4
    assert sums["int_mm_ms"] == 33.5 and sums["cudnn_bf16_conv_ms"] == 67.0
    assert sums["stride_1_convs"] == 64 and sums["stride_2_convs"] == 3
    assert sums["stride_1_tree_ms"] == [32.0] * 4
    assert sums["stride_2_old_ms"] == [30.0] * 4


def test_the_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        int8_turns.main(["--old-dir", "nowhere"])
