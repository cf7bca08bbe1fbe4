"""Host-side planning of the exit-head kernel (``kernels/exit_head.py``):
the grid, the partials scratch and the choice between the aligned and the
odd-pitch instance.  Runs on the CPU: nothing here launches a kernel."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import exit_head

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "exit_head.cu")


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, f"{name} not found in {CSRC.name}"
    return int(m.group(1))


def test_tile_constants_match_the_cuda_source():
    assert exit_head.BLOCK_V == _constant("BV")
    assert exit_head.ROWS == _constant("TB")


def test_four_blocks_fit_on_an_sm():
    """The ring and the x slices of four resident blocks fit in an SM's
    228 KB of shared memory (1 KB of it reserved per block)."""
    bv, dk, stages = _constant("BV"), _constant("DK"), _constant("NSTAGE")
    rows = _constant("TB")
    smem = (stages * dk * (bv + 8) + 2 * rows * (dk + 8)) * 2
    assert _constant("MIN_BLOCKS") == 4
    assert 4 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("t,d,v,tiles,groups", [
    (16, 2048, 49155, 385, 1),       # granite-3-2b's exit head
    (16, 7168, 129280, 1010, 1),     # deepseek-v3's
    (40, 2048, 49155, 385, 3),
    (17, 512, 8192, 64, 2),
    (1, 300, 513, 5, 1)])
def test_plan_grid_and_scratch(t, d, v, tiles, groups):
    p = exit_head.plan(t, d, v, 0)
    assert p["n_tiles"] == tiles and p["row_groups"] == groups
    assert p["scratch"] == 3 * t * tiles     # (m, s, t) per row and tile
    assert (p["n_tiles"] - 1) * exit_head.BLOCK_V < v \
        <= p["n_tiles"] * exit_head.BLOCK_V


@pytest.mark.parametrize("v,ptr,want", [
    (129280, 0, "aligned"), (129280, 4096, "aligned"),
    (49155, 0, "odd_pitch"),         # rows of 98,310 bytes
    (1024, 2, "odd_pitch"),          # V % 8 == 0, W off 16 by 2 bytes
    (1024, 8, "odd_pitch"), (1000, 16, "aligned"), (1004, 16, "odd_pitch")])
def test_instance_needs_every_row_on_16_bytes(v, ptr, want):
    assert exit_head.instance(v, ptr) == want
    assert exit_head.plan(16, 64, v, ptr)["instance"] == want
