"""On the card, at each cell's own size: the program's runs come out
correct under the committed limits, and the control (the reference in
bfloat16 in the program's place) does not, on three seeds each.
Run with `python3 -m pytest framebench/tests -m cuda` on a machine with
an NVIDIA GPU; `tests/readings.py` prints the numbers themselves."""
import pytest

from framebench.tests.readings import readings

CELLS = ["play_1080p_hdr10", "transcode_2160p_hdr10", "play_2160p_hdr10"]
SEEDS = [2 ** 32 + 7001, 2 ** 32 + 7002, 2 ** 32 + 7003]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_control_not(card, cell):
    for r in readings(cell, SEEDS, SEEDS, 2.0, controls=("bfloat16",)):
        if r["control"] is None:
            assert r["correct"], r
        else:
            assert not r["correct"], r
