"""On the card, at each cell's own size: the control (the configuration's
precision one step down) and the planted faults fail the cell's check on
three seeds, as the readings its limits were set from did
(``python3 -m portbench.calibrate``). Run with ``python3 -m pytest
portbench/tests -m cuda`` on a machine with a card."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate as C
from portbench import run as R

SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", [
    ("xl_image.primx", "fp8"),        # the reference in float8 e4m3
    ("xl_image.primx", "w8a8"),       # the program's own W8A8 path
    ("xl_train.bs8", "fp8"),          # the reference in float8 e4m3
    ("xl_train.bs8", "half_batch"),   # half of each batch left out
])
def test_the_control_and_the_faults_fail_the_check(cell, variant):
    dev = _card()
    c = R.load_cell(cell)
    lines = C.readings(c, SEEDS, variant, int(c["traffic_data"].get(
        "check_requests", 1)), dev)
    for line in lines:
        assert any(line[k] > lim for k, lim in c["limits"].items()), line
