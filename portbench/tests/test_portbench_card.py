"""The checks' control on the card: each cell run at its own size with a
short window, once as the program runs (correct) and once with the
control in the program's place, the reference in float32 with TF32
matmuls, the nearest precision below the configuration's float32 with
TF32 off (not correct).  Skipped without enough CUDA cards.

    python -m pytest portbench/tests/test_portbench_card.py -q -m gpu
"""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from portbench import harness  # noqa: E402

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def cell(request):
    import torch

    c = harness.resolve(BENCH, request.param)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        pytest.skip(f"{c.name} needs {c.chips} CUDA card(s)")
    return c


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS, indirect=True)
def test_control_is_not_correct(cell):
    seed = 2 ** 31 + 101
    sound = harness.run(cell, seed, 2.0, log=lambda *a: None)
    control = harness.run(cell, seed, 2.0, control=True,
                          log=lambda *a: None)
    assert sound["correct"] is True, sound["checks"]
    assert control["correct"] is False, control["checks"]
