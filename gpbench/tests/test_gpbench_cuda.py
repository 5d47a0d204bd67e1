"""On the card (marked `cuda`; skips without one): the control, the
reference in float32 with TF32 matmuls in the program's place, comes out
not correct by the cell's own limits, where the program's run on the same
inputs comes out correct. At a reduced deployment that a test run holds:

    python -m pytest -o addopts="" --noconftest -q \\
        gpbench/tests/test_gpbench_cuda.py

(the card's machine has no xdist; run from the repository's root)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpbench import run, verify  # noqa: E402

SMALL = dict(expert_half_km=400, expert_step_km=100, expert_stride=1,
             n_tracks=300, train_radius_km=500, pred_radius_km=200)
CELLS = ["gpr_arctic50.fit", "gpr_arctic50.repredict"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    spec = run.cell_spec(cell)
    spec["config"]["deployment"].update(SMALL)
    rec = run.run_cell(spec, 2 ** 31 + 99, 0.05, False, card)
    assert rec["correct"], rec["checks"]
    numbers = spec["mode"].control(spec, 2 ** 31 + 99, card)
    ok, rows = verify.judge(dict(numbers, nonfinite=0.0),
                            spec["checks"]["limits"])
    assert not ok, rows
