"""Shared helpers of the benchmark's CPU tests: cells cut to a few dozen
experts so that a whole run (set-up, window, check) takes seconds on the
host's CPU, with the engine in the configuration's float32 on torch's plain
paths."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpbench import run  # noqa: E402

# a few dozen experts with a few dozen observations each
TINY = dict(expert_half_km=200, expert_step_km=100, expert_stride=1,
            n_tracks=120, train_radius_km=250, pred_radius_km=100)
SEED = 2 ** 31 + 12345     # a seed above 32 signed bits


def tiny_spec(cell, root=run.ROOT):
    spec = run.cell_spec(cell, root)
    spec["config"]["deployment"].update(TINY)
    return spec


def tiny_run(cell, seed=SEED, spec=None):
    spec = spec or tiny_spec(cell)
    return run.run_cell(spec, seed, 0.05, False, torch.device("cpu"))


@pytest.fixture(autouse=True)
def _threads():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def cuda_device():
    """The card, decided inside the test; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
