"""`correct` comes out false when the timed path is broken underneath: a
fit that returns its start unchanged, half of the experts' answers left out
(the mean of the rest in their place), an answer altered where it is
produced; and true on the sound path. (One chip: no exchange between chips
to leave out.)"""

import numpy as np
import pytest

from gpbench import harness

from conftest import tiny_run

CELLS = ["gpr_arctic50.fit", "gpr_arctic50.repredict"]


def broken_day(monkeypatch, fault):
    day = harness.Program.day

    def wrapped(self, inp, **kw):
        if fault == "unchanged":
            kw["optimise"] = False
        out = day(self, inp, **kw)
        f = out["preds"]["f*"]
        if fault == "half":
            half = np.arange(len(f)) % 2 == 1
            f[half] = np.nanmean(f[~half], axis=0)
        elif fault == "altered":
            f[:, 0] += 1e-2
        return out
    monkeypatch.setattr(harness.Program, "day", wrapped)


def test_sound_runs_are_correct():
    for cell in CELLS:
        assert tiny_run(cell)["correct"], cell


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_caught(monkeypatch, cell, fault):
    if fault == "unchanged" and cell.endswith("repredict"):
        from gpsat_tpu_torch import postprocessing
        monkeypatch.setattr(postprocessing, "smooth_field",
                            lambda x0, y0, vals, *a, **k: np.asarray(vals))
    else:
        broken_day(monkeypatch, fault)
    assert not tiny_run(cell)["correct"]
