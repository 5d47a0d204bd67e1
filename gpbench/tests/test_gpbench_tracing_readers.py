"""The readers of the program's spans and counters (pool_issue_ms,
host_reads.fit, host_reads.repredict) on a synthetic span store."""

import sys

import pytest

from gpbench import run
from gpsat_tpu_torch import tracing


def span(name, t0, t1, reads=0):
    return {"id": 0, "name": name, "t0": t0, "t1": t1, "parent": None,
            "thread": 1, "attrs": {},
            "counts": {"host_reads": reads} if reads else {}}


def unit(kind, t0, t1, iters=(30, 0)):
    return {"kind": kind, "t0": t0, "t1": t1,
            "buckets": [{"pool_iterations": i} for i in iters]}


# a window from 10.0 to 20.0 s in two units, and records on either side
STORE = [
    span("lbfgs.issue", 9.0, 9.5, reads=4),         # before the window
    span("execute.level", 10.0, 14.0, reads=2),
    span("lbfgs.issue", 10.5, 10.504),
    span("lbfgs.read", 10.504, 10.505, reads=1),
    span("lbfgs.issue", 15.0, 15.006),
    span("fill.read", 16.0, 16.5, reads=7),
    {"id": 0, "name": None, "t0": 19.0, "t1": 19.0, "parent": None,
     "thread": 1, "attrs": {}, "counts": {"host_reads": 1}},
    span("lbfgs.issue", 20.0, 21.0, reads=50),      # at the window's end
]


def read(name, rec):
    return run.metric_reader(name)(rec, name)


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", lambda: list(STORE))


def test_pool_issue_ms_is_issue_time_over_the_windows_iterations(store):
    rec = {"units": [unit("day", 10.0, 15.0), unit("day", 15.0, 20.0)]}
    assert read("pool_issue_ms", rec) == pytest.approx(1e3 * 0.010 / 60)


def test_host_reads_per_unit_of_its_kind(store):
    days = {"units": [unit("day", 10.0, 15.0), unit("day", 15.0, 20.0)]}
    assert read("host_reads.fit", days) == pytest.approx((2 + 1 + 7 + 1) / 2)
    passes = {"units": [unit("pass", 10.0, 20.0, iters=(0,))]}
    assert read("host_reads.repredict", passes) == pytest.approx(11.0)
    assert read("host_reads.fit", passes) is None
    assert read("host_reads.repredict", days) is None


def test_the_window_bounds_the_records(store):
    """A window over the last unit alone leaves out the first's records."""
    rec = {"units": [unit("day", 15.0, 20.0, iters=(3,))]}
    assert read("pool_issue_ms", rec) == pytest.approx(1e3 * 0.006 / 3)
    assert read("host_reads.fit", rec) == pytest.approx(8.0)


def test_nothing_to_read_gives_nothing(monkeypatch, store):
    no_pool = {"units": [unit("day", 10.0, 20.0, iters=(0, 0))]}
    assert read("pool_issue_ms", no_pool) is None
    empty = {"units": [unit("day", 30.0, 40.0)]}
    assert read("pool_issue_ms", empty) is None
    assert read("host_reads.fit", empty) is None
    assert read("host_reads.fit", {"units": []}) is None
    # a program without the recorder (the parent of the change that adds it)
    monkeypatch.setitem(sys.modules, "gpsat_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["gpsat_tpu_torch"], "tracing")
    rec = {"units": [unit("day", 10.0, 20.0)]}
    for name in ("pool_issue_ms", "host_reads.fit"):
        assert read(name, rec) is None
