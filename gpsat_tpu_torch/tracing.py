"""Spans and counters of the port's host work, kept in memory.

`span(name, **attrs)` bounds a piece of host work; spans nest through a
stack kept per thread. `count(name, n)` adds to a counter of the innermost
open span of the calling thread, so every count has a time and a layer.
`host(t)` brings a tensor to the host and counts a copy off a device as one
`host_reads`: the engines and the L-BFGS loops read the device through it
alone. `snapshot()` returns the records, `clear()` empties them.

Recording happens only while `enable()` is in force, or while a torch
profiler is collecting in the calling thread: a profiled window turns the
spans on with nothing else to set. Off, `span` returns one shared no-op
context and `count` returns at once. Work handed to another thread records
there as the submitting thread does if it is wrapped in `propagate`.

A record is a dict: id, name, t0, t1 (seconds of `time.perf_counter()`),
parent (the id of the enclosing span of the same thread, or None), thread
(its ident), attrs, counts ({name: n}). A count made outside every span is
a record of its own, with name None and t0 == t1.
"""

import itertools
import threading
import time
from contextlib import contextmanager

import torch

__all__ = ["span", "count", "host", "enable", "enabled", "propagate",
           "snapshot", "clear", "intervals"]

_records = []
_forced = 0                 # depth of enable()
_local = threading.local()  # .stack: open span records; .bound: propagate
_ids = itertools.count()
_profiling = torch._C._autograd._profiler_enabled


def enabled():
    """Whether the calling thread records now."""
    return bool(_forced or _profiling() or getattr(_local, "bound", False))


@contextmanager
def enable():
    """Record in every thread while the block runs."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name, attrs):
        self.rec = {"id": next(_ids), "name": name, "t0": 0.0, "t1": 0.0,
                    "parent": None, "thread": threading.get_ident(),
                    "attrs": attrs, "counts": {}}

    def __enter__(self):
        stack = _stack()
        rec = self.rec
        rec["parent"] = stack[-1]["id"] if stack else None
        stack.append(rec)
        rec["t0"] = time.perf_counter()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec["t1"] = time.perf_counter()
        _stack().pop()
        _records.append(rec)
        return False


def span(name, **attrs):
    """A context manager that records the enclosed host work as `name`."""
    if not enabled():
        return _NOOP
    return _Span(name, attrs)


def count(name, n=1):
    """Add n to the counter `name` of the innermost open span."""
    if not enabled():
        return
    stack = _stack()
    if stack:
        counts = stack[-1]["counts"]
        counts[name] = counts.get(name, 0) + n
        return
    t = time.perf_counter()
    _records.append({"id": next(_ids), "name": None, "t0": t, "t1": t,
                     "parent": None, "thread": threading.get_ident(),
                     "attrs": {}, "counts": {name: n}})


def host(t):
    """`t` on the host. A tensor off the CPU is copied there, which waits
    for the device, and counts as one "host_reads"; anything else comes
    back as it is."""
    if isinstance(t, torch.Tensor) and t.device.type != "cpu":
        count("host_reads")
        return t.cpu()
    return t


def propagate(fn):
    """`fn`, to run on another thread: it records there if the calling
    thread records now."""
    if not enabled():
        return fn

    def bound(*args, **kwargs):
        _local.bound = True
        try:
            return fn(*args, **kwargs)
        finally:
            _local.bound = False
    return bound


def snapshot():
    """The records so far, each span at its end, in that order."""
    return list(_records)


def clear():
    """Forget every record."""
    _records.clear()


def intervals(records, thread=None):
    """[(name, t0, t1)] of the span records (of one thread, if given),
    innermost first: a span comes before every span that encloses it, so a
    search for the first interval holding a time finds the innermost."""
    spans = [r for r in records if r["name"] is not None
             and (thread is None or r["thread"] == thread)]
    parent = {r["id"]: r["parent"] for r in spans}
    depth = {}

    def depth_of(i):
        if i not in depth:
            p = parent.get(i)
            depth[i] = 0 if p not in parent else depth_of(p) + 1
        return depth[i]
    spans.sort(key=lambda r: (-depth_of(r["id"]), r["t0"]))
    return [(r["name"], r["t0"], r["t1"]) for r in spans]
