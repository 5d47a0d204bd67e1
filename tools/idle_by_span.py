"""Where the device waits, by the program's own spans: one traced window of a
benchmark cell, run as `python3 -m gpbench.run --trace 1` runs it, with the
idle gaps of its device trace labelled by the innermost span of
gpsat_tpu_torch.tracing that the host was in.

    python3 tools/idle_by_span.py --workload gpr_arctic50.fit --seed 7 \\
        --seconds 51

The window's profiler turns the program's spans on. The program's spans of
the main thread, innermost first, go to gpbench.trace.reduce ahead of the
harness's own level spans (in slices of the trace, so that each slice
searches only the spans it overlaps). Prints one JSON object:

- idle_s: device idle seconds by span, program spans first, then the
  harness's levels where no program span was open;
- spans: for each span name, its count, host seconds, self seconds (less
  its child spans), device idle seconds, the CUDA kernels launched inside it
  and their device seconds (a kernel belongs to the span in which the host
  launched it; a kernel of a CUDA graph, to the span that replayed the
  graph: it carries the correlation id of that `cudaGraphLaunch`), the
  graph launches and graph kernels among them and the host seconds of
  those launch calls, and its host_reads;
- drift: a second marker launched after the window's last synchronise,
  against the first: device time less host time between the two markers,
  the launch calls' clock less host time, and each marker's start after
  its launch. The device clock is anchored at the first marker's start,
  its launch time plus that latency (gpbench.run anchors it at the launch);
- metrics, correct: the cell's per-layer metrics and verdict, as the
  benchmark's result line gives them.

Needs a CUDA device; builds the kernels on a checkout's first run.
"""

import argparse
import bisect
import json
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from gpbench import run, trace  # noqa: E402
from gpsat_tpu_torch import tracing  # noqa: E402

SLICE = 4096    # device events per reduce call


class MarkedWindow(trace.Window):
    """trace.Window with a second marker after the window's last
    synchronise, and the launch (runtime) events of the trace kept:
    `launch_ns` {correlation id: (host start on the profiler's clock, the
    runtime call's name, its duration in ns)}."""

    last = None

    def __enter__(self):
        MarkedWindow.last = self
        return super().__enter__()

    def __exit__(self, *exc):
        dev = self.device
        torch.cuda.synchronize(dev)
        self.host_m2 = time.perf_counter()
        torch.ones(1, device=dev).add_(1.0)      # the second marker
        torch.cuda.synchronize(dev)
        self.host_t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        t = time.perf_counter()
        self.events, self.kernels, self.launch_ns = read_events(self.prof)
        self.seconds = {"stop": t - self.host_t1,
                        "events": time.perf_counter() - t}
        return False


def read_events(prof):
    """trace.device_events' list, each device event's correlation id in the
    same order, and {correlation id: (start_ns, name, duration_ns)} of the
    host's launch calls, from one pass over the profiler's results."""
    dev, host = [], {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            if e.name().startswith("cu"):
                host[e.correlation_id()] = (e.start_ns(), e.name(),
                                            e.duration_ns())
            continue
        s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        dev.append((s, e.name(), s + d, e.correlation_id()))
    dev.sort(key=lambda r: r[0])
    return ([(n, s, b) for s, n, b, _ in dev], [c for *_, c in dev], host)


class Timeline:
    """The innermost open span at any host time, from spans of one thread
    (which nest)."""

    def __init__(self, recs):
        self.t, self.name = [-np.inf], [None]
        stack = []
        for r in sorted(recs, key=lambda r: (r["t0"], -r["t1"])):
            while stack and stack[-1]["t1"] <= r["t0"]:
                self._mark(stack.pop()["t1"], stack)
            stack.append(r)
            self._mark(r["t0"], stack)
        while stack:
            self._mark(stack.pop()["t1"], stack)

    def _mark(self, t, stack):
        self.t.append(t)
        self.name.append(stack[-1]["name"] if stack else None)

    def at(self, t):
        return self.name[bisect.bisect_right(self.t, t) - 1]


def idle_by_span(events, host_t0, host_t1, spans):
    """{label: idle seconds} from gpbench.trace.reduce, a slice of SLICE
    device events at a time with the spans that overlap the slice (in their
    order): a slice ends where the next one's first event starts."""
    dev0 = events[0][1]
    s = np.array([a for _, a, _ in spans])
    e = np.array([b for _, _, b in spans])
    idle = {}
    for k in range(0, len(events), SLICE):
        part = events[k:k + SLICE]
        h0 = host_t0 + (part[0][1] - dev0) * 1e-6
        h1 = host_t0 + (events[k + SLICE][1] - dev0) * 1e-6 \
            if k + SLICE < len(events) else host_t1
        keep = np.flatnonzero((s < h1) & (e > h0))
        red = trace.reduce(part, h0, h1, [spans[j] for j in keep])
        for lab, v in red["idle"].items():
            idle[lab] = idle.get(lab, 0.0) + v
    return idle


def span_table(recs, main, idle, launched, graphs):
    """Per span name: count, host and self seconds, device idle seconds,
    kernels launched and their device seconds, graph launches, graph
    kernels and the launch calls' host seconds, host_reads; the prefetch
    thread's spans under their own names."""
    child = {}
    for r in recs:
        if r["parent"] is not None:
            child[r["parent"]] = child.get(r["parent"], 0.0) + \
                r["t1"] - r["t0"]
    rows = {}
    for r in recs:
        if r["name"] is None:
            continue
        row = rows.setdefault(r["name"], {
            "n": 0, "host_s": 0.0, "self_s": 0.0, "idle_s": 0.0,
            "kernels": 0, "device_s": 0.0, "host_reads": 0,
            "main_thread": r["thread"] == main})
        dt = r["t1"] - r["t0"]
        row["n"] += 1
        row["host_s"] += dt
        row["self_s"] += dt - child.get(r["id"], 0.0)
        row["host_reads"] += r["counts"].get("host_reads", 0)
    for name, row in rows.items():
        row["idle_s"] = idle.get(name, 0.0)
        row["kernels"], row["device_s"] = launched.get(name, (0, 0.0))
        row["graph_launches"], row["graph_kernels"], \
            row["graph_launch_s"] = graphs.get(name, (0, 0, 0.0))
    return rows


def attribute(win, rec):
    """The tool's summary of one traced window (see the module's doc)."""
    events = win.events
    main = threading.get_ident()
    recs = [r for r in tracing.snapshot()
            if win.host_t0 <= r["t0"] < win.host_t1]
    mine = [r for r in recs if r["thread"] == main and r["name"]]
    dev0 = events[0][1]
    r0 = win.launch_ns.get(win.kernels[0], (None,))[0]
    # the second marker: the last event named as the first (the marker's
    # fill kernel)
    m2 = max(i for i, ev in enumerate(events) if ev[0] == events[0][0])
    r2 = win.launch_ns.get(win.kernels[m2], (None,))[0]
    # each marker's start after its launch, on the profiler's one clock
    late = [None if r is None else (events[i][1] * 1e3 - r) * 1e-9
            for i, r in ((0, r0), (m2, r2))]
    host_gap = win.host_m2 - win.host_t0
    drift = {"host_s": host_gap,
             "device_less_host_ms": 1e3 * ((events[m2][1] - dev0) * 1e-6
                                           - host_gap),
             "launch_clock_less_host_ms": None if r0 is None or r2 is None
             else 1e3 * ((r2 - r0) * 1e-9 - host_gap),
             "marker_start_after_launch_ms": [
                 None if t is None else 1e3 * t for t in late]}

    # reduce maps the first event's start to the host time it is given: the
    # first marker's launch (host_t0) plus the marker's own latency
    spans = tracing.intervals(mine) + run.spans(rec)
    idle = idle_by_span(events, win.host_t0 + (late[0] or 0.0), win.host_t1,
                        spans)

    # each kernel to the span its launch call ran in (a graph's kernels to
    # the span of its cudaGraphLaunch), at the middle of the call: the
    # launch calls' clock set by the first marker (launched at host_t0; a
    # replay starts a span, which the call's start can precede by the
    # anchor's tens of microseconds), else the kernel's own start mapped by
    # the device clock
    tl = Timeline(mine)
    launched, by_launch, graphs, seen = {}, 0, {}, set()
    for (name, a, b), corr in zip(events, win.kernels):
        r, call, dur = win.launch_ns.get(corr, (None, None, 0))
        if r is not None and r0 is not None:
            t = win.host_t0 + (r + dur / 2 - r0) * 1e-9
            by_launch += 1
        else:
            t = win.host_t0 + (a - dev0) * 1e-6
        lab = tl.at(t)
        n, s = launched.get(lab, (0, 0.0))
        launched[lab] = (n + 1, s + (b - a) * 1e-6)
        if call is not None and call.startswith("cudaGraphLaunch"):
            g, k, d = graphs.get(lab, (0, 0, 0.0))
            new = corr not in seen
            graphs[lab] = (g + new, k + 1, d + new * dur * 1e-9)
            seen.add(corr)
    tr = rec["trace"]
    return {
        "window_s": tr["window_s"], "busy_s": tr["busy_s"],
        "idle_total_s": sum(idle.values()),
        "harness_idle_total_s": sum(tr["idle"].values()),
        "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "spans": span_table(recs, main, idle, launched, graphs),
        "kernels_outside_spans": launched.get(None, (0, 0.0)),
        "kernels": len(events), "kernels_by_launch": by_launch,
        "drift": drift,
        "pool_reruns": sum(1 for r in recs if r["name"] == "engine.pool"
                           and r["attrs"].get("restart")),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("idle_by_span: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = run.cell_spec(args.workload)
    trace.Window = MarkedWindow
    rec = run.run_cell(spec, args.seed, args.seconds, True,
                       torch.device("cuda", 0))
    t = time.perf_counter()
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0),
           "units": [round(u["seconds"], 3) for u in rec["units"]],
           **attribute(MarkedWindow.last, rec)}
    line = run.result_line(spec, rec, True)
    out.update(correct=line["correct"], metrics={
        k: v["value"] for k, v in line["metrics"].items()},
        attribution_s=time.perf_counter() - t)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
