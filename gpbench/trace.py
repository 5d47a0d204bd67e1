"""The device trace of a window: torch.profiler (CUDA activity only) around
the window, reduced to device busy time, kernel time by name, the port's
launches (vg, predict) by their kernels, and idle gaps labelled by the
harness's own spans.

`base_name` is a frozen copy of gpsat_tpu_torch/device_profile.py's; the
events are read one by one (`device_events`), not summed by name as
device_profile.device_times does, since a launch's kernels are told apart
by their order.

Alignment: the window opens with one marker launch after a synchronise, so
the first device event of the trace starts when the host clock read
`host_t0`; host spans map to device time by that offset.
"""

import functools
import time

import torch


@functools.lru_cache(maxsize=None)
def base_name(key):
    """A profiler kernel key without "void ", its arguments and its template
    argument list (which may hold spaces: "gp_cholinv_diag_kernel<CiKernel<1>
    >")."""
    name = key.split("(")[0].strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("<")[0]


# the last CUDA kernel of each of the port's launch entries, and the launch
# it closes (csrc/gp_vg.cu, gp_predict.cu, gp_value.cu)
FINISH = {"gp_vg_finish_kernel": "vg", "gp_predict_finish_kernel": "predict",
          "gp_value_finish_kernel": "value"}
PORT_PREFIX = "gp_"


class Window:
    """Profile the enclosed window: `with Window(device) as w: ...`, then
    w.events: [(name, start_us, end_us)] of the device activity, sorted,
    w.host_t0 / w.host_t1 the host clock at the window's ends, and
    w.seconds the host seconds that stopping the profiler and reading its
    events took."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize(self.device)
        self.prof.__enter__()
        self.host_t0 = time.perf_counter()
        torch.ones(1, device=self.device).add_(1.0)      # the marker
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.host_t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        t = time.perf_counter()
        self.events = device_events(self.prof)
        self.seconds = {"stop": t - self.host_t1,
                        "events": time.perf_counter() - t}
        return False


def device_events(prof):
    """[(name, start_us, end_us)] of every device event (kernels, copies,
    sets), by start, from the profiler's raw results (fast at millions of
    events)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            s, d = float(e.start_us()), float(e.duration_us())
        out.append((e.name(), s, s + d))
    out.sort(key=lambda r: r[1])
    return out


def merged(events):
    """Merged busy intervals [(start_us, end_us)] of sorted events."""
    busy = []
    for _, a, b in events:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return busy


def launch_seconds(events):
    """{launch: device seconds} of the port's launch entries: a run of
    consecutive gp_* kernels closed by a finish kernel is one launch of the
    entry that kernel names; a run cut by another kernel is `other`."""
    out = {}
    run = 0.0
    for name, a, b in events:
        base = base_name(name)
        if not base.startswith(PORT_PREFIX):
            if run:
                out["other"] = out.get("other", 0.0) + run
            run = 0.0
            continue
        run += (b - a) * 1e-6
        if base in FINISH:
            out[FINISH[base]] = out.get(FINISH[base], 0.0) + run
            run = 0.0
    if run:
        out["other"] = out.get("other", 0.0) + run
    return out


def reduce(events, host_t0, host_t1, spans):
    """The trace's summary: busy_s, window_s, kernel seconds by base name,
    the port's launches (launch_seconds), and idle seconds by the harness
    span the gap's midpoint falls in. spans: [(label, host_start,
    host_end)] on the host clock."""
    window_s = host_t1 - host_t0
    if not events:
        return {"busy_s": 0.0, "window_s": window_s, "kernels": {},
                "launches": {}, "idle": {}}
    dev0 = events[0][1]
    end = dev0 + window_s * 1e6
    kernels = {}
    for name, a, b in events:
        base = base_name(name)
        kernels[base] = kernels.get(base, 0.0) + (b - a) * 1e-6
    busy = merged(events)
    busy_s = sum(min(b, end) - a for a, b in busy if a < end) * 1e-6
    idle = {}
    edges = [dev0] + [x for iv in busy for x in iv] + [end]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = host_t0 + ((a + b) / 2 - dev0) * 1e-6
        label = next((lab for lab, s, e in spans if s <= mid < e),
                     "outside the spans")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "launches": launch_seconds(events), "idle": idle}


def breakdown(summary, top=10):
    """The result line's breakdown: the device operations that took most
    time, and the idle time by what the host was doing."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
