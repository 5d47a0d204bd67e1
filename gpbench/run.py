"""Run one cell of the benchmark once:

    python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(gpbench/configs/<name>.json, through BENCHMARK.json's `configs`) and a
traffic mix (gpbench/traffic/<name>.json); its limits for `correct` are
gpbench/checks/<cell>.json. Found by name: the mix's mode
(gpbench/modes/<mode>.py: set-up, one unit of the window, the check), the
configuration's model (gpbench/models/<oi_model>.py: reference and flop
counts), each metric's reader (gpbench/metrics/<name>.py, or <the part
before the first dot>.py). Set-up makes the inputs from the seed, loads the
program's kernels (building them on a checkout's first run), makes the
engine and runs the mode's set-up; the window then runs the mode's units
(days or passes of gpsat_tpu_torch.local_experts.execute_buckets) until
--seconds have passed, whole units only. After it, the sampled answers are
held against the plain reference (gpbench/verify).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics and a breakdown of the device trace), device, checks.
Needs a CUDA device: without one, or with fewer than the cell asks for, it
exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpbench import generator, harness, names, peaks, trace, verify  # noqa

ROOT = names.ROOT
# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gpsat_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload, root=ROOT):
    """The cell's entry, configuration, traffic mix, limits, the metrics
    that apply to it ({"end_to_end": [...], "per_layer": [...]}), and the
    modules found by name: the mix's mode and the configuration's model."""
    bench = load_json(root, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    here = os.path.join(root, "gpbench")
    cfg = load_json(root, entry["file"])
    traffic = load_json(here, "traffic", cell["traffic"] + ".json")
    return {
        "cell": cell, "config": cfg, "traffic": traffic,
        "checks": load_json(here, "checks", workload + ".json"),
        "metrics": {kind: [m for m in bench[kind]
                           if workload in m.get("workloads", [workload])]
                    for kind in ("end_to_end", "per_layer")},
        "mode": names.load("modes", traffic["mode"], root),
        "model": names.load("models", cfg["model"]["oi_model"], root),
        "root": root,
    }


def metric_reader(name, root=ROOT):
    """read(rec, name) of gpbench/metrics/<name>.py, else of the file named
    by the part of `name` before its first dot."""
    for stem in (name, name.split(".")[0]):
        try:
            return names.load("metrics", stem, root).read
        except FileNotFoundError:
            pass
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{os.path.join(root, 'gpbench', 'metrics')}")


def run_cell(spec, seed, seconds, traced, device):
    """Set-up, window and check of one run; returns the run record. The
    traffic's mode (gpbench/modes/<mode>.py) sets up, runs each unit (a day
    or a pass) and checks; the window runs units until --seconds have
    passed, whole units only."""
    cfg, mode = spec["config"], spec["mode"]
    dep = cfg["deployment"]
    ctx = harness.Context(spec, device, T_START)
    ctx.mark("imports")
    if device.type == "cuda":
        from gpsat_tpu_torch.ops import _build
        _build.load_library()
        ctx.mark("kernels")
    obs = generator.observations(seed, dep)
    ctx.days = [generator.day_inputs(obs, dep, d)
                for d in mode.target_days(dep)]
    ctx.mark("inputs")
    D = int(np.shape(ctx.days[0]["X_list"][0])[1])
    ctx.prog = harness.Program(cfg, device, spec["traffic"].get("execute"),
                               coords_dim=D)
    ctx.mark("engine")
    mode.setup(ctx)
    rec = {"model": cfg["model"]["oi_model"], "D": D,
           "M": cfg["model"]["init_params"].get("num_inducing_points"),
           "root": spec["root"], "units": [], "trace": None,
           "setup_s": time.perf_counter() - T_START, "setup_parts": ctx.parts}

    window = trace.Window(device) if traced else None
    if window is not None:
        window.__enter__()
    t_w0 = time.perf_counter()
    while True:
        rec["units"].append(mode.unit(ctx, len(rec["units"])))
        if time.perf_counter() - t_w0 >= seconds:
            break
    rec["window_s"] = time.perf_counter() - t_w0
    if window is not None:
        window.__exit__(None, None, None)
        t0 = time.perf_counter()
        rec["trace"] = trace.reduce(window.events, window.host_t0,
                                    window.host_t1, spans(rec))
        rec["trace_s"] = dict(window.seconds,
                              reduce=time.perf_counter() - t0)
    rec["memory_peak_bytes"], rec["devices_used"] = device_memory()
    ctx.prog = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers = mode.check(ctx, seed)
    numbers["nonfinite"] = float(sum(u["nonfinite"] for u in rec["units"]))
    rec["worst"] = numbers.pop("_worst")
    rec["check_s"] = time.perf_counter() - t0
    rec["correct"], rec["checks"] = verify.judge(numbers,
                                                 spec["checks"]["limits"])
    return rec


def device_memory():
    """(the peak of allocated bytes on the fullest card, the cards the run
    allocated on); (0, 0) without a card."""
    if not torch.cuda.is_available():
        return 0, 0
    peaks_ = [int(torch.cuda.max_memory_allocated(i))
              for i in range(torch.cuda.device_count())]
    return max(peaks_), sum(p > 0 for p in peaks_)


def spans(rec):
    """The harness's host spans of the window: each level of each day or
    pass, and a pass's smoothing."""
    out = []
    for u in rec["units"]:
        start = u["t0"]
        if u["kind"] == "pass":
            out.append(("smooth_field", start, start + u["smooth_s"]))
            start += u["smooth_s"]
        for b, end in zip(u["buckets"], u["levels_t"]):
            out.append((f"{u['kind']} level N={b['n_max']}", start, end))
            start = end
        out.append((f"{u['kind']} tail", start, u["t1"]))
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(spec, rec, traced):
    """The JSON object of the last line, checks last."""
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec["metrics"][kind]:
        value = metric_reader(m["name"], spec["root"])(rec, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu",
           "kind": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu",
           "count": rec["devices_used"],
           "memory_peak_bytes": rec["memory_peak_bytes"],
           "card": peaks.power_limit()}
    line = {"correct": bool(rec["correct"]),
            "attempted": int(sum(u["experts"] for u in rec["units"])),
            "failed": int(sum(u["failed"] for u in rec["units"])),
            "metrics": metrics, "device": dev}
    if traced and rec["trace"]:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = trace.breakdown(rec["trace"])
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, v, lim in rec["checks"]}
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    # the configurations state float32 without TF32 (torch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"gpbench: the process holds {found}", file=sys.stderr)
        return 3
    line = result_line(spec, rec, bool(args.trace))
    print(f"gpbench: {args.workload} seed {args.seed}: set-up "
          f"{rec['setup_s']:.3f} s, window {rec['window_s']:.3f} s "
          f"({len(rec['units'])} units: "
          f"{[round(u['seconds'], 3) for u in rec['units']]}), check "
          f"{rec['check_s']:.3f} s; set-up parts "
          f"{ {k: round(v, 3) for k, v in rec['setup_parts'].items()} }"
          + (f"; trace {rec['trace_s']}" if "trace_s" in rec else ""),
          file=sys.stderr)
    for k, row in rec["worst"].items():
        print(f"worst {k}: {json.dumps(row)}", file=sys.stderr)
    for k, v, lim in rec["checks"]:
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
