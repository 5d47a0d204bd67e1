"""Host milliseconds the L-BFGS pool spends issuing one pool iteration: the
time in the program's `lbfgs.issue` spans (gpsat_tpu_torch.tracing, on
while the profiler runs) from the first unit's start to the last unit's
end, over the window's pool iterations (every level's `pool_iterations`,
summed over the units). Nothing where the program records no span there
(a program without the recorder) or the window ran no pool iteration."""


def read(rec, name):
    try:
        from gpsat_tpu_torch import tracing
    except ImportError:
        return None
    units = rec["units"]
    if not units:
        return None
    t0, t1 = units[0]["t0"], units[-1]["t1"]
    spans = [r for r in tracing.snapshot()
             if r["name"] == "lbfgs.issue" and t0 <= r["t0"] < t1]
    iters = sum(b["pool_iterations"] for u in units for b in u["buckets"])
    if not spans or not iters:
        return None
    return 1e3 * sum(r["t1"] - r["t0"] for r in spans) / iters
