"""Device-to-host reads of the program per unit: the program's
`host_reads` counts (gpsat_tpu_torch.tracing, on while the profiler runs)
from the first unit's start to the last unit's end, over the window's days
(host_reads.fit) or passes (host_reads.repredict). Nothing where the
program records nothing there (a program without the recorder) or the
window ran no unit of that kind."""

KIND = {"fit": "day", "repredict": "pass"}


def read(rec, name):
    try:
        from gpsat_tpu_torch import tracing
    except ImportError:
        return None
    units = [u for u in rec["units"] if u["kind"] == KIND[name.split(".")[1]]]
    if not units:
        return None
    t0, t1 = rec["units"][0]["t0"], rec["units"][-1]["t1"]
    records = [r for r in tracing.snapshot() if t0 <= r["t0"] < t1]
    if not records:
        return None
    reads = sum(r["counts"].get("host_reads", 0) for r in records)
    return reads / len(units)
