"""Share (%) of the float32 peak that the cholinv kernel reaches in an SGPR
window: the matrices the program factored there (its `cholinv_mats` count,
gpsat_tpu_torch.tracing, on while the profiler runs, from the first unit's
start to the last unit's end) times the useful flops of one factor and
inverse at the configuration's own M (gpbench/cholinv_flops.py), over the
peak, over the device seconds of the trace's gp_cholinv_* kernels. Nothing
outside SGPRModel (exact GPR's vg and predict launch the same gp_cholinv_*
kernels for their bordered factor, which the count does not see), without a
trace or its cholinv kernels, or where the program counts no matrix (a
program without the counter)."""

from gpbench import cholinv_flops, peaks

PREFIX = "gp_cholinv_"


def read(rec, name):
    tr = rec.get("trace")
    if not tr or rec["model"] != "SGPRModel" or not rec["units"]:
        return None
    try:
        from gpsat_tpu_torch import tracing
    except ImportError:
        return None
    t0, t1 = rec["units"][0]["t0"], rec["units"][-1]["t1"]
    mats = sum(r["counts"].get("cholinv_mats", 0) for r in tracing.snapshot()
               if t0 <= r["t0"] < t1)
    seconds = sum(s for k, s in tr["kernels"].items() if k.startswith(PREFIX))
    if not mats or seconds <= 0:
        return None
    useful = mats * cholinv_flops.factor_and_invert(rec["M"])
    return 100.0 * useful / peaks.FP32_FLOPS / seconds
