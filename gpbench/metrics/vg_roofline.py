"""Share (%) of the float32 peak that the exact-GPR value-and-gradient
kernel reaches: each expert's returned iterations times the useful flops of
one evaluation at its own N, over the peak, over the device time of the vg
launches' CUDA kernels in the trace. Nothing without a trace or a vg
launch."""

from gpbench import flops, peaks


def read(rec, name):
    tr = rec.get("trace")
    if not tr or rec["model"] != "GPRModel" or not tr["launches"].get("vg"):
        return None
    useful = sum(flops.unit_flops(rec, u)[0] for u in rec["units"])
    return 100.0 * useful / peaks.FP32_FLOPS / tr["launches"]["vg"]
