"""Share (%) of the float32 peak that the exact-GPR prediction kernel
reaches: the useful flops of one prediction per expert at its own N and P,
over the peak, over the device time of the predict launches' CUDA kernels
in the trace. Nothing without a trace or a predict launch."""

from gpbench import flops, peaks


def read(rec, name):
    tr = rec.get("trace")
    if not tr or rec["model"] != "GPRModel" or \
            not tr["launches"].get("predict"):
        return None
    useful = sum(flops.unit_flops(rec, u)[1] for u in rec["units"])
    return 100.0 * useful / peaks.FP32_FLOPS / tr["launches"]["predict"]
