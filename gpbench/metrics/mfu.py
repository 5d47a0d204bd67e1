"""The whole window's share (%) of the float32 peak: the useful flops of the
window's work at each expert's own sizes (a day: returned iterations times
one evaluation, and one prediction; a pass: one prediction) over the
window's seconds times the peak. One reader for mfu.fit and mfu.repredict."""

from gpbench import flops, peaks


def read(rec, name):
    useful = 0.0
    for u in rec["units"]:
        fit, pred = flops.unit_flops(rec, u)
        useful += fit + pred if u["kind"] == "day" else pred
    return 100.0 * useful / (rec["window_s"] * peaks.FP32_FLOPS)
