"""Host milliseconds of one SGPR value-and-gradient evaluation: the time in
the program's `sgpr.vg` spans (gpsat_tpu_torch.tracing, on while the
profiler runs: one a call of ops/cuda_sgpr.sgpr_vg_batched) from the first
unit's start to the last unit's end, over the number of those spans. On the
eager route hybrid that is the cost of issuing its kernels. Nothing where
the program records no such span there (exact GPR, or a program without
the span)."""


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
             if r["name"] == "sgpr.vg" and t0 <= r["t0"] < t1]
    if not spans:
        return None
    return 1e3 * sum(r["t1"] - r["t0"] for r in spans) / len(spans)
