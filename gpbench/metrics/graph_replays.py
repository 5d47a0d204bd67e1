"""CUDA graph replays a day of the program's L-BFGS loops: the program's
`graph_replays` counts (gpsat_tpu_torch.tracing, on while the profiler runs:
one a replayed iteration, in the pool and the one-shot loop alike) from the
first unit's start to the last unit's end, over the window's days. Nothing
where the program counts no replay there (a program that replays no graph)
or the window ran no day."""


def read(rec, name):
    try:
        from gpsat_tpu_torch import tracing
    except ImportError:
        return None
    days = [u for u in rec["units"] if u["kind"] == "day"]
    if not days:
        return None
    t0, t1 = rec["units"][0]["t0"], rec["units"][-1]["t1"]
    counts = [r["counts"]["graph_replays"] for r in tracing.snapshot()
              if t0 <= r["t0"] < t1 and "graph_replays" in r["counts"]]
    if not counts:
        return None
    return sum(counts) / len(days)
