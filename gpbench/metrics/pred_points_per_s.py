"""Prediction points delivered a second: every expert's prediction points of
every pass of the window over all the time the window took (smoothing and
re-predict, host clock, each pass ending in numpy results). Nothing where
the window ran no pass."""


def read(rec, name):
    passes = [u for u in rec["units"] if u["kind"] == "pass"]
    if not passes:
        return None
    return sum(u["points"] for u in passes) / rec["window_s"]
