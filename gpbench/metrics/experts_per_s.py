"""Experts fitted and predicted a second: every expert of every day of the
window over all the time the window took (host clock, each day ending in
numpy results). Nothing where the window ran no day."""


def read(rec, name):
    days = [u for u in rec["units"] if u["kind"] == "day"]
    if not days:
        return None
    return sum(u["experts"] for u in days) / rec["window_s"]
