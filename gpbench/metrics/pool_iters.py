"""L-BFGS pool iterations a day: the sum over a day's levels of each
level's pool iterations (0 for a level that ran no pool), averaged over the
window's days. Nothing where the window ran no day."""


def read(rec, name):
    days = [sum(b["pool_iterations"] for b in u["buckets"])
            for u in rec["units"] if u["kind"] == "day"]
    if not days:
        return None
    return sum(days) / len(days)
