"""Milliseconds a pass spends smoothing the hyperparameter fields
(postprocessing.smooth_field, every field, host clock ending in numpy
results), averaged over the window's passes. Nothing where no unit
smoothed."""


def read(rec, name):
    smooth = [u["smooth_s"] for u in rec["units"] if "smooth_s" in u]
    if not smooth:
        return None
    return 1e3 * sum(smooth) / len(smooth)
