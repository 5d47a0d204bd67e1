"""Timing decorator (copy of gpsat_tpu/decorators.py; reference:
GPSat/decorators.py:6)."""

import functools
import os
import time

_TIMER_ENABLED = os.environ.get("GPSAT_TPU_TIMER", "0") not in ("0", "false", "False")


def timer(func):
    """Print wall time of each call when GPSAT_TPU_TIMER is set.

    Unlike the reference, timing output is opt-in: the per-expert loop is gone,
    so per-call prints are rarely useful and pollute batched-run logs.
    """
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not _TIMER_ENABLED:
            return func(*args, **kwargs)
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        t1 = time.perf_counter()
        print(f"'{func.__name__}': {t1 - t0:.3f} seconds")
        return result
    return wrapper
