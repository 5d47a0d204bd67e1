"""Seconds from the start of the process to the first timed day or pass:
imports, the kernels' build (a checkout's first run) and load, the inputs
from the seed, the engine, the warm-up, and any fit the traffic's set-up
needs."""


def read(rec, name):
    return rec["setup_s"]
