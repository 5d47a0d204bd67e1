"""What the benchmark knows of the program's exact GPR (GPRModel): the
plain float64 reference of its reported objective (the NLML, which its fit
minimises) and of its posterior, and the useful flops of one evaluation and
one prediction at an expert's own sizes."""

from gpbench import flops
from gpbench.reference import gp

MAXIMISED = False


def extras(cfg, inp):
    """The rows of each expert's X that the model derives (none)."""
    return None


def objective(theta, X, y, Z, jitter):
    return gp.gpr_nlml(theta, X, y)


def predict(theta, X, y, Z, Xs, jitter):
    return gp.gpr_predict(theta, X, y, Xs)


def eval_flops(n, m, d):
    return flops.gpr_vg(n, d)


def predict_flops(n, m, p, d):
    return flops.gpr_predict(n, p, d)
