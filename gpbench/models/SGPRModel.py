"""What the benchmark knows of the program's SGPR (SGPRModel): the plain
float64 reference of its reported objective (the collapsed ELBO, which its
fit maximises) and of its posterior, its inducing points worked out again
from the program's documented recipe, and the useful flops of one
evaluation and one prediction at an expert's own N, M (the inducing points
it holds) and P."""

from gpbench import flops
from gpbench.reference import gp
from gpbench.reference.inducing import inducing_rows

MAXIMISED = True


def extras(cfg, inp):
    """{expert id: the rows of its X that are its inducing points}."""
    return inducing_rows([len(o) for o in inp["obs_list"]],
                         [len(p) for p in inp["pred_list"]],
                         cfg["model"]["init_params"]["num_inducing_points"],
                         cfg["defaults"]["inducing_seed"])


def objective(theta, X, y, Z, jitter):
    return gp.sgpr_elbo(theta, X, y, Z, jitter)


def predict(theta, X, y, Z, Xs, jitter):
    return gp.sgpr_predict(theta, X, y, Z, Xs, jitter)


def eval_flops(n, m, d):
    return flops.sgpr_vg(n, m, d)


def predict_flops(n, m, p, d):
    return flops.sgpr_predict(n, m, p, d)
