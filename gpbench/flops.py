"""Useful float32 operations of the program's work, at each expert's own
sizes: N its observations, P its prediction points, M its inducing points,
D the coordinate dimension. Never the padded level or the slot count.

Frozen copies of chip_smoke.py's vg_flops / predict_flops (the exact-GPR
terms of bench.py's analytic_flops) and of bench.py's SGPR per-evaluation
and per-prediction terms.
"""


def gpr_vg(N, D):
    """One NLML value and gradient: K build, Cholesky, triangular inverse,
    K^-1, the alpha solves and the (D + 2) gradient contractions."""
    return N ** 3 + N * N * (3 * D + 12 + 3 * (D + 2))


def gpr_predict(N, P, D):
    """One expert's posterior mean and variance at P points."""
    return N ** 3 / 3.0 + 2.0 * N * N * P + N * P * (3 * D + 12)


def sgpr_vg(N, M, D):
    """One collapsed-ELBO value and gradient (route hybrid's terms)."""
    return (4.0 / 3.0) * M ** 3 + 7.0 * M * M * N \
        + M * N * (3 * D + 8 + 3 * (D + 2)) + M * M * (3 * D + 8)


def sgpr_predict(N, M, P, D):
    """One SGPR expert's posterior mean and variance at P points."""
    return (4.0 / 3.0) * M ** 3 + 3.0 * M * M * N \
        + 2.0 * M * M * P + M * P * (3 * D + 8)


def unit_flops(rec, unit):
    """(fit flops, predict flops) of one day or pass of a run record: each
    expert's returned iterations times its model's per-evaluation count
    (gpbench/models/<oi_model>.py), and one prediction each, at the
    expert's own N, M (at most N) and P."""
    from gpbench import names
    model = names.load("models", rec["model"], rec.get("root", names.ROOT))
    D, M = rec["D"], rec["M"]
    fit = pred = 0.0
    for n, p, it in zip(unit["n"], unit["p"], unit["iterations"]):
        n, p, it = int(n), int(p), int(it)
        m = None if M is None else min(M, n)
        fit += it * model.eval_flops(n, m, D)
        pred += model.predict_flops(n, m, p, D)
    return fit, pred
