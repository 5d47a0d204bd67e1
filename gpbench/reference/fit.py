"""Local optimisation of one expert's hyperparameters for the reference and
the control: L-BFGS-B (scipy) over the logarithms of the positive
hyperparameters, inside the configuration's bounds, with the objective and
its gradient from torch autograd in the objective's dtype.

The reference polishes the program's fitted point in float64: how much that
lowers the objective says how far the program stopped from a local optimum.
The control fits from the program's documented start in a lower precision,
as a program that took that step would.
"""

import numpy as np
import torch
from scipy.optimize import minimize

NAMES = ("lengthscales", "kernel_variance", "likelihood_variance")


def bounds_of(model, d):
    """{name: (low [k], high [k])} in scaled units from a configuration's
    `model` block: lengthscale bounds divided by coords_scale (the program
    scales them when coords_scale is set), the kernel variance unbounded
    (the program's default softplus)."""
    scale = np.asarray(model["init_params"].get("coords_scale", [1.0] * d),
                       dtype=float)
    cons = model.get("constraints", {})
    out = {}
    for name in NAMES:
        k = d if name == "lengthscales" else 1
        low, high = np.full(k, 1e-12), np.full(k, np.inf)
        if name in cons:
            low = np.broadcast_to(np.asarray(cons[name]["low"], float), (k,))
            high = np.broadcast_to(np.asarray(cons[name]["high"], float),
                                   (k,))
            if name == "lengthscales":
                low, high = low / scale, high / scale
        out[name] = (np.array(low, float), np.array(high, float))
    return out


def start_of(y, bounds, d):
    """The program's documented start for one expert: lengthscales 1 (scaled
    units), kernel variance the signal variance, likelihood variance a tenth
    of it, each moved 1e-2 inside its bounds (as the engine does)."""
    var = max(float(np.var(y)), 1e-10)
    start = {"lengthscales": np.ones(d), "kernel_variance": np.array([var]),
             "likelihood_variance": np.array([0.1 * var])}
    for name, (low, high) in bounds.items():
        tol = min(1e-2, float(np.min(high - low)) / 2)
        start[name] = np.clip(start[name], low + tol, high - tol)
    return start


def _pack(theta):
    return np.log(np.concatenate([np.ravel(theta[n]) for n in NAMES]))


def _unpack(v, d, dtype, device):
    v = torch.as_tensor(v, dtype=dtype, device=device)
    return {"lengthscales": torch.exp(v[:d]),
            "kernel_variance": torch.exp(v[d]),
            "likelihood_variance": torch.exp(v[d + 1])}


def minimise(loss, theta0, bounds, d, dtype, device, maxiter=500):
    """L-BFGS-B on loss(theta) -> 0-d tensor from theta0 ({name: array}),
    in log space inside `bounds`. Returns (theta {name: array}, loss as a
    float in the loss's own precision)."""
    lo = np.log(np.concatenate([bounds[n][0] for n in NAMES]))
    hi = np.concatenate([bounds[n][1] for n in NAMES])
    hi = np.where(np.isfinite(hi), np.log(np.where(np.isfinite(hi), hi, 1)),
                  None)
    v0 = np.clip(_pack(theta0), lo, [h if h is not None else np.inf
                                      for h in hi])

    def fg(v):
        vt = torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
        th = {"lengthscales": torch.exp(vt[:d]),
              "kernel_variance": torch.exp(vt[d]),
              "likelihood_variance": torch.exp(vt[d + 1])}
        f = loss(th)
        (g,) = torch.autograd.grad(f, vt)
        f, g = float(f.detach()), g.double().cpu().numpy()
        if not np.isfinite(f) or not np.all(np.isfinite(g)):
            return 1e30, np.zeros_like(v)
        return f, g

    res = minimize(fg, v0, jac=True, method="L-BFGS-B",
                   bounds=list(zip(lo, hi)),
                   options={"maxiter": maxiter, "ftol": 1e-13,
                            "gtol": 1e-9})
    th = _unpack(res.x, d, torch.float64, "cpu")
    return {k: v.numpy().reshape(-1) for k, v in th.items()}, float(res.fun)


def as_theta(params, dtype, device):
    """{name: array} -> the reference's theta dict of tensors."""
    return {n: torch.as_tensor(np.asarray(params[n], dtype=float).reshape(
        -1 if n == "lengthscales" else ()), dtype=dtype, device=device)
        for n in NAMES}
