"""Actually-Sparse Variational GP features (B-spline inducing functions),
masked and batched (torch port of gpsat_tpu/ops/asvgp.py; the reference's
optional ASVGP backend is GPSat/models/asvgp_model.py:18-214).

Inter-domain inducing variables are RKHS projections of the GP onto uniform
B-spline basis functions on a box [a, b]^D. By the reproducing property
Kuf[m, i] = phi_m(x_i), a banded, hyperparameter-free feature matrix, and
Kuu[m, n] = <phi_m, phi_n>_H is a banded Gram matrix under the Matern RKHS
inner product. The D-dim model is the Kronecker product over per-dimension
bases, with the collapsed bound of ops/vff.py.

The Matern-p RKHS inner product on [a, b] is
    <f, g> = pref(lam, s2) * sum_r binom(p+1, r) lam^{2(p+1-r)} Int f^(r) g^(r)
             + jets(a)^T Qa jets(a-g) + jets(b)^T Qb jets(b-g)
with pref = 1/(2 lam s2), 1/(4 lam^3 s2), 3/(16 lam^5 s2) for p = 0, 1, 2
and boundary quadratic forms Q from the minimal-norm tail extension. For
uniform B-splines on integer knots the integrals and boundary jets are
constants scaled by powers of the knot spacing h (`_standard_grams`, numpy,
cast to the engine's dtype and device at use), so Kuu(theta) is a cheap
differentiable combination of fixed matrices.

Basis: degree-k cardinal B-splines matched to the Matern order (B1/Matern12,
B2/Matern32, B3/Matern52, asvgp_model.py:154-165), m basis functions per
dimension spanning m - k uniform intervals on [a, b]. Shapes as in
ops/vff.py: leading batch dimensions on every argument.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from gpsat_tpu_torch.ops.vff import (_khatri_rao_rows, _per_dim, collapsed,
                                     collapsed_elbo, collapsed_predict)

__all__ = ["kuu_dense", "kuf", "elbo", "neg_elbo", "predict",
           "spline_degree", "cardinal_bspline", "cardinal_bspline_deriv",
           "DEFAULT_JITTER"]

DEFAULT_JITTER = 1e-8

_DEGREE = {"Matern12": 1, "Matern32": 2, "Matern52": 3}
_SUPPORTED = tuple(_DEGREE)


def spline_degree(kernel):
    """B-spline degree matched to the Matern RKHS order."""
    if kernel not in _DEGREE:
        raise NotImplementedError(
            f"ASVGP supports {_SUPPORTED}, got: {kernel}")
    return _DEGREE[kernel]


def cardinal_bspline(p, t):
    """Cardinal B-spline B_p(t), support [0, p+1] (Cox-de Boor recursion), of
    a tensor or a numpy array."""
    def B(k, u):
        if k == 0:
            box = (u >= 0) & (u < 1)
            return box.to(u.dtype) if isinstance(u, torch.Tensor) \
                else box.astype(float)
        return (u * B(k - 1, u) + (k + 1 - u) * B(k - 1, u - 1)) / k
    return B(p, t)


def cardinal_bspline_deriv(p, t, r):
    """r-th derivative of B_p: finite differences of B_{p-r}."""
    if r == 0:
        return cardinal_bspline(p, t)
    out = None
    for i in range(r + 1):
        term = ((-1) ** i * math.comb(r, i)) * cardinal_bspline(p - r, t - i)
        out = term if out is None else out + term
    return out


@lru_cache(maxsize=None)
def _standard_grams(m, degree):
    """Hyperparameter-free spline constants on integer knots (numpy f64).

    Returns (G, Ja, Jb): G [degree+1, m, m] with G[r] = Int_0^{m-degree}
    B^(r)_i B^(r)_j du on standardised coordinates; Ja/Jb [degree, m]
    boundary jets at u = 0 and u = m - degree. Exact by Gauss-Legendre
    (2*degree+2 points per unit interval covers the piecewise-polynomial
    integrands of degree <= 2*degree).
    """
    p = degree
    ni = m - p
    assert ni >= 1, f"need m > degree ({m} <= {p})"
    q, w = np.polynomial.legendre.leggauss(2 * p + 2)
    # nodes in every unit interval [e, e+1]
    u = (np.arange(ni)[:, None] + (q[None, :] + 1.0) / 2.0).reshape(-1)
    wts = np.tile(w / 2.0, ni)
    j = np.arange(m)
    G = np.empty((p + 1, m, m))
    for r in range(p + 1):
        # Phi[r][n, j] = B^(r)_p(u_n - j + p)
        Phi = cardinal_bspline_deriv(p, u[:, None] - j[None, :] + p, r)
        G[r] = (Phi * wts[:, None]).T @ Phi
    # jets only up to order p-1 enter the boundary forms (continuous there)
    Ja = np.empty((p, m))
    Jb = np.empty((p, m))
    for r in range(p):
        Ja[r] = cardinal_bspline_deriv(p, 0.0 - j + p, r)
        Jb[r] = cardinal_bspline_deriv(p, float(ni) - j + p, r)
    return G, Ja, Jb


def _boundary_q(kernel, lam):
    """Boundary quadratic form Q (in jets f, f', ... f^(p-1)) at the *right*
    boundary, times s2 (the caller applies 1/s2), as nested lists Q[r][s] of
    [...] entries. At the left boundary odd-derivative entries flip sign."""
    if kernel == "Matern12":
        return [[0.5 * torch.ones_like(lam)]]
    if kernel == "Matern32":
        q01 = 1.0 / (4.0 * lam)
        return [[0.5 * torch.ones_like(lam), q01],
                [q01, 1.0 / (2.0 * lam ** 2)]]
    # Matern52
    q00 = 9.0 / 16.0 * torch.ones_like(lam)
    q01 = 9.0 / (16.0 * lam)
    q02 = 3.0 / (16.0 * lam ** 2)
    q11 = 3.0 / (2.0 * lam ** 2)
    q12 = 9.0 / (16.0 * lam ** 3)
    q22 = 9.0 / (16.0 * lam ** 4)
    return [[q00, q01, q02], [q01, q11, q12], [q02, q12, q22]]


_LAM_MULT = {"Matern12": 1.0, "Matern32": math.sqrt(3.0),
             "Matern52": math.sqrt(5.0)}
_PREF_C = {"Matern12": 2.0, "Matern32": 4.0, "Matern52": 16.0 / 3.0}


@lru_cache(maxsize=None)
def _grams_on(m, degree, dtype, device):
    """`_standard_grams` as tensors on `device` in `dtype`: (G [p+1, m, m],
    JA [p, p, m, m], JB [p, p, m, m]) with JA[r, s] = outer(Ja[r], Ja[s])."""
    G, Ja, Jb = _standard_grams(m, degree)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return (t(G), t(Ja[:, None, :, None] * Ja[None, :, None, :]),
            t(Jb[:, None, :, None] * Jb[None, :, None, :]))


def kuu_dense(kernel, lengthscale, variance, a, b, m, jitter=0.0):
    """Per-dim Kuu [..., m, m]: the B-spline Gram matrix under the Matern
    RKHS inner product on [a, b]. Differentiable in lengthscale, variance,
    a and b."""
    p = spline_degree(kernel)
    m = int(m)
    ni = m - p
    h = (b - a) / ni
    G, JA, JB = _grams_on(m, p, h.dtype, h.device)
    lam = _LAM_MULT[kernel] / lengthscale
    pref = 1.0 / (_PREF_C[kernel] * lam ** (2 * p - 1) * variance)

    out = 0.0
    for r in range(p + 1):
        w_r = math.comb(p, r) * lam ** (2 * (p - r))
        out = out + (pref * w_r * h ** (1 - 2 * r))[..., None, None] * G[r]

    Q = _boundary_q(kernel, lam)
    for r in range(p):
        for s in range(p):
            hs = h ** (-(r + s))
            qa = Q[r][s] * ((-1.0) ** r * (-1.0) ** s)
            out = out + (qa * hs / variance)[..., None, None] * JA[r, s] \
                + (Q[r][s] * hs / variance)[..., None, None] * JB[r, s]
    return out + jitter * torch.eye(m, dtype=h.dtype, device=h.device)


def kuf(kernel, x, a, b, m):
    """Per-dim feature matrix [..., m, N]: phi_j(x_i) = B_p((x-a)/h - j + p).
    Hyperparameter-free (reproducing property); zero outside the support."""
    p = spline_degree(kernel)
    ni = int(m) - p
    h = (b - a) / ni
    u = (x - a[..., None]) / h[..., None]
    j = torch.arange(int(m), dtype=x.dtype, device=x.device)
    return cardinal_bspline(p, u[..., None, :] - j[:, None] + p)


def _common(params, X, y, mask, a, b, ms, kernel, jitter):
    """Per-dimension blocks and the collapsed factor for elbo/predict."""
    D = X.shape[-1]
    ls = _per_dim(params["lengthscales"], X)
    kv = _per_dim(params["kernel_variance"], X)
    sn2 = torch.as_tensor(params["likelihood_variance"], dtype=X.dtype,
                          device=X.device)
    Kuf_d = [kuf(kernel, X[..., i], a[..., i], b[..., i], ms[i])
             for i in range(D)]
    Kuu_d = [kuu_dense(kernel, ls[..., i], kv[..., i], a[..., i], b[..., i],
                       ms[i], jitter=jitter) for i in range(D)]
    return kv, sn2, Kuu_d, collapsed(Kuf_d, Kuu_d, y, mask, sn2)


def elbo(params, X, y, mask, a, b, ms, kernel="Matern32",
         jitter=DEFAULT_JITTER):
    """Collapsed bound; the structure of the VFF GPR_kron bound (reference:
    GPSat/vff.py:612-644, shared by the external ASVGP GPR_kron)."""
    kv, sn2, Kuu_d, (mf, _, KufKfu, y_m, L, c) = _common(
        params, X, y, mask, a, b, ms, kernel, jitter)
    return collapsed_elbo(Kuu_d, kv, sn2, mf, KufKfu, y_m, L, c)


def neg_elbo(params, X, y, mask, a, b, ms, kernel="Matern32",
             jitter=DEFAULT_JITTER):
    return -elbo(params, X, y, mask, a, b, ms, kernel, jitter)


def predict(params, X, y, mask, Xs, a, b, ms, kernel="Matern32",
            jitter=DEFAULT_JITTER):
    """Posterior at Xs. Points outside the spline domain fall back to the
    prior (their features are zero): size the domain to cover predictions."""
    kv, sn2, Kuu_d, (_, _, _, _, L, c) = _common(
        params, X, y, mask, a, b, ms, kernel, jitter)
    Kus = _khatri_rao_rows([kuf(kernel, Xs[..., i], a[..., i], b[..., i],
                                ms[i]) for i in range(X.shape[-1])])
    return collapsed_predict(Kuu_d, Kus, kv, sn2, L, c)
