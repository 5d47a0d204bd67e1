"""Variational Fourier Features (Hensman, Durrande & Solin 2017), masked and
batched (torch port of gpsat_tpu/ops/vff.py; the reference's VFF stack is
GPSat/vff.py:14-676).

Inter-domain inducing variables are Fourier projections of the GP on a box
[a, b]^D with a separable product of 1-D Matern kernels. Per dimension, Kuu
has the closed form diag + low rank; the D-dim Kuu is their Kronecker
product and Kuf a row-wise Khatri-Rao product of per-dimension sinusoid
features. The collapsed (Titsias) bound then needs one Cholesky of
P = Kuu + Kuf Kfu / sigma^2 of size M_total = prod_d (2 m_d - 1).

Every function takes arbitrary leading batch dimensions: X [..., N, D],
y/mask [..., N], the box a, b [..., D], lengthscales and kernel_variance
[..., D] (a kernel_variance of shape [...] is taken for every dimension),
likelihood_variance [...]; the per-dimension helpers take the same leading
dimensions without the D. The JAX package vmaps the single-expert form.
The collapsed-bound helpers here serve ops/asvgp.py too, which swaps in its
B-spline Kuu and Kuf.
"""

import math
from functools import reduce

import torch

from gpsat_tpu_torch.ops.gpr import _cholesky

__all__ = ["kuu_dense", "kuf", "elbo", "neg_elbo", "predict", "num_features",
           "DEFAULT_JITTER"]

DEFAULT_JITTER = 1e-8

_SUPPORTED = ("Matern12", "Matern32", "Matern52")


def num_features(m):
    """Per-dim inducing count: m cosines (incl. omega=0) + (m-1) sines."""
    return 2 * int(m) - 1


def _omegas(m, a, b):
    """[..., m] frequencies 2 pi k / (b - a), in the dtype of the box: an f32
    box gives f32 features throughout (the JAX package anchors its dtype the
    same way, gpsat_tpu/ops/vff.py:37-44)."""
    ms = torch.arange(m, dtype=a.dtype, device=a.device)
    return 2.0 * math.pi * ms / (b - a)[..., None]


def _diag_plus(d, *vs):
    """diag(d) + sum of outer(v, v), batched over the leading dimensions."""
    out = torch.diag_embed(d)
    for v in vs:
        out = out + v[..., :, None] * v[..., None, :]
    return out


def kuu_dense(kernel, lengthscale, variance, a, b, m, jitter=0.0):
    """Dense per-dim Kuu [..., 2m-1, 2m-1] from the closed-form spectra
    (formulas: VFF paper Table 1; reference: GPSat/vff.py:381-457)."""
    om = _omegas(m, a, b)
    om_sin = om[..., 1:]
    span = (b - a)[..., None]
    ls = lengthscale[..., None]
    var = variance[..., None]
    ones = torch.ones_like(om)

    if kernel == "Matern12":
        lam = 1.0 / ls
        two_or_four = torch.where(om == 0, 2.0, 4.0).to(om.dtype)
        d_cos = span * (lam**2 + om**2) / lam / var / two_or_four
        K_cos = _diag_plus(d_cos, ones / torch.sqrt(var))
        d_sin = span * (lam**2 + om_sin**2) / lam / var / 4.0
        K_sin = torch.diag_embed(d_sin)
    elif kernel == "Matern32":
        lam = math.sqrt(3.0) / ls
        four_or_eight = torch.where(om == 0, 4.0, 8.0).to(om.dtype)
        d_cos = span * (lam**2 + om**2) ** 2 / lam**3 / var / four_or_eight
        K_cos = _diag_plus(d_cos, ones / torch.sqrt(var))
        d_sin = span * (lam**2 + om_sin**2) ** 2 / lam**3 / var / 8.0
        K_sin = _diag_plus(d_sin, om_sin / lam / torch.sqrt(var))
    elif kernel == "Matern52":
        lam = math.sqrt(5.0) / ls
        sixteen_or_32 = torch.where(om == 0, 16.0, 32.0).to(om.dtype)
        v1 = (3.0 * (om / lam) ** 2 - 1.0) / torch.sqrt(8.0 * var)
        v2 = ones / torch.sqrt(var)
        d_cos = 3.0 * span / sixteen_or_32 / lam**5 / var \
            * (lam**2 + om**2) ** 3
        K_cos = _diag_plus(d_cos, v1, v2)
        v_sin = math.sqrt(3.0) * om_sin / lam / torch.sqrt(var)
        d_sin = 3.0 * span / 32.0 / lam**5 / var \
            * (lam**2 + om_sin**2) ** 3
        K_sin = _diag_plus(d_sin, v_sin)
    else:
        raise NotImplementedError(
            f"VFF supports {_SUPPORTED}, got: {kernel}")

    z = K_cos.new_zeros(K_cos.shape[:-1] + (m - 1,))
    out = torch.cat([torch.cat([K_cos, z], dim=-1),
                     torch.cat([z.mT, K_sin], dim=-1)], dim=-2)
    return out + jitter * torch.eye(num_features(m), dtype=out.dtype,
                                    device=out.device)


def kuf(kernel, lengthscale, x, a, b, m):
    """Per-dim feature matrix [..., 2m-1, N]: cos/sin evaluations with
    boundary corrections outside [a, b] (reference: GPSat/vff.py:457-518)."""
    om = _omegas(m, a, b)[..., :, None]
    om_sin = om[..., 1:, :]
    a_, b_ = a[..., None], b[..., None]
    Kcos = torch.cos(om * (x - a_)[..., None, :])
    Ksin = torch.sin(om_sin * (x - a_)[..., None, :])

    lt_a = (x < a_)[..., None, :]
    gt_b = (x > b_)[..., None, :]
    ls = lengthscale[..., None]
    if kernel == "Matern12":
        edge_a = torch.exp(-torch.abs(x - a_) / ls)[..., None, :]
        edge_b = torch.exp(-torch.abs(x - b_) / ls)[..., None, :]
        Kcos = torch.where(lt_a, edge_a, Kcos)
        Kcos = torch.where(gt_b, edge_b, Kcos)
        Ksin = torch.where(lt_a | gt_b, torch.zeros_like(Ksin), Ksin)
    elif kernel == "Matern32":
        arg_a = math.sqrt(3.0) * torch.abs(x - a_) / ls
        arg_b = math.sqrt(3.0) * torch.abs(x - b_) / ls
        Kcos = torch.where(lt_a, ((1 + arg_a) * torch.exp(-arg_a))[..., None, :],
                           Kcos)
        Kcos = torch.where(gt_b, ((1 + arg_b) * torch.exp(-arg_b))[..., None, :],
                           Kcos)
        edge_sa = ((x - a_) * torch.exp(-arg_a))[..., None, :] * om_sin
        edge_sb = ((x - b_) * torch.exp(-arg_b))[..., None, :] * om_sin
        Ksin = torch.where(lt_a, edge_sa, Ksin)
        Ksin = torch.where(gt_b, edge_sb, Ksin)
    # Matern52: edges not implemented in the reference either
    #           (vff.py:500-515 asserts in-domain); in-domain values are exact
    return torch.cat([Kcos, Ksin], dim=-2)


def _khatri_rao_rows(mats):
    """Row-wise Kronecker stack: [..., M1, N], [..., M2, N] -> [..., M1*M2, N]
    (reference: make_kvs, GPSat/vff.py:528-559)."""
    def two(A, B):
        return (A[..., :, None, :] * B[..., None, :, :]).reshape(
            A.shape[:-2] + (A.shape[-2] * B.shape[-2], A.shape[-1]))
    return reduce(two, mats)


def _kron(mats):
    def two(A, B):
        return (A[..., :, None, :, None] * B[..., None, :, None, :]).reshape(
            A.shape[:-2] + (A.shape[-2] * B.shape[-2],
                            A.shape[-1] * B.shape[-1]))
    return reduce(two, mats)


def _per_dim(v, X):
    """A parameter of shape [...] or [..., D] as [..., D] (X [..., N, D])."""
    v = torch.as_tensor(v, dtype=X.dtype, device=X.device)
    if v.ndim == X.ndim - 2:
        v = v[..., None]
    return v.expand(X.shape[:-2] + (X.shape[-1],))


def collapsed(Kuf_d, Kuu_d, y, mask, sn2):
    """The collapsed-bound factor shared by VFF and ASVGP: (mf, Kuf, KufKfu,
    y_m, L, c) with L the lower factor of P = Kuf Kfu / sn2 + kron(Kuu_d)
    and c = L^{-1} Kuf y / sn2."""
    mf = mask.to(Kuf_d[0].dtype)
    Kuf = _khatri_rao_rows(Kuf_d) * mf[..., None, :]
    y_m = y * mf
    KufY = (Kuf @ y_m[..., None])[..., 0]
    KufKfu = Kuf @ Kuf.mT
    P = KufKfu / sn2[..., None, None] + _kron(Kuu_d)
    L = _cholesky(P)
    c = torch.linalg.solve_triangular(
        L, KufY[..., None], upper=False)[..., 0] / sn2[..., None]
    return mf, Kuf, KufKfu, y_m, L, c


def collapsed_elbo(Kuu_d, kv, sn2, mf, KufKfu, y_m, L, c):
    """Collapsed bound (reference: GPR_kron.elbo, GPSat/vff.py:612-644) from
    `collapsed`'s factors; kv [..., D] per-dimension variances."""
    n = torch.sum(mf, dim=-1)
    kdiag_total = torch.prod(kv, dim=-1)  # separable stationary product

    log_det_P = 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    M_total = math.prod(Ad.shape[-1] for Ad in Kuu_d)
    # logdet(kron(A_d)) = sum_d (M_total / M_d) logdet(A_d)
    kuu_logdet = 0.0
    for Ad in Kuu_d:
        _, ld = torch.linalg.slogdet(Ad)
        kuu_logdet = kuu_logdet + (M_total / Ad.shape[-1]) * ld

    Kuu_inv = _kron([torch.linalg.inv(Ad) for Ad in Kuu_d])

    out = -0.5 * n * torch.log(2.0 * math.pi * sn2)
    out = out - 0.5 * log_det_P
    out = out + 0.5 * kuu_logdet
    out = out - 0.5 * torch.sum(y_m * y_m, dim=-1) / sn2
    out = out + 0.5 * torch.sum(c * c, dim=-1)
    out = out - 0.5 * kdiag_total * n / sn2
    out = out + 0.5 * torch.sum(Kuu_inv * KufKfu, dim=(-2, -1)) / sn2
    return out


def collapsed_predict(Kuu_d, Kus, kv, sn2, L, c):
    """Posterior at the points of the features Kus [..., M, P]
    (reference: GPR_kron.predict_f, GPSat/vff.py:645)."""
    tmp = torch.linalg.solve_triangular(L, Kus, upper=False)
    mean = (tmp.mT @ c[..., None])[..., 0]
    Kuu_inv = _kron([torch.linalg.inv(Ad) for Ad in Kuu_d])
    KiKus = Kuu_inv @ Kus
    var = torch.prod(kv, dim=-1)[..., None] + torch.sum(tmp * tmp, dim=-2) \
        - torch.sum(KiKus * Kus, dim=-2)
    var = torch.clamp_min(var, 0.0)
    return {"f*": mean, "f*_var": var, "y_var": var + sn2[..., None]}


def _common(params, X, y, mask, a, b, ms, kernel, jitter):
    """Per-dimension blocks and the collapsed factor for elbo/predict."""
    D = X.shape[-1]
    ls = _per_dim(params["lengthscales"], X)
    kv = _per_dim(params["kernel_variance"], X)
    sn2 = torch.as_tensor(params["likelihood_variance"], dtype=X.dtype,
                          device=X.device)
    Kuf_d = [kuf(kernel, ls[..., i], X[..., i], a[..., i], b[..., i], ms[i])
             for i in range(D)]
    Kuu_d = [kuu_dense(kernel, ls[..., i], kv[..., i], a[..., i], b[..., i],
                       ms[i], jitter=jitter) for i in range(D)]
    return ls, kv, sn2, Kuu_d, collapsed(Kuf_d, Kuu_d, y, mask, sn2)


def elbo(params, X, y, mask, a, b, ms, kernel="Matern32",
         jitter=DEFAULT_JITTER):
    """Collapsed VFF bound of (padded) experts; [...] values."""
    _, kv, sn2, Kuu_d, (mf, _, KufKfu, y_m, L, c) = _common(
        params, X, y, mask, a, b, ms, kernel, jitter)
    return collapsed_elbo(Kuu_d, kv, sn2, mf, KufKfu, y_m, L, c)


def neg_elbo(params, X, y, mask, a, b, ms, kernel="Matern32",
             jitter=DEFAULT_JITTER):
    return -elbo(params, X, y, mask, a, b, ms, kernel, jitter)


def predict(params, X, y, mask, Xs, a, b, ms, kernel="Matern32",
            jitter=DEFAULT_JITTER):
    """Posterior at Xs [..., P, D]; keys as the reference."""
    ls, kv, sn2, Kuu_d, (_, _, _, _, L, c) = _common(
        params, X, y, mask, a, b, ms, kernel, jitter)
    Kus = _khatri_rao_rows([kuf(kernel, ls[..., i], Xs[..., i], a[..., i],
                                b[..., i], ms[i])
                            for i in range(X.shape[-1])])
    return collapsed_predict(Kuu_d, Kus, kv, sn2, L, c)
