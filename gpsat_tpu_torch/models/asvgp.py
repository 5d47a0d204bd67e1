"""Actually-Sparse VGP local-expert model, B-spline inducing features (torch
port of gpsat_tpu/models/asvgp.py; reference parity: GPflowASVGPModel,
GPSat/models/asvgp_model.py:18-214).

The interface of VFFModel (separable Matern product kernel on a per-expert
box domain, per-dimension lengthscales and kernel_variance), with uniform
B-spline features matched to the Matern order (reference basis mapping:
asvgp_model.py:154-165). `num_inducing_features` is the number of basis
functions per dimension; M_total = prod_d m_d.
"""

from gpsat_tpu_torch.models.vff import VFFModel
from gpsat_tpu_torch.ops import asvgp as asvgp_math

__all__ = ["ASVGPModel"]


class ASVGPModel(VFFModel):
    """ASVGP expert: O(N M) feature build (banded), O(M^3) an iteration."""

    _math = asvgp_math

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("jitter", asvgp_math.DEFAULT_JITTER)
        super().__init__(*args, **kwargs)
        degree = asvgp_math.spline_degree(self.kernel)
        for m in self.ms:
            assert m > degree, (
                f"ASVGP needs num_inducing_features > spline degree "
                f"({degree}) for kernel {self.kernel}; got {m}")
