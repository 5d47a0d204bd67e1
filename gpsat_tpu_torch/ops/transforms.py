"""Bijectors for constrained hyperparameter optimisation (torch port of
gpsat_tpu/ops/transforms.py).

Optimisation runs in unconstrained space; these map unconstrained variables
to constrained parameters and back (reference semantics: GPflow's Sigmoid /
Softplus transforms). A bijector's tensors (shift, low, high) may carry a
leading expert axis, as the batched bijectors of the JAX engine do after its
broadcast; `map_tensors` rebuilds one with every tensor transformed, which is
how the engine broadcasts, casts and gathers them per slot.
"""

import torch

__all__ = ["Bijector", "Identity", "Exp", "Softplus", "Sigmoid",
           "get_bijector"]


class Bijector:
    """forward: unconstrained -> constrained; inverse: constrained -> unconstrained."""

    _fields = ()

    def forward(self, u):
        raise NotImplementedError

    def inverse(self, v):
        raise NotImplementedError

    def map_tensors(self, fn):
        """Same bijector with `fn` applied to each of its tensors."""
        return type(self)(*(fn(getattr(self, f)) for f in self._fields))

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)}" for f in self._fields)
        return f"{type(self).__name__}({inner})"


class Identity(Bijector):
    def forward(self, u):
        return u

    def inverse(self, v):
        return v


class Exp(Bijector):
    def forward(self, u):
        return torch.exp(u)

    def inverse(self, v):
        return torch.log(v)


class Softplus(Bijector):
    """v = log(1 + e^u) + shift, numerically stable in both directions."""

    _fields = ("shift",)

    def __init__(self, shift=0.0):
        self.shift = torch.as_tensor(shift)

    def forward(self, u):
        # logaddexp(u, 0): the same form as jax.nn.softplus (torch's
        # F.softplus switches to the identity above a threshold)
        return torch.logaddexp(u, torch.zeros_like(u)) + \
            self.shift.to(u)

    def inverse(self, v):
        y = v - self.shift.to(v)
        # log(e^y - 1) = y + log(1 - e^-y), stable for large y; log(y) for tiny y
        y_safe = torch.clamp_min(y, 1e-300)
        small = y_safe < 1e-10
        out = torch.where(
            small, torch.log(y_safe),
            y_safe + torch.log(-torch.expm1(-torch.where(
                small, torch.ones_like(y_safe), y_safe))))
        return torch.where(y <= 0, torch.full_like(out, -torch.inf), out)


class Sigmoid(Bijector):
    """v = low + (high - low) * sigmoid(u); box constraint (low, high)."""

    _fields = ("low", "high")

    def __init__(self, low=0.0, high=1.0):
        self.low = torch.as_tensor(low)
        self.high = torch.as_tensor(high)

    def forward(self, u):
        low, high = self.low.to(u), self.high.to(u)
        return low + (high - low) * torch.sigmoid(u)

    def inverse(self, v):
        low, high = self.low.to(v), self.high.to(v)
        z = torch.clamp((v - low) / (high - low), 0.0, 1.0)
        return torch.log(z) - torch.log1p(-z)


def get_bijector(func=None, low=None, high=None, shift=None, **kwargs):
    """Construct a bijector from config-style keyword arguments.

    low+high -> Sigmoid; shift (or nothing) -> Softplus; 'exp' -> Exp.
    """
    if func is None:
        func = "sigmoid" if (low is not None and high is not None) else "softplus"
    if isinstance(func, Bijector):
        return func
    func = func.lower()
    if func == "softplus":
        return Softplus(shift=0.0 if shift is None else shift)
    if func == "sigmoid":
        return Sigmoid(low=0.0 if low is None else low,
                       high=1.0 if high is None else high)
    if func == "exp":
        return Exp()
    if func in ("identity", "none"):
        return Identity()
    raise NotImplementedError(f"bijector func: {func} is not implemented")
