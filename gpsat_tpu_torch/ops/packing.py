"""Flat-vector packing of named parameter dicts for batched optimisers (torch
port of gpsat_tpu/ops/packing.py).

`pack` and `unpack` work on a trailing parameter axis, so the same spec packs
one expert ([P]) or a batch of experts ([B, P]).
"""

import numpy as np
import torch

__all__ = ["ParamSpec", "pack", "unpack"]


class ParamSpec:
    """Ordered (name, shape) list describing a flat parameter vector layout."""

    def __init__(self, entries):
        self.entries = [(name, tuple(shape)) for name, shape in entries]
        self.sizes = [int(np.prod(s)) if len(s) else 1 for _, s in self.entries]
        self.total = sum(self.sizes)
        self.offsets = np.cumsum([0] + self.sizes[:-1]).tolist()

    @property
    def names(self):
        return [n for n, _ in self.entries]

    def __repr__(self):
        return f"ParamSpec({self.entries})"


def pack(params, spec, batch_shape=()):
    """Dict of tensors -> flat [*batch_shape, total] vector in spec order."""
    parts = []
    for (name, shape), size in zip(spec.entries, spec.sizes):
        v = torch.as_tensor(params[name])
        parts.append(v.reshape(*batch_shape, size))
    if not parts:
        return torch.zeros(*batch_shape, 0)
    return torch.cat(parts, dim=-1)


def unpack(vec, spec):
    """Flat [..., total] vector -> dict of [..., *shape] tensors."""
    out = {}
    lead = vec.shape[:-1]
    for (name, shape), size, off in zip(spec.entries, spec.sizes, spec.offsets):
        v = vec[..., off:off + size]
        out[name] = v.reshape(*lead, *shape) if len(shape) else v[..., 0]
    return out
