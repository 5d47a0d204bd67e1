"""Device mesh and expert-axis sharding (torch port of
gpsat_tpu/parallel/mesh.py).

Every expert is independent, so a bucket batch [E, N, D] splits over a 1-d
"experts" mesh into contiguous blocks with no collective in the fit/predict
path. torch has no counterpart to jax.sharding.Mesh, and DeviceMesh/DTensor
bring collectives this path never uses: `Mesh` is a small value object (the
devices and the axis name), and `shard_experts` hands back one tree per
shard, each holding its block of the leading axis on its shard's device.

A device may appear more than once (``["cpu"] * 8``, ``["cuda:0"] * 2``):
the CPU mesh the tests use, and two shards of one card. Work of shard k runs
under ``mesh.scope(k)``: on a card, under its device and a CUDA stream of its
own, so that shards on one card overlap and the kernel wrappers (which launch
on the current stream of their tensors' device) follow the shard.
"""

from contextlib import contextmanager

import numpy as np
import torch

from gpsat_tpu_torch import resolve_device

__all__ = ["Mesh", "get_mesh", "shard_experts", "pad_to_multiple"]


class Mesh:
    """A 1-d mesh: `devices` (a tuple of torch.device), `size`,
    `axis_names`. Holds one CUDA stream per shard on a card, made on first
    use."""

    def __init__(self, devices, axis_name="experts"):
        devs = []
        for d in devices:
            d = resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)
        self.axis_names = (axis_name,)
        self._streams = {}

    @property
    def size(self):
        return len(self.devices)

    def stream(self, k):
        """Shard k's CUDA stream (None for a host shard)."""
        dev = self.devices[k]
        if dev.type != "cuda":
            return None
        if k not in self._streams:
            self._streams[k] = torch.cuda.Stream(device=dev)
        return self._streams[k]

    @contextmanager
    def scope(self, k):
        """Run the enclosed work as shard k: on a card, under its device and
        its stream, which first waits for the work already queued on the
        device's current stream (what the shard reads may come from there)."""
        stream = self.stream(k)
        if stream is None:
            yield
            return
        dev = self.devices[k]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            yield

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def get_mesh(n_devices=None, devices=None, axis_name="experts"):
    """1-d mesh over every visible CUDA device (the first `n_devices` of
    them if given), or over `devices`. Raises, as resolve_device does, when
    no card is present and no devices are given."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices, axis_name)


def pad_to_multiple(n, m):
    """Smallest multiple of m >= n."""
    return int(-(-n // m) * m)


def shard_experts(tree, mesh):
    """One tree per shard of `mesh`: every leaf with a leading (expert) axis
    split into `mesh.size` contiguous blocks (as PartitionSpec("experts")
    splits it), block k copied to shard k's device under its scope; 0-d
    tensors are copied whole, other leaves are passed as they are. Leaves
    are tensors or numpy arrays (numpy becomes a tensor of its dtype) inside
    tuples, lists, dicts and Bijectors."""
    from gpsat_tpu_torch.ops.lbfgs import _tree_map
    n = mesh.size

    def block(k):
        dev = mesh.devices[k]
        stream = mesh.stream(k)

        def put(a):
            if isinstance(a, np.ndarray):
                if a.ndim == 0:
                    return a
                a = torch.from_numpy(np.ascontiguousarray(a))
            if a.ndim == 0:
                part = a
            else:
                if a.shape[0] % n:
                    raise ValueError(f"leading axis {a.shape[0]} is not a "
                                     f"multiple of the mesh size {n}")
                b = a.shape[0] // n
                part = a[k * b:(k + 1) * b]
            if a.is_cuda and stream is not None and a.device == dev:
                # read on this shard's stream: keep the source's memory
                # until that read is done
                a.record_stream(stream)
            return part.to(dev, copy=True)

        with mesh.scope(k):
            return _tree_map(put, tree)

    return [block(k) for k in range(n)]
