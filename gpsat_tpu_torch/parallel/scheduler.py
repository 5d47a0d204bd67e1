"""Expert bucketing: group ragged experts into fixed padded shapes (torch port
of gpsat_tpu/parallel/scheduler.py).

Per-expert data counts vary widely, so experts are grouped into buckets keyed
by padded (N_obs, N_pred) levels (powers of two), then batched.
"""

import numpy as np
import torch

__all__ = ["bucket_level", "make_buckets", "auto_batch_size"]

_LEVELS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
           32768, 65536, 131072]


def bucket_level(n, levels=None):
    """Smallest padded level >= n."""
    levels = _LEVELS if levels is None else levels
    for lv in levels:
        if n <= lv:
            return lv
    return int(n)


def _default_budget_elems(device=None):
    """Element budget for the dominant [B, N, N] temporaries.

    On a CUDA device: 1/512 of the card's memory in elements (one f32 buffer
    takes 1/128 of it; the optimiser holds about a dozen such buffers on the
    torch path and a [B, N, 2N] f32 workspace on the kernel path), read from
    torch.cuda.get_device_properties. On the host: 2**26 elements (~512 MB
    per f64 buffer).
    """
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return int(props.total_memory // 512)
    return 2**26


def auto_batch_size(n_max, p_max=0, budget_elems=None, dtype_bytes=8,
                    max_batch=4096, device=None):
    """Batch size bounded by ~budget_elems elements for the dominant
    [B, N, N] kernel matrix."""
    if budget_elems is None:
        budget_elems = _default_budget_elems(device)
    per_expert = max(n_max * n_max + 2 * n_max * max(p_max, 1), 1)
    b = max(1, int(budget_elems // per_expert))
    return int(min(b, max_batch))


def make_buckets(n_obs, n_pred, batch_size=None, multiple_of=1, levels=None,
                 device=None):
    """Group expert indices into batches of identical padded shape.

    Parameters
    ----------
    n_obs, n_pred : [E] int arrays of per-expert valid counts.
    batch_size : fixed batch size per bucket, or None for auto.
    multiple_of : pad batch sizes to a multiple (device count).

    Returns
    -------
    list of dicts: {indices: [b] expert ids, n_max, p_max, batch_pad}
    where batch_pad >= len(indices) is the padded batch dimension.
    """
    n_obs = np.asarray(n_obs)
    n_pred = np.asarray(n_pred)
    keys = {}
    for i in range(len(n_obs)):
        k = (bucket_level(int(n_obs[i]), levels),
             bucket_level(int(n_pred[i]), levels) if n_pred[i] > 0 else 0)
        keys.setdefault(k, []).append(i)

    out = []
    for (n_max, p_max), idxs in sorted(keys.items()):
        bs = batch_size or auto_batch_size(n_max, p_max, device=device)
        bs = max(1, bs - bs % multiple_of) if bs >= multiple_of else bs
        for s in range(0, len(idxs), bs):
            chunk = idxs[s:s + bs]
            pad = len(chunk)
            if multiple_of > 1:
                pad = int(-(-pad // multiple_of) * multiple_of)
            # pad to the chosen batch size when it is a full chunk, so every
            # bucket level sees one shape
            if len(idxs) > bs:
                pad = bs if len(chunk) == bs else pad
            out.append({"indices": np.asarray(chunk), "n_max": n_max,
                        "p_max": p_max, "batch_pad": pad})
    return out
