"""Multi-process execution: share-nothing expert partitioning (copy of
gpsat_tpu/parallel/multihost.py, with torch.distributed in the place of
jax.distributed).

The reference scales out via independent SLURM array jobs that share nothing
(reference: submit_gpsat.sh:1-33) and relies on the results store's resume
semantics for restart safety. Every process computes a deterministic strided
stripe of the expert grid (`partition_experts`) and writes to its own
rank-namespaced store (`rank_store_path`): no cross-process locking, HDF5
stays single-writer. `merge_result_stores` concatenates the per-rank stores
into the single results file the post-processing stack expects.
`init_distributed` starts a torch.distributed process group where one is
wanted, so that rank and world come from the group; the sweep itself has no
collective.

CLI:  python -m gpsat_tpu_torch.parallel.multihost merge OUT IN1 IN2 [...]
"""

import os

__all__ = ["init_distributed", "process_info", "partition_experts",
           "rank_store_path", "rank_store_paths", "merge_result_stores"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Start the torch.distributed process group of a multi-process run
    (gpsat_tpu/parallel/multihost.py:32, with init_process_group in the
    place of jax.distributed.initialize).

    Safe to call unconditionally: a no-op when a group is already
    initialised, or when no argument is given and the environment describes
    one process (process_info) with no MASTER_ADDR. `coordinator_address`
    "host:port" becomes init_method "tcp://host:port" (else torch's env://
    rendezvous, MASTER_ADDR and MASTER_PORT); `num_processes` and
    `process_id` default to process_info()'s world and rank. The backend is
    nccl when the process has a card and gloo otherwise; `local_device_ids`
    (an int or a sequence, the first taken) picks the process's card.
    """
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if num_processes is None and coordinator_address is None \
            and process_info()[1] == 1 and "MASTER_ADDR" not in os.environ:
        return
    rank, world = process_info()
    world = world if num_processes is None else int(num_processes)
    rank = rank if process_id is None else int(process_id)
    cuda = torch.cuda.is_available()
    if local_device_ids is not None and cuda:
        ids = local_device_ids if isinstance(local_device_ids, (list, tuple)) \
            else [local_device_ids]
        torch.cuda.set_device(int(ids[0]))
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=None if coordinator_address is None
        else f"tcp://{coordinator_address}",
        world_size=world, rank=rank)


def process_info():
    """(rank, world) for the current process.

    Order of precedence: an initialised `torch.distributed` process group;
    explicit GPSAT_PROCESS_ID / GPSAT_NUM_PROCESSES; SLURM_PROCID /
    SLURM_NTASKS (the reference's array-job environment); single-process
    default.
    """
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    for rk, wk in (("GPSAT_PROCESS_ID", "GPSAT_NUM_PROCESSES"),
                   ("SLURM_PROCID", "SLURM_NTASKS")):
        if wk in os.environ and int(os.environ[wk]) > 1:
            return int(os.environ.get(rk, 0)), int(os.environ[wk])
    return 0, 1


def partition_experts(df, rank, world):
    """Deterministic strided stripe of the expert-location DataFrame.

    Strided (rank::world) rather than contiguous blocks: expert cost
    correlates with spatial position (data density), and striding balances
    the stripes without needing cost estimates.
    """
    if world <= 1:
        return df
    return df.iloc[int(rank)::int(world)]


def rank_store_path(path, rank, world):
    """Per-rank store path: results.h5 -> results.r003of008.h5."""
    if world <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.r{int(rank):03d}of{int(world):03d}{ext}"


def rank_store_paths(path, world):
    return [rank_store_path(path, r, world) for r in range(world)]


def merge_result_stores(in_paths, out_path, verbose=False):
    """Concatenate per-rank result stores into one.

    Row tables (preds, run_details, expert_locs, hyperparameter tables, and
    their *_SMOOTHED variants) are appended in rank order with their
    multi-indexes preserved; `oi_config*` provenance tables are copied from
    the first store that has them (every rank stored the identical config —
    the rank path never enters the stored config).
    """
    from gpsat_tpu_torch.store import ResultsStore

    tables = []
    for p in in_paths:
        with ResultsStore(p, mode="r") as store:
            for t in store.keys():
                if t not in tables:
                    tables.append(t)

    with ResultsStore(out_path, mode="a") as out:
        for t in tables:
            if t.startswith("oi_config"):
                for p in in_paths:
                    with ResultsStore(p, mode="r") as store:
                        if store.has_table(t):
                            df = store.get(t)
                            out.put(t, df, attrs=store.attrs(t))
                            break
                continue
            for p in in_paths:
                with ResultsStore(p, mode="r") as store:
                    if not store.has_table(t):
                        continue
                    df = store.select(t)
                    out.append(t, df)
            if verbose:  # pragma: no cover
                print(f"merged table {t}: {out.nrows(t)} rows")
    return out_path


def _main(argv):  # pragma: no cover - thin CLI
    if len(argv) >= 4 and argv[1] == "merge":
        merge_result_stores(argv[3:], argv[2], verbose=True)
        print(f"merged {len(argv) - 3} stores -> {argv[2]}")
        return 0
    print(__doc__)
    return 1


if __name__ == "__main__":  # pragma: no cover
    import sys
    raise SystemExit(_main(sys.argv))
