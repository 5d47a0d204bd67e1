"""End-to-end CLI acceptance pipeline through the port: the seven steps of
the JAX package's run_examples.sh (reference: run_examples.sh), with nothing
of jax.

    python -m gpsat_tpu_torch.examples.run_examples [--device D]
        [--workdir DIR] [--n-tracks N]

generate data -> read_and_store -> plot obs -> bin -> OI -> postprocess ->
re-run OI with smoothed params -> plot results. The configs are the
repository's configs/example_*.json; their relative paths (data/example,
results/) resolve under --workdir (default: the repository root). OI and
smoothing run on the card unless --device names another. Every step must
succeed, the plots too: a failing step fails the run.
"""

import argparse
import os
import sys
from contextlib import contextmanager

from gpsat_tpu_torch import get_config_path, get_parent_path, resolve_device

STEPS = ("generate synthetic example data", "read_and_store raw files",
         "plot observations", "bin raw data", "local expert OI",
         "postprocess (smooth hyperparameters) + re-predict",
         "plot results")


@contextmanager
def _argv(*args):
    """sys.argv of a CLI that reads its config from argument 1."""
    saved = sys.argv
    sys.argv = [saved[0] if saved else "run_examples", *args]
    try:
        yield
    finally:
        sys.argv = saved


@contextmanager
def _cwd(path):
    saved = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(saved)


def main(argv=None, device=None):
    """Run the seven steps; returns the results store's path."""
    ap = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.examples.run_examples")
    ap.add_argument("--device", default=device,
                    help="torch device of OI and smoothing (default: cuda)")
    ap.add_argument("--workdir", default=get_parent_path(),
                    help="directory the configs' relative paths resolve in")
    ap.add_argument("--n-tracks", type=int, default=40,
                    help="tracks a satellite of the generated data")
    # called from code with device= and no argv: the defaults, not sys.argv
    args = ap.parse_args([] if argv is None and device is not None else argv)
    dev = str(resolve_device(args.device))

    from gpsat_tpu_torch import bin_data, local_expert_oi, read_and_store
    from gpsat_tpu_torch import postprocessing
    from gpsat_tpu_torch.examples import (generate_example_data,
                                          plot_from_results,
                                          plot_observations)

    def step(i):
        print(f"=== {i}/{len(STEPS)} {STEPS[i - 1]}", flush=True)

    os.makedirs(args.workdir, exist_ok=True)
    with _cwd(args.workdir):
        os.makedirs("results", exist_ok=True)
        step(1)
        generate_example_data.main(os.path.join("data", "example"),
                                   n_tracks=args.n_tracks)
        step(2)
        with _argv(get_config_path("example_read_and_store_raw_data.json")):
            read_and_store.main()
        step(3)
        with _argv(get_config_path("example_plot_observations.json")):
            plot_observations.main()
        step(4)
        with _argv(get_config_path("example_bin_raw_data.json")):
            bin_data.main()
        step(5)
        local_expert_oi.main([get_config_path("example_local_expert_oi.json"),
                              "--device", dev])
        step(6)
        follow_up = postprocessing.main(
            [get_config_path("example_postprocessing.json"), "--device", dev])
        local_expert_oi.main([follow_up, "--device", dev])
        step(7)
        with _argv(get_config_path("example_plot_from_results.json")):
            plot_from_results.main()
    print("ALL EXAMPLES COMPLETED")
    return os.path.join(args.workdir, "results", "example_oi.h5")


if __name__ == "__main__":
    main()
