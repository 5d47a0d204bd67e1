"""Config-driven OI CLI, the port's counterpart of examples/local_expert_oi.py:

    python -m gpsat_tpu_torch.local_expert_oi [config.json] [--device D]

Runs each config through ExperimentConfig.run on the card unless --device
names another (``--device cpu`` runs on the host in float64). The config is a
single dict or a list of them, e.g. the follow-up file that
gpsat_tpu_torch.postprocessing.smooth_hyperparameters writes; without one,
configs/example_local_expert_oi.json runs (reference:
examples/local_expert_oi.py:34-60).
"""

import argparse
import json

from gpsat_tpu_torch import get_parent_path
from gpsat_tpu_torch.config_dataclasses import ExperimentConfig
from gpsat_tpu_torch.utils import cprint, nested_dict_literal_eval

__all__ = ["main"]


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m gpsat_tpu_torch.local_expert_oi",
        description="run local-expert OI from a JSON config (or a list)")
    parser.add_argument("config", nargs="?", default=None,
                        help="JSON config, or a list of configs")
    parser.add_argument("--device", default=None,
                        help="torch device of the engine (default: cuda)")
    args = parser.parse_args(argv)
    if args.config is None:
        fallback = get_parent_path("configs", "example_local_expert_oi.json")
        cprint(f"no config provided, using example: {fallback}", "WARNING")
        cfg_list = [ExperimentConfig.from_json_file(fallback)]
    else:
        with open(args.config) as f:
            config = nested_dict_literal_eval(json.load(f))
        config = config if isinstance(config, list) else [config]
        cfg_list = [ExperimentConfig.from_dict(c) for c in config]
    for cfg in cfg_list:
        cfg.run(device=args.device)


if __name__ == "__main__":
    main()
