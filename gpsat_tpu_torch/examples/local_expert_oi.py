"""Config-driven OI CLI (the port's counterpart of examples/local_expert_oi.py):

    python -m gpsat_tpu_torch.examples.local_expert_oi <config.json> [--device D]

Runs on the card unless --device names another; falls back to
configs/example_local_expert_oi.json. Accepts a single config dict or a list
of configs (e.g. the follow-up file written by smooth_hyperparameters). A
wrapper over gpsat_tpu_torch.local_expert_oi."""
from gpsat_tpu_torch.local_expert_oi import main

if __name__ == "__main__":
    main()
