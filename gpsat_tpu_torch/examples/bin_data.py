"""Binning CLI wrapper over gpsat_tpu_torch.bin_data (the port's counterpart
of examples/bin_data.py)."""
from gpsat_tpu_torch.bin_data import main

if __name__ == "__main__":
    main()
