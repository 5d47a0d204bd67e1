"""Raw-file sweep CLI wrapper over gpsat_tpu_torch.read_and_store (the port's
counterpart of examples/read_and_store_raw_data.py)."""
from gpsat_tpu_torch.read_and_store import main

if __name__ == "__main__":
    main()
