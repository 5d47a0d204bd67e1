"""CLI: python -m gpsat_tpu_torch.native.build"""
from gpsat_tpu_torch.native import build

if __name__ == "__main__":
    print(build(verbose=True))
