"""The control of a cell's `correct`: the plain reference in the program's
place, computed in the precision below the configuration's (float32 with
TF32 matmuls for the float32 model; float32 for the float64 smoother), on
the experts a run samples, at the cell's own sizes, on several seeds; or,
with --fault, the program with a fault planted underneath.

    python3 -m gpbench.control --workload <cell> --seeds <n>[,<n>...] \\
        [--fault unchanged]

Prints one JSON object a seed: {"seed", "control": {number: reading}}. The
readings come from the traffic's mode (gpbench/modes/<mode>.py: `control`,
`fault`). The benchmark's own runs never run it.
"""

import argparse
import json
import sys

import torch

from gpbench import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=("unchanged",), default=None,
                    help="read the program with this fault planted instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = run.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        dev = torch.device("cuda", 0)
        if args.fault:
            out = {"fault": args.fault,
                   "numbers": spec["mode"].fault(spec, seed, dev)}
        else:
            out = {"control": spec["mode"].control(spec, seed, dev)}
        print(json.dumps(dict(workload=args.workload, seed=seed, **out)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
