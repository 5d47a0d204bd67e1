"""Cache SMAP/SMOS thin-ice files for a date range + availability report.

The port's counterpart of examples/smap_availability.py: a CLI over
gpsat_tpu_torch.satdata.cache_smap_date_range — the reference ships this
as a standalone script (reference: IS2_SM_GP/cache_smap_data.py: download
per-day Bremen mix product, skip cached days, write a CSV of
date/success/cached/missing). Without network access, missing days are
reported rather than downloaded unless a pre-seeded cache holds them.

Run: python -m gpsat_tpu_torch.examples.smap_availability --start 2019-01-01 \
        --end 2019-01-31 --cache-dir ~/.cache/smap_data [--csv avail.csv]
"""

import argparse
import os

from gpsat_tpu_torch.satdata import cache_smap_date_range
from gpsat_tpu_torch.utils import cprint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", required=True, help="YYYY-MM-DD")
    ap.add_argument("--end", required=True, help="YYYY-MM-DD")
    ap.add_argument("--cache-dir", default=os.path.join(
        os.path.expanduser("~"), ".cache", "smap_data"))
    ap.add_argument("--csv", default=None, help="availability report path")
    args = ap.parse_args(argv)

    report = cache_smap_date_range(args.start, args.end, args.cache_dir,
                                   report_csv=args.csv, verbose=True)
    n = len(report)
    cprint(f"{n} days: {int(report['cached'].sum())} cached, "
           f"{int((report['success'] & ~report['cached']).sum())} downloaded, "
           f"{int(report['missing'].sum())} missing"
           + (f" -> {args.csv}" if args.csv else ""), "OKGREEN")
    return report


if __name__ == "__main__":
    main()
