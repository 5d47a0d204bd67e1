"""Sweep directories of raw flat files into one results-store table:
`python -m gpsat_tpu_torch.read_and_store <config.json>`
(copy of gpsat_tpu/read_and_store.py; reference: GPSat/read_and_store.py; CLI
documented in README.md:41-63). Host only: pandas and h5py are imported
when the files are read and stored.

Config:
  file_dirs / sub_dirs / file_regex : which files to read
  read_kwargs / col_funcs / row_select / col_select : per-file processing
  output: {file, table, append}
"""

import os
import re

from gpsat_tpu_torch.utils import (cprint, get_config_from_sysargv,
                                   get_run_info, json_serializable)

__all__ = ["get_dirs_to_search", "read_and_store", "main"]


def get_dirs_to_search(base_dirs, dir_regex=None):
    """Expand base dirs to subdirectories matching a regex
    (reference: read_and_store.py:29)."""
    base_dirs = [base_dirs] if isinstance(base_dirs, str) else list(base_dirs)
    out = []
    for bd in base_dirs:
        if not os.path.isdir(bd):
            continue
        if dir_regex is None:
            out.append(bd)
            continue
        for d in sorted(os.listdir(bd)):
            full = os.path.join(bd, d)
            if os.path.isdir(full) and re.search(dir_regex, d):
                out.append(full)
    return out


def read_and_store(file_dirs, file_regex, output, sub_dirs=None,
                   dir_regex=None, read_kwargs=None, col_funcs=None,
                   row_select=None, col_select=None, read_engine="csv",
                   verbose=True, **unused):
    """Read the matching files (DataLoader.read_from_multiple_files) and
    write them, with the config and run info as attributes, to
    output["file"]:output["table"] (reference: read_and_store.py:60)."""
    from gpsat_tpu_torch.dataloader import DataLoader
    dirs = get_dirs_to_search(file_dirs, dir_regex=dir_regex)
    df = DataLoader.read_from_multiple_files(
        file_dirs=dirs or file_dirs, file_regex=file_regex, sub_dirs=sub_dirs,
        read_engine=read_engine, col_funcs=col_funcs, row_select=row_select,
        col_select=col_select, read_kwargs=read_kwargs, verbose=verbose)
    cfg = json_serializable({"file_dirs": file_dirs, "file_regex": file_regex,
                             "row_select": row_select, "col_select": col_select})
    DataLoader.write_to_hdf(df, output["file"],
                            table=output.get("table", "data"),
                            append=output.get("append", False),
                            config=cfg, run_info=get_run_info())
    cprint(f"stored {len(df)} rows to {output['file']}:"
           f"{output.get('table', 'data')}", "OKGREEN")
    return df


def main():
    config = get_config_from_sysargv()
    if config is None:
        print("usage: python -m gpsat_tpu_torch.read_and_store <config.json>")
        return
    read_and_store(**config)


if __name__ == "__main__":
    main()
