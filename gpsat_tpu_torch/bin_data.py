"""Config-driven binning CLI: `python -m gpsat_tpu_torch.bin_data <config.json>`
(copy of gpsat_tpu/bin_data.py; reference: GPSat/bin_data.py; CLI documented
in reference README.md:41-63). Host only: pandas and h5py are imported when
data is loaded, binned and written.

Config sections:
  input    : DataLoader.load kwargs (source, table, where, col_funcs, ...)
  bin_config : DataPrep.bin_data_by kwargs (by_cols, val_col, grid_res, ...)
  output   : {file, table} results-store destination
  comment  : free text stored with the table
"""

from gpsat_tpu_torch.utils import (cprint, get_config_from_sysargv,
                                   get_run_info, json_serializable,
                                   stats_on_vals)

__all__ = ["BinData", "bin_wrapper", "get_bin_data_config", "main"]


def bin_wrapper(df, col_funcs=None, print_stats=True, **bin_config):
    """Apply optional column functions, optional stats print, then bin
    (reference: GPSat/bin_data.py:87)."""
    from gpsat_tpu_torch.dataloader import DataLoader
    from gpsat_tpu_torch.dataprepper import DataPrep
    DataLoader.add_cols(df, col_func_dict=col_funcs)
    val_col = bin_config.get("val_col")
    if print_stats and val_col in df:
        print(stats_on_vals(df[val_col].values, name=val_col))
    ds = DataPrep.bin_data_by(df=df, **bin_config)
    stats = stats_on_vals(df[val_col].values, name=val_col) if val_col in df else None
    return ds, stats


class BinData:
    """Binning pipeline (reference: GPSat/bin_data.py:574)."""

    def __init__(self, input=None, bin_config=None, output=None, comment=None,
                 add_output_cols=None):
        self.input = input or {}
        self.bin_config = bin_config or {}
        self.output = output or {}
        self.comment = comment
        self.add_output_cols = add_output_cols

    def bin_data_all_at_once(self):
        """Load everything then bin (reference: bin_data.py:181)."""
        from gpsat_tpu_torch.dataloader import DataLoader
        df = DataLoader.load(**self.input)
        ds, stats = bin_wrapper(df, **self.bin_config)
        out = ds.to_dataframe().dropna().reset_index()
        return out, stats

    def bin_data_by_batch(self, load_by):
        """Chunked binning over unique values of `load_by` columns
        (reference: bin_data.py:280).

        Out-of-core: the unique-value probe reads ONLY the `load_by`
        columns (plus the base where filter), pushed down to the store's
        column-subset reader — the full table is never materialised in this
        process (the reference iterates the HDF store in chunks for the
        same reason, bin_data.py:418-440). Each chunk then loads with an
        equality `where` on the load_by values, which the store also pushes
        down to a windowed read.
        """
        import pandas as pd
        from gpsat_tpu_torch.dataloader import DataLoader
        load_by = [load_by] if isinstance(load_by, str) else list(load_by)
        base_where = self.input.get("where", None) or []
        src_kwargs = {k: v for k, v in self.input.items() if k != "where"}
        # col_funcs / col_select apply to the per-chunk loads, not the probe
        # (load_by columns must be physical: the per-chunk where-pushdown
        # filters on them before any derived column exists — same contract
        # as the reference's `load_by in by_cols` requirement)
        probe_kwargs = {k: v for k, v in self.input.items()
                        if k not in ("col_funcs", "col_select", "row_select",
                                     "add_data_to_col")}
        probe = DataLoader.load(columns=load_by, **probe_kwargs)
        uniques = probe[load_by].drop_duplicates()
        out = []
        for _, row in uniques.iterrows():
            where = list(base_where) + [
                {"col": c, "comp": "==", "val": row[c]} for c in load_by]
            df = DataLoader.load(where=where, **src_kwargs)
            if len(df) == 0:
                continue
            ds, _ = bin_wrapper(df, print_stats=False, **self.bin_config)
            out.append(ds.to_dataframe().dropna().reset_index())
        return pd.concat(out, axis=0).reset_index(drop=True), None

    def bin_data(self, batch=False, load_by=None):
        """Run the configured binning; returns the binned DataFrame
        (reference: bin_data.py:574)."""
        if batch:
            assert load_by is not None, "batch=True requires load_by"
            binned, stats = self.bin_data_by_batch(load_by)
        else:
            binned, stats = self.bin_data_all_at_once()
        if self.add_output_cols:
            from gpsat_tpu_torch.dataloader import DataLoader
            DataLoader.add_cols(binned, col_func_dict=self.add_output_cols)
        return binned, stats

    def write_dataframe_to_table(self, df, file=None, table=None):
        """(reference: bin_data.py:701)"""
        import pandas as pd
        from gpsat_tpu_torch.dataloader import DataLoader
        file = file or self.output.get("file")
        table = table or self.output.get("table", "data")
        assert file is not None, "output file must be provided"
        config = json_serializable({"input": {k: v for k, v in self.input.items()
                                              if not isinstance(v, pd.DataFrame)},
                                    "bin_config": self.bin_config,
                                    "comment": self.comment})
        DataLoader.write_to_hdf(df, file, table=table, config=config,
                                run_info=get_run_info())
        cprint(f"binned data written to {file}:{table}", "OKGREEN")


def get_bin_data_config():
    """(reference: bin_data.py:853)"""
    return get_config_from_sysargv()


def main():
    config = get_bin_data_config()
    if config is None:
        print("usage: python -m gpsat_tpu_torch.bin_data <config.json>")
        return
    batch = config.pop("batch", False)
    load_by = config.pop("load_by", None)
    bd = BinData(**config)
    binned, _ = bd.bin_data(batch=batch, load_by=load_by)
    bd.write_dataframe_to_table(binned)


if __name__ == "__main__":
    main()
