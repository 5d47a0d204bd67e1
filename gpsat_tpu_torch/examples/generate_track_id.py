"""Add a per-satellite track id to stored observations (the port's
counterpart of examples/generate_track_id.py; reference: examples/generate_track_id.py, using utils.guess_track_num).

Usage: python -m gpsat_tpu_torch.examples.generate_track_id <config.json>
with {"input": DataLoader.load kwargs, "time_col": "datetime",
      "thresh_seconds": 60, "by": ["source"], "output": {file, table}}
"""

import numpy as np

from gpsat_tpu_torch.utils import cprint, get_config_from_sysargv, guess_track_num


def add_track_ids(df, time_col="datetime", thresh=60.0, by=None):
    df = df.sort_values(([*by] if by else []) + [time_col]).reset_index(drop=True)
    t = df[time_col].values
    if t.dtype.kind == "M":
        t = t.astype("datetime64[s]").astype(float)
    else:
        t = t.astype(float)
    if by:
        track = np.empty(len(df))
        start = 0
        for _, idx in df.groupby(list(by)).indices.items():
            idx = np.sort(idx)
            track[idx] = guess_track_num(t[idx], thresh, start_track=start)
            start = int(track[idx].max()) + 1
        df["track"] = track
    else:
        df["track"] = guess_track_num(t, thresh)
    return df


def main():
    config = get_config_from_sysargv()
    if config is None:
        print("usage: python -m gpsat_tpu_torch.examples.generate_track_id "
              "<config.json>")
        return
    from gpsat_tpu_torch.dataloader import DataLoader
    df = DataLoader.load(**config["input"])
    df = add_track_ids(df, time_col=config.get("time_col", "datetime"),
                       thresh=config.get("thresh_seconds", 60.0),
                       by=config.get("by"))
    out = config.get("output")
    if out:
        DataLoader.write_to_hdf(df, out["file"], table=out.get("table", "data"))
        cprint(f"wrote {len(df)} rows with track ids to {out['file']}", "OKGREEN")
    return df


if __name__ == "__main__":
    main()
