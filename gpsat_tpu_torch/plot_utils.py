"""Plotting helpers (copy of gpsat_tpu/plot_utils.py; reference:
GPSat/plot_utils.py:38-756).

cartopy is not a dependency of this stack; polar "projection" plots are drawn
by projecting lon/lat through the in-house LAEA transform
(gpsat_tpu_torch.utils.WGS84toEASE2) onto a plain matplotlib axes — visually
equivalent for the polar maps the reference produces. matplotlib is imported
inside the functions that make figures.
"""

import numpy as np

from gpsat_tpu_torch.utils import (WGS84toEASE2, EASE2toWGS84,
                                   WGS84toPolarStereo, stats_on_vals)

__all__ = ["get_projection", "plot_pcolormesh", "plot_hist", "plot_wrapper",
           "plot_pcolormesh_from_results_data", "plot_hyper_parameters",
           "plots_from_config", "plot_minimal_example"]


def get_projection(projection=None):
    """Projection descriptor: 'north'/'south' -> polar STEREOGRAPHIC
    parameters, matching the reference's cartopy NorthPolarStereo/
    SouthPolarStereo defaults (reference: plot_utils.py:181); 'north_laea'/
    'south_laea' select the EASE2-style LAEA used by the data grids."""
    if projection is None or projection == "north":
        return {"lat_0": 90, "lon_0": 0, "name": "north_polar_stereo"}
    if projection == "south":
        return {"lat_0": -90, "lon_0": 0, "name": "south_polar_stereo"}
    if projection == "north_laea":
        return {"lat_0": 90, "lon_0": 0, "name": "north_polar_laea"}
    if projection == "south_laea":
        return {"lat_0": -90, "lon_0": 0, "name": "south_polar_laea"}
    if isinstance(projection, dict):
        return projection
    raise ValueError(f"projection: {projection} not recognised")


def _project(lon, lat, projection=None):
    proj = get_projection(projection)
    if "stereo" in proj.get("name", ""):
        return WGS84toPolarStereo(np.asarray(lon), np.asarray(lat),
                                  lat_0=proj["lat_0"], lon_0=proj["lon_0"],
                                  lat_ts=proj.get("lat_ts"))
    return WGS84toEASE2(np.asarray(lon), np.asarray(lat),
                        lat_0=proj["lat_0"], lon_0=proj["lon_0"])


def plot_pcolormesh(ax, lon, lat, plot_data, fig=None, title=None,
                    vmin=None, vmax=None, cmap="YlGnBu_r", cbar_label=None,
                    scatter=False, extent=None, projection=None, s=4,
                    **scatter_args):
    """Colour map / scatter of values at lon/lat positions, polar-projected
    (reference: plot_utils.py:38)."""
    x, y = _project(lon, lat, projection)
    data = np.asarray(plot_data)
    if scatter:
        sc = ax.scatter(x, y, c=data, cmap=cmap, vmin=vmin, vmax=vmax, s=s,
                        **scatter_args)
    else:
        sc = ax.tripcolor(np.asarray(x).ravel(), np.asarray(y).ravel(),
                          data.ravel(), cmap=cmap, vmin=vmin, vmax=vmax)
    if extent is not None and len(extent) == 4:
        # extent = [lon_min, lon_max, lat_min, lat_max]: clip by latitude ring
        proj = get_projection(projection)
        ring_lat = extent[2] if proj["lat_0"] > 0 else extent[3]
        rx, ry = _project(np.linspace(-180, 180, 181),
                          np.full(181, ring_lat), projection)
        r = np.hypot(rx, ry).max()
        ax.set_xlim(-r, r)
        ax.set_ylim(-r, r)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    if title:
        ax.set_title(title)
    if fig is not None:
        cbar = fig.colorbar(sc, ax=ax, fraction=0.046, pad=0.04)
        if cbar_label:
            cbar.set_label(cbar_label)
    return sc


def plot_hist(ax, data, title="Histogram / Density", ylabel=None, xlabel=None,
              stats_values=None, select_bool=None, stats_loc=(0.2, 0.8),
              drop_nan_inf=True, bins=100, **hist_kwargs):
    """Histogram with optional stats annotation (reference: plot_utils.py:117)."""
    vals = np.asarray(data).ravel()
    if select_bool is not None:
        vals = vals[select_bool]
    if drop_nan_inf:
        vals = vals[np.isfinite(vals)]
    ax.hist(vals, bins=bins, density=True, **hist_kwargs)
    if stats_values:
        sdf = stats_on_vals(vals, name="data")
        txt = "\n".join(f"{k}: {sdf.loc[k].iloc[0]:.3g}"
                        for k in stats_values if k in sdf.index)
        ax.text(*stats_loc, txt, transform=ax.transAxes, fontsize=8,
                verticalalignment="top")
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    return ax


def plot_wrapper(plt_df, val_col, lon_col="lon", lat_col="lat", max_obs=None,
                 vmin_max=None, projection="north", extent=None,
                 s=0.5, q_vminmax=None, figsize=(15, 7)):
    """Side-by-side observation map + histogram (reference: plot_utils.py:608).

    Returns (fig, stats_df)."""
    import matplotlib.pyplot as plt
    df = plt_df
    if max_obs is not None and len(df) > max_obs:
        df = df.sample(n=max_obs, random_state=0)
    vals = df[val_col].values
    stats_df = stats_on_vals(vals, name=val_col)
    if vmin_max is not None:
        vmin, vmax = vmin_max
    elif q_vminmax is not None:
        vmin, vmax = np.nanquantile(vals, q_vminmax)
    else:
        vmin = vmax = None

    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=figsize)
    plot_pcolormesh(ax0, df[lon_col], df[lat_col], vals, fig=fig,
                    title=f"{val_col} observations", vmin=vmin, vmax=vmax,
                    scatter=True, s=s, extent=extent, projection=projection)
    plot_hist(ax1, vals, title=f"{val_col} histogram")
    return fig, stats_df


def plot_pcolormesh_from_results_data(ax, dfs, table, val_col, x_col="x",
                                      y_col="y", fig=None, lat_0=90, lon_0=0,
                                      **kwargs):
    """Map a results-table column by projecting its x/y coords back to lon/lat
    (reference: plot_utils.py)."""
    df = dfs[table]
    lon, lat = EASE2toWGS84(df[x_col].values, df[y_col].values,
                            lat_0=lat_0, lon_0=lon_0)
    return plot_pcolormesh(ax, lon, lat, df[val_col].values, fig=fig,
                           scatter=True, title=f"{table}:{val_col}", **kwargs)


def plot_hyper_parameters(dfs, coords_col, table_names, table_suffix="",
                          row_select=None, plot_template=None,
                          plots_per_row=3, suptitle=None, qvmin=0.01,
                          qvmax=0.99, figsize=(16, 5)):
    """Panel of hyperparameter maps, one subplot per parameter component
    (reference: plot_utils.py:501)."""
    import matplotlib.pyplot as plt
    plot_template = plot_template or {}
    lat_0 = plot_template.get("lat_0", 90)
    lon_0 = plot_template.get("lon_0", 0)
    panels = []
    for t in table_names:
        tbl = f"{t}{table_suffix}"
        if tbl not in dfs:
            continue
        df = dfs[tbl]
        if row_select is not None:
            from gpsat_tpu_torch.dataloader import DataLoader
            df = df.loc[DataLoader.row_select_bool(df, row_select)]
        dim_cols = [c for c in df.columns if c.startswith("_dim_")]
        if dim_cols and df[dim_cols[0]].nunique() > 1:
            for dv in sorted(df[dim_cols[0]].unique()):
                panels.append((f"{t}[{dv}]", df.loc[df[dim_cols[0]] == dv], t))
        else:
            panels.append((t, df, t))

    n = len(panels)
    if n == 0:
        return None
    nrows = -(-n // plots_per_row)
    fig, axes = plt.subplots(nrows, plots_per_row,
                             figsize=(figsize[0], figsize[1] * nrows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes[n:]:
        ax.axis("off")
    for ax, (title, df, val_col) in zip(axes, panels):
        lon, lat = EASE2toWGS84(df["x"].values, df["y"].values,
                                lat_0=lat_0, lon_0=lon_0)
        vals = df[val_col].values
        vmin, vmax = np.nanquantile(vals, [qvmin, qvmax])
        plot_pcolormesh(ax, lon, lat, vals, fig=fig, title=title, vmin=vmin,
                        vmax=vmax, scatter=True,
                        projection=plot_template.get("subplot_kwargs",
                                                     {}).get("projection"))
    if suptitle:
        fig.suptitle(suptitle)
    return fig


def plots_from_config(plot_configs, dfs, plots_per_row=3, suptitle=None):
    """Config-driven plot grid (reference: plot_utils.py:457)."""
    import matplotlib.pyplot as plt
    n = len(plot_configs)
    nrows = -(-n // plots_per_row)
    fig, axes = plt.subplots(nrows, plots_per_row, figsize=(16, 5 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes[n:]:
        ax.axis("off")
    for ax, cfg in zip(axes, plot_configs):
        cfg = dict(cfg)
        ptype = cfg.pop("plot_type", "heatmap")
        table = cfg.pop("table", None)
        df = dfs[table] if table else cfg.pop("df")
        val_col = cfg.pop("val_col")
        if ptype == "hist":
            plot_hist(ax, df[val_col].values, title=cfg.get("title", val_col))
        else:
            lat_0 = cfg.pop("lat_0", 90)
            lon_0 = cfg.pop("lon_0", 0)
            if "lon_col" in cfg and cfg["lon_col"] in df:
                lon, lat = df[cfg.pop("lon_col")], df[cfg.pop("lat_col")]
            else:
                lon, lat = EASE2toWGS84(df[cfg.pop("x_col", "x")].values,
                                        df[cfg.pop("y_col", "y")].values,
                                        lat_0=lat_0, lon_0=lon_0)
            plot_pcolormesh(ax, lon, lat, df[val_col].values, fig=fig,
                            title=cfg.get("title", val_col), scatter=True)
    if suptitle:
        fig.suptitle(suptitle)
    return fig


def plot_minimal_example(model_class, model_init=None, opt_params=None,
                         pred_params=None, seed=0, show=False):
    """1-d GP fit + posterior band — the reference's minimal-example harness
    (reference: plot_utils.py:346 plot_gpflow_minimal_example)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (25, 1))
    Y = np.sin(6 * X[:, 0]) + 0.2 * rng.standard_normal(25)
    m = model_class(coords=X, obs=Y[:, None], **(model_init or {}))
    m.optimise_parameters(**(opt_params or {}))
    Xs = np.linspace(-0.2, 1.2, 100)[:, None]
    out = m.predict(Xs, **(pred_params or {}))
    if show:  # pragma: no cover
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        ax.plot(Xs[:, 0], out["f*"], "C0")
        sd = np.sqrt(out["f*_var"])
        ax.fill_between(Xs[:, 0], out["f*"] - 2 * sd, out["f*"] + 2 * sd,
                        alpha=0.3)
        ax.scatter(X[:, 0], Y, c="k", s=10)
        plt.show()
    return {"X": X, "Y": Y, "Xs": Xs, "pred": out,
            "params": m.get_parameters(),
            "objective": m.get_objective_function_value()}
