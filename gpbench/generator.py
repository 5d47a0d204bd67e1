"""The traffic generator: synthetic along-track observations of a smooth
sea-ice field, binned to a grid a day, and each expert's local data for a
target day.

Frozen copy of the phase 6 generator of ``chip_smoke.py`` (``truth_field``,
``arctic_tracks``, ``arctic_observations``, ``arctic_select``,
``arctic_inputs``), with every size read from a configuration's
``deployment`` block instead of module constants, and the chords' layout
fixed by the deployment (`tracks`): the seed changes the data and the
experts' order, not the set of sizes. The program under test
receives only the arrays this module makes.
"""

import numpy as np

KM = 1000.0


def truth_field(x, y):
    """The noise-free field (examples/generate_example_data.py's formula)."""
    return (0.15 * np.sin(x / (300 * KM)) + 0.1 * np.cos(y / (400 * KM))
            + 0.08 * np.sin((x + 0.5 * y) / (500 * KM)) + 0.15)


def tracks(seed, dep):
    """Along-track chords, one day each, noise on the field: the (x, y, t, z)
    of every along-track point before binning. The chords and their days
    come from the deployment's fixed `layout_seed`, so that every seed gets
    the same sizes: the seed picks one of the eight symmetries of the square
    domain, which map the bins, the expert grid and each expert's prediction
    grid onto themselves (an expert's sizes go to another expert), and draws
    the noise."""
    rng = np.random.default_rng(dep["layout_seed"])
    dom = dep["domain_km"] * KM
    s = np.linspace(-dom, dom, int(2 * dom / (dep["track_spacing_km"] * KM)))
    xs, ys, ts = [], [], []
    for _ in range(dep["n_tracks"]):
        theta = rng.uniform(0, 2 * np.pi)
        offset = rng.uniform(-dom * 0.7, dom * 0.7)
        x = s * np.cos(theta) - offset * np.sin(theta)
        y = s * np.sin(theta) + offset * np.cos(theta)
        keep = (np.abs(x) < dom) & (np.abs(y) < dom)
        xs.append(x[keep])
        ys.append(y[keep])
        ts.append(np.full(int(keep.sum()), rng.integers(0, dep["days"])))
    x, y, t = (np.concatenate(a) for a in (xs, ys, ts))
    rng = np.random.default_rng(seed)
    k = int(rng.integers(8))
    x, y = (-x if k & 1 else x), (-y if k & 2 else y)
    if k & 4:
        x, y = y, x
    z = truth_field(x, y) + dep["noise"] * rng.standard_normal(len(x))
    return x, y, t, z


def observations(seed, dep):
    """The track points binned to a grid per day: (x, y, t) [n, 3] and z [n]
    of the non-empty cells, sorted by day."""
    x, y, t, z = tracks(seed, dep)
    dom = dep["domain_km"] * KM
    g = dep["bin_km"] * KM
    ng = int(round(2 * dom / g))
    ix = np.clip(np.floor((x + dom) / g).astype(int), 0, ng - 1)
    iy = np.clip(np.floor((y + dom) / g).astype(int), 0, ng - 1)
    cell, inv, cnt = np.unique((t * ng + iy) * ng + ix, return_inverse=True,
                               return_counts=True)
    zb = np.bincount(inv, weights=z) / cnt
    xb = -dom + (cell % ng + 0.5) * g
    yb = -dom + ((cell // ng) % ng + 0.5) * g
    return np.stack([xb, yb, (cell // (ng * ng)).astype(float)], 1), zb


def select(obs_xyt, obs_z, expert_xy, t_expert, radius, day_window):
    """Per-expert rows of the local data: days within +-day_window of the
    expert and a euclidean radius in (x, y), by cKDTree.query_ball_point
    (DataLoader.local_data_select's semantics: rows in the frame's order).
    Returns X_list, obs_list."""
    from scipy.spatial import cKDTree
    days = obs_xyt[:, 2]
    hits = [[] for _ in range(len(expert_xy))]
    for d in range(int(t_expert) - day_window, int(t_expert) + day_window + 1):
        rows = np.flatnonzero(days == d)
        if len(rows) == 0:
            continue
        found = cKDTree(obs_xyt[rows, :2]).query_ball_point(expert_xy,
                                                            r=radius)
        for i, f in enumerate(found):
            hits[i].append(rows[np.asarray(f, dtype=int)])
    idx = [np.sort(np.concatenate(h)) if h else np.zeros(0, int)
           for h in hits]
    return [obs_xyt[i] for i in idx], [obs_z[i] for i in idx]


def expert_xy(dep):
    """[E, 2] expert locations: every expert_stride-th point of a square grid
    of expert_step_km over +-expert_half_km, in each direction."""
    half, step = dep["expert_half_km"] * KM, dep["expert_step_km"] * KM
    e = np.arange(-half, half + step / 2, step)[::dep.get("expert_stride", 1)]
    ex, ey = (a.ravel() for a in np.meshgrid(e, e, indexing="ij"))
    return np.stack([ex, ey], 1)


def pred_offsets(dep):
    """[P, 3] prediction offsets about an expert: a pred_step_km grid within
    pred_radius_km (max_dist's strict <), at the expert's day."""
    step, radius = dep["pred_step_km"] * KM, dep["pred_radius_km"] * KM
    k = int(radius // step)
    o = np.arange(-k, k + 1) * step
    ox, oy = (a.ravel() for a in np.meshgrid(o, o, indexing="ij"))
    near = ox ** 2 + oy ** 2 < radius ** 2
    return np.stack([ox[near], oy[near], np.zeros(int(near.sum()))], 1)


def day_inputs(obs, dep, day):
    """execute_buckets' per-expert inputs for one target day: X_list,
    obs_list, pred_list (raw units) and the experts' (x, y, t)."""
    obs_xyt, obs_z = obs
    xy = expert_xy(dep)
    experts = np.concatenate([xy, np.full((len(xy), 1), float(day))], 1)
    X_list, obs_list = select(obs_xyt, obs_z, xy, day,
                              dep["train_radius_km"] * KM, dep["day_window"])
    offsets = pred_offsets(dep)
    return {"X_list": X_list, "obs_list": obs_list,
            "pred_list": [xe + offsets for xe in experts],
            "experts": experts}


def level_of(n, levels=(8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                        8192, 16384, 32768, 65536, 131072)):
    """The padded level of n points: the smallest level >= n (the program's
    bucketing rule, parallel/scheduler.bucket_level)."""
    for lv in levels:
        if n <= lv:
            return lv
    return int(n)


def level_mix(inp):
    """{level N: experts} of one day's inputs."""
    out = {}
    for o in inp["obs_list"]:
        lv = level_of(len(o))
        out[lv] = out.get(lv, 0) + 1
    return dict(sorted(out.items()))
