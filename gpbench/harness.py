"""What every traffic mode drives and records: the program under test
(`Program`), a run's shared state (`Context`), one day or pass as the metric
readers take it (`unit_record`), and the helpers around them."""

import time

import numpy as np
import torch

from gpbench.generator import KM, level_of
from gpbench.reference.fit import NAMES

PRED_KEYS = ("f*", "f*_var", "y_var")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: the engine of the configuration's model on
    `device`, in the configuration's dtype, and its entry points.
    `execute`: the traffic mix's further arguments of every execute_buckets
    call (its "execute" block, JSON values as they are; "mesh": n devices
    becomes the program's mesh over the first n cards)."""

    def __init__(self, cfg, device, execute=None, coords_dim=3):
        from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
        from gpsat_tpu_torch.models import get_model
        from gpsat_tpu_torch.postprocessing import smooth_field
        self.execute_buckets, self.smooth_field = execute_buckets, smooth_field
        m = cfg["model"]
        init = dict(m["init_params"], dtype=cfg["dtype"])
        self.coords_scale = m["init_params"]["coords_scale"]
        self.engine = make_engine(get_model(m["oi_model"]), init,
                                  m.get("constraints"), coords_dim=coords_dim,
                                  device=device)
        self.device = device
        self.execute = dict(execute or {})
        if "mesh" in self.execute:
            from gpsat_tpu_torch.parallel.mesh import get_mesh
            self.execute["mesh"] = get_mesh(int(self.execute["mesh"]))

    def day(self, inp, **kw):
        return self.execute_buckets(
            self.engine, inp["X_list"], inp["obs_list"], inp["pred_list"],
            coords_scale=self.coords_scale, **self.execute, **kw)

    def smooth(self, cfg, experts, params):
        """Every hyperparameter field smoothed over the experts' (x, y) as
        smooth_hyperparameters does it: one smooth_field a component."""
        sm = cfg["smoothing"]
        out = {}
        for name in NAMES:
            v = np.asarray(params[name], float)
            cols = v.reshape(len(experts), -1)
            res = np.empty_like(cols)
            for j in range(cols.shape[1]):
                res[:, j] = self.smooth_field(
                    experts[:, 0], experts[:, 1], cols[:, j],
                    sm["l_x_km"] * KM, sm["l_y_km"] * KM,
                    max=sm["max"].get(name), device=self.device)
            out[name] = res.reshape(v.shape)
        return out


class Context:
    """One run's shared state, handed to the traffic mode: the
    configuration, the traffic mix, its limits, the model's module
    (gpbench/models), the device; then the target days' inputs and the
    program; `state` for what the mode keeps between its set-up, units and
    check, and `parts` the set-up's seconds by part (`mark`)."""

    def __init__(self, spec, device, t_start):
        self.model = spec["model"]
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.checks = spec["checks"]
        self.device = device
        self.days = self.prog = None
        self.state, self.parts = {}, {}
        self._t = t_start

    def mark(self, name):
        """Record the set-up's seconds since the last mark under `name`."""
        now = time.perf_counter()
        self.parts[name] = now - self._t
        self._t = now


def warm_subset(inputs, per_level):
    """A few experts of every level of the given days, as one input set."""
    sub = {"X_list": [], "obs_list": [], "pred_list": []}
    seen = {}
    for inp in inputs:
        for e, o in enumerate(inp["obs_list"]):
            lv = level_of(len(o))
            if seen.get(lv, 0) < per_level:
                seen[lv] = seen.get(lv, 0) + 1
                for k in sub:
                    sub[k].append(inp[k][e])
    return sub


def level_clock():
    """(on_bucket callback, list of host times at each level's end)."""
    marks = []

    def on_bucket(ids, result, f_bar, per_expert_time, marks=marks):
        marks.append(time.perf_counter())
    return on_bucket, marks


def timed(ctx, inp, kind, **kw):
    """One execute_buckets call on `inp`, ending in a synchronise: (the
    unit record of `kind`, the program's result). In a "day" a failure also
    counts an unconverged expert."""
    cb, marks = level_clock()
    t0 = time.perf_counter()
    out = ctx.prog.day(inp, on_bucket=cb, **kw)
    sync(ctx.device)
    return unit_record(kind, inp, out, t0, time.perf_counter(), marks), out


def unit_record(kind, inp, out, t0, t1, levels_t):
    """One day or pass of the window, as the metric readers take it."""
    n = np.array([len(o) for o in inp["obs_list"]])
    p = np.asarray(out["n_pred"])
    nonfinite = nonfinite_experts(out)
    failed = nonfinite | (~np.asarray(out["converged"], bool)
                          if kind == "day" else False)
    return {"kind": kind, "t0": t0, "t1": t1, "seconds": t1 - t0,
            "experts": len(n), "points": int(p.sum()), "n": n, "p": p,
            "iterations": np.asarray(out["iterations"]),
            "buckets": out["buckets"], "levels_t": levels_t,
            "failed": int(failed.sum()), "nonfinite": int(nonfinite.sum())}


def nonfinite_experts(out):
    """[E] experts with a non-finite objective, hyperparameter or
    prediction."""
    bad = ~np.isfinite(out["objective"])
    for name in NAMES:
        v = np.asarray(out["params"][name], float).reshape(len(bad), -1)
        bad |= ~np.isfinite(v).all(1)
    P = np.asarray(out["n_pred"])
    valid = np.arange(out["preds"]["f*"].shape[1])[None, :] < P[:, None]
    for k in PRED_KEYS:
        bad |= ~np.where(valid, np.isfinite(out["preds"][k]), True).all(1)
    return bad
