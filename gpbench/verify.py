"""The comparison that decides `correct`: the program's answers against the
plain reference (gpbench/reference), on experts drawn from the seed out of
every level of the window's own days, and the control (the reference in
the precision below the configuration's) on the same experts.

Numbers, each the worst over the sampled experts:
  objective_gap  |program objective - reference objective| / n, the
                 objective at the program's own hyperparameters (NLML for
                 GPR, ELBO for SGPR), per observation;
  fit_gap        reference objective at the program's hyperparameters minus
                 the reference's after a float64 L-BFGS-B polish from there
                 (nats): how far the program stopped from a local optimum;
  fit_shortfall  fit_gap over the whole gain from the program's documented
                 start to that polished optimum: 0 at the optimum, 1 for a
                 fit that never left its start;
  f_err          |f* - reference f*| over the prediction points;
  var_err        |f*_var or y_var - reference| / reference y_var;
  smooth_err     (re-predict) |smoothed field - reference| / |reference|
                 over every expert of every field;
  nonfinite      experts of every day or pass of the window with a
                 non-finite objective, hyperparameter or prediction (counted
                 by gpbench/run.py; limit 0).
"""

import numpy as np
import torch

from gpbench.generator import KM, level_of
from gpbench.harness import PRED_KEYS
from gpbench.reference import fit as ref_fit
from gpbench.reference import gp


def sample_experts(n_obs, seed, per_level, salt):
    """Expert ids drawn from the seed: `per_level` from each padded level of
    the day, and the expert with the most observations."""
    rng = np.random.default_rng([int(seed), int(salt)])
    lv = np.array([level_of(int(n)) for n in n_obs])
    ids = {int(np.argmax(n_obs))}
    for level in np.unique(lv):
        members = np.flatnonzero(lv == level)
        k = min(per_level, len(members))
        ids.update(int(i) for i in rng.choice(members, k, replace=False))
    return sorted(ids)


class Expert:
    """One expert's inputs in the reference's units: X, Xs scaled by
    coords_scale, y the observations, Z the rows of X the model derives
    (its module's `extras`: SGPR's inducing points), or None."""

    def __init__(self, cfg, inp, e, z_rows=None):
        scale = np.asarray(cfg["model"]["init_params"]["coords_scale"],
                           float)
        self.X = np.asarray(inp["X_list"][e], float) / scale
        self.y = np.asarray(inp["obs_list"][e], float)
        self.Xs = np.asarray(inp["pred_list"][e], float) / scale
        self.Z = None if z_rows is None else self.X[z_rows[e]]
        self.n = len(self.y)


class Side:
    """The reference (float64) or the control (float32 with TF32 matmuls) on
    a device: objective, loss to minimise and predictions of one expert, by
    the model's module (gpbench/models/<oi_model>.py)."""

    def __init__(self, cfg, model, device, control=False):
        self.cfg, self.model, self.device = cfg, model, torch.device(device)
        self.control = control
        self.dtype = torch.float32 if control else torch.float64
        self.jitter = float(cfg["defaults"].get("jitter", 0.0))

    def t(self, a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, float), dtype=self.dtype, device=self.device)

    def _tf32(self):
        return _Tf32(self.control and self.device.type == "cuda")

    def objective(self, theta, ex):
        """The program's reported objective (the NLML of GPR, the ELBO of
        SGPR)."""
        with self._tf32():
            return self.model.objective(theta, self.t(ex.X), self.t(ex.y),
                                        self.t(ex.Z), self.jitter)

    def loss(self, ex):
        """theta -> the objective the fit minimises."""
        sign = -1.0 if self.model.MAXIMISED else 1.0
        return lambda theta: sign * self.objective(theta, ex)

    def predict(self, theta, ex):
        with self._tf32(), torch.no_grad():
            out = self.model.predict(theta, self.t(ex.X), self.t(ex.y),
                                     self.t(ex.Z), self.t(ex.Xs),
                                     self.jitter)
        return {k: v.double().cpu().numpy() for k, v in out.items()}

    def theta(self, params):
        return ref_fit.as_theta(params, self.dtype, self.device)


class _Tf32:
    """TF32 matmuls on inside the block (the control's precision)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on or self.was

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.was


def _params_of(out, e):
    return {n: np.asarray(out["params"][n][e], float)
            for n in ref_fit.NAMES}


def pred_errors(got, want):
    """(f_err, var_err) of one expert's predictions against the reference."""
    f = float(np.max(np.abs(got["f*"] - want["f*"])))
    var = max(float(np.max(np.abs(got[k] - want[k]) / want["y_var"]))
              for k in ("f*_var", "y_var"))
    return f, var


def expert_readings(ref, ex, params, objective, preds, polish=True):
    """The readings of one expert: the program's (or the control's) fitted
    params, objective and predictions held against the reference."""
    d = ex.X.shape[1]
    theta = ref.theta(params)
    with torch.enable_grad():
        ref_obj = float(ref.objective(theta, ex))
    out = {"objective_gap": abs(float(objective) - ref_obj) / ex.n,
           "expert": {"n": ex.n, "objective": float(objective),
                      "reference": ref_obj,
                      "theta": {k: np.round(np.ravel(v), 6).tolist()
                                for k, v in params.items()}}}
    if polish:
        bounds = ref_fit.bounds_of(ref.cfg["model"], d)
        loss = ref.loss(ex)
        _, best = ref_fit.minimise(loss, params, bounds, d, ref.dtype,
                                   ref.device)
        with torch.enable_grad():
            start = float(loss(ref.theta(ref_fit.start_of(ex.y, bounds,
                                                           d))))
        fitted = -ref_obj if ref.model.MAXIMISED else ref_obj
        out["fit_gap"] = fitted - best
        out["fit_shortfall"] = (fitted - best) / max(start - best, 1e-12)
    if preds is not None:
        out["f_err"], out["var_err"] = pred_errors(preds,
                                                   ref.predict(theta, ex))
    return out


def worst(rows):
    """{number: worst over rows}; NaN anywhere stays NaN."""
    keys = sorted({k for r in rows for k in r if k != "expert"})
    return {k: float(np.max([r[k] for r in rows if k in r])) for k in keys}


def worst_experts(rows):
    """{number: the row of the expert that sets it}, for diagnostics."""
    keys = sorted({k for r in rows for k in r if k != "expert"})
    return {k: max((r for r in rows if k in r),
                   key=lambda r: np.nan_to_num(r[k], nan=np.inf))
            for k in keys}


def program_preds(out, e):
    P = int(out["n_pred"][e])
    return {k: np.asarray(out["preds"][k][e, :P], float) for k in PRED_KEYS}


def check_fit_days(cfg, model, days, seed, per_level, device):
    """Readings of a fit window: days = [(inputs, program result)]."""
    ref = Side(cfg, model, device)
    rows = []
    for j, (inp, out) in enumerate(days):
        z = model.extras(cfg, inp)
        n = [len(o) for o in inp["obs_list"]]
        for e in sample_experts(n, seed, per_level, salt=j):
            ex = Expert(cfg, inp, e, z)
            rows.append(expert_readings(ref, ex, _params_of(out, e),
                                        out["objective"][e],
                                        program_preds(out, e)))
    return dict(worst(rows), _worst=worst_experts(rows))


def smoothed_fields(cfg, experts, params, dtype, device):
    """The reference's smoothing of fitted parameters over the experts'
    (x, y): {name: [E, ...]}, one field per component."""
    sm = cfg["smoothing"]
    x = torch.as_tensor(experts[:, 0], dtype=dtype, device=device)
    y = torch.as_tensor(experts[:, 1], dtype=dtype, device=device)
    out = {}
    for name in ref_fit.NAMES:
        v = np.asarray(params[name], float)
        cols = v.reshape(len(x), -1)
        res = np.empty_like(cols)
        for j in range(cols.shape[1]):
            res[:, j] = gp.smooth(
                x, y, torch.as_tensor(cols[:, j], dtype=dtype,
                                      device=device),
                sm["l_x_km"] * KM, sm["l_y_km"] * KM,
                sm["max"].get(name)).double().cpu().numpy()
        out[name] = res.reshape(v.shape)
    return out


def smooth_err(got, want):
    return max(float(np.max(np.abs(got[n] - want[n]) / np.abs(want[n])))
               for n in want)


def check_repredict(cfg, model, inp, fitted, smoothed, out, seed,
                    per_level, device):
    """Readings of a re-predict window: the program's smoothed fields
    against the reference's smoothing of the set-up's fitted parameters;
    the last pass's predictions and objective against the reference at the
    reference's smoothed parameters; the set-up's fit (the state the window
    starts from) by its fit_shortfall."""
    ref = Side(cfg, model, device)
    want = smoothed_fields(cfg, inp["experts"], fitted["params"],
                           torch.float64, device)
    numbers = {"smooth_err": smooth_err(smoothed, want)}
    z = model.extras(cfg, inp)
    n = [len(o) for o in inp["obs_list"]]
    rows, fit_rows = [], []
    for e in sample_experts(n, seed, per_level, salt=7):
        ex = Expert(cfg, inp, e, z)
        rows.append(expert_readings(
            ref, ex, {k: v[e] for k, v in want.items()}, out["objective"][e],
            program_preds(out, e), polish=False))
        fit_rows.append(expert_readings(ref, ex, _params_of(fitted, e),
                                        fitted["objective"][e], None))
    numbers.update(worst(rows))
    fit = worst(fit_rows)
    numbers["setup_fit_shortfall"] = fit["fit_shortfall"]
    numbers["_worst"] = worst_experts(rows + fit_rows)
    return numbers


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that is missing or not finite fails."""
    rows = [(k, float(numbers.get(k, np.nan)), float(limits[k]))
            for k in sorted(limits)]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows


def control_fit(cfg, model, inp, ids, device):
    """The control's readings on experts `ids` of one day: the reference in
    the precision below the configuration's (float32 with TF32 matmuls) in
    the program's place, fitting each expert from the program's documented
    start and predicting at its fit, held against the float64 reference."""
    ref, ctrl = Side(cfg, model, device), Side(cfg, model, device,
                                                control=True)
    z = model.extras(cfg, inp)
    rows = []
    for e in ids:
        ex = Expert(cfg, inp, e, z)
        d = ex.X.shape[1]
        bounds = ref_fit.bounds_of(cfg["model"], d)
        theta, _ = ref_fit.minimise(ctrl.loss(ex),
                                    ref_fit.start_of(ex.y, bounds, d),
                                    bounds, d, ctrl.dtype, ctrl.device)
        th = ctrl.theta(theta)
        with torch.enable_grad():
            obj = float(ctrl.objective(th, ex))
        rows.append(expert_readings(ref, ex, theta, obj,
                                    ctrl.predict(th, ex)))
    return dict(worst(rows), _worst=worst_experts(rows))


def control_fit_days(cfg, model, days, seed, per_level, device):
    """control_fit on the experts check_fit_days samples: days = [inputs]."""
    rows = []
    for j, inp in enumerate(days):
        n = [len(o) for o in inp["obs_list"]]
        ids = sample_experts(n, seed, per_level, salt=j)
        rows.append(control_fit(cfg, model, inp, ids, device))
    return {k: max(r[k] for r in rows) for k in rows[0] if k != "_worst"}


def control_repredict(cfg, model, inp, fitted, seed, per_level, device):
    """The control of a re-predict window: the fields smoothed in float32
    (the smoother's configuration is float64), the predictions and objective
    in float32 with TF32 matmuls at the control's smoothed parameters, each
    against the float64 reference's; the set-up's fit as control_fit."""
    ref, ctrl = Side(cfg, model, device), Side(cfg, model, device,
                                                control=True)
    want = smoothed_fields(cfg, inp["experts"], fitted["params"],
                           torch.float64, device)
    got = smoothed_fields(cfg, inp["experts"], fitted["params"],
                          torch.float32, device)
    numbers = {"smooth_err": smooth_err(got, want)}
    z = model.extras(cfg, inp)
    n = [len(o) for o in inp["obs_list"]]
    ids = sample_experts(n, seed, per_level, salt=7)
    rows = []
    for e in ids:
        ex = Expert(cfg, inp, e, z)
        th = ctrl.theta({k: v[e] for k, v in got.items()})
        with torch.enable_grad():
            obj = float(ctrl.objective(th, ex))
        row = expert_readings(ref, ex, {k: v[e] for k, v in want.items()},
                              obj, ctrl.predict(th, ex), polish=False)
        rows.append(row)
    numbers.update(worst(rows))
    numbers["setup_fit_shortfall"] = control_fit(
        cfg, model, inp, ids, device)["fit_shortfall"]
    return numbers
