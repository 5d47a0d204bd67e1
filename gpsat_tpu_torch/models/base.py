"""BaseGPRModel, the per-expert model contract (torch port of
gpsat_tpu/models/base.py).

Keeps the reference's API (GPSat/models/base_model.py:17): data ingest from a
DataFrame or arrays, de-mean/rescale order, `param_names` with get_*/set_*
per name, `set_parameter_constraints` dispatch, and the abstract predict /
optimise_parameters / get_objective_function_value.

A model instance is a *view* onto the batched math in gpsat_tpu_torch.ops: the
hyperparameters live on the host as numpy values, and tensors are made per
call on the model's `device` in its `dtype` (cuda and float32 unless the
caller passes others; float64 on the CPU).

pandas is never imported: `data`, and coordinates handed to `predict` as a
Series or DataFrame, are used through their own interface (`.loc`,
`.to_numpy`), so the array path needs numpy alone.
"""

import platform
import re
from abc import ABC, abstractmethod
from typing import Dict, List

import numpy as np
import torch

from gpsat_tpu_torch import default_dtype, resolve_device

__all__ = ["BaseGPRModel", "frame_values"]


def _get_processor_name():
    try:
        if platform.system() == "Linux":
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if "model name" in line:
                        return re.sub(r".*model name.*:", "", line, count=1).strip()
        return platform.processor() or platform.machine()
    except OSError:
        return "unknown"


def _get_accelerator_name(device):
    """Name of the card the model runs on, None on the host."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return None


def frame_values(coords, coords_col):
    """Coordinates handed over as a pandas Series/DataFrame -> their values
    (the `coords_col` columns when there are any); anything else is returned
    as it came. Told apart by its interface, so pandas is never imported."""
    if hasattr(coords, "to_numpy") and hasattr(coords, "loc"):
        if coords_col is not None:
            coords = coords[coords_col]
        return coords.to_numpy()
    return coords


class BaseGPRModel(ABC):
    """Base class for all local-expert models (see module docstring)."""

    def __init__(self,
                 data=None,
                 coords_col=None,
                 obs_col=None,
                 coords=None,
                 obs=None,
                 coords_scale=None,
                 obs_scale=None,
                 obs_mean=None,
                 verbose=False,
                 device=None,
                 dtype=None,
                 **kwargs):
        self.device = resolve_device(device)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self.dtype = default_dtype(self.device) if dtype is None else dtype

        if data is not None:
            assert coords_col is not None, "data was provided, but coords_col was not"
            assert obs_col is not None, "data was provided, but obs_col was not"
            if isinstance(coords_col, str):
                coords_col = [coords_col]
            if isinstance(obs_col, str):
                obs_col = [obs_col]
            self.obs = data.loc[:, obs_col].to_numpy(copy=True)
            self.coords = data.loc[:, coords_col].to_numpy(copy=True)
            self.obs_col = obs_col
            self.coords_col = coords_col
        else:
            assert obs is not None, "provide either data or obs"
            assert coords is not None, "provide either data or coords"
            obs = np.asarray(obs)
            coords = np.asarray(coords)
            if obs.ndim == 1:
                obs = obs[:, None]
            if coords.ndim == 1:
                coords = coords[:, None]
            assert len(obs) == len(coords), "obs and coords lengths don't match"
            self.obs = obs.copy()
            self.coords = coords.copy()
            self.coords_col = coords_col if coords_col is not None \
                else list(range(self.coords.shape[1]))
            self.obs_col = obs_col if obs_col is not None else [0]

        assert not np.isnan(self.coords).any(), "nans found in coords"
        assert not np.isnan(self.obs).any(), "nans found in obs"

        # de-mean: 'local' -> subtract the sample mean
        if isinstance(obs_mean, str) and obs_mean == "local":
            obs_mean = np.mean(self.obs, axis=0)
        elif obs_mean is None:
            obs_mean = np.array([0])[None, :]
        if isinstance(obs_mean, list):
            obs_mean = np.array(obs_mean)[None, :]
        elif isinstance(obs_mean, (int, float)):
            obs_mean = np.array([obs_mean])[None, :]
        elif isinstance(obs_mean, np.ndarray) and obs_mean.ndim == 1:
            obs_mean = obs_mean[None, :]
        self.obs_mean = obs_mean

        def _as_2d(v):
            if v is None:
                return np.atleast_2d(1)
            if isinstance(v, list):
                return np.array(v)[None, :]
            if isinstance(v, (int, float)):
                return np.array([v])[None, :]
            return np.atleast_2d(np.asarray(v))

        self.obs_scale = _as_2d(obs_scale)
        self.coords_scale = _as_2d(coords_scale)

        # scale coords / obs — order matters and matches the reference
        # (GPSat/models/base_model.py:234-245)
        self.coords = self.coords.astype(float)
        self.obs = self.obs.astype(float)
        self.coords = self.coords / self.coords_scale
        self.obs = self.obs - self.obs_mean
        self.obs = self.obs / self.obs_scale

        self.gpu_name = _get_accelerator_name(self.device)
        self.cpu_name = _get_processor_name()

        # every param_name must have a get_/set_ method
        for pn in self.param_names:
            assert " " not in pn, f"param_name '{pn}' contains a space"
            getattr(self, f"set_{pn}")
            getattr(self, f"get_{pn}")

    def _tensor(self, a, dtype=None):
        """Tensor of `a` on the model's device (model dtype unless given)."""
        dtype = self.dtype if dtype is None else dtype
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _prediction_coords(self, coords, apply_scale):
        """Prediction coordinates as a [P, D] float array, scaled by
        coords_scale when `apply_scale`."""
        coords = np.asarray(frame_values(coords, self.coords_col),
                            dtype=float)
        if coords.ndim == 1:
            coords = coords[None, :]
        if apply_scale:
            coords = coords / self.coords_scale
        return coords

    # -- abstract interface --------------------------------------------------

    @abstractmethod
    def predict(self, coords) -> Dict[str, np.ndarray]:
        """Predictions at given coords; dict with at least 'f*', 'f*_var', 'y_var'."""

    @abstractmethod
    def optimise_parameters(self):
        """Fit the model; returns bool optimisation success."""

    @property
    @abstractmethod
    def param_names(self) -> List[str]:
        """Names of (hyper)parameters, each with get_*/set_* methods."""

    @abstractmethod
    def get_objective_function_value(self):
        """Value of the training objective at the current parameters."""

    # -- shared parameter plumbing ------------------------------------------

    def get_parameters(self, *args, return_dict=True):
        if len(args) == 0:
            args = self.param_names
        for a in args:
            assert a in self.param_names, \
                f"cannot get parameter '{a}': not in param_names {self.param_names}"
        if return_dict:
            return {a: getattr(self, f"get_{a}")() for a in args}
        return [getattr(self, f"get_{a}")() for a in args]

    def set_parameters(self, **kwargs):
        for k, v in kwargs.items():
            assert k in self.param_names, \
                f"cannot set parameter '{k}': not in param_names {self.param_names}"
            getattr(self, f"set_{k}")(v)

    def set_parameter_constraints(self, constraints_dict, **kwargs):
        for k, v in constraints_dict.items():
            assert k in self.param_names, \
                f"cannot constrain '{k}': not in param_names {self.param_names}"
            getattr(self, f"set_{k}_constraints")(**v, **kwargs)
