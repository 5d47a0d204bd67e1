"""JSON-(de)serialisable experiment configuration dataclasses (copy of
gpsat_tpu/config_dataclasses.py; reference:
GPSat/config_dataclasses.py:11-630).

Plain dataclasses with to_dict/from_dict (the reference used dataclasses-json;
not a dependency here). Sections mirror the reference's experiment config:
data / model / locations (expert locations) / pred_loc / run_kwargs.
"""

import json
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, List, Optional, Union

from gpsat_tpu_torch.utils import json_serializable, nested_dict_literal_eval

__all__ = ["DataConfig", "ModelConfig", "ExpertLocsConfig",
           "PredictionLocsConfig", "RunConfig", "ExperimentConfig"]


class _DictMixin:
    def to_dict(self):
        return json_serializable({k: v for k, v in asdict(self).items()
                                  if v is not None})

    def to_json(self, **kwargs):
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_dict(cls, d):
        if d is None:
            return None
        if isinstance(d, cls):
            return d
        names = {f.name for f in fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        return cls(**known)


@dataclass
class DataConfig(_DictMixin):
    """Observation data source + selection (reference: config_dataclasses.py:11)."""
    data_source: Optional[Any] = None
    obs_col: Optional[str] = None
    coords_col: Optional[List[str]] = None
    table: Optional[str] = None
    global_select: Optional[List[dict]] = None
    local_select: Optional[List[dict]] = None
    where: Optional[List[dict]] = None
    row_select: Optional[List[dict]] = None
    col_select: Optional[List[str]] = None
    col_funcs: Optional[Dict[str, dict]] = None
    engine: Optional[str] = None
    read_kwargs: Optional[dict] = None


@dataclass
class ModelConfig(_DictMixin):
    """Model + optimisation settings (reference: config_dataclasses.py:221)."""
    oi_model: Union[str, dict, None] = None
    init_params: Optional[dict] = None
    constraints: Optional[dict] = None
    load_params: Optional[dict] = None
    optim_kwargs: Optional[dict] = None
    pred_kwargs: Optional[dict] = None
    params_to_store: Union[str, List[str], None] = None
    replacement_threshold: Optional[int] = None
    replacement_model: Optional[str] = None


@dataclass
class ExpertLocsConfig(_DictMixin):
    """Expert-location source (reference: config_dataclasses.py:333)."""
    source: Optional[Any] = None
    where: Optional[List[dict]] = None
    col_funcs: Optional[dict] = None
    row_select: Optional[List[dict]] = None
    col_select: Optional[List[str]] = None
    sort_by: Optional[Union[str, List[str]]] = None
    source_kwargs: Optional[dict] = None


@dataclass
class PredictionLocsConfig(_DictMixin):
    """Prediction-location generation (reference: config_dataclasses.py:450)."""
    method: str = "expert_loc"
    df: Optional[Any] = None
    df_file: Optional[str] = None
    max_dist: Optional[float] = None
    load_kwargs: Optional[dict] = None


@dataclass
class RunConfig(_DictMixin):
    """run() keyword arguments (reference: config_dataclasses.py:514)."""
    store_path: Optional[str] = None
    store_every: int = 10
    check_config_compatible: bool = True
    skip_valid_checks_on: Optional[list] = None
    optimise: bool = True
    predict: bool = True
    min_obs: int = 3
    table_suffix: str = ""


@dataclass
class ExperimentConfig(_DictMixin):
    """Full experiment = data + model + locations + pred_loc + run_kwargs
    (reference: config_dataclasses.py:552)."""
    data: Optional[DataConfig] = None
    model: Optional[ModelConfig] = None
    locations: Optional[ExpertLocsConfig] = None
    pred_loc: Optional[PredictionLocsConfig] = None
    run_kwargs: Optional[RunConfig] = None
    comment: Optional[str] = None

    @classmethod
    def from_dict(cls, d):
        if d is None:
            return None
        d = nested_dict_literal_eval(d)
        return cls(
            data=DataConfig.from_dict(d.get("data")),
            model=ModelConfig.from_dict(d.get("model")),
            locations=ExpertLocsConfig.from_dict(d.get("locations")),
            pred_loc=PredictionLocsConfig.from_dict(d.get("pred_loc")),
            run_kwargs=RunConfig.from_dict(d.get("run_kwargs")),
            comment=d.get("comment"))

    @classmethod
    def from_json_file(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self):
        out = {}
        for name in ("data", "model", "locations", "pred_loc", "run_kwargs"):
            v = getattr(self, name)
            if v is not None:
                out[name] = v.to_dict() if hasattr(v, "to_dict") else v
        if self.comment:
            out["comment"] = self.comment
        return out

    def run(self, device=None):
        """Build the port's LocalExpertOI from this config and run it, on
        `device` ("cuda" unless the caller passes another; the device never
        enters the stored config)."""
        from gpsat_tpu_torch.local_experts import LocalExpertOI
        locexp = LocalExpertOI(
            expert_loc_config=self.locations.to_dict() if self.locations else None,
            data_config=self.data.to_dict() if self.data else None,
            model_config=self.model.to_dict() if self.model else None,
            pred_loc_config=self.pred_loc.to_dict() if self.pred_loc else None,
            device=device)
        rk = self.run_kwargs.to_dict() if self.run_kwargs else {}
        return locexp.run(**rk)
