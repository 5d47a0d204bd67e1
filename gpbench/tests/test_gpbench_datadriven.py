"""A later change adds a configuration, a traffic mix, a mode, a metric and
a cell by adding files and entries alone, in a copy of the benchmark."""

import json
import os
import shutil

import torch

from gpbench import run

from conftest import ROOT, SEED, TINY


def copy_of_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpbench"), tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "gpbench"


MODE = '''
import os
from gpbench import names
_fit = names.load("modes", "fit", os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
setup, unit, check = _fit.setup, _fit.unit, _fit.check


def target_days(dep):
    return dep["target_days"][1:]
'''


def test_add_config_mix_mode_metric_and_cell(tmp_path, monkeypatch):
    g = copy_of_the_benchmark(tmp_path)
    cfg = json.loads((g / "configs" / "gpr_arctic50.json").read_text())
    cfg["name"] = "gpr_small"
    cfg["deployment"].update(TINY)
    (g / "configs" / "gpr_small.json").write_text(json.dumps(cfg))
    mix = {"mode": "fit_second", "warm_experts_per_level": 1,
           "execute": {"batch_size": 8}}
    (g / "traffic" / "fit_lean.json").write_text(json.dumps(mix))
    (g / "modes" / "fit_second.py").write_text(MODE)
    (g / "checks" / "gpr_small.fit_lean.json").write_text(
        (g / "checks" / "gpr_arctic50.fit.json").read_text())
    (g / "metrics" / "days.py").write_text(
        "def read(rec, name):\n    return len(rec['units'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gpr_small", "source": "x",
                             "file": "gpbench/configs/gpr_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gpr_small.fit_lean",
                               "config": "gpr_small", "traffic": "fit_lean",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "days", "unit": "days",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "experts_per_s",
                               "workloads": ["gpr_small.fit_lean"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    from gpsat_tpu_torch import local_experts
    calls = []
    execute = local_experts.execute_buckets

    def recorded(*a, **kw):
        calls.append(kw)
        return execute(*a, **kw)
    monkeypatch.setattr(local_experts, "execute_buckets", recorded)

    spec = run.cell_spec("gpr_small.fit_lean", str(tmp_path))
    rec = run.run_cell(spec, SEED, 0.05, False, torch.device("cpu"))
    rec["trace"] = None
    line = run.result_line(spec, rec, True)
    assert line["metrics"]["days"]["value"] == 1
    assert "vg_roofline" not in line["metrics"]
    assert line["correct"]
    # the mix's execute block reaches every call; the new mode's days
    assert calls and all(kw["batch_size"] == 8 for kw in calls)
    assert spec["mode"].target_days(cfg["deployment"]) == [5]


def test_a_cell_on_files_already_here_needs_entries_alone(tmp_path):
    """sgpr_is2.fit: its configuration, traffic, model and limits are files
    of gpbench/; BENCHMARK.json entries make it a cell."""
    copy_of_the_benchmark(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sgpr_is2", "source": "x",
                             "file": "gpbench/configs/sgpr_is2.json",
                             "reduced": ["expert_stride"], "why": "x"})
    bench["workloads"].append({"name": "sgpr_is2.fit", "config": "sgpr_is2",
                               "traffic": "fit", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.cell_spec("sgpr_is2.fit", str(tmp_path))
    assert spec["config"]["model"]["oi_model"] == "SGPRModel"
    assert spec["model"].MAXIMISED
    assert spec["checks"]["limits"]["fit_shortfall"] > 0
    assert [m["name"] for m in spec["metrics"]["end_to_end"]] == ["setup_s"]


def test_a_mix_asks_for_the_programs_mesh_by_its_size(monkeypatch):
    from gpbench import harness
    from gpsat_tpu_torch.parallel import mesh
    made = []
    monkeypatch.setattr(mesh, "get_mesh", lambda n: made.append(n) or "m")
    cfg = run.cell_spec("gpr_arctic50.fit")["config"]
    prog = harness.Program(cfg, torch.device("cpu"), {"mesh": 4})
    assert made == [4] and prog.execute == {"mesh": "m"}
