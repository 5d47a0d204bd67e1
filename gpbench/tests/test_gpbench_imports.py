"""Nothing the benchmark runs holds jax or the JAX package: the check
compares whole top-level module names (the port's name begins with the JAX
package's); and without a card, or without the program, a run prints no
result."""

import json
import os
import shutil
import subprocess
import sys

from gpbench import run

from conftest import ROOT, tiny_run


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "gpsat_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpsat_tpu.ops.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["gpsat_tpu", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, json\n"
            "sys.path.insert(0, 'gpbench/tests')\n"
            "from conftest import tiny_run\n"
            "tiny_run('gpr_arctic50.repredict')\n"
            "from gpbench import run\n"
            "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "gpbench.run", "--workload",
         "gpr_arctic50.fit", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_cli(ROOT, env)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpbench"), tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run_cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_cpu_run_reads_every_end_to_end_metric_of_its_cell():
    spec = run.cell_spec("gpr_arctic50.fit")
    rec = tiny_run("gpr_arctic50.fit")
    line = run.result_line(spec, rec, False)
    assert set(line["metrics"]) == {"experts_per_s", "setup_s"}
    assert list(line)[-1] == "checks" and line["correct"]
