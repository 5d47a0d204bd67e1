"""Where phase 10's SGPR run over the mesh parts from the one-device run.

    python3 tools/mesh_fill_width.py

Runs chip_smoke.py's SGPR pipeline cell (96 centre experts, M=500, route
"mega") on one device, again over the mesh and again on one device, and
prints which fields of each run differ from the first in any bit; then the
fill alone at the one-device fit's parameters: the first 48 experts
predicted on their own against the same experts inside the whole level of
96 (a mesh of two shards predicts 48 a shard). Needs a CUDA device.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch

import chip_smoke as cs
from gpsat_tpu_torch.local_experts import make_engine
from gpsat_tpu_torch.models.sgpr import SGPRModel
from gpsat_tpu_torch.ops import _build, cuda_gpr

torch.backends.cuda.matmul.allow_tf32 = False
_build.build(force=True)
inp = cs.arctic_inputs()
sgpr = cs.phase_pipeline_sgpr(cuda_gpr, inp)
mesh = cs.mesh_of_run()
init = dict(cs.ARCTIC_MODEL["init_params"], num_inducing_points=cs.SGPR_RUN["M"],
            route=cs.SGPR_RUN["route"])


def engine():
    return make_engine(SGPRModel, init, cs.ARCTIC_MODEL["constraints"],
                       coords_dim=3)


s_out = cs.run_pipeline(engine(), sgpr["sub"], mesh)
cs.report_mesh_run("mesh SGPR", s_out, sgpr["out"])
again = cs.run_pipeline(engine(), sgpr["sub"])
cs.report_mesh_run("one-device SGPR again", again, sgpr["out"])
# the fill alone: predictions at the one-device fit's parameters, the 96
# experts in one call against its first 48 alone
sub = sgpr["sub"]
bk = cs.buckets_of(sub)[0]
X, y, mask, Xs, *_ = cs.assembled(sub, bk)
ids = bk["indices"]
ov = {k: v[ids] for k, v in sgpr["out"]["params"].items()}
whole = engine().fit_predict_many(X, y, mask, Xs=Xs, optimise=False,
                                  param_overrides=ov)
half = engine().fit_predict_many(X[:48], y[:48], mask[:48], Xs=Xs[:48],
                                 optimise=False,
                                 param_overrides={k: v[:48] for k, v in ov.items()})
for k in ("f*", "f*_var", "y_var"):
    d = np.abs(whole["preds"][k][:48] - half["preds"][k])
    print(f"fill of 48 alone vs inside 96: {k} experts differing "
          f"{int((d.reshape(48, -1) > 0).any(axis=1).sum())}, max abs {d.max():.3e}")
for k in ("objective",):
    d = np.abs(whole[k][:48] - half[k])
    print(f"fill {k}: differing {int((d > 0).sum())}, max abs {d.max():.3e}")
