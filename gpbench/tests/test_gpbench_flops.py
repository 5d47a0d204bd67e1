"""The flop counts against the formulas they were copied from."""

import pytest

import bench
from gpbench import flops


@pytest.mark.parametrize("N, P, D, M", [(400, 400, 3, 500), (37, 793, 3, 11),
                                        (5701, 793, 3, 300)])
def test_against_bench_analytic_flops(N, P, D, M):
    for evals in (0, 7):
        assert bench.analytic_flops("gpr", N, P, D, M, evals, 1) == \
            pytest.approx(evals * flops.gpr_vg(N, D)
                          + flops.gpr_predict(N, P, D), rel=1e-12)
        assert bench.analytic_flops("sgpr", N, P, D, M, evals, 1) == \
            pytest.approx(evals * flops.sgpr_vg(N, M, D)
                          + flops.sgpr_predict(N, M, P, D), rel=1e-12)


def test_unit_flops_take_each_experts_own_sizes():
    rec = {"D": 3, "M": 300, "model": "SGPRModel"}
    unit = {"n": [200, 5000], "p": [10, 793], "iterations": [3, 0]}
    fit, pred = flops.unit_flops(rec, unit)
    assert fit == 3 * flops.sgpr_vg(200, 200, 3)
    assert pred == flops.sgpr_predict(200, 200, 10, 3) + \
        flops.sgpr_predict(5000, 300, 793, 3)
