"""The traffic generator: seeded, and the level mixes the configurations
state."""

import json
import os

import numpy as np
import pytest

from gpbench import generator, run


def config(name):
    path = os.path.join(run.ROOT, "gpbench", "configs", name + ".json")
    with open(path) as f:
        return json.load(f)


def test_same_seed_same_inputs_other_seed_other_inputs():
    dep = dict(config("gpr_arctic50")["deployment"], n_tracks=20)
    a, b = generator.observations(2 ** 33 + 5, dep), \
        generator.observations(2 ** 33 + 5, dep)
    c = generator.observations(2 ** 33 + 6, dep)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].shape != c[1].shape or not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("name, day, mix", [
    ("gpr_arctic50", 3, {64: 9, 128: 45, 256: 248, 512: 1260, 1024: 1039}),
    ("gpr_arctic50", 5, {32: 1, 64: 8, 128: 35, 256: 147, 512: 1168,
                         1024: 1242}),
    ("sgpr_is2", 15, {1024: 3, 2048: 1, 4096: 19, 8192: 26}),
    ("sgpr_is2", 16, {1024: 3, 2048: 1, 4096: 17, 8192: 28}),
])
def test_level_mix_at_seed_0(name, day, mix):
    dep = config(name)["deployment"]
    inp = generator.day_inputs(generator.observations(0, dep), dep, day)
    assert generator.level_mix(inp) == mix
    assert {len(p) for p in inp["pred_list"]} == {793}


@pytest.mark.parametrize("name, day", [("gpr_arctic50", 3),
                                       ("sgpr_is2", 15)])
def test_every_seed_has_the_same_sizes_in_another_order(name, day):
    dep = config(name)["deployment"]
    sizes, orders = [], set()
    for seed in (0, 2 ** 31 + 7, 2 ** 31 + 8, 4100000003, 6100000003):
        inp = generator.day_inputs(generator.observations(seed, dep), dep,
                                   day)
        n = [len(o) for o in inp["obs_list"]]
        sizes.append(sorted(n))
        orders.add(tuple(n))
    assert all(s == sizes[0] for s in sizes[1:])
    assert len(orders) > 1
