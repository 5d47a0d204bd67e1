"""The inducing points of an SGPR expert, worked out again from the recipe the
program documents: experts grouped into padded levels by their numbers of
observations and prediction points (ascending level, experts in index
order); one numpy generator seeded with `inducing_seed` a level; each expert
with more than M observations takes the first M rows of a permutation drawn
from it, in turn; an expert with at most M takes all its rows."""

import numpy as np

from gpbench.generator import level_of


def levels(n_obs, n_pred):
    """[(key, [expert ids])] of the padded levels, in the program's order."""
    keys = {}
    for i, (n, p) in enumerate(zip(n_obs, n_pred)):
        keys.setdefault((level_of(int(n)), level_of(int(p)) if p else 0),
                        []).append(i)
    return sorted(keys.items())


def inducing_rows(n_obs, n_pred, M, seed=42):
    """{expert id: row indices of its inducing points}."""
    out = {}
    for (n_max, _), ids in levels(n_obs, n_pred):
        m = min(M, n_max)
        rng = np.random.default_rng(seed)
        for i in ids:
            n = int(n_obs[i])
            out[i] = rng.permutation(n)[:m] if n > m else np.arange(n)
    return out
