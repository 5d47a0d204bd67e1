"""The port's entry points (gpsat_tpu_torch.entry_points) against the
repository's JAX ones (__graft_entry__.py) on the CPU: entry()'s inputs and
forward step, and dryrun_multichip over a CPU mesh."""

import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gpsat_tpu_torch import entry_points

torch.set_num_threads(1)


def jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(__file__), "..",
                                    "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


def flat(params, X, y, mask, Xs):
    return [params[k] for k in sorted(params)] + [X, y, mask, Xs]


def widened(args):
    """The entry's float32 inputs in float64 (the same values)."""
    params, *arrays = args
    return ({k: v.double() for k, v in params.items()},
            *(a.double() if a.is_floating_point() else a for a in arrays))


def test_entry_inputs_are_the_jax_entrys():
    """float32 inputs equal the JAX entry's bit for bit (the same
    default_rng(0) draws)."""
    _, jargs = jax_entry()
    _, targs = entry_points.entry(device="cpu")
    for j, t in zip(flat(*jargs), flat(*targs)):
        j = np.asarray(j)
        assert t.device.type == "cpu" and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), j)
    assert targs[1].dtype == torch.float32 and targs[3].dtype == torch.bool


def test_entry_forward_matches_jax():
    """fn(*args) on the inputs widened to f64 against the JAX forward step
    on its inputs widened the same way: NLML, f* and f*_var at 1e-10; the
    f32 run at 1e-4."""
    jfn, jargs = jax_entry()
    fn, args = entry_points.entry(device="cpu")
    j64 = jax.tree.map(lambda a: a.astype(jnp.float64)
                       if a.dtype == jnp.float32 else a, jargs)
    want = [np.asarray(w) for w in jax.jit(jfn)(*j64)]
    got = fn(*widened(args))
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(8,), (8, 32), (8, 32)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10)
    for g, w in zip(fn(*args), want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_entry_needs_a_card_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_points.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_points.dryrun_multichip(2)


def test_dryrun_multichip_2(capsys):
    entry_points.dryrun_multichip(2, devices=["cpu"] * 2)
    assert capsys.readouterr().out.strip() == (
        "dryrun_multichip: OK on 2 devices (B=4, N=16, P=8; gpr pool + "
        "sgpr pool + svgp + smoothing + tiled smoothing)")


def test_dryrun_multichip_needs_its_devices():
    with pytest.raises(RuntimeError, match="need 3 devices"):
        entry_points.dryrun_multichip(3, devices=["cpu"] * 2)


@pytest.mark.slow
def test_dryrun_multichip_8(capsys):
    entry_points.dryrun_multichip(8, devices=["cpu"] * 8)
    assert "OK on 8 devices (B=16, N=16, P=8;" in capsys.readouterr().out
