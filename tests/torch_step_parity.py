"""Shared helpers of the whole-step parity tests (test_torch_train.py,
test_torch_train_supervised.py): one JAX train step and one port step from
the same weights, batch and random draws, and their comparison.  The limits
and the reasons for them are set out in test_torch_train.py's docstring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polardepth_tpu.ops.fresnel import normal_priors_from_xolp
from polardepth_tpu.ops.xolp import xolp_from_pol
from polardepth_tpu.train.state import create_train_state

from polardepth_tpu_torch.models import network
from polardepth_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.train import state

B, H, W = 2, 64, 96
LOSS_RTOL = 1e-5
# the photometric terms reproj_loss/s: see test_torch_train.py,
# test_reproj_terms_resolve_to_the_rounding_of_the_grid
REPROJ_RTOL = 1e-3
GRAD_RTOL = 1e-4
NOISE_MULT = 4.0
REROLL_SCALES = (1.0 + 2.0 ** -20, 1.0 - 2.0 ** -20)
STATS_ATOL = 1e-5
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _float32_jax():
    """The JAX steps in float32, as on the TPU (tests/conftest.py turns on
    x64 for the float64 oracles of other tests; with it, the JAX package's
    random draws, and so its jittered images, would be float64)."""
    with jax.enable_x64(False):
        yield


def _jax_preprocess(pol, n=1.5):
    """The JAX package's CPU preprocess, in the port's network."""
    xolp = xolp_from_pol(jnp.asarray(pol.detach().numpy()))
    priors = normal_priors_from_xolp(xolp, n)
    return (torch.from_numpy(np.array(xolp)),
            torch.from_numpy(np.array(priors)))


@pytest.fixture(autouse=True)
def _same_preprocess(monkeypatch):
    monkeypatch.setattr(network, "fused_polar_preprocess", _jax_preprocess)


def _redraw_bn(variables, seed, stats=False):
    """BatchNorm scales and biases drawn with numpy, so that no layer starts
    at the symmetric 1/0 init; with stats, the running means and variances
    too."""
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        a = np.asarray(a, np.float32)
        names = [getattr(p, "key", "") for p in path]
        if any(n.startswith("BatchNorm") for n in names):
            if names[-1] == "scale" or (stats and names[-1] == "var"):
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            if names[-1] == "bias" or (stats and names[-1] == "mean"):
                return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))


def _jitter_draws(key, b):
    """The factors color_jitter(key, ...) draws (data/augment.py:70-89)."""
    kb, kc, ks, kh, kp = jax.random.split(key, 5)

    def u(k, lo, hi):
        return np.asarray(jax.random.uniform(k, (b, 1, 1, 1), minval=lo,
                                             maxval=hi))

    return {"brightness": torch.from_numpy(u(kb, 0.8, 1.2)),
            "contrast": torch.from_numpy(u(kc, 0.8, 1.2)),
            "saturation": torch.from_numpy(u(ks, 0.8, 1.2)),
            "hue": torch.from_numpy(u(kh, -0.1, 0.1)),
            "apply": torch.from_numpy(
                np.asarray(jax.random.uniform(kp, (b, 1, 1, 1)) < 0.5))}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def _flat(tree):
    return dict(_leaves(tree))


def _report(bad, what):
    assert not bad, f"{what}: " + "; ".join(bad[:10])


def _assert_logs_close(logs, ref_logs):
    assert set(logs) == set(ref_logs)
    for k, v in ref_logs.items():
        rtol = REPROJ_RTOL if k.startswith("reproj_loss/") else LOSS_RTOL
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=rtol,
                                   err_msg=k)


def _torch_trees(model):
    """(grads, params, batch_stats) of the port's model as flat dicts of
    JAX-layout numpy arrays."""
    grads = {k: p.grad for k, p in model.named_parameters()}
    g_tree, _ = jax_from_state_dict(grads, fused_encoders=True)
    p_tree, s_tree = jax_from_state_dict(model.state_dict(),
                                         fused_encoders=True)
    return _flat(g_tree), _flat(p_tree), _flat(s_tree)


def _gradient_limits(ref_g, g, rerolls):
    """Per tensor: GRAD_RTOL of the JAX gradient's max abs, plus NOISE_MULT
    times the port's own float32 spread there: the largest difference
    between g and the gradients of the port's steps from the weights
    scaled by 1 +- 2^-20 (``REROLL_SCALES``), or jiggled (``_run_port``)."""
    return {k: GRAD_RTOL * np.abs(r).max() + NOISE_MULT * max(
        np.abs(g[k] - again[k]).max() for again in rerolls)
        for k, r in ref_g.items()}


def _run_port(tmodel_fn, tstep_fn, tcfg, weights, batch, draws, scale=None,
              jiggle=None):
    """One port step from weights; scale multiplies every weight, jiggle (a
    seed) each weight element by 1 + or - 2^-20 at random."""
    tmodel = tmodel_fn(tcfg)
    tmodel.load_state_dict(weights)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(jiggle or 0)
        for prm in tmodel.parameters():
            if scale is not None:
                prm.mul_(scale)
            if jiggle is not None:
                sign = torch.randint(0, 2, prm.shape, generator=gen) * 2 - 1
                prm.mul_(1.0 + sign * 2.0 ** -20)
    tstate = state.create_train_state(tmodel, tcfg)
    logs = tstep_fn(tmodel, tcfg)(tstate, batch, **draws)
    assert tstate.step == 1
    return logs, tmodel


def _jax_reference(jcfg, jmodel, jstep_fn, example, batch, draws_of,
                   redraw_stats=False):
    """One JAX step from its init with BatchNorm redrawn (its running
    statistics too with redraw_stats) -> (the port's weights of the JAX
    state before the step, the port's draws of the step, the reference:
    the step's logs and its gradients, parameters and statistics after it
    as flat dicts)."""
    rng = jax.random.PRNGKey(0)
    jstate = create_train_state(jmodel, {"params": rng, "dropout": rng},
                                example, jcfg.learning_rate)
    v = _redraw_bn({"params": jstate.params,
                    "batch_stats": jstate.batch_stats}, 1, redraw_stats)
    jstate = jstate.replace(params=v["params"], batch_stats=v["batch_stats"])
    weights = state_dict_from_jax(v["params"], v["batch_stats"],
                                  fused_encoders=True)
    new_j, jlogs = jax.jit(jstep_fn)(
        jstate, {k: jnp.asarray(x) for k, x in batch.items()}, rng)
    assert int(new_j.step) == 1
    ref = {"logs": jlogs,
           "g": _flat(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                             new_j.opt_state[0].mu)),
           "p": _flat(jax.device_get(new_j.params)),
           "s": _flat(jax.device_get(new_j.batch_stats))}
    return weights, draws_of(jax.random.fold_in(rng, 0)), ref


def _run_pair(jcfg, jmodel, jstep_fn, example, tmodel_fn, tstep_fn, tcfg,
              batch, draws_of):
    """One JAX step and one port step from the same weights, compared."""
    weights, draws, ref = _jax_reference(jcfg, jmodel, jstep_fn, example,
                                         batch, draws_of)
    return _compare_port(ref, tmodel_fn, tstep_fn, tcfg, weights, batch,
                         draws, jcfg.learning_rate)


def _compare_port(ref, tmodel_fn, tstep_fn, tcfg, weights, batch, draws,
                  lr, jiggles=()):
    """The port's step from weights with draws against ref (as
    ``_jax_reference`` gives it) at the module's limits; returns the
    port's logs.  The float32 spread comes from the steps from the weights
    scaled by ``REROLL_SCALES`` and, for each seed in jiggles, from the
    weights jiggled element by element (``_run_port``)."""
    logs, tmodel = _run_port(tmodel_fn, tstep_fn, tcfg, weights, batch,
                             draws)
    rerolls = [_torch_trees(_run_port(tmodel_fn, tstep_fn, tcfg, weights,
                                      batch, draws, **kw)[1])[0]
               for kw in [{"scale": sc} for sc in REROLL_SCALES]
               + [{"jiggle": seed} for seed in jiggles]]

    _assert_logs_close(logs, ref["logs"])
    g, p, s = _torch_trees(tmodel)
    ref_g, ref_p, ref_s = ref["g"], ref["p"], ref["s"]
    assert g.keys() == ref_g.keys() == p.keys() == ref_p.keys()
    assert s.keys() == ref_s.keys()
    limits = _gradient_limits(ref_g, g, rerolls)
    _report([f"{k}: {np.abs(g[k] - r).max():.3e} > {limits[k]:.3e}"
             for k, r in ref_g.items()
             if np.abs(g[k] - r).max() > limits[k]], "gradients")
    _report([f"{k}: {np.abs(s[k] - r).max():.3e}" for k, r in ref_s.items()
             if np.abs(s[k] - r).max() > STATS_ATOL], "batch stats")
    # Adam's first step moves each element by lr * u(g), u(g) = g/(|g|+eps);
    # the port's parameters lie within PARAM_ATOL of the JAX package's plus
    # the spread of lr * u over the gradient limit around the JAX gradient
    def u(x):
        return x / (np.abs(x) + 1e-8)

    bad = []
    for k, r in ref_p.items():
        gj, lim = ref_g[k], limits[k]
        spread = np.maximum(np.abs(u(gj + lim) - u(gj)),
                            np.abs(u(gj - lim) - u(gj)))
        excess = np.abs(p[k] - r) - (PARAM_ATOL + lr * spread)
        if excess.max() > 0:
            bad.append(f"{k}: exceeds by {excess.max():.3e}")
    _report(bad, "parameters")
    return logs
