"""Helpers shared by the parity tests of the port's language models
(``tests/test_torch_{deepseek_v3,whisper,qwen2_vl}.py``): the same reduced
model in both packages from one seed, and the comparisons.

The reference's weights are made by its ``init`` and carried into the port
by ``repro_torch.convert.lm_params``; inputs are numpy arrays of explicit
float32/int32 dtype. The JAX side runs under ``repro.Database(dispatch=
JAX_TIER)`` (the kernels' plain references), the port's under
``repro_torch.Database(device="cpu")``, where every kernel wrapper takes
its plain version.

Tolerances: 1e-5 absolute and relative (``TOL``) for f32 values, as in
``tests/test_torch_gemma.py``; logits and gradients are held to TOL of
their tensor's largest entry (at least 1, ``close_scaled``): each entry is
an f32 sum whose rounding scales with its terms, not with the sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro
import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train import lm_loss as jax_lm_loss
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.train import lm_loss

TOL = 1e-5
#: the reference's dispatch tier
JAX_TIER = "ref"


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def configs(arch, **kw):
    """(port config, reference config) of ``arch`` reduced, equal field by
    field."""
    cfg, jcfg = get_config(arch).reduced(**kw), jax_get_config(arch).reduced(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def lm(arch, **kw):
    """(reference model, its params as numpy, port model with those params)."""
    cfg, jcfg = configs(arch, **kw)
    jmodel = jax_build_model(jcfg)
    params = np_tree(jmodel.init(jax.random.PRNGKey(0)))
    model = convert.lm_params(build_model(cfg, device="cpu", seed=1), params)
    return jmodel, params, model


def ref():
    return repro.Database(dispatch=JAX_TIER).activate()


def port():
    return repro_torch.Database(device="cpu").activate()


def close(got, want, atol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=TOL, atol=atol,
    )


def close_scaled(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, atol=TOL * max(1.0, float(np.abs(want).max())))


def gap(got, want) -> float:
    """max |got − want| as a share of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def flat_ref(tree, sep="."):
    return {
        sep.join(str(getattr(k, "key", getattr(k, "idx", "?"))) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def close_tree(got, want):
    """Port caches against the reference's, unstacked into the port's
    layout by ``convert.lm_caches``: the same keys, shapes and dtypes."""

    def walk(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                walk(g[k], w[k])
        elif isinstance(w, list):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                walk(gi, wi)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            close_scaled(g, w.numpy())

    walk(got, convert.lm_caches(np_tree(want), "cpu"))


def grads_match(jmodel, params, model, jbatch, batch):
    """The train loss (lm_loss + 0.01·aux) and every parameter's gradient,
    in both packages from the same weights and batch: the losses within
    TOL, each gradient within TOL of its largest entry (a stacked
    reference leaf against each of the port's unstacked ones). Returns the
    port's gradients by name."""

    def jloss(p):
        logits, aux = jmodel.train_logits(p, jbatch)
        return jax_lm_loss(logits, jbatch["labels"]) + 0.01 * aux

    with ref():
        want_loss, jg = jax.jit(jax.value_and_grad(jloss))(jax_tree(params))
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
    with port():
        logits, aux = model.train_logits(batch, leaves)
        loss = lm_loss(logits, batch["labels"]) + 0.01 * aux
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=TOL, atol=TOL)
    carried = dict(convert.lm_params(build_model(model.cfg, device="cpu"), np_tree(jg))
                   .named_parameters())
    assert sorted(carried) == sorted(got)
    for k in got:
        close_scaled(got[k], carried[k].detach().numpy())
    return got


def batch_pair(jcfg, cfg, b, s, seed=0):
    """The same ``batch_for`` batch from both packages (one rng draw order)."""
    from repro.data import batch_for as jax_batch_for
    from repro_torch.data import batch_for

    jb = jax_batch_for(jcfg, b, s, np.random.default_rng(seed))
    tb = batch_for(cfg, b, s, np.random.default_rng(seed), device="cpu")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert np.array_equal(np.asarray(jb[k]), tb[k].numpy()), k
    return jb, tb
