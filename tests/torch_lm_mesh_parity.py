"""The reference's side of the language-model mesh tests
(tests/test_torch_lm_mesh*.py): its weights and its one-device steps for
a suite of ``tests/torch_lm_mesh_workers.py``, the ranks started meanwhile,
and the bound the tests hold the port to.

The bound. A mesh step sums the same f32 terms as the one-process step
in another order: each model rank's partial of a row-parallel
contraction (``wo``, ``out_proj``, ``x_proj``), of the experts' combine,
of the embedding's lookup and of the gated norm's Σy², then the ranks'
sums added; the data ranks' gradients added. The logits and each
gradient are held to TOL = 1e-5 of their tensor's largest entry (at least
1), the bound the parity tests hold the port to the reference by
(tests/torch_lm_parity.py: ``close_scaled``); the losses and global norms
to TOL relative. Reordering a sum of K ≤ 512 f32 terms moves it by about
√K·u ≈ 1.3e-6 of its terms' sizes, and the layers add a few of those. A
missing all-reduce leaves three quarters of a sum out and fails the bound
by orders of magnitude.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np

import repro
import torch_lm_mesh_workers as W
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train import lm_loss as jax_lm_loss
from repro_torch.launch.mesh import start_ranks

TOL = 1e-5


def jax_config(arch, suite):
    return jax_get_config(arch).reduced(**suite.overrides(arch))


def weights(suite):
    """The reference's weights of each of the suite's archs (numpy), from
    PRNGKey(0)."""
    out = {}
    for arch in suite.archs:
        jm = jax_build_model(jax_config(arch, suite))
        out[arch] = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return out


def start(name, weights_, *, one_rank=False):
    """(every rank's results of ``run_checks`` on 4 gloo ranks on the CPU,
    the reference's steps, and with ``one_rank`` the results of
    ``one_rank`` on a one-rank group), all computed at once."""
    suite = W.SUITES[name]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        started = pool.submit(start_ranks, W.run_checks, 4, backend="gloo", device="cpu",
                              args=(weights_, name))
        single = (pool.submit(start_ranks, W.one_rank, 1, backend="gloo", device="cpu", args=(name,))
                  if one_rank else None)
        ref = reference(weights_, suite)
        return started.result(), ref, None if single is None else single.result()[0]


def reference(weights_, suite):
    """The reference's one-device prefill and decode, loss, global norm
    and gradients, per arch."""
    out = {}
    for arch in suite.archs:
        cfg = jax_config(arch, suite)
        model = jax_build_model(cfg)
        params = jax.tree.map(jnp.asarray, weights_[arch])
        tokens, labels, fed = W.batch(cfg, suite=suite)
        with repro.Database(dispatch="ref").activate():
            logits, caches = model.prefill(params, {"tokens": jnp.asarray(tokens)}, suite.cache)
            steps = [np.asarray(logits)]
            for i in range(suite.decode):
                logits, caches = model.decode_step(params, jnp.asarray(fed[:, i:i + 1]), caches,
                                                   suite.s + i)
                steps.append(np.asarray(logits))

            def loss_fn(p):
                lg, aux = model.train_logits(p, {"tokens": jnp.asarray(tokens)})
                return jax_lm_loss(lg, jnp.asarray(labels)) + 0.01 * aux

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        grads = jax.tree.map(np.asarray, grads)
        norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                                 for g in jax.tree.leaves(grads))))
        out[arch] = {"logits": np.stack(steps), "loss": float(loss), "norm": norm, "grads": grads}
    return out


def close(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() <= TOL * max(1.0, np.abs(want).max())


def far(got, want, factor=1e3):
    """Whether ``got`` misses ``want`` by ``factor`` times the bound."""
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() > factor * TOL * max(1.0, np.abs(want).max())


def reference_grad(grads, name):
    """The reference's gradient of the port parameter ``name``."""
    from repro_torch.convert import reference_leaf

    path, repeat, _ = reference_leaf(name)
    node = grads
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node if repeat is None else node[repeat]


def train_misses(mesh, one, lr=W.LR):
    """What of a 2 × 2 train step ``mesh`` misses the one-process step
    ``one``: the loss and global norm within TOL relative, each gradient
    within the bound, and the new parameters within 2·lr everywhere and
    1e-3·lr where the gradient is clear of its rounding (test_torch_lm_mesh.py)."""
    bad = [k for k in ("loss", "total", "norm") if abs(mesh[k] - one[k]) > TOL * abs(one[k])]
    if sorted(mesh["grads"]) != sorted(one["grads"]):
        return bad + ["names"]
    for k, g in one["grads"].items():
        dp = np.abs(mesh["params"][k] - one["params"][k])
        clear = np.abs(g) >= 1e-4 * np.abs(g).max()
        if not close(mesh["grads"][k], g) or dp.max() > 2 * lr or (dp[clear] > 1e-3 * lr).any():
            bad.append(k)
    return bad


def reference_misses(mesh, ref):
    """What of a 2 × 2 train step ``mesh`` misses the reference's step."""
    bad = [k for k, r in (("total", "loss"), ("norm", "norm")) if abs(mesh[k] - ref[r]) > TOL * abs(ref[r])]
    return bad + [k for k, g in mesh["grads"].items() if not close(g, reference_grad(ref["grads"], k))]
