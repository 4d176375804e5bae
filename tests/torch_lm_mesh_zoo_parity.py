"""The reference's side of the mesh tests of whisper, qwen2-vl and a pod
axis (tests/test_torch_lm_mesh_{whisper,qwen2_vl,pod}.py): its weights
and its one-device steps for a suite of
``tests/torch_lm_mesh_zoo_workers.py`` — over whisper's frames (its
decode steps on ``_encode``'s output) or qwen2-vl's patches (its decode
at ``length = seq + vis_seq``) — with the ranks started meanwhile. The
bound is tests/torch_lm_mesh_parity.py's.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np

import repro
import torch_lm_mesh_zoo_workers as Z
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train import lm_loss as jax_lm_loss
from repro_torch.launch.mesh import start_ranks


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
    suite = Z.SUITES[name]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        started = pool.submit(start_ranks, Z.run_checks, 4, backend="gloo", device="cpu",
                              args=(weights_, name))
        single = (pool.submit(start_ranks, Z.one_rank, 1, backend="gloo", device="cpu", args=(name,))
                  if one_rank else None)
        ref = reference(weights_, suite)
        return started.result(), ref, None if single is None else single.result()[0]


def reference(weights_, suite):
    """The reference's one-device prefill and decode, loss, global norm
    and gradients, per arch (inputs as explicit float32/int32 arrays)."""
    out = {}
    for arch in suite.archs:
        cfg = jax_config(arch, suite)
        model = jax_build_model(cfg)
        params = jax.tree.map(jnp.asarray, weights_[arch])
        data = Z.batch(cfg, suite)
        extra = {k: jnp.asarray(data[k], jnp.float32) for k in ("frames", "patches") if k in data}
        tokens = jnp.asarray(data["tokens"], jnp.int32)
        vis = cfg.vis_seq or 0
        with repro.Database(dispatch="ref").activate():
            logits, caches = model.prefill(params, {"tokens": tokens, **extra}, suite.cache(cfg))
            steps = [np.asarray(logits)]
            enc = model._encode(params, extra["frames"]) if cfg.encoder_layers else None
            for i in range(suite.decode):
                tok = jnp.asarray(data["fed"][:, i:i + 1], jnp.int32)
                logits, caches = model.decode_step(params, tok, caches, suite.s + vis + i, enc)
                steps.append(np.asarray(logits))

            def loss_fn(p):
                lg, aux = model.train_logits(p, {"tokens": tokens, **extra})
                return jax_lm_loss(lg, jnp.asarray(data["labels"], jnp.int32)) + 0.01 * aux

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        grads = jax.tree.map(np.asarray, grads)
        norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                                 for g in jax.tree.leaves(grads))))
        out[arch] = {"logits": np.stack(steps), "loss": float(loss), "norm": norm, "grads": grads}
    return out
