"""Training step factory.

``make_train_step(model)`` returns a (params, opt_state, batch) →
(params, opt_state, metrics) function, ``params`` a name → tensor dict
with the model's ``named_parameters()`` names, applied to the model as its
weights (``Model.train_logits(batch, params)``). Gradients flow through
the relational ``autograd.Function``s, i.e. the backward pass executes the
RA-autodiff-generated queries, which step through the staged engine
(core/engine.py): the FRA graphs are lowered once per signature and reused
across steps.

PyTorch runs eagerly, so the reference's ``jit`` has no analogue (it is
accepted and ignored), and its donation is an in-place update: with
``donate=True`` the step writes the new parameters and Adam moments into
the tensors it was given.

On a mesh (``mesh=``, or ``database.mesh``) the step runs every kind
(``launch.sharding.MESH_KINDS``, and qwen2-vl's vision prefix) tensor-,
expert- and fully-sharded data-parallel (``launch/sharding.py``): each
rank takes its shards of the parameters and the moments (cut where it is
given them whole) and its rows of the batch — cut over the ("pod",
"data") fold where the mesh has a pod axis — sums its gradients over the
data ranks (FSDP over "data", then every leaf over "pod"), clips to the
global norm of the whole gradient and updates its shards. A mesh given
by its axis sizes walks ``meta`` tensors only (``launch/dryrun.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.launch.sharding import DP, hint
from repro_torch.optim import adam_init, adam_update

from .losses import lm_loss, lm_nll


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_train_step(
    model,
    *,
    lr: float = 3e-4,
    aux_weight: float = 0.01,
    grad_clip: float = 1.0,
    jit: bool = True,
    donate: bool = False,
    mesh=None,
    database=None,
) -> Callable:
    """Build the train step once; the returned callable is reused every
    iteration.

    The loss is ``lm_loss + aux_weight·aux`` (aux the MoE's load-balance
    loss), the update Adam with the gradients clipped to global 2-norm
    ``grad_clip``. ``jit`` is accepted for the reference's signature and
    ignored: there is nothing to compile. ``donate=True`` updates the
    parameters and the moments in place (the caller rebinds both from the
    step's outputs, which are the same tensors); the step's results are
    bit-equal to ``donate=False``'s. ``database`` runs every step inside
    ``database.activate()``, so the relational ops in the model dispatch
    through that session.

    ``mesh`` (a DeviceMesh, or a ``launch.mesh.resolve_mesh`` spec string;
    default ``database.mesh``) places the step (module docstring): it
    returns the rank's shards of the parameters and moments, and the
    metrics of the whole batch. The loss is the one-device loss: each rank
    sums its rows' negative log-likelihoods over the whole batch's label
    count, and its rows' mean load-balance loss over the data ranks, so
    that the ranks' gradients sum to the whole batch's."""
    del jit
    if database is not None and mesh is None:
        mesh = database.mesh
    if isinstance(mesh, str):
        from repro_torch.launch.mesh import resolve_mesh

        dev = database.device if database is not None else model.device
        mesh = resolve_mesh(mesh, device_type=dev.type)
    if mesh is not None:
        step = _mesh_step(model, mesh, lr=lr, aux_weight=aux_weight, grad_clip=grad_clip,
                          donate=donate)
        return step if database is None else _sessioned(step, database)

    def loss_fn(params, batch):
        logits, aux = model.train_logits(batch, params)
        loss = lm_loss(logits, batch["labels"])
        total = loss + aux_weight * aux
        return total, {"loss": loss, "aux": aux}

    def train_step(params: Dict[str, torch.Tensor], opt_state, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total, metrics = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        del leaves
        params, opt_state = adam_update(
            params, grads, opt_state, lr=lr, grad_clip=grad_clip, donate=donate,
        )
        metrics = {k: v.detach() for k, v in dict(metrics, total=total).items()}
        return params, opt_state, metrics

    if database is None:
        return train_step
    return _sessioned(train_step, database)


def _sessioned(step, database):
    """``step`` run inside ``database.activate()``."""

    def sessioned_step(params, opt_state, batch):
        with database.activate():
            return step(params, opt_state, batch)

    return sessioned_step


def _mesh_step(model, mesh, *, lr, aux_weight, grad_clip, donate):
    """The train step of ``make_train_step`` on a mesh."""
    from repro_torch.launch.sharding import Placement

    place = model.placement
    if place is None or place.mesh is not mesh:
        place = Placement(model.cfg, mesh)
    rows = place.batch
    d = place.size(rows)

    def train_step(params, opt_state, batch):
        params = place.shard(params)
        opt_state = dict(opt_state, mu=place.shard(opt_state["mu"]), nu=place.shard(opt_state["nu"]))
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits, aux = model.train_logits(batch, leaves, place=place)
        with place.active():
            labels = hint(batch["labels"], DP, None)
        nll, count = lm_nll(logits, labels)
        # the count in the loss's dtype, which the division promotes it to
        loss = nll / torch.clamp(place.all_reduce(count.to(nll.dtype), rows), min=1)
        total = loss + aux_weight * aux / d
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        del leaves, logits
        grads = place.sync_grads(grads)
        params, opt_state = adam_update(
            params, grads, opt_state, lr=lr, grad_clip=grad_clip, donate=donate,
            grad_norm=place.grad_norm,
        )
        with torch.no_grad():
            loss = place.all_reduce(loss.detach(), rows)
            aux = place.all_reduce(aux.detach(), rows) / d
            metrics = {"loss": loss, "aux": aux, "total": loss + aux_weight * aux}
        return params, opt_state, metrics

    return train_step


def init_train_state(model, dtype=None) -> TrainState:
    """The model's parameters as a name → tensor dict (the module's own
    tensors: a donated step updates the model) and zero Adam moments in
    ``dtype`` (default ``cfg.opt_state_dtype``). The reference's ``key``
    draws the weights; here ``build_model``'s seed has drawn them."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt_dtype = getattr(torch, dtype or model.cfg.opt_state_dtype)
    return TrainState(params, adam_init(params, dtype=opt_dtype))
