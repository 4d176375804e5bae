"""Faults planted in the timed path, to show that the comparison catches
them (``perfbench/tests``, and ``calibrate.py`` on the chip at the cells'
sizes). Each is a context manager that patches one seam and restores it."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def state_unchanged():
    """The optimizer step returns the parameters and its state unchanged."""
    import repro_torch.optim

    return _patched(repro_torch.optim, "adam_update", lambda params, grads, state, **kw: (params, state))


def half_batch():
    """The training loss leaves half of the nodes out and takes the mean
    over the rest."""
    from perfbench.entries import gcn_train

    def nll(z, y):
        n = z.shape[0] // 2
        return -torch.log_softmax(z[:n], dim=1).gather(1, y[:n, None]).mean()

    return _patched(gcn_train, "nll", nll)


def dropped_waves():
    """The streamed step runs only the first half of its waves."""
    from repro_torch.core.engine import StreamedCompiled

    run = StreamedCompiled._waves

    def first_half(self, resident, seed):
        for w, out in enumerate(run(self, resident, seed)):
            if w >= self.plan.num_waves // 2:
                break
            yield out

    return _patched(StreamedCompiled, "_waves", first_half)


def altered_answer():
    """The streamed step's dEdge has its largest entry negated."""
    from repro_torch.core.engine import StreamedCompiled

    call = StreamedCompiled.__call__

    def altered(self, env, seed=None):
        out, grads = call(self, env, seed)
        v = grads["Edge"].values
        i = int(v.abs().argmax())
        v[i] = -v[i]
        return out, grads

    return _patched(StreamedCompiled, "__call__", altered)
