"""Faults planted in the program for the check to catch (the harness's
tests, and ``calibrate.py``'s readings of what a fault reads): each is a
context within which the port's Engine misbehaves in one way."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(name: str, make):
    from geoformer_tpu_torch.engine import Engine

    orig = getattr(Engine, name)
    setattr(Engine, name, make(orig))
    try:
        yield
    finally:
        setattr(Engine, name, orig)


def state_unchanged():
    """A training step that computes its loss and leaves the parameters
    and the optimizer as they were."""
    def make(orig):
        def train_step(self, batch, epoch, generator, **kw):
            if self.state is None:
                self.init_state()
            apply = self.state.apply_gradients
            self.state.apply_gradients = lambda lr: self.state.zero_grad()
            try:
                return orig(self, batch, epoch, generator, **kw)
            finally:
                self.state.apply_gradients = apply
        return train_step
    return _patched("train_step", make)


def half_batch():
    """A training step over the first half of the batch's scenes, its loss
    the mean over those."""
    def make(orig):
        def train_step(self, batch, epoch, generator, **kw):
            half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
            return orig(self, half, epoch, generator, **kw)
        return train_step
    return _patched("train_step", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
