"""Training steps of the prepare phase, written out: the backbone's forward
in training mode (``backbone.Backbone``), the semantic cross-entropy (the
mean over the valid points whose label is not ``ignore_label``), its
gradients by autograd, and Adam (betas 0.9 and 0.999, eps 1e-8, no weight
decay) at the learning rate of the prepare phase's schedule. Every
parameter of the model is a leaf here, those the loss does not reach with
a zero gradient; a state dict's batch-norm statistics and Fourier basis
(``mean``, ``var``, ``gauss_B``) are not parameters."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from benchmark.reference.backbone import Backbone

BUFFERS = ("mean", "var", "gauss_B")


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 matmuls in full float32 (TF32 off), or in TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def parameters(state_dict: dict) -> dict:
    return {k: v for k, v in state_dict.items() if k.rsplit(".", 1)[-1] not in BUFFERS}


def learning_rate(cfg, epoch: int) -> float:
    """The prepare phase's: flat at ``lr`` until ``prepare_epochs``, then a
    half cosine to the last epoch, never under 1e-6."""
    if epoch < cfg.prepare_epochs:
        return cfg.lr
    t = (epoch - cfg.prepare_epochs) / max(cfg.epochs - cfg.prepare_epochs, 1)
    return max(1e-6, 0.5 * cfg.lr * (1 + math.cos(t * math.pi)))


def semantic_loss(cfg, out: dict, batch: dict) -> torch.Tensor:
    labels = batch["labels"].reshape(-1)[out["flat"]]
    keep = labels != cfg.ignore_label
    return F.cross_entropy(out["semantic_scores"][keep], labels[keep])


class Adam:
    def __init__(self, params: dict, betas=(0.9, 0.999), eps=1e-8):
        self.params, (self.b1, self.b2), self.eps, self.t = params, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p -= lr * m_hat / (v_hat.sqrt() + self.eps)


def step(cfg, params: dict, batch: dict, narrow=None) -> tuple:
    """One forward and backward -> (loss, {leaf: gradient})."""
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    loss = semantic_loss(cfg, Backbone(cfg, params, narrow)(batch), batch)
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    for p in params.values():
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), grads


def train_steps(cfg, state_dict: dict, batches: list, epoch: int, dropout_seed: int,
                narrow=None):
    """Steps over ``batches`` in order from the weights of ``state_dict``,
    the dropout masks from the default generator seeded by
    ``dropout_seed`` -> (losses [float], the first step's gradients, the
    parameters after the last step)."""
    if epoch > cfg.prepare_epochs:
        raise ValueError("the reference covers the prepare phase only")
    params = {k: v.detach().clone().float() for k, v in parameters(state_dict).items()}
    adam = Adam(params)
    lr = learning_rate(cfg, epoch)
    torch.manual_seed(int(dropout_seed))
    losses, first = [], None
    for batch in batches:
        loss, grads = step(cfg, params, batch, narrow)
        first = grads if first is None else first
        adam.step(grads, lr)
        losses.append(float(loss))
    return losses, first, {k: p.detach().clone() for k, p in params.items()}
