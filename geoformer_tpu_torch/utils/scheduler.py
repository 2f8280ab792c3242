"""LR schedules (reference util/utils_scheduler.py:7-35, util/utils.py:33-37).

The port's copy of geoformer_tpu/utils/scheduler.py (pure Python, kept name
for name).

Two-phase training: `cosine_lr_after_step` during the prepare phase and
warmup+cosine afterwards (train.py:53-56).
"""

from __future__ import annotations

import math


def adjust_learning_rate(base_lr, warm_lr, final_lr, warm_epochs, total_epochs, epoch):
    """Warmup from warm_lr then cosine to final_lr (utils_scheduler.py:7-35)."""
    if epoch < warm_epochs and warm_epochs > 0:
        return warm_lr + epoch / warm_epochs * (base_lr - warm_lr)
    t = (epoch - warm_epochs) / max(total_epochs - warm_epochs, 1)
    return final_lr + 0.5 * (base_lr - final_lr) * (1 + math.cos(t * math.pi))


def cosine_lr_after_step(base_lr, epoch, step_epoch, total_epochs, clip=1e-6):
    """util/utils.py:33-37: flat until step_epoch, then cosine decay."""
    if epoch < step_epoch:
        return base_lr
    return max(
        clip,
        0.5 * base_lr * (1 + math.cos((epoch - step_epoch) / max(total_epochs - step_epoch, 1) * math.pi)),
    )


# ---- scheduler zoo (reference solver.py:7-74, unused by the shipped
# configs but part of the public surface) ----

def step_lr(base_lr, epoch, step_epoch, multiplier=0.1):
    """Decay by `multiplier` every `step_epoch` epochs."""
    return base_lr * multiplier ** (epoch // max(step_epoch, 1))


def multi_step_lr(base_lr, epoch, milestones, gamma=0.1):
    """Decay by gamma at each milestone epoch."""
    return base_lr * gamma ** sum(1 for m in milestones if epoch >= m)


def poly_lr(base_lr, epoch, total_epochs, power=0.9):
    """Polynomial decay to 0 at total_epochs."""
    return base_lr * (1 - min(epoch / max(total_epochs, 1), 1.0)) ** power


def exp_lr(base_lr, epoch, gamma=0.95):
    """Exponential decay."""
    return base_lr * gamma ** epoch


def get_scheduler(name: str):
    """Name -> schedule fn, for cfg.lr_scheduler dispatch."""
    return {
        "cosine": adjust_learning_rate,
        "cosine_after_step": cosine_lr_after_step,
        "step": step_lr,
        "multi_step": multi_step_lr,
        "poly": poly_lr,
        "exp": exp_lr,
    }[name]
