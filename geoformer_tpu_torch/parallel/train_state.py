"""The trainer's state: optimizer with module freezing, per-step learning
rate and gradient accumulation (port of
geoformer_tpu/parallel/train_state.py).

The JAX package builds an optax multi_transform of Adam (no weight decay) or
SGD with momentum and decayed weights added before the momentum, under
``inject_hyperparams`` for the learning rate and, with ``grad_accum_steps``
> 1, ``optax.MultiSteps``. Here the same updates come from
``torch.optim.Adam`` / ``torch.optim.SGD``:

* a frozen top-level module (``cfg.fix_module`` through ``_FIX_NAME_MAP``)
  is left out of the optimizer: no update and no optimizer state, as optax's
  ``MaskedNode`` keeps none; its parameters take no gradient;
* a trainable parameter that the step's loss did not reach gets a zero
  gradient, as JAX's gradient of the whole tree gives it (Adam's moments
  still decay);
* ``grad_accum_steps`` = k: the running mean of k micro-step gradients,
  one update on the k-th micro-step, the parameters unchanged in between;
* under a mesh of N ranks (parallel/mesh.py), one all-reduce of
  the SUM of the trainable gradients over every rank, flattened into one buffer, before
  each update: the losses are normalised over the global batch
  (losses/), so the sum is the global batch's gradient, as SPMD's
  implicit psum makes it in the JAX package (DDP's mean would be N times
  too small). Every trainable parameter takes part, with zeros where the
  step's loss did not reach it, so every rank reduces the same buffer; the
  frozen modules are in no rank's buffer. On a ("data", "model") mesh
  each rank's gradient is that of its own part of the global loss (its
  queries' terms, and the terms its model group computes alike on model
  index 0 only), so the same sum over every rank is the global gradient.
  With accumulation the reduction
  runs once, at the update, on the window's mean (the mean of the ranks'
  sums is the sum of their means). No ``DistributedDataParallel``: its
  module wrapping does not fit the frozen modules, the remat and the
  phase-dependent graph (``semantic_only``).

``weights.opt_state_to_jax`` / ``opt_state_from_jax`` carry this state to and
from the optax state tree of a JAX checkpoint.
"""

from __future__ import annotations

import torch

from geoformer_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

# cfg.fix_module names -> the model's top-level modules
_FIX_NAME_MAP = {
    "input_conv": ["backbone"],
    "unet": ["backbone"],
    "output_layer": ["backbone"],
    "semantic": ["semantic"],
    "semantic_linear": ["semantic"],
    "mask_tower": ["mask_tower0", "mask_tower1", "mask_tower2", "mask_out"],
    "controller": ["controller_head"],
    "set_aggregator": ["set_aggregator"],
    "pos_embedding": ["pos_embedding"],
    "query_projection": ["query_projection"],
    "decoder": ["decoder"],
    "encoder_to_decoder_projection": ["encoder_to_decoder_projection"],
    "similarity_net": ["similarity_net"],
}


def frozen_toplevel_names(fix_module) -> set[str]:
    out: set[str] = set()
    for name in fix_module:
        out.update(_FIX_NAME_MAP.get(name, [name]))
    return out


class TrainState:
    """Optimizer, accumulation buffers and step counter of one model.

    ``step`` counts micro-steps (the JAX TrainState's ``step``),
    ``gradient_step`` the updates made under accumulation, ``mini_step``
    the micro-step within the current accumulation window."""

    def __init__(self, cfg, model: torch.nn.Module, mesh: Mesh | None = None):
        self.model = model
        self.mesh = mesh
        self.optim_name = cfg.optim.lower()
        self.frozen = frozen_toplevel_names(cfg.fix_module)
        self.params = {}
        for name, p in model.named_parameters():
            trainable = name.split(".")[0] not in self.frozen
            p.requires_grad_(trainable)
            if trainable:
                self.params[name] = p
        if self.optim_name == "adam":
            self.optimizer = torch.optim.Adam(list(self.params.values()), lr=cfg.lr,
                                              betas=(0.9, 0.999), eps=1e-8)
        else:
            self.optimizer = torch.optim.SGD(list(self.params.values()), lr=cfg.lr,
                                             momentum=cfg.momentum,
                                             weight_decay=cfg.weight_decay)
        self.hyper = {"momentum": float(cfg.momentum), "weight_decay": float(cfg.weight_decay)}
        self.lr = float(cfg.lr)
        self.updates = 0  # inner optimizer updates (optax's inject_hyperparams count)
        self.step = 0
        self.accum = int(getattr(cfg, "grad_accum_steps", 1) or 1)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc_grads = ({k: torch.zeros_like(p) for k, p in self.params.items()}
                          if self.accum > 1 else None)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def set_lr(self, lr: float) -> None:
        self.lr = float(lr)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """The trainable gradients summed over every rank of the mesh, in one
        all-reduce of one flat buffer (per dtype); nothing without a process
        group."""
        if self.mesh is None or self.mesh.group is None:
            return
        by_dtype = {}
        for p in self.params.values():
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), self.mesh,
                                  axis="all", site="gradients")
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    @torch.no_grad()
    def apply_gradients(self, lr: float) -> None:
        """One micro-step after ``loss.backward()``: an update at ``lr``, or
        with accumulation the gradients' running mean (and an update of it on
        the last micro-step of the window)."""
        self.set_lr(lr)
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accum == 1:
            self.reduce_gradients()
            self.optimizer.step()
            self.updates += 1
        else:
            n = self.mini_step
            for k, p in self.params.items():
                acc = self.acc_grads[k]
                acc.add_((p.grad - acc) / (n + 1))
            if n == self.accum - 1:
                for k, p in self.params.items():
                    p.grad.copy_(self.acc_grads[k])
                self.reduce_gradients()
                self.optimizer.step()
                self.updates += 1
                self.gradient_step += 1
                for acc in self.acc_grads.values():
                    acc.zero_()
            self.mini_step = (n + 1) % self.accum
        self.zero_grad()
        self.step += 1
