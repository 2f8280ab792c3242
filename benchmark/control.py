"""The control: the plain reference put in the program's place, computed in
the precision below the one the configuration states (float8 operands,
scaled by their largest magnitude, for the training's bf16 levels). It
answers the calls the training kind makes of the program's Engine, so a
run with it in place goes through the same set-up, window and check; the
check must then come out not correct. ``benchmark/calibrate.py`` reads it
on the card; the tests read it at a small size."""

from __future__ import annotations

import contextlib
import types

import torch

from benchmark import common
from benchmark.reference import training


class Control:
    """An Engine of the reference: ``train_step``, the parameters and the
    optimizer state the training check reads (torch's Adam), and zero
    capacity counters (the reference refuses a batch beyond them)."""

    def __init__(self, cfg, state_dict, device, narrow_dtype):
        self.cfg, self.narrow = cfg, narrow_dtype
        params = {k: v.detach().clone() for k, v in training.parameters(state_dict).items()}
        opt = torch.optim.Adam(list(params.values()), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.state = types.SimpleNamespace(params=params, optimizer=opt)
        zero = torch.zeros(1, dtype=torch.long, device=device)
        self.last_voxel_stats = {k: zero for k in common.BACKBONE_COUNTERS}

    def train_step(self, batch, epoch, generator):
        lr = training.learning_rate(self.cfg, epoch)
        with training.precision(tf32=False):
            loss, grads = training.step(self.cfg, self.state.params, batch, self.narrow)
        opt = self.state.optimizer
        for group in opt.param_groups:
            group["lr"] = lr
        for k, p in self.state.params.items():
            p.grad = grads[k]
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss, {}, lr


@contextlib.contextmanager
def in_place_of_program(narrow_dtype=torch.float8_e4m3fn):
    """Within: every engine a traffic kind makes is the control."""
    made = common.engine

    def engine(run, section):
        sd = common.weights.state_dict(run.namespace(section), run.seed, run.device,
                                       bias=run.config.get("weights", {}).get("bias"))
        return Control(run.namespace(section), sd, run.device, narrow_dtype), sd

    common.engine = engine
    try:
        yield
    finally:
        common.engine = made
