"""Checkpoint save/load with tolerant partial restore (port of
geoformer_tpu/utils/checkpoint.py).

Checkpoints are the JAX package's flax msgpack files (weights.write_msgpack
/ read_msgpack), so either package resumes or evaluates the other's. A
training payload is ``{params, batch_stats, constants, opt_state, step,
epoch}``; ``align_and_update`` copies pretrained leaves by path suffix and
skips a shape mismatch (the few-shot model widens
encoder_to_decoder_projection from 2m to 6m).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from geoformer_tpu_torch.weights import (
    COLLECTIONS,
    checkpoint_tree,
    from_jax_variables,
    opt_state_from_jax,
    read_msgpack,
    to_jax_variables,
    write_msgpack,
)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path, state: dict) -> None:
    """state: a tree of dicts, arrays and Python scalars."""
    write_msgpack(path, state)


def load_checkpoint(path) -> dict:
    return read_msgpack(path)


def align_and_update(target: dict, loaded: dict, logger=None) -> dict:
    """Copy loaded leaves into target wherever the path suffix matches and
    shapes agree. Returns a new tree."""
    tflat = _flatten(target)
    lflat = _flatten(loaded)
    out = dict(tflat)
    n_loaded = 0
    for tkey in tflat:
        best = None
        if tkey in lflat:
            best = tkey
        else:
            # longest loaded key that is a suffix match
            cands = [lk for lk in lflat if lk.endswith("/" + tkey) or tkey.endswith("/" + lk)]
            if cands:
                best = max(cands, key=len)
        if best is None:
            continue
        lv, tv = lflat[best], tflat[tkey]
        if np.shape(lv) == np.shape(tv):
            out[tkey] = np.asarray(lv, dtype=np.asarray(tv).dtype)
            n_loaded += 1
        elif logger:
            logger.info(f"skip {tkey}: shape {np.shape(lv)} vs {np.shape(tv)}")
    if logger:
        logger.info(f"loaded {n_loaded}/{len(tflat)} tensors")
    return _unflatten(out)


def load_pretrain(model: torch.nn.Module, loaded: dict, logger=None) -> None:
    """train.py's ``--pretrain``: params and batch_stats aligned into the
    model's own, constants kept."""
    own = to_jax_variables(model)
    variables = {c: (align_and_update(own[c], loaded.get(c, {}), logger)
                     if c != "constants" else own[c]) for c in COLLECTIONS}
    model.load_state_dict(from_jax_variables(variables), strict=True)


def state_payload(state, epoch: int) -> dict:
    """Full training payload of a TrainState: weights, optimizer state,
    step counter and epoch."""
    return checkpoint_tree(state.model, epoch, state)


def restore_train_state(state, loaded: dict) -> None:
    """Exact resume, in place: weights, optimizer state and step counter."""
    own = to_jax_variables(state.model)
    variables = {c: loaded.get(c) or own[c] for c in COLLECTIONS}
    state.model.load_state_dict(from_jax_variables(variables), strict=True)
    state.step = int(loaded.get("step", 0))
    if "opt_state" in loaded:
        opt_state_from_jax(state, loaded["opt_state"])


def checkpoint_path(output_path: str, epoch: int | None = None) -> str:
    if epoch is None:
        return os.path.join(output_path, "checkpoint_last.ckpt")
    return os.path.join(output_path, f"checkpoint_epoch_{epoch}.ckpt")


def find_last_checkpoint(output_path: str) -> str | None:
    last = checkpoint_path(output_path)
    if os.path.exists(last):
        return last
    if not os.path.isdir(output_path):
        return None
    epochs = []
    for f in os.listdir(output_path):
        m = re.match(r"checkpoint_epoch_(\d+)\.ckpt", f)
        if m:
            epochs.append(int(m.group(1)))
    if not epochs:
        return None
    return checkpoint_path(output_path, max(epochs))
