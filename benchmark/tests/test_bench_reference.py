"""The plain reference: its voxel levels against a brute-force pairing of
voxels, and its training steps against the port's at a tiny size on the
same seeded weights and scans (float32 levels, where the two agree to
rounding, and the configuration's bf16 levels, where rounding in two
orders moves the later steps). On the CPU the port runs its kernels' plain
versions; the tests marked ``cuda`` run them on the card."""

import types

import numpy as np
import pytest
import torch

from benchmark import common, scenes, weights
from benchmark.reference import training, voxels
from benchmark.tests import tiny
from benchmark.traffic import train_steps


def _values(dtype):
    return dict(tiny.tiny_config("geoformer-scannet")["train"], tpu_compute_dtype=dtype)


def test_levels_pair_voxels_as_brute_force_does():
    values = dict(_values("float32"), tpu_max_points=500)
    batch = scenes.stack(scenes.scans(values, np.random.default_rng(3), 2))
    coords = torch.as_tensor(batch["coords"])
    levels, _, point_voxel, flat = voxels.build_levels(
        coords, torch.ones(coords.shape[:2], dtype=torch.bool), 3, 128)
    cells = [(b, tuple(c[::-1])) for b in range(2) for c in batch["coords"][b].tolist()]
    for lvl, level in enumerate(levels):
        rows = [(int(b), tuple(z.tolist())) for b, z in zip(level.scene, level.zyx)]
        want = sorted({(b, tuple(x >> lvl for x in c)) for b, c in cells})
        assert rows == want
        index = {r: i for i, r in enumerate(rows)}
        # every ordered pair of voxels of one scene whose cells differ by the offset
        scene = torch.tensor([r[0] for r in rows])
        zyx = torch.tensor([r[1] for r in rows])
        diff = zyx[None, :, :] - zyx[:, None, :]
        same = scene[:, None] == scene[None, :]
        for k, off in enumerate(voxels.OFFSETS):
            got = set(zip(level.subm[k][0].tolist(), level.subm[k][1].tolist()))
            hit = same & (diff == torch.tensor(off)).all(-1)
            assert got == set(map(tuple, torch.nonzero(hit).tolist()))
        if level.parent is not None:
            for i, (b, zyx) in enumerate(rows):
                assert levels[lvl + 1].zyx[level.parent[i]].tolist() == [x // 2 for x in zyx]
    level0 = sorted(set(cells))
    assert point_voxel.tolist() == [level0.index(c) for c in cells]
    assert flat.numel() == len(cells)


def _steps(device, dtype):
    from geoformer_tpu_torch.config import load_config
    from geoformer_tpu_torch.engine import Engine

    values = _values(dtype)
    ns = types.SimpleNamespace(**values)
    sd = weights.state_dict(ns, 3, device)
    eng = Engine(load_config(None, **values), device=device, state_dict=sd)
    g = np.random.default_rng(0)
    batches = [common.to_device(scenes.stack(scenes.scans(values, g, 2)), device)
               for _ in range(3)]
    torch.manual_seed(11)
    gen = torch.Generator(device=device).manual_seed(12)
    losses, grads1 = [], None
    for b in batches:
        losses.append(float(eng.train_step(b, 1, gen)[0]))
        if grads1 is None:
            opt = eng.state.optimizer
            grads1 = {k: opt.state[p]["exp_avg"] / 0.1 for k, p in eng.state.params.items()}
    narrow = torch.bfloat16 if dtype == "bfloat16" else None
    with training.precision(tf32=False):
        ref = training.train_steps(ns, sd, batches, 1, 11, narrow)
    run = types.SimpleNamespace(losses=losses, grads1=grads1, weights=sd,
                                params_after={k: p.detach() for k, p in
                                              eng.state.params.items()})
    return train_steps.compare(run, *ref)


# the widest gaps each comparison allows here: float32 agrees to rounding,
# bf16 levels round in two orders and Adam carries that into later steps
LIMITS = {"float32": {"first_loss": 1e-6, "loss": 1e-4, "first_grad": 0.02, "update": 0.05},
          "bfloat16": {"first_loss": 1e-4, "loss": 2e-3, "first_grad": 0.2, "update": 0.15}}


@pytest.mark.parametrize("dtype", sorted(LIMITS))
def test_training_steps_follow_the_port(dtype):
    gaps = _steps(torch.device("cpu"), dtype)
    assert all(gaps[k] <= lim for k, lim in LIMITS[dtype].items()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(LIMITS))
def test_training_steps_follow_the_port_on_the_card(card, dtype):
    gaps = _steps(card, dtype)
    assert all(gaps[k] <= lim for k, lim in LIMITS[dtype].items()), gaps
