"""Port K3 (row gather) vs JAX.

The plain version (geoformer_tpu_torch/kernels/row_gather.py) is held
exactly against the TPU probe's own inputs and answer: the four Pallas probe
kernels of tools/pallas_gather_probe.py in interpret mode and ``jnp.take``.
A gather moves bits, so every comparison is exact (no tolerance). The CUDA
kernel is held against the plain version on the card (marker ``cuda``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from geoformer_tpu_torch.kernels.row_gather import row_gather, row_gather_plain
from geoformer_tpu_torch.tools import gather_probe
from tools import pallas_gather_probe


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def test_probe_inputs_are_the_tpu_probes_and_plain_matches_take():
    """Same seed-0 inputs as the TPU probe; all four Pallas forms answer OK
    on them (interpret mode), and the plain version equals jnp.take bit for
    bit, with [N,1] and with [N] ids."""
    x, idx = gather_probe.probe_inputs()
    assert x.shape == (512, 128) and idx.shape == (256, 1) and idx.dtype == np.int32
    rng = np.random.default_rng(0)  # pallas_gather_probe.run_probe's draws
    np.testing.assert_array_equal(x, rng.normal(size=(512, 128)).astype(np.float32))
    np.testing.assert_array_equal(idx, rng.integers(0, 512, size=(256, 1)).astype(np.int32))

    res = pallas_gather_probe.run_probe(interpret=True)
    assert res == {name: "OK" for name in pallas_gather_probe.KERNELS}

    want = np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx[:, 0]), axis=0))
    for ids in (idx, idx[:, 0]):
        got = row_gather(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
        assert got.shape == (256, 128)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("p,q,n", [(50, 7, 33), (9, 1, 40), (64, 12, 5), (17, 130, 17)])
def test_plain_moves_bits_at_any_width(p, q, n):
    """Widths that are no multiple of 4, repeated ids, NaN payloads and -0.0:
    the rows come out bit for bit."""
    rng = np.random.default_rng(p * 1000 + q)
    x = rng.normal(size=(p, q)).astype(np.float32)
    x.reshape(-1).view(np.uint32)[::3] |= 0x7FC00123  # NaNs with a payload
    x[1] = -0.0
    idx = rng.integers(0, p, size=(n,)).astype(np.int32)
    got = row_gather_plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(x[idx]))
    want = np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_run_probe_on_cpu_and_without_a_card():
    assert gather_probe.run_probe("cpu") == {"row_gather": "OK", "plain": "OK"}
    assert gather_probe.main(["--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            gather_probe.run_probe()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,n", [(512, 128, 256), (1000, 7, 333), (250000, 16, 131072)])
def test_kernel_matches_plain_on_card(cuda, p, q, n):
    g = torch.Generator().manual_seed(p + q)
    x = torch.randn(p, q, generator=g)
    x.view(torch.int32).reshape(-1)[::3] |= 0x7FC00123
    idx = torch.randint(0, p, (n, 1), generator=g, dtype=torch.int32)
    x, idx = x.to(cuda), idx.to(cuda)
    before = row_gather.launches
    out = row_gather(x, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(out.view(torch.int32), row_gather_plain(x, idx).view(torch.int32))
    assert gather_probe.run_probe() == {"row_gather": "OK", "plain": "OK"}
    with pytest.raises(ValueError):  # a strided table would need a hidden copy
        row_gather(torch.cat([x, x], dim=1)[:, :q], idx)
