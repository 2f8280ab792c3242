"""Port K3 (row gather) vs JAX.

The plain version (geoformer_tpu_torch/kernels/row_gather.py) is held
exactly against the TPU probe's own inputs and answer: the four Pallas probe
kernels of tools/pallas_gather_probe.py in interpret mode and ``jnp.take``,
and against numpy's ``x[idx]`` on the corner cases of the kernel's design
(``kernels/edge_cases.py:gather_cases``). A gather moves bits, so every
comparison is exact (no tolerance). The CUDA kernel is held against the
plain version on the card on those cases (marker ``cuda``). JAX is
imported inside the CPU tests, so that the card tests also run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gather.py
"""

import numpy as np
import pytest
import torch

from geoformer_tpu_torch.kernels.edge_cases import gather_cases, gather_table
from geoformer_tpu_torch.kernels.row_gather import row_gather, row_gather_plain
from geoformer_tpu_torch.tools import gather_probe


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def test_probe_inputs_are_the_tpu_probes_and_plain_matches_take():
    """Same seed-0 inputs as the TPU probe; all four Pallas forms answer OK
    on them (interpret mode), and the plain version equals jnp.take bit for
    bit, with [N,1] and with [N] ids."""
    import jax.numpy as jnp

    from tools import pallas_gather_probe

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


@pytest.mark.parametrize("p,q,n,misaligned", [
    pytest.param(50, 7, 33, False, id="50-7-33"),
    pytest.param(9, 1, 40, False, id="9-1-40"),
    pytest.param(64, 12, 5, False, id="64-12-5"),
    pytest.param(17, 130, 17, False, id="17-130-17"),
    pytest.param(40, 16, 60, True, id="40-16-60-misaligned"),
    pytest.param(1, 3, 1, True, id="1-3-1-misaligned"),
])
def test_plain_moves_bits_at_any_width(p, q, n, misaligned):
    """Widths that are no multiple of 4, repeated ids, NaN payloads and -0.0,
    tables that start off a 16-byte boundary (``gather_table``): the rows
    come out bit for bit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(p * 1000 + q)
    x = rng.normal(size=(p, q)).astype(np.float32)
    x.reshape(-1).view(np.uint32)[::3] |= 0x7FC00123  # NaNs with a payload
    x[p // 2] = -0.0
    idx = rng.integers(0, p, size=(n,)).astype(np.int32)
    t = gather_table(x, misaligned, "cpu")
    assert (t.data_ptr() % 16 != 0) == misaligned
    got = row_gather_plain(t, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(x[idx]))
    want = np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(_bits(got), _bits(want))


CASES = {name: (x, idx, misaligned) for name, x, idx, misaligned in gather_cases()}


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
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(cuda, case):
    """The kernel bit-equal to the plain version on each corner case (every
    width class on either side of the rows-a-thread threshold, misaligned
    views, n = 1, P = 1, ids 0 and P - 1, repeated ids, NaN payloads), one
    launch counted a call."""
    x, idx, misaligned = CASES[case]
    x, idx = gather_table(x, misaligned, cuda), torch.from_numpy(idx).to(cuda)
    want = row_gather_plain(x, idx).view(torch.int32)
    before = row_gather.launches
    out = row_gather(x, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(out.view(torch.int32), want)


@pytest.mark.cuda
def test_kernel_on_card_refuses_what_it_cannot_take(cuda):
    """The probe answers OK on the card; a strided table (which would need a
    hidden copy), a float64 table and int64 ids raise, and launch nothing."""
    assert gather_probe.run_probe() == {"row_gather": "OK", "plain": "OK"}
    x = torch.randn(4, 16, device=cuda)
    idx = torch.tensor([3, 0], dtype=torch.int32, device=cuda)
    before = row_gather.launches
    for bad_x, bad_idx in ((x[:, :8], idx), (x.double(), idx), (x, idx.long())):
        with pytest.raises(ValueError):
            row_gather(bad_x, bad_idx)
    assert row_gather.launches == before
