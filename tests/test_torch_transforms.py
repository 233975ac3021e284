"""Port parity: x265_tpu_torch.ops.transforms against x265_tpu.ops.transforms
(lanes and batch forms, sizes 4-32) on seeded integers. Tolerance:
exact equality — the transforms are integer."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265_tpu.ops import transforms as ref
from x265_tpu_torch.ops import transforms as port

torch.set_num_threads(2)

SIZES = (4, 8, 16, 32)


def _resi(b, n, seed, lanes=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(-255, 256, (b, n, n)).astype(np.int32)
    return np.ascontiguousarray(a.transpose(1, 2, 0)) if lanes else a


def _eq(jx, tt):
    np.testing.assert_array_equal(np.asarray(jx), tt.numpy())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("qp", (22, 29, 37))
def test_batch_pipeline(n, qp):
    """dct -> quant (+ remainders) -> sign hiding -> dequant -> idct,
    block-major (B, N, N), per-block scan selection."""
    resi = _resi(24, n, seed=n * 100 + qp)
    dst = n == 4
    tj = ref.dct_batch(jnp.asarray(resi), n, 8, dst=dst)
    tt = port.dct_batch(torch.from_numpy(resi), n, 8, dst=dst)
    _eq(tj, tt)
    for intra in (True, False):
        lj, duj = ref.quant_batch(tj, n, qp, 8, intra=intra, with_rem=True)
        lt, dut = port.quant_batch(tt, n, qp, 8, intra=intra, with_rem=True)
        _eq(lj, lt)
        _eq(duj, dut)
    sel = np.random.default_rng(qp).integers(0, 3, 24).astype(np.int32)
    shj = ref.sign_hide_batch(lj, n, jnp.asarray(sel), duj)
    sht = port.sign_hide_batch(lt, n, torch.from_numpy(sel), dut)
    _eq(shj, sht)
    _eq(ref.sign_hide_batch(lj, n, 0, duj), port.sign_hide_batch(lt, n, 0,
                                                                  dut))
    dj = ref.dequant_batch(shj, n, qp, 8)
    dt = port.dequant_batch(sht, n, qp, 8)
    _eq(dj, dt)
    _eq(ref.idct_batch(dj, n, 8, dst=dst), port.idct_batch(dt, n, 8,
                                                           dst=dst))


@pytest.mark.parametrize("n", SIZES)
def test_lanes_pipeline(n):
    """The (N, N, B) lanes forms of the P-frame residual path."""
    qp = 32
    resi = _resi(20, n, seed=7 + n, lanes=True)
    tj = ref.dct_lanes(jnp.asarray(resi), n, 8)
    tt = port.dct_lanes(torch.from_numpy(resi), n, 8)
    _eq(tj, tt)
    lj, duj = ref.quant_lanes(tj, n, qp, 8, intra=False, with_rem=True)
    lt, dut = port.quant_lanes(tt, n, qp, 8, intra=False, with_rem=True)
    _eq(lj, lt)
    _eq(duj, dut)
    shj = ref.sign_hide_lanes(lj, n, 0, duj)
    sht = port.sign_hide_lanes(lt, n, 0, dut)
    _eq(shj, sht)
    dj = ref.dequant_lanes(shj, n, qp, 8)
    dt = port.dequant_lanes(sht, n, qp, 8)
    _eq(dj, dt)
    _eq(ref.idct_lanes(dj, n, 8), port.idct_lanes(dt, n, 8))


def test_inverse_transform_full_range():
    """The inverse transform at the coefficient extremes (the clip of
    both stages is exercised), against the numpy oracle too."""
    rng = np.random.default_rng(3)
    for n in SIZES:
        c = rng.integers(-32768, 32768, (6, n, n)).astype(np.int32)
        got = port.idct_batch(torch.from_numpy(c), n, 8)
        _eq(ref.idct_batch(jnp.asarray(c), n, 8), got)
        for b in range(2):
            np.testing.assert_array_equal(ref.idct_np(c[b]), got[b].numpy())


def test_per_block_qp_is_refused():
    """dQP vectors are not ported: a tensor QP raises."""
    with pytest.raises(NotImplementedError, match="item 15"):
        port.quant_batch(torch.zeros((1, 4, 4), dtype=torch.int32), 4,
                         torch.tensor([30]), 8)
