"""Port parity for the multi-device paths: x265_tpu_torch against
x265_tpu on the same inputs, made from seeds with numpy, on the CPU.

GOP chains: the port's encode_chains on the mesh ["cpu", "cpu"] against
the reference's on a 2-device mesh of tests/conftest.py's 8 virtual CPU
devices, 64x64, two chains of one P frame each after their own I frame,
deblock on, SAO off, computed once in a module fixture (the reference's
chain program is the one this file compiles): every syntax field and
recon sample equal, the per-chain rate estimates within 1e-6 relative,
the total within the reference's own 1e-3 of their sum; each chain's
stream equal to its single-device encode. Also shared_rc_step against
the reference's, the mesh's device list, and the B-layer fan-out
(encode_bframes_gpu(mesh=["cpu"] * 2) equal to the single-device batch;
an untiled layer refused). Tolerance: exact equality unless stated."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from chip_smoke import chain_streams
from test_multichip import _chain
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc.ratecontrol import RateControl as RefRateControl
from x265_tpu.parallel import gop_sharding as ref_gs
from x265_tpu_torch.common.params import EncoderConfig
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc.bframe_gpu import encode_bframes_gpu
from x265_tpu_torch.enc.intra_recon import ReconFrame
from x265_tpu_torch.enc.ratecontrol import RateControl
from x265_tpu_torch.parallel import gop_sharding as port_gs

torch.set_num_threads(2)

H = W = 64
MESH = ["cpu", "cpu"]


def _record_sharded(module):
    """Wrap module.encode_chains_sharded so that its return value (with
    the per-chain rates, which encode_chains does not return) is kept."""
    real = module.encode_chains_sharded
    seen = []

    def recording(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    return recording, seen


@pytest.fixture(scope="module")
def chains():
    """Both packages' encode_chains on the same two chains: (reference
    (out, total, sharded result), port (...), chains, config)."""
    if jax.device_count() < 2:
        pytest.skip("needs tests/conftest.py's virtual CPU devices")
    rcfg = RefConfig(width=W, height=H, qp=30, deblock=True, sao=False)
    chains = []
    for ci in range(2):
        frames = _chain(H, W, 2, seed=ci)
        r0 = RefEncoder(rcfg).encode_frame(*frames[0])
        chains.append((frames[1:], r0.recon))
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for module, run in (
                (ref_gs, lambda: ref_gs.encode_chains(
                    chains, rcfg, mesh=ref_gs.make_gop_mesh(2))),
                (port_gs, lambda: port_gs.encode_chains(
                    chains, cfg, mesh=port_gs.make_gop_mesh(devices=MESH)))):
            recording, seen = _record_sharded(module)
            mp.setattr(module, "encode_chains_sharded", recording)
            res, total = run()
            out.append((res, total, seen[0]))
    return out[0], out[1], chains, cfg


FIELDS = ("depth8", "mv8", "coeff_y", "coeff_cb", "coeff_cr", "sao_params",
          "intra8", "mode8", "tusplit8", "ref8")


@pytest.mark.parametrize("field", FIELDS)
def test_chain_syntax_matches_reference(chains, field):
    (ref, _, _), (port, _, _), _, _ = chains
    for (rs, _), (ps, _) in zip(ref, port):
        for a, b in zip(rs, ps):
            x, y = getattr(a, field), getattr(b, field)
            if x is None or y is None:
                assert x is None and y is None
            else:
                np.testing.assert_array_equal(x, y)


def test_chain_recon_matches_reference(chains):
    (ref, _, _), (port, _, _), _, _ = chains
    for (_, rr), (_, pr) in zip(ref, port):
        for a, b in zip(rr, pr):
            for k in ("y", "cb", "cr"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("k", range(11))
def test_chain_sharded_arrays_match_reference(chains, k):
    """encode_chains_sharded's result arrays, in the reference's layout:
    the fields, the coefficient and recon stacks, and the final
    references."""
    (_, _, (rres, rfinal, _, _)), (_, _, (pres, pfinal, _, _)), _, _ = chains
    a, b = np.asarray(rres[k]), pres[k]
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    if k < 3:
        np.testing.assert_array_equal(np.asarray(rfinal[k]), pfinal[k])


def test_chain_rates_match_reference(chains):
    (_, rtotal, (_, _, _, rrates)), (_, ptotal, (_, _, _, prates)), _, _ = \
        chains
    rrates = np.asarray(rrates)
    assert prates.dtype == np.float32 and prates.shape == (2,)
    np.testing.assert_allclose(prates, rrates, rtol=1e-6)
    assert abs(ptotal - float(prates.sum())) <= 1e-3 * max(ptotal, 1)
    assert abs(ptotal - rtotal) <= 1e-3 * max(rtotal, 1)


def test_chain_streams_equal_single_device_encodes(chains):
    """Each chain's CABAC-coded records equal the stream of its own
    encode on one device (the chain configuration's encoder, from the
    chain's I recon)."""
    _, (port, _, _), chain_list, cfg = chains
    for (frames, ref), (syns, recons) in zip(chain_list, port):
        enc = IntraEncoder(port_gs.chain_config(cfg), device="cpu")
        enc.ref = ReconFrame(*(np.asarray(p) for p in (ref.y, ref.cb,
                                                        ref.cr)))
        want = [r.bitstream for r in enc.encode_pgop(frames)]
        assert chain_streams(syns, recons, cfg) == want


def test_shared_rc_step_matches_reference():
    rcfg = RefConfig(width=W, height=H, qp=30, rc_mode="abr", bitrate=500)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    rrc, prc = RefRateControl(rcfg), RateControl(cfg)
    for rate, n in ((12345.5, 4), (3.0e5, 2), (777.0, 8)):
        want = ref_gs.shared_rc_step(rrc, rate, n, 30)
        assert port_gs.shared_rc_step(prc, rate, n, 30) == want


def test_make_gop_mesh():
    assert port_gs.make_gop_mesh(devices=MESH) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="devices given"):
        port_gs.make_gop_mesh(3, devices=MESH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            port_gs.make_gop_mesh(2)


def _b_layer():
    """A 64x64 layer of four B frames between an I and a P picture
    (test_multichip.py's B-layer fan-out case), port only."""
    cfg = EncoderConfig(width=W, height=H, qp=30, deblock=True, bframes=2)
    frames = _chain(H, W, 6, seed=3)
    enc = IntraEncoder(cfg, device="cpu")
    r0 = enc.encode_frame(*frames[0])
    enc.ref = r0.device_ref
    r1 = enc.encode_pgop([frames[5]])[0]
    return cfg, frames[1:5], [r0.device_ref] * 4, [r1.recon] * 4


def test_b_layer_fan_out_equals_single_device():
    cfg, layer, ref0s, ref1s = _b_layer()
    one = encode_bframes_gpu(layer, ref0s, ref1s, cfg, 32, device="cpu")
    fan = encode_bframes_gpu(layer, ref0s, ref1s, cfg, 32, mesh=MESH)
    assert len(fan[0]) == len(one[0]) == 4
    for sa, sb in zip(one[0], fan[0]):
        for f in ("depth8", "mv8", "pf8", "coeff_y", "coeff_cb", "coeff_cr"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    for ra, rb in zip(one[1], fan[1]):
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k))
    for da, db in zip(one[2], fan[2]):
        assert torch.equal(da.y, db.y)


def test_b_layer_fan_out_refuses_an_untiled_layer():
    cfg, layer, ref0s, ref1s = _b_layer()
    with pytest.raises(ValueError, match="do not tile"):
        encode_bframes_gpu(layer[:3], ref0s[:3], ref1s[:3], cfg, 32,
                           mesh=MESH)
