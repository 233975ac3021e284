"""Port parity: one 2-frame P chunk of x265_tpu_torch.enc.pgop_gpu
against x265_tpu.enc.pgop_tpu, both predicting from the SAME reference
picture — the reference package's own I-frame reconstruction, carried
into the port by x265_tpu_torch.convert. Tolerance: exact equality of
every FramePSyntax field and recon sample."""

import dataclasses

import numpy as np
import torch

from x265_tpu.common import bit_calib as ref_calib
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc.pgop_tpu import encode_pgop_tpu
from x265_tpu.enc.weightp import analyse_gop_weights
from x265_tpu_torch.common import bit_calib as port_calib
from x265_tpu_torch.convert import config_from_dict, device_ref_from_numpy
from x265_tpu_torch.enc.pgop_gpu import collect_pgop_gpu, submit_pgop_gpu

torch.set_num_threads(2)

FIELDS = ("depth8", "mv8", "coeff_y", "coeff_cb", "coeff_cr", "intra8",
          "mode8", "tusplit8", "ref8", "sao_params", "qp_map", "max_merge")


def _clip(nf, h=64, w=96, seed=21):
    """A pan with a textured object entering from the right edge (new
    content, so intra competes in the P frames) and a luma fade (so the
    weightp weights are not neutral)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 5 + yy * 3) % 200 + 20).astype(np.int32)
    tex = rng.integers(0, 256, (h, w))
    frames = []
    for i in range(nf):
        y = np.roll(base, 3 * i, axis=1) + rng.integers(-5, 5, (h, w))
        edge = w - 10 * i
        y[16:48, edge:] = tex[16:48, edge:]
        y = np.clip(y * (1.0 - 0.06 * i), 0, 255).astype(np.uint8)
        cb = np.clip(110 + (xx[::2, ::2] >> 3) + 2 * i, 0, 255) \
            .astype(np.uint8)
        cr = np.clip(140 - (yy[::2, ::2] >> 2), 0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def test_p_chunk_matches_reference():
    frames = _clip(3)
    h, w = frames[0][0].shape
    rcfg = RefConfig(width=w, height=h, qp=32, deblock=True)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    enc = RefEncoder(rcfg)
    r0 = enc.encode_frame(*frames[0], qp=29, use_device_recon=True)
    wps = analyse_gop_weights(frames[1:], frames[0])
    wvecs = np.stack([wp.vec() for wp in wps])
    assert any(wp.luma_on for wp in wps)

    def stack(k):
        return np.stack([f[k] for f in frames[1:]])

    syns, recons, _ = encode_pgop_tpu(stack(0), stack(1), stack(2),
                                      r0.device_ref, rcfg, 32,
                                      need_recon=True, me_range=rcfg.me_range,
                                      weights=wvecs)
    ref = device_ref_from_numpy(r0.recon.y, r0.recon.cb, r0.recon.cr,
                                device="cpu")
    pend = submit_pgop_gpu(stack(0), stack(1), stack(2), ref, cfg, 32,
                           need_recon=True, me_range=cfg.me_range,
                           weights=wvecs, device="cpu")
    tsyns, trecons, last = collect_pgop_gpu(pend)
    assert len(tsyns) == 2
    for i in range(2):
        for k in FIELDS:
            a, b = getattr(syns[i], k), getattr(tsyns[i], k)
            assert (a is None) == (b is None), (i, k)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"frame {i} {k}")
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(recons[i], k),
                                          getattr(trecons[i], k),
                                          err_msg=f"frame {i} recon {k}")
    # the carried reference stack holds the last recon in slot 0
    assert last.y.shape == (1, h, w)
    np.testing.assert_array_equal(last.to_recon().y, trecons[-1].y)
    # the content exercises intra-in-inter and the RQT split
    assert any(s.intra8 is not None for s in syns)
    assert any(s.tusplit8 is not None for s in syns)


def test_bit_calibration_tables_match_reference():
    """The encoder's only fitted constants are copied, not imported."""
    assert port_calib.BIT_CALIB == ref_calib.BIT_CALIB
    assert port_calib._FALLBACK == ref_calib._FALLBACK
    for qp in range(0, 52):
        assert port_calib.calib_for_qp(qp) == ref_calib.calib_for_qp(qp)
