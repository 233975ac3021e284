"""The port's main path as a whole: bench-shaped low-delay IPPP (CQP 32,
deblock, I frame at QP 29 through the device recon, then pipelined P
chunks of 2) encoded by x265_tpu_torch on the CPU must give streams
byte-identical to x265_tpu's, which x265_tpu.decoder decodes to the
port's recon. Frames and config follow tests/test_pipelined.py, so the
reference's compiled programs can come from the persistent cache.
Also: the package imports neither JAX nor x265_tpu, its entry points
want a GPU unless the CPU is asked for, and options it does not port
raise."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.decoder import decode_annexb
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu_torch.common.params import EncoderConfig
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.enc import IntraEncoder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n, h=64, w=96, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    base = np.clip(base + rng.integers(-8, 8, (h, w)), 0, 255) \
        .astype(np.uint8)
    cb = np.full((h // 2, w // 2), 120, np.uint8)
    cr = np.full((h // 2, w // 2), 132, np.uint8)
    return [(np.roll(base, 2 * i, axis=1), cb, cr) for i in range(n)]


@pytest.mark.parametrize("h,w", [(64, 96), (72, 96)])
def test_ippp_stream_matches_reference(h, w):
    frames = _frames(7, h, w)
    rcfg = RefConfig(width=w, height=h, qp=32, deblock=True)
    enc = RefEncoder(rcfg)
    r0 = enc.encode_frame(*frames[0], qp=rcfg.qp - 3, use_device_recon=True)
    enc.ref = r0.device_ref
    enc.poc = 0
    rs = enc.encode_pgop_pipelined(frames[1:], chunk=2)

    cfg = config_from_dict(dataclasses.asdict(rcfg))
    penc = IntraEncoder(cfg, device="cpu")
    p0 = penc.encode_frame(*frames[0], qp=cfg.qp - 3, use_device_recon=True)
    penc.ref = p0.device_ref
    penc.poc = 0
    ps = penc.encode_pgop_pipelined(frames[1:], chunk=2, need_recon=True)

    assert p0.bitstream == r0.bitstream
    assert len(ps) == len(rs) == 6
    for i, (a, b) in enumerate(zip(rs, ps)):
        assert a.bitstream == b.bitstream, f"P frame {i + 1}"

    stream = p0.bitstream + b"".join(r.bitstream for r in ps)
    dec = decode_annexb(stream)
    assert len(dec) == 7
    for i, d in enumerate(dec):
        rec = p0.recon if i == 0 else ps[i - 1].recon
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k), getattr(rec, k),
                                          err_msg=f"frame {i} {k}")


def test_package_imports_neither_jax_nor_reference():
    """Every module of x265_tpu_torch, and chip_smoke.py, import without
    pulling JAX or the reference package into the process."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import x265_tpu_torch\n"
        "for m in pkgutil.walk_packages(x265_tpu_torch.__path__, "
        "'x265_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'x265_tpu' or m.startswith('x265_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_entry_points_want_a_gpu():
    """device=None means the GPU: without one the entry points raise
    instead of running on the CPU."""
    from x265_tpu_torch.enc.intra_recon import ReconFrame
    from x265_tpu_torch.enc.pgop_gpu import submit_pgop_gpu
    cfg = EncoderConfig(width=64, height=64, qp=32)
    if torch.cuda.is_available():
        assert IntraEncoder(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IntraEncoder(cfg)
    z = np.zeros((64, 64), np.uint8)
    zc = np.zeros((32, 32), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        submit_pgop_gpu(z[None], zc[None], zc[None], ReconFrame(z, zc, zc),
                        cfg, 32)


@pytest.mark.parametrize("field,value,item", [
    ("num_refs", 2, 12), ("tmvp", True, 12), ("sao", True, 13),
    ("ctu_size", 64, 14), ("aq_mode", 2, 15), ("rdoq", True, 16),
    ("nr_inter", 100, 16), ("lowpass_dct", True, 16), ("wpp", True, 17),
    ("lossless", True, 18), ("bit_depth", 10, 19), ("bframes", 3, 21),
    ("hash_sei", 1, 24)])
def test_unported_options_raise(field, value, item):
    cfg = EncoderConfig(width=64, height=64, qp=32)
    setattr(cfg, field, value)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 item {item}"):
        IntraEncoder(cfg, device="cpu")


def test_host_recon_i_path_raises():
    enc = IntraEncoder(EncoderConfig(width=64, height=64, qp=32),
                       device="cpu")
    z = np.zeros((64, 64), np.uint8)
    zc = np.zeros((32, 32), np.uint8)
    with pytest.raises(NotImplementedError, match="item 18"):
        enc.encode_frame(z, zc, zc, use_device_recon=False)


def test_config_from_dict_round_trips_and_rejects_unknown_fields():
    rcfg = RefConfig(width=96, height=72, qp=27, deblock=True, me_range=7)
    cfg = config_from_dict(dataclasses.asdict(rcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    with pytest.raises(ValueError):
        config_from_dict({**dataclasses.asdict(rcfg), "no_such_field": 1})
