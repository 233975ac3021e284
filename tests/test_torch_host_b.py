"""Port parity for the host B path: x265_tpu_torch against x265_tpu on
the same inputs, made from seeds with numpy, on the CPU.

Piece by piece: the batched block MC (mc_block_batch raw and rounded,
bi_average) at 8 and 10 bits, luma and chroma, every fractional phase,
n = 4-32; the MV bit proxy over every |v| the searches reach; the
dense search (coarse_search, refine_size, motion_search_frame) on
tests/test_me.py's two inputs, both at 64x96; encode_b_frame_arrays, every
FrameBSyntax field and the recon, with host and device references.
Whole streams: encode_bgop on tests/test_bframes.py's three
configurations and clips (96x64 deblock off and on; its 64x64 clip
with deblock, SAO and the MD5 SEI coded here at 96x64, the shape of
the search tests above, whose coarse and refinement programs it
reuses: at 64x64 the reference traced four more, about 125 s cold),
encode_minigop(device=False) over 4 frames, one
WPP + dQP stream, one Main10 stream without SAO, and get_stats as
tests/test_ratecontrol.py::test_encoder_stats reads it. Every stream is
byte-identical to the reference's, and both the reference's and the
port's decoder reproduce the port's recon. Shapes and configurations
are those of the reference's own tests, so its programs can come from
the persistent JAX cache. Module-scoped fixtures encode each stream
once. Tolerance: exact equality everywhere.

The module runs under test_torch_main10.py's refuse_uint16_tensor_reads
(a tensor-indexed read of a uint16 tensor raises, as on the card)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import to_10bit
from test_inter_e2e import moving_sequence
from test_me import _textured
from test_torch_main10 import refuse_uint16_tensor_reads  # noqa: F401
from test_torch_transforms import JitRef
from x265_tpu.bitstream.syntax import FrameBSyntax as RefBSyntax
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.common.tables import lambda_from_qp
from x265_tpu.decoder import decode_annexb as ref_decode
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc import bi_frame as ref_bi
from x265_tpu.ops import interp as ref_interp
from x265_tpu.ops import me as ref_me
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.decoder import decode_annexb as port_decode
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc import bi_frame as port_bi
from x265_tpu_torch.enc.intra_recon import DeviceRef, ReconFrame
from x265_tpu_torch.ops import interp as port_interp
from x265_tpu_torch.ops import me as port_me

torch.set_num_threads(2)

# the reference's record; the port's adds sao_params and qp_map, which
# the device B path fills
SYN_FIELDS = tuple(f.name for f in dataclasses.fields(RefBSyntax))


def _port(rcfg):
    return IntraEncoder(config_from_dict(dataclasses.asdict(rcfg)),
                        device="cpu")


def _assert_recon(a, b, msg=""):
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)),
                                      err_msg=f"{msg} {k}")


def _assert_decodes(results):
    """Both decoders reproduce the port's recon, frame by frame in
    decode order (each verifies any MD5 SEI as it goes)."""
    stream = b"".join(r.bitstream for r in results)
    for decode in (ref_decode, port_decode):
        decs = decode(stream)
        assert len(decs) == len(results)
        for i, (d, r) in enumerate(zip(decs, results)):
            assert d.poc == r.poc, (decode.__module__, i)
            _assert_recon(d, r.recon, f"{decode.__module__} frame {i}")


def _assert_same_streams(ref, port):
    assert [r.ftype for r in ref] == [r.ftype for r in port]
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a.bitstream == b.bitstream, f"decode-order frame {i}"
        _assert_recon(a.recon, b.recon, f"frame {i}")


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def _mc_inputs(rng, bd, is_luma, n, h=40, w=56):
    """Every (fx, fy) phase pair twice, with random integer parts and
    origins, some reaching past every edge of the plane."""
    nf = 4 if is_luma else 8
    fx, fy = np.meshgrid(np.arange(nf), np.arange(nf), indexing="ij")
    fx, fy = np.tile(fx.ravel(), 2), np.tile(fy.ravel(), 2)
    b = fx.size
    sh = 2 if is_luma else 3
    mvx = (rng.integers(-12, 12, b) << sh) | fx
    mvy = (rng.integers(-12, 12, b) << sh) | fy
    x0 = rng.integers(-8, w, b)
    y0 = rng.integers(-8, h, b)
    ref = rng.integers(0, 1 << bd, (h, w))
    return [a.astype(np.int32) for a in (ref, x0, y0, mvx, mvy)]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("raw", [False, True])
def test_mc_block_batch_matches_reference(bd, is_luma, raw):
    rng = np.random.default_rng(bd * 4 + 2 * is_luma + raw)
    for n in (4, 8, 16, 32):
        args = _mc_inputs(rng, bd, is_luma, n)
        want = JitRef(ref_interp).mc_block_batch(
            *map(jnp.asarray, args), n, is_luma=is_luma, bit_depth=bd,
            raw=raw)
        got = port_interp.mc_block_batch(
            *map(torch.from_numpy, args), n, is_luma=is_luma, bit_depth=bd,
            raw=raw)
        np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                      err_msg=f"n {n}")


@pytest.mark.parametrize("bd", [8, 10])
def test_bi_average_matches_reference(bd):
    rng = np.random.default_rng(bd)
    lo, hi = -(1 << (bd + 6)), (1 << bd) << (20 - bd)
    a0, a1 = (rng.integers(lo, hi, (37, 8, 8)).astype(np.int32)
              for _ in range(2))
    np.testing.assert_array_equal(
        np.asarray(ref_interp.bi_average(jnp.asarray(a0), jnp.asarray(a1),
                                         bd)),
        port_interp.bi_average(torch.from_numpy(a0), torch.from_numpy(a1),
                               bd).numpy())


def test_mv_bits_matches_reference():
    """The reference's float32 ceil(log2(|v| + 1)) and the port's integer
    bit length agree over every |v| up to 4096 qpel, both signs (the
    searches reach a few hundred)."""
    v = np.arange(-4096, 4097, dtype=np.int32)
    for dx, dy in ((v, v[::-1].copy()), (v, np.zeros_like(v))):
        want = jax.jit(ref_me._mv_bits)(jnp.asarray(dx), jnp.asarray(dy))
        got = port_me._mv_bits(torch.from_numpy(dx), torch.from_numpy(dy))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _me_case(case):
    """tests/test_me.py's two inputs, a global translation and a static
    picture, with their QPs, both at 64x96 (the reference traces its
    unrolled search programs once per shape, for 5-10 s each, so one
    shape serves both cases)."""
    if case == "translation":
        h, w = 64, 96
        ref = _textured(h + 32, w + 32, 3)
        cur = ref[22:22 + h, 6:6 + w]
        return cur, ref[16:16 + h, 16:16 + w], 32
    cur = _textured(64, 96, 9)
    return cur, cur.copy(), 30


@functools.lru_cache(maxsize=None)
def _me_fields(case):
    cur, ref, qp = _me_case(case)
    return (ref_me.motion_search_frame(cur, ref, qp=qp),
            port_me.motion_search_frame(cur, ref, qp=qp, device="cpu"))


ME_CASES = ["translation", "static"]


@pytest.mark.parametrize("case", ME_CASES)
def test_coarse_search_matches_reference(case):
    cur, ref, _ = _me_case(case)
    want = ref_me.coarse_search(
        JitRef(ref_me)._downsample4(jnp.asarray(cur, jnp.int32)),
        JitRef(ref_me)._downsample4(jnp.asarray(ref, jnp.int32)))
    t = torch.from_numpy
    got = port_me.coarse_search(port_me._downsample4(t(cur)),
                                port_me._downsample4(t(ref)))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("case", ME_CASES)
@pytest.mark.parametrize("n", [8, 16, 32])
def test_refine_size_matches_reference(case, n):
    """From seeds the coarse search could give (scaled, with spread),
    every qpel MV and cost."""
    cur, ref, qp = _me_case(case)
    lam = int(round(lambda_from_qp(qp)))
    h, w = cur.shape
    rng = np.random.default_rng(n)
    seed = rng.integers(-8, 9, ((h // n) * (w // n), 2)).astype(np.int32)
    # the keywords motion_search_frame passes, so its program is reused
    want = ref_me.refine_size(jnp.asarray(cur, jnp.int32),
                              jnp.asarray(ref, jnp.int32),
                              jnp.asarray(seed), jnp.int32(lam), n,
                              bit_depth=8)
    got = port_me.refine_size(torch.from_numpy(cur.astype(np.int32)),
                              torch.from_numpy(ref.astype(np.int32)),
                              torch.from_numpy(seed), lam, n, bit_depth=8)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("case", ME_CASES)
def test_motion_search_frame_matches_reference(case):
    want, got = _me_fields(case)
    assert sorted(want) == sorted(got) == [8, 16, 32]
    for n in want:
        for a, b in zip(want[n], got[n]):
            np.testing.assert_array_equal(a, b, err_msg=f"size {n}")


# ---------------------------------------------------------------------------
# test_bframes.py's streams, and one B frame of them
# ---------------------------------------------------------------------------

BGOP = {
    "96x64_deblock_off": (96, 64, 5, 41, dict(qp=32, deblock=False)),
    "96x64_deblock_on": (96, 64, 5, 41, dict(qp=32, deblock=True)),
    # the id names test_bframes.py's 64x64 clip; coded here at 96x64
    "64x64_sao_hash": (96, 64, 3, 44, dict(qp=35, deblock=True, sao=True,
                                            hash_sei=True)),
}


@functools.lru_cache(maxsize=None)
def _bgop(name):
    """One of test_bframes.py's configurations and clips through
    encode_bgop: (reference config, frames, reference encoder and
    results, port encoder and results)."""
    w, h, n, seed, kw = BGOP[name]
    rcfg = RefConfig(width=w, height=h, bframes=1, num_refs=2, **kw)
    frames = moving_sequence(w, h, n, seed=seed)
    ref_enc, port_enc = RefEncoder(rcfg), _port(rcfg)
    return (rcfg, frames, ref_enc, ref_enc.encode_bgop(frames), port_enc,
            port_enc.encode_bgop(frames))


@pytest.fixture(scope="module", params=sorted(BGOP))
def bgop(request):
    """The reference's and the port's encode_bgop results."""
    return _bgop(request.param)[3::2]



@functools.lru_cache(maxsize=None)
def _b_frame_case(refs):
    """encode_b_frame_arrays on the 96x64 deblocked clip's frame 1
    between the reference's I and P recons of frames 0 and 2 (its
    encode_bgop's), at the B QP 34; the port's references host
    ReconFrames or DeviceRefs on the CPU."""
    rcfg, frames, _, ref_res, _, _ = _bgop("96x64_deblock_on")
    r0, r2 = ref_res[0].recon, ref_res[1].recon
    want = ref_bi.encode_b_frame_arrays(*frames[1], r0, r2, rcfg, 1, (0, 2),
                                        34)
    pr = [ReconFrame(*(np.asarray(p, np.int32) for p in (r.y, r.cb, r.cr)))
          for r in (r0, r2)]
    if refs == "device":
        pr = [DeviceRef(*(torch.from_numpy(p.astype(np.uint8))
                          for p in (r.y, r.cb, r.cr))) for r in pr]
    got = port_bi.encode_b_frame_arrays(
        *frames[1], *pr, config_from_dict(dataclasses.asdict(rcfg)), 1,
        (0, 2), 34, device="cpu")
    return want, got


@pytest.mark.parametrize("refs", ["host", "device"])
@pytest.mark.parametrize("field", SYN_FIELDS)
def test_b_frame_syntax_matches_reference(refs, field):
    (want, _), (got, _) = _b_frame_case(refs)
    a, b = getattr(want, field), getattr(got, field)
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
    else:
        assert a == b


@pytest.mark.parametrize("refs", ["host", "device"])
def test_b_frame_recon_matches_reference(refs):
    (want_syn, want), (got_syn, got) = _b_frame_case(refs)
    _assert_recon(want, got)
    assert got_syn.sao_params is None and got_syn.qp_map is None
    # the case exercises every prediction flag and every depth
    assert set(np.unique(want_syn.pf8)) == {1, 2, 3}


# ---------------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------------

def test_bgop_stream_matches_reference(bgop):
    ref, port = bgop
    _assert_same_streams(ref, port)
    assert [r.poc for r in port] == [0, 2, 1, 4, 3][:len(port)]


def test_bgop_stream_decodes_to_recon(bgop):
    _assert_decodes(bgop[1])


def test_bgop_b_syntax_matches_reference(bgop):
    for a, b in zip(*bgop):
        if a.ftype == "B":
            for f in SYN_FIELDS:
                x, y = getattr(a.syntax, f), getattr(b.syntax, f)
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=f)
                else:
                    assert x == y, f


@pytest.fixture(scope="module")
def minigop():
    """encode_minigop(device=False) over 4 frames after an IDR: the
    anchor P at POC 4, the BREF at 2, then the non-reference Bs 1 and 3
    (one at a time, through the host B path)."""
    rcfg = RefConfig(width=96, height=64, qp=32, deblock=True, bframes=3,
                     num_refs=2)
    frames = moving_sequence(96, 64, 5, seed=41)
    out = []
    for enc in (RefEncoder(rcfg), _port(rcfg)):
        r0 = enc.encode_frame(*frames[0])
        enc.ref = r0.recon if isinstance(enc, RefEncoder) else r0.device_ref
        enc.poc = 0
        out.append([r0] + enc.encode_minigop(frames[1:], device=False))
    return out


def test_minigop_host_path_matches_reference(minigop):
    ref, port = minigop
    _assert_same_streams(ref, port)
    assert [r.poc for r in port] == [0, 4, 2, 1, 3]
    assert [r.ftype for r in port] == ["I", "P", "B", "B", "B"]


def test_minigop_host_path_decodes_to_recon(minigop):
    _assert_decodes(minigop[1])


def test_wpp_dqp_bgop_matches_reference():
    """WPP substreams and a cu_qp_delta PPS (AQ on): the host B slice
    codes a flat QP map at its QP, one substream per CTU row."""
    rcfg = RefConfig(width=96, height=64, qp=32, deblock=True, bframes=1,
                     num_refs=2, wpp=True, aq_mode=1)
    frames = moving_sequence(96, 64, 3, seed=41)
    ref, port = (RefEncoder(rcfg).encode_bgop(frames),
                 _port(rcfg).encode_bgop(frames))
    _assert_same_streams(ref, port)
    _assert_decodes(port)


def test_main10_bgop_matches_reference():
    """At 10 bits, without SAO (ROADMAP item 31), through the I, P and
    host B paths, under the uint16 read refusal."""
    rcfg = RefConfig(width=96, height=64, qp=32, deblock=True, bframes=1,
                     num_refs=2, bit_depth=10, hash_sei=True)
    frames = [to_10bit(f, 5, shift=2 * k) for k, f in
              enumerate(moving_sequence(96, 64, 3, seed=41))]
    ref, port = (RefEncoder(rcfg).encode_bgop(frames),
                 _port(rcfg).encode_bgop(frames))
    _assert_same_streams(ref, port)
    _assert_decodes(port)
    assert port[2].recon.y.max() > 255


@pytest.mark.parametrize("name", sorted(BGOP))
def test_encoder_stats_match_reference(name):
    """get_stats after encode_bgop, as
    tests/test_ratecontrol.py::test_encoder_stats reads it: every key
    equal (but encode_fps, which times each run's host clock)."""
    _, frames, ref_enc, _, port_enc, _ = _bgop(name)
    want, got = ref_enc.get_stats(), port_enc.get_stats()
    assert got["frames"] == len(frames)
    assert got["count_by_type"] == {"I": 1, "P": (len(frames) - 1) // 2,
                                    "B": (len(frames) - 1) // 2}
    assert set(want) == set(got)
    for k in want:
        if k != "encode_fps":
            assert want[k] == got[k], k
