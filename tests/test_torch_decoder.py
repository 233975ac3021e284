"""The port's Python slice coder and validation decoder against the
reference's, on the CPU, exact equality throughout.

Streams are encoded by x265_tpu_torch alone on the CPU (no reference
program is traced), in one module fixture, from the clips and
configurations of chip_smoke.py and the other port tests:
- bench IPPP (64x96, CQP 32, the I frame at QP 29, chunks of 2);
- --preset fast --tune zerolatency on the strobe clip (3 references,
  TMVP, SAO);
- --preset medium --tune zerolatency on the 72x128 clip (CTU 64), and
  --preset placebo --tune zerolatency on it (RDOQ, 5 references,
  merge 5);
- --preset fast with B frames through the CLI's mini-GOP loop, plain and
  with aq-mode 2 (dQP in the B body);
- medium/zerolatency + aq-mode 2 + cuTree through encode_sequence (the
  host-recon I frame with a QP map, dQP P frames);
- a lossless I frame (checksum SEI) and two CTU-16 keyint-1 I frames
  (CRC SEI);
- a --param wpp=1 --hash 1 CLI stream (MD5 SEI);
- a Main10 --no-sao fast/zerolatency stream with MD5 SEIs.
Every slice the encoder codes is captured (its syntax record, the
arguments of its native coder and the bytes it wrote).

Checks:
- x265_tpu_torch.decoder.decode_annexb returns what
  x265_tpu.decoder.decode_annexb returns: decode order, POCs, planes
  and the parsed maps; both equal the port's recon; a flipped hash byte
  raises ValueError in both, and corrupt slice data raises the same
  exception in both;
- the port's SliceSyntaxEncoder writes the native coder's bytes on
  every captured slice (I, P and B, WPP substreams, SAO, dQP, lossless,
  NxN, TMVP, merge 3 and 5), with sign hiding on and off, as does the
  reference's SliceSyntaxEncoder on the same records;
  IntraEncoder.encode_frame(use_native_cabac=False) writes the default
  stream;
- the merge / AMVP / TMVP candidates of every CU those slices code
  equal the reference's mv_derive on the same fields;
- BitReader and CabacDecoder read back what BitWriter and CabacEncoder
  wrote (seeded ue/se/bit, context, bypass and terminate sequences),
  against the reference's classes;
- the numpy MC oracles equal the reference's at 8 and 10 bits at every
  fractional phase; inter_bs_maps / inter_bs_maps_b equal the
  reference's on the P and B records."""

import copy
import dataclasses
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import chip_smoke as cs
from x265_tpu import decoder as ref_decoder
from x265_tpu.bitstream import bitwriter as ref_bw
from x265_tpu.bitstream import cabac as ref_cabac
from x265_tpu.bitstream import syntax as ref_syntax
from x265_tpu.common import mv_derive as ref_mv
from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.ops import deblock as ref_deblock
from x265_tpu.ops import interp as ref_interp
from x265_tpu_torch import decoder as port_decoder
from x265_tpu_torch.bitstream import bitwriter as port_bw
from x265_tpu_torch.bitstream import cabac as port_cabac
from x265_tpu_torch.bitstream import syntax as port_syntax
from x265_tpu_torch.bitstream.bitreader import BitReader
from x265_tpu_torch.bitstream.ctx_tables import NUM_CONTEXTS, init_states
from x265_tpu_torch.bitstream.headers import write_slice_header
from x265_tpu_torch.bitstream.nal import emulation_prevention, split_annexb
from x265_tpu_torch.cli import main as cli_main
from x265_tpu_torch.common import mv_derive as port_mv
from x265_tpu_torch.common.params import B_SLICE, I_SLICE, P_SLICE
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc import encoder as encoder_mod
from x265_tpu_torch.io import Y4MReader
from x265_tpu_torch.native.entropy_native import (encode_slice_native,
                                                  encode_slice_wpp_native)
from x265_tpu_torch.ops import deblock as port_deblock
from x265_tpu_torch.ops import interp as port_interp

torch.set_num_threads(2)

SUFFIX_SEI = 40


# ---------------------------------------------------------------------------
# streams: the port alone, on the CPU, every slice captured
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stream:
    data: bytes
    recon: list            # (poc, y, cb, cr) in decode order
    slices: list           # captured _code_slice calls


@contextmanager
def capture_slices(out: list):
    """Record every IntraEncoder._code_slice call: (slice_type, cfg,
    syntax record, qp, header, coder kwargs, native, (rbsp, escaped)),
    copied at the call (the encoder mutates its cfg and records later)."""
    real = IntraEncoder._code_slice

    def spy(enc, slice_type, syn, qp, header, coder, native=True):
        got = real(enc, slice_type, syn, qp, header, coder, native)
        out.append((slice_type, copy.deepcopy(enc.cfg), copy.deepcopy(syn),
                    qp, dict(header), dict(coder), native, got))
        return got

    IntraEncoder._code_slice = spy
    try:
        yield out
    finally:
        IntraEncoder._code_slice = real


def _recon_of(results):
    return [(r.poc, r.recon.y, r.recon.cb, r.recon.cr) for r in results]


def _ippp(frames, cfg, chunk=2):
    enc = IntraEncoder(cfg, device="cpu")
    r0 = enc.encode_frame(*frames[0], qp=cfg.qp - 3)
    enc.ref, enc.poc = r0.device_ref, 0
    return [r0] + enc.encode_pgop_pipelined(frames[1:], chunk=chunk,
                                            need_recon=True)


def _fast_b_aq(h, w):
    cfg = cs.fast_b_config(h, w)
    cfg.aq_mode = 2
    return cfg


def _lossless_frame():
    rng = np.random.default_rng(5)
    y, cb, cr = cs.small_clip(1)[0]
    y = np.clip(y.astype(np.int32) + rng.integers(-20, 20, y.shape), 0,
                255).astype(np.uint8)
    return [(y, rng.integers(100, 140, cb.shape).astype(np.uint8),
             rng.integers(120, 150, cr.shape).astype(np.uint8))]


def _lib(make):
    def run(tmp):
        res = make()
        return b"".join(r.bitstream for r in res), _recon_of(res)
    return run


def _cli_wpp(tmp):
    src = cs.write_y4m(tmp / "wpp.y4m", cs.small_clip(4))
    out, rec = tmp / "wpp.hevc", tmp / "wpp_rec.y4m"
    assert cli_main([src, "-o", str(out), "--preset", "fast", "--tune",
                     "zerolatency", "--param", "wpp=1", "--hash", "1",
                     "--recon", str(rec), "--no-progress"],
                    device="cpu") == 0
    # IPPP: decode order is display order
    return out.read_bytes(), [(k, *f) for k, f in
                              enumerate(Y4MReader(str(rec)))]


def _main10():
    cfg = cs.main10_config(64, 96, "fast", "zerolatency", hash_sei=1)
    return _ippp(cs.synth10_clip(4, 64, 96), cfg)


def _ctu16():
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=96, height=64, qp=32, ctu_size=16, keyint=1,
                        bframes=0, deblock=True, hash_sei=2)
    enc = IntraEncoder(cfg, device="cpu")
    return [enc.encode_frame(*f) for f in cs.small_clip(2)]


def _lossless():
    from x265_tpu_torch.common.params import EncoderConfig
    cfg = EncoderConfig(width=96, height=64, qp=32, lossless=True,
                        hash_sei=3)
    return [IntraEncoder(cfg, device="cpu").encode_frame(
        *_lossless_frame()[0])]


MAKERS = {
    "bench_ippp": _lib(lambda: _ippp(cs.small_clip(5),
                                     cs.bench_config(64, 96))),
    "fast_zl_strobe": _lib(lambda: _ippp(cs.strobe_clip(5),
                                         cs.fast_config(64, 96))),
    "medium_zl_ctu64": _lib(lambda: _ippp(cs.medium_clip(5),
                                          cs.medium_config(72, 128))),
    "placebo_zl": _lib(lambda: _ippp(cs.medium_clip(6),
                                     cs.placebo_config(72, 128), chunk=5)),
    "fast_b": _lib(lambda: cs.encode_random_access(
        cs.b_clip(6), "cpu", cs.fast_b_config(64, 96))[0]),
    "fast_b_aq2": _lib(lambda: cs.encode_random_access(
        cs.b_clip(5), "cpu", _fast_b_aq(64, 96))[0]),
    "aq_cutree_seq": _lib(lambda: IntraEncoder(
        cs.aq_cutree_config(72, 128), device="cpu").encode_sequence(
        cs.medium_clip(4))),
    "lossless_i": _lib(_lossless),
    "ctu16": _lib(_ctu16),
    "cli_wpp": _cli_wpp,
    "main10": _lib(_main10),
}
NAMES = list(MAKERS)
HASHED = ["lossless_i", "ctu16", "cli_wpp", "main10"]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streams")
    out = {}
    for name, make in MAKERS.items():
        slices = []
        with capture_slices(slices):
            data, recon = make(tmp)
        out[name] = Stream(data, recon, slices)
    return out


@pytest.fixture(scope="module")
def decoded(streams):
    """Each stream through both decoders (decode order)."""
    return {name: (port_decoder.decode_annexb(s.data),
                   ref_decoder.decode_annexb(s.data))
            for name, s in streams.items()}


def test_streams_cover_the_slice_kinds(streams):
    """The captured slices reach what the cases claim: I, P and B
    slices, WPP, SAO, dQP, lossless, NxN, TMVP, several references,
    CTU 16 and 64, 10 bits, and the hash SEI types 1-3."""
    seen = set()
    for name, s in streams.items():
        for st, cfg, syn, qp, header, coder, native, _ in s.slices:
            seen.add({I_SLICE: "I", P_SLICE: "P", B_SLICE: "B"}[st])
            seen.update(k for k, on in (
                ("wpp", cfg.wpp), ("lossless", cfg.lossless),
                ("sao", coder.get("sao_params") is not None),
                ("dqp", coder.get("qp_map") is not None),
                ("ctu16", cfg.ctu_size == 16), ("ctu64", cfg.ctu_size == 64),
                ("main10", cfg.bit_depth == 10),
                ("nxn", getattr(syn, "nxn8", None) is not None
                 and syn.nxn8.any()),
                ("tmvp", coder.get("col") is not None),
                ("refidx", getattr(syn, "ref8", None) is not None),
                ("merge3", coder.get("max_merge", 2) >= 3),
                ("merge5", coder.get("max_merge", 2) >= 5),
                ("bi", st == B_SLICE and (syn.pf8 == 3).any()),
                ("intra_in_p", st == P_SLICE and syn.intra8 is not None
                 and syn.intra8.any())) if on)
        types = {int(t) for t, _, _ in split_annexb(s.data)}
        if name in HASHED:
            assert SUFFIX_SEI in types, name
    assert seen >= {"I", "P", "B", "wpp", "lossless", "sao", "dqp", "ctu16",
                    "ctu64", "main10", "nxn", "tmvp", "refidx", "merge3",
                    "merge5", "bi", "intra_in_p"}, seen


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def _assert_same_frame(a, b, what):
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa.keys() == fb.keys()
    for k, va in fa.items():
        vb = fb[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, (what, k)
            assert va.dtype == vb.dtype, (what, k)
            np.testing.assert_array_equal(va, vb, err_msg=f"{what} {k}")
        else:
            assert va == vb, (what, k)


@pytest.mark.parametrize("name", NAMES)
def test_decoder_matches_reference(decoded, name):
    port, ref = decoded[name]
    assert len(port) == len(ref) > 0
    for i, (a, b) in enumerate(zip(port, ref)):
        _assert_same_frame(a, b, f"{name} frame {i}")


@pytest.mark.parametrize("name", NAMES)
def test_decoder_equals_port_recon(streams, decoded, name):
    port, _ = decoded[name]
    recon = streams[name].recon
    assert [f.poc for f in port] == [r[0] for r in recon]
    for i, (f, (_, y, cb, cr)) in enumerate(zip(port, recon)):
        for k, p in zip(("y", "cb", "cr"), (y, cb, cr)):
            got = getattr(f, k)
            np.testing.assert_array_equal(got, p[:got.shape[0],
                                                 :got.shape[1]],
                                          err_msg=f"{name} frame {i} {k}")
            assert got.shape == p.shape, (name, i, k)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_sets_match_reference(streams, name):
    for t, rbsp, _ in split_annexb(streams[name].data):
        for kind, nal in (("sps", 33), ("pps", 34)):
            if int(t) == nal:
                a = getattr(port_decoder.decoder, f"parse_{kind}")(rbsp)
                b = getattr(ref_decoder.decoder, f"parse_{kind}")(rbsp)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _flip_first_hash_byte(data: bytes) -> bytes:
    """The stream with the first byte of the first picture hash flipped:
    SEI header (2 bytes), payload type 132, size, hash type, digest."""
    at = 0
    while True:
        at = data.index(b"\x00\x00\x01", at) + 3
        if data[at] >> 1 == SUFFIX_SEI and data[at + 2] == 132:
            pos = at + 5
            return data[:pos] + bytes([data[pos] ^ 0x10]) + data[pos + 1:]


@pytest.mark.parametrize("name", HASHED)
def test_flipped_hash_byte_raises_in_both(streams, name):
    bad = _flip_first_hash_byte(streams[name].data)
    for dec in (port_decoder, ref_decoder):
        with pytest.raises(ValueError, match="decoded-picture-hash"):
            dec.decode_annexb(bad)


def _outcome(dec, data):
    try:
        return dec.decode_annexb(data)
    except Exception as e:   # the exception type and text are compared
        return (type(e), str(e))


@pytest.mark.parametrize("name,frame,offset",
                         [("bench_ippp", 0, 24), ("bench_ippp", 1, 9),
                          ("fast_b", 2, 7), ("cli_wpp", 1, 12)])
def test_corrupt_slice_data_behaves_as_reference(streams, name, frame,
                                                 offset):
    """A byte of one picture's slice data flipped: the same exception
    (type and message; end_of_slice where the arithmetic decoder loses
    step) or the same frames in both decoders."""
    data = streams[name].data
    units = [i for i in range(len(data) - 3)
             if data[i:i + 3] == b"\x00\x00\x01"
             and (data[i + 3] >> 1) in (1, 19, 0)]
    pos = units[frame] + 3 + 2 + offset + 8
    bad = data[:pos] + bytes([data[pos] ^ 0x5A]) + data[pos + 1:]
    a, b = _outcome(port_decoder, bad), _outcome(ref_decoder, bad)
    if isinstance(b, tuple):
        assert a == b
    else:
        assert not isinstance(a, tuple), a
        assert len(a) == len(b)
        for i, (fa, fb) in enumerate(zip(a, b)):
            _assert_same_frame(fa, fb, f"frame {i}")


def test_end_of_slice_assertion_as_reference(streams):
    """Slice data cut short inside the I frame: both decoders stop on the
    end_of_slice check with an AssertionError."""
    data = streams["bench_ippp"].data
    at = next(i for i in range(len(data) - 3)
              if data[i:i + 3] == b"\x00\x00\x01" and data[i + 3] >> 1 == 19)
    end = data.index(b"\x00\x00\x01", at + 3)
    bad = data[:at + 40] + data[end - 1:]
    for dec in (port_decoder, ref_decoder):
        with pytest.raises(AssertionError, match="end_of_slice"):
            dec.decode_annexb(bad)


# ---------------------------------------------------------------------------
# the Python slice coder
# ---------------------------------------------------------------------------

def _ref_record(syn):
    cls = getattr(ref_syntax, type(syn).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(syn).items()
                  if k in names})


def _python_rbsp(coder_cls, cfg, syn, st, qp, header, coder):
    """rbsp and escaped substreams as _code_slice writes them, the slice
    data from coder_cls (the port's or the reference's SliceSyntaxEncoder)
    and the header from the port's writer."""
    enc = coder_cls(cfg, syn, st, qp, sao_params=coder.get("sao_params"),
                    qp_map=coder.get("qp_map"))
    if cfg.wpp:
        escaped = [emulation_prevention(s)
                   for s in enc.encode_slice_data_wpp()]
        sw = write_slice_header(
            cfg, st, num_entry_points=len(escaped) - 1,
            entry_point_offsets=[len(e) for e in escaped[:-1]], **header)
        return sw.get_bytes(), b"".join(escaped)
    sw = write_slice_header(cfg, st, **header)
    enc.encode_slice_data().finish_into(sw)
    sw.align_one()
    return sw.get_bytes(), b""


def _ref_cfg(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", NAMES)
def test_python_coder_matches_native(streams, name):
    for k, (st, cfg, syn, qp, header, coder, native, got) in \
            enumerate(streams[name].slices):
        assert native
        want = _python_rbsp(port_syntax.SliceSyntaxEncoder, cfg, syn, st, qp,
                            header, coder)
        assert want == got, f"{name} slice {k}"


@pytest.mark.parametrize("name", NAMES)
def test_reference_python_coder_matches_port(streams, name):
    for k, (st, cfg, syn, qp, header, coder, _, got) in \
            enumerate(streams[name].slices):
        rcfg = _ref_cfg(cfg)
        ref = ref_syntax.SliceSyntaxEncoder(
            rcfg, _ref_record(syn), st, qp,
            sao_params=coder.get("sao_params"), qp_map=coder.get("qp_map"))
        port = port_syntax.SliceSyntaxEncoder(
            cfg, syn, st, qp, sao_params=coder.get("sao_params"),
            qp_map=coder.get("qp_map"))
        if cfg.wpp:
            assert ref.encode_slice_data_wpp() == \
                port.encode_slice_data_wpp(), f"{name} slice {k}"
        else:
            a, b = ref.encode_slice_data(), port.encode_slice_data()
            assert (a.finish(), a._tail) == (b.finish(), b._tail), \
                f"{name} slice {k}"


def _native_data(st, cfg, syn, qp, coder):
    """The slice data as the native coder writes it from the captured
    arguments (fresh context states per call)."""
    args = (st, syn.depth8, syn.coeff_y, syn.coeff_cb, syn.coeff_cr,
            cfg.width_padded, cfg.height_padded, cfg.log2_ctu,
            cfg.log2_min_cu, init_states(st, qp))
    if cfg.wpp:
        return encode_slice_wpp_native(*args, **coder)
    return encode_slice_native(*args, **coder)


def _python_data(cls, cfg, syn, st, qp, coder):
    enc = cls(cfg, syn, st, qp, sao_params=coder.get("sao_params"),
              qp_map=coder.get("qp_map"))
    if cfg.wpp:
        return enc.encode_slice_data_wpp()
    cab = enc.encode_slice_data()
    return (cab.finish(), *cab._tail)


@pytest.mark.parametrize("name", ["bench_ippp", "fast_zl_strobe",
                                  "medium_zl_ctu64", "placebo_zl", "fast_b",
                                  "cli_wpp", "main10"])
def test_sign_hiding_off_matches_native(streams, name):
    """The same records coded with sign hiding off (every sign written):
    port Python coder == native coder == reference Python coder."""
    for k, (st, cfg, syn, qp, header, coder, _, _) in \
            enumerate(streams[name].slices):
        if not cfg.sign_hiding:
            continue
        cfg = copy.deepcopy(cfg)
        cfg.sign_hiding = False
        coder = dict(coder, sign_hiding=False)
        port = _python_data(port_syntax.SliceSyntaxEncoder, cfg, syn, st, qp,
                            coder)
        native = _native_data(st, cfg, syn, qp, coder)
        ref = _python_data(ref_syntax.SliceSyntaxEncoder, _ref_cfg(cfg),
                           _ref_record(syn), st, qp, coder)
        assert port == ref, f"{name} slice {k}"
        if cfg.wpp:
            assert port == native, f"{name} slice {k}"
        else:
            assert port == tuple(native), f"{name} slice {k}"


@pytest.mark.parametrize("seed", range(3))
def test_python_coder_codes_every_ref_idx(streams, seed):
    """The placebo stream's last P record (5 references) with seeded
    refIdx 0-4 per 8x8 cell (the streams choose 0 and 1 only): the
    ref_idx bins past the two context-coded ones are bypass; port
    Python coder == native coder == reference Python coder."""
    st, cfg, syn, qp, _, coder, _, _ = streams["placebo_zl"].slices[-1]
    assert st == P_SLICE and syn.num_ref == 5
    syn = copy.deepcopy(syn)
    # one refIdx per CU (the coders read it at the CU's first cell),
    # intra CUs keep theirs
    cells = (cfg.ctu_size >> syn.depth8.astype(np.int32)) // 8
    ys, xs = np.indices(syn.depth8.shape)
    pick = np.random.default_rng(seed).integers(0, 5, syn.depth8.shape)
    ref8 = pick[ys // cells * cells, xs // cells * cells]
    if syn.intra8 is not None:
        ref8 = np.where(syn.intra8, 0 if syn.ref8 is None else syn.ref8,
                        ref8)
    syn.ref8 = ref8.astype(np.uint8)
    coder = dict(coder, ref8=syn.ref8)
    port = _python_data(port_syntax.SliceSyntaxEncoder, cfg, syn, st, qp,
                        coder)
    assert port == tuple(_native_data(st, cfg, syn, qp, coder))
    assert port == _python_data(ref_syntax.SliceSyntaxEncoder, _ref_cfg(cfg),
                                _ref_record(syn), st, qp, coder)


def _encode_i(cfg, frame, native, **kw):
    return IntraEncoder(cfg, device="cpu").encode_frame(
        *frame, use_native_cabac=native, **kw)


@pytest.mark.parametrize("case", ["plain", "wpp", "lossless", "dqp",
                                  "host_sao"])
def test_encode_frame_python_coder_writes_default_stream(case, monkeypatch):
    """IntraEncoder.encode_frame(use_native_cabac=False): the reference's
    Python-coder branches (WPP, lossless, dQP; x265_tpu/enc/encoder.py
    366-410) write the default stream."""
    from x265_tpu_torch.common.params import EncoderConfig
    frame = cs.small_clip(1)[0]
    kw = {}
    if case == "lossless":
        frame = _lossless_frame()[0]
    make = {"plain": lambda: cs.bench_config(64, 96),
            "wpp": lambda: EncoderConfig(width=96, height=64, qp=30,
                                         wpp=True, sao=True),
            "lossless": lambda: EncoderConfig(width=96, height=64, qp=32,
                                              lossless=True),
            "dqp": lambda: EncoderConfig(width=96, height=64, qp=32,
                                         aq_mode=2, deblock=True),
            "host_sao": lambda: EncoderConfig(width=96, height=64, qp=30,
                                              sao=True, ctu_size=16,
                                              keyint=1, bframes=0)}[case]
    if case == "dqp":
        # deltas from 1 to 14: cu_qp_delta_abs's prefix and EG0 suffix
        kw["qp_map"] = np.array([[31, 40, 26], [36, 32, 18]], np.int32)
    made = []

    class Counted(port_syntax.SliceSyntaxEncoder):
        def __init__(self, *a, **k):
            made.append(a[2])
            super().__init__(*a, **k)

    monkeypatch.setattr(encoder_mod, "SliceSyntaxEncoder", Counted)
    a = _encode_i(make(), frame, True, **kw)
    assert made == []
    b = _encode_i(make(), frame, False, **kw)
    assert made == [I_SLICE]           # the slice went through it
    assert a.bitstream == b.bitstream
    np.testing.assert_array_equal(a.recon.y, b.recon.y)


# ---------------------------------------------------------------------------
# mv_derive: the candidates of every CU the P and B slices code
# ---------------------------------------------------------------------------

def _as_ref_field(field):
    ref = object.__new__(getattr(ref_mv, type(field).__name__))
    ref.__dict__.update(copy.deepcopy(field.__dict__))
    return ref


@contextmanager
def compare_mv_derive(calls: list):
    """Wrap the port's candidate functions so that each call also runs
    the reference's on a copy of the same field and compares."""
    saved = {}

    def wrap(name):
        port_fn, ref_fn = getattr(port_mv, name), getattr(ref_mv, name)

        def run(*a, **k):
            got = port_fn(*a, **k)
            ra = [_as_ref_field(x) if isinstance(
                x, (port_mv.MvField, port_mv.MvFieldB)) else x for x in a]
            want = ref_fn(*ra, **k)
            assert got == want, (name, a[1:])
            calls.append(name)
            return got
        saved[name] = port_fn
        setattr(port_mv, name, run)

    for name in ("merge_candidates", "amvp_candidates", "temporal_mv_p",
                 "merge_candidates_b", "amvp_candidates_b"):
        wrap(name)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(port_mv, name, fn)


@pytest.mark.parametrize("name", ["bench_ippp", "fast_zl_strobe",
                                  "medium_zl_ctu64", "placebo_zl", "fast_b",
                                  "aq_cutree_seq"])
def test_mv_candidates_match_reference(streams, name):
    calls = []
    with compare_mv_derive(calls):
        for st, cfg, syn, qp, _, coder, _, _ in streams[name].slices:
            if st != I_SLICE:
                _python_data(port_syntax.SliceSyntaxEncoder, cfg, syn, st,
                             qp, coder)
    assert calls
    if name == "fast_zl_strobe":
        assert "temporal_mv_p" in calls
    if name == "fast_b":
        assert {"merge_candidates_b", "amvp_candidates_b"} <= set(calls)


def test_scale_mv_and_z_available_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(400):
        mv = tuple(int(v) for v in rng.integers(-300, 300, 2))
        tb, td = (int(v) for v in rng.integers(-8, 9, 2))
        if td == 0:
            continue
        assert port_mv._scale_mv(mv, tb, td) == ref_mv._scale_mv(mv, tb, td)
    for _ in range(400):
        nx, ny, cux, cuy = (int(v) for v in rng.integers(-8, 72, 4))
        args = (nx, ny, cux, cuy, 64, 48, 5)
        assert port_mv.z_available(*args) == ref_mv.z_available(*args)


# ---------------------------------------------------------------------------
# bit reader and CABAC engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_bitreader_reads_back_bitwriter(seed):
    rng = np.random.default_rng(seed)
    ops = []
    w = port_bw.BitWriter()
    for _ in range(600):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            n = int(rng.integers(1, 33))
            v = int(rng.integers(0, 1 << n, dtype=np.uint64))
            w.write(v, n)
        elif kind == 1:
            v = int(rng.integers(0, 1 << int(rng.integers(1, 20))))
            w.write_ue(v)
        elif kind == 2:
            v = int(rng.integers(-(1 << 15), 1 << 15))
            w.write_se(v)
        else:
            n, v = 1, int(rng.integers(0, 2))
            w.write_flag(v)
        ops.append((kind, v, n if kind == 0 else 1))
    w.align_one()
    data = w.get_bytes()
    for reader in (BitReader(data), ref_bw.BitReader(data)):
        for kind, v, n in ops:
            got = (lambda: reader.read(n), reader.read_ue, reader.read_se,
                   reader.read_flag)[kind]()
            assert got == v
        assert not reader.more_rbsp_data()
        assert reader.read_flag() == 1       # rbsp_stop_one_bit
        reader.byte_align()
        assert reader.bit_position == len(data) * 8


@pytest.mark.parametrize("seed", range(4))
def test_cabac_round_trip_matches_reference(seed):
    """A seeded sequence of context bins (skewed per context, so states
    move), bypass bins, bypass runs and terminate bins: the port's
    encoder writes the reference's bytes and the port's decoder (and the
    reference's) reads the sequence back."""
    rng = np.random.default_rng(seed)
    qp = int(rng.integers(0, 52))
    bias = rng.uniform(0.02, 0.98, NUM_CONTEXTS)
    seq = []
    for _ in range(4000):
        kind = int(rng.choice(4, p=[0.7, 0.15, 0.1, 0.05]))
        if kind == 0:
            c = int(rng.integers(0, NUM_CONTEXTS))
            seq.append((0, c, int(rng.random() < bias[c])))
        elif kind == 1:
            seq.append((1, 0, int(rng.integers(0, 2))))
        elif kind == 2:
            n = int(rng.integers(1, 17))
            seq.append((2, n, int(rng.integers(0, 1 << n))))
        else:
            seq.append((3, 0, 0))
    seq.append((3, 0, 1))
    outs = []
    for mod in (port_cabac, ref_cabac):
        ctx = mod.ContextSet(0)
        ctx.states = init_states(P_SLICE, qp)
        enc = mod.CabacEncoder(ctx)
        for kind, a, v in seq:
            (lambda: enc.encode_bin(a, v), lambda: enc.encode_bypass(v),
             lambda: enc.encode_bypass_bins(v, a),
             lambda: enc.encode_terminate(v))[kind]()
        bw = port_bw.BitWriter()
        enc.finish_into(bw)
        bw.align_one()
        outs.append((bw.get_bytes(), enc.ctx.states.copy()))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    for mod in (port_cabac, ref_cabac):
        ctx = mod.ContextSet(0)
        ctx.states = init_states(P_SLICE, qp)
        dec = mod.CabacDecoder(outs[0][0], ctx)
        for kind, a, v in seq:
            got = (lambda: dec.decode_bin(a), dec.decode_bypass,
                   lambda: dec.decode_bypass_bins(a),
                   dec.decode_terminate)[kind]()
            assert got == v
        np.testing.assert_array_equal(ctx.states, outs[0][1])


def test_context_set_and_counting_encoder_match_reference():
    """ContextSet.init_from / copy and the counting (RDO) mode."""
    iv = np.arange(0, 256, 7, dtype=np.uint8)
    a, b = port_cabac.ContextSet(len(iv)), ref_cabac.ContextSet(len(iv))
    a.init_from(30, iv)
    b.init_from(30, iv)
    np.testing.assert_array_equal(a.states, b.states)
    np.testing.assert_array_equal(a.copy().states, a.states)
    bits = []
    for mod in (port_cabac, ref_cabac):
        ctx = mod.ContextSet(0)
        ctx.states = init_states(I_SLICE, 30)
        enc = mod.CabacEncoder(ctx, counting=True)
        for i in range(300):
            enc.encode_bin(i % 50, (i * 7) % 3 == 0)
            enc.encode_bypass_bins(i & 7, 3)
            enc.encode_terminate(0)
        bits.append(enc.frac_bits)
    assert bits[0] == bits[1] > 0


# ---------------------------------------------------------------------------
# the numpy MC oracles and the boundary-strength maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("fx", range(4))
def test_mc_oracles_match_reference(bits, fx):
    """Luma at the quarter phases (fx, every fy) and chroma at the eighth
    phases (2 fx, 2 fx + 1; every fy), 8x8 luma / 4x4 chroma blocks on
    seeded planes, some reaching past the picture edge; the bi average
    of two luma accumulators."""
    rng = np.random.default_rng(bits * 10 + fx)
    top = (1 << bits) - 1
    luma = rng.integers(0, top + 1, (24, 32)).astype(np.int32)
    chroma = rng.integers(0, top + 1, (12, 16)).astype(np.int32)
    for fy in range(4):
        for x0, y0, ix, iy in ((8, 8, 1, -1), (0, 0, -3, -2),
                               (24, 16, 2, 3)):
            mvx, mvy = 4 * ix + fx, 4 * iy + fy
            for fn in ("luma_mc_np", "luma_mc_raw_np"):
                np.testing.assert_array_equal(
                    getattr(port_interp, fn)(luma, x0, y0, 8, mvx, mvy, bits),
                    getattr(ref_interp, fn)(luma, x0, y0, 8, mvx, mvy, bits))
            a = port_interp._luma_mc_acc(luma, x0, y0, 8, mvx, mvy, bits)
            np.testing.assert_array_equal(
                a, ref_interp._luma_mc_acc(luma, x0, y0, 8, mvx, mvy, bits))
            b = port_interp._luma_mc_acc(luma, x0, y0, 8, -mvy, mvx, bits)
            np.testing.assert_array_equal(
                port_interp.bi_average_np(a, b, bits),
                ref_interp.bi_average_np(a, b, bits))
            for cfx in (2 * fx, 2 * fx + 1):
                for cfy in (2 * fy, 2 * fy + 1):
                    cmx, cmy = 8 * ix + cfx, 8 * iy + cfy
                    for fn in ("chroma_mc_np", "chroma_mc_acc_np"):
                        np.testing.assert_array_equal(
                            getattr(port_interp, fn)(
                                chroma, x0 // 2, y0 // 2, 4, cmx, cmy, bits),
                            getattr(ref_interp, fn)(
                                chroma, x0 // 2, y0 // 2, 4, cmx, cmy, bits))


@pytest.mark.parametrize("name", ["bench_ippp", "fast_zl_strobe",
                                  "medium_zl_ctu64", "placebo_zl", "fast_b",
                                  "fast_b_aq2", "aq_cutree_seq", "main10"])
def test_inter_bs_maps_match_reference(streams, name):
    n = 0
    for st, cfg, syn, *_ in streams[name].slices:
        if st == P_SLICE:
            args = (syn.depth8, syn.mv8, syn.coeff_y, cfg.ctu_size)
            kw = dict(intra8=syn.intra8, tusplit8=syn.tusplit8)
            got = port_deblock.inter_bs_maps(*args, **kw)
            want = ref_deblock.inter_bs_maps(*args, **kw)
        elif st == B_SLICE:
            args = (syn.depth8, syn.mv8, syn.pf8, syn.coeff_y, cfg.ctu_size)
            got = port_deblock.inter_bs_maps_b(*args)
            want = ref_deblock.inter_bs_maps_b(*args)
        else:
            continue
        n += 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert n
