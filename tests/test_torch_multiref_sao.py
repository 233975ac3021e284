"""Port parity for multi-reference P prediction, TMVP and SAO: the
modules (me_all_sizes on a stack of references, the windowed chroma
predictions in multi-reference mode, the composed search current, and
the three SAO functions) against x265_tpu on the same numpy inputs, and
two whole streams against x265_tpu's:

  (a) --preset fast --tune zerolatency (3 references, TMVP, SAO, me_range
      5, CTU 32) on strobe content, 1 I + 6 P in chunks of 2, so the
      reference stack crosses chunk boundaries;
  (b) num_refs=2, tmvp, max_merge=3, no SAO (the configuration of
      tests/test_smoke.py's default-tools case) on panning strobe
      content, 1 I + 4 P in chunks of 2.

Each stream is byte-identical to the reference's and x265_tpu.decoder
decodes it to the port's recon (the port's I frame through its device
wavefront, the reference's through its host recon, handed on as a
reference stack: tests/test_torch_encoder.py reference_i_frame). One
reference encode and one port encode per configuration are shared by
the module-scoped fixtures.
Tolerance: exact equality everywhere (integer outputs)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265_tpu.common.params import EncoderConfig as RefConfig
from x265_tpu.decoder import decode_annexb
from x265_tpu.enc import IntraEncoder as RefEncoder
from x265_tpu.enc import pgop_tpu as ref_pgop
from x265_tpu.ops import me_win as ref_me
from x265_tpu.ops import sao_tpu as ref_sao
from test_torch_encoder import reference_i_frame
from x265_tpu_torch.common.tables import lambda2_from_qp
from x265_tpu_torch.convert import config_from_dict
from x265_tpu_torch.enc import IntraEncoder
from x265_tpu_torch.enc import pgop_gpu as port_pgop
from x265_tpu_torch.ops import me_win as port_me
from x265_tpu_torch.ops import sao_gpu as port_sao

torch.set_num_threads(2)

H, W = 64, 96
R = 3


# ---------------------------------------------------------------------------
# module parity: multi-reference ME and chroma
# ---------------------------------------------------------------------------

def _lanes_np(plane, n):
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).transpose(1, 3, 0, 2) \
        .reshape(n, n, -1)


def _compose_np(planes, sel, blk):
    """Per pixel, the plane that the block's selection names."""
    selpix = np.repeat(np.repeat(sel, blk, 0), blk, 1)
    return np.take_along_axis(np.stack(planes), selpix[None], 0)[0]


def _multiref_inputs(seed=5):
    """A current picture, three references (the current shifted by
    different amounts, with their own noise) and their chroma, the
    per-region selections mixing all three references, and seeds."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = ((xx * 3 + yy * 2 + ((xx * yy) >> 6)) % 256).astype(np.int32)
    cur = np.clip(base + rng.integers(-8, 8, (H, W)), 0, 255)
    refs = [np.clip(np.roll(base, -(2 + 3 * k), axis=1) +
                    rng.integers(-6, 6, (H, W)), 0, 255) for k in range(R)]
    cbs = [np.clip(120 + (xx[::2, ::2] >> 3) + 2 * k +
                   rng.integers(-3, 3, (H // 2, W // 2)), 0, 255)
           for k in range(R)]
    crs = [np.clip(132 - (yy[::2, ::2] >> 3) - k, 0, 255) for k in range(R)]
    ref16 = rng.integers(0, R, (H // 16, W // 16)).astype(np.int32)
    ref16[0, :3] = (0, 1, 2)
    ref32 = rng.integers(0, R, (H // 32, W // 32)).astype(np.int32)
    ref32[0, :3] = (2, 0, 1)
    cmv16 = rng.integers(-9, 10, (H // 16, W // 16, 2)).astype(np.int32)
    cmv32 = rng.integers(-9, 10, ((H // 32) * (W // 32), 2)).astype(np.int32)
    i32 = lambda a: [p.astype(np.int32) for p in a]   # noqa: E731
    return (cur.astype(np.int32), i32(refs), i32(cbs), i32(crs), ref16,
            ref32, cmv16, cmv32)


@pytest.mark.parametrize("weighted", (False, True))
def test_me_all_sizes_and_chroma_preds_multiref(weighted):
    """Three references stacked vertically, each 16-region and 32-block
    on its own reference (all three used), the 32-block seeds from
    cmv32, zero-MV candidates from the composed planes and, weighted,
    explicit weights that reach reference 0 only: MVs, costs and
    predictions of every block size, then the windowed chroma
    predictions at those MVs, at 64x96 and me_range 5."""
    cur, refs, cbs, crs, ref16, ref32, cmv16, cmv32 = _multiref_inputs()
    r = 5
    pad_y, pad_c = 2 * r + 8, r + 8
    lam = 37
    wvec = np.array([70, -3, 60, 2, 66, 1], np.int32) if weighted else None
    ref_pad = np.concatenate([np.pad(p.astype(np.uint8), pad_y, mode="edge")
                              for p in refs])
    stride = H + 2 * pad_y
    zy = {16: _compose_np(refs, ref16, 16), 32: _compose_np(refs, ref32, 32)}
    kw = dict(radius=r, pad=pad_y, bit_depth=8, ref_stride=stride)

    # the reference as one jitted program (one compile, kept by the
    # persistent cache, instead of hundreds of eager ones)
    jres, jseeds = jax.jit(functools.partial(ref_me.me_all_sizes, **kw))(
        jnp.asarray(cur), jnp.asarray(ref_pad), jnp.asarray(cmv16),
        jnp.int32(lam), wvec=None if wvec is None else jnp.asarray(wvec),
        ref16=jnp.asarray(ref16.reshape(-1)),
        ref32=jnp.asarray(ref32.reshape(-1)), cmv32=jnp.asarray(cmv32),
        zero_planes={k: jnp.asarray(v) for k, v in zy.items()})
    tres, tseeds = port_me.me_all_sizes(
        torch.from_numpy(cur), torch.from_numpy(ref_pad),
        torch.from_numpy(cmv16), lam,
        wvec=None if wvec is None else torch.from_numpy(wvec),
        ref16=torch.from_numpy(ref16.reshape(-1)),
        ref32=torch.from_numpy(ref32.reshape(-1)),
        cmv32=torch.from_numpy(cmv32),
        zero_planes={k: torch.from_numpy(v) for k, v in zy.items()}, **kw)
    for n in (8, 16, 32):
        for k in range(3):
            np.testing.assert_array_equal(np.asarray(jres[n][k]),
                                          tres[n][k].numpy(),
                                          err_msg=f"n={n} field {k}")
    for n in (16, 32):
        for k in range(2):
            np.testing.assert_array_equal(np.asarray(jseeds[n][k]),
                                          tseeds[n][k].numpy())

    cpad2 = np.stack([
        np.concatenate([np.pad(p.astype(np.uint8), pad_c, mode="edge")
                        for p in planes]) for planes in (cbs, crs)])
    zc = {16: (_compose_np(cbs, ref16, 8), _compose_np(crs, ref16, 8)),
          32: (_compose_np(cbs, ref32, 16), _compose_np(crs, ref32, 16))}
    arrays = dict(cpad2=cpad2, refcb=cbs[0], refcr=crs[0], wvec=wvec,
                  ref16=ref16.reshape(-1), ref32=ref32.reshape(-1))
    ckw = dict(pc=pad_c, radius=r, h=H, w=W, bit_depth=8,
               cstride=H // 2 + 2 * pad_c)
    jc = jax.jit(functools.partial(ref_pgop._chroma_preds_windowed, **ckw))(
        mvs={n: jres[n][0] for n in (8, 16, 32)}, seeds=jseeds,
        zplanes={k: tuple(jnp.asarray(p) for p in v) for k, v in zc.items()},
        **{k: None if v is None else jnp.asarray(v)
           for k, v in arrays.items()})
    tc = port_pgop._chroma_preds_windowed(
        mvs={n: tres[n][0] for n in (8, 16, 32)}, seeds=tseeds,
        zplanes={k: tuple(torch.from_numpy(p) for p in v)
                 for k, v in zc.items()},
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in arrays.items()}, **ckw)
    for n in (8, 16, 32):
        for k in range(2):
            np.testing.assert_array_equal(np.asarray(jc[n][k]),
                                          tc[n][k].numpy(),
                                          err_msg=f"chroma n={n} plane {k}")


@pytest.mark.parametrize("n,k", ((8, 16), (32, 32)))
def test_search_plane_gives_the_reference_lanes(n, k):
    """The reference picks the search current per block,
    jnp.where(wm, cur_s, cur) on (n, n, B) lanes; the port's search
    kernels take one plane, composed per region. The composed plane's
    lanes must be the reference's: the 8-block lanes from the 16-region
    mask (the pair search), the 32-block lanes from the 32-block mask."""
    rng = np.random.default_rng(k)
    cur = rng.integers(0, 256, (H, W)).astype(np.int32)
    cur_s = rng.integers(0, 256, (H, W)).astype(np.int32)
    wm = rng.integers(0, 2, (H // k) * (W // k)).astype(bool)
    wm[:2] = (True, False)
    wm_n = np.repeat(np.repeat(wm.reshape(H // k, W // k), k // n, 0),
                     k // n, 1).reshape(-1)
    want = np.where(wm_n[None, None, :], _lanes_np(cur_s, n),
                    _lanes_np(cur, n))
    plane = port_me.search_plane(torch.from_numpy(cur),
                                 torch.from_numpy(cur_s),
                                 torch.from_numpy(wm), k)
    np.testing.assert_array_equal(port_me.lanes_of(plane, n).numpy(), want)


# ---------------------------------------------------------------------------
# module parity: SAO
# ---------------------------------------------------------------------------

def _sao_planes(h, w, seed):
    """A source plane and a 'reconstruction' of it that SAO can improve:
    the left third textured with ringing along x (EO territory), the
    rest a smooth ramp shifted by a constant (BO territory: edge
    categories cannot see a shift of flat samples)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = ((xx * 5 + yy * 3) % 180) + 40 + rng.integers(-4, 5, (h, w))
    ramp = 90 + (xx + yy) // 6
    left = xx < w // 3
    orig = np.clip(np.where(left, tex, ramp), 0, 255)
    ring = np.where(xx % 2 == 0, 3, -3)
    rec = np.clip(np.where(left, orig + ring + rng.integers(-2, 3, (h, w)),
                           orig - 5), 0, 255)
    return orig.astype(np.int32), rec.astype(np.int32)


@pytest.mark.parametrize("h,w", ((64, 96), (72, 96)))
def test_sao_luma_decision_and_apply(h, w):
    """choose_sao_t (CTU 32; 72 rows leave a partial CTU row) and
    apply_sao_t of its parameters, against the reference."""
    orig, rec = _sao_planes(h, w, seed=h)
    lam = float(lambda2_from_qp(32))
    want = np.asarray(ref_sao.choose_sao_t(jnp.asarray(orig),
                                           jnp.asarray(rec), 32, 32, 8, lam))
    got = port_sao.choose_sao_t(torch.from_numpy(orig),
                                torch.from_numpy(rec), 32, 32, 8, lam)
    np.testing.assert_array_equal(want, got.numpy())
    assert {1, 2} <= set(want[..., 0].ravel().tolist()), \
        "the clip should make both EO and BO win somewhere"
    np.testing.assert_array_equal(
        np.asarray(ref_sao.apply_sao_t(jnp.asarray(rec), jnp.asarray(want),
                                       32, 8)),
        port_sao.apply_sao_t(torch.from_numpy(rec), got, 32, 8).numpy())


@pytest.mark.parametrize("h,w", ((32, 48), (36, 48)))
def test_sao_chroma_decision_and_apply(h, w):
    """choose_sao_chroma_t (joint cb/cr, CTU 16) and apply_sao_t of its
    parameters on both planes, against the reference."""
    ocb, rcb = _sao_planes(h, w, seed=h + 1)
    ocr, rcr = _sao_planes(h, w, seed=h + 2)
    rcr = np.clip(rcr + 2, 0, 255).astype(np.int32)
    lam = float(lambda2_from_qp(30))
    j = lambda a: jnp.asarray(a)               # noqa: E731
    t = lambda a: torch.from_numpy(a)          # noqa: E731
    want = ref_sao.choose_sao_chroma_t(j(ocb), j(rcb), j(ocr), j(rcr), 16,
                                       30, 8, lam)
    got = port_sao.choose_sao_chroma_t(t(ocb), t(rcb), t(ocr), t(rcr), 16,
                                       30, 8, lam)
    for wp, gp, rec in zip(want, got, (rcb, rcr)):
        np.testing.assert_array_equal(np.asarray(wp), gp.numpy())
        np.testing.assert_array_equal(
            np.asarray(ref_sao.apply_sao_t(j(rec), wp, 16, 8)),
            port_sao.apply_sao_t(t(rec), gp, 16, 8).numpy())
    assert np.asarray(want[0])[..., 0].any()


def test_sao_apply_every_type_class_and_band():
    """apply_sao_t with parameters drawn at random per CTU (OFF, BO at
    every band position including the wrap past 31, EO in all four
    classes, offsets of both signs) against the reference."""
    rng = np.random.default_rng(3)
    _, rec = _sao_planes(72, 96, seed=9)
    rec[:8] = rng.integers(0, 256, (8, 96))         # every band occurs
    params = np.zeros((3, 3, 6), np.int32)
    params[..., 0] = rng.integers(0, 3, (3, 3))
    params[..., 1] = np.where(params[..., 0] == 2,
                              rng.integers(0, 4, (3, 3)),
                              rng.integers(0, 32, (3, 3)))
    params[0, :3, :2] = ((1, 30), (2, 3), (1, 0))
    params[..., 2:] = rng.integers(-7, 8, (3, 3, 4))
    np.testing.assert_array_equal(
        np.asarray(ref_sao.apply_sao_t(jnp.asarray(rec), jnp.asarray(params),
                                       32, 8)),
        port_sao.apply_sao_t(torch.from_numpy(rec), torch.from_numpy(params),
                             32, 8).numpy())


# ---------------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------------

def _strobe_frames(n, pan=0, seed=0):
    """Two alternating textures (as tests/test_multiref.py's flicker
    clip): frame k matches frame k - 2, so reference 1 wins where the
    texture flips. With pan, frame k is also shifted by pan * k pixels,
    so the matching reference sits at a nonzero motion vector."""
    rng = np.random.default_rng(seed)
    texa = rng.integers(0, 255, (H, W + pan * n)).astype(np.uint8)
    texb = rng.integers(0, 255, (H, W + pan * n)).astype(np.uint8)
    ca = rng.integers(100, 160, (H // 2, W // 2)).astype(np.uint8)
    cb = rng.integers(100, 160, (H // 2, W // 2)).astype(np.uint8)
    return [((texa, texb)[k % 2][:, pan * k:pan * k + W],
             (ca, cb)[k % 2], (ca, cb)[k % 2]) for k in range(n)]


def _fast_zerolatency():
    cfg = RefConfig(width=W, height=H, qp=32)
    cfg.apply_preset("fast")
    cfg.apply_tune("zerolatency")
    return cfg


CONFIGS = {
    "fast_zerolatency": (_fast_zerolatency, dict(n=7)),
    "refs2_tmvp_merge3": (
        lambda: RefConfig(width=W, height=H, qp=32, deblock=True, sao=False,
                          num_refs=2, tmvp=True, max_merge=3),
        dict(n=5, pan=2, seed=4)),
}


def _encode(enc, frames):
    """I frame at QP - 3, then pipelined P chunks of 2 (need_recon for
    the decode check). The port's I frame goes through its device
    wavefront, the reference's through its host recon, whose bytes and
    recon are its wavefront's, as a reference stack
    (tests/test_torch_encoder.py reference_i_frame)."""
    if isinstance(enc, RefEncoder):
        r0 = reference_i_frame(enc, frames[0], enc.cfg.qp - 3)
    else:
        r0 = enc.encode_frame(*frames[0], qp=enc.cfg.qp - 3,
                              use_device_recon=True)
        enc.ref = r0.device_ref
        enc.poc = 0
    return [r0] + enc.encode_pgop_pipelined(frames[1:], chunk=2,
                                            need_recon=True)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def streams(request):
    make_cfg, clip = CONFIGS[request.param]
    rcfg = make_cfg()
    frames = _strobe_frames(**clip)
    ref = _encode(RefEncoder(rcfg), frames)
    port = _encode(IntraEncoder(config_from_dict(dataclasses.asdict(rcfg)),
                                device="cpu"), frames)
    return request.param, rcfg, ref, port


def test_stream_matches_reference(streams):
    name, rcfg, ref, port = streams
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a.bitstream == b.bitstream, f"{name}: frame {i}"


def test_stream_decodes_to_port_recon(streams):
    name, rcfg, ref, port = streams
    dec = decode_annexb(b"".join(r.bitstream for r in port))
    assert len(dec) == len(port)
    for i, (d, r) in enumerate(zip(dec, port)):
        for k in ("y", "cb", "cr"):
            np.testing.assert_array_equal(getattr(d, k), getattr(r.recon, k),
                                          err_msg=f"{name}: frame {i} {k}")


def test_stream_uses_older_references_and_its_tools(streams):
    """The strobe content must drive what the configuration turns on:
    P frames that predict from reference 1 or later (after the first,
    which has one reference), TMVP's collocated picture (the previous P
    frame) and with SAO a P-frame CTU whose SAO is on."""
    name, rcfg, ref, port = streams
    ps = port[1:]
    assert ps[0].syntax.ref8 is None and ps[0].syntax.num_ref == 1
    assert any(r.syntax.ref8 is not None and (r.syntax.ref8 > 0).any()
               for r in ps[1:])
    assert [r.syntax.num_ref for r in ps] == \
        [min(k + 1, rcfg.num_refs) for k in range(len(ps))]
    assert all(r.syntax.col_poc == r.poc - 1 for r in ps[1:])
    if rcfg.sao:
        assert any(any(p[..., 0].any() for p in r.syntax.sao_params)
                   for r in ps)
    else:
        assert all(r.syntax.sao_params is None for r in ps)
