"""Batched device wavefront intra reconstruction.

Counterpart of x265_tpu/enc/intra_recon_tpu.py (reconstruct_intra_gop_tpu)
for CTU 32 and 64. The wavefront tile is 32 pixels at both sizes (intra
CUs cap at 32): at CTU 32 the tiles are the CTUs, processed along
anti-diagonals d = cx + 2*cy (the WPP dependency slope); at CTU 64 they
are the z-scan quadrants of each CTU, processed in the longest-path
levels of their dependency graph, and two per-lane flags carry what
z order changes: a bottom-right quadrant has no above-right samples,
and a top-left quadrant sees the left CTU's bottom-right quadrant as
its below-left column. Every frame of the batch rides the same
wavefront. Inside a tile the z-scan is a 16-step sweep with all three
CU sizes (and the PART_NxN 4x4 sub-TUs) evaluated masked per lane;
each CU is predicted from decoded neighbours, transformed, quantized
and reconstructed exactly as a decoder will, so recon == decoder
output.

Storage is tiled, (tiles, 32, 32) with tile 0 a zero dummy for absent
neighbours. On a GPU every step runs one fixed launch sequence over
lanes padded to the widest step, captured once as a CUDA graph and
replayed per step (the quadrant flags are lane data the step copies
in); on the CPU a step carries only its tiles and skips the masked CU
steps no lane takes. Recon and coefficient planes come back whole;
nothing is compacted.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bitstream.syntax import FrameIntraSyntax
from ..common.params import EncoderConfig
from ..common.tables import chroma_qp
from ..ops.intra import intra_pred_single_mode
from ..ops.transforms import (dct_batch, dequant_batch, idct_batch,
                              quant_batch, sign_hide_batch)
from .intra_analysis import edge_pad
from .intra_recon import ReconFrame

CTU = 32


def _zpos(p: int) -> tuple[int, int]:
    """z-order position p (0..15) -> (ox, oy) in pixels."""
    ox = ((p >> 2) & 1) * 16 + (p & 1) * 8
    oy = ((p >> 3) & 1) * 16 + ((p >> 1) & 1) * 8
    return ox, oy


def _zindex(bx: int, by: int) -> int:
    """min-block (bx, by) -> z-scan index within the CTU."""
    return (((by >> 1) & 1) << 3) | (((bx >> 1) & 1) << 2) | \
        ((by & 1) << 1) | (bx & 1)


@lru_cache(maxsize=None)
def _ref_geometry(n: int, ox: int, oy: int, p: int, ctu: int,
                  sub: int | None = None, bl: bool = False):
    """Static canonical-ref geometry for a CU of size n at (ox, oy):
    (4n+1,) tile-relative coords, decode-order availability (picture
    borders are checked per lane), halo indices, and the above-right-
    tile and below-left-column regions. `p` is the z index of the
    current min-block; `sub` (0..3) refines availability to the 4x4
    sub-TU z position inside it (PART_NxN). `bl` (CTU 64): the
    below-left column (x = -1, y >= ctu) counts as available here and
    is masked per lane; its indices point past the halo, into the
    below-left column appended to it."""
    k = 4 * n + 1
    bshift = (ctu // 4).bit_length() - 1    # 3 luma / 2 chroma
    rx = np.zeros(k, dtype=np.int32)
    ry = np.zeros(k, dtype=np.int32)
    for i in range(k):
        if i < 2 * n:
            rx[i], ry[i] = ox - 1, oy + (2 * n - 1 - i)
        elif i == 2 * n:
            rx[i], ry[i] = ox - 1, oy - 1
        else:
            rx[i], ry[i] = ox + (i - 2 * n - 1), oy - 1
    z_ok = np.zeros(k, dtype=bool)
    for i in range(k):
        x, y = int(rx[i]), int(ry[i])
        if y < 0:
            z_ok[i] = True          # top CTU row (or top-right CTU)
        elif x < 0:
            z_ok[i] = y < ctu or bl  # left CTU; below-left: CTU-64 TL
        elif x >= ctu or y >= ctu:
            z_ok[i] = False         # right CTU / below: undecoded
        elif sub is None:
            z_ok[i] = _zindex(x >> bshift, y >> bshift) < p
        else:
            z4 = _zindex(x >> 3, y >> 3) * 4 + \
                ((((y >> 2) & 1) << 1) | ((x >> 2) & 1))
            z_ok[i] = z4 < p * 4 + sub
    eh, ew = ctu + 1, 2 * ctu + 1
    bl_reg = (rx == -1) & (ry >= ctu)
    exti = np.minimum(np.clip(ry + 1, 0, eh - 1) * ew +
                      np.clip(rx + 1, 0, ew - 1), eh * ew - 1)
    if bl:
        exti = np.where(bl_reg, eh * ew + np.clip(ry - ctu, 0, ctu - 1),
                        exti)
    tr_reg = (ry < 0) & (rx >= ctu)
    return rx, ry, z_ok, exti.astype(np.int64), tr_reg, bl_reg


@lru_cache(maxsize=None)
def _ref_geometry_t(n: int, ox: int, oy: int, p: int, ctu: int,
                    sub: int | None, bl: bool, device: torch.device):
    """_ref_geometry as device tensors, uploaded once."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _ref_geometry(n, ox, oy, p, ctu, sub, bl))


def _substitute(refs: torch.Tensor, avail: torch.Tensor,
                bit_depth: int) -> torch.Tensor:
    """Reference substitution (8.4.4.2.2): each position takes the last
    available value at or before it; a leading unavailable run takes
    the first available value; no available sample gives mid-grey."""
    b, k = refs.shape
    iota = torch.arange(k, device=refs.device).expand(b, k)
    filled = torch.cummax(torch.where(avail, iota, -1), dim=1).values
    first = torch.argmax(avail.to(torch.int32), dim=1)
    out = torch.gather(refs, 1, torch.clamp(filled, min=0))
    out = torch.where(filled >= 0, out, torch.gather(refs, 1, first[:, None]))
    any_avail = avail.any(dim=1, keepdim=True)
    return torch.where(any_avail, out, 1 << (bit_depth - 1))


def _scan_sel(modes: torch.Tensor) -> torch.Tensor:
    """Mode-dependent coefficient scan (clause 7.4.9.11): VER for
    near-horizontal modes 6..14, HOR for near-vertical 22..30."""
    return torch.where((modes >= 6) & (modes <= 14), 2,
                       torch.where((modes >= 22) & (modes <= 30), 1, 0))


def _intra_tq(orig: torch.Tensor, pred: torch.Tensor, n: int, qp: int,
              bit_depth: int, sign_hiding: bool, scan_sel, dst: bool):
    """Intra TU pipeline on (B, n, n) blocks: returns (recon, coefs)."""
    resi = orig - pred
    tc = dct_batch(resi, n, bit_depth, dst=dst)
    if sign_hiding:
        coefs, du = quant_batch(tc, n, qp, bit_depth, intra=True,
                                with_rem=True)
        coefs = sign_hide_batch(coefs, n, scan_sel, du)
    else:
        coefs = quant_batch(tc, n, qp, bit_depth, intra=True)
    cbf = (coefs != 0).any(dim=2).any(dim=1)
    r = idct_batch(dequant_batch(coefs, n, qp, bit_depth), n, bit_depth,
                   dst=dst)
    maxv = (1 << bit_depth) - 1
    rec = torch.where(cbf[:, None, None], torch.clamp(pred + r, 0, maxv),
                      pred)
    return rec, torch.where(cbf[:, None, None], coefs, 0)


def _process_cu(ext, flat, cf_tile, orig_tile, x0s, y0s, modes, active, n,
                ox, oy, p, qp, bit_depth, w, h, is_luma, ctu, sign_hiding,
                sub=None, quad=None):
    """Reconstruct one masked CU (size n at tile position (ox, oy)) per
    lane, in place. ext: (B, ctu+1, 2ctu+1) halo tiles, a view of flat
    (_assemble_ext); cf_tile, orig_tile: (B, ctu, ctu); modes/active:
    (B,). quad (CTU 64 only): (tr_ok, bl_ok) (B,) bool, whether the
    tile's above-right tile and below-left column (flat's tail) are
    decoded."""
    rx, ry, z_ok, exti, tr_reg, bl_reg = _ref_geometry_t(
        n, ox, oy, p, ctu, sub, quad is not None, ext.device)
    refs = flat[:, exti]
    gx = x0s[:, None] + rx[None, :]
    gy = y0s[:, None] + ry[None, :]
    avail = z_ok[None, :] & (gx >= 0) & (gy >= 0) & (gx < w) & (gy < h)
    if quad is not None:
        avail = avail & (quad[0][:, None] | ~tr_reg[None, :]) & \
            (quad[1][:, None] | ~bl_reg[None, :])
    refs = _substitute(refs, avail, bit_depth)
    pred = intra_pred_single_mode(refs, modes, n, is_luma=is_luma,
                                  bit_depth=bit_depth)
    orig = orig_tile[:, oy:oy + n, ox:ox + n]
    mode_scan = (is_luma and n <= 8) or (not is_luma and n == 4)
    rec, coefs = _intra_tq(orig, pred, n, qp, bit_depth, sign_hiding,
                           _scan_sel(modes) if mode_scan else 0,
                           dst=is_luma and n == 4)
    sel = active[:, None, None]
    cur = ext[:, oy + 1:oy + 1 + n, ox + 1:ox + 1 + n]
    ext[:, oy + 1:oy + 1 + n, ox + 1:ox + 1 + n] = torch.where(sel, rec, cur)
    curc = cf_tile[:, oy:oy + n, ox:ox + n]
    cf_tile[:, oy:oy + n, ox:ox + n] = torch.where(sel, coefs, curc)


def _assemble_ext(tiles, ti, ti_top, ti_topright, ti_topleft, ti_left,
                  n: int, ti_belowleft=None):
    """(B, n+1, 2n+1) halo tiles from the tiled store (tile 0 = dummy),
    and the flat (B, (n+1)(2n+1)) buffer they view; with ti_belowleft
    (CTU 64) the buffer has a tail of n, the right column of the
    below-left tile. Returns (ext, flat)."""
    b = ti.shape[0]
    k = (n + 1) * (2 * n + 1)
    flat = torch.zeros((b, k + (0 if ti_belowleft is None else n)),
                       dtype=torch.int32, device=tiles.device)
    ext = flat[:, :k].view(b, n + 1, 2 * n + 1)
    ext[:, 0, 0] = tiles[ti_topleft][:, -1, -1]
    ext[:, 0, 1:n + 1] = tiles[ti_top][:, -1, :]
    ext[:, 0, n + 1:] = tiles[ti_topright][:, -1, :]
    ext[:, 1:, 0] = tiles[ti_left][:, :, -1]
    ext[:, 1:, 1:n + 1] = tiles[ti]
    if ti_belowleft is not None:
        flat[:, k:] = tiles[ti_belowleft][:, :, -1]
    return ext, flat


@lru_cache(maxsize=None)
def _wavefront_schedule(ncx: int, ncy: int, ctu: int = CTU):
    """Per wavefront step, the (cx, cy) tiles on it. CTU 32: the
    anti-diagonals d = cx + 2*cy. CTU 64: the tiles are z-scan
    quadrants, and a top-left quadrant also waits for its below-left
    tile (the left CTU's bottom-right quadrant) while a bottom-right
    one does not wait for its above-right tile; the steps are the
    longest-path levels of that dependency graph, tiles in raster
    order within a step."""
    if ctu != 64:
        ndiag = (ncx - 1) + 2 * (ncy - 1) + 1
        return [[(d - 2 * cy, cy) for cy in range(ncy)
                 if 0 <= d - 2 * cy < ncx] for d in range(ndiag)]

    def deps(cx, cy):
        q = (cy % 2) * 2 + (cx % 2)
        out = [(cx + dx, cy + dy)
               for dx, dy in ((-1, 0), (0, -1), (-1, -1), (1, -1))
               if not (q == 3 and (dx, dy) == (1, -1))]
        if q == 0:
            out.append((cx - 1, cy + 1))
        return [(x, y) for x, y in out if 0 <= x < ncx and 0 <= y < ncy]

    tiles = [(cx, cy) for cy in range(ncy) for cx in range(ncx)]
    dep = {t: deps(*t) for t in tiles}
    lev = dict.fromkeys(tiles, 0)
    changed = True
    while changed:
        changed = False
        for t in tiles:
            v = 1 + max((lev[d] for d in dep[t]), default=-1)
            if v != lev[t]:
                lev[t], changed = v, True
    steps = [[] for _ in range(max(lev.values()) + 1)]
    for t in tiles:
        steps[lev[t]].append(t)
    return steps


FAR = 1 << 20          # origin of a padding lane: outside every picture


def _lane_indices(cells, nf: int, ncx: int, ncy: int, lanes: int,
                  ctu: int = CTU):
    """Per-lane tile ids for one wavefront step (luma; cb|cr lanes for
    chroma), frame-major, padded to `lanes` lanes per frame with lanes
    outside the picture that read and write the dummy tile 0. At CTU 64
    also the quadrant flags: tr_ok (0 for a bottom-right quadrant, whose
    above-right tile is decoded later) and, for a top-left quadrant,
    its below-left tile (the left CTU's bottom-right quadrant) and
    bl_ok, whether that tile exists."""
    nct = ncx * ncy

    def tid(f, cy, cx):
        if cy < 0 or cx < 0 or cy >= ncy or cx >= ncx:
            return 0
        return 1 + f * nct + cy * ncx + cx

    rows = []
    for f in range(nf):
        for cx, cy in cells:
            tl = not (cx & 1) and not (cy & 1)
            bl = tid(f, cy + 1, cx - 1) if tl else 0
            rows.append((cx * CTU, cy * CTU, tid(f, cy, cx),
                         tid(f, cy - 1, cx), tid(f, cy - 1, cx + 1),
                         tid(f, cy - 1, cx - 1), tid(f, cy, cx - 1), bl,
                         f * nct + cy * ncx + cx, 1,
                         0 if (cx & 1) and (cy & 1) else 1, int(bl > 0)))
        rows += [(FAR, FAR, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0)] * \
            (lanes - len(cells))
    a = np.asarray(rows, dtype=np.int64)
    out = {"x0": a[:, 0], "y0": a[:, 1], "self_o": a[:, 8],
           "real": a[:, 9] != 0}
    keys = ("self", "top", "topright", "topleft", "left") + \
        (("belowleft",) if ctu == 64 else ())
    for j, key in enumerate(keys):
        t = a[:, 2 + j]
        out[key + "_y"] = t
        out[key + "_c"] = np.concatenate(
            [t, np.where(t > 0, t + nf * nct, 0)])
    out["self_oc"] = np.concatenate([a[:, 8], a[:, 8] + nf * nct])
    if ctu == 64:
        out["tr_ok"] = a[:, 10] != 0
        out["bl_ok"] = a[:, 11] != 0
    return out


def _diag_step(st: dict, inp: dict, host, *, qp: int, qpc: int, bd: int,
               w: int, h: int, sh: bool, use_nxn: bool) -> None:
    """One wavefront step across the lanes, updating the tiled stores
    st (rec_y, rec_c, cf_y, cf_c; org_y, org_c read) in place. inp holds
    the lanes' device tensors; host, when given, is (depth, nxn) numpy
    tiles of the lanes so masked CU steps that no lane takes are
    skipped — None runs every step (a fixed launch sequence, as a CUDA
    graph needs)."""
    half = CTU // 2
    x0s, y0s = inp["x0"], inp["y0"]
    x0c = torch.cat([x0s, x0s]) // 2
    y0c = torch.cat([y0s, y0s]) // 2

    def ext_of(tiles, sfx, n):
        return _assemble_ext(tiles, *(inp[k + sfx] for k in (
            "self", "top", "topright", "topleft", "left")), n,
            inp.get("belowleft" + sfx))

    ext_y, flat_y = ext_of(st["rec_y"], "_y", CTU)
    ext_c, flat_c = ext_of(st["rec_c"], "_c", half)
    if "tr_ok" in inp:
        # CTU 64: the z-quadrant flags, lane data like the tile ids
        tr, bl = inp["tr_ok"], inp["bl_ok"]
        quad_y = (tr, bl)
        quad_c = (torch.cat([tr, tr]), torch.cat([bl, bl]))
    else:
        quad_y = quad_c = None
    oy_t = st["org_y"][inp["self_o"]]
    oc_t = st["org_c"][inp["self_oc"]]
    b = x0s.shape[0]
    dev = x0s.device
    cfy_t = torch.zeros((b, CTU, CTU), dtype=torch.int32, device=dev)
    cfc_t = torch.zeros((2 * b, half, half), dtype=torch.int32, device=dev)
    dt, mt, ct, nt, m4t = (inp[k] for k in ("dt", "mt", "ct", "nt", "m4t"))

    for p in range(16):
        ox, oy = _zpos(p)
        cy8, cx8 = oy >> 3, ox >> 3
        d = dt[:, cy8, cx8]
        m = mt[:, cy8, cx8]
        cm = ct[:, cy8, cx8]
        is_nxn = nt[:, cy8, cx8] != 0
        if host is not None:
            d_np = host[0][:, cy8, cx8]
            nx_np = host[1][:, cy8, cx8] != 0
        else:
            d_np = nx_np = None
        plans = [(8, ox, oy, (d == 2) & ~is_nxn, d == 2,
                  lambda: d_np == 2, lambda: (d_np == 2) & ~nx_np)]
        if p % 4 == 0:
            plans.append((16, (ox >> 4) << 4, (oy >> 4) << 4, d == 1, d == 1,
                          lambda: d_np == 1, lambda: d_np == 1))
        if p == 0:
            plans.append((32, 0, 0, d == 0, d == 0, lambda: d_np == 0,
                          lambda: d_np == 0))
        for n, cox, coy, act, cact, any_c, any_y in plans:
            if host is not None and not any_c().any():
                continue
            if host is None or any_y().any():
                _process_cu(ext_y, flat_y, cfy_t, oy_t, x0s, y0s, m, act, n,
                            cox, coy, p, qp, bd, w, h, True, CTU, sh,
                            quad=quad_y)
            _process_cu(ext_c, flat_c, cfc_t, oc_t, x0c, y0c,
                        torch.cat([cm, cm]), torch.cat([cact, cact]), n >> 1,
                        cox >> 1, coy >> 1, p, qpc, bd, w // 2, h // 2,
                        False, half, sh, quad=quad_c)
        if use_nxn and (host is None or ((d_np == 2) & nx_np).any()):
            # PART_NxN: four 4x4 luma PU/TUs in z order, each predicting
            # from the previous sub-TUs' reconstruction
            act4 = (d == 2) & is_nxn
            for s_, (sx, sy) in enumerate(((0, 0), (4, 0), (0, 4), (4, 4))):
                m4 = m4t[:, (oy + sy) >> 2, (ox + sx) >> 2]
                _process_cu(ext_y, flat_y, cfy_t, oy_t, x0s, y0s, m4, act4,
                            4, ox + sx, oy + sy, p, qp, bd, w, h, True, CTU,
                            sh, sub=s_, quad=quad_y)
    # padding lanes write the dummy tile 0, which is only ever read as
    # an unavailable neighbour
    st["rec_y"][inp["self_y"]] = ext_y[:, 1:, 1:1 + CTU]
    st["rec_c"][inp["self_c"]] = ext_c[:, 1:, 1:1 + half]
    st["cf_y"][inp["self_y"]] = cfy_t
    st["cf_c"][inp["self_c"]] = cfc_t


def _run_graphed(st: dict, diag_inputs: list[dict], step) -> None:
    """Run the wavefront steps as replays of one CUDA graph: the step is
    captured once (after a warm-up of step 0, which a step may repeat:
    it reads only earlier steps' tiles), then each step copies its lane
    tensors (tile ids, decisions and, at CTU 64, the quadrant flags)
    into the static inputs and replays. Replays
    cut the per-launch host cost of the ~10^4 small kernels a step
    issues, which dominates the eager wavefront."""
    static = {k: v.clone() for k, v in diag_inputs[0].items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(st, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(st, static)
    for inp in diag_inputs:
        for k, v in inp.items():
            static[k].copy_(v)
        graph.replay()


def reconstruct_intra_gop_gpu(orig_y: torch.Tensor, orig_cb: torch.Tensor,
                              orig_cr: torch.Tensor, depth8: np.ndarray,
                              mode8: np.ndarray, cfg: EncoderConfig,
                              qp: int | None = None,
                              cmode8: np.ndarray | None = None,
                              nxn8: np.ndarray | None = None,
                              mode4: np.ndarray | None = None,
                              fixed_steps: bool | None = None):
    """Reconstruct a batch of intra frames on the device.

    orig_*: (F, H, W) uint8 (uint16 at 10 bits) planes on the device
    (8-aligned coded size); depth8/mode8/cmode8/nxn8: (F, H/8, W/8) and
    mode4 (F, H/4, W/4) host decision maps, depth8 relative to the SPS CTU
    (at CTU 64 never 0: intra CUs cap at 32). Returns (syns, (rec_y,
    rec_cb, rec_cr)): FrameIntraSyntax records with host coefficient
    planes, and int32 device recon planes (F, H, W) / (F, H/2, W/2).

    fixed_steps (default: on for CUDA): every wavefront step runs the
    same launch sequence over lanes padded to the widest step, replayed
    as one CUDA graph on a GPU; off, a step carries only its tiles and
    skips CU steps no lane takes. Both give the same result."""
    if cfg.ctu_size not in (32, 64):
        raise NotImplementedError(
            "CTU 16: the device wavefront runs CTU 32 and 64; a CTU-16 "
            "I frame takes the host-recon I path (IntraEncoder."
            "encode_frame)")
    ctu64 = cfg.ctu_size == 64
    nf, h, w = orig_y.shape
    dev = orig_y.device
    fixed = dev.type == "cuda" if fixed_steps is None else fixed_steps
    half = CTU // 2
    ncx = (w + CTU - 1) // CTU
    ncy = (h + CTU - 1) // CTU
    nct = ncy * ncx
    qp = cfg.qp if qp is None else qp

    def tiles_of(planes, m):
        p = edge_pad(planes.to(torch.int32), ncy * m, ncx * m)
        return p.reshape(-1, ncy, m, ncx, m).permute(0, 1, 3, 2, 4) \
            .reshape(-1, m, m)

    # tiled stores: tile 0 is the dummy for absent neighbours
    rec_y = torch.zeros((nf * nct + 1, CTU, CTU), dtype=torch.int32,
                        device=dev)
    rec_c = torch.zeros((2 * nf * nct + 1, half, half), dtype=torch.int32,
                        device=dev)
    st = {"rec_y": rec_y, "rec_c": rec_c, "cf_y": torch.zeros_like(rec_y),
          "cf_c": torch.zeros_like(rec_c), "org_y": tiles_of(orig_y, CTU),
          "org_c": tiles_of(torch.cat([orig_cb, orig_cr]), half)}

    # per-CTU decision tiles (host); CTUs past the coded area are
    # all-8x8 DC (their CUs lie outside the picture, never coded)
    n8, n4 = CTU // 8, CTU // 4
    n8y, n8x = depth8.shape[1:]
    use_nxn = nxn8 is not None and bool(np.any(nxn8))

    def tile_dec(src, fill, k, hh, ww):
        pad = np.full((nf, ncy * k, ncx * k), fill, np.int64)
        if src is not None:
            pad[:, :hh, :ww] = src
        return pad.reshape(nf, ncy, k, ncx, k).transpose(0, 1, 3, 2, 4) \
            .reshape(nf * nct, k, k)

    # tile-relative depth: at CTU 64 the SPS depth is one level deeper
    # than the 32-tile's (the forced split of the 64 level)
    dec = {"dt": tile_dec(np.maximum(depth8.astype(np.int64) - 1, 0)
                          if ctu64 else depth8, 2, n8, n8y, n8x),
           "mt": tile_dec(mode8, 1, n8, n8y, n8x),
           "ct": tile_dec(mode8 if cmode8 is None else cmode8, 1, n8, n8y,
                          n8x),
           "nt": tile_dec(nxn8 if use_nxn else None, 0, n8, n8y, n8x),
           "m4t": tile_dec(mode4 if use_nxn else None, 1, n4, 2 * n8y,
                           2 * n8x)}
    fill = {"dt": 2, "mt": 1, "ct": 1, "nt": 0, "m4t": 1}
    diags = _wavefront_schedule(ncx, ncy, cfg.ctu_size)
    bmax = max(len(c) for c in diags)
    inputs, hosts = [], []
    for cells in diags:
        ix = _lane_indices(cells, nf, ncx, ncy, bmax if fixed else len(cells),
                           cfg.ctu_size)
        real = ix.pop("real")
        for k, a in dec.items():
            v = a[ix["self_o"]]
            v[~real] = fill[k]
            ix[k] = v
        hosts.append((ix["dt"], ix["nt"]))
        inputs.append({k: torch.as_tensor(v, device=dev)
                       for k, v in ix.items()})

    kw = dict(qp=qp, qpc=chroma_qp(qp), bd=cfg.bit_depth, w=w, h=h,
              sh=cfg.sign_hiding, use_nxn=use_nxn)
    if fixed and dev.type == "cuda":
        _run_graphed(st, inputs,
                     lambda st_, inp: _diag_step(st_, inp, None, **kw))
    else:
        for inp, host in zip(inputs, hosts):
            _diag_step(st, inp, None if fixed else host, **kw)

    def untile(tiles, count, m):
        return tiles[1:1 + count].reshape(-1, ncy, ncx, m, m) \
            .permute(0, 1, 3, 2, 4).reshape(-1, ncy * m, ncx * m)

    ry = untile(st["rec_y"], nf * nct, CTU)[:, :h, :w]
    rc = untile(st["rec_c"], 2 * nf * nct, half)[:, :h // 2, :w // 2]
    cfy_np = untile(st["cf_y"], nf * nct, CTU)[:, :h, :w].cpu().numpy()
    cfc_np = untile(st["cf_c"], 2 * nf * nct, half)[:, :h // 2, :w // 2] \
        .cpu().numpy()
    syns = [FrameIntraSyntax(
        depth8=depth8[f], mode8=mode8[f], coeff_y=cfy_np[f],
        coeff_cb=cfc_np[f], coeff_cr=cfc_np[nf + f],
        cmode8=None if cmode8 is None else cmode8[f],
        nxn8=None if nxn8 is None else nxn8[f],
        mode4=None if mode4 is None else mode4[f]) for f in range(nf)]
    return syns, (ry, rc[:nf], rc[nf:])


def reconstruct_intra_frame_gpu(orig_y: torch.Tensor, orig_cb: torch.Tensor,
                                orig_cr: torch.Tensor, depth8: np.ndarray,
                                mode8: np.ndarray, cfg: EncoderConfig,
                                qp: int | None = None,
                                cmode8: np.ndarray | None = None,
                                nxn8: np.ndarray | None = None,
                                mode4: np.ndarray | None = None):
    """One intra frame through reconstruct_intra_gop_gpu: orig_* (H, W)
    and (H/2, W/2) planes on the device, the decision maps of that one
    frame. Returns (FrameIntraSyntax, ReconFrame) with int32 host recon
    planes."""
    syns, (ry, rcb, rcr) = reconstruct_intra_gop_gpu(
        orig_y[None], orig_cb[None], orig_cr[None], depth8[None],
        mode8[None], cfg, qp,
        cmode8=None if cmode8 is None else cmode8[None],
        nxn8=None if nxn8 is None else nxn8[None],
        mode4=None if mode4 is None else mode4[None])
    return syns[0], ReconFrame(*(p[0].cpu().numpy() for p in (ry, rcb, rcr)))
