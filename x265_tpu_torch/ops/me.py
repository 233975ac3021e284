"""Batched hierarchical motion estimation: the 4x4 mean pool and the MV
bit-cost proxy the windowed searches share, and the dense search of the
host B path (counterpart of x265_tpu/ops/me.py).

The host B path searches every block of every size at once: (1) a
full search at quarter resolution scores every shift of every 4x4
block (coarse_search); (2) per size a fixed-iteration integer diamond
on full-resolution blocks, seeded by the coarse MV and its neighbours,
then a half- and quarter-pel refinement scored by SA8D with the
normative interpolation (refine_size). Every reference block is
gathered at its own position (_sad_at, ops/interp.py _gather_patches):
no window gather. Costs are int32; every comparison is a strict < in
the reference's candidate order, so ties keep the earlier candidate.

MVs are in quarter-pel units, per 8/16/32 block grids.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.tables import lambda_from_qp
from ..device import resolve_device
from .interp import mc_block_batch
from .satd import sa8d_nxn_batch


def _downsample4(plane: torch.Tensor) -> torch.Tensor:
    """4x4 mean pool (integer: sum >> 4 == truncated float mean for
    non-negative pixels)."""
    h, w = plane.shape
    p = plane[:h // 4 * 4, :w // 4 * 4].to(torch.int32)
    p = p[0::2, :] + p[1::2, :]
    p = p[0::2, :] + p[1::2, :]
    p = p[:, 0::2] + p[:, 1::2]
    p = p[:, 0::2] + p[:, 1::2]
    return p >> 4


def bitlen(a: torch.Tensor) -> torch.Tensor:
    """Integer bit length of a >= 0 (== ceil(log2(a + 1))) read from the
    float32 exponent field; exact for a < 2^24."""
    e = (a.to(torch.float32).view(torch.int32) >> 23) - 126
    return torch.where(a > 0, e, 0)


def _mv_bits(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Approximate Exp-Golomb signalling cost of an MVD, in bits:
    2 * ceil(log2(|v| + 1)) + 1 per component. The reference evaluates
    the logarithm in float32; the integer bit length is the same value
    for |v| < 2^21, far beyond any MV the search reaches."""
    return 2 * bitlen(torch.abs(dx)) + 1 + 2 * bitlen(torch.abs(dy)) + 1


def coarse_search(cur4: torch.Tensor, ref4: torch.Tensor, radius: int = 8,
                  blk: int = 4):
    """Full search on quarter-resolution planes: every (2r+1)^2 shift
    for every blk x blk block, with a centre bias |dx| + |dy|, the first
    shift in (dy, dx) raster order winning ties. Returns (integer MVs
    (by, bx, 2) in quarter-resolution pixels, costs (by, bx))."""
    h, w = cur4.shape
    hh, ww = h // blk * blk, w // blk * blk
    dev = cur4.device
    cur = cur4[:hh, :ww].to(torch.int32)
    by, bx = hh // blk, ww // blk
    best_cost = torch.full((by, bx), 1 << 30, dtype=torch.int32, device=dev)
    best_mv = torch.zeros((by, bx, 2), dtype=torch.int32, device=dev)
    # edge padding by radius on every side
    yi = torch.clamp(torch.arange(-radius, h + radius, device=dev), 0, h - 1)
    xi = torch.clamp(torch.arange(-radius, w + radius, device=dev), 0, w - 1)
    pad = ref4.to(torch.int32)[yi[:, None], xi[None, :]]
    shifts = [(dx, dy) for dy in range(-radius, radius + 1)
              for dx in range(-radius, radius + 1)]
    mvs = torch.tensor(shifts, dtype=torch.int32, device=dev)
    for k, (dx, dy) in enumerate(shifts):
        sh = pad[dy + radius:dy + radius + hh, dx + radius:dx + radius + ww]
        sad = torch.abs(cur - sh).reshape(by, blk, bx, blk) \
            .sum((1, 3), dtype=torch.int32)
        cost = sad + (abs(dx) + abs(dy))
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_mv = torch.where(better[..., None], mvs[k], best_mv)
    return best_mv, best_cost


def _block_origins(h: int, w: int, n: int, device):
    by, bx = h // n, w // n
    ys = (np.arange(by) * n).repeat(bx)
    xs = np.tile(np.arange(bx) * n, by)
    return (torch.as_tensor(xs.astype(np.int32), device=device),
            torch.as_tensor(ys.astype(np.int32), device=device), by, bx)


def _sad_at(cur_blocks, ref, x0s, y0s, mvx_i, mvy_i, n):
    """Integer-MV SAD: the reference block at (x0 + mvx, y0 + mvy),
    clamped to the plane."""
    h, w = ref.shape
    ar = torch.arange(n, device=ref.device)
    ys = torch.clamp(y0s[:, None] + mvy_i[:, None] + ar[None, :], 0, h - 1)
    xs = torch.clamp(x0s[:, None] + mvx_i[:, None] + ar[None, :], 0, w - 1)
    patch = ref[ys[:, :, None], xs[:, None, :]]
    return torch.abs(cur_blocks - patch).sum((1, 2), dtype=torch.int32)


DIAMOND = [(1, 0), (-1, 0), (0, 1), (0, -1)]


def refine_size(cur: torch.Tensor, ref: torch.Tensor, seed_mv: torch.Tensor,
                lam: int, n: int, iters: int = 8, bit_depth: int = 8):
    """Integer diamond + quarter-pel refinement for all n-blocks.

    cur/ref: (H, W) int32 planes (H, W multiples of n); seed_mv: (B, 2)
    full-pel integer MV seeds; lam: the integer lambda. Returns
    (mv_qpel (B, 2), cost (B,)) with SA8D + lam * bits costs."""
    h, w = cur.shape
    cur = cur.to(torch.int32)
    ref = ref.to(torch.int32)
    x0s, y0s, by, bx = _block_origins(h, w, n, cur.device)
    cur_blocks = cur.reshape(by, n, bx, n).permute(0, 2, 1, 3) \
        .reshape(-1, n, n)

    def sad_cost(cx, cy):
        return _sad_at(cur_blocks, ref, x0s, y0s, cx, cy, n) + \
            lam * _mv_bits(cx * 4, cy * 4)

    def take(cx, cy, mvx, mvy, cost):
        c = sad_cost(cx, cy)
        better = c < cost
        return (torch.where(better, cx, mvx), torch.where(better, cy, mvy),
                torch.where(better, c, cost))

    mvx = seed_mv[:, 0]
    mvy = seed_mv[:, 1]
    cost = sad_cost(mvx, mvy)
    # candidate seeds: zero and the coarse seeds of the left, top and
    # top-right neighbours on the block grid (wrapping, as jnp.roll)
    seeds2 = seed_mv.reshape(by, bx, 2)
    for cand in (torch.zeros_like(seeds2),
                 torch.roll(seeds2, 1, dims=1),
                 torch.roll(seeds2, 1, dims=0),
                 torch.roll(seeds2, (1, -1), dims=(0, 1))):
        mvx, mvy, cost = take(cand[..., 0].reshape(-1),
                              cand[..., 1].reshape(-1), mvx, mvy, cost)

    def diamond(mvx, mvy, cost, rounds):
        for _ in range(rounds):
            for dx, dy in DIAMOND:
                mvx, mvy, cost = take(mvx + dx, mvy + dy, mvx, mvy, cost)
        return mvx, mvy, cost

    mvx, mvy, cost = diamond(mvx, mvy, cost, iters)
    # two rounds of the refined neighbours' MVs, each followed by two
    # diamond rounds
    for _ in range(2):
        field = torch.stack([mvx, mvy], dim=1).reshape(by, bx, 2)
        for sh, ax in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
            cand = torch.roll(field, sh, dims=ax)
            mvx, mvy, cost = take(cand[..., 0].reshape(-1),
                                  cand[..., 1].reshape(-1), mvx, mvy, cost)
        mvx, mvy, cost = diamond(mvx, mvy, cost, 2)
    # sub-pel refinement (half, then quarter), SA8D-scored
    def satd_cost(cx, cy):
        pred = mc_block_batch(ref, x0s, y0s, cx, cy, n, is_luma=True,
                              bit_depth=bit_depth)
        return sa8d_nxn_batch(cur_blocks - pred, n) + lam * _mv_bits(cx, cy)

    mvqx = mvx * 4
    mvqy = mvy * 4
    scost = satd_cost(mvqx, mvqy)
    for step in (2, 1):
        for dx, dy in DIAMOND + [(1, 1), (1, -1), (-1, 1), (-1, -1)]:
            cx = mvqx + dx * step
            cy = mvqy + dy * step
            c = satd_cost(cx, cy)
            better = c < scost
            scost = torch.where(better, c, scost)
            mvqx = torch.where(better, cx, mvqx)
            mvqy = torch.where(better, cy, mvqy)
    return torch.stack([mvqx, mvqy], dim=1), scost


def motion_search_frame(cur_y, ref_y, qp: int, sizes=(8, 16, 32),
                        bit_depth: int = 8, device=None):
    """Dense MV fields for every block size. cur_y / ref_y: (H, W)
    planes, tensors (searched on their device) or host arrays (uploaded
    to device). Returns dict size -> (mv (by, bx, 2) int32 qpel, cost
    (by, bx) int32), host arrays."""
    def plane(p):
        if isinstance(p, torch.Tensor):
            return p.to(torch.int32)
        return torch.as_tensor(np.asarray(p, np.int32),
                               device=resolve_device(device))

    cur = plane(cur_y)
    ref = plane(ref_y).to(cur.device)
    h, w = cur.shape
    lam = int(round(lambda_from_qp(qp)))
    cmv, _ = coarse_search(_downsample4(cur), _downsample4(ref))
    cby, cbx = cmv.shape[:2]
    out = {}
    for n in sizes:
        by, bx = h // n, w // n
        # seed: the coarse MV at the block centre, in full-res pixels
        iy = torch.clamp((torch.arange(by, device=cur.device) * n + n // 2)
                         // 16, 0, cby - 1)
        ix = torch.clamp((torch.arange(bx, device=cur.device) * n + n // 2)
                         // 16, 0, cbx - 1)
        seed = (cmv[iy[:, None], ix[None, :]] * 4).reshape(-1, 2)
        mv, cost = refine_size(cur, ref, seed, lam, n, bit_depth=bit_depth)
        out[n] = (mv.reshape(by, bx, 2).cpu().numpy(),
                  cost.reshape(by, bx).cpu().numpy())
    return out
