"""CABAC arithmetic coding engine (H.265 clause 9.3).

Encoder follows the HM/x265 register formulation (behavioral reference:
x265 source/encoder/entropy.cpp:2396-2609 — start/encodeBin/encodeBinEP/
encodeBinsEP/encodeBinTrm/writeOut/finish). The decoder is written
directly from the spec pseudo-code (clauses 9.3.4.3.2-9.3.4.3.5) so the
encoder/decoder round-trip test doubles as a conformance check.

Table data are normative constants of ITU-T H.265:
- RANGE_TAB_LPS: Table 9-46 (rangeTabLps)
- state transitions: Tables 9-47 packed as (pStateIdx << 1) | valMps
- ENTROPY_BITS: non-normative fractional-bit estimates (Q15) used for
  RDO bit estimation (HM lineage).

A copy of x265_tpu/bitstream/cabac.py. The encoder's slices are coded
by the native engine (native/entropy.cpp); the Python slice coder
(bitstream/syntax.py SliceSyntaxEncoder) and the validation decoder
(decoder/) run on this one.
"""

from __future__ import annotations

import numpy as np

# --- normative engine tables -------------------------------------------------

# rangeTabLps[pStateIdx][qRangeIdx]  (H.265 Table 9-46)
RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9],
    [2, 2, 2, 2],
], dtype=np.uint8)

# transIdxLps[pStateIdx] (H.265 Table 9-47); transIdxMps is min(p+1, 62)
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.uint8)

# Packed-state transition tables over s = (pStateIdx << 1) | valMps.
# NEXT_MPS[s]: state after coding the MPS; NEXT_LPS[s]: after the LPS
# (includes the valMps flip at pStateIdx == 0).
NEXT_MPS = np.zeros(128, dtype=np.uint8)
NEXT_LPS = np.zeros(128, dtype=np.uint8)
for _p in range(64):
    for _mps in range(2):
        _s = (_p << 1) | _mps
        _pm = _p if _p == 62 or _p == 63 else _p + 1
        NEXT_MPS[_s] = (_pm << 1) | _mps if _p != 63 else _s
        if _p == 63:
            NEXT_LPS[_s] = _s
        elif _p == 0:
            NEXT_LPS[_s] = (int(TRANS_IDX_LPS[_p]) << 1) | (1 - _mps)
        else:
            NEXT_LPS[_s] = (int(TRANS_IDX_LPS[_p]) << 1) | _mps

# Fractional-bit cost per (state ^ bin), Q15 (non-normative, RDO only).
ENTROPY_BITS = np.array([
    0x07b23, 0x085f9, 0x074a0, 0x08cbc, 0x06ee4, 0x09354, 0x067f4, 0x09c1b,
    0x060b0, 0x0a62a, 0x05a9c, 0x0af5b, 0x0548d, 0x0b955, 0x04f56, 0x0c2a9,
    0x04a87, 0x0cbf7, 0x045d6, 0x0d5c3, 0x04144, 0x0e01b, 0x03d88, 0x0e937,
    0x039e0, 0x0f2cd, 0x03663, 0x0fc9e, 0x03347, 0x10600, 0x03050, 0x10f95,
    0x02d4d, 0x11a02, 0x02ad3, 0x12333, 0x0286e, 0x12cad, 0x02604, 0x136df,
    0x02425, 0x13f48, 0x021f4, 0x149c4, 0x0203e, 0x1527b, 0x01e4d, 0x15d00,
    0x01c99, 0x166de, 0x01b18, 0x17017, 0x019a5, 0x17988, 0x01841, 0x18327,
    0x016df, 0x18d50, 0x015d9, 0x19547, 0x0147c, 0x1a083, 0x0138e, 0x1a8a3,
    0x01251, 0x1b418, 0x01166, 0x1bd27, 0x01068, 0x1c77b, 0x00f7f, 0x1d18e,
    0x00eda, 0x1d91a, 0x00e19, 0x1e254, 0x00d4f, 0x1ec9a, 0x00c90, 0x1f6e0,
    0x00c01, 0x1fef8, 0x00b5f, 0x208b1, 0x00ab6, 0x21362, 0x00a15, 0x21e46,
    0x00988, 0x2285d, 0x00934, 0x22ea8, 0x008a8, 0x239b2, 0x0081d, 0x24577,
    0x007c9, 0x24ce6, 0x00763, 0x25663, 0x00710, 0x25e8f, 0x006a0, 0x26a26,
    0x00672, 0x26f23, 0x005e8, 0x27ef8, 0x005ba, 0x284b5, 0x0055e, 0x29057,
    0x0050c, 0x29bab, 0x004c1, 0x2a674, 0x004a7, 0x2aa5e, 0x0046f, 0x2b32f,
    0x0041f, 0x2c0ad, 0x003e7, 0x2ca8d, 0x003ba, 0x2d323, 0x0010c, 0x3bfbb,
], dtype=np.uint32)


def init_context(qp: int, init_value: int) -> int:
    """Context initialization (H.265 clause 9.3.2.2) -> packed state."""
    qp = min(max(qp, 0), 51)
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * qp) >> 4) + offset), 126)
    mps = 1 if pre >= 64 else 0
    p_state = (pre - 64) if mps else (63 - pre)
    return (p_state << 1) | mps


class ContextSet:
    """A flat array of packed CABAC context states."""

    __slots__ = ("states",)

    def __init__(self, n: int) -> None:
        self.states = np.zeros(n, dtype=np.uint8)

    def init_from(self, qp: int, init_values: np.ndarray) -> None:
        for i, iv in enumerate(init_values):
            self.states[i] = init_context(qp, int(iv))

    def copy(self) -> "ContextSet":
        c = ContextSet(len(self.states))
        c.states[:] = self.states
        return c


class CabacEncoder:
    """HEVC binary arithmetic encoder (HM register formulation).

    Operates on an external ContextSet so WPP-style context forking is a
    plain array copy.
    """

    __slots__ = ("low", "range", "bits_left", "buffered_byte",
                 "num_buffered", "out", "ctx", "frac_bits", "counting", "_tail")

    def __init__(self, ctx: ContextSet | None = None, counting: bool = False) -> None:
        self.ctx = ctx if ctx is not None else ContextSet(0)
        self.counting = counting   # True: only accumulate frac_bits (RDO mode)
        self.frac_bits = 0
        self.start()

    def start(self) -> None:
        self.low = 0
        self.range = 510
        self.bits_left = -12
        self.buffered_byte = 0xFF
        self.num_buffered = 0
        self.out = bytearray()

    # -- bin coding -----------------------------------------------------------

    def encode_bin(self, ctx_idx: int, bin_val: int) -> None:
        states = self.ctx.states
        mstate = states[ctx_idx]
        states[ctx_idx] = NEXT_MPS[mstate] if bin_val == (mstate & 1) else NEXT_LPS[mstate]
        if self.counting:
            self.frac_bits += int(ENTROPY_BITS[mstate ^ bin_val])
            return
        rng = self.range
        lps = int(RANGE_TAB_LPS[mstate >> 1, (rng >> 6) & 3])
        rng -= lps
        low = self.low
        if bin_val != (mstate & 1):
            # renorm shift: smallest n with (lps << n) >= 256
            nbits = 8 - lps.bit_length() + 1 if lps < 128 else 1
            if (mstate >> 1) == 63:
                nbits = 6  # lps==2 only reachable via terminate path in spec
            low += rng
            rng = lps
        else:
            nbits = 1 if rng < 256 else 0
        self.low = low << nbits
        self.range = rng << nbits
        self.bits_left += nbits
        if self.bits_left >= 0:
            self._write_out()

    def encode_bypass(self, bin_val: int) -> None:
        if self.counting:
            self.frac_bits += 32768
            return
        self.low <<= 1
        if bin_val:
            self.low += self.range
        self.bits_left += 1
        if self.bits_left >= 0:
            self._write_out()

    def encode_bypass_bins(self, value: int, nbins: int) -> None:
        if self.counting:
            self.frac_bits += 32768 * nbins
            return
        while nbins > 8:
            nbins -= 8
            pattern = value >> nbins
            self.low = (self.low << 8) + self.range * pattern
            value -= pattern << nbins
            self.bits_left += 8
            if self.bits_left >= 0:
                self._write_out()
        self.low = (self.low << nbins) + self.range * value
        self.bits_left += nbins
        if self.bits_left >= 0:
            self._write_out()

    def encode_terminate(self, bin_val: int) -> None:
        if self.counting:
            self.frac_bits += int(ENTROPY_BITS[126 ^ bin_val])
            return
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left += 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left += 1
        if self.bits_left >= 0:
            self._write_out()

    # -- byte output ----------------------------------------------------------

    def _write_out(self) -> None:
        lead = self.low >> (13 + self.bits_left)
        self.low &= (1 << (13 + self.bits_left)) - 1
        self.bits_left -= 8
        if lead == 0xFF:
            self.num_buffered += 1
        else:
            if self.num_buffered > 0:
                carry = lead >> 8
                self.out.append((self.buffered_byte + carry) & 0xFF)
                fill = (0xFF + carry) & 0xFF
                for _ in range(self.num_buffered - 1):
                    self.out.append(fill)
            self.num_buffered = 1
            self.buffered_byte = lead & 0xFF

    def finish(self) -> bytes:
        """Flush the arithmetic engine. Returns the CABAC byte string
        (caller appends rbsp stop bit / alignment via BitWriter)."""
        if self.low >> (21 + self.bits_left):
            self.out.append((self.buffered_byte + 1) & 0xFF)
            for _ in range(self.num_buffered - 1):
                self.out.append(0x00)
            self.low -= 1 << (21 + self.bits_left)
        else:
            if self.num_buffered > 0:
                self.out.append(self.buffered_byte)
            for _ in range(self.num_buffered - 1):
                self.out.append(0xFF)
        # remaining 13 + bits_left bits of (low >> 8), MSB first
        nbits = 13 + self.bits_left
        val = (self.low >> 8) & ((1 << nbits) - 1) if nbits > 0 else 0
        self._tail = (val, nbits)
        return bytes(self.out)

    def finish_into(self, bw) -> None:
        """finish() + write the sub-byte tail into a BitWriter."""
        data = self.finish()
        for b in data:
            bw.write(b, 8)
        val, nbits = self._tail
        if nbits > 0:
            bw.write(val, nbits)

    def finish_aligned(self) -> bytes:
        """finish() + tail + byte_alignment (stop bit 1 + zero pad) —
        one self-contained WPP substream (Entropy::finishSlice
        analog, entropy.h:154)."""
        from .bitwriter import BitWriter
        bw = BitWriter()
        self.finish_into(bw)
        bw.align_one()
        return bw.get_bytes()


class CabacDecoder:
    """Arithmetic decoder written from H.265 clauses 9.3.4.3.2-9.3.4.3.5."""

    __slots__ = ("data", "bitpos", "range", "offset", "ctx")

    def __init__(self, data: bytes, ctx: ContextSet) -> None:
        self.data = data
        self.bitpos = 0
        self.ctx = ctx
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._read_bit()

    def _read_bit(self) -> int:
        pos = self.bitpos
        self.bitpos = pos + 1
        byte_idx = pos >> 3
        if byte_idx >= len(self.data):
            return 0
        return (self.data[byte_idx] >> (7 - (pos & 7))) & 1

    def decode_bin(self, ctx_idx: int) -> int:
        states = self.ctx.states
        mstate = int(states[ctx_idx])
        p_state, mps = mstate >> 1, mstate & 1
        lps = int(RANGE_TAB_LPS[p_state, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            bin_val = 1 - mps
            self.offset -= self.range
            self.range = lps
            states[ctx_idx] = NEXT_LPS[mstate]
        else:
            bin_val = mps
            states[ctx_idx] = NEXT_MPS[mstate]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, nbins: int) -> int:
        v = 0
        for _ in range(nbins):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0
