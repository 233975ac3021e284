"""Raw bit writer + Exp-Golomb (ue/se) syntax writer, and the reader
the validation decoder parses headers with (BitReader).

Behavioral reference: x265 source/common/bitstream.h (Bitstream,
SyntaxElementWriter) — re-implemented from the H.265 spec definitions
(clauses 9.2, 7.4.3). No emulation prevention here; that happens at NAL
packaging time (see nal.py).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit accumulator producing an RBSP byte string."""

    __slots__ = ("_bytes", "_acc", "_nbits")

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0      # bit accumulator, MSB-aligned semantics via counter
        self._nbits = 0    # number of valid bits in _acc (< 8 after flushes)

    def write(self, value: int, nbits: int) -> None:
        """Write `nbits` bits of `value` (MSB first)."""
        if nbits == 0:
            return
        assert 0 <= nbits <= 32, nbits
        assert 0 <= value < (1 << nbits), (value, nbits)
        acc = (self._acc << nbits) | value
        n = self._nbits + nbits
        while n >= 8:
            n -= 8
            self._bytes.append((acc >> n) & 0xFF)
        self._acc = acc & ((1 << n) - 1)
        self._nbits = n

    def write_flag(self, flag: int | bool) -> None:
        self.write(1 if flag else 0, 1)

    def write_ue(self, value: int) -> None:
        """ue(v): unsigned Exp-Golomb."""
        assert value >= 0
        v = value + 1
        nbits = v.bit_length()
        self.write(0, nbits - 1)
        self.write(v, nbits)

    def write_se(self, value: int) -> None:
        """se(v): signed Exp-Golomb. Mapping: k>0 -> 2k-1, k<=0 -> -2k."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, "byte-align before appending raw bytes"
        self._bytes.extend(data)

    def align_one(self) -> None:
        """rbsp_trailing_bits(): stop bit '1' then zero-pad to byte."""
        self.write(1, 1)
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def align_zero(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "stream not byte-aligned"
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader over an RBSP byte string (for the validation
    decoder). Mirrors BitWriter."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        v = 0
        pos = self._pos
        data = self._data
        for _ in range(nbits):
            byte = data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return v

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            assert zeros < 32, "malformed ue(v)"
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_position(self) -> int:
        return self._pos

    def more_rbsp_data(self) -> bool:
        """True if there is payload before the rbsp_stop_one_bit."""
        nbits = len(self._data) * 8
        if self._pos >= nbits:
            return False
        # find last '1' bit in the stream (the stop bit)
        last = nbits - 1
        while last >= 0:
            byte = self._data[last >> 3]
            if (byte >> (7 - (last & 7))) & 1:
                break
            last -= 1
        return self._pos < last
