"""NAL unit packaging: start codes + emulation prevention.

Behavioral reference: x265 source/common/nal.cpp (NALList::serialize):
insert 0x03 after any 0x00 0x00 pair that would otherwise be followed by
0x00..0x03 inside the payload (H.265 clause 7.4.2 / B.2.1).
"""

from __future__ import annotations

from enum import IntEnum

from .bitwriter import BitWriter


class NalUnitType(IntEnum):
    # H.265 Table 7-1 (subset we emit; full enum mirrors x265.h NalUnitType)
    TRAIL_N = 0
    TRAIL_R = 1
    TSA_N = 2
    TSA_R = 3
    STSA_N = 4
    STSA_R = 5
    RADL_N = 6
    RADL_R = 7
    RASL_N = 8
    RASL_R = 9
    BLA_W_LP = 16
    BLA_W_RADL = 17
    BLA_N_LP = 18
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    VPS = 32
    SPS = 33
    PPS = 34
    AUD = 35
    EOS = 36
    EOB = 37
    FD = 38
    PREFIX_SEI = 39
    SUFFIX_SEI = 40


def emulation_prevention(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (0x03)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_header(nal_type: NalUnitType, layer_id: int = 0, temporal_id: int = 0) -> bytes:
    """2-byte nal_unit_header (clause 7.3.1.2)."""
    w = BitWriter()
    w.write(0, 1)                 # forbidden_zero_bit
    w.write(int(nal_type), 6)     # nal_unit_type
    w.write(layer_id, 6)          # nuh_layer_id
    w.write(temporal_id + 1, 3)   # nuh_temporal_id_plus1
    return w.get_bytes()


def wrap_nal(nal_type: NalUnitType, rbsp: bytes, *, long_start_code: bool = True,
             temporal_id: int = 0) -> bytes:
    """Annex-B NAL unit: start code + header + emulation-prevented RBSP."""
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + nal_header(nal_type, 0, temporal_id) + emulation_prevention(rbsp)


def annexb_stream(nals: list[tuple]) -> bytes:
    """Serialize a list of (type, rbsp[, preescaped_data]) into one
    Annex-B access unit stream. VPS/SPS/PPS and the first NAL of an AU
    get 4-byte start codes. An optional third element carries payload
    that is ALREADY emulation-prevented (WPP substream concatenations,
    whose entry point offsets count escaped bytes — the
    serializeSubstreams contract, nal.cpp:176)."""
    out = bytearray()
    for i, item in enumerate(nals):
        t, rbsp = item[0], item[1]
        pre = item[2] if len(item) > 2 else b""
        long_sc = i == 0 or t in (NalUnitType.VPS, NalUnitType.SPS, NalUnitType.PPS,
                                  NalUnitType.AUD)
        out += wrap_nal(t, rbsp, long_start_code=long_sc)
        out += pre
    return bytes(out)
