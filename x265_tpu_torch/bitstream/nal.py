"""NAL unit packaging: start codes + emulation prevention, and the
length-prefixed (--no-annexb) form with the parsers that split both.

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


def remove_emulation_prevention(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        if zeros >= 2 and b == 3 and i + 1 == n:
            # trailing cabac_zero_word guard byte
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
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


def length_prefixed_stream(nals: list[tuple]) -> bytes:
    """Serialize NAL units with 4-byte big-endian length prefixes
    instead of start codes (the x265 --no-annexb / mp4-track form,
    nal.cpp serialize with bAnnexB=false). Payloads are still
    emulation-prevented, matching the reference's behavior."""
    out = bytearray()
    for item in nals:
        t, rbsp = item[0], item[1]
        pre = item[2] if len(item) > 2 else b""
        body = nal_header(t) + emulation_prevention(rbsp) + pre
        out += len(body).to_bytes(4, "big") + body
    return bytes(out)


def split_length_prefixed(stream: bytes) -> list[tuple[int, bytes, bytes]]:
    """Inverse of length_prefixed_stream: (type, rbsp, raw) units."""
    out = []
    pos = 0
    while pos + 4 <= len(stream):
        ln = int.from_bytes(stream[pos:pos + 4], "big")
        body = stream[pos + 4:pos + 4 + ln]
        pos += 4 + ln
        t = (body[0] >> 1) & 0x3F
        out.append((t, remove_emulation_prevention(body[2:]), body[2:]))
    return out


def annexb_to_length_prefixed(stream: bytes) -> bytes:
    """Convert an Annex-B AU to 4-byte length-prefixed units (keeps
    the already-escaped payload bytes verbatim)."""
    out = bytearray()
    for t, _rbsp, raw in split_annexb(stream):
        body = nal_header(t) + raw
        out += len(body).to_bytes(4, "big") + body
    return bytes(out)


def split_annexb(stream: bytes) -> list[tuple[int, bytes, bytes]]:
    """Parse an Annex-B stream into (nal_type, rbsp, raw_payload)
    units (validation decoder). raw_payload is the emulation-prevented
    payload after the 2-byte NAL header — WPP entry point offsets
    count bytes in that domain (clause 7.4.7.1)."""
    n = len(stream)
    # start-code prefix positions: index of the byte AFTER each 00 00 01
    starts: list[int] = []
    sc_begin: list[int] = []  # index of first byte of the start code prefix
    i = 0
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            begin = i
            if i >= 1 and stream[i - 1] == 0:
                begin = i - 1  # 4-byte start code
            starts.append(i + 3)
            sc_begin.append(begin)
            i += 3
        else:
            i += 1
    units: list[tuple[int, bytes, bytes]] = []
    bounds = sc_begin[1:] + [n]
    for s, e in zip(starts, bounds):
        payload = stream[s:e]
        if len(payload) < 2:
            continue
        nal_type = (payload[0] >> 1) & 0x3F
        rbsp = remove_emulation_prevention(payload[2:])
        units.append((nal_type, rbsp, payload[2:]))
    return units
