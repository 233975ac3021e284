"""SEI messages (Annex D): decoded_picture_hash (MD5, CRC, checksum),
buffering period, picture timing, recovery point, user data
unregistered, mastering display, content light level, and the access
unit delimiter. A copy of x265_tpu/bitstream/sei.py; the CRC runs in
the package's own native coder (entropy.cpp picture_crc16).

Reference behavior: x265 source/encoder/sei.{h,cpp} SEIDecodedPictureHash
and source/common/md5.cpp; frameencoder.cpp:1167 computes the hash over
the cropped decoded picture, so a decoder can verify its reconstruction
against the encoder's.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .bitwriter import BitWriter
from .nal import NalUnitType

SEI_DECODED_PICTURE_HASH = 132


def picture_md5(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                bit_depth: int = 8) -> list[bytes]:
    """Per-plane MD5 over raster samples (little-endian 16-bit when
    bit depth > 8), clause D.3.19."""
    out = []
    for p in (y, cb, cr):
        if bit_depth > 8:
            data = np.ascontiguousarray(p.astype("<u2")).tobytes()
        else:
            data = np.ascontiguousarray(p.astype(np.uint8)).tobytes()
        out.append(hashlib.md5(data).digest())
    return out


def _crc16_bits(plane: np.ndarray, bit_depth: int) -> int:
    """Pure-Python oracle for the D.3.19 CRC shift register (picyuv.cpp
    updateCRC/crcFinish behavior): s' = s*x + bit mod 0x11021, low byte
    first, finished with 16 zero bits."""
    crc = 0xFFFF
    nbits = 16 if bit_depth > 8 else 8
    for s in plane.reshape(-1).tolist():
        for grp in range(0, nbits, 8):
            for bit in range(8):
                b = (s >> (grp + 7 - bit)) & 1
                msb = (crc >> 15) & 1
                crc = (((crc << 1) + b) & 0xFFFF) ^ (0x1021 if msb else 0)
    for _ in range(16):
        msb = (crc >> 15) & 1
        crc = ((crc << 1) & 0xFFFF) ^ (0x1021 if msb else 0)
    return crc


def picture_crc(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                bit_depth: int = 8) -> list[bytes]:
    """Per-plane CRC-16 (hash_type 1), via the native table-driven
    kernel (entropy.cpp picture_crc16); 2-byte big-endian digests."""
    from ..native.entropy_native import get_lib
    import ctypes
    lib = get_lib()
    if not hasattr(lib.picture_crc16, "_typed"):
        lib.picture_crc16.restype = ctypes.c_int
        lib.picture_crc16.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int]
        lib.picture_crc16._typed = True
    out = []
    for p in (y, cb, cr):
        a = np.ascontiguousarray(p.astype(np.uint16))
        v = lib.picture_crc16(a.ctypes.data, a.size,
                              1 if bit_depth > 8 else 0)
        out.append(bytes([(v >> 8) & 0xFF, v & 0xFF]))
    return out


def picture_checksum(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     bit_depth: int = 8) -> list[bytes]:
    """Per-plane position-masked checksum (hash_type 2, D.3.19;
    picyuv.cpp updateChecksum) — vectorized over the plane."""
    out = []
    for p in (y, cb, cr):
        h, w = p.shape
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((xx & 0xFF) ^ (yy & 0xFF) ^ (xx >> 8) ^ (yy >> 8)) & 0xFF
        s = p.astype(np.uint32)
        total = int(((s & 0xFF) ^ mask).sum(dtype=np.uint64))
        if bit_depth > 8:
            total += int(((s >> 8) ^ mask).sum(dtype=np.uint64))
        total &= 0xFFFFFFFF
        out.append(total.to_bytes(4, "big"))
    return out


HASH_FNS = {1: picture_md5, 2: picture_crc, 3: picture_checksum}


def write_picture_hash_sei(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                           bit_depth: int = 8, hash_type: int = 1
                           ) -> tuple[NalUnitType, bytes]:
    """Build the suffix-SEI NAL (type, rbsp) for the decoded picture.
    hash_type follows the x265 --hash numbering: 1=MD5, 2=CRC,
    3=checksum (the SEI's hash_type field is that minus one)."""
    hashes = HASH_FNS[hash_type](y, cb, cr, bit_depth)
    payload = bytes([hash_type - 1]) + b"".join(hashes)
    w = BitWriter()
    w.write(SEI_DECODED_PICTURE_HASH, 8)      # payload_type
    size = len(payload)
    while size >= 255:
        w.write(255, 8)
        size -= 255
    w.write(size, 8)                          # payload_size
    w.write_bytes(payload)
    w.align_one()                             # rbsp trailing
    return NalUnitType.SUFFIX_SEI, w.get_bytes()


def parse_picture_hash_sei(rbsp: bytes
                           ) -> tuple[int, list[bytes]] | None:
    """Parse a suffix SEI rbsp; returns (hash_type 1/2/3 in x265
    numbering, the 3 per-plane digests) if present."""
    i = 0
    while i < len(rbsp) - 1:
        ptype = 0
        while rbsp[i] == 255:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        size = 0
        while rbsp[i] == 255:
            size += 255
            i += 1
        size += rbsp[i]
        i += 1
        if ptype == SEI_DECODED_PICTURE_HASH:
            payload = rbsp[i:i + size]
            htype = payload[0] + 1
            n = {1: 16, 2: 2, 3: 4}.get(htype)
            if n is None:
                return None
            return htype, [payload[1 + n * k:1 + n * (k + 1)]
                           for k in range(3)]
        i += size
    return None


SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_RECOVERY_POINT = 6
SEI_USER_DATA_UNREGISTERED = 5


def _sei_nal(ptype: int, payload_bits: BitWriter,
             prefix: bool = True) -> tuple[NalUnitType, bytes]:
    """Wrap one SEI payload (already bit-exact, byte-aligned via its
    own alignment) into an SEI NAL rbsp."""
    payload_bits.align_one()          # payload rbsp trailing bits
    payload = payload_bits.get_bytes()
    w = BitWriter()
    t = ptype
    while t >= 255:
        w.write(255, 8)
        t -= 255
    w.write(t, 8)
    size = len(payload)
    while size >= 255:
        w.write(255, 8)
        size -= 255
    w.write(size, 8)
    w.write_bytes(payload)
    w.align_one()                     # sei rbsp trailing
    return (NalUnitType.PREFIX_SEI if prefix else NalUnitType.SUFFIX_SEI,
            w.get_bytes())


def write_buffering_period_sei(cfg, initial_fill_bits: float
                               ) -> tuple[NalUnitType, bytes]:
    """buffering_period SEI (D.2.2) for the single NAL CPB signalled in
    the VUI (ratecontrol.cpp:2277 HRD analog). Delays are in 90 kHz
    ticks of buffer drain time."""
    from .headers import HRD_AU_DELAY_LEN, HRD_INIT_DELAY_LEN
    w = BitWriter()
    w.write_ue(0)                     # bp_seq_parameter_set_id
    # irap_cpb_params_present_flag absent (no sub_pic, rap_cpb_params=0)
    w.write_flag(0)                   # concatenation_flag
    w.write(0, HRD_AU_DELAY_LEN)      # au_cpb_removal_delay_delta_minus1
    delay = int(90000.0 * initial_fill_bits /
                max(cfg.vbv_maxrate * 1000.0, 1.0))
    maxd = (1 << HRD_INIT_DELAY_LEN) - 1
    w.write(min(max(delay, 1), maxd), HRD_INIT_DELAY_LEN)
    w.write(0, HRD_INIT_DELAY_LEN)    # initial_cpb_removal_offset
    return _sei_nal(SEI_BUFFERING_PERIOD, w)


def write_pic_timing_sei(cfg, au_index_in_bp: int, dpb_delay: int = 1
                         ) -> tuple[NalUnitType, bytes]:
    """pic_timing SEI (D.2.3): CPB removal + DPB output delays (the
    frame_field part is absent — frame_field_info_present_flag = 0)."""
    from .headers import HRD_AU_DELAY_LEN, HRD_DPB_DELAY_LEN
    w = BitWriter()
    w.write(max(au_index_in_bp, 1) - 1 if au_index_in_bp else 0,
            HRD_AU_DELAY_LEN)         # au_cpb_removal_delay_minus1
    w.write(dpb_delay, HRD_DPB_DELAY_LEN)  # pic_dpb_output_delay
    return _sei_nal(SEI_PIC_TIMING, w)


def write_recovery_point_sei(poc_offset: int = 0
                             ) -> tuple[NalUnitType, bytes]:
    """recovery_point SEI (D.2.8)."""
    w = BitWriter()
    w.write_se(poc_offset)            # recovery_poc_cnt
    w.write_flag(1)                   # exact_match_flag
    w.write_flag(0)                   # broken_link_flag
    return _sei_nal(SEI_RECOVERY_POINT, w)


def write_user_data_sei(text: bytes) -> tuple[NalUnitType, bytes]:
    """user_data_unregistered SEI (D.2.7): 16-byte UUID + payload
    (the x265 version-banner SEI analog, encoder.cpp getStreamHeaders)."""
    uuid = bytes.fromhex("2ca2de09b51747dbbb55a4fe7fc2fc4e")
    w = BitWriter()
    w.write_bytes(uuid + text)
    return _sei_nal(SEI_USER_DATA_UNREGISTERED, w)


def write_aud(slice_types_present: int) -> tuple[NalUnitType, bytes]:
    """access_unit_delimiter_rbsp (7.3.2.5): pic_type 0=I, 1=I/P,
    2=I/P/B."""
    w = BitWriter()
    w.write(slice_types_present, 3)
    w.align_one()
    return NalUnitType.AUD, w.get_bytes()


SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144
SEI_ALTERNATIVE_TRANSFER = 147


def parse_master_display(s: str):
    """Parse the x265 --master-display string
    "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)" into
    (primaries_gbr[(x,y)*3], white_point(x,y), max_lum, min_lum)."""
    import re
    m = re.match(r"G\((\d+),(\d+)\)B\((\d+),(\d+)\)R\((\d+),(\d+)\)"
                 r"WP\((\d+),(\d+)\)L\((\d+),(\d+)\)", s.replace(" ", ""))
    if not m:
        raise ValueError(f"bad master-display string: {s!r}")
    v = [int(x) for x in m.groups()]
    return [(v[0], v[1]), (v[2], v[3]), (v[4], v[5])], (v[6], v[7]), \
        v[8], v[9]


def write_mastering_display_sei(s: str) -> tuple[NalUnitType, bytes]:
    """mastering_display_colour_volume (D.2.28; SMPTE ST 2086).
    Reference: x265 sei.h SEIMasteringDisplayColorVolume, fed by
    --master-display (param.cpp x265_param_parse masteringDisplay)."""
    prim, wp, maxl, minl = parse_master_display(s)
    w = BitWriter()
    for x, y in prim:                 # display_primaries_{x,y}[c], GBR
        w.write(x, 16)
        w.write(y, 16)
    w.write(wp[0], 16)                # white_point_x
    w.write(wp[1], 16)                # white_point_y
    w.write(maxl, 32)                 # max_display_mastering_luminance
    w.write(minl, 32)                 # min_display_mastering_luminance
    return _sei_nal(SEI_MASTERING_DISPLAY, w)


def write_content_light_level_sei(s: str) -> tuple[NalUnitType, bytes]:
    """content_light_level_info (D.2.35): "maxCLL,maxFALL"
    (x265 --max-cll)."""
    cll, fall = (int(x) for x in s.split(","))
    w = BitWriter()
    w.write(cll, 16)                  # max_content_light_level
    w.write(fall, 16)                 # max_pic_average_light_level
    return _sei_nal(SEI_CONTENT_LIGHT_LEVEL, w)
