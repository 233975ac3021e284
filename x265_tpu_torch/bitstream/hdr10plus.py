"""HDR10+ (SMPTE ST 2094-40) dynamic metadata: JSON -> per-frame
user_data_registered_itu_t_t35 prefix SEI payloads. A copy of
x265_tpu/bitstream/hdr10plus.py.

Reference behavior: x265 source/dynamicHDR10/metadataFromJson.cpp
fillMetadataArray (bitfield order) + SeiMetadataDictionary.cpp (JSON
key names); the encoder attaches one payload per source frame
(frameencoder.cpp:1105 writes the raw payload bytes into a prefix
SEI). Both JSON dialects the reference accepts are handled:

- LLC: top-level object {"SceneInfo": [...]} with "LuminanceParameters"
  -> {"MaxScl": [r,g,b], "AverageRGB", "LuminanceDistributions":
  {"DistributionIndex": [...], "DistributionValues": [...]}} and
  "BezierCurveData" -> {"KneePointX/Y", "Anchors": [...]}.
- LEGACY: top-level array, "MaxScl0/1/2", "PercentileLuminance" with
  "PercentilePercentage{i}"/"PercentileLuminance{i}" keys, and
  "Anchor{i}" bezier keys.
"""

from __future__ import annotations

import json

from .bitwriter import BitWriter
from .nal import NalUnitType

SEI_USER_DATA_REGISTERED_T35 = 4


def _window_payload(w: BitWriter, frame: dict, llc: bool) -> None:
    lum = frame.get("LuminanceParameters", {})
    if llc:
        maxscl = lum.get("MaxScl", [0, 0, 0])
        dist = lum.get("LuminanceDistributions", {})
        percentages = dist.get("DistributionIndex", [])
        percentiles = dist.get("DistributionValues", [])
    else:
        maxscl = [lum.get(f"MaxScl{i}", 0) for i in range(3)]
        pl = lum.get("PercentileLuminance", {})
        order = int(pl.get("NumberOfPercentiles", 0))
        percentages = [pl.get(f"PercentilePercentage{i}", 0)
                       for i in range(order)]
        percentiles = [pl.get(f"PercentileLuminance{i}", 0)
                       for i in range(order)]
    avg = int(lum.get("AverageRGB", 0))
    for v in (*maxscl, avg):                  # maxscl[c] + average: 17 bits
        v = int(v)
        w.write((v >> 16) & 1, 1)
        w.write(v & 0xFFFF, 16)
    n = min(len(percentiles), 15)
    w.write(n, 4)                             # num_distribution_maxrgb
    for i in range(n):
        w.write(int(percentages[i]) & 0x7F, 7)
        v = int(percentiles[i])
        w.write((v >> 16) & 1, 1)
        w.write(v & 0xFFFF, 16)
    w.write(0, 10)                            # fraction_bright_pixels


def _bezier_payload(w: BitWriter, frame: dict, llc: bool,
                    window: int = 0) -> None:
    """Bezier tone curve for one window. Window 0 reads the global
    frame curve; local windows read their OWN curve from
    LocalParameters[window-1] (metadataFromJson.cpp:563-566)."""
    if window == 0:
        curve = frame.get("BezierCurveData")
    else:
        locals_ = frame.get("LocalParameters", [])
        curve = locals_[window - 1].get("BezierCurveData") \
            if window - 1 < len(locals_) else None
    if not curve:
        w.write_flag(0)                       # tone_mapping_flag
        return
    w.write_flag(1)
    w.write(int(curve.get("KneePointX", 0)) & 0xFFF, 12)
    w.write(int(curve.get("KneePointY", 0)) & 0xFFF, 12)
    if llc:
        anchors = curve.get("Anchors", [])
    else:
        n = int(curve.get("NumberOfAnchors", 0))
        anchors = [curve.get(f"Anchor{i}", 0) for i in range(n)]
    anchors = anchors[:14]
    w.write(len(anchors), 4)                  # num_bezier_curve_anchors
    for a in anchors:
        w.write(int(a) & 0x3FF, 10)


def frame_payload(frame: dict, llc: bool) -> bytes:
    """ST 2094-40 app-4 T.35 payload for one frame (the
    fillMetadataArray analog). Local (ellipse) windows beyond the
    global one follow the LEGACY layout."""
    w = BitWriter()
    w.write(0xB5, 8)                          # itu_t_t35_country_code
    w.write(0x003C, 16)                       # terminal_provider_code
    w.write(0x0001, 16)                       # provider_oriented_code
    w.write(4, 8)                             # application_identifier
    w.write(1 if llc else 0, 8)               # application_version
    if llc:
        num_windows = 1
        w.write(num_windows, 2)
    else:
        locals_ = frame.get("LocalParameters", [])[:2]
        num_windows = int(frame.get("NumberOfWindows", 1))
        w.write(num_windows, 2)
        for lp in locals_:
            wd = lp.get("WindowData", {})
            for k in ("WindowUpperLeftCornerX", "WindowUpperLeftCornerY",
                      "WindowLowerRightCornerX", "WindowLowerRightCornerY"):
                w.write(int(wd.get(k, 0)) & 0xFFFF, 16)
            el = lp.get("EllipseData", {})
            w.write(int(el.get("CenterOfEllipseX", 0)) & 0xFFFF, 16)
            w.write(int(el.get("CenterOfEllipseY", 0)) & 0xFFFF, 16)
            ang = int(el.get("RotationAngle", 0))
            w.write((ang - 180 if ang > 180 else ang) & 0xFF, 8)
            w.write(int(el.get("SemimajorAxisInternalEllipse", 0)), 16)
            w.write(int(el.get("SemimajorAxisExternalEllipse", 0)), 16)
            w.write(int(el.get("SemiminorAxisExternalEllipse", 0)), 16)
            w.write(int(el.get("OverlapProcessOption", 0)) & 1, 1)
    peak = int(frame.get("TargetedSystemDisplayMaximumLuminance", 0))
    w.write(peak & 0x7FFFFFF, 27)
    w.write_flag(0)      # targeted_system_display_actual_peak_luminance
    for _ in range(num_windows):
        _window_payload(w, frame, llc)
    w.write_flag(0)      # mastering_display_actual_peak_luminance
    for wi in range(num_windows):
        _bezier_payload(w, frame, llc, window=wi)
    w.write_flag(0)      # color_saturation_mapping_flag
    w.align_zero()       # zero-pad the trailing partial byte
    return w.get_bytes()


def load_payloads(path: str) -> list[bytes]:
    """Parse an HDR10+ JSON sidecar into per-frame T.35 payloads
    (the hdr10plus_json_to_frame_eif analog, dynamicHDR10/api.cpp)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "SceneInfo" in data:
        frames, llc = data["SceneInfo"], True
    elif isinstance(data, list):
        frames, llc = data, False
    else:
        raise ValueError(f"unrecognized HDR10+ JSON layout in {path}")
    return [frame_payload(fr, llc) for fr in frames]


def write_t35_sei(payload: bytes) -> tuple[NalUnitType, bytes]:
    """Wrap a raw T.35 payload as a prefix SEI NAL rbsp (payload
    type 4, user_data_registered_itu_t_t35)."""
    w = BitWriter()
    w.write(SEI_USER_DATA_REGISTERED_T35, 8)
    size = len(payload)
    while size >= 255:
        w.write(255, 8)
        size -= 255
    w.write(size, 8)
    w.write_bytes(payload)
    w.align_one()
    return NalUnitType.PREFIX_SEI, w.get_bytes()


def parse_t35_seis(rbsp: bytes) -> list[bytes]:
    """Extract T.35 payloads from a prefix-SEI rbsp (test support)."""
    out, i = [], 0
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
        if ptype == SEI_USER_DATA_REGISTERED_T35:
            out.append(bytes(rbsp[i:i + size]))
        i += size
    return out
