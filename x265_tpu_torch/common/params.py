"""Encoder configuration (the x265_param analog).

Reference surface: x265 source/x265.h:753-1935 (x265_param) and
source/common/param.cpp (defaults/presets/validation). This is a
deliberately smaller, typed configuration object that grows field-by-
field as features land; `validate()` mirrors x265_check_params' role.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# Slice types (order matches the CABAC init-table rows; see ctx_tables)
B_SLICE = 0
P_SLICE = 1
I_SLICE = 2

CHROMA_420 = 1
CHROMA_422 = 2
CHROMA_444 = 3


@dataclass
class EncoderConfig:
    # source description
    width: int = 0
    height: int = 0
    fps_num: int = 25
    fps_den: int = 1
    bit_depth: int = 8
    chroma_format: int = CHROMA_420

    # coding structure
    ctu_size: int = 32           # 16/32/64
    min_cu_size: int = 8
    keyint: int = 250            # max GOP length (x265 --keyint)
    bframes: int = 0             # 0 = IPPP; >0 enables B-GOP (later)
    b_adapt: int = 1             # adaptive B placement from lowres
    #                              costs (slicetypePath analog,
    #                              slicetype.cpp:2378); 0 = fixed runs
    num_refs: int = 1            # L0 references for P slices (x265
    #                              --ref, param.cpp:211 medium = 3;
    #                              device ME selects the reference per
    #                              16/32 region from the coarse pass)
    tmvp: bool = False           # temporal MVP (sps_temporal_mvp,
    #                              clause 8.5.3.2.8; x265 default on,
    #                              encoder.cpp:3384). Flipped on by the
    #                              medium+ presets once col fields flow.
    max_merge: int = 2           # merge candidate list size (x265
    #                              --max-merge, param.cpp:196 default 3)

    # rate control (CQP only for now; ABR/CRF land with ratecontrol.py)
    qp: int = 32
    rc_mode: str = "cqp"
    bitrate: int = 0             # kbps, for abr
    crf: float = 28.0
    vbv_bufsize: int = 0         # kbits (x265 --vbv-bufsize)
    vbv_maxrate: int = 0         # kbps  (x265 --vbv-maxrate)
    vbv_init: float = 0.9        # initial buffer fullness fraction
    aud: bool = False            # emit access unit delimiters

    # video usability information / HDR signalling (Annex E; x265
    # --sar/--range/--colorprim/--transfer/--colormatrix/--chromaloc,
    # --master-display/--max-cll, param.cpp vui block)
    sar: tuple | None = None     # (w, h) pixel aspect ratio
    video_full_range: bool = False
    colorprim: int = 2           # unspecified
    transfer: int = 2
    colormatrix: int = 2
    chromaloc: int | None = None  # chroma_sample_loc_type (0..5)
    master_display: str = ""     # "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)"
    max_cll: str = ""            # "cll,fall"
    dhdr10_info: str = ""        # HDR10+ JSON sidecar path (x265
    #                              --dhdr10-info; dynamicHDR10/api.cpp)
    dhdr10_opt: bool = False     # emit the T.35 SEI only on IDR frames
    #                              (x265 --dhdr10-opt)

    @property
    def vbv_enabled(self) -> bool:
        return self.vbv_bufsize > 0 and self.vbv_maxrate > 0

    # in-loop filters
    deblock: bool = False
    sao: bool = False

    # tools
    hash_sei: int = 0            # decoded-picture-hash SEI: 0=off,
    #                              1=MD5, 2=CRC, 3=checksum (x265 --hash)
    lossless: bool = False       # cu_transquant_bypass on every CU
    #                              (x265 --lossless, param.cpp bLossless:
    #                              transform/quant/loop filters bypassed,
    #                              recon == source exactly)
    rdoq: bool = False
    sign_hiding: bool = True   # x265 default (param.cpp:208)
    wpp: bool = False

    # analysis
    intra_smoothing: bool = True  # strong_intra_smoothing off; [1 2 1] on
    intra_nxn: bool = True       # PART_NxN at min CU (4x4 luma PUs/TUs
    #                              with DST-IV; x265 rdLevel>=3 behavior,
    #                              search.cpp:2166 checkIntra PART_NxN)
    me_iters: int = 8            # integer diamond rounds, host/B path
    #                              (subme analog, motion.cpp:820 ladder)
    me_range: int = 10           # windowed full-search radius around the
    #                              coarse seed (merange analog) — the
    #                              fused P-GOP path's search effort.
    #                              Round-4 sweep: 6 -> 10 is worth 5.8
    #                              BD-rate points vs x265 medium
    #                              (+19.7% -> +13.9%); 12 adds nothing
    intra_in_inter: bool = True  # 8x8 intra CUs in P frames
    #                              (checkIntraInInter, search.cpp:1291)
    nr_inter: int = 0            # inter noise reduction strength
    #                              0-2000 (x265 --nr-inter; denoiseDct,
    #                              quant.cpp:744 + frameencoder.cpp:2098)
    lowpass_dct: bool = False    # approximate transform: half-size DCT
    #                              of 2x2 averages, high bands zeroed
    #                              (x265 --lowpass-dct, lowpassdct.cpp)
    rqt_inter: bool = True       # inter TU tree depth 1: 16/32 CUs may
    #                              code their residual as four TUs
    #                              (estimateResidualQT analog,
    #                              search.cpp:3178; SPS
    #                              max_transform_hierarchy_depth_inter)
    weightp: bool = True         # explicit weighted prediction for P
    #                              slices (x265 --weightp default on,
    #                              param.cpp bEnableWeightedPred;
    #                              weightPrediction.cpp:222 analysis)
    aq_mode: int = 0             # 0 off, 1 variance, 2 autovariance,
    #                              3 autovariance-biased (x265 default 2,
    #                              param.cpp:268)
    aq_strength: float = 1.0
    cutree: bool = False         # cuTree propagation (x265 default on,
    #                              param.cpp:273); needs aq/dQP plumbing
    qcomp: float = 0.6           # cuTree strength = 5*(1-qcomp)
    psy_rd: float = 2.0          # AC-energy preservation weight in the
    #                              leaf RDO (x265 param.cpp psyRd
    #                              default 2.0; rdcost.h calcPsyRdCost)

    @property
    def dqp_enabled(self) -> bool:
        """cu_qp_delta signalling needed (PPS cu_qp_delta_enabled_flag):
        any per-CTU QP source active."""
        return self.aq_mode > 0 or self.cutree

    def apply_preset(self, name: str) -> None:
        """Preset ladder over the implemented tool set (reference:
        x265 x265_param_default_preset, param.cpp:379-560 and
        doc/reST/presets.rst:36-108, mapped to this encoder's knobs)."""
        if name not in PRESETS:
            raise ValueError(f"unknown preset {name!r}")
        for k, v in PRESETS[name].items():
            setattr(self, k, v)

    def apply_tune(self, name: str) -> None:
        """Tunes (x265_param_default_preset tune column,
        presets.rst:112-217): psnr/ssim adjust AQ, grain freezes the
        QP machinery, fastdecode drops decoder-heavy tools,
        zerolatency removes B frames and lookahead depth."""
        if name not in TUNES:
            raise ValueError(f"unknown tune {name!r}")
        for k, v in TUNES[name].items():
            setattr(self, k, v)

    def enforce_level(self) -> list[str]:
        """Clamp parameters to the level the stream signals
        (level.cpp:290 enforceLevel analog): returns a list of human-
        readable adjustments made (empty = already conformant)."""
        notes = []
        fps = self.fps_num / max(self.fps_den, 1)
        idc = level_idc(self.width, self.height, fps)
        # Table A.6 main-tier max bitrate (kbps) per level
        max_br = {30: 128, 60: 1500, 63: 3000, 90: 6000, 93: 10000,
                  120: 12000, 123: 20000, 150: 25000, 153: 40000,
                  156: 60000, 180: 60000, 183: 120000, 186: 240000}
        cap = max_br.get(idc, 240000)
        if self.bitrate and self.bitrate > cap:
            notes.append(f"bitrate {self.bitrate} -> level {idc/30:.1f} "
                         f"cap {cap} kbps")
            self.bitrate = cap
        if self.vbv_maxrate and self.vbv_maxrate > cap:
            notes.append(f"vbv-maxrate clamped to {cap} kbps")
            self.vbv_maxrate = cap
        return notes

    def param_parse(self, name: str, value: str) -> None:
        """x265_param_parse-style string K/V (param.cpp): accepts the
        x265 option name (dashes) or the field name (underscores)."""
        key = name.replace("-", "_")
        alias = {
            "signhide": "sign_hiding", "sao": "sao", "deblock": "deblock",
            "keyint": "keyint", "b": "bframes", "ref": "num_refs",
            "ctu": "ctu_size", "min_cu_size": "min_cu_size",
            "hash": "hash_sei", "aq_mode": "aq_mode",
            "aq_strength": "aq_strength", "cutree": "cutree",
            "cu_tree": "cutree", "qcomp": "qcomp",
            "b_adapt": "b_adapt", "rqt": "rqt_inter",
            "lowpass_dct": "lowpass_dct", "nr_inter": "nr_inter",
        }
        key = alias.get(key, key)
        if not hasattr(self, key):
            raise ValueError(f"unknown parameter {name!r}")
        cur = getattr(self, key)
        if isinstance(cur, bool):
            setattr(self, key, value.lower() in ("1", "true", "yes", "on"))
        elif isinstance(cur, int):
            setattr(self, key, int(value))
        elif isinstance(cur, float):
            setattr(self, key, float(value))
        else:
            setattr(self, key, value)

    def validate(self) -> None:
        if self.width <= 0 or self.height <= 0:
            raise ValueError("frame size must be positive")
        if self.ctu_size not in (16, 32, 64):
            raise ValueError("ctu_size must be 16/32/64")
        if self.ctu_size == 16 and (self.bframes or self.keyint != 1):
            # the fused inter scans evaluate CU sizes up to 32; CTU 16
            # is an all-intra configuration (decoder handles 16/32/64)
            raise NotImplementedError(
                "ctu_size 16 supports all-intra only (keyint 1)")
        if self.bit_depth not in (8, 10):
            # Main12 (RExt) profile signalling is not implemented —
            # reject rather than emit a mislabelled stream
            raise ValueError("bit_depth must be 8 or 10 (Main/Main10)")
        if self.chroma_format != CHROMA_420:
            raise NotImplementedError("only 4:2:0 implemented so far")
        if not 0 <= self.qp <= 51:
            raise ValueError("qp out of range")
        if self.num_refs < 1 or self.num_refs > 8:
            raise ValueError("num_refs must be 1..8")
        if not 1 <= self.max_merge <= 5:
            raise ValueError("max_merge must be 1..5")

    # fields reconfigurable mid-stream: they change neither the SPS/
    # PPS nor any compiled program shape (x265_encoder_reconfig
    # contract, encoder.cpp:2284 — latched at the next frame)
    RECONFIGURABLE = frozenset((
        "qp", "crf", "bitrate", "me_range", "me_iters", "psy_rd",
        "aq_strength", "nr_inter", "keyint", "vbv_maxrate",
        "vbv_bufsize", "intra_in_inter"))

    def reconfigure(self, **updates) -> None:
        """Apply a mid-stream parameter update (the
        x265_encoder_reconfig analog): only fields that do not change
        stream headers or compiled shapes may move; anything else
        raises (x265 returns failure for those too)."""
        for k, v in updates.items():
            if k not in self.RECONFIGURABLE:
                raise ValueError(
                    f"{k!r} is not reconfigurable mid-stream")
            setattr(self, k, v)
        self.validate()

    # --- derived geometry ---------------------------------------------------

    @property
    def width_padded(self) -> int:
        m = self.min_cu_size
        return (self.width + m - 1) // m * m

    @property
    def height_padded(self) -> int:
        m = self.min_cu_size
        return (self.height + m - 1) // m * m

    @property
    def ctu_cols(self) -> int:
        return (self.width_padded + self.ctu_size - 1) // self.ctu_size

    @property
    def ctu_rows(self) -> int:
        return (self.height_padded + self.ctu_size - 1) // self.ctu_size

    @property
    def conf_win_right(self) -> int:
        # conformance window offsets are in chroma units for 4:2:0
        return (self.width_padded - self.width) // 2

    @property
    def conf_win_bottom(self) -> int:
        return (self.height_padded - self.height) // 2

    @property
    def log2_ctu(self) -> int:
        return self.ctu_size.bit_length() - 1

    @property
    def log2_min_cu(self) -> int:
        return self.min_cu_size.bit_length() - 1


# Preset ladder (x265 param.cpp:379-560 semantics over our knobs):
# me_iters ~ subme/search effort; bframes = mini-GOP B count (pyramid);
# ultrafast/superfast disable SAO, ultrafast also sign-hiding, exactly
# like the reference table.
PRESETS = {
    "ultrafast": dict(me_iters=2, me_range=2, bframes=3, sao=False,
                      sign_hiding=False, deblock=True, intra_nxn=False,
                      weightp=False, num_refs=1, tmvp=False,
                      max_merge=2, ctu_size=32),
    "superfast": dict(me_iters=3, me_range=3, bframes=3, sao=False,
                      sign_hiding=True, deblock=True, intra_nxn=False,
                      weightp=False, num_refs=1, tmvp=True,
                      max_merge=2, ctu_size=32),
    "veryfast": dict(me_iters=4, me_range=4, bframes=3, sao=True,
                     sign_hiding=True, deblock=True, num_refs=2,
                     tmvp=True, max_merge=2, ctu_size=32),
    "faster": dict(me_iters=5, me_range=5, bframes=3, sao=True,
                   sign_hiding=True, deblock=True, num_refs=2,
                   tmvp=True, max_merge=2, ctu_size=32),
    "fast": dict(me_iters=6, me_range=5, bframes=3, sao=True,
                 sign_hiding=True, deblock=True, num_refs=3,
                 tmvp=True, max_merge=2, ctu_size=32),
    "medium": dict(me_iters=8, me_range=10, bframes=4, sao=True,
                   sign_hiding=True, deblock=True, num_refs=3,
                   tmvp=True, max_merge=3, ctu_size=64),
    "slow": dict(rdoq=True, me_iters=10, me_range=10, bframes=4, sao=True,
                 sign_hiding=True, deblock=True, num_refs=4, tmvp=True,
                 max_merge=3, ctu_size=64),
    "slower": dict(rdoq=True, me_iters=12, me_range=12, bframes=8, sao=True,
                   sign_hiding=True, deblock=True, num_refs=4,
                   tmvp=True, max_merge=4, ctu_size=64),
    "veryslow": dict(rdoq=True, me_iters=16, me_range=12, bframes=8,
                     sao=True, sign_hiding=True, deblock=True,
                     num_refs=5, tmvp=True, max_merge=4, ctu_size=64),
    "placebo": dict(rdoq=True, me_iters=16, me_range=12, bframes=8,
                    sao=True, sign_hiding=True, deblock=True,
                    num_refs=5, tmvp=True, max_merge=5, ctu_size=64),
}


# Tunes (presets.rst:112-217 semantics over our knobs)
TUNES = {
    "psnr": dict(aq_mode=0, cutree=False, psy_rd=0.0),  # pure-PSNR
    "ssim": dict(aq_mode=2, aq_strength=1.0),       # variance AQ helps SSIM
    "grain": dict(aq_mode=0, cutree=False,          # freeze QP machinery
                  sign_hiding=False, psy_rd=4.0),
    "fastdecode": dict(sao=False, deblock=False,    # drop decoder load
                       sign_hiding=False),
    "zerolatency": dict(bframes=0),                 # no reordering
}


def level_idc(width: int, height: int, fps: float) -> int:
    """Pick the smallest level whose limits fit (H.265 Table A.6, main tier)."""
    luma_ps = width * height
    luma_sr = luma_ps * fps
    # (level*30, MaxLumaPs, MaxLumaSr)
    table = [
        (30, 36864, 552960), (60, 122880, 3686400), (63, 245760, 7372800),
        (90, 552960, 16588800), (93, 983040, 33177600),
        (120, 2228224, 66846720), (123, 2228224, 133693440),
        (150, 8912896, 267386880), (153, 8912896, 534773760),
        (156, 8912896, 1069547520), (180, 35651584, 1069547520),
        (183, 35651584, 2139095040), (186, 35651584, 4278190080),
    ]
    for idc, max_ps, max_sr in table:
        if luma_ps <= max_ps and luma_sr <= max_sr:
            return idc
    return 186
