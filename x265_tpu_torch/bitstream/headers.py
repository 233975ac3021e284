"""VPS / SPS / PPS / slice-header RBSP writers (H.265 clause 7.3).

Written from the spec syntax tables; behavioral parity reference:
x265 source/encoder/entropy.cpp:233-763 (codeVPS/codeSPS/codePPS/
codeSliceHeader). Only the feature set the encoder currently emits is
signalled; every field is written explicitly so the stream documents
its own configuration.
"""

from __future__ import annotations

from ..common.params import EncoderConfig, I_SLICE, P_SLICE, B_SLICE, level_idc
from .bitwriter import BitWriter


def write_profile_tier_level(w: BitWriter, cfg: EncoderConfig) -> None:
    """profile_tier_level(1, 0) — clause 7.3.3."""
    main10 = cfg.bit_depth > 8
    profile = 2 if main10 else 1
    w.write(0, 2)                     # general_profile_space
    w.write_flag(0)                   # general_tier_flag (main tier)
    w.write(profile, 5)               # general_profile_idc
    compat = (1 << (31 - 2)) if main10 else ((1 << (31 - 1)) | (1 << (31 - 2)))
    w.write(compat, 32)               # general_profile_compatibility_flags
    w.write_flag(1)                   # general_progressive_source_flag
    w.write_flag(0)                   # general_interlaced_source_flag
    w.write_flag(0)                   # general_non_packed_constraint_flag
    w.write_flag(1)                   # general_frame_only_constraint_flag
    w.write(0, 22)                    # general_reserved_zero_44bits
    w.write(0, 22)
    fps = cfg.fps_num / max(cfg.fps_den, 1)
    w.write(level_idc(cfg.width_padded, cfg.height_padded, fps), 8)


def write_vps(cfg: EncoderConfig) -> bytes:
    """video_parameter_set_rbsp — clause 7.3.2.1."""
    w = BitWriter()
    w.write(0, 4)                     # vps_video_parameter_set_id
    w.write(3, 2)                     # vps_base_layer_internal/available (reserved=3)
    w.write(0, 6)                     # vps_max_layers_minus1
    w.write(0, 3)                     # vps_max_sub_layers_minus1
    w.write_flag(1)                   # vps_temporal_id_nesting_flag
    w.write(0xFFFF, 16)               # vps_reserved_0xffff_16bits
    write_profile_tier_level(w, cfg)
    w.write_flag(1)                   # vps_sub_layer_ordering_info_present_flag
    w.write_ue(dpb_max_buffering(cfg))   # vps_max_dec_pic_buffering_minus1
    w.write_ue(num_reorder_pics(cfg))    # vps_max_num_reorder_pics
    w.write_ue(0)                     # vps_max_latency_increase_plus1
    w.write(0, 6)                     # vps_max_layer_id
    w.write_ue(0)                     # vps_num_layer_sets_minus1
    w.write_flag(1)                   # vps_timing_info_present_flag
    w.write(cfg.fps_den, 32)          # vps_num_units_in_tick
    w.write(cfg.fps_num, 32)          # vps_time_scale
    w.write_flag(0)                   # vps_poc_proportional_to_timing_flag
    w.write_ue(0)                     # vps_num_hrd_parameters
    w.write_flag(0)                   # vps_extension_flag
    w.align_one()
    return w.get_bytes()


def dpb_max_buffering(cfg: EncoderConfig) -> int:
    # max_dec_pic_buffering_minus1: refs + current
    return max(cfg.num_refs, 1)


def num_reorder_pics(cfg: EncoderConfig) -> int:
    return 1 if cfg.bframes > 0 else 0


def write_sps(cfg: EncoderConfig) -> bytes:
    """seq_parameter_set_rbsp — clause 7.3.2.2."""
    w = BitWriter()
    w.write(0, 4)                     # sps_video_parameter_set_id
    w.write(0, 3)                     # sps_max_sub_layers_minus1
    w.write_flag(1)                   # sps_temporal_id_nesting_flag
    write_profile_tier_level(w, cfg)
    w.write_ue(0)                     # sps_seq_parameter_set_id
    w.write_ue(cfg.chroma_format)     # chroma_format_idc
    w.write_ue(cfg.width_padded)      # pic_width_in_luma_samples
    w.write_ue(cfg.height_padded)     # pic_height_in_luma_samples
    crop = cfg.conf_win_right or cfg.conf_win_bottom
    w.write_flag(1 if crop else 0)    # conformance_window_flag
    if crop:
        w.write_ue(0)                 # conf_win_left_offset
        w.write_ue(cfg.conf_win_right)
        w.write_ue(0)                 # conf_win_top_offset
        w.write_ue(cfg.conf_win_bottom)
    w.write_ue(cfg.bit_depth - 8)     # bit_depth_luma_minus8
    w.write_ue(cfg.bit_depth - 8)     # bit_depth_chroma_minus8
    w.write_ue(POC_LSB_BITS - 4)      # log2_max_pic_order_cnt_lsb_minus4
    w.write_flag(1)                   # sps_sub_layer_ordering_info_present_flag
    w.write_ue(dpb_max_buffering(cfg))
    w.write_ue(num_reorder_pics(cfg))
    w.write_ue(0)                     # sps_max_latency_increase_plus1
    w.write_ue(cfg.log2_min_cu - 3)   # log2_min_luma_coding_block_size_minus3
    w.write_ue(cfg.log2_ctu - cfg.log2_min_cu)
    w.write_ue(0)                     # log2_min_luma_transform_block_size_minus2
    w.write_ue(min(cfg.log2_ctu, 5) - 2)  # log2_diff_max_min_transform_block_size
    # inter TU tree depth (16/32 CUs may split residual into 4 TUs)
    w.write_ue(1 if getattr(cfg, "rqt_inter", False) else 0)
    w.write_ue(0)                     # max_transform_hierarchy_depth_intra
    w.write_flag(0)                   # scaling_list_enabled_flag
    w.write_flag(0)                   # amp_enabled_flag
    w.write_flag(1 if cfg.sao else 0)  # sample_adaptive_offset_enabled_flag
    w.write_flag(0)                   # pcm_enabled_flag
    w.write_ue(0)                     # num_short_term_ref_pic_sets
    w.write_flag(0)                   # long_term_ref_pics_present_flag
    w.write_flag(1 if getattr(cfg, "tmvp", False) else 0)
    #                                 # sps_temporal_mvp_enabled_flag
    w.write_flag(0)                   # strong_intra_smoothing_enabled_flag
    w.write_flag(1)                   # vui_parameters_present_flag
    _write_vui(w, cfg)
    w.write_flag(0)                   # sps_extension_present_flag
    w.align_one()
    return w.get_bytes()


POC_LSB_BITS = 8


def _write_vui(w: BitWriter, cfg: EncoderConfig) -> None:
    """vui_parameters — Annex E.2.1 (timing, aspect ratio, video
    signal type / colour description, chroma siting)."""
    sar = getattr(cfg, "sar", None)
    if sar:
        w.write_flag(1)               # aspect_ratio_info_present_flag
        w.write(255, 8)               # aspect_ratio_idc = EXTENDED_SAR
        w.write(int(sar[0]), 16)      # sar_width
        w.write(int(sar[1]), 16)      # sar_height
    else:
        w.write_flag(0)               # aspect_ratio_info_present_flag
    w.write_flag(0)                   # overscan_info_present_flag
    has_colour = (getattr(cfg, "colorprim", 2) != 2 or
                  getattr(cfg, "transfer", 2) != 2 or
                  getattr(cfg, "colormatrix", 2) != 2)
    if has_colour or getattr(cfg, "video_full_range", False):
        w.write_flag(1)               # video_signal_type_present_flag
        w.write(5, 3)                 # video_format = unspecified
        w.write_flag(1 if cfg.video_full_range else 0)
        w.write_flag(1 if has_colour else 0)
        if has_colour:                # colour_description_present_flag
            w.write(cfg.colorprim, 8)
            w.write(cfg.transfer, 8)
            w.write(cfg.colormatrix, 8)
    else:
        w.write_flag(0)               # video_signal_type_present_flag
    if getattr(cfg, "chromaloc", None) is not None:
        w.write_flag(1)               # chroma_loc_info_present_flag
        w.write_ue(cfg.chromaloc)     # chroma_sample_loc_type_top_field
        w.write_ue(cfg.chromaloc)     # chroma_sample_loc_type_bottom
    else:
        w.write_flag(0)               # chroma_loc_info_present_flag
    w.write_flag(0)                   # neutral_chroma_indication_flag
    w.write_flag(0)                   # field_seq_flag
    w.write_flag(0)                   # frame_field_info_present_flag
    w.write_flag(0)                   # default_display_window_flag
    w.write_flag(1)                   # vui_timing_info_present_flag
    w.write(cfg.fps_den, 32)          # vui_num_units_in_tick
    w.write(cfg.fps_num, 32)          # vui_time_scale
    w.write_flag(0)                   # vui_poc_proportional_to_timing_flag
    if cfg.vbv_enabled:
        w.write_flag(1)               # vui_hrd_parameters_present_flag
        _write_hrd(w, cfg)
    else:
        w.write_flag(0)               # vui_hrd_parameters_present_flag
    w.write_flag(0)                   # bitstream_restriction_flag


# HRD fixed-point field widths (shared with the buffering period /
# pic timing SEI writers, sei.py)
HRD_INIT_DELAY_LEN = 23
HRD_AU_DELAY_LEN = 23
HRD_DPB_DELAY_LEN = 23
HRD_BIT_RATE_SCALE = 4
HRD_CPB_SIZE_SCALE = 4


def _write_hrd(w: BitWriter, cfg: EncoderConfig) -> None:
    """hrd_parameters — Annex E.2.2, one NAL CPB (the VBV signalling,
    ratecontrol.cpp:2277 initHRD analog)."""
    w.write_flag(1)                   # nal_hrd_parameters_present_flag
    w.write_flag(0)                   # vcl_hrd_parameters_present_flag
    w.write_flag(0)                   # sub_pic_hrd_params_present_flag
    w.write(HRD_BIT_RATE_SCALE, 4)    # bit_rate_scale
    w.write(HRD_CPB_SIZE_SCALE, 4)    # cpb_size_scale
    w.write(HRD_INIT_DELAY_LEN - 1, 5)
    w.write(HRD_AU_DELAY_LEN - 1, 5)
    w.write(HRD_DPB_DELAY_LEN - 1, 5)
    # sub-layer 0
    w.write_flag(1)                   # fixed_pic_rate_general_flag
    w.write_ue(0)                     # elemental_duration_in_tc_minus1
    w.write_ue(0)                     # cpb_cnt_minus1
    # sub_layer_hrd_parameters, CPB 0
    br = (cfg.vbv_maxrate * 1000) >> (6 + HRD_BIT_RATE_SCALE)
    cs = (cfg.vbv_bufsize * 1000) >> (4 + HRD_CPB_SIZE_SCALE)
    w.write_ue(max(br, 1) - 1)        # bit_rate_value_minus1
    w.write_ue(max(cs, 1) - 1)        # cpb_size_value_minus1
    w.write_flag(0)                   # cbr_flag


def write_pps(cfg: EncoderConfig) -> bytes:
    """pic_parameter_set_rbsp — clause 7.3.2.3."""
    w = BitWriter()
    w.write_ue(0)                     # pps_pic_parameter_set_id
    w.write_ue(0)                     # pps_seq_parameter_set_id
    w.write_flag(0)                   # dependent_slice_segments_enabled_flag
    w.write_flag(0)                   # output_flag_present_flag
    w.write(0, 3)                     # num_extra_slice_header_bits
    w.write_flag(1 if cfg.sign_hiding else 0)  # sign_data_hiding_enabled_flag
    w.write_flag(0)                   # cabac_init_present_flag
    w.write_ue(0)                     # num_ref_idx_l0_default_active_minus1
    w.write_ue(0)                     # num_ref_idx_l1_default_active_minus1
    w.write_se(cfg.qp - 26)           # init_qp_minus26
    w.write_flag(0)                   # constrained_intra_pred_flag
    w.write_flag(0)                   # transform_skip_enabled_flag
    # cu_qp_delta: QG == CTU (diff_cu_qp_delta_depth = 0), so QP
    # prediction degenerates to the previous QG in raster order
    # (clause 8.6.1: the left/above QGs are in other CTBs)
    w.write_flag(1 if cfg.dqp_enabled else 0)  # cu_qp_delta_enabled_flag
    if cfg.dqp_enabled:
        w.write_ue(0)                 # diff_cu_qp_delta_depth
    w.write_se(0)                     # pps_cb_qp_offset
    w.write_se(0)                     # pps_cr_qp_offset
    w.write_flag(0)                   # pps_slice_chroma_qp_offsets_present_flag
    w.write_flag(1 if cfg.weightp else 0)  # weighted_pred_flag
    w.write_flag(0)                   # weighted_bipred_flag (x265
    #                                   default: --weightb off)
    w.write_flag(1 if cfg.lossless else 0)  # transquant_bypass_enabled_flag
    w.write_flag(0)                   # tiles_enabled_flag
    w.write_flag(1 if cfg.wpp else 0)  # entropy_coding_sync_enabled_flag
    w.write_flag(1)                   # pps_loop_filter_across_slices_enabled_flag
    w.write_flag(1)                   # deblocking_filter_control_present_flag
    w.write_flag(0)                   # deblocking_filter_override_enabled_flag
    w.write_flag(0 if cfg.deblock else 1)  # pps_deblocking_filter_disabled_flag
    if cfg.deblock:
        w.write_se(0)                 # pps_beta_offset_div2
        w.write_se(0)                 # pps_tc_offset_div2
    w.write_flag(0)                   # pps_scaling_list_data_present_flag
    w.write_flag(0)                   # lists_modification_present_flag
    w.write_ue(0)                     # log2_parallel_merge_level_minus2
    w.write_flag(0)                   # slice_segment_header_extension_present_flag
    w.write_flag(0)                   # pps_extension_present_flag
    w.align_one()
    return w.get_bytes()


def write_slice_header(cfg: EncoderConfig, slice_type: int, *, poc: int = 0,
                       idr: bool = True, slice_qp: int | None = None,
                       ref_delta_poc: int = 1, ref_delta_poc_after: int = 1,
                       max_merge: int = 2,
                       rps_neg: list[tuple[int, bool]] | None = None,
                       rps_pos: list[tuple[int, bool]] | None = None,
                       num_entry_points: int = 0,
                       entry_point_offsets: list[int] | None = None,
                       weights=None, num_ref: int = 1,
                       tmvp: bool = False) -> BitWriter:
    """slice_segment_header — clause 7.3.6.1. Returns the open BitWriter so
    the caller appends CABAC slice data after byte alignment.

    rps_neg/rps_pos: general short-term RPS as (delta_poc, used) lists,
    deltas positive and ascending (the DPB retention contract,
    dpb.cpp:221 analog). When absent, the legacy 1-before(+1-after for
    B) set is written from ref_delta_poc/ref_delta_poc_after."""
    if slice_qp is None:
        slice_qp = cfg.qp
    w = BitWriter()
    w.write_flag(1)                   # first_slice_segment_in_pic_flag
    if idr:
        w.write_flag(0)               # no_output_of_prior_pics_flag
    w.write_ue(0)                     # slice_pic_parameter_set_id
    w.write_ue(slice_type)            # slice_type (2=I, 1=P, 0=B)
    if not idr:
        w.write(poc & ((1 << POC_LSB_BITS) - 1), POC_LSB_BITS)
        w.write_flag(0)               # short_term_ref_pic_set_sps_flag -> inline
        # st_ref_pic_set() (clause 7.3.7)
        if rps_neg is None:
            delta_poc = ref_delta_poc if ref_delta_poc else 1
            rps_neg = [(delta_poc * k, True)
                       for k in range(1, max(num_ref, 1) + 1)]
            rps_pos = [(ref_delta_poc_after or 1, True)] \
                if slice_type == B_SLICE else []
        rps_pos = rps_pos or []
        w.write_ue(len(rps_neg))      # num_negative_pics
        w.write_ue(len(rps_pos))      # num_positive_pics
        prev = 0
        for delta, used in rps_neg:
            w.write_ue(delta - prev - 1)   # delta_poc_s0_minus1
            w.write_flag(1 if used else 0)
            prev = delta
        prev = 0
        for delta, used in rps_pos:
            w.write_ue(delta - prev - 1)   # delta_poc_s1_minus1
            w.write_flag(1 if used else 0)
            prev = delta
        if getattr(cfg, "tmvp", False):
            w.write_flag(1 if tmvp else 0)
            #                         # slice_temporal_mvp_enabled_flag
    if cfg.sao:
        w.write_flag(1)               # slice_sao_luma_flag
        w.write_flag(1)               # slice_sao_chroma_flag
    if slice_type != I_SLICE:
        # num_ref_idx override: the PPS default is 1 ref/list
        if slice_type == P_SLICE and num_ref > 1:
            w.write_flag(1)           # num_ref_idx_active_override_flag
            w.write_ue(num_ref - 1)   # num_ref_idx_l0_active_minus1
        else:
            w.write_flag(0)
        # ref_pic_lists_modification absent (flag off)
        if slice_type == B_SLICE:
            w.write_flag(0)           # mvd_l1_zero_flag
        # cabac_init absent (cabac_init_present_flag = 0)
        if getattr(cfg, "tmvp", False) and tmvp:
            # collocated_from_l0 inferred 1 for P; the collocated
            # picture is always L0 ref 0 (the previous frame)
            if num_ref > 1:
                w.write_ue(0)         # collocated_ref_idx
        if cfg.weightp and slice_type == P_SLICE:
            # pred_weight_table, clause 7.3.6.3. Explicit weights come
            # from weightp.WeightParams for ref 0; further refs write
            # inferred-neutral flags (decodes identically to the
            # default path — nested-floor identity,
            # ops/me_win.apply_weight_acc). None = all-neutral.
            wp = weights
            denom = wp.denom if wp is not None else 6
            w.write_ue(denom)             # luma_log2_weight_denom
            w.write_se(0)                 # delta_chroma_log2_weight_denom
            luma_on = wp is not None and wp.luma_on
            chroma_on = wp is not None and wp.chroma_on
            for i in range(num_ref):      # luma_weight_l0_flag[i]
                w.write_flag(1 if (luma_on and i == 0) else 0)
            for i in range(num_ref):      # chroma_weight_l0_flag[i]
                w.write_flag(1 if (chroma_on and i == 0) else 0)
            if luma_on:
                w.write_se(wp.wy - (1 << denom))  # delta_luma_weight_l0
                w.write_se(wp.oy)                 # luma_offset_l0
            if chroma_on:
                for wc, oc in ((wp.wcb, wp.ocb), (wp.wcr, wp.ocr)):
                    w.write_se(wc - (1 << denom))  # delta_chroma_weight
                    # delta encodes offset + ((128*w) >> denom) - 128
                    w.write_se(oc + ((128 * wc) >> denom) - 128)
        w.write_ue(5 - max_merge)     # five_minus_max_num_merge_cand
    w.write_se(slice_qp - cfg.qp)     # slice_qp_delta (init_qp = cfg.qp)
    # deblocking override disabled; loop-filter-across flag only when a
    # filter is active
    if cfg.sao or cfg.deblock:
        w.write_flag(1)               # slice_loop_filter_across_slices_enabled_flag
    if cfg.wpp:
        w.write_ue(num_entry_points)  # num_entry_point_offsets
        if num_entry_points:
            offsets = entry_point_offsets or []
            olen = max(o.bit_length() for o in offsets)
            w.write_ue(olen - 1)      # offset_len_minus1
            for o in offsets:
                w.write(o - 1, olen)  # entry_point_offset_minus1
    w.align_one()                     # byte_alignment()
    return w
