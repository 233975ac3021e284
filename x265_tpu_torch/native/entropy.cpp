// Native CABAC slice-data encoder for the x265_tpu framework.
//
// This is the serial entropy stage (the only intrinsically sequential
// part of HEVC encoding); it mirrors the tested Python implementation
// in x265_tpu/bitstream/{cabac,syntax}.py bin-for-bin, and exists for
// throughput: the per-bin loop must run at native speed while the
// massively parallel analysis/reconstruction stages run on the TPU.
// Reference analog: x265 source/encoder/entropy.cpp (CABAC + CTU
// syntax); engine uses the same HM register formulation.
//
// Context layout and initialization states are PASSED IN from Python
// (ctx_tables.py is the single source of truth); the struct of offsets
// below must match the group order there (asserted at load time by
// entropy_native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- normative engine tables (H.265 Table 9-46/9-47) ----------------------
const uint8_t RANGE_TAB_LPS[64][4] = {
    {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
    {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
    {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
    {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
    {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
    {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
    {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
    {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
    {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
    {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
    {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
    {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
    {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
    {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
    {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
    {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2},
};
const uint8_t TRANS_IDX_LPS[64] = {
    0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,
    22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,
    35,35,35,36,36,36,37,37,37,38,38,63,
};

struct Tables {
    uint8_t next_mps[128];
    uint8_t next_lps[128];
    uint8_t renorm[128];  // shifts for lps value per state
    Tables() {
        for (int p = 0; p < 64; p++) {
            for (int m = 0; m < 2; m++) {
                int s = (p << 1) | m;
                if (p == 63) { next_mps[s] = s; next_lps[s] = s; }
                else {
                    int pm = (p == 62) ? 62 : p + 1;
                    next_mps[s] = (pm << 1) | m;
                    next_lps[s] = (p == 0)
                        ? ((TRANS_IDX_LPS[p] << 1) | (1 - m))
                        : ((TRANS_IDX_LPS[p] << 1) | m);
                }
            }
        }
        (void)renorm;
    }
};
const Tables T;

static int renorm_shift(int lps) {
    // smallest n with (lps << n) >= 256
    int n = 0;
    while ((lps << n) < 256) n++;
    return n;
}

// ---- CABAC encoder (HM register formulation) ------------------------------
struct Cabac {
    uint64_t low = 0;
    uint32_t range = 510;
    int bits_left = -12;
    uint32_t buffered_byte = 0xFF;
    int num_buffered = 0;
    uint64_t nbits = 0;     // renormalization bits pushed so far
    std::vector<uint8_t> out;
    uint8_t* ctx;

    // exact fractional coder position in 1/256-bit units: emitted
    // bits plus the entropy still held in the range register — the
    // bit-counting mode of x265's RDO entropy (entropy.cpp:2217)
    // realized as position deltas on the REAL coder
    int64_t pos256() const {
        double f = 9.0 - std::log2((double)range);
        return (int64_t)(nbits << 8) + (int64_t)(f * 256.0 + 0.5);
    }

    explicit Cabac(uint8_t* states) : ctx(states) { out.reserve(1 << 16); }

    void reset() {
        low = 0; range = 510; bits_left = -12;
        buffered_byte = 0xFF; num_buffered = 0;
        out.clear();
    }

    void write_out() {
        uint32_t lead = (uint32_t)(low >> (13 + bits_left));
        low &= ((uint64_t)1 << (13 + bits_left)) - 1;
        bits_left -= 8;
        if (lead == 0xFF) { num_buffered++; }
        else {
            if (num_buffered > 0) {
                uint32_t carry = lead >> 8;
                out.push_back((buffered_byte + carry) & 0xFF);
                uint8_t fill = (0xFF + carry) & 0xFF;
                for (int i = 0; i < num_buffered - 1; i++) out.push_back(fill);
            }
            num_buffered = 1;
            buffered_byte = lead & 0xFF;
        }
    }

    void encode_bin(int idx, int bin) {
        uint8_t mstate = ctx[idx];
        ctx[idx] = (bin == (mstate & 1)) ? T.next_mps[mstate]
                                         : T.next_lps[mstate];
        uint32_t lps = RANGE_TAB_LPS[mstate >> 1][(range >> 6) & 3];
        range -= lps;
        int nbits;
        if (bin != (mstate & 1)) {
            nbits = renorm_shift(lps);
            low += range;
            range = lps;
        } else {
            nbits = (range < 256) ? 1 : 0;
        }
        low <<= nbits;
        range <<= nbits;
        bits_left += nbits;
        this->nbits += nbits;
        if (bits_left >= 0) write_out();
    }

    void encode_bypass(int bin) {
        low <<= 1;
        if (bin) low += range;
        bits_left += 1;
        nbits += 1;
        if (bits_left >= 0) write_out();
    }

    void encode_bypass_bins(uint32_t value, int nbins) {
        while (nbins > 8) {
            nbins -= 8;
            uint32_t pattern = value >> nbins;
            low = (low << 8) + (uint64_t)range * pattern;
            value -= pattern << nbins;
            bits_left += 8;
            nbits += 8;
            if (bits_left >= 0) write_out();
        }
        low = (low << nbins) + (uint64_t)range * value;
        bits_left += nbins;
        nbits += nbins;
        if (bits_left >= 0) write_out();
    }

    void encode_terminate(int bin) {
        range -= 2;
        if (bin) {
            low += range;
            low <<= 7;
            range = 2 << 7;
            bits_left += 7;
            nbits += 7;
        } else if (range >= 256) {
            return;
        } else {
            low <<= 1;
            range <<= 1;
            bits_left += 1;
            nbits += 1;
        }
        if (bits_left >= 0) write_out();
    }

    // flush; returns (tail_value, tail_nbits) appended as whole bits
    void finish(uint32_t* tail_val, int* tail_bits) {
        if (low >> (21 + bits_left)) {
            out.push_back((buffered_byte + 1) & 0xFF);
            for (int i = 0; i < num_buffered - 1; i++) out.push_back(0x00);
            low -= (uint64_t)1 << (21 + bits_left);
        } else {
            if (num_buffered > 0) out.push_back(buffered_byte);
            for (int i = 0; i < num_buffered - 1; i++) out.push_back(0xFF);
        }
        int nbits = 13 + bits_left;
        *tail_bits = nbits > 0 ? nbits : 0;
        *tail_val = nbits > 0
            ? (uint32_t)((low >> 8) & (((uint64_t)1 << nbits) - 1)) : 0;
    }
};

// ---- context group offsets (generated to match ctx_tables.py) -------------
#include "ctx_offsets.h"

// ---- scan tables (clause 6.5.3), built on first use -----------------------
struct Scans {
    // [scan_idx][log2-2]: raster index per scan position (CG-major)
    std::vector<int> full[3][4];
    std::vector<int> cg[3][4];     // CG (x,y) pairs
    int inv4[3][16];               // scan pos per raster pos, 4x4

    static void diag(int n, std::vector<int>& xy) {
        int x = 0, y = 0;
        while ((int)xy.size() < 2 * n * n) {
            while (y >= 0) {
                if (x < n && y < n) { xy.push_back(x); xy.push_back(y); }
                y--; x++;
            }
            y = x; x = 0;
        }
    }
    static void order(int scan, int n, std::vector<int>& xy) {
        if (scan == 1) {         // horizontal
            for (int y = 0; y < n; y++)
                for (int x = 0; x < n; x++) { xy.push_back(x); xy.push_back(y); }
        } else if (scan == 2) {  // vertical
            for (int x = 0; x < n; x++)
                for (int y = 0; y < n; y++) { xy.push_back(x); xy.push_back(y); }
        } else diag(n, xy);
    }
    Scans() {
        for (int s = 0; s < 3; s++) {
            for (int l2 = 2; l2 <= 5; l2++) {
                int n = 1 << l2;
                std::vector<int> inner; order(s, 4, inner);
                std::vector<int>& f = full[s][l2 - 2];
                std::vector<int>& c = cg[s][l2 - 2];
                if (l2 == 2) {
                    for (int i = 0; i < 16; i++)
                        f.push_back(inner[2*i+1] * n + inner[2*i]);
                    c.push_back(0); c.push_back(0);
                } else {
                    std::vector<int> cgxy; order(s, n >> 2, cgxy);
                    c = cgxy;
                    for (size_t g = 0; g < cgxy.size() / 2; g++)
                        for (int i = 0; i < 16; i++) {
                            int x = cgxy[2*g] * 4 + inner[2*i];
                            int y = cgxy[2*g+1] * 4 + inner[2*i+1];
                            f.push_back(y * n + x);
                        }
                }
            }
            for (int i = 0; i < 16; i++) inv4[s][full[s][0][i]] = i;
        }
    }
};
const Scans S;

const int GROUP_IDX[32] = {0,1,2,3,4,4,5,5,6,6,6,6,7,7,7,7,
                           8,8,8,8,8,8,8,8,9,9,9,9,9,9,9,9};
const int MIN_IN_GROUP[10] = {0,1,2,3,4,6,8,12,16,24};
const int SIG_CTX_4X4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};

inline int intra_scan_idx(int mode, int log2_size, bool luma) {
    if ((luma && log2_size <= 3) || (!luma && log2_size == 2)) {
        if (mode >= 6 && mode <= 14) return 2;
        if (mode >= 22 && mode <= 30) return 1;
    }
    return 0;
}

// ---- slice syntax ---------------------------------------------------------
struct SliceEnc {
    Cabac cab;
    const uint8_t *depth8, *mode8;
    const int16_t *cy, *ccb, *ccr;
    int w, h, n8x, n8y, log2_ctu, log2_min_cu;
    // P-slice state
    int slice_type = 2;
    const int32_t* mv8 = nullptr;
    int max_merge = 2;
    // multi-reference P (x265 --ref): per-cell L0 refIdx + ref POCs
    const uint8_t* ref8 = nullptr;     // null = all refIdx 0
    int num_ref = 1;
    const int32_t* ref_pocs = nullptr; // (num_ref,)
    // temporal MVP (clause 8.5.3.2.8): collocated picture fields
    int tmvp = 0;
    // bit-counting harvest: per-min-cell ACTUAL CU bits (x16 fixed
    // point), written at each leaf CU's origin cell
    int32_t* cu_bits = nullptr;
    const int32_t* col_mv = nullptr;   // (n8, 2)
    const uint8_t* col_ref8 = nullptr;
    const uint8_t* col_inter8 = nullptr;
    int col_poc = 0;
    const int32_t* col_ref_pocs = nullptr;
    int n_col_refs = 1;
    // B-slice state: per-cell pred flags + MVs per list, POCs for the
    // AMVP scaling pass (mv_derive.py MvFieldB twin)
    const int32_t* mvb = nullptr;      // (n8, 2 lists, 2)
    const uint8_t* pf8 = nullptr;
    int poc = 0, poc_ref0 = 0, poc_ref1 = 0;
    std::vector<uint8_t> fld_pf;       // coded motion field (parse order)
    std::vector<int32_t> fld_mv;       // (n8*4): [cell][list][xy]
    int sign_hiding = 0;
    int lossless = 0;              // cu_transquant_bypass on every CU
    const uint8_t* cmode8 = nullptr;   // chroma pred mode; null = DM
    const uint8_t* intra8 = nullptr;   // P slices: 8x8 intra CU flags
    const uint8_t* tusplit8 = nullptr; // inter TU-tree split flags
    int rqt_inter = 0;                 // SPS max TU hierarchy depth inter
    const uint8_t* nxn8 = nullptr;     // PART_NxN flags at min CU
    const uint8_t* mode4 = nullptr;    // per-PU modes, 4x4 granularity
    const int32_t* sao_p[3] = {nullptr, nullptr, nullptr};
    // per-CTU dQP (cu_qp_delta; QG == CTU so the predictor is the
    // previous QG's QP in raster order)
    const int32_t* qp_map = nullptr;   // (rows, cols) desired per-CTU QP
    int slice_qp = 26;
    int prev_qp = 26;
    int dqp_target = 26;
    bool dqp_pending = false;
    // WPP (entropy_coding_sync): one byte-aligned substream per CTU
    // row; row r+1 starts from the contexts saved after CTU 1 of row r
    // (frameencoder.cpp:1509-1537 behavior)
    int wpp = 0;
    int num_ctx = 0;
    std::vector<std::vector<uint8_t>> substreams;
    std::vector<uint8_t> skip8, coded8;

    SliceEnc(uint8_t* states, const uint8_t* d8, const uint8_t* m8,
             const int16_t* y, const int16_t* cb, const int16_t* cr,
             int w_, int h_, int l2ctu, int l2min)
        : cab(states), depth8(d8), mode8(m8), cy(y), ccb(cb), ccr(cr),
          w(w_), h(h_), n8x(w_ / 8), n8y(h_ / 8),
          log2_ctu(l2ctu), log2_min_cu(l2min),
          skip8(n8x * n8y, 0), coded8(n8x * n8y, 0),
          fld_pf(n8x * n8y, 0), fld_mv(n8x * n8y * 4, 0) {}

    int depth_at(int x, int y) const { return depth8[(y >> 3) * n8x + (x >> 3)]; }
    // IntraPredModeY at PU (4x4) granularity (mode4 carries NxN PUs)
    int mode_at(int x, int y) const {
        if (mode4) return mode4[(y >> 2) * (n8x * 2) + (x >> 2)];
        return mode8[(y >> 3) * n8x + (x >> 3)];
    }

    void run() {
        int ctu = 1 << log2_ctu;
        int rows = (h + ctu - 1) >> log2_ctu;
        int cols = (w + ctu - 1) >> log2_ctu;
        int nctu = rows * cols;
        prev_qp = slice_qp;
        for (int a = 0; a < nctu; a++) {
            int cx = a % cols, cy_ = a / cols;
            if (qp_map) {
                dqp_pending = true;
                dqp_target = qp_map[a];
            }
            if (sao_p[0]) code_sao(cx, cy_, cols);
            cu_tree(cx * ctu, cy_ * ctu, log2_ctu);
            cab.encode_terminate(a == nctu - 1 ? 1 : 0);
        }
    }

    // flush the current cabac into a byte-aligned substream
    // (Entropy::finishSlice analog: finish + byte alignment)
    void flush_substream() {
        uint32_t tv; int tb;
        cab.finish(&tv, &tb);
        std::vector<uint8_t>& out = cab.out;
        // append tail bits, then alignment: stop bit 1 + zero pad
        uint32_t acc = 0; int nb = 0;
        for (int i = tb - 1; i >= 0; i--) {
            acc = (acc << 1) | ((tv >> i) & 1);
            if (++nb == 8) { out.push_back((uint8_t)acc); acc = 0; nb = 0; }
        }
        acc = (acc << 1) | 1; nb++;            // alignment one bit
        acc <<= (8 - nb);                      // zero pad
        out.push_back((uint8_t)acc);
        substreams.push_back(out);
    }

    void run_wpp() {
        int ctu = 1 << log2_ctu;
        int rows = (h + ctu - 1) >> log2_ctu;
        int cols = (w + ctu - 1) >> log2_ctu;
        int nctu = rows * cols;
        std::vector<uint8_t> saved(num_ctx);
        memcpy(saved.data(), cab.ctx, num_ctx);  // cols==1: re-init rows
        for (int row = 0; row < rows; row++) {
            if (row > 0) {
                memcpy(cab.ctx, saved.data(), num_ctx);
                cab.reset();
            }
            prev_qp = slice_qp;   // qPY_PREV resets per CTU row (8.6.1)
            for (int col = 0; col < cols; col++) {
                int a = row * cols + col;
                if (qp_map) {
                    dqp_pending = true;
                    dqp_target = qp_map[a];
                }
                if (sao_p[0]) code_sao(col, row, cols);
                cu_tree(col * ctu, row * ctu, log2_ctu);
                cab.encode_terminate(a == nctu - 1 ? 1 : 0);
                if (col == 1 && rows > 1)
                    memcpy(saved.data(), cab.ctx, num_ctx);
            }
            if (row < rows - 1)
                cab.encode_terminate(1);       // end_of_subset_one_bit
            flush_substream();
        }
    }

    // cu_qp_delta_abs/sign (9.3.3.9: TU(5) prefix + EG0 suffix), coded
    // once per QG at the first TU with any cbf
    void maybe_code_dqp() {
        if (!dqp_pending) return;
        dqp_pending = false;
        int delta = dqp_target - prev_qp;
        prev_qp = dqp_target;
        int a = delta < 0 ? -delta : delta;
        cab.encode_bin(OFF_CU_QP_DELTA_ABS, a > 0);
        if (a == 0) return;
        int lim = a < 5 ? a : 5;
        for (int k = 1; k < lim; k++)
            cab.encode_bin(OFF_CU_QP_DELTA_ABS + 1, 1);
        if (a < 5) {
            cab.encode_bin(OFF_CU_QP_DELTA_ABS + 1, 0);
        } else {
            uint32_t sym = a - 5;    // EG0 suffix
            int count = 0;
            while (sym >= (1u << count)) {
                cab.encode_bypass(1);
                sym -= 1u << count;
                count++;
            }
            cab.encode_bypass(0);
            if (count) cab.encode_bypass_bins(sym, count);
        }
        cab.encode_bypass(delta < 0);
    }

    // -- sao (clause 7.3.8.3) ------------------------------------------------
    void sao_type_bin(int t) {
        cab.encode_bin(OFF_SAO_TYPE_IDX, t != 0);
        if (t) cab.encode_bypass(t == 2);
    }
    void sao_offset_abs(int v) {
        for (int i = 0; i < v; i++) cab.encode_bypass(1);
        if (v < 7) cab.encode_bypass(0);
    }
    bool sao_eq(int ax, int ay, int bx, int by, int cols) {
        for (int c = 0; c < 3; c++) {
            const int32_t* pa = sao_p[c] + (ay * cols + ax) * 6;
            const int32_t* pb = sao_p[c] + (by * cols + bx) * 6;
            for (int i = 0; i < 6; i++) if (pa[i] != pb[i]) return false;
        }
        return true;
    }
    void code_sao(int tx, int ty, int cols) {
        if (tx > 0) {
            bool ml = sao_eq(tx - 1, ty, tx, ty, cols);
            cab.encode_bin(OFF_SAO_MERGE_FLAG, ml);
            if (ml) return;
        }
        if (ty > 0) {
            bool mu = sao_eq(tx, ty - 1, tx, ty, cols);
            cab.encode_bin(OFF_SAO_MERGE_FLAG, mu);
            if (mu) return;
        }
        for (int cidx = 0; cidx < 3; cidx++) {
            const int32_t* p = sao_p[cidx] + (ty * cols + tx) * 6;
            int t = p[0];
            if (cidx < 2) sao_type_bin(t);
            if (t == 0) continue;
            for (int i = 0; i < 4; i++)
                sao_offset_abs(p[2 + i] < 0 ? -p[2 + i] : p[2 + i]);
            if (t == 1) {
                for (int i = 0; i < 4; i++)
                    if (p[2 + i] != 0) cab.encode_bypass(p[2 + i] < 0);
                cab.encode_bypass_bins(p[1], 5);
            } else if (cidx < 2) {
                cab.encode_bypass_bins(p[1], 2);
            }
        }
    }

    // -- z-scan availability + MV candidates (mirrors common/mv_derive.py) ----
    int z8(int x, int y) const {
        int bx = (x & ((1 << log2_ctu) - 1)) >> 3;
        int by = (y & ((1 << log2_ctu) - 1)) >> 3;
        int z = 0;
        for (int b = 0; b < log2_ctu - 3; b++) {
            z |= ((bx >> b) & 1) << (2 * b);
            z |= ((by >> b) & 1) << (2 * b + 1);
        }
        return z;
    }
    bool z_avail(int nx, int ny, int cux, int cuy) const {
        if (nx < 0 || ny < 0 || nx >= w || ny >= h) return false;
        int tnx = nx >> log2_ctu, tny = ny >> log2_ctu;
        int tcx = cux >> log2_ctu, tcy = cuy >> log2_ctu;
        if (tny != tcy) return tny < tcy;
        if (tnx != tcx) return tnx < tcx;
        return z8(nx, ny) < z8(cux, cuy);
    }
    int ref_poc_of(int i) const {
        return ref_pocs ? ref_pocs[i] : poc - 1 - i;
    }
    // out[3] = {mvx, mvy, refIdx}
    bool mv_at(int nx, int ny, int cux, int cuy, int out[3]) const {
        if (!z_avail(nx, ny, cux, cuy)) return false;
        if (intra8 && intra8[(ny >> 3) * n8x + (nx >> 3)])
            return false;              // intra neighbour: no MV
        const int32_t* m = mv8 + ((ny >> 3) * n8x + (nx >> 3)) * 2;
        out[0] = m[0]; out[1] = m[1];
        out[2] = ref8 ? ref8[(ny >> 3) * n8x + (nx >> 3)] : 0;
        return true;
    }
    // temporal candidate (8.5.3.2.8), 16x16-compressed col field
    bool probe_col(int px, int py, int target_ref, int out[2]) const {
        if (px < 0 || py < 0 || px >= w || py >= h) return false;
        int ccx = (px >> 4) << 4, ccy = (py >> 4) << 4;
        int c8 = (ccy >> 3) * n8x + (ccx >> 3);
        if (!col_inter8[c8]) return false;
        const int32_t* m = col_mv + c8 * 2;
        int cref = col_ref8 ? col_ref8[c8] : 0;
        if (cref >= n_col_refs) cref = n_col_refs - 1;
        int tb = poc - ref_poc_of(target_ref);
        int td = col_poc - (col_ref_pocs ? col_ref_pocs[cref]
                                         : col_poc - 1 - cref);
        if (tb == td) { out[0] = m[0]; out[1] = m[1]; return true; }
        int mv_in[2] = {m[0], m[1]};
        scale_mv(mv_in, tb, td, out);
        return true;
    }
    bool tmvp_cand(int x0, int y0, int nw, int nh, int target_ref,
                   int out[2]) const {
        if (!tmvp || !col_inter8 || !col_mv) return false;
        // bottom-right only inside the current CTU row
        if (((y0 + nh) >> log2_ctu) == (y0 >> log2_ctu) &&
            probe_col(x0 + nw, y0 + nh, target_ref, out))
            return true;
        return probe_col(x0 + (nw >> 1), y0 + (nh >> 1), target_ref,
                         out);
    }
    int merge_cands(int x0, int y0, int n, int cands[5][3]) const {
        int a1[3], b1[3], b0[3], a0[3], b2[3];
        bool ha1 = mv_at(x0 - 1, y0 + n - 1, x0, y0, a1);
        bool hb1 = mv_at(x0 + n - 1, y0 - 1, x0, y0, b1);
        bool hb0 = mv_at(x0 + n, y0 - 1, x0, y0, b0);
        bool ha0 = mv_at(x0 - 1, y0 + n, x0, y0, a0);
        int cnt = 0;
        auto neq = [](const int* a, const int* b) {
            return a[0] != b[0] || a[1] != b[1] || a[2] != b[2];
        };
        auto put = [&](const int* c) {
            cands[cnt][0] = c[0]; cands[cnt][1] = c[1];
            cands[cnt][2] = c[2]; cnt++;
        };
        if (ha1) put(a1);
        if (hb1 && (!ha1 || neq(b1, a1))) put(b1);
        if (hb0 && (!hb1 || neq(b0, b1))) put(b0);
        if (ha0 && (!ha1 || neq(a0, a1))) put(a0);
        if (cnt < 4) {
            bool hb2 = mv_at(x0 - 1, y0 - 1, x0, y0, b2);
            if (hb2 && (!ha1 || neq(b2, a1)) && (!hb1 || neq(b2, b1)))
                put(b2);
        }
        if (cnt < max_merge) {
            int t[3];
            if (tmvp_cand(x0, y0, n, n, 0, t)) { t[2] = 0; put(t); }
        }
        if (cnt > max_merge) cnt = max_merge;
        int zero_idx = 0;
        while (cnt < max_merge) {
            cands[cnt][0] = 0; cands[cnt][1] = 0;
            cands[cnt][2] = zero_idx < num_ref ? zero_idx : 0;
            cnt++; zero_idx++;
        }
        return max_merge;
    }
    // AMVP for refIdx target_ref (8.5.3.2.6-7): same-ref unscaled
    // pass, then POC-scaled passes, then the temporal candidate
    void amvp_cands(int x0, int y0, int n, int target_ref,
                    int cands[2][2]) const {
        int nb[5][3];
        bool have[5];
        have[0] = mv_at(x0 - 1, y0 + n, x0, y0, nb[0]);      // A0
        have[1] = mv_at(x0 - 1, y0 + n - 1, x0, y0, nb[1]);  // A1
        have[2] = mv_at(x0 + n, y0 - 1, x0, y0, nb[2]);      // B0
        have[3] = mv_at(x0 + n - 1, y0 - 1, x0, y0, nb[3]);  // B1
        have[4] = mv_at(x0 - 1, y0 - 1, x0, y0, nb[4]);      // B2
        int tpoc = ref_poc_of(target_ref);
        auto unscaled = [&](const int* c, int out[2]) -> bool {
            if (c[2] != target_ref) return false;
            out[0] = c[0]; out[1] = c[1];
            return true;
        };
        auto scaled_of = [&](const int* c, int out[2]) -> bool {
            int tb = poc - tpoc;
            int td = poc - ref_poc_of(c[2]);
            if (tb == td) { out[0] = c[0]; out[1] = c[1]; return true; }
            int mv_in[2] = {c[0], c[1]};
            scale_mv(mv_in, tb, td, out);
            return true;
        };
        int mvp_a[2]; bool has_a = false;
        for (int i = 0; i < 2 && !has_a; i++)
            if (have[i]) has_a = unscaled(nb[i], mvp_a);
        bool is_scaled_a = have[0] || have[1];
        if (!has_a)
            for (int i = 0; i < 2 && !has_a; i++)
                if (have[i]) has_a = scaled_of(nb[i], mvp_a);
        int mvp_b[2]; bool has_b = false;
        for (int i = 2; i < 5 && !has_b; i++)
            if (have[i]) has_b = unscaled(nb[i], mvp_b);
        if (!has_a) {
            if (has_b) { mvp_a[0] = mvp_b[0]; mvp_a[1] = mvp_b[1];
                         has_a = true; }
            has_b = false;
        }
        if (!has_b && !is_scaled_a)
            for (int i = 2; i < 5 && !has_b; i++)
                if (have[i]) has_b = scaled_of(nb[i], mvp_b);
        int cnt = 0;
        if (has_a) { cands[cnt][0] = mvp_a[0]; cands[cnt][1] = mvp_a[1];
                     cnt++; }
        if (has_b && (!has_a || mvp_b[0] != mvp_a[0] ||
                      mvp_b[1] != mvp_a[1])) {
            cands[cnt][0] = mvp_b[0]; cands[cnt][1] = mvp_b[1]; cnt++;
        }
        if (cnt < 2) {
            int t[2];
            if (tmvp_cand(x0, y0, n, n, target_ref, t) &&
                (cnt == 0 || t[0] != cands[0][0] || t[1] != cands[0][1])) {
                cands[cnt][0] = t[0]; cands[cnt][1] = t[1]; cnt++;
            }
        }
        while (cnt < 2) { cands[cnt][0] = 0; cands[cnt][1] = 0; cnt++; }
    }
    // ref_idx_l0 — TR binarization cMax = num_ref-1; bins 0/1 ctx-coded
    void code_ref_idx(int ref) {
        int cmax = num_ref - 1;
        if (cmax <= 0) return;
        int lim = ref + 1 < cmax ? ref + 1 : cmax;
        for (int i = 0; i < lim; i++) {
            int bit = i < ref ? 1 : 0;
            if (i < 2) cab.encode_bin(OFF_REF_IDX + i, bit);
            else cab.encode_bypass(bit);
            if (!bit) break;
        }
    }

    // -- P-slice CU (clauses 7.3.8.5-7.3.8.9) --------------------------------
    void code_merge_idx(int idx) {
        if (max_merge <= 1) return;
        cab.encode_bin(OFF_MERGE_IDX, idx > 0);
        if (idx > 0)
            for (int i = 1; i < max_merge - 1; i++) {
                cab.encode_bypass(idx == i ? 0 : 1);
                if (idx == i) break;
            }
    }
    void code_eg1(uint32_t symbol) {
        int count = 1;
        while (symbol >= (1u << count)) {
            cab.encode_bypass(1);
            symbol -= 1u << count;
            count++;
        }
        cab.encode_bypass(0);
        cab.encode_bypass_bins(symbol, count);
    }
    void code_mvd(int mx, int my) {
        int ax = mx < 0 ? -mx : mx, ay = my < 0 ? -my : my;
        cab.encode_bin(OFF_ABS_MVD_GREATER_FLAG, ax > 0);
        cab.encode_bin(OFF_ABS_MVD_GREATER_FLAG, ay > 0);
        if (ax > 0) cab.encode_bin(OFF_ABS_MVD_GREATER_FLAG + 1, ax > 1);
        if (ay > 0) cab.encode_bin(OFF_ABS_MVD_GREATER_FLAG + 1, ay > 1);
        if (ax > 0) {
            if (ax > 1) code_eg1(ax - 2);
            cab.encode_bypass(mx < 0);
        }
        if (ay > 0) {
            if (ay > 1) code_eg1(ay - 2);
            cab.encode_bypass(my < 0);
        }
    }
    int neighbor_mode_p(int x, int y, bool above) const {
        // candIntraPredMode in a P slice: non-intra neighbours -> DC
        int nx = x, ny = y;
        if (above) {
            if (y == 0 || ((y - 1) >> log2_ctu) != (y >> log2_ctu))
                return 1;
            ny = y - 1;
        } else {
            if (x == 0) return 1;
            nx = x - 1;
        }
        if (!intra8 || !intra8[(ny >> 3) * n8x + (nx >> 3)]) return 1;
        return mode8[(ny >> 3) * n8x + (nx >> 3)];
    }

    void code_cu_p_intra(int x0, int y0, int l2) {
        // intra CU inside a P slice (checkIntraInInter analog):
        // cu_skip 0, pred_mode 1, PART_2Nx2N, DM chroma
        int ctx = 0;
        if (x0 > 0 && skip8[(y0 >> 3) * n8x + ((x0 - 1) >> 3)]) ctx++;
        if (y0 > 0 && skip8[((y0 - 1) >> 3) * n8x + (x0 >> 3)]) ctx++;
        cab.encode_bin(OFF_CU_SKIP_FLAG + ctx, 0);
        int s = (1 << l2) >> 3;
        for (int j = 0; j < s; j++)
            for (int i = 0; i < s; i++) {
                skip8[((y0 >> 3) + j) * n8x + (x0 >> 3) + i] = 0;
                coded8[((y0 >> 3) + j) * n8x + (x0 >> 3) + i] = 1;
            }
        cab.encode_bin(OFF_PRED_MODE_FLAG, 1);
        if (l2 == log2_min_cu) cab.encode_bin(OFF_PART_MODE, 1);
        int mode = mode8[(y0 >> 3) * n8x + (x0 >> 3)];
        int a = neighbor_mode_p(x0, y0, false);
        int b2 = neighbor_mode_p(x0, y0, true);
        int mpm[3];
        if (a == b2) {
            if (a < 2) { mpm[0] = 0; mpm[1] = 1; mpm[2] = 26; }
            else { mpm[0] = a; mpm[1] = 2 + ((a + 29) % 32);
                   mpm[2] = 2 + ((a - 2 + 1) % 32); }
        } else {
            mpm[0] = a; mpm[1] = b2;
            if (a != 0 && b2 != 0) mpm[2] = 0;
            else if (a != 1 && b2 != 1) mpm[2] = 1;
            else mpm[2] = 26;
        }
        bool in_mpm = mode == mpm[0] || mode == mpm[1] || mode == mpm[2];
        cab.encode_bin(OFF_PREV_INTRA_LUMA_PRED_FLAG, in_mpm);
        code_luma_mode(mode, mpm);
        cab.encode_bin(OFF_INTRA_CHROMA_PRED_MODE, 0);   // DM
        transform_unit(x0, y0, l2, mode, mode);
    }

    // ---- B-slice motion field + candidates (mv_derive.py twins) ----------
    struct MI { int pf; int mv[2][2]; };

    bool mi_at(int nx, int ny, int cux, int cuy, MI* out) const {
        if (!z_avail(nx, ny, cux, cuy)) return false;
        int c = (ny >> 3) * n8x + (nx >> 3);
        int pf = fld_pf[c];
        if (!pf) return false;
        out->pf = pf;
        for (int l = 0; l < 2; l++)
            for (int k = 0; k < 2; k++)
                out->mv[l][k] = fld_mv[c * 4 + l * 2 + k];
        return true;
    }

    static bool mi_eq(const MI& a, const MI& b) {
        if (a.pf != b.pf) return false;
        // normalized comparison: unused lists are zeroed by callers
        for (int l = 0; l < 2; l++)
            for (int k = 0; k < 2; k++)
                if (a.mv[l][k] != b.mv[l][k]) return false;
        return true;
    }

    static void mi_norm(MI* m) {
        if (!(m->pf & 1)) { m->mv[0][0] = 0; m->mv[0][1] = 0; }
        if (!(m->pf & 2)) { m->mv[1][0] = 0; m->mv[1][1] = 0; }
    }

    int merge_cands_b(int x0, int y0, int n, MI cands[5]) const {
        MI a1, b1, b0, a0, b2;
        bool ha1 = mi_at(x0 - 1, y0 + n - 1, x0, y0, &a1);
        bool hb1 = mi_at(x0 + n - 1, y0 - 1, x0, y0, &b1);
        bool hb0 = mi_at(x0 + n, y0 - 1, x0, y0, &b0);
        bool ha0 = mi_at(x0 - 1, y0 + n, x0, y0, &a0);
        int cnt = 0;
        if (ha1) cands[cnt++] = a1;
        if (hb1 && (!ha1 || !mi_eq(b1, a1))) cands[cnt++] = b1;
        if (hb0 && (!hb1 || !mi_eq(b0, b1))) cands[cnt++] = b0;
        if (ha0 && (!ha1 || !mi_eq(a0, a1))) cands[cnt++] = a0;
        if (cnt < 4) {
            bool hb2 = mi_at(x0 - 1, y0 - 1, x0, y0, &b2);
            if (hb2 && (!ha1 || !mi_eq(b2, a1)) &&
                (!hb1 || !mi_eq(b2, b1)))
                cands[cnt++] = b2;
        }
        if (cnt > max_merge) cnt = max_merge;
        // combined bi-predictive candidates (8.5.3.2.4)
        static const int comb[12][2] = {
            {0,1},{1,0},{0,2},{2,0},{1,2},{2,1},
            {0,3},{3,0},{1,3},{3,1},{2,3},{3,2}};
        int norig = cnt;
        if (norig > 1) {
            for (int i = 0; i < 12 && cnt < max_merge; i++) {
                int l0i = comb[i][0], l1i = comb[i][1];
                if (l0i >= norig || l1i >= norig) continue;
                if (!(cands[l0i].pf & 1) || !(cands[l1i].pf & 2))
                    continue;
                MI c;
                c.pf = 3;
                c.mv[0][0] = cands[l0i].mv[0][0];
                c.mv[0][1] = cands[l0i].mv[0][1];
                c.mv[1][0] = cands[l1i].mv[1][0];
                c.mv[1][1] = cands[l1i].mv[1][1];
                cands[cnt++] = c;
            }
        }
        while (cnt < max_merge) {
            MI z; z.pf = 3;
            z.mv[0][0] = z.mv[0][1] = z.mv[1][0] = z.mv[1][1] = 0;
            cands[cnt++] = z;
        }
        return max_merge;
    }

    static void scale_mv(const int in[2], int tb, int td, int out[2]) {
        // POC-distance MV scaling (8.5.3.2.8)
        if (td > 127) td = 127; if (td < -128) td = -128;
        if (tb > 127) tb = 127; if (tb < -128) tb = -128;
        int q = 16384 + (td >= 0 ? td >> 1 : (-td) >> 1);
        int tx = td > 0 ? q / td : -(q / -td);
        long long dsf = (long long)tb * tx + 32;
        dsf >>= 6;
        if (dsf > 4095) dsf = 4095; if (dsf < -4096) dsf = -4096;
        for (int k = 0; k < 2; k++) {
            long long s = dsf * in[k];
            long long a = (s >= 0 ? s : -s);
            long long v = ((a + 127) >> 8);
            if (s < 0) v = -v;
            if (v > 32767) v = 32767; if (v < -32768) v = -32768;
            out[k] = (int)v;
        }
    }

    void amvp_cands_b(int lx, int x0, int y0, int n, int cands[2][2]) {
        int ly = 1 - lx;
        int poc_refs[2] = {poc_ref0, poc_ref1};
        int target = poc_refs[lx];
        MI nb[5];
        bool have[5];
        have[0] = mi_at(x0 - 1, y0 + n, x0, y0, &nb[0]);      // a0
        have[1] = mi_at(x0 - 1, y0 + n - 1, x0, y0, &nb[1]);  // a1
        have[2] = mi_at(x0 + n, y0 - 1, x0, y0, &nb[2]);      // b0
        have[3] = mi_at(x0 + n - 1, y0 - 1, x0, y0, &nb[3]);  // b1
        have[4] = mi_at(x0 - 1, y0 - 1, x0, y0, &nb[4]);      // b2

        auto unscaled = [&](const MI& c, int out[2]) -> bool {
            if (c.pf & (1 << lx)) {
                out[0] = c.mv[lx][0]; out[1] = c.mv[lx][1];
                return true;
            }
            return false;
        };
        auto scaled_of = [&](const MI& c, int out[2]) -> bool {
            int order[2] = {lx, ly};
            for (int oi = 0; oi < 2; oi++) {
                int li = order[oi];
                if (c.pf & (1 << li)) {
                    int tb = poc - target;
                    int td = poc - poc_refs[li];
                    if (td == tb) {
                        out[0] = c.mv[li][0]; out[1] = c.mv[li][1];
                    } else {
                        scale_mv(c.mv[li], tb, td, out);
                    }
                    return true;
                }
            }
            return false;
        };

        int mvp_a[2]; bool has_a = false;
        for (int i = 0; i < 2 && !has_a; i++)
            if (have[i]) has_a = unscaled(nb[i], mvp_a);
        bool is_scaled_a = have[0] || have[1];
        if (!has_a)
            for (int i = 0; i < 2 && !has_a; i++)
                if (have[i]) has_a = scaled_of(nb[i], mvp_a);

        int mvp_b[2]; bool has_b = false;
        for (int i = 2; i < 5 && !has_b; i++)
            if (have[i]) has_b = unscaled(nb[i], mvp_b);
        if (!has_a) {
            if (has_b) { mvp_a[0] = mvp_b[0]; mvp_a[1] = mvp_b[1];
                         has_a = true; has_b = false; }
        }
        if (!has_b && !is_scaled_a)
            for (int i = 2; i < 5 && !has_b; i++)
                if (have[i]) has_b = scaled_of(nb[i], mvp_b);

        int cnt = 0;
        if (has_a) { cands[cnt][0] = mvp_a[0]; cands[cnt][1] = mvp_a[1];
                     cnt++; }
        if (has_b && (!has_a || mvp_b[0] != mvp_a[0] ||
                      mvp_b[1] != mvp_a[1])) {
            cands[cnt][0] = mvp_b[0]; cands[cnt][1] = mvp_b[1]; cnt++;
        }
        while (cnt < 2) { cands[cnt][0] = 0; cands[cnt][1] = 0; cnt++; }
    }

    void set_fld(int x0, int y0, int size, int pf, const int m0[2],
                 const int m1[2]) {
        int s = size >> 3;
        for (int j = 0; j < s; j++)
            for (int i = 0; i < s; i++) {
                int c = ((y0 >> 3) + j) * n8x + (x0 >> 3) + i;
                fld_pf[c] = (uint8_t)pf;
                fld_mv[c * 4 + 0] = m0[0]; fld_mv[c * 4 + 1] = m0[1];
                fld_mv[c * 4 + 2] = m1[0]; fld_mv[c * 4 + 3] = m1[1];
            }
    }

    void code_cu_b(int x0, int y0, int l2) {
        int size = 1 << l2;
        int c8 = (y0 >> 3) * n8x + (x0 >> 3);
        int pf = pf8[c8];
        int m0[2] = {mvb[c8 * 4 + 0], mvb[c8 * 4 + 1]};
        int m1[2] = {mvb[c8 * 4 + 2], mvb[c8 * 4 + 3]};
        MI mi;
        mi.pf = pf;
        mi.mv[0][0] = (pf & 1) ? m0[0] : 0;
        mi.mv[0][1] = (pf & 1) ? m0[1] : 0;
        mi.mv[1][0] = (pf & 2) ? m1[0] : 0;
        mi.mv[1][1] = (pf & 2) ? m1[1] : 0;
        int cstride = w >> 1;
        bool fy = cbf(cy, w, x0, y0, size);
        bool fcb = cbf(ccb, cstride, x0 >> 1, y0 >> 1, size >> 1);
        bool fcr = cbf(ccr, cstride, x0 >> 1, y0 >> 1, size >> 1);
        bool any = fy || fcb || fcr;
        MI cands[5];
        merge_cands_b(x0, y0, size, cands);
        int midx = -1;
        for (int i = 0; i < max_merge; i++) {
            MI c = cands[i];
            mi_norm(&c);
            if (mi_eq(c, mi)) { midx = i; break; }
        }
        bool skip = midx >= 0 && !any;
        int ctx = 0;
        if (x0 > 0 && skip8[(y0 >> 3) * n8x + ((x0 - 1) >> 3)]) ctx++;
        if (y0 > 0 && skip8[((y0 - 1) >> 3) * n8x + (x0 >> 3)]) ctx++;
        cab.encode_bin(OFF_CU_SKIP_FLAG + ctx, skip);
        int s = size >> 3;
        for (int j = 0; j < s; j++)
            for (int i = 0; i < s; i++)
                skip8[((y0 >> 3) + j) * n8x + (x0 >> 3) + i] = skip;
        set_fld(x0, y0, size, pf, mi.mv[0], mi.mv[1]);
        if (skip) { code_merge_idx(midx); return; }
        cab.encode_bin(OFF_PRED_MODE_FLAG, 0);
        cab.encode_bin(OFF_PART_MODE, 1);
        if (midx >= 0) {
            cab.encode_bin(OFF_MERGE_FLAG, 1);
            code_merge_idx(midx);
        } else {
            cab.encode_bin(OFF_MERGE_FLAG, 0);
            int depth = log2_ctu - l2;
            // inter_pred_idc (9.3.3.7): bin0 = BI? (ctx depth); else
            // bin1 = L1? (ctx 4)
            cab.encode_bin(OFF_INTER_PRED_IDC + depth, pf == 3);
            if (pf != 3)
                cab.encode_bin(OFF_INTER_PRED_IDC + 4, pf == 2);
            for (int lxi = 0; lxi < 2; lxi++) {
                if (!(pf & (1 << lxi))) continue;
                int ac[2][2];
                amvp_cands_b(lxi, x0, y0, size, ac);
                const int* mv = lxi == 0 ? m0 : m1;
                int c0 = abs_i(mv[0] - ac[0][0]) + abs_i(mv[1] - ac[0][1]);
                int c1 = abs_i(mv[0] - ac[1][0]) + abs_i(mv[1] - ac[1][1]);
                int mvp = c0 <= c1 ? 0 : 1;
                code_mvd(mv[0] - ac[mvp][0], mv[1] - ac[mvp][1]);
                cab.encode_bin(OFF_MVP_FLAG, mvp);
            }
            cab.encode_bin(OFF_RQT_ROOT_CBF, any ? 1 : 0);
            if (!any) return;
        }
        transform_tree_inter(x0, y0, l2, fy, fcb, fcr);
    }

    // transform_tree for an inter 2Nx2N CU (clause 7.3.8.8): TU depth
    // 0 or 1 (split from tusplit8; SPS max_transform_hierarchy_depth_
    // inter == rqt_inter). Mirrors syntax.py _code_transform_unit_inter.
    void transform_tree_inter(int x0, int y0, int l2, bool fy,
                              bool fcb, bool fcr) {
        int size = 1 << l2;
        int cstride = w >> 1;
        int split = 0;
        if (l2 == 6) {
            split = 1;   // 64 > max TB 32: split inferred (7.4.9.8)
        } else if (rqt_inter && l2 > 2 && l2 <= 5) {
            split = tusplit8 ? tusplit8[(y0 >> 3) * n8x + (x0 >> 3)] : 0;
            cab.encode_bin(OFF_SPLIT_TRANSFORM_FLAG + 5 - l2, split);
        }
        cab.encode_bin(OFF_CBF_CHROMA, fcb);
        cab.encode_bin(OFF_CBF_CHROMA, fcr);
        if (!split) {
            if (fcb || fcr) cab.encode_bin(OFF_CBF_LUMA + 1, fy);
            if (fy || fcb || fcr) maybe_code_dqp();
            if (fy) residual(cy, w, x0, y0, l2, 0, 0);
            if ((size >> 1) >= 4) {
                if (fcb) residual(ccb, cstride, x0 >> 1, y0 >> 1, l2 - 1, 1, 0);
                if (fcr) residual(ccr, cstride, x0 >> 1, y0 >> 1, l2 - 1, 2, 0);
            }
            return;
        }
        int cl2 = l2 - 1, hs = size >> 1, qs = hs >> 1;
        static const int offs[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
        for (int blk = 0; blk < 4; blk++) {
            int dy = offs[blk][0] * hs, dx = offs[blk][1] * hs;
            bool c_cb = false, c_cr = false;
            if (cl2 > 2) {
                if (fcb) {
                    c_cb = cbf(ccb, cstride, (x0 + dx) >> 1,
                               (y0 + dy) >> 1, qs);
                    cab.encode_bin(OFF_CBF_CHROMA + 1, c_cb);
                }
                if (fcr) {
                    c_cr = cbf(ccr, cstride, (x0 + dx) >> 1,
                               (y0 + dy) >> 1, qs);
                    cab.encode_bin(OFF_CBF_CHROMA + 1, c_cr);
                }
            } else {
                // 4x4 luma TUs: single chroma TU coded with blkIdx 3
                c_cb = blk == 3 && fcb;
                c_cr = blk == 3 && fcr;
            }
            bool c_y = cbf(cy, w, x0 + dx, y0 + dy, hs);
            cab.encode_bin(OFF_CBF_LUMA, c_y);   // trafoDepth 1
            if (c_y || c_cb || c_cr) maybe_code_dqp();
            if (c_y) residual(cy, w, x0 + dx, y0 + dy, cl2, 0, 0);
            if (cl2 > 2) {
                if (c_cb) residual(ccb, cstride, (x0 + dx) >> 1,
                                   (y0 + dy) >> 1, cl2 - 1, 1, 0);
                if (c_cr) residual(ccr, cstride, (x0 + dx) >> 1,
                                   (y0 + dy) >> 1, cl2 - 1, 2, 0);
            } else if (blk == 3) {
                if (fcb) residual(ccb, cstride, x0 >> 1, y0 >> 1, 2, 1, 0);
                if (fcr) residual(ccr, cstride, x0 >> 1, y0 >> 1, 2, 2, 0);
            }
        }
    }

    static int abs_i(int v) { return v < 0 ? -v : v; }

    void code_cu_p(int x0, int y0, int l2) {
        if (intra8 && intra8[(y0 >> 3) * n8x + (x0 >> 3)]) {
            code_cu_p_intra(x0, y0, l2);
            return;
        }
        int size = 1 << l2;
        const int32_t* m = mv8 + ((y0 >> 3) * n8x + (x0 >> 3)) * 2;
        int mv[2] = {m[0], m[1]};
        int ref = ref8 ? ref8[(y0 >> 3) * n8x + (x0 >> 3)] : 0;
        int cstride = w >> 1;
        bool fy = cbf(cy, w, x0, y0, size);
        bool fcb = cbf(ccb, cstride, x0 >> 1, y0 >> 1, size >> 1);
        bool fcr = cbf(ccr, cstride, x0 >> 1, y0 >> 1, size >> 1);
        bool any = fy || fcb || fcr;
        int cands[5][3];
        merge_cands(x0, y0, size, cands);
        int midx = -1;
        for (int i = 0; i < max_merge; i++)
            if (cands[i][0] == mv[0] && cands[i][1] == mv[1] &&
                cands[i][2] == ref) { midx = i; break; }
        bool skip = midx >= 0 && !any;
        int ctx = 0;
        if (x0 > 0 && skip8[(y0 >> 3) * n8x + ((x0 - 1) >> 3)]) ctx++;
        if (y0 > 0 && skip8[((y0 - 1) >> 3) * n8x + (x0 >> 3)]) ctx++;
        cab.encode_bin(OFF_CU_SKIP_FLAG + ctx, skip);
        int s = size >> 3;
        for (int j = 0; j < s; j++)
            for (int i = 0; i < s; i++) {
                skip8[((y0 >> 3) + j) * n8x + (x0 >> 3) + i] = skip;
                coded8[((y0 >> 3) + j) * n8x + (x0 >> 3) + i] = 1;
            }
        if (skip) { code_merge_idx(midx); return; }
        cab.encode_bin(OFF_PRED_MODE_FLAG, 0);
        cab.encode_bin(OFF_PART_MODE, 1);
        if (midx >= 0) {
            cab.encode_bin(OFF_MERGE_FLAG, 1);
            code_merge_idx(midx);
        } else {
            cab.encode_bin(OFF_MERGE_FLAG, 0);
            code_ref_idx(ref);
            int ac[2][2];
            amvp_cands(x0, y0, size, ref, ac);
            int c0 = (mv[0] > ac[0][0] ? mv[0] - ac[0][0] : ac[0][0] - mv[0]) +
                     (mv[1] > ac[0][1] ? mv[1] - ac[0][1] : ac[0][1] - mv[1]);
            int c1 = (mv[0] > ac[1][0] ? mv[0] - ac[1][0] : ac[1][0] - mv[0]) +
                     (mv[1] > ac[1][1] ? mv[1] - ac[1][1] : ac[1][1] - mv[1]);
            int mvp = c0 <= c1 ? 0 : 1;
            code_mvd(mv[0] - ac[mvp][0], mv[1] - ac[mvp][1]);
            cab.encode_bin(OFF_MVP_FLAG, mvp);
            cab.encode_bin(OFF_RQT_ROOT_CBF, any ? 1 : 0);
            if (!any) return;
        }
        // inter transform tree: diag scans, cbf_luma inference, TU
        // depth 0/1
        transform_tree_inter(x0, y0, l2, fy, fcb, fcr);
    }

    void cu_tree(int x0, int y0, int l2) {
        int size = 1 << l2;
        int depth = log2_ctu - l2;
        bool inside = x0 + size <= w && y0 + size <= h;
        bool split;
        if (inside && l2 > log2_min_cu) {
            split = depth_at(x0, y0) > depth;
            int ctx = 0;
            if (x0 > 0 && depth_at(x0 - 1, y0) > depth) ctx++;
            if (y0 > 0 && depth_at(x0, y0 - 1) > depth) ctx++;
            cab.encode_bin(OFF_SPLIT_CU_FLAG + ctx, split);
        } else if (l2 > log2_min_cu) {
            split = true;
        } else {
            split = false;
        }
        if (split) {
            int half = size >> 1;
            for (int s = 0; s < 4; s++) {
                int sx = x0 + (s & 1) * half, sy = y0 + (s >> 1) * half;
                if (sx < w && sy < h) cu_tree(sx, sy, l2 - 1);
            }
        } else {
            int64_t p0 = cu_bits ? cab.pos256() : 0;
            if (lossless) cab.encode_bin(OFF_CU_TRANSQUANT_BYPASS, 1);
            if (slice_type == 1) code_cu_p(x0, y0, l2);
            else if (slice_type == 0) code_cu_b(x0, y0, l2);
            else code_cu(x0, y0, l2);
            if (cu_bits)
                cu_bits[(y0 >> 3) * n8x + (x0 >> 3)] =
                    (int32_t)((cab.pos256() - p0) >> 4);
        }
    }

    int neighbor_mode(int x, int y, bool above) const {
        if (above) {
            if (y == 0) return 1;  // DC
            if (((y - 1) >> log2_ctu) != (y >> log2_ctu)) return 1;
            return mode_at(x, y - 1);
        }
        if (x == 0) return 1;
        return mode_at(x - 1, y);
    }

    void derive_mpm(int x, int y, int mpm[3]) const {
        int a = neighbor_mode(x, y, false), b = neighbor_mode(x, y, true);
        if (a == b) {
            if (a < 2) { mpm[0] = 0; mpm[1] = 1; mpm[2] = 26; }
            else { mpm[0] = a; mpm[1] = 2 + ((a + 29) % 32);
                   mpm[2] = 2 + ((a - 2 + 1) % 32); }
        } else {
            mpm[0] = a; mpm[1] = b;
            if (a != 0 && b != 0) mpm[2] = 0;
            else if (a != 1 && b != 1) mpm[2] = 1;
            else mpm[2] = 26;
        }
    }

    void code_luma_mode(int mode, const int mpm[3]) {
        int idx = -1;
        for (int i = 0; i < 3; i++) if (mpm[i] == mode) { idx = i; break; }
        if (idx >= 0) {
            cab.encode_bypass(idx == 0 ? 0 : 1);
            if (idx) cab.encode_bypass(idx - 1);
        } else {
            int rem = mode;
            // subtract the count of MPMs smaller than mode
            int srt[3] = {mpm[0], mpm[1], mpm[2]};
            for (int i = 0; i < 2; i++)
                for (int j = i + 1; j < 3; j++)
                    if (srt[j] < srt[i]) { int t = srt[i]; srt[i] = srt[j]; srt[j] = t; }
            for (int i = 2; i >= 0; i--) if (mode > srt[i]) rem--;
            cab.encode_bypass_bins(rem, 5);
        }
    }

    void code_cu(int x0, int y0, int l2) {
        bool nxn = l2 == log2_min_cu && nxn8 &&
                   nxn8[(y0 >> 3) * n8x + (x0 >> 3)];
        if (l2 == log2_min_cu) cab.encode_bin(OFF_PART_MODE, nxn ? 0 : 1);
        int npu = nxn ? 4 : 1;
        int px[4] = {x0, x0 + 4, x0, x0 + 4};
        int py[4] = {y0, y0, y0 + 4, y0 + 4};
        int modes[4], mpm[4][3];
        // loop 1: prev_intra_luma_pred_flags (clause 7.3.8.5)
        for (int i = 0; i < npu; i++) {
            modes[i] = mode_at(px[i], py[i]);
            derive_mpm(px[i], py[i], mpm[i]);
            bool in_mpm = modes[i] == mpm[i][0] || modes[i] == mpm[i][1] ||
                          modes[i] == mpm[i][2];
            cab.encode_bin(OFF_PREV_INTRA_LUMA_PRED_FLAG, in_mpm);
        }
        // loop 2: mpm_idx / rem_intra_luma_pred_mode
        for (int i = 0; i < npu; i++) code_luma_mode(modes[i], mpm[i]);
        // intra_chroma_pred_mode: '0' = DM; '1' + 2 bypass bins =
        // index into [planar, ver, hor, dc] with the luma-mode entry
        // substituted by angular-34 (clause 8.4.3); DM source = PU0
        int mode = modes[0];
        int cmode = cmode8 ? cmode8[(y0 >> 3) * n8x + (x0 >> 3)] : mode;
        if (cmode == mode) {
            cab.encode_bin(OFF_INTRA_CHROMA_PRED_MODE, 0);
        } else {
            int cand[4] = {0, 26, 10, 1};
            for (int i = 0; i < 4; i++) if (cand[i] == mode) cand[i] = 34;
            int idx = 0;
            while (idx < 4 && cand[idx] != cmode) idx++;
            cab.encode_bin(OFF_INTRA_CHROMA_PRED_MODE, 1);
            cab.encode_bypass_bins(idx, 2);
        }
        if (nxn) transform_nxn(x0, y0, modes, cmode);
        else transform_unit(x0, y0, l2, mode, cmode);
    }

    // implicitly-split transform tree of a PART_NxN intra CU
    // (7.3.8.8): chroma cbfs at trafoDepth 0, four 4x4 luma TUs with
    // cbf ctx 0 and DST scan-by-PU-mode, chroma residual with blkIdx 3
    void transform_nxn(int x0, int y0, const int modes[4], int cmode) {
        int cx = x0 >> 1, cy_ = y0 >> 1, cstride = w >> 1;
        bool fcb = cbf(ccb, cstride, cx, cy_, 4);
        bool fcr = cbf(ccr, cstride, cx, cy_, 4);
        cab.encode_bin(OFF_CBF_CHROMA, fcb);
        cab.encode_bin(OFF_CBF_CHROMA, fcr);
        int px[4] = {x0, x0 + 4, x0, x0 + 4};
        int py[4] = {y0, y0, y0 + 4, y0 + 4};
        for (int s = 0; s < 4; s++) {
            bool fy = cbf(cy, w, px[s], py[s], 4);
            cab.encode_bin(OFF_CBF_LUMA, fy);
            // transform_unit blkIdx s: chroma cbfs attach to s == 3
            if (fy || (s == 3 && (fcb || fcr))) maybe_code_dqp();
            if (fy)
                residual(cy, w, px[s], py[s], 2, 0,
                         intra_scan_idx(modes[s], 2, true));
        }
        int csc = intra_scan_idx(cmode, 2, false);
        if (fcb) residual(ccb, cstride, cx, cy_, 2, 1, csc);
        if (fcr) residual(ccr, cstride, cx, cy_, 2, 2, csc);
    }

    bool cbf(const int16_t* plane, int stride, int x, int y, int size) const {
        for (int j = 0; j < size; j++)
            for (int i = 0; i < size; i++)
                if (plane[(y + j) * stride + x + i]) return true;
        return false;
    }

    void transform_unit(int x0, int y0, int l2, int mode,
                        int cmode = -1) {
        if (cmode < 0) cmode = mode;
        int size = 1 << l2;
        int cx = x0 >> 1, cy_ = y0 >> 1, cs = size >> 1, cstride = w >> 1;
        bool fcb = cbf(ccb, cstride, cx, cy_, cs);
        bool fcr = cbf(ccr, cstride, cx, cy_, cs);
        bool fy = cbf(cy, w, x0, y0, size);
        cab.encode_bin(OFF_CBF_CHROMA, fcb);
        cab.encode_bin(OFF_CBF_CHROMA, fcr);
        cab.encode_bin(OFF_CBF_LUMA + 1, fy);
        if (fy || fcb || fcr) maybe_code_dqp();
        if (fy)
            residual(cy, w, x0, y0, l2, 0, intra_scan_idx(mode, l2, true));
        if (cs >= 4) {
            int csc = intra_scan_idx(cmode, l2 - 1, false);
            if (fcb) residual(ccb, cstride, cx, cy_, l2 - 1, 1, csc);
            if (fcr) residual(ccr, cstride, cx, cy_, l2 - 1, 2, csc);
        }
    }

    static int sig_ctx(int xc, int yc, int l2, int cidx, int scan,
                       int prev_csbf) {
        if (l2 == 2) return SIG_CTX_4X4[(yc << 2) + xc];
        if (xc + yc == 0) return 0;
        int xp = xc & 3, yp = yc & 3, s;
        if (prev_csbf == 0) { int t = xp + yp; s = t == 0 ? 2 : (t < 3 ? 1 : 0); }
        else if (prev_csbf == 1) s = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
        else if (prev_csbf == 2) s = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
        else s = 2;
        if (cidx == 0) {
            if ((xc >> 2) + (yc >> 2) > 0) s += 3;
            s += (l2 == 3) ? (scan == 0 ? 9 : 15) : 21;
        } else {
            s += (l2 == 3) ? 9 : 12;
        }
        return s;
    }

    void code_remaining(uint32_t value, int rice) {
        if (value < (uint32_t)(3 << rice)) {
            int length = value >> rice;
            cab.encode_bypass_bins((1u << (length + 1)) - 2, length + 1);
            cab.encode_bypass_bins(value & ((1u << rice) - 1), rice);
        } else {
            int length = rice;
            value -= 3 << rice;
            while (value >= (1u << length)) { value -= 1u << length; length++; }
            int nbits = 3 + length + 1 - rice;
            cab.encode_bypass_bins((1u << nbits) - 2, nbits);
            cab.encode_bypass_bins(value, length);
        }
    }

    void last_position(int lx, int ly, int l2, int cidx) {
        int ctx_off, ctx_shift;
        if (cidx == 0) {
            ctx_off = 3 * (l2 - 2) + ((l2 - 1) >> 2);
            ctx_shift = (l2 + 1) >> 2;
        } else { ctx_off = 15; ctx_shift = l2 - 2; }
        int gx = GROUP_IDX[lx], gy = GROUP_IDX[ly];
        int max_group = GROUP_IDX[(1 << l2) - 1];
        for (int i = 0; i < gx; i++)
            cab.encode_bin(OFF_LAST_SIG_X + ctx_off + (i >> ctx_shift), 1);
        if (gx < max_group)
            cab.encode_bin(OFF_LAST_SIG_X + ctx_off + (gx >> ctx_shift), 0);
        for (int i = 0; i < gy; i++)
            cab.encode_bin(OFF_LAST_SIG_Y + ctx_off + (i >> ctx_shift), 1);
        if (gy < max_group)
            cab.encode_bin(OFF_LAST_SIG_Y + ctx_off + (gy >> ctx_shift), 0);
        if (gx > 3) cab.encode_bypass_bins(lx - MIN_IN_GROUP[gx], (gx >> 1) - 1);
        if (gy > 3) cab.encode_bypass_bins(ly - MIN_IN_GROUP[gy], (gy >> 1) - 1);
    }

    void residual(const int16_t* plane, int stride, int bx, int by, int l2,
                  int cidx, int scan_idx) {
        int n = 1 << l2;
        const std::vector<int>& scan = S.full[scan_idx][l2 - 2];
        const std::vector<int>& cgs = S.cg[scan_idx][l2 - 2];
        int nn = n * n;
        int32_t levels[1024];
        int last_pos = -1;
        for (int i = 0; i < nn; i++) {
            int r = scan[i];
            levels[i] = plane[(by + r / n) * stride + bx + r % n];
            if (levels[i]) last_pos = i;
        }
        int lx = scan[last_pos] % n, ly = scan[last_pos] / n;
        if (scan_idx == 2) { int t = lx; lx = ly; ly = t; }
        last_position(lx, ly, l2, cidx);

        int last_cg = last_pos >> 4;
        int ncg = n >= 4 ? (n >> 2) : 1;
        int csbf[9][9];
        memset(csbf, 0, sizeof(csbf));
        int gtr1_base = OFF_GREATER1_FLAG + (cidx ? 16 : 0);
        int gtr2_base = OFF_GREATER2_FLAG + (cidx ? 4 : 0);
        int sig_base = OFF_SIG_COEFF_FLAG + (cidx ? 27 : 0);
        int csbf_base = OFF_CODED_SUB_BLOCK_FLAG + (cidx ? 2 : 0);

        int c1 = 1;
        for (int i = last_cg; i >= 0; i--) {
            int cg_x = cgs[2 * i], cg_y = cgs[2 * i + 1];
            int infer_dc = 0, coded_sb;
            bool has = false;
            int s0 = i * 16, e0 = (i * 16 + 16 < last_pos + 1) ? i * 16 + 16
                                                               : last_pos + 1;
            for (int k = s0; k < e0; k++) if (levels[k]) { has = true; break; }
            if (i == last_cg || i == 0) {
                coded_sb = 1;
            } else {
                coded_sb = has ? 1 : 0;
                int ctx = csbf[cg_y][cg_x + 1] + csbf[cg_y + 1][cg_x];
                cab.encode_bin(csbf_base + (ctx > 1 ? 1 : ctx), coded_sb);
                infer_dc = 1;
            }
            csbf[cg_y][cg_x] = coded_sb;
            if (!coded_sb) continue;

            int start_n = (i == last_cg) ? (last_pos - 1 - i * 16) : 15;
            int sig_pos[17], nsig = 0;
            if (i == last_cg) sig_pos[nsig++] = last_pos;
            int prev_csbf = csbf[cg_y][cg_x + 1] + 2 * csbf[cg_y + 1][cg_x];
            for (int k = start_n; k >= 0; k--) {
                int pos = i * 16 + k;
                int sig = levels[pos] != 0;
                if (k > 0 || !infer_dc) {
                    int r = scan[pos];
                    cab.encode_bin(sig_base + sig_ctx(r % n, r / n, l2, cidx,
                                                      scan_idx, prev_csbf), sig);
                    if (sig) infer_dc = 0;
                }
                if (sig) sig_pos[nsig++] = pos;
            }

            int ctx_set = ((i == 0 || cidx) ? 0 : 2) + (c1 == 0 ? 1 : 0);
            c1 = 1;
            int gtr1_coded = nsig < 8 ? nsig : 8;
            int first_g2 = -1;
            for (int j = 0; j < gtr1_coded; j++) {
                int lvl = levels[sig_pos[j]] < 0 ? -levels[sig_pos[j]]
                                                 : levels[sig_pos[j]];
                int g1 = lvl > 1;
                cab.encode_bin(gtr1_base + ctx_set * 4 + c1, g1);
                if (g1) { if (first_g2 < 0) first_g2 = j; c1 = 0; }
                else if (c1 > 0 && c1 < 3) c1++;
            }
            if (first_g2 >= 0) {
                int lvl = levels[sig_pos[first_g2]];
                if (lvl < 0) lvl = -lvl;
                cab.encode_bin(gtr2_base + ctx_set, lvl > 2);
            }
            // sign-data-hiding: the sign of the coefficient at
            // firstSigScanPos (last coded here) is inferred from the
            // CG's sum-of-levels parity (clause 7.4.9.11); the quant
            // stage enforced the parity upstream
            bool hidden = sign_hiding && nsig > 0 &&
                          (sig_pos[0] - sig_pos[nsig - 1] > 3);
            int nsign = hidden ? nsig - 1 : nsig;
            for (int j = 0; j < nsign; j++)
                cab.encode_bypass(levels[sig_pos[j]] < 0);
            int rice = 0;
            for (int j = 0; j < nsig; j++) {
                int lvl = levels[sig_pos[j]] < 0 ? -levels[sig_pos[j]]
                                                 : levels[sig_pos[j]];
                int base = 1;
                if (j < gtr1_coded) base = (j == first_g2) ? 3 : 2;
                if (lvl >= base) {
                    code_remaining(lvl - base, rice);
                    if (lvl > (3 << rice) && rice < 4) rice++;
                }
            }
        }
    }
};

}  // namespace

extern "C" {

// Optional P-slice extension block (multi-ref + TMVP); null = legacy
// single-ref behavior. Mirrors the FramePSyntax fields.
struct PExtC {
    const uint8_t* ref8;          // per-cell L0 refIdx (null = 0)
    int32_t num_ref;
    int32_t tmvp;                 // slice_temporal_mvp enabled
    const int32_t* ref_pocs;      // (num_ref,)
    const int32_t* col_mv;        // collocated picture (n8, 2) MVs
    const uint8_t* col_ref8;
    const uint8_t* col_inter8;
    int32_t col_poc;
    const int32_t* col_ref_pocs;
    int32_t n_col_refs;
    int32_t* cu_bits_out;         // optional (n8,) harvest buffer
};

static void apply_pext(SliceEnc& enc, const PExtC* px) {
    if (!px) return;
    enc.ref8 = px->ref8;
    enc.num_ref = px->num_ref > 0 ? px->num_ref : 1;
    enc.ref_pocs = px->ref_pocs;
    enc.tmvp = px->tmvp;
    enc.col_mv = px->col_mv;
    enc.col_ref8 = px->col_ref8;
    enc.col_inter8 = px->col_inter8;
    enc.col_poc = px->col_poc;
    enc.col_ref_pocs = px->col_ref_pocs;
    enc.n_col_refs = px->n_col_refs > 0 ? px->n_col_refs : 1;
    enc.cu_bits = px->cu_bits_out;
}

// Generic slice-data encoder: slice_type 2 = I (mode8 used), 1 = P
// (mv8/max_merge used). sao_*, nxn8, mode4 may be null. Returns bytes
// written or -1.
int encode_slice(int slice_type, const uint8_t* depth8,
                 const uint8_t* mode8, const int32_t* mv8,
                 const int32_t* mvb, const uint8_t* pf8,
                 int poc, int poc_ref0, int poc_ref1, int max_merge,
                 int sign_hiding, int lossless, const uint8_t* cmode8,
                 const int16_t* coeff_y, const int16_t* coeff_cb,
                 const int16_t* coeff_cr,
                 const int32_t* sao_py, const int32_t* sao_pcb,
                 const int32_t* sao_pcr,
                 const uint8_t* nxn8, const uint8_t* mode4,
                 const uint8_t* intra8,
                 const uint8_t* tusplit8, int rqt_inter,
                 const int32_t* qp_map, int slice_qp,
                 int w, int h, int log2_ctu, int log2_min_cu,
                 uint8_t* init_states, int num_ctx,
                 const void* pext,
                 uint8_t* out, int out_cap,
                 uint32_t* tail_val, int* tail_bits) {
    (void)num_ctx;
    SliceEnc enc(init_states, depth8, mode8, coeff_y, coeff_cb, coeff_cr,
                 w, h, log2_ctu, log2_min_cu);
    enc.slice_type = slice_type;
    apply_pext(enc, (const PExtC*)pext);
    enc.mv8 = mv8;
    enc.mvb = mvb;
    enc.pf8 = pf8;
    enc.poc = poc; enc.poc_ref0 = poc_ref0; enc.poc_ref1 = poc_ref1;
    enc.max_merge = max_merge;
    enc.sign_hiding = sign_hiding;
    enc.lossless = lossless;
    enc.cmode8 = cmode8;
    enc.nxn8 = nxn8;
    enc.mode4 = mode4;
    enc.intra8 = intra8;
    enc.tusplit8 = tusplit8;
    enc.rqt_inter = rqt_inter;
    enc.qp_map = qp_map;
    enc.slice_qp = slice_qp;
    enc.sao_p[0] = sao_py; enc.sao_p[1] = sao_pcb; enc.sao_p[2] = sao_pcr;
    enc.run();
    enc.cab.finish(tail_val, tail_bits);
    int nbytes = (int)enc.cab.out.size();
    if (nbytes > out_cap) return -1;
    memcpy(out, enc.cab.out.data(), nbytes);
    return nbytes;
}

// Encode the intra slice data. Returns bytes written, or -1 on overflow.
// tail_val/tail_bits receive the sub-byte CABAC tail (appended by the
// Python BitWriter before rbsp trailing bits).
int encode_intra_slice(const uint8_t* depth8, const uint8_t* mode8,
                       const int16_t* coeff_y, const int16_t* coeff_cb,
                       const int16_t* coeff_cr, int w, int h,
                       int log2_ctu, int log2_min_cu,
                       uint8_t* init_states, int num_ctx,
                       uint8_t* out, int out_cap,
                       uint32_t* tail_val, int* tail_bits) {
    (void)num_ctx;
    SliceEnc enc(init_states, depth8, mode8, coeff_y, coeff_cb, coeff_cr,
                 w, h, log2_ctu, log2_min_cu);
    enc.run();
    enc.cab.finish(tail_val, tail_bits);
    int nbytes = (int)enc.cab.out.size();
    if (nbytes > out_cap) return -1;
    memcpy(out, enc.cab.out.data(), nbytes);
    return nbytes;
}

// WPP slice encoder: one byte-aligned substream per CTU row. Writes
// the concatenated raw substreams into out and per-substream lengths
// into sub_lens; returns total bytes or -1.
int encode_slice_wpp(int slice_type, const uint8_t* depth8,
                     const uint8_t* mode8, const int32_t* mv8,
                     const int32_t* mvb, const uint8_t* pf8,
                     int poc, int poc_ref0, int poc_ref1,
                     int max_merge, int sign_hiding, int lossless,
                     const uint8_t* cmode8,
                     const int16_t* coeff_y, const int16_t* coeff_cb,
                     const int16_t* coeff_cr,
                     const int32_t* sao_py, const int32_t* sao_pcb,
                     const int32_t* sao_pcr,
                     const uint8_t* nxn8, const uint8_t* mode4,
                     const uint8_t* intra8,
                     const uint8_t* tusplit8, int rqt_inter,
                     const int32_t* qp_map, int slice_qp,
                     int w, int h, int log2_ctu, int log2_min_cu,
                     uint8_t* init_states, int num_ctx,
                     const void* pext,
                     uint8_t* out, int out_cap,
                     int* sub_lens, int max_subs) {
    SliceEnc enc(init_states, depth8, mode8, coeff_y, coeff_cb, coeff_cr,
                 w, h, log2_ctu, log2_min_cu);
    enc.slice_type = slice_type;
    apply_pext(enc, (const PExtC*)pext);
    enc.mv8 = mv8;
    enc.mvb = mvb;
    enc.pf8 = pf8;
    enc.poc = poc; enc.poc_ref0 = poc_ref0; enc.poc_ref1 = poc_ref1;
    enc.max_merge = max_merge;
    enc.sign_hiding = sign_hiding;
    enc.lossless = lossless;
    enc.cmode8 = cmode8;
    enc.nxn8 = nxn8;
    enc.mode4 = mode4;
    enc.intra8 = intra8;
    enc.tusplit8 = tusplit8;
    enc.rqt_inter = rqt_inter;
    enc.qp_map = qp_map;
    enc.slice_qp = slice_qp;
    enc.wpp = 1;
    enc.num_ctx = num_ctx;
    enc.sao_p[0] = sao_py; enc.sao_p[1] = sao_pcb; enc.sao_p[2] = sao_pcr;
    enc.run_wpp();
    int nsubs = (int)enc.substreams.size();
    if (nsubs > max_subs) return -1;
    int total = 0;
    for (int s = 0; s < nsubs; s++) {
        int len = (int)enc.substreams[s].size();
        if (total + len > out_cap) return -1;
        memcpy(out + total, enc.substreams[s].data(), len);
        sub_lens[s] = len;
        total += len;
    }
    return total;
}

int ctx_layout_checksum() {
    // lets Python assert the generated offsets match ctx_tables.py
    return CTX_LAYOUT_CHECKSUM;
}

// Expand compacted 4x4 coefficient groups into a dense int16 plane.
// vals: (t, 16) int16 CG rows in raster scan (row k -> dy=k/4, dx=k%4);
// idx: (t,) int32 raster CG indices on the SOURCE grid of in_ncx CG
// columns (caller subtracts any stacked-frame base); out is
// (out_h, out_w) — CGs outside the crop are dropped. The host-side
// numpy equivalent (scatter + transpose/reshape of the full CG
// tensor) cost ~0.5 s per 8-frame 1080p chunk; this is a ~2 ms
// memset + scatter. The dense plane is what the slice encoder walks
// (x265 keeps coefficients in per-thread dense TU buffers for the
// same reason, frameencoder.cpp).
void expand_cgs(const int16_t* vals, const int32_t* idx, int t,
                int in_ncx, int out_h, int out_w, int16_t* out) {
    memset(out, 0, (size_t)out_h * out_w * sizeof(int16_t));
    for (int r = 0; r < t; r++) {
        const int cg = idx[r];
        const int cy = cg / in_ncx, cx = cg % in_ncx;
        if (cy * 4 >= out_h || cx * 4 >= out_w)
            continue;
        int16_t* dst = out + (size_t)(cy * 4) * out_w + cx * 4;
        const int16_t* src = vals + (size_t)r * 16;
        for (int dy = 0; dy < 4; dy++)
            for (int dx = 0; dx < 4; dx++)
                dst[dy * out_w + dx] = src[dy * 4 + dx];
    }
}

// decoded-picture-hash CRC (hash_type 1, H.265 D.3.19): CRC-16/CCITT
// over the raster sample bytes, low byte first then (bit depth > 8)
// high byte; init 0xffff, finished by clocking 16 zero bits.
// Reference behavior: picyuv.cpp updateCRC/crcFinish.
int picture_crc16(const uint16_t* plane, long long n, int two_bytes) {
    static uint16_t tab[256];
    static bool init = false;
    if (!init) {
        for (int b = 0; b < 256; b++) {
            uint32_t c = (uint32_t)b << 8;
            for (int k = 0; k < 8; k++)
                c = ((c << 1) & 0xffff) ^ ((c >> 15) & 1 ? 0x1021 : 0);
            tab[b] = (uint16_t)c;
        }
        init = true;
    }
    // one step is s' = s*x + bit mod P (bit enters the LSB), so a byte
    // is s' = (s_lo << 8) ^ tab[s_hi] ^ byte with tab[h] = h*x^16 mod P
    uint32_t crc = 0xffff;
    for (long long i = 0; i < n; i++) {
        uint16_t s = plane[i];
        crc = ((crc << 8) & 0xffff) ^ tab[(crc >> 8) & 0xff] ^ (s & 0xff);
        if (two_bytes)
            crc = ((crc << 8) & 0xffff) ^ tab[(crc >> 8) & 0xff] ^ (s >> 8);
    }
    // crcFinish: 16 zero bits
    crc = ((crc << 8) & 0xffff) ^ tab[(crc >> 8) & 0xff];
    crc = ((crc << 8) & 0xffff) ^ tab[(crc >> 8) & 0xff];
    return (int)crc;
}

}  // extern "C"
