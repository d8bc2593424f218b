// bath_tpu_torch native host runtime: sequence digitization, reverse
// complement, six-frame ORF extraction, and frame translation.
//
// This is the framework's host-side data loader (the role Easel's
// esl_sqio/esl_gencode C code plays in the reference, ref:
// bathsearch.c:385-392 ProcessStart/Piece/End usage): the hot
// per-nucleotide loops that feed window batches to the device.
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).
//
// Digital alphabet conventions match bath_tpu_torch.alphabet (Easel order):
//   DNA: 0..3 ACGT, 4 gap, 5..14 degenerate, 15 N(any)=Kp-3,
//        16 '*', 17 '~'  (Kp=18)
//   amino: 0..19, ..., 26 '*'(stop)=Kp-2, X=Kp-3=25? (Kp=29: X=26? see
//   python: sym "ACDEFGHIKLMNPQRSTVWY-BJZOUX*~": X at 26, '*' 27, '~' 28)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <omp.h>
#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

extern "C" {

// --- DNA digitization ------------------------------------------------
// table: 256 int8 entries, -1 = invalid.  Returns count of invalid.
int bio_digitize(const char* text, int64_t n, const int8_t* table,
                 int32_t* out) {
    int bad = 0;
    for (int64_t i = 0; i < n; i++) {
        int8_t v = table[(uint8_t)text[i]];
        if (v < 0) { bad++; v = 15; }
        out[i] = v;
    }
    return bad;
}

// --- reverse complement ---------------------------------------------
// comp: Kp int32 complement map
void bio_revcomp(const int32_t* dsq, int64_t n, const int32_t* comp,
                 int32_t* out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = comp[dsq[n - 1 - i]];
}

// --- degenerate-aware codon translation ------------------------------
// basic:  [64] canonical codon -> amino (stop = stop_code)
// masks:  [Kp_dna] 4-bit mask of compatible canonical nucleotides
//         (0 for gap/nonres/missing)
// any_aa: the 'X' amino code
static inline int translate_codon(int x1, int x2, int x3,
                                  const int32_t* basic,
                                  const uint8_t* masks, int any_aa) {
    if (x1 < 4 && x2 < 4 && x3 < 4)
        return basic[16 * x1 + 4 * x2 + x3];
    uint8_t m1 = masks[x1], m2 = masks[x2], m3 = masks[x3];
    if (!m1 || !m2 || !m3) return any_aa;
    int aa = -1;
    for (int a = 0; a < 4; a++) {
        if (!(m1 & (1 << a))) continue;
        for (int b = 0; b < 4; b++) {
            if (!(m2 & (1 << b))) continue;
            for (int c = 0; c < 4; c++) {
                if (!(m3 & (1 << c))) continue;
                int v = basic[16 * a + 4 * b + c];
                if (aa == -1) aa = v;
                else if (aa != v) return any_aa;
            }
        }
    }
    return aa < 0 ? any_aa : aa;
}

// --- six-frame ORF extraction ---------------------------------------
// Walk codons in end-position order with frames interleaved (matching
// esl_gencode ProcessPiece, ref: bathsearch.c:385); an ORF closes at
// its stop codon; open ORFs flush at the end in frame order.
//
// Outputs:
//   aa_out   caller buffer >= L ints: concatenated ORF aminos
//   meta_out caller buffer >= 4*(L/3+3) ints: per ORF
//            (start, end, frame, len); aa offsets are cumulative.
// Returns number of ORFs.
// One frame's ORFs in codon-end order.  Writes aminos contiguously
// into aa_buf (one open ORF per frame, rewound when it dies below
// minlen), per-ORF meta (start, end, frame, len) and the finish-event
// position ev (the stop codon's e; the end-of-sequence flush gets
// L+1+f so flushes sort after every stop, in frame order) — the keys
// that let the three frames be scanned in parallel and merged back
// into the exact interleaved codon-end order of the serial walk.
static int64_t extract_orfs_frame(
    const int32_t* dsq, int64_t L, int f,
    const int32_t* basic, const uint8_t* masks, const uint8_t* is_init,
    int stop_code, int any_aa, int minlen, int require_init,
    int is_revcomp, int32_t* aa_buf, int32_t* meta_buf,
    int64_t* ev_buf) {
    int64_t norf = 0, aa_pos = 0;
    int64_t fstart = 0, flen = 0;
    bool fin = false;

    auto finish = [&](int64_t apos_last, int64_t ev) {
        if (fin && flen >= minlen) {
            int64_t s = fstart, e = apos_last;
            if (is_revcomp) { s = L - s + 1; e = L - e + 1; }
            meta_buf[4 * norf + 0] = (int32_t)s;
            meta_buf[4 * norf + 1] = (int32_t)e;
            meta_buf[4 * norf + 2] = f;
            meta_buf[4 * norf + 3] = (int32_t)flen;
            ev_buf[norf] = ev;
            aa_pos += flen;
            norf++;
        }
        flen = 0;
        fin = false;
    };

    for (int64_t e = 3 + f; e <= L; e += 3) {
        int x1 = dsq[e - 3], x2 = dsq[e - 2], x3 = dsq[e - 1];
        bool canonical = x1 < 4 && x2 < 4 && x3 < 4;
        int aa = canonical ? basic[16 * x1 + 4 * x2 + x3]
                           : translate_codon(x1, x2, x3, basic, masks,
                                             any_aa);
        if (aa == stop_code) {
            finish(e - 3, e);
        } else if (!fin) {
            bool ok = true;
            if (require_init)
                ok = canonical && is_init[16 * x1 + 4 * x2 + x3];
            if (ok) {
                fin = true;
                fstart = e - 2;
                aa_buf[aa_pos] = aa;
                flen = 1;
            }
        } else {
            aa_buf[aa_pos + flen++] = aa;
        }
    }
    int64_t e_last = L - ((L - f) % 3);
    finish(e_last, L + 1 + f);
    return norf;
}

int bio_extract_orfs(const int32_t* dsq, int64_t L,
                     const int32_t* basic, const uint8_t* masks,
                     const uint8_t* is_init, int stop_code, int any_aa,
                     int minlen, int require_init, int is_revcomp,
                     int32_t* aa_out, int32_t* meta_out) {
    if (L < 3) return 0;
    // per-frame scratch (heap per call: shared across the OMP team
    // and the merging thread, so thread_local won't do)
    int64_t fc = L / 3 + 2;
    int32_t* aa_b = new int32_t[3 * fc];
    int32_t* meta_b = new int32_t[3 * 4 * fc];
    int64_t* ev_b = new int64_t[3 * fc];
    int64_t cnt[3];
#pragma omp parallel for num_threads(3) schedule(static, 1)
    for (int f = 0; f < 3; f++)
        cnt[f] = extract_orfs_frame(dsq, L, f, basic, masks, is_init,
                                    stop_code, any_aa, minlen,
                                    require_init, is_revcomp,
                                    aa_b + f * fc, meta_b + f * 4 * fc,
                                    ev_b + f * fc);
    // 3-way merge by finish-event position (each frame ascending;
    // events never tie across frames) = the serial interleaved order
    int norf = 0;
    int64_t aa_pos = 0;
    int64_t hd[3] = {0, 0, 0};
    int64_t ap[3] = {0, 0, 0};
    while (true) {
        int best = -1;
        int64_t bev = 0;
        for (int f = 0; f < 3; f++)
            if (hd[f] < cnt[f]
                && (best < 0 || ev_b[f * fc + hd[f]] < bev)) {
                best = f;
                bev = ev_b[f * fc + hd[f]];
            }
        if (best < 0) break;
        const int32_t* m = meta_b + best * 4 * fc + 4 * hd[best];
        int32_t len = m[3];
        memcpy(meta_out + 4 * norf, m, 4 * sizeof(int32_t));
        memcpy(aa_out + aa_pos, aa_b + best * fc + ap[best],
               len * sizeof(int32_t));
        aa_pos += len;
        ap[best] += len;
        hd[best]++;
        norf++;
    }
    delete[] aa_b;
    delete[] meta_b;
    delete[] ev_b;
    return norf;
}

// --- frame translation (for bias filter / display) -------------------
void bio_translate_frame(const int32_t* dsq, int64_t L, int frame,
                         const int32_t* basic, const uint8_t* masks,
                         int any_aa, int32_t* out, int64_t* out_n) {
    int64_t n = 0;
    for (int64_t i = frame; i + 3 <= L; i += 3)
        out[n++] = translate_codon(dsq[i], dsq[i + 1], dsq[i + 2],
                                   basic, masks, any_aa);
    *out_n = n;
}

}  // extern "C"

// --- quantized acceleration filters ---------------------------------
// Exact ports of the reference's SSV/MSV/ViterbiFilter semantics
// (ref: impl_sse/ssvfilter.c :875, msvfilter.c :76, vitfilter.c :39;
// numpy reference in bath_tpu_torch/ops/reference/filters.py).  All-integer
// recurrences, so results are bit-identical to the scalar reference.

extern "C" {

#if defined(__AVX512BW__)
// SSV DP in the offset-u8 domain: u = d + 128.  Signed byte costs
// are split into positive / negative-magnitude u8 tables so the
// int16 clamps become saturating u8 ops:
//   v = clamp(d - row, -128, 127)  ==  subs_epu8(adds_epu8(u, r-), r+)
// (adds saturating at 255 == the +127 clamp; subs at 0 == -128; for
// |row| >= 255 both still agree because d is in [-128,127]).  The
// scalar path's unsigned row max over (d & 0xFF) is max_epu8 over
// (u XOR 0x80).  One pass, 64 lanes; the k-1 diagonal shift is a
// 1-byte-unaligned load.  Tail lanes (r+ padded 255, r- padded 0)
// produce u=0 -> 128, the same value every dead cell contributes in
// the scalar path (cells start at d=-128, so the running xE_u is
// always >= 128 after row 1).
static int ssv_xe_u8_avx512(const int32_t* dsq, int64_t L,
                            const uint8_t* sbv8p,
                            const uint8_t* sbv8n, int spad, int M) {
    static thread_local uint8_t* ubuf = nullptr;
    static thread_local int64_t ucap = 0;
    if (ucap < 2 * spad) {
        delete[] ubuf;
        ubuf = new uint8_t[2 * spad];
        ucap = 2 * spad;
    }
    memset(ubuf, 0, 2 * spad);
    uint8_t* u0 = ubuf;
    uint8_t* u1 = ubuf + spad;
    const __m512i x80 = _mm512_set1_epi8((char)0x80);
    __m512i vmax = _mm512_setzero_si512();
    for (int64_t i = 0; i < L; i++) {
        const uint8_t* rowp = sbv8p + (int64_t)dsq[i] * spad;
        const uint8_t* rown = sbv8n + (int64_t)dsq[i] * spad;
        const uint8_t* up = (i & 1) ? u1 : u0;
        uint8_t* un = (i & 1) ? u0 : u1;
        for (int kb = 0; kb < M; kb += 64) {
            __m512i p = _mm512_loadu_si512(
                (const void*)(up + kb));
            __m512i rp = _mm512_loadu_si512(
                (const void*)(rowp + kb + 1));
            __m512i rn = _mm512_loadu_si512(
                (const void*)(rown + kb + 1));
            __m512i v = _mm512_subs_epu8(
                _mm512_adds_epu8(p, rn), rp);
            _mm512_storeu_si512((void*)(un + kb + 1), v);
            vmax = _mm512_max_epu8(vmax,
                                   _mm512_xor_si512(v, x80));
        }
    }
    // horizontal max_epu8
    __m256i a = _mm256_max_epu8(_mm512_castsi512_si256(vmax),
                                _mm512_extracti64x4_epi64(vmax, 1));
    __m128i b = _mm_max_epu8(_mm256_castsi256_si128(a),
                             _mm256_extracti128_si256(a, 1));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 8));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 4));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 2));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 1));
    return _mm_extract_epi8(b, 0) & 0xFF;
}
#endif

#if defined(__AVX512VBMI__)
}  // pause extern "C" (templates need C++ linkage)
// Register-resident SSV: the whole DP row lives in NB zmm registers
// across positions (no store -> shifted-reload round trip, which
// stalls on failed store-forwarding); the k-1 diagonal shift is a
// cross-lane byte permute.  Bit-identical xE_u to the scalar loop.
// shift index: out[0] = a[63] (previous block's last), else b[j-1]
static const __m512i SSV_SHIFT_IDX = []() {
    alignas(64) uint8_t sidx[64];
    sidx[0] = 63;
    for (int j = 1; j < 64; j++) sidx[j] = (uint8_t)(64 + j - 1);
    return _mm512_load_si512((const void*)sidx);
}();

template <int NB>
static int ssv_xe_u8_avx512_reg(const int32_t* dsq, int64_t L,
                                const uint8_t* sbv8p,
                                const uint8_t* sbv8n, int spad) {
    const __m512i idx = SSV_SHIFT_IDX;
    const __m512i x80 = _mm512_set1_epi8((char)0x80);
    const __m512i zero = _mm512_setzero_si512();
    __m512i v[NB], vmax = zero;
    for (int b = 0; b < NB; b++) v[b] = zero;
    for (int64_t i = 0; i < L; i++) {
        const uint8_t* rowp = sbv8p + (int64_t)dsq[i] * spad + 1;
        const uint8_t* rown = sbv8n + (int64_t)dsq[i] * spad + 1;
        __m512i carry = zero;      // u[0] = 0 (column 0 never moves)
        for (int b = 0; b < NB; b++) {
            __m512i sh = _mm512_permutex2var_epi8(carry, idx, v[b]);
            carry = v[b];
            __m512i rp = _mm512_loadu_si512(
                (const void*)(rowp + b * 64));
            __m512i rn = _mm512_loadu_si512(
                (const void*)(rown + b * 64));
            v[b] = _mm512_subs_epu8(_mm512_adds_epu8(sh, rn), rp);
            vmax = _mm512_max_epu8(vmax,
                                   _mm512_xor_si512(v[b], x80));
        }
    }
    __m256i a = _mm256_max_epu8(_mm512_castsi512_si256(vmax),
                                _mm512_extracti64x4_epi64(vmax, 1));
    __m128i b = _mm_max_epu8(_mm256_castsi256_si128(a),
                             _mm256_extracti128_si256(a, 1));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 8));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 4));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 2));
    b = _mm_max_epu8(b, _mm_srli_si128(b, 1));
    return _mm_extract_epi8(b, 0) & 0xFF;
}
extern "C" {  // resume
#endif

// Shared SSV score epilogue (uint16-wraparound post-processing of
// the row max, ref: filters.py ssv fast path).  Returns 1 = certain
// hit (+inf), 0 = score written, -1 = fell through to full MSV.
static int ssv_postprocess(int xE_u, int base, int tec, int tjb,
                           int tbm, int bias, double scale,
                           float* out_sc) {
    unsigned xE = (unsigned)xE_u & 0xFFFF;
    if (xE >= (unsigned)(255 - bias)) {
        if (base - tjb - tbm < 128) return -1;
        *out_sc = 0.0f;
        return 1;
    }
    xE = (xE + base - tjb - tbm) & 0xFFFF;
    xE = (xE - 128) & 0xFFFF;
    if (xE >= (unsigned)(255 - bias)) { *out_sc = 0.0f; return 1; }
    unsigned xJ = (xE - tec) & 0xFFFF;
    if (xJ > (unsigned)base) return -1;
    *out_sc = (float)((((double)((int)xJ - tjb)) - (double)base)
                      / scale - 3.0);
    return 0;
}

// returns 0 = score valid, 1 = +inf (overflow / certain hit)
// sbv: [Kp][M+1] int16 byte costs; rbv: [Kp][M+1] int32 (uint8 costs)
// sbv8p/sbv8n/spad: optional padded positive/negative-magnitude u8
// views of sbv (per-batch precompute; enable the SIMD SSV inner
// loop — bit-identical xE_u)
int bio_msv_filter(const int32_t* dsq, int64_t L, const int16_t* sbv,
                   const int32_t* rbv, int Kp, int M, int base,
                   int tec, int tjb, int tbm, int bias, double scale,
                   const uint8_t* sbv8p, const uint8_t* sbv8n,
                   int spad, float* out_sc) {
    int stride = M + 1;
    // ---- SSV fast path ----
    bool ssv_ok = (tjb + tbm + tec + bias) < 127;
#if defined(__AVX512BW__)
    if (ssv_ok && sbv8p) {
        int xE_u;
#if defined(__AVX512VBMI__)
        switch ((M + 63) / 64) {
        case 1:
            xE_u = ssv_xe_u8_avx512_reg<1>(dsq, L, sbv8p, sbv8n,
                                           spad);
            break;
        case 2:
            xE_u = ssv_xe_u8_avx512_reg<2>(dsq, L, sbv8p, sbv8n,
                                           spad);
            break;
        case 3:
            xE_u = ssv_xe_u8_avx512_reg<3>(dsq, L, sbv8p, sbv8n,
                                           spad);
            break;
        case 4:
            xE_u = ssv_xe_u8_avx512_reg<4>(dsq, L, sbv8p, sbv8n,
                                           spad);
            break;
        case 5:
            xE_u = ssv_xe_u8_avx512_reg<5>(dsq, L, sbv8p, sbv8n,
                                           spad);
            break;
        case 6:
            xE_u = ssv_xe_u8_avx512_reg<6>(dsq, L, sbv8p, sbv8n,
                                           spad);
            break;
        default:
            xE_u = ssv_xe_u8_avx512(dsq, L, sbv8p, sbv8n, spad, M);
        }
#else
        xE_u = ssv_xe_u8_avx512(dsq, L, sbv8p, sbv8n, spad, M);
#endif
        int st = ssv_postprocess(xE_u, base, tec, tjb, tbm, bias,
                                 scale, out_sc);
        if (st >= 0) return st;
        ssv_ok = false;         // fell through -> full MSV below
    }
#endif
    if (ssv_ok) {
        // two alternating rows so the diagonal recurrence
        // d_new[k] = d_old[k-1] - row[k] is a straight out-of-place
        // loop the compiler can vectorize (the in-place descending
        // form defeats autovectorization)
        static thread_local int16_t* dbuf = nullptr;
        static thread_local int64_t dcap = 0;
        if (dcap < stride) {
            delete[] dbuf;
            dbuf = new int16_t[2 * stride];
            dcap = stride;
        }
        int16_t* d0 = dbuf;
        int16_t* d1 = dbuf + stride;
        for (int k = 0; k <= M; k++) d0[k] = d1[k] = -128;
        int xE_u = 0;
        for (int64_t i = 0; i < L; i++) {
            const int16_t* row = sbv + dsq[i] * stride;
            const int16_t* dp_ = (i & 1) ? d1 : d0;
            int16_t* dn = (i & 1) ? d0 : d1;
            for (int k = 1; k <= M; k++) {
                int v = (int)dp_[k - 1] - (int)row[k];
                if (v < -128) v = -128;
                if (v > 127) v = 127;
                dn[k] = (int16_t)v;
            }
            int rmax = 0;
            for (int k = 1; k <= M; k++) {
                int u = (int)dn[k] & 0xFF;
                if (u > rmax) rmax = u;
            }
            if (rmax > xE_u) xE_u = rmax;
        }
        int st = ssv_postprocess(xE_u, base, tec, tjb, tbm, bias,
                                 scale, out_sc);
        if (st >= 0) return st;
        // fell through -> full MSV below
    }
    // ---- full MSV ----
    static thread_local int32_t* dp = nullptr;
    static thread_local int64_t dpcap = 0;
    if (dpcap < stride) {
        delete[] dp;
        dp = new int32_t[stride];
        dpcap = stride;
    }
    for (int k = 0; k <= M; k++) dp[k] = 0;
    int xJ = 0;
    int tjbm = (tjb + tbm) & 0xFF;
    int xB = base - tjbm;
    if (xB < 0) xB = 0;
    for (int64_t i = 0; i < L; i++) {
        const int32_t* row = rbv + dsq[i] * stride;
        int xE = 0;
        int prev = 0;                     // mpv[0] = 0
        for (int k = 1; k <= M; k++) {
            int sv = prev > xB ? prev : xB;
            prev = dp[k];                 // save old dp[k] for k+1
            sv += bias;
            if (sv > 255) sv = 255;
            sv -= row[k];
            if (sv < 0) sv = 0;
            dp[k] = sv;
            if (sv > xE) xE = sv;
        }
        dp[0] = 0;
        if (xE + bias >= 255) { *out_sc = 0.0f; return 1; }
        xE -= tec;
        if (xE < 0) xE = 0;
        if (xE > xJ) xJ = xE;
        int b = base > xJ ? base : xJ;
        xB = b - tjbm;
        if (xB < 0) xB = 0;
    }
    *out_sc = (float)((((double)(xJ - tjb)) - (double)base) / scale
                      - 3.0);
    return 0;
}

// ViterbiFilter score only (no window capture), int16-saturated ops
// in int32 (ref: vitfilter.c :39).  move_w: wordified length-model
// move score; e_move/e_loop: E-state word scores.
// twv layout: [M][8] in P_* slot order (P_MM..P_II as in bath_tpu_torch).
int bio_vit_filter(const int32_t* dsq, int64_t L, const int32_t* rwv,
                   const int32_t* twv, int Kp, int M, int base,
                   double scale, int move_w, int e_move, int e_loop,
                   float* out_sc) {
    const int NEG = -32768;
    const int P_MM = 0, P_IM = 1, P_DM = 2, P_BM = 3, P_MD = 4,
        P_DD = 5, P_MI = 6, P_II = 7;
    int stride = M + 1;
    auto sat = [](int x) {
        if (x < -32768) return -32768;
        if (x > 32767) return 32767;
        return x;
    };
    static thread_local int32_t *dm = nullptr, *di = nullptr,
        *dd = nullptr, *nm = nullptr, *ni = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < stride) {
        delete[] dm; delete[] di; delete[] dd;
        delete[] nm; delete[] ni;
        dm = new int32_t[stride]; di = new int32_t[stride];
        dd = new int32_t[stride]; nm = new int32_t[stride];
        ni = new int32_t[stride];
        cap = stride;
    }
    for (int k = 0; k <= M; k++) dm[k] = di[k] = dd[k] = NEG;
    int xN = base;
    int xB = sat(xN + move_w);
    int xJ = NEG, xC = NEG;
    for (int64_t i = 0; i < L; i++) {
        const int32_t* row = rwv + dsq[i] * stride;
        int xE = NEG;
        // M and I rows (new values into nm/ni)
        nm[0] = ni[0] = NEG;
        for (int k = 1; k <= M; k++) {
            const int32_t* tin = twv + (k - 1) * 8;  // into node k
            int sv = sat(xB + tin[P_BM]);
            int v = sat(dm[k - 1] + tin[P_MM]); if (v > sv) sv = v;
            v = sat(di[k - 1] + tin[P_IM]); if (v > sv) sv = v;
            v = sat(dd[k - 1] + tin[P_DM]); if (v > sv) sv = v;
            sv = sat(sv + row[k]);
            nm[k] = sv;
            if (sv > xE) xE = sv;
            if (k < M) {
                const int32_t* tout = twv + k * 8;    // out of node k
                int iv = sat(dm[k] + tout[P_MI]);
                int iv2 = sat(di[k] + tout[P_II]);
                ni[k] = iv > iv2 ? iv : iv2;
            } else ni[k] = NEG;
        }
        if (xE >= 32767) { *out_sc = 0.0f; return 1; }
        // D row: max-plus closure along k
        dd[0] = dd[1] = NEG;
        for (int k = 2; k <= M; k++) {
            const int32_t* tin = twv + (k - 1) * 8;
            int v1 = sat(nm[k - 1] + tin[P_MD]);
            int v2 = sat(dd[k - 1] + tin[P_DD]);
            dd[k] = v1 > v2 ? v1 : v2;
        }
        // specials (-3nat approximation: loop scores 0)
        int xC2 = xC > sat(xE + e_move) ? xC : sat(xE + e_move);
        int xJ2 = xJ > sat(xE + e_loop) ? xJ : sat(xE + e_loop);
        int b1 = sat(xJ2 + move_w), b2 = sat(xN + move_w);
        xB = b1 > b2 ? b1 : b2;
        xJ = xJ2; xC = xC2;
        int32_t* t = dm; dm = nm; nm = t;
        t = di; di = ni; ni = t;
    }
    if (xC > NEG) {
        *out_sc = (float)((((double)(xC + move_w)) - (double)base)
                          / scale - 3.0);
        return 0;
    }
    *out_sc = -1.0f / 0.0f;
    return 0;
}

// Batched ViterbiFilter scores over the bias-surviving ORFs of a
// window (OpenMP; one call per window batch).  move_ws[i] is the
// per-ORF-length wordified N->B move score (reconfig_length result);
// the E scores and base/scale are length-independent.
void bio_vit_filter_batch(const int32_t* dsq_cat, const int64_t* offs,
                          const int32_t* lens, const int32_t* move_ws,
                          int64_t n, const int32_t* rwv,
                          const int32_t* twv, int Kp, int M, int base,
                          double scale, int e_move, int e_loop,
                          float* out) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t i = 0; i < n; i++) {
        float sc = 0.0f;
        int st = bio_vit_filter(dsq_cat + offs[i], lens[i], rwv, twv,
                                Kp, M, base, scale, move_ws[i],
                                e_move, e_loop, &sc);
        out[i] = st == 1 ? 1.0f / 0.0f : sc;
    }
}

// Batched MSV over concatenated ORFs: one library call per window
// batch instead of one per ORF (the Python->C transition dominated
// the e2e profile).  offs[i] is the start of ORF i in dsq_cat;
// tjbs[i] the per-length tjb byte.  out[i] = score, +inf on the
// overflow/certain-hit status.
void bio_msv_filter_batch(const int32_t* dsq_cat, const int64_t* offs,
                          const int32_t* lens, const int32_t* tjbs,
                          int64_t n, const int16_t* sbv,
                          const int32_t* rbv, int Kp, int M, int base,
                          int tec, int tbm, int bias, double scale,
                          float* out) {
    // padded positive/negative-magnitude u8 views of sbv for the
    // SIMD SSV inner loop (per-batch precompute, ~8KB)
    int stride = M + 1;
    int spad = ((stride + 64 + 63) / 64) * 64;
    uint8_t* sbv8p = nullptr;
    uint8_t* sbv8n = nullptr;
#if defined(__AVX512BW__)
    sbv8p = new uint8_t[2 * (size_t)Kp * spad];
    sbv8n = sbv8p + (size_t)Kp * spad;
    for (int x = 0; x < Kp; x++) {
        for (int k = 0; k < stride; k++) {
            int v = sbv[x * stride + k];
            int p = v > 0 ? v : 0;
            int m = v < 0 ? -v : 0;
            sbv8p[(size_t)x * spad + k] =
                (uint8_t)(p > 255 ? 255 : p);
            sbv8n[(size_t)x * spad + k] =
                (uint8_t)(m > 255 ? 255 : m);
        }
        for (int k = stride; k < spad; k++) {
            sbv8p[(size_t)x * spad + k] = 255;
            sbv8n[(size_t)x * spad + k] = 0;
        }
    }
#endif
    // host analogue of the reference's pthread worker pool over
    // sequence blocks (ref: bathsearch.c thread_loop): ORFs are
    // independent, scores deterministic regardless of schedule
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t i = 0; i < n; i++) {
        float sc = 0.0f;
        int st = bio_msv_filter(dsq_cat + offs[i], lens[i], sbv, rbv,
                                Kp, M, base, tec, tjbs[i], tbm, bias,
                                scale, sbv8p, sbv8n, spad, &sc);
        out[i] = st == 1 ? 1.0f / 0.0f : sc;
    }
    delete[] sbv8p;
}

// Sequential prob-space DD closure, same IEEE f32 op order as the
// Python reference loop (fwdback_fs.py _dd_closure): bit-identical.
void bio_dd_closure_f32(float* dc, const float* tdd, int M) {
    for (int k = 2; k <= M; k++) dc[k] += dc[k - 1] * tdd[k];
}

// Reversed D recurrence of the frameshift Backward rows
// (fwdback_fs.py: new_d[k] = tdm[k]*iv1[k] + tdd[k]*new_d[k+1] + xE),
// identical op order -> bit-identical.
void bio_bwd_d_fs_f32(float* nd, const float* tdm, const float* iv1,
                      const float* tdd, float xE, int M) {
    for (int k = M - 1; k >= 1; k--)
        nd[k] = tdm[k] * iv1[k] + tdd[k] * nd[k + 1] + xE;
}

// Reversed DD closure of the standard Backward rows
// (fwdback.py: dc[k] = dc[k] + dc[k+1]*tdd[k+1]).
void bio_bwd_dd_f32(float* dc, const float* tdd, int M) {
    for (int k = M - 1; k >= 1; k--)
        dc[k] = dc[k] + dc[k + 1] * tdd[k + 1];
}

// numpy's pairwise summation for f32 (PW_BLOCKSIZE = 128), needed so
// the C DP reductions are bit-identical to the numpy reference's
// .sum() calls.
static float np_pairwise_f32(const float* a, int64_t n) {
    if (n < 8) {
        float res = 0.f;
        for (int64_t i = 0; i < n; i++) res += a[i];
        return res;
    } else if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; j++) r[j] = a[j];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; j++) r[j] += a[i + j];
        float res = ((r[0] + r[1]) + (r[2] + r[3]))
            + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) res += a[i];
        return res;
    } else {
        int64_t n2 = n / 2;
        n2 -= n2 % 8;
        return np_pairwise_f32(a, n2) + np_pairwise_f32(a + n2, n - n2);
    }
}

// Standard amino Forward parser, score path only — bit-exact
// transcription of the numpy reference (fwdback.py forward :73):
// same f32 op order (note the reference divides the specials by the
// scale but multiplies the rows by its reciprocal), numpy-pairwise
// reductions.  Finish semantics as in bio_fs3_parser_score.
static float np_pairwise_f32(const float* a, int64_t n);
int bio_fwd_parser_score(const int32_t* dsq, int64_t L,
                         const float* rfv, int M,
                         const float* tBM, const float* tMM,
                         const float* tIM, const float* tDM,
                         const float* tMD, const float* tDD,
                         const float* tMI, const float* tII,
                         const float* xff, float* out_scales,
                         float* out_xctot) {
    const int W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* fbuf = nullptr;
    static thread_local int64_t fcap = 0;
    if (fcap < 4 * (int64_t)W) {
        delete[] fbuf;
        fbuf = new float[4 * W];
        fcap = 4 * W;
    }
    float* mc = fbuf;
    float* ic = fbuf + W;
    float* dc = fbuf + 2 * W;
    float* sv = fbuf + 3 * W;
    for (int k = 0; k <= M; k++) mc[k] = ic[k] = dc[k] = 0.f;
    float xN = 1.0f, xB = nmove, xJ = 0.f, xC = 0.f;
    for (int64_t i = 0; i <= L; i++) out_scales[i] = 1.0f;

    for (int64_t i = 1; i <= L; i++) {
        const float* row = rfv + (int64_t)dsq[i - 1] * W;
        sv[0] = 0.f;
        for (int k = 1; k <= M; k++)
            sv[k] = (xB * tBM[k] + mc[k - 1] * tMM[k]
                     + ic[k - 1] * tIM[k] + dc[k - 1] * tDM[k])
                * row[k];
        // new_i into ic AFTER sv has consumed old mc/ic shifts; the
        // reference computes new_i from the UNSHIFTED old rows
        for (int k = M; k >= 1; k--)
            ic[k] = mc[k] * tMI[k] + ic[k] * tII[k];
        ic[0] = 0.f;
        dc[0] = dc[1] = 0.f;
        for (int k = 2; k <= M; k++) dc[k] = sv[k - 1] * tMD[k];
        for (int k = 2; k <= M; k++) dc[k] += dc[k - 1] * tDD[k];
        for (int k = 0; k <= M; k++) mc[k] = sv[k];
        float xE = np_pairwise_f32(mc + 1, M)
            + np_pairwise_f32(dc + 1, M);
        xN = xN * nloop;
        xC = xC * cloop + xE * emove;
        xJ = xJ * jloop + xE * eloop;
        xB = xJ * jmove + xN * nmove;
        if (xE > 1.0e4f) {
            float scale = xE;
            xN /= scale; xC /= scale; xJ /= scale; xB /= scale;
            float inv = 1.0f / scale;
            for (int k = 0; k <= M; k++) {
                mc[k] *= inv; ic[k] *= inv; dc[k] *= inv;
            }
            out_scales[i] = scale;
        }
    }
    if (xC != xC) return 1;
    if (L > 0 && xC == 0.0f) return 1;
    if (xC - xC != 0.0f) return 1;
    *out_xctot = xC * cmove;
    return 0;
}

// Frameshift 3-codon Forward parser, score path only — a bit-exact
// transcription of the numpy reference (fwdback_fs.py
// forward_parser_fs3 :204; ref: impl_sse/fwdback_fs.c :97): same
// elementwise f32 op order, numpy-pairwise reductions, global
// live-row rescaling.  Logs are left to the caller: out_scales[i]
// records the rescale factor applied at row i (1.0 = none) and
// *out_xctot the final C-state total, so Python computes
// totscale/score with numpy's own log semantics.
// xff layout: [nloop nmove jloop jmove cloop cmove eloop emove].
// Returns 0 ok, 1 range error (nan/inf/underflow), caller raises.
int bio_fs3_parser_score(const int32_t* ci2, const int32_t* ci3,
                         const int32_t* ci4, int64_t L,
                         const float* rfv, int M,
                         const float* tBM, const float* tMM,
                         const float* tIM, const float* tDM,
                         const float* tMD, const float* tDD,
                         const float* tMI, const float* tII,
                         const float* xff, float* out_scales,
                         float* out_xctot) {
    const int W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    // 4 M + 4 I + 4 D + 3 IVX rows + 1 scratch shift row
    if (cap < 16 * (int64_t)W) {
        delete[] buf;
        buf = new float[16 * W];
        cap = 16 * W;
    }
    float* mrow[4]; float* irow[4]; float* drow[4]; float* ivx[3];
    for (int r = 0; r < 4; r++) {
        mrow[r] = buf + r * W;
        irow[r] = buf + (4 + r) * W;
        drow[r] = buf + (8 + r) * W;
    }
    for (int r = 0; r < 3; r++) ivx[r] = buf + (12 + r) * W;
    for (int64_t k = 0; k < 15 * W; k++) buf[k] = 0.f;
    float xNb[4] = {1.f, 1.f, 0.f, 0.f};
    float xBb[4] = {nmove, nmove, 0.f, 0.f};
    float xJb[4] = {0.f, 0.f, 0.f, 0.f};
    float xCb[4] = {0.f, 0.f, 0.f, 0.f};
    if (L < 2) return 1;
    for (int64_t i = 0; i <= L; i++) out_scales[i] = 1.0f;

    for (int64_t i = 2; i <= L; i++) {
        int curr = (int)(i % 4), prev2 = (int)((i - 2) % 4),
            prev3 = (int)((i + 1) % 4);          // == (i-3) mod 4
        int s2 = (int)(i % 3), s3 = (int)((i - 1) % 3),
            s4 = (int)((i - 2) % 3);
        float* sv = ivx[s2];
        const float* mp = mrow[prev2];
        const float* ip = irow[prev2];
        const float* dp = drow[prev2];
        const float xB2 = xBb[prev2];
        sv[0] = 0.f;
        for (int k = 1; k <= M; k++)
            sv[k] = xB2 * tBM[k] + mp[k - 1] * tMM[k]
                + ip[k - 1] * tIM[k] + dp[k - 1] * tDM[k];
        const float* e2 = rfv + (int64_t)ci2[i - 1] * W;
        float* msv = mrow[curr];     // overwritten below before use
        if (i >= 3) {
            const float* e3 = rfv + (int64_t)ci3[i - 1] * W;
            const float* e4 = rfv + (int64_t)ci4[i - 1] * W;
            const float* i3 = ivx[s3];
            const float* i4 = ivx[s4];
            for (int k = 0; k <= M; k++)
                msv[k] = sv[k] * e2[k] + i3[k] * e3[k] + i4[k] * e4[k];
        } else {
            for (int k = 0; k <= M; k++) msv[k] = sv[k] * e2[k];
        }
        msv[0] = 0.f;
        float* ni = irow[curr];
        const float* m3 = mrow[prev3];
        const float* i3r = irow[prev3];
        for (int k = 0; k <= M; k++)
            ni[k] = m3[k] * tMI[k] + i3r[k] * tII[k];
        ni[0] = 0.f;
        float* dc = drow[curr];
        dc[0] = dc[1] = 0.f;
        for (int k = 2; k <= M; k++) dc[k] = msv[k - 1] * tMD[k];
        for (int k = 2; k <= M; k++) dc[k] += dc[k - 1] * tDD[k];
        float xE = np_pairwise_f32(msv + 1, M)
            + np_pairwise_f32(dc + 1, M);
        float xN, xJ, xC;
        if (i >= 3) {
            xN = xNb[prev3] * nloop;
            xJ = xJb[prev3] * jloop + xE * eloop;
            xC = xCb[prev3] * cloop + xE * emove;
        } else {
            xN = 1.0f;
            xJ = xE * eloop;
            xC = xE * emove;
        }
        float xB = xN * nmove + xJ * jmove;
        if (xE > 1.0e4f) {
            float inv = 1.0f / xE;
            xN *= inv; xJ *= inv; xC *= inv; xB *= inv;
            for (int64_t k = 0; k < 15 * W; k++) buf[k] *= inv;
            for (int r = 0; r < 4; r++) {
                xNb[r] *= inv; xBb[r] *= inv;
                xJb[r] *= inv; xCb[r] *= inv;
            }
            out_scales[i] = xE;
            xE = 1.0f;
        }
        xNb[curr] = xN; xBb[curr] = xB; xJb[curr] = xJ; xCb[curr] = xC;
    }
    float xctot = xCb[L % 4] + xCb[(L - 1) % 4] * cloop
        + xCb[(L - 2) % 4] * cloop;
    if (xctot != xctot || xctot - xctot != 0.0f) return 1;  // nan/inf
    if (L > 2 && xctot == 0.0f) return 1;
    *out_xctot = xctot * cmove;
    return 0;
}

// Frameshift 3-codon Forward parser, full-specials path — the score
// kernel above plus per-row specials stores (the parser PMatrix keeps
// only xE/xN/xJ/xB/xC + scale; ref: fwdback_fs.py forward_parser_fs3
// :204, impl_sse/fwdback_fs.c :97).  Same DP, same rescale schedule.
int bio_fs3_parser_fwd_fill(const int32_t* ci2, const int32_t* ci3,
                            const int32_t* ci4, int64_t L,
                            const float* rfv, int M,
                            const float* tBM, const float* tMM,
                            const float* tIM, const float* tDM,
                            const float* tMD, const float* tDD,
                            const float* tMI, const float* tII,
                            const float* xff,
                            float* xEv, float* xNv, float* xJv,
                            float* xBv, float* xCv,
                            float* out_scales, float* out_xctot) {
    const int W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < 16 * (int64_t)W) {
        delete[] buf;
        buf = new float[16 * W];
        cap = 16 * W;
    }
    float* mrow[4]; float* irow[4]; float* drow[4]; float* ivx[3];
    for (int r = 0; r < 4; r++) {
        mrow[r] = buf + r * W;
        irow[r] = buf + (4 + r) * W;
        drow[r] = buf + (8 + r) * W;
    }
    for (int r = 0; r < 3; r++) ivx[r] = buf + (12 + r) * W;
    for (int64_t k = 0; k < 15 * W; k++) buf[k] = 0.f;
    float xNb[4] = {1.f, 1.f, 0.f, 0.f};
    float xBb[4] = {nmove, nmove, 0.f, 0.f};
    float xJb[4] = {0.f, 0.f, 0.f, 0.f};
    float xCb[4] = {0.f, 0.f, 0.f, 0.f};
    if (L < 2) return 1;
    for (int64_t i = 0; i <= L; i++) {
        out_scales[i] = 1.0f;
        xEv[i] = xNv[i] = xJv[i] = xBv[i] = xCv[i] = 0.f;
    }
    xNv[0] = xNv[1] = 1.0f;
    xBv[0] = xBv[1] = nmove;

    for (int64_t i = 2; i <= L; i++) {
        int curr = (int)(i % 4), prev2 = (int)((i - 2) % 4),
            prev3 = (int)((i + 1) % 4);
        int s2 = (int)(i % 3), s3 = (int)((i - 1) % 3),
            s4 = (int)((i - 2) % 3);
        float* sv = ivx[s2];
        const float* mp = mrow[prev2];
        const float* ip = irow[prev2];
        const float* dp = drow[prev2];
        const float xB2 = xBb[prev2];
        sv[0] = 0.f;
        for (int k = 1; k <= M; k++)
            sv[k] = xB2 * tBM[k] + mp[k - 1] * tMM[k]
                + ip[k - 1] * tIM[k] + dp[k - 1] * tDM[k];
        const float* e2 = rfv + (int64_t)ci2[i - 1] * W;
        float* msv = mrow[curr];
        if (i >= 3) {
            const float* e3 = rfv + (int64_t)ci3[i - 1] * W;
            const float* e4 = rfv + (int64_t)ci4[i - 1] * W;
            const float* i3 = ivx[s3];
            const float* i4 = ivx[s4];
            for (int k = 0; k <= M; k++)
                msv[k] = sv[k] * e2[k] + i3[k] * e3[k] + i4[k] * e4[k];
        } else {
            for (int k = 0; k <= M; k++) msv[k] = sv[k] * e2[k];
        }
        msv[0] = 0.f;
        float* ni = irow[curr];
        const float* m3 = mrow[prev3];
        const float* i3r = irow[prev3];
        for (int k = 0; k <= M; k++)
            ni[k] = m3[k] * tMI[k] + i3r[k] * tII[k];
        ni[0] = 0.f;
        float* dc = drow[curr];
        dc[0] = dc[1] = 0.f;
        for (int k = 2; k <= M; k++) dc[k] = msv[k - 1] * tMD[k];
        for (int k = 2; k <= M; k++) dc[k] += dc[k - 1] * tDD[k];
        float xE = np_pairwise_f32(msv + 1, M)
            + np_pairwise_f32(dc + 1, M);
        float xN, xJ, xC;
        if (i >= 3) {
            xN = xNb[prev3] * nloop;
            xJ = xJb[prev3] * jloop + xE * eloop;
            xC = xCb[prev3] * cloop + xE * emove;
        } else {
            xN = 1.0f;
            xJ = xE * eloop;
            xC = xE * emove;
        }
        float xB = xN * nmove + xJ * jmove;
        if (xE > 1.0e4f) {
            float inv = 1.0f / xE;
            xN *= inv; xJ *= inv; xC *= inv; xB *= inv;
            for (int64_t k = 0; k < 15 * W; k++) buf[k] *= inv;
            for (int r = 0; r < 4; r++) {
                xNb[r] *= inv; xBb[r] *= inv;
                xJb[r] *= inv; xCb[r] *= inv;
            }
            out_scales[i] = xE;
            xE = 1.0f;
        }
        xNb[curr] = xN; xBb[curr] = xB; xJb[curr] = xJ; xCb[curr] = xC;
        xEv[i] = xE; xNv[i] = xN; xJv[i] = xJ;
        xBv[i] = xB; xCv[i] = xC;
    }
    float xctot = xCb[L % 4] + xCb[(L - 1) % 4] * cloop
        + xCb[(L - 2) % 4] * cloop;
    if (xctot != xctot || xctot - xctot != 0.0f) return 1;
    if (L > 2 && xctot == 0.0f) return 1;
    *out_xctot = xctot * cmove;
    return 0;
}

// Frameshift 3-codon Backward parser, full-specials path (ref:
// fwdback_fs.py backward_parser_fs3 :300, impl_sse/fwdback_fs.c
// p7_BackwardParser_Frameshift_3Codons :565).  Borrows the Forward's
// per-row scale factors, switching permanently to its own once
// xB > 1e16 (has_own_scales); *out_own reports the final flag.
void bio_fs3_parser_bwd_fill(const int32_t* ci2, const int32_t* ci3,
                             const int32_t* ci4, int64_t L,
                             const float* rfv, int M,
                             const float* tBM, const float* tMI,
                             const float* tII, const float* tMMk,
                             const float* tIMk, const float* tDMk,
                             const float* tMDk, const float* tDDk,
                             const float* xff, const float* fwd_scale,
                             float* xEv, float* xNv, float* xJv,
                             float* xBv, float* xCv,
                             float* out_scales, int32_t* out_own) {
    const int W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    // 6 M rows + 6 I rows ring, plus ivxb/iv1/prod scratch
    if (cap < 15 * (int64_t)W) {
        delete[] buf;
        buf = new float[15 * W];
        cap = 15 * W;
    }
    float* mrow[6]; float* irow[6];
    for (int r = 0; r < 6; r++) {
        mrow[r] = buf + r * W;
        irow[r] = buf + (6 + r) * W;
    }
    float* ivxb = buf + 12 * W;
    float* iv1 = buf + 13 * W;
    float* nd = buf + 14 * W;
    for (int64_t k = 0; k < 14 * W; k++) buf[k] = 0.f;
    float xNb[6] = {0, 0, 0, 0, 0, 0};
    float xBb[6] = {0, 0, 0, 0, 0, 0};
    float xJb[6] = {0, 0, 0, 0, 0, 0};
    float xCb[6] = {0, 0, 0, 0, 0, 0};
    int own = 0;
    for (int64_t i = 0; i <= L; i++) {
        out_scales[i] = 1.0f;
        xEv[i] = xNv[i] = xJv[i] = xBv[i] = xCv[i] = 0.f;
    }
    const int32_t* cis[5] = {0, 0, ci2, ci3, ci4};
    static thread_local float* nm_buf = nullptr;
    static thread_local int64_t nm_cap = 0;
    if (nm_cap < 2 * (int64_t)W) {
        delete[] nm_buf;
        nm_buf = new float[2 * W];
        nm_cap = 2 * W;
    }
    float* new_m = nm_buf;
    float* new_i = nm_buf + W;

    for (int64_t i = L; i >= 1; i--) {
        int curr = (int)(i % 6);
        for (int k = 0; k <= M; k++) ivxb[k] = 0.f;
        for (int c = 2; c <= 4; c++) {
            int64_t j = i + c;
            if (j <= L) {
                const float* e = rfv + (int64_t)cis[c][j - 1] * W;
                const float* bM = mrow[j % 6];
                for (int k = 0; k <= M; k++) ivxb[k] += e[k] * bM[k];
            }
        }
        float xC;
        if (i == L) xC = cmove;
        else if (i >= L - 2) xC = cloop * cmove;
        else xC = cloop * xCb[(i + 3) % 6];
        for (int k = 1; k <= M; k++) iv1[k - 1] = ivxb[k] * tBM[k];
        float xB = np_pairwise_f32(iv1, M);
        float xJ = ((i + 3 <= L) ? xJb[(i + 3) % 6] * jloop : 0.f)
            + xB * jmove;
        float xN = ((i + 3 <= L) ? xNb[(i + 3) % 6] * nloop : 0.f)
            + xB * nmove;
        float xE = xC * emove + xJ * eloop;

        for (int k = 0; k < M; k++) iv1[k] = ivxb[k + 1];
        iv1[M] = 0.f;
        const float* bI3 = (i + 3 <= L) ? irow[(i + 3) % 6] : 0;
        for (int k = 0; k <= M; k++) {
            float b3 = bI3 ? bI3[k] : 0.f;
            new_i[k] = tIMk[k] * iv1[k] + tII[k] * b3;
            new_m[k] = tMMk[k] * iv1[k] + tMI[k] * b3 + xE;
        }
        nd[M] = xE;
        for (int k = M - 1; k >= 1; k--)
            nd[k] = tDMk[k] * iv1[k] + tDDk[k] * nd[k + 1] + xE;
        nd[0] = 0.f;
        for (int k = 0; k < M; k++)
            new_m[k] = new_m[k] + tMDk[k] * nd[k + 1];
        new_m[0] = new_i[0] = 0.f;

        double sc = (double)fwd_scale[i];
        if (xB > 1.0e16f) own = 1;
        if (own) sc = (xB > 1.0e4f) ? (double)xB : 1.0;
        if (sc != 1.0) {
            float inv = (float)(1.0 / sc);
            for (int k = 0; k <= M; k++) {
                new_m[k] *= inv; new_i[k] *= inv; nd[k] *= inv;
            }
            for (int r = 0; r < 6; r++)
                for (int k = 0; k <= M; k++) {
                    mrow[r][k] *= inv; irow[r][k] *= inv;
                }
            for (int r = 0; r < 6; r++) {
                xNb[r] *= inv; xBb[r] *= inv;
                xJb[r] *= inv; xCb[r] *= inv;
            }
            xN *= inv; xB *= inv; xJ *= inv;
            xC *= inv; xE *= inv;
        }
        out_scales[i] = (float)sc;
        for (int k = 0; k <= M; k++) {
            mrow[curr][k] = new_m[k];
            irow[curr][k] = new_i[k];
        }
        xNb[curr] = xN; xBb[curr] = xB; xJb[curr] = xJ; xCb[curr] = xC;
        xEv[i] = xE; xNv[i] = xN; xJv[i] = xJ;
        xBv[i] = xB; xCv[i] = xC;
    }
    for (int64_t i = 0; i <= 2; i++) {
        for (int k = 0; k <= M; k++) ivxb[k] = 0.f;
        for (int c = 2; c <= 4; c++) {
            int64_t j = i + c;
            if (j >= 1 && j <= L) {
                const float* e = rfv + (int64_t)cis[c][j - 1] * W;
                const float* bM = mrow[j % 6];
                for (int k = 0; k <= M; k++) ivxb[k] += e[k] * bM[k];
            }
        }
        for (int k = 1; k <= M; k++) iv1[k - 1] = ivxb[k] * tBM[k];
        float xB = np_pairwise_f32(iv1, M);
        float xN = ((i + 3 <= L) ? xNb[(i + 3) % 6] : 0.f) * nloop
            + xB * nmove;
        xBv[i] = xB; xNv[i] = xN;
        out_scales[i] = 1.0f;
    }
    *out_own = own;
}

// Frameshift 5-codon full Forward, score path only — bit-exact
// transcription of fwdback_fs.py forward_fs5 :472 (ref:
// p7_Forward_Frameshift :2054): per-row sparse rescaling with
// cross-row insert adjustment; committed rows keep their own scale.
// Finish semantics as in bio_fs3_parser_score.
int bio_fs5_forward_score(const int32_t* ci1, const int32_t* ci2,
                          const int32_t* ci3, const int32_t* ci4,
                          const int32_t* ci5, int64_t L,
                          const float* rfv, int M,
                          const float* tBM, const float* tMM,
                          const float* tIM, const float* tDM,
                          const float* tMD, const float* tDD,
                          const float* tMI, const float* tII,
                          const float* xff, float* out_scales,
                          float* out_xctot) {
    const int W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* b5 = nullptr;
    static thread_local int64_t c5 = 0;
    // 4 mc0 + 4 im + 4 dm + 5 ivx + 1 msv + 1 ni = 19 rows
    if (c5 < 19 * (int64_t)W) {
        delete[] b5;
        b5 = new float[19 * W];
        c5 = 19 * W;
    }
    float* mr[4]; float* ir[4]; float* dr[4]; float* ivx[5];
    for (int r = 0; r < 4; r++) {
        mr[r] = b5 + r * W;
        ir[r] = b5 + (4 + r) * W;
        dr[r] = b5 + (8 + r) * W;
    }
    for (int r = 0; r < 5; r++) ivx[r] = b5 + (12 + r) * W;
    float* msv = b5 + 17 * W;
    float* ni = b5 + 18 * W;
    for (int64_t k = 0; k < 19 * W; k++) b5[k] = 0.f;
    float xNb[4] = {1.f, 1.f, 1.f, 0.f};
    float xBb[4] = {nmove, nmove, nmove, 0.f};
    float xJb[4] = {0.f, 0.f, 0.f, 0.f};
    float xCb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t i = 0; i <= L; i++) out_scales[i] = 1.0f;

    for (int64_t i = 1; i <= L; i++) {
        int curr = (int)(i % 4);
        int p1 = (int)((i + 3) % 4);          // (i-1) mod 4
        int p3 = (int)((i + 1) % 4);          // (i-3) mod 4
        int s1 = (int)(i % 5), s2 = (int)((i + 4) % 5),
            s3 = (int)((i + 3) % 5), s4 = (int)((i + 2) % 5),
            s5 = (int)((i + 1) % 5);
        const float* mp = mr[p1];
        const float* ip = ir[p1];
        const float* dp = dr[p1];
        float xB1 = xBb[p1];
        float* sv = ivx[s1];
        sv[0] = 0.f;
        for (int k = 1; k <= M; k++)
            sv[k] = xB1 * tBM[k] + mp[k - 1] * tMM[k]
                + ip[k - 1] * tIM[k] + dp[k - 1] * tDM[k];
        const float* e1 = rfv + (int64_t)ci1[i - 1] * W;
        const float* e2 = (i >= 2) ? rfv + (int64_t)ci2[i - 1] * W : 0;
        const float* e3 = (i >= 3) ? rfv + (int64_t)ci3[i - 1] * W : 0;
        const float* e4 = (i >= 4) ? rfv + (int64_t)ci4[i - 1] * W : 0;
        const float* e5 = (i >= 5) ? rfv + (int64_t)ci5[i - 1] * W : 0;
        const float* v2 = ivx[s2];
        const float* v3 = ivx[s3];
        const float* v4 = ivx[s4];
        const float* v5 = ivx[s5];
        for (int k = 0; k <= M; k++) {
            // msv = mcs1 + mcs2 + ... in the reference add order
            float m1 = sv[k] * e1[k];
            float m2 = (i >= 2) ? v2[k] * e2[k] : 0.f;
            float m3 = (i >= 3) ? v3[k] * e3[k] : 0.f;
            float m4 = (i >= 4) ? v4[k] * e4[k] : 0.f;
            float m5 = (i >= 5) ? v5[k] * e5[k] : 0.f;
            msv[k] = (((m1 + m2) + m3) + m4) + m5;
        }
        msv[0] = 0.f;
        if (i >= 3) {
            float adj = 1.0f
                / (out_scales[i - 2] * out_scales[i - 1]);
            const float* m3r = mr[p3];
            const float* i3r = ir[p3];
            for (int k = 0; k <= M; k++)
                ni[k] = (m3r[k] * adj) * tMI[k]
                    + (i3r[k] * adj) * tII[k];
        } else {
            for (int k = 0; k <= M; k++) ni[k] = 0.f;
        }
        ni[0] = 0.f;
        float* dc = dr[curr];
        dc[0] = dc[1] = 0.f;
        for (int k = 2; k <= M; k++) dc[k] = msv[k - 1] * tMD[k];
        for (int k = 2; k <= M; k++) dc[k] += dc[k - 1] * tDD[k];
        float xE = np_pairwise_f32(msv + 1, M)
            + np_pairwise_f32(dc + 1, M);
        float xN, xJ, xC;
        if (i >= 3) {
            xN = xNb[p3] * nloop;
            xJ = xJb[p3] * jloop + xE * eloop;
            xC = xCb[p3] * cloop + xE * emove;
        } else {
            xN = 1.0f;
            xJ = xE * eloop;
            xC = xE * emove;
        }
        float xB = xN * nmove + xJ * jmove;
        if (xE > 1.0e4f) {
            float inv = 1.0f / xE;
            for (int k = 0; k <= M; k++) {
                msv[k] *= inv; ni[k] *= inv; dc[k] *= inv;
            }
            for (int r = 0; r < 5; r++)
                for (int k = 0; k <= M; k++) ivx[r][k] *= inv;
            xN *= inv; xJ *= inv; xC *= inv; xB *= inv;
            for (int r = 0; r < 4; r++) {
                xNb[r] *= inv; xBb[r] *= inv;
                xJb[r] *= inv; xCb[r] *= inv;
            }
            out_scales[i] = xE;
            xE = 1.0f;
        }
        for (int k = 0; k <= M; k++) mr[curr][k] = msv[k];
        for (int k = 0; k <= M; k++) ir[curr][k] = ni[k];
        xNb[curr] = xN; xBb[curr] = xB; xJb[curr] = xJ; xCb[curr] = xC;
    }
    float xctot = xCb[L % 4] + xCb[(L - 1) % 4] * cloop
        + xCb[(L - 2) % 4] * cloop;
    if (xctot != xctot || xctot - xctot != 0.0f) return 1;
    if (L > 1 && xctot == 0.0f) return 1;
    *out_xctot = xctot * cmove;
    return 0;
}


// 2-state bias-filter HMM forward recurrence (ref: p7_bg_FilterScore
// via esl_hmm_Forward; numpy reference bath_tpu_torch/bg.py _hmm_forward).
// Exact f32 op order of the numpy loop; the per-step max rescales are
// returned so the caller can take numpy's own f32 logs (numpy's
// vectorized f32 log differs from libm logf by 1 ulp on ~12% of
// inputs, so logs stay on the Python side).
void bio_bg_hmm_forward(const int32_t* dsq, int64_t L,
                        const float* eo /*[Kp][2]*/,
                        const float* pi /*[2]*/,
                        const float* t /*[2][3]*/,
                        float* scales /*[L]*/, float* end_out) {
    if (L == 0) { *end_out = 1.0f; return; }
    float d0 = eo[dsq[0] * 2 + 0] * pi[0];
    float d1 = eo[dsq[0] * 2 + 1] * pi[1];
    float mx = d0 > d1 ? d0 : d1;
    d0 /= mx; d1 /= mx;
    scales[0] = mx;
    for (int64_t i = 1; i < L; i++) {
        const float* e = eo + dsq[i] * 2;
        float n0 = (d0 * t[0] + d1 * t[3]) * e[0];
        float n1 = (d0 * t[1] + d1 * t[4]) * e[1];
        mx = n0 > n1 ? n0 : n1;
        d0 = n0 / mx; d1 = n1 / mx;
        scales[i] = mx;
    }
    *end_out = d0 * t[2] + d1 * t[5];
}

// Cap the OpenMP team size (forked bathsearch workers divide the
// machine's cores among themselves; results are schedule-invariant).
void bio_set_threads(int n) { omp_set_num_threads(n); }

// Single-linkage components over sampled trace segments (ref:
// p7_spensemble_Cluster / esl_cluster_SingleLinkage; numpy reference
// ensemble.cluster_segments).  Same f64 division comparisons as the
// numpy predicate, pairwise union-find instead of six [n,n]
// matrices.  labels_out gets component ids numbered by first
// appearance (the BFS order of the numpy version).  Returns ncomp.
int64_t bio_cluster_components(const int64_t* iv, const int64_t* jv,
                               const int64_t* kv, const int64_t* mv,
                               int64_t n, double min_overlap,
                               int of_smaller, int64_t max_diagdiff,
                               int fs, int64_t* labels_out) {
    static thread_local int64_t* uf = nullptr;
    static thread_local int64_t ufcap = 0;
    if (ufcap < n) {
        delete[] uf;
        uf = new int64_t[n];
        ufcap = n;
    }
    for (int64_t a = 0; a < n; a++) uf[a] = a;
    auto find = [&](int64_t a) {
        while (uf[a] != a) {
            uf[a] = uf[uf[a]];
            a = uf[a];
        }
        return a;
    };
    for (int64_t a = 0; a < n; a++) {
        int64_t la = jv[a] - iv[a] + 1;
        int64_t lka = mv[a] - kv[a] + 1;
        int64_t d1a = fs ? iv[a] / 3 - kv[a] : iv[a] - kv[a];
        int64_t d2a = fs ? jv[a] / 3 - mv[a] : jv[a] - mv[a];
        int64_t ra = find(a);
        for (int64_t b = a + 1; b < n; b++) {
            int64_t rb = find(b);
            if (ra == rb) continue;
            int64_t lb = jv[b] - iv[b] + 1;
            double ns = (double)(of_smaller
                                 ? (la < lb ? la : lb)
                                 : (la > lb ? la : lb));
            if (!(ns > 0)) continue;
            double nov = (double)((jv[a] < jv[b] ? jv[a] : jv[b])
                                  - (iv[a] > iv[b] ? iv[a] : iv[b])
                                  + 1);
            if (nov / ns < min_overlap) continue;
            int64_t lkb = mv[b] - kv[b] + 1;
            double nk = (double)(of_smaller
                                 ? (lka < lkb ? lka : lkb)
                                 : (lka > lkb ? lka : lkb));
            if (!(nk > 0)) continue;
            double novk = (double)((mv[a] < mv[b] ? mv[a] : mv[b])
                                   - (kv[a] > kv[b] ? kv[a] : kv[b]));
            if (novk / nk < min_overlap) continue;
            int64_t d1b = fs ? iv[b] / 3 - kv[b] : iv[b] - kv[b];
            int64_t d2b = fs ? jv[b] / 3 - mv[b] : jv[b] - mv[b];
            int64_t e1 = d1a > d1b ? d1a - d1b : d1b - d1a;
            int64_t e2 = d2a > d2b ? d2a - d2b : d2b - d2a;
            if (e1 > max_diagdiff && e2 > max_diagdiff) continue;
            uf[rb] = ra;        // union (b's root under a's root)
        }
    }
    // label components by first-appearance order (matches the numpy
    // BFS that scans s0 ascending)
    int64_t ncomp = 0;
    for (int64_t a = 0; a < n; a++) labels_out[a] = -1;
    for (int64_t a = 0; a < n; a++) {
        int64_t r = find(a);
        if (labels_out[r] < 0) labels_out[r] = ncomp++;
        if (r != a) labels_out[a] = labels_out[r];
    }
    return ncomp;
}

// strict sequential f32 accumulation (bit-equal to the numpy loop's
// `acc += np.float32(x)`; numpy's own reductions are pairwise)
float bio_f32_seq_sum(const float* x, int64_t n) {
    float acc = 0.0f;
    for (int64_t i = 0; i < n; i++) acc += x[i];
    return acc;
}

// Batched bias-filter forward over the F1-surviving ORFs of a window
// (one OpenMP call instead of one Python->C transition per ORF).
// Per-ORF length model folded in: t00 = f32(L)/f32(L+1) (identical to
// numpy set_length), t01 = 1 - t00; t02 and row 1 of t are the
// set_filter constants.  scales go to scales_cat at out_offs[i] for
// the caller's single vectorized np.log.
void bio_bg_hmm_forward_batch(const int32_t* dsq_cat,
                              const int64_t* in_offs,
                              const int64_t* out_offs,
                              const int32_t* lens, int64_t n,
                              const float* eo, const float* pi,
                              float t02, const float* t_row1,
                              float* scales_cat, float* ends) {
#pragma omp parallel for schedule(dynamic, 32)
    for (int64_t i = 0; i < n; i++) {
        int64_t L = lens[i];
        float p1 = (float)L / (float)(L + 1);
        float t[6] = {p1, 1.0f - p1, t02,
                      t_row1[0], t_row1[1], t_row1[2]};
        bio_bg_hmm_forward(dsq_cat + in_offs[i], L, eo, pi, t,
                           scales_cat + out_offs[i], ends + i);
    }
}

// Per-ORF strict-sequential f32 sums over a concatenated buffer.
void bio_f32_seq_sum_batch(const float* x, const int64_t* offs,
                           const int32_t* lens, int64_t n,
                           float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++)
        out[i] = bio_f32_seq_sum(x + offs[i], lens[i]);
}


// ===================================================================
// Full-matrix fs5 envelope stages (ref: p7_Forward_Frameshift :2054,
// p7_Backward_Frameshift :2634, p7_Decoding_Frameshift :55,
// p7_OptimalAccuracy_Frameshift optacc_fs.c:53).  Bit-exact C fills
// of the numpy reference row loops in
// bath_tpu_torch/ops/reference/fwdback_fs.py (forward_fs5 :472,
// backward_fs5 :582, decoding_fs :696, optimal_accuracy_fs :765):
// identical f32 op order, numpy pairwise reductions; all np.log /
// np.exp stay on the Python side (numpy's transcendentals differ
// from libm by 1 ulp).
// ===================================================================

static double np_pairwise_f64(const double* a, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; i++) res += a[i];
        return res;
    } else if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; j++) r[j] = a[j];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; j++) r[j] += a[i + j];
        double res = ((r[0] + r[1]) + (r[2] + r[3]))
            + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) res += a[i];
        return res;
    } else {
        int64_t n2 = n / 2;
        n2 -= n2 % 8;
        return np_pairwise_f64(a, n2) + np_pairwise_f64(a + n2, n - n2);
    }
}

// mc is the 6-channel matrix [6][L+1][W]; im/dm [L+1][W]; the
// specials and scale are [L+1].  Returns 1 on over/underflow (the
// caller raises RangeError), else 0 and *out_xctot = xCtot * cmove.
int bio_fs5_forward_fill(const int32_t* ci1, const int32_t* ci2,
                         const int32_t* ci3, const int32_t* ci4,
                         const int32_t* ci5, int64_t L,
                         const float* rfv, int M,
                         const float* tBM, const float* tMM,
                         const float* tIM, const float* tDM,
                         const float* tMD, const float* tDD,
                         const float* tMI, const float* tII,
                         const float* xff,
                         float* mc, float* im, float* dm,
                         float* xEv, float* xNv, float* xJv,
                         float* xBv, float* xCv, float* scale,
                         float* out_xctot) {
    const int64_t W = M + 1;
    const int64_t RS = (L + 1) * W;          // channel stride in mc
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < 6 * W) {
        delete[] buf;
        buf = new float[6 * W];
        cap = 6 * W;
    }
    float* ivx[5];
    for (int r = 0; r < 5; r++) ivx[r] = buf + r * W;
    float* ni = buf + 5 * W;
    for (int64_t k = 0; k < 6 * W; k++) buf[k] = 0.f;
    // row 0 of every stored matrix is zero
    for (int c = 0; c < 6; c++)
        for (int64_t k = 0; k < W; k++) mc[c * RS + k] = 0.f;
    for (int64_t k = 0; k < W; k++) im[k] = dm[k] = 0.f;
    float xNb[4] = {1.f, 1.f, 1.f, 0.f};
    float xBb[4] = {nmove, nmove, nmove, 0.f};
    float xJb[4] = {0.f, 0.f, 0.f, 0.f};
    float xCb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t i = 0; i <= L; i++) {
        scale[i] = 1.0f;
        xEv[i] = xNv[i] = xJv[i] = xBv[i] = xCv[i] = 0.f;
    }
    for (int64_t r = 0; r <= (L < 2 ? L : 2); r++) {
        xNv[r] = 1.0f;
        xBv[r] = nmove;
    }

    for (int64_t i = 1; i <= L; i++) {
        int b3 = (int)((i + 1) % 4);          // (i-3) mod 4
        int s1 = (int)(i % 5), s2 = (int)((i + 4) % 5),
            s3 = (int)((i + 3) % 5), s4 = (int)((i + 2) % 5),
            s5 = (int)((i + 1) % 5);
        const float* mp = mc + (i - 1) * W;    // mc0[i-1]
        const float* ip = im + (i - 1) * W;
        const float* dp = dm + (i - 1) * W;
        float xB1 = xBv[i - 1];
        float* sv = ivx[s1];
        sv[0] = 0.f;
        for (int k = 1; k <= M; k++)
            sv[k] = xB1 * tBM[k] + mp[k - 1] * tMM[k]
                + ip[k - 1] * tIM[k] + dp[k - 1] * tDM[k];
        const float* e1 = rfv + (int64_t)ci1[i - 1] * W;
        const float* e2 = (i >= 2) ? rfv + (int64_t)ci2[i - 1] * W : 0;
        const float* e3 = (i >= 3) ? rfv + (int64_t)ci3[i - 1] * W : 0;
        const float* e4 = (i >= 4) ? rfv + (int64_t)ci4[i - 1] * W : 0;
        const float* e5 = (i >= 5) ? rfv + (int64_t)ci5[i - 1] * W : 0;
        float* m0 = mc + i * W;                // channel rows for row i
        float* m1 = mc + RS + i * W;
        float* m2 = mc + 2 * RS + i * W;
        float* m3 = mc + 3 * RS + i * W;
        float* m4 = mc + 4 * RS + i * W;
        float* m5 = mc + 5 * RS + i * W;
        const float* v2 = ivx[s2];
        const float* v3 = ivx[s3];
        const float* v4 = ivx[s4];
        const float* v5 = ivx[s5];
        for (int k = 0; k <= M; k++) {
            float c1v = sv[k] * e1[k];
            float c2v = (i >= 2) ? v2[k] * e2[k] : 0.f;
            float c3v = (i >= 3) ? v3[k] * e3[k] : 0.f;
            float c4v = (i >= 4) ? v4[k] * e4[k] : 0.f;
            float c5v = (i >= 5) ? v5[k] * e5[k] : 0.f;
            m1[k] = c1v; m2[k] = c2v; m3[k] = c3v;
            m4[k] = c4v; m5[k] = c5v;
            m0[k] = (((c1v + c2v) + c3v) + c4v) + c5v;
        }
        m0[0] = 0.f;
        if (i >= 3) {
            float adj = 1.0f / (scale[i - 2] * scale[i - 1]);
            const float* m3r = mc + (i - 3) * W;
            const float* i3r = im + (i - 3) * W;
            for (int k = 0; k <= M; k++)
                ni[k] = (m3r[k] * adj) * tMI[k]
                    + (i3r[k] * adj) * tII[k];
        } else {
            for (int k = 0; k <= M; k++) ni[k] = 0.f;
        }
        ni[0] = 0.f;
        float* dc = dm + i * W;
        dc[0] = dc[1] = 0.f;
        for (int k = 2; k <= M; k++) dc[k] = m0[k - 1] * tMD[k];
        for (int k = 2; k <= M; k++) dc[k] += dc[k - 1] * tDD[k];
        float xE = np_pairwise_f32(m0 + 1, M)
            + np_pairwise_f32(dc + 1, M);
        float xN, xJ, xC;
        if (i >= 3) {
            xN = xNb[b3] * nloop;
            xJ = xJb[b3] * jloop + xE * eloop;
            xC = xCb[b3] * cloop + xE * emove;
        } else {
            xN = 1.0f;
            xJ = xE * eloop;
            xC = xE * emove;
        }
        float xB = xN * nmove + xJ * jmove;
        if (xE > 1.0e4f) {
            float inv = 1.0f / xE;
            for (int k = 0; k <= M; k++) {
                m1[k] *= inv; m2[k] *= inv; m3[k] *= inv;
                m4[k] *= inv; m5[k] *= inv;
                m0[k] *= inv; ni[k] *= inv; dc[k] *= inv;
            }
            for (int r = 0; r < 5; r++)
                for (int k = 0; k <= M; k++) ivx[r][k] *= inv;
            xN *= inv; xJ *= inv; xC *= inv; xB *= inv;
            for (int r = 0; r < 4; r++) {
                xNb[r] *= inv; xBb[r] *= inv;
                xJb[r] *= inv; xCb[r] *= inv;
            }
            scale[i] = xE;
            xE = 1.0f;
        }
        float* imr = im + i * W;
        for (int k = 0; k <= M; k++) imr[k] = ni[k];
        int curr = (int)(i % 4);
        xNb[curr] = xN; xBb[curr] = xB; xJb[curr] = xJ; xCb[curr] = xC;
        xEv[i] = xE; xNv[i] = xN; xJv[i] = xJ;
        xBv[i] = xB; xCv[i] = xC;
    }
    float xctot = xCb[L % 4] + xCb[(L - 1) % 4] * cloop
        + xCb[(L - 2) % 4] * cloop;
    if (xctot != xctot || xctot - xctot != 0.0f) return 1;
    if (L > 1 && xctot == 0.0f) return 1;
    *out_xctot = xctot * cmove;
    return 0;
}

// Shifted transition vectors tMMk/tIMk/tDMk/tMDk/tDDk ([M+1], slot k
// = transition out of node k into k+1) are prepared by the caller.
void bio_fs5_backward_fill(const int32_t* ci1, const int32_t* ci2,
                           const int32_t* ci3, const int32_t* ci4,
                           const int32_t* ci5, int64_t L,
                           const float* rfv, int M,
                           const float* tBM, const float* tMI,
                           const float* tII, const float* tMMk,
                           const float* tIMk, const float* tDMk,
                           const float* tMDk, const float* tDDk,
                           const float* xff,
                           float* mm, float* im, float* dm,
                           float* xEv, float* xNv, float* xJv,
                           float* xBv, float* xCv, float* scale) {
    const int64_t W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < 4 * W) {
        delete[] buf;
        buf = new float[4 * W];
        cap = 4 * W;
    }
    float* ivxb = buf;
    float* iv1 = buf + W;
    float* prod = buf + 2 * W;
    float* bI3 = buf + 3 * W;
    for (int64_t i = 0; i <= L; i++) {
        scale[i] = 1.0f;
        xEv[i] = xNv[i] = xJv[i] = xBv[i] = xCv[i] = 0.f;
    }
    for (int64_t k = 0; k < (L + 1) * W; k++) mm[k] = im[k] = dm[k] = 0.f;
    const int32_t* cis[6] = {0, ci1, ci2, ci3, ci4, ci5};

    for (int64_t i = L; i >= 1; i--) {
        for (int k = 0; k <= M; k++) ivxb[k] = 0.f;
        for (int c = 1; c <= 5; c++) {
            int64_t j = i + c;
            if (j <= L) {
                float adj = 1.0f;
                for (int64_t r = i + 1; r < j; r++) adj /= scale[r];
                const float* e = rfv + (int64_t)cis[c][j - 1] * W;
                const float* bM = mm + j * W;
                for (int k = 0; k <= M; k++)
                    ivxb[k] += (e[k] * bM[k]) * adj;
            }
        }
        float xC;
        if (i >= L - 2) {
            xC = (i == L) ? cmove : cloop * cmove;
        } else {
            float adj = 1.0f;
            for (int64_t r = i + 1; r < i + 3; r++) adj /= scale[r];
            xC = cloop * xCv[i + 3] * adj;
        }
        for (int k = 1; k <= M; k++) prod[k - 1] = ivxb[k] * tBM[k];
        float xB = np_pairwise_f32(prod, M);
        float adj3 = 1.0f;
        if (i + 3 <= L)
            for (int64_t r = i + 1; r < i + 3; r++) adj3 /= scale[r];
        float xJ = ((i + 3 <= L) ? xJv[i + 3] * adj3 * jloop : 0.f)
            + xB * jmove;
        float xN = ((i + 3 <= L) ? xNv[i + 3] * adj3 * nloop : 0.f)
            + xB * nmove;
        float xE = xC * emove + xJ * eloop;

        for (int k = 0; k < M; k++) iv1[k] = ivxb[k + 1];
        iv1[M] = 0.f;
        if (i + 3 <= L) {
            const float* bi = im + (i + 3) * W;
            for (int k = 0; k <= M; k++) bI3[k] = bi[k] * adj3;
        } else {
            for (int k = 0; k <= M; k++) bI3[k] = 0.f;
        }
        float* new_i = im + i * W;
        float* new_m = mm + i * W;
        float* new_d = dm + i * W;
        for (int k = 0; k <= M; k++)
            new_i[k] = tIMk[k] * iv1[k] + tII[k] * bI3[k];
        for (int k = 0; k <= M; k++)
            new_m[k] = tMMk[k] * iv1[k] + tMI[k] * bI3[k] + xE;
        new_d[M] = xE;
        for (int k = M - 1; k >= 1; k--)
            new_d[k] = tDMk[k] * iv1[k] + tDDk[k] * new_d[k + 1] + xE;
        new_d[0] = 0.f;
        for (int k = 0; k < M; k++)
            new_m[k] = new_m[k] + tMDk[k] * new_d[k + 1];
        // k = M: dshift[M] = 0 -> new_m unchanged
        new_m[0] = new_i[0] = 0.f;

        float mmax = new_m[0];
        for (int k = 1; k <= M; k++)
            if (new_m[k] > mmax) mmax = new_m[k];
        float mx = mmax > xB ? mmax : xB;
        if (mx > 1.0e4f) {
            float sc = mx;
            float inv = 1.0f / sc;
            for (int k = 0; k <= M; k++) {
                new_m[k] *= inv; new_i[k] *= inv; new_d[k] *= inv;
            }
            xN *= inv; xB *= inv; xJ *= inv; xC *= inv; xE *= inv;
            scale[i] = sc;
        }
        xEv[i] = xE; xNv[i] = xN; xJv[i] = xJ;
        xBv[i] = xB; xCv[i] = xC;
    }
    // rows 2,1,0 (N-side)
    for (int64_t i = 2; i >= 0; i--) {
        for (int k = 0; k <= M; k++) ivxb[k] = 0.f;
        for (int c = 1; c <= 5; c++) {
            int64_t j = i + c;
            if (j >= 1 && j <= L) {
                float adj = 1.0f;
                for (int64_t r = i + 1; r < j; r++) adj /= scale[r];
                const float* e = rfv + (int64_t)cis[c][j - 1] * W;
                const float* bM = mm + j * W;
                for (int k = 0; k <= M; k++)
                    ivxb[k] += (e[k] * bM[k]) * adj;
            }
        }
        for (int k = 1; k <= M; k++) prod[k - 1] = ivxb[k] * tBM[k];
        float xB = np_pairwise_f32(prod, M);
        float adj3 = 1.0f;
        if (i + 3 <= L)
            for (int64_t r = i + 1; r < i + 3; r++) adj3 /= scale[r];
        float xN = ((i + 3 <= L) ? xNv[i + 3] * adj3 * nloop : 0.f)
            + xB * nmove;
        xBv[i] = xB; xNv[i] = xN;
        scale[i] = 1.0f;
    }
}

// Posterior decoding rows (the f64 factor/N/J/C arrays are prepared
// by the caller with numpy's exp/log semantics).
int bio_fs5_decoding_rows(int64_t L, int M,
                          const float* fmc, const float* fim,
                          const float* bmm, const float* bim,
                          const double* factor_mdi,
                          const double* npp, const double* jpp,
                          const double* cpp,
                          float* pmc, float* pim,
                          float* xNv, float* xJv, float* xCv) {
    const int64_t W = M + 1;
    const int64_t RS = (L + 1) * W;
    static thread_local double* dbuf = nullptr;
    static thread_local int64_t dcap = 0;
    static thread_local float* fbuf = nullptr;
    static thread_local int64_t fcap = 0;
    if (dcap < W) { delete[] dbuf; dbuf = new double[W]; dcap = W; }
    if (fcap < 7 * W) {
        delete[] fbuf;
        fbuf = new float[7 * W];
        fcap = 7 * W;
    }
    float* ppi = fbuf + 6 * W;
    for (int64_t i = 1; i <= L; i++) {
        const float* bM = bmm + i * W;
        const float* bI = bim + i * W;
        const float* fI = fim + i * W;
        for (int k = 0; k <= M; k++) ppi[k] = fI[k] * bI[k];
        for (int c = 0; c < 6; c++) {
            const float* f = fmc + c * RS + i * W;
            float* o = fbuf + c * W;
            for (int k = 0; k <= M; k++) o[k] = f[k] * bM[k];
        }
        for (int k = 1; k <= M; k++) dbuf[k - 1] = (double)fbuf[k];
        double raw = np_pairwise_f64(dbuf, M);
        for (int k = 1; k <= M; k++) dbuf[k - 1] = (double)ppi[k];
        raw += np_pairwise_f64(dbuf, M);
        double denom = raw * factor_mdi[i] + npp[i] + jpp[i] + cpp[i];
        if (!(denom > 0.0)) return 1;
        double dinv = 1.0 / denom;
        if (dinv == dinv + dinv && dinv != 0.0) return 1;  // inf check
        if (dinv * 0.0 != 0.0) return 1;
        float scv = (float)(factor_mdi[i] / denom);
        for (int c = 0; c < 6; c++) {
            const float* o = fbuf + c * W;
            float* p = pmc + c * RS + i * W;
            for (int k = 0; k <= M; k++) p[k] = o[k] * scv;
        }
        float* pI = pim + i * W;
        for (int k = 0; k <= M; k++) pI[k] = ppi[k] * scv;
        xNv[i] = (float)(npp[i] / denom);
        xJv[i] = (float)(jpp[i] / denom);
        xCv[i] = (float)(cpp[i] / denom);
    }
    return 0;
}

// Optimal-accuracy fill over the fs posterior matrix.
void bio_fs5_optacc_fill(int64_t L, int M,
                         const float* pmc, const float* pim,
                         const float* pxN, const float* pxJ,
                         const float* pxC,
                         const float* tBM, const float* tMM,
                         const float* tIM, const float* tDM,
                         const float* tMD, const float* tDD,
                         const float* tMI, const float* tII,
                         const float* xff,
                         float* mm, float* im, float* dm,
                         float* xEv, float* xNv, float* xJv,
                         float* xBv, float* xCv, float* out_ret) {
    const int64_t W = M + 1;
    const int64_t RS = (L + 1) * W;
    const float NEG = -1.0f / 0.0f;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    (void)jmove; (void)cmove;
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    static thread_local unsigned char* mk = nullptr;
    static thread_local int64_t mkcap = 0;
    if (cap < 2 * W) {
        delete[] buf;
        buf = new float[2 * W];
        cap = 2 * W;
    }
    if (mkcap < 8 * W) {
        delete[] mk;
        mk = new unsigned char[8 * W];
        mkcap = 8 * W;
    }
    float* sv = buf;
    float* acc = buf + W;
    unsigned char* mBM = mk;
    unsigned char* mMM = mk + W;
    unsigned char* mIM = mk + 2 * W;
    unsigned char* mDM = mk + 3 * W;
    unsigned char* mMD = mk + 4 * W;
    unsigned char* mDD = mk + 5 * W;
    unsigned char* mMI = mk + 6 * W;
    unsigned char* mII = mk + 7 * W;
    int allBM = 1, allMM = 1, allIM = 1, allDM = 1, allMD = 1,
        allDD2 = 1, allMI = 1, allII = 1;
    for (int k = 0; k <= M; k++) {
        mBM[k] = tBM[k] > 0.f; allBM &= mBM[k];
        mMM[k] = tMM[k] > 0.f; allMM &= mMM[k];
        mIM[k] = tIM[k] > 0.f; allIM &= mIM[k];
        mDM[k] = tDM[k] > 0.f; allDM &= mDM[k];
        mMD[k] = tMD[k] > 0.f; allMD &= mMD[k];
        mDD[k] = tDD[k] > 0.f;
        if (k >= 2) allDD2 &= mDD[k];
        mMI[k] = tMI[k] > 0.f; allMI &= mMI[k];
        mII[k] = tII[k] > 0.f; allII &= mII[k];
    }
    for (int64_t i = 0; i <= L; i++) {
        xEv[i] = NEG; xJv[i] = NEG; xCv[i] = NEG;
        xNv[i] = 0.f; xBv[i] = 0.f;
    }
    for (int64_t k = 0; k < (L + 1) * W; k++) mm[k] = im[k] = dm[k] = NEG;
    xNv[0] = 0.f;
    xBv[0] = 0.f;

    for (int64_t i = 1; i <= L; i++) {
        float* out_m = mm + i * W;
        for (int c = 1; c <= 5; c++) {
            int64_t j = i - c;
            const float* pc = pmc + c * RS + i * W;
            const float *mp = 0, *ipr = 0, *dp = 0;
            float xBj = NEG;
            if (j >= 0) {
                mp = mm + j * W;
                ipr = im + j * W;
                dp = dm + j * W;
                xBj = xBv[j];
            }
            for (int k = 0; k <= M; k++) {
                float mpk = (j >= 0) ? (k >= 1 ? mp[k - 1] : NEG) : NEG;
                float ipk = (j >= 0) ? (k >= 1 ? ipr[k - 1] : NEG) : NEG;
                float dpk = (j >= 0) ? (k >= 1 ? dp[k - 1] : NEG) : NEG;
                float s = allBM ? xBj : (mBM[k] ? xBj : 0.f);
                float v = allMM ? mpk : (mMM[k] ? mpk : 0.f);
                if (v > s) s = v;
                v = allIM ? ipk : (mIM[k] ? ipk : 0.f);
                if (v > s) s = v;
                v = allDM ? dpk : (mDM[k] ? dpk : 0.f);
                if (v > s) s = v;
                s = s + pc[k];
                if (c == 1) sv[k] = s;
                else if (s > sv[k]) sv[k] = s;
            }
        }
        sv[0] = NEG;
        for (int k = 0; k <= M; k++) out_m[k] = sv[k];
        int64_t j3 = (i >= 3) ? i - 3 : 0;
        const float* mj3 = mm + j3 * W;
        const float* ij3 = im + j3 * W;
        const float* pI = pim + i * W;
        float* out_i = im + i * W;
        for (int k = 0; k <= M; k++) {
            float a = allMI ? mj3[k] : (mMI[k] ? mj3[k] : 0.f);
            float b = allII ? ij3[k] : (mII[k] ? ij3[k] : 0.f);
            float v = a > b ? a : b;
            out_i[k] = v + pI[k];
        }
        out_i[0] = NEG;
        out_i[M] = NEG;
        float* dv = dm + i * W;
        dv[0] = dv[1] = NEG;
        for (int k = 2; k <= M; k++) {
            float s = sv[k - 1];
            dv[k] = allMD ? s : (mMD[k] ? s : 0.f);
        }
        if (allDD2) {
            for (int k = 3; k <= M; k++)
                if (dv[k - 1] > dv[k]) dv[k] = dv[k - 1];
        } else {
            for (int k = 2; k <= M; k++) {
                float g = mDD[k] ? dv[k - 1] : 0.f;
                if (g > dv[k]) dv[k] = g;
            }
        }
        float smax = NEG, dmax = NEG;
        for (int k = 1; k <= M; k++) {
            if (sv[k] > smax) smax = sv[k];
            if (dv[k] > dmax) dmax = dv[k];
        }
        float xE = smax > dmax ? smax : dmax;
        xEv[i] = xE;
        float xN, xJ, xC;
        if (i > 2) {
            xN = (nloop == 0.f) ? 0.f : xNv[i - 3] + pxN[i];
            float t1 = (jloop == 0.f) ? 0.f : xJv[i - 3] + pxJ[i];
            float t2 = (eloop == 0.f) ? 0.f : xE;
            xJ = t1 > t2 ? t1 : t2;
            t1 = (cloop == 0.f) ? 0.f : xCv[i - 3] + pxC[i];
            t2 = (emove == 0.f) ? 0.f : xE;
            xC = t1 > t2 ? t1 : t2;
        } else {
            xN = (nloop == 0.f) ? 0.f : pxN[i];
            xJ = (eloop == 0.f) ? 0.f : xE;
            xC = (emove == 0.f) ? 0.f : xE;
        }
        xNv[i] = xN; xJv[i] = xJ; xCv[i] = xC;
        float t1 = (nmove == 0.f) ? 0.f : xN;
        float t2 = (xff[3] == 0.f) ? 0.f : xJ;
        xBv[i] = t1 > t2 ? t1 : t2;
    }
    *out_ret = (xCv[L] + xCv[L - 1]) + xCv[L - 2];
}

// Frameshift domain decoding: btot/etot/mocc arrays from the fs3
// parser Forward/Backward specials (ref: decoding_fs.c
// p7_DomainDecoding_Frameshift :242; bit-exact transcription of
// fwdback_fs.py domain_decoding_fs — f32 pair products promoted to
// f64 against exp(), per-step f32 rounding of the stride-3 chains).
void bio_fs_domain_decoding(int64_t L,
    const float* fscale, const float* bscale,
    const float* fxB, const float* fxE, const float* fxN,
    const float* fxJ, const float* fxC,
    const float* bxB, const float* bxE, const float* bxN,
    const float* bxJ, const float* bxC,
    float nloop, float jloop, float cloop,
    double log_inv_Z,
    float* btot, float* etot, float* mocc) {
    double* lsf = new double[L + 2];
    double* lsb = new double[L + 2];
    lsf[0] = log((double)fscale[0]);
    for (int64_t i = 1; i <= L; i++)
        lsf[i] = lsf[i - 1] + log((double)fscale[i]);
    lsb[L + 1] = 0.0;
    for (int64_t i = L; i >= 0; i--)
        lsb[i] = lsb[i + 1] + log((double)bscale[i]);
    for (int64_t i = 0; i <= L; i++) btot[i] = etot[i] = mocc[i] = 0.f;
    for (int64_t i = 3; i <= L; i++) {
        btot[i] = (float)((double)btot[i - 3]
            + (double)(fxB[i - 3] * bxB[i - 3])
            * exp(lsf[i - 3] + lsb[i - 3] + log_inv_Z));
        etot[i] = (float)((double)etot[i - 3]
            + (double)(fxE[i] * bxE[i])
            * exp(lsf[i] + lsb[i] + log_inv_Z));
        double njcp = 0.0;
        const int64_t los[3] = {i - 3, i - 2, i - 1};
        const int64_t his[3] = {i, i + 1, i + 2};
        for (int t = 0; t < 3; t++) {
            int64_t lo = los[t], hi = his[t];
            if (hi > L) continue;
            double f = exp(lsf[lo] + lsb[hi] + log_inv_Z);
            njcp += (double)(fxN[lo] * bxN[hi] * nloop) * f;
            njcp += (double)(fxJ[lo] * bxJ[hi] * jloop) * f;
            njcp += (double)(fxC[lo] * bxC[hi] * cloop) * f;
        }
        mocc[i] = 1.0f - (float)njcp;
    }
    delete[] lsf;
    delete[] lsb;
}

// ---------------------------------------------------------------------
// Frameshift 5-codon stochastic traceback (ref: stotrace_fs.c
// p7_StochasticTrace_Frameshift :72; bit-exact transcription of
// ensemble.stochastic_trace_fs5 including the MT19937 stream and the
// f32-accumulated total in the E-state choose).
// ---------------------------------------------------------------------
static uint32_t bio_mt_u32(uint32_t* mt, int32_t* mti) {
    if (*mti >= 624) {
        for (int i = 0; i < 624; i++) {
            uint32_t y = (mt[i] & 0x80000000u)
                | (mt[(i + 1) % 624] & 0x7fffffffu);
            mt[i] = mt[(i + 397) % 624] ^ (y >> 1)
                ^ ((y & 1u) ? 0x9908b0dfu : 0u);
        }
        *mti = 0;
    }
    uint32_t y = mt[(*mti)++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
}

static double bio_mt_rand(uint32_t* mt, int32_t* mti) {
    return bio_mt_u32(mt, mti) / 4294967296.0;
}

// choose over double weights (Python-float tuples: f64 sum + scan)
static int bio_choose_d(uint32_t* mt, int32_t* mti,
                        const double* w, int n) {
    double tot = 0.0;
    for (int a = 0; a < n; a++) tot += w[a];
    if (tot <= 0.0) return 0;
    double roll = bio_mt_rand(mt, mti) * tot;
    double s = 0.0;
    for (int a = 0; a < n; a++) {
        s += w[a];
        if (roll < s) return a;
    }
    return n - 1;
}

// choose over the E-state's concatenated f32 rows: the total
// accumulates in f32 (Python sum() over a float32 ndarray), the scan
// in f64
static int bio_choose_e(uint32_t* mt, int32_t* mti,
                        const float* w1, const float* w2, int n) {
    float tot32 = 0.f;
    for (int a = 0; a < n; a++) tot32 += w1[a];
    for (int a = 0; a < n; a++) tot32 += w2[a];
    double tot = (double)tot32;
    if (tot <= 0.0) return 0;
    double roll = bio_mt_rand(mt, mti) * tot;
    double s = 0.0;
    for (int a = 0; a < n; a++) {
        s += (double)w1[a];
        if (roll < s) return a;
    }
    for (int a = 0; a < n; a++) {
        s += (double)w2[a];
        if (roll < s) return n + a;
    }
    return 2 * n - 1;
}

// codon-length choice: 5 Python-float weights mc[1..5][i][k]
static int bio_choose_c(uint32_t* mt, int32_t* mti, const float* mc,
                        int64_t stride_c, int64_t row_off) {
    double w[5];
    for (int cc = 1; cc <= 5; cc++)
        w[cc - 1] = (double)mc[cc * stride_c + row_off];
    return 1 + bio_choose_d(mt, mti, w, 5);
}

int64_t bio_fs5_stotrace(int64_t L, int M,
    const float* mc, const float* im, const float* dm,
    const float* xB, const float* xC, const float* xE,
    const float* xN, const float* xJ, const float* scale,
    const float* tBM, const float* tMM, const float* tIM,
    const float* tDM, const float* tMD, const float* tDD,
    const float* tMI, const float* tII,
    const float* xff,
    uint32_t* mt, int32_t* mti_io,
    int32_t* o_st, int32_t* o_k, int32_t* o_i, int32_t* o_c,
    int64_t max_out) {
    // state codes match bath_tpu_torch.constants (T_M..T_T)
    enum { T_M = 1, T_D = 2, T_I = 3, T_S = 4, T_N = 5, T_B = 6,
           T_E = 7, T_C = 8, T_T = 9, T_J = 10, T_X = 11 };
    const double nloop = (double)xff[0], nmove = (double)xff[1];
    const double jloop = (double)xff[2], jmove = (double)xff[3];
    const double cloop = (double)xff[4];
    const double eloop = (double)xff[6], emove = (double)xff[7];
    const int W = M + 1;
    const int64_t stride_c = (int64_t)(L + 1) * W;
    int32_t mti = *mti_io;
    int64_t n = 0;
#define EMIT(S, K, I, Cc) do { \
    if (n >= max_out) return -1; \
    o_st[n] = (S); o_k[n] = (K); o_i[n] = (I); o_c[n] = (Cc); n++; \
} while (0)

    EMIT(T_T, 0, 0, 0);
    double wterm[3];
    wterm[0] = (double)xC[L];
    wterm[1] = (L >= 1) ? (double)xC[L - 1] * cloop / (double)scale[L]
                        : 0.0;
    wterm[2] = (L >= 2) ? (double)xC[L - 2] * cloop
        / ((double)scale[L] * (double)scale[L - 1]) : 0.0;
    int64_t i = L - bio_choose_d(mt, &mti, wterm, 3);
    EMIT(T_C, 0, (int32_t)i, 0);
    int k = 0, c = 0;
    int st = T_C, nxt = T_C;
    while (st != T_S) {
        if (st == T_C) {
            double w[2];
            if (i >= 3) {
                double adj = (double)scale[i] * (double)scale[i - 1]
                    * (double)scale[i - 2];
                w[0] = (double)xC[i - 3] * cloop / adj;
            } else w[0] = 0.0;
            w[1] = (double)xE[i] * emove;
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_C : T_E;
            if (nxt == T_C) i -= 3;
        } else if (st == T_E) {
            const float* m0 = mc + 0 * stride_c + i * W + 1;
            const float* d0 = dm + i * W + 1;
            int sel = bio_choose_e(mt, &mti, m0, d0, M);
            if (sel < M) {
                k = sel + 1;
                c = bio_choose_c(mt, &mti, mc, stride_c, i * W + k);
                nxt = T_M;
            } else { nxt = T_D; k = sel - M + 1; c = 0; }
        } else if (st == T_M) {
            int64_t ip = i - c;
            double w[4];
            w[0] = (double)xB[ip] * (double)tBM[k];
            w[1] = (double)mc[0 * stride_c + ip * W + k - 1]
                * (double)tMM[k];
            w[2] = (double)im[ip * W + k - 1] * (double)tIM[k];
            w[3] = (double)dm[ip * W + k - 1] * (double)tDM[k];
            static const int nxts[4] = { T_B, T_M, T_I, T_D };
            nxt = nxts[bio_choose_d(mt, &mti, w, 4)];
            i = ip;
            k -= 1;
            if (nxt == T_M)
                c = bio_choose_c(mt, &mti, mc, stride_c, i * W + k);
        } else if (st == T_D) {
            double w[2];
            w[0] = (double)mc[0 * stride_c + i * W + k - 1]
                * (double)tMD[k];
            w[1] = (double)dm[i * W + k - 1] * (double)tDD[k];
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_M : T_D;
            k -= 1;
            if (nxt == T_M)
                c = bio_choose_c(mt, &mti, mc, stride_c, i * W + k);
        } else if (st == T_I) {
            double w[2];
            w[0] = (double)mc[0 * stride_c + (i - 3) * W + k]
                * (double)tMI[k];
            w[1] = (double)im[(i - 3) * W + k] * (double)tII[k];
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_M : T_I;
            i -= 3;
            if (nxt == T_M)
                c = bio_choose_c(mt, &mti, mc, stride_c, i * W + k);
        } else if (st == T_B) {
            double w[2];
            w[0] = (double)xN[i] * nmove;
            w[1] = (double)xJ[i] * jmove;
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_N : T_J;
        } else if (st == T_J) {
            double w[2];
            if (i >= 3) {
                double adj = (double)scale[i] * (double)scale[i - 1]
                    * (double)scale[i - 2];
                w[0] = (double)xJ[i - 3] * jloop / adj;
            } else w[0] = 0.0;
            w[1] = (double)xE[i] * eloop;
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_J : T_E;
            if (nxt == T_J) i -= 3;
        } else if (st == T_N) {
            nxt = (i <= 2) ? T_S : T_N;
            if (nxt == T_N) i -= 3;
        } else {
            return -2;      // bogus state
        }
        if (nxt == T_M) EMIT(T_M, k, (int32_t)i, c);
        else if (nxt == T_I) EMIT(T_I, k, (int32_t)i, 3);
        else if (nxt == T_D) EMIT(T_D, k, 0, 0);
        else EMIT(nxt, 0, (nxt == T_S) ? 0 : (int32_t)i, 0);
        st = nxt;
    }
#undef EMIT
    *mti_io = mti;
    return n;
}

// p7_Builder_MaxLength emitted-length DP (ref: p7_builder.c :572;
// numpy reference hmm.set_max_length) — exact f64 transcription,
// same accumulation order.  t: [M+1][7] doubles in H_MM..H_DD slot
// order.  Returns the max_length.
int64_t bio_hmm_max_length(const double* t, int M, int64_t bound,
                           double emit_thresh) {
    enum { H_MM = 0, H_MI = 1, H_MD = 2, H_IM = 3, H_II = 4,
           H_DM = 5, H_DD = 6 };
    const int W = M + 1;
    double* Mv = new double[2 * W]();
    double* Iv = new double[2 * W]();
    double* Dv = new double[2 * W]();
#define AT(a, k, c) a[(k) * 2 + (c)]
    AT(Mv, 1, 0) = 1.0;
    if (M >= 2) AT(Dv, 2, 0) = t[1 * 7 + H_MD];
    for (int k = 3; k <= M; k++)
        AT(Dv, k, 0) = t[(k - 1) * 7 + H_DD] * AT(Dv, k - 1, 0);
    AT(Iv, 1, 1) = t[1 * 7 + H_MI] * AT(Mv, 1, 0);
    if (M >= 2) AT(Mv, 2, 1) = t[1 * 7 + H_MM] * AT(Mv, 1, 0);
    for (int k = 3; k <= M; k++) {
        AT(Mv, k, 1) = t[(k - 1) * 7 + H_DM] * AT(Dv, k - 1, 0);
        AT(Dv, k, 1) = t[(k - 1) * 7 + H_MD] * AT(Mv, k - 1, 1)
            + t[(k - 1) * 7 + H_DD] * AT(Dv, k - 1, 1);
    }
    double p_sum = AT(Mv, M, 0) + AT(Mv, M, 1) + AT(Dv, M, 0)
        + AT(Dv, M, 1);
    int64_t result = bound;
    int cp = 0;
    for (int64_t col = 3; col <= bound; col++) {
        int pp = 1 - cp;
        double surv = 0.0;
        AT(Mv, 1, cp) = AT(Dv, 1, cp) = 0.0;
        AT(Iv, 1, cp) = t[1 * 7 + H_II] * AT(Iv, 1, pp);
        surv += AT(Iv, 1, cp);
        for (int k = 2; k <= M; k++) {
            AT(Mv, k, cp) = t[(k - 1) * 7 + H_MM] * AT(Mv, k - 1, pp)
                + t[(k - 1) * 7 + H_DM] * AT(Dv, k - 1, pp)
                + t[(k - 1) * 7 + H_IM] * AT(Iv, k - 1, pp);
            AT(Iv, k, cp) = t[k * 7 + H_MI] * AT(Mv, k, pp)
                + t[k * 7 + H_II] * AT(Iv, k, pp);
            AT(Dv, k, cp) = t[(k - 1) * 7 + H_MD] * AT(Mv, k - 1, cp)
                + t[(k - 1) * 7 + H_DD] * AT(Dv, k - 1, cp);
            surv += AT(Iv, k, cp)
                + AT(Mv, k, cp) * (1 - t[k * 7 + H_MD])
                + AT(Dv, k, cp) * (1 - t[k * 7 + H_DD]);
        }
        surv += AT(Mv, M, cp) * t[M * 7 + H_MD]
            + AT(Dv, M, cp) * t[M * 7 + H_DD] - AT(Iv, M, cp);
        p_sum += AT(Mv, M, cp) + AT(Dv, M, cp);
        surv /= surv + p_sum;
        if (surv < emit_thresh) {
            result = col;
            break;
        }
        cp = pp;
    }
#undef AT
    delete[] Mv; delete[] Iv; delete[] Dv;
    return result;
}

// Calibration DNA emission: L iid aminos from cumulative f (pass 1,
// esl_rsq_xfIID draw order), then a random synonymous codon per
// amino (pass 2, esl_rnd_Roll) — the exact two-pass MT19937 draw
// order of evalues.fs_tau's sample_iid + reverse_translate.
// codon_flat: concatenated [cnt_a][3] nt triples per amino;
// codon_off[a] start (in triples); codon_cnt[a] count.
// Returns 0, or -1 if an amino has no codons.
int bio_sample_dna(const double* cum, int K,
                   const int32_t* codon_flat, const int32_t* codon_off,
                   const int32_t* codon_cnt, int64_t L,
                   uint32_t* mt, int32_t* mti_io, int32_t* out) {
    int32_t mti = *mti_io;
    static thread_local int32_t* am = nullptr;
    static thread_local int64_t amcap = 0;
    if (amcap < L) {
        delete[] am;
        am = new int32_t[L];
        amcap = L;
    }
    for (int64_t i = 0; i < L; i++) {
        double u = bio_mt_rand(mt, &mti);
        int j = 0;
        while (j < K - 1 && !(cum[j] > u)) j++;
        am[i] = j;
    }
    for (int64_t i = 0; i < L; i++) {
        int a = am[i];
        int n = codon_cnt[a];
        if (n <= 0) return -1;
        int64_t pick = (int64_t)(bio_mt_rand(mt, &mti) * n);
        const int32_t* c = codon_flat + 3 * (codon_off[a] + pick);
        out[3 * i] = c[0];
        out[3 * i + 1] = c[1];
        out[3 * i + 2] = c[2];
    }
    *mti_io = mti;
    return 0;
}

// esl_rsq_xfIID: L iid draws from the cumulative distribution (the
// searchsorted-right + clip semantics of rng.sample_iid).
void bio_sample_iid(const double* cum, int K, int64_t L,
                    uint32_t* mt, int32_t* mti_io, int32_t* out) {
    int32_t mti = *mti_io;
    for (int64_t i = 0; i < L; i++) {
        double u = bio_mt_rand(mt, &mti);
        int j = 0;
        while (j < K - 1 && !(cum[j] > u)) j++;
        out[i] = j;
    }
    *mti_io = mti;
}

// Sampled fs5 trace reduced directly to its domain table (ref:
// p7_trace_Index semantics over the sampled path; the ensemble only
// consumes sq/hmm domain coordinates, so the per-trace Python list
// round trip is skipped).  dom_out: [ndom][4] = sqfrom, sqto,
// hmmfrom, hmmto.  Returns ndom, or -1 on sampler overflow/error
// (RNG state untouched by the caller contract of bio_fs5_stotrace).
int64_t bio_fs5_stotrace_domains(int64_t L, int M,
    const float* mc, const float* im, const float* dm,
    const float* xB, const float* xC, const float* xE,
    const float* xN, const float* xJ, const float* scale,
    const float* tBM, const float* tMM, const float* tIM,
    const float* tDM, const float* tMD, const float* tDD,
    const float* tMI, const float* tII,
    const float* xff,
    uint32_t* mt, int32_t* mti_io,
    int64_t* dom_out, int64_t max_dom) {
    enum { T_M = 1, T_B = 6, T_E = 7 };
    static thread_local int32_t* buf = nullptr;
    static thread_local int64_t cap = 0;
    int64_t need = 2 * (L + 8);
    if (cap < need) {
        delete[] buf;
        buf = new int32_t[4 * need];
        cap = need;
    }
    int32_t* st = buf;
    int32_t* kk = buf + cap;
    int32_t* ii = buf + 2 * cap;
    int32_t* cc = buf + 3 * cap;
    int64_t n = bio_fs5_stotrace(L, M, mc, im, dm, xB, xC, xE, xN,
                                 xJ, scale, tBM, tMM, tIM, tDM, tMD,
                                 tDD, tMI, tII, xff, mt, mti_io,
                                 st, kk, ii, cc, cap);
    if (n < 0) return -1;
    // arrays are emitted in traceback (reverse) order; forward index
    // z maps to array slot n-1-z.  Mirrors Trace.index().
    int64_t ndom = 0;
    int64_t z = 0;
    while (z < n) {
        if (st[n - 1 - z] == T_B) {
            int64_t sqfrom = 0, sqto = 0, hmmfrom = 0, hmmto = 0;
            int64_t zz = z + 1;
            while (zz < n && st[n - 1 - zz] != T_E) {
                int64_t s = n - 1 - zz;
                if (st[s] == T_M) {
                    if (sqfrom == 0) {
                        int64_t cm1 = cc[s] - 1;
                        sqfrom = ii[s] - (cm1 > 0 ? cm1 : 0);
                        hmmfrom = kk[s];
                    }
                    sqto = ii[s];
                    hmmto = kk[s];
                }
                zz++;
            }
            if (ndom >= max_dom) return -1;
            dom_out[4 * ndom + 0] = sqfrom;
            dom_out[4 * ndom + 1] = sqto;
            dom_out[4 * ndom + 2] = hmmfrom;
            dom_out[4 * ndom + 3] = hmmto;
            ndom++;
            z = zz;
        }
        z++;
    }
    return ndom;
}

// Standard (amino) Forward full fill — bit-exact transcription of
// fwdback.py forward(full=True, fast=False) (ref: fwdback.c
// forward_engine): f32 elementwise row ops, sequential DD closure,
// numpy-pairwise row sums, sparse rescale at xE > 1e4 (specials
// divided, rows multiplied by the reciprocal).
int bio_fwd_fill(const int32_t* dsq, int64_t L, const float* rfv,
                 int M, int full,
                 const float* tBM, const float* tMM, const float* tIM,
                 const float* tDM, const float* tMD, const float* tDD,
                 const float* tMI, const float* tII,
                 const float* xff,
                 float* mmat, float* imat, float* dmat,
                 float* xEv, float* xNv, float* xJv, float* xBv,
                 float* xCv, float* scales, double* out_sc) {
    const int W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < 4 * (int64_t)W) {
        delete[] buf;
        buf = new float[4 * W];
        cap = 4 * W;
    }
    float* mc = buf;
    float* ic = buf + W;
    float* dc = buf + 2 * W;
    float* sv = buf + 3 * W;
    for (int k = 0; k <= M; k++) mc[k] = ic[k] = dc[k] = 0.f;
    float xN = 1.0f, xB = nmove, xE = 0.f, xJ = 0.f, xC = 0.f;
    for (int64_t i = 0; i <= L; i++) {
        scales[i] = 1.0f;
        xEv[i] = xNv[i] = xJv[i] = xBv[i] = xCv[i] = 0.f;
        if (full)
            for (int k = 0; k <= M; k++) {
                mmat[i * W + k] = imat[i * W + k]
                    = dmat[i * W + k] = 0.f;
            }
    }
    xNv[0] = xN; xBv[0] = xB;
    double totscale = 0.0;
    for (int64_t i = 1; i <= L; i++) {
        const float* row = rfv + (int64_t)dsq[i - 1] * W;
        sv[0] = 0.f;
        for (int k = 1; k <= M; k++) {
            float mpv = mc[k - 1], ipv = ic[k - 1], dpv = dc[k - 1];
            sv[k] = (((xB * tBM[k] + mpv * tMM[k]) + ipv * tIM[k])
                     + dpv * tDM[k]) * row[k];
        }
        for (int k = 0; k <= M; k++) {
            float ni = mc[k] * tMI[k] + ic[k] * tII[k];
            ic[k] = ni;
        }
        ic[0] = 0.f;
        dc[0] = dc[1] = 0.f;
        for (int k = 2; k <= M; k++) dc[k] = sv[k - 1] * tMD[k];
        for (int k = 2; k <= M; k++) dc[k] += dc[k - 1] * tDD[k];
        for (int k = 0; k <= M; k++) mc[k] = sv[k];
        xE = np_pairwise_f32(mc + 1, M) + np_pairwise_f32(dc + 1, M);
        xN = xN * nloop;
        xC = xC * cloop + xE * emove;
        xJ = xJ * jloop + xE * eloop;
        xB = xJ * jmove + xN * nmove;
        if (xE > 1.0e4f) {
            float sc = xE;
            xN /= sc; xC /= sc; xJ /= sc; xB /= sc;
            float inv = 1.0f / sc;
            for (int k = 0; k <= M; k++) {
                mc[k] *= inv; ic[k] *= inv; dc[k] *= inv;
            }
            scales[i] = sc;
            totscale += log((double)sc);
            xE = 1.0f;
        }
        xEv[i] = xE; xNv[i] = xN; xJv[i] = xJ;
        xBv[i] = xB; xCv[i] = xC;
        if (full)
            for (int k = 0; k <= M; k++) {
                mmat[i * W + k] = mc[k];
                imat[i * W + k] = ic[k];
                dmat[i * W + k] = dc[k];
            }
    }
    if (xC != xC) return 1;                       // NaN
    if (L > 0 && xC == 0.0f) return 2;            // underflow
    if (xC == HUGE_VALF || xC == -HUGE_VALF) return 3;   // overflow
    *out_sc = totscale + log((double)(xC * cmove));
    return 0;
}

// Frameshift OA traceback (ref: optacc_fs.c p7_OATrace_Frameshift
// :538; bit-exact transcription of fwdback_fs.py oa_trace_fs —
// first-max argmax semantics, f32 pair sums promoted at compare).
// tfv column order: MM,IM,DM,BM,MD,DD,MI,II (constants.py:30).
int64_t bio_fs5_oa_trace(int64_t L, int M,
    const float* omm, const float* oim, const float* odm,
    const float* oxE, const float* oxN, const float* oxJ,
    const float* oxB, const float* oxC,
    const float* pmc, const float* pim,
    const float* pxN, const float* pxJ, const float* pxC,
    const float* tfv,
    const float* xff,
    int32_t* o_st, int32_t* o_k, int32_t* o_i, float* o_pp,
    int32_t* o_c, int64_t max_out) {
    enum { T_M = 1, T_D = 2, T_I = 3, T_S = 4, T_N = 5, T_B = 6,
           T_E = 7, T_C = 8, T_T = 9, T_J = 10 };
    enum { P_MM = 0, P_IM = 1, P_DM = 2, P_BM = 3, P_MD = 4,
           P_DD = 5, P_MI = 6, P_II = 7 };
    const double NEG = -HUGE_VAL;   // NEG_INF (f32 -inf)
    const int W = M + 1;
    const int64_t stride_c = (int64_t)(L + 1) * W;
    const float nmove = xff[1], jloop = xff[2], jmove = xff[3],
        cloop = xff[4], eloop = xff[6], emove = xff[7];
#define TP(slot, t) (((slot) >= 0 && (slot) < M) \
    ? tfv[(int64_t)(slot) * 8 + (t)] : 0.0f)
#define EMIT(S, K, I, PP, Cc) do { \
    if (n >= max_out) return -1; \
    o_st[n] = (S); o_k[n] = (K); o_i[n] = (I); \
    o_pp[n] = (PP); o_c[n] = (Cc); n++; \
} while (0)
    int64_t n = 0;
    int64_t i = L;
    int k = 0, c = 0;
    EMIT(T_T, 0, (int32_t)i, 0.f, 0);
    EMIT(T_C, 0, (int32_t)i, 0.f, 0);
    int sprv = T_C, scur = T_C;
    while (sprv != T_S) {
        if (sprv == T_M) {
            double p[4];
            p[0] = (k >= 2 && TP(k - 1, P_MM) > 0.f)
                ? (double)omm[i * W + k - 1] : NEG;
            p[1] = (k >= 2 && TP(k - 1, P_IM) > 0.f)
                ? (double)oim[i * W + k - 1] : NEG;
            p[2] = (k >= 2 && TP(k - 1, P_DM) > 0.f)
                ? (double)odm[i * W + k - 1] : NEG;
            p[3] = (TP(k - 1, P_BM) > 0.f) ? (double)oxB[i] : NEG;
            int best = 0;
            for (int a = 1; a < 4; a++) if (p[a] > p[best]) best = a;
            static const int sts[4] = { T_M, T_I, T_D, T_B };
            scur = sts[best];
            k -= 1;
        } else if (sprv == T_D) {
            double p0 = (k >= 2 && TP(k - 1, P_MD) > 0.f)
                ? (double)omm[i * W + k - 1] : NEG;
            double p1 = (k >= 2 && TP(k - 1, P_DD) > 0.f)
                ? (double)odm[i * W + k - 1] : NEG;
            scur = (p0 >= p1) ? T_M : T_D;
            k -= 1;
        } else if (sprv == T_I) {
            int64_t j3 = (i >= 3) ? i - 3 : 0;
            double p0 = (TP(k, P_MI) > 0.f)
                ? (double)omm[j3 * W + k] : NEG;
            double p1 = (TP(k, P_II) > 0.f)
                ? (double)oim[j3 * W + k] : NEG;
            scur = (p0 >= p1) ? T_M : T_I;
            i -= 3;
        } else if (sprv == T_N) {
            scur = (i == 0) ? T_S : T_N;
        } else if (sprv == T_C) {
            if (i < 4) {
                scur = T_E;
            } else {
                int t1 = (cloop != 0.f);
                double p[4];
                p[0] = t1 ? (double)(oxC[i - 3] + pxC[i]) : NEG;
                p[1] = (i < L && t1)
                    ? (double)(oxC[i - 2] + pxC[i + 1]) : NEG;
                p[2] = (i < L - 1 && t1)
                    ? (double)(oxC[i - 1] + pxC[i + 2]) : NEG;
                p[3] = (emove != 0.f) ? (double)oxE[i] : NEG;
                int best = 0;
                for (int a = 1; a < 4; a++)
                    if (p[a] > p[best]) best = a;
                scur = (best == 3) ? T_E : T_C;
            }
        } else if (sprv == T_J) {
            if (i <= 5) {
                scur = T_E;
            } else {
                double p0 = (jloop != 0.f)
                    ? (double)(oxJ[i] + pxJ[i]) : NEG;
                double p1 = (eloop != 0.f) ? (double)oxE[i] : NEG;
                scur = (p0 >= p1) ? T_J : T_E;
            }
        } else if (sprv == T_E) {
            double mx = NEG;
            int smax = T_M, kmax = 1;
            for (int kk = 1; kk <= M; kk++) {
                double vM = (double)omm[i * W + kk];
                if (vM > mx) { mx = vM; smax = T_M; kmax = kk; }
                double vD = (double)odm[i * W + kk];
                if (vD > mx) { mx = vD; smax = T_D; kmax = kk; }
            }
            k = kmax;
            scur = smax;
        } else if (sprv == T_B) {
            double p0 = (nmove != 0.f) ? (double)oxN[i] : NEG;
            double p1 = (jmove != 0.f) ? (double)oxJ[i] : NEG;
            scur = (p0 > p1) ? T_N : T_J;
        } else {
            return -2;
        }
        float postprob = 0.f;
        if (scur == T_M)
            postprob = pmc[0 * stride_c + i * W + k];
        else if (scur == T_I)
            postprob = pim[i * W + k];
        else if (scur == sprv && scur == T_N)
            postprob = pxN[i];
        else if (scur == sprv && scur == T_C)
            postprob = pxC[i];
        else if (scur == sprv && scur == T_J)
            postprob = pxJ[i];
        if (scur == T_M) {
            float best = pmc[1 * stride_c + i * W + k];
            c = 1;
            for (int cc = 2; cc <= 5; cc++) {
                float v = pmc[cc * stride_c + i * W + k];
                if (v > best) { best = v; c = cc; }
            }
        } else c = 0;
        if (scur == T_M)
            EMIT(T_M, k, (int32_t)i, postprob, c);
        else if (scur == T_I)
            EMIT(T_I, k, (int32_t)i, postprob, 0);
        else if ((scur == T_N || scur == T_C || scur == T_J)
                 && scur == sprv)
            EMIT(scur, 0, (int32_t)i, postprob, 0);
        else
            EMIT(scur, (scur == T_D) ? k : 0, 0, postprob, 0);
        if ((scur == T_N || scur == T_C || scur == T_J)
            && scur == sprv)
            i -= 1;
        sprv = scur;
        i -= c;
    }
#undef TP
#undef EMIT
    return n;
}

// SSV filter with diagonal-window capture (ref: impl_sse/msvfilter.c
// p7_SSVFilter_BATH :250; bit-exact transcription of
// filters.ssv_filter_bath including numpy negative-index wrap in the
// backward walk).  Returns the number of captured windows, or -1 if
// max_w would be exceeded (caller falls back to Python).
int64_t bio_ssv_filter_bath(const int32_t* dsq, int64_t L,
    const uint8_t* rbv, const uint8_t* ssv_scores, int64_t ssv_len,
    int Kp, int M,
    int base, int bias, int tjb, int tbm, double scale_b,
    int32_t sc_thresh,
    int32_t* w_n, int32_t* w_k, int32_t* w_len, float* w_sc,
    int64_t max_w) {
    const int W = M + 1;
    const int tjbm = tjb + tbm;
    const int xB = (base - tjbm > 0) ? base - tjbm : 0;
    const int Qb = ((M + 15) / 16) > 2 ? ((M + 15) / 16) : 2;
    static thread_local int16_t* dp = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < W) {
        delete[] dp;
        dp = new int16_t[W];
        cap = W;
    }
    for (int k = 0; k <= M; k++) dp[k] = 0;
    int64_t nw = 0;
    for (int64_t i = 1; i <= L; i++) {
        const uint8_t* row = rbv + (int64_t)dsq[i - 1] * W;
        int rowmax = -1;
        // dp update in reverse so dp[k-1] reads the previous row
        for (int k = M; k >= 1; k--) {
            int sv = dp[k - 1] > xB ? dp[k - 1] : xB;
            sv += bias;
            if (sv > 255) sv = 255;
            sv -= (int)row[k];
            if (sv < 0) sv = 0;
            dp[k] = (int16_t)sv;
            if (sv > rowmax) rowmax = sv;
        }
        dp[0] = 0;
        if (M >= 1 && rowmax >= sc_thresh) {
            int end = -1, rem_sc = -1;
            for (int q = 0; q < Qb; q++)
                for (int z = 0; z < 16; z++) {
                    int k = q + Qb * z + 1;
                    if (k <= M && (int)dp[k] >= sc_thresh
                        && (int)dp[k] > rem_sc) {
                        end = k;
                        rem_sc = (int)dp[k];
                    }
                }
            for (int k = 0; k <= M; k++) dp[k] = 0;
            int sc = rem_sc;
            int64_t start = end, tstart = i;
            while (rem_sc > base - tjbm) {
                int64_t di = tstart - 1;
                if (di < 0) di += L;             // numpy wrap
                int64_t si = start * (int64_t)Kp + dsq[di];
                if (si < 0) si += ssv_len;       // numpy wrap
                rem_sc -= bias - (int)ssv_scores[si];
                start -= 1;
                tstart -= 1;
            }
            start += 1;
            tstart += 1;
            int64_t k2 = end + 1, n2 = i + 1;
            int64_t max_end = i;
            int max_sc = sc, pos_since_max = 0;
            while (k2 < M && n2 <= L) {
                sc += bias
                    - (int)ssv_scores[k2 * (int64_t)Kp + dsq[n2 - 1]];
                if (sc >= max_sc) {
                    max_sc = sc;
                    max_end = n2;
                    pos_since_max = 0;
                } else {
                    pos_since_max += 1;
                    if (pos_since_max == 5) break;
                }
                k2 += 1;
                n2 += 1;
            }
            end += (int)(max_end - i);
            double ret = ((double)(max_sc - tjb) - (double)base)
                / scale_b - 3.0;
            if (nw >= max_w) return -1;
            w_n[nw] = (int32_t)tstart;
            w_k[nw] = end;
            w_len[nw] = (int32_t)(end - start + 1);
            w_sc[nw] = (float)ret;
            nw++;
        }
    }
    return nw;
}

// ViterbiFilter with diagonal-window capture (ref: impl_sse/
// vitfilter.c p7_ViterbiFilter_BATH :286; bit-exact transcription of
// filters.viterbi_filter's capture mode).  All-integer int16-saturated
// DP in int32; the eager D closure gives the same M rows / xE as the
// Python lazy-F form (Farrar's lazy-F invariant), so captures and the
// final score are identical.  Returns the number of captured windows,
// or -1 if max_w would be exceeded (caller falls back to Python).
// out_status: 1 = xE overflow (score is a certain hit; Python returns
// +inf immediately, keeping windows captured so far).
int64_t bio_vit_filter_bath(const int32_t* dsq, int64_t L,
    const int32_t* rwv, const int32_t* twv, int Kp, int M,
    int base, double scale, int move_w, int e_move, int e_loop,
    int64_t sc_thresh, int64_t sc_ext_thresh,
    const uint8_t* ssv_scores, int bias_b,
    int32_t* w_n, int32_t* w_k, int32_t* w_len, int64_t max_w,
    float* out_sc, int32_t* out_status) {
    const int NEG = -32768;
    const int P_MM = 0, P_IM = 1, P_DM = 2, P_BM = 3, P_MD = 4,
        P_DD = 5, P_MI = 6, P_II = 7;
    int stride = M + 1;
    auto sat = [](int x) {
        if (x < -32768) return -32768;
        if (x > 32767) return 32767;
        return x;
    };
    static thread_local int32_t *dm = nullptr, *di = nullptr,
        *dd = nullptr, *nm = nullptr, *ni = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < stride) {
        delete[] dm; delete[] di; delete[] dd;
        delete[] nm; delete[] ni;
        dm = new int32_t[stride]; di = new int32_t[stride];
        dd = new int32_t[stride]; nm = new int32_t[stride];
        ni = new int32_t[stride];
        cap = stride;
    }
    for (int k = 0; k <= M; k++) dm[k] = di[k] = dd[k] = NEG;
    int xN = base;
    int xB = sat(xN + move_w);
    int xJ = NEG, xC = NEG;
    const int Qw = ((M + 7) / 8) > 2 ? ((M + 7) / 8) : 2;
    int64_t skip_until = 0;
    int64_t nw = 0;
    *out_status = 0;
    for (int64_t i = 1; i <= L; i++) {
        const int32_t* row = rwv + (int64_t)dsq[i - 1] * stride;
        int xE = NEG;
        nm[0] = ni[0] = NEG;
        for (int k = 1; k <= M; k++) {
            const int32_t* tin = twv + (k - 1) * 8;
            int sv = sat(xB + tin[P_BM]);
            int v = sat(dm[k - 1] + tin[P_MM]); if (v > sv) sv = v;
            v = sat(di[k - 1] + tin[P_IM]); if (v > sv) sv = v;
            v = sat(dd[k - 1] + tin[P_DM]); if (v > sv) sv = v;
            sv = sat(sv + row[k]);
            nm[k] = sv;
            if (sv > xE) xE = sv;
            if (k < M) {
                const int32_t* tout = twv + k * 8;
                int iv = sat(dm[k] + tout[P_MI]);
                int iv2 = sat(di[k] + tout[P_II]);
                ni[k] = iv > iv2 ? iv : iv2;
            } else ni[k] = NEG;
        }
        if (xE >= 32767) {
            *out_sc = 1.0f / 0.0f;
            *out_status = 1;
            return nw;
        }
        dd[0] = dd[1] = NEG;
        for (int k = 2; k <= M; k++) {
            const int32_t* tin = twv + (k - 1) * 8;
            int v1 = sat(nm[k - 1] + tin[P_MD]);
            int v2 = sat(dd[k - 1] + tin[P_DD]);
            dd[k] = v1 > v2 ? v1 : v2;
        }
        int xC2 = xC > sat(xE + e_move) ? xC : sat(xE + e_move);
        int xJ2 = xJ > sat(xE + e_loop) ? xJ : sat(xE + e_loop);
        int b1 = sat(xJ2 + move_w), b2 = sat(xN + move_w);
        xB = b1 > b2 ? b1 : b2;
        xJ = xJ2; xC = xC2;
        int32_t* t = dm; dm = nm; nm = t;
        t = di; di = ni; ni = t;

        if (i > skip_until && (int64_t)xE >= sc_thresh) {
            // striped-order scan for the first k with M(i,k) == xE
            int k_start = 0;
            for (int q = 0; q < Qw && !k_start; q++)
                for (int z = 0; z < 8; z++) {
                    int k = q + Qw * z + 1;
                    if (k <= M && dm[k] == xE) { k_start = k; break; }
                }
            int max_k_end = k_start;
            int64_t max_i_end = i;
            int64_t sc_ext = sc_ext_thresh;
            int64_t max_sc_ext = sc_ext;
            int pos_since_max = 0;
            int64_t kk = k_start + 1, nn = i + 1;
            while (kk <= M && nn <= L) {
                sc_ext += bias_b
                    - (int)ssv_scores[kk * (int64_t)Kp + dsq[nn - 1]];
                if (sc_ext >= max_sc_ext) {
                    max_sc_ext = sc_ext;
                    max_k_end = (int)kk;
                    max_i_end = nn;
                    pos_since_max = 0;
                } else {
                    pos_since_max += 1;
                    if (pos_since_max == 5) break;
                }
                kk += 1;
                nn += 1;
            }
            if (nw >= max_w) return -1;
            w_n[nw] = (int32_t)i;
            w_k[nw] = max_k_end;
            w_len[nw] = max_k_end - k_start + 1;
            nw++;
            skip_until = max_i_end;
        }
    }
    if (xC > NEG)
        *out_sc = (float)((((double)(xC + move_w)) - (double)base)
                          / scale - 3.0);
    else
        *out_sc = -1.0f / 0.0f;
    return nw;
}

// Max-plus D-chain for the spliced Viterbi row (ref: the sequential
// D recursion of generic_viterbi_spliced.c):
//   d[k] = max(m[k-2] + tMD[k-1], d[k-1] + tDD[k-1]),  k = 2..M
void bio_d_max_chain(float* d, const float* m, const float* tMD,
                     const float* tDD, int M) {
    for (int k = 2; k <= M; k++) {
        float a = m[k - 2] + tMD[k - 1];
        float b = d[k - 1] + tDD[k - 1];
        d[k] = a > b ? a : b;
    }
}

// ---------------------------------------------------------------------
// Spliced translated Viterbi fill (ref: generic_viterbi_spliced.c
// p7_GViterbi_Spliced :65; bit-exact transcription of
// splice/viterbi_spliced.py viterbi_spliced — f32 DP with the
// acceptor lookups in f64 exactly like the numpy mixed-dtype math).
// ---------------------------------------------------------------------
int bio_spliced_vit_fill(
    const int32_t* ntv, const int64_t* ci_arr, const int64_t* c1_base,
    const int32_t* accv, const int32_t* donv,
    int64_t L, int M,
    const float* rsc, int W,
    const int64_t* sub_k,
    const float* tMM, const float* tIM, const float* tDM,
    const float* tMD, const float* tDD, const float* tMI,
    const float* tII,
    float entry, float exitc, int global_start, int global_end,
    float nloop, float nmove, float cloop, float emove,
    const double* sigsc, float tsc_p, int min_intron,
    float* mmx, float* imx, float* dmx,
    float* xN, float* xB, float* xE, float* xC) {
    enum { S_GTAG = 0, S_GCAG = 1, S_ATAC = 2,
           ACCEPT_AG = 2, ACCEPT_AC = 1 };
    const int Wl = M + 1;                 // local row width
    const float NEG = -HUGE_VALF;
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    // pvx[4][Wl], ssx0[Wl][3], ssx1[Wl][3][5], ssx2[Wl][3][5],
    // m_new/i_new/d_new/cand [Wl]
    int64_t need = 4 * Wl + 3 * Wl + 15 * Wl + 15 * Wl + 4 * Wl;
    if (cap < need) {
        delete[] buf;
        buf = new float[need];
        cap = need;
    }
    float* pvx = buf;
    float* ssx0 = pvx + 4 * Wl;           // [k*3 + s]
    float* ssx1 = ssx0 + 3 * Wl;          // [(k*3 + s)*5 + j]
    float* ssx2 = ssx1 + 15 * Wl;
    float* m_new = ssx2 + 15 * Wl;
    float* i_new = m_new + Wl;
    float* d_new = i_new + Wl;
    float* cand = d_new + Wl;
    for (int64_t z = 0; z < need; z++) buf[z] = NEG;

    int64_t loop_end = L < min_intron + 2 ? L : min_intron + 2;
    for (int64_t phase = 0; phase < 2; phase++) {
        int64_t i0 = (phase == 0) ? 3 : min_intron + 3;
        int64_t i1 = (phase == 0) ? loop_end : L;
        for (int64_t i = i0; i <= i1; i++) {
            const float* rc = rsc + ci_arr[i - 3] * W;
            if (!global_start) {
                xN[i] = xN[i - 3] + nloop;
                xB[i] = xN[i] + nmove;
            }
            const float* pm = mmx + (i - 3) * Wl;
            const float* pi = imx + (i - 3) * Wl;
            const float* pd = dmx + (i - 3) * Wl;
            const float* pvp = pvx + ((i - 3) % 4) * Wl;

            for (int k = 1; k <= M; k++) {
                float c;
                if (global_start) {
                    if (k == 1) {
                        c = (phase == 0 && i == 3) ? xB[i - 3] : NEG;
                    } else {
                        c = pm[k - 1] + tMM[k - 1];
                        float t = pi[k - 1] + tIM[k - 1];
                        if (t > c) c = t;
                        t = pd[k - 1] + tDM[k - 1];
                        if (t > c) c = t;
                        if (phase == 1) {
                            t = pvp[k - 1] + tsc_p;
                            if (t > c) c = t;
                        }
                    }
                } else {
                    c = pm[k - 1] + tMM[k - 1];
                    float t = pi[k - 1] + tIM[k - 1];
                    if (t > c) c = t;
                    t = pd[k - 1] + tDM[k - 1];
                    if (t > c) c = t;
                    if (phase == 1 && k >= 2) {
                        t = pvp[k - 1] + tsc_p;
                        if (t > c) c = t;
                    }
                    t = xB[i - 3] + entry;
                    if (t > c) c = t;
                }
                float em = rc[sub_k[k - 1]];
                m_new[k - 1] = c + em;
                float iv = pm[k] + tMI[k - 1];
                float iw = pi[k] + tII[k - 1];
                float in_ = iv > iw ? iv : iw;
                if (em == NEG) in_ = NEG;
                i_new[k - 1] = in_;
            }
            i_new[M - 1] = NEG;
            d_new[0] = d_new[1] = NEG;
            for (int k = 2; k <= M; k++) {
                float a = m_new[k - 2] + tMD[k - 1];
                float b = d_new[k - 1] + tDD[k - 1];
                d_new[k] = a > b ? a : b;
            }
            float* mrow = mmx + i * Wl;
            float* irow = imx + i * Wl;
            float* drow = dmx + i * Wl;
            mrow[0] = NEG;            // caller passes uninitialized
            irow[0] = NEG;            // rows (pooled buffers)
            for (int k = 1; k <= M; k++) {
                mrow[k] = m_new[k - 1];
                irow[k] = i_new[k - 1];
            }
            for (int k = 0; k <= M; k++) drow[k] = d_new[k];

            if (!global_end) {
                double e;
                if (phase == 0) {
                    double mm = NEG, dd = NEG;
                    for (int k = 0; k < M; k++)
                        if (m_new[k] > mm) mm = m_new[k];
                    for (int k = 0; k <= M; k++)
                        if (d_new[k] > dd) dd = d_new[k];
                    // python stores the f32-rounded sum before the
                    // max with ei — replicate the intermediate round
                    float e1 = (float)((mm > dd ? mm : dd)
                                       + (double)exitc);
                    double ei = m_new[M - 1] > d_new[M]
                        ? m_new[M - 1] : d_new[M];
                    e = (ei > (double)e1) ? ei : (double)e1;
                } else {
                    double mm = NEG, dd = NEG;
                    for (int k = 0; k < M - 1; k++)
                        if (m_new[k] > mm) mm = m_new[k];
                    for (int k = 1; k < M; k++)
                        if (d_new[k] > dd) dd = d_new[k];
                    e = (mm > dd ? mm : dd) + (double)exitc;
                    if ((double)m_new[M - 1] > e) e = m_new[M - 1];
                    if ((double)d_new[M] > e) e = d_new[M];
                }
                xE[i] = (float)e;
                float c1 = xC[i - 3] + cloop;
                float c2 = xE[i] + emove;
                xC[i] = c1 > c2 ? c1 : c2;
            }

            if (phase == 1) {
                // P-state row from acceptor signals
                float* pvn = pvx + (i % 4) * Wl;
                for (int k = 0; k <= M; k++) pvn[k] = NEG;
                int acc0 = accv[i - 5], acc1 = accv[i - 4],
                    acc2 = accv[i - 3];
                if (acc0 >= 0 || acc1 >= 0 || acc2 >= 0) {
                    int nuc3 = ntv[i - 1] < 4 ? ntv[i - 1] : 4;
                    int64_t c1i[5];
                    for (int j = 0; j < 5; j++) {
                        static const int n1v[5] = {0, 1, 2, 3, 65};
                        int64_t v = c1_base[i - 3] + n1v[j];
                        c1i[j] = v < 64 ? v : 64;
                    }
                    for (int k = 1; k < M; k++) {
                        double best = -HUGE_VAL;
                        int64_t gk = sub_k[k - 1];
                        if (acc0 == ACCEPT_AG) {
                            double a = (double)ssx0[k * 3 + S_GTAG]
                                + sigsc[S_GTAG];
                            double b = (double)ssx0[k * 3 + S_GCAG]
                                + sigsc[S_GCAG];
                            double t = (a > b ? a : b)
                                + (double)rc[gk];
                            if (t > best) best = t;
                        } else if (acc0 == ACCEPT_AC) {
                            double t = (double)ssx0[k * 3 + S_ATAC]
                                + sigsc[S_ATAC] + (double)rc[gk];
                            if (t > best) best = t;
                        }
                        if (acc1 == ACCEPT_AG) {
                            for (int j = 0; j < 5; j++) {
                                double a = (double)ssx1[
                                    (k * 3 + S_GTAG) * 5 + j]
                                    + sigsc[S_GTAG];
                                double b = (double)ssx1[
                                    (k * 3 + S_GCAG) * 5 + j]
                                    + sigsc[S_GCAG];
                                double t = (a > b ? a : b)
                                    + (double)rsc[c1i[j] * W + gk];
                                if (t > best) best = t;
                            }
                        } else if (acc1 == ACCEPT_AC) {
                            for (int j = 0; j < 5; j++) {
                                double t = (double)ssx1[
                                    (k * 3 + S_ATAC) * 5 + j]
                                    + sigsc[S_ATAC]
                                    + (double)rsc[c1i[j] * W + gk];
                                if (t > best) best = t;
                            }
                        }
                        if (acc2 == ACCEPT_AG) {
                            double a = (double)ssx2[
                                (k * 3 + S_GTAG) * 5 + nuc3]
                                + sigsc[S_GTAG];
                            double b = (double)ssx2[
                                (k * 3 + S_GCAG) * 5 + nuc3]
                                + sigsc[S_GCAG];
                            double t = a > b ? a : b;
                            if (t > best) best = t;
                        } else if (acc2 == ACCEPT_AC) {
                            double t = (double)ssx2[
                                (k * 3 + S_ATAC) * 5 + nuc3]
                                + sigsc[S_ATAC];
                            if (t > best) best = t;
                        }
                        pvn[k] = (float)best;
                    }
                }
                // NOTE: pvn computed from ssx BEFORE this row's donor
                // updates, matching the python order? (python computes
                // pv_new first, then donor updates) -- yes.

                // donor updates for the row min_intron+3 back
                const float* dm_m = mmx + (i - min_intron - 3) * Wl;
                const float* dm_d = dmx + (i - min_intron - 3) * Wl;
                int don0 = donv[i - min_intron - 3];
                int don1 = donv[i - min_intron - 2];
                int don2 = donv[i - min_intron - 1];
                if (M > 2 && (don0 >= 0 || don1 >= 0 || don2 >= 0)) {
                    if (don2 >= 0) {
                        int r_ = ntv[i - min_intron - 3];
                        int s_ = ntv[i - min_intron - 2];
                        for (int j = 0; j < 5; j++) {
                            static const int n3v[5] = {0, 1, 2, 3, 65};
                            int64_t ci = (int64_t)n3v[j] * 16
                                + (int64_t)s_ * 4 + r_;
                            if (ci > 64) ci = 64;
                            const float* emr = rsc + ci * W;
                            for (int k = 2; k < M; k++) {
                                float tmp = dm_m[k - 1] > dm_d[k - 1]
                                    ? dm_m[k - 1] : dm_d[k - 1];
                                float t = tmp + emr[sub_k[k - 1]];
                                float* slot = &ssx2[
                                    (k * 3 + don2) * 5 + j];
                                if (t > *slot) *slot = t;
                            }
                        }
                    }
                    if (don1 >= 0) {
                        int r_ = ntv[i - min_intron - 3];
                        if (r_ > 4) r_ = 4;
                        for (int k = 2; k < M; k++) {
                            float tmp = dm_m[k - 1] > dm_d[k - 1]
                                ? dm_m[k - 1] : dm_d[k - 1];
                            float* slot = &ssx1[(k * 3 + don1) * 5 + r_];
                            if (tmp > *slot) *slot = tmp;
                        }
                    }
                    if (don0 >= 0) {
                        for (int k = 2; k < M; k++) {
                            float tmp = dm_m[k - 1] > dm_d[k - 1]
                                ? dm_m[k - 1] : dm_d[k - 1];
                            float* slot = &ssx0[k * 3 + don0];
                            if (tmp > *slot) *slot = tmp;
                        }
                    }
                }
            }
        }
    }
    if (global_end) {
        float a = mmx[L * Wl + M], b = dmx[L * Wl + M];
        xE[L] = a > b ? a : b;
        xC[L] = xE[L] + emove;
    }
    return 0;
}

// Standard (amino) Backward fill — bit-exact transcription of
// fwdback.py backward (ref: fwdback.c backward_engine): borrows the
// Forward's scale factors with the overflow fallback to its own
// (has_own_scales); numpy-pairwise xB sums; f32 elementwise rows.
// Scores/totscale stay Python-side (np.log dtype quirks).
int bio_bwd_fill(const int32_t* dsq, int64_t L, const float* rfv,
                 int M, int full,
                 const float* tBM, const float* tMM, const float* tIM,
                 const float* tDM, const float* tMD, const float* tDD,
                 const float* tMI, const float* tII,
                 const float* xff, const float* fwd_scale,
                 float* mmat, float* imat, float* dmat,
                 float* xEv, float* xNv, float* xJv, float* xBv,
                 float* xCv, float* scales, int32_t* own_io) {
    const int W = M + 1;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], cmove = xff[5],
        eloop = xff[6], emove = xff[7];
    static thread_local float* buf = nullptr;
    static thread_local int64_t cap = 0;
    if (cap < 7 * (int64_t)W) {
        delete[] buf;
        buf = new float[7 * W];
        cap = 7 * W;
    }
    float* mc = buf;
    float* ic = buf + W;
    float* dc = buf + 2 * W;
    float* nm = buf + 3 * W;
    float* ni = buf + 4 * W;
    float* nd = buf + 5 * W;
    float* ms = buf + 6 * W;
    int own = *own_io;

    // init row L
    float xJ = 0.f, xB = 0.f, xN = 0.f;
    float xC = cmove;
    float xE = xC * emove;
    for (int k = 0; k <= M; k++) { mc[k] = dc[k] = xE; ic[k] = 0.f; }
    mc[0] = dc[0] = 0.f;
    for (int k = M - 1; k >= 1; k--)
        dc[k] = dc[k] + dc[k + 1] * tDD[k + 1];
    for (int k = 1; k < M; k++)
        mc[k] = mc[k] + dc[k + 1] * tMD[k + 1];
    float scL = fwd_scale[L];
    if (scL > 1.0f) {
        float inv = 1.0f / scL;
        xE *= inv; xN *= inv; xC *= inv; xJ *= inv; xB *= inv;
        for (int k = 0; k <= M; k++) {
            mc[k] *= inv; dc[k] *= inv; ic[k] *= inv;
        }
    }
    scales[L] = scL;
    xEv[L] = xE; xNv[L] = xN; xJv[L] = xJ; xBv[L] = xB; xCv[L] = xC;
    if (full)
        for (int k = 0; k <= M; k++) {
            mmat[L * W + k] = mc[k];
            imat[L * W + k] = ic[k];
            dmat[L * W + k] = dc[k];
        }

    for (int64_t i = L - 1; i >= 1; i--) {
        const float* row = rfv + (int64_t)dsq[i] * W;
        ms[0] = 0.f;
        for (int k = 1; k <= M; k++) ms[k] = mc[k] * row[k];
        // xB = pairwise sum of ms[1..M] * tBM[1..M]
        {
            static thread_local float* tmp = nullptr;
            static thread_local int64_t tcap = 0;
            if (tcap < M) {
                delete[] tmp;
                tmp = new float[M > 1 ? M : 1];
                tcap = M;
            }
            for (int k = 1; k <= M; k++)
                tmp[k - 1] = ms[k] * tBM[k];
            xB = np_pairwise_f32(tmp, M);
        }
        for (int k = 0; k <= M; k++) nm[k] = ni[k] = nd[k] = 0.f;
        for (int k = 1; k <= M; k++) {
            float ms1 = (k < M) ? ms[k + 1] : 0.f;
            float tMMk = (k < M) ? tMM[k + 1] : 0.f;
            float tIMk = (k < M) ? tIM[k + 1] : 0.f;
            float tDMk = (k < M) ? tDM[k + 1] : 0.f;
            ni[k] = ic[k] * tII[k] + ms1 * tIMk;
            nm[k] = ic[k] * tMI[k] + ms1 * tMMk;
            nd[k] = ms1 * tDMk;
        }
        xC = xC * cloop;
        xJ = xB * jmove + xJ * jloop;
        xN = xB * nmove + xN * nloop;
        xE = xC * emove + xJ * eloop;

        for (int k = 1; k <= M; k++) nd[k] = nd[k] + xE;
        nd[0] = 0.f;
        for (int k = M - 1; k >= 1; k--)
            nd[k] = nd[k] + nd[k + 1] * tDD[k + 1];
        for (int k = 1; k <= M; k++) nm[k] = nm[k] + xE;
        nm[0] = 0.f;
        for (int k = 1; k < M; k++)
            nm[k] = nm[k] + nd[k + 1] * tMD[k + 1];

        float* t;
        t = mc; mc = nm; nm = t;
        t = ic; ic = ni; ni = t;
        t = dc; dc = nd; nd = t;

        if (xB > 1.0e16f) own = 1;
        double sc = own ? ((xB > 1.0e4f) ? (double)xB : 1.0)
                        : (double)fwd_scale[i];
        scales[i] = (float)sc;
        if (sc > 1.0) {
            float inv = 1.0f / (float)sc;
            xE *= inv; xN *= inv; xJ *= inv; xB *= inv; xC *= inv;
            for (int k = 0; k <= M; k++) {
                mc[k] *= inv; ic[k] *= inv; dc[k] *= inv;
            }
        }
        xEv[i] = xE; xNv[i] = xN; xJv[i] = xJ;
        xBv[i] = xB; xCv[i] = xC;
        if (full)
            for (int k = 0; k <= M; k++) {
                mmat[i * W + k] = mc[k];
                imat[i * W + k] = ic[k];
                dmat[i * W + k] = dc[k];
            }
    }

    // termination at i = 0
    {
        const float* row = rfv + (int64_t)dsq[0] * W;
        static thread_local float* tmp0 = nullptr;
        static thread_local int64_t t0cap = 0;
        if (t0cap < M) {
            delete[] tmp0;
            tmp0 = new float[M > 1 ? M : 1];
            t0cap = M;
        }
        for (int k = 1; k <= M; k++)
            tmp0[k - 1] = (mc[k] * row[k]) * tBM[k];
        xB = np_pairwise_f32(tmp0, M);
        xN = xB * nmove + xN * nloop;
        xBv[0] = xB; xNv[0] = xN;
        scales[0] = 1.0f;
    }
    *own_io = own;
    if (xNv[0] != xNv[0]) return 1;
    if (L > 0 && xNv[0] == 0.0f) return 2;
    if (xNv[0] == HUGE_VALF || xNv[0] == -HUGE_VALF) return 3;
    return 0;
}

// Standard optimal-accuracy fill — bit-exact transcription of
// fwdback.py optimal_accuracy (ref: impl_sse/optacc.c
// p7_OptimalAccuracy :57): masked maxes with the (t>0 ? v : 0)
// and_ps idiom, gated D chain, f64 specials compares.
void bio_oa_fill(int64_t L, int M,
                 const float* tBM, const float* tMM, const float* tIM,
                 const float* tDM, const float* tMD, const float* tDD,
                 const float* tMI, const float* tII,
                 const float* xff,
                 const float* pmm, const float* pim,
                 const float* pxN, const float* pxJ, const float* pxC,
                 float* omm, float* oim, float* odm,
                 float* xEv, float* xNv, float* xJv, float* xBv,
                 float* xCv) {
    const int W = M + 1;
    const float NEG = -HUGE_VALF;
    const float nloop = xff[0], nmove = xff[1], jloop = xff[2],
        jmove = xff[3], cloop = xff[4], emove = xff[7],
        eloop = xff[6];
    for (int64_t i = 0; i <= L; i++) {
        xEv[i] = NEG; xJv[i] = NEG; xCv[i] = NEG;
        xNv[i] = 0.f; xBv[i] = 0.f;
        for (int k = 0; k <= M; k++)
            omm[i * W + k] = oim[i * W + k] = odm[i * W + k] = NEG;
    }
    xNv[0] = 0.f;
    xBv[0] = 0.f;
    for (int64_t i = 1; i <= L; i++) {
        const float* mprev = omm + (i - 1) * W;
        const float* iprev = oim + (i - 1) * W;
        const float* dprev = odm + (i - 1) * W;
        float* mrow = omm + i * W;
        float* irow = oim + i * W;
        float* drow = odm + i * W;
        const float* ppm = pmm + i * W;
        const float* ppi = pim + i * W;
        float xBp = xBv[i - 1];
        for (int k = 1; k <= M; k++) {
            float sv = (tBM[k] > 0.f) ? xBp : 0.f;
            float t = (tMM[k] > 0.f) ? mprev[k - 1] : 0.f;
            if (t > sv) sv = t;
            t = (tIM[k] > 0.f) ? iprev[k - 1] : 0.f;
            if (t > sv) sv = t;
            t = (tDM[k] > 0.f) ? dprev[k - 1] : 0.f;
            if (t > sv) sv = t;
            mrow[k] = sv + ppm[k];
            float iv = (tMI[k] > 0.f) ? mprev[k] : 0.f;
            t = (tII[k] > 0.f) ? iprev[k] : 0.f;
            if (t > iv) iv = t;
            irow[k] = iv + ppi[k];
        }
        mrow[0] = NEG;
        irow[0] = NEG;
        drow[0] = drow[1] = NEG;
        for (int k = 2; k <= M; k++)
            drow[k] = (tMD[k] > 0.f) ? mrow[k - 1] : 0.f;
        for (int k = 2; k <= M; k++) {
            float g = (tDD[k] > 0.f) ? drow[k - 1] : 0.f;
            if (g > drow[k]) drow[k] = g;
        }
        float mmax = NEG, dmax = NEG;
        for (int k = 1; k <= M; k++) {
            if (mrow[k] > mmax) mmax = mrow[k];
            if (drow[k] > dmax) dmax = drow[k];
        }
        double xE = (double)(mmax > dmax ? mmax : dmax);
        xEv[i] = (float)xE;
        double t1 = (jloop == 0.f) ? 0.0
            : (double)(xJv[i - 1] + pxJ[i]);
        double t2 = (eloop == 0.f) ? 0.0 : (double)xEv[i];
        xJv[i] = (float)(t1 > t2 ? t1 : t2);
        t1 = (cloop == 0.f) ? 0.0 : (double)(xCv[i - 1] + pxC[i]);
        t2 = (emove == 0.f) ? 0.0 : (double)xEv[i];
        xCv[i] = (float)(t1 > t2 ? t1 : t2);
        xNv[i] = (nloop == 0.f) ? 0.f : (xNv[i - 1] + pxN[i]);
        t1 = (nmove == 0.f) ? 0.0 : (double)xNv[i];
        t2 = (jmove == 0.f) ? 0.0 : (double)xJv[i];
        xBv[i] = (float)(t1 > t2 ? t1 : t2);
    }
}

// Standard stochastic traceback (ref: generic_stotrace.c
// p7_GStochasticTrace :42 semantics; bit-exact transcription of
// ensemble.stochastic_trace incl. the MT19937 stream).
int64_t bio_stotrace(int64_t L, int M,
    const float* mm, const float* im, const float* dm,
    const float* xB, const float* xC, const float* xE,
    const float* xN, const float* xJ, const float* scale,
    const float* tBM, const float* tMM, const float* tIM,
    const float* tDM, const float* tMD, const float* tDD,
    const float* tMI, const float* tII,
    const float* xff,
    uint32_t* mt, int32_t* mti_io,
    int32_t* o_st, int32_t* o_k, int32_t* o_i,
    int64_t max_out) {
    enum { T_M = 1, T_D = 2, T_I = 3, T_S = 4, T_N = 5, T_B = 6,
           T_E = 7, T_C = 8, T_T = 9, T_J = 10 };
    const double nloop = (double)xff[0], nmove = (double)xff[1];
    const double jloop = (double)xff[2], jmove = (double)xff[3];
    const double cloop = (double)xff[4];
    const double eloop = (double)xff[6], emove = (double)xff[7];
    const int W = M + 1;
    int32_t mti = *mti_io;
    int64_t n = 0;
#define EMIT2(S, K, I) do { \
    if (n >= max_out) return -1; \
    o_st[n] = (S); o_k[n] = (K); o_i[n] = (I); n++; \
} while (0)
    EMIT2(T_T, 0, 0);
    EMIT2(T_C, 0, 0);
    int64_t i = L;
    int k = 0;
    int st = T_C, nxt = T_C;
    while (st != T_S) {
        if (st == T_C) {
            double w[2];
            w[0] = (i > 0) ? (double)xC[i - 1] * cloop
                / (double)scale[i] : 0.0;
            w[1] = (double)xE[i] * emove;
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_C : T_E;
            if (nxt == T_C) i -= 1;
        } else if (st == T_E) {
            int sel = bio_choose_e(mt, &mti, mm + i * W + 1,
                                   dm + i * W + 1, M);
            if (sel < M) { nxt = T_M; k = sel + 1; }
            else { nxt = T_D; k = sel - M + 1; }
        } else if (st == T_M) {
            double w[4];
            w[0] = (double)xB[i - 1] * (double)tBM[k];
            w[1] = (double)mm[(i - 1) * W + k - 1] * (double)tMM[k];
            w[2] = (double)im[(i - 1) * W + k - 1] * (double)tIM[k];
            w[3] = (double)dm[(i - 1) * W + k - 1] * (double)tDM[k];
            static const int nxts[4] = { T_B, T_M, T_I, T_D };
            nxt = nxts[bio_choose_d(mt, &mti, w, 4)];
            i -= 1;
            k -= 1;
        } else if (st == T_D) {
            double w[2];
            w[0] = (double)mm[i * W + k - 1] * (double)tMD[k];
            w[1] = (double)dm[i * W + k - 1] * (double)tDD[k];
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_M : T_D;
            k -= 1;
        } else if (st == T_I) {
            double w[2];
            w[0] = (double)mm[(i - 1) * W + k] * (double)tMI[k];
            w[1] = (double)im[(i - 1) * W + k] * (double)tII[k];
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_M : T_I;
            i -= 1;
        } else if (st == T_B) {
            double w[2];
            w[0] = (double)xN[i] * nmove;
            w[1] = (double)xJ[i] * jmove;
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_N : T_J;
        } else if (st == T_J) {
            double w[2];
            w[0] = (i > 0) ? (double)xJ[i - 1] * jloop
                / (double)scale[i] : 0.0;
            w[1] = (double)xE[i] * eloop;
            nxt = (bio_choose_d(mt, &mti, w, 2) == 0) ? T_J : T_E;
            if (nxt == T_J) i -= 1;
        } else if (st == T_N) {
            nxt = (i == 0) ? T_S : T_N;
            if (nxt == T_N) i -= 1;
        } else {
            return -2;
        }
        if (nxt == T_M || nxt == T_I) EMIT2(nxt, k, (int32_t)i);
        else if (nxt == T_D) EMIT2(T_D, k, 0);
        else EMIT2(nxt, 0, (nxt == T_S) ? 0 : (int32_t)i);
        st = nxt;
    }
#undef EMIT2
    *mti_io = mti;
    return n;
}

// Standard posterior decoding (mirrors ops/reference/fwdback.py
// decoding; ref: p7_Decoding decoding.c:55).  f32 op order identical
// to the numpy rows: (f*b)*totr, ((f*b)*loop)*sp.  Returns 1 on
// scaleproduct overflow (caller raises RangeError).
int bio_decoding(int64_t L, int M,
    const float* fmm, const float* fim,
    const float* fxN, const float* fxJ, const float* fxC,
    const float* fscale,
    const float* bmm, const float* bim,
    const float* bxN, const float* bxJ, const float* bxC,
    const float* bscale, int b_own,
    float nloop, float jloop, float cloop,
    float* pmm, float* pim,
    float* pxN, float* pxJ, float* pxC) {
    const int W = M + 1;
    float sp = 1.0f / bxN[0];
    for (int64_t i = 1; i <= L; i++) {
        float totr = sp * fscale[i];
        const float* fm = fmm + i * W;
        const float* bm = bmm + i * W;
        const float* fi = fim + i * W;
        const float* bi = bim + i * W;
        float* pm = pmm + i * W;
        float* pi = pim + i * W;
        for (int k = 0; k < W; k++) pm[k] = (fm[k] * bm[k]) * totr;
        for (int k = 0; k < W; k++) pi[k] = (fi[k] * bi[k]) * totr;
        pxN[i] = ((fxN[i - 1] * bxN[i]) * nloop) * sp;
        pxJ[i] = ((fxJ[i - 1] * bxJ[i]) * jloop) * sp;
        pxC[i] = ((fxC[i - 1] * bxC[i]) * cloop) * sp;
        if (b_own) sp = (sp * fscale[i]) / bscale[i];
    }
    return std::isinf(sp) ? 1 : 0;
}

// Standard OA traceback (mirrors ops/reference/fwdback.py oa_trace;
// ref: p7_OATrace optacc.c:230).  Striped select_e traversal (stripe
// width 4, M-pass >= then D-pass > per stripe), first-max argmax for
// select_m, f32 adds converted to f64 for the C/J comparisons.
// Returns the number of (reversed) steps, or -1 on overflow/error.
int64_t bio_oa_trace(int64_t L, int M,
    const float* omm, const float* oim, const float* odm,
    const float* oxE, const float* oxN, const float* oxJ,
    const float* oxB, const float* oxC,
    const float* pmm, const float* pim,
    const float* pxN, const float* pxJ, const float* pxC,
    const float* tfv, const float* xff,
    int32_t* o_st, int32_t* o_k, int32_t* o_i, float* o_pp,
    int64_t max_out) {
    enum { T_M = 1, T_D = 2, T_I = 3, T_S = 4, T_N = 5, T_B = 6,
           T_E = 7, T_C = 8, T_T = 9, T_J = 10 };
    enum { P_MM = 0, P_IM = 1, P_DM = 2, P_BM = 3, P_MD = 4,
           P_DD = 5, P_MI = 6, P_II = 7 };
    const double NEG = -HUGE_VAL;
    const int W = M + 1;
    const int Qf = (M + 3) / 4 > 1 ? (M + 3) / 4 : 1;
    const float nmove = xff[1], jloop = xff[2], jmove = xff[3],
        cloop = xff[4], eloop = xff[6], emove = xff[7];
#define TPS(slot, t) (((slot) >= 0 && (slot) < M) \
    ? tfv[(int64_t)(slot) * 8 + (t)] : 0.0f)
#define EMITS(S, K, I, PP) do { \
    if (n >= max_out) return -1; \
    o_st[n] = (S); o_k[n] = (K); o_i[n] = (I); o_pp[n] = (PP); n++; \
} while (0)
    int64_t n = 0;
    int64_t i = L;
    int k = 0;
    EMITS(T_T, 0, 0, 0.f);
    EMITS(T_C, 0, 0, 0.f);
    int s0 = T_C, s1 = T_C;
    while (s0 != T_S) {
        if (s0 == T_M) {
            double p[4];
            p[0] = (k >= 2 && TPS(k - 1, P_MM) > 0.f)
                ? (double)omm[(i - 1) * W + k - 1] : NEG;
            p[1] = (k >= 2 && TPS(k - 1, P_IM) > 0.f)
                ? (double)oim[(i - 1) * W + k - 1] : NEG;
            p[2] = (k >= 2 && TPS(k - 1, P_DM) > 0.f)
                ? (double)odm[(i - 1) * W + k - 1] : NEG;
            p[3] = (TPS(k - 1, P_BM) > 0.f)
                ? (double)oxB[i - 1] : NEG;
            int best = 0;
            for (int a = 1; a < 4; a++) if (p[a] > p[best]) best = a;
            static const int sts[4] = { T_M, T_I, T_D, T_B };
            s1 = sts[best];
            k -= 1;
            i -= 1;
        } else if (s0 == T_D) {
            float p0 = (k >= 2 && TPS(k - 1, P_MD) > 0.f)
                ? omm[i * W + k - 1] : -HUGE_VALF;
            float p1 = (k >= 2 && TPS(k - 1, P_DD) > 0.f)
                ? odm[i * W + k - 1] : -HUGE_VALF;
            s1 = (p0 >= p1) ? T_M : T_D;
            k -= 1;
        } else if (s0 == T_I) {
            float p0 = (TPS(k, P_MI) > 0.f)
                ? omm[(i - 1) * W + k] : -HUGE_VALF;
            float p1 = (TPS(k, P_II) > 0.f)
                ? oim[(i - 1) * W + k] : -HUGE_VALF;
            s1 = (p0 >= p1) ? T_M : T_I;
            i -= 1;
        } else if (s0 == T_N) {
            s1 = (i == 0) ? T_S : T_N;
        } else if (s0 == T_C) {
            // numpy wraps xC[-1] to xC[L] when i==0
            int64_t im1 = (i - 1 >= 0) ? i - 1 : L;
            double p0 = (cloop != 0.f)
                ? (double)(oxC[im1] + pxC[i]) : NEG;
            double p1 = (emove != 0.f) ? (double)oxE[i] : NEG;
            s1 = (p0 > p1) ? T_C : T_E;
        } else if (s0 == T_J) {
            int64_t im1 = (i - 1 >= 0) ? i - 1 : L;
            double p0 = (jloop != 0.f)
                ? (double)(oxJ[im1] + pxJ[i]) : NEG;
            double p1 = (eloop != 0.f) ? (double)oxE[i] : NEG;
            s1 = (p0 > p1) ? T_J : T_E;
        } else if (s0 == T_E) {
            double mx = NEG;
            int smax = T_M, kmax = 1;
            for (int q = 0; q < Qf; q++) {
                for (int r = 0; r < 4; r++) {
                    int kk = r * Qf + q + 1;
                    double vM = (kk <= M)
                        ? (double)omm[i * W + kk] : 0.0;
                    if (vM >= mx) { mx = vM; smax = T_M; kmax = kk; }
                }
                for (int r = 0; r < 4; r++) {
                    int kk = r * Qf + q + 1;
                    double vD = (kk <= M)
                        ? (double)odm[i * W + kk] : 0.0;
                    if (vD > mx) { mx = vD; smax = T_D; kmax = kk; }
                }
            }
            k = kmax;
            s1 = smax;
        } else if (s0 == T_B) {
            double p0 = (nmove != 0.f) ? (double)oxN[i] : NEG;
            double p1 = (jmove != 0.f) ? (double)oxJ[i] : NEG;
            s1 = (p0 > p1) ? T_N : T_J;
        } else {
            return -1;
        }

        float postprob = 0.f;
        if (s1 == T_M) postprob = pmm[i * W + k];
        else if (s1 == T_I) postprob = pim[i * W + k];
        else if (s1 == s0 && s1 == T_N) postprob = pxN[i];
        else if (s1 == s0 && s1 == T_C) postprob = pxC[i];
        else if (s1 == s0 && s1 == T_J) postprob = pxJ[i];

        if (s1 == T_M || s1 == T_I) {
            EMITS(s1, k, (int32_t)i, postprob);
        } else if ((s1 == T_N || s1 == T_C || s1 == T_J) && s1 == s0) {
            EMITS(s1, 0, (int32_t)i, postprob);
        } else {
            EMITS(s1, (s1 == T_D) ? k : 0, 0, postprob);
        }
        if ((s1 == T_N || s1 == T_J || s1 == T_C) && s1 == s0) i -= 1;
        s0 = s1;
    }
#undef TPS
#undef EMITS
    return n;
}

// _close(r_tol=1e-5, a_tol=1e-4) from splice/viterbi_spliced.py
static inline bool bio_sp_close(double a, double b) {
    if (a == b) return true;
    if (!std::isfinite(a) || !std::isfinite(b)) return false;
    double d = fabs(a - b);
    double fa = fabs(a), fb = fabs(b);
    double m = fa > fb ? fa : fb;
    return d <= 1e-4 || d <= 1e-5 * m;
}

// Spliced-Viterbi traceback (mirrors splice/viterbi_spliced.py
// viterbi_spliced_trace; ref: p7_GViterbi_SplicedTrace
// generic_viterbi_spliced.c:483).  All arithmetic in f64 on
// f32-stored cells, identical op order to the Python oracle; the
// tolerance comparator replicates _close(r_tol=1e-5, a_tol=1e-4).
// Returns 0 on success, 1 on an untraceable cell (caller raises).
int bio_spliced_vit_trace(
    const int32_t* sub, int64_t L, int M, int Mfull,
    const float* rsc, int W,
    const float* tsc,
    float xsc_cmove, float xsc_cloop, float xsc_emove, float xsc_nmove,
    const double* sigsc,
    const float* mmx, const float* imx, const float* dmx,
    const float* xN, const float* xB, const float* xEv, const float* xCv,
    int k_start, int i_start, int min_intron, double tsc_p,
    int32_t* out_st, int32_t* out_k, int32_t* out_i, int32_t* out_c,
    int64_t cap, int64_t* out_n, double* out_vsc) {
    enum { T_M = 0, T_D = 1, T_I = 2, T_S = 3, T_N = 4, T_B = 5,
           T_E = 6, T_C = 7, T_P = 8 };
    enum { S_GTAG = 0, S_GCAG = 1, S_ATAC = 2,
           ACCEPT_AG = 2, ACCEPT_AC = 1,
           DONOR_GT = 11, DONOR_GC = 9, DONOR_AT = 3 };
    const int Wl = M + 1;
    const float NEGF = -HUGE_VALF;

#define NTL(il) (((il) < 1 || (il) > L) ? 65 \
                 : (sub[(il) - 1] < 4 ? sub[(il) - 1] : 65))
#define CODON1(v, w, x) \
    ({ int64_t _ci = (int64_t)(x) * 16 + (int64_t)(w) * 4 + (v); \
       _ci < 64 ? _ci : 64; })
#define TSCG(t, kg) (((kg) < 0 || (kg) >= Mfull) ? -HUGE_VAL \
                     : (double)tsc[(int64_t)(kg) * 8 + (t)])
#define CLOSE(a, b) bio_sp_close((a), (b))

    int64_t i = L;
    int k = 0;
    double vsc = (double)xCv[L] + (double)xsc_cmove;
    int64_t n = 0;
#define APPEND(s, kk, ii, cc) do { \
        if (n >= cap) return 10; \
        out_st[n] = (s); \
        out_k[n] = (kk) > 0 ? k_start + (kk) - 1 : 0; \
        out_i[n] = (ii) > 0 ? (int32_t)(i_start + (ii) - 1) : 0; \
        out_c[n] = (cc); \
        n++; \
    } while (0)

    APPEND(9, 0, i, 0);          // T terminal marker
    APPEND(T_C, 0, i, 0);
    int sprv = T_C;
    int64_t donor_i = -1;
    int c = 0;
    while (sprv != T_S) {
        int scur = -1;
        if (sprv == T_C) {
            bool lt = (i >= 2 && xCv[i] < xCv[i - 2])
                      || (i >= 1 && xCv[i] < xCv[i - 1]);
            if (lt) {
                scur = T_C;
            } else if (xCv[i] == NEGF) {
                return 11;
            } else if (i >= 3 && CLOSE((double)xCv[i],
                                       (double)xCv[i - 3]
                                       + (double)xsc_cloop)) {
                scur = T_C;
            } else if (CLOSE((double)xCv[i],
                             (double)xEv[i] + (double)xsc_emove)) {
                scur = T_E;
            } else {
                return 12;
            }
        } else if (sprv == T_E) {
            if (xEv[i] == NEGF) return 13;
            scur = -1;
            for (int kq = M; kq >= 1; kq--) {
                if (CLOSE((double)xEv[i], (double)mmx[i * Wl + kq])) {
                    scur = T_M; k = kq; break;
                }
                if (CLOSE((double)xEv[i], (double)dmx[i * Wl + kq])) {
                    scur = T_D; k = kq; break;
                }
            }
            if (scur < 0) return 14;
        } else if (sprv == T_M) {
            if (mmx[i * Wl + k] == NEGF) return 15;
            if (i < 3) return 16;   // oracle would fail via row wrap
            int v = NTL(i - 2), w = NTL(i - 1), x = NTL(i);
            int sub_k = k_start + k - 1;
            double emit = (double)rsc[CODON1(v, w, x) * W + sub_k];
            double cur = (double)mmx[i * Wl + k];
            if (CLOSE(cur, (double)mmx[(i - 3) * Wl + k - 1]
                      + TSCG(0, sub_k - 1) + emit)) {          // P_MM
                scur = T_M;
            } else if (CLOSE(cur, (double)imx[(i - 3) * Wl + k - 1]
                             + TSCG(1, sub_k - 1) + emit)) {   // P_IM
                scur = T_I;
            } else if (CLOSE(cur, (double)dmx[(i - 3) * Wl + k - 1]
                             + TSCG(2, sub_k - 1) + emit)) {   // P_DM
                scur = T_D;
            } else if (CLOSE(cur, (double)xB[i - 3] + emit)) {
                scur = T_B;
            } else {
                // P state: re-derive the donor site by scanning
                if (i < min_intron + 7) return 17;
                vsc -= tsc_p;
                int acc[3] = {0, 0, 0};
                static const int a_offs[3] = {7, 6, 5};
                for (int slot = 0; slot < 3; slot++) {
                    int aa = NTL(i - a_offs[slot]);
                    int bb = NTL(i - a_offs[slot] + 1);
                    if (aa <= 3 && bb <= 3) {
                        int s = 4 * aa + bb;
                        if (s == ACCEPT_AG) acc[slot] = 1;
                        else if (s == ACCEPT_AC) acc[slot] = 2;
                    }
                }
                if (!acc[0] && !acc[1] && !acc[2]) return 18;
                scur = -1;
                for (int64_t j = 0; j < i - min_intron - 4; j++) {
                    int da = NTL(i - min_intron - j - 1);
                    int db = NTL(i - min_intron - j);
                    if (da > 3 || db > 3) continue;
                    int s = 4 * da + db;
                    int don_sig;
                    if (s == DONOR_GT) don_sig = S_GTAG;
                    else if (s == DONOR_GC) don_sig = S_GCAG;
                    else if (s == DONOR_AT) don_sig = S_ATAC;
                    else continue;
                    int t_ = NTL(i - min_intron - j - 3);
                    int u_ = NTL(i - min_intron - j - 2);
                    int v_ = NTL(i - 5), w_ = NTL(i - 4),
                        x_ = NTL(i - 3);
                    double emit2 =
                        (double)rsc[CODON1(t_, u_, x_) * W + sub_k - 1];
                    double emit1 =
                        (double)rsc[CODON1(u_, w_, x_) * W + sub_k - 1];
                    double emit0 =
                        (double)rsc[CODON1(v_, w_, x_) * W + sub_k - 1];
                    int want = (don_sig == S_ATAC) ? 2 : 1;
                    const double emxs[3] = {emit2, emit1, emit0};
                    const int64_t dis[3] = {i - min_intron - j - 4,
                                            i - min_intron - j - 3,
                                            i - min_intron - j - 2};
                    static const int ccs[3] = {2, 1, 0};
                    // numpy wraps k-2 == -1 to the last column; the
                    // oracle relies on that for (pathological) k==1
                    int kc = k - 2 >= 0 ? k - 2 : k - 2 + Wl;
                    for (int q = 0; q < 3; q++) {
                        int cc = ccs[q];
                        if (acc[cc] != want) continue;
                        double m0 = (double)mmx[dis[q] * Wl + kc];
                        double d0 = (double)dmx[dis[q] * Wl + kc];
                        double ps = (m0 > d0 ? m0 : d0)
                            + sigsc[don_sig] + emxs[q];
                        if (CLOSE(cur, ps + tsc_p + emit)) {
                            scur = T_P;
                            c = cc;
                            donor_i = dis[q];
                            vsc -= sigsc[don_sig];
                            break;
                        }
                    }
                    if (scur == T_P) break;
                }
                if (scur != T_P) return 19;
            }
            k -= 1;
            i -= 3;
        } else if (sprv == T_D) {
            if (dmx[i * Wl + k] == NEGF) return 20;
            int sub_k = k_start + k - 1;
            if (CLOSE((double)dmx[i * Wl + k],
                      (double)mmx[i * Wl + k - 1]
                      + TSCG(4, sub_k - 1))) {                 // P_MD
                scur = T_M;
            } else if (CLOSE((double)dmx[i * Wl + k],
                             (double)dmx[i * Wl + k - 1]
                             + TSCG(5, sub_k - 1))) {          // P_DD
                scur = T_D;
            } else {
                return 21;
            }
            k -= 1;
        } else if (sprv == T_I) {
            if (imx[i * Wl + k] == NEGF) return 22;
            if (i < 3) return 23;   // oracle would fail via row wrap
            int sub_k = k_start + k - 1;
            if (CLOSE((double)imx[i * Wl + k],
                      (double)mmx[(i - 3) * Wl + k]
                      + TSCG(6, sub_k))) {                     // P_MI
                scur = T_M;
            } else if (CLOSE((double)imx[i * Wl + k],
                             (double)imx[(i - 3) * Wl + k]
                             + TSCG(7, sub_k))) {              // P_II
                scur = T_I;
            } else {
                return 24;
            }
            i -= 3;
        } else if (sprv == T_P) {
            scur = (mmx[donor_i * Wl + k - 1]
                    > dmx[donor_i * Wl + k - 1]) ? T_M : T_D;
            k -= 1;
            i = donor_i;
        } else if (sprv == T_N) {
            if (xN[i] == NEGF) return 25;
            scur = (i == 0) ? T_S : T_N;
        } else if (sprv == T_B) {
            vsc += TSCG(3, k_start + k - 1);                   // P_BM
            if (xB[i] == NEGF) return 26;
            if (CLOSE((double)xB[i],
                      (double)xN[i] + (double)xsc_nmove)) {
                scur = T_N;
            } else {
                return 27;
            }
        } else {
            return 28;
        }

        if (scur == T_M) c = 3;
        else if (scur != T_P) c = 0;
        APPEND(scur, k, i, c);
        if ((scur == T_N || scur == T_C) && scur == sprv) i -= 1;
        sprv = scur;
    }
#undef APPEND
#undef NTL
#undef CODON1
#undef TSCG
#undef CLOSE
    *out_n = n;
    *out_vsc = vsc;
    return 0;
}

}  // extern "C"