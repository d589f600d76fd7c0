/* Motion replay of the native parse: merge and AMVP candidate derivation
 * (spec 8.5.3.2) over the CU/PU syntax events that ctu.c records for P and
 * B slices, ONE call a picture (native/parse.py NativeParseState
 * .replay_motion).  ctypes releases the interpreter lock for the call.
 *
 * Mirrors golden/mv.py bit for bit -- derive_merge_list, derive_amvp,
 * MotionCtx.motion_at / temporal_candidate / store_pu, scale_mv -- and
 * syntax/ctu.py wrap_mv, which the Python parser (syntax/ctu.py, the PCM
 * fallback) still derives motion with:
 *   - a neighbour is available when its CU is marked in the replay grid (a
 *     CU is marked when the NEXT CU event arrives, as the parser marks it
 *     after its last PU) and it lies in the current CU's tile and slice, or
 *     when a PU of the current CU already stored motion there (the per-CU
 *     serial of motion_coded);
 *   - candidates compare reference pictures by POC, as golden/mv.py does;
 *   - the AMVP path leaves lt False, as the Python parser does.
 *
 * The library is built from this file, which includes ctu.c (which
 * includes cabac.c): one translation unit. */
#include <stdlib.h>

#include "ctu.c"

#define R_NO_REF (-(1 << 30))
#define R_MAX_CANDS 16
#define PU_W 14   /* x, y, w, h, mv[2][2], ref_idx[2], ref_poc[2], lt[2] */

typedef struct {
    int32_t mv[2][2];
    int32_t ref_idx[2];
    int32_t ref_poc[2];
    int32_t lt[2];
} RMotion;

typedef struct {
    const int32_t *ev;            /* [n_ev, EV_W] */
    int32_t n_ev;
    int32_t pic_width, pic_height, log2_ctb, wc, h4, w4;
    const int32_t *tile_map4;     /* [h4, w4] */
    const int32_t *slice_of_ctb;  /* [num_ctbs] */
    const int32_t *intra_map;     /* [h4, w4] */
    const int32_t *list_poc[2];
    const uint8_t *list_lt[2];
    int32_t n_poc[2], n_lt[2];
    int32_t poc, no_backward, tmvp, collocated_from_l0;
    const int32_t *col_mv;        /* [col_h, col_w, 2, 2]; NULL: none */
    const int32_t *col_ref_poc;   /* [col_h, col_w, 2] */
    const uint8_t *col_lt;        /* [col_h, col_w, 2]; NULL: all zero */
    int32_t col_h, col_w, col_poc;
    int32_t *mv;                  /* MotionCtx grids, [h4, w4, ...] */
    int32_t *ref_idx;
    int32_t *ref_poc;
    uint8_t *lt;
    int64_t *motion_coded;
    int64_t cur_cu;               /* in and out: MotionCtx.cur_cu */
    int32_t *pus;                 /* [cap_pus, PU_W] */
    int32_t n_pus, cap_pus;
} NReplay;

typedef struct {
    NReplay *r;
    uint8_t *avail;               /* the replay grid, [h4, w4] */
    int32_t cur_tile, cur_slice;
    int err;
} RState;

static const int COMB_IDX[12][2] = {
    {0, 1}, {1, 0}, {0, 2}, {2, 0}, {1, 2}, {2, 1},
    {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};

static inline void r_clear(RMotion *m) {
    m->mv[0][0] = m->mv[0][1] = m->mv[1][0] = m->mv[1][1] = 0;
    m->ref_idx[0] = m->ref_idx[1] = -1;
    m->ref_poc[0] = m->ref_poc[1] = R_NO_REF;
    m->lt[0] = m->lt[1] = 0;
}

static inline int32_t r_list_poc(RState *s, int lx, int i) {
    if (i < 0 || i >= s->r->n_poc[lx]) { s->err = 1; return 0; }
    return s->r->list_poc[lx][i];
}

static inline int r_list_lt(RState *s, int lx, int i) {
    if (i < 0 || i >= s->r->n_lt[lx]) { s->err = 1; return 0; }
    return s->r->list_lt[lx][i] != 0;
}

static inline int32_t r_clip(int64_t v, int32_t lo, int32_t hi) {
    return (int32_t)(v < lo ? lo : (v > hi ? hi : v));
}

/* C-style truncating division (golden/mv.py _trunc_div) */
static inline int64_t r_trunc_div(int64_t a, int64_t b) {
    int64_t q = (a < 0 ? -a : a) / (b < 0 ? -b : b);
    return ((a < 0) != (b < 0)) ? -q : q;
}

/* temporal MV scaling (spec 8.5.3.2.8 eq 8-175..8-177) */
static void r_scale_mv(const int32_t mv[2], int64_t tb, int64_t td,
                       int32_t out[2]) {
    tb = r_clip(tb, -128, 127);
    td = r_clip(td, -128, 127);
    if (td == tb) { out[0] = mv[0]; out[1] = mv[1]; return; }
    int64_t tx = r_trunc_div(16384 + ((td < 0 ? -td : td) >> 1), td);
    int64_t dsf = r_clip((tb * tx + 32) >> 6, -4096, 4095);
    for (int c = 0; c < 2; c++) {
        int64_t p = dsf * mv[c];
        int64_t a = ((p < 0 ? -p : p) + 127) >> 8;
        out[c] = r_clip(p < 0 ? -a : a, -32768, 32767);
    }
}

/* 16-bit wrap-around of mvp + mvd (spec 8.5.3.1 eq 8-95) */
static inline int32_t r_wrap_mv(int64_t v) {
    int64_t u = ((v % 65536) + 65536) % 65536;
    return (int32_t)(u >= 32768 ? u - 65536 : u);
}

static inline int r_uses(const RMotion *m, int lx) {
    return m->ref_idx[lx] >= 0;
}

static int r_same_motion(const RMotion *a, const RMotion *b) {
    for (int lx = 0; lx < 2; lx++) {
        if (r_uses(a, lx) != r_uses(b, lx)) return 0;
        if (r_uses(a, lx) && (a->mv[lx][0] != b->mv[lx][0]
                              || a->mv[lx][1] != b->mv[lx][1]
                              || a->ref_idx[lx] != b->ref_idx[lx]))
            return 0;
    }
    return 1;
}

/* the replay availability of (x, y), inside the picture */
static inline int r_avail(RState *s, int x, int y) {
    const NReplay *r = s->r;
    size_t i = (size_t)(y >> 2) * r->w4 + (x >> 2);
    if (r->tile_map4[i] != s->cur_tile) return 0;
    if (r->slice_of_ctb[(y >> r->log2_ctb) * r->wc + (x >> r->log2_ctb)]
        != s->cur_slice) return 0;
    return s->avail[i];
}

/* MotionCtx.motion_at: motion of the coded block covering luma (x, y);
 * 0 if unavailable or intra */
static int r_motion_at(RState *s, int x, int y, RMotion *m) {
    const NReplay *r = s->r;
    if (x < 0 || y < 0 || x >= r->pic_width || y >= r->pic_height) return 0;
    size_t i = (size_t)(y >> 2) * r->w4 + (x >> 2);
    if (!(r_avail(s, x, y)
          || (r->cur_cu && r->motion_coded[i] == r->cur_cu))) return 0;
    if (r->intra_map[i]) return 0;
    const int32_t *ri = r->ref_idx + i * 2;
    if (ri[0] < 0 && ri[1] < 0) return 0;
    for (int lx = 0; lx < 2; lx++) {
        m->mv[lx][0] = r->mv[i * 4 + lx * 2];
        m->mv[lx][1] = r->mv[i * 4 + lx * 2 + 1];
        m->ref_idx[lx] = ri[lx];
        m->ref_poc[lx] = r->ref_poc[i * 2 + lx];
        m->lt[lx] = r->lt[i * 2 + lx] != 0;
    }
    return 1;
}

/* MotionCtx._col_motion_at: the collocated picture's motion at (x, y) */
static int r_col_at(const NReplay *r, int x, int y, size_t *idx) {
    int x16 = x >> 4, y16 = y >> 4;
    if (y16 >= r->col_h || x16 >= r->col_w) return 0;
    size_t i = (size_t)y16 * r->col_w + x16;
    const int32_t *rp = r->col_ref_poc + i * 2;
    if (rp[0] == R_NO_REF && rp[1] == R_NO_REF) return 0;
    *idx = i;
    return 1;
}

/* MotionCtx.temporal_candidate (spec 8.5.3.2.8) -> 1 with out set */
static int r_temporal(RState *s, int x_pb, int y_pb, int n_w, int n_h,
                      int lx, int ref_idx, int32_t out[2]) {
    const NReplay *r = s->r;
    if (!r->col_mv) return 0;
    int x_br = x_pb + n_w, y_br = y_pb + n_h;
    size_t i = 0;
    int got = 0;
    if (x_br < r->pic_width && y_br < r->pic_height
        && (y_br >> r->log2_ctb) == (y_pb >> r->log2_ctb))
        got = r_col_at(r, (x_br >> 4) << 4, (y_br >> 4) << 4, &i);
    if (!got) {
        int xc = x_pb + (n_w >> 1), yc = y_pb + (n_h >> 1);
        got = r_col_at(r, (xc >> 4) << 4, (yc >> 4) << 4, &i);
    }
    if (!got) return 0;
    const int32_t *rp = r->col_ref_poc + i * 2;
    int l_col;
    if (rp[0] == R_NO_REF) l_col = 1;
    else if (rp[1] == R_NO_REF) l_col = 0;
    else if (r->no_backward) l_col = lx;
    else l_col = r->collocated_from_l0 ? 0 : 1;
    const int32_t *mv_col = r->col_mv + i * 4 + l_col * 2;
    int col_lt = r->col_lt ? r->col_lt[i * 2 + l_col] != 0 : 0;
    int target_lt = r_list_lt(s, lx, ref_idx);
    if (col_lt != target_lt) return 0;
    if (target_lt) { out[0] = mv_col[0]; out[1] = mv_col[1]; return 1; }
    int64_t tb = (int64_t)r->poc - r_list_poc(s, lx, ref_idx);
    int64_t td = (int64_t)r->col_poc - rp[l_col];
    if (td == 0) td = 1;
    r_scale_mv(mv_col, tb, td, out);
    return 1;
}

/* derive_merge_list (spec 8.5.3.2.2-8.5.3.2.5) -> the candidate count */
static int r_merge_list(RState *s, int x_pb, int y_pb, int n_w, int n_h,
                        int part, int part_idx, int max_cands,
                        RMotion *cands) {
    const NReplay *r = s->r;
    int is_b = r->n_poc[1] > 0;
    RMotion a1, b1, b0, a0, b2;
    int h_a1 = 0, h_b1 = 0, h_b0, h_a0, h_b2 = 0;
    /* Nx2N, nLx2N, nRx2N: part 2, 6, 7; 2NxN, 2NxnU, 2NxnD: 1, 4, 5 */
    if (!(part_idx == 1 && (part == 2 || part == 6 || part == 7)))
        h_a1 = r_motion_at(s, x_pb - 1, y_pb + n_h - 1, &a1);
    if (!(part_idx == 1 && (part == 1 || part == 4 || part == 5)))
        h_b1 = r_motion_at(s, x_pb + n_w - 1, y_pb - 1, &b1);
    h_b0 = r_motion_at(s, x_pb + n_w, y_pb - 1, &b0);
    h_a0 = r_motion_at(s, x_pb - 1, y_pb + n_h, &a0);
    int n = 0;
    if (h_a1) cands[n++] = a1;
    if (h_b1 && !(h_a1 && r_same_motion(&b1, &a1))) cands[n++] = b1;
    if (h_b0 && !(h_b1 && r_same_motion(&b0, &b1))) cands[n++] = b0;
    if (h_a0 && !(h_a1 && r_same_motion(&a0, &a1))) cands[n++] = a0;
    if (h_a0 + h_a1 + h_b0 + h_b1 < 4) {
        h_b2 = r_motion_at(s, x_pb - 1, y_pb - 1, &b2);
        if (h_b2 && !((h_a1 && r_same_motion(&b2, &a1))
                      || (h_b1 && r_same_motion(&b2, &b1))))
            cands[n++] = b2;
    }
    /* temporal */
    if (r->tmvp && n < max_cands) {
        RMotion m;
        r_clear(&m);
        int32_t mv[2];
        int got = r_temporal(s, x_pb, y_pb, n_w, n_h, 0, 0, mv);
        if (got) {
            m.mv[0][0] = mv[0]; m.mv[0][1] = mv[1];
            m.ref_idx[0] = 0;
            m.ref_poc[0] = r_list_poc(s, 0, 0);
            m.lt[0] = r_list_lt(s, 0, 0);
        }
        if (is_b && got && r_temporal(s, x_pb, y_pb, n_w, n_h, 1, 0, mv)) {
            m.mv[1][0] = mv[0]; m.mv[1][1] = mv[1];
            m.ref_idx[1] = 0;
            m.ref_poc[1] = r_list_poc(s, 1, 0);
            m.lt[1] = r_list_lt(s, 1, 0);
        }
        if (got) cands[n++] = m;
    }
    if (n > max_cands) n = max_cands;
    /* combined bi-predictive (B only) */
    if (is_b && 1 < n && n < max_cands) {
        int n_orig = n;
        int n_comb = n_orig * (n_orig - 1);
        if (n_comb > 12) n_comb = 12;
        for (int k = 0; k < n_comb; k++) {
            int i = COMB_IDX[k][0], j = COMB_IDX[k][1];
            if (i >= n_orig || j >= n_orig) continue;
            const RMotion *ci = &cands[i], *cj = &cands[j];
            if (!(r_uses(ci, 0) && r_uses(cj, 1))) continue;
            if (ci->ref_poc[0] == cj->ref_poc[1]
                && ci->mv[0][0] == cj->mv[1][0]
                && ci->mv[0][1] == cj->mv[1][1]) continue;
            RMotion m;
            m.mv[0][0] = ci->mv[0][0]; m.mv[0][1] = ci->mv[0][1];
            m.ref_idx[0] = ci->ref_idx[0]; m.ref_poc[0] = ci->ref_poc[0];
            m.mv[1][0] = cj->mv[1][0]; m.mv[1][1] = cj->mv[1][1];
            m.ref_idx[1] = cj->ref_idx[1]; m.ref_poc[1] = cj->ref_poc[1];
            m.lt[0] = ci->lt[0]; m.lt[1] = cj->lt[1];
            cands[n++] = m;
            if (n == max_cands) break;
        }
    }
    /* zero candidates */
    int n0 = r->n_poc[0], n1 = r->n_poc[1];
    int num_refs = is_b ? (n0 < n1 ? n0 : n1) : n0;
    for (int zidx = 0; n < max_cands; zidx++) {
        int ri = zidx < num_refs ? zidx : 0;
        RMotion m;
        r_clear(&m);
        m.ref_idx[0] = ri;
        m.ref_poc[0] = n0 ? r_list_poc(s, 0, ri) : R_NO_REF;
        m.lt[0] = n0 ? r_list_lt(s, 0, ri) : 0;
        if (is_b) {
            m.ref_idx[1] = ri;
            m.ref_poc[1] = r_list_poc(s, 1, ri);
            m.lt[1] = r_list_lt(s, 1, ri);
        }
        cands[n++] = m;
    }
    /* 8x4/4x8 PUs: bi candidates become uni L0 (8.5.3.2.2 final step) */
    if (n_w + n_h == 12) {
        for (int k = 0; k < n; k++) {
            RMotion *m = &cands[k];
            if (r_uses(m, 0) && r_uses(m, 1)) {
                m->ref_idx[1] = -1;
                m->ref_poc[1] = R_NO_REF;
                m->mv[1][0] = m->mv[1][1] = 0;
                m->lt[1] = 0;
            }
        }
    }
    return n;
}

/* derive_amvp's candidate_from: pass 1 same POC (either list, unscaled);
 * pass 2 (allow_scaled) any reference of matching lt-ness */
static int r_amvp_side(RState *s, const int pos[][2], int n_pos, int lx,
                       int32_t target_poc, int target_lt, int allow_scaled,
                       int32_t out[2]) {
    RMotion m;
    for (int k = 0; k < n_pos; k++) {
        if (!r_motion_at(s, pos[k][0], pos[k][1], &m)) continue;
        for (int t = 0; t < 2; t++) {
            int ly = t ? 1 - lx : lx;
            if (r_uses(&m, ly) && m.ref_poc[ly] == target_poc) {
                out[0] = m.mv[ly][0]; out[1] = m.mv[ly][1];
                return 1;
            }
        }
    }
    if (!allow_scaled) return 0;
    for (int k = 0; k < n_pos; k++) {
        if (!r_motion_at(s, pos[k][0], pos[k][1], &m)) continue;
        for (int t = 0; t < 2; t++) {
            int ly = t ? 1 - lx : lx;
            if (r_uses(&m, ly) && m.lt[ly] == target_lt) {
                if (target_lt) {
                    out[0] = m.mv[ly][0]; out[1] = m.mv[ly][1];
                    return 1;
                }
                int64_t tb = (int64_t)s->r->poc - target_poc;
                int64_t td = (int64_t)s->r->poc - m.ref_poc[ly];
                if (td == 0) td = 1;
                r_scale_mv(m.mv[ly], tb, td, out);
                return 1;
            }
        }
    }
    return 0;
}

/* derive_amvp (spec 8.5.3.2.6-8.5.3.2.7) -> the predictor of index mvp */
static void r_amvp(RState *s, int x_pb, int y_pb, int n_w, int n_h, int lx,
                   int ref_idx, int mvp, int32_t out[2]) {
    int32_t target_poc = r_list_poc(s, lx, ref_idx);
    int target_lt = r_list_lt(s, lx, ref_idx);
    const int pos_a[2][2] = {{x_pb - 1, y_pb + n_h}, {x_pb - 1, y_pb + n_h - 1}};
    const int pos_b[3][2] = {{x_pb + n_w, y_pb - 1}, {x_pb + n_w - 1, y_pb - 1},
                             {x_pb - 1, y_pb - 1}};
    int32_t mv_a[2], mv_b[2], cands[3][2];
    int n = 0;
    int got_a = r_amvp_side(s, pos_a, 2, lx, target_poc, target_lt, 1, mv_a);
    /* B-side scaling only when no A neighbour exists at all (isScaledFlag) */
    RMotion m;
    int a_exists = r_motion_at(s, pos_a[0][0], pos_a[0][1], &m)
                   || r_motion_at(s, pos_a[1][0], pos_a[1][1], &m);
    int got_b = r_amvp_side(s, pos_b, 3, lx, target_poc, target_lt,
                            !a_exists, mv_b);
    if (got_a) { cands[n][0] = mv_a[0]; cands[n][1] = mv_a[1]; n++; }
    if (got_b && !(got_a && mv_b[0] == mv_a[0] && mv_b[1] == mv_a[1])) {
        cands[n][0] = mv_b[0]; cands[n][1] = mv_b[1]; n++;
    }
    if (n < 2 && s->r->tmvp) {
        int32_t mv_t[2];
        if (r_temporal(s, x_pb, y_pb, n_w, n_h, lx, ref_idx, mv_t)) {
            cands[n][0] = mv_t[0]; cands[n][1] = mv_t[1]; n++;
        }
    }
    while (n < 2) { cands[n][0] = cands[n][1] = 0; n++; }
    out[0] = cands[mvp][0];
    out[1] = cands[mvp][1];
}

/* MotionCtx.store_pu (numpy slices clip to the grid) */
static void r_store_pu(NReplay *r, int x, int y, int w, int h,
                       const RMotion *m) {
    int x4a = x >> 2, y4a = y >> 2, x4b = (x + w) >> 2, y4b = (y + h) >> 2;
    if (x4a < 0) x4a = 0;
    if (y4a < 0) y4a = 0;
    if (x4b > r->w4) x4b = r->w4;
    if (y4b > r->h4) y4b = r->h4;
    for (int yy = y4a; yy < y4b; yy++) {
        for (int xx = x4a; xx < x4b; xx++) {
            size_t i = (size_t)yy * r->w4 + xx;
            for (int lx = 0; lx < 2; lx++) {
                r->mv[i * 4 + lx * 2] = m->mv[lx][0];
                r->mv[i * 4 + lx * 2 + 1] = m->mv[lx][1];
                r->ref_idx[i * 2 + lx] = m->ref_idx[lx];
                r->ref_poc[i * 2 + lx] = m->ref_poc[lx];
                r->lt[i * 2 + lx] = m->lt[lx] != 0;
            }
            r->motion_coded[i] = r->cur_cu;
        }
    }
}

/* the replay grid: a CU's samples (clipped to the picture) become available
 * once the next CU starts */
static void r_mark(RState *s, int x0, int y0, int size) {
    NReplay *r = s->r;
    int x1 = x0 + size < r->pic_width ? x0 + size : r->pic_width;
    int y1 = y0 + size < r->pic_height ? y0 + size : r->pic_height;
    int xb = (x1 + 3) >> 2, yb = (y1 + 3) >> 2;
    if (xb > r->w4) xb = r->w4;
    if (yb > r->h4) yb = r->h4;
    for (int yy = y0 >> 2; yy < yb; yy++)
        memset(s->avail + (size_t)yy * r->w4 + (x0 >> 2), 1,
               xb > (x0 >> 2) ? (size_t)(xb - (x0 >> 2)) : 0);
}

/* -> the number of PUs written to r->pus; < 0 on a malformed event stream
 * (-1 a reference index outside its list, -2 the PU table full, -3 a merge
 * index or candidate count out of range, -4 a CU outside the picture, -5 no
 * memory) */
EXPORT int replay_motion(NReplay *r) {
    RState s;
    s.r = r;
    s.cur_tile = 0;
    s.cur_slice = 0;
    s.err = 0;
    s.avail = (uint8_t *)calloc((size_t)r->h4 * r->w4 + 1, 1);
    if (!s.avail) return -5;
    int pending = 0, px0 = 0, py0 = 0, psize = 0, ret = 0;
    r->n_pus = 0;
    for (int k = 0; k < r->n_ev; k++) {
        const int32_t *e = r->ev + (size_t)k * EV_W;
        if (e[0] == EV_CU) {
            if (pending) r_mark(&s, px0, py0, psize);
            px0 = e[1]; py0 = e[2]; psize = 1 << e[3];
            if (px0 < 0 || py0 < 0 || px0 >= r->pic_width
                || py0 >= r->pic_height) { ret = -4; break; }
            pending = 1;
            s.cur_tile = r->tile_map4[(size_t)(py0 >> 2) * r->w4
                                      + (px0 >> 2)];
            s.cur_slice = r->slice_of_ctb[(py0 >> r->log2_ctb) * r->wc
                                          + (px0 >> r->log2_ctb)];
            r->cur_cu++;
            continue;
        }
        int x = e[1], y = e[2], w = e[3], h = e[4];
        RMotion motion;
        if (e[7]) {                              /* merge */
            RMotion cands[R_MAX_CANDS];
            int max_cands = e[18], midx = e[8];
            if (!pending || max_cands < 1 || max_cands > R_MAX_CANDS
                || midx < 0 || midx >= max_cands) { ret = -3; break; }
            r_merge_list(&s, x, y, w, h, e[5], e[6], max_cands, cands);
            motion = cands[midx];
        } else {
            int idc = e[9];
            r_clear(&motion);
            for (int lx = 0; lx < 2; lx++) {
                if ((idc == 0 && lx == 1) || (idc == 1 && lx == 0)) continue;
                int ridx = e[10 + lx], mvp = e[16 + lx];
                if (mvp < 0 || mvp > 1) { ret = -3; break; }
                int32_t pred[2];
                r_amvp(&s, x, y, w, h, lx, ridx, mvp, pred);
                motion.mv[lx][0] = r_wrap_mv((int64_t)pred[0] + e[12 + 2 * lx]);
                motion.mv[lx][1] = r_wrap_mv((int64_t)pred[1] + e[13 + 2 * lx]);
                motion.ref_idx[lx] = ridx;
                motion.ref_poc[lx] = r_list_poc(&s, lx, ridx);
                /* lt stays 0, as the Python parser leaves Motion.lt */
            }
            if (ret) break;
        }
        if (s.err) { ret = -s.err; break; }
        if (r->n_pus >= r->cap_pus) { ret = -2; break; }
        r_store_pu(r, x, y, w, h, &motion);
        int32_t *o = r->pus + (size_t)r->n_pus++ * PU_W;
        o[0] = x; o[1] = y; o[2] = w; o[3] = h;
        o[4] = motion.mv[0][0]; o[5] = motion.mv[0][1];
        o[6] = motion.mv[1][0]; o[7] = motion.mv[1][1];
        o[8] = motion.ref_idx[0]; o[9] = motion.ref_idx[1];
        o[10] = motion.ref_poc[0]; o[11] = motion.ref_poc[1];
        o[12] = motion.lt[0]; o[13] = motion.lt[1];
    }
    free(s.avail);
    return ret ? ret : r->n_pus;
}
