/* The deblocking edge parameters of one picture (spec 8.7.2): the boundary
 * strength, beta and tc of every 4-sample luma segment and the chroma tc of
 * every 4-sample chroma segment, both directions, ONE call a picture
 * (native/deblock.py edge_params).  ctypes releases the interpreter lock
 * for the call.
 *
 * Mirrors kernels/loopfilter.py bs_vec, luma_edge_params and
 * chroma_edge_params bit for bit:
 *   - a P or Q side intra gives bS 2; else a coded luma block (cbf) on
 *     either side, or (inter pictures: mv given) a motion difference gives
 *     1; else 0;
 *   - the motion difference: the number of lists used differs, or the two
 *     unordered sets of reference POCs (an unused list is NO_REF) differ,
 *     or the first used list's MVs differ by 4 or more quarter samples in
 *     either component, or both sides use both lists and their list-1 MVs
 *     differ so;
 *   - an edge is filtered where edge_flags has its bit (1 vertical, 2
 *     horizontal); beta and tc are read where bS > 0, their indices
 *     clipped to 0..51 and 0..53;
 *   - a chroma edge (every 16 luma samples) takes the bS and the mean QP of
 *     the luma segment on it (the first of each chroma segment's two), tc
 *     where bS is 2.
 * Vertical grids are [h/4, n_e] (luma) and [h/8, n_ce] (chroma), segment
 * by edge; horizontal ones are in the transposed layout, [w/4, n_e] and
 * [w/8, n_ce].  Every element of every grid is written.
 *
 * The library is built from this file, which includes replay.c (which
 * includes ctu.c, which includes cabac.c): one translation unit. */
#include "replay.c"

#define D_NO_REF (-(1 << 30))

typedef struct {
    int32_t w, h, h4, w4;         /* picture size; the maps' shape */
    const int32_t *intra_map;     /* [h4, w4] */
    const int32_t *cbf_map;       /* [h4, w4] */
    const int32_t *qp_map;        /* [h4, w4] */
    const int32_t *edge_flags;    /* [h4, w4] */
    const int32_t *mv;            /* [h4, w4, 2, 2]; NULL: an intra picture */
    const int32_t *ref_poc;       /* [h4, w4, 2] */
    int32_t beta_off, tc_off;     /* slice_beta/tc_offset_div2 * 2 */
    int32_t c_off[2];             /* pps cb / cr QP offsets */
    const int32_t *beta_table;    /* [52] */
    const int32_t *tc_table;      /* [54] */
    const int32_t *qpc_table;     /* [58] */
    int16_t *bs[2], *beta[2], *tc[2];   /* [0] vertical, [1] horizontal */
    int16_t *tcc[2][2];                 /* [direction][cb, cr] */
} NDeblock;

static inline int32_t d_clip(int32_t v, int32_t lo, int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline int d_ge4(const int32_t *a, const int32_t *b) {
    int64_t d0 = (int64_t)a[0] - b[0], d1 = (int64_t)a[1] - b[1];
    return d0 >= 4 || d0 <= -4 || d1 >= 4 || d1 <= -4;
}

/* the set of reference POCs of a 4x4 unit, sorted, a duplicate or an
 * unused list as BIG (loopfilter.py bs_vec ref_set) */
static inline void d_ref_set(const int32_t *r, int u0, int u1, int64_t *lo,
                             int64_t *hi) {
    const int64_t big = (int64_t)1 << 60;
    int64_t a = u0 ? r[0] : big, b = u1 ? r[1] : big;
    *lo = a < b ? a : b;
    *hi = a < b ? b : a;
    if (*lo == *hi) *hi = big;
}

/* bS of the edge between the 4x4 units at flat indices p and q */
static int d_bs(const NDeblock *d, int64_t p, int64_t q) {
    if (d->intra_map[p] || d->intra_map[q]) return 2;
    if (d->cbf_map[p] || d->cbf_map[q]) return 1;
    if (!d->mv) return 0;
    const int32_t *rp = d->ref_poc + 2 * p, *rq = d->ref_poc + 2 * q;
    int up0 = rp[0] != D_NO_REF, up1 = rp[1] != D_NO_REF;
    int uq0 = rq[0] != D_NO_REF, uq1 = rq[1] != D_NO_REF;
    int cnt_p = up0 + up1, cnt_q = uq0 + uq1;
    if (cnt_p != cnt_q) return 1;
    int64_t lp, hp, lq, hq;
    d_ref_set(rp, up0, up1, &lp, &hp);
    d_ref_set(rq, uq0, uq1, &lq, &hq);
    if (lp != lq || hp != hq) return 1;
    const int32_t *mp = d->mv + 4 * p, *mq = d->mv + 4 * q;
    if (d_ge4(up0 ? mp : mp + 2, uq0 ? mq : mq + 2)) return 1;
    return cnt_p == 2 && cnt_q == 2 && d_ge4(mp + 2, mq + 2);
}

/* one direction: dir 0 vertical edges (x = 8, 16, ...), 1 horizontal */
static void d_direction(const NDeblock *d, int dir) {
    int n_s = dir ? d->w / 4 : d->h / 4;         /* luma segments */
    int extent = dir ? d->h : d->w;              /* across the edges */
    int n_e = extent > 8 ? (extent - 1) / 8 : 0;
    int n_cs = dir ? d->w / 8 : d->h / 8;        /* chroma segments */
    int n_ce = extent > 16 ? (extent - 1) / 16 : 0;
    int bit = dir ? 2 : 1;
    /* a step of one 4x4 unit across the edge, and along it */
    int64_t across = dir ? d->w4 : 1, along = dir ? 1 : d->w4;
    int16_t *bs = d->bs[dir], *beta = d->beta[dir], *tc = d->tc[dir];
    for (int s = 0; s < n_s; s++) {
        for (int k = 0; k < n_e; k++) {
            int64_t q = s * along + (int64_t)(2 * (k + 1)) * across;
            int64_t p = q - across;
            int64_t o = (int64_t)s * n_e + k;
            int b = (d->edge_flags[q] & bit) ? d_bs(d, p, q) : 0;
            bs[o] = (int16_t)b;
            if (b > 0) {
                int32_t qpl = (d->qp_map[p] + d->qp_map[q] + 1) >> 1;
                beta[o] = (int16_t)d->beta_table[d_clip(qpl + d->beta_off,
                                                        0, 51)];
                tc[o] = (int16_t)d->tc_table[d_clip(
                    qpl + 2 * (b - 1) + d->tc_off, 0, 53)];
            } else {
                beta[o] = 0;
                tc[o] = 0;
            }
        }
    }
    /* chroma segment i, edge j: luma segment 2i, luma edge 2j + 1 */
    for (int i = 0; i < n_cs; i++) {
        for (int j = 0; j < n_ce; j++) {
            int64_t lo = (int64_t)(2 * i) * n_e + 2 * j + 1;
            int64_t o = (int64_t)i * n_ce + j;
            if (bs[lo] < 2) {
                d->tcc[dir][0][o] = d->tcc[dir][1][o] = 0;
                continue;
            }
            int64_t q = (int64_t)(2 * i) * along
                        + (int64_t)(4 * (j + 1)) * across;
            int32_t qpl = (d->qp_map[q - across] + d->qp_map[q] + 1) >> 1;
            for (int c = 0; c < 2; c++) {
                int32_t qpc = d->qpc_table[d_clip(qpl + d->c_off[c], 0, 57)];
                d->tcc[dir][c][o] = (int16_t)d->tc_table[d_clip(
                    qpc + 2 + d->tc_off, 0, 53)];
            }
        }
    }
}

EXPORT void deblock_params(const NDeblock *d) {
    d_direction(d, 0);
    d_direction(d, 1);
}
