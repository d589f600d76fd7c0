// Copy of p265_tpu/native/ctu.c.  Deviations: one comment names
// build_tensor_plan by its function name; the event stream's comment
// names the motion replay in C (replay.c).
/* Native Stage-A CTU parser (intra slices): SAO params + coding quadtree +
 * CU/TU syntax + residual decode for one CTU per call, emitting the
 * size-bucketed tensor-plan records (positions, wavefront steps, reference
 * gather tables, coefficients) directly -- no per-bin ctypes round trips and
 * no per-TU Python objects.
 *
 * Mirrors p265_tpu/syntax/ctu.py (CtuCoder decode path) and
 * p265_tpu/plan/frame_plan.py (build_tensor_plan) bit-for-bit; the Python
 * implementations remain the reference and tests assert exact agreement of
 * the decoded YUV (two independently written parsers must agree).
 *
 * Single-translation-unit build: includes cabac.c for the arithmetic engine
 * and the residual_coding hot loop.
 */
#include "cabac.c"

/* context block offsets (tables.CTX_OFFSET), filled by Python */
typedef struct {
    int split_cu_flag;
    int cu_transquant_bypass_flag;
    int cu_skip_flag;
    int merge_flag;
    int merge_idx;
    int part_mode;
    int pred_mode_flag;
    int prev_intra_luma_pred_flag;
    int intra_chroma_pred_mode;
    int inter_pred_idc;
    int abs_mvd_greater_flag;
    int ref_idx;
    int mvp_flag;
    int cu_qp_delta_abs;
    int cbf_luma;
    int cbf_chroma;
    int rqt_root_cbf;
    int sao_merge_flag;
    int sao_type_idx;
    int split_transform_flag;
    int transform_skip_flag;
    int last_x;
    int last_y;
    int csbf;
    int sig;
    int gt1;
    int gt2;
} NCtx;

typedef struct {
    /* geometry */
    int pic_width, pic_height;
    int log2_ctb, log2_min_cb, log2_min_tb, log2_max_tb;
    int max_tt_depth_intra;
    int w4, h4;              /* luma 4x4 grid */
    int wc;                  /* pic_width_ctbs */
    /* pps/sps flags */
    int transform_skip_enabled;
    int sign_data_hiding;
    int cu_qp_delta_enabled;
    int min_qg_log2;         /* log2_ctb - diff_cu_qp_delta_depth */
    int transquant_bypass_enabled;
    int strong_intra_smoothing;  /* unused here (bucket assembly) */
    int scaling_enabled;
    /* slice */
    int slice_qp;
    int slice_idx;
    int slice_type;          /* 0 = B, 1 = P, 2 = I */
    int sao_luma, sao_chroma;
    /* inter-slice syntax parameters */
    int max_merge_cand;
    int num_ref_l0, num_ref_l1;
    int mvd_l1_zero;
    int amp_enabled;
    int max_tt_depth_inter;
} NParams;

typedef struct {
    /* all [h4*w4] int32 (luma 4x4 grid) unless noted */
    int32_t *mode_map;       /* intra_mode_map */
    int32_t *depth_map;      /* ct_depth_map */
    int32_t *qp_map;
    int32_t *intra_map;
    int32_t *cbf_map;
    int32_t *edge_flags;
    int32_t *skip_map;
    int32_t *bypass_map;
    uint8_t *avail;          /* parse availability (luma grid) */
    int32_t *tile_map4;
    int32_t *slice_of_ctb;   /* [num_ctbs] */
} NMaps;

typedef struct {
    int last_cu_qp;
    int pred;
    int delta;
    int delta_coded;
    int qg_x, qg_y;
} NQp;

/* one size bucket of tensor-plan records (plane-major: p_idx*4 + log2-2) */
typedef struct {
    int32_t *meta;           /* [cap, 8]: y,x,step,mode,qp,flags,matrix_id,0 */
    int16_t *coeffs;         /* [cap, s*s] */
    int16_t *ref_ys;         /* [cap, 2*(2s+1)] */
    int16_t *ref_xs;
    uint8_t *ref_ok;
    uint8_t *ok_scan;        /* [cap, 4s+1] */
    int32_t count;
    int32_t cap;
} NBucket;

/* per-plane tensor-plan wavefront state */
typedef struct {
    uint8_t *tavail;         /* [ph4*pw4] */
    int32_t *tstep;
    int32_t pw, ph, pw4, ph4;
    int32_t last_tile, last_slice;  /* -1 sentinel */
    int32_t n_steps;
} NPlane;

#define F_TSKIP 1
#define F_PRED_ONLY 2
#define F_IS_INTER 4
#define F_BYPASS 8

/* motion-syntax event stream (P/B slices): the C parser records per-CU and
 * per-PU SYNTAX only -- merge/AMVP candidate derivation does not affect the
 * bitstream, so it replays afterwards in C (replay.c, one call a picture
 * from native/parse.py replay_motion), walking these events in z-order
 * with its own availability grid to reproduce the parse-time neighborhood
 * exactly. */
#define EV_W 20
#define EV_CU 0              /* [0, x0, y0, log2] (every CU, any pred mode) */
#define EV_PU 1              /* [1, x, y, w, h, part, part_idx, merge,
                                merge_idx, idc, ref0, ref1, mvd0x, mvd0y,
                                mvd1x, mvd1y, mvp0, mvp1, max_cands, 0] */

typedef struct {
    int32_t *ev;             /* [cap, EV_W] */
    int32_t count;
    int32_t cap;
} NEv;

typedef struct {
    Cabac *c;
    const NParams *p;
    const NMaps *m;
    NQp *q;
    NBucket *bk;             /* [12] */
    NPlane *pl;              /* [3] */
    int32_t *sao;            /* [num_ctbs * 20] */
    NEv *ev;
    CtxOffsets rox;          /* residual_coding offsets view */
    const NCtx *ox;
    int cur_tile;
    int err;
} Ctu;

static inline int32_t *ev_push(Ctu *t) {
    if (t->ev->count >= t->ev->cap) { t->err = 3; return NULL; }
    int32_t *r = t->ev->ev + (size_t)t->ev->count++ * EV_W;
    for (int i = 0; i < EV_W; i++) r[i] = 0;
    return r;
}

/* ---------------------------------------------------------------- helpers */

static inline int avail_at(Ctu *t, int x, int y) {
    const NParams *p = t->p;
    if (x < 0 || y < 0 || x >= p->pic_width || y >= p->pic_height) return 0;
    int g = (y >> 2) * p->w4 + (x >> 2);
    if (t->m->tile_map4[g] != t->cur_tile) return 0;
    int addr = (y >> p->log2_ctb) * p->wc + (x >> p->log2_ctb);
    if (t->m->slice_of_ctb[addr] != p->slice_idx) return 0;
    return t->m->avail[g];
}

static inline void set_map(Ctu *t, int32_t *m, int x0, int y0, int w, int h,
                           int32_t v) {
    const NParams *p = t->p;
    int x1 = x0 + w; if (x1 > p->pic_width) x1 = p->pic_width;
    int y1 = y0 + h; if (y1 > p->pic_height) y1 = p->pic_height;
    int gx0 = x0 >> 2, gx1 = (x1 + 3) >> 2;
    for (int gy = y0 >> 2; gy < (y1 + 3) >> 2; gy++)
        for (int gx = gx0; gx < gx1; gx++)
            m[gy * p->w4 + gx] = v;
}

static inline void mark_avail(Ctu *t, int x0, int y0, int size) {
    const NParams *p = t->p;
    int x1 = x0 + size; if (x1 > p->pic_width) x1 = p->pic_width;
    int y1 = y0 + size; if (y1 > p->pic_height) y1 = p->pic_height;
    int gx0 = x0 >> 2, gx1 = (x1 + 3) >> 2;
    for (int gy = y0 >> 2; gy < (y1 + 3) >> 2; gy++)
        for (int gx = gx0; gx < gx1; gx++)
            t->m->avail[gy * p->w4 + gx] = 1;
}

static inline void set_edges(Ctu *t, int x0, int y0, int w, int h) {
    const NParams *p = t->p;
    int32_t *ef = t->m->edge_flags;
    int x1 = x0 + w; if (x1 > p->pic_width) x1 = p->pic_width;
    int y1 = y0 + h; if (y1 > p->pic_height) y1 = p->pic_height;
    for (int gy = y0 >> 2; gy < (y1 + 3) >> 2; gy++)
        ef[gy * p->w4 + (x0 >> 2)] |= 1;
    for (int gx = x0 >> 2; gx < (x1 + 3) >> 2; gx++)
        ef[(y0 >> 2) * p->w4 + gx] |= 2;
}

/* -- QP state (syntax/qp.py) --------------------------------------------- */

static void qp_maybe_start_qg(Ctu *t, int x0, int y0, int log2_size) {
    const NParams *p = t->p;
    NQp *q = t->q;
    if (!p->cu_qp_delta_enabled || log2_size < p->min_qg_log2) return;
    q->delta = 0;
    q->delta_coded = 0;
    q->qg_x = x0; q->qg_y = y0;
    int prev = q->last_cu_qp;
    int ab[2] = {prev, prev};
    const int nx[2] = {x0 - 1, x0};
    const int ny[2] = {y0, y0 - 1};
    for (int i = 0; i < 2; i++) {
        if (nx[i] < 0 || ny[i] < 0) continue;
        if ((nx[i] >> p->log2_ctb) != (x0 >> p->log2_ctb)
            || (ny[i] >> p->log2_ctb) != (y0 >> p->log2_ctb)) continue;
        if (!avail_at(t, nx[i], ny[i])) continue;
        ab[i] = t->m->qp_map[(ny[i] >> 2) * p->w4 + (nx[i] >> 2)];
    }
    q->pred = (ab[0] + ab[1] + 1) >> 1;
}

static inline int qp_cur(Ctu *t) {
    if (!t->p->cu_qp_delta_enabled) return t->p->slice_qp;
    return (t->q->pred + t->q->delta + 52) % 52;
}

static inline void qp_end_cu(Ctu *t) { t->q->last_cu_qp = qp_cur(t); }

/* -- binarization helpers -------------------------------------------------*/

static inline int tr_bypass(Cabac *c, int c_max) {
    int v = 0;
    while (v < c_max && dec_bypass(c)) v++;
    return v;
}

/* -- tensor-plan record emission (frame_plan.build_tensor_plan) ---------- */

static void emit_tu(Ctu *t, int p_idx, int x, int y, int log2, int mode,
                    int qp, int flags, int matrix_id,
                    const int32_t *levels /* NULL if pred_only */) {
    NPlane *pl = &t->pl[p_idx];
    NBucket *b = &t->bk[p_idx * 4 + (log2 - 2)];
    if (b->count >= b->cap) { t->err = 2; return; }
    int n = 1 << log2;
    int pw = pl->pw, ph = pl->ph, pw4 = pl->pw4;
    /* availability reset on tile/slice change (build_tensor_plan semantics) */
    if (pl->last_tile != t->cur_tile || pl->last_slice != t->p->slice_idx) {
        pl->last_tile = t->cur_tile;
        pl->last_slice = t->p->slice_idx;
        memset(pl->tavail, 0, (size_t)pl->pw4 * pl->ph4);
        memset(pl->tstep, 0, (size_t)pl->pw4 * pl->ph4 * 4);
    }
    int idx = b->count++;
    int n41 = 4 * n + 1;
    int nref2 = 2 * (2 * n + 1);
    if (flags & F_IS_INTER) {
        /* MC prediction: no in-frame reference dependency -> step 1
           (mirrors frame_plan.build_tensor_plan's is_inter branch) */
        memset(b->ref_ys + (size_t)idx * nref2, 0, nref2 * 2);
        memset(b->ref_xs + (size_t)idx * nref2, 0, nref2 * 2);
        memset(b->ref_ok + (size_t)idx * nref2, 0, nref2);
        memset(b->ok_scan + (size_t)idx * n41, 0, n41);
        int32_t *me = b->meta + (size_t)idx * 8;
        me[0] = y; me[1] = x; me[2] = 1; me[3] = mode;
        me[4] = qp; me[5] = flags; me[6] = matrix_id; me[7] = 0;
        int16_t *cf = b->coeffs + (size_t)idx * n * n;
        if (levels) {
            for (int i = 0; i < n * n; i++) cf[i] = (int16_t)levels[i];
        } else {
            memset(cf, 0, (size_t)n * n * 2);
        }
        int x1 = x + n; if (x1 > pw) x1 = pw;
        int y1 = y + n; if (y1 > ph) y1 = ph;
        for (int gy = y >> 2; gy < (y1 + 3) >> 2; gy++)
            for (int gx = x >> 2; gx < (x1 + 3) >> 2; gx++) {
                pl->tavail[gy * pw4 + gx] = 1;
                pl->tstep[gy * pw4 + gx] = 1;
            }
        if (1 > pl->n_steps) pl->n_steps = 1;
        return;
    }
    /* search order: p[-1][2N-1]..p[-1][-1] (bottom-left upward), corner,
       p[0..2N-1][-1] (top, rightward) */
    int cx[4 * 32 + 1], cy[4 * 32 + 1];
    uint8_t ok[4 * 32 + 1];
    int any_ok = 0;
    for (int i = 0; i < n41; i++) {
        int xx, yy;
        if (i < 2 * n)      { xx = x - 1; yy = y + (2 * n - 1 - i); }
        else if (i == 2 * n) { xx = x - 1; yy = y - 1; }
        else                 { xx = x + (i - 2 * n - 1); yy = y - 1; }
        int o = (xx >= 0 && yy >= 0 && xx < pw && yy < ph
                 && pl->tavail[(yy >> 2) * pw4 + (xx >> 2)]);
        ok[i] = (uint8_t)o;
        cx[i] = xx; cy[i] = yy;
        any_ok |= o;
    }
    /* substitution forward fill over source coords */
    int sx[4 * 32 + 1], sy[4 * 32 + 1];
    if (any_ok) {
        int first = 0;
        while (!ok[first]) first++;
        sx[0] = ok[0] ? cx[0] : cx[first];
        sy[0] = ok[0] ? cy[0] : cy[first];
        for (int i = 1; i < n41; i++) {
            if (ok[i]) { sx[i] = cx[i]; sy[i] = cy[i]; }
            else       { sx[i] = sx[i - 1]; sy[i] = sy[i - 1]; }
        }
    }
    /* repackage: left[0..2N] (corner first, downward), top[0..2N] */
    int16_t *rys = b->ref_ys + (size_t)idx * nref2;
    int16_t *rxs = b->ref_xs + (size_t)idx * nref2;
    uint8_t *rok = b->ref_ok + (size_t)idx * nref2;
    uint8_t *osc = b->ok_scan + (size_t)idx * n41;
    int dep = 0;
    for (int i = 0; i < n41; i++) osc[i] = ok[i];
    if (any_ok) {
        for (int i = 0; i <= 2 * n; i++) {           /* left: corner, then down */
            int j = (i == 0) ? 2 * n : (2 * n - i);
            rys[i] = (int16_t)sy[j]; rxs[i] = (int16_t)sx[j]; rok[i] = 1;
            int st = pl->tstep[(sy[j] >> 2) * pw4 + (sx[j] >> 2)];
            if (st > dep) dep = st;
        }
        for (int i = 0; i <= 2 * n; i++) {           /* top: corner, then right */
            int j = (i == 0) ? 2 * n : (2 * n + i);
            rys[2 * n + 1 + i] = (int16_t)sy[j];
            rxs[2 * n + 1 + i] = (int16_t)sx[j];
            rok[2 * n + 1 + i] = 1;
            int st = pl->tstep[(sy[j] >> 2) * pw4 + (sx[j] >> 2)];
            if (st > dep) dep = st;
        }
    } else {
        memset(rys, 0, nref2 * 2);
        memset(rxs, 0, nref2 * 2);
        memset(rok, 0, nref2);
    }
    int step = dep + 1;
    int32_t *me = b->meta + (size_t)idx * 8;
    me[0] = y; me[1] = x; me[2] = step; me[3] = mode;
    me[4] = qp; me[5] = flags; me[6] = matrix_id; me[7] = 0;
    int16_t *cf = b->coeffs + (size_t)idx * n * n;
    if (levels) {
        for (int i = 0; i < n * n; i++) cf[i] = (int16_t)levels[i];
    } else {
        memset(cf, 0, (size_t)n * n * 2);
    }
    /* mark produced samples */
    int x1 = x + n; if (x1 > pw) x1 = pw;
    int y1 = y + n; if (y1 > ph) y1 = ph;
    for (int gy = y >> 2; gy < (y1 + 3) >> 2; gy++)
        for (int gx = x >> 2; gx < (x1 + 3) >> 2; gx++) {
            pl->tavail[gy * pw4 + gx] = 1;
            pl->tstep[gy * pw4 + gx] = step;
        }
    if (step > pl->n_steps) pl->n_steps = step;
}

/* -- residual + pred-only TU handling ------------------------------------ */

static inline int scan_idx_of(int intra_mode, int log2, int c_idx) {
    if ((c_idx == 0 && (log2 == 2 || log2 == 3))
        || (c_idx > 0 && log2 == 2)) {
        if (intra_mode >= 6 && intra_mode <= 14) return 2;
        if (intra_mode >= 22 && intra_mode <= 30) return 1;
    }
    return 0;
}

static void code_residual(Ctu *t, int x, int y, int log2, int c_idx,
                          int mode, int qp, int cu_bypass, int is_inter) {
    int scan = scan_idx_of(mode, log2, c_idx);
    int32_t levels[32 * 32];
    int r = residual_coding(t->c, &t->rox, log2, c_idx, scan,
                            t->p->transform_skip_enabled,
                            t->p->sign_data_hiding, cu_bypass, levels);
    if (r < 0) { t->err = 1; return; }
    int mid = (log2 == 5) ? (is_inter ? 1 : 0)
                          : 3 * (is_inter ? 1 : 0) + c_idx;
    int flags = (r ? F_TSKIP : 0) | (cu_bypass ? F_BYPASS : 0)
                | (is_inter ? F_IS_INTER : 0);
    emit_tu(t, c_idx, x, y, log2, mode, qp, flags, mid, levels);
}

static void pred_only(Ctu *t, int x, int y, int log2, int c_idx, int mode,
                      int qp, int is_inter) {
    emit_tu(t, c_idx, x, y, log2, mode, qp,
            F_PRED_ONLY | (is_inter ? F_IS_INTER : 0), 0, NULL);
}

/* -- cu_qp_delta (7.3.8.10 / 9.3.3) --------------------------------------- */

static void cu_qp_delta_syntax(Ctu *t) {
    Cabac *c = t->c;
    int a = 0;
    if (dec_bin(c, t->ox->cu_qp_delta_abs)) {
        a = 1;
        while (a < 5 && dec_bin(c, t->ox->cu_qp_delta_abs + 1)) a++;
        if (a == 5) a += dec_eg(c, 0);
    }
    int v = 0;
    if (a) v = dec_bypass(c) ? -a : a;
    t->q->delta = v;
    t->q->delta_coded = 1;
}

/* -- transform tree / unit (7.3.8.8 / 7.3.8.10) --------------------------- */

static void transform_unit(Ctu *t, int x0, int y0, int x_base, int y_base,
                           int log2_size, int depth, int blk_idx,
                           const int *modes, int n_modes, int chroma_mode,
                           int cbf_luma, int cbf_cb, int cbf_cr,
                           int cu_bypass, int is_intra) {
    int lmode;
    if (!is_intra) lmode = -1;
    else if (n_modes == 1) lmode = modes[0];
    else lmode = (depth == 1) ? modes[blk_idx] : modes[0];
    if (t->p->cu_qp_delta_enabled && !t->q->delta_coded
        && (cbf_luma || cbf_cb || cbf_cr))
        cu_qp_delta_syntax(t);
    int qp = qp_cur(t);
    int inter = !is_intra;
    if (cbf_luma)
        code_residual(t, x0, y0, log2_size, 0, lmode, qp, cu_bypass, inter);
    else
        pred_only(t, x0, y0, log2_size, 0, lmode, qp, inter);
    if (t->err) return;
    set_map(t, t->m->cbf_map, x0, y0, 1 << log2_size, 1 << log2_size,
            cbf_luma);
    set_edges(t, x0, y0, 1 << log2_size, 1 << log2_size);
    int do_chroma, cx, cy, clog2;
    if (log2_size > 2) {
        do_chroma = 1; cx = x0 >> 1; cy = y0 >> 1; clog2 = log2_size - 1;
    } else if (blk_idx == 3) {
        do_chroma = 1; cx = x_base >> 1; cy = y_base >> 1; clog2 = 2;
    } else {
        do_chroma = 0; cx = cy = clog2 = 0;
    }
    if (do_chroma) {
        const int cbfs[2] = {cbf_cb, cbf_cr};
        for (int ci = 1; ci <= 2; ci++) {
            if (t->err) return;
            if (cbfs[ci - 1])
                code_residual(t, cx, cy, clog2, ci, chroma_mode, qp,
                              cu_bypass, inter);
            else
                pred_only(t, cx, cy, clog2, ci, chroma_mode, qp, inter);
        }
    }
}

static void transform_tree(Ctu *t, int x0, int y0, int x_base, int y_base,
                           int log2_size, int depth, int blk_idx,
                           const int *modes, int n_modes, int chroma_mode,
                           int split0, int max_depth, int cbf_cb, int cbf_cr,
                           int cu_bypass, int is_intra) {
    const NParams *p = t->p;
    Cabac *c = t->c;
    int split;
    if (log2_size <= p->log2_max_tb && log2_size > p->log2_min_tb
        && depth < max_depth && !(split0 && depth == 0)) {
        split = dec_bin(c, t->ox->split_transform_flag + (5 - log2_size));
    } else {
        split = (log2_size > p->log2_max_tb || (split0 && depth == 0));
    }
    if (log2_size > 2) {
        if (cbf_cb) cbf_cb = dec_bin(c, t->ox->cbf_chroma + depth);
        if (cbf_cr) cbf_cr = dec_bin(c, t->ox->cbf_chroma + depth);
    }
    if (split) {
        int half = 1 << (log2_size - 1);
        const int d[4][2] = {{0, 0}, {half, 0}, {0, half}, {half, half}};
        for (int i = 0; i < 4; i++) {
            if (t->err) return;
            transform_tree(t, x0 + d[i][0], y0 + d[i][1], x0, y0,
                           log2_size - 1, depth + 1, i, modes, n_modes,
                           chroma_mode, split0, max_depth, cbf_cb, cbf_cr,
                           cu_bypass, is_intra);
        }
        return;
    }
    /* leaf: cbf_luma coded except inter depth-0 with no chroma cbf
       (inferred 1, spec 7.3.8.8) */
    int cbf_luma;
    if (is_intra || depth != 0 || cbf_cb || cbf_cr)
        cbf_luma = dec_bin(c, t->ox->cbf_luma + (depth == 0 ? 1 : 0));
    else
        cbf_luma = 1;
    transform_unit(t, x0, y0, x_base, y_base, log2_size, depth, blk_idx,
                   modes, n_modes, chroma_mode, cbf_luma, cbf_cb, cbf_cr,
                   cu_bypass, is_intra);
}

/* -- intra CU (7.3.8.5) ---------------------------------------------------*/

static void derive_mpm_c(int a, int b, int out[3]) {
    if (a < 0) a = 1;
    if (b < 0) b = 1;
    if (a == b) {
        if (a < 2) { out[0] = 0; out[1] = 1; out[2] = 26; }
        else {
            out[0] = a;
            out[1] = 2 + ((a + 29) % 32);
            out[2] = 2 + ((a - 1) % 32);
        }
        return;
    }
    out[0] = a; out[1] = b;
    if (a != 0 && b != 0) out[2] = 0;
    else if (a != 1 && b != 1) out[2] = 1;
    else out[2] = 26;
}

static void mpm_for(Ctu *t, int i, const int pux[4], const int puy[4],
                    const int *modes, int n_pu, int x0, int y0, int cu_size,
                    int out[3]) {
    const NParams *p = t->p;
    int px = pux[i], py = puy[i];
    int nbm[2];
    const int nx[2] = {px - 1, px};
    const int ny[2] = {py, py - 1};
    for (int k = 0; k < 2; k++) {
        int m = -1;
        int xx = nx[k], yy = ny[k];
        if (xx < 0 || yy < 0) { nbm[k] = -1; continue; }
        if (k == 1 && (yy >> p->log2_ctb) != (py >> p->log2_ctb)) {
            nbm[k] = -1; continue;
        }
        if (x0 <= xx && xx < x0 + cu_size && y0 <= yy && yy < y0 + cu_size) {
            int pb = (n_pu > 1) ? cu_size >> 1 : cu_size;
            int j = (((yy - y0) / pb) << 1) | ((xx - x0) / pb);
            m = (j < n_pu) ? modes[j] : -1;
        } else if (avail_at(t, xx, yy)) {
            m = t->m->mode_map[(yy >> 2) * p->w4 + (xx >> 2)];
        }
        nbm[k] = m;
    }
    derive_mpm_c(nbm[0], nbm[1], out);
}

static void intra_cu(Ctu *t, int x0, int y0, int log2_size, int cu_bypass) {
    const NParams *p = t->p;
    Cabac *c = t->c;
    int size = 1 << log2_size;
    int part_nxn = 0;
    if (log2_size == p->log2_min_cb)
        part_nxn = 1 - dec_bin(c, t->ox->part_mode);
    /* PCM is gated off in the Python wrapper (falls back to the Python
       parser when sps.pcm_enabled); nothing to parse here. */
    int n_pu = part_nxn ? 4 : 1;
    int pb = part_nxn ? size >> 1 : size;
    int pux[4], puy[4];
    for (int i = 0; i < n_pu; i++) {
        pux[i] = x0 + (i & 1) * pb;
        puy[i] = y0 + (i >> 1) * pb;
    }
    int modes[4] = {-1, -1, -1, -1};
    int prev_flags[4];
    for (int i = 0; i < n_pu; i++)
        prev_flags[i] = dec_bin(c, t->ox->prev_intra_luma_pred_flag);
    for (int i = 0; i < n_pu; i++) {
        int cands[3];
        mpm_for(t, i, pux, puy, modes, n_pu, x0, y0, size, cands);
        if (prev_flags[i]) {
            modes[i] = cands[tr_bypass(c, 2)];
        } else {
            int s0 = cands[0], s1 = cands[1], s2 = cands[2], tmp;
            if (s0 > s1) { tmp = s0; s0 = s1; s1 = tmp; }
            if (s1 > s2) { tmp = s1; s1 = s2; s2 = tmp; }
            if (s0 > s1) { tmp = s0; s0 = s1; s1 = tmp; }
            int rem = dec_bypass_bits(c, 5);
            if (rem >= s0) rem++;
            if (rem >= s1) rem++;
            if (rem >= s2) rem++;
            modes[i] = rem;
        }
        set_map(t, t->m->mode_map, pux[i], puy[i], pb, pb, modes[i]);
    }
    int cidx = 4;
    if (dec_bin(c, t->ox->intra_chroma_pred_mode))
        cidx = dec_bypass_bits(c, 2);
    int chroma_mode;
    if (cidx == 4) chroma_mode = modes[0];
    else {
        const int cands[4] = {0, 26, 10, 1};
        chroma_mode = (cands[cidx] == modes[0]) ? 34 : cands[cidx];
    }
    set_map(t, t->m->intra_map, x0, y0, size, size, 1);
    set_map(t, t->m->skip_map, x0, y0, size, size, 0);
    set_edges(t, x0, y0, size, size);
    int max_depth = p->max_tt_depth_intra + part_nxn;
    transform_tree(t, x0, y0, x0, y0, log2_size, 0, 0, modes, n_pu,
                   chroma_mode, part_nxn, max_depth, 1, 1, cu_bypass, 1);
    set_map(t, t->m->qp_map, x0, y0, size, size, qp_cur(t));
    mark_avail(t, x0, y0, size);
    qp_end_cu(t);
}

/* -- inter CU syntax (7.3.8.5/.6, mirrors syntax/ctu.py _inter_cu) -------- */

/* part codes: 0=2Nx2N 1=2NxN 2=Nx2N 3=NxN 4=2NxnU 5=2NxnD 6=nLx2N 7=nRx2N
   rect tables in quarter units (syntax/ctu.py _PART_RECTS) */
static const int PART_RECTS[8][4][4] = {
    {{0, 0, 4, 4}},
    {{0, 0, 4, 2}, {0, 2, 4, 2}},
    {{0, 0, 2, 4}, {2, 0, 2, 4}},
    {{0, 0, 2, 2}, {2, 0, 2, 2}, {0, 2, 2, 2}, {2, 2, 2, 2}},
    {{0, 0, 4, 1}, {0, 1, 4, 3}},
    {{0, 0, 4, 3}, {0, 3, 4, 1}},
    {{0, 0, 1, 4}, {1, 0, 3, 4}},
    {{0, 0, 3, 4}, {3, 0, 1, 4}},
};
static const int PART_N[8] = {1, 2, 2, 4, 2, 2, 2, 2};

static int part_mode_inter(Ctu *t, int log2_size) {
    const NParams *p = t->p;
    Cabac *c = t->c;
    int at_min = log2_size == p->log2_min_cb;
    int amp = p->amp_enabled && !at_min;
    if (dec_bin(c, t->ox->part_mode)) return 0;
    int horiz = dec_bin(c, t->ox->part_mode + 1);
    if (!at_min) {
        if (amp) {
            int plain = dec_bin(c, t->ox->part_mode + 3);
            if (plain) return horiz ? 1 : 2;
            int second = dec_bypass(c);
            if (horiz) return second ? 5 : 4;
            return second ? 7 : 6;
        }
        return horiz ? 1 : 2;
    }
    if (horiz) return 1;
    if (log2_size == 3) return 2;     /* inter NxN forbidden for 8x8 CUs */
    int third = dec_bin(c, t->ox->part_mode + 2);
    return third ? 2 : 3;
}

static int ref_idx_syntax(Ctu *t, int n_ref) {
    int c_max = n_ref - 1;
    if (c_max == 0) return 0;
    int v = 0;
    while (v < c_max) {
        int b = (v < 2) ? dec_bin(t->c, t->ox->ref_idx + v)
                        : dec_bypass(t->c);
        if (!b) break;
        v++;
    }
    return v;
}

static void mvd_coding(Ctu *t, int out[2]) {
    Cabac *c = t->c;
    int g0x = dec_bin(c, t->ox->abs_mvd_greater_flag);
    int g0y = dec_bin(c, t->ox->abs_mvd_greater_flag);
    int g1x = g0x ? dec_bin(c, t->ox->abs_mvd_greater_flag + 1) : 0;
    int g1y = g0y ? dec_bin(c, t->ox->abs_mvd_greater_flag + 1) : 0;
    const int g0[2] = {g0x, g0y}, g1[2] = {g1x, g1y};
    for (int i = 0; i < 2; i++) {
        if (!g0[i]) { out[i] = 0; continue; }
        int mag = 1;
        if (g1[i]) mag = 2 + dec_eg(c, 1);
        out[i] = dec_bypass(c) ? -mag : mag;
    }
}

/* -> merge flag; writes one EV_PU record */
static int inter_pu(Ctu *t, int x, int y, int w, int h, int part,
                    int part_idx, int cu_log2, int merge_only) {
    const NParams *p = t->p;
    Cabac *c = t->c;
    int32_t *r = ev_push(t);
    if (!r) return 1;
    int merge = merge_only ? 1 : dec_bin(c, t->ox->merge_flag);
    int midx = 0, idc = 0;
    int ref[2] = {-1, -1}, mvp[2] = {0, 0}, mvd[2][2] = {{0, 0}, {0, 0}};
    if (merge) {
        int c_max = p->max_merge_cand - 1;
        if (c_max > 0 && dec_bin(c, t->ox->merge_idx))
            midx = 1 + tr_bypass(c, c_max - 1);
    } else {
        int is_b = p->slice_type == 0;
        if (is_b) {
            if (w + h != 12) {
                int ct_depth = p->log2_ctb - cu_log2;
                if (dec_bin(c, t->ox->inter_pred_idc + ct_depth))
                    idc = 2;
                else
                    idc = dec_bin(c, t->ox->inter_pred_idc + 4) ? 1 : 0;
            } else {
                idc = dec_bin(c, t->ox->inter_pred_idc + 4) ? 1 : 0;
            }
        }
        for (int lx = 0; lx < 2; lx++) {
            if ((idc == 0 && lx == 1) || (idc == 1 && lx == 0)) continue;
            int n_ref = lx ? p->num_ref_l1 : p->num_ref_l0;
            ref[lx] = ref_idx_syntax(t, n_ref);
            if (!(lx == 1 && p->mvd_l1_zero && idc == 2))
                mvd_coding(t, mvd[lx]);
            mvp[lx] = dec_bin(c, t->ox->mvp_flag);
        }
    }
    r[0] = EV_PU; r[1] = x; r[2] = y; r[3] = w; r[4] = h;
    r[5] = part; r[6] = part_idx; r[7] = merge; r[8] = midx; r[9] = idc;
    r[10] = ref[0]; r[11] = ref[1];
    r[12] = mvd[0][0]; r[13] = mvd[0][1];
    r[14] = mvd[1][0]; r[15] = mvd[1][1];
    r[16] = mvp[0]; r[17] = mvp[1];
    r[18] = p->max_merge_cand;
    return merge;
}

static void emit_inter_pred_only(Ctu *t, int x0, int y0, int size) {
    /* mirrors _emit_inter_pred_only + frame_plan._expand_large: 64x64
       pred-only luma splits into four 32x32 quadrants (buckets top out at
       log2 5); chroma (size>>1 <= 32) always fits */
    int qp = qp_cur(t);
    if (size == 64) {
        for (int dy = 0; dy < 64; dy += 32)
            for (int dx = 0; dx < 64; dx += 32)
                pred_only(t, x0 + dx, y0 + dy, 5, 0, -1, qp, 1);
    } else {
        int log2 = 0;
        while ((1 << log2) < size) log2++;
        pred_only(t, x0, y0, log2, 0, -1, qp, 1);
    }
    int clog2 = 0;
    while ((1 << clog2) < (size >> 1)) clog2++;
    pred_only(t, x0 >> 1, y0 >> 1, clog2, 1, -1, qp, 1);
    pred_only(t, x0 >> 1, y0 >> 1, clog2, 2, -1, qp, 1);
    set_map(t, t->m->cbf_map, x0, y0, size, size, 0);
}

static void inter_cu(Ctu *t, int x0, int y0, int log2_size, int cu_bypass) {
    const NParams *p = t->p;
    int size = 1 << log2_size;
    int part = part_mode_inter(t, log2_size);
    int q = size >> 2;
    int merge0 = 0;
    for (int i = 0; i < PART_N[part]; i++) {
        const int *rc = PART_RECTS[part][i];
        int px = x0 + rc[0] * q, py = y0 + rc[1] * q;
        int pw = rc[2] * q, ph = rc[3] * q;
        int m = inter_pu(t, px, py, pw, ph, part, i, log2_size, 0);
        if (i == 0) merge0 = m;
        set_edges(t, px, py, pw, ph);
        if (t->err) return;
    }
    set_map(t, t->m->intra_map, x0, y0, size, size, 0);
    set_map(t, t->m->skip_map, x0, y0, size, size, 0);
    set_map(t, t->m->mode_map, x0, y0, size, size, -1);
    set_edges(t, x0, y0, size, size);
    int rqt_root = 1;
    if (!(part == 0 && merge0))
        rqt_root = dec_bin(t->c, t->ox->rqt_root_cbf);
    if (rqt_root) {
        int max_depth = p->max_tt_depth_inter;
        int inter_split = (max_depth == 0 && part != 0);
        transform_tree(t, x0, y0, x0, y0, log2_size, 0, 0, NULL, 0, -1,
                       inter_split, max_depth, 1, 1, cu_bypass, 0);
    } else {
        emit_inter_pred_only(t, x0, y0, size);
    }
    set_map(t, t->m->qp_map, x0, y0, size, size, qp_cur(t));
    mark_avail(t, x0, y0, size);
    qp_end_cu(t);
}

/* -- coding unit / quadtree (7.3.8.4/.5) ----------------------------------*/

static void coding_unit(Ctu *t, int x0, int y0, int log2_size) {
    const NParams *p = t->p;
    int size = 1 << log2_size;
    int32_t *ev = NULL;
    if (p->slice_type != 2) {         /* CU event for the motion replay */
        ev = ev_push(t);
        if (!ev) return;
        ev[0] = EV_CU; ev[1] = x0; ev[2] = y0; ev[3] = log2_size;
    }
    int cu_bypass = 0;
    if (p->transquant_bypass_enabled) {
        cu_bypass = dec_bin(t->c, t->ox->cu_transquant_bypass_flag);
        if (cu_bypass)
            set_map(t, t->m->bypass_map, x0, y0, size, size, 1);
    }
    if (p->slice_type != 2) {
        int inc = 0;
        if (avail_at(t, x0 - 1, y0))
            inc += t->m->skip_map[(y0 >> 2) * p->w4 + ((x0 - 1) >> 2)];
        if (avail_at(t, x0, y0 - 1))
            inc += t->m->skip_map[((y0 - 1) >> 2) * p->w4 + (x0 >> 2)];
        int skip = dec_bin(t->c, t->ox->cu_skip_flag + inc);
        if (skip) {
            set_map(t, t->m->skip_map, x0, y0, size, size, 1);
            set_map(t, t->m->intra_map, x0, y0, size, size, 0);
            set_map(t, t->m->qp_map, x0, y0, size, size, qp_cur(t));
            set_edges(t, x0, y0, size, size);
            inter_pu(t, x0, y0, size, size, 0, 0, log2_size, 1);
            emit_inter_pred_only(t, x0, y0, size);
            mark_avail(t, x0, y0, size);
            qp_end_cu(t);
            return;
        }
        if (!dec_bin(t->c, t->ox->pred_mode_flag)) {
            inter_cu(t, x0, y0, log2_size, cu_bypass);
            return;
        }
    }
    intra_cu(t, x0, y0, log2_size, cu_bypass);
}

static void coding_quadtree(Ctu *t, int x0, int y0, int log2_size,
                            int depth) {
    const NParams *p = t->p;
    int size = 1 << log2_size;
    qp_maybe_start_qg(t, x0, y0, log2_size);
    int inside = (x0 + size <= p->pic_width) && (y0 + size <= p->pic_height);
    int can_split = log2_size > p->log2_min_cb;
    int split;
    if (inside && can_split) {
        int inc = 0;
        if (avail_at(t, x0 - 1, y0))
            inc += t->m->depth_map[(y0 >> 2) * p->w4 + ((x0 - 1) >> 2)] > depth;
        if (avail_at(t, x0, y0 - 1))
            inc += t->m->depth_map[((y0 - 1) >> 2) * p->w4 + (x0 >> 2)] > depth;
        split = dec_bin(t->c, t->ox->split_cu_flag + inc);
    } else {
        split = can_split;
    }
    if (split) {
        int half = size >> 1;
        const int d[4][2] = {{0, 0}, {half, 0}, {0, half}, {half, half}};
        for (int i = 0; i < 4; i++) {
            int x1 = x0 + d[i][0], y1 = y0 + d[i][1];
            if (t->err) return;
            if (x1 < p->pic_width && y1 < p->pic_height)
                coding_quadtree(t, x1, y1, log2_size - 1, depth + 1);
        }
        return;
    }
    set_map(t, t->m->depth_map, x0, y0, size, size, depth);
    coding_unit(t, x0, y0, log2_size);
}

/* -- SAO parameters (7.3.8.3); record: 20 int32 per CTB ------------------- */
/* layout: type[3], cls[3], offsets[3][4], merge_left, merge_up */

static void code_sao(Ctu *t, int ctb_addr) {
    const NParams *p = t->p;
    Cabac *c = t->c;
    int32_t *rec = t->sao + (size_t)ctb_addr * 20;
    int wc = p->wc;
    const int32_t *tof = t->m->tile_map4;  /* unused; use helper below */
    (void)tof;
    /* tile ids per CTB come via tile_of helper using tile_map4 at CTB corner */
    int xg = (ctb_addr % wc) << (p->log2_ctb - 2);
    int yg = (ctb_addr / wc) << (p->log2_ctb - 2);
    int my_tile = t->m->tile_map4[yg * p->w4 + xg];
    int left_ok = 0, up_ok = 0;
    if (ctb_addr % wc != 0) {
        int lg = ((ctb_addr - 1) % wc) << (p->log2_ctb - 2);
        left_ok = (t->m->tile_map4[yg * p->w4 + lg] == my_tile
                   && t->m->slice_of_ctb[ctb_addr - 1] == p->slice_idx);
    }
    if (ctb_addr >= wc) {
        int ug = ((ctb_addr - wc) / wc) << (p->log2_ctb - 2);
        up_ok = (t->m->tile_map4[ug * p->w4 + xg] == my_tile
                 && t->m->slice_of_ctb[ctb_addr - wc] == p->slice_idx);
    }
    int merge = 0;
    if (left_ok) {
        rec[18] = dec_bin(c, t->ox->sao_merge_flag);
        merge = rec[18];
    }
    if (!merge && up_ok) {
        rec[19] = dec_bin(c, t->ox->sao_merge_flag);
        merge = rec[19];
    }
    if (merge) {
        const int32_t *src = t->sao
            + (size_t)(rec[18] ? ctb_addr - 1 : ctb_addr - wc) * 20;
        for (int i = 0; i < 18; i++) rec[i] = src[i];
        return;
    }
    for (int ci = 0; ci < 3; ci++) {
        int enabled = ci == 0 ? p->sao_luma : p->sao_chroma;
        if (!enabled) continue;
        int ty;
        if (ci == 2) {
            ty = rec[1];          /* cr inherits type idx from cb */
        } else {
            if (dec_bin(c, t->ox->sao_type_idx))
                ty = dec_bypass(c) ? 2 : 1;   /* EDGE : BAND */
            else
                ty = 0;
            rec[ci] = ty;
            if (ci == 1) rec[2] = ty;
        }
        rec[ci] = ty;
        if (ty == 0) continue;
        int mags[4];
        for (int i = 0; i < 4; i++) mags[i] = tr_bypass(c, 7);
        int32_t *offs = rec + 6 + ci * 4;
        if (ty == 1) {            /* band */
            for (int i = 0; i < 4; i++) {
                int v = mags[i];
                if (v && dec_bypass(c)) v = -v;
                offs[i] = v;
            }
            rec[3 + ci] = dec_bypass_bits(c, 5);
        } else {                  /* edge */
            offs[0] = mags[0]; offs[1] = mags[1];
            offs[2] = -mags[2]; offs[3] = -mags[3];
            if (ci == 2) rec[5] = rec[4];
            else {
                rec[3 + ci] = dec_bypass_bits(c, 2);
                if (ci == 1) rec[5] = rec[4];
            }
        }
    }
}

/* -- entry point: one CTU -------------------------------------------------*/

EXPORT int ctu_parse(Cabac *c, const NParams *p, const NMaps *m, NQp *q,
                     NBucket *buckets, NPlane *planes, int32_t *sao,
                     NEv *ev, const NCtx *ox, int ctb_addr, int cur_tile,
                     int do_sao) {
    Ctu t;
    t.c = c; t.p = p; t.m = m; t.q = q;
    t.bk = buckets; t.pl = planes; t.sao = sao;
    t.ev = ev;
    t.ox = ox;
    t.rox.transform_skip_flag = ox->transform_skip_flag;
    t.rox.last_x = ox->last_x;
    t.rox.last_y = ox->last_y;
    t.rox.csbf = ox->csbf;
    t.rox.sig = ox->sig;
    t.rox.gt1 = ox->gt1;
    t.rox.gt2 = ox->gt2;
    t.cur_tile = cur_tile;
    t.err = 0;
    int wc = p->wc;
    int xc = (ctb_addr % wc) << p->log2_ctb;
    int yc = (ctb_addr / wc) << p->log2_ctb;
    m->slice_of_ctb[ctb_addr] = p->slice_idx;
    if (do_sao) code_sao(&t, ctb_addr);
    coding_quadtree(&t, xc, yc, p->log2_ctb, 0);
    if (t.err || c->err) return -t.err - (c->err ? 10 : 0);
    return dec_terminate(c);
}
