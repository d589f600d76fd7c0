// Copy of p265_tpu/native/cabac.c.  Deviation: a remark on the build
// tooling is cut from the first comment.
/* Native CABAC decode fast lane: binary arithmetic engine + the
 * residual_coding hot loop (spec 9.3.4.3, 7.3.8.11).
 *
 * Mirrors p265_tpu/entropy/engine.py and p265_tpu/syntax/residual.py
 * bin-for-bin; the Python implementations remain the reference and the tests
 * assert byte-exact agreement.  Built as a plain shared library, loaded via
 * ctypes.
 */
#include <stdint.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

static const uint8_t RANGE_LPS[64][4] = {
    {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
    {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
    {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
    {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
    {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
    {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
    {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
    {33,41,48,56},{32,39,46,53},{30,37,43,50},{28,35,41,47},
    {27,33,39,45},{25,31,37,43},{24,30,35,41},{23,28,33,39},
    {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
    {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
    {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
    {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
    {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
    {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
    {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2}};

static const uint8_t TRANS_LPS[64] = {
    0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,
    23,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,
    35,35,35,36,36,36,37,37,37,38,38,63};

static const uint8_t SIG_CTX_4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};

typedef struct {
    const uint8_t *buf;
    int64_t nbits;
    int64_t pos;          /* bit position */
    uint32_t range;
    uint32_t offset;
    uint8_t *state;       /* [num_ctx] */
    uint8_t *mps;         /* [num_ctx] */
    int err;              /* sticky error flag (bit starvation etc.) */
} Cabac;

typedef struct {
    /* context block offsets from tables.CTX_OFFSET */
    int transform_skip_flag;
    int last_x;
    int last_y;
    int csbf;
    int sig;
    int gt1;
    int gt2;
} CtxOffsets;

static inline int read_bit(Cabac *c) {
    if (c->pos >= c->nbits) { c->err = 1; return 0; }
    int b = (c->buf[c->pos >> 3] >> (7 - (c->pos & 7))) & 1;
    c->pos++;
    return b;
}

static inline int dec_bin(Cabac *c, int idx) {
    int state = c->state[idx];
    uint32_t lps = RANGE_LPS[state][(c->range >> 6) & 3];
    int bin;
    c->range -= lps;
    if (c->offset >= c->range) {
        bin = 1 - c->mps[idx];
        c->offset -= c->range;
        c->range = lps;
        if (state == 0) c->mps[idx] = 1 - c->mps[idx];
        c->state[idx] = TRANS_LPS[state];
    } else {
        bin = c->mps[idx];
        if (state < 62) c->state[idx] = state + 1;
    }
    while (c->range < 256) {
        c->range <<= 1;
        c->offset = (c->offset << 1) | read_bit(c);
    }
    return bin;
}

static inline int dec_bypass(Cabac *c) {
    c->offset = (c->offset << 1) | read_bit(c);
    if (c->offset >= c->range) { c->offset -= c->range; return 1; }
    return 0;
}

static inline int dec_bypass_bits(Cabac *c, int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | dec_bypass(c);
    return v;
}

static inline int dec_terminate(Cabac *c) {
    c->range -= 2;
    if (c->offset >= c->range) return 1;
    while (c->range < 256) {
        c->range <<= 1;
        c->offset = (c->offset << 1) | read_bit(c);
    }
    return 0;
}

static inline int dec_eg(Cabac *c, int k) {
    int n = 0;
    while (dec_bypass(c)) { if (++n > 32) { c->err = 1; return 0; } }
    int suffix = (n + k) ? dec_bypass_bits(c, n + k) : 0;
    return (((1 << n) - 1) << k) + suffix;
}

/* -------- scan tables (spec 6.5.3): generated on first use -------------- */
/* scan order arrays: [scanIdx][log2-2] -> positions (x | y<<8) */
static uint16_t scan_tab[3][4][1024];
static uint16_t cg_tab[3][4][64];
static int scan_ready = 0;

static void gen_diag(uint16_t *out, int blk) {
    int i = 0, x = 0, y = 0;
    while (i < blk * blk) {
        while (y >= 0) {
            if (x < blk && y < blk) out[i++] = (uint16_t)(x | (y << 8));
            y--; x++;
        }
        y = x; x = 0;
    }
}
static void gen_horiz(uint16_t *out, int blk) {
    int i = 0;
    for (int y = 0; y < blk; y++)
        for (int x = 0; x < blk; x++) out[i++] = (uint16_t)(x | (y << 8));
}
static void gen_vert(uint16_t *out, int blk) {
    int i = 0;
    for (int x = 0; x < blk; x++)
        for (int y = 0; y < blk; y++) out[i++] = (uint16_t)(x | (y << 8));
}

static void build_scans(void) {
    uint16_t tmp[64];
    for (int s = 0; s < 3; s++) {
        for (int l = 0; l < 4; l++) {
            int size = 4 << l;
            if (size == 4) {
                if (s == 0) gen_diag(scan_tab[s][l], 4);
                else if (s == 1) gen_horiz(scan_tab[s][l], 4);
                else gen_vert(scan_tab[s][l], 4);
                cg_tab[s][l][0] = 0;
                continue;
            }
            int ncg = size >> 2;
            uint16_t *cg = cg_tab[s][l];
            if (s == 0) gen_diag(cg, ncg);
            else if (s == 1) gen_horiz(cg, ncg);
            else gen_vert(cg, ncg);
            uint16_t inner[16];
            if (s == 0) gen_diag(inner, 4);
            else if (s == 1) gen_horiz(inner, 4);
            else gen_vert(inner, 4);
            (void)tmp;
            for (int g = 0; g < ncg * ncg; g++) {
                int gx = cg[g] & 0xff, gy = cg[g] >> 8;
                for (int k = 0; k < 16; k++) {
                    int ix = inner[k] & 0xff, iy = inner[k] >> 8;
                    scan_tab[s][l][g * 16 + k] =
                        (uint16_t)((gx * 4 + ix) | ((gy * 4 + iy) << 8));
                }
            }
        }
    }
    scan_ready = 1;
}

static inline int sig_ctx_inc(int xc, int yc, int log2, int cidx, int scan,
                              int right, int below) {
    int sig;
    if (log2 == 2) {
        sig = SIG_CTX_4x4[(yc << 2) + xc];
    } else if (xc + yc == 0) {
        sig = 0;
    } else {
        int prev = right + 2 * below;
        int xp = xc & 3, yp = yc & 3;
        if (prev == 0)       sig = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0;
        else if (prev == 1)  sig = (yp == 0) ? 2 : (yp == 1) ? 1 : 0;
        else if (prev == 2)  sig = (xp == 0) ? 2 : (xp == 1) ? 1 : 0;
        else                 sig = 2;
        if (cidx == 0) {
            if (((xc >> 2) | (yc >> 2)) != 0) sig += 3;
            if (log2 == 3) sig += (scan == 0) ? 9 : 15;
            else sig += 21;
        } else {
            sig += (log2 == 3) ? 9 : 12;
        }
    }
    return sig + (cidx ? 27 : 0);
}

/* Returns: 0/1 transform_skip flag, or -1 on stream error. */
EXPORT int residual_coding(Cabac *c, const CtxOffsets *ox, int log2, int cidx,
                           int scan_idx, int tskip_allowed, int sdh,
                           int tq_bypass, int32_t *levels /* [size*size] */) {
    if (!scan_ready) build_scans();
    int size = 1 << log2;
    memset(levels, 0, sizeof(int32_t) * size * size);
    int tskip = 0;
    if (tskip_allowed && !tq_bypass && log2 == 2)
        tskip = dec_bin(c, ox->transform_skip_flag + (cidx ? 1 : 0));

    /* last significant position */
    int c_max = (log2 << 1) - 1;
    int off, shift;
    if (cidx == 0) { off = 3 * (log2 - 2) + ((log2 - 1) >> 2); shift = (log2 + 1) >> 2; }
    else { off = 15; shift = log2 - 2; }
    int px = 0, py = 0;
    while (px < c_max && dec_bin(c, ox->last_x + (px >> shift) + off)) px++;
    while (py < c_max && dec_bin(c, ox->last_y + (py >> shift) + off)) py++;
    int sx = (px > 3) ? dec_bypass_bits(c, (px >> 1) - 1) : 0;
    int sy = (py > 3) ? dec_bypass_bits(c, (py >> 1) - 1) : 0;
    int last_x = (px <= 3) ? px : ((1 << ((px >> 1) - 1)) * (2 + (px & 1)) + sx);
    int last_y = (py <= 3) ? py : ((1 << ((py >> 1) - 1)) * (2 + (py & 1)) + sy);
    if (scan_idx == 2) { int t = last_x; last_x = last_y; last_y = t; }

    const uint16_t *scan = scan_tab[scan_idx][log2 - 2];
    const uint16_t *cgs = cg_tab[scan_idx][log2 - 2];
    int last_pos = -1;
    for (int i = 0; i < size * size; i++) {
        if ((scan[i] & 0xff) == last_x && (scan[i] >> 8) == last_y) {
            last_pos = i;
            break;
        }
    }
    if (last_pos < 0) { c->err = 1; return -1; }
    int last_cg = last_pos >> 4;
    int ncg = (size > 4) ? (size >> 2) : 1;
    uint8_t csbf[64];
    memset(csbf, 0, sizeof(csbf));
    int c1 = 1;

    for (int i = last_cg; i >= 0; i--) {
        int xs = cgs[i] & 0xff, ys = cgs[i] >> 8;
        int infer_dc = 0;
        if (i == last_cg || i == 0) {
            csbf[ys * 8 + xs] = 1;
        } else {
            int right = (xs + 1 < ncg) ? csbf[ys * 8 + xs + 1] : 0;
            int below = (ys + 1 < ncg) ? csbf[(ys + 1) * 8 + xs] : 0;
            int inc = ((right + below) > 0 ? 1 : 0) + (cidx ? 2 : 0);
            csbf[ys * 8 + xs] = (uint8_t)dec_bin(c, ox->csbf + inc);
            infer_dc = 1;
        }
        if (!csbf[ys * 8 + xs]) continue;

        int start_n = (i == last_cg) ? (last_pos - 1 - (i << 4)) : 15;
        int sig_pos[16];
        int nsig = 0;
        if (i == last_cg) sig_pos[nsig++] = last_pos & 15;
        int right = (xs + 1 < ncg) ? csbf[ys * 8 + xs + 1] : 0;
        int below = (ys + 1 < ncg) ? csbf[(ys + 1) * 8 + xs] : 0;
        for (int n = start_n; n >= 0; n--) {
            int p = scan[(i << 4) + n];
            int xc = p & 0xff, yc = p >> 8;
            if (n > 0 || !infer_dc) {
                int inc = sig_ctx_inc(xc, yc, log2, cidx, scan_idx, right, below);
                if (dec_bin(c, ox->sig + inc)) {
                    sig_pos[nsig++] = n;
                    infer_dc = 0;
                }
            } else {
                sig_pos[nsig++] = n;
            }
        }
        if (!nsig) continue;

        int ctx_set = (i == 0 || cidx > 0) ? 0 : 2;
        if (c1 == 0) ctx_set++;
        c1 = 1;
        int gt1[16];
        int gt2_pos = -1;
        for (int k = 0; k < nsig && k < 8; k++) {
            int base = ctx_set * 4 + (c1 < 3 ? c1 : 3) + (cidx ? 16 : 0);
            int f = dec_bin(c, ox->gt1 + base);
            gt1[k] = f;
            if (f) { if (gt2_pos < 0) gt2_pos = k; c1 = 0; }
            else if (c1 > 0 && c1 < 3) c1++;
        }
        int gt2 = 0;
        if (gt2_pos >= 0)
            gt2 = dec_bin(c, ox->gt2 + ctx_set + (cidx ? 4 : 0));

        int first_sig = sig_pos[nsig - 1];
        int last_sig = sig_pos[0];
        int sign_hidden = sdh && !tq_bypass && (last_sig - first_sig) > 3;
        int signs[16];
        for (int k = 0; k < nsig; k++) {
            if (sign_hidden && sig_pos[k] == first_sig) { signs[k] = -1; continue; }
            signs[k] = dec_bypass(c);
        }

        int rice = 0;
        int64_t sum_abs = 0;
        int vals[16];
        for (int k = 0; k < nsig; k++) {
            int had_gt1 = k < 8;
            int is_g2 = (k == gt2_pos);
            int base_level = 1 + (had_gt1 ? gt1[k] : 0) + (is_g2 ? gt2 : 0);
            int threshold = had_gt1 ? (is_g2 ? 3 : 2) : 1;
            int level = base_level;
            if (base_level == threshold) {
                /* coeff_abs_level_remaining: TR(4<<rice) + EG(rice+1) */
                int prefix = 0;
                while (prefix < 4 && dec_bypass(c)) prefix++;
                int rem;
                if (prefix < 4) {
                    int suffix = rice ? dec_bypass_bits(c, rice) : 0;
                    rem = (prefix << rice) + suffix;
                } else {
                    rem = (4 << rice) + dec_eg(c, rice + 1);
                }
                level += rem;
                if (level > (3 << rice) && rice < 4) rice++;
            }
            sum_abs += level;
            vals[k] = level;
        }
        for (int k = 0; k < nsig; k++) {
            int n = sig_pos[k];
            int p = scan[(i << 4) + n];
            int xc = p & 0xff, yc = p >> 8;
            int neg;
            if (sign_hidden && n == first_sig) neg = (int)(sum_abs & 1);
            else neg = signs[k];
            levels[yc * size + xc] = neg ? -vals[k] : vals[k];
        }
    }
    return c->err ? -1 : tskip;
}

/* -- thin wrappers so Python can drive single bins through the same state -- */
EXPORT int cabac_init(Cabac *c, const uint8_t *buf, int64_t nbytes,
                      uint8_t *state, uint8_t *mps) {
    c->buf = buf; c->nbits = nbytes * 8; c->pos = 0;
    c->range = 510; c->err = 0;
    c->state = state; c->mps = mps;
    c->offset = 0;
    for (int i = 0; i < 9; i++) c->offset = (c->offset << 1) | read_bit(c);
    return c->err;
}
EXPORT int cabac_bin(Cabac *c, int idx) { return dec_bin(c, idx); }
EXPORT int cabac_bypass(Cabac *c) { return dec_bypass(c); }
EXPORT int cabac_bypass_bits(Cabac *c, int n) { return dec_bypass_bits(c, n); }
EXPORT int cabac_terminate(Cabac *c) { return dec_terminate(c); }
EXPORT int cabac_eg(Cabac *c, int k) { return dec_eg(c, k); }
EXPORT int64_t cabac_pos(Cabac *c) { return c->pos; }
EXPORT int cabac_err(Cabac *c) { return c->err; }
