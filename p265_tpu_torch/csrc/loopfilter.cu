// The in-loop filters of HEVC on batches of int32 planes [B,H,W]: the
// deblocking of the vertical edges at x = 8(k+1), then of the horizontal
// edges at y = 8(k+1) (8.7.2), and SAO (8.7.3), bit-exact with
// p265_tpu_torch/kernels/loopfilter.py deblock_planes_ref (and, one
// direction, deblock_luma_vertical_ref and deblock_chroma_vertical_ref) and
// sao_apply_ref.
//
// Replaces the device half of p265_tpu/kernels/loopfilter.py:
// `_deblock_luma_vertical` (:146), `_deblock_chroma_vertical` (:231) and
// `_sao_apply` (:296), jax.jit functions that XLA fused inside the
// dispatch's one program (vmapped at p265_tpu/pipeline/batch_decode.py
// :449-476; the horizontal pass on swapped axes).  Not Pallas kernels.
//
// What bounds them on Hopper: bytes.  Each reads every sample of its
// planes once and writes every sample once (int32 at the function's
// boundary: 12.4 MB each way for a 1080p picture's three planes, ~7.4 us
// at 3.35 TB/s), plus a few parameters per 4-line segment of an edge or
// per CTB; the arithmetic (a few dozen integer operations a sample) is far
// below the bytes.  A design that passes over the planes more than once,
// or loads a sector per thread, pays for it directly.  So:
// - deblocking (`deblock_tiles`): ONE launch for both directions and for a
//   table of plane groups (a dispatch's luma and chroma).  A CTA takes a
//   32x32 tile of output samples and stages the tile plus a 4-sample halo
//   on every side in shared memory with cp.async (16 bytes a thread where
//   the rows are dense and aligned, 4 otherwise).  It filters the vertical
//   edges of every staged row, halo rows included, then (after a barrier)
//   the horizontal edges of the tile's columns from those V-filtered
//   samples, and stores the tile's own samples once, in 16-byte stores
//   where the output is dense.  This equals V then H over the whole plane:
//   a V-filtered sample depends only on its own row, within the 8-column
//   window of its edge, and on lines 0 and 3 of its 4-line segment; an H
//   edge at the tile's top or bottom row reads 4 V-filtered rows beyond
//   it.  Tiles and halos start on multiples of 4 rows and columns, so a
//   staged segment holds its lines 0 and 3.  The edges of a direction are
//   8 apart and each reads and writes only its own 8-sample window, so
//   they filter in place; the threads of one segment read its decision
//   lines before any of them writes (a barrier between).  bS is folded
//   into beta as the tile loads its segments' parameters, once.  The
//   single-direction calls (the row-sharded deblocking, on any strides)
//   run the same kernel without the second pass and the row halo;
// - both read their parameters at the reference's wire dtypes, as a
//   dispatch stages them (kernels/loopfilter.py pack_filter_params): the
//   deblocking's bS, beta and tc grids int16, SAO's type, class and offset
//   maps int8;
// - SAO (`sao_tiles`): a CTA per 64x32 tile aligned to the CTB grid in
//   picture rows (the first and last tile of a band of rows may be
//   partial).  It loads the parameters of the tile's CTBs (one CTB for
//   64-sample CTBs, at most 32 for 8-sample ones) once into shared memory,
//   stages the tile plus a 1-sample halo (as 4 aligned columns) with
//   cp.async, and each thread filters 4 adjacent samples of a row and
//   writes them with one 16-byte store.  A sample finds its CTB by shifts:
//   no thread divides.  A row offset, the picture's height and halo rows
//   let the row-sharded SAO (shard/filters.py) filter a band of rows
//   through the same kernel; rows past the CTB map take its last CTB row.
//   Its store is the end of the dispatch's filter chain (the counterpart
//   of p265_tpu/pipeline/batch_decode.py:476-480): it writes uint8 (or
//   int32) samples, and where a bypass mask is given, the prefilter sample
//   in place of the filtered one (mask ? prefilter : sao(deblocked)), so
//   no restore or cast follows it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(g));
}
__device__ __forceinline__ void cp_async16(int32_t* smem, const int32_t* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// whether rows of 4 int32 starting at multiples of 4 elements are 16-byte
// aligned: unit column stride, row and plane strides multiples of 4
bool dense16(const void* ptr, long long sb, long long sy, long long sx) {
  return sx == 1 && sy % 4 == 0 && sb % 4 == 0 &&
         reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// ---------------------------------------------------------------------------
// deblocking
// ---------------------------------------------------------------------------

constexpr int kTileW = 32, kTileH = 32;  // output samples of a tile
constexpr int kHalo = 4;
constexpr int kPitch = kTileW + 2 * kHalo + 4;  // ints: 16-byte rows
constexpr int kEdges = kTileW / 8 + 1;  // edges a tile row (column) meets
constexpr int kMaxGroups = 2;
constexpr int kDbCols = 20;             // int64 columns of a group's row
static_assert(kTileW == kTileH && kTileW % 8 == 0, "square tiles of 8k");
static_assert((kTileH + 2 * kHalo) * kEdges <= kThreads,
              "a thread a (staged row, edge)");

struct DbGroup {
  const int32_t* in;
  int32_t* out;
  const int16_t* v[3];   // bS, beta, tc of the vertical edges
                         // [B, H/4, n_ev] (bS, beta null for chroma)
  const int16_t* h[3];   // of the horizontal edges [B, W/4, n_eh]
  long long ib, iy, ix;  // input strides, in elements
  long long ob, oy, ox;  // output strides
  int B, H, W, n_ev, n_eh, chroma;
  int tiles_x, tiles_y, first_tile;
  int vec_in, vec_out;   // 16-byte loads / stores (dense16)
};

struct DbParams {
  DbGroup g[kMaxGroups];
  int n_groups;
};

// The luma filter of line `ln` of a 4-line segment of one edge (8.7.2.5.3,
// .5.6, .5.7): e points at q0 of line 0, s steps across the edge (p_i at
// e - (i+1)s, q_i at e + i s), l from line to line.  beta is 0 where bS is
// 0.  -> the new p2, p1, p0, q0, q1, q2 of the line.
__device__ __forceinline__ void luma_line(const int32_t* e, int s, int l,
                                          int ln, int beta, int tc,
                                          int o[6]) {
  const int32_t* l0 = e;
  const int32_t* l3 = e + 3 * l;
  const int dp0 = iabs(l0[-3 * s] - 2 * l0[-2 * s] + l0[-s]);
  const int dp3 = iabs(l3[-3 * s] - 2 * l3[-2 * s] + l3[-s]);
  const int dq0 = iabs(l0[2 * s] - 2 * l0[s] + l0[0]);
  const int dq3 = iabs(l3[2 * s] - 2 * l3[s] + l3[0]);
  const bool filt = dp0 + dp3 + dq0 + dq3 < beta;
  auto strong_line = [&](const int32_t* r, int dpl, int dql) {
    return 2 * (dpl + dql) < (beta >> 2) &&
           iabs(r[-4 * s] - r[-s]) + iabs(r[0] - r[3 * s]) < (beta >> 3) &&
           iabs(r[-s] - r[0]) < ((5 * tc + 1) >> 1);
  };
  const bool strong = filt && strong_line(l0, dp0, dq0) &&
                      strong_line(l3, dp3, dq3);
  const int side = (beta + (beta >> 1)) >> 3;
  const int32_t* r = e + ln * l;
  const int p0 = r[-s], p1 = r[-2 * s], p2 = r[-3 * s], p3 = r[-4 * s];
  const int q0 = r[0], q1 = r[s], q2 = r[2 * s], q3 = r[3 * s];
  o[0] = p2; o[1] = p1; o[2] = p0; o[3] = q0; o[4] = q1; o[5] = q2;
  if (strong) {
    o[2] = clip3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - 2 * tc,
                 p0 + 2 * tc);
    o[1] = clip3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc, p1 + 2 * tc);
    o[0] = clip3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - 2 * tc,
                 p2 + 2 * tc);
    o[3] = clip3((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0 - 2 * tc,
                 q0 + 2 * tc);
    o[4] = clip3((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tc, q1 + 2 * tc);
    o[5] = clip3((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2 - 2 * tc,
                 q2 + 2 * tc);
  } else if (filt) {
    const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
    if (iabs(delta) < tc * 10) {
      const int dlt = clip3(delta, -tc, tc);
      o[2] = clip3(p0 + dlt, 0, 255);
      o[3] = clip3(q0 - dlt, 0, 255);
      if (dp0 + dp3 < side)
        o[1] = clip3(p1 + clip3((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                                -(tc >> 1), tc >> 1), 0, 255);
      if (dq0 + dq3 < side)
        o[4] = clip3(q1 + clip3((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                                -(tc >> 1), tc >> 1), 0, 255);
    }
  }
}

// The chroma filter of one line (8.7.2.5.5): r points at q0 -> p0, q0.
__device__ __forceinline__ void chroma_line(const int32_t* r, int s, int tc,
                                            int o[2]) {
  const int p1 = r[-2 * s], p0 = r[-s], q0 = r[0], q1 = r[s];
  o[0] = p0;
  o[1] = q0;
  if (tc > 0) {
    const int delta = clip3(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, -tc, tc);
    o[0] = clip3(p0 + delta, 0, 255);
    o[1] = clip3(q0 - delta, 0, 255);
  }
}

// One direction's edges on the staged tile, in place.  A work item is
// (line, edge): `ln` the line's index in its 4-line segment, e0 the
// staged q0 of the segment's line 0 (nullptr: no work), s and l the steps
// across the edge and from line to line.  Every item reads before any
// writes.
__device__ __forceinline__ void filter_lines(int32_t* e0, int s, int l,
                                             int ln, int beta, int tc,
                                             bool chroma) {
  int o[6];
  if (e0) {
    if (chroma)
      chroma_line(e0 + ln * l, s, tc, o);
    else
      luma_line(e0, s, l, ln, beta, tc, o);
  }
  __syncthreads();
  if (e0) {
    int32_t* r = e0 + ln * l;
    if (chroma) {
      r[-s] = o[0];
      r[0] = o[1];
    } else {
#pragma unroll
      for (int i = 0; i < 6; ++i) r[(i - 3) * s] = o[i];
    }
  }
}

template <bool kBoth>
__global__ void __launch_bounds__(kThreads)
deblock_tiles(const __grid_constant__ DbParams p) {
  constexpr int HR = kBoth ? kHalo : 0;  // halo rows: the H pass reads them
  constexpr int RH = kTileH + 2 * HR;    // staged rows
  constexpr int CH = (kTileW + 2 * kHalo) / 4;  // 4-column chunks a row
  __shared__ __align__(16) int32_t tile[RH * kPitch];
  __shared__ int v_beta[RH / 4][kEdges], v_tc[RH / 4][kEdges];
  __shared__ int h_beta[kTileW / 4][kEdges], h_tc[kTileW / 4][kEdges];

  // the group of this CTA: the last one that starts at or before it
  int gi = 0;
  for (int i = 1; i < p.n_groups; ++i)
    if (static_cast<int>(blockIdx.x) >= p.g[i].first_tile) gi = i;
  const DbGroup& g = p.g[gi];
  int t = static_cast<int>(blockIdx.x) - g.first_tile;
  const int tx = t % g.tiles_x;
  t /= g.tiles_x;
  const int ty = t % g.tiles_y;
  const int b = t / g.tiles_y;
  const int x0 = tx * kTileW, y0 = ty * kTileH;
  const int rx0 = x0 - kHalo, ry0 = y0 - HR;  // staged origin
  const int tid = threadIdx.x;

  // stage the tile and its halo (samples outside the plane stay unset:
  // no edge that exists reads them)
  const int32_t* in = g.in + b * g.ib;
  for (int i = tid; i < RH * CH; i += kThreads) {
    const int r = i / CH, x = rx0 + 4 * (i % CH), y = ry0 + r;
    if (y < 0 || y >= g.H) continue;
    int32_t* dst = tile + r * kPitch + (x - rx0);
    const int32_t* row = in + y * g.iy;
    if (g.vec_in && x >= 0 && x + 4 <= g.W) {
      cp_async16(dst, row + x);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j >= 0 && x + j < g.W) cp_async4(dst + j, row + (x + j) * g.ix);
    }
  }
  // the parameters of the tile's segments, once; bS folded into beta
  // (d < beta is never true for beta 0); 0 where no edge exists
  const int kv0 = x0 / 8 - 1, kh0 = y0 / 8 - 1;  // edge index of item 0
  for (int i = tid; i < (RH / 4) * kEdges; i += kThreads) {
    const int si = i / kEdges, j = i % kEdges;
    const int s = ry0 / 4 + si, k = kv0 + j;
    int beta = 0, tc = 0;
    if (s >= 0 && s < g.H / 4 && k >= 0 && k < g.n_ev) {
      const long long o = (static_cast<long long>(b) * (g.H / 4) + s) *
                              g.n_ev + k;
      tc = g.v[2][o];
      if (!g.chroma) beta = g.v[0][o] > 0 ? g.v[1][o] : 0;
    }
    v_beta[si][j] = beta;
    v_tc[si][j] = tc;
  }
  if (kBoth) {
    for (int i = tid; i < (kTileW / 4) * kEdges; i += kThreads) {
      const int si = i / kEdges, j = i % kEdges;
      const int s = x0 / 4 + si, k = kh0 + j;
      int beta = 0, tc = 0;
      if (s < g.W / 4 && k >= 0 && k < g.n_eh) {
        const long long o = (static_cast<long long>(b) * (g.W / 4) + s) *
                                g.n_eh + k;
        tc = g.h[2][o];
        if (!g.chroma) beta = g.h[0][o] > 0 ? g.h[1][o] : 0;
      }
      h_beta[si][j] = beta;
      h_tc[si][j] = tc;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // vertical edges c = x0 + 8j of every staged row: item (row r, edge j)
  {
    const int r = tid / kEdges, j = tid % kEdges;
    const int y = ry0 + r, k = kv0 + j;
    const bool on = tid < RH * kEdges && y >= 0 && y < g.H && k >= 0 &&
                    k < g.n_ev;
    int32_t* e0 = on ? tile + (r & ~3) * kPitch + kHalo + 8 * j : nullptr;
    filter_lines(e0, 1, kPitch, r & 3, on ? v_beta[r >> 2][j] : 0,
                 on ? v_tc[r >> 2][j] : 0, g.chroma);
  }
  // horizontal edges y = y0 + 8j of the tile's columns: item (column c,
  // edge j), neighbouring threads on neighbouring columns
  if (kBoth) {
    __syncthreads();
    const int c = tid % kTileW, j = tid / kTileW;
    const int k = kh0 + j;
    const bool on = j < kEdges && x0 + c < g.W && k >= 0 && k < g.n_eh;
    int32_t* e0 =
        on ? tile + (HR + 8 * j) * kPitch + kHalo + (c & ~3) : nullptr;
    filter_lines(e0, kPitch, 1, c & 3, on ? h_beta[c >> 2][j] : 0,
                 on ? h_tc[c >> 2][j] : 0, g.chroma);
  }
  __syncthreads();

  // the tile's own samples, once
  int32_t* out = g.out + b * g.ob;
  for (int i = tid; i < kTileH * (kTileW / 4); i += kThreads) {
    const int r = i / (kTileW / 4), x = x0 + 4 * (i % (kTileW / 4));
    const int y = y0 + r;
    if (y >= g.H || x >= g.W) continue;
    const int32_t* src = tile + (r + HR) * kPitch + kHalo + (x - x0);
    int32_t* row = out + y * g.oy;
    if (g.vec_out && x + 4 <= g.W) {
      *reinterpret_cast<int4*>(row + x) =
          *reinterpret_cast<const int4*>(src);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < g.W) row[(x + j) * g.ox] = src[j];
    }
  }
}

// ---------------------------------------------------------------------------
// SAO
// ---------------------------------------------------------------------------

constexpr int kSaoW = 64, kSaoH = 32;     // output samples of a tile
constexpr int kSaoPitch = kSaoW + 8 + 4;  // ints: x0-4 .. x0+67, staggered
constexpr int kSaoRows = kSaoH + 2;
constexpr int kMinCtb = 8;
constexpr int kMaxCtbs = (kSaoW / kMinCtb) * (kSaoH / kMinCtb);

struct SaoParams {
  const int32_t* src;    // [B, H + 2 * src_row0, W], strided
  void* out;             // [B, H, W] contiguous, uint8 or int32
  const int8_t* ty;      // [B, ny, nx]
  const int8_t* cls;     // [B, ny, nx]
  const int8_t* off;     // [B, 4, ny, nx]
  const int32_t* pre;    // [B, H, W] strided: the prefilter samples
  const uint8_t* mask;   // [B, H, W] contiguous bool, or null: bypass
  long long pb, py, px;  // pre's strides, in elements
  int out_u8;
  int B, H, W;
  long long sb, sy, sx;  // source strides, in elements
  int src_row0;          // source row of output row 0 (1: a halo row above)
  int row0, total_h;     // picture row of output row 0; picture height
  int ny, nx, lg, band, edge;  // lg: log2 of the CTB size
  int tiles_x, tiles_y, tile_row0;  // tile_row0: row0 / kSaoH
  int vec_in, vec_out;
};

__global__ void __launch_bounds__(kThreads)
sao_tiles(const __grid_constant__ SaoParams p) {
  __shared__ __align__(16) int32_t tile[kSaoRows * kSaoPitch];
  __shared__ int c_ty[kMaxCtbs], c_cls[kMaxCtbs], c_off[4][kMaxCtbs];
  constexpr int CH = (kSaoW + 8) / 4;  // chunks a staged row: x0-4..x0+67
  int t = static_cast<int>(blockIdx.x);
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  const int b = t / p.tiles_y;
  const int tid = threadIdx.x;
  // the tile's picture rows [g0, g1) and columns [x0, x1)
  const int gt = (p.tile_row0 + ty) * kSaoH;
  const int g0 = max(gt, p.row0), g1 = min(gt + kSaoH, p.row0 + p.H);
  const int x0 = tx * kSaoW, x1 = min(x0 + kSaoW, p.W);
  // staged row 0 is the source row above g0's
  const int sr0 = g0 - p.row0 + p.src_row0 - 1;
  const int hs = p.H + 2 * p.src_row0;
  const int32_t* src = p.src + b * p.sb;
  for (int i = tid; i < (g1 - g0 + 2) * CH; i += kThreads) {
    const int r = i / CH, x = x0 - 4 + 4 * (i % CH), sr = sr0 + r;
    if (sr < 0 || sr >= hs) continue;
    int32_t* dst = tile + r * kSaoPitch + (x - x0 + 4);
    const int32_t* row = src + sr * p.sy;
    if (p.vec_in && x >= 0 && x + 4 <= p.W) {
      cp_async16(dst, row + x);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j >= 0 && x + j < p.W) cp_async4(dst + j, row + (x + j) * p.sx);
    }
  }
  // the tile's CTBs, once: rows past the map take its last row
  const int cy0 = min(g0 >> p.lg, p.ny - 1);
  const int cy1 = min((g1 - 1) >> p.lg, p.ny - 1);
  const int cx0 = x0 >> p.lg, ncx = ((x1 - 1) >> p.lg) - cx0 + 1;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  for (int i = tid; i < (cy1 - cy0 + 1) * ncx; i += kThreads) {
    const int cy = cy0 + i / ncx, cx = cx0 + i % ncx;
    const long long c = (static_cast<long long>(b) * p.ny + cy) * p.nx + cx;
    c_ty[i] = p.ty[c];
    c_cls[i] = p.cls[c];
    const int8_t* off = p.off + b * 3 * plane + c;  // off[b, k, cy, cx]
#pragma unroll
    for (int k = 0; k < 4; ++k) c_off[k][i] = off[k * plane];
  }
  cp_async_wait_all();
  __syncthreads();

  // a thread 4 adjacent samples of a row, all of one CTB (CTBs >= 8)
  const long long out0 = static_cast<long long>(b) * p.H * p.W;
  for (int i = tid; i < kSaoH * (kSaoW / 4); i += kThreads) {
    const int r = i / (kSaoW / 4), x = x0 + 4 * (i % (kSaoW / 4));
    const int gy = g0 + r;
    if (gy >= g1 || x >= x1) continue;
    const int ci = (min(gy >> p.lg, p.ny - 1) - cy0) * ncx +
                   (x >> p.lg) - cx0;
    const int type = c_ty[ci], cl = c_cls[ci];
    const int32_t* v = tile + (r + 1) * kSaoPitch + (x - x0 + 4);
    // the neighbours of the edge class: (dy0, dx0), (dy1, dx1)
    const int e = cl == 0 ? 0 : cl == 1 ? 1 : cl == 2 ? 2 : 3;
    const int dy0 = e == 0 ? 0 : -1, dx0 = e == 1 ? 0 : e == 3 ? 1 : -1;
    const int dy1 = -dy0, dx1 = -dx0;
    const bool rows_ok = gy + dy0 >= 0 && gy + dy0 < p.total_h &&
                         gy + dy1 >= 0 && gy + dy1 < p.total_h;
    int res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = v[j];
      int delta = 0;
      if (type == p.band) {
        const int rel = ((s >> 3) - cl) & 31;
        if (rel < 4) delta = c_off[rel][ci];
      } else if (type == p.edge) {
        const int xj = x + j;
        if (rows_ok && xj + dx0 >= 0 && xj + dx0 < p.W && xj + dx1 >= 0 &&
            xj + dx1 < p.W) {
          const int n0 = v[j + dy0 * kSaoPitch + dx0];
          const int n1 = v[j + dy1 * kSaoPitch + dx1];
          const int k = sgn(s - n0) + sgn(s - n1);
          if (k != 0) delta = c_off[k < 0 ? k + 2 : k + 1][ci];
        }
      }
      res[j] = clip3(s + delta, 0, 255);
    }
    const long long row = out0 + static_cast<long long>(gy - p.row0) * p.W;
    if (p.mask) {   // bypass samples keep their prefilter values
      const uint8_t* mk = p.mask + row;
      const int32_t* pr = p.pre + b * p.pb + (gy - p.row0) * p.py;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x + j < p.W && mk[x + j]) res[j] = pr[(x + j) * p.px];
    }
    if (p.out_u8) {
      uint8_t* o = static_cast<uint8_t*>(p.out) + row;
      if (p.vec_out && x + 4 <= p.W) {
        *reinterpret_cast<uchar4*>(o + x) =
            make_uchar4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x + j < p.W) o[x + j] = static_cast<uint8_t>(res[j]);
      }
    } else {
      int32_t* o = static_cast<int32_t*>(p.out) + row;
      if (p.vec_out && x + 4 <= p.W) {
        *reinterpret_cast<int4*>(o + x) = make_int4(res[0], res[1], res[2],
                                                    res[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (x + j < p.W) o[x + j] = res[j];
      }
    }
  }
}

}  // namespace

// table: n_groups rows of kDbCols int64 (host memory): in, out, bS_v,
//   beta_v, tc_v, bS_h, beta_h, tc_h (device pointers; bS and beta 0 for
//   chroma, the _h ones 0 for one direction), chroma, B, H, W, n_ev, n_eh,
//   in strides (b, y, x), out strides (b, y, x).  both: 1 vertical then
//   horizontal edges, 0 the vertical edges only.
extern "C" int p265_deblock(const int64_t* table, int n_groups, int both,
                            cudaStream_t stream) {
  if (n_groups <= 0 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  DbParams p{};
  p.n_groups = n_groups;
  long long tiles = 0;
  for (int i = 0; i < n_groups; ++i) {
    const int64_t* q = table + static_cast<int64_t>(i) * kDbCols;
    DbGroup& g = p.g[i];
    g.in = reinterpret_cast<const int32_t*>(q[0]);
    g.out = reinterpret_cast<int32_t*>(q[1]);
    for (int k = 0; k < 3; ++k) {
      g.v[k] = reinterpret_cast<const int16_t*>(q[2 + k]);
      g.h[k] = reinterpret_cast<const int16_t*>(q[5 + k]);
    }
    g.chroma = static_cast<int>(q[8]);
    g.B = static_cast<int>(q[9]);
    g.H = static_cast<int>(q[10]);
    g.W = static_cast<int>(q[11]);
    g.n_ev = static_cast<int>(q[12]);
    g.n_eh = both ? static_cast<int>(q[13]) : 0;
    g.ib = q[14];
    g.iy = q[15];
    g.ix = q[16];
    g.ob = q[17];
    g.oy = q[18];
    g.ox = q[19];
    // every edge's window lies inside the plane; whole 4-line segments
    const int reach = g.chroma ? 2 : 4;
    const bool params_ok =
        (g.n_ev == 0 || (g.v[2] && (g.chroma || (g.v[0] && g.v[1])))) &&
        (g.n_eh == 0 || (g.h[2] && (g.chroma || (g.h[0] && g.h[1]))));
    if (g.B <= 0 || g.H <= 0 || g.W <= 0 || g.H % 4 != 0 ||
        (both && g.W % 4 != 0) || g.n_ev < 0 || g.n_eh < 0 ||
        8LL * g.n_ev + reach > g.W || 8LL * g.n_eh + reach > g.H ||
        !g.in || !g.out || !params_ok)
      return static_cast<int>(cudaErrorInvalidValue);
    g.vec_in = dense16(g.in, g.ib, g.iy, g.ix);
    g.vec_out = dense16(g.out, g.ob, g.oy, g.ox);
    g.tiles_x = (g.W + kTileW - 1) / kTileW;
    g.tiles_y = (g.H + kTileH - 1) / kTileH;
    g.first_tile = static_cast<int>(tiles);
    tiles += static_cast<long long>(g.B) * g.tiles_x * g.tiles_y;
  }
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (both)
    deblock_tiles<true><<<static_cast<unsigned>(tiles), kThreads, 0,
                          stream>>>(p);
  else
    deblock_tiles<false><<<static_cast<unsigned>(tiles), kThreads, 0,
                           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// q: 25 int64 (host memory): src, out, ty, cls, off (device pointers;
//   the maps int8), B, H, W, src strides (b, y, x), src_row0, row0,
//   total_h, ny, nx, ctb, the type values of band offset and of edge
//   offset, out_u8 (out is uint8, else int32), pre, mask (device
//   pointers, or 0 for no bypass restore; mask contiguous bool [B,H,W]),
//   pre strides (b, y, x).
extern "C" int p265_sao(const int64_t* q, cudaStream_t stream) {
  SaoParams p{};
  p.src = reinterpret_cast<const int32_t*>(q[0]);
  p.out = reinterpret_cast<void*>(q[1]);
  p.ty = reinterpret_cast<const int8_t*>(q[2]);
  p.cls = reinterpret_cast<const int8_t*>(q[3]);
  p.off = reinterpret_cast<const int8_t*>(q[4]);
  p.B = static_cast<int>(q[5]);
  p.H = static_cast<int>(q[6]);
  p.W = static_cast<int>(q[7]);
  p.sb = q[8];
  p.sy = q[9];
  p.sx = q[10];
  p.src_row0 = static_cast<int>(q[11]);
  p.row0 = static_cast<int>(q[12]);
  p.total_h = static_cast<int>(q[13]);
  p.ny = static_cast<int>(q[14]);
  p.nx = static_cast<int>(q[15]);
  const long long ctb = q[16];
  p.band = static_cast<int>(q[17]);
  p.edge = static_cast<int>(q[18]);
  p.out_u8 = static_cast<int>(q[19]);
  p.pre = reinterpret_cast<const int32_t*>(q[20]);
  p.mask = reinterpret_cast<const uint8_t*>(q[21]);
  p.pb = q[22];
  p.py = q[23];
  p.px = q[24];
  p.lg = 0;
  while ((1LL << p.lg) < ctb) ++p.lg;
  // CTBs of a power of two from 8 (a tile holds at most kMaxCtbs, and 4
  // adjacent samples lie in one CTB); a neighbour row the picture has
  // lies in the source
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || ctb < kMinCtb ||
      (1LL << p.lg) != ctb || p.ny <= 0 || p.nx <= 0 ||
      static_cast<long long>(p.nx) * ctb < p.W || p.src_row0 < 0 ||
      p.row0 < 0 ||
      (p.src_row0 == 0 && (p.row0 > 0 || p.row0 + p.H < p.total_h)) ||
      !p.out || (p.mask && !p.pre))
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec_in = dense16(p.src, p.sb, p.sy, p.sx);
  // 4 samples a store: 16 bytes of int32, or 4 of uint8
  p.vec_out = p.out_u8 ? p.W % 4 == 0 &&
                             reinterpret_cast<uintptr_t>(p.out) % 4 == 0
                       : dense16(p.out, static_cast<long long>(p.H) * p.W,
                                 p.W, 1);
  p.tiles_x = (p.W + kSaoW - 1) / kSaoW;
  p.tile_row0 = p.row0 / kSaoH;
  p.tiles_y = (p.row0 + p.H + kSaoH - 1) / kSaoH - p.tile_row0;
  const long long tiles = static_cast<long long>(p.B) * p.tiles_x *
                          p.tiles_y;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sao_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
