// Motion compensation (HEVC 8.5.3.3) of every MC block of one picture in
// ONE launch: for each block, the (block+taps-1)^2 reference window of each
// of its lists, the separable 8-tap (luma) or 4-tap (chroma) int32 filter,
// >> 6, and then one of two epilogues:
// - the samples (kUni, kBi): the uni, bi or explicitly weighted combination
//   of the block's lists (8.5.3.3.4.2-3, its wp row), clipped to 8 bits and
//   stored straight into the destination plane at the block's position,
//   bit-exact with p265_tpu_torch/kernels/mc.py mc_pred_planes_ref (the
//   interpolation, combine() and the scatter into the plane); pad blocks
//   (a position at or below the plane's height) are skipped;
// - the 14-bit intermediates (kRaw) of one list a group, [n,B,B] int32,
//   bit-exact with mc.py mc_blocks_ref (mc_blocks_grouped).
// Any MV is exact: a window that crosses the picture edge is loaded sample
// by sample with the row and column clamped to the picture (the spec's edge
// rule).
//
// Replaces p265_tpu/kernels/pallas_mc.py `_kernel` (mc_blocks_pallas), and
// with it the rest of the MC stage of the reference's device program,
// p265_tpu/kernels/mc.py mc_pred_plane (`_combine` and the scatter into the
// plane).  The TPU kernel DMA'd (8,128)-aligned covering tiles out of an
// edge-padded reference stack and rolled them to the window origin, and was
// exact only while every MV's overreach fit the pad.
//
// What bounds it on Hopper: bytes, by far.  A uni-predicted 1080p P picture
// reads ~3.1 MB of reference windows and ~0.7 MB of block records and
// writes 3.1 M samples; its ~41 M multiply-adds are a few microseconds of
// the int32 lanes.  The version before this one wrote the intermediates of
// each list as int32 (~9.7 MB a picture) and left the combine, the
// placement and a copy into the tall plane to a dozen torch operations a
// plane (about 12x the kernel's own device time), and each of its CTAs ran
// one load -> sync -> horizontal -> sync -> vertical chain over a handful of
// blocks, with nothing in flight across the barriers.  So this version:
// - takes a table of groups (one per (plane, block size) bucket, both
//   lists; or, for the intermediates, one per (plane, size, list)) as a
//   kernel parameter; each CTA walks a run of consecutive tiles of one
//   group, a tile being the blocks that 128 threads cover (a thread filters
//   2 adjacent columns of a block: 16 blocks of 16x16, 128 of 2x2);
// - stages the windows of the next tile with cp.async (4-byte words of the
//   reference rows, aligned) into the other half of a double buffer in
//   dynamic shared memory while the current tile filters; windows that
//   cross the picture edge take the clamped per-sample path instead;
// - runs the horizontal and the vertical pass in registers: a thread walks
//   down its 2 columns, each window row filtered horizontally once (9 or 5
//   byte reads of shared memory for 2 results) into a ring of the last TAPS
//   rows, from which each output row takes its vertical sum: no barrier and
//   no shared round trip between the passes;
// - combines both lists in registers and stores the finished samples at
//   their place in the destination plane (the tall prediction plane at the
//   frame's segment row), coalesced along each row: the intermediates never
//   leave the SM.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2;        // adjacent columns a thread filters
constexpr int kBitDepth = 8;
constexpr int kMaxGroups = 32;
constexpr int kTableCols = 19;

enum Epilogue { kRaw = 0, kUni = 1, kBi = 2 };

struct McGroup {
  const uint8_t* refs;     // [R,H,W] reference planes
  const int32_t* pos;      // [n,2] (y, x) block origins
  const int32_t* mv[2];    // [n,2] (mvx, mvy) of each list, 1/4 or 1/8 pel
  const int32_t* ridx[2];  // [n] reference index of each list
  const uint8_t* has1;     // [n] the block reads list 1 (kBi)
  const int32_t* wp;       // [n,5] (w0, o0, w1, o1, log2_wd) (kUni, kBi)
  int32_t* dst;            // kRaw: [n,B,B]; else the plane's first sample
  int R, H, W, n;
  int block, taps, vec;    // vec: W % 4 == 0 and refs 4-byte aligned
  int pitch, dh, dw;       // destination row pitch and plane shape
  int first_cta;
};

struct McParams {
  McGroup g[kMaxGroups];
  int n_groups, tiles_per_cta;
  signed char luma[4 * 8];     // LUMA_FILTER [fraction][tap]
  signed char chroma[8 * 4];   // CHROMA_FILTER [fraction][tap]
};

// blocks a tile: one thread for each kCols columns of a block
__host__ __device__ constexpr int tile_blocks(int block) {
  return kThreads / (block / kCols);
}

// bytes of one half of the double buffer: the windows of every list, as
// words of reference rows from the window's column rounded down to 4 (so
// its lead is 0..3), then one int4 record a block and list
__host__ __device__ constexpr int buffer_bytes(int block, int taps,
                                               int lists) {
  return lists * tile_blocks(block) *
         ((block + taps - 1) * ((block + taps + 5) / 4) * 4 + 16);
}

template <int BLOCK, int TAPS>
struct Geo {
  static constexpr int SPAN = BLOCK + TAPS - 1;
  static constexpr int WW = (SPAN + 6) / 4;   // words a window row
  static constexpr int TPB = BLOCK / kCols;   // threads a block
  static constexpr int G = tile_blocks(BLOCK);
  static constexpr int WIN = G * SPAN * WW;   // words a list
};

__device__ __forceinline__ void cp_async4(uint32_t* smem, const void* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// meta.w: lead | fraction x << 2 | fraction y << 5 | inside << 8 |
// active << 9 (the block has this list; not a pad block)
__device__ __forceinline__ bool active(int4 m) { return (m.w >> 9) & 1; }

// the record of each block and list of a tile: window origin (row, column
// rounded down to a word), clamped reference index, lead, fractions; the
// shifts and masks of negative MVs are the spec's (arithmetic, two's
// complement)
template <int BLOCK, int TAPS, int E>
__device__ __forceinline__ void tile_meta(const McGroup& g, int tile,
                                          int4* meta) {
  using C = Geo<BLOCK, TAPS>;
  constexpr int L = E == kBi ? 2 : 1;
  constexpr int HALF = TAPS / 2 - 1;
  constexpr int UNIT = TAPS == 8 ? 2 : 3;   // quarter / eighth pel
  constexpr int FMASK = TAPS == 8 ? 3 : 7;
  for (int e = threadIdx.x; e < L * C::G; e += kThreads) {
    const int l = e / C::G, b = tile * C::G + e % C::G;
    int4 m = make_int4(0, 0, 0, 0);
    if (b < g.n) {
      bool on = E == kRaw || g.pos[2 * b] < g.dh;
      if (E == kBi && l == 1) on = on && g.has1[b];
      if (on) {
        const int mx = g.mv[l][2 * b], my = g.mv[l][2 * b + 1];
        const int y = g.pos[2 * b] + (my >> UNIT) - HALF;
        const int x = g.pos[2 * b + 1] + (mx >> UNIT) - HALF;
        const bool inside = g.vec && y >= 0 && y + C::SPAN <= g.H &&
                            x >= 0 && x + C::SPAN <= g.W;
        m = make_int4(y, x & ~3, min(max(g.ridx[l][b], 0), g.R - 1),
                      (x & 3) | (mx & FMASK) << 2 | (my & FMASK) << 5 |
                          static_cast<int>(inside) << 8 | 1 << 9);
      }
    }
    meta[e] = m;
  }
}

// the windows of a tile, [list][block][row][word]: cp.async of aligned
// words inside the picture (a word past the row's end is never read), the
// clamped bytes where a window crosses the edge
template <int BLOCK, int TAPS, int E>
__device__ __forceinline__ void tile_stage(const McGroup& g,
                                           const int4* meta, uint32_t* win) {
  using C = Geo<BLOCK, TAPS>;
  constexpr int L = E == kBi ? 2 : 1;
  const int64_t plane = static_cast<int64_t>(g.H) * g.W;
  for (int e = threadIdx.x; e < L * C::WIN; e += kThreads) {
    const int w = e % C::WW, r = (e / C::WW) % C::SPAN;
    const int4 m = meta[e / (C::WW * C::SPAN)];
    if (!active(m)) continue;
    const uint8_t* src = g.refs + m.z * plane;
    const int x0 = m.y + 4 * w;
    if ((m.w >> 8) & 1) {
      if (x0 + 4 <= g.W)
        cp_async4(win + e, src + static_cast<int64_t>(m.x + r) * g.W + x0);
    } else {
      const uint8_t* row =
          src + static_cast<int64_t>(min(max(m.x + r, 0), g.H - 1)) * g.W;
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v |= static_cast<uint32_t>(row[min(max(x0 + k, 0), g.W - 1)])
             << (8 * k);
      win[e] = v;
    }
  }
}

// one thread: kCols adjacent columns of one block, both lists, every row
template <int BLOCK, int TAPS, int E>
__device__ __forceinline__ void tile_filter(const McGroup& g, int tile,
                                            const int4* meta,
                                            const uint32_t* win,
                                            const int* filt) {
  using C = Geo<BLOCK, TAPS>;
  constexpr int L = E == kBi ? 2 : 1;
  constexpr int NB = kCols + TAPS - 1;   // window bytes a row and thread
  const int k = threadIdx.x / C::TPB, c0 = threadIdx.x % C::TPB * kCols;
  const int b = tile * C::G + k;
  if (!active(meta[k])) return;
  const bool bi = E == kBi && active(meta[C::G + k]);
  int fh[L][TAPS], fv[L][TAPS];
  const uint8_t* base[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int4 m = meta[l * C::G + k];
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      fh[l][t] = filt[((m.w >> 2) & 7) * TAPS + t];
      fv[l][t] = filt[((m.w >> 5) & 7) * TAPS + t];
    }
    base[l] = reinterpret_cast<const uint8_t*>(
                  win + (l * C::G + k) * C::SPAN * C::WW) +
              (m.w & 3) + c0;
  }
  int w0 = 1, o0 = 0, w1 = 1, o1 = 0, wd = 0, py = 0, px = 0;
  if (E != kRaw) {
    const int32_t* wr = g.wp + 5 * static_cast<int64_t>(b);
    w0 = wr[0], o0 = wr[1], w1 = wr[2], o1 = wr[3], wd = wr[4];
    py = g.pos[2 * b], px = g.pos[2 * b + 1] + c0;
  }
  int ring[L][TAPS][kCols];   // horizontal results of the last TAPS rows
#pragma unroll
  for (int i = 0; i < C::SPAN; ++i) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l == 1 && !bi) continue;
      const uint8_t* rp = base[l] + i * C::WW * 4;
      int s[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j] = rp[j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        int acc = 0;
#pragma unroll
        for (int t = 0; t < TAPS; ++t) acc += fh[l][t] * s[c + t];
        ring[l][i % TAPS][c] = acc >> (kBitDepth - 8);
      }
    }
    if (i < TAPS - 1) continue;
    const int r = i - (TAPS - 1);   // output row
    int v[L][kCols];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l == 1 && !bi) continue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        int acc = 0;
#pragma unroll
        for (int t = 0; t < TAPS; ++t)
          acc += fv[l][t] * ring[l][(r + t) % TAPS][c];
        v[l][c] = acc >> 6;
      }
    }
    if (E == kRaw) {
      int32_t* o = g.dst + (static_cast<int64_t>(b) * BLOCK + r) * BLOCK + c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[c] = v[0][c];
      continue;
    }
    // combine (mc.py combine, the reference's _combine): the weighted
    // rounding with the block's wp row; identity rows give the unweighted
    if (py + r < 0 || py + r >= g.dh) continue;
    int32_t* o = g.dst + static_cast<int64_t>(py + r) * g.pitch + px;
    const int shift = wd + 6;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      int x;
      if (bi) {
        const int off = static_cast<int>(
            static_cast<unsigned>(o0 + o1 + 1) << shift);
        x = (v[0][c] * w0 + v[L - 1][c] * w1 + off) >> (wd + 7);
      } else {
        x = ((v[0][c] * w0 + (1 << (shift - 1))) >> shift) + o0;
      }
      if (px + c >= 0 && px + c < g.dw) o[c] = min(max(x, 0), 255);
    }
  }
}

// a CTA: tiles t0..t1-1 of one group; tile t filters while the windows of
// t+1 are in flight into the other half of the buffer
template <int BLOCK, int TAPS, int E>
__device__ __forceinline__ void mc_cta(const McGroup& g,
                                       const signed char* taps, int cta,
                                       int per_cta, unsigned char* smem,
                                       int* filt) {
  using C = Geo<BLOCK, TAPS>;
  constexpr int L = E == kBi ? 2 : 1;
  constexpr int BUF = buffer_bytes(BLOCK, TAPS, L);
  if (threadIdx.x < 32) filt[threadIdx.x] = taps[threadIdx.x];
  const int t0 = cta * per_cta;
  const int t1 = min(t0 + per_cta, (g.n + C::G - 1) / C::G);
  // half h of the buffer: the windows, then the records
  auto win = [&](int h) {
    return reinterpret_cast<uint32_t*>(smem + h * BUF);
  };
  auto meta = [&](int h) {
    return reinterpret_cast<int4*>(smem + h * BUF + L * C::WIN * 4);
  };
  if (t0 < t1) tile_meta<BLOCK, TAPS, E>(g, t0, meta(0));
  __syncthreads();
  if (t0 < t1) tile_stage<BLOCK, TAPS, E>(g, meta(0), win(0));
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1, nxt = cur ^ 1;
    __syncthreads();   // tile t-1 is filtered: the other half is free
    if (t + 1 < t1) tile_meta<BLOCK, TAPS, E>(g, t + 1, meta(nxt));
    __syncthreads();
    if (t + 1 < t1) {
      tile_stage<BLOCK, TAPS, E>(g, meta(nxt), win(nxt));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the windows of tile t have landed
    tile_filter<BLOCK, TAPS, E>(g, t, meta(cur), win(cur), filt);
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads)
mc_grouped_kernel(const __grid_constant__ McParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int filt[32];
  // the group of this CTA: the last one that starts at or before it
  int gi = 0;
  for (int i = 1; i < p.n_groups; ++i)
    if (static_cast<int>(blockIdx.x) >= p.g[i].first_cta) gi = i;
  const McGroup& g = p.g[gi];
  const int cta = static_cast<int>(blockIdx.x) - g.first_cta;
  const int per = p.tiles_per_cta;
  switch (g.block * 16 + g.taps) {   // uniform across the CTA
    case 16 * 16 + 8: mc_cta<16, 8, E>(g, p.luma, cta, per, smem, filt); break;
    case 8 * 16 + 8: mc_cta<8, 8, E>(g, p.luma, cta, per, smem, filt); break;
    case 4 * 16 + 8: mc_cta<4, 8, E>(g, p.luma, cta, per, smem, filt); break;
    case 8 * 16 + 4: mc_cta<8, 4, E>(g, p.chroma, cta, per, smem, filt); break;
    case 4 * 16 + 4: mc_cta<4, 4, E>(g, p.chroma, cta, per, smem, filt); break;
    case 2 * 16 + 4: mc_cta<2, 4, E>(g, p.chroma, cta, per, smem, filt); break;
    default: break;
  }
}

bool geometry_ok(int block, int taps) {
  const int key = block * 16 + taps;
  return key == 16 * 16 + 8 || key == 8 * 16 + 8 || key == 4 * 16 + 8 ||
         key == 8 * 16 + 4 || key == 4 * 16 + 4 || key == 2 * 16 + 4;
}

}  // namespace

// CTAs of `kernel` that the current device holds at once (common.cu)
cudaError_t p265_resident_ctas(const void* kernel, int threads, int smem,
                               int* slots);

// table: n_groups rows of kTableCols int64 (host memory): refs, pos, mv0,
//   mv1|0, ridx0, ridx1|0, has1|0, wp|0, dst (device pointers), R, H, W, n,
//   block, taps, vec, pitch, dh, dw.  luma [4*8] and chroma [8*4] are host
//   int32 filter tables.  epilogue: 0 the intermediates of list 0 into each
//   group's dst [n,B,B]; 1 uni-, 2 bi-predicted samples into each group's
//   plane (dst, pitch, dh x dw).
extern "C" int p265_mc_grouped(const int64_t* table, int n_groups,
                               const int32_t* luma, const int32_t* chroma,
                               int epilogue, cudaStream_t stream) {
  if (n_groups <= 0 || n_groups > kMaxGroups || epilogue < kRaw ||
      epilogue > kBi)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lists = epilogue == kBi ? 2 : 1;
  McParams p{};
  p.n_groups = n_groups;
  for (int i = 0; i < 32; ++i) {
    p.luma[i] = static_cast<signed char>(luma[i]);
    p.chroma[i] = static_cast<signed char>(chroma[i]);
  }
  int tiles[kMaxGroups], total = 0, smem = 0;
  for (int i = 0; i < n_groups; ++i) {
    const int64_t* t = table + static_cast<int64_t>(i) * kTableCols;
    McGroup& g = p.g[i];
    g.refs = reinterpret_cast<const uint8_t*>(t[0]);
    g.pos = reinterpret_cast<const int32_t*>(t[1]);
    g.mv[0] = reinterpret_cast<const int32_t*>(t[2]);
    g.mv[1] = reinterpret_cast<const int32_t*>(t[3]);
    g.ridx[0] = reinterpret_cast<const int32_t*>(t[4]);
    g.ridx[1] = reinterpret_cast<const int32_t*>(t[5]);
    g.has1 = reinterpret_cast<const uint8_t*>(t[6]);
    g.wp = reinterpret_cast<const int32_t*>(t[7]);
    g.dst = reinterpret_cast<int32_t*>(t[8]);
    g.R = static_cast<int>(t[9]);
    g.H = static_cast<int>(t[10]);
    g.W = static_cast<int>(t[11]);
    g.n = static_cast<int>(t[12]);
    g.block = static_cast<int>(t[13]);
    g.taps = static_cast<int>(t[14]);
    g.vec = static_cast<int>(t[15]);
    g.pitch = static_cast<int>(t[16]);
    g.dh = static_cast<int>(t[17]);
    g.dw = static_cast<int>(t[18]);
    const bool lists_ok = epilogue != kBi || (g.mv[1] && g.ridx[1] && g.has1);
    if (!geometry_ok(g.block, g.taps) || g.R <= 0 || g.H <= 0 || g.W <= 0 ||
        g.n < 0 || !lists_ok || (epilogue != kRaw && !g.wp))
      return static_cast<int>(cudaErrorInvalidValue);
    tiles[i] = (g.n + tile_blocks(g.block) - 1) / tile_blocks(g.block);
    total += tiles[i];
    smem = std::max(smem, 2 * buffer_bytes(g.block, g.taps, lists));
  }
  if (total == 0) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(McParams) = epilogue == kRaw ? mc_grouped_kernel<kRaw>
                             : epilogue == kUni ? mc_grouped_kernel<kUni>
                                                : mc_grouped_kernel<kBi>;
  // the largest buffer (4x4 luma blocks, both lists) is 48 KB: above the
  // default with the static table of taps
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // enough tiles a CTA that the grid is one wave of as many CTAs as the
  // SMs hold at once: a CTA's later tiles load while its earlier ones
  // filter, and no partial second wave trails the first
  int slots = 0;
  if (e == cudaSuccess)
    e = p265_resident_ctas(reinterpret_cast<const void*>(kernel), kThreads,
                           smem, &slots);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.tiles_per_cta = std::max(1, (total + slots - 1) / slots);
  int ctas = 0;
  for (int i = 0; i < n_groups; ++i) {
    p.g[i].first_cta = ctas;
    ctas += (tiles[i] + p.tiles_per_cta - 1) / p.tiles_per_cta;
  }
  kernel<<<ctas, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
