// Motion-compensated interpolation (HEVC 8.5.3.3.3) of every MC block of
// one picture in ONE launch: for each block, the (block+taps-1)^2 reference
// window, the separable 8-tap (luma) or 4-tap (chroma) int32 filter, >> 6
// -- the 14-bit intermediates that p265_tpu_torch/kernels/mc.py combine()
// turns into samples.  Bit-exact with mc.py mc_blocks_ref for any MV.
//
// Replaces p265_tpu/kernels/pallas_mc.py `_kernel` (mc_blocks_pallas).
// The TPU kernel DMA'd (8,128)-aligned covering tiles out of an edge-padded
// reference stack and rolled them to the window origin, and was exact only
// while every MV's overreach fit the pad (the mc_overreach gate).  Here a
// window that crosses the picture edge is loaded sample by sample with the
// row and column clamped to the picture -- the spec's edge rule -- so there
// is no pad and no gate.
//
// What bounds it on Hopper: bytes.  One uni-predicted 1080p P picture
// moves ~9.7 MB of int32 output, ~3.1 MB of reference planes and ~0.7 MB
// of block records: ~4 us at 3.35 TB/s, while its ~43 M int32
// multiply-adds take ~2.6 us on the CUDA cores (132 SMs x 64 int32 lanes x
// 1.98 GHz).  The first version took 20-40 us per launch and launched once
// per (plane, block size, list): 9 launches per P picture, some of them
// less than one wave of the card.  So this version:
// - takes a table of groups (one per (plane, block size, list)) as a kernel
//   parameter and gives each CTA a tile of blocks of one group, so one
//   launch per picture fills the 132 SMs with all of its blocks and no
//   table is copied to the device;
// - loads a window that lies inside the picture with aligned 4-byte loads,
//   row by row, into uint8 shared memory (the clamped per-sample path runs
//   only for windows that cross the edge);
// - keeps the horizontal pass in shared memory and writes the vertical
//   pass coalesced: a tile's blocks are contiguous in the output.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBitDepth = 8;
constexpr int kMaxGroups = 32;
constexpr int kSmem = 9472;    // bytes: the largest tile, 64 2x2 blocks
constexpr int kTableCols = 12;

struct McGroup {
  const uint8_t* refs;   // [R,H,W] reference planes
  const int32_t* pos;    // [n,2] (y, x) block origins
  const int32_t* mv;     // [n,2] (mvx, mvy), quarter / eighth pel
  const int32_t* ridx;   // [n] reference index
  int64_t out;           // element offset of the group's [n,B,B] output
  int R, H, W, n;
  int block, taps;
  int first_tile;        // first CTA of the group
  int vec;               // W % 4 == 0 and refs 4-byte aligned
};

struct McParams {
  McGroup g[kMaxGroups];
  int n_groups;
  int luma[4 * 8];       // LUMA_FILTER [fraction][tap]
  int chroma[8 * 4];     // CHROMA_FILTER [fraction][tap]
};

// blocks per CTA: one output sample a thread
__host__ __device__ constexpr int tile_blocks(int block) {
  return block * block >= kThreads ? 1 : kThreads / (block * block);
}

template <int BLOCK, int TAPS>
struct Geo {
  static constexpr int SPAN = BLOCK + TAPS - 1;
  static constexpr int G = tile_blocks(BLOCK);
  static constexpr int WW = (SPAN + 3) / 4 + 1;    // words per window row
  static constexpr int WIN = G * SPAN * WW;        // uint32 words
  static constexpr int TMP = G * SPAN * BLOCK;     // ints
  static constexpr int META = G * (4 + 2 * TAPS);  // ints
  static_assert(4 * (WIN + TMP + META) <= kSmem,
                "MC tile exceeds its shared memory");
};

template <int BLOCK, int TAPS>
__device__ __forceinline__ void mc_tile(const McGroup& gr, const int* filt,
                                        int tile, unsigned char* smem,
                                        int32_t* __restrict__ out) {
  using C = Geo<BLOCK, TAPS>;
  constexpr int SPAN = C::SPAN, G = C::G, WW = C::WW;
  constexpr int HALF = TAPS / 2 - 1;
  constexpr int UNIT = TAPS == 8 ? 2 : 3;   // quarter / eighth pel
  constexpr int FMASK = TAPS == 8 ? 3 : 7;

  uint32_t* win = reinterpret_cast<uint32_t*>(smem);   // [G][SPAN][WW]
  int* tmp = reinterpret_cast<int*>(win + C::WIN);     // [G][SPAN][BLOCK]
  int* oy = tmp + C::TMP;  // [G] window row
  int* ox4 = oy + G;       // [G] window column, rounded down to a word
  int* rs = ox4 + G;       // [G] clamped reference index
  int* in = rs + G;        // [G] lead = column - ox4 for a window inside
                           //     the picture, -1 - lead for one that is not
  int* fh = in + G;        // [G][TAPS]
  int* fv = fh + G * TAPS;

  const int tid = threadIdx.x;
  const int b0 = tile * G;
  const int nb = min(G, gr.n - b0);   // blocks of this tile
  const int H = gr.H, W = gr.W;
  const int64_t plane = static_cast<int64_t>(H) * W;

  // per-block window origin and taps; >> and & on negative MVs are the
  // arithmetic shift and two's-complement mask, as in the spec
  if (tid < nb) {
    const int b = b0 + tid;
    const int mx = gr.mv[2 * b], my = gr.mv[2 * b + 1];
    const int y = gr.pos[2 * b] + (my >> UNIT) - HALF;
    const int x = gr.pos[2 * b + 1] + (mx >> UNIT) - HALF;
    oy[tid] = y;
    ox4[tid] = x & ~3;
    rs[tid] = min(max(gr.ridx[b], 0), gr.R - 1);   // as the reference gathers
    const bool inside = gr.vec && y >= 0 && y + SPAN <= H && x >= 0 &&
                        x + SPAN <= W;
    in[tid] = inside ? (x & 3) : -1 - (x & 3);
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      fh[tid * TAPS + t] = filt[(mx & FMASK) * TAPS + t];
      fv[tid * TAPS + t] = filt[(my & FMASK) * TAPS + t];
    }
  }
  __syncthreads();

  // windows, one 32-bit word of a row per thread and step: aligned loads
  // inside the picture, clamped bytes where the window crosses the edge
  for (int e = tid; e < nb * SPAN * WW; e += kThreads) {
    const int g = e / (SPAN * WW), r = (e / WW) % SPAN, w = e % WW;
    const uint8_t* src = gr.refs + rs[g] * plane;
    const int x0 = ox4[g] + 4 * w;
    uint32_t v = 0;
    if (in[g] >= 0) {
      if (x0 + 4 <= W)   // a word past the row end is never read
        v = *reinterpret_cast<const uint32_t*>(
            src + static_cast<int64_t>(oy[g] + r) * W + x0);
    } else {
      const int y = min(max(oy[g] + r, 0), H - 1);
      const uint8_t* row = src + static_cast<int64_t>(y) * W;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v |= static_cast<uint32_t>(row[min(max(x0 + k, 0), W - 1)]) << (8 * k);
    }
    win[e] = v;
  }
  __syncthreads();

  // horizontal pass over all SPAN rows: tmp[r][c] = sum_t fH[t] w[r][c+t]
  for (int e = tid; e < nb * SPAN * BLOCK; e += kThreads) {
    const int g = e / (SPAN * BLOCK), r = (e / BLOCK) % SPAN, c = e % BLOCK;
    const int lead = in[g] >= 0 ? in[g] : -1 - in[g];
    const uint8_t* w = reinterpret_cast<const uint8_t*>(
        win + (g * SPAN + r) * WW) + lead + c;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) acc += fh[g * TAPS + t] * w[t];
    tmp[e] = acc >> (kBitDepth - 8);
  }
  __syncthreads();

  // vertical pass: out[r][c] = (sum_t fV[t] tmp[r+t][c]) >> 6, coalesced
  int32_t* o = out + gr.out + static_cast<int64_t>(b0) * BLOCK * BLOCK;
  for (int e = tid; e < nb * BLOCK * BLOCK; e += kThreads) {
    const int g = e / (BLOCK * BLOCK), r = (e / BLOCK) % BLOCK, c = e % BLOCK;
    const int* tp = tmp + g * SPAN * BLOCK + r * BLOCK + c;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) acc += fv[g * TAPS + t] * tp[t * BLOCK];
    o[e] = acc >> 6;
  }
}

__global__ void __launch_bounds__(kThreads)
mc_grouped_kernel(const __grid_constant__ McParams p,
                  int32_t* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem[kSmem];
  // the group of this CTA: the last one that starts at or before it (an
  // empty group starts where the next one does)
  int gi = 0;
  for (int i = 1; i < p.n_groups; ++i)
    if (static_cast<int>(blockIdx.x) >= p.g[i].first_tile) gi = i;
  const McGroup& gr = p.g[gi];
  const int tile = static_cast<int>(blockIdx.x) - gr.first_tile;
  switch (gr.block * 16 + gr.taps) {   // uniform across the CTA
    case 16 * 16 + 8: mc_tile<16, 8>(gr, p.luma, tile, smem, out); break;
    case 8 * 16 + 8: mc_tile<8, 8>(gr, p.luma, tile, smem, out); break;
    case 4 * 16 + 8: mc_tile<4, 8>(gr, p.luma, tile, smem, out); break;
    case 8 * 16 + 4: mc_tile<8, 4>(gr, p.chroma, tile, smem, out); break;
    case 4 * 16 + 4: mc_tile<4, 4>(gr, p.chroma, tile, smem, out); break;
    case 2 * 16 + 4: mc_tile<2, 4>(gr, p.chroma, tile, smem, out); break;
    default: break;
  }
}

}  // namespace

// table: n_groups rows of kTableCols int64 (host memory):
//   refs, pos, mv, ridx (device pointers), out offset, R, H, W, n, block,
//   taps, vec.  luma [4*8] and chroma [8*4] are host int32 filter tables.
extern "C" int p265_mc_grouped(const int64_t* table, int n_groups,
                               const int32_t* luma, const int32_t* chroma,
                               int32_t* out, cudaStream_t stream) {
  if (n_groups <= 0 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  McParams p{};
  p.n_groups = n_groups;
  for (int i = 0; i < 32; ++i) {
    p.luma[i] = luma[i];
    p.chroma[i] = chroma[i];
  }
  int tiles = 0;
  for (int i = 0; i < n_groups; ++i) {
    const int64_t* t = table + static_cast<int64_t>(i) * kTableCols;
    McGroup& g = p.g[i];
    g.refs = reinterpret_cast<const uint8_t*>(t[0]);
    g.pos = reinterpret_cast<const int32_t*>(t[1]);
    g.mv = reinterpret_cast<const int32_t*>(t[2]);
    g.ridx = reinterpret_cast<const int32_t*>(t[3]);
    g.out = t[4];
    g.R = static_cast<int>(t[5]);
    g.H = static_cast<int>(t[6]);
    g.W = static_cast<int>(t[7]);
    g.n = static_cast<int>(t[8]);
    g.block = static_cast<int>(t[9]);
    g.taps = static_cast<int>(t[10]);
    g.vec = static_cast<int>(t[11]);
    const int key = g.block * 16 + g.taps;
    const bool geometry_ok = key == 16 * 16 + 8 || key == 8 * 16 + 8 ||
                             key == 4 * 16 + 8 || key == 8 * 16 + 4 ||
                             key == 4 * 16 + 4 || key == 2 * 16 + 4;
    if (!geometry_ok || g.R <= 0 || g.H <= 0 || g.W <= 0 || g.n < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    g.first_tile = tiles;
    const int G = tile_blocks(g.block);
    tiles += (g.n + G - 1) / G;
  }
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  mc_grouped_kernel<<<tiles, kThreads, 0, stream>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
