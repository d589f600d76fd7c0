// Motion-compensated interpolation (HEVC 8.5.3.3.3): for each MC block,
// the (block+taps-1)^2 reference window, the separable 8-tap (luma) or
// 4-tap (chroma) int32 filter, >> 6 -- the 14-bit intermediates that
// p265_tpu_torch/kernels/mc.py combine() turns into samples.  Bit-exact
// with mc.py mc_blocks_ref and p265_tpu/kernels/mc.py _mc_blocks.
//
// Replaces p265_tpu/kernels/pallas_mc.py `_kernel` (mc_blocks_pallas).
// The TPU kernel DMA'd (8,128)-aligned covering tiles out of an edge-padded
// reference stack and rolled them to the window origin, and was exact only
// while every MV's overreach fit the pad (the mc_overreach gate).  Here
// each thread loads window samples itself with the row and column clamped
// to the picture -- the spec's edge rule -- so there is no pad, no tile,
// no roll and no gate, and any MV is exact.
//
// What bounds it on Hopper: window bytes gathered from the uint8 reference
// (L2-resident at 1080p: a 3 MB luma slab) and the int32 output written.
// The filter is ~2*taps multiply-adds per output sample.  One 256-thread
// block handles 256/(block*block) MC blocks (1 at 16x16, 64 at 2x2), keeps
// windows and the horizontal pass in shared memory, and writes outputs
// contiguously.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBitDepth = 8;

template <int BLOCK, int TAPS>
__global__ void __launch_bounds__(kThreads)
mc_blocks_kernel(const uint8_t* __restrict__ refs, int R, int H, int W,
                 const int32_t* __restrict__ pos,   // [n,2] (y, x)
                 const int32_t* __restrict__ mv,    // [n,2] (mvx, mvy)
                 const int32_t* __restrict__ ridx,  // [n]
                 const int32_t* __restrict__ filt,  // [frac, TAPS]
                 int32_t* __restrict__ out, int n) {
  constexpr int SPAN = BLOCK + TAPS - 1;
  constexpr int G = BLOCK * BLOCK >= kThreads ? 1
                                              : kThreads / (BLOCK * BLOCK);
  constexpr int HALF = TAPS / 2 - 1;
  constexpr int UNIT = TAPS == 8 ? 2 : 3;   // quarter / eighth pel
  constexpr int FMASK = TAPS == 8 ? 3 : 7;

  __shared__ int win[G * SPAN * SPAN];
  __shared__ int tmp[G * SPAN * BLOCK];
  __shared__ int fh[G * TAPS], fv[G * TAPS];
  __shared__ int oy[G], ox[G], rs[G];

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * G;
  const int64_t plane = static_cast<int64_t>(H) * W;

  // per-block window origin and taps; >> and & on negative MVs are the
  // arithmetic shift and two's-complement mask, as in the spec
  for (int g = tid; g < G; g += kThreads) {
    const int b = b0 + g;
    if (b < n) {
      const int mx = mv[2 * b], my = mv[2 * b + 1];
      oy[g] = pos[2 * b] + (my >> UNIT) - HALF;
      ox[g] = pos[2 * b + 1] + (mx >> UNIT) - HALF;
      rs[g] = min(max(ridx[b], 0), R - 1);   // clamped, as the reference gathers
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        fh[g * TAPS + t] = filt[(mx & FMASK) * TAPS + t];
        fv[g * TAPS + t] = filt[(my & FMASK) * TAPS + t];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < G * SPAN * SPAN; e += kThreads) {
    const int g = e / (SPAN * SPAN);
    if (b0 + g < n) {
      const int r = (e / SPAN) % SPAN, c = e % SPAN;
      const int y = min(max(oy[g] + r, 0), H - 1);
      const int x = min(max(ox[g] + c, 0), W - 1);
      win[e] = refs[rs[g] * plane + static_cast<int64_t>(y) * W + x];
    }
  }
  __syncthreads();

  // horizontal pass over all SPAN rows: tmp[r][c] = sum_t fH[t] w[r][c+t]
  for (int e = tid; e < G * SPAN * BLOCK; e += kThreads) {
    const int g = e / (SPAN * BLOCK);
    if (b0 + g < n) {
      const int r = (e / BLOCK) % SPAN, c = e % BLOCK;
      const int* w = win + g * SPAN * SPAN + r * SPAN + c;
      int acc = 0;
#pragma unroll
      for (int t = 0; t < TAPS; ++t) acc += fh[g * TAPS + t] * w[t];
      tmp[e] = acc >> (kBitDepth - 8);
    }
  }
  __syncthreads();

  // vertical pass: out[r][c] = (sum_t fV[t] tmp[r+t][c]) >> 6
  for (int e = tid; e < G * BLOCK * BLOCK; e += kThreads) {
    const int g = e / (BLOCK * BLOCK);
    const int b = b0 + g;
    if (b < n) {
      const int r = (e / BLOCK) % BLOCK, c = e % BLOCK;
      const int* tp = tmp + g * SPAN * BLOCK + r * BLOCK + c;
      int acc = 0;
#pragma unroll
      for (int t = 0; t < TAPS; ++t) acc += fv[g * TAPS + t] * tp[t * BLOCK];
      out[static_cast<int64_t>(b) * BLOCK * BLOCK + r * BLOCK + c] = acc >> 6;
    }
  }
}

template <int BLOCK, int TAPS>
void launch(const uint8_t* refs, int R, int H, int W, const int32_t* pos,
            const int32_t* mv, const int32_t* ridx, const int32_t* filt,
            int32_t* out, int n, cudaStream_t stream) {
  constexpr int G = BLOCK * BLOCK >= kThreads ? 1
                                              : kThreads / (BLOCK * BLOCK);
  const int grid = (n + G - 1) / G;
  mc_blocks_kernel<BLOCK, TAPS><<<grid, kThreads, 0, stream>>>(
      refs, R, H, W, pos, mv, ridx, filt, out, n);
}

}  // namespace

extern "C" int p265_mc_blocks(const uint8_t* refs, int R, int H, int W,
                              const int32_t* pos, const int32_t* mv,
                              const int32_t* ridx, const int32_t* filt,
                              int32_t* out, int n, int block, int taps,
                              cudaStream_t stream) {
  if (n <= 0 || R <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int key = block * 16 + taps;
  switch (key) {
    case 16 * 16 + 8: launch<16, 8>(refs, R, H, W, pos, mv, ridx, filt, out, n,
                                    stream); break;
    case 8 * 16 + 8: launch<8, 8>(refs, R, H, W, pos, mv, ridx, filt, out, n,
                                  stream); break;
    case 4 * 16 + 8: launch<4, 8>(refs, R, H, W, pos, mv, ridx, filt, out, n,
                                  stream); break;
    case 8 * 16 + 4: launch<8, 4>(refs, R, H, W, pos, mv, ridx, filt, out, n,
                                  stream); break;
    case 4 * 16 + 4: launch<4, 4>(refs, R, H, W, pos, mv, ridx, filt, out, n,
                                  stream); break;
    case 2 * 16 + 4: launch<2, 4>(refs, R, H, W, pos, mv, ridx, filt, out, n,
                                  stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
