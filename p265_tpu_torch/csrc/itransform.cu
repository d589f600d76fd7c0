// Fused dequant + inverse transform (HEVC 8.6.2-8.6.4) for a batch of
// same-size TUs, bit-exact with p265_tpu_torch/kernels/itransform.py
// batch_residual_ref.
//
// Replaces p265_tpu/kernels/pallas_itransform.py `_kernel`
// (pallas_batch_residual), and also covers what that kernel left to XLA:
// 4x4 TUs with the DST and transform skip, and scaling lists (scale_m).
//
// What bounds it on Hopper: bytes.  Each TU reads s*s int32 levels (plus
// s*s scale_m entries) and writes s*s int32 residuals; the two s-deep
// integer products per sample are a few hundred int32 multiply-adds per TU
// on the CUDA cores.  So the design keeps the dequantized block and the
// stage-1 intermediate in shared memory (no device-memory round trip
// between the stages, the point of the Pallas kernel too) and uses plain
// int32 multiply-adds: the MXU's 8-bit-limb bf16 trick has no purpose here.
// One 256-thread block handles one TU at s >= 16 and 256/(s*s) TUs at
// s <= 8, so every thread has work at every size.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBitDepth = 8;

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

// Spec dequant ((c * m * ls << qp/6) + (1 << (bd - 1))) >> bd, staged in
// int32 exactly as p265_tpu/kernels/itransform.py _dequant does: a rounded
// right shift by bd - qp/6, or a left shift by qp/6 - bd of the value
// clamped to +-2^27 (anything past 2^15 saturates anyway).
__device__ __forceinline__ int dequant(int level, int m, int qp, int bd,
                                       const int* ls) {
  const int e = qp / 6;
  const int x = level * m * ls[qp % 6];
  int d;
  if (e > bd) {
    const int xc = min(max(x, -(1 << 27)), 1 << 27);
    d = xc * (1 << (e - bd));
  } else {
    const int rnd = e < bd ? 1 << (bd - 1 - e) : 0;
    d = (x + rnd) >> (bd - e);
  }
  return clip16(d);
}

// consts: [s*s DCT matrix][16 DST matrix (4x4 only)][6 levelScale], int32.
template <int LOG2>
__global__ void __launch_bounds__(kThreads)
itransform_kernel(const int32_t* __restrict__ levels,
                  const int32_t* __restrict__ qp,
                  const uint8_t* __restrict__ is_dst,
                  const uint8_t* __restrict__ tskip,
                  const uint8_t* __restrict__ bypass,
                  const int32_t* __restrict__ scale_m,
                  const int32_t* __restrict__ consts,
                  int32_t* __restrict__ out, int n) {
  constexpr int S = 1 << LOG2;
  constexpr int SS = S * S;
  constexpr int TPB = SS >= kThreads ? 1 : kThreads / SS;  // TUs per block
  constexpr int E = TPB * SS;                              // samples
  constexpr int BD = kBitDepth + LOG2 - 5;
  constexpr int SHIFT2 = 20 - kBitDepth;

  __shared__ int mat[SS];
  __shared__ int dst[16];
  __shared__ int ls[6];
  __shared__ int d[E];   // dequantized levels
  __shared__ int t[E];   // stage-1 output

  const int tid = threadIdx.x;
  const int tu0 = blockIdx.x * TPB;
  for (int i = tid; i < SS; i += kThreads) mat[i] = consts[i];
  if (tid < 16) dst[tid] = consts[SS + tid];
  if (tid < 6) ls[tid] = consts[SS + 16 + tid];
  __syncthreads();

  for (int e = tid; e < E; e += kThreads) {
    const int tu = tu0 + e / SS;
    if (tu < n) {
      const int64_t g = static_cast<int64_t>(tu) * SS + e % SS;
      const int m = scale_m ? scale_m[g] : 16;
      d[e] = dequant(levels[g], m, qp[tu], BD, ls);
    }
  }
  __syncthreads();

  // stage 1: t = clip((M^T d + 64) >> 7), t[i][j] = sum_k M[k][i] d[k][j]
  for (int e = tid; e < E; e += kThreads) {
    const int u = e / SS, tu = tu0 + u;
    if (tu < n) {
      const int i = (e % SS) / S, j = e % S;
      const int* m = (LOG2 == 2 && is_dst[tu]) ? dst : mat;
      const int* db = d + u * SS;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) acc += m[k * S + i] * db[k * S + j];
      t[e] = clip16((acc + 64) >> 7);
    }
  }
  __syncthreads();

  // stage 2: r = clip((t M + 2048) >> 12), r[i][j] = sum_k t[i][k] M[k][j]
  for (int e = tid; e < E; e += kThreads) {
    const int u = e / SS, tu = tu0 + u;
    if (tu >= n) continue;
    const int i = (e % SS) / S, j = e % S;
    const int64_t g = static_cast<int64_t>(tu) * SS + e % SS;
    const int* m = (LOG2 == 2 && is_dst[tu]) ? dst : mat;
    const int* tb = t + u * SS + i * S;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) acc += tb[k] * m[k * S + j];
    int r = clip16((acc + (1 << (SHIFT2 - 1))) >> SHIFT2);
    if (LOG2 == 2 && tskip[tu]) {
      // transform skip always dequantizes flat (scale 16)
      const int df = scale_m ? dequant(levels[g], 16, qp[tu], BD, ls) : d[e];
      r = clip16((df * 128 + (1 << (SHIFT2 - 1))) >> SHIFT2);
    }
    if (bypass && bypass[tu]) r = levels[g];
    out[g] = r;
  }
}

template <int LOG2>
void launch(const int32_t* levels, const int32_t* qp, const uint8_t* is_dst,
            const uint8_t* tskip, const uint8_t* bypass,
            const int32_t* scale_m, const int32_t* consts, int32_t* out,
            int n, cudaStream_t stream) {
  constexpr int SS = 1 << (2 * LOG2);
  constexpr int TPB = SS >= kThreads ? 1 : kThreads / SS;
  const int grid = (n + TPB - 1) / TPB;
  itransform_kernel<LOG2><<<grid, kThreads, 0, stream>>>(
      levels, qp, is_dst, tskip, bypass, scale_m, consts, out, n);
}

}  // namespace

extern "C" int p265_itransform(const int32_t* levels, const int32_t* qp,
                               const uint8_t* is_dst, const uint8_t* tskip,
                               const uint8_t* bypass, const int32_t* scale_m,
                               const int32_t* consts, int32_t* out, int n,
                               int log2, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (log2) {
    case 2: launch<2>(levels, qp, is_dst, tskip, bypass, scale_m, consts,
                      out, n, stream); break;
    case 3: launch<3>(levels, qp, is_dst, tskip, bypass, scale_m, consts,
                      out, n, stream); break;
    case 4: launch<4>(levels, qp, is_dst, tskip, bypass, scale_m, consts,
                      out, n, stream); break;
    case 5: launch<5>(levels, qp, is_dst, tskip, bypass, scale_m, consts,
                      out, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
