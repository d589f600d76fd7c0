// Fused dequant + inverse transform (HEVC 8.6.2-8.6.4) of the TUs of all
// four sizes of one call site in ONE launch, bit-exact with
// p265_tpu_torch/kernels/itransform.py batch_residual_ref.
//
// Replaces p265_tpu/kernels/pallas_itransform.py `_kernel`
// (pallas_batch_residual), and also covers what that kernel left to XLA:
// 4x4 TUs with the DST and transform skip, and scaling lists (scale_m).
//
// What bounds it on Hopper: bytes.  Every sample reads a 2-byte int16
// level (plus 4 bytes of scale_m with a scaling list) and writes a 4-byte
// int32 residual: 12.4 M samples a 1080p pass, ~75 MB, ~22 us at
// 3.35 TB/s.  A 1-D inverse transform of length s costs s/2 int32
// multiply-adds per output in the even/odd (partial butterfly) form used
// here, half of the direct product: ~250 M a pass, ~15 us on the CUDA
// cores (132 SMs x 64 int32 lanes x 1.98 GHz), under the bytes.  The first
// version took 20-40 us per launch, launched once per TU size and call
// site (28 launches a pass), read int32 levels that a separate device op
// had widened, and spent s multiply-adds per output.  So this version:
// - takes a table of groups (one per TU size) as a kernel parameter and
//   gives each CTA a tile of 1024 samples of one size (1 TU of 32x32, 4 of
//   16x16, 16 of 8x8, 64 of 4x4), so all sizes of a call site share one
//   launch and every CTA has the same work;
// - reads the int16 levels as the host packs them (int32 is taken too);
// - loads the size's DCT, the DST and levelScale once per CTA into shared
//   memory, from the wrapper's tables (the kernel holds no copy of them);
// - computes both 1-D stages as even/odd pairs: output i and s-1-i of a
//   column (or row) share the even-row and odd-row partial sums, because
//   DCT row k is symmetric for even k and antisymmetric for odd k.  This
//   is the same integer sum as the direct product, regrouped.  The 4x4 DST
//   has no such symmetry and keeps the direct product.
// - keeps the dequantized block, the stage-1 output and the residual in
//   shared memory (rows padded to s+1 ints, so the row pass is free of
//   bank conflicts) and reads levels and writes residuals coalesced.
// The tensor cores are not used: their integer path takes int8 operands,
// and the dequantized levels (16 bits) and DCT entries (8 bits signed) would
// need a split into limbs with int32 recombination for a kernel whose
// bound is bytes, not operations.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;   // samples per CTA
constexpr int kBitDepth = 8;
constexpr int kShift2 = 20 - kBitDepth;
constexpr int kMaxGroups = 4;
constexpr int kTableCols = 10;
// consts: [DCT 4x4][DCT 8x8][DCT 16x16][DCT 32x32][DST 4x4][levelScale 6]
constexpr int kDstOff = 16 + 64 + 256 + 1024;
constexpr int kLsOff = kDstOff + 16;
constexpr int kSmemInts = 3200;

struct ItGroup {
  const void* levels;       // [n,s,s] int16 or int32
  const int32_t* qp;        // [n]
  const uint8_t* is_dst;    // [n] bool, or null: no DST
  const uint8_t* tskip;     // [n] bool
  const uint8_t* bypass;    // [n] bool, or null
  const int32_t* scale_m;   // [n,s,s], or null: flat 16
  int64_t out;              // element offset of the group's [n,s,s] output
  int n, log2, wide;        // wide: levels are int32
  int first_tile;           // first CTA of the group
};

struct ItParams {
  ItGroup g[kMaxGroups];
  int n_groups;
  const int32_t* consts;
};

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

__device__ __forceinline__ int load_level(const ItGroup& gr, int64_t i) {
  return gr.wide ? static_cast<const int32_t*>(gr.levels)[i]
                 : static_cast<const int16_t*>(gr.levels)[i];
}

__host__ __device__ constexpr int dct_off(int log2) {
  return log2 == 2 ? 0 : log2 == 3 ? 16 : log2 == 4 ? 80 : 336;
}

template <int LOG2>
struct Geo {
  static constexpr int S = 1 << LOG2;
  static constexpr int SS = S * S;
  static constexpr int P = S + 1;          // padded row
  static constexpr int TPB = kTile / SS;   // TUs per CTA
  static constexpr int INTS = SS + 16 + 8 + 2 * TPB + 2 * TPB * S * P;
  static_assert(INTS <= kSmemInts, "itransform tile exceeds shared memory");
};

template <int LOG2>
__device__ __forceinline__ void it_tile(const ItGroup& gr,
                                        const int32_t* __restrict__ consts,
                                        int tile, int* smem,
                                        int32_t* __restrict__ out) {
  using C = Geo<LOG2>;
  constexpr int S = C::S, SS = C::SS, P = C::P, TPB = C::TPB, H2 = S / 2;
  constexpr int BD = kBitDepth + LOG2 - 5;
  constexpr int RND2 = 1 << (kShift2 - 1);

  int* mat = smem;           // [S][S] DCT, mat[k*S + i] = M[k][i]
  int* dst = mat + SS;       // [4][4] DST
  int* ls = dst + 16;        // [6] levelScale (8 with padding)
  int* tq = ls + 8;          // [TPB] qp
  int* tf = tq + TPB;        // [TPB] flags: 1 DST, 2 tskip, 4 bypass
  int* d = tf + TPB;         // [TPB][S][P] dequantized, then the residual
  int* t = d + TPB * S * P;  // [TPB][S][P] stage-1 output

  const int tid = threadIdx.x;
  const int tu0 = tile * TPB;
  const int nt = min(TPB, gr.n - tu0);   // TUs of this tile
  const int64_t g0 = static_cast<int64_t>(tu0) * SS;

  constexpr int DCT = dct_off(LOG2);
  for (int i = tid; i < SS; i += kThreads) mat[i] = consts[DCT + i];
  if (tid < 16) dst[tid] = consts[kDstOff + tid];
  if (tid < 6) ls[tid] = consts[kLsOff + tid];
  if (tid < nt) {
    const int u = tu0 + tid;
    tq[tid] = gr.qp[u];
    tf[tid] = (LOG2 == 2 && gr.is_dst && gr.is_dst[u] ? 1 : 0) |
              (LOG2 == 2 && gr.tskip[u] ? 2 : 0) |
              (gr.bypass && gr.bypass[u] ? 4 : 0);
  }
  __syncthreads();

  for (int e = tid; e < nt * SS; e += kThreads) {
    const int u = e / SS, k = e % SS;
    const int m = gr.scale_m ? gr.scale_m[g0 + e] : 16;
    d[u * S * P + (k / S) * P + k % S] =
        dequant(load_level(gr, g0 + e), m, tq[u], BD, ls);
  }
  __syncthreads();

  // stage 1, columns: t[i][j] = clip((sum_k M[k][i] d[k][j] + 64) >> 7),
  // outputs i and S-1-i of column j from the even-k and odd-k sums
  for (int q = tid; q < nt * SS / 2; q += kThreads) {
    const int j = q % S, i = (q / S) % H2, u = q / (S * H2);
    const int* db = d + u * S * P + j;
    int o0, o1;
    if (LOG2 == 2 && (tf[u] & 1)) {
      o0 = o1 = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o0 += dst[k * 4 + i] * db[k * P];
        o1 += dst[k * 4 + 3 - i] * db[k * P];
      }
    } else {
      int ev = 0, od = 0;
#pragma unroll
      for (int k = 0; k < S; k += 2) {
        ev += mat[k * S + i] * db[k * P];
        od += mat[(k + 1) * S + i] * db[(k + 1) * P];
      }
      o0 = ev + od;
      o1 = ev - od;
    }
    int* tb = t + u * S * P + j;
    tb[i * P] = clip16((o0 + 64) >> 7);
    tb[(S - 1 - i) * P] = clip16((o1 + 64) >> 7);
  }
  __syncthreads();

  // stage 2, rows: r[i][j] = clip((sum_k t[i][k] M[k][j] + 2048) >> 12),
  // outputs j and S-1-j of row i, into d
  for (int q = tid; q < nt * SS / 2; q += kThreads) {
    const int j = q % H2, i = (q / H2) % S, u = q / (S * H2);
    const int* tb = t + u * S * P + i * P;
    int o0, o1;
    if (LOG2 == 2 && (tf[u] & 1)) {
      o0 = o1 = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o0 += tb[k] * dst[k * 4 + j];
        o1 += tb[k] * dst[k * 4 + 3 - j];
      }
    } else {
      int ev = 0, od = 0;
#pragma unroll
      for (int k = 0; k < S; k += 2) {
        ev += tb[k] * mat[k * S + j];
        od += tb[k + 1] * mat[(k + 1) * S + j];
      }
      o0 = ev + od;
      o1 = ev - od;
    }
    int* rb = d + u * S * P + i * P;
    rb[j] = clip16((o0 + RND2) >> kShift2);
    rb[S - 1 - j] = clip16((o1 + RND2) >> kShift2);
  }
  __syncthreads();

  // coalesced write; transform skip (always on the flat dequant, even with
  // a scaling list) and bypass (the levels are the residual) per TU
  int32_t* o = out + gr.out + g0;
  for (int e = tid; e < nt * SS; e += kThreads) {
    const int u = e / SS, k = e % SS;
    int r = d[u * S * P + (k / S) * P + k % S];
    if (tf[u] & 2) {
      const int df = dequant(load_level(gr, g0 + e), 16, tq[u], BD, ls);
      r = clip16((df * 128 + RND2) >> kShift2);
    }
    if (tf[u] & 4) r = load_level(gr, g0 + e);
    o[e] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
itransform_grouped_kernel(const __grid_constant__ ItParams p,
                          int32_t* __restrict__ out) {
  __shared__ int smem[kSmemInts];
  int gi = 0;   // the last group that starts at or before this CTA
  for (int i = 1; i < p.n_groups; ++i)
    if (static_cast<int>(blockIdx.x) >= p.g[i].first_tile) gi = i;
  const ItGroup& gr = p.g[gi];
  const int tile = static_cast<int>(blockIdx.x) - gr.first_tile;
  switch (gr.log2) {   // uniform across the CTA
    case 2: it_tile<2>(gr, p.consts, tile, smem, out); break;
    case 3: it_tile<3>(gr, p.consts, tile, smem, out); break;
    case 4: it_tile<4>(gr, p.consts, tile, smem, out); break;
    case 5: it_tile<5>(gr, p.consts, tile, smem, out); break;
    default: break;
  }
}

}  // namespace

// table: n_groups rows of kTableCols int64 (host memory):
//   levels, qp, is_dst|0, tskip, bypass|0, scale_m|0 (device pointers),
//   out offset, n, log2, wide.  consts: the device tables laid out as above.
extern "C" int p265_itransform_grouped(const int64_t* table, int n_groups,
                                       const int32_t* consts, int32_t* out,
                                       cudaStream_t stream) {
  if (n_groups <= 0 || n_groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  ItParams p{};
  p.n_groups = n_groups;
  p.consts = consts;
  int tiles = 0;
  for (int i = 0; i < n_groups; ++i) {
    const int64_t* t = table + static_cast<int64_t>(i) * kTableCols;
    ItGroup& g = p.g[i];
    g.levels = reinterpret_cast<const void*>(t[0]);
    g.qp = reinterpret_cast<const int32_t*>(t[1]);
    g.is_dst = reinterpret_cast<const uint8_t*>(t[2]);
    g.tskip = reinterpret_cast<const uint8_t*>(t[3]);
    g.bypass = reinterpret_cast<const uint8_t*>(t[4]);
    g.scale_m = reinterpret_cast<const int32_t*>(t[5]);
    g.out = t[6];
    g.n = static_cast<int>(t[7]);
    g.log2 = static_cast<int>(t[8]);
    g.wide = static_cast<int>(t[9]);
    if (g.log2 < 2 || g.log2 > 5 || g.n < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    g.first_tile = tiles;
    const int tpb = kTile >> (2 * g.log2);
    tiles += (g.n + tpb - 1) / tpb;
  }
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  itransform_grouped_kernel<<<tiles, kThreads, 0, stream>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
