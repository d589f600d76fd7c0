// Fused dequant + inverse transform (HEVC 8.6.2-8.6.4) of the TUs of all
// four sizes of one call site in ONE launch, bit-exact with
// p265_tpu_torch/kernels/itransform.py batch_residual_ref.
//
// Replaces p265_tpu/kernels/pallas_itransform.py `_kernel`
// (pallas_batch_residual), and also covers what that kernel left to XLA:
// 4x4 TUs with the DST and transform skip, and scaling lists (scale_m).
//
// What bounds it on Hopper: the int32 lanes and the bytes, about equally.
// A 1-D inverse transform of
// length s costs s/2 multiply-adds an output in the even/odd (partial
// butterfly) form used here: output i and s-1-i of a column (or row) share
// the even-row and odd-row partial sums, because DCT row k is symmetric for
// even k and antisymmetric for odd k (the same integer sum as the direct
// product, regrouped; the 4x4 DST has no such symmetry and keeps the direct
// product).  That is ~266 M multiply-adds a 1080p pass, ~16 us on 132 SMs x
// 64 int32 lanes, against ~50 MB of levels in and residuals out (~15 us at
// 3.35 TB/s).  The version before this one read two shared-memory operands
// for every multiply-add (the DCT entry and the sample: a warp's shared load
// is one wavefront a clock, so it ran at a quarter of the lanes), copied its
// size's whole DCT from global memory into every CTA, and ran each CTA
// through one 1024-sample tile with nothing in flight across its barriers.
// So this version:
// - takes a table of groups (one per TU size) as a kernel parameter; each
//   CTA walks a run of consecutive 1024-sample tiles of one size (1 TU of
//   32x32, 4 of 16x16, 16 of 8x8, 64 of 4x4), so the grid is one wave of
//   as many CTAs as the SMs hold, however many TUs a call site has;
// - stages the next tile's int16 (or int32) levels and its scale_m with
//   16-byte cp.async into the other half of a double buffer while the
//   current tile computes, and the next tile's qp and flags into registers;
// - blocks both stages in registers: a thread owns the output pair (p,
//   s-1-p) of 4 adjacent columns in stage 1 and of 4 adjacent rows in stage
//   2, and keeps that pair's DCT column in registers, read once a CTA from
//   the wrapper's table (the kernel holds no copy of the spec's tables);
//   each 16-byte shared load of 4 dequantized (or stage-1) values then
//   feeds 4 multiply-adds, and the threads of a warp that work on the same
//   4 columns (rows) read the same 16 bytes, one broadcast;
// - keeps the dequantized block, the stage-1 output and the residual in
//   shared memory (rows padded to s+4 ints: 16-byte aligned, and the
//   stage-1 stores of a warp's 8 rows fall on distinct banks) and reads
//   levels and writes residuals 16 bytes a thread, coalesced;
// - dequantizes each sample once (transform skip on the flat matrix) and
//   finishes transform-skip and bypass TUs in that pass;
// - reads the reference's wire dtypes as they were staged: qp and scale_m
//   uint8 (a 4x4 TU's scale_m is 16 bytes, so a tile's scale_m still goes
//   by 16-byte cp.async from a leaf on 64 bytes), levels int16 (int32 for
//   the callers that pass it), TU positions uint16 or int32;
// - has two epilogues: the residuals into an int32 buffer (the scan's
//   TUs), or, for the hoisted inter TUs, in place into the tall plane that
//   holds their prediction: plane[y][x] = clip(plane[y][x] + residual, 0,
//   255) at each TU's position, 16 bytes a thread where the row is aligned
//   (the counterpart of the reference's flat scatter and clip,
//   p265_tpu/pipeline/batch_decode.py:397-431).
// The tensor cores are not used: their integer path takes int8 operands,
// so the 16-bit dequantized levels would need a split into limbs (the
// reference's _limb_matmul) with int32 recombination, and the int32 lanes
// do not set this kernel's pace (its device time is several times its
// operation bound; PERF.md).
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;   // samples a tile
constexpr int kTileTus = 64;  // TUs of a tile of 4x4 TUs, the most
constexpr int kBitDepth = 8;
constexpr int kShift2 = 20 - kBitDepth;
constexpr int kMaxGroups = 4;
constexpr int kTableCols = 11;
// consts: [DCT 4x4][DCT 8x8][DCT 16x16][DCT 32x32][DST 4x4][levelScale 6]
constexpr int kDstOff = 16 + 64 + 256 + 1024;
constexpr int kLsOff = kDstOff + 16;
// TU flags in shared memory
constexpr int kDst = 1, kTskip = 2, kBypass = 4;

struct ItGroup {
  const void* levels;       // [n,s,s] int16 or int32, 16-byte aligned
  const uint8_t* qp;        // [n]
  const uint8_t* is_dst;    // [n] bool, or null: no DST
  const uint8_t* tskip;     // [n] bool
  const uint8_t* bypass;    // [n] bool, or null
  const uint8_t* scale_m;   // [n,s,s], 16-byte aligned, or null: flat 16
  const void* pos;          // [n,2] (row, col) uint16 or int32; plane only
  int64_t out;              // element offset of the group's [n,s,s] output
  int n, log2, wide;        // wide: levels are int32
  int first_cta;            // first CTA of the group
};

struct ItParams {
  ItGroup g[kMaxGroups];
  int n_groups, tiles_per_cta;
  const int32_t* consts;
  int32_t* out;             // the residuals, or null: the plane epilogue
  int32_t* plane;           // [rows, pitch], updated in place, or null
  int64_t pitch;
  int pos_wide;             // positions are int32 (else uint16)
  int vec;                  // plane rows take 16-byte accesses
};

template <int LOG2>
struct Geo {
  static constexpr int S = 1 << LOG2;
  static constexpr int SS = S * S;
  static constexpr int TPB = kTile / SS;      // TUs a tile
  static constexpr int P = S == 4 ? 4 : S + 4;   // row pitch, ints
  static constexpr int BLK = S * P;           // ints a TU
  static constexpr int H2 = S / 2, Q = S / 4;
};
// the largest block of a tile: 16 TUs of 8 rows of 12 ints
constexpr int kBlockInts = 1536;
static_assert(Geo<2>::TPB * Geo<2>::BLK <= kBlockInts &&
                  Geo<3>::TPB * Geo<3>::BLK <= kBlockInts &&
                  Geo<4>::TPB * Geo<4>::BLK <= kBlockInts &&
                  Geo<5>::TPB * Geo<5>::BLK <= kBlockInts,
              "itransform tile exceeds its shared block");

struct ItSmem {
  int4 lv[2][kTile / 4];    // staged levels (int16 pairs or int32)
  int4 sm[2][kTile / 16];   // staged scale_m (uint8)
  int4 d[kBlockInts / 4];   // dequantized block, then the residual
  int4 t[kBlockInts / 4];   // stage-1 output
  int qp[2][kTileTus], fl[2][kTileTus];
  int py[2][kTileTus], px[2][kTileTus];   // TU positions (plane epilogue)
  int ls[8];                // levelScale
};

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__host__ __device__ constexpr int dct_off(int log2) {
  return log2 == 2 ? 0 : log2 == 3 ? 16 : log2 == 4 ? 80 : 336;
}

// the levels (and scale_m) of tile `tile` into half h, by cp.async
template <int LOG2>
__device__ __forceinline__ void stage_tile(const ItGroup& g, int tile, int h,
                                           ItSmem& sm) {
  using C = Geo<LOG2>;
  const int tu0 = tile * C::TPB, nt = min(C::TPB, g.n - tu0);
  const int64_t e0 = static_cast<int64_t>(tu0) * C::SS;
  const int esz = g.wide ? 4 : 2;
  const char* lv = static_cast<const char*>(g.levels) + e0 * esz;
  for (int c = threadIdx.x; c < nt * C::SS * esz / 16; c += kThreads)
    cp_async16(&sm.lv[h][c], lv + 16 * c);
  if (g.scale_m) {   // a 4x4 TU's matrix is 16 bytes: whole chunks
    const uint8_t* sc = g.scale_m + e0;
    for (int c = threadIdx.x; c < nt * C::SS / 16; c += kThreads)
      cp_async16(&sm.sm[h][c], sc + 16 * c);
  }
}

// qp, flags and (with a plane) position of TU threadIdx.x of tile `tile`
// (loads left in flight).  A uint16 coordinate is read as uint16_t:
// columns and rows of 32768 and more stay positive.
template <int LOG2>
__device__ __forceinline__ void tile_records(const ItParams& p,
                                             const ItGroup& g, int tile,
                                             int& qp, int& fl, int& py,
                                             int& px) {
  using C = Geo<LOG2>;
  const int u = tile * C::TPB + static_cast<int>(threadIdx.x);
  if (static_cast<int>(threadIdx.x) < C::TPB && u < g.n) {
    qp = g.qp[u];
    fl = (LOG2 == 2 && g.is_dst && g.is_dst[u] ? kDst : 0) |
         (LOG2 == 2 && g.tskip[u] ? kTskip : 0) |
         (g.bypass && g.bypass[u] ? kBypass : 0);
    if (p.plane) {
      if (p.pos_wide) {
        const int32_t* q = static_cast<const int32_t*>(g.pos) + 2 * u;
        py = q[0], px = q[1];
      } else {
        const uint16_t* q = static_cast<const uint16_t*>(g.pos) + 2 * u;
        py = q[0], px = q[1];
      }
    }
  }
}

template <int LOG2>
__device__ __forceinline__ void it_cta(const ItParams& prm, const ItGroup& g,
                                       int cta, ItSmem& sm) {
  using C = Geo<LOG2>;
  constexpr int S = C::S, SS = C::SS, TPB = C::TPB, P = C::P, BLK = C::BLK;
  constexpr int H2 = C::H2, Q = C::Q;
  constexpr int BD = kBitDepth + LOG2 - 5;
  constexpr int RND2 = 1 << (kShift2 - 1);
  const int tid = threadIdx.x;
  const int32_t* __restrict__ consts = prm.consts;
  const int per_cta = prm.tiles_per_cta;
  const int tiles = (g.n + TPB - 1) / TPB;
  const int t0 = cta * per_cta, t1 = min(t0 + per_cta, tiles);
  int* d = reinterpret_cast<int*>(sm.d);
  int* tb = reinterpret_cast<int*>(sm.t);
  if (tid < 6) sm.ls[tid] = consts[kLsOff + tid];

  // this thread's output pair (p, S-1-p) in both stages (kThreads is a
  // multiple of S/2) and its coefficients: M[k][p]; for 4x4 also
  // M[k][3-p] and the DST's columns p and 3-p
  const int p = tid % H2;
  int cf[S], cb[4], da[4], db[4];
#pragma unroll
  for (int k = 0; k < S; ++k) cf[k] = consts[dct_off(LOG2) + k * S + p];
  if (LOG2 == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cb[k] = consts[k * 4 + 3 - p];
      da[k] = consts[kDstOff + k * 4 + p];
      db[k] = consts[kDstOff + k * 4 + 3 - p];
    }
  }

  int nq = 0, nf = 0, ny = 0, nx = 0;   // the next tile's record of TU tid
  if (t0 < t1) {
    stage_tile<LOG2>(g, t0, 0, sm);
    tile_records<LOG2>(prm, g, t0, nq, nf, ny, nx);
    if (tid < TPB)
      sm.qp[0][tid] = nq, sm.fl[0][tid] = nf, sm.py[0][tid] = ny,
      sm.px[0][tid] = nx;
  }
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1, nxt = cur ^ 1;
    const bool more = t + 1 < t1;
    if (more) {
      stage_tile<LOG2>(g, t + 1, nxt, sm);
      tile_records<LOG2>(prm, g, t + 1, nq, nf, ny, nx);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile t's levels and records; the last copy-out done

    const int tu0 = t * TPB, nt = min(TPB, g.n - tu0);
    // dequant, 4 samples of a row a step; transform skip (always on the
    // flat dequant, even with a scaling list) and bypass (the levels are
    // the residual) are final here
    for (int e = tid; e < nt * SS / 4; e += kThreads) {
      const int u = e / (SS / 4), k4 = e % (SS / 4) * 4;
      int lvl[4], m[4] = {16, 16, 16, 16};
      if (g.wide) {
        const int4 v = sm.lv[cur][e];
        lvl[0] = v.x, lvl[1] = v.y, lvl[2] = v.z, lvl[3] = v.w;
      } else {
        const int16_t* v = reinterpret_cast<const int16_t*>(sm.lv[cur]) + 4 * e;
#pragma unroll
        for (int i = 0; i < 4; ++i) lvl[i] = v[i];
      }
      if (g.scale_m) {
        const uchar4 v = reinterpret_cast<const uchar4*>(sm.sm[cur])[e];
        m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
      }
      const int qp = sm.qp[cur][u], fl = sm.fl[cur][u];
      int r[4];
      if (fl & kBypass) {
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = lvl[i];
      } else {
        const bool ts = fl & kTskip;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = dequant(lvl[i], ts ? 16 : m[i], qp, BD, sm.ls);
          r[i] = ts ? clip16((d * 128 + RND2) >> kShift2) : d;
        }
      }
      *reinterpret_cast<int4*>(d + u * BLK + k4 / S * P + k4 % S) =
          make_int4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();

    // stage 1, columns: t[i][j] = clip((sum_k M[k][i] d[k][j] + 64) >> 7)
    // for i = p and S-1-p, j = 4q..4q+3
    for (int e = tid; e < nt * H2 * Q; e += kThreads) {
      const int q = e / H2 % Q, u = e / (H2 * Q);
      if (sm.fl[cur][u] & (kTskip | kBypass)) continue;
      const int* db0 = d + u * BLK + 4 * q;
      int o0[4] = {0, 0, 0, 0}, o1[4] = {0, 0, 0, 0};
      if (LOG2 == 2) {
        const bool dst = sm.fl[cur][u] & kDst;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int4 v = *reinterpret_cast<const int4*>(db0 + k * P);
          const int a = dst ? da[k] : cf[k], b = dst ? db[k] : cb[k];
          o0[0] += a * v.x, o0[1] += a * v.y, o0[2] += a * v.z, o0[3] += a * v.w;
          o1[0] += b * v.x, o1[1] += b * v.y, o1[2] += b * v.z, o1[3] += b * v.w;
        }
      } else {
        int ev[4] = {0, 0, 0, 0}, od[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const int4 v = *reinterpret_cast<const int4*>(db0 + k * P);
          if (k & 1) {
            od[0] += cf[k] * v.x, od[1] += cf[k] * v.y;
            od[2] += cf[k] * v.z, od[3] += cf[k] * v.w;
          } else {
            ev[0] += cf[k] * v.x, ev[1] += cf[k] * v.y;
            ev[2] += cf[k] * v.z, ev[3] += cf[k] * v.w;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) o0[c] = ev[c] + od[c], o1[c] = ev[c] - od[c];
      }
      int* r0 = tb + u * BLK + p * P + 4 * q;
      int* r1 = tb + u * BLK + (S - 1 - p) * P + 4 * q;
      *reinterpret_cast<int4*>(r0) =
          make_int4(clip16((o0[0] + 64) >> 7), clip16((o0[1] + 64) >> 7),
                    clip16((o0[2] + 64) >> 7), clip16((o0[3] + 64) >> 7));
      *reinterpret_cast<int4*>(r1) =
          make_int4(clip16((o1[0] + 64) >> 7), clip16((o1[1] + 64) >> 7),
                    clip16((o1[2] + 64) >> 7), clip16((o1[3] + 64) >> 7));
    }
    __syncthreads();

    // stage 2, rows: r[i][j] = clip((sum_k t[i][k] M[k][j] + 2048) >> 12)
    // for j = p and S-1-p, i = 4q..4q+3, into d
    for (int e = tid; e < nt * H2 * Q; e += kThreads) {
      const int q = e / H2 % Q, u = e / (H2 * Q);
      if (sm.fl[cur][u] & (kTskip | kBypass)) continue;
      const int* tr = tb + u * BLK + 4 * q * P;
      int o0[4] = {0, 0, 0, 0}, o1[4] = {0, 0, 0, 0};
      if (LOG2 == 2) {
        const bool dst = sm.fl[cur][u] & kDst;
        int a[4], b[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          a[k] = dst ? da[k] : cf[k], b[k] = dst ? db[k] : cb[k];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int4 v = *reinterpret_cast<const int4*>(tr + c * P);
          o0[c] = v.x * a[0] + v.y * a[1] + v.z * a[2] + v.w * a[3];
          o1[c] = v.x * b[0] + v.y * b[1] + v.z * b[2] + v.w * b[3];
        }
      } else {
        int ev[4] = {0, 0, 0, 0}, od[4] = {0, 0, 0, 0};
#pragma unroll
        for (int m4 = 0; m4 < Q; ++m4) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int4 v = *reinterpret_cast<const int4*>(tr + c * P + 4 * m4);
            ev[c] += v.x * cf[4 * m4] + v.z * cf[4 * m4 + 2];
            od[c] += v.y * cf[4 * m4 + 1] + v.w * cf[4 * m4 + 3];
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) o0[c] = ev[c] + od[c], o1[c] = ev[c] - od[c];
      }
      int* rb = d + u * BLK + 4 * q * P;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rb[c * P + p] = clip16((o0[c] + RND2) >> kShift2);
        rb[c * P + S - 1 - p] = clip16((o1[c] + RND2) >> kShift2);
      }
    }
    __syncthreads();

    if (prm.plane) {
      // the plane epilogue: 4 samples of a TU row a thread, added to the
      // prediction the plane holds and clipped, in place
      for (int e = tid; e < nt * SS / 4; e += kThreads) {
        const int u = e / (SS / 4), k4 = e % (SS / 4) * 4;
        const int4 r =
            *reinterpret_cast<const int4*>(d + u * BLK + k4 / S * P + k4 % S);
        const int x = sm.px[cur][u] + k4 % S;
        int32_t* dst = prm.plane +
                       static_cast<int64_t>(sm.py[cur][u] + k4 / S) *
                           prm.pitch + x;
        if (prm.vec && (x & 3) == 0) {
          const int4 v = *reinterpret_cast<const int4*>(dst);
          *reinterpret_cast<int4*>(dst) = make_int4(
              min(max(v.x + r.x, 0), 255), min(max(v.y + r.y, 0), 255),
              min(max(v.z + r.z, 0), 255), min(max(v.w + r.w, 0), 255));
        } else {
          dst[0] = min(max(dst[0] + r.x, 0), 255);
          dst[1] = min(max(dst[1] + r.y, 0), 255);
          dst[2] = min(max(dst[2] + r.z, 0), 255);
          dst[3] = min(max(dst[3] + r.w, 0), 255);
        }
      }
    } else {
      // the residuals out, 16 bytes a thread
      int32_t* o = prm.out + g.out + static_cast<int64_t>(tu0) * SS;
      for (int e = tid; e < nt * SS / 4; e += kThreads) {
        const int u = e / (SS / 4), k4 = e % (SS / 4) * 4;
        *reinterpret_cast<int4*>(o + 4 * e) =
            *reinterpret_cast<const int4*>(d + u * BLK + k4 / S * P + k4 % S);
      }
    }
    if (more && tid < TPB)
      sm.qp[nxt][tid] = nq, sm.fl[nxt][tid] = nf, sm.py[nxt][tid] = ny,
      sm.px[nxt][tid] = nx;
  }
}

__global__ void __launch_bounds__(kThreads)
itransform_grouped_kernel(const __grid_constant__ ItParams p) {
  __shared__ ItSmem sm;
  int gi = 0;   // the last group that starts at or before this CTA
  for (int i = 1; i < p.n_groups; ++i)
    if (static_cast<int>(blockIdx.x) >= p.g[i].first_cta) gi = i;
  const ItGroup& gr = p.g[gi];
  const int cta = static_cast<int>(blockIdx.x) - gr.first_cta;
  switch (gr.log2) {   // uniform across the CTA
    case 2: it_cta<2>(p, gr, cta, sm); break;
    case 3: it_cta<3>(p, gr, cta, sm); break;
    case 4: it_cta<4>(p, gr, cta, sm); break;
    case 5: it_cta<5>(p, gr, cta, sm); break;
    default: break;
  }
}

}  // namespace

// CTAs of `kernel` that the current device holds at once (common.cu)
cudaError_t p265_resident_ctas(const void* kernel, int threads, int smem,
                               int* slots);

// table: n_groups rows of kTableCols int64 (host memory):
//   levels, qp, is_dst|0, tskip, bypass|0, scale_m|0 (device pointers;
//   levels and scale_m 16-byte aligned; qp and scale_m uint8), out offset,
//   n, log2, wide, pos|0 ([n,2] uint16, or int32 with pos_wide).
//   consts: the device tables laid out as above.  out: the residuals
//   (every group at its out offset); or, with plane non-null, out is
//   unused and each TU's residual is added to plane [rows, pitch] int32 at
//   its position and clipped to 0..255, in place (every group needs pos).
extern "C" int p265_itransform_grouped(const int64_t* table, int n_groups,
                                       const int32_t* consts, int32_t* out,
                                       int32_t* plane, int64_t pitch,
                                       int pos_wide, cudaStream_t stream) {
  if (n_groups <= 0 || n_groups > kMaxGroups || (!plane && !out) ||
      (plane && pitch <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  ItParams p{};
  p.n_groups = n_groups;
  p.consts = consts;
  p.out = plane ? nullptr : out;
  p.plane = plane;
  p.pitch = pitch;
  p.pos_wide = pos_wide;
  p.vec = plane && pitch % 4 == 0 &&
          reinterpret_cast<uintptr_t>(plane) % 16 == 0;
  int tiles[kMaxGroups], total = 0;
  for (int i = 0; i < n_groups; ++i) {
    const int64_t* t = table + static_cast<int64_t>(i) * kTableCols;
    ItGroup& g = p.g[i];
    g.levels = reinterpret_cast<const void*>(t[0]);
    g.qp = reinterpret_cast<const uint8_t*>(t[1]);
    g.is_dst = reinterpret_cast<const uint8_t*>(t[2]);
    g.tskip = reinterpret_cast<const uint8_t*>(t[3]);
    g.bypass = reinterpret_cast<const uint8_t*>(t[4]);
    g.scale_m = reinterpret_cast<const uint8_t*>(t[5]);
    g.out = t[6];
    g.n = static_cast<int>(t[7]);
    g.log2 = static_cast<int>(t[8]);
    g.wide = static_cast<int>(t[9]);
    g.pos = reinterpret_cast<const void*>(t[10]);
    if (g.log2 < 2 || g.log2 > 5 || g.n < 0 || t[0] % 16 != 0 ||
        t[5] % 16 != 0 || (plane && !g.pos))
      return static_cast<int>(cudaErrorInvalidValue);
    const int tpb = kTile >> (2 * g.log2);
    tiles[i] = (g.n + tpb - 1) / tpb;
    total += tiles[i];
  }
  if (total == 0) return static_cast<int>(cudaErrorInvalidValue);
  // enough tiles a CTA that the grid is one wave of as many CTAs as the
  // SMs hold at once: a CTA's later tiles load while its earlier ones
  // compute, and no partial second wave trails the first
  int slots = 0;
  cudaError_t e = p265_resident_ctas(
      reinterpret_cast<const void*>(itransform_grouped_kernel), kThreads, 0,
      &slots);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.tiles_per_cta = std::max(1, (total + slots - 1) / slots);
  int ctas = 0;
  for (int i = 0; i < n_groups; ++i) {
    p.g[i].first_cta = ctas;
    ctas += (tiles[i] + p.tiles_per_cta - 1) / p.tiles_per_cta;
  }
  itransform_grouped_kernel<<<ctas, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
