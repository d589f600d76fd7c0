// The intra wavefront scan of one merged tall plane (HEVC 8.4.4.2), every
// step in ONE launch of one thread-block cluster, bit-exact with
// p265_tpu_torch/pipeline/wavefront.py scan_packed_ref.
//
// Replaces p265_tpu/pipeline/wavefront.py:455 `_scan_plane`, a `lax.scan`
// that XLA compiled into the per-picture device program (not a Pallas
// kernel): for each wavefront step, every intra TU of the step gathers its
// 2(2s+1) reference samples from the plane as it stood before the step
// (128 where a reference is unavailable), smooths them (luma: [1 2 1], and
// the strong bilinear filter at 32x32), predicts its s x s samples
// (planar, DC or one of the 33 angular modes, with the DC and mode 10/26
// edge filters below 32x32) and writes clip(pred + residual, 0, 255) back.
// Chroma TUs ride in the same buckets with their smoothing and edge flags
// off.
//
// What bounds it on Hopper: the chain of steps, not bytes or operations.
// A 1080p I picture has ~1,500 dependent steps of at most ~66 TUs each;
// its bytes (~60 MB) take ~20 us at 3.35 TB/s and its arithmetic less.
// Each step costs one barrier among the CTAs that run it plus the latency
// of one gather -> smooth -> predict -> store chain through L2.  So:
// - the barrier is sized to the step, not to the card: the launch is ONE
//   cluster of kCtas = 16 CTAs of kWarps = 16 warps (cudaLaunchKernelEx
//   with a cluster dimension; the hardware co-schedules a cluster), and a
//   step ends with the hardware cluster barrier
//   (barrier.cluster.arrive.release / wait.acquire).  Release/acquire at
//   cluster scope orders the plane's global stores; the plane is read with
//   ld.global.cg so no CTA reads a stale line from its SM's L1;
// - a warp runs one work item of at most 128 samples: a 4x4 TU (on 16
//   lanes) or an 8x8 TU, half a 16x16 TU or an eighth of a 32x32 TU (each
//   warp of a TU gathers and smooths the references itself, so no warp
//   waits for another; on an H100, 256 samples an item measured slower
//   than 128, and 64 tied with 128 at this shape), with __syncwarp
//   between its stages and a warp
//   reduction for the DC sum.  The block-wide syncs are gone, and a step
//   of up to kCtas x kWarps items runs every item on its own warp.  The
//   items of a step are enumerated larger buckets first and dealt
//   round-robin over the CTAs first, so the large TUs of a step land on
//   different SMs; a step wider than the warps loops;
// - only the gather waits for the barrier: the step starts of the launch's
//   range sit in shared memory, and each warp loads its next item's mode,
//   flags, position, reference coordinates, ref_ok and residual into
//   registers between its arrive and its wait, so those loads overlap the
//   barrier.
// - the bucket record is the reference's wire format as a dispatch stages
//   it (p265_tpu/pipeline/wavefront.py _stack_plane): reference rows and
//   columns and TU positions at one coordinate dtype a launch (uint16, or
//   int32 for planes of 65000 rows or columns and more; a uint16 is read
//   as uint16_t, so coordinates of 32768 and more stay positive), modes
//   uint8, flags as bytes.  The kernel is a template on the coordinate
//   type, one instantiation a launch; a warp keeps an item's raw rows and
//   columns in registers and forms each reference's flat index row * pw +
//   column, in 64 bits, after the barrier, where the gather needs it (a
//   multiply before the wait would hold the warp for the coordinates'
//   loads, which the barrier otherwise hides).
//   After the wait the chain is: gather from the plane, smooth, predict,
//   add, store.  (Loading two steps ahead, into a second set of registers,
//   measured no faster on an H100.)
// - every sample comes straight from the spec's integer formulas.  The
//   port's plain route (an A-table product per mode, kernels/intra.py) is
//   not carried over, but its index clamps are.
// barrier_only walks the same steps and barriers and loads or computes
// nothing else: the floor of the step chain, for measurement.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The launch shape: one cluster of kCtas CTAs of kWarps warps.  Every
// launch takes it; profile_scan.py rebuilds this file with other values
// (-DP265_SCAN_CTAS=.. -DP265_SCAN_WARPS=..) to time them.
#ifndef P265_SCAN_CTAS
#define P265_SCAN_CTAS 16
#endif
#ifndef P265_SCAN_WARPS
#define P265_SCAN_WARPS 16
#endif
constexpr int kCtas = P265_SCAN_CTAS;     // 1..16; above 8 non-portable
constexpr int kWarps = P265_SCAN_WARPS;   // 1..16
static_assert(kCtas >= 1 && kCtas <= 16 && kWarps >= 1 && kWarps <= 16,
              "launch shape");
constexpr int kMaxBuckets = 4;
constexpr int kTableCols = 10;
constexpr int kModes = 35;
constexpr int kMaxRefs = 4 * 32 + 2;   // left(0..2s) then top(0..2s)
constexpr int kMaxExt = 3 * 32 + 2;    // ref[-s..2s] and one zero slot
constexpr int kPart = 128;        // samples of one work item (a warp's)
constexpr int kRefSlots = (kMaxRefs + 31) / 32;   // references a lane holds
constexpr int kResSlots = kPart / 32;             // residuals a lane holds
constexpr int kMaxDevices = 64;

struct ScanBucket {
  const void* ref_ys;             // [n, 4s+2] reference rows (coordinate)
  const void* ref_xs;             // [n, 4s+2] reference columns
  const uint8_t* ref_ok;          // [n, 4s+2] bool
  const uint8_t* mode;            // [n]
  const uint8_t* filter_flag;     // [n] bool
  const uint8_t* strong_allowed;  // [n] bool
  const uint8_t* dc_edge;         // [n] bool
  const void* pos;                // [n, 2] (row, col) in the plane
  const int32_t* residual;        // [n, s, s]
  int log2;
  int parts;                      // work items a TU: s * s / kPart, or 1
};

struct ScanParams {
  ScanBucket b[kMaxBuckets];      // ascending log2
  int n_buckets;
  const int32_t* starts;  // [n_buckets, stride]: TUs of step k of bucket
                          // i are rows starts[i][k]..starts[i][k+1]-1
  int stride;             // n_steps + 1
  int k0, k1;
  int32_t* plane;         // [rows, pw], updated in place
  int pw;
  int barrier_only;
  int angle[kModes];      // intraPredAngle (0 for planar and DC)
  int inv_angle[kModes];  // invAngle for modes 11..25, else 0
};

// One work item's operands, held by its warp in registers: part q of a TU
// (its samples q * kPart .. q * kPart + kPart - 1; all of a small TU).
// Lane l holds references l, l + 32, ... and the item's residual samples
// l, l + 32, ...
struct TuOps {
  int log2;               // 0: the warp has no item
  int q;
  int mode;
  bool filt, strong_ok, edge;
  int py, px;
  int ys[kRefSlots], xs[kRefSlots];   // the references' rows and columns
  bool ok[kRefSlots];
  int res[kResSlots];
};

// The step starts of the launch's range in shared memory: bucket i, step k
// at sh[i * len + k - k0].  -> the work items of step kk.
__device__ __forceinline__ int step_items(const ScanParams& p, const int* sh,
                                          int len, int kk) {
  int t = 0;
#pragma unroll
  for (int i = 0; i < kMaxBuckets; ++i)
    if (i < p.n_buckets)
      t += (sh[i * len + kk + 1] - sh[i * len + kk]) * p.b[i].parts;
  return t;
}

__device__ __forceinline__ int next_live(const ScanParams& p, const int* sh,
                                         int len, int kk, int n) {
  while (kk < n && step_items(p, sh, len, kk) == 0) ++kk;
  return kk;
}

// Coordinate i of an array of C (uint16_t or int32_t; read-only path).
template <typename C>
__device__ __forceinline__ int coord(const void* a, int64_t i) {
  return static_cast<int>(__ldg(static_cast<const C*>(a) + i));
}

// Work item j of step kk, the larger buckets first and the parts of a TU
// next to each other (so on different CTAs) -> its operands (log2 0 when
// the step has fewer than j + 1 items).  Loads only what does not depend
// on the plane, through the read-only path.
template <typename C>
__device__ __forceinline__ void fetch(const ScanParams& p, const int* sh,
                                      int len, int kk, int j, int lane,
                                      TuOps& t) {
  int b = -1, u = 0, r = j;
#pragma unroll
  for (int i = kMaxBuckets - 1; i >= 0; --i) {
    if (i < p.n_buckets && b < 0) {
      const int a = sh[i * len + kk];
      const int c = (sh[i * len + kk + 1] - a) * p.b[i].parts;
      if (r < c) {
        b = i;
        u = a + r / p.b[i].parts;
        r %= p.b[i].parts;
      } else {
        r -= c;
      }
    }
  }
  t.log2 = 0;
  if (b < 0) return;
  const ScanBucket& B = p.b[b];
  const int L2 = B.log2, S = 1 << L2, R = 4 * S + 2, SS = S * S;
  const int n_res = SS < kPart ? SS : kPart;
  t.log2 = L2;
  t.q = r;
  t.mode = __ldg(B.mode + u);
  t.filt = __ldg(B.filter_flag + u) != 0;
  t.strong_ok = __ldg(B.strong_allowed + u) != 0;
  t.edge = __ldg(B.dc_edge + u) != 0;
  t.py = coord<C>(B.pos, 2 * static_cast<int64_t>(u));
  t.px = coord<C>(B.pos, 2 * static_cast<int64_t>(u) + 1);
  const int64_t ro = static_cast<int64_t>(u) * R;
#pragma unroll
  for (int i = 0; i < kRefSlots; ++i) {
    const int q = lane + 32 * i;
    if (q < R) {
      t.ok[i] = __ldg(B.ref_ok + ro + q) != 0;
      t.ys[i] = coord<C>(B.ref_ys, ro + q);
      t.xs[i] = coord<C>(B.ref_xs, ro + q);
    }
  }
  const int32_t* res =
      B.residual + static_cast<int64_t>(u) * SS + r * kPart;
#pragma unroll
  for (int i = 0; i < kResSlots; ++i) {
    const int e = lane + 32 * i;
    if (e < n_res) t.res[i] = __ldg(res + e);
  }
}

// One work item on one warp: the TU's references, smoothed and extended
// (each part of a large TU prepares them itself: no warp waits for
// another), then the item's samples.  Per-warp shared scratch: raw and sel
// [4s+2], ext [3s+2].
template <int LOG2>
__device__ __forceinline__ void predict_tu(const ScanParams& p,
                                           const TuOps& t, int lane, int* raw,
                                           int* sel, int* ext) {
  constexpr int S = 1 << LOG2, N2 = 2 * S, NREF = N2 + 1, R = 2 * NREF;
  constexpr int NS = S * S < kPart ? S * S : kPart;   // the item's samples
  const int mode = t.mode;
  __syncwarp();   // the warp's previous item is done with its scratch

  // 1. the references, from the plane before this step
#pragma unroll
  for (int i = 0; i < (R + 31) / 32; ++i) {
    const int q = lane + 32 * i;
    if (q < R)
      raw[q] = t.ok[i] ? __ldcg(p.plane + static_cast<int64_t>(t.ys[i]) *
                                              p.pw + t.xs[i])
                       : 128;
  }
  __syncwarp();

  // 2. smoothing (kernels/intra.py filter_refs), gated by filter_flag
  bool strong = false;
  if (S == 32 && t.filt && t.strong_ok) {
    const int* Lr = raw;
    const int* Tr = raw + NREF;
    strong = abs(Tr[0] + Tr[N2] - 2 * Tr[S]) < 8 &&
             abs(Lr[0] + Lr[N2] - 2 * Lr[S]) < 8;
  }
#pragma unroll
  for (int k = 0; k < (R + 31) / 32; ++k) {
    const int q = lane + 32 * k;
    if (q < R) {
      const int* a = raw + (q < NREF ? 0 : NREF);   // left or top
      const int i = q < NREF ? q : q - NREF;
      int v = a[i];
      if (t.filt) {
        if (strong) {
          if (i != 0 && i != N2) v = ((N2 - i) * a[0] + i * a[N2] + S) >> 6;
        } else if (i == 0) {
          v = (raw[1] + 2 * raw[0] + raw[NREF + 1] + 2) >> 2;   // corner
        } else if (i < N2) {
          v = (a[i - 1] + 2 * a[i] + a[i + 1] + 2) >> 2;
        }
      }
      sel[q] = v;
    }
  }
  __syncwarp();
  const int* L = sel;
  const int* T = sel + NREF;

  // 3. the DC value (a warp sum; integer sums are exact in any order), or
  //    the extended main reference of an angular mode: ext[S + j] = main[j]
  //    (j = 0..2S), ext[i < S] = side projected by the inverse angle
  //    (clamped into 0..2S), ext[3S + 1] = 0
  int dc = 0;
  if (mode == 1) {
    const int part = lane < S ? L[lane + 1] + T[lane + 1] : 0;
    dc = (__reduce_add_sync(0xffffffffu, part) + S) >> (LOG2 + 1);
  } else if (mode >= 2) {
    const int* mainr = mode >= 18 ? T : L;
    const int* side = mode >= 18 ? L : T;
    const int inv = p.inv_angle[mode];
#pragma unroll
    for (int k = 0; k < (3 * S + 2 + 31) / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < 3 * S + 2) {
        int v = 0;
        if (i >= S && i <= 3 * S)
          v = mainr[i - S];
        else if (i < S)
          v = side[min(max(((i - S) * inv + 128) >> 8, 0), N2)];
        ext[i] = v;
      }
    }
    __syncwarp();
  }

  // 4. the samples: prediction, edge filters, + residual, clip, store
  const int angle = p.angle[mode];
  const bool edge = S < 32 && t.edge;
#pragma unroll
  for (int k = 0; k < (NS + 31) / 32; ++k) {
    const int el = lane + 32 * k;
    if (el < NS) {
      const int e = t.q * NS + el;
      const int y = e >> LOG2, x = e & (S - 1);
      int v;
      if (mode == 0) {
        v = ((S - 1 - x) * L[1 + y] + (x + 1) * T[S + 1] +
             (S - 1 - y) * T[1 + x] + (y + 1) * L[S + 1] + S) >> (LOG2 + 1);
      } else if (mode == 1) {
        v = dc;
        if (edge) {
          if (x == 0 && y == 0)
            v = (L[1] + 2 * dc + T[1] + 2) >> 2;
          else if (y == 0)
            v = (T[x + 1] + 3 * dc + 2) >> 2;
          else if (x == 0)
            v = (L[y + 1] + 3 * dc + 2) >> 2;
        }
      } else {
        // the horizontal family (modes 2..17) runs on main = left,
        // transposed
        const bool vert = mode >= 18;
        const int yy = (vert ? y : x) + 1, xx = vert ? x : y;
        const int idx = (yy * angle) >> 5, fact = (yy * angle) & 31;
        const int i1 = min(max(S + xx + idx + 1, 0), 3 * S);
        const int i2 = min(i1 + 1, 3 * S + 1);
        v = ((32 - fact) * ext[i1] + fact * ext[i2] + 16) >> 5;
        if (edge && mode == 26 && x == 0)
          v = min(max(T[1] + ((L[y + 1] - L[0]) >> 1), 0), 255);
        if (edge && mode == 10 && y == 0)
          v = min(max(L[1] + ((T[x + 1] - T[0]) >> 1), 0), 255);
      }
      v = min(max(v + t.res[k], 0), 255);
      p.plane[static_cast<int64_t>(t.py + y) * p.pw + t.px + x] = v;
    }
  }
}

__device__ __forceinline__ void run_tu(const ScanParams& p, const TuOps& t,
                                       int lane, int* raw, int* sel,
                                       int* ext) {
  switch (t.log2) {   // uniform across the warp
    case 2: predict_tu<2>(p, t, lane, raw, sel, ext); break;
    case 3: predict_tu<3>(p, t, lane, raw, sel, ext); break;
    case 4: predict_tu<4>(p, t, lane, raw, sel, ext); break;
    case 5: predict_tu<5>(p, t, lane, raw, sel, ext); break;
    default: break;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Every 128-byte line of bytes [a, b) of `base` into L2, the lines
// dealt over the cluster's threads (thread `tid` of `nth`).
__device__ __forceinline__ void prefetch_l2(const void* base, int64_t a,
                                            int64_t b, int tid, int nth) {
  const char* c = static_cast<const char*>(base);
  for (int64_t o = (a & ~int64_t{127}) + 128 * static_cast<int64_t>(tid);
       o < b; o += 128 * static_cast<int64_t>(nth))
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
}

// The records of the TUs of the launch's steps (bucket i's rows sh[i *
// len] .. sh[i * len + len - 1]) into L2, before the first step: they
// arrive by a host-to-device copy, and each step's loads would otherwise
// wait on device memory in the chain (PERF.md).
template <typename C>
__device__ __forceinline__ void prefetch_records(const ScanParams& p,
                                                 const int* sh, int len) {
  const int nth = kCtas * kWarps * 32;
  const int tid = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  for (int i = 0; i < p.n_buckets; ++i) {
    const ScanBucket& B = p.b[i];
    const int64_t a = sh[i * len], b = sh[i * len + len - 1];
    const int64_t S = int64_t{1} << B.log2, R = 4 * S + 2;
    const int64_t cs = sizeof(C);
    prefetch_l2(B.ref_ys, a * R * cs, b * R * cs, tid, nth);
    prefetch_l2(B.ref_xs, a * R * cs, b * R * cs, tid, nth);
    prefetch_l2(B.ref_ok, a * R, b * R, tid, nth);
    prefetch_l2(B.pos, a * 2 * cs, b * 2 * cs, tid, nth);
    prefetch_l2(B.mode, a, b, tid, nth);
    prefetch_l2(B.filter_flag, a, b, tid, nth);
    prefetch_l2(B.strong_allowed, a, b, tid, nth);
    prefetch_l2(B.dc_edge, a, b, tid, nth);
    prefetch_l2(B.residual, a * S * S * 4, b * S * S * 4, tid, nth);
  }
}

// The coordinates' type C: uint16_t or int32_t.  One CTA a multiprocessor
// is all a launch takes, and saying so lets the compiler keep a work item
// in registers: left to aim for two CTAs, it rematerialises lane and
// parameter values in the step's chain, which measured slower on an H100
// (PERF.md).
template <typename C>
__global__ void __launch_bounds__(kWarps * 32, 1)
scan_kernel(const __grid_constant__ ScanParams p) {
  extern __shared__ int sh[];   // [n_buckets, k1 - k0 + 1] step starts
  __shared__ int s_raw[kWarps][kMaxRefs];
  __shared__ int s_sel[kWarps][kMaxRefs];
  __shared__ int s_ext[kWarps][kMaxExt];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int nw = kCtas * kWarps;
  const int gw = blockIdx.x + kCtas * w;   // item j goes to CTA j % kCtas
  const int n = p.k1 - p.k0, len = n + 1, nb = p.n_buckets;
  for (int i = threadIdx.x; i < nb * len; i += blockDim.x)
    sh[i] = __ldg(p.starts + static_cast<int64_t>(i / len) * p.stride +
                  p.k0 + i % len);
  __syncthreads();
  if (!p.barrier_only) prefetch_records<C>(p, sh, len);
  int* raw = s_raw[w];
  int* sel = s_sel[w];
  int* ext = s_ext[w];

  TuOps t;
  int kk = next_live(p, sh, len, 0, n);
  if (!p.barrier_only && kk < n) fetch<C>(p, sh, len, kk, gw, lane, t);
  while (kk < n) {
    if (!p.barrier_only) {
      run_tu(p, t, lane, raw, sel, ext);
      const int total = step_items(p, sh, len, kk);
      for (int j = gw + nw; j < total; j += nw) {   // a step wider
        fetch<C>(p, sh, len, kk, j, lane, t);        // than the warps
        run_tu(p, t, lane, raw, sel, ext);
      }
    }
    const int kn = next_live(p, sh, len, kk + 1, n);
    if (kn >= n) break;
    // the next step's operands load between the arrive and the wait
    __syncwarp();
    cluster_arrive();
    if (!p.barrier_only) fetch<C>(p, sh, len, kn, gw, lane, t);
    cluster_wait();
    kk = kn;
  }
}

// Per device: the kernel's attributes set and its launch checked once
// (0 unknown, 1 launchable, else -cudaError_t of the check).
int g_state[kMaxDevices];
int g_max_dyn[kMaxDevices];

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, size_t smem) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One instantiation's attributes set and one cluster of it with `dyn`
// bytes of dynamic shared memory checked to fit.
template <typename C>
cudaError_t prepare_kernel(int dyn) {
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        scan_kernel<C>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int fits = 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, dyn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&fits, scan_kernel<C>, &cfg);
  if (e == cudaSuccess && fits < 1) e = cudaErrorNotSupported;
  return e;
}

cudaError_t prepare(int dev) {
  int& state = g_state[dev];
  if (state == 1) return cudaSuccess;
  if (state < 0) return static_cast<cudaError_t>(-state);
  int optin = 0;
  cudaFuncAttributes fa16{}, fa32{};
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa16, scan_kernel<uint16_t>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa32, scan_kernel<int32_t>);
  // one cluster with the most shared memory a launch takes must fit
  const int dyn = optin - static_cast<int>(std::max(fa16.sharedSizeBytes,
                                                    fa32.sharedSizeBytes));
  if (e == cudaSuccess) e = prepare_kernel<uint16_t>(dyn);
  if (e == cudaSuccess) e = prepare_kernel<int32_t>(dyn);
  g_max_dyn[dev] = dyn;
  state = e == cudaSuccess ? 1 : -static_cast<int>(e);
  return e;
}

}  // namespace

// table: n_buckets rows of kTableCols int64 (host memory): ref_ys, ref_xs,
//   ref_ok, mode, filter_flag, strong_allowed, dc_edge, pos, residual
//   (device pointers; coordinates uint16, or int32 with coord_wide; mode
//   uint8; flags bytes), log2; ascending log2.  starts: device int32 [n_buckets,
//   stride].  angles: host int32 [2 * 35], intraPredAngle then invAngle per
//   mode.  The starts of steps k0..k1 must fit in
//   shared memory (n_buckets * (k1 - k0 + 1) int32, ~200 KB on an H100).
//   Launches on `stream`, does not synchronise, returns the cudaError_t of
//   the checks or of the launch; nothing falls back.
extern "C" int p265_scan(const int64_t* table, int n_buckets,
                         const int32_t* starts, int stride, int k0, int k1,
                         int32_t* plane, int pw, int coord_wide,
                         int barrier_only,
                         const int32_t* angles, cudaStream_t stream) {
  if (n_buckets <= 0 || n_buckets > kMaxBuckets || k0 < 0 || k1 <= k0 ||
      k1 > stride - 1 || pw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanParams p{};
  p.n_buckets = n_buckets;
  for (int i = 0; i < n_buckets; ++i) {
    const int64_t* t = table + static_cast<int64_t>(i) * kTableCols;
    ScanBucket& b = p.b[i];
    b.ref_ys = reinterpret_cast<const void*>(t[0]);
    b.ref_xs = reinterpret_cast<const void*>(t[1]);
    b.ref_ok = reinterpret_cast<const uint8_t*>(t[2]);
    b.mode = reinterpret_cast<const uint8_t*>(t[3]);
    b.filter_flag = reinterpret_cast<const uint8_t*>(t[4]);
    b.strong_allowed = reinterpret_cast<const uint8_t*>(t[5]);
    b.dc_edge = reinterpret_cast<const uint8_t*>(t[6]);
    b.pos = reinterpret_cast<const void*>(t[7]);
    b.residual = reinterpret_cast<const int32_t*>(t[8]);
    b.log2 = static_cast<int>(t[9]);
    b.parts = (1 << 2 * b.log2) > kPart ? (1 << 2 * b.log2) / kPart : 1;
    if (b.log2 < 2 || b.log2 > 5 || (i > 0 && b.log2 <= p.b[i - 1].log2))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.starts = starts;
  p.stride = stride;
  p.k0 = k0;
  p.k1 = k1;
  p.plane = plane;
  p.pw = pw;
  p.barrier_only = barrier_only;
  for (int m = 0; m < kModes; ++m) {
    p.angle[m] = angles[m];
    p.inv_angle[m] = angles[kModes + m];
  }

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  e = prepare(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long smem = 4L * n_buckets * (k1 - k0 + 1);
  if (smem > g_max_dyn[dev]) return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, static_cast<size_t>(smem));
  cfg.stream = stream;
  void* args[] = {&p};
  const void* kernel =
      coord_wide ? reinterpret_cast<const void*>(scan_kernel<int32_t>)
                 : reinterpret_cast<const void*>(scan_kernel<uint16_t>);
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
