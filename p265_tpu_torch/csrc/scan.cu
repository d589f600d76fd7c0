// The intra wavefront scan of one merged tall plane (HEVC 8.4.4.2), every
// step in ONE cooperative launch, bit-exact with
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
// A 1080p I picture has ~1,500 dependent steps; its bytes (each TU's
// references with their int64 index and ref_ok, its residual and its
// output, ~50 MB) take ~15 us at 3.35 TB/s, and its arithmetic (tens of
// integer operations a sample) less.  Each step costs at least one grid-
// wide barrier plus the latency of one gather -> smooth -> predict ->
// store chain through L2.  So the design spends the least it can per step:
// - one launch walks steps k0..k1-1; the host sets no pace inside it (the
//   plain loop runs ~25 torch operations a bucket a step, ~2.7 ms of host
//   time a step beside an H100);
// - the grid is made co-resident by cudaLaunchCooperativeKernel, and its
//   size is the least of the card's resident blocks and the most TUs any
//   step of the range has, so no block idles at a barrier for nothing;
// - the four size buckets of a step form one linear range of TUs, block b
//   taking TUs b, b + grid, ...; a step with no TU is skipped by every
//   block alike, without a barrier;
// - between steps, one hand-written barrier (an arrive counter and a
//   generation word, the wrapper zeroes both), after a __threadfence by
//   every thread; the plane is read with ld.global.cg so no block reads a
//   stale line from its SM's L1; the plane (int32, ~17 MB at 1080p) stays
//   in L2;
// - a TU's references, smoothed references and extended main reference
//   live in shared memory; every thread then computes samples straight
//   from the spec's integer formulas.  The port's plain route (an A-table
//   product per mode, kernels/intra.py) is not carried over: it reads a
//   [s*s, 4s+3] matrix per TU to do the same sums.
// Later work (not here): a warp per 4x4 TU, int16/uint8 planes, fewer
// barriers by fusing steps.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 4;
constexpr int kTableCols = 9;
constexpr int kModes = 35;
constexpr int kMaxRefs = 4 * 32 + 2;   // left(0..2s) then top(0..2s)
constexpr int kMaxExt = 3 * 32 + 2;    // ref[-s..2s] and one zero slot

struct ScanBucket {
  const int64_t* ref_idx;         // [n, 4s+2] flat plane indices
  const uint8_t* ref_ok;          // [n, 4s+2] bool
  const int32_t* mode;            // [n]
  const uint8_t* filter_flag;     // [n] bool
  const uint8_t* strong_allowed;  // [n] bool
  const uint8_t* dc_edge;         // [n] bool
  const int64_t* pos;             // [n, 2] (row, col) in the plane
  const int32_t* residual;        // [n, s, s]
  int log2;
};

struct ScanParams {
  ScanBucket b[kMaxBuckets];
  int n_buckets;
  const int32_t* starts;  // [n_buckets, stride]: TUs of step k of bucket
                          // i are rows starts[i][k]..starts[i][k+1]-1
  int stride;             // n_steps + 1
  int k0, k1;
  int32_t* plane;         // [rows, pw], updated in place
  int pw;
  int barrier_only;       // walk the steps and barriers, compute no TU
  unsigned int* bar;      // [2]: arrive count, generation
  int angle[kModes];      // intraPredAngle (0 for planar and DC)
  int inv_angle[kModes];  // invAngle for modes 11..25, else 0
};

// All blocks of the cooperative grid meet here.  Every thread fences its
// plane writes; thread 0 reads the generation, arrives, and either (the
// last to arrive) resets the counter and bumps the generation, or spins
// until the generation moves.
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int nblocks) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();   // the read of g stays before the arrive
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// One TU: row u of bucket B.  Shared scratch: raw and sel [4s+2], ext
// [3s+2], dcv.
template <int LOG2>
__device__ void predict_tu(const ScanParams& p, const ScanBucket& B, int u,
                           int* raw, int* sel, int* ext, int* dcv) {
  constexpr int S = 1 << LOG2, N2 = 2 * S, NREF = N2 + 1, R = 2 * NREF;
  const int tid = threadIdx.x;
  const int mode = __ldg(B.mode + u);
  const bool filt = __ldg(B.filter_flag + u) != 0;
  const bool edge = S < 32 && __ldg(B.dc_edge + u) != 0;
  __syncthreads();   // the block's previous TU is done with shared memory

  // 1. the references, from the plane before this step
  if (tid < R) {
    const int64_t o = static_cast<int64_t>(u) * R + tid;
    raw[tid] = __ldg(B.ref_ok + o) ? __ldcg(p.plane + __ldg(B.ref_idx + o))
                                   : 128;
  }
  __syncthreads();

  // 2. smoothing (kernels/intra.py filter_refs), gated by filter_flag
  if (tid < R) {
    const int* a = raw + (tid < NREF ? 0 : NREF);   // left or top
    const int i = tid < NREF ? tid : tid - NREF;
    int v = a[i];
    if (filt) {
      bool strong = false;
      if (S == 32 && __ldg(B.strong_allowed + u)) {
        const int* L = raw;
        const int* T = raw + NREF;
        strong = abs(T[0] + T[N2] - 2 * T[S]) < 8 &&
                 abs(L[0] + L[N2] - 2 * L[S]) < 8;
      }
      if (strong) {
        if (i != 0 && i != N2) v = ((N2 - i) * a[0] + i * a[N2] + S) >> 6;
      } else if (i == 0) {
        v = (raw[1] + 2 * raw[0] + raw[NREF + 1] + 2) >> 2;   // the corner
      } else if (i < N2) {
        v = (a[i - 1] + 2 * a[i] + a[i + 1] + 2) >> 2;
      }
    }
    sel[tid] = v;
  }
  __syncthreads();
  const int* L = sel;
  const int* T = sel + NREF;

  // 3. the DC value, or the extended main reference of an angular mode:
  //    ext[S + j] = main[j] (j = 0..2S), ext[i < S] = side projected by the
  //    inverse angle (clamped into 0..2S), ext[3S + 1] = 0
  if (mode == 1) {
    if (tid == 0) {
      int sum = S;
      for (int j = 1; j <= S; ++j) sum += L[j] + T[j];
      *dcv = sum >> (LOG2 + 1);
    }
  } else if (mode >= 2) {
    const int* mainr = mode >= 18 ? T : L;
    const int* side = mode >= 18 ? L : T;
    const int inv = p.inv_angle[mode];
    for (int i = tid; i < 3 * S + 2; i += kThreads) {
      int v = 0;
      if (i >= S && i <= 3 * S)
        v = mainr[i - S];
      else if (i < S)
        v = side[min(max(((i - S) * inv + 128) >> 8, 0), N2)];
      ext[i] = v;
    }
  }
  __syncthreads();

  // 4. the samples: prediction, edge filters, + residual, clip, store
  const int angle = p.angle[mode];
  const int dc = mode == 1 ? *dcv : 0;
  const int64_t py = __ldg(B.pos + 2 * static_cast<int64_t>(u));
  const int64_t px = __ldg(B.pos + 2 * static_cast<int64_t>(u) + 1);
  const int32_t* res = B.residual + static_cast<int64_t>(u) * S * S;
  for (int e = tid; e < S * S; e += kThreads) {
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
      // the horizontal family (modes 2..17) runs on main = left, transposed
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
    v = min(max(v + __ldg(res + e), 0), 255);
    p.plane[(py + y) * p.pw + px + x] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const __grid_constant__ ScanParams p) {
  __shared__ int raw[kMaxRefs];
  __shared__ int sel[kMaxRefs];
  __shared__ int ext[kMaxExt];
  __shared__ int dcv;
  for (int k = p.k0; k < p.k1; ++k) {
    int a[kMaxBuckets], cnt[kMaxBuckets], total = 0;
#pragma unroll
    for (int b = 0; b < kMaxBuckets; ++b) {
      a[b] = cnt[b] = 0;
      if (b < p.n_buckets) {
        const int32_t* st = p.starts + static_cast<int64_t>(b) * p.stride;
        a[b] = __ldg(st + k);
        cnt[b] = __ldg(st + k + 1) - a[b];
        total += cnt[b];
      }
    }
    if (total == 0) continue;   // the same in every block
    if (!p.barrier_only) {
      for (int j = blockIdx.x; j < total; j += gridDim.x) {
        // TU j of the step -> bucket b, row u (unrolled: a and cnt stay in
        // registers)
        int b = 0, r = j, u = a[0];
#pragma unroll
        for (int i = 0; i + 1 < kMaxBuckets; ++i) {
          if (b == i && r >= cnt[i]) {
            r -= cnt[i];
            b = i + 1;
            u = a[i + 1];
          }
        }
        u += r;
        const ScanBucket& B = p.b[b];
        switch (B.log2) {   // uniform across the block
          case 2: predict_tu<2>(p, B, u, raw, sel, ext, &dcv); break;
          case 3: predict_tu<3>(p, B, u, raw, sel, ext, &dcv); break;
          case 4: predict_tu<4>(p, B, u, raw, sel, ext, &dcv); break;
          case 5: predict_tu<5>(p, B, u, raw, sel, ext, &dcv); break;
          default: break;
        }
      }
    }
    if (k + 1 < p.k1) grid_barrier(p.bar, gridDim.x);
  }
}

}  // namespace

// table: n_buckets rows of kTableCols int64 (host memory): ref_idx, ref_ok,
//   mode, filter_flag, strong_allowed, dc_edge, pos, residual (device
//   pointers), log2.  starts: device int32 [n_buckets, stride].
//   max_tus: the most TUs of one step in k0..k1-1 (caps the grid).
//   angles: host int32 [2 * 35], intraPredAngle then invAngle per mode.
//   bar: device uint32 [2], zero.  Launches on `stream`, does not
//   synchronise, returns the launch's cudaError_t.
extern "C" int p265_scan(const int64_t* table, int n_buckets,
                         const int32_t* starts, int stride, int k0, int k1,
                         int32_t* plane, int pw, int max_tus,
                         int barrier_only, unsigned int* bar,
                         const int32_t* angles, cudaStream_t stream) {
  if (n_buckets <= 0 || n_buckets > kMaxBuckets || k0 < 0 || k1 <= k0 ||
      k1 > stride - 1 || pw <= 0 || max_tus < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanParams p{};
  p.n_buckets = n_buckets;
  for (int i = 0; i < n_buckets; ++i) {
    const int64_t* t = table + static_cast<int64_t>(i) * kTableCols;
    ScanBucket& b = p.b[i];
    b.ref_idx = reinterpret_cast<const int64_t*>(t[0]);
    b.ref_ok = reinterpret_cast<const uint8_t*>(t[1]);
    b.mode = reinterpret_cast<const int32_t*>(t[2]);
    b.filter_flag = reinterpret_cast<const uint8_t*>(t[3]);
    b.strong_allowed = reinterpret_cast<const uint8_t*>(t[4]);
    b.dc_edge = reinterpret_cast<const uint8_t*>(t[5]);
    b.pos = reinterpret_cast<const int64_t*>(t[6]);
    b.residual = reinterpret_cast<const int32_t*>(t[7]);
    b.log2 = static_cast<int>(t[8]);
    if (b.log2 < 2 || b.log2 > 5)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.starts = starts;
  p.stride = stride;
  p.k0 = k0;
  p.k1 = k1;
  p.plane = plane;
  p.pw = pw;
  p.barrier_only = barrier_only;
  p.bar = bar;
  for (int m = 0; m < kModes; ++m) {
    p.angle[m] = angles[m];
    p.inv_angle[m] = angles[kModes + m];
  }

  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || per_sm <= 0) return static_cast<int>(cudaErrorNotSupported);
  const int most = per_sm * sms;
  const int grid = max_tus < 1 ? 1 : max_tus < most ? max_tus : most;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(scan_kernel),
                                  dim3(grid), dim3(kThreads), args, 0,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
