// The in-loop filters of HEVC on a batch of int32 planes [B,H,W]: the
// deblocking of the vertical edges at x = 8(k+1) (8.7.2; the horizontal
// edges are the same filter on the transposed planes) and SAO (8.7.3),
// bit-exact with p265_tpu_torch/kernels/loopfilter.py
// deblock_luma_vertical_ref, deblock_chroma_vertical_ref and sao_apply_ref.
//
// Replaces the device half of p265_tpu/kernels/loopfilter.py:
// `_deblock_luma_vertical` (:146), `_deblock_chroma_vertical` (:231) and
// `_sao_apply` (:296), jax.jit functions that XLA fused inside the
// dispatch's one program (vmapped at p265_tpu/pipeline/batch_decode.py
// :456-472).  Not Pallas kernels: the port ran them as a few hundred eager
// torch operations a dispatch.
//
// What bounds them on Hopper: bytes.  Both read every sample of the planes
// and write every sample once; deblocking reads one int32 of bS, beta and
// tc per 4-line segment of an edge, SAO a CTB's type, class and offsets
// (cached: a CTB's parameters serve ctb^2 samples).  A 1080p picture's
// planes are 3.1 M samples, 12.4 MB each way as int32: ~7.4 us a pass of a
// direction or of SAO at 3.35 TB/s.  The arithmetic (a few dozen integer
// operations a sample) is far below the bytes.  So the design is one
// launch a call over all B planes, every thread doing a small independent
// piece, and no shared memory:
// - deblocking: edges 8 apart read columns [8k+4, 8k+11] and write
//   [8k+5, 8k+10] (chroma: [8k+6, 8k+9] and [8k+7, 8k+8]), so every 4-line
//   segment of every edge is independent within one direction.  One thread
//   takes one (plane, segment, edge): the decisions from lines 0 and 3,
//   then the four lines.  The same launch copies every sample no edge
//   writes (the rest of the grid), so the output is a new tensor and the
//   input is not modified, as in the plain version.  Threads run along
//   the axis of unit stride (edges for the vertical pass, segments for the
//   transposed view of the horizontal pass), so that a warp's loads share
//   sectors; both input and output are addressed by their strides, so the
//   horizontal pass needs no transposed copy;
// - SAO: one thread a sample: its CTB's type, class and offsets, the band
//   offset or the edge offset from its two neighbours (with the picture-
//   edge test of the plain version), clamp to 0..255.  A row offset and the
//   picture's height let the row-sharded SAO (shard/filters.py) filter a
//   band of rows with its halo rows through the same kernel.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct DbParams {
  const int32_t* in;
  int32_t* out;
  const int32_t* bs;     // [B, H/4, n_e] (luma only)
  const int32_t* beta;   // [B, H/4, n_e] (luma only)
  const int32_t* tc;     // [B, H/4, n_e]
  int B, H, W, n_e;
  long long ib, iy, ix;  // input strides, in elements
  long long ob, oy, ox;  // output strides
  int seg_fast;          // filter threads run along segments (else edges)
  long long n_filter;    // B * H/4 * n_e
  long long n_copy;      // B * H * W
};

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// one luma segment: 4 lines of the edge at column c
__device__ void luma_segment(const DbParams& p, long long seg, int b, int s,
                             int c) {
  const int bs = p.bs[seg], beta = p.beta[seg], tc = p.tc[seg];
  const int32_t* in = p.in + b * p.ib + 4LL * s * p.iy;
  int32_t* out = p.out + b * p.ob + 4LL * s * p.oy;
  int P[4][4], Q[4][4];  // [line][i]: p_i at c-1-i, q_i at c+i
#pragma unroll
  for (int ln = 0; ln < 4; ++ln)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      P[ln][i] = in[ln * p.iy + (c - 1 - i) * p.ix];
      Q[ln][i] = in[ln * p.iy + (c + i) * p.ix];
    }
  const int dp0 = iabs(P[0][2] - 2 * P[0][1] + P[0][0]);
  const int dp3 = iabs(P[3][2] - 2 * P[3][1] + P[3][0]);
  const int dq0 = iabs(Q[0][2] - 2 * Q[0][1] + Q[0][0]);
  const int dq3 = iabs(Q[3][2] - 2 * Q[3][1] + Q[3][0]);
  const bool filt = bs > 0 && dp0 + dp3 + dq0 + dq3 < beta;
  auto strong_line = [&](int ln, int dpl, int dql) {
    return 2 * (dpl + dql) < (beta >> 2) &&
           iabs(P[ln][3] - P[ln][0]) + iabs(Q[ln][0] - Q[ln][3]) <
               (beta >> 3) &&
           iabs(P[ln][0] - Q[ln][0]) < ((5 * tc + 1) >> 1);
  };
  const bool strong = filt && strong_line(0, dp0, dq0) &&
                      strong_line(3, dp3, dq3);
  const int side = (beta + (beta >> 1)) >> 3;
  const bool dep1 = dp0 + dp3 < side, deq1 = dq0 + dq3 < side;
#pragma unroll
  for (int ln = 0; ln < 4; ++ln) {
    const int p0 = P[ln][0], p1 = P[ln][1], p2 = P[ln][2], p3 = P[ln][3];
    const int q0 = Q[ln][0], q1 = Q[ln][1], q2 = Q[ln][2], q3 = Q[ln][3];
    int np0 = p0, np1 = p1, np2 = p2, nq0 = q0, nq1 = q1, nq2 = q2;
    if (strong) {
      np0 = clip3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                  p0 - 2 * tc, p0 + 2 * tc);
      np1 = clip3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc, p1 + 2 * tc);
      np2 = clip3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - 2 * tc,
                  p2 + 2 * tc);
      nq0 = clip3((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                  q0 - 2 * tc, q0 + 2 * tc);
      nq1 = clip3((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tc, q1 + 2 * tc);
      nq2 = clip3((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2 - 2 * tc,
                  q2 + 2 * tc);
    } else if (filt) {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (iabs(delta) < tc * 10) {
        const int dlt = clip3(delta, -tc, tc);
        np0 = clip3(p0 + dlt, 0, 255);
        nq0 = clip3(q0 - dlt, 0, 255);
        if (dep1)
          np1 = clip3(p1 + clip3((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                                 -(tc >> 1), tc >> 1), 0, 255);
        if (deq1)
          nq1 = clip3(q1 + clip3((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                                 -(tc >> 1), tc >> 1), 0, 255);
      }
    }
    int32_t* o = out + ln * p.oy;
    o[(c - 3) * p.ox] = np2;
    o[(c - 2) * p.ox] = np1;
    o[(c - 1) * p.ox] = np0;
    o[c * p.ox] = nq0;
    o[(c + 1) * p.ox] = nq1;
    o[(c + 2) * p.ox] = nq2;
  }
}

// one chroma segment: 4 lines of the edge at column c
__device__ void chroma_segment(const DbParams& p, long long seg, int b,
                               int s, int c) {
  const int tc = p.tc[seg];
  const int32_t* in = p.in + b * p.ib + 4LL * s * p.iy;
  int32_t* out = p.out + b * p.ob + 4LL * s * p.oy;
#pragma unroll
  for (int ln = 0; ln < 4; ++ln) {
    const int32_t* r = in + ln * p.iy;
    const int p1 = r[(c - 2) * p.ix], p0 = r[(c - 1) * p.ix];
    const int q0 = r[c * p.ix], q1 = r[(c + 1) * p.ix];
    int np0 = p0, nq0 = q0;
    if (tc > 0) {
      const int delta = clip3(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, -tc, tc);
      np0 = clip3(p0 + delta, 0, 255);
      nq0 = clip3(q0 - delta, 0, 255);
    }
    out[ln * p.oy + (c - 1) * p.ox] = np0;
    out[ln * p.oy + c * p.ox] = nq0;
  }
}

template <bool kLuma>
__global__ void __launch_bounds__(kThreads)
deblock_kernel(const __grid_constant__ DbParams p) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  const int segs = p.H / 4;
  if (t < p.n_filter) {
    int b, s, k;
    if (p.seg_fast) {
      s = static_cast<int>(t % segs);
      const long long r = t / segs;
      k = static_cast<int>(r % p.n_e);
      b = static_cast<int>(r / p.n_e);
    } else {
      k = static_cast<int>(t % p.n_e);
      const long long r = t / p.n_e;
      s = static_cast<int>(r % segs);
      b = static_cast<int>(r / segs);
    }
    const long long seg = (static_cast<long long>(b) * segs + s) * p.n_e + k;
    if (kLuma)
      luma_segment(p, seg, b, s, 8 * (k + 1));
    else
      chroma_segment(p, seg, b, s, 8 * (k + 1));
    return;
  }
  const long long u = t - p.n_filter;
  if (u >= p.n_copy) return;
  // the copy of every sample that no edge writes, along the unit stride
  int b, y, x;
  if (p.seg_fast) {
    y = static_cast<int>(u % p.H);
    const long long r = u / p.H;
    x = static_cast<int>(r % p.W);
    b = static_cast<int>(r / p.W);
  } else {
    x = static_cast<int>(u % p.W);
    const long long r = u / p.W;
    y = static_cast<int>(r % p.H);
    b = static_cast<int>(r / p.H);
  }
  // columns written by edge k: [8k+5, 8k+10] (luma), [8k+7, 8k+8] (chroma)
  const int first = kLuma ? 5 : 7, span = kLuma ? 6 : 2;
  if (x >= first && (x - first) / 8 < p.n_e && (x - first) % 8 < span)
    return;
  p.out[b * p.ob + y * p.oy + x * p.ox] = p.in[b * p.ib + y * p.iy +
                                               x * p.ix];
}

struct SaoParams {
  const int32_t* src;    // [B, H + 2 * src_row0, W], strided
  int32_t* out;          // [B, H, W] contiguous
  const int32_t* ty;     // [B, ny, nx]
  const int32_t* cls;    // [B, ny, nx]
  const int32_t* off;    // [B, 4, ny, nx]
  int B, H, W;
  long long sb, sy, sx;  // source strides, in elements
  int src_row0;          // source row of output row 0 (1: a halo row above)
  int row0, total_h;     // picture row of output row 0; picture height
  int ny, nx, ctb, band, edge;
};

// the neighbours of the four edge classes: (dy0, dx0, dy1, dx1)
__constant__ int kEo[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {-1, 1, 1, -1}};

__global__ void __launch_bounds__(kThreads)
sao_kernel(const __grid_constant__ SaoParams p) {
  const long long t = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (t >= static_cast<long long>(p.B) * p.H * p.W) return;
  const int x = static_cast<int>(t % p.W);
  const long long r = t / p.W;
  const int y = static_cast<int>(r % p.H);
  const int b = static_cast<int>(r / p.H);
  const int32_t* row = p.src + b * p.sb + (y + p.src_row0) * p.sy;
  const int v = row[x * p.sx];
  const int gy = p.row0 + y;
  const int cy = min(gy / p.ctb, p.ny - 1), cx = x / p.ctb;
  const long long ctb = (static_cast<long long>(b) * p.ny + cy) * p.nx + cx;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const int type = p.ty[ctb], cl = p.cls[ctb];
  // off[b, i, cy, cx]
  const int32_t* off = p.off + (static_cast<long long>(b) * 4 * p.ny + cy) *
                                   p.nx + cx;
  int delta = 0;
  if (type == p.band) {
    const int rel = ((v >> 3) - cl) & 31;
    if (rel < 4) delta = off[rel * plane];
  } else if (type == p.edge) {
    const int* eo = kEo[cl == 0 ? 0 : cl == 1 ? 1 : cl == 2 ? 2 : 3];
    const bool valid =
        gy + eo[0] >= 0 && gy + eo[0] < p.total_h && x + eo[1] >= 0 &&
        x + eo[1] < p.W && gy + eo[2] >= 0 && gy + eo[2] < p.total_h &&
        x + eo[3] >= 0 && x + eo[3] < p.W;
    if (valid) {
      const int n0 = row[eo[0] * p.sy + (x + eo[1]) * p.sx];
      const int n1 = row[eo[2] * p.sy + (x + eo[3]) * p.sx];
      const int e = sgn(v - n0) + sgn(v - n1);
      if (e != 0) delta = off[(e < 0 ? e + 2 : e + 1) * plane];
    }
  }
  p.out[t] = clip3(v + delta, 0, 255);
}

}  // namespace

// q: 16 int64 (host memory): in, out, bs, beta, tc (device pointers;
//   bs and beta 0 for chroma), B, H, W, n_e, in strides (b, y, x), out
//   strides (b, y, x), seg_fast.  chroma: 0 luma, 1 chroma.
extern "C" int p265_deblock(const int64_t* q, int chroma,
                            cudaStream_t stream) {
  DbParams p{};
  p.in = reinterpret_cast<const int32_t*>(q[0]);
  p.out = reinterpret_cast<int32_t*>(q[1]);
  p.bs = reinterpret_cast<const int32_t*>(q[2]);
  p.beta = reinterpret_cast<const int32_t*>(q[3]);
  p.tc = reinterpret_cast<const int32_t*>(q[4]);
  p.B = static_cast<int>(q[5]);
  p.H = static_cast<int>(q[6]);
  p.W = static_cast<int>(q[7]);
  p.n_e = static_cast<int>(q[8]);
  p.ib = q[9];
  p.iy = q[10];
  p.ix = q[11];
  p.ob = q[12];
  p.oy = q[13];
  p.ox = q[14];
  p.seg_fast = static_cast<int>(q[15]);
  // the last edge's window must lie inside the plane
  const int reach = chroma ? 2 : 4;
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || p.H % 4 != 0 || p.n_e < 0 ||
      8 * p.n_e + reach > p.W || !p.tc ||
      (!chroma && (!p.bs || !p.beta)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_filter = static_cast<long long>(p.B) * (p.H / 4) * p.n_e;
  p.n_copy = static_cast<long long>(p.B) * p.H * p.W;
  const long long blocks = (p.n_filter + p.n_copy + kThreads - 1) / kThreads;
  if (chroma)
    deblock_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(p);
  else
    deblock_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// q: 19 int64 (host memory): src, out, ty, cls, off (device pointers),
//   B, H, W, src strides (b, y, x), src_row0, row0, total_h, ny, nx, ctb,
//   and the type values of band offset and of edge offset.
extern "C" int p265_sao(const int64_t* q, cudaStream_t stream) {
  SaoParams p{};
  p.src = reinterpret_cast<const int32_t*>(q[0]);
  p.out = reinterpret_cast<int32_t*>(q[1]);
  p.ty = reinterpret_cast<const int32_t*>(q[2]);
  p.cls = reinterpret_cast<const int32_t*>(q[3]);
  p.off = reinterpret_cast<const int32_t*>(q[4]);
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
  p.ctb = static_cast<int>(q[16]);
  p.band = static_cast<int>(q[17]);
  p.edge = static_cast<int>(q[18]);
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || p.ctb <= 0 || p.ny <= 0 ||
      p.nx <= 0 || static_cast<long long>(p.nx) * p.ctb < p.W ||
      p.src_row0 < 0 || p.row0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(p.B) * p.H * p.W;
  sao_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
               kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
