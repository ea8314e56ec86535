// Kernel D: one separable gaussian blur in one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel sift_tpu/ops/pallas_blur.py::pallas_separable_blur
// (:121; one pallas_call per pass in _one_pass :82-118, body _pass_kernel
// :59-72).  One launch blurs (B, H, W) f32 along both axes:
//   h   = (x[i]*k0 + sum_u k_u*(x[i+u] + x[i-u])) / sum_w   along W
//   out = (h[j]*k0 + sum_u k_u*(h[j+u] + h[j-u])) / sum_w   along H
// with every tap index clamped to [0, n-1] (the reference's clamp at the
// border, src/image.cpp:174-181), one IEEE operation at a time (built with
// -fmad=false, explicit _rn intrinsics), the horizontal value rounded to
// float32 before the vertical pass, so it is bit-equal to the plain version
// sift_tpu_torch/ops/blur.py::separable_blur.
//
// What bounds it: one read and one write of the plane, 8 bytes per pixel,
// against 2 (3r + 2) float operations per pixel (r <= 15): bound by bytes on
// this card (0.047 ms for 16 x 960 x 1280).  The earlier version ran the two
// passes as two launches through device memory (16 bytes per pixel), with
// its taps indexed at run time out of a stack frame.
//
// Design: a rolling row window, kernel A's (csrc/octave_front.cu) with one
// blur.  A CTA of BATCH_ROWS warps owns one TILE_W-column tile of one image
// over a strip of rows and walks down it, BATCH_ROWS rows a step:
//   1. each warp takes one input row (read from device memory into
//      registers a step ahead, r clamped columns on each side), puts it in
//      its own shared row and runs the horizontal pass of the tile's columns
//      into a ring of 2r + BATCH_ROWS rows;
//   2. after a barrier, each warp computes one output row whose taps are in
//      the ring (rows clamped to [0, H-1] before the slot is chosen) and
//      writes it to device memory, once.
// So every input row of the strip is read once (plus the strip's r warm-up
// rows on each side) and every output row written once.  The radius is a
// template parameter (the launcher picks the instance by ntaps), so the
// tap loops are unrolled and the taps are constant-bank operands: no stack
// frame.  The strip rule sizes the grid to the CTAs the card holds at once,
// as the runtime reports them for the radius instance.  The row schedule,
// ring slot by ring slot, is modelled in plain PyTorch by
// ops/blur_pass.py::blur_rolling_plain, which mirrors the constants and the
// strip rule below.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TAPS 16
#define TILE_W 256      // columns of a CTA's tile
#define BATCH_ROWS 8    // rows per step = warps per CTA
#define NTHREADS (32 * BATCH_ROWS)
#define GROUPS (TILE_W / 32)
#define FILL_ROWS 16    // the strip rule's allowance for the pipeline's fill
#define MIN_STRIP 32

struct BlurTaps {
  float k[MAX_TAPS];
  float sum_w;
};

// grid (ceil(W / TILE_W), ceil(H / strip), B), NTHREADS threads.
template <int R>
__global__ void __launch_bounds__(NTHREADS)
blur_kernel(const float* __restrict__ src, float* __restrict__ dst,
            const BlurTaps t, int H, int W, int strip) {
  constexpr int DEPTH = 2 * R + BATCH_ROWS;  // ring rows
  constexpr int RAW = TILE_W + 2 * R;        // an input row with its halo
  constexpr int NPRE = (RAW + 31) / 32;
  __shared__ float ring[DEPTH][TILE_W];
  __shared__ float raw[BATCH_ROWS][RAW];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TILE_W;
  const int ys = blockIdx.y * strip, ye = min(ys + strip, H);
  const int hi = min(H, ye + R);  // horizontal rows [max(0, ys - R), hi)
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* in = src + plane;
  float* out = dst + plane;

  float pre[NPRE];
  auto fetch = [&](int y) {
    const float* row = in + (size_t)y * W;
#pragma unroll
    for (int i = 0; i < NPRE; ++i) {
      const int c = lane + 32 * i;
      if (c < RAW) pre[i] = row[min(max(x0 - R + c, 0), W - 1)];
    }
  };

  int hn = max(0, ys - R), vn = ys;  // next horizontal row, next output row
  if (warp < hi - hn) fetch(hn + warp);
  while (vn < ye) {
    // 1: horizontal pass of rows [hn, hn + hc), one a warp.
    const int hc = min(BATCH_ROWS, hi - hn);
    if (warp < hc) {
      float* s = raw[warp];
#pragma unroll
      for (int i = 0; i < NPRE; ++i) {
        const int c = lane + 32 * i;
        if (c < RAW) s[c] = pre[i];
      }
      __syncwarp();
      float* d = ring[(hn + warp) % DEPTH];
#pragma unroll
      for (int i = 0; i < GROUPS; ++i) {
        const float* c = s + lane + 32 * i + R;
        float acc = __fmul_rn(c[0], t.k[0]);
#pragma unroll
        for (int u = 1; u <= R; ++u)
          acc = __fadd_rn(acc, __fmul_rn(t.k[u], __fadd_rn(c[u], c[-u])));
        d[lane + 32 * i] = __fdiv_rn(acc, t.sum_w);
      }
    }
    hn += hc;
    if (warp < min(BATCH_ROWS, hi - hn)) fetch(hn + warp);
    __syncthreads();
    // 2: the output rows whose taps exist, at most a batch, one a warp.
    const int lim = hn == hi ? ye : min(ye, hn - R);
    const int vc = max(0, min(BATCH_ROWS, lim - vn));
    if (warp < vc) {
      const int y = vn + warp, sy = y % DEPTH;
      float acc[GROUPS];
#pragma unroll
      for (int i = 0; i < GROUPS; ++i) acc[i] = __fmul_rn(ring[sy][lane + 32 * i], t.k[0]);
#pragma unroll
      for (int u = 1; u <= R; ++u) {
        int sp = sy + (min(y + u, H - 1) - y);
        if (sp >= DEPTH) sp -= DEPTH;
        int sm = sy - (y - max(y - u, 0));
        if (sm < 0) sm += DEPTH;
#pragma unroll
        for (int i = 0; i < GROUPS; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(t.k[u], __fadd_rn(ring[sp][lane + 32 * i],
                                                                 ring[sm][lane + 32 * i])));
      }
      float* o = out + (size_t)y * W + x0;
#pragma unroll
      for (int i = 0; i < GROUPS; ++i)
        if (x0 + lane + 32 * i < W) o[lane + 32 * i] = __fdiv_rn(acc[i], t.sum_w);
    }
    vn += vc;
    __syncthreads();  // the ring's oldest rows are read before step 1 overwrites them
  }
}

typedef void (*BlurKernel)(const float*, float*, const BlurTaps, int, int, int);
static const BlurKernel kBlur[MAX_TAPS] = {
    blur_kernel<0>, blur_kernel<1>, blur_kernel<2>, blur_kernel<3>,
    blur_kernel<4>, blur_kernel<5>, blur_kernel<6>, blur_kernel<7>,
    blur_kernel<8>, blur_kernel<9>, blur_kernel<10>, blur_kernel<11>,
    blur_kernel<12>, blur_kernel<13>, blur_kernel<14>, blur_kernel<15>};

// Rows of a CTA's strip: of the strip counts whose strips are at least
// MIN_STRIP rows, the one with the least estimated time, (waves of CTAs
// over slots = SMs x resident CTAs an SM) x (rows a CTA walks: its strip, r
// warm-up rows on both sides and the pipeline's fill); the smaller count on
// a tie.
static int strip_rows_for(int B, int H, int W, int r, long long slots) {
  const long long tiles = (long long)((W + TILE_W - 1) / TILE_W) * B;
  long long best = -1;
  int best_rows = H;
  const int max_ns = H / MIN_STRIP > 1 ? H / MIN_STRIP : 1;
  for (int ns = 1; ns <= max_ns; ++ns) {
    const int rows = (H + ns - 1) / ns;
    const long long waves = (tiles * ns + slots - 1) / slots;
    const long long cost = waves * (rows + 2 * r + FILL_ROWS);
    if (best < 0 || cost < best) {
      best = cost;
      best_rows = rows;
    }
  }
  return best_rows;
}

// The launch plan of one blur on the current device: the strip rows, and
// the resident CTAs an SM (the radius instance's registers and shared
// memory decide it: 5 or 6 for the chain's radii on an H100) and the SMs
// the strip rule counts.  The occupancy is asked of the runtime once per
// radius.  On an H100 the rule's one wave at the main path's blur (720
// CTAs of 107 rows) is 7% slower than 1.3 waves of 74-row strips: the wave
// count does not model a kernel bound by bytes (PERF.md, open questions).
// Returns a CUDA error code.
extern "C" int blur_plan(int B, int H, int W, int ntaps, int* strip, int* ctas_per_sm,
                         int* sm_count) {
  static int occ[MAX_TAPS], sms;
  if (B < 1 || H < 1 || W < 1 || ntaps < 1 || ntaps > MAX_TAPS) return (int)cudaErrorInvalidValue;
  if (sms == 0) {
    int dev, n;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms = n;
  }
  if (occ[ntaps - 1] == 0) {
    int n;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kBlur[ntaps - 1], NTHREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    occ[ntaps - 1] = n;
  }
  *ctas_per_sm = occ[ntaps - 1];
  *sm_count = sms;
  *strip = strip_rows_for(B, H, W, ntaps - 1, (long long)sms * occ[ntaps - 1]);
  return 0;
}

// One blur of (B, H, W) f32 on ``stream``: taps, ntaps one-sided taps.
// Returns cudaGetLastError().
extern "C" int blur_launch(const float* src, float* dst, int B, int H, int W,
                           const float* taps, int ntaps, float sum_w,
                           void* stream) {
  int strip, ctas, sms;
  const int e = blur_plan(B, H, W, ntaps, &strip, &ctas, &sms);
  if (e != 0) return e;
  const int nstrips = (H + strip - 1) / strip;
  if (B > 65535 || nstrips > 65535) return (int)cudaErrorInvalidValue;
  BlurTaps t;
  for (int u = 0; u < MAX_TAPS; ++u) t.k[u] = u < ntaps ? taps[u] : 0.0f;
  t.sum_w = sum_w;
  dim3 grid((W + TILE_W - 1) / TILE_W, nstrips, B);
  kBlur[ntaps - 1]<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(src, dst, t, H, W, strip);
  return (int)cudaGetLastError();
}
