// Kernels A and C: the octave of the SIFT pyramid, for Hopper (sm_90a).
//
// Kernel A (octave_front_launch) replaces the TPU kernels
// sift_tpu/ops/pallas_pyramid.py::fused_octave_front (:240, body
// _octave_front_kernel :148-200) and the value outputs of
// fused_octave_front_twin (:513, body _octave_front_twin_kernel :346-458).
// Per octave, from the seed image (B, H, W) f32 it writes
//   gauss  (B, n+1, H, W)   the seed and n chained separable blurs
//   dog    (B, n,   H, W)   gauss[i+1] - gauss[i]
//   mask   (B, n-2, H, nbm*128) f32 0/1: |c| > thr and c >= or <= all 27
//          values of its 3x3x3 window (centre included), interior only,
//          lanes >= W zero
//   counts (B, n-2, H, nbm) int32: popcount of each 128-lane mask block.
// The TPU twin-row / cube-packed layout emission is not ported: the port's
// gathers read these plain stacks.
//
// Kernel C (octave_blur_launch) replaces
// sift_tpu/ops/pallas_pyramid.py::fused_octave_blur (:675, body
// _octave_kernel :105-122): the same kernel compiled without the mask, so
// it writes only gauss and dog, and its halo drops the mask's +1 ring.
// The TPU kernel replicates the border rows after each vertical pass
// (_fix_borders); here every tap index is clamped to the layer's true
// border instead, which reads the same values.
//
// Arithmetic is the plain version's (sift_tpu_torch/ops/blur.py), one IEEE
// operation at a time: acc = x*k0; acc = acc + k_u*(x[+u] + x[-u]);
// acc = acc / sum_w; horizontal then vertical, each tap index clamped to the
// current layer's true image border.  Built with -fmad=false and the
// explicit _rn intrinsics, so gauss and DoG are bit-equal to the plain
// version (and kernels A and C to each other), and mask and counts (exact
// functions of the DoGs) equal too.
//
// Design: one CTA per (128-column tile, 32-row strip, image).  The CTA loads
// the seed tile plus a halo of (sum of blur radii, +1 for A) rows and
// columns into shared memory and runs the whole blur chain there, shrinking
// the computed region by each blur's radius; A's +1 keeps the last DoG
// valid on the tile's +-1 ring that the 3x3x3 window reads.  Three DoG
// layers live in a ring buffer for A's mask.  128-column tiles own whole
// popcount blocks, so counts need no global atomics.
//
// What bounds them: the mandatory traffic is one seed read and (n+1)+n
// output planes (A: + (n-2) mask planes) written, 48 (A: ~60) bytes per
// pixel at n = 5: memory-bound in principle.  In this first version the
// halo is recomputed per tile (a 196x100 input region for a 128x32 tile at
// the default sigmas), and a CTA needs ~150 KB (C) or ~210 KB (A) of shared
// memory, so one CTA of 8 warps runs per SM; the kernels are
// latency/occupancy-bound on shared-memory arithmetic rather than on DRAM
// bandwidth.  Cheaper halos (taller strips for C, which has no ring; a
// rolling row window) are later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MAX_LAYERS 8
#define MAX_TAPS 16
#define TILE_W 128
#define TILE_H 32
#define NTHREADS 256
#define RING_W (TILE_W + 2)
#define RING_H (TILE_H + 2)

struct FrontParams {
  float taps[MAX_LAYERS][MAX_TAPS];
  float sum_w[MAX_LAYERS];
  int ntaps[MAX_LAYERS];
  int n;      // blur layers
  int halo;   // sum of radii + 1
  int H, W, nbm, wpad;
  float thr;
  int pitch;  // row pitch of the two blur buffers in shared memory
  int rows;   // rows of the two blur buffers
};

// kMask: kernel A (mask + counts); without it, kernel C (gauss + dog only).
template <bool kMask>
__global__ void __launch_bounds__(NTHREADS)
octave_kernel(const float* __restrict__ seed, float* __restrict__ gauss,
              float* __restrict__ dog, float* __restrict__ mask,
              int* __restrict__ counts, const FrontParams p) {
  extern __shared__ float smem[];
  float* G = smem;                    // current gauss layer
  float* T = G + p.rows * p.pitch;    // horizontal-pass result
  float* ring = T + p.rows * p.pitch; // 3 DoG layers on the tile +-1
  int* cnt = reinterpret_cast<int*>(ring + 3 * RING_H * RING_W);

  const int H = p.H, W = p.W, n = p.n, pitch = p.pitch;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const int x1 = min(x0 + TILE_W, W), y1 = min(y0 + TILE_H, H);
  // Shared-memory origin (global coordinates of buffer element 0).
  const int oy = max(0, y0 - p.halo), ox = max(0, x0 - p.halo);
  const size_t plane = (size_t)H * W;
  const float* src = seed + (size_t)b * plane;
  float* gb = gauss + (size_t)b * (n + 1) * plane;
  float* db = dog + (size_t)b * n * plane;
  const int tid = threadIdx.x;

  if (kMask && tid < TILE_H) cnt[tid] = 0;

  // Seed region: the tile plus the full halo, clipped to the image.
  int h = p.halo;
  {
    const int ry0 = max(0, y0 - h), ry1 = min(H, y1 + h);
    const int rx0 = max(0, x0 - h), rx1 = min(W, x1 + h);
    const int nc = rx1 - rx0, total = (ry1 - ry0) * nc;
    for (int i = tid; i < total; i += NTHREADS) {
      const int y = ry0 + i / nc, x = rx0 + i % nc;
      const float v = src[(size_t)y * W + x];
      G[(y - oy) * pitch + (x - ox)] = v;
      if (y >= y0 && y < y1 && x >= x0 && x < x1) gb[(size_t)y * W + x] = v;
    }
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const int r = p.ntaps[k] - 1;
    const int hn = h - r;  // halo left after this blur
    const float* tp = p.taps[k];
    const float sw = p.sum_w[k];

    // Horizontal pass: rows of the previous region, columns of the new one.
    // Tap columns clamp to [0, W-1]; they stay inside the previous region.
    {
      const int ry0 = max(0, y0 - h), ry1 = min(H, y1 + h);
      const int rx0 = max(0, x0 - hn), rx1 = min(W, x1 + hn);
      const int nc = rx1 - rx0, total = (ry1 - ry0) * nc;
      for (int i = tid; i < total; i += NTHREADS) {
        const int y = ry0 + i / nc, x = rx0 + i % nc;
        const float* row = G + (y - oy) * pitch;
        float acc = __fmul_rn(row[x - ox], tp[0]);
        for (int u = 1; u <= r; ++u) {
          const float s = __fadd_rn(row[min(x + u, W - 1) - ox],
                                    row[max(x - u, 0) - ox]);
          acc = __fadd_rn(acc, __fmul_rn(tp[u], s));
        }
        T[(y - oy) * pitch + (x - ox)] = __fdiv_rn(acc, sw);
      }
    }
    __syncthreads();

    // Vertical pass over the new region; DoG = new - old, written in place
    // over the old layer (each element is read and written by one thread).
    {
      const int ry0 = max(0, y0 - hn), ry1 = min(H, y1 + hn);
      const int rx0 = max(0, x0 - hn), rx1 = min(W, x1 + hn);
      const int nc = rx1 - rx0, total = (ry1 - ry0) * nc;
      float* rk = ring + (k % 3) * RING_H * RING_W;
      for (int i = tid; i < total; i += NTHREADS) {
        const int y = ry0 + i / nc, x = rx0 + i % nc;
        const float* col = T + (x - ox);
        float acc = __fmul_rn(col[(y - oy) * pitch], tp[0]);
        for (int u = 1; u <= r; ++u) {
          const float s = __fadd_rn(col[(min(y + u, H - 1) - oy) * pitch],
                                    col[(max(y - u, 0) - oy) * pitch]);
          acc = __fadd_rn(acc, __fmul_rn(tp[u], s));
        }
        const float g = __fdiv_rn(acc, sw);
        float* gp = G + (y - oy) * pitch + (x - ox);
        const float d = __fsub_rn(g, *gp);
        *gp = g;
        if (y >= y0 && y < y1 && x >= x0 && x < x1) {
          gb[(size_t)(k + 1) * plane + (size_t)y * W + x] = g;
          db[(size_t)k * plane + (size_t)y * W + x] = d;
        }
        if (kMask && y >= y0 - 1 && y <= y1 && x >= x0 - 1 && x <= x1)
          rk[(y - y0 + 1) * RING_W + (x - x0 + 1)] = d;
      }
    }
    __syncthreads();
    h = hn;

    // Extremum mask of interior DoG layer z = k - 1 once dog[k] exists.
    if (kMask && k >= 2) {
      const int z = k - 1;
      const float* dm = ring + ((k - 2) % 3) * RING_H * RING_W;
      const float* dc = ring + ((k - 1) % 3) * RING_H * RING_W;
      const float* dp = ring + (k % 3) * RING_H * RING_W;
      float* mz = mask + ((size_t)b * (n - 2) + (z - 1)) * (size_t)H * p.wpad;
      // TILE_W is a multiple of 32, so every warp covers one tile row and
      // every thread runs the same number of iterations (ballot is safe).
      for (int i = tid; i < TILE_H * TILE_W; i += NTHREADS) {
        const int ly = i / TILE_W, lx = i % TILE_W;
        const int y = y0 + ly, x = x0 + lx;
        bool m = false;
        if (y >= 1 && y <= H - 2 && x >= 1 && x <= W - 2) {
          const int c0 = (ly + 1) * RING_W + (lx + 1);
          const float c = dc[c0];
          float mx = c, mn = c;
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              const int o = c0 + dy * RING_W + dx;
              mx = fmaxf(mx, fmaxf(dm[o], fmaxf(dc[o], dp[o])));
              mn = fminf(mn, fminf(dm[o], fminf(dc[o], dp[o])));
            }
          }
          m = fabsf(c) > p.thr && (c >= mx || c <= mn);
        }
        if (y < H) mz[(size_t)y * p.wpad + x] = m ? 1.0f : 0.0f;
        const unsigned bal = __ballot_sync(0xffffffffu, m);
        if ((tid & 31) == 0 && bal) atomicAdd(&cnt[ly], __popc(bal));
      }
      __syncthreads();
      if (tid < TILE_H) {
        const int y = y0 + tid;
        if (y < H)
          counts[(((size_t)b * (n - 2) + (z - 1)) * H + y) * p.nbm + blockIdx.x] =
              cnt[tid];
        cnt[tid] = 0;  // next use is after at least two barriers
      }
    }
  }
}

// Builds the parameter block from host arrays and launches on ``stream``.
// taps: n * MAX_TAPS floats (row k = layer k's one-sided taps), ntaps: n
// ints, sum_w: n floats.  Returns cudaGetLastError().
template <bool kMask>
static int launch(const float* seed, float* gauss, float* dog, float* mask,
                  int* counts, int B, int H, int W, int n, const float* taps,
                  const int* ntaps, const float* sum_w, float thr,
                  void* stream) {
  if (n < (kMask ? 3 : 1) || n > MAX_LAYERS || B < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  FrontParams p;
  memset(&p, 0, sizeof(p));
  int halo = kMask ? 1 : 0;
  for (int k = 0; k < n; ++k) {
    if (ntaps[k] < 1 || ntaps[k] > MAX_TAPS) return (int)cudaErrorInvalidValue;
    p.ntaps[k] = ntaps[k];
    p.sum_w[k] = sum_w[k];
    for (int u = 0; u < ntaps[k]; ++u) p.taps[k][u] = taps[k * MAX_TAPS + u];
    halo += ntaps[k] - 1;
  }
  p.n = n;
  p.halo = halo;
  p.H = H;
  p.W = W;
  p.nbm = (W + TILE_W - 1) / TILE_W;
  p.wpad = p.nbm * TILE_W;
  p.thr = thr;
  p.pitch = TILE_W + 2 * halo;
  p.rows = TILE_H + 2 * halo;
  size_t smem = sizeof(float) * 2 * (size_t)p.rows * p.pitch;
  if (kMask) smem += sizeof(float) * 3 * RING_H * RING_W + sizeof(int) * TILE_H;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      octave_kernel<kMask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.nbm, (H + TILE_H - 1) / TILE_H, B);
  octave_kernel<kMask><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      seed, gauss, dog, mask, counts, p);
  return (int)cudaGetLastError();
}

// Kernel A: gauss, dog, mask, counts.
extern "C" int octave_front_launch(const float* seed, float* gauss, float* dog,
                                   float* mask, int* counts, int B, int H,
                                   int W, int n, const float* taps,
                                   const int* ntaps, const float* sum_w,
                                   float thr, void* stream) {
  return launch<true>(seed, gauss, dog, mask, counts, B, H, W, n, taps, ntaps,
                      sum_w, thr, stream);
}

// Kernel C: gauss and dog only.
extern "C" int octave_blur_launch(const float* seed, float* gauss, float* dog,
                                  int B, int H, int W, int n,
                                  const float* taps, const int* ntaps,
                                  const float* sum_w, void* stream) {
  return launch<false>(seed, gauss, dog, nullptr, nullptr, B, H, W, n, taps,
                       ntaps, sum_w, 0.0f, stream);
}
