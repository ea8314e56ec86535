// Kernel D: one 1-D pass of the separable gaussian blur, for Hopper (sm_90a).
//
// Replaces the TPU kernel sift_tpu/ops/pallas_blur.py::pallas_separable_blur
// (:121; one pallas_call per pass in _one_pass :82-118, body _pass_kernel
// :59-72).  One launch blurs (B, H, W) f32 along one axis:
//   acc = x[i]*k0;  acc = acc + k_u*(x[i+u] + x[i-u])  for u = 1..r;
//   out = acc / sum_w
// with every tap index clamped to [0, n-1] (the reference's clamp at the
// border, src/image.cpp:174-181), one IEEE operation at a time (built with
// -fmad=false, explicit _rn intrinsics), so it is bit-equal to the plain
// version sift_tpu_torch/ops/blur.py.  The wrapper runs the horizontal pass,
// then the vertical one, as the TPU version does.
//
// Design: one thread per output pixel.  A CTA stages its row segment
// (horizontal) or its column strip (vertical) plus r clamped halo pixels on
// each side in shared memory, so each input pixel is read from device
// memory about once, and neighbouring threads read neighbouring addresses.
//
// What bounds it: one read and one write of the plane per pass, 8 bytes per
// pixel, against 3r+2 float operations per pixel (r <= 15): bound by bytes
// on this card.  Keeping the whole blur in one pass (a rolling row window)
// would halve the traffic; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TAPS 16
#define MAX_R (MAX_TAPS - 1)
#define H_TILE 256  // horizontal pass: output columns per CTA (one row)
#define V_COLS 32   // vertical pass: columns per CTA
#define V_ROWS 64   // vertical pass: output rows per CTA
#define V_TY 8      // vertical pass: thread rows

struct BlurParams {
  float taps[MAX_TAPS];
  float sum_w;
  int r;
  int H, W;
};

__device__ __forceinline__ float tap_sum(const float* s, int c, int step,
                                         const BlurParams& p) {
  float acc = __fmul_rn(s[c], p.taps[0]);
  for (int u = 1; u <= p.r; ++u) {
    const float t = __fadd_rn(s[c + u * step], s[c - u * step]);
    acc = __fadd_rn(acc, __fmul_rn(p.taps[u], t));
  }
  return __fdiv_rn(acc, p.sum_w);
}

// grid (ceil(W / H_TILE), H, B), H_TILE threads.
__global__ void __launch_bounds__(H_TILE)
blur_h_kernel(const float* __restrict__ src, float* __restrict__ dst,
              const BlurParams p) {
  __shared__ float s[H_TILE + 2 * MAX_R];
  const int x0 = blockIdx.x * H_TILE;
  const size_t row = ((size_t)blockIdx.z * p.H + blockIdx.y) * p.W;
  for (int i = threadIdx.x; i < H_TILE + 2 * p.r; i += H_TILE) {
    const int x = min(max(x0 - p.r + i, 0), p.W - 1);
    s[i] = src[row + x];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x < p.W) dst[row + x] = tap_sum(s, threadIdx.x + p.r, 1, p);
}

// grid (ceil(W / V_COLS), ceil(H / V_ROWS), B), (V_COLS, V_TY) threads.
__global__ void __launch_bounds__(V_COLS* V_TY)
blur_v_kernel(const float* __restrict__ src, float* __restrict__ dst,
              const BlurParams p) {
  __shared__ float s[(V_ROWS + 2 * MAX_R) * V_COLS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * V_COLS + tx;
  const int y0 = blockIdx.y * V_ROWS;
  const size_t plane = (size_t)blockIdx.z * p.H * p.W;
  if (x < p.W) {
    for (int i = ty; i < V_ROWS + 2 * p.r; i += V_TY) {
      const int y = min(max(y0 - p.r + i, 0), p.H - 1);
      s[i * V_COLS + tx] = src[plane + (size_t)y * p.W + x];
    }
  }
  __syncthreads();
  if (x >= p.W) return;
  for (int j = ty; j < V_ROWS && y0 + j < p.H; j += V_TY)
    dst[plane + (size_t)(y0 + j) * p.W + x] =
        tap_sum(s, (j + p.r) * V_COLS + tx, V_COLS, p);
}

// One pass over (B, H, W) f32 on ``stream``: axis 1 blurs along W
// (horizontal), axis 0 along H (vertical).  taps: ntaps one-sided taps.
// Returns cudaGetLastError().
extern "C" int blur_pass_launch(const float* src, float* dst, int B, int H,
                                int W, const float* taps, int ntaps,
                                float sum_w, int axis, void* stream) {
  if (B < 1 || H < 1 || W < 1 || ntaps < 1 || ntaps > MAX_TAPS ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  BlurParams p;
  for (int u = 0; u < MAX_TAPS; ++u) p.taps[u] = u < ntaps ? taps[u] : 0.0f;
  p.sum_w = sum_w;
  p.r = ntaps - 1;
  p.H = H;
  p.W = W;
  cudaStream_t st = (cudaStream_t)stream;
  if (axis == 1) {
    dim3 grid((W + H_TILE - 1) / H_TILE, H, B);
    blur_h_kernel<<<grid, H_TILE, 0, st>>>(src, dst, p);
  } else if (axis == 0) {
    dim3 grid((W + V_COLS - 1) / V_COLS, (H + V_ROWS - 1) / V_ROWS, B);
    blur_v_kernel<<<grid, dim3(V_COLS, V_TY), 0, st>>>(src, dst, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
