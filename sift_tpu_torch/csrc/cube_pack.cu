// Kernel G: cube-packed DoG rows of one octave, for Hopper (sm_90a).
//
// Replaces the TPU kernel sift_tpu/ops/pallas_relayout.py::cube_pack_rows
// (:195, call :220, body _cube_pack_kernel :185-192).  One launch packs an
// octave's plain DoG stack d (B, n, H, W) f32 into 128-lane rows of the
// shared buffer buf (B, P, 128) from row ``base``.  With sw = 128 / n stored
// columns per block, stride = sw - 3 and nbp blocks, row (y, cb) sits at
//
//   base + (((y >> ls) * nbp + cb) << ls) + (y & (st - 1)),   st = 1 << ls
//
// and its lane l < n * sw holds d[b, l / sw, y, cb * stride - 1 + l % sw]
// where that column lies in [0, W) and y < H, else 0: every DoG layer of a
// window of sw columns in one row, so a 3x3x3 cube is three rows
// (gather.CubeRows).  Every row of the octave's region [base, base +
// ceil(H / st) * st * nbp) is written, lanes >= n * sw and rows past H as
// zeros; rows outside it are not touched.  Pure data movement, bit-equal to
// its plain version sift_tpu_torch/ops/gather.py::cube_rows_plain.
//
// Design: one thread per output lane, a CTA of 128 x ROWS threads writes
// ROWS whole packed rows, so every warp writes one contiguous 128-byte run;
// its reads are n runs of sw consecutive columns of one image row.  Windows
// overlap by 3 columns, so about sw / stride of the input is read twice
// (from L2).
//
// What bounds it: bytes.  It reads B * n * H * W floats and writes
// B * nbp * ceil(H / st) * st * 128 floats (about 128 / (n * stride) times
// the input) and does no arithmetic beyond the index math (one division by
// sw per thread).

#include <cuda_runtime.h>
#include <stdint.h>

#define LANES 128
#define ROWS 8  // packed rows per CTA

// grid (ceil(nrows / ROWS), B), block (LANES, ROWS).
__global__ void cube_pack_kernel(const float* __restrict__ d,
                                 float* __restrict__ buf, int n, int H, int W,
                                 int nbp, int stride, int sw, int ls,
                                 long long rows_total, long long base,
                                 long long nrows) {
  const long long ol = (long long)blockIdx.x * ROWS + threadIdx.y;
  if (ol >= nrows) return;
  const int l = threadIdx.x;
  const long long t = ol >> ls;  // strip * nbp + cb
  const long long strip = t / nbp;
  const int cb = (int)(t - strip * nbp);
  const long long y = (strip << ls) + (ol & ((1LL << ls) - 1));
  const size_t bi = blockIdx.y;
  float v = 0.0f;
  if (l < n * sw && y < H) {
    const int z = l / sw;
    const int x = cb * stride - 1 + (l - z * sw);
    if (x >= 0 && x < W) v = d[((bi * n + z) * H + y) * (size_t)W + x];
  }
  buf[(bi * rows_total + base + ol) * (size_t)LANES + l] = v;
}

// One octave: d (B, n, H, W) into buf (B, rows_total, 128) at row ``base``,
// strips of 1 << ls rows.  Returns cudaGetLastError().
extern "C" int cube_pack_launch(const float* d, float* buf, int B, int n,
                                int H, int W, int ls, long long rows_total,
                                long long base, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || n > 32 || H < 1 || W < 1 || ls < 0 ||
      ls > 20)
    return (int)cudaErrorInvalidValue;
  const int sw = LANES / n, stride = sw - 3;
  if (stride < 1) return (int)cudaErrorInvalidValue;
  const int wi = W - 2 > 1 ? W - 2 : 1;
  const int nbp = (wi + stride - 1) / stride;
  const long long st = 1LL << ls;
  const long long nrows = (H + st - 1) / st * st * nbp;
  if (base < 0 || base % (nbp * st) != 0 || base + nrows > rows_total)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((nrows + ROWS - 1) / ROWS), B);
  cube_pack_kernel<<<grid, dim3(LANES, ROWS), 0, (cudaStream_t)stream>>>(
      d, buf, n, H, W, nbp, stride, sw, ls, rows_total, base, nrows);
  return (int)cudaGetLastError();
}
