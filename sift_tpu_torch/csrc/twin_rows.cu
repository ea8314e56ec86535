// Kernels E and H: twin-block rows, for Hopper (sm_90a).  E writes one
// octave's rows strip-interleaved into a shared gather buffer; H (at the
// end of this file) writes one matrix's rows in row-major order.
//
// Kernel E replaces the TPU kernel sift_tpu/ops/pallas_relayout.py::twin_rows_strips
// (:135; one pallas_call per octave in _twin_strips_write :98-120, body
// _twin_strips_kernel :89-95).  One launch copies an octave's rows
// f (B, R, W) f32 (R = S * H_o flat image rows) into the shared gather
// buffer buf (B, RT, 2 * blk) at row ``base``: flat row r, block b holds
// columns [b * blk, (b + 2) * blk) of row r (zero past W), stored at
//
//   base + (((r >> ls) * nb + b) << ls) + (r & (st - 1)),   st = 1 << ls
//
// for every r < rpad (R rounded up to a whole strip; rows R..rpad-1 are
// written as zeros).  Rows outside [base, base + nb * rpad) are not touched.
// Pure data movement, so it is bit-equal to its plain version
// sift_tpu_torch/ops/twin_rows.py::twin_rows_plain.
//
// Design: one thread per output element, a CTA of (2 * blk) x ROWS threads
// writes ROWS whole output rows, so each warp writes one contiguous run of
// an output row and reads a contiguous run of an input row.  Each input
// element is read twice (it sits in two twin blocks).
//
// What bounds it: bytes.  It reads B * R * W floats and writes
// B * nb * rpad * 2 * blk floats (about twice the input) and does no
// arithmetic beyond the index math.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROWS 4  // output rows per CTA

// grid (ceil(nb * rpad / ROWS), B), block (2 * blk, ROWS).
__global__ void twin_rows_kernel(const float* __restrict__ f,
                                 float* __restrict__ buf, int R, int W,
                                 int nb, int blk, int ls, long long rt,
                                 long long base, long long nrows) {
  const long long ol = (long long)blockIdx.x * ROWS + threadIdx.y;
  if (ol >= nrows) return;
  const int c = threadIdx.x;  // column in the twin row, < 2 * blk
  const long long st_mask = (1LL << ls) - 1;
  const long long t = ol >> ls;       // strip * nb + b
  const long long strip = t / nb;
  const int b = (int)(t - strip * nb);
  const long long r = (strip << ls) + (ol & st_mask);
  const int x = b * blk + c;
  const size_t bi = blockIdx.y;
  float v = 0.0f;
  if (r < R && x < W) v = f[(bi * R + r) * (size_t)W + x];
  buf[(bi * rt + base + ol) * (size_t)(2 * blk) + c] = v;
}

// One octave: f (B, R, W) into buf (B, rt, 2 * blk) at row ``base``, strips
// of 1 << ls rows, rpad = R rounded up to a strip, nb = ceil(W / blk).
// Returns cudaGetLastError().
extern "C" int twin_rows_launch(const float* f, float* buf, int B, int R,
                                int W, int blk, int ls, long long rt,
                                long long base, void* stream) {
  if (B < 1 || R < 1 || W < 1 || blk < 1 || 2 * blk * ROWS > 1024 ||
      ls < 0 || ls > 20 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nb = (W + blk - 1) / blk;
  const long long st = 1LL << ls;
  const long long rpad = (R + st - 1) / st * st;
  const long long nrows = nb * rpad;
  if (base < 0 || base % (nb * st) != 0 || base + nrows > rt)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((nrows + ROWS - 1) / ROWS), B);
  twin_rows_kernel<<<grid, dim3(2 * blk, ROWS), 0, (cudaStream_t)stream>>>(
      f, buf, R, W, nb, blk, ls, rt, base, nrows);
  return (int)cudaGetLastError();
}

// Kernel H: row-major twin-block rows of one matrix.
//
// Replaces the TPU kernel sift_tpu/ops/pallas_relayout.py::twin_rows_2d
// (:29, call :48, body _twin_kernel :23-26): mat (R, W) f32 -> out
// (R * nb, 2 * blk), row r * nb + b = columns [b * blk, (b + 2) * blk) of
// row r, zero past W.  It is kernel E's order with strips of one row and
// no batch, written out: the reader is gather.BlockRows, and the row-major
// gather.MultiRows of build_multi_rows.  Bit-equal to its plain version
// sift_tpu_torch/ops/twin_rows.py::twin_rows_2d_plain.
//
// Same design and the same bound as E: one thread per output element, a
// CTA writes ROWS whole output rows; it reads R * W floats (each twice) and
// writes R * nb * 2 * blk, and is bound by those bytes.
//
// grid (ceil(R * nb / ROWS)), block (2 * blk, ROWS).
__global__ void twin_rows_2d_kernel(const float* __restrict__ mat,
                                    float* __restrict__ out, int W, int nb,
                                    int blk, long long nrows) {
  const long long o = (long long)blockIdx.x * ROWS + threadIdx.y;
  if (o >= nrows) return;
  const int c = threadIdx.x;  // column in the twin row, < 2 * blk
  const long long r = o / nb;
  const int b = (int)(o - r * nb);
  const int x = b * blk + c;
  out[o * (size_t)(2 * blk) + c] = x < W ? mat[r * (size_t)W + x] : 0.0f;
}

// mat (R, W) -> out (R * nb, 2 * blk), nb = ceil(W / blk).  Returns
// cudaGetLastError().
extern "C" int twin_rows_2d_launch(const float* mat, float* out, int R, int W,
                                   int blk, void* stream) {
  if (R < 1 || W < 1 || blk < 1 || 2 * blk * ROWS > 1024)
    return (int)cudaErrorInvalidValue;
  const int nb = (W + blk - 1) / blk;
  const long long nrows = (long long)R * nb;
  const long long nblocks = (nrows + ROWS - 1) / ROWS;
  if (nblocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  twin_rows_2d_kernel<<<(unsigned)nblocks, dim3(2 * blk, ROWS), 0,
                        (cudaStream_t)stream>>>(mat, out, W, nb, blk, nrows);
  return (int)cudaGetLastError();
}
