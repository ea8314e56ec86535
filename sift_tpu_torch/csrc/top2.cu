// Kernel B: exact-integer top-2 descriptor matcher, for Hopper (sm_90a).
//
// Replaces the TPU kernel sift_tpu/ops/pallas_match.py::pallas_top2 (:90,
// body _kernel :29-86).  For each pair p and each row i of desc1[p] it scans
// desc2[p] and returns the smallest squared L2 distance (best), the
// second smallest (second) and the column of the best (idx), int32.
// d^2 = |a|^2 + |b|^2 - 2 a.b is computed in integers with __dp4a on packed
// uint8, so it is exact by construction (at most 128 * 255^2 < 2^24).
// Columns are scanned in ascending order with the update
//   if (d < b1) { b2 = b1; b1 = d; idx = j; } else if (d < b2) { b2 = d; }
// so the first column wins ties and a duplicate of the best counts as the
// second, as in the reference scan (src/sift.cpp:799-806).  Invalid targets
// read as HUGE_D2 = 1 << 24; a row with no valid target returns
// (HUGE, HUGE, 0), like argmin over an all-HUGE row.
//
// Design: one thread per row, its 128 bytes held in 32 registers; 128 rows
// per CTA.  Targets are staged through shared memory 64 at a time (their
// norms computed once per tile), and every thread reads the same target
// word at a time (a broadcast, no bank conflicts).  The N x M matrix is
// never materialized.
//
// What bounds it: 32 dp4a per (row, target) pair, i.e. 2 * 128 integer
// operations per pair.  At the main path's shapes (8 pairs of 2048 x 2048)
// that is ~8.6 G int8 operations, far below what memory traffic (~4 MB)
// would take; the bound is the card's integer rate, and this version runs
// on the CUDA cores' dp4a, not on the int8 tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#define HUGE_D2 (1 << 24)
#define ROWS 128
#define TM 64

__global__ void __launch_bounds__(ROWS)
top2_kernel(const uint8_t* __restrict__ d1, const uint8_t* __restrict__ d2,
            const uint8_t* __restrict__ v2, int* __restrict__ best,
            int* __restrict__ second, int* __restrict__ idx, int N, int M) {
  __shared__ uint32_t tile[TM][33];  // +1 word of padding per target row
  __shared__ int tnorm[TM];          // |b|^2, or -1 for an invalid target

  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * ROWS + tid;
  const bool live = row < N;

  uint32_t a[32];
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        d1 + ((size_t)p * N + (live ? row : 0)) * 128);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = live ? src[q] : make_uint4(0, 0, 0, 0);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  }
  unsigned na = 0;
#pragma unroll
  for (int w = 0; w < 32; ++w) na = __dp4a(a[w], a[w], na);

  int b1 = HUGE_D2, b2 = HUGE_D2, i1 = 0;
  const uint32_t* tb = reinterpret_cast<const uint32_t*>(d2 + (size_t)p * M * 128);
  const uint8_t* vb = v2 + (size_t)p * M;

  for (int j0 = 0; j0 < M; j0 += TM) {
    const int nt = min(TM, M - j0);
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < TM * 32; e += ROWS) {
      const int t = e >> 5, w = e & 31;
      tile[t][w] = t < nt ? tb[(size_t)(j0 + t) * 32 + w] : 0u;
    }
    __syncthreads();
    if (tid < TM) {
      unsigned s = 0;
#pragma unroll
      for (int w = 0; w < 32; ++w) s = __dp4a(tile[tid][w], tile[tid][w], s);
      tnorm[tid] = (tid < nt && vb[j0 + tid]) ? (int)s : -1;
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      unsigned dot = 0;
#pragma unroll
      for (int w = 0; w < 32; ++w) dot = __dp4a(a[w], tile[t][w], dot);
      const int nb = tnorm[t];
      const int d = nb < 0 ? HUGE_D2 : (int)na + nb - 2 * (int)dot;
      if (d < b1) {
        b2 = b1;
        b1 = d;
        i1 = j0 + t;
      } else if (d < b2) {
        b2 = d;
      }
    }
  }
  if (live) {
    const size_t o = (size_t)p * N + row;
    best[o] = b1;
    second[o] = b2;
    idx[o] = i1;
  }
}

// desc1 (P, N, 128) u8, desc2 (P, M, 128) u8, valid2 (P, M) u8 0/1 ->
// best, second, idx (P, N) int32.  Returns cudaGetLastError().
extern "C" int top2_launch(const uint8_t* desc1, const uint8_t* desc2,
                           const uint8_t* valid2, int* best, int* second,
                           int* idx, int P, int N, int M, void* stream) {
  if (P < 1 || N < 1 || M < 0 || P > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + ROWS - 1) / ROWS, P);
  top2_kernel<<<grid, ROWS, 0, (cudaStream_t)stream>>>(desc1, desc2, valid2,
                                                       best, second, idx, N, M);
  return (int)cudaGetLastError();
}
