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
// Design (the model is kernel E, csrc/twin_rows.cu).  A work unit (one CTA
// of 8 warps) is ROWS consecutive image rows [y0, y0 + ROWS) of one image
// and a chunk of nbc packed blocks [cb0, cb0 + nbc): grid (chunk, row
// group, image), so no thread divides to find its unit.  The CTA stages
// into shared memory, with cp.async, the n layers' ROWS rows over the
// columns [cb0 * stride - 1, (cb0 + nbc) * stride + 2) that its blocks'
// windows cover, starting from the 4-aligned column at or below the first:
// 16-byte copies where the rows are 16-byte aligned (W % 4 == 0, d
// aligned), 4-byte copies elsewhere, and zeros stored directly for columns
// outside [0, W) and rows >= H.  So each input float is read once from HBM
// (the 3 columns where two chunks meet, twice).  nbc comes from the
// shared-memory budget TILE_FLOATS (n * ROWS rows of cw floats, cw a
// multiple of 4 with room for the alignment shift).  Then warp j writes
// the packed rows (y0 + j, cb) of the chunk, each as 32 x 16 bytes with
// streaming stores (__stcs): thread t owns lanes 4t..4t+3, whose (layer,
// column) offsets into the tile it works out once; lanes >= n * sw get
// zeros.  The shared reads of a warp are 2-way bank conflicted at n = 5
// (the layer windows shift the banks), which the bytes leave room for.
// Rows y0 + j past the strip-padded height are outside the region and
// skipped; rows H..hpad-1 are written as zeros from the zero-staged rows.
// Index math is 32-bit: the 64-bit products are one per staged row (the
// source row) and one per packed row (the destination row).
//
// What bounds it: bytes.  It reads B * n * H * W floats and writes the
// region's B * nbp * hpad * 128 floats (about 128 / (n * stride) times the
// input, plus the strip padding), and does no arithmetic beyond the index
// math.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define LANES 128
#define ROWS 8             // image rows of a work unit (one warp writes each)
#define THREADS 256
#define TILE_FLOATS 12288  // staged floats of a unit at most (48 KB)

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g));
}

// Staged row pitch of a chunk of nbc blocks: the window columns plus up to
// 3 of alignment shift, rounded up to 16 bytes.
static int tile_width(int nbc, int stride) { return (nbc * stride + 6 + 3) & ~3; }

// VEC 4: 16-byte staging copies; 1: 4-byte.  grid (nchunks, hpad / ROWS
// rounded up, B), THREADS threads, n * ROWS * cw floats of dynamic shared
// memory.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    cube_pack_kernel(const float* __restrict__ d, float* __restrict__ buf, int n, int H, int W,
                     int nbp, int stride, int sw, int ls, int hpad, int nbc, int cw,
                     int rows_total, int base) {
  extern __shared__ __align__(16) float tile[];
  const int cb0 = blockIdx.x * nbc;
  const int nb = min(nbc, nbp - cb0);
  const int y0 = blockIdx.y * ROWS;
  const size_t bi = blockIdx.z;
  const int c0 = cb0 * stride - 1;             // first window column
  const int a0 = c0 >= 0 ? (c0 & ~3) : -4;     // the 4-aligned column at or below it
  const int shift = c0 - a0;
  const int ncols = (shift + nb * stride + 3 + 3) & ~3;  // staged columns, <= cw
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Stage: staged row q = z * ROWS + r is layer z of image row y0 + r.
  for (int q = warp; q < n * ROWS; q += THREADS / 32) {
    const int z = q / ROWS, y = y0 + (q % ROWS);
    float* trow = tile + q * cw;
    const float* srow = y < H ? d + ((bi * n + z) * H + y) * (size_t)W : nullptr;
    if (VEC == 4) {
      for (int t = lane * 4; t < ncols; t += 128) {
        const int x = a0 + t;  // a multiple of 4, as W is: inside or outside whole
        if (srow != nullptr && x >= 0 && x < W) cp_async16(trow + t, srow + x);
        else *reinterpret_cast<float4*>(trow + t) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int t = lane; t < ncols; t += 32) {
        const int x = a0 + t;
        if (srow != nullptr && x >= 0 && x < W) cp_async4(trow + t, srow + x);
        else trow[t] = 0.0f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Write: warp j writes the packed rows (y0 + j, cb0 + bb), bb < nb.
  const int y = y0 + warp;
  if (y >= hpad) return;
  int off[4];  // tile offset of lane 4 * lane + k at block cb0, or -1: a zero lane
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = 4 * lane + k;
    const int z = l / sw;
    off[k] = z < n ? (z * ROWS + warp) * cw + shift + (l - z * sw) : -1;
  }
  const int strip_row = (y >> ls) * nbp + cb0;  // (strip, block) index of block cb0
  const int sub = y & ((1 << ls) - 1);
  float* img = buf + bi * (size_t)rows_total * LANES;
  for (int bb = 0; bb < nb; ++bb) {
    const int row = base + ((strip_row + bb) << ls) + sub;
    const int col = bb * stride;
    float4 v;
    v.x = off[0] >= 0 ? tile[off[0] + col] : 0.0f;
    v.y = off[1] >= 0 ? tile[off[1] + col] : 0.0f;
    v.z = off[2] >= 0 ? tile[off[2] + col] : 0.0f;
    v.w = off[3] >= 0 ? tile[off[3] + col] : 0.0f;
    __stcs(reinterpret_cast<float4*>(img + (size_t)row * LANES) + lane, v);
  }
}

// Blocks a work unit takes: the most whose staged tile fits TILE_FLOATS,
// balanced over the chunks (ops/cube_pack.chunking mirrors this).
static void chunking(int n, int nbp, int stride, int* nbc, int* nchunks) {
  int most = 1;
  while (most < nbp && n * ROWS * tile_width(most + 1, stride) <= TILE_FLOATS) ++most;
  *nchunks = (nbp + most - 1) / most;
  *nbc = (nbp + *nchunks - 1) / *nchunks;
}

// One octave: d (B, n, H, W) into buf (B, rows_total, 128) at row ``base``,
// strips of 1 << ls rows.  Refuses a region that leaves the buffer, a base
// off the layout's grid, a buffer that is not 16-byte aligned or more rows
// than 32-bit row indices hold.  Returns cudaGetLastError().
extern "C" int cube_pack_launch(const float* d, float* buf, int B, int n,
                                int H, int W, int ls, long long rows_total,
                                long long base, void* stream) {
  static_assert(THREADS / 32 == ROWS, "one warp writes one image row");
  if (B < 1 || B > 65535 || n < 1 || n > 32 || H < 1 || W < 1 || ls < 0 || ls > 20 ||
      d == nullptr || buf == nullptr || ((uintptr_t)buf & 15) != 0 || rows_total > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int sw = LANES / n, stride = sw - 3;
  if (stride < 1) return (int)cudaErrorInvalidValue;
  const int wi = W - 2 > 1 ? W - 2 : 1;
  const int nbp = (wi + stride - 1) / stride;
  const long long st = 1LL << ls;
  const long long hpad = (H + st - 1) / st * st;
  const long long nrows = hpad * nbp;
  if (base < 0 || base % (nbp * st) != 0 || base + nrows > rows_total)
    return (int)cudaErrorInvalidValue;
  int nbc, nchunks;
  chunking(n, nbp, stride, &nbc, &nchunks);
  const int cw = tile_width(nbc, stride);
  const long long groups = (hpad + ROWS - 1) / ROWS;
  if ((long long)n * ROWS * cw > TILE_FLOATS || groups > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nchunks, (unsigned)groups, (unsigned)B);
  const size_t smem = (size_t)n * ROWS * cw * sizeof(float);
  const bool vec = W % 4 == 0 && ((uintptr_t)d & 15) == 0;
  if (vec)
    cube_pack_kernel<4><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        d, buf, n, H, W, nbp, stride, sw, ls, (int)hpad, nbc, cw, (int)rows_total, (int)base);
  else
    cube_pack_kernel<1><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        d, buf, n, H, W, nbp, stride, sw, ls, (int)hpad, nbc, cw, (int)rows_total, (int)base);
  return (int)cudaGetLastError();
}
