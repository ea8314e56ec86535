// Kernels E and H: twin-block rows, for Hopper (sm_90a).  One kernel, one
// launch per gather space.
//
// Kernel E replaces the TPU kernel sift_tpu/ops/pallas_relayout.py::twin_rows_strips
// (:135; pallas_call :102, body _twin_strips_kernel :89-95), kernel H
// ::twin_rows_2d (:29; pallas_call :48, body _twin_kernel :23-26).  Both
// write twin rows: in a region of the buffer out (B, rt, 2 * blk) f32, row
// (r, b) holds columns [b * blk, (b + 2) * blk) of flat row r of the
// region's source (B, R, W) f32, zero past W, and sits at
//
//   base + (((r >> ls) * nb + b) << ls) + (r & ((1 << ls) - 1))
//
// for every r < rpad and b < nb = ceil(W / blk); rows R..rpad-1 are zeros.
// E's strip-interleaved order has strips of 1 << ls rows (rpad = R rounded
// up to a strip); H's row-major order is the same with ls = 0 (row
// base + r * nb + b, rpad = R).  A launch takes a table of regions by value
// (at most MAX_REGIONS): E one per octave of a batch's stacks, H one per
// volume (B = 1), and each alignment gap between E's octaves as a region
// with no source rows (R = 0, nb = 1, ls = 0: rpad rows of zeros).  The
// wrappers (sift_tpu_torch/ops/twin_rows.py) build the table so that the
// regions tile the buffer: every row is written exactly once, and the
// buffer is allocated with torch.empty.  Pure data movement, bit-equal to
// the plain versions twin_rows_strips_plain / twin_rows_2d_plain.
//
// Design.  A work unit (one CTA of 8 warps) is ROWS consecutive flat rows of
// one region of one image and a chunk of nbc blocks [b0, b0 + nbc).  The
// CTA finds its region once, by a binary search over the table's prefix
// of units (``first``), and splits its unit with one 32-bit division.
// Warp j stages row r0 + j, columns [b0 * blk, (b0 + nbc + 1) * blk),
// into shared memory with cp.async (16 bytes where W % 4 == 0 and the
// source is aligned, else 4), zeros past W and past R stored directly; so
// each input float is read once from HBM (the one block where two chunks
// meet, twice).  Then each warp writes whole twin rows from the tile with
// 16-byte streaming stores (__stcs), 512 bytes a warp instruction at blk
// 64.  16-byte stores from registers rather than one cp.async.bulk per
// run: a twin row is a contiguous slice of a staged row, but E's runs
// (ROWS twin rows of one block) come from ROWS different staged rows, so a
// bulk store would need the output laid out in shared memory first, twice
// the tile, for stores that are already whole 32-byte sectors.  With ROWS
// dividing every strip (strips are >= 8 rows), a unit writes in E's order
// nbc runs of ROWS * 2 * blk contiguous floats, in H's order with one
// chunk ROWS * nb contiguous twin rows.  Threads do 32-bit index math; the
// 64-bit products are one per staged row and per twin row.
//
// What bounds it: bytes.  It reads B * R * W floats per region and writes
// the whole buffer, B * rt * 2 * blk floats (about twice the input), and
// does no arithmetic beyond the index math.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define ROWS 8            // flat rows of a work unit (one warp each)
#define THREADS 256
#define TILE_FLOATS 12288 // staged floats of a unit at most (48 KB)
#define MAX_REGIONS 64    // regions a launch takes
#define MAX_BLK 128
#define FIELDS 9          // ints per region in the launcher's table

struct Region {
  const float* src;  // (B, R, W), or null for a region of zeros
  int R, W, nb, ls, rpad, base, nbc, nchunks, first, vec;
};

struct Table {
  Region r[MAX_REGIONS];
  int n;
};

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g));
}

// VEC 4: 16-byte shared reads and stores (blk % 4 == 0, out aligned); 1:
// 4-byte.  grid (units, B), THREADS threads, ROWS * (nbc + 1) * blk floats
// of dynamic shared memory (the most of any region).
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    twin_rows_kernel(const __grid_constant__ Table t, float* __restrict__ out, int blk,
                     long long image_floats) {
  extern __shared__ __align__(16) float tile[];
  const int u = blockIdx.x;
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.r[mid].first <= u) lo = mid;
    else hi = mid - 1;
  }
  const Region& e = t.r[lo];
  const int v = u - e.first;
  const int g = v / e.nchunks;
  const int b0 = (v - g * e.nchunks) * e.nbc;
  const int r0 = g * ROWS;
  const int nbc = min(e.nbc, e.nb - b0);
  const int cw = (nbc + 1) * blk;  // staged columns
  const int x0 = b0 * blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bi = blockIdx.y;

  // Stage: warp j takes flat row r0 + j (THREADS / 32 == ROWS).
  {
    const int j = warp;
    float* trow = tile + j * cw;
    const int r = r0 + j;
    const int n = r < e.R ? min(cw, e.W - x0) : 0;  // source columns
    const float* srow = n > 0 ? e.src + (bi * e.R + r) * (size_t)e.W + x0 : nullptr;
    if (VEC == 4 && e.vec) {
      for (int c = lane * 4; c < cw; c += 128) {
        if (c < n) cp_async16(trow + c, srow + c);
        else *reinterpret_cast<float4*>(trow + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int c = lane; c < cw; c += 32) {
        if (c < n) cp_async4(trow + c, srow + c);
        else trow[c] = 0.0f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Write: twin row tr = bb * ROWS + j is block b0 + bb of flat row r0 + j.
  const int twin = 2 * blk;
  const int mask = (1 << e.ls) - 1;
  float* img = out + bi * (size_t)image_floats;
  for (int tr = warp; tr < ROWS * nbc; tr += THREADS / 32) {
    const int j = tr % ROWS, bb = tr / ROWS;
    const int r = r0 + j;
    if (r >= e.rpad) continue;
    const int row = e.base + ((((r >> e.ls) * e.nb + b0 + bb) << e.ls) + (r & mask));
    float* orow = img + (size_t)row * twin;
    const float* s = tile + j * cw + bb * blk;
    if (VEC == 4) {
      for (int c = lane * 4; c < twin; c += 128)
        __stcs(reinterpret_cast<float4*>(orow + c), *reinterpret_cast<const float4*>(s + c));
    } else {
      for (int c = lane; c < twin; c += 32) __stcs(orow + c, s[c]);
    }
  }
}

// One launch over n regions.  ``regions`` holds FIELDS ints per region (R,
// W, nb, ls, rpad, base, nbc, nchunks, first: ``first`` the running sum of
// the units ceil(rpad / ROWS) * nchunks of the regions before), ``srcs`` a
// (B, R, W) float32 pointer per region (null where R == 0); out is (B, rt,
// 2 * blk).  Refuses a table whose regions leave the buffer or more than
// MAX_REGIONS regions.  Returns cudaGetLastError().
extern "C" int twin_rows_launch(const int* regions, const float* const* srcs, int n,
                                float* out, int B, int blk, long long rt, void* stream) {
  if (n < 1 || n > MAX_REGIONS || B < 1 || B > 65535 || blk < 1 || blk > MAX_BLK || rt < 1 ||
      rt > INT_MAX || out == nullptr)
    return (int)cudaErrorInvalidValue;
  static_assert(THREADS / 32 == ROWS, "one warp stages one row");
  Table t;
  t.n = n;
  const bool vec = blk % 4 == 0 && ((uintptr_t)out & 15) == 0;
  long long units = 0;
  int tile_floats = 0;
  for (int i = 0; i < n; ++i) {
    const int* f = regions + FIELDS * i;
    Region& e = t.r[i];
    e.src = srcs[i];
    e.R = f[0], e.W = f[1], e.nb = f[2], e.ls = f[3], e.rpad = f[4], e.base = f[5];
    e.nbc = f[6], e.nchunks = f[7], e.first = f[8];
    const bool ok =
        e.R >= 0 && e.R <= e.rpad && e.nb >= 1 && e.ls >= 0 && e.ls <= 20 &&
        e.rpad % (1 << e.ls) == 0 && e.base >= 0 && e.nbc >= 1 && e.nchunks >= 1 &&
        (long long)e.nbc * e.nchunks >= e.nb && (long long)(e.nchunks - 1) * e.nbc < e.nb &&
        e.first == units && e.base + (long long)e.nb * e.rpad <= rt &&
        (long long)ROWS * (e.nbc + 1) * blk <= TILE_FLOATS &&
        (e.R == 0 || (e.src != nullptr && e.W >= 1 && e.nb == (e.W + blk - 1) / blk));
    if (!ok) return (int)cudaErrorInvalidValue;
    e.vec = vec && e.W % 4 == 0 && ((uintptr_t)e.src & 15) == 0;
    units += (long long)((e.rpad + ROWS - 1) / ROWS) * e.nchunks;
    const int tf = ROWS * (e.nbc + 1) * blk;
    tile_floats = tf > tile_floats ? tf : tile_floats;
  }
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)units, (unsigned)B);
  const size_t smem = (size_t)tile_floats * sizeof(float);
  const long long image_floats = rt * 2 * blk;
  if (vec)
    twin_rows_kernel<4><<<grid, THREADS, smem, (cudaStream_t)stream>>>(t, out, blk, image_floats);
  else
    twin_rows_kernel<1><<<grid, THREADS, smem, (cudaStream_t)stream>>>(t, out, blk, image_floats);
  return (int)cudaGetLastError();
}
