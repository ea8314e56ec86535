// Kernels A, C and F: the octave of the SIFT pyramid, for Hopper (sm_90a).
// One kernel template, three modes that share every arithmetic instruction
// and differ only in what they store.
//
// Kernel A (octave_front_launch) replaces the TPU kernel
// sift_tpu/ops/pallas_pyramid.py::fused_octave_front (:240, body
// _octave_front_kernel :148-200).  Per octave, from the seed image
// (B, H, W) f32 it writes
//   gauss  (B, n+1, H, W)   the seed and n chained separable blurs
//   dog    (B, n,   H, W)   gauss[i+1] - gauss[i]
//   mask   (B, n-2, H, nbm*128) f32 0/1: |c| > thr and c >= or <= all 27
//          values of its 3x3x3 window (centre included), interior only,
//          lanes >= W zero
//   counts (B, n-2, H, nbm) int32: popcount of each 128-lane mask block.
//
// Kernel F (octave_front_twin_launch) replaces
// sift_tpu/ops/pallas_pyramid.py::fused_octave_front_twin (:513, call :611,
// body _octave_front_twin_kernel :346-458): the same values, but no plain
// stack is written.  Gauss layers [g_l0, g_l0 + g_nl) go out as twin-block
// rows in the strip-major / layer-minor order into a gather buffer gbuf
// (B, G, 2*blk) shared by all octaves (gather.MultiRows with nls): layer s,
// image row y, block b = columns [b*blk, (b+2)*blk), at row
//   gbase + ((((y >> ls) * g_nl + s - g_l0) * nbt + b) << ls) + (y & (st-1))
// so every value is stored twice, in block x / blk and, where that is >= 1,
// in the second half of the block before it.  DoGs go out cube-packed into
// a shared buffer pkbuf (B, P, 128) (gather.CubeRows): layer k, row y,
// column x at lane k*sw + (x + 1 - cb*stride) of row
//   pkbase + (((y >> ls) * nbp + cb) << ls) + (y & (st-1)),
// cb = (x + 1) / stride, and also in block cb - 1 where the windows overlap
// (the first sw - stride = 3 lanes of a block); a block outside [0, nbp-1]
// is skipped.  mask and counts are A's; gauss[n-2] goes out plain as
// ``down`` (B, H, W), the next octave's seed.  The strip st = 1 << ls is a
// parameter of the layout (the gathers must use the same one) and has
// nothing to do with the CTA's tile.  The kernel writes only in-image
// values: lanes past the image, rows past H and unused lanes are whatever
// the buffers held (the wrapper hands in zeros).  The u-row-unit view of
// the TPU kernel is the same bytes in a contiguous buffer, and its
// create/alias modes are Mosaic devices: neither has a counterpart here.
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
// version (and kernels A, C and F to each other), and mask and counts
// (exact functions of the DoGs) equal too.
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
// pixel at n = 5: memory-bound in principle.  F writes 2 * g_nl twin
// planes, 128 / stride packed lanes per pixel column, the mask planes and
// ``down``: about as many bytes as A at n = 5, g_nl = 3, but as two
// scattered copies of each value (runs of up to blk, or stride, floats).  In this first version the
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

// Where kernel F stores: the two shared gather buffers and their layouts.
struct TwinParams {
  float* gbuf;   // (B, g_rows, 2 * blk)
  float* pkbuf;  // (B, pk_rows, 128)
  float* down;   // (B, H, W)
  long long g_rows, gbase, pk_rows, pkbase;
  int ls;                // log2 of the layouts' row strip
  int blk, nbt;          // twin block width, blocks per image row
  int g_l0, g_nl;        // stored gauss layers [g_l0, g_l0 + g_nl)
  int stride, sw, nbp;   // packed layout (gather.cube_rows_params)
};

enum { MODE_BLUR = 0, MODE_FRONT = 1, MODE_TWIN = 2 };

// Kernel F's store of gauss layer ``layer`` at (y, x): both twin blocks.
__device__ __forceinline__ void store_twin(const TwinParams& t, size_t b,
                                           int layer, int y, int x, float v) {
  if (layer < t.g_l0 || layer >= t.g_l0 + t.g_nl) return;
  const int bk = x / t.blk, c = x - bk * t.blk;
  const long long group =
      ((long long)(y >> t.ls) * t.g_nl + (layer - t.g_l0)) * t.nbt;
  const long long in_strip = y & ((1 << t.ls) - 1);
  float* img = t.gbuf + b * (size_t)t.g_rows * (2 * t.blk);
  const long long row = t.gbase + ((group + bk) << t.ls) + in_strip;
  img[(size_t)row * (2 * t.blk) + c] = v;
  if (bk >= 1)
    img[(size_t)(row - (1LL << t.ls)) * (2 * t.blk) + t.blk + c] = v;
}

// Kernel F's store of DoG layer ``k`` at (y, x): its packed block and, in
// the overlap, the block before it.
__device__ __forceinline__ void store_packed(const TwinParams& t, size_t b,
                                             int k, int y, int x, float v) {
  const int cb = (x + 1) / t.stride, j = x + 1 - cb * t.stride;
  const long long in_strip = y & ((1 << t.ls) - 1);
  const long long strip0 = (long long)(y >> t.ls) * t.nbp;
  float* img = t.pkbuf + b * (size_t)t.pk_rows * 128;
  if (cb < t.nbp) {
    const long long row = t.pkbase + ((strip0 + cb) << t.ls) + in_strip;
    img[(size_t)row * 128 + k * t.sw + j] = v;
  }
  if (cb >= 1 && cb - 1 < t.nbp && j + t.stride < t.sw) {
    const long long row = t.pkbase + ((strip0 + cb - 1) << t.ls) + in_strip;
    img[(size_t)row * 128 + k * t.sw + j + t.stride] = v;
  }
}

// kMode: MODE_BLUR kernel C (gauss + dog only), MODE_FRONT kernel A (and
// mask + counts), MODE_TWIN kernel F (A's values in the gather layouts).
template <int kMode>
__global__ void __launch_bounds__(NTHREADS)
octave_kernel(const float* __restrict__ seed, float* __restrict__ gauss,
              float* __restrict__ dog, float* __restrict__ mask,
              int* __restrict__ counts, const FrontParams p,
              const TwinParams tw) {
  constexpr bool kMask = kMode != MODE_BLUR;
  constexpr bool kTwin = kMode == MODE_TWIN;
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
      if (y >= y0 && y < y1 && x >= x0 && x < x1) {
        if (kTwin)
          store_twin(tw, b, 0, y, x, v);
        else
          gb[(size_t)y * W + x] = v;
      }
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
          if (kTwin) {
            store_twin(tw, b, k + 1, y, x, g);
            store_packed(tw, b, k, y, x, d);
            if (k + 1 == n - 2) tw.down[(size_t)b * plane + (size_t)y * W + x] = g;
          } else {
            gb[(size_t)(k + 1) * plane + (size_t)y * W + x] = g;
            db[(size_t)k * plane + (size_t)y * W + x] = d;
          }
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
template <int kMode>
static int launch(const float* seed, float* gauss, float* dog, float* mask,
                  int* counts, int B, int H, int W, int n, const float* taps,
                  const int* ntaps, const float* sum_w, float thr,
                  const TwinParams& tw, void* stream) {
  constexpr bool kMask = kMode != MODE_BLUR;
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
      octave_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.nbm, (H + TILE_H - 1) / TILE_H, B);
  octave_kernel<kMode><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      seed, gauss, dog, mask, counts, p, tw);
  return (int)cudaGetLastError();
}

// Kernel A: gauss, dog, mask, counts.
extern "C" int octave_front_launch(const float* seed, float* gauss, float* dog,
                                   float* mask, int* counts, int B, int H,
                                   int W, int n, const float* taps,
                                   const int* ntaps, const float* sum_w,
                                   float thr, void* stream) {
  TwinParams tw;
  memset(&tw, 0, sizeof(tw));
  return launch<MODE_FRONT>(seed, gauss, dog, mask, counts, B, H, W, n, taps,
                            ntaps, sum_w, thr, tw, stream);
}

// Kernel C: gauss and dog only.
extern "C" int octave_blur_launch(const float* seed, float* gauss, float* dog,
                                  int B, int H, int W, int n,
                                  const float* taps, const int* ntaps,
                                  const float* sum_w, void* stream) {
  TwinParams tw;
  memset(&tw, 0, sizeof(tw));
  return launch<MODE_BLUR>(seed, gauss, dog, nullptr, nullptr, B, H, W, n,
                           taps, ntaps, sum_w, 0.0f, tw, stream);
}

// Kernel F: gauss layers [g_l0, g_l0 + g_nl) as twin rows into gbuf
// (B, g_rows, 2 * blk) from row gbase, DoGs cube-packed into pkbuf
// (B, pk_rows, 128) from row pkbase, both in strips of 1 << ls rows; mask,
// counts; down (B, H, W).  Each base must be a multiple of its layout's rows
// per strip, and the octave's region must lie inside its buffer.
extern "C" int octave_front_twin_launch(
    const float* seed, float* gbuf, float* pkbuf, float* mask, int* counts,
    float* down, int B, int H, int W, int n, const float* taps,
    const int* ntaps, const float* sum_w, float thr, long long g_rows,
    long long gbase, int ls, int blk, int g_l0, int g_nl, long long pk_rows,
    long long pkbase, void* stream) {
  if (n < 3 || n > MAX_LAYERS || H < 1 || W < 1 || ls < 0 || ls > 20 ||
      blk < 1 || g_l0 < 0 || g_nl < 0 || g_l0 + g_nl > n + 1)
    return (int)cudaErrorInvalidValue;
  TwinParams tw;
  memset(&tw, 0, sizeof(tw));
  tw.gbuf = gbuf;
  tw.pkbuf = pkbuf;
  tw.down = down;
  tw.g_rows = g_rows;
  tw.gbase = gbase;
  tw.pk_rows = pk_rows;
  tw.pkbase = pkbase;
  tw.ls = ls;
  tw.blk = blk;
  tw.nbt = (W + blk - 1) / blk;
  tw.g_l0 = g_l0;
  tw.g_nl = g_nl;
  tw.sw = 128 / n;
  tw.stride = tw.sw - 3;
  const int wi = W - 2 > 1 ? W - 2 : 1;
  tw.nbp = (wi + tw.stride - 1) / tw.stride;
  const long long st = 1LL << ls, nstrips = (H + st - 1) / st;
  const long long g_unit = (long long)g_nl * tw.nbt * st;
  const long long pk_unit = (long long)tw.nbp * st;
  if (gbase < 0 || (g_unit > 0 && gbase % g_unit != 0) ||
      gbase + nstrips * g_unit > g_rows || pkbase < 0 ||
      pkbase % pk_unit != 0 || pkbase + nstrips * pk_unit > pk_rows)
    return (int)cudaErrorInvalidValue;
  return launch<MODE_TWIN>(seed, nullptr, nullptr, mask, counts, B, H, W, n,
                           taps, ntaps, sum_w, thr, tw, stream);
}
