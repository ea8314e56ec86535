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
// Design: a rolling row window.  One CTA owns one 128-column tile of one
// image over a tall row strip and walks down it, a batch of rows a step
// (BATCH_ROWS = 12, or the most whose rings fit shared memory where a
// chain's radii are larger); each row of the batch belongs to WARPS_PER_ROW
// (2) warps, which split its column groups (columns lane + 32 i), so a CTA
// has 24 warps at the default radii.
// Shared memory holds, per blur layer k = 1..n (radius r_k), a ring of the
// last 2 r_k + batch rows of that layer's horizontal pass; per gauss
// layer k = 0..n-1 the last r_{k+1} + batch rows (DoG k's earlier
// operand waits there for gauss k+1); for A and F, per DoG layer j the last
// r_{j+2} + r_{j+3} + batch + 2 rows, 130 columns wide (mask layer j+1
// waits for DoG j+2).  A ring row is addressed by (row % depth), computed
// with one multiply by the ring's magic number; a tap's row is clamped to
// [0, H-1] first and mapped to its slot second, so an image shorter than a
// ring works like any other.  gauss k's rows are as wide as the tile plus
// ext_k = r_{k+1} + ... + r_n (+1 for the mask) columns on both sides.  A
// column outside the image holds its border column's value (computed at
// the clamped column), so the horizontal pass clamps once per output and
// not per tap, and the vertical pass not at all in x.
//
// A step is n + 1 sub-phases with one __syncthreads() each:
//   0: the mask rows whose three DoG layers exist (one row and layer per
//      warp: column extremes of the 9 rows, neighbours by shuffle, the
//      popcount by ballot, so counts need neither shared memory nor
//      atomics); then a batch of seed rows into gauss 0's ring (read from
//      device memory into registers a step earlier), the row's warps going
//      on, after a barrier of their own, to layer 1's horizontal pass;
//   k: the rows of gauss k whose taps exist (at most a batch): vertical
//      pass from ring k, DoG k-1 against gauss k-1's ring, the stores, and
//      layer k+1's horizontal pass of the same row by the same warps.
// So every gauss row is computed once per strip (not once per 32-row
// tile), all warps of a sub-phase do the same layer (equal work), and a
// lane carries up to 4 independent accumulators.  Which rows a sub-phase
// computes follows from the streams' progress, the same numbers in every
// warp (stream k in lane k's registers, read by shuffle) and settled one
// sub-phase ahead.  The row schedule, ring by ring, is spelled out in plain
// PyTorch in ops/octave_rolling.py (octave_rolling_plain), which the CPU
// tests hold against the plain version; the constants and the strip rule
// below are mirrored there.
//
// Shared memory at the default radii 4, 5, 6, 8, 10: horizontal rings
// 20+22+24+28+32 rows, gauss rings 16+17+18+20+22, DoG rings 25+28+32+24+14,
// at pitches 196..130 floats: 208,664 bytes for A and F, 142,952 for C
// (+256 of tail padding): one CTA of 768 threads per SM for all three.
// ptxas (CUDA 12.8, sm_90a): 80 registers for A and F, 75 for C, no spills.
//
// What bounds them: the mandatory traffic is one seed read and (n+1)+n
// output planes (A: + (n-2) mask planes) written, 48 (A: ~60) bytes per
// pixel at n = 5: memory-bound in principle.  F writes 2 * g_nl twin
// planes, 128 / stride packed lanes per pixel column, the mask planes and
// ``down``: about as many bytes as A at n = 5, g_nl = 3, but as two
// scattered copies of each value (runs of up to blk, or stride, floats).
// In practice the kernels are bound by instruction throughput, about half of it
// outside the taps: per output and pass an IEEE division, the ring and
// output stores with their bounds, F's block arithmetic, and per row and
// warp the ring addresses; the taps cost two shared loads, add, multiply,
// add and a share of the slot arithmetic each, times the redundant halo
// work (columns: (128 + 2 ext_k) / 128; rows: the strip's warm-up rows).
// Timings, and what was tried: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MAX_LAYERS 8
#define MAX_TAPS 16
#define TILE_W 128
// BATCH_ROWS and WARPS_PER_ROW can be set with -D, and the TUNE_* switches
// below cut a part of the work out (wrong results, for timing only):
// scripts/tune_octave_front.py builds and times such variants.
#ifndef BATCH_ROWS
#define BATCH_ROWS 12    // rows per step, at most: fewer where the rings would not fit
#endif
#ifndef WARPS_PER_ROW
#define WARPS_PER_ROW 2  // warps that share a row of the batch, by column groups
#endif
#define NWARPS (BATCH_ROWS * WARPS_PER_ROW)
#define NTHREADS (32 * NWARPS)
static_assert(NTHREADS <= 1024, "a CTA has at most 1024 threads");
static_assert(WARPS_PER_ROW == 1 || BATCH_ROWS <= 15, "a row's warps meet at named barrier 1 + row");
#define PREFETCH 8       // seed column groups a warp holds in registers
#define SM_COUNT 132   // the strip rule's estimate of the card
#define FILL_ROWS 16   // the strip rule's allowance for the pipeline's fill
#define MIN_STRIP 32
#define SMEM_LIMIT 232448
#define TAIL_PAD 64    // floats past the last ring: idle lanes read, never store

struct FrontParams {
  float taps[MAX_LAYERS + 1][MAX_TAPS];  // [k] = layer k's one-sided taps, k = 1..n
  float sum_w[MAX_LAYERS + 1];
  int rad[MAX_LAYERS + 1];               // r_k
  int ext[MAX_LAYERS + 1];               // halo of gauss k, k = 0..n
  int h_off[MAX_LAYERS + 1], h_depth[MAX_LAYERS + 1];  // ring of layer k's horizontal pass
  int g_off[MAX_LAYERS + 1], g_depth[MAX_LAYERS + 1];  // ring of gauss k, k = 0..n-1
  int d_off[MAX_LAYERS + 1], d_depth[MAX_LAYERS + 1];  // ring of DoG j, j = 0..n-1
  // floor(2^32 / depth) + 1 of each ring: row % depth without a division.
  unsigned h_magic[MAX_LAYERS + 1], g_magic[MAX_LAYERS + 1], d_magic[MAX_LAYERS + 1];
  int n;       // blur layers
  int H, W, nbm, wpad;
  int strip;   // rows of a CTA's strip
  int batch;   // rows per step: the CTA has batch * WARPS_PER_ROW warps
  float thr;
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
  // floor(2^32 / blk) + 1 and floor(2^32 / stride) + 1: x / blk and
  // (x + 1) / stride as one multiply (exact while x * divisor < 2^32).
  unsigned blk_magic, stride_magic;
};

enum { MODE_BLUR = 0, MODE_FRONT = 1, MODE_TWIN = 2 };

// Kernel F's stores, a row at a time: ``row`` points at the row's first
// block (twin block 0 of gauss layer ``layer``, or packed block 0 at DoG
// layer k's lanes) and ``step`` is the distance in floats to the next
// block's row, so that an element costs one multiply for its block number.
struct BlockRow {
  float* row;      // nullptr: the layer is not stored
  long long step;
};

__device__ __forceinline__ BlockRow twin_row(const TwinParams& t, size_t b, int layer, int y) {
  BlockRow r;
  r.step = (long long)(2 * t.blk) << t.ls;
  if (layer < t.g_l0 || layer >= t.g_l0 + t.g_nl) {
    r.row = nullptr;
    return r;
  }
  const long long group = ((long long)(y >> t.ls) * t.g_nl + (layer - t.g_l0)) * t.nbt;
  const long long row = t.gbase + (group << t.ls) + (y & ((1 << t.ls) - 1));
  r.row = t.gbuf + (b * (size_t)t.g_rows + (size_t)row) * (2 * t.blk);
  return r;
}

// Gauss value v at column x: its own twin block and, from block 1 on, the
// second half of the block before it.
__device__ __forceinline__ void twin_put(const TwinParams& t, const BlockRow& r, int x, float v) {
  const int bk = (int)__umulhi((unsigned)x, t.blk_magic), c = x - bk * t.blk;
  float* q = r.row + bk * r.step + c;
  *q = v;
  if (bk >= 1) q[t.blk - r.step] = v;
}

__device__ __forceinline__ BlockRow packed_row(const TwinParams& t, size_t b, int k, int y) {
  BlockRow r;
  r.step = 128LL << t.ls;
  const long long row = t.pkbase + (((long long)(y >> t.ls) * t.nbp) << t.ls) + (y & ((1 << t.ls) - 1));
  r.row = t.pkbuf + (b * (size_t)t.pk_rows + (size_t)row) * 128 + k * t.sw;
  return r;
}

// DoG value v at column x: its packed block and, in the overlap, the block
// before it; a block outside [0, nbp - 1] is skipped.
__device__ __forceinline__ void packed_put(const TwinParams& t, const BlockRow& r, int x, float v) {
  const int cb = (int)__umulhi((unsigned)(x + 1), t.stride_magic), j = x + 1 - cb * t.stride;
  float* q = r.row + cb * r.step + j;
  if (cb < t.nbp) *q = v;
  if (cb >= 1 && cb - 1 < t.nbp && j + t.stride < t.sw) q[t.stride - r.step] = v;
}

#define PITCH(p, k) (TILE_W + 2 * (p).ext[k])  // of gauss k's and layer k's rings
#define D_PITCH (TILE_W + 2)                    // of the DoG rings
#define MAX_ROWS (1 << 20)  // slot_of is exact while row * depth < 2^32

// row % depth, by the ring's magic number floor(2^32 / depth) + 1.
__device__ __forceinline__ int slot_of(int row, int depth, unsigned magic) {
  return row - depth * (int)__umulhi((unsigned)row, magic);
}

// Horizontal pass of layer k over NG column groups (columns cb + 32 i) of
// one row: src is gauss k-1's ring row (its first column is image column
// src_x0), dst layer k's (first column xv0).  s[i] points at the output's
// own column, clamped to the image, so the taps need no clamp.
template <int NG>
__device__ __forceinline__ void hpass_groups(const float* __restrict__ src,
                                             float* __restrict__ dst,
                                             const float* __restrict__ tp, float sw,
                                             int r, int cb, int width, int xv0,
                                             int W, int src_x0) {
  const float* s[NG];
  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int xc = min(max(xv0 + cb + 32 * i, 0), W - 1);
    s[i] = src + (xc - src_x0);
    acc[i] = __fmul_rn(s[i][0], tp[0]);
  }
#pragma unroll 2
  for (int u = 1; u <= r; ++u) {
    const float t = tp[u];
#pragma unroll
    for (int i = 0; i < NG; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(t, __fadd_rn(s[i][u], s[i][-u])));
  }
#pragma unroll
  for (int i = 0; i < NG; ++i)
#ifdef TUNE_NO_DIV
    if (cb + 32 * i < width) dst[cb + 32 * i] = acc[i] * sw;
#else
    if (cb + 32 * i < width) dst[cb + 32 * i] = __fdiv_rn(acc[i], sw);
#endif
}

// Vertical pass of layer k over NG column groups of row y: ring is layer
// k's horizontal-pass ring (slot sy holds row y).  Tap rows clamp to
// [0, H-1] before they are mapped to a slot.
template <int NG>
__device__ __forceinline__ void vpass_groups(const float* __restrict__ ring, int pitch,
                                             int depth, int sy, int y, int H,
                                             const float* __restrict__ tp, float sw,
                                             int r, int cb, float* g) {
  const float* c = ring + cb;
  float acc[NG];
  {
    const float* row = c + sy * pitch;
#pragma unroll
    for (int i = 0; i < NG; ++i) acc[i] = __fmul_rn(row[32 * i], tp[0]);
  }
#pragma unroll 2
  for (int u = 1; u <= r; ++u) {
    int sp = sy + (min(y + u, H - 1) - y);
    if (sp >= depth) sp -= depth;
    int sm = sy - (y - max(y - u, 0));
    if (sm < 0) sm += depth;
    const float* rp = c + sp * pitch;
    const float* rm = c + sm * pitch;
    const float t = tp[u];
#pragma unroll
    for (int i = 0; i < NG; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(t, __fadd_rn(rp[32 * i], rm[32 * i])));
  }
#pragma unroll
#ifdef TUNE_NO_DIV
  for (int i = 0; i < NG; ++i) g[i] = acc[i] * sw;
#else
  for (int i = 0; i < NG; ++i) g[i] = __fdiv_rn(acc[i], sw);
#endif
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

  const int H = p.H, W = p.W, n = p.n;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W, x1 = min(x0 + TILE_W, W), twd = x1 - x0;
  const int ys = blockIdx.y * p.strip, ye = min(ys + p.strip, H);
  const size_t plane = (size_t)H * W;
  const float* src = seed + (size_t)b * plane;
  float* gb = kTwin ? nullptr : gauss + (size_t)b * (n + 1) * plane;
  float* db = kTwin ? nullptr : dog + (size_t)b * n * plane;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_i = warp / WARPS_PER_ROW, part = warp % WARPS_PER_ROW;
  const int batch = p.batch, nwarps = batch * WARPS_PER_ROW;

  // The warps of a row meet (after the row's gauss values are in shared
  // memory, before its horizontal pass reads them).
  auto row_sync = [&]() {
    if (WARPS_PER_ROW == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(1 + row_i), "r"(32 * WARPS_PER_ROW) : "memory");
  };
  // This warp's column groups [g0, g1) of a row ``width`` columns wide.
  auto my_groups = [&](int width, int& g0, int& g1) {
    const int groups = (width + 31) >> 5, per = (groups + WARPS_PER_ROW - 1) / WARPS_PER_ROW;
    g0 = part * per;
    g1 = min(groups, g0 + per);
  };

  // Progress of every stream, the same numbers in every warp, stream k in
  // lane k's registers (read by shuffle: no local memory): the next row of
  // gauss k, the end of its rows, the next row of mask layer k.
  const unsigned full = 0xffffffffu;
  const int my_ext = p.ext[min(lane, MAX_LAYERS)];
  int gn_l = max(0, ys - my_ext), mn_l = ys;
  const int hi_l = min(H, ye + my_ext);
  auto gn = [&](int k) { return __shfl_sync(full, gn_l, k); };
  auto hi = [&](int k) { return __shfl_sync(full, hi_l, k); };

  // Layer k's horizontal pass of row y, by the row's warps.
  auto hpass = [&](int k, int y) {
    const int width = twd + 2 * p.ext[k];
    const float* s = smem + p.g_off[k - 1] + slot_of(y, p.g_depth[k - 1], p.g_magic[k - 1]) * PITCH(p, k - 1);
    float* d = smem + p.h_off[k] + slot_of(y, p.h_depth[k], p.h_magic[k]) * PITCH(p, k);
    const float* tp = p.taps[k];
    const float sw = p.sum_w[k];
#ifdef TUNE_TAPS0
    const int r = 0, xv0 = x0 - p.ext[k], sx0 = x0 - p.ext[k - 1];
#else
    const int r = p.rad[k], xv0 = x0 - p.ext[k], sx0 = x0 - p.ext[k - 1];
#endif
    int gi, g1;
    my_groups(width, gi, g1);
    for (; gi + 4 <= g1; gi += 4)
      hpass_groups<4>(s, d, tp, sw, r, lane + 32 * gi, width, xv0, W, sx0);
    const int cb = lane + 32 * gi, left = g1 - gi;  // groups left, 0..3
    if (left == 1) hpass_groups<1>(s, d, tp, sw, r, cb, width, xv0, W, sx0);
    else if (left == 2) hpass_groups<2>(s, d, tp, sw, r, cb, width, xv0, W, sx0);
    else if (left == 3) hpass_groups<3>(s, d, tp, sw, r, cb, width, xv0, W, sx0);
  };

  // Row y of gauss k (k >= 1), by the row's warps.
  auto vpass = [&](int k, int y) {
    const int pitch = PITCH(p, k), depth = p.h_depth[k];
    const int e = p.ext[k], width = twd + 2 * e, shift = p.rad[k];
    const float* ring = smem + p.h_off[k];
    const float* tp = p.taps[k];
    const float sw = p.sum_w[k];
#ifdef TUNE_TAPS0
    const int r = 0, sy = slot_of(y, depth, p.h_magic[k]);
#else
    const int r = p.rad[k], sy = slot_of(y, depth, p.h_magic[k]);
#endif
    float* grow = k < n ? smem + p.g_off[k] + slot_of(y, p.g_depth[k], p.g_magic[k]) * pitch : nullptr;
    const float* prow = smem + p.g_off[k - 1] +
                        slot_of(y, p.g_depth[k - 1], p.g_magic[k - 1]) * PITCH(p, k - 1) + shift;
    float* drow = kMask ? smem + p.d_off[k - 1] +
                              slot_of(y, p.d_depth[k - 1], p.d_magic[k - 1]) * D_PITCH + (1 - e)
                        : nullptr;
    // The row's place in the output planes, indexed by ring column.
    const bool out_row = y >= ys && y < ye;
    const long long at = (long long)y * W + x0 - e;
    float* g_out = kTwin ? nullptr : gb + (size_t)k * plane + at;
    float* d_out = kTwin ? nullptr : db + (size_t)(k - 1) * plane + at;
    float* down = kTwin && k == n - 2 ? tw.down + (size_t)b * plane + at : nullptr;
    BlockRow trow, prow_pk;
    if (kTwin) {
      trow = twin_row(tw, b, k, y);
      prow_pk = packed_row(tw, b, k - 1, y);
    }
    // What becomes of gauss k at ring column col: its own ring, DoG k-1
    // against gauss k-1's ring, the stores, the mask's DoG ring.
    auto emit = [&](int col, float g) {
      if (col >= width) return;
      if (k < n) grow[col] = g;
      const float d = __fsub_rn(g, prow[col]);
      const unsigned c = (unsigned)(col - e);  // column in the tile, if below twd
#ifndef TUNE_NO_GSTORE
      if (out_row && c < (unsigned)twd) {
        if (kTwin) {
          if (trow.row) twin_put(tw, trow, x0 + (int)c, g);
          packed_put(tw, prow_pk, x0 + (int)c, d);
          if (down) down[col] = g;
        } else {
          g_out[col] = g;
          d_out[col] = d;
        }
      }
#endif
      if (kMask && c + 1u <= (unsigned)twd + 1u) drow[col] = d;  // tile columns -1..twd
    };
    float g[4];
    int gi, g1;
    my_groups(width, gi, g1);
    for (; gi + 4 <= g1; gi += 4) {
      vpass_groups<4>(ring, pitch, depth, sy, y, H, tp, sw, r, lane + 32 * gi, g);
#pragma unroll
      for (int i = 0; i < 4; ++i) emit(lane + 32 * (gi + i), g[i]);
    }
    const int cb = lane + 32 * gi, left = g1 - gi;  // groups left, 0..3
    if (left == 1) vpass_groups<1>(ring, pitch, depth, sy, y, H, tp, sw, r, cb, g);
    else if (left == 2) vpass_groups<2>(ring, pitch, depth, sy, y, H, tp, sw, r, cb, g);
    else if (left == 3) vpass_groups<3>(ring, pitch, depth, sy, y, H, tp, sw, r, cb, g);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < left) emit(cb + 32 * i, g[i]);
  };

  // Seed row y, in two halves so that device memory's latency is hidden
  // behind a whole step: seed_fetch reads this warp's column groups of the
  // row into registers (the first PREFETCH of them); seed_row, a step
  // later, puts them into gauss 0's ring and out as gauss layer 0.
  const int seed_w = twd + 2 * p.ext[0];
  int sg0, sg1;
  my_groups(seed_w, sg0, sg1);
  float pre[PREFETCH];
  auto seed_at = [&](int y, int col) {
    return src[(size_t)y * W + min(max(x0 - p.ext[0] + col, 0), W - 1)];
  };
  auto seed_fetch = [&](int y) {
#pragma unroll
    for (int i = 0; i < PREFETCH; ++i)
      if (sg0 + i < sg1) pre[i] = seed_at(y, lane + 32 * (sg0 + i));
  };
  BlockRow srow_tw;
  auto seed_put = [&](int y, int col, float v, float* grow) {
    if (col >= seed_w) return;
    grow[col] = v;
    const int x = x0 - p.ext[0] + col;
    if (y >= ys && y < ye && x >= x0 && x < x1) {
      if (kTwin) {
        if (srow_tw.row) twin_put(tw, srow_tw, x, v);
      } else {
        gb[(size_t)y * W + x] = v;
      }
    }
  };
  auto seed_row = [&](int y) {
    float* grow = smem + p.g_off[0] + slot_of(y, p.g_depth[0], p.g_magic[0]) * PITCH(p, 0);
    if (kTwin) srow_tw = twin_row(tw, b, 0, y);
#pragma unroll
    for (int i = 0; i < PREFETCH; ++i)
      if (sg0 + i < sg1) seed_put(y, lane + 32 * (sg0 + i), pre[i], grow);
    for (int gi = sg0 + PREFETCH; gi < sg1; ++gi)
      seed_put(y, lane + 32 * gi, seed_at(y, lane + 32 * gi), grow);
  };

  // Row y of mask layer z and its popcount, by one warp: the tile's 128
  // columns, lane + 32 i; ring column = tile column + 1.
  auto mask_row = [&](int z, int y) {
    float* mz = mask + (((size_t)b * (n - 2) + (z - 1)) * H + y) * p.wpad + x0;
    int total = 0;
    if (y < 1 || y > H - 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mz[lane + 32 * i] = 0.0f;
    } else {
      const float* rows[9];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int depth = p.d_depth[z - 1 + j];
        int s = slot_of(y - 1, depth, p.d_magic[z - 1 + j]);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          rows[3 * j + dy] = smem + p.d_off[z - 1 + j] + s * D_PITCH;
          if (++s == depth) s = 0;
        }
      }
      // Extremes of the 9 values of each column: the lane's four, and the
      // two columns beside the tile (lane 0: left, lane 1: right).
      float cmx[5], cmn[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int rc = i < 4 ? 1 + lane + 32 * i : (lane == 0 ? 0 : TILE_W + 1);
        float mx = rows[0][rc], mi = mx;
#pragma unroll
        for (int q = 1; q < 9; ++q) {
          const float v = rows[q][rc];
          mx = fmaxf(mx, v);
          mi = fminf(mi, v);
        }
        cmx[i] = mx;
        cmn[i] = mi;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lmx = __shfl_up_sync(full, cmx[i], 1), lmn = __shfl_up_sync(full, cmn[i], 1);
        float rmx = __shfl_down_sync(full, cmx[i], 1), rmn = __shfl_down_sync(full, cmn[i], 1);
        // The neighbour across a group's edge: lane 31 of the group before
        // (or the column left of the tile), lane 0 of the group after (or
        // the column right of the tile).
        const float pmx = i ? __shfl_sync(full, cmx[i - 1], 31) : __shfl_sync(full, cmx[4], 0);
        const float pmn = i ? __shfl_sync(full, cmn[i - 1], 31) : __shfl_sync(full, cmn[4], 0);
        const float nmx = i < 3 ? __shfl_sync(full, cmx[i + 1], 0) : __shfl_sync(full, cmx[4], 1);
        const float nmn = i < 3 ? __shfl_sync(full, cmn[i + 1], 0) : __shfl_sync(full, cmn[4], 1);
        if (lane == 0) { lmx = pmx; lmn = pmn; }
        if (lane == 31) { rmx = nmx; rmn = nmn; }
        const float mx = fmaxf(cmx[i], fmaxf(lmx, rmx));
        const float mi = fminf(cmn[i], fminf(lmn, rmn));
        const int x = x0 + lane + 32 * i;
        const float c = rows[4][1 + lane + 32 * i];
        const bool m = x >= 1 && x <= W - 2 && fabsf(c) > p.thr && (c >= mx || c <= mi);
        mz[lane + 32 * i] = m ? 1.0f : 0.0f;
        total += __popc(__ballot_sync(full, m));
      }
    }
    if (lane == 0)
      counts[(((size_t)b * (n - 2) + (z - 1)) * H + y) * p.nbm + blockIdx.x] = total;
  };

  {
    const int g0 = gn(0);
    if (row_i < min(batch, hi(0) - g0)) seed_fetch(g0 + row_i);
  }
  for (;;) {
    // Sub-phase 0: mask rows whose three DoG layers exist (a row and layer
    // per warp), then seed rows.
    bool done = gn(n) == hi(n);
    if (kMask) {
      for (int z = 1; z <= n - 2; ++z) {
        const int g2 = gn(z + 2), mz = __shfl_sync(full, mn_l, z);
        const int lim = g2 == hi(z + 2) ? ye : min(ye, g2 - 1);
        const int cnt = max(0, min(batch, lim - mz));
        const int i = (warp + z * batch) % nwarps;
#ifndef TUNE_NO_MASK
        if (i < cnt) mask_row(z, mz + i);
#endif
        if (lane == z) mn_l += cnt;
        done = done && mz + cnt == ye;
      }
    }
    if (done) break;
    // The rows of each sub-phase are settled a sub-phase ahead, so that the
    // bookkeeping overlaps the work before the barrier.
    int up = gn(0);               // gauss k-1's next row, after its update
    const int hi0 = hi(0);
    int cnt = min(batch, hi0 - up), y = up + row_i;
    up += cnt;
    if (lane == 0) gn_l = up;
    const int seed_next = up, seed_left = hi0 - up;
    bool up_done = up == hi0;
    int ncnt, ny;
    auto settle = [&](int k) {  // the rows of gauss k whose taps exist, at most a batch
      const int g = gn(k), h = hi(k);
      const int lim = up_done ? h : min(h, up - p.rad[k]);
      ncnt = max(0, min(batch, lim - g));
      ny = g + row_i;
      up = g + ncnt;
      up_done = up == h;
      if (lane == k) gn_l = up;
    };
    settle(1);
    if (row_i < cnt) {
      seed_row(y);
      row_sync();
      hpass(1, y);
    }
    if (row_i < min(batch, seed_left)) seed_fetch(seed_next + row_i);
    __syncthreads();
    // Sub-phase k: rows of gauss k, and layer k+1's horizontal pass of each.
    for (int k = 1; k <= n; ++k) {
      cnt = ncnt;
      y = ny;
      if (k < n) settle(k + 1);
      if (row_i < cnt) {
        vpass(k, y);
        if (k < n) {
          row_sync();
          hpass(k + 1, y);
        }
      }
      __syncthreads();
    }
  }
}

// Rows of a CTA's strip: of the strip counts whose strips are at least
// MIN_STRIP rows, the one with the least estimated time, (waves of CTAs
// over the SMs) x (rows a CTA walks: its strip, the warm-up rows on both
// sides and the pipeline's fill); the smaller count on a tie.
static int strip_rows_for(int B, int H, int W, int halo) {
  const long long tiles = (long long)((W + TILE_W - 1) / TILE_W) * B;
  long long best = -1;
  int best_rows = H;
  const int max_ns = H / MIN_STRIP > 1 ? H / MIN_STRIP : 1;
  for (int ns = 1; ns <= max_ns; ++ns) {
    const int rows = (H + ns - 1) / ns;
    const long long waves = (tiles * ns + SM_COUNT - 1) / SM_COUNT;
    const long long cost = waves * (rows + 2 * halo + FILL_ROWS);
    if (best < 0 || cost < best) {
      best = cost;
      best_rows = rows;
    }
  }
  return best_rows;
}

// Builds the parameter block from host arrays and launches on ``stream``.
// taps: n * MAX_TAPS floats (row k = layer k's one-sided taps), ntaps: n
// ints, sum_w: n floats.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a chain whose rings do not fit shared memory.
template <int kMode>
static int launch(const float* seed, float* gauss, float* dog, float* mask,
                  int* counts, int B, int H, int W, int n, const float* taps,
                  const int* ntaps, const float* sum_w, float thr,
                  const TwinParams& tw, void* stream) {
  constexpr bool kMask = kMode != MODE_BLUR;
  if (n < (kMask ? 3 : 1) || n > MAX_LAYERS || B < 1 || B > 65535 || H < 1 ||
      H > MAX_ROWS || W < 1)
    return (int)cudaErrorInvalidValue;
  FrontParams p;
  memset(&p, 0, sizeof(p));
  for (int k = 1; k <= n; ++k) {
    const int nt = ntaps[k - 1];
    if (nt < 1 || nt > MAX_TAPS) return (int)cudaErrorInvalidValue;
    p.rad[k] = nt - 1;
    p.sum_w[k] = sum_w[k - 1];
    for (int u = 0; u < nt; ++u) p.taps[k][u] = taps[(k - 1) * MAX_TAPS + u];
  }
  p.ext[n] = kMask ? 1 : 0;
  for (int k = n - 1; k >= 0; --k) p.ext[k] = p.ext[k + 1] + p.rad[k + 1];
  // The rings, one after the other (ops/octave_rolling.py ring_plan), at the
  // largest batch up to BATCH_ROWS whose rings fit shared memory.
  auto rad = [&](int k) { return k >= 1 && k <= n ? p.rad[k] : 0; };
  size_t smem = 0;
  for (p.batch = BATCH_ROWS; p.batch >= 1; --p.batch) {
    long long off = 0;
    auto ring = [&](int* at, int* depth, unsigned* magic, int rows, int pitch) {
      *at = (int)off;
      *depth = rows;
      *magic = (unsigned)((1ull << 32) / rows) + 1;
      off += (long long)rows * pitch;
    };
    for (int k = 1; k <= n; ++k)
      ring(&p.h_off[k], &p.h_depth[k], &p.h_magic[k], 2 * p.rad[k] + p.batch, PITCH(p, k));
    for (int k = 0; k < n; ++k)
      ring(&p.g_off[k], &p.g_depth[k], &p.g_magic[k], p.rad[k + 1] + p.batch, PITCH(p, k));
    for (int j = 0; kMask && j < n; ++j)
      ring(&p.d_off[j], &p.d_depth[j], &p.d_magic[j], rad(j + 2) + rad(j + 3) + p.batch + 2,
           D_PITCH);
    smem = sizeof(float) * (size_t)(off + TAIL_PAD);
    if (smem <= SMEM_LIMIT) break;
  }
  if (p.batch < 1) return (int)cudaErrorInvalidValue;
  p.n = n;
  p.H = H;
  p.W = W;
  p.nbm = (W + TILE_W - 1) / TILE_W;
  p.wpad = p.nbm * TILE_W;
  p.thr = thr;
  p.strip = strip_rows_for(B, H, W, p.ext[0]);
  cudaError_t e = cudaFuncSetAttribute(
      octave_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.nbm, (H + p.strip - 1) / p.strip, B);
  octave_kernel<kMode><<<grid, 32 * p.batch * WARPS_PER_ROW, smem, (cudaStream_t)stream>>>(
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
  if (n < 3 || n > MAX_LAYERS || H < 1 || W < 1 || W >= (1 << 20) || ls < 0 ||
      ls > 20 || blk < 1 || blk > 4096 || g_l0 < 0 || g_nl < 0 ||
      g_l0 + g_nl > n + 1)
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
  tw.blk_magic = (unsigned)((1ull << 32) / blk) + 1;
  tw.stride_magic = (unsigned)((1ull << 32) / tw.stride) + 1;
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
