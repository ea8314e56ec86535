// Kernel B: exact-integer top-2 descriptor matcher, for Hopper (sm_90a).
//
// Replaces the TPU kernel sift_tpu/ops/pallas_match.py::pallas_top2 (:90,
// body _kernel :29-86).  For each pair p and each row i of desc1[p] it scans
// desc2[p] and returns the smallest squared L2 distance (best), the second
// smallest (second) and the column of the best (idx), int32.  The first
// column wins ties and a duplicate of the best counts as the second, as in
// the reference scan (src/sift.cpp:799-806).  Invalid targets read as
// HUGE_D2 = 1 << 24; a row with no valid target (or M = 0) returns
// (HUGE, HUGE, 0), like argmin over an all-HUGE row.
//
// What bounds it: 128 multiply-adds per (row, target) pair, 8.6 G int8
// operations at the main path's 8 pairs of 2048 x 2048, 0.0043 ms at the
// tensor cores' dense int8 rate; device memory (~4 MB) is far below that.
// The realistic floor is the compare scan: 33.5 M distances at 6-8 integer
// instructions each (the distance, the running top-2), about 0.02 ms at the
// card's int32 rate.  The earlier version ran 32 __dp4a a
// pair on the CUDA cores, one thread a row, 4 warps an SM.
//
// Design: the dot products on the int8 tensor cores,
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32, exact (u8 x u8 summed in
// s32, at most 128 * 255^2 < 2^24).  A CTA of 4 warps owns 64 rows (16 a
// warp) and keeps their A fragments for K = 128 in registers (16 words a
// lane) for the whole scan, with each row's |a|^2.  K is permuted so that a
// lane's fragment words are 8 contiguous words of a descriptor (lane t of a
// quad holds words 8t .. 8t+7, k-step s uses words 8t+2s and 8t+2s+1): the
// sum is the same, and a B fragment is two 16-byte shared loads.  Targets
// are staged in shared memory 128 at a time (rows padded to 36 words: no
// bank conflicts), double buffered with cp.async; each tile carries |b|^2,
// or INVALID_NORM for an invalid or missing target.  Epilogue on the
// accumulator fragment: a lane holds rows g and g+8 at columns 2t and 2t+1
// of every 8-column fragment, so it sees its columns in ascending order.
// It compares d - |a|^2 = |b|^2 - 2 a.b (one multiply-add; the row's |a|^2
// is added back after the scan), starting from HUGE_D2 - |a|^2, so that an
// invalid target (INVALID_NORM - 2 a.b > HUGE_D2) never enters and a row
// with no valid target ends at HUGE_D2.  The running (b1, i1, b2) takes
// the strict update
//   if (d < b1) { b2 = b1; b1 = d; i1 = j; } else if (d < b2) b2 = d;
// which, for ascending j, is the lexicographic rule on (d, j).  The four
// lanes of a quad are then merged by shuffles: the best is the
// lexicographic minimum of (b1, i1), the second the minimum of every other
// partial's b1 and of every b2, so the order of the merge does not matter.
// The columns may be split over the CTAs of a cluster (nsplit, at most
// MAX_SPLIT, contiguous runs of tiles); rank 0 merges the others' partials
// out of their shared memory by the same rule.  On an H100 the split pays
// at both shapes it meets (device time, scripts/ab_blur_top2.py): 8 pairs
// of 2048 x 2048 take 0.030 ms in two splits against 0.035 in one, one
// pair of 1286 x 1430 (21 CTAs of rows) 0.008 ms in six against 0.021.  The scan order, ring to
// merge, is modelled in plain PyTorch by ops/top2.py::top2_tiled_plain,
// which mirrors the constants and the split rule below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define HUGE_D2 (1 << 24)
#define INVALID_NORM (1 << 26)  // this - 2 a.b > HUGE_D2 for any a, b
#define ROWS 64                 // rows of a CTA, 16 a warp
#define NTHREADS 128
#define TILE 128                // targets a stage
#define PITCH 36                // words of a staged target row (32 + 4 of padding)
#define MAX_SPLIT 8             // CTAs of a cluster that split the columns
#define SM_COUNT 132
#define CTAS_PER_SM 2           // the split rule's target of CTAs an SM

struct Top2 {
  int b1, i1, b2;
};

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool a_wins = a.b1 < b.b1 || (a.b1 == b.b1 && a.i1 < b.i1);
  Top2 m;
  m.b1 = a_wins ? a.b1 : b.b1;
  m.i1 = a_wins ? a.i1 : b.i1;
  m.b2 = min(min(a.b2, b.b2), a_wins ? b.b1 : a.b1);
  return m;
}

__device__ __forceinline__ Top2 shfl_merge(Top2 a, int mask) {
  Top2 b;
  b.b1 = __shfl_xor_sync(0xffffffffu, a.b1, mask);
  b.i1 = __shfl_xor_sync(0xffffffffu, a.i1, mask);
  b.b2 = __shfl_xor_sync(0xffffffffu, a.b2, mask);
  return merge(a, b);
}

__device__ __forceinline__ void update(Top2& s, int d, int j) {
  const bool lt = d < s.b1;
  s.b2 = lt ? s.b1 : min(s.b2, d);
  s.i1 = lt ? j : s.i1;
  s.b1 = lt ? d : s.b1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void mma_u8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (ceil(N / ROWS) * nsplit, P), cluster (nsplit, 1, 1), NTHREADS threads.
__global__ void __launch_bounds__(NTHREADS)
top2_kernel(const uint8_t* __restrict__ d1, const uint8_t* __restrict__ d2,
            const uint8_t* __restrict__ v2, int* __restrict__ best,
            int* __restrict__ second, int* __restrict__ idx, int N, int M,
            int nsplit, int tiles_per_split) {
  __shared__ __align__(16) uint32_t tile[2][TILE * PITCH];
  __shared__ __align__(16) int tnorm[2][TILE];
  __shared__ Top2 part[ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p = blockIdx.y;
  const int split = blockIdx.x % nsplit;
  const int row0 = (blockIdx.x / nsplit) * ROWS + warp * 16;

  // A fragments of rows g and g+8 (a[s][0..3], k-step s): words 8t + 2s and
  // 8t + 2s + 1 of each row; the rows' |a|^2, summed over the quad.
  uint32_t a[4][4];
  int na[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
    if (r < N) {
      const uint4* src = reinterpret_cast<const uint4*>(d1 + ((size_t)p * N + r) * 128 + 32 * t);
      w0 = src[0];
      w1 = src[1];
    }
    const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    unsigned s2 = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[s][h] = w[2 * s];
      a[s][2 + h] = w[2 * s + 1];
      s2 = __dp4a(w[2 * s], w[2 * s], s2);
      s2 = __dp4a(w[2 * s + 1], w[2 * s + 1], s2);
    }
    s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
    na[h] = (int)s2;
  }

  // Running top-2 of |b|^2 - 2 a.b for rows g and g+8.
  Top2 st[2] = {{HUGE_D2 - na[0], 0, HUGE_D2 - na[0]}, {HUGE_D2 - na[1], 0, HUGE_D2 - na[1]}};
  const int ntiles = (M + TILE - 1) / TILE;
  const int t0 = split * tiles_per_split, t1 = min(ntiles, t0 + tiles_per_split);
  const uint8_t* tb = d2 + (size_t)p * M * 128;
  const uint8_t* vb = v2 + (size_t)p * M;

  // Tile k of the targets into buffer k & 1: 8 chunks of 16 bytes a thread,
  // zeros past M.
  auto stage = [&](int k) {
    uint32_t* dst = tile[k & 1];
#pragma unroll
    for (int q = 0; q < TILE * 8 / NTHREADS; ++q) {
      const int e = tid + NTHREADS * q, row = e >> 3, ch = e & 7;
      const int j = k * TILE + row;
      cp_async16(dst + row * PITCH + 4 * ch, tb + (size_t)min(j, M - 1) * 128 + 16 * ch,
                 j < M ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (t0 < t1) stage(t0);
  for (int k = t0; k < t1; ++k) {
    const int j_me = k * TILE + tid;  // this thread's target for the norms
    const bool ok = j_me < M && vb[min(j_me, M - 1)];
    if (k + 1 < t1) {
      stage(k + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile k is in for every thread
    const uint32_t* buf = tile[k & 1];
    {
      const uint4* row = reinterpret_cast<const uint4*>(buf + tid * PITCH);
      unsigned s2 = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = row[q];
        s2 = __dp4a(v.x, v.x, s2);
        s2 = __dp4a(v.y, v.y, s2);
        s2 = __dp4a(v.z, v.z, s2);
        s2 = __dp4a(v.w, v.w, s2);
      }
      tnorm[k & 1][tid] = ok ? (int)s2 : INVALID_NORM;
    }
    __syncthreads();
    const int* nb = tnorm[k & 1];
#pragma unroll 2
    for (int f = 0; f < TILE / 8; ++f) {
      const uint4* brow = reinterpret_cast<const uint4*>(buf + (8 * f + g) * PITCH + 8 * t);
      const uint4 b0 = brow[0], b1 = brow[1];
      const uint32_t b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < 4; ++s) mma_u8(c, a[s], b[2 * s], b[2 * s + 1]);
      const int2 n2 = *reinterpret_cast<const int2*>(nb + 8 * f + 2 * t);
      const int j = k * TILE + 8 * f + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        update(st[h], n2.x - 2 * c[2 * h], j);
        update(st[h], n2.y - 2 * c[2 * h + 1], j + 1);
      }
    }
    __syncthreads();  // buffer k & 1 is read before tile k + 2 lands in it
  }

  // The quad's four partials (one row, one |a|^2), back to distances, then
  // across the cluster's splits.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st[h] = shfl_merge(st[h], 1);
    st[h] = shfl_merge(st[h], 2);
    st[h].b1 += na[h];
    st[h].b2 += na[h];
  }
  if (t == 0) {
    part[warp * 16 + g] = st[0];
    part[warp * 16 + g + 8] = st[1];
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (nsplit > 1) cluster.sync();
  else __syncthreads();
  if (split == 0 && tid < ROWS) {
    Top2 m = part[tid];
    for (int r = 1; r < nsplit; ++r) m = merge(m, cluster.map_shared_rank(part, r)[tid]);
    const int row = (blockIdx.x / nsplit) * ROWS + tid;
    if (row < N) {
      const size_t o = (size_t)p * N + row;
      best[o] = m.b1;
      second[o] = m.b2;
      idx[o] = m.i1;
    }
  }
  if (nsplit > 1) cluster.sync();  // rank 0 has read every partial
}

// Splits of the columns: enough CTAs for CTAS_PER_SM an SM, at most
// MAX_SPLIT and no more than the tiles; then as few splits as give the same
// tiles per split.  Writes the tiles per split.
static int split_for(int P, int N, int M, int* tiles_per_split) {
  const int ntiles = (M + TILE - 1) / TILE;
  const long long blocks = (long long)((N + ROWS - 1) / ROWS) * P;
  long long s = (SM_COUNT * CTAS_PER_SM + blocks - 1) / blocks;
  s = s < 1 ? 1 : (s > MAX_SPLIT ? MAX_SPLIT : s);
  if (s > ntiles) s = ntiles > 1 ? ntiles : 1;
  const int tps = ntiles > 0 ? (int)((ntiles + s - 1) / s) : 0;
  *tiles_per_split = tps;
  return tps > 0 ? (ntiles + tps - 1) / tps : 1;
}

// desc1 (P, N, 128) u8, desc2 (P, M, 128) u8, valid2 (P, M) u8 0/1 ->
// best, second, idx (P, N) int32.  Returns cudaGetLastError().
extern "C" int top2_launch(const uint8_t* desc1, const uint8_t* desc2,
                           const uint8_t* valid2, int* best, int* second,
                           int* idx, int P, int N, int M, void* stream) {
  if (P < 1 || N < 1 || M < 0 || P > 65535) return (int)cudaErrorInvalidValue;
  int tps;
  const int nsplit = split_for(P, N, M, &tps);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + ROWS - 1) / ROWS) * nsplit, P, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, top2_kernel, desc1, desc2, valid2, best, second,
                                     idx, N, M, nsplit, tps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
