// Kernel J: stage 2 of the front and front-twin routes (extrema compaction,
// cascaded Newton refinement, contrast and edge tests, compaction to kp_cap)
// in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this stage with XLA
// (sift_tpu/models/detect.py::extrema_from_counts + refine_keypoints_all),
// and the port ran it as a chain of plain-PyTorch launches
// (models/detect.py): hundreds of small launches a call, the cascade's sorts
// and scatters, and host waits for the tables built from host values.  The
// launches, not the card, set that stage's pace.  This kernel computes what
// that chain returns, bit for bit, and reads nothing back.
//
// One CTA of NTHREADS threads an image.  Its lanes are the image's
// extrema_cap extrema slots, k = 0 .. n - 1, in (octave, z, y, x) order:
//   1. extrema: the popcount rows of every octave in order, a tile of
//      NTHREADS x ROWS_PER_THREAD rows at a time; a block-wide exclusive
//      scan gives each row's first slot, and a row with set bits lists them
//      from its 128-lane mask row into the lane buffer (the slot of the j-th
//      set bit is the row's first slot + j; the j-th bit is what
//      extrema_from_counts' searchsorted finds for that slot).  Slots past
//      the true total take, as the chain's gathers give them, the last row
//      of the last octave;
//   2. Newton step 1 on every lane; later phases follow
//      refine_cascade_caps: before each, a scan over the bit mask of the
//      still-active lanes gives each its rank, and the lanes ranked below
//      the phase's cap (the chain's compact_mask) run the phase's steps in
//      registers, stopping once converged or out of the volume; the others
//      are rejected where they stand, as the chain's unwind leaves them;
//   3. every lane, when it stops, is tested (contrast, edge) and its
//      keypoint fields are written to a per-lane buffer, its accept bit set;
//   4. a scan over the accept bits packs the accepted lanes, in lane order,
//      into the (kp_cap,) output; the slots after them hold lane n - 1's
//      fields, invalid, as kputil.compact's clamped indices give them.
// Ranks come from scans, never from atomics: two launches give the same
// bytes (the shared bit masks take atomicAnd / atomicOr, whose result does
// not depend on their order).
//
// Arithmetic: the chain's expression order (models/detect.py), every
// product, sum and division an explicit _rn intrinsic (and -fmad=false),
// the cube values divided by 255 (a true division), round half away from
// zero and numerics.to_i32's NaN and saturation rule; the size takes exp2f,
// which is what torch.exp2 calls.  Cube reads follow gather_cubes' clamps
// and the index rule of the DoG gather space (ops/gather.py: CubeRows.index,
// StackSpace.index), which ops/detect.py::space_index models.
//
// What bounds it: per valid lane at most five reads of a 27-value cube and
// the lane's fields, per image one pass over the popcounts and the masks'
// rows that hold extrema: a few MB a batch, microseconds at 3.35 TB/s.  The
// work is small; the point is one launch instead of hundreds.  One CTA an
// image keeps every scan inside a block (no second pass, no grid sync).

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 512
#define NWARPS (NTHREADS / 32)
#define ROWS_PER_THREAD 8
#define ROWS_IN_FLIGHT 4  // mask rows a warp reads at once
#define MAXV 16  // octaves
#define MAXP 4   // cascade phases after step 1

enum { MODE_STACK = 0, MODE_CUBE_ROWS = 1 };

// Mirrors ops/detect.py::_Args field by field.
struct DetectArgs {
  long long rt;            // per image: elements (stack space) or packed rows (CubeRows)
  long long base[MAXV];    // each octave's first element or packed row
  long long counts[MAXV];  // device address of counts[o]: (B, n_int, H, nbm) int32
  long long masks[MAXV];   // device address of masks[o]: (B, n_int, H, nbm * 128) float32
  int mode, nvol, stride, sw, width;
  int S[MAXV], H[MAXV], W[MAXV], nbp[MAXV], ls[MAXV], nbm[MAXV];
  float scale[MAXV];  // 2^o
  int n_int;          // interior layers of a mask
  int n;              // lanes an image: extrema_cap
  int kp_cap;
  int depth;          // layers of the DoG stack (the chain's space.shapes[0][0])
  int border;         // window_size // 2
  int nph;            // cascade phases after step 1
  int cap[MAXP], steps[MAXP];
  // float32 constants, each the float that PyTorch makes of the chain's
  // Python number: 255, intervals, init_sigma, contrast_threshold,
  // eigen_ratio and (eigen_ratio + 1)^2.
  float c255, intervals, init_sigma, contrast, eigen_ratio, edge_lim;
};

struct Pos {
  int z, y, x, o;
};

// The Newton fit of the step that converged; zero on every other lane.
struct Fit {
  float g0, g1, g2, h00, h11, h22, h01, h02, h12, o0, o1, o2, ctr;
};

enum { MOVING = 0, CONVERGED = 1, STOPPED = 2 };

// The flat offset of element (s, y, x) of octave o of image img, the window
// starting at column x0: StackSpace.index and CubeRows.index.
__device__ __forceinline__ long long space_index(const DetectArgs& a, int o, long long img,
                                                 int s, int y, int x, int x0) {
  if (a.mode == MODE_STACK)
    return img * a.rt + a.base[o] + ((long long)s * a.H[o] + y) * a.W[o] + x;
  const int nbp = a.nbp[o], ls = a.ls[o];
  const int cb = min(max(x0, 0) / a.stride, nbp - 1);
  const long long row = img * a.rt + a.base[o] +
                        ((((long long)(y >> ls) * nbp) + cb) << ls) + (y & ((1 << ls) - 1));
  return row * a.width + (long long)s * a.sw + x - ((long long)cb * a.stride - 1);
}

__device__ __forceinline__ float round_half_away(float v) {
  return v >= 0.f ? floorf(__fadd_rn(v, 0.5f)) : ceilf(__fsub_rn(v, 0.5f));
}

// numerics.to_i32: NaN -> 0, +-inf -> +-2^30, clamp to +-2^30, truncate.
__device__ __forceinline__ int to_i32(float v) {
  const float lim = 1073741824.0f;
  if (v != v) return 0;
  return (int)fminf(fmaxf(v, -lim), lim);
}

// The chain clamps every lane's position into [border, dims - 1 - border]
// after each step, active or not (models/detect.py::_newton_refine).
__device__ __forceinline__ void clamp(const DetectArgs& a, Pos& p) {
  const int b = a.border;
  p.z = min(max(p.z, b), a.depth - 1 - b);
  p.y = min(max(p.y, b), a.H[p.o] - 1 - b);
  p.x = min(max(p.x, b), a.W[p.o] - 1 - b);
}

// models/detect.py::_newton_refine, one step of one active lane (src/sift.cpp:330-436).
__device__ int newton_step(const DetectArgs& a, const float* __restrict__ flat, long long img,
                           Pos& p, Fit& f) {
  const int o = p.o;
  const int S = a.S[o], H = a.H[o], W = a.W[o];
  // gather_cubes: the read position clamped to the interior.
  const int zc = min(max(p.z, 1), S - 2), yc = min(max(p.y, 1), H - 2);
  const int xc = min(max(p.x, 1), W - 2);
  float c[3][3][3];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        c[dz][dy][dx] = __fdiv_rn(
            flat[space_index(a, o, img, zc + dz - 1, yc + dy - 1, xc + dx - 1, xc - 1)], a.c255);
  // _gradient (dz, dx, dy), _hessian, axes (z, x, y).
  const float g0 = __fmul_rn(0.5f, __fsub_rn(c[2][1][1], c[0][1][1]));
  const float g1 = __fmul_rn(0.5f, __fsub_rn(c[1][1][2], c[1][1][0]));
  const float g2 = __fmul_rn(0.5f, __fsub_rn(c[1][2][1], c[1][0][1]));
  const float ctr = c[1][1][1];
  const float ctr2 = __fmul_rn(2.0f, ctr);
  const float h00 = __fadd_rn(__fsub_rn(c[0][1][1], ctr2), c[2][1][1]);
  const float h11 = __fadd_rn(__fsub_rn(c[1][1][0], ctr2), c[1][1][2]);
  const float h22 = __fadd_rn(__fsub_rn(c[1][0][1], ctr2), c[1][2][1]);
  const float h01 = __fmul_rn(0.25f, __fadd_rn(__fsub_rn(__fsub_rn(c[2][1][2], c[2][1][0]),
                                                         c[0][1][2]), c[0][1][0]));
  const float h02 = __fmul_rn(0.25f, __fadd_rn(__fsub_rn(__fsub_rn(c[2][2][1], c[2][0][1]),
                                                         c[0][2][1]), c[0][0][1]));
  const float h12 = __fmul_rn(0.25f, __fadd_rn(__fsub_rn(__fsub_rn(c[1][0][0], c[1][0][2]),
                                                         c[1][2][0]), c[1][2][2]));
  // _fit_quadratic: the adjugate, in the order of src/sift.cpp:86-106.
  float det = __fmul_rn(__fmul_rn(h00, h11), h22);
  det = __fadd_rn(det, __fmul_rn(2.0f, __fmul_rn(__fmul_rn(h01, h12), h02)));
  det = __fsub_rn(det, __fmul_rn(__fmul_rn(h02, h11), h02));
  det = __fsub_rn(det, __fmul_rn(__fmul_rn(h00, h12), h12));
  det = __fsub_rn(det, __fmul_rn(__fmul_rn(h01, h01), h22));
  const float i00 = __fdiv_rn(__fsub_rn(__fmul_rn(h11, h22), __fmul_rn(h12, h12)), det);
  const float i01 = __fdiv_rn(__fsub_rn(__fmul_rn(h02, h12), __fmul_rn(h01, h22)), det);
  const float i02 = __fdiv_rn(__fsub_rn(__fmul_rn(h01, h12), __fmul_rn(h02, h11)), det);
  const float i11 = __fdiv_rn(__fsub_rn(__fmul_rn(h00, h22), __fmul_rn(h02, h02)), det);
  const float i12 = __fdiv_rn(__fsub_rn(__fmul_rn(h02, h01), __fmul_rn(h00, h12)), det);
  const float i22 = __fdiv_rn(__fsub_rn(__fmul_rn(h00, h11), __fmul_rn(h01, h01)), det);
  const float o0 = __fsub_rn(__fsub_rn(__fmul_rn(-i00, g0), __fmul_rn(i01, g1)),
                             __fmul_rn(i02, g2));
  const float o1 = __fsub_rn(__fsub_rn(__fmul_rn(-i01, g0), __fmul_rn(i11, g1)),
                             __fmul_rn(i12, g2));
  const float o2 = __fsub_rn(__fsub_rn(__fmul_rn(-i02, g0), __fmul_rn(i12, g1)),
                             __fmul_rn(i22, g2));
  // max(|o0|, |o1|, |o2|) < 0.5 with torch.maximum's NaN rule: a NaN fails.
  int st;
  if (fabsf(o0) < 0.5f && fabsf(o1) < 0.5f && fabsf(o2) < 0.5f) {
    f = Fit{g0, g1, g2, h00, h11, h22, h01, h02, h12, o0, o1, o2, ctr};
    st = CONVERGED;
  } else {
    const int b = a.border;
    p.z += to_i32(round_half_away(o0));
    p.y += to_i32(round_half_away(o2));
    p.x += to_i32(round_half_away(o1));
    const bool in_bounds = p.x >= b && p.x < W - b && p.y >= b && p.y < H - b && p.z >= b &&
                           p.z < a.depth - b;
    st = in_bounds ? MOVING : STOPPED;
  }
  clamp(a, p);
  return st;
}

// models/detect.py::_accept_and_emit: (x, y, size, octave | layer << 8) of
// a stopped lane; ``fit`` is the converged step's fit, or null (all zero).
__device__ float4 emit(const DetectArgs& a, const Pos& p, const Fit* fit, bool* accepted) {
  const bool conv = fit != nullptr;
  const Fit f = conv ? *fit : Fit{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(f.g0, f.o0), __fmul_rn(f.g1, f.o1)),
                              __fmul_rn(f.g2, f.o2));
  const float interp = __fadd_rn(f.ctr, __fmul_rn(0.5f, dot));
  const bool contrast = __fmul_rn(fabsf(interp), a.intervals) >= a.contrast;
  const float tr = __fadd_rn(f.h11, f.h22);
  const float det2 = __fsub_rn(__fmul_rn(f.h11, f.h22), __fmul_rn(f.h12, f.h12));
  const bool not_edge =
      tr > 0.f && __fmul_rn(__fmul_rn(tr, tr), a.eigen_ratio) < __fmul_rn(a.edge_lim, det2);
  const bool acc = conv && contrast && not_edge;
  const float sc = a.scale[p.o];
  const float fx = __fmul_rn(sc, __fadd_rn((float)p.x, f.o1));
  const float fy = __fmul_rn(sc, __fadd_rn((float)p.y, f.o2));
  const float size = __fmul_rn(__fmul_rn(a.init_sigma, sc),
                               exp2f(__fdiv_rn(__fadd_rn((float)p.z, f.o0), a.intervals)));
  *accepted = acc;
  return make_float4(fx, fy, size, __int_as_float(p.o | (p.z << 8)));
}

// Block-wide exclusive prefix sum of v; *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* total, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NWARPS ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < NWARPS) wsum[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? wsum[warp - 1] : 0);
  *total = wsum[NWARPS - 1];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(NTHREADS, 1) detect_kernel(
    const __grid_constant__ DetectArgs a, const float* __restrict__ flat, int4* ws_lane,
    float4* ws_emit, int* ws_list, float* ox, float* oy, int* ooct, int* olayer, float* osize,
    float* opori, uint8_t* odesc, uint8_t* ovalid, int* oextrema, int* orefined,
    int* oactive) {
  extern __shared__ unsigned bits[];  // alive, then accept: one bit a lane each
  __shared__ int wsum[NWARPS];
  __shared__ int last_set[128];
  __shared__ int n_last;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int img = blockIdx.x;
  const int n = a.n, words = (n + 31) >> 5;
  unsigned* alive = bits;
  unsigned* acc = bits + words;
  int4* lanes = ws_lane + (long long)img * n;
  float4* em = ws_emit + (long long)img * n;
  int* list = ws_list + (long long)img * n;
  for (int w = t; w < 2 * words; w += NTHREADS) bits[w] = 0u;

  // 1. Extrema slots from the popcounts and the masks.
  long long run = 0;  // set bits in the rows before the tile
  for (int o = 0; o < a.nvol; ++o) {
    const int nbm = a.nbm[o], H = a.H[o];
    const long long rows = (long long)a.n_int * H * nbm;
    const int* cnt = reinterpret_cast<const int*>(a.counts[o]) + img * rows;
    const float* msk = reinterpret_cast<const float*>(a.masks[o]) + img * rows * 128;
    for (long long tile = 0; tile < rows; tile += NTHREADS * ROWS_PER_THREAD) {
      const long long r0 = tile + (long long)t * ROWS_PER_THREAD;
      int c[ROWS_PER_THREAD];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        c[j] = r0 + j < rows ? cnt[r0 + j] : 0;
        sum += c[j];
      }
      int tot;
      const long long first = run + block_scan(sum, &tot, wsum);
      run += tot;
      // Each warp lists the set bits of its threads' rows that start below
      // n, a row at a time across the warp (lane l reads mask lanes 4l ..
      // 4l + 3), up to ROWS_IN_FLIGHT rows at once.
      int bj[ROWS_PER_THREAD];
      long long acc_b = first;
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        bj[j] = (int)min(acc_b, (long long)n);
        acc_b += c[j];
      }
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        unsigned pend = __ballot_sync(0xffffffffu, c[j] > 0 && bj[j] < n);
        while (pend) {
          int src[ROWS_IN_FLIGHT];
          float4 v[ROWS_IN_FLIGHT];
#pragma unroll
          for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
            src[u] = pend ? __ffs(pend) - 1 : -1;
            pend &= pend ? pend - 1u : 0u;
            const int r = __shfl_sync(0xffffffffu, (int)(r0 + j), max(src[u], 0));
            if (src[u] >= 0) v[u] = reinterpret_cast<const float4*>(msk + (long long)r * 128)[lane];
          }
#pragma unroll
          for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
            if (src[u] < 0) break;
            const int r = __shfl_sync(0xffffffffu, (int)(r0 + j), src[u]);
            const int cr = __shfl_sync(0xffffffffu, c[j], src[u]);
            const int br = __shfl_sync(0xffffffffu, bj[j], src[u]);
            const int z = r / (H * nbm) + 1, y = (r / nbm) % H, x0 = (r % nbm) * 128;
            const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
            int mine = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) mine += e[i] > 0.f;
            int at = mine;  // inclusive prefix of the set bits over the warp
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const int up = __shfl_up_sync(0xffffffffu, at, d);
              if (lane >= d) at += up;
            }
            const int nset = __shfl_sync(0xffffffffu, at, 31);
            at -= mine;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (e[i] > 0.f) {
                if (at < cr && br + at < n) lanes[br + at] = make_int4(z, y, x0 + 4 * lane + i, o);
                ++at;
              }
            }
            // A count above the row's set bits: the chain's gather finds bit 0.
            for (int kk = nset + lane; kk < cr && br + kk < n; kk += 32)
              lanes[br + kk] = make_int4(z, y, x0, o);
          }
        }
      }
    }
  }
  const long long total = run;
  // Slots past the total: the chain's searchsorted gives them the last row
  // of the last octave, and its ranks there the set bits of that row.
  const int lo = a.nvol - 1;
  const long long rows_last = (long long)a.n_int * a.H[lo] * a.nbm[lo];
  if (warp == 0) {  // lane l reads mask lanes 4l .. 4l + 3
    const float4 v = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(a.masks[lo]) +
        (img * rows_last + rows_last - 1) * 128)[lane];
    const float e[4] = {v.x, v.y, v.z, v.w};
    int mine = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) mine += e[i] > 0.f;
    int at = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, at, d);
      if (lane >= d) at += up;
    }
    if (lane == 31) n_last = at;
    at -= mine;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e[i] > 0.f) last_set[at++] = 4 * lane + i;
    if (lane == 0) oextrema[img] = (int)total;
  }
  __syncthreads();

  // 2. Newton step 1 on every lane.
  const Pos garbage_base = {a.n_int, a.H[lo] - 1, (a.nbm[lo] - 1) * 128, lo};
  for (int k0 = 0; k0 < n; k0 += NTHREADS) {
    const int k = k0 + t;
    bool live = false, accepted = false;
    if (k < n) {
      Pos p;
      bool valid = k < total;
      if (valid) {
        const int4 l = lanes[k];
        p = Pos{l.x, l.y, l.z, l.w};
      } else {
        p = garbage_base;
        const long long rank = k - total;
        p.x += rank < n_last ? last_set[rank] : 0;
      }
      Fit f;
      int st = STOPPED;
      if (valid)
        st = newton_step(a, flat, img, p, f);
      else  // an inactive lane: the step only clamps its position
        clamp(a, p);
      if (st == MOVING) {
        lanes[k] = make_int4(p.z, p.y, p.x, p.o);
        live = true;
      } else {
        em[k] = emit(a, p, st == CONVERGED ? &f : nullptr, &accepted);
      }
    }
    const unsigned bl = __ballot_sync(0xffffffffu, live);
    const unsigned ba = __ballot_sync(0xffffffffu, accepted);
    const int w = (k0 >> 5) + warp;
    if (lane == 0 && w < words) {
      alive[w] = bl;
      acc[w] = ba;
    }
  }

  // 3. The cascade's later phases.
  const int wpt = (words + NTHREADS - 1) / NTHREADS;
  const int w0 = min(t * wpt, words), w1 = min(w0 + wpt, words);
  for (int ph = 0; ph < a.nph; ++ph) {
    __syncthreads();
    int mine = 0;
    for (int w = w0; w < w1; ++w) mine += __popc(alive[w]);
    int tot;
    int rank = block_scan(mine, &tot, wsum);
    if (t == 0) oactive[img * a.nph + ph] = tot;
    const int cap = a.cap[ph];
    for (int w = w0; w < w1; ++w) {
      unsigned rest = alive[w], keep = 0u;
      while (rest) {
        const int b = __ffs(rest) - 1;
        rest &= rest - 1u;
        const int k = (w << 5) + b;
        if (rank < cap) {
          list[rank] = k;
          keep |= 1u << b;
        } else {  // ranked out of the phase: rejected where it stands
          const int4 l = lanes[k];
          bool unused;
          em[k] = emit(a, Pos{l.x, l.y, l.z, l.w}, nullptr, &unused);
        }
        ++rank;
      }
      alive[w] = keep;
    }
    __syncthreads();
    const int nlist = min(tot, cap);
    for (int e = t; e < nlist; e += NTHREADS) {
      const int k = list[e];
      const int4 l = lanes[k];
      Pos p = Pos{l.x, l.y, l.z, l.w};
      Fit f;
      int st = MOVING;
      for (int s = 0; s < a.steps[ph] && st == MOVING; ++s) st = newton_step(a, flat, img, p, f);
      if (st == MOVING) {
        lanes[k] = make_int4(p.z, p.y, p.x, p.o);
      } else {
        bool accepted;
        em[k] = emit(a, p, st == CONVERGED ? &f : nullptr, &accepted);
        atomicAnd(&alive[k >> 5], ~(1u << (k & 31)));
        if (accepted) atomicOr(&acc[k >> 5], 1u << (k & 31));
      }
    }
  }
  __syncthreads();
  // Lanes still moving after the last phase are rejected where they stand.
  for (int w = w0; w < w1; ++w) {
    unsigned rest = alive[w];
    while (rest) {
      const int b = __ffs(rest) - 1;
      rest &= rest - 1u;
      const int k = (w << 5) + b;
      const int4 l = lanes[k];
      bool unused;
      em[k] = emit(a, Pos{l.x, l.y, l.z, l.w}, nullptr, &unused);
    }
  }
  __syncthreads();

  // 4. kputil.compact to kp_cap.
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(acc[w]);
  int n_acc;
  int rank = block_scan(mine, &n_acc, wsum);
  if (t == 0) orefined[img] = n_acc;
  const int kc = min(a.kp_cap, n);
  const long long ob = (long long)img * a.kp_cap;
  for (int w = w0; w < w1; ++w) {
    unsigned rest = acc[w];
    while (rest && rank < kc) {
      const int b = __ffs(rest) - 1;
      rest &= rest - 1u;
      const float4 v = em[(w << 5) + b];
      const int code = __float_as_int(v.w);
      ox[ob + rank] = v.x;
      oy[ob + rank] = v.y;
      osize[ob + rank] = v.z;
      ooct[ob + rank] = code & 0xff;
      olayer[ob + rank] = code >> 8;
      ovalid[ob + rank] = 1;
      ++rank;
    }
  }
  const int n_out = min(n_acc, kc);
  const float4 tail = em[n - 1];
  const int tcode = __float_as_int(tail.w);
  for (int j = n_out + t; j < a.kp_cap; j += NTHREADS) {
    const bool in = j < kc;  // past n: zero padding
    ox[ob + j] = in ? tail.x : 0.f;
    oy[ob + j] = in ? tail.y : 0.f;
    osize[ob + j] = in ? tail.z : 0.f;
    ooct[ob + j] = in ? (tcode & 0xff) : 0;
    olayer[ob + j] = in ? tcode >> 8 : 0;
    ovalid[ob + j] = 0;
  }
  for (int j = t; j < a.kp_cap; j += NTHREADS) opori[ob + j] = 0.f;
  uint4* d = reinterpret_cast<uint4*>(odesc + ob * 128);
  for (int j = t; j < a.kp_cap * 8; j += NTHREADS) d[j] = make_uint4(0u, 0u, 0u, 0u);
}

extern "C" int detect_launch(const DetectArgs* args, int bsz, const float* flat, void* ws_lane,
                             void* ws_emit, int* ws_list, float* x, float* y, int* octave,
                             int* layer, float* size, float* pori, uint8_t* desc, uint8_t* valid,
                             int* extrema, int* refined, int* n_active, void* stream) {
  const DetectArgs a = *args;
  if (bsz < 1 || a.n < 1 || a.kp_cap < 1 || a.nvol < 1 || a.nvol > MAXV || a.nph < 0 ||
      a.nph > MAXP || a.n_int < 1 || (a.mode != MODE_STACK && a.mode != MODE_CUBE_ROWS) ||
      (a.mode == MODE_CUBE_ROWS && a.stride < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * ((a.n + 31) / 32) * sizeof(unsigned);  // the two bit masks
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  detect_kernel<<<bsz, NTHREADS, smem, (cudaStream_t)stream>>>(
      a, flat, (int4*)ws_lane, (float4*)ws_emit, ws_list, x, y, octave, layer, size, pori, desc,
      valid, extrema, refined, n_active);
  return (int)cudaGetLastError();
}
