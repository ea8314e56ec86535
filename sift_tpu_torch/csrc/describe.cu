// Kernel I: the 128-byte descriptors of a post-dedup keypoint buffer, and
// kernel K: the orientation candidates of a refined keypoint buffer, for
// Hopper (sm_90a).  Both read a gauss gather space by one index rule
// (space_index) and take one argument struct (DescArgs); K is described
// above its own code, after I's.
//
// Replaces no TPU kernel: the JAX package computes descriptors with XLA
// (sift_tpu/models/descriptor.py::compute_descriptors_all), and the port
// ran the same stage as a chain of plain-PyTorch launches per radius class
// and lane chunk (models/descriptor.py::_descriptors), with host reads to
// compact the lanes and size the classes.  The chain's launches, not the
// card, set that stage's pace; this kernel does the whole stage in one
// launch and reads nothing back.
//
// One CTA of 128 threads a lane of the (B * n) buffer; an invalid lane
// writes its 128 zero bytes and leaves.  A valid lane:
//   1. computes in registers what _lane_args computed per lane: the octave's
//      scale (pow_denom), x and y truncated, the histogram width, the
//      radius (round half away, clamped by the octave's diagonal), the
//      clamped centre, cos and sin of the orientation;
//   2. stages its own (2r + 3)^2 patch of its gauss layer in shared memory,
//      r = min(radius, rmax), reading the gather space by exactly the rule
//      of ops/gather.py (rows and columns clamped to the octave, the twin
//      block from the window start x0 = xc - r - 1, the layer clamp of the
//      layer-minor order);
//   3. walks its window in tiles of 128 samples in row-major order (row
//      offset i, then column offset j): each thread computes one sample as
//      the plain path does (reciprocal-multiply rotation, the separable
//      gaussian with a true division, atan2f, the two fmodf, the bins, the
//      mask), then the samples with m > 0 are listed per spatial cell
//      (4 x 4) in ascending sample order (warp ballots, no atomics), and
//      thread k owns histogram bin k = (row * 4 + col) * 8 + ori: it adds
//      ((m * f_r) * f_c) * f_o of every listed sample of its cell, in list
//      order;
//   4. normalises as hist_to_desc does (L2, clip at 0.2, L2, floor(512 v),
//      at most 255), each sum of squares a fixed tree over the 128 bins
//      (s[k] += s[k + w] for w = 64, 32, ..., 1), and writes its bytes.
//
// So each bin is the sum of its contributions in row-major sample order.
// A sample that is masked, or has m = 0, adds an exact +0 to a sum of
// non-negative terms, so skipping it changes no bit, and a lane's bytes do
// not depend on any window larger than its own: they depend on the lane
// alone, whatever route or batch it comes from.  No floating-point atomic
// is used and the result is the same on every launch.  The order is
// modelled in plain PyTorch by ops/describe.py::describe_ordered_plain, which
// mirrors the index rule and the argument struct below; every product,
// sum and division here is an explicit _rn intrinsic (and -fmad=false),
// so nothing is contracted into a multiply-add.
//
// What bounds it: per valid lane one read of its patch (at most 83^2 floats
// at the default radius bound 40) and 128 bytes written, against about 30
// float operations a window sample plus atan2f, two fmodf and a square root
// for each sample inside the histogram's square: the window's samples, not
// the bytes, set the floor (PERF.md's kernel table gives both).

#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 128
#define NBINS 128
#define NCELLS 16
#define MAXV 16  // volumes (octaves) of a gather space

enum { MODE_STACK = 0, MODE_ROWS = 1, MODE_STRIPS = 2, MODE_LAYER_MINOR = 3 };

// Mirrors ops/describe.py::_Args field by field.
struct DescArgs {
  long long rt;          // per image: rows of a MultiRows buffer, elements of a stack space
  long long base[MAXV];  // each volume's first row (MultiRows) or element (stack space)
  int mode, nvol, blk, l0;
  int H[MAXV], W[MAXV], nb[MAXV], ls[MAXV], nl[MAXV];
  float pow_denom[MAXV], diag[MAXV];
  int n;       // lanes per image
  int lanes;   // B * n
  int o0;      // octave of volume 0
  int s_max;   // the layer clamp: S - 1
  int rmax;    // window radius bound
  // float32 constants, each the float that PyTorch makes of the program's
  // Python number: the scale factor, sqrt(2), 2 pi, 8 / (2 pi), 0.2.
  float dsf, sqrt2, pi2, obin, thr;
};

// The flat offset of element (s, y, x) of volume o of image img: the index
// rule of ops/gather.py (StackSpace.index, MultiRows.index, _twin_block).
__device__ __forceinline__ long long space_index(const DescArgs& a, int o, long long img,
                                                 int s, int y, int x, int x0) {
  if (a.mode == MODE_STACK)
    return img * a.rt + a.base[o] + ((long long)s * a.H[o] + y) * a.W[o] + x;
  const int blk = a.blk;
  const int nb = a.nb[o];
  const int b = max(min(max(x0, 0) / blk, nb - 1), x / blk - 1);
  long long local;
  if (a.mode == MODE_ROWS) {
    local = ((long long)s * a.H[o] + y) * nb + b;
  } else {
    const int ls = a.ls[o];
    const long long low = (1LL << ls) - 1;
    if (a.mode == MODE_STRIPS) {
      const long long r = (long long)s * a.H[o] + y;
      local = ((((r >> ls) * nb) + b) << ls) + (r & low);
    } else {
      const int nl = a.nl[o];
      const int sc = min(max(s, a.l0), a.l0 + nl - 1);
      const long long group = ((long long)(y >> ls) * nl + sc) * nb;
      local = ((group + b) << ls) + (y & low);
    }
  }
  return (img * a.rt + a.base[o] + local) * (2 * blk) + x - (long long)b * blk;
}

// The fixed-order sum of red[0..127]: s[k] += s[k + w], w = 64, 32, ..., 1.
__device__ __forceinline__ float tree_sum(float* red, float v, int t) {
  red[t] = v;
  __syncthreads();
#pragma unroll
  for (int w = NBINS / 2; w > 0; w >>= 1) {
    if (t < w) red[t] = __fadd_rn(red[t], red[t + w]);
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(NTHREADS) describe_kernel(
    const __grid_constant__ DescArgs a, const float* __restrict__ flat,
    const float* __restrict__ kx, const float* __restrict__ ky,
    const float* __restrict__ ksize, const float* __restrict__ kpori,
    const int* __restrict__ koct, const int* __restrict__ klayer,
    const uint8_t* __restrict__ valid, uint8_t* __restrict__ out) {
  extern __shared__ float dyn[];  // the patch, (2 rmax + 3)^2, then g1, 2 rmax + 1
  __shared__ float fr0[NTHREADS], fr1[NTHREADS], fc0[NTHREADS], fc1[NTHREADS];
  __shared__ float fo0[NTHREADS], fo1[NTHREADS], red[NBINS];
  __shared__ int bins[NTHREADS];
  __shared__ int cnt[NTHREADS / 32][NCELLS];
  __shared__ uint8_t list[NCELLS][NTHREADS];

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  uint8_t* dst = out + (long long)lane * NBINS;
  if (!valid[lane]) {
    dst[t] = 0;
    return;
  }

  // 1. The lane's arguments (models/descriptor.py::_lane_args).
  const long long img = lane / a.n;
  const int o = min(max(koct[lane] - a.o0, 0), a.nvol - 1);
  const float pd = a.pow_denom[o];
  const int x = (int)__fmul_rn(kx[lane], pd);  // C truncation
  const int y = (int)__fmul_rn(ky[lane], pd);
  const float hist_width = __fmul_rn(a.dsf, __fmul_rn(ksize[lane], pd));
  const float hw = hist_width > 0.f ? hist_width : 1.f;
  float tr = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(hist_width, 0.5f), a.sqrt2), 5.0f), 0.5f);
  tr = tr >= 0.f ? floorf(__fadd_rn(tr, 0.5f)) : ceilf(__fsub_rn(tr, 0.5f));
  const int radius = (int)fminf(tr, a.diag[o]);
  const int W = a.W[o], H = a.H[o];
  const int layer = min(max(klayer[lane], 0), a.s_max);
  const int xc = min(max(x, 0), W - 1), yc = min(max(y, 0), H - 1);
  const float pori = kpori[lane];
  const float ca = cosf(pori), sa = sinf(pori);
  const float inv = __fdiv_rn(1.0f, hw);
  const float coef = __fdiv_rn(__fmul_rn(inv, inv), 8.0f);
  const int r = max(min(radius, a.rmax), 0);
  const int side = 2 * r + 1, ps = side + 2;
  float* patch = dyn;
  float* g1 = dyn + (2 * a.rmax + 3) * (2 * a.rmax + 3);

  // 2. The patch: rows yc - r - 1 .., columns x0 = xc - r - 1 .., clamped.
  const int ys0 = yc - r - 1, xs0 = xc - r - 1;
  for (int q = t; q < ps * ps; q += NTHREADS) {
    const int pa = q / ps, pb = q - pa * ps;
    const int yy = min(max(ys0 + pa, 0), H - 1);
    const int xx = min(max(xs0 + pb, 0), W - 1);
    patch[q] = flat[space_index(a, o, img, layer, yy, xx, xs0)];
  }
  for (int k = t; k < side; k += NTHREADS) {
    const float o2 = (float)((k - r) * (k - r));
    g1[k] = expf(__fmul_rn(-o2, coef));
  }
  __syncthreads();

  // 3. The histogram, tile by tile.
  const int warp = t >> 5, wl = t & 31;
  const unsigned below = (1u << wl) - 1u;
  const int my_cell = t >> 3, my_r = t >> 5, my_c = (t >> 3) & 3, my_o = t & 7;
  float h = 0.f;
  const int nsamp = side * side;
  for (int tile = 0; tile < nsamp; tile += NTHREADS) {
    const int q = tile + t;
    bool hit = false;
    int br = 0, bc = 0;
    if (q < nsamp) {
      const int i = q / side - r, j = q - (q / side) * side - r;
      const float fi = (float)i, fj = (float)j;
      const float row_rot = __fmul_rn(__fadd_rn(__fmul_rn(fj, sa), __fmul_rn(fi, ca)), inv);
      const float col_rot = __fmul_rn(__fsub_rn(__fmul_rn(fj, ca), __fmul_rn(fi, sa)), inv);
      const float row_bin = __fsub_rn(__fadd_rn(row_rot, 2.0f), 0.5f);
      const float col_bin = __fsub_rn(__fadd_rn(col_rot, 2.0f), 0.5f);
      const int nx = x + j, ny = y + i;
      const bool on = row_bin > -1.f && row_bin < 4.f && col_bin > -1.f && col_bin < 4.f &&
                      nx > 0 && nx < W - 1 && ny > 0 && ny < H - 1 && radius >= 0;
      if (on) {
        const int c = (i + r + 1) * ps + (j + r + 1);
        const float dx = __fsub_rn(patch[c + 1], patch[c - 1]);
        const float dy = __fsub_rn(patch[c - ps], patch[c + ps]);
        const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        float ang = __fsub_rn(atan2f(dy, dx), pori);
        ang = fmodf(__fadd_rn(fmodf(ang, a.pi2), a.pi2), a.pi2);
        const float ori_bin = __fmul_rn(ang, a.obin);
        const float m = __fmul_rn(mag, __fmul_rn(g1[i + r], g1[j + r]));
        hit = m > 0.f;
        if (hit) {
          const float fbr = floorf(row_bin), fbc = floorf(col_bin), fbo = floorf(ori_bin);
          const float dr = __fsub_rn(row_bin, fbr), dc = __fsub_rn(col_bin, fbc);
          const float dob = __fsub_rn(ori_bin, fbo);
          br = (int)fbr;
          bc = (int)fbc;
          fr0[t] = __fmul_rn(m, __fsub_rn(1.0f, dr));
          fr1[t] = __fmul_rn(m, dr);
          fc0[t] = __fsub_rn(1.0f, dc);
          fc1[t] = dc;
          fo0[t] = __fsub_rn(1.0f, dob);
          fo1[t] = dob;
          bins[t] = (br + 1) | ((bc + 1) << 4) | ((int)fbo << 8);
        }
      }
    }
    // The listed samples of each cell, in ascending sample order.
    unsigned bal[NCELLS];
#pragma unroll
    for (int k = 0; k < NCELLS; ++k) {
      const int kr = k >> 2, kc = k & 3;
      bal[k] = __ballot_sync(0xffffffffu,
                             hit && (kr == br || kr == br + 1) && (kc == bc || kc == bc + 1));
      if (wl == 0) cnt[warp][k] = __popc(bal[k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NCELLS; ++k) {
      if (bal[k] >> wl & 1u) {
        int at = __popc(bal[k] & below);
        for (int w = 0; w < warp; ++w) at += cnt[w][k];
        list[k][at] = (uint8_t)t;
      }
    }
    __syncthreads();
    int len = 0;
#pragma unroll
    for (int w = 0; w < NTHREADS / 32; ++w) len += cnt[w][my_cell];
    for (int e = 0; e < len; ++e) {
      const int s = list[my_cell][e];
      const int code = bins[s];
      const int sr = (code & 15) - 1, sc = ((code >> 4) & 15) - 1, so = code >> 8;
      const float f_r = sr == my_r ? fr0[s] : fr1[s];
      const float f_c = sc == my_c ? fc0[s] : fc1[s];
      const float f_o = (so & 7) == my_o ? fo0[s] : (((so + 1) & 7) == my_o ? fo1[s] : 0.f);
      h = __fadd_rn(h, __fmul_rn(__fmul_rn(f_r, f_c), f_o));
    }
    __syncthreads();
  }

  // 4. hist_to_desc with fixed-order norms.
  const float n1 = __fsqrt_rn(tree_sum(red, __fmul_rn(h, h), t));
  const float inv1 = n1 > 0.f ? __fdiv_rn(1.0f, n1) : 0.f;
  const float hn = fminf(__fmul_rn(h, inv1), a.thr);
  const float n2 = __fsqrt_rn(tree_sum(red, __fmul_rn(hn, hn), t));
  const float inv2 = n2 > 0.f ? __fdiv_rn(1.0f, n2) : 0.f;
  const int v = (int)floorf(__fmul_rn(__fmul_rn(512.0f, hn), inv2));
  dst[t] = (uint8_t)min(v, 255);
}

extern "C" int describe_launch(const DescArgs* args, const float* flat, const float* x,
                               const float* y, const float* size, const float* pori,
                               const int* octave, const int* layer, const uint8_t* valid,
                               uint8_t* out, void* stream) {
  const DescArgs a = *args;
  if (a.lanes < 1 || a.n < 1 || a.nvol < 1 || a.nvol > MAXV || a.rmax < 0 ||
      a.mode < MODE_STACK || a.mode > MODE_LAYER_MINOR || (a.mode != MODE_STACK && a.blk < 1))
    return (int)cudaErrorInvalidValue;
  const int ps = 2 * a.rmax + 3;
  const size_t smem = (size_t)(ps * ps + 2 * a.rmax + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        describe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  describe_kernel<<<a.lanes, NTHREADS, smem, (cudaStream_t)stream>>>(
      a, flat, x, y, size, pori, octave, layer, valid, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel K: orientation assignment (src/sift.cpp:447-533) of a refined
// keypoint buffer in one launch.
//
// Replaces no TPU kernel: the JAX package assigns orientations with XLA
// (sift_tpu/models/orient.py::orient_all).  The plain chain that the CPU
// and float64 keep (models/orient.py::orient_plain) is a one-hot
// contraction per radius class and lane chunk, 2 x 36 elementwise launches
// of in-order smoothing, the peaks' own launches, and host reads to compact
// the lanes and size the classes: on the card its launches and waits, not
// the card, would set the stage's pace.
//
// One warp a lane of the (B * n) buffer, ORI_WARPS lanes a CTA.  An invalid
// lane writes its slots (the lane's fields, pori 0, not valid) and leaves.
// A valid lane:
//   1. computes in registers what _lane_args computed per lane: the octave's
//      scale (I's pow_denom times halve: 1 / 2^octave), x and y rounded half
//      away, the scale, the radius (rounded half away), the gaussian's
//      denominator, the clamped centre and layer;
//   2. stages its own (2r + 3)^2 patch of its gauss layer in shared memory,
//      r = min(radius, rmax), by I's index rule, and the 2r + 1 factors of
//      the separable gaussian exp(-o^2 / edenom) (true division, expf);
//   3. walks its window in tiles of 32 samples in row-major order (row
//      offset i, then column offset j): each thread computes one sample as
//      the plain chain does (gradients, sqrt, atan2f, the bin rounded half
//      away with a true division, the image mask), then the tile's samples
//      with a non-zero contribution are broadcast one by one in sample order
//      (warp shuffles, no atomics) to the thread that owns their bin (bin b:
//      thread b % 32), which adds them: each bin is the sum of its
//      contributions in row-major sample order;
//   4. smooths the histogram in place, twice, bin by bin, as the reference's
//      loop does (one thread, (0.25 h[i-1] + 0.5 h[i]) + 0.25 h[i+1]);
//   5. marks the peaks above ratio * max, interpolates them by the parabola
//      (true division, the two fmodf of the plain chain), ranks them in bin
//      order (ballots) and writes its first `slots` of them; the count of
//      peaks goes to max_peaks by an integer atomicMax (order-free; the
//      launcher zeroes max_peaks first).
//
// A sample that is masked, or contributes +0, adds an exact +0 to a sum of
// non-negative terms, so skipping it changes no bit: a lane's candidates
// depend on the lane alone, whatever its batch, route or window.  No
// floating-point atomic is used.  The order is modelled in plain PyTorch
// by ops/orient.py::orient_ordered_plain (the plain chain's arguments,
// patches and samples, each bin summed in this order); every product, sum
// and division is an explicit _rn intrinsic (and -fmad=false).
//
// What bounds it: per valid lane one read of its patch (at most 37^2
// floats at the default radius bound 17) and its slots written once,
// against about 40 float operations a window sample plus atan2f and a
// square root: the samples, not the bytes, set the floor (PERF.md's kernel
// table gives both).

#define ORI_WARPS 4
#define ORI_THREADS (32 * ORI_WARPS)
#define MAXBINS 64
#define MAXSLOTS 32
#define SMOOTH_ITERATIONS 2

// Mirrors ops/orient.py::_OriArgs field by field: the stage's constants,
// each the float that PyTorch makes of the program's Python number.
struct OriArgs {
  int nbins;    // histogram bins
  int slots;    // candidate slots a lane
  float sigma;  // ori_sigma_factor
  float ratio;  // peak_ratio
  float pi;     // pi
  float halve;  // 0.5 where the input image was doubled, else 1
};

// C++ std::round of a float: half away from zero (numerics.round_half_away).
__device__ __forceinline__ int round_away(float v) {
  return (int)(v >= 0.f ? floorf(__fadd_rn(v, 0.5f)) : ceilf(__fsub_rn(v, 0.5f)));
}

__global__ void __launch_bounds__(ORI_THREADS) orient_kernel(
    const __grid_constant__ DescArgs a, const __grid_constant__ OriArgs g,
    const float* __restrict__ flat, const float* __restrict__ kx,
    const float* __restrict__ ky, const float* __restrict__ ksize,
    const int* __restrict__ koct, const int* __restrict__ klayer,
    const uint8_t* __restrict__ valid, float* __restrict__ cx, float* __restrict__ cy,
    float* __restrict__ csize, int* __restrict__ coct, int* __restrict__ clayer,
    float* __restrict__ cpori, uint8_t* __restrict__ cvalid, int* __restrict__ max_peaks) {
  extern __shared__ float dyn[];  // per warp: the patch, (2 rmax + 3)^2, then g1, 2 rmax + 1
  __shared__ float hist[ORI_WARPS][MAXBINS];
  __shared__ float peak_ori[ORI_WARPS][MAXSLOTS];

  const unsigned full = 0xffffffffu;
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const long long lane = (long long)blockIdx.x * ORI_WARPS + w;
  if (lane >= a.lanes) return;
  const int nb = g.nbins;
  const long long out0 = lane * g.slots;

  // The fields every slot of the lane repeats (the plain chain's rep(kp.x * halve)).
  const float hx = __fmul_rn(kx[lane], g.halve), hy = __fmul_rn(ky[lane], g.halve);
  const float hs = __fmul_rn(ksize[lane], g.halve);
  const int oct = koct[lane], lay = klayer[lane];
  if (!valid[lane]) {
    if (t < g.slots) {
      cx[out0 + t] = hx;
      cy[out0 + t] = hy;
      csize[out0 + t] = hs;
      coct[out0 + t] = oct;
      clayer[out0 + t] = lay;
      cpori[out0 + t] = 0.f;
      cvalid[out0 + t] = 0;
    }
    return;
  }

  // 1. The lane's arguments (models/orient.py::_lane_args).
  const long long img = lane / a.n;
  const int o = min(max(oct - a.o0, 0), a.nvol - 1);
  const float pd = __fmul_rn(a.pow_denom[o], g.halve);
  const int x = round_away(__fmul_rn(kx[lane], pd));
  const int y = round_away(__fmul_rn(ky[lane], pd));
  const float scale = __fmul_rn(g.sigma, __fmul_rn(ksize[lane], pd));
  const int radius = round_away(__fmul_rn(3.0f, scale));
  const float edenom = __fmul_rn(__fmul_rn(2.0f, scale), scale);
  const int W = a.W[o], H = a.H[o];
  const int layer = min(max(lay, 0), a.s_max);
  const int xc = min(max(x, 0), W - 1), yc = min(max(y, 0), H - 1);
  const int r = max(min(radius, a.rmax), 0);
  const int side = 2 * r + 1, ps = side + 2;
  const int pmax = 2 * a.rmax + 3;
  float* patch = dyn + (long long)w * (pmax * pmax + 2 * a.rmax + 1);
  float* g1 = patch + pmax * pmax;

  // 2. The patch: rows yc - r - 1 .., columns x0 = xc - r - 1 .., clamped.
  const int ys0 = yc - r - 1, xs0 = xc - r - 1;
  for (int q = t; q < ps * ps; q += 32) {
    const int pa = q / ps, pb = q - pa * ps;
    const int yy = min(max(ys0 + pa, 0), H - 1);
    const int xx = min(max(xs0 + pb, 0), W - 1);
    patch[q] = flat[space_index(a, o, img, layer, yy, xx, xs0)];
  }
  for (int k = t; k < side; k += 32) {
    const float o2 = (float)((k - r) * (k - r));
    g1[k] = expf(__fdiv_rn(-o2, edenom));
  }
  __syncwarp();

  // 3. The histogram, tile by tile; thread t owns bins t and t + 32.
  const float nbf = (float)nb;
  float h0 = 0.f, h1 = 0.f;
  const int nsamp = side * side;
  for (int tile = 0; tile < nsamp; tile += 32) {
    const int q = tile + t;
    int bin = 0;
    float c = 0.f;
    if (q < nsamp) {
      const int qi = q / side;
      const int i = qi - r, j = q - qi * side - r;
      const int nx = x + j, ny = y + i;
      if (abs(i) <= radius && abs(j) <= radius && nx - 1 >= 0 && nx + 1 <= W - 1 &&
          ny - 1 >= 0 && ny + 1 <= H - 1) {
        const int cc = (i + r + 1) * ps + (j + r + 1);
        const float dx = __fsub_rn(patch[cc + 1], patch[cc - 1]);
        const float dy = __fsub_rn(patch[cc - ps], patch[cc + ps]);
        const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        const float v = __fdiv_rn(__fmul_rn(nbf, __fadd_rn(atan2f(dy, dx), g.pi)), a.pi2);
        bin = round_away(v);
        if (bin >= nb) bin = 0;  // src/sift.cpp:490
        c = __fmul_rn(__fmul_rn(g1[i + r], g1[j + r]), mag);
      }
    }
    unsigned m = __ballot_sync(full, c > 0.f);
    while (m) {
      const int s = __ffs(m) - 1;
      m &= m - 1;
      const int b = __shfl_sync(full, bin, s);
      const float cs = __shfl_sync(full, c, s);
      if (b == t) h0 = __fadd_rn(h0, cs);
      if (b == t + 32) h1 = __fadd_rn(h1, cs);
    }
  }
  float* h = hist[w];
  if (t < nb) h[t] = h0;
  if (t + 32 < nb) h[t + 32] = h1;
  __syncwarp();

  // 4. In-place circular smoothing, twice: updated bins feed later ones.
  if (t == 0) {
    for (int it = 0; it < SMOOTH_ITERATIONS; ++it)
      for (int i = 0; i < nb; ++i) {
        const float prev = h[i == 0 ? nb - 1 : i - 1], next = h[i == nb - 1 ? 0 : i + 1];
        h[i] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, prev), __fmul_rn(0.5f, h[i])),
                         __fmul_rn(0.25f, next));
      }
  }
  __syncwarp();

  // 5. Peaks above ratio * max, interpolated, the first `slots` in bin order.
  float mx = 0.f;
  for (int b = t; b < nb; b += 32) mx = fmaxf(mx, h[b]);
  for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(full, mx, d));
  const float thr = __fmul_rn(g.ratio, mx);
  bool pk[2] = {false, false};
  float ori[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int b = t + 32 * u;
    if (b < nb) {
      const float hb = h[b], hm = h[b == 0 ? nb - 1 : b - 1], hp = h[b == nb - 1 ? 0 : b + 1];
      pk[u] = hb > hm && hb > hp && hb > thr;
      const float den = __fadd_rn(__fsub_rn(hm, __fmul_rn(2.0f, hb)), hp);
      const float ds = den == 0.f ? 1.0f : den;
      float ip = __fadd_rn((float)b, __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(hm, hp)), ds));
      ip = fmodf(__fadd_rn(ip, nbf), nbf);
      const float oo = __fdiv_rn(__fmul_rn(a.pi2, ip), nbf);
      ori[u] = fmodf(__fadd_rn(oo, a.pi2), a.pi2);
    }
  }
  const unsigned p0 = __ballot_sync(full, pk[0]), p1 = __ballot_sync(full, pk[1]);
  const unsigned below = (1u << t) - 1u;
  const int count = __popc(p0) + __popc(p1);
  const int rank0 = __popc(p0 & below), rank1 = __popc(p0) + __popc(p1 & below);
  if (pk[0] && rank0 < g.slots) peak_ori[w][rank0] = ori[0];
  if (pk[1] && rank1 < g.slots) peak_ori[w][rank1] = ori[1];
  __syncwarp();
  if (t < g.slots) {
    const bool ok = t < count;
    cx[out0 + t] = hx;
    cy[out0 + t] = hy;
    csize[out0 + t] = hs;
    coct[out0 + t] = oct;
    clayer[out0 + t] = lay;
    cpori[out0 + t] = ok ? peak_ori[w][t] : 0.f;
    cvalid[out0 + t] = ok ? 1 : 0;
  }
  if (t == 0) atomicMax(max_peaks, count);
}

extern "C" int orient_launch(const DescArgs* args, const OriArgs* oargs, const float* flat,
                             const float* x, const float* y, const float* size,
                             const int* octave, const int* layer, const uint8_t* valid,
                             float* cx, float* cy, float* csize, int* coct, int* clayer,
                             float* cpori, uint8_t* cvalid, int* max_peaks, void* stream) {
  const DescArgs a = *args;
  const OriArgs g = *oargs;
  if (a.lanes < 1 || a.n < 1 || a.nvol < 1 || a.nvol > MAXV || a.rmax < 0 ||
      a.mode < MODE_STACK || a.mode > MODE_LAYER_MINOR || (a.mode != MODE_STACK && a.blk < 1) ||
      g.nbins < 1 || g.nbins > MAXBINS || g.slots < 1 || g.slots > MAXSLOTS)
    return (int)cudaErrorInvalidValue;
  const int pmax = 2 * a.rmax + 3;
  const size_t smem = (size_t)ORI_WARPS * (pmax * pmax + 2 * a.rmax + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        orient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // max_peaks starts at 0 for the lanes' atomicMax.
  const cudaError_t z = cudaMemsetAsync(max_peaks, 0, sizeof(int), (cudaStream_t)stream);
  if (z != cudaSuccess) return (int)z;
  const unsigned blocks = (unsigned)((a.lanes + ORI_WARPS - 1) / ORI_WARPS);
  orient_kernel<<<blocks, ORI_THREADS, smem, (cudaStream_t)stream>>>(
      a, g, flat, x, y, size, octave, layer, valid, cx, cy, csize, coct, clayer, cpori, cvalid,
      max_peaks);
  return (int)cudaGetLastError();
}
