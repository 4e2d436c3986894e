// Banded bilinear warp for Hopper (sm_90a): forward (K2), grid gradient
// (K3) and image gradient (K4) of grid_sample(padding_mode="border") on
// coordinates that the caller has already clamped into the image and into a
// K-row band.
//
// Replaces the TPU kernels of polardepth_tpu/ops/pallas/band_warp.py:
//   K2  _pallas_fwd (:356), pl.pallas_call at :376, body _fwd_kernel (:158)
//   K3  _band_bwd (:392), pl.pallas_call at :417, body _bwd_kernel (:217)
// K4 has no TPU kernel: the JAX custom VJP returns a zero image cotangent
// (:350-351), and the JAX package's exact routes get the image gradient
// from XLA's autodiff of a gather.
//
// What the TPU kernels did and why none of it carries over.  The TPU gathers
// slowly, so K2 fetched a (K*C, W+1) row band per output row by DMA and did
// the horizontal lerp as a one-hot MXU product, with bf16 hi/lo operand
// splits to keep f32 accuracy; K3 contracted the same band with +-1 one-hot
// matrices.  What decides the function is only the coordinate clamp done
// before the kernel (ops/band_warp.py:_prep): ix in [0, W-1], iy in
// [0, H-1] and then in [base, base+K-1].  On those coordinates K2 is plain
// bilinear sampling whose x1 = min(x0+1, W-1) tap is the TPU's edge-pad
// column and whose y1 = min(y0+1, H-1) tap has weight 0 wherever it leaves
// the band.  K3 keeps the TPU's own conventions, which are not the autograd
// of a gather: d/dix is the one-hot difference at x0 = floor(ix) (0 at
// ix = W-1), and d/diy is t[y1] - t[y0] where fy > 0 and 0 where iy is an
// integer (-sign(dy) on |dy| < 1, sign(0) = 0).  The image gets no gradient.
//
// What bounds it on the H100: bytes.  Per output pixel K2 reads ix, iy (8 B)
// and writes C floats; the image (C floats per source pixel) is read once
// from device memory and its 4 taps per pixel hit L1/L2, since neighbouring
// output pixels sample neighbouring source pixels.  K3 reads ix, iy, the
// cotangent g (C floats) and the image, and writes dix, diy (8 B).  A few
// dozen flops per pixel are far below the arithmetic rate.  f32 throughout,
// channels last in and out, no transposes around the kernels (the TPU wrote
// (B, OH, C, OW) and transposed after).  K2 has two layouts, each keeping
// every warp's accesses within a contiguous span, with the batch on the grid's y so
// that no pixel divides by the image size:
//   - C = 1 and C = 3 (the training warps): one thread per pixel, each
//     storing its C floats from registers; a warp's C stores cover 128·C
//     contiguous bytes between them.  (Staging C = 3 tiles through shared
//     memory for 16-byte stores bought 2% on the H100.)
//   - C a multiple of 4 (the plane sweep's C = 64 feature channels): lanes
//     over channels, C/4 lanes a pixel.  Each lane reads its float4 of each
//     of the four taps and stores its float4, so a pixel's group reads and
//     writes 4C contiguous bytes (256 B at C = 64).  One thread per pixel
//     stored C floats 4C bytes apart across a warp.  The stores stream
//     (__stcs, evict first): the plane sweep writes 472 MB, nine times the
//     L2, and the image it gathers from (29 MB) should stay there.
// C = 1, 3, 4 and 64 are compiled for their C; any other C takes the same
// layouts with C read at run time, and C not in {1, 3} and not a multiple
// of 4 takes one thread per pixel with scalar stores.  K3 is one thread per
// pixel: it reads g as the forward writes out, and writes two floats.
//
// K4, the image gradient, is the transpose of K2: each output pixel adds
// its cotangent times the four bilinear weights into the same four clamped
// taps that K2 reads, d img[y0, x0] += (1-fx)(1-fy) g and so on.  Several
// output pixels hit one source pixel, so the sums are formed with atomics,
// into a buffer that the launcher zeroes first on the same stream.  Its
// bound is bytes: it reads g, ix and iy once and writes the gradient once.
//
// What bounded the first design: the L2's rate of atomic operations, not
// bytes.  One thread per output pixel sent each pixel's four taps straight
// to device memory: 4C scalar atomics (22 M at the training shape,
// (12, 320, 480, 3)) took 0.29 ms on the H100, then 2 to 4 vector atomics
// of sm_90 per tap row (7-15 M) 0.14 ms, 8x the byte bound: neighbouring
// pixels hit the same or adjacent source pixels and their adds meet, and
// queue, in L2.
//
// This design sums in shared memory first.  A block takes a tile of 8 x 32
// output pixels, one pixel a thread and one warp an output row; the batch
// is on the grid's y, so no pixel divides by the image size.  Each warp
// reduces its pixels' clamped taps to their extent and the sums of their
// (y0, x0); warp 0 reduces the warps' and opens a window of the source: at
// most kWinCols = 64 columns and kWinFloats = 6144 floats (24 KB: 64 x 32
// pixels at C = 3), the extent itself where it fits, else a part of it
// centred on the mean tap (robust to a few far taps) and clipped into it.
// A tap inside the window goes into it with a shared-memory atomicAdd;
// after a barrier each warp adds window rows into the gradient, each row
// segment (cols x C contiguous floats) as 16-byte red.global.add.v4.f32
// from its first 16-byte boundary, 8-byte or 4-byte ones at its ends,
// all-zero vectors not sent.  Blocks' windows overlap at their edges, so
// the flush stays atomic.
//
// A tap outside the window spills: it goes straight to device memory, in
// the same launch, with the first design's vector atomics (red_add).  Grids
// whose taps spread further than the window (the random-depth parallax
// grid, up to ~130 px) spill; so does every tap where C > 6144.  Before a
// spill, the lanes of a warp that hit the same tap (a border column onto
// which clamping sends a whole row) are found with __match_any_sync and
// summed into the lowest lane by shuffles, in lane order: one atomic per
// tap per warp instead of 32.  A zero product is never sent, on either
// route, nor is a window cell left at 0 flushed: adding 0 to a sum that
// started at +0 leaves it as it was, bit for bit.  C = 3 (the colour frames
// res_pose re-warps) is compiled for its C; any other C reads it at run
// time.  A second build of each (COUNT) also counts the taps, the spills
// and the windows' floats, for the wrapper's counted launch; the
// training path launches the first.
//
// What bounds it now (H100, (12, 320, 480, 3); PERF.md): the L2's atomics
// no longer, but the SM's instructions and its shared-memory adds.  sm_90
// has no shared-memory float add: atomicAdd there compiles to a load, an
// add and a compare-and-swap in a loop (ATOMS.CAST.SPIN), 12 of them a
// pixel at C = 3.  The block-wide reductions are done once, by warp 0, in
// 32-bit integers (the launcher refuses H or W of 2^23 or more), and
// __launch_bounds__ holds 32 registers, for 8 blocks an SM.
//
// Rounding: built with -fmad=false and written in the order of the plain
// torch versions in ops/band_warp.py, so the two agree to the last bit or
// within a few ulps (the channel sums of K3).  K4's products are the plain
// version's to the bit, but its sums (shared-memory atomics, a warp's
// combined spills, the flush) run in another order, which changes from run
// to run; for any order of a pixel's n products the sum lies within
// 2 (n - 1) u of their magnitude sum of the plain version's.
//
// Plain C interface for ctypes (ops/build.py).  Each launch function checks
// its arguments, launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  const float* r0;  // source row y0 of this pixel's image
  const float* r1;  // source row y1 = min(y0 + 1, H - 1)
  int x0;           // column offsets (times C) of x0 and x1 = min(x0+1, W-1)
  int x1;
  float fx;
  float fy;
};

// plane: the pixel's image (H, W, C)
__device__ __forceinline__ Taps taps(const float* __restrict__ plane, float x,
                                     float y, int H, int W, int C) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Taps t;
  t.fx = x - x0f;
  t.fy = y - y0f;
  // memory safety only: the caller's coordinates lie in [0, W-1] x [0, H-1]
  const int x0 = min(max(static_cast<int>(x0f), 0), W - 1);
  const int y0 = min(max(static_cast<int>(y0f), 0), H - 1);
  t.r0 = plane + static_cast<long long>(y0) * W * C;
  t.r1 = plane + static_cast<long long>(min(y0 + 1, H - 1)) * W * C;
  t.x0 = x0 * C;
  t.x1 = min(x0 + 1, W - 1) * C;
  return t;
}

// The bilinear value of one channel, in the plain version's order.
__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float t0 = (1.0f - fx) * v00 + fx * v01;
  const float t1 = (1.0f - fx) * v10 + fx * v11;
  return (1.0f - fy) * t0 + fy * t1;
}

// K2, one thread per output pixel.  CT > 0 fixes the channel count at
// compile time; CT == 0 reads it from C.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    band_warp_fwd_pixel(const float* __restrict__ img,
                        const float* __restrict__ ix,
                        const float* __restrict__ iy, float* __restrict__ out,
                        int B, int H, int W, int C_rt, int per_image) {
  const int C = CT > 0 ? CT : C_rt;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* plane = img + static_cast<long long>(b) * H * W * C;
    const long long pix0 = static_cast<long long>(b) * per_image;
    for (long long q = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         q < per_image; q += static_cast<long long>(gridDim.x) * kThreads) {
      const long long p = pix0 + q;
      const Taps t = taps(plane, __ldg(ix + p), __ldg(iy + p), H, W, C);
      float* o = out + p * C;
#pragma unroll
      for (int c = 0; c < C; ++c)
        o[c] = lerp4(__ldg(t.r0 + t.x0 + c), __ldg(t.r0 + t.x1 + c),
                     __ldg(t.r1 + t.x0 + c), __ldg(t.r1 + t.x1 + c), t.fx,
                     t.fy);
    }
  }
}

// K2, lanes over channels: C = 4 * L, L lanes a pixel, each lane one float4
// of every tap and of the output.  LT > 0 fixes L at compile time.  img and
// out must be 16-byte aligned.
template <int LT>
__global__ void __launch_bounds__(kThreads)
    band_warp_fwd_lanes(const float* __restrict__ img,
                        const float* __restrict__ ix,
                        const float* __restrict__ iy, float* __restrict__ out,
                        int B, int H, int W, int L_rt, int per_image) {
  const int L = LT > 0 ? LT : L_rt;
  const int C = 4 * L;
  const long long items = static_cast<long long>(per_image) * L;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* plane = img + static_cast<long long>(b) * H * W * C;
    const long long pix0 = static_cast<long long>(b) * per_image;
    for (long long q = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         q < items; q += static_cast<long long>(gridDim.x) * kThreads) {
      const long long p = pix0 + q / L;
      const int lane4 = 4 * static_cast<int>(q % L);
      const Taps t = taps(plane, __ldg(ix + p), __ldg(iy + p), H, W, C);
      const float* r0 = t.r0 + lane4;
      const float* r1 = t.r1 + lane4;
      const float4 v00 = __ldg(reinterpret_cast<const float4*>(r0 + t.x0));
      const float4 v01 = __ldg(reinterpret_cast<const float4*>(r0 + t.x1));
      const float4 v10 = __ldg(reinterpret_cast<const float4*>(r1 + t.x0));
      const float4 v11 = __ldg(reinterpret_cast<const float4*>(r1 + t.x1));
      float4 o;
      o.x = lerp4(v00.x, v01.x, v10.x, v11.x, t.fx, t.fy);
      o.y = lerp4(v00.y, v01.y, v10.y, v11.y, t.fx, t.fy);
      o.z = lerp4(v00.z, v01.z, v10.z, v11.z, t.fx, t.fy);
      o.w = lerp4(v00.w, v01.w, v10.w, v11.w, t.fx, t.fy);
      __stcs(reinterpret_cast<float4*>(out + p * C + lane4), o);
    }
  }
}

template <int CT>
__global__ void __launch_bounds__(kThreads)
    band_warp_bwd_kernel(const float* __restrict__ img,
                         const float* __restrict__ ix,
                         const float* __restrict__ iy,
                         const float* __restrict__ g, float* __restrict__ dix,
                         float* __restrict__ diy, int H, int W, int C_rt,
                         long long per_image, long long n) {
  const int C = CT > 0 ? CT : C_rt;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < n; p += stride) {
    const Taps t = taps(img + (p / per_image) * H * W * C, ix[p], iy[p], H, W,
                        C);
    const float gx = 1.0f - t.fx;
    const float gy = 1.0f - t.fy;
    const float* gp = g + p * C;
    float sx = 0.0f;
    float sy = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v00 = __ldg(t.r0 + t.x0 + c);
      const float v01 = __ldg(t.r0 + t.x1 + c);
      const float v10 = __ldg(t.r1 + t.x0 + c);
      const float v11 = __ldg(t.r1 + t.x1 + c);
      const float gc = __ldg(gp + c);
      sx = sx + gc * (gy * (v01 - v00) + t.fy * (v11 - v10));
      const float t0 = gx * v00 + t.fx * v01;
      const float t1 = gx * v10 + t.fx * v11;
      sy = sy + gc * (t1 - t0);
    }
    dix[p] = sx;
    diy[p] = t.fy > 0.0f ? sy : 0.0f;
  }
}

// Adds the N values of the span [lo | hi] (lo, hi of N/2 each, or lo alone
// when HALF == N) into p[0, N), with the widest atomics the addresses
// allow: 16-byte (float4) and 8-byte (float2) vector atomics of sm_90, else
// 4 bytes.  M is p's offset in floats within a 16-byte line, so every
// choice is made at compile time.  Each lane of a vector atomic is its own
// float add, as a scalar atomic's; a vector whose lanes are all 0 (a weight
// of 0, the band's clamped rows, the border's clamped columns) is not sent:
// adding 0 leaves a sum that started at +0 as it was, bit for bit.
template <int N, int HALF, int M, int I = 0>
__device__ __forceinline__ void red_span(float* p, const float (&lo)[HALF],
                                         const float (&hi)[HALF]) {
  if constexpr (I < N) {
    constexpr int pos = (M + I) % 4;
    const auto v = [&](int i) { return i < HALF ? lo[i] : hi[i - HALF]; };
    if constexpr (pos == 0 && I + 4 <= N) {
      const float4 x = make_float4(v(I), v(I + 1), v(I + 2), v(I + 3));
      if (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f)
        atomicAdd(reinterpret_cast<float4*>(p + I), x);
      red_span<N, HALF, M, I + 4>(p, lo, hi);
    } else if constexpr (pos % 2 == 0 && I + 2 <= N) {
      const float2 x = make_float2(v(I), v(I + 1));
      if (x.x != 0.0f || x.y != 0.0f)
        atomicAdd(reinterpret_cast<float2*>(p + I), x);
      red_span<N, HALF, M, I + 2>(p, lo, hi);
    } else {
      if (v(I) != 0.0f) atomicAdd(p + I, v(I));
      red_span<N, HALF, M, I + 1>(p, lo, hi);
    }
  }
}

template <int N, int HALF>
__device__ __forceinline__ void red_add(float* p, const float (&lo)[HALF],
                                        const float (&hi)[HALF]) {
  switch ((reinterpret_cast<size_t>(p) / sizeof(float)) % 4) {
    case 0: red_span<N, HALF, 0>(p, lo, hi); break;
    case 1: red_span<N, HALF, 1>(p, lo, hi); break;
    case 2: red_span<N, HALF, 2>(p, lo, hi); break;
    default: red_span<N, HALF, 3>(p, lo, hi); break;
  }
}

// K4's tile of output pixels (one warp an output row) and its window of
// the source in shared memory: at most kWinCols columns and kWinFloats
// floats.
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kImgThreads = kTileX * kTileY;
constexpr int kWarps = kImgThreads / 32;
constexpr int kWinCols = 64;
constexpr int kWinFloats = 6144;
constexpr unsigned kFull = 0xffffffffu;

// A warp's sum of v over the lanes of its group grp (a __match_any_sync
// mask), in lane order; every lane of the warp must call it.
__device__ __forceinline__ float group_sum(float v, unsigned grp) {
  float acc = 0.0f;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const float t = __shfl_sync(kFull, v, l);
    if ((grp >> l) & 1u) acc += t;
  }
  return acc;
}

// K4's spill route for one tap kind (x0 or x1, y0 or y1) of a warp: the
// lanes whose tap (y, x) lies outside the window (spill) add w * g into it
// in plane (H, W, C).  Lanes that share a tap are summed into its lowest
// lane first, where any do.  gv holds the pixel's C cotangent values
// (CT > 0); CT == 0 reads them from gp.  Warp-uniform: every lane calls it.
template <int CT>
__device__ __forceinline__ void spill_tap(
    bool spill, int y, int x, float* plane, int W, float w,
    const float (&gv)[CT > 0 ? CT : 1], const float* gp, int C) {
  if (!__any_sync(kFull, spill)) return;
  const int key = y * W + x;
  float* p = plane + static_cast<long long>(key) * C;
  const unsigned grp = __match_any_sync(kFull, spill ? key : -1);
  const bool combine = __any_sync(kFull, spill && __popc(grp) > 1);
  const bool lead = spill && (threadIdx.x % 32) == __ffs(grp) - 1;
  if constexpr (CT > 0) {
    float v[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      v[c] = spill ? w * gv[c] : 0.0f;
      if (combine) v[c] = group_sum(v[c], grp);
    }
    if (combine ? lead : spill) red_add<CT, CT>(p, v, v);
  } else {
    for (int c = 0; c < C; ++c) {
      float v = spill ? w * __ldg(gp + c) : 0.0f;
      if (combine) v = group_sum(v, grp);
      if ((combine ? lead : spill) && v != 0.0f) atomicAdd(p + c, v);
    }
  }
}

// K4's window of the source in shared memory: its first row and column,
// its rows and columns.
struct Window {
  int y0, x0, rows, cols;
};

// K4: a block per tile of kTileY x kTileX output pixels of one image (the
// batch on the grid's y), ix, iy (B, OH, OW) and the cotangent g
// (B, OH, OW, C) -> grad (B, H, W, C), zeroed by the launcher.  The taps
// inside the block's window are summed in shared memory and flushed once;
// the others spill to grad.  CT > 0 fixes C at compile time.  COUNT also
// adds into counts (zeroed by the launcher): the taps of nonzero weight,
// those of them that spilled, and the floats of the windows opened.
template <int CT, bool COUNT>
__global__ void __launch_bounds__(kImgThreads, 8)
    band_warp_img_grad_kernel(const float* __restrict__ ix,
                              const float* __restrict__ iy,
                              const float* __restrict__ g,
                              float* __restrict__ grad, int B, int H, int W,
                              int C_rt, int OH, int OW, int tiles_x,
                              unsigned long long* __restrict__ counts) {
  const int C = CT > 0 ? CT : C_rt;
  __shared__ __align__(16) float win[kWinFloats];
  __shared__ int parts[kWarps][7];
  __shared__ Window window;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ox = (blockIdx.x % tiles_x) * kTileX + lane;
  const int oy = (blockIdx.x / tiles_x) * kTileY + warp;
  const bool valid = ox < OW && oy < OH;
  const int cells = kWinFloats / C;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long p = (static_cast<long long>(b) * OH + oy) * OW + ox;
    float x = 0.0f;
    float y = 0.0f;
    if (valid) {
      x = __ldg(ix + p);
      y = __ldg(iy + p);
    }
    // the taps as taps() clamps them
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = min(max(static_cast<int>(x0f), 0), W - 1);
    const int y0 = min(max(static_cast<int>(y0f), 0), H - 1);
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);

    // the block's extent and mean tap: each warp's, then warp 0 reduces
    // the warps' and opens the window (sums of columns and rows fit an int:
    // the launcher refuses H or W of 2^23 or more)
    {
      const int xmin = __reduce_min_sync(kFull, valid ? x0 : W);
      const int xmax = __reduce_max_sync(kFull, valid ? x1 : -1);
      const int ymin = __reduce_min_sync(kFull, valid ? y0 : H);
      const int ymax = __reduce_max_sync(kFull, valid ? y1 : -1);
      const unsigned xsum = __reduce_add_sync(kFull, valid ? x0 : 0);
      const unsigned ysum = __reduce_add_sync(kFull, valid ? y0 : 0);
      const int count = __popc(__ballot_sync(kFull, valid));
      if (lane == 0) {
        int* q = parts[warp];
        q[0] = xmin;
        q[1] = xmax;
        q[2] = ymin;
        q[3] = ymax;
        q[4] = static_cast<int>(xsum);
        q[5] = static_cast<int>(ysum);
        q[6] = count;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const bool mine = lane < kWarps;
      const int* q = parts[mine ? lane : 0];
      const int xmin = __reduce_min_sync(kFull, mine ? q[0] : W);
      const int xmax = __reduce_max_sync(kFull, mine ? q[1] : -1);
      const int ymin = __reduce_min_sync(kFull, mine ? q[2] : H);
      const int ymax = __reduce_max_sync(kFull, mine ? q[3] : -1);
      const int xsum =
          static_cast<int>(__reduce_add_sync(kFull, mine ? q[4] : 0));
      const int ysum =
          static_cast<int>(__reduce_add_sync(kFull, mine ? q[5] : 0));
      const int count =
          static_cast<int>(__reduce_add_sync(kFull, mine ? q[6] : 0));
      // the extent where it fits, else centred on the mean tap and
      // clipped into the extent; 0 x 0 where no cell fits
      if (lane == 0) {
        Window w;
        w.cols = min(min(xmax - xmin + 1, kWinCols), cells);
        w.rows = w.cols > 0 ? min(ymax - ymin + 1, cells / w.cols) : 0;
        w.x0 = min(max(xsum / count - (w.cols - 1) / 2, xmin),
                   xmax - w.cols + 1);
        w.y0 = min(max(ysum / count - (w.rows - 1) / 2, ymin),
                   ymax - w.rows + 1);
        window = w;
      }
    }
    __syncthreads();
    const int cols = window.cols;
    const int rows = window.rows;
    const int wx0 = window.x0;
    const int wy0 = window.y0;
    const int len = cols * C;  // floats per window row
    if constexpr (COUNT) {
      if (threadIdx.x == 0)
        atomicAdd(counts + 2, static_cast<unsigned long long>(rows) * len);
    }
    for (int i = threadIdx.x; i < (rows * len + 3) / 4; i += kImgThreads)
      reinterpret_cast<float4*>(win)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // accumulate: the window's taps in shared memory, the rest spill
    const float* gp = g + p * C;
    float gv[CT > 0 ? CT : 1];
    if constexpr (CT > 0) {
#pragma unroll
      for (int c = 0; c < CT; ++c) gv[c] = valid ? __ldg(gp + c) : 0.0f;
    }
    const auto g_of = [&](int c) {
      if constexpr (CT > 0) return gv[c];
      else return __ldg(gp + c);
    };
    float* plane = grad + static_cast<long long>(b) * H * W * C;
    const int ty[2] = {y0, y1};
    const int tx[2] = {x0, x1};
    const int ry[2] = {y0 - wy0, y1 - wy0};
    const int qx[2] = {x0 - wx0, x1 - wx0};
    const unsigned urows = rows;
    const unsigned ucols = cols;
    const bool in_y[2] = {valid && static_cast<unsigned>(ry[0]) < urows,
                          valid && static_cast<unsigned>(ry[1]) < urows};
    const bool in_x[2] = {static_cast<unsigned>(qx[0]) < ucols,
                          static_cast<unsigned>(qx[1]) < ucols};
    const float wt[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                         (1.0f - fx) * fy, fx * fy};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = k / 2;  // the tap's row: y0, y1
      const int j = k % 2;  // its column: x0, x1
      const bool inside = in_y[i] && in_x[j];
      if (inside) {
        float* cell = win + ry[i] * len + qx[j] * C;
        for (int c = 0; c < C; ++c) {
          const float v = wt[k] * g_of(c);
          if (v != 0.0f) atomicAdd(cell + c, v);
        }
      }
      spill_tap<CT>(valid && !inside, ty[i], tx[j], plane, W, wt[k], gv, gp,
                    C);
      if constexpr (COUNT) {
        const bool live = valid && wt[k] != 0.0f;
        const unsigned n = __popc(__ballot_sync(kFull, live));
        const unsigned spilled = __popc(__ballot_sync(kFull, live && !inside));
        if (lane == 0 && n) {
          atomicAdd(counts, static_cast<unsigned long long>(n));
          atomicAdd(counts + 1, static_cast<unsigned long long>(spilled));
        }
      }
    }
    __syncthreads();

    // flush: a warp a window row, its len floats into grad in 16-byte
    // chunks counted from grad's 16-byte boundaries (grad is 16-byte
    // aligned), the lanes over the chunks
    const long long row0 =
        ((static_cast<long long>(b) * H + wy0) * W + wx0) * C;
    for (int r = warp; r < rows; r += kWarps) {
      const long long start = row0 + static_cast<long long>(r) * W * C;
      const long long a0 = start & ~3LL;
      const int skip = static_cast<int>(start - a0);  // floats before start
      const int n = (skip + len + 3) / 4;
      const float* src = win + r * len - skip;  // src[i] goes to grad[a0 + i]
      for (int k = lane; k < n; k += 32) {
        const int lo = k == 0 ? skip : 0;
        const int hi = k == n - 1 ? skip + len - 4 * k : 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = j >= lo && j < hi ? src[4 * k + j] : 0.0f;
        float* out = grad + a0 + 4LL * k;
        if (lo == 0 && hi == 4) {
          if (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f || v[3] != 0.0f)
            atomicAdd(reinterpret_cast<float4*>(out),
                      make_float4(v[0], v[1], v[2], v[3]));
          continue;
        }
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          if (lo <= h && h + 2 <= hi) {
            if (v[h] != 0.0f || v[h + 1] != 0.0f)
              atomicAdd(reinterpret_cast<float2*>(out + h),
                        make_float2(v[h], v[h + 1]));
          } else {
            for (int j = h; j < h + 2; ++j)
              if (j >= lo && j < hi && v[j] != 0.0f) atomicAdd(out + j, v[j]);
          }
        }
      }
    }
    __syncthreads();  // the next image reuses win, parts and window
  }
}

unsigned blocks_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < (1LL << 30) ? want : (1LL << 30));
}

bool bad_shape(int H, int W, int C, long long per_image, long long n) {
  return H <= 0 || W <= 0 || C <= 0 || per_image <= 0 || n % per_image;
}

bool misaligned(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 != 0;
}

template <bool COUNT>
void img_grad_kernel_launch(dim3 grid, cudaStream_t s, const float* ix,
                            const float* iy, const float* g, float* grad,
                            int B, int H, int W, int C, int OH, int OW,
                            int tiles_x, unsigned long long* counts) {
  if (C == 3) {
    band_warp_img_grad_kernel<3, COUNT><<<grid, kImgThreads, 0, s>>>(
        ix, iy, g, grad, B, H, W, C, OH, OW, tiles_x, counts);
  } else {
    band_warp_img_grad_kernel<0, COUNT><<<grid, kImgThreads, 0, s>>>(
        ix, iy, g, grad, B, H, W, C, OH, OW, tiles_x, counts);
  }
}

}  // namespace

extern "C" {

// img (B, H, W, C), ix and iy (B, OH, OW), out (B, OH, OW, C); float32,
// contiguous; img and out 16-byte aligned where C is a multiple of 4.
// per_image = OH * OW, n = B * OH * OW.  *ran_lanes is set to 1 where the
// lanes kernel was launched, else to 0.
int band_warp_fwd_launch(const float* img, const float* ix, const float* iy,
                         float* out, int H, int W, int C, long long per_image,
                         long long n, int* ran_lanes, void* stream) {
  *ran_lanes = 0;
  if (n == 0) return 0;
  if (bad_shape(H, W, C, per_image, n) || per_image >= (1LL << 31) - kThreads ||
      (C % 4 == 0 && (misaligned(img) || misaligned(out))))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long B = n / per_image;
  const int P = static_cast<int>(per_image);
  const unsigned by = static_cast<unsigned>(B < 65535 ? B : 65535);
  if (C % 4 == 0) {
    *ran_lanes = 1;
    const int L = C / 4;
    const dim3 grid(blocks_for(per_image * L), by);
    if (L == 16) {
      band_warp_fwd_lanes<16><<<grid, kThreads, 0, s>>>(img, ix, iy, out, B, H,
                                                        W, L, P);
    } else if (L == 1) {
      band_warp_fwd_lanes<1><<<grid, kThreads, 0, s>>>(img, ix, iy, out, B, H,
                                                       W, L, P);
    } else {
      band_warp_fwd_lanes<0><<<grid, kThreads, 0, s>>>(img, ix, iy, out, B, H,
                                                       W, L, P);
    }
  } else {
    const dim3 grid(blocks_for(per_image), by);
    if (C == 3) {
      band_warp_fwd_pixel<3><<<grid, kThreads, 0, s>>>(img, ix, iy, out, B, H,
                                                       W, C, P);
    } else if (C == 1) {
      band_warp_fwd_pixel<1><<<grid, kThreads, 0, s>>>(img, ix, iy, out, B, H,
                                                       W, C, P);
    } else {
      band_warp_fwd_pixel<0><<<grid, kThreads, 0, s>>>(img, ix, iy, out, B, H,
                                                       W, C, P);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// As above, plus the cotangent g (B, OH, OW, C) -> dix, diy (B, OH, OW).
int band_warp_bwd_launch(const float* img, const float* ix, const float* iy,
                         const float* g, float* dix, float* diy, int H, int W,
                         int C, long long per_image, long long n,
                         void* stream) {
  if (n == 0) return 0;
  if (bad_shape(H, W, C, per_image, n)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(blocks_for(n));
  if (C == 3) {
    band_warp_bwd_kernel<3><<<blocks, kThreads, 0, s>>>(
        img, ix, iy, g, dix, diy, H, W, C, per_image, n);
  } else if (C == 1) {
    band_warp_bwd_kernel<1><<<blocks, kThreads, 0, s>>>(
        img, ix, iy, g, dix, diy, H, W, C, per_image, n);
  } else {
    band_warp_bwd_kernel<0><<<blocks, kThreads, 0, s>>>(
        img, ix, iy, g, dix, diy, H, W, C, per_image, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: ix, iy (B, OH, OW) and the cotangent g (B, OH, OW, C) -> grad
// (B, H, W, C), which this function zeroes and then accumulates into;
// float32, contiguous, grad 16-byte aligned.  Refuses OH * OW or H * W of
// 2^31 or more (a tap's index y * W + x is an int), and H or W of 2^23 or
// more (a block's sum of 256 columns or rows is an int).  counts, where
// not null, is zeroed and receives the kernel's three counts (taps of
// nonzero weight, those spilled, window floats) from its counting build.
int band_warp_img_grad_launch(const float* ix, const float* iy,
                              const float* g, float* grad, int H, int W,
                              int C, int B, int OH, int OW,
                              unsigned long long* counts, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || B < 0 || OH < 0 || OW < 0 ||
      H >= (1 << 23) || W >= (1 << 23) ||
      static_cast<long long>(H) * W >= (1LL << 31) ||
      static_cast<long long>(OH) * OW >= (1LL << 31) - kImgThreads ||
      misaligned(grad))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(
      grad, 0, static_cast<size_t>(B) * H * W * C * sizeof(float), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (counts) {
    const cudaError_t counted =
        cudaMemsetAsync(counts, 0, 3 * sizeof(unsigned long long), s);
    if (counted != cudaSuccess) return static_cast<int>(counted);
  }
  if (B == 0 || OH == 0 || OW == 0) return 0;
  const int tiles_x = (OW + kTileX - 1) / kTileX;
  const long long tiles =
      static_cast<long long>(tiles_x) * ((OH + kTileY - 1) / kTileY);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(B < 65535 ? B : 65535));
  if (counts) {
    img_grad_kernel_launch<true>(grid, s, ix, iy, g, grad, B, H, W, C, OH,
                                 OW, tiles_x, counts);
  } else {
    img_grad_kernel_launch<false>(grid, s, ix, iy, g, grad, B, H, W, C, OH,
                                  OW, tiles_x, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* polardepth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
