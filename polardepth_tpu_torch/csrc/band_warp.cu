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
// output pixels hit one source pixel, so the adds are atomic (RED, resolved
// in L2) into a buffer that the launcher zeroes first on the same stream.
// Its bound is bytes: it reads g, ix and iy once and writes the zeroed and
// the accumulated gradient.  What limits it is the L2's rate of atomic
// operations: 4C scalar atomics per pixel (12 at C = 3; 22 M at the
// training shape) took 0.29 ms on the H100, 12x the byte bound.  So a
// pixel's two taps in a row, 2C contiguous floats, go in with sm_90's
// 16- and 8-byte vector atomics where their alignment allows (2 to 4
// operations for a row at C = 3), and an all-zero vector, from a zero
// weight, is not sent.  One thread per output pixel, C compiled for 1 and
// 3.
//
// Rounding: built with -fmad=false and written in the order of the plain
// torch versions in ops/band_warp.py, so the two agree to the last bit or
// within a few ulps (the channel sums of K3).  K4's products are the plain
// version's to the bit, but its atomic sums run in the order the threads
// reach them, which changes from run to run.
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

// One source row's two taps of K4: the C values of tap x0 and the C of tap
// x1.  Where x1 = x0 + 1 the two taps are one contiguous span of 2C floats;
// where the column is clamped (x1 = x0, x0 = W-1) each goes in on its own.
template <int C>
__device__ __forceinline__ void red_row(float* row, int x0, int x1,
                                        const float (&a)[C],
                                        const float (&b)[C]) {
  if (x1 == x0 + C) {
    red_add<2 * C, C>(row + x0, a, b);
  } else {
    red_add<C, C>(row + x0, a, a);
    red_add<C, C>(row + x1, b, b);
  }
}

// K4: one thread per output pixel, g's C channels times the bilinear
// weights added into the four taps of grad (B, H, W, C), zeroed by the
// launcher.  CT = 3 (the colour frames res_pose re-warps) goes through
// red_row's vector atomics; CT == 0 reads C at run time and adds each value
// with a scalar atomic.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    band_warp_img_grad_kernel(const float* __restrict__ ix,
                              const float* __restrict__ iy,
                              const float* __restrict__ g,
                              float* __restrict__ grad, int H, int W,
                              int C_rt, long long per_image, long long n) {
  const int C = CT > 0 ? CT : C_rt;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < n; p += stride) {
    // taps() gives the row pointers into grad; it only reads the
    // coordinates, never the plane
    const Taps t = taps(grad + (p / per_image) * H * W * C, __ldg(ix + p),
                        __ldg(iy + p), H, W, C);
    float* r0 = const_cast<float*>(t.r0);
    float* r1 = const_cast<float*>(t.r1);
    const float w00 = (1.0f - t.fx) * (1.0f - t.fy);
    const float w01 = t.fx * (1.0f - t.fy);
    const float w10 = (1.0f - t.fx) * t.fy;
    const float w11 = t.fx * t.fy;
    const float* gp = g + p * C;
    if constexpr (CT > 0) {
      float a0[CT], b0[CT], a1[CT], b1[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float gc = __ldg(gp + c);
        a0[c] = w00 * gc;
        b0[c] = w01 * gc;
        a1[c] = w10 * gc;
        b1[c] = w11 * gc;
      }
      red_row<CT>(r0, t.x0, t.x1, a0, b0);
      red_row<CT>(r1, t.x0, t.x1, a1, b1);
    } else {
      for (int c = 0; c < C; ++c) {
        const float gc = __ldg(gp + c);
        atomicAdd(r0 + t.x0 + c, w00 * gc);
        atomicAdd(r0 + t.x1 + c, w01 * gc);
        atomicAdd(r1 + t.x0 + c, w10 * gc);
        atomicAdd(r1 + t.x1 + c, w11 * gc);
      }
    }
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
// (B, H, W, C), which this function zeroes and then accumulates into.
int band_warp_img_grad_launch(const float* ix, const float* iy,
                              const float* g, float* grad, int H, int W,
                              int C, long long per_image, long long n,
                              void* stream) {
  if (bad_shape(H, W, C, per_image, n)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long B = n / per_image;
  const cudaError_t zeroed = cudaMemsetAsync(
      grad, 0, static_cast<size_t>(B) * H * W * C * sizeof(float), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (n == 0) return 0;
  const int blocks = static_cast<int>(blocks_for(n));
  if (C == 3) {
    band_warp_img_grad_kernel<3><<<blocks, kThreads, 0, s>>>(
        ix, iy, g, grad, H, W, C, per_image, n);
  } else {
    band_warp_img_grad_kernel<0><<<blocks, kThreads, 0, s>>>(
        ix, iy, g, grad, H, W, C, per_image, n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* polardepth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
