// Fused polar preprocess: 4 polarizer captures -> XOLP + 9 Fresnel priors.
//
// Replaces the TPU kernel of polardepth_tpu/ops/pallas/polar_preprocess.py,
// fused_polar_preprocess (kernel body _make_kernel.kernel).  For each pixel:
//   1. Stokes fit (a, b, c) = pinv(A) . (I0, I45, I90, I135)   (ops/xolp.py)
//   2. rho = |(b, c)| / a, non-finite -> 0;  phi = atan2(c, b) / 2
//   3. theta of the diffuse curve and of the two specular branches, from the
//      two-level table of ops/fresnel.py:HierarchicalInterp (n = 1.5,
//      prune_tol = 1e-5 on the serving path)
//   4. out: xolp [rho, phi] and priors [N_diff(3), N_spec1(3), N_spec2(3)],
//      N = (cos az sin theta, sin az sin theta, cos theta), the specular
//      azimuth being phi + pi/2.
// Inputs and outputs are channels-last: pol (P, 4), xolp (P, 2), priors
// (P, 9), float32.
//
// Bound: device memory.  Each pixel reads 16 B and writes 44 B, so the
// serving batch (12 x 320 x 480 = 1,843,200 px) moves 110.6 MB: about 33 us at
// the H100's 3.35 TB/s.  The design keeps every access at full width and
// everything else on chip:
//   - one thread per pixel, a 16-byte load of the four grays and a float2
//     store of xolp, both unit-stride across a warp;
//   - the priors (36 B a pixel) go through a per-warp tile in shared memory:
//     lane t writes its 9 floats at t*9 (9 is odd, so no bank conflict), and
//     the warp writes the tile's 1,152 B out as 72 consecutive 16-byte
//     stores.  Stored straight from registers, each warp-wide store of one
//     channel touched 36 sectors for 128 useful bytes;
//   - the table (one row of 31 floats per coarse bin, ~121 bins) lives in
//     shared memory at a row stride of 33 floats: the lanes of a warp look up
//     many bins at once (rho differs per pixel), and at a stride of 32 every
//     row began in bank 0, so each distinct bin cost one more pass;
//   - the bin search is six halving steps over each curve's knots, padded
//     with +inf to 64 in shared memory (seven, to 128, for the wider tables
//     of n near 1 or of no pruning), so no step checks a bound and every
//     lane takes the same steps;
//   - a persistent grid, as many blocks as fit on the card at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each staging the
//     table once and then walking over 256-pixel tiles.
// With the stores and the table fixed, the kernel is bound by instruction
// issue rather than bytes: each of the five angles' sine and cosine costs an
// accurate range reduction, so they are taken in pairs by sincosf, which
// gives the bits of sinf and cosf (chip_smoke.py phase 3 holds the kernel
// to its plain version, and prints 0).
//
// Built with -fmad=false: the plain torch version (ops/polar_preprocess.py)
// rounds after every multiply and add, and where b and c cancel to residues
// of the pinv's ~1e-17 coefficients a fused multiply-add changes phi by O(1).
// The kernel does the plain version's operations in its order, so the two
// agree to the last bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 32;         // floats per coarse-bin row in device memory
constexpr int kStride = 33;      // ... and in shared memory
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32 * 9;    // one warp's priors, in floats

struct Pinv {
  float w[12];                 // row-major (3, 4)
};

// One curve's section of the table in shared memory: ck, its coarse knots
// padded with +inf to MaxBins (ck[0] = -1e6 <= any rho), and rows, one per
// bin: [fine_thresh(7), d_x0(7), d_f0(7), d_slope(7), base_x0, base_f0,
// base_slope].  The bin is the last whose knot is <= rho; the deltas of the
// fine thresholds rho passes are added to the base in threshold order.
template <int MaxBins>
__device__ __forceinline__ float theta_of(const float* ck, const float* rows,
                                          float rho) {
  int b = 0;
#pragma unroll
  for (int s = MaxBins / 2; s >= 1; s >>= 1)
    if (ck[b + s] <= rho) b += s;
  const float* r = rows + b * kStride;
  float x0 = r[28], f0 = r[29], sl = r[30];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    if (rho >= r[k]) {
      x0 = x0 + r[7 + k];
      f0 = f0 + r[14 + k];
      sl = sl + r[21 + k];
    }
  }
  return f0 + (rho - x0) * sl;
}

__device__ __forceinline__ void normal(float* o, float cos_az, float sin_az,
                                       float theta) {
  float st, ct;
  sincosf(theta, &st, &ct);
  o[0] = cos_az * st;
  o[1] = sin_az * st;
  o[2] = ct;
}

// MaxBins: the padded size of a curve's section: 64 for the pruned tables
// of n >= 1.2 (at most 60 bins), 128 for those of n near 1 (71 at n = 1.05)
// and the unpruned ones (125).
template <int MaxBins>
__global__ void __launch_bounds__(kThreads)
polar_preprocess_kernel(const float4* __restrict__ pol,
                        float2* __restrict__ xolp,
                        float* __restrict__ priors, long long n_pix,
                        const float* __restrict__ ck_g,
                        const float* __restrict__ rows_g, int nb, int o1,
                        int o2, Pinv p) {
  // [kWarps tiles of kTile floats | nb rows of kStride floats | 3 sections
  // of MaxBins knots]; float4 storage keeps the tiles 16-byte aligned
  extern __shared__ float4 smem4[];
  float* const tiles = reinterpret_cast<float*>(smem4);
  float* const rows = tiles + kWarps * kTile;
  float* const ck = rows + nb * kStride;
  for (int i = threadIdx.x; i < nb * kRow; i += kThreads)
    rows[(i / kRow) * kStride + i % kRow] = rows_g[i];
  const int sect[4] = {0, o1, o2, nb};
  for (int i = threadIdx.x; i < 3 * MaxBins; i += kThreads) {
    const int lo = sect[i / MaxBins], j = i % MaxBins;
    ck[i] = lo + j < sect[i / MaxBins + 1] ? ck_g[lo + j] : INFINITY;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* const tile = tiles + warp * kTile;
  const long long n_tiles = (n_pix + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long first = t * kThreads + warp * 32;  // the warp's pixel 0
    const long long i = first + lane;
    if (i < n_pix) {
      const float4 q = pol[i];
      float a = q.x * p.w[0] + q.y * p.w[1] + q.z * p.w[2] + q.w * p.w[3];
      float b = q.x * p.w[4] + q.y * p.w[5] + q.z * p.w[6] + q.w * p.w[7];
      float c = q.x * p.w[8] + q.y * p.w[9] + q.z * p.w[10] + q.w * p.w[11];
      float rho = sqrtf(b * b + c * c) / a;
      if (!isfinite(rho)) rho = 0.0f;
      float phi = 0.5f * atan2f(c, b);
      xolp[i] = make_float2(rho, phi);

      float phi_s = phi + 1.57079632679489661923f;
      float cp, sp, cs, ss;
      sincosf(phi, &sp, &cp);
      sincosf(phi_s, &ss, &cs);
      float* o = tile + lane * 9;
      normal(o, cp, sp, theta_of<MaxBins>(ck, rows, rho));
      normal(o + 3, cs, ss,
             theta_of<MaxBins>(ck + MaxBins, rows + o1 * kStride, rho));
      normal(o + 6, cs, ss,
             theta_of<MaxBins>(ck + 2 * MaxBins, rows + o2 * kStride, rho));
    }
    __syncwarp();
    float* const dst = priors + first * 9;
    if (first + 32 <= n_pix) {
      // 1,152 B from a 16-byte aligned offset (first is a multiple of 32)
      const float4* src = reinterpret_cast<const float4*>(tile);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int k = lane; k < kTile / 4; k += 32) dst4[k] = src[k];
    } else if (first < n_pix) {
      const int n = static_cast<int>(n_pix - first) * 9;
      for (int k = lane; k < n; k += 32) dst[k] = tile[k];
    }
    __syncwarp();
  }
}

template <int MaxBins>
int launch(const float4* pol, float2* xolp, float* priors, long long n_pix,
           const float* ck, const float* rows, int nb, int o1, int o2,
           const Pinv& p, cudaStream_t stream) {
  auto* kernel = polar_preprocess_kernel<MaxBins>;
  // ~26 KB at n = 1.5: 9 KB of tiles and the ~16 KB table
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * kTile + (size_t)nb * kStride +
                       3 * MaxBins);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_pix + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      pol, xolp, priors, n_pix, ck, rows, nb, o1, o2, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pol, xolp, priors, ck, rows: device pointers (priors 16-byte aligned);
// pinv: 12 host floats; stream: a cudaStream_t.  o1, o2 split the nb bins
// into the three curves' sections, each of at most 128 bins.  Returns the
// cudaError_t of the launch.
int polar_preprocess_launch(const void* pol, void* xolp, void* priors,
                            long long n_pix, const void* ck, const void* rows,
                            int nb, int o1, int o2, const void* pinv,
                            void* stream) {
  if (n_pix <= 0) return 0;
  int widest = o1 > o2 - o1 ? o1 : o2 - o1;
  if (nb - o2 > widest) widest = nb - o2;
  if (o1 < 1 || o2 <= o1 || nb <= o2 || widest > 128 ||
      reinterpret_cast<size_t>(priors) % 16)
    return (int)cudaErrorInvalidValue;
  Pinv p;
  for (int k = 0; k < 12; ++k) p.w[k] = static_cast<const float*>(pinv)[k];
  auto* go = widest <= 64 ? launch<64> : launch<128>;
  return go(static_cast<const float4*>(pol), static_cast<float2*>(xolp),
            static_cast<float*>(priors), n_pix, static_cast<const float*>(ck),
            static_cast<const float*>(rows), nb, o1, o2, p,
            static_cast<cudaStream_t>(stream));
}

const char* polardepth_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
