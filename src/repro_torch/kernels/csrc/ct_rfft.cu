// K2: one-sided PSD of framed data by a two-stage Cooley-Tukey split,
// N = n1 * n2, both stages as small dense products.
//
// Replaces the TPU kernel src/repro/kernels/ct_rfft.py:122
// (ct_frame_psd, pallas_call at :172, _chain :92-118, constants :40-73).
//
// With n = n2_count*j1 + j2 and bin k = k1 + n1*k2:
//   A[j1, j2] = (w * x)[n2_count*j1 + j2]              (row-major reshape)
//   Y[k1, j2] = sum_j1 A[j1, j2] W_n1^(j1 k1)          stage 1 (real input)
//   Z[k1, j2] = Y[k1, j2] W_N^(k1 j2)                  twiddle
//   X[k1 + n1 k2] = sum_j2 Z[k1, j2] W_n2^(j2 k2)      stage 2, k2 <= n2/2
//
// Bound on this card: bytes.  At set 2 (nfft 4096) the function reads
// 16 KB and writes 8 KB a frame; an FFT needs about 2.5 N log2 N =
// 123 kFLOP, ~5 FLOP/byte, below the f32 ridge of 20.  This design's
// two dense stages (n1 = n2 = 64) do ~2.16 MFLOP a frame, ~17x that, so
// the f32 FMA pipes, not the bytes, limit it: the gap to the bound is
// the algorithm's.
//
// Design: one block of 256 threads per frame.
//  * The windowed frame A (16 KB at 4096) and the twiddled Z, re and im
//    (32 KB), live in shared memory (48 KB at 4096; above that the
//    dynamic-memory opt-in is taken).  The DFT, twiddle and scale
//    constants (~150 KB at 4096, shared by every block) are read through
//    L1/L2.
//  * Stage 1: thread t owns k1 = t % n1 and J columns j2 = t/n1 +
//    (256/n1)*j.  Per j1 it loads one cos and one sin (coalesced across
//    lanes) and J samples of A (a shared-memory broadcast: a warp shares
//    its columns), then does 2J FMAs.
//  * The twiddle constants are passed transposed, (n2, n1), so the loads
//    are coalesced, and Z is stored transposed so stage 2 reads it
//    without bank conflicts.
//  * Stage 2: thread t owns k1 = t % n1 and J2 output columns k2; per j2
//    it loads Z re/im (2 shared loads) and J2 cos/sin pairs (broadcast),
//    then does 4*J2 FMAs.  Output lands in bin order k = k1 + n1*k2:
//    consecutive lanes write consecutive bins.
//  * Zero padding (window < nfft) is done while staging.  int16 frames
//    are converted and multiplied by the frame's decode scale there too,
//    before the window multiply: the host decode's single rounding.
#include "depam.cuh"

namespace {

constexpr int kThreads = 256;

template <int J>
__host__ __device__ constexpr int stage2_cols() {
  return J == 1 ? 1 : J / 2 + 1;
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
ct_frame_psd_kernel(const T* __restrict__ x, long long ldx,
                    const float* __restrict__ frame_scale,
                    const float* __restrict__ w,
                    const float* __restrict__ c1,
                    const float* __restrict__ s1,
                    const float* __restrict__ tr_t,
                    const float* __restrict__ ti_t,
                    const float* __restrict__ c2,
                    const float* __restrict__ s2,
                    const float* __restrict__ scale,
                    float* __restrict__ out, int window, int n1, int n_bins) {
  constexpr int kN = kThreads * J;
  constexpr int J2 = stage2_cols<J>();
  extern __shared__ float smem[];
  float* a = smem;            // (n1, n2), row-major
  float* zr = smem + kN;      // (n2, n1), transposed
  float* zi = smem + 2 * kN;
  const long long f = blockIdx.x;
  const int n2 = kN / n1;
  const int n2h = n2 / 2 + 1;
  const float fscale = frame_scale != nullptr ? frame_scale[f] : 1.f;

  const T* xf = x + f * ldx;
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    const float v = i < window ? depam::sample(xf, i, fscale) : 0.f;
    a[i] = __fmul_rn(v, w[i]);
  }
  __syncthreads();

  const int k1 = threadIdx.x % n1;
  const int col0 = threadIdx.x / n1;
  const int cstep = kThreads / n1;

  float yr[J], yi[J];
#pragma unroll
  for (int j = 0; j < J; ++j) yr[j] = yi[j] = 0.f;
  for (int j1 = 0; j1 < n1; ++j1) {
    const float cv = c1[j1 * n1 + k1];
    const float sv = s1[j1 * n1 + k1];
    const float* arow = a + j1 * n2;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float av = arow[col0 + cstep * j];
      yr[j] = fmaf(cv, av, yr[j]);
      yi[j] = fmaf(sv, av, yi[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int j2 = col0 + cstep * j;
    const float tr = tr_t[j2 * n1 + k1];
    const float ti = ti_t[j2 * n1 + k1];
    zr[j2 * n1 + k1] = yr[j] * tr - yi[j] * ti;
    zi[j2 * n1 + k1] = yr[j] * ti + yi[j] * tr;
  }
  __syncthreads();

  float xr[J2], xi[J2];
  int k2c[J2];
#pragma unroll
  for (int j = 0; j < J2; ++j) {
    xr[j] = xi[j] = 0.f;
    k2c[j] = min(col0 + cstep * j, n2h - 1);
  }
  for (int j2 = 0; j2 < n2; ++j2) {
    const float zrv = zr[j2 * n1 + k1];
    const float ziv = zi[j2 * n1 + k1];
    const float* c2r = c2 + j2 * n2h;
    const float* s2r = s2 + j2 * n2h;
#pragma unroll
    for (int j = 0; j < J2; ++j) {
      const float cv = c2r[k2c[j]];
      const float sv = s2r[k2c[j]];
      xr[j] = fmaf(zrv, cv, xr[j]);
      xr[j] = fmaf(-ziv, sv, xr[j]);
      xi[j] = fmaf(zrv, sv, xi[j]);
      xi[j] = fmaf(ziv, cv, xi[j]);
    }
  }
  float* of = out + f * n_bins;
#pragma unroll
  for (int j = 0; j < J2; ++j) {
    const int k2 = col0 + cstep * j;
    const int bin = k1 + n1 * k2;
    if (k2 < n2h && bin < n_bins)
      of[bin] = (xr[j] * xr[j] + xi[j] * xi[j]) * scale[k2 * n1 + k1];
  }
}

template <typename T, int J>
cudaError_t launch(const T* x, long long ldx, const float* frame_scale,
                   const float* const* consts, float* out, int n_frames,
                   int window, int n1, int n_bins, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * 3 * kThreads * J;
  auto kernel = ct_frame_psd_kernel<T, J>;
  cudaError_t err = depam::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<n_frames, kThreads, bytes, stream>>>(
      x, ldx, frame_scale, consts[0], consts[1], consts[2], consts[3],
      consts[4], consts[5], consts[6], consts[7], out, window, n1, n_bins);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, long long ldx, const float* frame_scale,
             const float* const* consts, float* out, int n_frames,
             int window, int nfft, int n1, int n_bins, void* stream) {
  if (n_frames <= 0) return 0;
  if (nfft % kThreads != 0 || n1 < 1 || n1 > kThreads || kThreads % n1 != 0
      || window > nfft)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n2h = nfft / n1 / 2 + 1;
  const int cstep = kThreads / n1;
  cudaError_t err;
  switch (nfft / kThreads) {
#define DEPAM_J(J)                                                         \
  case J:                                                                  \
    if (cstep * stage2_cols<J>() < n2h) return cudaErrorInvalidValue;      \
    err = launch<T, J>(x, ldx, frame_scale, consts, out, n_frames, window, \
                       n1, n_bins, st);                                    \
    break;
    DEPAM_J(1) DEPAM_J(2) DEPAM_J(4) DEPAM_J(8) DEPAM_J(16) DEPAM_J(32)
#undef DEPAM_J
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// consts: window (nfft), c1, s1 (n1, n1), twiddle re/im transposed
// (n2, n1), c2, s2 (n2, n2/2+1), bin scale (n2/2+1, n1).
extern "C" int depam_ct_frame_psd_f32(const float* x, long long ldx,
                                      const float* const* consts, float* out,
                                      int n_frames, int window, int nfft,
                                      int n1, int n_bins, void* stream) {
  return dispatch(x, ldx, static_cast<const float*>(nullptr), consts, out,
                  n_frames, window, nfft, n1, n_bins, stream);
}

extern "C" int depam_ct_frame_psd_i16(const int16_t* x, long long ldx,
                                      const float* frame_scale,
                                      const float* const* consts, float* out,
                                      int n_frames, int window, int nfft,
                                      int n1, int n_bins, void* stream) {
  return dispatch(x, ldx, frame_scale, consts, out, n_frames, window, nfft,
                  n1, n_bins, stream);
}
