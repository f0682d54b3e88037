// K2: one-sided PSD of framed data, (n_frames, window) -> (n_frames,
// nfft/2 + 1), by a radix-8/4 FFT (fft.cuh).
//
// Replaces the TPU kernel src/repro/kernels/ct_rfft.py:122
// (ct_frame_psd, pallas_call at :172).  The TPU kernel splits nfft =
// n1 * n2 into two small dense DFT products, the shape of the MXU.  On
// Hopper those products run on the f32 FMA pipes (~2.16 MFLOP a frame
// at nfft 4096, ~17x an FFT), so this kernel is an FFT instead; n1
// remains a parameter of the Python function and no longer changes
// the arithmetic.
//
// Bound on this card: bytes.  At paper set 2 (nfft 4096) the function
// reads 16 KB and writes 8 KB a frame; an FFT needs ~2.5 N log2 N =
// 123 kFLOP, ~5 FLOP/byte, below the f32 ridge of 20 (67 TFLOP/s over
// 3.35 TB/s).
//
// Design: one group of L = nfft/16 lanes per frame (fft.cuh), each lane
// 8 points a pass.  From nfft 512 up a group is one block (L threads)
// and one frame: 640 blocks of 256 threads at set 2.  Below, 4 warps
// of 32/L groups each take 4*32/L frames a block.
//  * The first pass reads its points straight from device memory:
//    sample pairs (x[2q], x[2q+1]), decoded, windowed and zero-padded
//    past `window` as they load, so the frame is read once and never
//    staged.  int16 frames are converted and multiplied by the frame's
//    decode scale first (depam::sample): the host decode's single
//    rounding, so int16 and float32 calls give the same bits.
//  * The other passes and the split exchange points through one
//    buffer of nfft floats a frame in shared memory (32 KB at nfft
//    8192), laid out so that no access has a bank conflict.
//  * Twiddles (~nfft/2 float2), split factors (nfft/2 + 1 float4) and
//    the bin scale are shared by every block and read through the
//    read-only path (L1/L2).
//  * Each lane stores bins l + L t: consecutive lanes write consecutive
//    bins of the frame's row.
#include "depam.cuh"
#include "fft.cuh"

namespace {

template <int L>
__host__ __device__ constexpr int block_threads() {
  return L < 32 ? 128 : L;
}

// One buffer per warp below 32 lanes, else one per block (one group).
template <int L>
__host__ __device__ constexpr int block_floats() {
  return depam::fft::Group<L>::kFloats
         * (L < 32 ? block_threads<L>() / 32 : 1);
}

template <typename T, int L>
__global__ void __launch_bounds__(L < 32 ? 128 : L)
ct_fft_psd_kernel(const T* __restrict__ x, long long ldx,
                  const float* __restrict__ frame_scale,
                  const float* __restrict__ w,
                  const float2* __restrict__ tw,
                  const float4* __restrict__ split,
                  const float* __restrict__ scale, unsigned radices,
                  int n_pass, float* __restrict__ out, int n_frames,
                  int window) {
  using Grp = depam::fft::Group<L>;
  constexpr int kFramesPerBlock = block_threads<L>() / L;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  Grp grp;
  grp.re = smem + (L < 32 ? warp * Grp::kFloats : 0);
  grp.g = L < 32 ? (threadIdx.x % 32) / L : 0;
  grp.l = threadIdx.x % L;
  const long long f =
      static_cast<long long>(blockIdx.x) * kFramesPerBlock + threadIdx.x / L;
  const bool live = f < n_frames;
  const float fscale =
      live && frame_scale != nullptr ? frame_scale[f] : 1.f;
  const T* xf = x + (live ? f : 0) * ldx;

  auto first = [&](int q) {
    const int n = 2 * q;
    float a = 0.f, b = 0.f;
    if (live && n < window)
      a = __fmul_rn(depam::sample(xf, n, fscale), w[n]);
    if (live && n + 1 < window)
      b = __fmul_rn(depam::sample(xf, n + 1, fscale), w[n + 1]);
    return make_float2(a, b);
  };
  const int rot = grp.run(first, radices, n_pass, tw);

  float pw[9];
  grp.power(rot, split, pw);
  if (!live) return;
  float* of = out + f * (Grp::M + 1);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int k = grp.l + L * t;
    if (k <= Grp::M) of[k] = pw[t] * scale[k];
  }
}

template <typename T, int L>
cudaError_t launch(const T* x, long long ldx, const float* frame_scale,
                   const float* const* consts, unsigned radices, int n_pass,
                   float* out, int n_frames, int window,
                   cudaStream_t stream) {
  constexpr int kThreads = block_threads<L>();
  constexpr int kFramesPerBlock = kThreads / L;
  constexpr size_t bytes = sizeof(float) * block_floats<L>();
  static_assert(bytes <= 49152, "K2 fits the default shared memory");
  const int blocks = (n_frames + kFramesPerBlock - 1) / kFramesPerBlock;
  ct_fft_psd_kernel<T, L><<<blocks, kThreads, bytes, stream>>>(
      x, ldx, frame_scale, consts[0],
      reinterpret_cast<const float2*>(consts[1]),
      reinterpret_cast<const float4*>(consts[2]), consts[3], radices, n_pass,
      out, n_frames, window);
  return cudaGetLastError();
}

// consts: window (window floats), twiddles (n_twiddles float2), split
// factors (nfft/2 + 1 float4), bin scale (nfft/2 + 1).  The kernel takes
// a power-of-two nfft from 256 to 8192 and window <= nfft.
template <typename T>
int dispatch(const T* x, long long ldx, const float* frame_scale,
             const float* const* consts, unsigned radices, int n_pass,
             int n_twiddles, float* out, int n_frames, int window, int nfft,
             int n_bins, void* stream) {
  if (window < 1 || window > nfft || n_bins != nfft / 2 + 1
      || !depam::fft::plan_fits(radices, n_pass, n_twiddles, nfft / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nfft) {
#define DEPAM_N(N)                                                       \
  case N:                                                                \
    return static_cast<int>(launch<T, N / 16>(x, ldx, frame_scale,       \
                                              consts, radices, n_pass,   \
                                              out, n_frames, window, st));
    DEPAM_N(256) DEPAM_N(512) DEPAM_N(1024) DEPAM_N(2048) DEPAM_N(4096)
    DEPAM_N(8192)
#undef DEPAM_N
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int depam_ct_frame_psd_f32(const float* x, long long ldx,
                                      const float* const* consts,
                                      unsigned radices, int n_pass,
                                      int n_twiddles, float* out,
                                      int n_frames, int window, int nfft,
                                      int n_bins, void* stream) {
  return dispatch(x, ldx, static_cast<const float*>(nullptr), consts,
                  radices, n_pass, n_twiddles, out, n_frames, window, nfft,
                  n_bins, stream);
}

extern "C" int depam_ct_frame_psd_i16(const int16_t* x, long long ldx,
                                      const float* frame_scale,
                                      const float* const* consts,
                                      unsigned radices, int n_pass,
                                      int n_twiddles, float* out,
                                      int n_frames, int window, int nfft,
                                      int n_bins, void* stream) {
  return dispatch(x, ldx, frame_scale, consts, radices, n_pass, n_twiddles,
                  out, n_frames, window, nfft, n_bins, stream);
}
