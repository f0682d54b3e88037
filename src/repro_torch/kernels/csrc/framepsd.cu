// K1 and K5: the per-record Welch PSD and the per-frame PSD of paper
// set 1, sharing one staging of the signal (stage_chunk below):
//
//  * K1 welch_psd: per-record Welch PSD (frame -> window -> real DFT ->
//    |X|^2 -> mean over frames -> one-sided density scale), per-frame
//    spectra never written to device memory.  Replaces the TPU kernel
//    src/repro/kernels/framepsd.py:239 (welch_psd, pallas_call at :289,
//    bodies :211-235).
//  * K5 frame_psd: the per-frame PSD (the spectrogram), each frame's
//    (re^2 + im^2) x one-sided weight x density scale stored.  Replaces
//    the TPU kernel src/repro/kernels/framepsd.py:130 (frame_psd,
//    pallas_call at :191, bodies :113-126).
//
// Bound on this card: bytes.  K1 reads the signal once (set 1: 7.9 MB of
// f32 per record) and writes 129 floats; K5 reads the same and writes
// 15 359 x 129 floats (7.9 MB) per record.  An FFT needs about
// 2.5 N log2 N = 5.1 kFLOP per 256-sample frame, ~10 FLOP/byte for K1
// and ~5 for K5, below the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20).
//
// Shared by both:
//  * A block owns one (record, chunk of 8 warps x FT frames) tile.  The
//    reference stacked m = window/hop shifted hop views in device
//    memory; here the chunk's samples, (8*FT - 1)*hop + window floats,
//    are staged once in shared memory (stage_chunk) and every frame is
//    read from there: device-memory traffic is the signal, once.  int16
//    records are converted and multiplied by the record's decode scale
//    while they are staged: the host decode's single rounding, so int16
//    and float32 calls give the same bits.  Frames never cross a
//    record, so one scale per record gives the reference's per-frame
//    scales' numbers.
//  * The Pallas welch grid carried the frame sum across sequential grid
//    steps; here K1's block writes its per-bin partial to a (R,
//    n_chunks, cols) scratch and a second small kernel sums the chunks
//    in order and applies the bin scale (one-sided weight x density
//    scale x 1/frames).  No float atomics, so every run gives the same
//    bits (int16 == float32 and resumed == uninterrupted depend on it).
//
// K1 by FFT (welch_fft_kernel), for a power-of-two nfft from 128 to 512
// and window <= nfft: the FFT core of fft.cuh, shared with K2.  A group
// of L = nfft/16 lanes transforms one frame (16 lanes x 8 points at nfft
// 256, two frames a warp); its first pass reads the frame's sample
// pairs from the staged chunk, windowed as they load (window <= nfft
// zero-pads).  Each lane adds |X|^2 of its bins over its group's frames
// in registers, in frame order; the block then sums its 8 x (32/L)
// groups in a fixed order into the chunk's partial.  About 5 kFLOP a
// frame at nfft 256 against the direct DFT's 132 kFLOP.
//
// The direct tile (dft_tile): the window folded into DFT matrices C
// and S (window x cols, cols = 32 * NB >= n_bins, zero-padded), read
// through L1/L2; warp w owns FT frames, lane l owns bins l + 32j, and per
// sample k a thread does 2*FT*NB FMAs.  ~25x an FFT's operations.  K1
// keeps it for an nfft the FFT core does not take (not a power of two,
// which psd_backend still sends to "direct"): the choice is made by
// shape in welch_fft_shape, never on a failure.  K5 still runs it: the
// FFT core needs its own store epilogue for K5's frame rows, which is
// the next kernel change, and until then K5's numbers stay as measured.
#include "depam.cuh"
#include "fft.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <int NB>
__host__ __device__ constexpr int frames_per_warp() {
  return NB <= 5 ? 8 : 4;
}

// Stage the samples of frames [f0, f0 + 8*FT) of one record into shared
// memory, decoded (zero past the record's end).
template <typename T, int FT>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ xr,
                                            long long n, int f0, int window,
                                            int hop, float scale,
                                            float* smem) {
  const long long base = static_cast<long long>(f0) * hop;
  const int span = (kWarps * FT - 1) * hop + window;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long g = base + i;
    smem[i] = g < n ? depam::sample(xr, g, scale) : 0.f;
  }
}

// The folded DFT of this warp's FT staged frames: re[i][j] and im[i][j]
// for frame warp*FT + i of the chunk and bin lane + 32j.
template <int NB, int FT>
__device__ __forceinline__ void dft_tile(const float* smem,
                                         const float* __restrict__ c,
                                         const float* __restrict__ s,
                                         int window, int hop,
                                         float (&re)[FT][NB],
                                         float (&im)[FT][NB]) {
  constexpr int kCols = 32 * NB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* xs = smem + warp * FT * hop;
#pragma unroll
  for (int i = 0; i < FT; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k = 0; k < window; ++k) {
    float cv[NB], sv[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      cv[j] = c[k * kCols + lane + 32 * j];
      sv[j] = s[k * kCols + lane + 32 * j];
    }
#pragma unroll
    for (int i = 0; i < FT; ++i) {
      const float a = xs[i * hop + k];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        re[i][j] = fmaf(a, cv[j], re[i][j]);
        im[i][j] = fmaf(a, sv[j], im[i][j]);
      }
    }
  }
}

template <typename T, int NB, int FT>
__global__ void __launch_bounds__(kThreads)
welch_partial_kernel(const T* __restrict__ x, long long ld, long long n,
                     const float* __restrict__ rec_scale,
                     const float* __restrict__ c,
                     const float* __restrict__ s,
                     float* __restrict__ partial, int n_frames, int window,
                     int hop) {
  extern __shared__ float smem[];
  constexpr int kCols = 32 * NB;
  const int chunk = blockIdx.x;
  const long long r = blockIdx.y;
  const int f0 = chunk * kWarps * FT;
  const float scale = rec_scale != nullptr ? rec_scale[r] : 1.f;
  stage_chunk<T, FT>(x + r * ld, n, f0, window, hop, scale, smem);
  __syncthreads();

  float re[FT][NB], im[FT][NB];
  dft_tile<NB, FT>(smem, c, s, window, hop, re, im);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float pw[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) pw[j] = 0.f;
#pragma unroll
  for (int i = 0; i < FT; ++i) {
    if (f0 + warp * FT + i < n_frames) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        pw[j] += re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  }

  __syncthreads();  // every warp is done with the staged samples
  float* red = smem;
#pragma unroll
  for (int j = 0; j < NB; ++j) red[warp * kCols + lane + 32 * j] = pw[j];
  __syncthreads();
  for (int col = threadIdx.x; col < kCols; col += kThreads) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w * kCols + col];
    partial[(r * gridDim.x + chunk) * kCols + col] = t;
  }
}

__global__ void __launch_bounds__(128)
welch_finish_kernel(const float* __restrict__ partial,
                    const float* __restrict__ bin_scale,
                    float* __restrict__ out, int n_chunks, int n_bins,
                    int cols) {
  const int b = blockIdx.x * 128 + threadIdx.x;
  const long long r = blockIdx.y;
  if (b >= n_bins) return;
  const float* p = partial + r * n_chunks * cols + b;
  float acc = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch)
    acc += p[static_cast<long long>(ch) * cols];
  out[r * n_bins + b] = acc * bin_scale[b];
}

// K1 by FFT: frame chunks of one record as welch_partial_kernel, each
// frame transformed by a group of L lanes (fft.cuh).
constexpr int kFftFrames = 8;  // frames per warp

template <int L>
__host__ __device__ constexpr int fft_bufs() {
  return kWarps * depam::fft::Group<L>::kFloats;
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
welch_fft_kernel(const T* __restrict__ x, long long ld, long long n,
                 const float* __restrict__ rec_scale,
                 const float* __restrict__ w,
                 const float2* __restrict__ tw,
                 const float4* __restrict__ split, unsigned radices,
                 int n_pass, float* __restrict__ partial, int n_frames,
                 int window, int hop) {
  using Grp = depam::fft::Group<L>;
  constexpr int kCols = Grp::M + 1;
  constexpr int G = Grp::G;
  extern __shared__ float smem[];
  float* bufs = smem;                      // one FFT buffer a warp
  float* stage = smem + fft_bufs<L>();     // the chunk's samples
  const int chunk = blockIdx.x;
  const long long r = blockIdx.y;
  const int f0 = chunk * kWarps * kFftFrames;
  const float scale = rec_scale != nullptr ? rec_scale[r] : 1.f;
  stage_chunk<T, kFftFrames>(x + r * ld, n, f0, window, hop, scale, stage);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  Grp grp;
  grp.re = bufs + warp * Grp::kFloats;
  grp.g = (threadIdx.x % 32) / L;
  grp.l = threadIdx.x % L;
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  for (int it = 0; it < kFftFrames / G; ++it) {
    const int fc = warp * kFftFrames + it * G + grp.g;  // frame of chunk
    const float* xs = stage + fc * hop;
    auto first = [&](int q) {
      const int i = 2 * q;
      return make_float2(i < window ? __fmul_rn(xs[i], w[i]) : 0.f,
                         i + 1 < window ? __fmul_rn(xs[i + 1], w[i + 1])
                                        : 0.f);
    };
    const int rot = grp.run(first, radices, n_pass, tw);
    float pw[9];
    grp.power(rot, split, pw);
    if (f0 + fc < n_frames) {
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[t] += pw[t];
    }
  }

  __syncthreads();  // every group is done with its buffer
  float* red = bufs;  // (kWarps * G, kCols) fits in the buffers
  const int row = warp * G + grp.g;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int k = grp.l + L * t;
    if (k < kCols) red[row * kCols + k] = acc[t];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < kCols; col += kThreads) {
    float t = 0.f;
    for (int i = 0; i < kWarps * G; ++i) t += red[i * kCols + col];
    partial[(r * gridDim.x + chunk) * kCols + col] = t;
  }
}

template <typename T, int NB, int FT>
__global__ void __launch_bounds__(kThreads)
frame_psd_kernel(const T* __restrict__ x, long long ld, long long n,
                 const float* __restrict__ rec_scale,
                 const float* __restrict__ c, const float* __restrict__ s,
                 const float* __restrict__ bin_scale,
                 float* __restrict__ out, int n_frames, int window, int hop,
                 int n_bins) {
  extern __shared__ float smem[];
  const long long r = blockIdx.y;
  const int f0 = blockIdx.x * kWarps * FT;
  const float scale = rec_scale != nullptr ? rec_scale[r] : 1.f;
  stage_chunk<T, FT>(x + r * ld, n, f0, window, hop, scale, smem);
  __syncthreads();

  float re[FT][NB], im[FT][NB];
  dft_tile<NB, FT>(smem, c, s, window, hop, re, im);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float bs[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int b = lane + 32 * j;
    bs[j] = b < n_bins ? bin_scale[b] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < FT; ++i) {
    const int f = f0 + warp * FT + i;
    if (f >= n_frames) break;
    float* row = out + (r * n_frames + f) * n_bins;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int b = lane + 32 * j;
      if (b < n_bins)
        row[b] = (re[i][j] * re[i][j] + im[i][j] * im[i][j]) * bs[j];
    }
  }
}

// K1's route, by shape: the FFT core for a power-of-two nfft from 128
// to 512 (groups of 8 to 32 lanes) with window <= nfft; the direct tile
// for any other nfft.
bool welch_fft_shape(int nfft, int window) {
  return nfft >= 128 && nfft <= 512 && (nfft & (nfft - 1)) == 0
         && window <= nfft;
}

size_t welch_fft_bytes(int nfft, int window, int hop) {
  const int span = (kWarps * kFftFrames - 1) * hop + window;
  const int bufs = nfft == 128 ? fft_bufs<8>()
                   : nfft == 256 ? fft_bufs<16>() : fft_bufs<32>();
  return sizeof(float) * static_cast<size_t>(bufs + span);
}

template <int NB>
size_t welch_direct_bytes(int window, int hop) {
  constexpr int FT = frames_per_warp<NB>();
  const int span = (kWarps * FT - 1) * hop + window;
  const int floats = span > kWarps * 32 * NB ? span : kWarps * 32 * NB;
  return sizeof(float) * static_cast<size_t>(floats);
}

cudaError_t welch_finish(const float* partial, const float* bin_scale,
                         float* out, int n_rec, int n_chunks, int n_bins,
                         int cols, cudaStream_t stream) {
  welch_finish_kernel<<<dim3((n_bins + 127) / 128, n_rec), 128, 0,
                        stream>>>(partial, bin_scale, out, n_chunks, n_bins,
                                  cols);
  return cudaGetLastError();
}

// The launches assume depam_welch_psd_plan raised the kernels' shared
// memory limit for this shape on this device.
template <typename T, int L>
cudaError_t launch_welch_fft(const T* x, long long ld, long long n,
                             const float* rec_scale,
                             const float* const* consts, unsigned radices,
                             int n_pass, float* partial, float* out,
                             int n_rec, int n_frames, int window, int hop,
                             cudaStream_t stream) {
  constexpr int kChunk = kWarps * kFftFrames;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  welch_fft_kernel<T, L>
      <<<dim3(n_chunks, n_rec), kThreads,
         welch_fft_bytes(16 * L, window, hop), stream>>>(
          x, ld, n, rec_scale, consts[3],
          reinterpret_cast<const float2*>(consts[4]),
          reinterpret_cast<const float4*>(consts[5]), radices, n_pass,
          partial, n_frames, window, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return welch_finish(partial, consts[2], out, n_rec, n_chunks, 8 * L + 1,
                      8 * L + 1, stream);
}

template <typename T, int NB>
cudaError_t launch_welch_direct(const T* x, long long ld, long long n,
                                const float* rec_scale,
                                const float* const* consts, float* partial,
                                float* out, int n_rec, int n_frames,
                                int window, int hop, int n_bins,
                                cudaStream_t stream) {
  constexpr int FT = frames_per_warp<NB>();
  constexpr int kChunk = kWarps * FT;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  welch_partial_kernel<T, NB, FT>
      <<<dim3(n_chunks, n_rec), kThreads,
         welch_direct_bytes<NB>(window, hop), stream>>>(
          x, ld, n, rec_scale, consts[0], consts[1], partial, n_frames,
          window, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return welch_finish(partial, consts[2], out, n_rec, n_chunks, n_bins,
                      32 * NB, stream);
}

// Raise the shared-memory limit of K1's kernel for this shape (both
// payload types).
template <typename T>
cudaError_t welch_allow(int nfft, int window, int hop, int n_bins) {
  if (welch_fft_shape(nfft, window)) {
    const size_t bytes = welch_fft_bytes(nfft, window, hop);
    switch (nfft) {
      case 128: return depam::allow_smem(welch_fft_kernel<T, 8>, bytes);
      case 256: return depam::allow_smem(welch_fft_kernel<T, 16>, bytes);
      default: return depam::allow_smem(welch_fft_kernel<T, 32>, bytes);
    }
  }
  switch ((n_bins + 31) / 32) {
#define DEPAM_NB(NB)                                                      \
  case NB:                                                                \
    return depam::allow_smem(                                             \
        welch_partial_kernel<T, NB, frames_per_warp<NB>()>,               \
        welch_direct_bytes<NB>(window, hop));
    DEPAM_NB(1) DEPAM_NB(2) DEPAM_NB(3) DEPAM_NB(4) DEPAM_NB(5)
    DEPAM_NB(6) DEPAM_NB(7) DEPAM_NB(8) DEPAM_NB(9)
#undef DEPAM_NB
    default:
      return cudaErrorInvalidValue;
  }
}

// consts: C, S (window x 32*NB; direct route), bin scale (n_bins),
// window, twiddles (float2), split factors (float4) (FFT route).
template <typename T>
int welch_dispatch(const T* x, long long ld, long long n,
                   const float* rec_scale, const float* const* consts,
                   unsigned radices, int n_pass, int n_twiddles,
                   float* partial, float* out, int n_rec, int n_frames,
                   int window, int hop, int nfft, int n_bins, void* stream) {
  if (n_rec <= 0 || n_frames <= 0) return 0;
  if (n_rec > 65535 || n_bins != nfft / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (welch_fft_shape(nfft, window)) {
    if (!depam::fft::plan_fits(radices, n_pass, n_twiddles, nfft / 2))
      return static_cast<int>(cudaErrorInvalidValue);
#define DEPAM_L(N)                                                          \
  case N:                                                                   \
    err = launch_welch_fft<T, N / 16>(x, ld, n, rec_scale, consts, radices, \
                                      n_pass, partial, out, n_rec,          \
                                      n_frames, window, hop, st);           \
    break;
    switch (nfft) { DEPAM_L(128) DEPAM_L(256) DEPAM_L(512) }
#undef DEPAM_L
    return static_cast<int>(err);
  }
  switch ((n_bins + 31) / 32) {
#define DEPAM_NB(NB)                                                        \
  case NB:                                                                  \
    err = launch_welch_direct<T, NB>(x, ld, n, rec_scale, consts, partial,  \
                                     out, n_rec, n_frames, window, hop,     \
                                     n_bins, st);                           \
    break;
    DEPAM_NB(1) DEPAM_NB(2) DEPAM_NB(3) DEPAM_NB(4) DEPAM_NB(5)
    DEPAM_NB(6) DEPAM_NB(7) DEPAM_NB(8) DEPAM_NB(9)
#undef DEPAM_NB
    default:
      break;
  }
  return static_cast<int>(err);
}

template <typename T, int NB>
cudaError_t launch_frames(const T* x, long long ld, long long n,
                          const float* rec_scale, const float* c,
                          const float* s, const float* bin_scale,
                          float* /*partial*/, float* out, int n_rec,
                          int n_frames, int window, int hop, int n_bins,
                          cudaStream_t stream) {
  constexpr int FT = frames_per_warp<NB>();
  constexpr int kChunk = kWarps * FT;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  const size_t bytes =
      sizeof(float) * static_cast<size_t>((kChunk - 1) * hop + window);
  auto kernel = frame_psd_kernel<T, NB, FT>;
  cudaError_t err = depam::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_chunks, n_rec), kThreads, bytes, stream>>>(
      x, ld, n, rec_scale, c, s, bin_scale, out, n_frames, window, hop,
      n_bins);
  return cudaGetLastError();
}

// One switch over NB (bins / 32, rounded up).
template <typename T>
int frames_dispatch(const T* x, long long ld, long long n,
                    const float* rec_scale, const float* c, const float* s,
                    const float* bin_scale, float* out, int n_rec,
                    int n_frames, int window, int hop, int n_bins,
                    void* stream) {
  if (n_rec <= 0 || n_frames <= 0) return 0;
  if (n_rec > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((n_bins + 31) / 32) {
#define DEPAM_NB(NB)                                                     \
  case NB:                                                               \
    err = launch_frames<T, NB>(x, ld, n, rec_scale, c, s, bin_scale,     \
                               nullptr, out, n_rec, n_frames, window,    \
                               hop, n_bins, st);                         \
    break;
    DEPAM_NB(1) DEPAM_NB(2) DEPAM_NB(3) DEPAM_NB(4) DEPAM_NB(5)
    DEPAM_NB(6) DEPAM_NB(7) DEPAM_NB(8) DEPAM_NB(9)
#undef DEPAM_NB
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// K1's launch plan for one shape, on the current device: the route (1
// FFT, 0 direct), the frames a block reduces and the columns of its
// partial (for the wrapper's scratch), and the kernels' shared-memory
// limit raised for both payload types.  Called once per configuration.
extern "C" int depam_welch_psd_plan(int nfft, int window, int hop,
                                    int n_bins, int* route,
                                    int* block_frames, int* cols) {
  if (window < 1 || hop < 1 || n_bins != nfft / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fft = welch_fft_shape(nfft, window);
  const int nb = (n_bins + 31) / 32;
  if (!fft && nb > 9) return static_cast<int>(cudaErrorInvalidValue);
  *route = fft ? 1 : 0;
  *block_frames = kWarps * (fft ? kFftFrames : (nb <= 5 ? 8 : 4));
  *cols = fft ? n_bins : 32 * nb;
  cudaError_t err = welch_allow<float>(nfft, window, hop, n_bins);
  if (err == cudaSuccess)
    err = welch_allow<int16_t>(nfft, window, hop, n_bins);
  return static_cast<int>(err);
}

extern "C" int depam_welch_psd_f32(const float* x, long long ld, long long n,
                                   const float* const* consts,
                                   unsigned radices, int n_pass,
                                   int n_twiddles, float* partial,
                                   float* out, int n_rec, int n_frames,
                                   int window, int hop, int nfft,
                                   int n_bins, void* stream) {
  return welch_dispatch(x, ld, n, static_cast<const float*>(nullptr),
                        consts, radices, n_pass, n_twiddles, partial, out,
                        n_rec, n_frames, window, hop, nfft, n_bins, stream);
}

extern "C" int depam_welch_psd_i16(const int16_t* x, long long ld,
                                   long long n, const float* rec_scale,
                                   const float* const* consts,
                                   unsigned radices, int n_pass,
                                   int n_twiddles, float* partial,
                                   float* out, int n_rec, int n_frames,
                                   int window, int hop, int nfft,
                                   int n_bins, void* stream) {
  return welch_dispatch(x, ld, n, rec_scale, consts, radices, n_pass,
                        n_twiddles, partial, out, n_rec, n_frames, window,
                        hop, nfft, n_bins, stream);
}

extern "C" int depam_frame_psd_f32(const float* x, long long ld, long long n,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* out,
                                   int n_rec, int n_frames, int window,
                                   int hop, int n_bins, void* stream) {
  return frames_dispatch(x, ld, n, static_cast<const float*>(nullptr), c, s,
                         bin_scale, out, n_rec, n_frames, window, hop,
                         n_bins, stream);
}

extern "C" int depam_frame_psd_i16(const int16_t* x, long long ld,
                                   long long n, const float* rec_scale,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* out,
                                   int n_rec, int n_frames, int window,
                                   int hop, int n_bins, void* stream) {
  return frames_dispatch(x, ld, n, rec_scale, c, s, bin_scale, out, n_rec,
                         n_frames, window, hop, n_bins, stream);
}
