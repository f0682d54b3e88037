// K1 and K5: the window-folded direct real DFT of paper set 1, in two
// variants that share one tile (stage_chunk + dft_tile below):
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
// Both replace the reference's shared _dft_accum (framepsd.py:87-106):
// stage_chunk and dft_tile are the one copy of the staging, decode and
// DFT accumulation, so the two transports (float32, int16) and the two
// variants cannot drift apart.
//
// Bound on this card: bytes.  K1 reads the signal once (set 1: 7.9 MB of
// f32 per record) and writes 129 floats; K5 reads the same and writes
// 15 359 x 129 floats (7.9 MB) per record.  An FFT needs about
// 2.5 N log2 N = 5.1 kFLOP per 256-sample frame, ~10 FLOP/byte for K1
// and ~5 for K5, below the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20).
// This design's direct DFT does 256 x 129 x 4 = 132 kFLOP per frame,
// ~25x an FFT, so the f32 FMA pipes, not the bytes, limit both: the gap
// to the bound is the algorithm's.
//
// Design:
//  * A block owns one (record, chunk of 8*FT frames) tile.  The Pallas
//    welch grid carried the frame sum across sequential grid steps; here
//    K1's block writes its per-bin partial to a (R, n_chunks, cols)
//    scratch and a second small kernel sums the chunks in order and
//    applies the bin scale (one-sided weight x density scale x
//    1/frames).  No float atomics, so every run gives the same bits
//    (int16 == float32 and resume == uninterrupted depend on it).  K5's
//    block stores its frames' rows directly: lane l owns bins l + 32j,
//    so each frame's row is written coalesced.
//  * The reference stacked m = window/hop shifted hop views in device
//    memory.  Here the chunk's samples, (8*FT - 1)*hop + window floats,
//    are staged once in shared memory and every frame of every hop phase
//    is read from there: device-memory traffic is the signal, once.
//  * The window is folded into the DFT matrices C and S (window x cols,
//    cols = 32 * NB >= n_bins, zero-padded).  At set 1 they take
//    2 x 256 x 160 x 4 B = 328 KB, more than a block's 227 KB of shared
//    memory, so they are read through L1/L2: the 8 warps of a block walk
//    the same row k together, so each row is fetched from L2 once per
//    block and hit in L1 by the other warps.
//  * Register tiling: warp w owns FT frames, lane l owns bins l + 32j
//    (j < NB).  Per sample k a thread loads NB cos and NB sin values
//    (coalesced across lanes) and FT samples (one shared-memory
//    broadcast each), then does 2*FT*NB FMAs.
//  * int16 records are converted and multiplied by the record's decode
//    scale while they are staged, before any dot product: the host
//    decode's single rounding.  Frames never cross a record, so one
//    scale per record gives the reference's per-frame scales' numbers.
#include "depam.cuh"

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

template <typename T, int NB>
cudaError_t launch_welch(const T* x, long long ld, long long n,
                         const float* rec_scale, const float* c,
                         const float* s, const float* bin_scale,
                         float* partial, float* out, int n_rec,
                         int n_frames, int window, int hop, int n_bins,
                         cudaStream_t stream) {
  constexpr int FT = frames_per_warp<NB>();
  constexpr int kChunk = kWarps * FT;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  const int span = (kChunk - 1) * hop + window;
  const int floats = span > kWarps * 32 * NB ? span : kWarps * 32 * NB;
  const size_t bytes = sizeof(float) * static_cast<size_t>(floats);
  auto kernel = welch_partial_kernel<T, NB, FT>;
  cudaError_t err = depam::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_chunks, n_rec), kThreads, bytes, stream>>>(
      x, ld, n, rec_scale, c, s, partial, n_frames, window, hop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  welch_finish_kernel<<<dim3((n_bins + 127) / 128, n_rec), 128, 0,
                        stream>>>(partial, bin_scale, out, n_chunks, n_bins,
                                  32 * NB);
  return cudaGetLastError();
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

// One switch over NB (bins / 32, rounded up) for both variants.
template <bool kFrames, typename T>
int dispatch(const T* x, long long ld, long long n, const float* rec_scale,
             const float* c, const float* s, const float* bin_scale,
             float* partial, float* out, int n_rec, int n_frames, int window,
             int hop, int n_bins, void* stream) {
  if (n_rec <= 0 || n_frames <= 0) return 0;
  if (n_rec > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((n_bins + 31) / 32) {
#define DEPAM_NB(NB)                                                     \
  case NB:                                                               \
    if constexpr (kFrames)                                               \
      err = launch_frames<T, NB>(x, ld, n, rec_scale, c, s, bin_scale,   \
                                 partial, out, n_rec, n_frames, window,  \
                                 hop, n_bins, st);                       \
    else                                                                 \
      err = launch_welch<T, NB>(x, ld, n, rec_scale, c, s, bin_scale,    \
                                partial, out, n_rec, n_frames, window,   \
                                hop, n_bins, st);                        \
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

// Frames each K1 block reduces, for the wrapper's scratch allocation.
extern "C" int depam_welch_psd_block_frames(int n_bins) {
  return (n_bins + 31) / 32 <= 5 ? kWarps * 8 : kWarps * 4;
}

extern "C" int depam_welch_psd_f32(const float* x, long long ld, long long n,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* partial,
                                   float* out, int n_rec, int n_frames,
                                   int window, int hop, int n_bins,
                                   void* stream) {
  return dispatch<false>(x, ld, n, nullptr, c, s, bin_scale, partial, out,
                         n_rec, n_frames, window, hop, n_bins, stream);
}

extern "C" int depam_welch_psd_i16(const int16_t* x, long long ld,
                                   long long n, const float* rec_scale,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* partial,
                                   float* out, int n_rec, int n_frames,
                                   int window, int hop, int n_bins,
                                   void* stream) {
  return dispatch<false>(x, ld, n, rec_scale, c, s, bin_scale, partial,
                         out, n_rec, n_frames, window, hop, n_bins, stream);
}

extern "C" int depam_frame_psd_f32(const float* x, long long ld, long long n,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* out,
                                   int n_rec, int n_frames, int window,
                                   int hop, int n_bins, void* stream) {
  return dispatch<true>(x, ld, n, nullptr, c, s, bin_scale, nullptr, out,
                        n_rec, n_frames, window, hop, n_bins, stream);
}

extern "C" int depam_frame_psd_i16(const int16_t* x, long long ld,
                                   long long n, const float* rec_scale,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* out,
                                   int n_rec, int n_frames, int window,
                                   int hop, int n_bins, void* stream) {
  return dispatch<true>(x, ld, n, rec_scale, c, s, bin_scale, nullptr, out,
                        n_rec, n_frames, window, hop, n_bins, stream);
}
