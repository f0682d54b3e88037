// K1: fused per-record Welch PSD (frame -> window -> real DFT -> |X|^2
// -> mean over frames -> one-sided density scale), per-frame spectra
// never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/framepsd.py:239 (welch_psd,
// pallas_call at :289, bodies :211-235, _dft_accum :87-106).
//
// Bound on this card: bytes.  The function reads the signal once (set 1:
// 7.9 MB of f32 per record) and writes 129 floats; an FFT needs about
// 2.5 N log2 N = 5.1 kFLOP per 256-sample frame, 78 MFLOP per record,
// ~10 FLOP/byte, below the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20).
// This design's direct DFT does 256 x 129 x 4 = 132 kFLOP per frame,
// ~25x that, so the f32 FMA pipes, not the bytes, limit it: the gap to
// the bound is the algorithm's.
//
// Design:
//  * The Pallas grid carried the frame sum across sequential grid steps.
//    Here a block owns one (record, chunk of 8*FT frames) tile and
//    writes its per-bin partial to a (R, n_chunks, cols) scratch; a
//    second small kernel sums the chunks in order and applies the bin
//    scale (one-sided weight x density scale x 1/frames).  No float
//    atomics, so every run gives the same bits (int16 == float32 and
//    resume == uninterrupted depend on it).
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
//    decode's single rounding.
#include "depam.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <int NB>
__host__ __device__ constexpr int frames_per_warp() {
  return NB <= 5 ? 8 : 4;
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
  constexpr int kChunk = kWarps * FT;
  constexpr int kCols = 32 * NB;
  const int chunk = blockIdx.x;
  const long long r = blockIdx.y;
  const int f0 = chunk * kChunk;
  const float scale = rec_scale != nullptr ? rec_scale[r] : 1.f;

  const long long base = static_cast<long long>(f0) * hop;
  const int span = (kChunk - 1) * hop + window;
  const T* xr = x + r * ld;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long g = base + i;
    smem[i] = g < n ? depam::sample(xr, g, scale) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* xs = smem + warp * FT * hop;
  float re[FT][NB], im[FT][NB];
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

template <typename T, int NB>
cudaError_t launch(const T* x, long long ld, long long n,
                   const float* rec_scale, const float* c, const float* s,
                   const float* bin_scale, float* partial, float* out,
                   int n_rec, int n_frames, int window, int hop, int n_bins,
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

template <typename T>
int dispatch(const T* x, long long ld, long long n, const float* rec_scale,
             const float* c, const float* s, const float* bin_scale,
             float* partial, float* out, int n_rec, int n_frames, int window,
             int hop, int n_bins, void* stream) {
  if (n_rec <= 0 || n_frames <= 0) return 0;
  if (n_rec > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((n_bins + 31) / 32) {
#define DEPAM_NB(NB)                                                       \
  case NB:                                                                 \
    err = launch<T, NB>(x, ld, n, rec_scale, c, s, bin_scale, partial, out, \
                        n_rec, n_frames, window, hop, n_bins, st);         \
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

// Frames each block reduces, for the wrapper's scratch allocation.
extern "C" int depam_welch_psd_block_frames(int n_bins) {
  return (n_bins + 31) / 32 <= 5 ? kWarps * 8 : kWarps * 4;
}

extern "C" int depam_welch_psd_f32(const float* x, long long ld, long long n,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* partial,
                                   float* out, int n_rec, int n_frames,
                                   int window, int hop, int n_bins,
                                   void* stream) {
  return dispatch(x, ld, n, nullptr, c, s, bin_scale, partial, out, n_rec,
                  n_frames, window, hop, n_bins, stream);
}

extern "C" int depam_welch_psd_i16(const int16_t* x, long long ld,
                                   long long n, const float* rec_scale,
                                   const float* c, const float* s,
                                   const float* bin_scale, float* partial,
                                   float* out, int n_rec, int n_frames,
                                   int window, int hop, int n_bins,
                                   void* stream) {
  return dispatch(x, ld, n, rec_scale, c, s, bin_scale, partial, out, n_rec,
                  n_frames, window, hop, n_bins, stream);
}
