// K1 and K5: the per-record Welch PSD and the per-frame PSD of paper
// set 1, sharing one staging of the signal (stage_chunk below) and one
// FFT core (fft.cuh, shared with K2):
//
//  * K1 welch_psd: per-record Welch PSD (frame -> window -> real DFT ->
//    |X|^2 -> mean over frames -> one-sided density scale), per-frame
//    spectra never written to device memory.  Replaces the TPU kernel
//    src/repro/kernels/framepsd.py:239 (welch_psd, pallas_call at :289,
//    bodies :211-235).
//  * K5 frame_psd: the per-frame PSD (the spectrogram), each frame's
//    |X|^2 x one-sided weight x density scale stored as a row.  Replaces
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
//  * The route, by shape (fft_shape, the one rule for both kernels):
//    the FFT core for a power-of-two nfft from 128 to 512 with window
//    <= nfft, the direct tile for any other nfft.  Chosen by shape, never
//    on a failure.
//  * No float atomics: every value has one fixed order of operations,
//    so every run gives the same bits (int16 == float32, a 1-D call ==
//    its row of the 2-D call, resumed == uninterrupted depend on it).
//
// The FFT route: a group of L = nfft/16 lanes transforms one frame (16
// lanes x 8 points at nfft 256, two frames a warp); its first pass reads
// the frame's sample pairs from the staged chunk, windowed as they load
// (window <= nfft zero-pads).  About 5 kFLOP a frame at nfft 256
// against the direct DFT's 132 kFLOP.
//  * K1 (welch_fft_kernel): each lane adds |X|^2 of its bins over its
//    group's frames in registers, in frame order; the block sums its
//    8 x (32/L) groups in a fixed order into the chunk's partial, and
//    welch_finish_kernel sums the chunks in order and applies the bin
//    scale (one-sided weight x density scale x 1/frames).  The Pallas
//    grid carried the frame sum across sequential grid steps; here the
//    chunks run in parallel and the finish kernel is the carry.
//  * K5 (frame_fft_kernel): the store epilogue.  A warp's G groups hold
//    G consecutive frames, whose rows are one contiguous run of G x
//    n_bins floats in the output.  Once every group has read its
//    buffer (power, then __syncwarp), each lane writes its bins' power
//    x bin scale into the warp's FFT buffer in row order, and the warp
//    stores the run lane by lane: 32 neighbouring floats a store, and
//    no shared memory beyond K1's (at nfft 256, 64 registers against
//    K1's 80 in nvcc -Xptxas -v for sm_90a, so four blocks fit an SM
//    where K1 fits three).  Frames past the record's end are
//    transformed (zeros) and not stored.  Streaming stores (__stcs) in
//    place of plain ones measured slower on an H100.  The direct
//    route's K5 was bound by its DFT (2*FT*NB FMAs a thread a sample,
//    C and S read through L1/L2: 25x an FFT's work); this route's
//    63 MB of row writes at set 1 are its floor (19 us at 3.35 TB/s).
//
// The direct tile (dft_tile): the window folded into DFT matrices C
// and S (window x cols, cols = 32 * NB >= n_bins, zero-padded), read
// through L1/L2; warp w owns FT frames, lane l owns bins l + 32j, and per
// sample k a thread does 2*FT*NB FMAs.  ~25x an FFT's operations.  Both
// kernels keep it for an nfft the FFT core does not take (not a power of
// two, such as 320, or below 128).
#include "depam.cuh"
#include "fft.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// Frames a warp takes on the direct route, by NB (bins / 32, rounded
// up): its registers hold FT x NB complex bins.
__host__ __device__ constexpr int frames_per_warp(int nb) {
  return nb <= 5 ? 8 : 4;
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

// The FFT route: frame chunks of one record as welch_partial_kernel,
// each frame transformed by a group of L lanes (fft.cuh).
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

// K5 by FFT: welch_fft_kernel's grid, staging and transform, then the
// store epilogue: the warp's G consecutive frames leave through its FFT
// buffer as one run of G rows.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
frame_fft_kernel(const T* __restrict__ x, long long ld, long long n,
                 const float* __restrict__ rec_scale,
                 const float* __restrict__ bin_scale,
                 const float* __restrict__ w,
                 const float2* __restrict__ tw,
                 const float4* __restrict__ split, unsigned radices,
                 int n_pass, float* __restrict__ out, int n_frames,
                 int window, int hop) {
  using Grp = depam::fft::Group<L>;
  constexpr int kBins = Grp::M + 1;
  constexpr int G = Grp::G;
  extern __shared__ float smem[];
  float* bufs = smem;                      // one FFT buffer a warp
  float* stage = smem + fft_bufs<L>();     // the chunk's samples
  const long long r = blockIdx.y;
  const int f0 = blockIdx.x * kWarps * kFftFrames;
  const float scale = rec_scale != nullptr ? rec_scale[r] : 1.f;
  stage_chunk<T, kFftFrames>(x + r * ld, n, f0, window, hop, scale, stage);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Grp grp;
  grp.re = bufs + warp * Grp::kFloats;
  grp.g = lane / L;
  grp.l = threadIdx.x % L;
  float bs[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int k = grp.l + L * t;
    bs[t] = k < kBins ? bin_scale[k] : 0.f;
  }
  // The run of G rows fits the buffer: G (M + 1) <= 2 M G floats.
  float* run = grp.re;
  float* rows = out + (r * n_frames + f0) * kBins;
  for (int it = 0; it < kFftFrames / G; ++it) {
    const int fw = warp * kFftFrames + it * G;  // the warp's first frame
    const float* xs = stage + (fw + grp.g) * hop;
    auto first = [&](int q) {
      const int i = 2 * q;
      return make_float2(i < window ? __fmul_rn(xs[i], w[i]) : 0.f,
                         i + 1 < window ? __fmul_rn(xs[i + 1], w[i + 1])
                                        : 0.f);
    };
    const int rot = grp.run(first, radices, n_pass, tw);
    float pw[9];
    grp.power(rot, split, pw);
    __syncwarp();  // every group has read its buffer
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int k = grp.l + L * t;
      if (k < kBins) run[grp.g * kBins + k] = pw[t] * bs[t];
    }
    __syncwarp();
    const int live = min(G, n_frames - (f0 + fw));
    float* dst = rows + fw * kBins;
    for (int i = lane; i < live * kBins; i += 32) dst[i] = run[i];
    __syncwarp();  // the run is stored before the next pass writes
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

// The route of both kernels, by shape: the FFT core for a power-of-two
// nfft from 128 to 512 (groups of 8 to 32 lanes) with window <= nfft;
// the direct tile for any other nfft.
bool fft_shape(int nfft, int window) {
  return nfft >= 128 && nfft <= 512 && (nfft & (nfft - 1)) == 0
         && window <= nfft;
}

// Shared memory of the FFT route (either kernel): the warps' buffers
// and the staged chunk.
size_t fft_bytes(int nfft, int window, int hop) {
  const int span = (kWarps * kFftFrames - 1) * hop + window;
  const int bufs = nfft == 128 ? fft_bufs<8>()
                   : nfft == 256 ? fft_bufs<16>() : fft_bufs<32>();
  return sizeof(float) * static_cast<size_t>(bufs + span);
}

// Shared memory of the direct route: the staged chunk, which K1 reuses
// for its warps' partials.
template <int NB>
size_t direct_bytes(bool frames, int window, int hop) {
  constexpr int FT = frames_per_warp(NB);
  const int span = (kWarps * FT - 1) * hop + window;
  const int red = frames ? 0 : kWarps * 32 * NB;
  return sizeof(float) * static_cast<size_t>(span > red ? span : red);
}

cudaError_t welch_finish(const float* partial, const float* bin_scale,
                         float* out, int n_rec, int n_chunks, int n_bins,
                         int cols, cudaStream_t stream) {
  welch_finish_kernel<<<dim3((n_bins + 127) / 128, n_rec), 128, 0,
                        stream>>>(partial, bin_scale, out, n_chunks, n_bins,
                                  cols);
  return cudaGetLastError();
}

// The launches assume the plan (depam_welch_psd_plan or
// depam_frame_psd_plan) raised the kernel's shared-memory limit for this
// shape on this device.  consts: C, S (window x 32*NB; direct route),
// bin scale (n_bins), window, twiddles (float2), split factors (float4)
// (FFT route).
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
      <<<dim3(n_chunks, n_rec), kThreads, fft_bytes(16 * L, window, hop),
         stream>>>(
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
  constexpr int FT = frames_per_warp(NB);
  constexpr int kChunk = kWarps * FT;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  welch_partial_kernel<T, NB, FT>
      <<<dim3(n_chunks, n_rec), kThreads,
         direct_bytes<NB>(false, window, hop), stream>>>(
          x, ld, n, rec_scale, consts[0], consts[1], partial, n_frames,
          window, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return welch_finish(partial, consts[2], out, n_rec, n_chunks, n_bins,
                      32 * NB, stream);
}

template <typename T, int L>
cudaError_t launch_frame_fft(const T* x, long long ld, long long n,
                             const float* rec_scale,
                             const float* const* consts, unsigned radices,
                             int n_pass, float* out, int n_rec,
                             int n_frames, int window, int hop,
                             cudaStream_t stream) {
  constexpr int kChunk = kWarps * kFftFrames;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  frame_fft_kernel<T, L>
      <<<dim3(n_chunks, n_rec), kThreads, fft_bytes(16 * L, window, hop),
         stream>>>(
          x, ld, n, rec_scale, consts[2], consts[3],
          reinterpret_cast<const float2*>(consts[4]),
          reinterpret_cast<const float4*>(consts[5]), radices, n_pass, out,
          n_frames, window, hop);
  return cudaGetLastError();
}

template <typename T, int NB>
cudaError_t launch_frame_direct(const T* x, long long ld, long long n,
                                const float* rec_scale,
                                const float* const* consts, float* out,
                                int n_rec, int n_frames, int window, int hop,
                                int n_bins, cudaStream_t stream) {
  constexpr int FT = frames_per_warp(NB);
  constexpr int kChunk = kWarps * FT;
  const int n_chunks = (n_frames + kChunk - 1) / kChunk;
  frame_psd_kernel<T, NB, FT>
      <<<dim3(n_chunks, n_rec), kThreads,
         direct_bytes<NB>(true, window, hop), stream>>>(
          x, ld, n, rec_scale, consts[0], consts[1], consts[2], out,
          n_frames, window, hop, n_bins);
  return cudaGetLastError();
}

// Raise the shared-memory limit of the kernel that serves this shape:
// K5's (frames) or K1's, for payload type T.
template <typename T>
cudaError_t allow(bool frames, int nfft, int window, int hop, int n_bins) {
  if (fft_shape(nfft, window)) {
    const size_t bytes = fft_bytes(nfft, window, hop);
#define DEPAM_L(N)                                                    \
  case N:                                                             \
    return frames ? depam::allow_smem(frame_fft_kernel<T, N / 16>, bytes) \
                  : depam::allow_smem(welch_fft_kernel<T, N / 16>, bytes);
    switch (nfft) { DEPAM_L(128) DEPAM_L(256) DEPAM_L(512) }
#undef DEPAM_L
    return cudaErrorInvalidValue;
  }
  switch ((n_bins + 31) / 32) {
#define DEPAM_NB(NB)                                                      \
  case NB: {                                                              \
    constexpr int FT = frames_per_warp(NB);                             \
    const size_t bytes = direct_bytes<NB>(frames, window, hop);           \
    return frames                                                         \
        ? depam::allow_smem(frame_psd_kernel<T, NB, FT>, bytes)           \
        : depam::allow_smem(welch_partial_kernel<T, NB, FT>, bytes);      \
  }
    DEPAM_NB(1) DEPAM_NB(2) DEPAM_NB(3) DEPAM_NB(4) DEPAM_NB(5)
    DEPAM_NB(6) DEPAM_NB(7) DEPAM_NB(8) DEPAM_NB(9)
#undef DEPAM_NB
    default:
      return cudaErrorInvalidValue;
  }
}

// The plan of either kernel for one shape, on the current device: the
// route (1 FFT, 0 direct) and the kernel's shared-memory limit raised
// for both payload types.
int plan(bool frames, int nfft, int window, int hop, int n_bins,
         int* route) {
  if (window < 1 || hop < 1 || n_bins != nfft / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fft = fft_shape(nfft, window);
  if (!fft && (n_bins + 31) / 32 > 9)
    return static_cast<int>(cudaErrorInvalidValue);
  *route = fft ? 1 : 0;
  cudaError_t err = allow<float>(frames, nfft, window, hop, n_bins);
  if (err == cudaSuccess)
    err = allow<int16_t>(frames, nfft, window, hop, n_bins);
  return static_cast<int>(err);
}

// The arguments both dispatches check before a launch.
int refuse(int n_rec, int nfft, int window, unsigned radices, int n_pass,
           int n_twiddles, int n_bins) {
  if (n_rec > 65535 || n_bins != nfft / 2 + 1) return 1;
  return fft_shape(nfft, window)
         && !depam::fft::plan_fits(radices, n_pass, n_twiddles, nfft / 2);
}

template <typename T>
int welch_dispatch(const T* x, long long ld, long long n,
                   const float* rec_scale, const float* const* consts,
                   unsigned radices, int n_pass, int n_twiddles,
                   float* partial, float* out, int n_rec, int n_frames,
                   int window, int hop, int nfft, int n_bins, void* stream) {
  if (n_rec <= 0 || n_frames <= 0) return 0;
  if (refuse(n_rec, nfft, window, radices, n_pass, n_twiddles, n_bins))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (fft_shape(nfft, window)) {
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

template <typename T>
int frames_dispatch(const T* x, long long ld, long long n,
                    const float* rec_scale, const float* const* consts,
                    unsigned radices, int n_pass, int n_twiddles, float* out,
                    int n_rec, int n_frames, int window, int hop, int nfft,
                    int n_bins, void* stream) {
  if (n_rec <= 0 || n_frames <= 0) return 0;
  if (refuse(n_rec, nfft, window, radices, n_pass, n_twiddles, n_bins))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (fft_shape(nfft, window)) {
#define DEPAM_L(N)                                                          \
  case N:                                                                   \
    err = launch_frame_fft<T, N / 16>(x, ld, n, rec_scale, consts, radices, \
                                      n_pass, out, n_rec, n_frames, window, \
                                      hop, st);                             \
    break;
    switch (nfft) { DEPAM_L(128) DEPAM_L(256) DEPAM_L(512) }
#undef DEPAM_L
    return static_cast<int>(err);
  }
  switch ((n_bins + 31) / 32) {
#define DEPAM_NB(NB)                                                     \
  case NB:                                                               \
    err = launch_frame_direct<T, NB>(x, ld, n, rec_scale, consts, out,   \
                                     n_rec, n_frames, window, hop,       \
                                     n_bins, st);                        \
    break;
    DEPAM_NB(1) DEPAM_NB(2) DEPAM_NB(3) DEPAM_NB(4) DEPAM_NB(5)
    DEPAM_NB(6) DEPAM_NB(7) DEPAM_NB(8) DEPAM_NB(9)
#undef DEPAM_NB
    default:
      break;
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
  const int err = plan(false, nfft, window, hop, n_bins, route);
  if (err != 0) return err;
  const int nb = (n_bins + 31) / 32;
  *block_frames = kWarps * (*route ? kFftFrames : frames_per_warp(nb));
  *cols = *route ? n_bins : 32 * nb;
  return 0;
}

// K5's launch plan for one shape, on the current device: the route (1
// FFT, 0 direct) and the kernel's shared-memory limit raised for both
// payload types.  Called once per configuration.
extern "C" int depam_frame_psd_plan(int nfft, int window, int hop,
                                    int n_bins, int* route) {
  return plan(true, nfft, window, hop, n_bins, route);
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
                                   const float* const* consts,
                                   unsigned radices, int n_pass,
                                   int n_twiddles, float* out, int n_rec,
                                   int n_frames, int window, int hop,
                                   int nfft, int n_bins, void* stream) {
  return frames_dispatch(x, ld, n, static_cast<const float*>(nullptr),
                         consts, radices, n_pass, n_twiddles, out, n_rec,
                         n_frames, window, hop, nfft, n_bins, stream);
}

extern "C" int depam_frame_psd_i16(const int16_t* x, long long ld,
                                   long long n, const float* rec_scale,
                                   const float* const* consts,
                                   unsigned radices, int n_pass,
                                   int n_twiddles, float* out, int n_rec,
                                   int n_frames, int window, int hop,
                                   int nfft, int n_bins, void* stream) {
  return frames_dispatch(x, ld, n, rec_scale, consts, radices, n_pass,
                         n_twiddles, out, n_rec, n_frames, window, hop, nfft,
                         n_bins, stream);
}
