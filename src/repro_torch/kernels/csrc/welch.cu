// K3: Welch mean over frames, (R, F, B) -> (R, B) with 1/F folded in.
//
// Replaces the TPU kernel src/repro/kernels/welch.py:32 (welch_mean,
// pallas_call at :49, body :21-28).
//
// Bound on this card: bytes.  Each input float is read once and added
// once (set 2: 8 x 80 x 2049 floats, 5.2 MB, ~1.6 us at 3.35 TB/s),
// beside the ~2.1 us that any queued launch costs on an H100
// (scripts/torch_kernel_time.py).  Reaching it takes enough loads in
// flight on every SM; the earlier design, a thread per (record, bin)
// walking the frames with one dependent accumulator (136 blocks of 4
// warps at set 2, one load in flight a thread), was latency-bound.
//
// Design: a block of kWarps warps per (32 bins, record), 65 x 8 = 520
// blocks of 8 warps at set 2, four to an SM.  Lane l takes bin
// 32 * blockIdx.x + l, so each warp reads 128 contiguous bytes of a
// frame row; warp w takes frames w, w + kWarps, ... and loads kUnroll
// of them at once into independent partial sums.  Rows are 2049
// floats, only 4-byte aligned, so the loads stay scalar.  The sum order
// is fixed: each lane adds its partials in order, then the warps' sums
// are added in warp order through shared memory, and the f32 1/F
// scales once.  No atomics, the same bits on every run; the order
// differs from the plain version's sum, so the two agree to rounding,
// not bit for bit.  (Measured on an H100, scripts/torch_kernel_time.py:
// 4 or 16 warps a block, 4 bins a lane, or all of a lane's frames
// loaded at once with predicates were slower; kUnroll 2, 4, 5 and 8
// alike.)
#include "depam.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;    // frames a lane loads at once

__global__ void __launch_bounds__(kThreads)
welch_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int n_frames, int n_bins, float inv_n) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.x * 32 + lane;
  const long long r = blockIdx.y;
  const bool live = b < n_bins;
  const float* p = x + r * n_frames * n_bins + (live ? b : 0);
  const long long step = static_cast<long long>(kWarps) * n_bins;

  float acc[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) acc[j] = 0.f;
  if (live) {
    int f = warp;
    for (; f + (kUnroll - 1) * kWarps < n_frames; f += kUnroll * kWarps) {
      const float* q = p + static_cast<long long>(f) * n_bins;
      float v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) v[j] = q[j * step];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc[j] += v[j];
    }
    // fewer than kUnroll of the warp's frames are left
    const float* q = p + static_cast<long long>(f) * n_bins;
#pragma unroll
    for (int j = 0; j < kUnroll - 1; ++j)
      if (f + j * kWarps < n_frames) acc[j] += q[j * step];
  }
  float s = acc[0];
#pragma unroll
  for (int j = 1; j < kUnroll; ++j) s += acc[j];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && live) {
    s = part[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][lane];
    out[r * n_bins + b] = s * inv_n;
  }
}

}  // namespace

extern "C" int depam_welch_mean(const float* x, float* out, int n_rec,
                                int n_frames, int n_bins, float inv_n,
                                void* stream) {
  if (n_rec <= 0 || n_bins <= 0) return 0;
  if (n_rec > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n_bins + 31) / 32, n_rec);
  welch_mean_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n_frames, n_bins, inv_n);
  return static_cast<int>(cudaGetLastError());
}
