// K3: Welch mean over frames, (R, F, B) -> (R, B) with 1/F folded in.
//
// Replaces the TPU kernel src/repro/kernels/welch.py:32 (welch_mean,
// pallas_call at :49, body :21-28).
//
// Bound on this card: bytes.  Each input float is read once and added
// once (set 2: 8 x 80 x 2049 floats, 5.2 MB, ~1.6 us at 3.35 TB/s).
//
// Design: one thread per (record, bin), looping frames in order, so a
// warp reads 32 neighbouring bins of one frame (128 coalesced bytes) per
// step; the Pallas grid's sequential frame-chunk carry becomes this
// in-thread loop.  The sum order is fixed: no atomics, same bits on
// every run.
#include "depam.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
welch_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int n_frames, int n_bins, float inv_n) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const long long r = blockIdx.y;
  if (b >= n_bins) return;
  const float* p = x + r * n_frames * n_bins + b;
  float acc = 0.f;
  for (int f = 0; f < n_frames; ++f)
    acc += p[static_cast<long long>(f) * n_bins];
  out[r * n_bins + b] = acc * inv_n;
}

}  // namespace

extern "C" int depam_welch_mean(const float* x, float* out, int n_rec,
                                int n_frames, int n_bins, float inv_n,
                                void* stream) {
  if (n_rec <= 0 || n_bins <= 0) return 0;
  if (n_rec > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n_bins + kThreads - 1) / kThreads, n_rec);
  welch_mean_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n_frames, n_bins, inv_n);
  return static_cast<int>(cudaGetLastError());
}
