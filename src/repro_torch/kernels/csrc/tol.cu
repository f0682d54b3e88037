// K4: third-octave levels, 10*log10(max((psd @ M) * df, 1e-30)) + gain.
//
// Replaces the TPU kernel src/repro/kernels/tol.py:29 (tol_levels,
// pallas_call at :48, body :22-25).
//
// Bound on this card: neither bytes nor operations.  The main path
// gives it (8, 129) x (129, 33) or (8, 2049) x (2049, 33): at most
// ~340 KB moved and ~1 MFLOP, under a microsecond of either, so the
// launch dominates.
//
// Design: one block per record.  Threads are (band lane, bin slice):
// 64 band lanes x 8 slices.  Each slice walks its contiguous run of bins
// in order with f32 FMAs (M is read through L1/L2: at 2049 x 33 floats
// it is larger than shared memory), the 8 slice partials are summed in
// a fixed order in shared memory, and one thread per band takes the
// log.  No atomics, so the result is the same on every run.
#include "depam.cuh"

namespace {

constexpr int kBandLanes = 64;
constexpr int kSlices = 8;

__global__ void __launch_bounds__(kBandLanes * kSlices)
tol_levels_kernel(const float* __restrict__ psd,
                  const float* __restrict__ m, float* __restrict__ out,
                  int n_bins, int n_bands, float df, float gain_db) {
  __shared__ float part[kSlices][kBandLanes];
  const int r = blockIdx.x;
  const int lane = threadIdx.x % kBandLanes;
  const int slice = threadIdx.x / kBandLanes;
  const int per = (n_bins + kSlices - 1) / kSlices;
  const int k0 = min(n_bins, slice * per);
  const int k1 = min(n_bins, k0 + per);
  const float* row = psd + static_cast<long long>(r) * n_bins;
  for (int g = 0; g < n_bands; g += kBandLanes) {
    const int band = g + lane;
    float acc = 0.f;
    if (band < n_bands) {
      for (int k = k0; k < k1; ++k)
        acc = fmaf(row[k], m[static_cast<long long>(k) * n_bands + band],
                   acc);
    }
    part[slice][lane] = acc;
    __syncthreads();
    if (slice == 0 && band < n_bands) {
      float power = 0.f;
      for (int s = 0; s < kSlices; ++s) power += part[s][lane];
      power = __fmul_rn(power, df);
      out[static_cast<long long>(r) * n_bands + band] =
          10.f * log10f(fmaxf(power, 1e-30f)) + gain_db;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int depam_tol_levels(const float* psd, const float* m, float* out,
                                int n_rec, int n_bins, int n_bands, float df,
                                float gain_db, void* stream) {
  if (n_rec <= 0 || n_bands <= 0) return 0;
  tol_levels_kernel<<<n_rec, kBandLanes * kSlices, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      psd, m, out, n_bins, n_bands, df, gain_db);
  return static_cast<int>(cudaGetLastError());
}
