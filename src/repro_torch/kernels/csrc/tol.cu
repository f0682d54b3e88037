// K4: third-octave levels, 10*log10(max((psd @ M) * df, 1e-30)) + gain.
//
// Replaces the TPU kernel src/repro/kernels/tol.py:29 (tol_levels,
// pallas_call at :48, body :22-25).
//
// Bound on this card: bytes, and far below the launch.  The main path
// gives it (8, 129) x (129, 33) or (8, 2049) x (2049, 33): at most
// ~340 KB moved (0.1 us at 3.35 TB/s) and ~0.5 MFLOP, so a call should
// cost about one launch.
//
// What held the earlier design back: one block per record (8 blocks on
// 132 SMs), 64 band lanes for 33 bands, and each live thread walking
// its 257-bin slice as one serial chain of FMAs, every step waiting on
// an L2 load of M (about 23 us on an H100 at set 2).
//
// Design: a block per (band, group of kRecs records), 256 threads:
// n_bands x ceil(n_rec / kRecs) blocks, 33 at the paper's 8 records.
// Thread t takes bins k = t, t + 256, ...: it reads M[k, band] once and
// psd[r, k] of its block's records (coalesced along k), and keeps one
// accumulator per record, so the loads of a step are independent and a
// chain is ceil(n_bins / 256) steps long (9 at set 2; unrolled by 2,
// which measured faster on an H100 than unrolled by 9).  Each record's
// 256 partials are then summed by a fixed tree (shuffles within each
// warp, then the 8 warps in order in shared memory), and one thread per
// record takes the scale, the floor and the log.  M is read as the
// dense matrix it is, whatever its sparsity, and the sum order depends
// only on the shapes: no atomics, the same bits on every run.
#include "depam.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRecs = 8;  // records a block

__global__ void __launch_bounds__(kThreads)
tol_levels_kernel(const float* __restrict__ psd,
                  const float* __restrict__ m, float* __restrict__ out,
                  int n_rec, int n_bins, int n_bands, float df,
                  float gain_db) {
  __shared__ float part[kWarps][kRecs];
  const int band = blockIdx.x;
  const int r0 = blockIdx.y * kRecs;
  const int nr = min(kRecs, n_rec - r0);
  const float* rows = psd + static_cast<long long>(r0) * n_bins;
  float acc[kRecs];
#pragma unroll
  for (int i = 0; i < kRecs; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int k = threadIdx.x; k < n_bins; k += kThreads) {
    const float mk = m[static_cast<long long>(k) * n_bands + band];
#pragma unroll
    for (int i = 0; i < kRecs; ++i)
      if (i < nr)
        acc[i] = fmaf(rows[static_cast<long long>(i) * n_bins + k], mk,
                      acc[i]);
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < kRecs; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRecs; ++i) part[warp][i] = acc[i];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nr) {
    float power = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) power += part[w][threadIdx.x];
    power = __fmul_rn(power, df);
    out[static_cast<long long>(r0 + threadIdx.x) * n_bands + band] =
        10.f * log10f(fmaxf(power, 1e-30f)) + gain_db;
  }
}

}  // namespace

extern "C" int depam_tol_levels(const float* psd, const float* m, float* out,
                                int n_rec, int n_bins, int n_bands, float df,
                                float gain_db, void* stream) {
  if (n_rec <= 0 || n_bands <= 0) return 0;
  const int groups = (n_rec + kRecs - 1) / kRecs;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  tol_levels_kernel<<<dim3(n_bands, groups), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      psd, m, out, n_rec, n_bins, n_bands, df, gain_db);
  return static_cast<int>(cudaGetLastError());
}
