// K7: per-event impulsive metrics over each event's own samples:
// (B, N) f32 waveforms, or int16 PCM + per-record f32 decode scales,
// and K6's (counts (B,) int32, rows (B, K, 4) f32) -> (B, K, 4) f32 =
// (sel, peak, kurtosis, rise) for the first min(count, K) slots of
// each record, zeros in the others.
//
// K7 replaces no TPU kernel: the reference computes the impulsive
// metrics in plain jnp (src/repro/api/features.py:614), as a
// (B, K, N) span mask reduced by einsums for every capacity slot,
// whether the slot holds an event or not.  On this card that design
// read about 1 GB a step at paper set 2 (8 x 327 680 samples, K = 16),
// held ~420 MB of transients above the carry and enqueued about 70
// device operations a step from the host, the largest share of the
// detection step's device time, memory and dispatch.  K7 is one launch.
//
// Semantics, the plain version's (kernels/impulsive.py) float32
// formulas: slot k < min(count, K) of record r spans samples
// [onset * hop, min((onset + dur - 1) * hop + window, N)) with onset and
// dur truncated from rows[r, k, 0:2];
//  * n = the span's length (exact), nz = max(n, 1); S_j = sum of x^j
//    over the span, with x^2 = x * x, x^3 = x^2 * x, x^4 = x^2 * x^2;
//  * sel = db(S_2 / fs); mean = S_1 / nz, m2 = S_2 / nz - mean^2,
//    m4 = S_4 / nz - 4 mean (S_3 / nz) + 6 mean^2 (S_2 / nz) - 3 mean^2
//    mean^2, kurtosis = m4 / max(m2^2, 1e-30);
//  * peak = db(max x^2) and rise = (i - onset * hop) / fs, i the first
//    index of that maximum; NaN counts as the largest (torch.amax and
//    argmax).  Outside its span a slot's row reads 0, so a span whose
//    largest x^2 is 0 (or that is empty) peaks at 0 at index 0, as the
//    plain version's argmax over the masked row does;
//  * db(v) = 10 log10(max(v, 1e-30)) + gain, clamp keeping NaN.
// Every scalar step after the sums is an explicitly rounded float32
// operation in the plain version's order, so max, argmax, peak and rise
// equal the plain version's bit for bit; the sums run in this kernel's
// order, not cuBLAS's, so sel and kurtosis agree to a tolerance.
//
// Bound on this card: bytes.  A step of paper set 2 holds about 16
// events of 1-2 frames (4 096-8 192 samples), well under 1 MB of span
// samples, plus the counts, the rows and the output (4 KB): under a
// microsecond at 3.35 TB/s, so a call costs about its launch.  The
// arithmetic (three multiplies, four adds and a compare a sample) is
// far under the float32 peak.
//
// Design: one block per (record, slot), kThreads threads.  A slot at
// or past min(count, K) writes zeros and returns.  A live slot reads
// its span alone: thread t takes samples s0 + t, s0 + t + kThreads, ...
// (coalesced: a warp reads 32 neighbouring samples a load), kUnroll
// loads in flight per thread; the int16 path dequantizes as it loads
// with depam::sample's single float32 multiply, so both payloads reach
// the sums with the same float32 x.  Each thread's order is set by the
// sample index alone, whatever the payload or the row's alignment, and
// the block reduces in a fixed order (warp shuffles, then the warps'
// totals in shared memory, read by one thread), with no atomics: the
// same inputs give the same bits on every run, and the int16 and
// float32 payloads give the same bits.  An event as long as the record
// (80 frames at set 2, 1.3 MB of float32 or 655 KB of int16) is read by
// one block, a few microseconds; a second pass splitting long spans
// over blocks would cost more than it saves at the event lengths the
// detector gives.
#include "depam.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;

struct Acc {
  float s1, s2, s3, s4;
  float pk;     // largest x^2 so far; -1 before any sample
  int at;       // its first index
};

// (v, i) -> the larger value, the first index on a tie; NaN is larger
// than any number, and the first NaN wins.
__device__ __forceinline__ void take_max(float& v, int& i, float v2,
                                         int i2) {
  const bool nan1 = v != v, nan2 = v2 != v2;
  if (nan1 || nan2) {
    if (nan2 && (!nan1 || i2 < i)) {
      v = v2;
      i = i2;
    }
    return;
  }
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void add_sample(Acc& a, float x, int i) {
  const float x2 = __fmul_rn(x, x);
  a.s1 = __fadd_rn(a.s1, x);
  a.s2 = __fadd_rn(a.s2, x2);
  a.s3 = __fadd_rn(a.s3, __fmul_rn(x2, x));
  a.s4 = __fadd_rn(a.s4, __fmul_rn(x2, x2));
  // samples come in increasing index, so strict > keeps the first
  if (x2 > a.pk || (x2 != x2 && a.pk == a.pk)) {
    a.pk = x2;
    a.at = i;
  }
}

__device__ __forceinline__ void combine(Acc& a, const Acc& b) {
  a.s1 = __fadd_rn(a.s1, b.s1);
  a.s2 = __fadd_rn(a.s2, b.s2);
  a.s3 = __fadd_rn(a.s3, b.s3);
  a.s4 = __fadd_rn(a.s4, b.s4);
  take_max(a.pk, a.at, b.pk, b.at);
}

__device__ __forceinline__ Acc shfl_down(const Acc& a, int d) {
  return Acc{__shfl_down_sync(kFull, a.s1, d),
             __shfl_down_sync(kFull, a.s2, d),
             __shfl_down_sync(kFull, a.s3, d),
             __shfl_down_sync(kFull, a.s4, d),
             __shfl_down_sync(kFull, a.pk, d),
             __shfl_down_sync(kFull, a.at, d)};
}

__device__ __forceinline__ float db(float v, float gain) {
  const float c = v < 1e-30f ? 1e-30f : v;   // keeps NaN, as clamp does
  return __fadd_rn(__fmul_rn(10.f, log10f(c)), gain);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
impulsive_kernel(const T* __restrict__ x, const float* __restrict__ scales,
                 const int* __restrict__ counts,
                 const float* __restrict__ rows, float* __restrict__ out,
                 int n_samples, int hop, int window, int capacity, float fs,
                 float gain) {
  __shared__ Acc warp_acc[kWarps];
  const int k = blockIdx.x;
  const long long r = blockIdx.y;
  const int t = threadIdx.x;
  float4* dst = reinterpret_cast<float4*>(out) + r * capacity + k;
  if (k >= min(counts[r], capacity)) {
    if (t == 0) *dst = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float* ev = rows + (r * capacity + k) * 4;
  const int onset = static_cast<int>(ev[0]);
  const int dur = static_cast<int>(ev[1]);
  const int s0 = onset * hop;
  const int s1 = min((onset + dur - 1) * hop + window, n_samples);
  const T* row = x + r * n_samples;
  const float scale = scales == nullptr ? 0.f : scales[r];

  Acc a{0.f, 0.f, 0.f, 0.f, -1.f, kNoIndex};
  // samples come to each thread in increasing index (add_sample)
  for (int i0 = s0 + t; i0 < s1; i0 += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < s1 ? depam::sample(row, i, scale) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * kThreads < s1) add_sample(a, v[u], i0 + u * kThreads);
  }

  // fixed-order block reduction: down the warp, then the warps' totals
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const Acc b = shfl_down(a, d);
    combine(a, b);
  }
  if (t % 32 == 0) warp_acc[t / 32] = a;
  __syncthreads();
  if (t != 0) return;
  a = warp_acc[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) combine(a, warp_acc[w]);

  const float n = static_cast<float>(max(s1 - s0, 0));
  const float nz = fmaxf(n, 1.f);
  const bool some = a.pk > 0.f || a.pk != a.pk;
  const float pk = some ? a.pk : 0.f;
  const int at = some ? a.at : 0;
  const float sel = db(__fdiv_rn(a.s2, fs), gain);
  const float peak = db(pk, gain);
  const float mean = __fdiv_rn(a.s1, nz);
  const float mm = __fmul_rn(mean, mean);
  const float e2 = __fdiv_rn(a.s2, nz);
  const float m2 = __fsub_rn(e2, mm);
  float m4 = __fsub_rn(__fdiv_rn(a.s4, nz),
                       __fmul_rn(__fmul_rn(4.f, mean), __fdiv_rn(a.s3, nz)));
  m4 = __fadd_rn(m4, __fmul_rn(__fmul_rn(6.f, mm), e2));
  m4 = __fsub_rn(m4, __fmul_rn(__fmul_rn(3.f, mm), mm));
  const float m22 = __fmul_rn(m2, m2);
  const float kurt = __fdiv_rn(m4, m22 < 1e-30f ? 1e-30f : m22);
  const float rise = __fdiv_rn(
      __fsub_rn(static_cast<float>(at), static_cast<float>(s0)), fs);
  *dst = make_float4(sel, peak, kurt, rise);
}

template <typename T>
cudaError_t launch(const T* x, const float* scales, const int* counts,
                   const float* rows, float* out, int n_rec, int n_samples,
                   int hop, int window, int capacity, float fs, float gain,
                   cudaStream_t stream) {
  impulsive_kernel<T><<<dim3(capacity, n_rec), kThreads, 0, stream>>>(
      x, scales, counts, rows, out, n_samples, hop, window, capacity, fs,
      gain);
  return cudaGetLastError();
}

}  // namespace

// x: (n_rec, n_samples) float32 (int16 == 0; scales NULL) or int16 PCM
// (int16 != 0; scales (n_rec,) float32); counts (n_rec,) int32; rows
// and out (n_rec, capacity, 4) float32.  Launches on ``stream``; no
// synchronisation, no allocation.
extern "C" int depam_impulsive_metrics(const void* x, int int16,
                                       const float* scales,
                                       const int* counts, const float* rows,
                                       float* out, int n_rec, int n_samples,
                                       int hop, int window, int capacity,
                                       float fs, float gain, void* stream) {
  if (n_rec <= 0) return 0;
  if (capacity < 1 || capacity > 65535 || n_rec > 65535 || n_samples < 0
      || hop < 1 || window < 1 || (int16 && scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = int16
      ? launch(static_cast<const int16_t*>(x), scales, counts, rows, out,
               n_rec, n_samples, hop, window, capacity, fs, gain, s)
      : launch(static_cast<const float*>(x), nullptr, counts, rows, out,
               n_rec, n_samples, hop, window, capacity, fs, gain, s);
  return static_cast<int>(err);
}
