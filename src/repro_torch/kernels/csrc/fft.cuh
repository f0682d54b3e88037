// The FFT core shared by K1 (framepsd.cu, welch_psd) and K2 (ct_rfft.cu,
// ct_frame_psd): one copy, so the two kernels cannot drift apart.
//
// A real frame of N = 2M samples is packed into M complex points,
// z[q] = x[2q] + i x[2q+1], and transformed by an M-point complex FFT.
// The split then gives the one-sided spectrum:
//   X[k] = Z[k] A[k] + conj(Z[M-k]) B[k],   k = 0..M,  Z[M] = Z[0],
//   A[k] = (1 - i W_N^k) / 2,  B[k] = (1 + i W_N^k) / 2.
//
// The complex FFT is a sequence of Stockham passes of radix 8 or 4 (the
// plan, built in Python: kernels/fftplan.py).  A pass of radix R over
// sub-transforms of length ns reads point j + r M/R, multiplies it by
// the twiddle W_{ns R}^(r (j mod ns)), runs an R-point DFT in registers
// and writes point (j - j mod ns) R + j mod ns + r ns.  The output
// comes out in natural order, with no bit reversal.
//
// Geometry: a group of L lanes transforms one frame; each lane holds
// 8 points in every pass (one radix-8 or two radix-4 butterflies), so
// M = 8 L.  Below 32 lanes, G = 32 / L groups share a warp and their
// buffers are interleaved point by point (point i of group g at i G + g),
// so that the G groups fall in different banks.  A pass reads all its
// points into registers, the group syncs, and it writes them back into
// the same buffer: one buffer of M complex (re and im as two float
// arrays) per frame in flight.
//
// Banks: inside a row of W = min(L, 32) points, each layout is rotated by
// rot x row, where rot depends on the ns of the pass that wrote it (1
// after ns = 1, 4 after ns = 8 when ns < W, else 0).  That makes every
// pass's reads and writes, and the split's reads, free of bank
// conflicts for every M from 64 to 4096 (checked by enumerating the
// addresses of each warp's accesses).
//
// Tables (kernels/fftplan.py): the twiddles of pass p as (R-1, ns)
// float2, passes in order; the split factors as (M+1) float4 (A re,
// A im, B re, B im).  Both are computed in float64 on the host and
// rounded once to f32; nothing here calls sin or cos.
#pragma once

#include <cuda_runtime.h>

namespace depam {
namespace fft {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-place DFT of 4 or 8 points, natural order: v[k] = sum_n v[n] W_R^(nk).
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = mul_mi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  dft4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  constexpr float kH = 0.70710678118654752f;  // sqrt(1/2)
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  // o_k *= W_8^k
  o1 = make_float2((o1.x + o1.y) * kH, (o1.y - o1.x) * kH);
  o2 = mul_mi(o2);
  o3 = make_float2((o3.y - o3.x) * kH, -(o3.x + o3.y) * kH);
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// Rotation of the layout written by a pass over sub-transforms of ns.
template <int W>
__device__ __forceinline__ int rot_after(int ns) {
  return ns >= W ? 0 : (ns == 1 ? 1 : 4);
}

// One group's view of its buffer.  L lanes, M = 8 L points; sync() is
// the group's barrier (the warp below 32 lanes, else the block, which
// then holds exactly one group).
template <int L>
struct Group {
  static constexpr int M = 8 * L;
  static constexpr int G = L < 32 ? 32 / L : 1;
  static constexpr int W = L < 32 ? L : 32;
  static constexpr int kFloats = 2 * M * G;  // one buffer, G groups

  float* re;  // the buffer of this group's warp (L < 32) or block
  int g;      // group within the warp
  int l;      // lane within the group

  __device__ static void sync() {
    if constexpr (L <= 32)
      __syncwarp();
    else
      __syncthreads();
  }

  __device__ int at(int i, int rot) const {
    const int s = (i & ~(W - 1)) | ((i + rot * (i / W)) & (W - 1));
    return s * G + g;
  }

  __device__ float2 get(int i, int rot) const {
    const int a = at(i, rot);
    return make_float2(re[a], re[M * G + a]);
  }

  __device__ void put(int i, int rot, float2 v) const {
    const int a = at(i, rot);
    re[a] = v.x;
    re[M * G + a] = v.y;
  }

  // One Stockham pass of radix R.  load(i) gives input point i; the
  // output goes to the buffer in the layout rot_after(ns).
  template <int R, typename Load>
  __device__ void pass(Load load, int ns, const float2* tw) const {
    constexpr int B = 8 / R;
    constexpr int Q = M / R;
    float2 v[B][R];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) v[b][r] = load(l + b * L + r * Q);
    sync();
    const int rot = rot_after<W>(ns);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int j = l + b * L;
      const int k = j & (ns - 1);
      if (ns > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r)
          v[b][r] = cmul(v[b][r], tw[(r - 1) * ns + k]);
      }
      dft<R>(v[b]);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) put(base + r * ns, rot, v[b][r]);
    }
    sync();
  }

  // The M-point complex FFT of the points first(i) gives, by the plan
  // `radices` (4 bits a pass, the first pass in the low bits; the first
  // radix is 8).  The result is left in the buffer in natural order;
  // the return value is its layout's rotation.
  template <typename Load>
  __device__ int run(Load first, unsigned radices, int n_pass,
                     const float2* tw) const {
    pass<8>(first, 1, tw);
    tw += 7;
    int ns = 8;
    int rot = rot_after<W>(1);
    for (int p = 1; p < n_pass; ++p) {
      const int R = (radices >> (4 * p)) & 15;
      const int rin = rot;
      auto from_buf = [&](int i) { return get(i, rin); };
      if (R == 8)
        pass<8>(from_buf, ns, tw);
      else
        pass<4>(from_buf, ns, tw);
      rot = rot_after<W>(ns);
      tw += (R - 1) * ns;
      ns *= R;
    }
    return rot;
  }

  // |X[k]|^2 for this lane's bins k = l + L t (t < 9, k <= M; 0 past M).
  __device__ void power(int rot, const float4* split, float (&pw)[9]) const {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int k = l + L * t;
      pw[t] = 0.f;
      if (k <= M) {
        const float2 z = get(k & (M - 1), rot);
        const float2 c = get((M - k) & (M - 1), rot);
        const float4 s = split[k];
        // z A + conj(c) B
        const float xr = z.x * s.x - z.y * s.y + c.x * s.z + c.y * s.w;
        const float xi = z.x * s.y + z.y * s.x + c.x * s.w - c.y * s.z;
        pw[t] = xr * xr + xi * xi;
      }
    }
  }
};

// Twiddle count of a plan: sum over passes of (R - 1) ns.
__host__ __device__ inline int twiddle_count(unsigned radices, int n_pass) {
  int ns = 1, n = 0;
  for (int p = 0; p < n_pass; ++p) {
    const int R = (radices >> (4 * p)) & 15;
    n += (R - 1) * ns;
    ns *= R;
  }
  return n;
}

// A plan fits M when it is n_pass radices of 4 or 8, the first 8, whose
// product is M, and its table has twiddle_count entries.
inline bool plan_fits(unsigned radices, int n_pass, int n_twiddles, int m) {
  if (n_pass < 1 || n_pass > 7 || (radices & 15) != 8) return false;
  long long prod = 1;
  for (int p = 0; p < n_pass; ++p) {
    const int R = (radices >> (4 * p)) & 15;
    if (R != 4 && R != 8) return false;
    prod *= R;
  }
  if ((radices >> (4 * n_pass)) != 0) return false;
  return prod == m && twiddle_count(radices, n_pass) == n_twiddles;
}

}  // namespace fft
}  // namespace depam
