// K6: Schmitt-trigger event detection and compaction over a frame-SPL
// trace: (B, F) f32 SPL + int32 peak bins -> TRUE counts (B,) int32 and
// rows (B, capacity, 4) f32 = (onset, n_frames, peak_bin, peak_db).
//
// Replaces the TPU kernel src/repro/kernels/events.py:137
// (detect_events, pallas_call at :168, scan body scan_events :47-108).
//
// Semantics, exactly the reference's scan (no rounding anywhere, so the
// kernel equals the plain version and the reference bit for bit):
//  * close: an open event closes at the first frame with s < lo, where
//    lo = f32(threshold) - f32(hysteresis) rounded once in f32
//    (events.py:61-62); its duration excludes that frame; it is kept
//    when the duration is >= min_len;
//  * peak: strict >, so ties keep the first frame and NaN never becomes
//    the peak;
//  * open: a frame with s >= threshold opens an event when none is open
//    after the close test (the step below runs the reference's three
//    tests in its order, so a negative hysteresis, where a closing frame
//    can re-open, needs no special case);
//  * an event open at the record end closes at n_frames (the reference's
//    post-loop emit, events.py:104-107).  This kernel scans exactly
//    n_frames frames (the staging's zero fill past the record end is
//    never scanned), so the reference's -inf frame padding has no
//    counterpart here;
//  * counts are never capped (count > capacity flags overflow); a row is
//    written only while its index is < capacity; unused slots are zero.
//
// Bound on this card: bytes (set 1: 8 x 15 359 x 8 B = 0.98 MB read,
// 2 KB written, 0.3 us at 3.35 TB/s), plus a dependent depth of about
// 3 x kTile frame steps and log2(threads) scan steps a chunk.  The
// frame-by-frame chain of the reference's scan is not inherent: the
// trigger has two control states, and what a stretch of frames does to
// it can be summarised and the summaries composed associatively.
//
// Design: one block per record, up to kMaxThreads threads (whole warps,
// as few as the record needs), looping over the record in chunks of
// threads x kTile frames.  Each chunk is staged in shared memory by
// cp.async, coalesced, into one of two buffers, so that the next
// chunk's copy is in flight while this one is scanned.  Thread t owns
// the kTile consecutive frames t*kTile... of the chunk and reads them
// into registers once; kTile is odd, so the threads of a warp read 32
// distinct banks.
//  1. Tile summary: each thread scans its tile twice in one loop, once
//     entering closed (exit state, qualifying events closed) and once
//     entering open with an unknown start and peak (the frame where the
//     carried event closes, if it does; its local peak over the frames
//     before that, by strict > from -inf; the exit state and qualifying
//     events after the close).
//  2. Block scan: the summaries compose associatively (compose() below:
//     peaks combine as "the incoming peak unless the later one is
//     strictly greater", the reference's sequential strict >); an
//     exclusive scan (shuffles within warps, as many levels as the
//     chunk's tiles need, then over the warps' totals) applied to the
//     state carried in from the previous chunk gives every tile its
//     true entry state and the record-level index of its first event,
//     and settles the carried events' min_len tests.
//  3. Emit: each thread re-runs the reference's step over its tile from
//     its true entry state and writes each qualifying event's row.  The
//     exit state and count of the thread that owns the chunk's last
//     frame carry into the next chunk.
// After the last chunk an open event closes at n_frames, and the slots
// past the kept events are zeroed.  No scratch in device memory: the
// summaries live in registers and shared memory.  A block per record
// leaves most SMs idle at 8 records (set 1: 8 of 132); spreading a
// record over blocks would need a chained scan across them.  (Measured
// on an H100, scripts/torch_kernel_time.py: tiles of 7 or 31 frames, or
// blocks of 256 or 1024 threads, were slower at set 1; tiles of 7 were
// faster at set 2's 80 frames.)
#include <cuda_pipeline.h>

#include "depam.cuh"

namespace {

constexpr int kTile = 15;         // frames a thread owns in a chunk (odd)
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

struct Trigger {
  float thr, lo;
  int min_len;
};

// The trigger's state at a frame boundary.  start, pk and bin mean
// something only while in is true.
struct State {
  bool in;
  int start;
  float pk;
  int bin;
};

// What a stretch of frames does to the trigger, for either entry state.
struct Summary {
  State c;          // exit state when entered closed
  int cn;           // qualifying events closed, entered closed
  bool closes;      // entered open: the carried event closes here
  int close_at;     //   at this frame (valid when closes)
  float lp;         //   local peak over the frames before the close
  int lpb;          //   (strict > from -inf; -inf when there is none)
  State o;          //   exit state when entered open (valid when closes)
  int on;           //   qualifying events after the close
};

__device__ __forceinline__ State closed_state() {
  return State{false, 0, neg_inf(), 0};
}

__device__ __forceinline__ Summary identity() {
  return Summary{closed_state(), 0, false, 0, neg_inf(), 0, closed_state(),
                 0};
}

// The later peak wins only when strictly greater.
__device__ __forceinline__ void take_peak(float& v, int& b, float v2,
                                          int b2) {
  if (v2 > v) {
    v = v2;
    b = b2;
  }
}

// One frame of the reference's scan body (events.py:69-86); returns 1
// when a qualifying event closes at frame f.
__device__ __forceinline__ int step(State& st, float s, int pb, int f,
                                    const Trigger& tg) {
  int q = 0;
  if (st.in && s < tg.lo) {
    q = f - st.start >= tg.min_len;
    st.in = false;
  }
  if (st.in) take_peak(st.pk, st.bin, s, pb);
  if (!st.in && s >= tg.thr) st = State{true, f, s, pb};
  return q;
}

// The state after the stretch m, entered in the concrete state e;
// adds the qualifying events closed in m to count.
__device__ __forceinline__ State apply(const Summary& m, State e,
                                       int& count, const Trigger& tg) {
  if (!e.in) {
    count += m.cn;
    return m.c;
  }
  if (!m.closes) {
    take_peak(e.pk, e.bin, m.lp, m.lpb);
    return e;
  }
  count += (m.close_at - e.start >= tg.min_len) + m.on;
  return m.o;
}

// The stretch a followed by the stretch b.
__device__ __forceinline__ Summary compose(const Summary& a,
                                           const Summary& b,
                                           const Trigger& tg) {
  Summary r;
  r.cn = a.cn;
  r.c = apply(b, a.c, r.cn, tg);
  r.lp = a.lp;
  r.lpb = a.lpb;
  if (a.closes) {
    r.closes = true;
    r.close_at = a.close_at;
    r.on = a.on;
    r.o = apply(b, a.o, r.on, tg);
  } else {
    take_peak(r.lp, r.lpb, b.lp, b.lpb);
    r.closes = b.closes;
    r.close_at = b.close_at;
    r.o = b.o;
    r.on = b.on;
  }
  return r;
}

__device__ __forceinline__ Summary shfl_up(const Summary& v, int d) {
  const int flags = v.c.in | v.closes << 1 | v.o.in << 2;
  const int f = __shfl_up_sync(kFull, flags, d);
  Summary r;
  r.c = State{(f & 1) != 0, __shfl_up_sync(kFull, v.c.start, d),
              __shfl_up_sync(kFull, v.c.pk, d),
              __shfl_up_sync(kFull, v.c.bin, d)};
  r.cn = __shfl_up_sync(kFull, v.cn, d);
  r.closes = (f & 2) != 0;
  r.close_at = __shfl_up_sync(kFull, v.close_at, d);
  r.lp = __shfl_up_sync(kFull, v.lp, d);
  r.lpb = __shfl_up_sync(kFull, v.lpb, d);
  r.o = State{(f & 4) != 0, __shfl_up_sync(kFull, v.o.start, d),
              __shfl_up_sync(kFull, v.o.pk, d),
              __shfl_up_sync(kFull, v.o.bin, d)};
  r.on = __shfl_up_sync(kFull, v.on, d);
  return r;
}

// Inclusive scan of the summaries over a warp's lanes, as far as the
// first n lanes need (n is the same across the block).
__device__ __forceinline__ Summary warp_scan(Summary m, int lane, int n,
                                             const Trigger& tg) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= n) break;
    const Summary up = shfl_up(m, d);
    if (lane >= d) m = compose(up, m, tg);
  }
  return m;
}

__device__ __forceinline__ void write_row(float* rows, int idx, int start,
                                          int dur, int bin, float pk) {
  reinterpret_cast<float4*>(rows)[idx] = make_float4(
      static_cast<float>(start), static_cast<float>(dur),
      static_cast<float>(bin), pk);
}

__global__ void __launch_bounds__(kMaxThreads)
detect_events_kernel(const float* __restrict__ spl,
                     const int* __restrict__ peak_bin,
                     int* __restrict__ counts, float* __restrict__ rows,
                     int n_frames, float thr, float hyst, int min_len,
                     int capacity) {
  // two buffers, each a chunk of SPL then a chunk of peak bins
  extern __shared__ float smem[];
  __shared__ Summary warp_sum[kMaxWarps];
  __shared__ State carry_state;
  __shared__ int carry_count;

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int n_warps = blockDim.x / 32;
  const int chunk = blockDim.x * kTile;

  const long long r = blockIdx.x;
  const float* sr = spl + r * n_frames;
  const int* br = peak_bin + r * n_frames;
  float* out = rows + r * capacity * 4;
  const Trigger tg{thr, __fsub_rn(thr, hyst), min_len};

  // Copies frames c0 + k * blockDim + t (coalesced) into buffer buf,
  // asynchronously, as one commit group; past the record end nothing
  // is read.
  const auto stage = [&](int c0, int buf) {
    float* s_spl = smem + 2 * buf * chunk;
    int* s_pb = reinterpret_cast<int*>(s_spl + chunk);
    if (c0 < n_frames) {
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const int g = c0 + k * blockDim.x + t;
        const int i = k * blockDim.x + t;
        const size_t gone = g < n_frames ? 0 : 4;  // bytes zero-filled
        __pipeline_memcpy_async(s_spl + i, sr + (gone ? 0 : g), 4, gone);
        __pipeline_memcpy_async(s_pb + i, br + (gone ? 0 : g), 4, gone);
      }
    }
    __pipeline_commit();
  };

  if (t == 0) {
    carry_state = closed_state();
    carry_count = 0;
  }
  stage(0, 0);
  int buf = 0;
  for (int c0 = 0; c0 < n_frames; c0 += chunk, buf ^= 1) {
    stage(c0 + chunk, buf ^ 1);   // in flight while this chunk is scanned
    __pipeline_wait_prior(1);
    __syncthreads();

    const int n_c = min(chunk, n_frames - c0);
    const int tiles = (n_c + kTile - 1) / kTile;
    const int len = max(0, min(kTile, n_c - t * kTile));
    const int f0 = c0 + t * kTile;
    float s[kTile];
    int pb[kTile];
    {
      const float* s_spl = smem + 2 * buf * chunk + t * kTile;
      const int* s_pb = reinterpret_cast<const int*>(s_spl + chunk);
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        s[k] = s_spl[k];
        pb[k] = s_pb[k];
      }
    }

    // 1. this tile's summary, both entry states in one pass
    Summary m = identity();
    bool carried = true;
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (k < len) {
        const int f = f0 + k;
        m.cn += step(m.c, s[k], pb[k], f, tg);
        if (carried) {
          if (s[k] < tg.lo) {
            carried = false;
            m.close_at = f;
            m.on += step(m.o, s[k], pb[k], f, tg);  // m.o is closed
          } else {
            take_peak(m.lp, m.lpb, s[k], pb[k]);
          }
        } else {
          m.on += step(m.o, s[k], pb[k], f, tg);
        }
      }
    }
    m.closes = !carried;

    // 2. exclusive block scan of the summaries over the chunk's tiles
    const Summary incl = warp_scan(m, lane, tiles, tg);
    Summary excl = shfl_up(incl, 1);
    if (lane == 0) excl = identity();
    if (n_warps > 1) {
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        Summary w = lane < n_warps ? warp_sum[lane] : identity();
        w = warp_scan(w, lane, n_warps, tg);
        if (lane < n_warps) warp_sum[lane] = w;
      }
      __syncthreads();
      if (warp > 0) excl = compose(warp_sum[warp - 1], excl, tg);
    }
    int count = carry_count;
    State st = apply(excl, carry_state, count, tg);

    // 3. emit this tile's events from its true entry state
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (k < len) {
        const int f = f0 + k;
        if (st.in && s[k] < tg.lo) {
          const int dur = f - st.start;
          if (dur >= tg.min_len) {
            if (count < capacity)
              write_row(out, count, st.start, dur, st.bin, st.pk);
            ++count;
          }
          st.in = false;
        }
        if (st.in) take_peak(st.pk, st.bin, s[k], pb[k]);
        if (!st.in && s[k] >= tg.thr) st = State{true, f, s[k], pb[k]};
      }
    }
    __syncthreads();   // every thread has read the carry
    if (t == tiles - 1) {
      carry_state = st;
      carry_count = count;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // the record end closes an open event; then zero the unused slots
  if (t == 0) {
    State st = carry_state;
    int count = carry_count;
    const int dur = n_frames - st.start;
    if (st.in && dur >= min_len) {
      if (count < capacity) write_row(out, count, st.start, dur, st.bin,
                                      st.pk);
      ++count;
    }
    counts[r] = count;
    carry_count = count;
  }
  __syncthreads();
  for (int i = 4 * min(carry_count, capacity) + t; i < 4 * capacity;
       i += blockDim.x)
    out[i] = 0.f;
}

}  // namespace

// K6's launch plan on the current device: raises the kernel's dynamic
// shared-memory limit (two buffers of kMaxThreads x kTile frames are
// 120 KB, over the 48 KB default) and reports the layout: the frames a
// thread owns and the most frames a block stages at once.  Called once
// per device, before the first launch.
extern "C" int depam_detect_events_plan(int* tile, int* chunk) {
  *tile = kTile;
  *chunk = kMaxThreads * kTile;
  return static_cast<int>(depam::allow_smem(
      detect_events_kernel, 4 * sizeof(float) * kMaxThreads * kTile));
}

extern "C" int depam_detect_events(const float* spl, const int* peak_bin,
                                   int* counts, float* rows, int n_rec,
                                   int n_frames, float thr, float hyst,
                                   int min_len, int capacity, void* stream) {
  if (n_rec <= 0) return 0;
  if (capacity < 1 || n_frames < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // whole warps, as few as one chunk of the record needs, at most
  // kMaxThreads
  const int tiles = (n_frames + kTile - 1) / kTile;
  const int threads = min(kMaxThreads, max(32, (tiles + 31) / 32 * 32));
  const size_t smem = 4 * sizeof(float) * threads * kTile;
  detect_events_kernel<<<n_rec, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      spl, peak_bin, counts, rows, n_frames, thr, hyst, min_len, capacity);
  return static_cast<int>(cudaGetLastError());
}
