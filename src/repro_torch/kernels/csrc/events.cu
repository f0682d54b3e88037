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
//  * peak: strict >, so ties keep the first frame;
//  * open: a frame with s >= threshold opens an event when none is open
//    (a closing frame has s < lo <= threshold, so it cannot re-open);
//  * an event open at the record end closes at n_frames (the reference's
//    post-loop emit, events.py:104-107).  This kernel scans exactly
//    n_frames frames and pads nothing, so the reference's -inf frame
//    padding has no counterpart here;
//  * counts are never capped (count > capacity flags overflow); a row is
//    written only while count < capacity; unused slots are zero.
//
// Bound on this card: bytes by the table (set 1: 8 x 15 359 x 8 B =
// 0.98 MB read, 2 KB written, 0.3 us at 3.35 TB/s), but the scan is a
// chain of F dependent steps per record, and that chain is what holds
// it: no design does better than one step per frame per record in
// sequence.
//
// Design: one warp per record, 4 records per block.  The warp loads the
// trace in coalesced 32-frame tiles into registers (the next tile's load
// is issued before the current tile is scanned, so its latency hides
// behind the scan), and every lane runs the same automaton over the
// tile's frames, taken one by one with __shfl_sync: the state stays
// uniform across the warp, nothing diverges, and lane 0 writes the rows.
#include "depam.cuh"

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void emit(float* rows, int capacity, int& count,
                                     bool qualify, int start, int dur,
                                     int pk_bin, float pk_db, int lane) {
  if (!qualify) return;
  if (lane == 0 && count < capacity) {
    float* row = rows + 4 * count;
    row[0] = static_cast<float>(start);
    row[1] = static_cast<float>(dur);
    row[2] = static_cast<float>(pk_bin);
    row[3] = pk_db;
  }
  ++count;
}

__global__ void __launch_bounds__(32 * kWarps)
detect_events_kernel(const float* __restrict__ spl,
                     const int* __restrict__ peak_bin,
                     int* __restrict__ counts, float* __restrict__ rows,
                     int n_rec, int n_frames, float thr, float hyst,
                     int min_len, int capacity) {
  const int lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps
                      + threadIdx.x / 32;
  if (r >= n_rec) return;
  const float* sr = spl + r * n_frames;
  const int* br = peak_bin + r * n_frames;
  float* out = rows + r * capacity * 4;
  for (int i = lane; i < capacity * 4; i += 32) out[i] = 0.f;
  __syncwarp();

  const float lo = __fsub_rn(thr, hyst);
  bool in_ev = false;
  int start = 0, pk_bin = 0, count = 0;
  float pk_db = -__int_as_float(0x7f800000);  // -inf

  float s_next = lane < n_frames ? sr[lane] : 0.f;
  int b_next = lane < n_frames ? br[lane] : 0;
  for (int t0 = 0; t0 < n_frames; t0 += 32) {
    const float s_tile = s_next;
    const int b_tile = b_next;
    const int g = t0 + 32 + lane;
    s_next = g < n_frames ? sr[g] : 0.f;
    b_next = g < n_frames ? br[g] : 0;
    const int n_tile = min(32, n_frames - t0);
    for (int i = 0; i < n_tile; ++i) {
      const float s = __shfl_sync(kFull, s_tile, i);
      const int pb = __shfl_sync(kFull, b_tile, i);
      const int f = t0 + i;
      const bool closing = in_ev && s < lo;
      emit(out, capacity, count, closing && f - start >= min_len, start,
           f - start, pk_bin, pk_db, lane);
      in_ev = in_ev && !closing;
      if (in_ev && s > pk_db) {
        pk_db = s;
        pk_bin = pb;
      }
      if (!in_ev && s >= thr) {
        in_ev = true;
        start = f;
        pk_db = s;
        pk_bin = pb;
      }
    }
  }
  emit(out, capacity, count, in_ev && n_frames - start >= min_len, start,
       n_frames - start, pk_bin, pk_db, lane);
  if (lane == 0) counts[r] = count;
}

}  // namespace

extern "C" int depam_detect_events(const float* spl, const int* peak_bin,
                                   int* counts, float* rows, int n_rec,
                                   int n_frames, float thr, float hyst,
                                   int min_len, int capacity, void* stream) {
  if (n_rec <= 0) return 0;
  if (capacity < 1 || n_frames < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rec + kWarps - 1) / kWarps;
  detect_events_kernel<<<blocks, 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      spl, peak_bin, counts, rows, n_rec, n_frames, thr, hyst, min_len,
      capacity);
  return static_cast<int>(cudaGetLastError());
}
