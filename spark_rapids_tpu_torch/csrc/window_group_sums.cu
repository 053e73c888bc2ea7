// Per-group f32 sums over rows sorted by group (the banded lane of the
// aggregate's merge).
//
// Replaces: spark_rapids_tpu/ops/grouped_window.py window_group_sums (body
// _window_block_kernel plus its slab-merge matmul), which builds a 2R-wide
// one-hot window per 256-row block on the TPU's matrix unit.
//
// What bounds it on an H100: bytes.  Each row reads one int32 group id and
// M f32 measures once, and each output cell is written once; the floor is
// (4 + 4 M) B/row + 4 M B/group over 3.35 TB/s.
//
// Design: one launch, every output cell written once with a plain store,
// and no atomics on the output.  gid is non-decreasing, so the rows of a
// group are one contiguous run.
//  - A block owns a tile of 1,024 rows (256 threads x 4 rows, int4 and
//    float4 loads).  Each thread scans its 4 rows, then a warp reduces its
//    threads' trailing runs with a segmented shuffle scan (a lane adds the
//    lane `off` below it only when both end on the same id, which for
//    sorted ids means the whole span between them does), and the warps'
//    carries chain through shared memory in warp order.  Where each row
//    that ends a run sends its sum is worked out once per tile, not once
//    per measure.
//  - A run that starts and ends inside the tile is staged in shared
//    memory, with the tile's absent ids as 0, and the tile's span of
//    output rows is stored as one contiguous block (a span too wide to
//    stage is stored cell by cell).  A run that goes on into the next
//    tile leaves its in-tile sum as the tile's tail partial and raises
//    the tile's flag.  The tile where a
//    run that came in from earlier tiles ends waits for the flags of the
//    tiles it crosses (they have lower block indices, so they are running
//    or done, as in a single-pass decoupled look-back scan) and stores
//    their tail partials, summed in a fixed order, plus its own head.
//  - Ids absent from the input are written as 0 by the same launch: the
//    ids below the first and above the last by the whole grid, the gaps
//    between successive ids by the tile that holds the larger one.
// On an H100 at 2^22 rows over 10^6 groups and 17 measures this runs at
// about half its bytes bound (PERF.md); every group id in its own row is
// far slower, since such a tile's span is too wide to stage.
// Each sum is taken in an order fixed by the tile layout, so every call
// gives the same bits.  Groups at or past out_cap, and negative ids (an
// empty batch numbers its rows -1), are dropped.  Flags carry a new epoch
// per launch, so they are never cleared; two launches may not share a
// flag array at the same time.
//
// Exactness the engine relies on (exec/aggregate.py _banded_aggregate):
// the first-row-index limb measures have exactly one non-zero per group,
// and integral sums stay below 2^23 under the deferred certificate.  Both
// hold for any order of f32 additions, since adding zeros is exact and
// integers below 2^24 add exactly.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                      // rows per thread, 4 a load
constexpr int kTileRows = kThreads * kRows;   // rows per block
constexpr int kChunk = 4;                     // measures per register pass
// blocks per SM the register budget is cut for: the kernel is bound by
// the latency of its few loads a thread, so residency pays more than the
// registers a wider measure chunk would hold
constexpr int kMinBlocks = 4;
constexpr int kMaxMeasures = 64;
constexpr int kGapSlots = 64;                 // large gaps a block shares
constexpr long long kSmallGap = 64;           // cells a thread zeroes alone
constexpr int kStageFloats = 8192;            // output cells a tile stages
constexpr unsigned kFull = 0xffffffffu;

struct Measures {
  const float* p[kMaxMeasures];
};

__device__ __forceinline__ void zero_ids(float* out, int out_stride,
                                         int n_measures, long long lo,
                                         long long hi, long long first,
                                         long long step) {
  const long long n = (hi - lo) * n_measures;
  if (out_stride == n_measures) {  // the ids' rows are one contiguous span
    float* span = out + lo * out_stride;
    for (long long i = first; i < n; i += step) span[i] = 0.0f;
    return;
  }
  for (long long i = first; i < n; i += step)
    out[(lo + i / n_measures) * out_stride + i % n_measures] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_group_sums_kernel(const int* __restrict__ gid, Measures vals,
                         int n_measures, int capacity, int out_cap,
                         float* __restrict__ out, int out_stride,
                         float* __restrict__ tail, int* __restrict__ flags,
                         int epoch, int vec) {
  __shared__ float s_wsum[kMaxMeasures][kWarps];
  __shared__ int s_wkey[kWarps];
  __shared__ int s_gap_lo[kGapSlots], s_gap_hi[kGapSlots];
  __shared__ float s_head[kMaxMeasures];
  __shared__ float s_stage[kStageFloats];
  __shared__ int s_ngaps;
  __shared__ int s_start;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const long long t0 = (long long)tile * kTileRows;
  const long long t_end = min(t0 + kTileRows, (long long)capacity);
  const long long r0 = t0 + (long long)threadIdx.x * kRows;
  if (threadIdx.x == 0) s_ngaps = 0;

  // ids below the first and above the last, spread over the whole grid
  {
    const long long g_first = __ldg(gid), g_final = __ldg(gid + capacity - 1);
    const long long lead = max(0LL, min(g_first, (long long)out_cap));
    const long long trail = max(0LL, min(g_final + 1, (long long)out_cap));
    const long long me = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long all = (long long)gridDim.x * blockDim.x;
    zero_ids(out, out_stride, n_measures, 0, lead, me, all);
    zero_ids(out, out_stride, n_measures, trail, out_cap, me, all);
  }

  // this thread's rows; rows past capacity take INT_MAX (past any kept id)
  int g[kRows];
  const bool quad = vec && r0 + kRows <= capacity;
  if (quad) {
#pragma unroll
    for (int h = 0; h < kRows; h += 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(gid + r0 + h));
      g[h] = q.x; g[h + 1] = q.y; g[h + 2] = q.z; g[h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      g[j] = r0 + j < capacity ? __ldg(gid + r0 + j) : INT_MAX;
  }
  const int g_before = (r0 > 0 && r0 <= capacity) ? __ldg(gid + r0 - 1)
                                                  : INT_MIN;
  const int g_after = r0 + kRows < capacity ? __ldg(gid + r0 + kRows)
                                            : INT_MAX;
  const int tile_first = __ldg(gid + t0);
  const int tile_last = __ldg(gid + t_end - 1);
  const bool cont_in = t0 > 0 && __ldg(gid + t0 - 1) == tile_first;
  const bool cont_out = t_end < capacity && __ldg(gid + t_end) == tile_last;
  // the output rows this tile owns: the ids after the previous tile's last
  // up to its own last, less a last run that goes on into the next tile.
  // Where they fit in shared memory they are staged (absent ids as 0)
  // and stored as one contiguous span.
  const long long own_lo = max(
      t0 > 0 ? (long long)__ldg(gid + t0 - 1) + 1 : (long long)tile_first,
      0LL);
  const long long own_hi = min((long long)tile_last + (cont_out ? 0 : 1),
                               (long long)out_cap);
  const long long own_cells = max(own_hi - own_lo, 0LL) * n_measures;
  const bool staged = own_cells <= kStageFloats;
  if (staged)
    for (int i = threadIdx.x; i < own_cells; i += blockDim.x)
      s_stage[i] = 0.0f;
  __syncthreads();  // s_ngaps

  // gaps between successive ids, owned by the row holding the larger id
#pragma unroll
  for (int j = 0; j < kRows && !staged; ++j) {
    const long long row = r0 + j;
    const long long prev = j ? g[j - 1] : g_before;
    if (row <= 0 || row >= capacity || prev + 1 >= g[j]) continue;
    const long long lo = max(prev + 1, 0LL);
    const long long hi = min((long long)g[j], (long long)out_cap);
    if (lo >= hi) continue;
    if ((hi - lo) * n_measures <= kSmallGap) {
      zero_ids(out, out_stride, n_measures, lo, hi, 0, 1);
    } else {
      const int slot = atomicAdd(&s_ngaps, 1);
      if (slot < kGapSlots) {
        s_gap_lo[slot] = (int)lo;
        s_gap_hi[slot] = (int)hi;
      } else {
        zero_ids(out, out_stride, n_measures, lo, hi, 0, 1);
      }
    }
  }

  // where each row that ends a run sends the run's sum: the address of
  // measure 0 of its cell (null: no run ends there, or the id is
  // dropped).  carry_bits marks the rows of the thread's first run, which
  // add the sum of the rows before the thread.
  float* dst[kRows];
  unsigned carry_bits = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long row = r0 + j;
    const int next = j + 1 < kRows ? g[j + 1] : g_after;
    if (g[j] == g[0]) carry_bits |= 1u << j;
    dst[j] = nullptr;
    if (row >= t_end || (next == g[j] && row != t_end - 1)) continue;
    if (cont_out && row == t_end - 1)
      dst[j] = tail + (size_t)tile * n_measures;  // goes on into next tile
    else if (cont_in && g[j] == tile_first)
      dst[j] = s_head;                            // came in from before
    else if (g[j] >= 0 && g[j] < out_cap)
      dst[j] = staged ? s_stage + (g[j] - own_lo) * n_measures
                      : out + (size_t)g[j] * out_stride;
  }
  const int glast = g[kRows - 1];
  // same bit i: the lane (1 << i) below ends on this lane's last id
  unsigned same = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int off = 1 << i;
    const int ku = __shfl_up_sync(kFull, glast, off);
    if (lane >= off && ku == glast) same |= 1u << i;
  }
  const int key_up = __shfl_up_sync(kFull, glast, 1);
  if (lane == 31) s_wkey[warp] = glast;
  __syncthreads();
  // the run the previous warp ends on (id ck) takes in warps w0 .. warp-1
  const int ck = warp > 0 ? s_wkey[warp - 1] : INT_MIN;
  int w0 = warp > 0 ? warp - 1 : 0;
  while (w0 > 0 && s_wkey[w0 - 1] == ck) --w0;

  for (int m0 = 0; m0 < n_measures; m0 += kChunk) {
    float s[kChunk][kRows];
    float x[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int m = m0 + c;
      float v[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) v[j] = 0.0f;
      if (m < n_measures) {
        if (quad) {
#pragma unroll
          for (int h = 0; h < kRows; h += 4) {
            const float4 q =
                __ldg(reinterpret_cast<const float4*>(vals.p[m] + r0 + h));
            v[h] = q.x; v[h + 1] = q.y; v[h + 2] = q.z; v[h + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (r0 + j < capacity) v[j] = __ldg(vals.p[m] + r0 + j);
        }
      }
      // in-thread segmented inclusive scan
      s[c][0] = v[0];
#pragma unroll
      for (int j = 1; j < kRows; ++j)
        s[c][j] = (g[j] == g[j - 1] ? s[c][j - 1] : 0.0f) + v[j];
      // across the warp: the in-warp sum of the run this thread ends on
      float xx = s[c][kRows - 1];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float u = __shfl_up_sync(kFull, xx, 1 << i);
        if (same & (1u << i)) xx += u;
      }
      x[c] = xx;
      if (lane == 31 && m < n_measures) s_wsum[m][warp] = xx;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int m = m0 + c;
      if (m >= n_measures) break;
      // the in-tile sum of the run the previous warp ends on, in warp order
      float cv = 0.0f;
      for (int w = w0; w < warp; ++w) cv += s_wsum[m][w];
      const float xt = x[c] + (glast == ck ? cv : 0.0f);
      const float up = __shfl_up_sync(kFull, xt, 1);
      // the in-tile sum of rows before this thread with id g[0]
      const float carry = lane > 0 ? (key_up == g[0] ? up : 0.0f)
                                   : (ck == g[0] ? cv : 0.0f);
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (dst[j] != nullptr)
          dst[j][m] = s[c][j] + ((carry_bits >> j) & 1u ? carry : 0.0f);
    }
  }

  // publish the tail partial for the tiles after this one
  if (cont_out) __threadfence();
  __syncthreads();
  if (cont_out && threadIdx.x == 0) atomicExch(flags + tile, epoch);
  if (staged) {
    float* dst = out + own_lo * out_stride;
    if (out_stride == n_measures) {
      for (int i = threadIdx.x; i < own_cells; i += blockDim.x)
        dst[i] = s_stage[i];
    } else {
      for (int i = threadIdx.x; i < own_cells; i += blockDim.x)
        dst[(i / n_measures) * out_stride + i % n_measures] = s_stage[i];
    }
  }

  // large gaps, zeroed by the whole block
  const int ngaps = min(s_ngaps, kGapSlots);
  for (int i = 0; i < ngaps; ++i)
    zero_ids(out, out_stride, n_measures, s_gap_lo[i], s_gap_hi[i],
             threadIdx.x, blockDim.x);

  // a run that reaches in from earlier tiles and ends in this one: its
  // sum is the tail partials of the tiles it crosses, added in a fixed
  // order, plus this tile's head
  if (!cont_in || (tile_first == tile_last && cont_out)) return;
  if (warp == 0) {
    long long first = tile - 1;  // the tile the run starts in
    if (first > 0 && __ldg(gid + first * kTileRows - 1) == tile_first) {
      // it crosses three tiles or more: find its first row by a 32-way
      // search over [lo, hi], where gid[hi] holds the id
      long long lo = 0, hi = first * kTileRows - 1;
      while (hi - lo > 32) {
        const long long step = (hi - lo + 31) / 32;
        const long long p = lo + lane * step;
        const int k = __popc(__ballot_sync(
            kFull, p < hi && __ldg(gid + p) < tile_first));
        if (k == 0) {
          hi = lo;
        } else {
          const long long next_hi = lo + k * step;
          lo += (k - 1) * step + 1;
          hi = min(hi, next_hi);
        }
      }
      const long long p = lo + lane;
      lo += __popc(__ballot_sync(kFull,
                                 p < hi && __ldg(gid + p) < tile_first));
      first = lo / kTileRows;
    }
    if (lane == 0) s_start = (int)first;
  }
  __syncthreads();
  const int first = s_start;
  // blocks start in index order, so the tiles waited on are running or
  // done (the scheme of single-pass decoupled look-back scans)
  for (int w = first + threadIdx.x; w < tile; w += blockDim.x) {
    while (*(volatile const int*)(flags + w) != epoch) __nanosleep(32);
  }
  __threadfence();
  __syncthreads();
  if (tile_first < 0 || tile_first >= out_cap) return;
  for (int m = warp; m < n_measures; m += kWarps) {
    float acc = 0.0f;
    for (int w = first + lane; w < tile; w += 32)
      acc += __ldcg(tail + (size_t)w * n_measures + m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) out[(size_t)tile_first * out_stride + m] = acc + s_head[m];
  }
}

}  // namespace

extern "C" {

int window_group_sums_max_measures() { return kMaxMeasures; }

// gid int32 [capacity], non-decreasing; vals: host array of n_measures
// device pointers to f32 [capacity]; out: f32 [out_cap, out_stride] (need
// not be zeroed), of which columns [0, n_measures) are written; tail: f32
// scratch [ceil(capacity / tile_rows), n_measures]; flags: int32
// [ceil(capacity / tile_rows)] that holds no `epoch` yet (zeroed once, then
// a new epoch per launch); vec: gid and every measure are 16-byte
// aligned.
int window_group_sums_launch(const int* gid, const float* const* vals,
                             int n_measures, int capacity, int out_cap,
                             float* out, int out_stride, float* tail,
                             int* flags, int epoch, int vec, void* stream) {
  if (n_measures <= 0 || n_measures > kMaxMeasures || capacity <= 0 ||
      out_cap <= 0 || out_stride < n_measures || epoch == 0)
    return (int)cudaErrorInvalidValue;
  Measures m{};
  for (int i = 0; i < n_measures; ++i) m.p[i] = vals[i];
  const long long tiles = ((long long)capacity + kTileRows - 1) / kTileRows;
  window_group_sums_kernel<<<(unsigned)tiles, kThreads, 0,
                             (cudaStream_t)stream>>>(
      gid, m, n_measures, capacity, out_cap, out, out_stride, tail, flags,
      epoch, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
