// Per-key sums and counts over dictionary key ids (the dictionary lane of
// every per-batch partial aggregate).
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py grouped_sum_pallas
// (body _grouped_sum_kernel), a one-hot matmul per block on the TPU's
// matrix unit.
//
// What bounds it on an H100: bytes.  Each row reads one int32 key and M
// f32 measures once; the group table is tiny next to the rows, so the
// floor is (4 + 4 M) B/row over 3.35 TB/s.  A one-hot product would do G
// multiply-adds per row and byte, which is why this kernel scatters
// instead.  What a scatter has to avoid is collisions: Q1 feeds 2^23 rows
// into about 7 live slots of 26, so adds that share a table serialise.
//
// Three tiers, chosen per launch by the caller (ops/kernels.py
// grouped_sum_plan) from the table size G (M + 1) cells:
//
//  A. lane-private tables, when 4 or more warps' worth fit in shared
//     memory (G (M + 1) 32 4 B a warp).  Lane l's copy of cell c is word
//     c 32 + l, which lies in bank l: updates are plain load/add/store,
//     with no atomics and no bank conflicts whatever the keys.  One block
//     per SM walks the rows grid-stride, 4 rows a thread a step (int4
//     keys, float4 measures), with the next step's loads issued before
//     this step's table updates.
//  B. one table per warp, when the lane-private form does not fit but
//     eight tables of G (M + 1) words do.  Lanes whose keys collide are
//     ranked with __match_any_sync and add in rank order, one round per
//     rank, so no two lanes of a round touch one cell and the updates
//     stay plain stores.  Where fewer than eight tables fit, warps share
//     tables and add with shared-memory atomics.
//  C. the table past shared memory (227 KB): adds straight into the
//     global [G, stride] table.  Four lanes cover one row's measures, so
//     the warp's reductions land on contiguous addresses, with Hopper's
//     vector reduction atomicAdd(float4*, float4): ceil(M / 4) + 1 atomic
//     instructions a row instead of M + 1 scattered ones.
//
// Tiers A and B flush each block's table with plain stores into a
// [blocks, G, M + 1] partial (counts as int32 bits in the last column),
// summing the lane or warp copies of a cell in a fixed order.  In tier A
// the last block to finish (a ticket counter it resets) adds the
// partials in block order into the float64 sums and int32 counts; for
// tier B the caller does the same in PyTorch.  Each f32 add sees a fixed
// sequence of rows, so A, and B with a table per warp, give the same
// bits on every call.  Tier C, and B with shared tables, add in
// an order that changes from run to run, as the library's index_add_
// does.
//
// Rows with row >= num_rows, or with a key outside [0, G), are dropped.
// Counts are int32 and exact.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxMeasures = 64;
constexpr int kChunk = 16;   // measures held in registers per pass
constexpr int kThreadsBC = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Measures {
  const float* p[kMaxMeasures];
};

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ long long live_rows(const int* num_rows,
                                               int capacity) {
  const int n = __ldg(num_rows);
  return n < 0 ? 0 : (n < capacity ? n : capacity);
}

// Loads quad q (rows 4q .. 4q + 3) of measures m0 .. m0 + mc - 1 and,
// with_keys, of the keys; a quad at or past nq gets keys -1 (dropped).
__device__ __forceinline__ void load_quad(const int* __restrict__ keys,
                                          const Measures& vals, long long q,
                                          long long nq, int m0, int mc,
                                          bool with_keys, int4& kk,
                                          float4* v) {
  if (with_keys)
    kk = q < nq ? __ldg(reinterpret_cast<const int4*>(keys) + q)
                : make_int4(-1, -1, -1, -1);
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (j < mc && q < nq)
      v[j] = __ldg(reinterpret_cast<const float4*>(vals.p[m0 + j]) + q);
}

// Adds a quad's rows to this lane's table (cell c at tab[c * 32]); the
// count goes with the first measure chunk.
__device__ __forceinline__ void add_quad(float* tab, int width,
                                         int n_measures, int n_groups,
                                         const int4& kk, const float4* v,
                                         int m0, int mc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = lane_of(kk, r);
    if ((unsigned)k >= (unsigned)n_groups) continue;
    float* cell = tab + (size_t)k * width * 32;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < mc) cell[(m0 + j) * 32] += lane_of(v[j], r);
    if (m0 == 0) reinterpret_cast<int*>(cell)[n_measures * 32] += 1;
  }
}

// ---------------------------------------------------------------------------
// Tier A: every lane owns a [G, M + 1] table; cell c of lane l is word
// c * 32 + l of its warp's slab.
__global__ void __launch_bounds__(256)
grouped_sum_lane_tables(const int* __restrict__ keys, Measures vals,
                        int n_measures, const int* __restrict__ num_rows,
                        int capacity, int n_groups, int vec,
                        float* __restrict__ partial,
                        double* __restrict__ sums, int sums_stride,
                        int* __restrict__ counts,
                        unsigned* __restrict__ ticket) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int width = n_measures + 1;
  const int cells = n_groups * width;
  for (int i = threadIdx.x; i < cells * 32 * warps; i += blockDim.x)
    smem[i] = 0.0f;
  __syncthreads();
  float* tab = smem + (size_t)warp * cells * 32 + lane;
  const long long nrows = live_rows(num_rows, capacity);
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  const long long nq = vec ? nrows / 4 : 0;
  if (vec && n_measures <= kChunk) {
    // one quad a thread a step, with the next step's loads in flight
    // while this step's rows update the table
    int4 kk[2];
    float4 v[2][kChunk];
    load_quad(keys, vals, tid, nq, 0, n_measures, true, kk[0], v[0]);
    for (long long q = tid; q < nq; q += 2 * nthreads) {
      load_quad(keys, vals, q + nthreads, nq, 0, n_measures, true, kk[1],
                v[1]);
      add_quad(tab, width, n_measures, n_groups, kk[0], v[0], 0, n_measures);
      load_quad(keys, vals, q + 2 * nthreads, nq, 0, n_measures, true, kk[0],
                v[0]);
      add_quad(tab, width, n_measures, n_groups, kk[1], v[1], 0, n_measures);
    }
    done = nq * 4;
  } else if (vec) {
    for (long long q = tid; q < nq; q += nthreads) {
      int4 kk;
      float4 v[kChunk];
      load_quad(keys, vals, q, nq, 0, 0, true, kk, v);
      for (int m0 = 0; m0 < n_measures; m0 += kChunk) {
        const int mc = min(kChunk, n_measures - m0);
        load_quad(keys, vals, q, nq, m0, mc, false, kk, v);
        add_quad(tab, width, n_measures, n_groups, kk, v, m0, mc);
      }
    }
    done = nq * 4;
  }
  // the rows past the last full quad, or every row when the columns are
  // not 16-byte aligned
  for (long long row = done + tid; row < nrows; row += nthreads) {
    const int k = __ldg(keys + row);
    if ((unsigned)k >= (unsigned)n_groups) continue;
    float* cell = tab + (size_t)k * width * 32;
    for (int m = 0; m < n_measures; ++m)
      cell[m * 32] += __ldg(vals.p[m] + row);
    reinterpret_cast<int*>(cell)[n_measures * 32] += 1;
  }
  __syncthreads();
  // flush: warp w sums cells w, w + warps, ...: the warp copies in warp
  // order, then the 32 lane copies by a fixed butterfly
  const int cells4 = (cells + 3) & ~3;  // partial rows padded to float4
  float* out = partial + (size_t)blockIdx.x * cells4;
  const int* ismem = reinterpret_cast<const int*>(smem);
  for (int c = warp; c < cells; c += warps) {
    if (c % width == n_measures) {
      int s = 0;
      for (int w = 0; w < warps; ++w)
        s += ismem[((size_t)w * cells + c) * 32 + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) reinterpret_cast<int*>(out)[c] = s;
    } else {
      float s = 0.0f;
      for (int w = 0; w < warps; ++w)
        s += smem[((size_t)w * cells + c) * 32 + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) out[c] = s;
    }
  }
  // the last block to finish adds every block's partial in block order:
  // float64 sums, exact counts; then it resets the ticket
  // (the table is flushed, so its first word can carry the verdict)
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem);
  if (threadIdx.x == 0) *last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // thread t takes cells 4t .. 4t + 3 (a tier-A table has at most 454
  // cells, so one pass of >= 128 threads covers it), one float4 a block,
  // with several blocks' loads in flight
  for (int c0 = 4 * threadIdx.x; c0 < cells; c0 += 4 * blockDim.x) {
    double total[4] = {0.0, 0.0, 0.0, 0.0};
    unsigned whole[4] = {0u, 0u, 0u, 0u};  // counts' int32 bits, exact
    const float4* col = reinterpret_cast<const float4*>(partial + c0);
#pragma unroll 12
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const float4 q = __ldcg(col + (size_t)b * (cells4 / 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = lane_of(q, j);
        total[j] += (double)x;
        whole[j] += __float_as_uint(x);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= cells) break;
      const int k = c / width, m = c - k * width;
      if (m < n_measures)
        sums[(size_t)k * sums_stride + m] = total[j];
      else if (counts != nullptr)
        counts[k] = (int)whole[j];
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ---------------------------------------------------------------------------
// Tier B: one [G, M + 1] table per warp (or per group of warps).
// Adds row slot r of every lane of the warp into `tab`: lanes that share
// a key add in lane order, one round per rank.
__device__ __forceinline__ void warp_table_add(float* tab, int width,
                                               int n_measures, int n_groups,
                                               bool shared_table, int k,
                                               const float4* v, int r,
                                               int m0, int mc) {
  const int lane = threadIdx.x & 31;
  const bool ok = (unsigned)k < (unsigned)n_groups;
  float* cell = tab + (size_t)(ok ? k : 0) * width;
  if (shared_table) {
    if (ok) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < mc) atomicAdd(cell + m0 + j, lane_of(v[j], r));
      if (m0 == 0) atomicAdd(reinterpret_cast<int*>(cell) + n_measures, 1);
    }
    return;
  }
  const unsigned peers = __match_any_sync(kFull, ok ? k : -1);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int rounds = __reduce_max_sync(kFull, ok ? rank : 0) + 1;
  for (int rd = 0; rd < rounds; ++rd) {
    if (ok && rank == rd) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < mc) cell[m0 + j] += lane_of(v[j], r);
      if (m0 == 0) reinterpret_cast<int*>(cell)[n_measures] += 1;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreadsBC)
grouped_sum_warp_tables(const int* __restrict__ keys, Measures vals,
                        int n_measures, const int* __restrict__ num_rows,
                        int capacity, int n_groups, int copies, int vec,
                        float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int width = n_measures + 1;
  const int cells = n_groups * width;
  for (int i = threadIdx.x; i < cells * copies; i += blockDim.x)
    smem[i] = 0.0f;
  __syncthreads();
  float* tab = smem + (size_t)(warp % copies) * cells;
  const bool shared_table = copies < warps;
  const long long nrows = live_rows(num_rows, capacity);
  const long long gwarp = (long long)blockIdx.x * warps + warp;
  const long long nwarps = (long long)gridDim.x * warps;
  long long done = 0;
  if (vec) {
    const long long nq = nrows / 4;
    // loop bounds are warp-uniform: every lane takes part in the votes
    for (long long qb = gwarp * 32; qb < nq; qb += nwarps * 32) {
      const long long q = qb + lane;
      const int4 kk = q < nq ? __ldg(reinterpret_cast<const int4*>(keys) + q)
                             : make_int4(-1, -1, -1, -1);
      for (int m0 = 0; m0 == 0 || m0 < n_measures; m0 += kChunk) {
        const int mc = min(kChunk, n_measures - m0);
        float4 v[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < mc && q < nq)
            v[j] = __ldg(reinterpret_cast<const float4*>(vals.p[m0 + j]) + q);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          warp_table_add(tab, width, n_measures, n_groups, shared_table,
                         lane_of(kk, r), v, r, m0, mc);
      }
    }
    done = nq * 4;
  }
  for (long long rb = done + gwarp * 32; rb < nrows; rb += nwarps * 32) {
    const long long row = rb + lane;
    const int k = row < nrows ? __ldg(keys + row) : -1;
    for (int m0 = 0; m0 == 0 || m0 < n_measures; m0 += kChunk) {
      const int mc = min(kChunk, n_measures - m0);
      float4 v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        v[j].x = (j < mc && row < nrows) ? __ldg(vals.p[m0 + j] + row) : 0.0f;
      warp_table_add(tab, width, n_measures, n_groups, shared_table, k, v, 0,
                     m0, mc);
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * cells;
  const int* ismem = reinterpret_cast<const int*>(smem);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    if (c % width == n_measures) {
      int s = 0;
      for (int w = 0; w < copies; ++w) s += ismem[(size_t)w * cells + c];
      reinterpret_cast<int*>(out)[c] = s;
    } else {
      float s = 0.0f;
      for (int w = 0; w < copies; ++w) s += smem[(size_t)w * cells + c];
      out[c] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Tier C: global [G, stride] f32 sums (stride a multiple of 4, padding
// columns take zeros) and [G] int32 counts.  Lane l covers measures
// 4 (l % 4) .. + 3 of a 16-measure chunk for row l / 4 of each 8-row
// group; a warp step takes 32 rows, all loaded before any reduction.
__global__ void __launch_bounds__(kThreadsBC)
grouped_sum_global(const int* __restrict__ keys, Measures vals,
                   int n_measures, const int* __restrict__ num_rows,
                   int capacity, int n_groups, float* __restrict__ sums,
                   int stride, int* __restrict__ counts) {
  constexpr int kGroups = 4;  // 8-row groups per warp step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & 3, rr = lane >> 2;
  const long long nrows = live_rows(num_rows, capacity);
  const long long gwarp = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const long long nwarps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long base = gwarp * 32; base < nrows; base += nwarps * 32) {
    int k[kGroups];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const long long row = base + gi * 8 + rr;
      k[gi] = row < nrows ? __ldg(keys + row) : -1;
    }
    for (int m0 = 0; m0 == 0 || m0 < n_measures; m0 += kChunk) {
      float v[kGroups][4];
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const long long row = base + gi * 8 + rr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + sub * 4 + j;
          v[gi][j] = ((unsigned)k[gi] < (unsigned)n_groups && m < n_measures)
                         ? __ldg(vals.p[m] + row) : 0.0f;
        }
      }
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        if ((unsigned)k[gi] >= (unsigned)n_groups) continue;
        const int m = m0 + sub * 4;
        if (m < n_measures)
          atomicAdd(reinterpret_cast<float4*>(sums + (size_t)k[gi] * stride + m),
                    make_float4(v[gi][0], v[gi][1], v[gi][2], v[gi][3]));
        if (m0 == 0 && sub == 0 && counts != nullptr)
          atomicAdd(counts + k[gi], 1);
      }
    }
  }
}

}  // namespace

extern "C" {

int grouped_sum_max_measures() { return kMaxMeasures; }

// The current device's SM count and opt-in shared memory per block, and
// lets tiers A and B use all of it (once per device, not per launch).
int grouped_sum_init(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_sum_lane_tables,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_sum_warp_tables,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_optin);
  return (int)err;
}

// keys int32 [capacity]; vals: host array of n_measures device pointers
// to f32 [capacity]; num_rows: int32 [1] on the device; vec: keys and
// every measure are 16-byte aligned.  By tier:
//  0 (A): scratch is f32 [blocks, round_up(n_groups (n_measures + 1), 4)]
//     (16-byte aligned); the launch
//     writes float64 sums to sums [n_groups, sums_stride] (columns
//     [0, n_measures)) and int32 counts to counts [n_groups] (or skips
//     them if null); ticket: an unsigned zero the launch leaves at zero.
//  1 (B): scratch is the same partial (counts as int32 bits in the last
//     column), for the caller to combine; sums, counts, ticket unused.
//  2 (C): scratch is the zeroed f32 [n_groups, scratch_stride] table
//     (scratch_stride % 4 == 0, 16-byte aligned), counts the zeroed int32
//     [n_groups] or null; sums and ticket unused.
int grouped_sum_launch(int tier, const int* keys, const float* const* vals,
                       int n_measures, const int* num_rows, int capacity,
                       int n_groups, int blocks, int threads, int copies,
                       int smem_bytes, int vec, float* scratch,
                       int scratch_stride, double* sums, int sums_stride,
                       int* counts, unsigned* ticket, void* stream) {
  if (n_measures < 0 || n_measures > kMaxMeasures || n_groups <= 0 ||
      capacity <= 0 || blocks <= 0 || threads <= 0)
    return (int)cudaErrorInvalidValue;
  Measures m{};
  for (int i = 0; i < n_measures; ++i) m.p[i] = vals[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (tier == 0) {
    if (ticket == nullptr || sums_stride < n_measures)
      return (int)cudaErrorInvalidValue;
    grouped_sum_lane_tables<<<blocks, threads, smem_bytes, s>>>(
        keys, m, n_measures, num_rows, capacity, n_groups, vec, scratch,
        sums, sums_stride, counts, ticket);
  } else if (tier == 1) {
    if (copies <= 0) return (int)cudaErrorInvalidValue;
    grouped_sum_warp_tables<<<blocks, threads, smem_bytes, s>>>(
        keys, m, n_measures, num_rows, capacity, n_groups, copies, vec,
        scratch);
  } else if (tier == 2) {
    if (scratch_stride < n_measures || scratch_stride % 4)
      return (int)cudaErrorInvalidValue;
    grouped_sum_global<<<blocks, threads, 0, s>>>(
        keys, m, n_measures, num_rows, capacity, n_groups, scratch,
        scratch_stride, counts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
