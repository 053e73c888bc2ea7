// Per-group f32 sums over rows sorted by group (the banded lane of the
// aggregate's merge).
//
// Replaces: spark_rapids_tpu/ops/grouped_window.py window_group_sums (body
// _window_block_kernel plus its slab-merge matmul), which builds a 2R-wide
// one-hot window per 256-row block on the TPU's matrix unit.
//
// What bounds it on an H100: bytes.  Each row reads one int32 group id and
// M f32 measures once, and each group writes M f32 sums; the floor is
// (4 + 4 M) B/row + 4 M B/group over 3.35 TB/s.
//
// Design: gid is non-decreasing, so the rows of a group are contiguous.
// A warp takes 32 consecutive rows, one per lane, and reduces every run of
// equal gid with a segmented warp-shuffle scan (a lane adds the lane `off`
// below it only when both hold the same gid, which for sorted ids means
// the whole span between them does).  The last lane of each run issues one
// atomicAdd per measure into the zeroed [out_cap, M] output.  Groups at or
// past out_cap, and negative ids (an empty batch numbers its rows -1), are
// dropped.
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
constexpr int kMaxMeasures = 64;

struct Measures {
  const float* p[kMaxMeasures];
};

__global__ void __launch_bounds__(kThreads)
window_group_sums_kernel(const int* __restrict__ gid, Measures vals,
                         int n_measures, int capacity, int out_cap,
                         float* __restrict__ out, int out_stride) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long chunk = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
       chunk * 32 < capacity; chunk += warps) {
    const long long row = chunk * 32 + lane;
    const bool in = row < capacity;
    const int g = in ? __ldg(gid + row) : INT_MAX;
    // same[i]: the lane (1 << i) below holds the same group
    unsigned same = 0;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int off = 1 << i;
      const int gu = __shfl_up_sync(full, g, off);
      if (lane >= off && gu == g) same |= 1u << i;
    }
    const int g_next = __shfl_down_sync(full, g, 1);
    const bool last = lane == 31 || g_next != g;
    const bool keep = last && g >= 0 && g < out_cap;
    for (int m = 0; m < n_measures; ++m) {
      float v = in ? __ldg(vals.p[m] + row) : 0.0f;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float u = __shfl_up_sync(full, v, 1 << i);
        if (same & (1u << i)) v += u;
      }
      if (keep) atomicAdd(out + (size_t)g * out_stride + m, v);
    }
  }
}

}  // namespace

extern "C" {

int window_group_sums_max_measures() { return kMaxMeasures; }

// gid int32 [capacity], non-decreasing; vals: host array of n_measures
// device pointers to f32 [capacity]; out: f32 [out_cap, out_stride] zeroed,
// of which columns [0, n_measures) are written.
int window_group_sums_launch(const int* gid, const float* const* vals,
                             int n_measures, int capacity, int out_cap,
                             float* out, int out_stride, void* stream) {
  if (n_measures <= 0 || n_measures > kMaxMeasures || capacity <= 0 ||
      out_cap <= 0 || out_stride < n_measures)
    return (int)cudaErrorInvalidValue;
  Measures m{};
  for (int i = 0; i < n_measures; ++i) m.p[i] = vals[i];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = ((long long)capacity + kThreads - 1) / kThreads;
  const int blocks = (int)(want < sms * 16LL ? want : sms * 16LL);
  window_group_sums_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      gid, m, n_measures, capacity, out_cap, out, out_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
