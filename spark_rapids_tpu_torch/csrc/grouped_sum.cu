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
// instead.
//
// Design: when the [G, M] f32 table plus the [G] int32 counts fit in the
// block's shared memory (227 KB after opting in past 48 KB), every block
// privatizes them in dynamic shared memory, adds its rows with
// shared-memory atomics, and flushes the groups it touched to the global
// f32 sums and int32 counts with one global atomic each.  When the table
// does not fit, the same kernel adds straight into global memory with
// global atomics (a branch inside the kernel, chosen per launch).
//
// Rows with row >= num_rows, or with a key outside [0, G), are dropped.
// Counts are int32 atomics and exact.  The order of the f32 additions
// changes from run to run; float sums carry the variableFloatAgg
// tolerance the engine already gates this lane on.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMeasures = 64;

struct Measures {
  const float* p[kMaxMeasures];
};

__global__ void __launch_bounds__(kThreads)
grouped_sum_kernel(const int* __restrict__ keys, Measures vals,
                   int n_measures, const int* __restrict__ num_rows,
                   int capacity, int n_groups, float* __restrict__ sums,
                   int sums_stride, int* __restrict__ counts,
                   bool use_shared) {
  extern __shared__ float smem[];
  float* s_sums = smem;
  int* s_counts = reinterpret_cast<int*>(smem + (size_t)n_groups * n_measures);
  if (use_shared) {
    const int n = n_groups * (n_measures + 1);
    for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = 0.0f;
    __syncthreads();
  }
  float* dst_sums = use_shared ? s_sums : sums;
  int* dst_counts = use_shared ? s_counts : counts;
  const int stride = use_shared ? n_measures : sums_stride;
  const int nrows = min(__ldg(num_rows), capacity);
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < nrows;
       row += gridDim.x * blockDim.x) {
    const int k = __ldg(keys + row);
    if (k < 0 || k >= n_groups) continue;
    float* cell = dst_sums + (size_t)k * stride;
    for (int m = 0; m < n_measures; ++m) atomicAdd(cell + m, __ldg(vals.p[m] + row));
    if (dst_counts != nullptr) atomicAdd(dst_counts + k, 1);
  }
  if (!use_shared) return;
  __syncthreads();
  // flush only the groups this block saw: a group with a zero block count
  // has nothing in its sums either
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    const int c = s_counts[g];
    if (c == 0) continue;
    if (counts != nullptr) atomicAdd(counts + g, c);
    for (int m = 0; m < n_measures; ++m)
      atomicAdd(sums + (size_t)g * sums_stride + m,
                s_sums[(size_t)g * n_measures + m]);
  }
}

}  // namespace

extern "C" {

int grouped_sum_max_measures() { return kMaxMeasures; }

// keys int32 [capacity]; vals: host array of n_measures device pointers to
// f32 [capacity]; num_rows: int32 [1] on the device; sums: f32 [n_groups,
// sums_stride] zeroed, of which columns [0, n_measures) are written;
// counts: int32 [n_groups] zeroed, or null to skip counting.
// *used_shared reports which branch of the kernel ran.
int grouped_sum_launch(const int* keys, const float* const* vals,
                       int n_measures, const int* num_rows, int capacity,
                       int n_groups, float* sums, int sums_stride,
                       int* counts, int* used_shared, void* stream) {
  if (n_measures < 0 || n_measures > kMaxMeasures || n_groups <= 0 ||
      capacity <= 0 || sums_stride < n_measures)
    return (int)cudaErrorInvalidValue;
  Measures m{};
  for (int i = 0; i < n_measures; ++i) m.p[i] = vals[i];
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t table_bytes =
      (size_t)n_groups * (size_t)(n_measures + 1) * sizeof(float);
  const bool use_shared = table_bytes <= (size_t)smem_optin;
  const size_t smem = use_shared ? table_bytes : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(grouped_sum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int want = (capacity + kThreads - 1) / kThreads;
  const int blocks = want < sms * 4 ? want : sms * 4;
  grouped_sum_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      keys, m, n_measures, num_rows, capacity, n_groups, sums, sums_stride,
      counts, use_shared);
  *used_shared = use_shared ? 1 : 0;
  return (int)cudaGetLastError();
}

}  // extern "C"
