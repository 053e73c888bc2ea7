// TPC-H Q1 scan -> filter -> project -> group-reduce in one pass over the
// seven lineitem columns.
//
// Replaces: spark_rapids_tpu/ops/pallas_kernels.py q1_fused_pallas (body
// _q1_block_kernel), the Pallas kernel of the stacked Q1 step.
//
// What bounds it on an H100: bytes.  Every live row is read once (3 int32
// + 4 f32 columns, 28 B/row) and the work per row is ~80 integer and f32
// instructions, far below the card's ~295 operations per byte, so the
// floor is 28 B per live row over 3.35 TB/s.  Padding rows past
// num_rows[batch] are skipped before any column is read, so a stacked
// input of capacity C moves the bytes of its live rows, not of C.
//
// Design: each block owns 8192 consecutive rows; each of its 256 threads
// reads 32 of them (neighbouring threads on neighbouring rows, so loads
// coalesce) and keeps the 6 groups x 6 measures in 36 f32 registers.  The
// group of a row is a compile-time-unrolled compare, so the registers are
// never indexed dynamically (no local-memory spill).  A thread's f32
// partial covers at most 32 rows and a block's at most 8192, the same kind
// of bound the TPU kernel puts on its per-lane partials; the wrapper adds
// the per-block partials in float64.  A warp-shuffle reduction, then one
// pass through shared memory, writes one [8, 6] f32 partial per block
// (slots 6 and 7 are zero, as in the TPU kernel's table).
//
// Semantics kept from the TPU kernel:
//   - a row counts when row_in_batch < num_rows[batch] and
//     shipdate <= cutoff (int32 compare);
//   - a filtered row is skipped, not multiplied by a 0/1 mask, so a NaN
//     in a filtered row never reaches a sum (the TPU kernel's `where`);
//   - disc_price = price * (1 - disc) and charge = disc_price * (1 + tax)
//     are computed in f32.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 32;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kGroups = 6;
constexpr int kMeasures = 6;
constexpr int kSlots = 8;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
q1_fused_kernel(const int* __restrict__ flag, const int* __restrict__ status,
                const float* __restrict__ qty,
                const float* __restrict__ price,
                const float* __restrict__ disc,
                const float* __restrict__ tax,
                const int* __restrict__ ship,
                const int* __restrict__ num_rows, int capacity,
                int batch_rows, int cutoff, float* __restrict__ partials) {
  float acc[kGroups][kMeasures];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int j = 0; j < kMeasures; ++j) acc[g][j] = 0.0f;

  const int base = blockIdx.x * kRowsPerBlock + threadIdx.x;
#pragma unroll 4
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int row = base + k * kThreads;
    if (row >= capacity) break;
    const int batch = row / batch_rows;
    if (row - batch * batch_rows >= __ldg(num_rows + batch)) continue;
    if (__ldg(ship + row) > cutoff) continue;
    const int g = __ldg(flag + row) * 2 + __ldg(status + row);
    const float q = __ldg(qty + row);
    const float p = __ldg(price + row);
    const float d = __ldg(disc + row);
    const float t = __ldg(tax + row);
    const float disc_price = p * (1.0f - d);
    const float charge = disc_price * (1.0f + t);
    const float v[kMeasures] = {q, p, disc_price, charge, d, 1.0f};
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const bool in = g == gi;
#pragma unroll
      for (int j = 0; j < kMeasures; ++j) acc[gi][j] += in ? v[j] : 0.0f;
    }
  }

  // warp tree, then the block's warps through shared memory
  __shared__ float red[kWarps][kGroups * kMeasures];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int j = 0; j < kMeasures; ++j) {
      float x = acc[g][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) red[warp][g * kMeasures + j] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x < kSlots * kMeasures) {
    float s = 0.0f;
    if (threadIdx.x < kGroups * kMeasures) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    }
    partials[(size_t)blockIdx.x * kSlots * kMeasures + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" {

int q1_fused_rows_per_block() { return kRowsPerBlock; }

// partials: [n_blocks, 8, 6] f32 with n_blocks = ceil(capacity / 8192).
// num_rows: int32 [capacity / batch_rows] on the device.
int q1_fused_launch(const int* flag, const int* status, const float* qty,
                    const float* price, const float* disc, const float* tax,
                    const int* ship, const int* num_rows, int capacity,
                    int batch_rows, int cutoff, float* partials,
                    void* stream) {
  if (capacity <= 0 || batch_rows <= 0 || capacity % batch_rows != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (capacity + kRowsPerBlock - 1) / kRowsPerBlock;
  q1_fused_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      flag, status, qty, price, disc, tax, ship, num_rows, capacity,
      batch_rows, cutoff, partials);
  return (int)cudaGetLastError();
}

}  // extern "C"
