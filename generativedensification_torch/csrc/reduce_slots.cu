// Segmented row sum for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `pallas_reduce_slots` / `_reduce_slots_kernel` of
// generativedensification_tpu/splat/pallas_kernels.py: rows (n*d, w) ->
// out (n, w), out[g, c] = sum over k < d of rows[g*d + k, c].  The backward
// of a compositor writes one gradient row per sorted slot; under
// GD_APOS_MODE=gauss|rank the caller gathers those rows into (gaussian,
// slot) order and this kernel folds each gaussian's d slot rows into one.
//
// The TPU kernel computes the sum as a selector matmul on the MXU only to
// pin XLA's layout of the gather that feeds it.  Here it is a direct sum:
// the d rows of an output row are added in increasing k with explicitly
// rounded adds, so the result is bitwise the one of the plain version
// (splat/kernels.py::reduce_slots_plain) and of the D-gather loop of the
// default gauss_dsum strategy.
//
// The rows of G consecutive gaussians are one contiguous run of G*d*w
// floats: a block copies its run into shared memory with coalesced loads
// (G chosen so that the run fills up to 32 KB), then each thread sums one
// output element from shared memory and the block writes its G*w outputs,
// again contiguous.
//
// Bound on an H100: bytes.  Each input row is read once and each output row
// written once (n*d*w + n*w floats: ~104 MB at 262,144 gaussians, d = 9,
// w = 10, ~0.031 ms at 3.35 TB/s); d - 1 adds per output element are far
// below the f32 rate.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGE_FLOATS = 8192;   // 32 KB of shared memory per block

__global__ void __launch_bounds__(THREADS)
reduce_slots_kernel(const float* __restrict__ rows, float* __restrict__ out,
                    long long n, int d, int w, int groups) {
  extern __shared__ float stage[];
  const long long g0 = static_cast<long long>(blockIdx.x) * groups;
  const int G = static_cast<int>(n - g0 < groups ? n - g0 : groups);
  const int run = G * d * w;
  const float* src = rows + g0 * d * w;
  for (int i = threadIdx.x; i < run; i += THREADS) stage[i] = __ldg(src + i);
  __syncthreads();
  float* dst = out + g0 * w;
  for (int i = threadIdx.x; i < G * w; i += THREADS) {
    const int g = i / w;
    const float* p = stage + g * d * w + (i - g * w);
    float acc = p[0];
    for (int k = 1; k < d; ++k) acc = __fadd_rn(acc, p[k * w]);
    dst[i] = acc;
  }
}

}  // namespace

extern "C" int gd_reduce_slots(const float* rows, float* out, int n, int d,
                               int w, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (d <= 0 || d * w > STAGE_FLOATS) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = STAGE_FLOATS / (d * w);
  const long long blocks = (static_cast<long long>(n) + groups - 1) / groups;
  const size_t smem = static_cast<size_t>(groups) * d * w * sizeof(float);
  reduce_slots_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(rows, out, n, d, w,
                                                             groups);
  return static_cast<int>(cudaGetLastError());
}
