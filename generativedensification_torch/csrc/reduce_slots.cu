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
// default gauss_dsum strategy, NaN and inf included.
//
// Bound on an H100: bytes.  Each input row is read once and each output row
// written once (n*d*w + n*w floats: ~104 MB at 262,144 gaussians, d = 9,
// w = 10, ~0.031 ms at 3.35 TB/s); d - 1 adds per output element are far
// below the f32 rate.  So the design keeps enough bytes in flight (Little's
// law: ~3.35 TB/s x ~0.7 us ~ 2.3 MB, ~18 KB per SM) and spends almost no
// instructions on the loads:
//
// - The input is cut into runs of G gaussians, G a multiple of 4, so that a
//   run (G*d*w floats, ~STAGE_BYTES) is a multiple of 16 B and starts 16 B
//   aligned whenever the base does.  Runs are dealt round robin to a
//   persistent grid of CTAS_PER_SM CTAs per SM.
// - Each CTA keeps a ring of STAGES runs in dynamic shared memory.  One
//   thread fills it with 1-D bulk copies (TMA, cp.async.bulk), each arming
//   the stage's mbarrier with the run's bytes; the CTA sums stage s while
//   the copies of the next stages are still landing, and the stage is
//   refilled once every thread is past it (one __syncthreads per run).
// - A thread sums one output element at a time from shared memory (d reads
//   at a stride of w floats) and stores it; consecutive threads write
//   consecutive floats of the run's contiguous G*w outputs, so each warp
//   stores 128 B at once.  The (gaussian, column) of the element advances
//   by constants: no integer division per element.  w and d are runtime
//   values: a build with w a template parameter for the widths the
//   backwards write (2, 10, 12, 19) ran within 0.3% of this one at every
//   train shape on an H100 (PERF.md §6).
// - A base that is not 16 B aligned (a view that starts mid-row) or a d*w
//   whose ring does not fit in shared memory sends every run, and the
//   ragged last run always, through a per-thread path in the same kernel
//   that reads device memory directly.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "launch_limits.cuh"

namespace {

constexpr int THREADS = 256;
// Timed on an H100 at the train step's shapes: 3 stages, or 1 or 3 CTAs per
// SM, within 2% of these; 8 KB stages up to 6% and 32 KB up to 12% slower.
constexpr int STAGE_BYTES = 16384;
constexpr int STAGES = 4;
constexpr int CTAS_PER_SM = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(1u) : "memory");
}

// Arm `bar` with `bytes` and start one bulk copy global -> shared that
// completes them (one thread).
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  const unsigned long long g =
      static_cast<unsigned long long>(__cvta_generic_to_global(src));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(g), "r"(bytes), "r"(b) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

// The thread's walk over the output elements of a run: element i =
// threadIdx.x + k * THREADS sits at gaussian g, column c.
struct Walk {
  int g0, c0, dg, dc;
};

// out[i] = sum over k < d of src[g*d*w + k*w + c] for the `count` gaussians
// of a run (src in shared or device memory), added in increasing k.
__device__ __forceinline__ void sum_run(const float* __restrict__ src,
                                        float* __restrict__ dst, int count,
                                        int d, int w, const Walk& walk) {
  const int dw = d * w;
  const int total = count * w;
  int g = walk.g0, c = walk.c0;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const float* p = src + g * dw + c;
    float acc = p[0];
    for (int k = 1; k < d; ++k) acc = __fadd_rn(acc, p[k * w]);
    dst[i] = acc;
    g += walk.dg;
    c += walk.dc;
    if (c >= w) {
      c -= w;
      ++g;
    }
  }
}

// Runs r = blockIdx.x + j * gridDim.x; those below `bulk_runs` (whole,
// 16 B-aligned runs of G gaussians) go through the ring, the rest (the
// ragged last run, or all of them) through the direct path.
__global__ void __launch_bounds__(THREADS)
reduce_slots_kernel(const float* __restrict__ rows, float* __restrict__ out,
                    int n, int d, int w, int G, int bulk_runs, int runs) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) unsigned long long full[STAGES];
  const Walk walk{static_cast<int>(threadIdx.x) / w,
                  static_cast<int>(threadIdx.x) % w, THREADS / w, THREADS % w};
  const long long run_floats = static_cast<long long>(G) * d * w;
  const int first = blockIdx.x;
  const int stride = gridDim.x;
  const int mine = first < bulk_runs ? (bulk_runs - 1 - first) / stride + 1 : 0;
  if (mine > 0) {
    const unsigned bytes = static_cast<unsigned>(run_floats * sizeof(float));
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) bar_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES && s < mine; ++s)
        bulk_load(ring + s * run_floats,
                  rows + static_cast<long long>(first + s * stride) * run_floats,
                  bytes, &full[s]);
    }
    for (int j = 0; j < mine; ++j) {
      const int s = j % STAGES;
      const long long r = first + static_cast<long long>(j) * stride;
      bar_wait(&full[s], (j / STAGES) & 1);
      sum_run(ring + s * run_floats, out + r * G * w, G, d, w, walk);
      __syncthreads();   // every thread is past stage s: refill it
      if (threadIdx.x == 0 && j + STAGES < mine)
        bulk_load(ring + s * run_floats,
                  rows + (r + static_cast<long long>(STAGES) * stride) * run_floats,
                  bytes, &full[s]);
    }
  }
  for (long long r = first + static_cast<long long>(mine) * stride; r < runs;
       r += stride) {
    const long long g0 = r * G;
    const int count = static_cast<int>(n - g0 < G ? n - g0 : G);
    sum_run(rows + g0 * d * w, out + g0 * w, count, d, w, walk);
  }
}

}  // namespace

extern "C" int gd_reduce_slots(const float* rows, float* out, int n, int d,
                               int w, void* stream) {
  static std::atomic<int> dyn_set[gd::MAX_DEVICES];
  if (n <= 0 || w <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  gd::Limits lim;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = gd::device_limits(dev, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_bytes = static_cast<long long>(d) * w * sizeof(float);
  long long G = (STAGE_BYTES / row_bytes) / 4 * 4;
  if (G < 4) G = 4;
  if (G > n) G = (n + 3) / 4 * 4;
  const long long smem = STAGES * G * row_bytes;
  const bool ring = smem + 1024 <= lim.smem_optin &&
                    reinterpret_cast<std::uintptr_t>(rows) % 16 == 0;
  const long long runs = (n + G - 1) / G;
  const long long bulk_runs = ring ? n / G : 0;
  long long grid = static_cast<long long>(CTAS_PER_SM) * lim.sms;
  if (grid > runs) grid = runs;
  const size_t dyn = bulk_runs > 0 ? static_cast<size_t>(smem) : 0;
  // the static barriers count against the 48 KB default too: raise the
  // limit for every ring, not only for those above 48 KB
  if (dyn > 0) {
    err = gd::allow_dynamic_smem(reduce_slots_kernel, dev, static_cast<int>(dyn),
                                 dyn_set);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reduce_slots_kernel<<<static_cast<unsigned>(grid), THREADS, dyn,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, out, n, d, w, static_cast<int>(G), static_cast<int>(bulk_runs),
      static_cast<int>(runs));
  return static_cast<int>(cudaGetLastError());
}
