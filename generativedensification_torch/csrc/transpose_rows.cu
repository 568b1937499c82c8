// Exact transpose for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `pallas_transpose16` / `_transpose_cols_kernel` of
// generativedensification_tpu/splat/pallas_kernels.py: cols (w, M) ->
// rows (M, w).  Under GD_APOS_MODE=gauss_dsum_col the caller sums each
// gaussian's slot gradients as columns of the attribute-major view of the
// per-slot gradient rows, and this kernel turns the (w, N) sums back into
// the (N, w) rows the unpacking reads.
//
// The TPU kernel transposes with an identity matmul (HIGHEST precision)
// only to pin XLA's layouts on both sides.  Here it is a copy through
// shared memory, exact by construction.  The widths are small (2 to 19), so
// a block takes 256 columns of up to 32 input rows: it reads each row's 256
// floats with one coalesced load per thread, and the 256 output rows it
// writes are one contiguous run of 256 * w floats when w <= 32, written
// with consecutive threads on consecutive floats.  The tile's row pitch of
// 257 floats spreads a warp's column reads over the banks.
//
// Bound on an H100: bytes, 2 * w * M floats (~21 MB at 262,144 gaussians
// and w = 10, ~0.0063 ms at 3.35 TB/s).

#include <cuda_runtime.h>

namespace {

constexpr int TM = 256;   // columns per block (= threads per block)
constexpr int TR = 32;    // input rows per block

__global__ void __launch_bounds__(TM)
transpose_kernel(const float* __restrict__ cols, float* __restrict__ rows,
                 int w, long long M) {
  __shared__ float tile[TR][TM + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * TM;
  const int r0 = blockIdx.y * TR;
  const int nr = w - r0 < TR ? w - r0 : TR;
  const int nm = static_cast<int>(M - m0 < TM ? M - m0 : TM);
  if (threadIdx.x < nm) {
    for (int r = 0; r < nr; ++r)
      tile[r][threadIdx.x] = __ldg(cols + static_cast<long long>(r0 + r) * M + m0 + threadIdx.x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nm * nr; i += TM) {
    const int m = i / nr;
    const int r = i - m * nr;
    rows[(m0 + m) * w + r0 + r] = tile[r][m];
  }
}

}  // namespace

extern "C" int gd_transpose_rows(const float* cols, float* rows, int w, int M,
                                 void* stream) {
  if (w <= 0 || M <= 0) return 0;
  dim3 grid(static_cast<unsigned>((static_cast<long long>(M) + TM - 1) / TM),
            static_cast<unsigned>((w + TR - 1) / TR));
  transpose_kernel<<<grid, TM, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, rows, w, M);
  return static_cast<int>(cudaGetLastError());
}
