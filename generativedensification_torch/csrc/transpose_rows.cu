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
// shared memory, exact by construction (NaN payloads included).
//
// Bound on an H100: bytes, 2 * w * M floats (~21 MB at 262,144 gaussians
// and w = 10, ~0.0063 ms at 3.35 TB/s).  At that size the launch, ramp and
// tail are a large share, so the design puts the whole input in flight at
// once and spends no instructions on addressing:
//
// - A CTA takes TM columns (TM = 1,024, halved while the grid would have
//   fewer CTAs than the card has SMs: 256 CTAs at M = 262,144, 232 of 512
//   columns at M = 118,752), one thread per 4 columns.  Its tile holds all
//   w rows of its columns in dynamic shared memory (w x (TM + 4) floats,
//   78 KB at w = 19, so two CTAs fit on an SM and the whole grid is
//   resident at once).
// - Loads: each thread issues its w 16 B loads (ld.global.nc.v4) before it
//   stores any of them (w is a template parameter for the widths the
//   backwards write, 2, 10, 12 and 19, with a generic instance for the
//   rest; the generic instance alone, whose loads unroll by 4, ran 4-19%
//   slower at the train shapes on an H100, PERF.md §6).  They need M % 4 == 0 and a 16 B aligned base; otherwise (a view
//   that starts mid-row, a ragged M) the threads load the same tile with
//   scalar loads.  A build that loaded the w row segments with 1-D bulk
//   copies (TMA) on one mbarrier instead ran within 1% of this one at
//   every train shape, so the simpler loads stayed (PERF.md §6).
// - Stores: the CTA's TM output rows are one contiguous run of TM * w
//   floats; each thread reads 4 consecutive floats of it out of the tile
//   (column-wise; the row pitch TM + 4 keeps a warp's reads within 2-3 per
//   bank) and writes them with one 16 B store.  The position in the tile
//   advances by constants: no integer division per element.
// - A w too wide for one tile even at 128 columns (above 438 rows in an
//   H100's 227 KB; the generic instance only) is cut into groups of rows along the grid's
//   second dimension; such a CTA writes its rows' part of each output row
//   with scalar stores.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "launch_limits.cuh"

namespace {

// Timed on an H100 at the train step's shapes: 512 columns ran within 1% of
// 1,024.
constexpr int TM = 1024;
constexpr int PAD = 4;         // floats of padding per tile row
constexpr int MIN_TM = 128;

// The w x nm input tile into shared memory (row pitch P floats).  `vec`:
// M % 4 == 0 and a 16 B aligned base, so every row segment is 16 B aligned
// and nm is a multiple of 4.
template <int W>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* tile, int w_rt, long long M,
                                          int nm, int P, bool vec) {
  const int w = W > 0 ? W : w_rt;
  const int c = 4 * static_cast<int>(threadIdx.x);
  if (!vec) {
    for (int r = 0; r < w; ++r)
      for (int e = 0; e < 4; ++e)
        if (c + e < nm) tile[r * P + c + e] = src[r * M + c + e];
    return;
  }
  if (c >= nm) return;
  if constexpr (W > 0) {
    float4 v[W];
#pragma unroll
    for (int r = 0; r < W; ++r)
      v[r] = __ldg(reinterpret_cast<const float4*>(src + r * M + c));
#pragma unroll
    for (int r = 0; r < W; ++r) *reinterpret_cast<float4*>(tile + r * P + c) = v[r];
  } else {
#pragma unroll 4
    for (int r = 0; r < w; ++r)
      *reinterpret_cast<float4*>(tile + r * P + c) =
          __ldg(reinterpret_cast<const float4*>(src + r * M + c));
  }
}

template <int W>
__global__ void __launch_bounds__(TM / 4)
transpose_kernel(const float* __restrict__ cols, float* __restrict__ rows,
                 int w_rt, int M, int tm, int wg, int vec_in, int vec_out) {
  extern __shared__ __align__(128) float tile[];
  const int w = W > 0 ? W : w_rt;
  const int P = tm + PAD;
  const long long m0 = static_cast<long long>(blockIdx.x) * tm;
  const int nm = static_cast<int>(M - m0 < tm ? M - m0 : tm);
  if constexpr (W == 0) {
    if (gridDim.y > 1) {   // rows r0 .. r0 + h of w, in groups of wg
      const int r0 = blockIdx.y * wg;
      const int h = w - r0 < wg ? w - r0 : wg;
      load_tile<0>(cols + static_cast<long long>(r0) * M + m0, tile, h, M, nm,
                   P, vec_in != 0);
      __syncthreads();
      for (int j = threadIdx.x; j < nm * h; j += blockDim.x)
        rows[(m0 + j / h) * w + r0 + j % h] = tile[(j % h) * P + j / h];
      return;
    }
  }
  load_tile<W>(cols + m0, tile, w, M, nm, P, vec_in != 0);
  __syncthreads();

  // output element j of the run sits at tile column m = j / w, row r = j % w
  float* dst = rows + m0 * w;
  const int total = nm * w;
  const int quads = vec_out ? total / 4 : 0;
  const int step = 4 * blockDim.x;
  const int dm = step / w, dr = step % w;
  int m = 4 * threadIdx.x / w, r = 4 * threadIdx.x % w;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    float v[4];
    int mm = m, rr = r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = tile[rr * P + mm];
      if (++rr == w) {
        rr = 0;
        ++mm;
      }
    }
    *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(v[0], v[1], v[2], v[3]);
    m += dm;
    r += dr;
    if (r >= w) {
      r -= w;
      ++m;
    }
  }
  // the last total % 4 floats (all of them if the output is not 16 B aligned)
  for (int j = 4 * quads + threadIdx.x; j < total; j += blockDim.x)
    dst[j] = tile[(j % w) * P + j / w];
}

template <int W>
int launch(const float* cols, float* rows, int w, int M, cudaStream_t stream) {
  static std::atomic<int> dyn_set[gd::MAX_DEVICES];
  int dev = 0;
  gd::Limits lim;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = gd::device_limits(dev, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a tile of h rows of tm columns, beside 1 KB the runtime reserves
  const auto fits = [&](int h, int tm) {
    return static_cast<long long>(h) * (tm + PAD) * sizeof(float) + 1024 <=
           lim.smem_optin;
  };
  int tm = TM;
  while (tm > MIN_TM && (M + tm - 1) / tm < lim.sms) tm /= 2;
  while (tm > MIN_TM && !fits(w, tm)) tm /= 2;
  int wg = w;   // rows per CTA
  if (!fits(wg, tm))
    wg = static_cast<int>((lim.smem_optin - 1024) / ((tm + PAD) * sizeof(float)));
  const size_t dyn = static_cast<size_t>(wg) * (tm + PAD) * sizeof(float);
  auto* kernel = transpose_kernel<W>;
  err = gd::allow_dynamic_smem(kernel, dev, static_cast<int>(dyn), dyn_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_in = M % 4 == 0 && reinterpret_cast<std::uintptr_t>(cols) % 16 == 0;
  const int vec_out = reinterpret_cast<std::uintptr_t>(rows) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((M + tm - 1) / tm),
                  static_cast<unsigned>((w + wg - 1) / wg));
  kernel<<<grid, tm / 4, dyn, stream>>>(cols, rows, w, M, tm, wg, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gd_transpose_rows(const float* cols, float* rows, int w, int M,
                                 void* stream) {
  if (w <= 0 || M <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 2: return launch<2>(cols, rows, w, M, st);
    case 10: return launch<10>(cols, rows, w, M, st);
    case 12: return launch<12>(cols, rows, w, M, st);
    case 19: return launch<19>(cols, rows, w, M, st);
    default: return launch<0>(cols, rows, w, M, st);
  }
}
