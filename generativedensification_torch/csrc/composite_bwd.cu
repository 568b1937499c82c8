// 3DGS compositing backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `pallas_composite_bwd` / `_bwd_kernel` of
// generativedensification_tpu/splat/pallas_kernels.py, with the semantics of
// the JAX package's `_xla_bwd` (splat/composite.py): per tile, walk the
// tile's depth-sorted segment front to back, recompute alpha, the
// transmittance T before each gaussian and the include test exactly as the
// forward kernel (composite_fwd.cu) does, carry the inclusive prefix of
// contrib * w with contrib = gC . color + gD * z and w = alpha * T, and form
//   suffix  = G2 - prefix                  (G2 = G + dL/dT_fin, per pixel)
//   g_alpha = contrib * T - suffix / max(1 - alpha, 0.01)
//   g_power = g_alpha * alpha              (0 where alpha is clamped at 0.99)
//   gx = g_power (a dx + b dy),  gy = g_power (c dy + b dx).
// Per slot the kernel reduces over the tile's pixels:
//   full    (12 rows) gx, gy, the three conic rows, g_power / opacity,
//                     w gC (3), w gD, |gx|, |gy|
//   noabs   (10 rows) the first ten
//   selonly ( 2 rows) |gx|, |gy|  (the AbsGS selection pass)
// and writes one row per slot into out (P, rows).  Rows a mode does not
// compute are not stored at all; the caller pads them with zeros.
//
// Design.  The forward's front (composite_subtile.cuh): one CTA of 256
// threads per 16 x 16 sub-tile, one pixel per thread, the tile's segment
// staged in batches with the order-preserving footprint skip.  A 32 px tile
// is launched as a thread-block cluster of its four sub-tile CTAs, which run
// their batches in lockstep; a 16 px tile is a cluster of one.  Per batch:
//   1. each CTA sums every kept slot's rows over its 256 pixels in a fixed
//      order (a warp shuffle tree, then the eight warp partials in warp
//      order) into its shared per-slot sums (zero for a slot it dropped);
//   2. after a cluster barrier, CTA q sums the batch's rows q/4 .. (q+1)/4
//      over the four CTAs in rank order through distributed shared memory
//      and writes each of them once.
// No atomics, so the output is bitwise the same from run to run; the
// selection scores built from it feed a top-k, where a reordered sum could
// flip a near-tied pick between two identical requests.  The per-slot sums
// are double-buffered, so one cluster barrier per batch suffices.  A CTA
// whose pixels are all done joins the barriers with zero sums; the cluster
// leaves the segment once no pixel of the tile is alive (each CTA's count
// of live pixels travels with its sums), and slots past that point keep the
// zeros the wrapper allocates.
//
// Bound on an H100.  Bytes are small (table, live ids, the per-pixel
// cotangent rows and the per-slot output: tens of MB at 262,144 gaussians,
// ~0.01 ms at 3.35 TB/s).  The work is the forward's ~17-operation
// evaluation per kept (slot, live pixel) plus ~29 operations per
// contribution and the mode's row sums (chip_smoke.py computes the bound
// from each run's own counts), so the kernel is bound by f32 operations.
// Every operation on the per-pixel chain is an explicitly rounded intrinsic
// (no FMA contraction) in the order of the plain PyTorch version in
// splat/kernels.py.  Build without --use_fast_math: approximate exp, flushed
// denormals or approximate division would move the alpha >= 1/255 and
// T < 1e-4 edges.

#include <cooperative_groups.h>

#include "composite_subtile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace subtile;

// 1 - ALPHA_MAX as the JAX package rounds it: the f32 nearest 0.01, not
// 1.0f - 0.99f (which is 0.00999999)
constexpr float ONE_M_FLOOR = 0.01f;

constexpr int MODE_FULL = 0;
constexpr int MODE_NOABS = 1;
constexpr int MODE_SELONLY = 2;

template <int MODE>
struct Rows {
  static constexpr int W = MODE == MODE_FULL ? 12 : (MODE == MODE_NOABS ? 10 : 2);
  // slots staged per round: the warp partials take NWARPS * BATCH * W floats
  static constexpr int BATCH = W <= 2 ? 256 : 64;
};

template <int TS, int MODE>
__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ sorted_ids,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const float* __restrict__ gc4,
                     const float* __restrict__ g2,
                     float* __restrict__ out, int tiles_x) {
  constexpr int NPIX = TS * TS;
  constexpr int W = Rows<MODE>::W;
  constexpr int NB = Rows<MODE>::BATCH;
  constexpr int CL = SubTile<TS>::CTAS;    // the cluster: the tile's CTAs
  static_assert(NB <= THREADS, "one staging thread per slot");

  __shared__ Staged<NB> s;
  __shared__ float s_part[NWARPS][NB][W];
  __shared__ float s_sum[2][NB * W];       // per-slot sums, double-buffered
  __shared__ int s_live[2];                // live pixels after the batch

  const SubTile<TS> st;
  const int start = tile_starts[st.tile];
  const int count = tile_counts[st.tile];
  const float ox = static_cast<float>((st.tile % tiles_x) * TS);
  const float oy = static_cast<float>((st.tile / tiles_x) * TS);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* gct = gc4 + static_cast<size_t>(st.tile) * 4 * NPIX + st.p;
  const float gr = gct[0], gg = gct[NPIX], gb = gct[2 * NPIX], gd = gct[3 * NPIX];
  const float G2 = g2[static_cast<size_t>(st.tile) * NPIX + st.p];
  float T = 1.0f, prefix = 0.0f;
  bool alive = true;
  bool cta_alive = true;

  for (int base = 0, buf = 0; base < count; base += NB, buf ^= 1) {
    const int n = min(NB, count - base);
    float* sum = s_sum[buf];
    // this buffer was last read by the cluster two batches ago, before the
    // barrier of the previous batch
    for (int i = threadIdx.x; i < n * W; i += THREADS) sum[i] = 0.0f;

    if (cta_alive) {
      const int kept = stage_batch<NB, true, false>(
          s, table, sorted_ids + start + base, n, ox, oy, st.rcx, st.rcy);
      for (int k = 0; k < kept; ++k) {
        float acc[W];
#pragma unroll
        for (int r = 0; r < W; ++r) acc[r] = 0.0f;
        bool hit = false;
        if (alive) {
          const float a = s.a[k], b = s.b[k], c = s.c[k];
          float dx, dy;
          const float power = power_of(st.px, st.py, s.x[k], s.y[k], a, b, c, dx, dy);
          const float alpha = fminf(ALPHA_MAX, __fmul_rn(s.o[k], expf(power)));
          if (alpha >= ALPHA_MIN) {
            const float one_m = __fsub_rn(1.0f, alpha);
            const float U = __fmul_rn(T, one_m);
            if (U < T_EPS) {  // done before this gaussian
              alive = false;
            } else {
              hit = true;
              const float w = __fmul_rn(alpha, T);
              const float contrib = __fadd_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(gr, s.r[k]), __fmul_rn(gg, s.g[k])),
                            __fmul_rn(gb, s.bl[k])),
                  __fmul_rn(gd, s.z[k]));
              prefix = __fadd_rn(prefix, __fmul_rn(contrib, w));
              const float suffix = __fsub_rn(G2, prefix);
              const float inv_1ma = __frcp_rn(fmaxf(one_m, ONE_M_FLOOR));
              const float g_alpha = __fsub_rn(__fmul_rn(contrib, T),
                                              __fmul_rn(suffix, inv_1ma));
              const float g_power =
                  alpha < ALPHA_MAX ? __fmul_rn(g_alpha, alpha) : 0.0f;
              const float gx = __fmul_rn(
                  g_power, __fadd_rn(__fmul_rn(a, dx), __fmul_rn(b, dy)));
              const float gy = __fmul_rn(
                  g_power, __fadd_rn(__fmul_rn(c, dy), __fmul_rn(b, dx)));
              if constexpr (MODE == MODE_SELONLY) {
                acc[0] = fabsf(gx);
                acc[1] = fabsf(gy);
              } else {
                const float gh = __fmul_rn(g_power, -0.5f);
                acc[0] = gx;
                acc[1] = gy;
                acc[2] = __fmul_rn(__fmul_rn(gh, dx), dx);
                acc[3] = __fmul_rn(g_power, __fmul_rn(-dx, dy));
                acc[4] = __fmul_rn(__fmul_rn(gh, dy), dy);
                acc[5] = g_power;
                acc[6] = __fmul_rn(w, gr);
                acc[7] = __fmul_rn(w, gg);
                acc[8] = __fmul_rn(w, gb);
                acc[9] = __fmul_rn(w, gd);
                if constexpr (MODE == MODE_FULL) {
                  acc[10] = fabsf(gx);
                  acc[11] = fabsf(gy);
                }
              }
              T = U;
            }
          }
        }
        // fixed-order reduction over the warp's lanes (skipped, with a zero
        // partial, when no lane of the warp contributes)
        if (__any_sync(FULL_MASK, hit)) {
#pragma unroll
          for (int r = 0; r < W; ++r) {
            float v = acc[r];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
            acc[r] = v;
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < W; ++r) s_part[warp][k][r] = acc[r];
        }
      }
      const int live = __syncthreads_count(alive);
      // the CTA's sum of each kept slot: the warp partials in warp order
      for (int i = threadIdx.x; i < kept * W; i += THREADS) {
        const int k = i / W;
        const int r = i - k * W;
        float v = s_part[0][k][r];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) v = __fadd_rn(v, s_part[w][k][r]);
        sum[s.src[k] * W + r] = v;
      }
      cta_alive = live > 0;
    }
    if (threadIdx.x == 0) s_live[buf] = cta_alive;

    // the cluster's sums of this batch, then this CTA's share of the rows
    int any = 0;
    float* dst = out + static_cast<size_t>(start + base) * W;
    const int per = (n + CL - 1) / CL;
    const int j0 = st.q * per;
    const int j1 = min(n, j0 + per);
    if constexpr (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const float* sums[CL];
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        sums[q] = cluster.map_shared_rank(sum, q);
        any += *cluster.map_shared_rank(&s_live[buf], q);
      }
      for (int i = j0 * W + threadIdx.x; i < j1 * W; i += THREADS) {
        float v = sums[0][i];
#pragma unroll
        for (int q = 1; q < CL; ++q) v = __fadd_rn(v, sums[q][i]);
        const int j = i / W;
        if (MODE != MODE_SELONLY && i - j * W == 5) {
          const float opa = table[static_cast<size_t>(sorted_ids[start + base + j]) * ROW + 5];
          v = __fdiv_rn(v, fmaxf(opa, 1e-12f));
        }
        dst[i] = v;
      }
    } else {
      __syncthreads();
      any = s_live[buf];
      for (int i = threadIdx.x; i < n * W; i += THREADS) {
        float v = sum[i];
        const int j = i / W;
        if (MODE != MODE_SELONLY && i - j * W == 5) {
          const float opa = table[static_cast<size_t>(sorted_ids[start + base + j]) * ROW + 5];
          v = __fdiv_rn(v, fmaxf(opa, 1e-12f));
        }
        dst[i] = v;
      }
    }
    if (any == 0) break;
  }
  if constexpr (CL > 1) {
    // no CTA leaves while another may still read its shared memory
    cg::this_cluster().sync();
  }
}

template <int TS, int MODE>
int launch(const float* table, const int* sorted_ids, const int* tile_starts,
           const int* tile_counts, const float* gc4, const float* g2,
           float* out, int num_tiles, int tiles_x, cudaStream_t s) {
  constexpr int CL = SubTile<TS>::CTAS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_tiles * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, composite_bwd_kernel<TS, MODE>, table, sorted_ids, tile_starts,
      tile_counts, gc4, g2, out, tiles_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const float* table, const int* sorted_ids,
                const int* tile_starts, const int* tile_counts,
                const float* gc4, const float* g2, float* out, int num_tiles,
                int tiles_x, int tile_size, cudaStream_t s) {
  if (tile_size == 16)
    return launch<16, MODE>(table, sorted_ids, tile_starts, tile_counts, gc4,
                            g2, out, num_tiles, tiles_x, s);
  if (tile_size == 32)
    return launch<32, MODE>(table, sorted_ids, tile_starts, tile_counts, gc4,
                            g2, out, num_tiles, tiles_x, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table (N, 12) f32 row-major, 16-byte aligned; sorted_ids (P,) i32;
// tile_starts / tile_counts (num_tiles,) i32 with counts already clamped;
// gc4 (num_tiles, 4, ts*ts) f32 rows gC_r, gC_g, gC_b, gD; g2 (num_tiles,
// ts*ts) f32; out (P, rows) f32, zero-filled by the caller, rows = 12 / 10 /
// 2 for mode 0 (full) / 1 (noabs) / 2 (selonly).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int gd_composite_bwd(const float* table, const int* sorted_ids,
                                const int* tile_starts, const int* tile_counts,
                                const float* gc4, const float* g2, float* out,
                                int num_tiles, int tiles_x, int tile_size,
                                int mode, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FULL:
      return launch_mode<MODE_FULL>(table, sorted_ids, tile_starts, tile_counts,
                                    gc4, g2, out, num_tiles, tiles_x, tile_size, s);
    case MODE_NOABS:
      return launch_mode<MODE_NOABS>(table, sorted_ids, tile_starts, tile_counts,
                                     gc4, g2, out, num_tiles, tiles_x, tile_size, s);
    case MODE_SELONLY:
      return launch_mode<MODE_SELONLY>(table, sorted_ids, tile_starts,
                                       tile_counts, gc4, g2, out, num_tiles,
                                       tiles_x, tile_size, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
