// 2DGS surfel compositing backward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel `pallas_surfel_bwd` / `_bwd_kernel` of
// generativedensification_tpu/splat/pallas_surfel.py, with its closed-form
// distortion gradients and the geometry of the JAX package's `_xla_scan_fwd`
// (splat/surfel.py): per tile, walk the tile's depth-sorted segment front to
// back, recompute alpha, the transmittance T before each slot and the include
// test exactly as the forward kernel (surfel_fwd.cu) does, carry the
// inclusive prefix of cw * w (w = alpha T) and form
//   cw      = gC . color + gN . normal + gDexp z
//             + gdist (M2 + m^2 sum w - 2 m M1)       (full; gC . color only
//                                                      in selonly)
//   g_alpha = cw T - (G2 - prefix) / max(1 - alpha, 0.01)
//   g_power = g_alpha alpha               (0 where alpha is clamped at 0.99)
// The power's gradient goes to the branch that set it: the object-space one,
// -1/2 (cr_x^2 + cr_y^2) rz^2, through cr = acr + X bcr + Y ccr (and, in full,
// z = det rz with gz = w gDexp + dL/dm dm/dz + gDmed at the median crossing),
// or the screen-space filter -1/4 |(X, Y) - center|^2.  d cr_z is 0 where
// |cr_z| < 1e-8 (the guard's constant).  Per slot the kernel reduces over the
// tile's pixels:
//   full    (19 rows) d acr (3), d bcr (3), d ccr (3), d det, d center (2),
//                     d opacity (g_power / opacity), d color (3), d normal (3)
//   selonly ( 2 rows) |d/dscreen x|, |d/dscreen y|: translating a surfel by o
//                     moves acr by -bcr o_x - ccr o_y and its center by o
//                     (the AbsGS selection pass)
// and writes one row per slot into out (P, rows).
//
// Design.  The forward's front (surfel_subtile.cuh): one CTA of 256 threads
// per 16 x 16 sub-tile, one pixel per thread, the tile's segment staged in
// batches with the order-preserving screen-circle skip, and each pixel's
// chain (its prefix, its T and the slots it includes) bitwise that of the
// forward.  A 32 px tile is launched as a thread-block cluster of its four
// sub-tile CTAs, which run their batches in lockstep; a 16 px tile is a
// cluster of one.  Per batch:
//   1. each CTA sums every kept slot's rows over its 256 pixels in a fixed
//      order (a reduce-scatter shuffle butterfly over each warp, which
//      leaves one row per lane, skipped with a zero partial by a warp with
//      no contribution; then the eight warp partials in warp order) into
//      its shared per-slot sums (zero for a slot it dropped);
//   2. after a cluster barrier, CTA q sums the batch's rows q/4 .. (q+1)/4
//      over the four CTAs in rank order through distributed shared memory
//      and writes each of them once.
// No atomics, so the output is bitwise the same from run to run; the
// selection scores built from it feed a top-k, where a reordered sum could
// flip a near-tied pick between two identical requests.  The per-slot sums
// are double-buffered, so one cluster barrier per batch suffices.  A CTA
// whose pixels are all done joins the barriers with zero sums; the cluster
// leaves the segment once no pixel of the tile is alive (each CTA's count of
// live pixels travels with its sums), and slots past that point keep the
// zeros the wrapper allocates.  The batch, its warp partials and the sums
// live in dynamic shared memory: `full` stages FULL_BATCH slots per round
// (its warp partials take 8 * 19 floats per slot; 64 fit the 48 KB of static
// shared memory, 256 fit only in the 227 KB a CTA may have), `selonly` 256.
//
// Bound on an H100.  Bytes are small (table, live ids, the 13 per-pixel
// cotangent and total rows and the per-slot output: tens of MB at 262,144
// surfels), so the kernel is bound by f32 operations: the forward's circle
// test per (kept slot, live pixel) and geometry per pair inside the circle,
// plus ~55 operations per contribution in selonly (~106 in full)
// (chip_smoke.py computes the bound from each run's own counts).  Every
// operation on the per-pixel chain is an explicitly rounded intrinsic (no
// FMA contraction) in the order of the plain PyTorch version in
// splat/surfel_kernels.py.  Build without --use_fast_math.

#include <cooperative_groups.h>

#include "surfel_subtile.cuh"

#ifndef SURFEL_BWD_FULL_BATCH
#define SURFEL_BWD_FULL_BATCH 128
#endif

namespace {

namespace cg = cooperative_groups;
using namespace surfel_subtile;

// 1 - ALPHA_MAX as the JAX package rounds it: the f32 nearest 0.01, not
// 1.0f - 0.99f (which is 0.00999999)
constexpr float ONE_M_FLOOR = 0.01f;
// full's slots per staged batch (tools/surfel_break.py --full-batches
// rebuilds this source with other values to time them)
constexpr int FULL_BATCH = SURFEL_BWD_FULL_BATCH;
static_assert(FULL_BATCH > 0 && FULL_BATCH <= THREADS && FULL_BATCH % 32 == 0,
              "one staging thread per slot, whole warps");

constexpr int MODE_FULL = 0;
constexpr int MODE_SELONLY = 1;

template <int MODE>
struct Mode {
  static constexpr bool FULL = MODE == MODE_FULL;
  static constexpr int W = FULL ? 19 : 2;      // output rows per slot
  static constexpr int NCOT = FULL ? 8 : 3;    // cotangent rows read
  static constexpr int NAUX = FULL ? 5 : 1;    // total rows read
  static constexpr int BATCH = FULL ? FULL_BATCH : 256;
};

// W rounded up to a power of two (at most 32).
template <int W>
struct RowsPow2 {
  static constexpr int value = W <= 1 ? 1 : 2 * RowsPow2<(W + 1) / 2>::value;
};
template <>
struct RowsPow2<1> {
  static constexpr int value = 1;
};

// One butterfly step of warp_rows_sum: each lane holds N row sums, keeps
// the lower or upper half by its lane bit O, sends the other half to lane ^
// O and adds what it receives; past one row, a plain butterfly.
template <int N, int O>
__device__ __forceinline__ void rows_step(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL_MASK, send, O));
      }
      rows_step<H, O / 2>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL_MASK, v[0], O));
      rows_step<1, O / 2>(v, lane);
    }
  }
}

// The sums of the W rows of acc over the warp's 32 lanes, in a fixed order:
// a reduce-scatter butterfly (the rows padded to NP, a power of two) that
// halves the rows each lane carries at every step, NP - 1 + 5 - log2 NP
// shuffles against 5 W for W separate trees.  Returns row lane / (32 / NP)
// (every lane of that group holds it).
template <int W>
__device__ __forceinline__ float warp_rows_sum(const float (&acc)[W], int lane) {
  constexpr int NP = RowsPow2<W>::value;
  static_assert(NP <= 32, "at most 32 rows");
  float v[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) v[i] = i < W ? acc[i] : 0.0f;
  rows_step<NP, 16>(v, lane);
  return v[0];
}

// The backward's shared memory: the staged batch, the warp partials of its
// kept slots, the CTA's per-slot sums (double-buffered, read by the whole
// cluster) and its live flag per buffer.
template <int NB, int W>
struct Shared {
  Staged<NB> s;
  float part[NWARPS][NB][W];
  float sum[2][NB * W];
  int live[2];
};

template <int TS, int MODE>
__global__ void __launch_bounds__(THREADS)
surfel_bwd_kernel(const float* __restrict__ table,
                  const int* __restrict__ sorted_ids,
                  const int* __restrict__ tile_starts,
                  const int* __restrict__ tile_counts,
                  const float* __restrict__ planes,
                  const float* __restrict__ cot8,
                  const float* __restrict__ aux5,
                  float* __restrict__ out, int tiles_x) {
  using M = Mode<MODE>;
  constexpr int NPIX = TS * TS;
  constexpr int W = M::W;
  constexpr int NB = M::BATCH;
  constexpr int SPAN = 32 / RowsPow2<W>::value;   // lanes holding one row
  constexpr int CL = Pixel<TS>::CTAS;      // the cluster: the tile's CTAs

  extern __shared__ __align__(16) unsigned char smem[];
  Shared<NB, W>& sh = *reinterpret_cast<Shared<NB, W>*>(smem);
  Staged<NB>& s = sh.s;

  const Pixel<TS> px(tiles_x);
  const int tile = px.tile;
  const float X = px.X, Y = px.Y;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float znear = planes[0];
  const float zfar = planes[1];
  const float F = __fdiv_rn(zfar, __fsub_rn(zfar, znear));
  const float Fzn = __fmul_rn(F, znear);

  // the pixel's cotangents [gC (3), gN (3), gDexp, gdist] and totals [G2,
  // gDmed, sum w, M1, M2]; selonly reads gC and G2 only
  float cot[M::NCOT], aux[M::NAUX];
  const float* ct = cot8 + static_cast<size_t>(tile) * 8 * NPIX + px.p;
  const float* at = aux5 + static_cast<size_t>(tile) * 5 * NPIX + px.p;
#pragma unroll
  for (int r = 0; r < M::NCOT; ++r) cot[r] = ct[r * NPIX];
#pragma unroll
  for (int r = 0; r < M::NAUX; ++r) aux[r] = at[r * NPIX];
  float T = 1.0f, prefix = 0.0f;
  bool alive = true;
  bool cta_alive = true;

  for (int base = 0, buf = 0; base < count; base += NB, buf ^= 1) {
    const int n = min(NB, count - base);
    float* sum = sh.sum[buf];
    // this buffer was last read by the cluster two batches ago, before the
    // barrier of the previous batch
    for (int i = threadIdx.x; i < n * W; i += THREADS) sum[i] = 0.0f;

    if (cta_alive) {
      const int kept = stage_batch<NB>(s, table, sorted_ids + start + base, n,
                                       px.x0, px.y0);
      for (int k = 0; k < kept; ++k) {
        float acc[W];
#pragma unroll
        for (int r = 0; r < W; ++r) acc[r] = 0.0f;
        bool hit = false;
        Front f;
        if (alive && front(s, k, X, Y, f)) {
          const float one_m = __fsub_rn(1.0f, f.alpha);
          const float U = __fmul_rn(T, one_m);
          if (U < T_EPS) {  // done before this slot
            alive = false;
          } else {
            hit = true;
            const float alpha = f.alpha, z = f.z, rz = f.rz;
            const float crx = f.crx, cry = f.cry;
            const float w = __fmul_rn(alpha, T);
            float cw = __fadd_rn(__fadd_rn(__fmul_rn(cot[0], s.v[CR][k]),
                                           __fmul_rn(cot[1], s.v[CG][k])),
                                 __fmul_rn(cot[2], s.v[CB][k]));
            float m = 0.0f;
            if constexpr (M::FULL) {
              m = mapped_depth(F, znear, z);
              cw = __fadd_rn(cw, __fmul_rn(cot[3], s.v[NX][k]));
              cw = __fadd_rn(cw, __fmul_rn(cot[4], s.v[NY][k]));
              cw = __fadd_rn(cw, __fmul_rn(cot[5], s.v[NZ][k]));
              cw = __fadd_rn(cw, __fmul_rn(cot[6], z));
              const float ddist = __fsub_rn(
                  __fadd_rn(aux[4], __fmul_rn(__fmul_rn(m, m), aux[2])),
                  __fmul_rn(__fmul_rn(2.0f, m), aux[3]));
              cw = __fadd_rn(cw, __fmul_rn(cot[7], ddist));
            }
            prefix = __fadd_rn(prefix, __fmul_rn(cw, w));
            const float inv_1ma = __frcp_rn(fmaxf(one_m, ONE_M_FLOOR));
            const float g_alpha = __fsub_rn(
                __fmul_rn(cw, T), __fmul_rn(__fsub_rn(aux[0], prefix), inv_1ma));
            const float g_power = alpha < ALPHA_MAX ? __fmul_rn(g_alpha, alpha) : 0.0f;
            const float g3 = f.sel3 ? g_power : 0.0f;
            const float g2 = f.sel3 ? 0.0f : g_power;
            const float rz2 = __fmul_rn(rz, rz);
            const float d_crx = __fmul_rn(__fmul_rn(-crx, rz2), g3);
            const float d_cry = __fmul_rn(__fmul_rn(-cry, rz2), g3);
            float d_crz = __fmul_rn(
                __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(crx, crx), __fmul_rn(cry, cry)),
                                    rz2), rz), g3);
            const float gx2 = __fmul_rn(__fmul_rn(g2, f.dx), 0.5f);
            const float gy2 = __fmul_rn(__fmul_rn(g2, f.dy), 0.5f);
            if constexpr (M::FULL) {
              const float gm = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, cot[7]), w),
                                         __fsub_rn(__fmul_rn(m, aux[2]), aux[3]));
              const float dmdz = __fdiv_rn(Fzn, __fmul_rn(z, z));
              const bool crossed = T > 0.5f && U < 0.5f;
              const float gz = __fadd_rn(
                  __fadd_rn(__fmul_rn(w, cot[6]), __fmul_rn(gm, dmdz)),
                  crossed ? aux[1] : 0.0f);
              d_crz = __fsub_rn(d_crz, __fmul_rn(__fmul_rn(gz, s.v[DET][k]), rz2));
              if (f.tiny) d_crz = 0.0f;
              acc[0] = d_crx;
              acc[1] = d_cry;
              acc[2] = d_crz;
              acc[3] = __fmul_rn(d_crx, X);
              acc[4] = __fmul_rn(d_cry, X);
              acc[5] = __fmul_rn(d_crz, X);
              acc[6] = __fmul_rn(d_crx, Y);
              acc[7] = __fmul_rn(d_cry, Y);
              acc[8] = __fmul_rn(d_crz, Y);
              acc[9] = __fmul_rn(gz, rz);
              acc[10] = gx2;
              acc[11] = gy2;
              acc[12] = g_power;
#pragma unroll
              for (int r = 0; r < 6; ++r) acc[13 + r] = __fmul_rn(w, cot[r]);
            } else {
              if (f.tiny) d_crz = 0.0f;
              const float gx = __fadd_rn(
                  -__fadd_rn(__fadd_rn(__fmul_rn(d_crx, s.v[BX][k]),
                                       __fmul_rn(d_cry, s.v[BY][k])),
                             __fmul_rn(d_crz, s.v[BZ][k])),
                  gx2);
              const float gy = __fadd_rn(
                  -__fadd_rn(__fadd_rn(__fmul_rn(d_crx, s.v[CX][k]),
                                       __fmul_rn(d_cry, s.v[CY][k])),
                             __fmul_rn(d_crz, s.v[CZ][k])),
                  gy2);
              acc[0] = fabsf(gx);
              acc[1] = fabsf(gy);
            }
            T = U;
          }
        }
        // fixed-order reduction over the warp's lanes (skipped, with a zero
        // partial, when no lane of the warp contributes); lane r * SPAN
        // writes row r
        const float v = __any_sync(FULL_MASK, hit) ? warp_rows_sum<W>(acc, lane) : 0.0f;
        if ((lane & (SPAN - 1)) == 0 && lane / SPAN < W) sh.part[warp][k][lane / SPAN] = v;
      }
      const int live = __syncthreads_count(alive);
      // the CTA's sum of each kept slot: the warp partials in warp order
      for (int i = threadIdx.x; i < kept * W; i += THREADS) {
        const int k = i / W;
        const int r = i - k * W;
        float v = sh.part[0][k][r];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) v = __fadd_rn(v, sh.part[w][k][r]);
        sum[s.src[k] * W + r] = v;
      }
      cta_alive = live > 0;
    }
    if (threadIdx.x == 0) sh.live[buf] = cta_alive;

    // the cluster's sums of this batch, then this CTA's share of the rows
    int any = 0;
    float* dst = out + static_cast<size_t>(start + base) * W;
    const int per = (n + CL - 1) / CL;
    const int j0 = px.q * per;
    const int j1 = min(n, j0 + per);
    const float* sums[CL];
    if constexpr (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        sums[q] = cluster.map_shared_rank(sum, q);
        any += *cluster.map_shared_rank(&sh.live[buf], q);
      }
    } else {
      __syncthreads();
      sums[0] = sum;
      any = sh.live[buf];
    }
    for (int i = j0 * W + threadIdx.x; i < j1 * W; i += THREADS) {
      float v = sums[0][i];
#pragma unroll
      for (int q = 1; q < CL; ++q) v = __fadd_rn(v, sums[q][i]);
      const int j = i / W;
      if (M::FULL && i - j * W == OPA) {
        const float opa =
            table[static_cast<size_t>(sorted_ids[start + base + j]) * ROW + OPA];
        v = __fdiv_rn(v, fmaxf(opa, 1e-12f));
      }
      dst[i] = v;
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
           const int* tile_counts, const float* planes, const float* cot8,
           const float* aux5, float* out, int num_tiles, int tiles_x,
           cudaStream_t st) {
  using M = Mode<MODE>;
  constexpr int CL = Pixel<TS>::CTAS;
  constexpr size_t SMEM = sizeof(Shared<M::BATCH, M::W>);
  auto* kernel = surfel_bwd_kernel<TS, MODE>;
  if (SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_tiles * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, table, sorted_ids, tile_starts, tile_counts, planes, cot8,
      aux5, out, tiles_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const float* table, const int* sorted_ids,
                const int* tile_starts, const int* tile_counts,
                const float* planes, const float* cot8, const float* aux5,
                float* out, int num_tiles, int tiles_x, int tile_size,
                cudaStream_t st) {
  if (tile_size == 16)
    return launch<16, MODE>(table, sorted_ids, tile_starts, tile_counts, planes,
                            cot8, aux5, out, num_tiles, tiles_x, st);
  if (tile_size == 32)
    return launch<32, MODE>(table, sorted_ids, tile_starts, tile_counts, planes,
                            cot8, aux5, out, num_tiles, tiles_x, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table (N, 24) f32 row-major, 16-byte aligned; sorted_ids (P,) i32;
// tile_starts / tile_counts (num_tiles,) i32 with counts already clamped;
// planes (2,) f32 [znear, zfar]; cot8 (num_tiles, 8, ts*ts) f32 rows gC (3),
// gN (3), gDexp, gdist; aux5 (num_tiles, 5, ts*ts) f32 rows G2, gDmed, sum w,
// M1, M2; out (P, rows) f32, zero-filled by the caller, rows = 19 / 2 for
// mode 0 (full) / 1 (selonly).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int gd_surfel_bwd(const float* table, const int* sorted_ids,
                             const int* tile_starts, const int* tile_counts,
                             const float* planes, const float* cot8,
                             const float* aux5, float* out, int num_tiles,
                             int tiles_x, int tile_size, int mode, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_FULL:
      return launch_mode<MODE_FULL>(table, sorted_ids, tile_starts, tile_counts,
                                    planes, cot8, aux5, out, num_tiles, tiles_x,
                                    tile_size, st);
    case MODE_SELONLY:
      return launch_mode<MODE_SELONLY>(table, sorted_ids, tile_starts,
                                       tile_counts, planes, cot8, aux5, out,
                                       num_tiles, tiles_x, tile_size, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
