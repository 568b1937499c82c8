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
// Design.  The compositing backward's (composite_bwd.cu): one CTA per tile,
// 256 threads, the forward kernel's pixel layout and staging (each slot's
// 96-byte row gathered through sorted_ids into shared memory).  Every slot
// belongs to exactly one tile, so a slot's row is owned by one CTA and written
// once: no atomics.  The per-slot sum over the tile's pixels is taken in a
// fixed order (each thread over its pixels, a warp shuffle tree, then the
// eight warp partials added in warp order from shared memory), so the output
// is bitwise the same from run to run; the selection scores built from it
// feed a top-k.  A warp whose lanes have no contribution for a slot skips its
// shuffles.  The warp partials take 8 * BATCH * rows floats of shared memory,
// so a batch is 256 slots in selonly and 64 in full.  The block leaves the
// segment once every pixel is done (__syncthreads_count); slots past that
// point are never written and keep the zeros the wrapper allocates.
//
// Bound on an H100.  Bytes are small (table, live ids, the 13 per-pixel
// cotangent and total rows and the per-slot output: tens of MB at 262,144
// surfels), so the kernel is bound by f32 operations: the forward's circle
// test and geometry per (slot, live pixel) plus ~45 operations per
// contribution in selonly (~100 in full) (chip_smoke.py computes the bound
// from each run's own counts).  Every operation on the per-pixel chain is an
// explicitly rounded intrinsic (no FMA contraction) in the order of the plain
// PyTorch version in splat/surfel_kernels.py.  Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ROW = 24;         // table row (96 bytes), see surfel_kernels.py
constexpr int NV = 20;          // live attributes of a row
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float NEAR_CULL = 0.2f;
// 1 - ALPHA_MAX as the JAX package rounds it: the f32 nearest 0.01, not
// 1.0f - 0.99f (which is 0.00999999)
constexpr float ONE_M_FLOOR = 0.01f;
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int MODE_FULL = 0;
constexpr int MODE_SELONLY = 1;

enum { AX, AY, AZ, BX, BY, BZ, CX, CY, CZ, DET, PX, PY, OPA, CR, CG, CB, NX, NY,
       NZ, RAD };

template <int MODE>
struct Mode {
  static constexpr bool FULL = MODE == MODE_FULL;
  static constexpr int W = FULL ? 19 : 2;      // output rows per slot
  static constexpr int NCOT = FULL ? 8 : 3;    // cotangent rows read
  static constexpr int NAUX = FULL ? 5 : 1;    // total rows read
  // slots staged per round: the warp partials take NWARPS * BATCH * W floats
  static constexpr int BATCH = FULL ? 64 : 256;
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
  constexpr int PPT = NPIX / THREADS;
  constexpr int W = M::W;
  constexpr int BATCH = M::BATCH;
  static_assert(PPT * THREADS == NPIX, "tile must be a multiple of 256 px");
  static_assert(BATCH <= THREADS, "one staging thread per slot");

  __shared__ float s[NV][BATCH];   // row RAD holds rad * rad
  __shared__ float s_part[NWARPS][BATCH][W];

  const int tile = blockIdx.x;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const int ox = (tile % tiles_x) * TS;
  const int oy = (tile / tiles_x) * TS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float znear = planes[0];
  const float zfar = planes[1];
  const float F = __fdiv_rn(zfar, __fsub_rn(zfar, znear));
  const float Fzn = __fmul_rn(F, znear);

  // per-pixel cotangents [gC (3), gN (3), gDexp, gdist] and totals [G2,
  // gDmed, sum w, M1, M2]; selonly reads gC and G2 only
  float X[PPT], Y[PPT], T[PPT], prefix[PPT], cot[M::NCOT][PPT], aux[M::NAUX][PPT];
  bool alive[PPT];
  const float* ct = cot8 + static_cast<size_t>(tile) * 8 * NPIX;
  const float* at = aux5 + static_cast<size_t>(tile) * 5 * NPIX;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    X[i] = static_cast<float>(ox + p % TS);
    Y[i] = static_cast<float>(oy + p / TS);
    T[i] = 1.0f;
    prefix[i] = 0.0f;
    alive[i] = true;
#pragma unroll
    for (int r = 0; r < M::NCOT; ++r) cot[r][i] = ct[r * NPIX + p];
#pragma unroll
    for (int r = 0; r < M::NAUX; ++r) aux[r][i] = at[r * NPIX + p];
  }

  for (int base = 0; base < count; base += BATCH) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    // barrier: the previous batch's slots and partials are fully read
    if (__syncthreads_count(any) == 0) break;

    const int n = min(BATCH, count - base);
    if (threadIdx.x < n) {
      const int t = threadIdx.x;
      const int g = sorted_ids[start + base + t];
      const float4* row =
          reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * ROW);
#pragma unroll
      for (int q = 0; q < NV / 4; ++q) {
        const float4 v = row[q];
        s[4 * q][t] = v.x;
        s[4 * q + 1][t] = v.y;
        s[4 * q + 2][t] = v.z;
        s[4 * q + 3][t] = v.w;
      }
      s[RAD][t] = __fmul_rn(s[RAD][t], s[RAD][t]);
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float px = s[PX][j], py = s[PY][j], rad2 = s[RAD][j];
      float acc[W];
#pragma unroll
      for (int r = 0; r < W; ++r) acc[r] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!alive[i]) continue;
        const float dx = __fsub_rn(X[i], px);
        const float dy = __fsub_rn(Y[i], py);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (!(d2 <= rad2)) continue;
        const float crx = __fadd_rn(__fadd_rn(s[AX][j], __fmul_rn(X[i], s[BX][j])),
                                    __fmul_rn(Y[i], s[CX][j]));
        const float cry = __fadd_rn(__fadd_rn(s[AY][j], __fmul_rn(X[i], s[BY][j])),
                                    __fmul_rn(Y[i], s[CY][j]));
        const float crz = __fadd_rn(__fadd_rn(s[AZ][j], __fmul_rn(X[i], s[BZ][j])),
                                    __fmul_rn(Y[i], s[CZ][j]));
        const bool tiny = fabsf(crz) < 1e-8f;
        const float rz = __fdiv_rn(1.0f, tiny ? 1e-8f : crz);
        const float u = __fmul_rn(crx, rz);
        const float v = __fmul_rn(cry, rz);
        const float g3d = __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)));
        const float g2d = __fmul_rn(-0.25f, d2);
        const bool sel3 = g3d >= g2d;
        const float power = sel3 ? g3d : g2d;
        const float z = __fmul_rn(s[DET][j], rz);
        const float alpha = fminf(ALPHA_MAX, __fmul_rn(s[OPA][j], expf(power)));
        if (!(alpha >= ALPHA_MIN) || !(z > NEAR_CULL)) continue;
        const float one_m = __fsub_rn(1.0f, alpha);
        const float U = __fmul_rn(T[i], one_m);
        if (U < T_EPS) {  // done before this slot
          alive[i] = false;
          continue;
        }
        hit = true;
        const float w = __fmul_rn(alpha, T[i]);
        float cw = __fadd_rn(__fadd_rn(__fmul_rn(cot[0][i], s[CR][j]),
                                       __fmul_rn(cot[1][i], s[CG][j])),
                             __fmul_rn(cot[2][i], s[CB][j]));
        float m = 0.0f;
        if constexpr (M::FULL) {
          m = __fmul_rn(F, __fsub_rn(1.0f, __fdiv_rn(znear, fmaxf(z, 1e-6f))));
          cw = __fadd_rn(cw, __fmul_rn(cot[3][i], s[NX][j]));
          cw = __fadd_rn(cw, __fmul_rn(cot[4][i], s[NY][j]));
          cw = __fadd_rn(cw, __fmul_rn(cot[5][i], s[NZ][j]));
          cw = __fadd_rn(cw, __fmul_rn(cot[6][i], z));
          const float ddist = __fsub_rn(
              __fadd_rn(aux[4][i], __fmul_rn(__fmul_rn(m, m), aux[2][i])),
              __fmul_rn(__fmul_rn(2.0f, m), aux[3][i]));
          cw = __fadd_rn(cw, __fmul_rn(cot[7][i], ddist));
        }
        prefix[i] = __fadd_rn(prefix[i], __fmul_rn(cw, w));
        const float inv_1ma = __fdiv_rn(1.0f, fmaxf(one_m, ONE_M_FLOOR));
        const float g_alpha = __fsub_rn(__fmul_rn(cw, T[i]),
                                        __fmul_rn(__fsub_rn(aux[0][i], prefix[i]),
                                                  inv_1ma));
        const float g_power = alpha < ALPHA_MAX ? __fmul_rn(g_alpha, alpha) : 0.0f;
        const float g3 = sel3 ? g_power : 0.0f;
        const float g2 = sel3 ? 0.0f : g_power;
        const float rz2 = __fmul_rn(rz, rz);
        const float d_crx = __fmul_rn(__fmul_rn(-crx, rz2), g3);
        const float d_cry = __fmul_rn(__fmul_rn(-cry, rz2), g3);
        float d_crz = __fmul_rn(
            __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(crx, crx), __fmul_rn(cry, cry)),
                                rz2), rz), g3);
        const float gx2 = __fmul_rn(__fmul_rn(g2, dx), 0.5f);
        const float gy2 = __fmul_rn(__fmul_rn(g2, dy), 0.5f);
        if constexpr (M::FULL) {
          const float gm = __fmul_rn(
              __fmul_rn(__fmul_rn(2.0f, cot[7][i]), w),
              __fsub_rn(__fmul_rn(m, aux[2][i]), aux[3][i]));
          const float dmdz = __fdiv_rn(Fzn, __fmul_rn(z, z));
          const bool crossed = T[i] > 0.5f && U < 0.5f;
          const float gz = __fadd_rn(
              __fadd_rn(__fmul_rn(w, cot[6][i]), __fmul_rn(gm, dmdz)),
              crossed ? aux[1][i] : 0.0f);
          d_crz = __fsub_rn(d_crz, __fmul_rn(__fmul_rn(gz, s[DET][j]), rz2));
          if (tiny) d_crz = 0.0f;
          const float vals[W] = {
              d_crx, d_cry, d_crz,
              __fmul_rn(d_crx, X[i]), __fmul_rn(d_cry, X[i]), __fmul_rn(d_crz, X[i]),
              __fmul_rn(d_crx, Y[i]), __fmul_rn(d_cry, Y[i]), __fmul_rn(d_crz, Y[i]),
              __fmul_rn(gz, rz), gx2, gy2, g_power,
              __fmul_rn(w, cot[0][i]), __fmul_rn(w, cot[1][i]), __fmul_rn(w, cot[2][i]),
              __fmul_rn(w, cot[3][i]), __fmul_rn(w, cot[4][i]), __fmul_rn(w, cot[5][i])};
#pragma unroll
          for (int r = 0; r < W; ++r) acc[r] = __fadd_rn(acc[r], vals[r]);
        } else {
          if (tiny) d_crz = 0.0f;
          const float gx = __fadd_rn(
              -__fadd_rn(__fadd_rn(__fmul_rn(d_crx, s[BX][j]), __fmul_rn(d_cry, s[BY][j])),
                         __fmul_rn(d_crz, s[BZ][j])),
              gx2);
          const float gy = __fadd_rn(
              -__fadd_rn(__fadd_rn(__fmul_rn(d_crx, s[CX][j]), __fmul_rn(d_cry, s[CY][j])),
                         __fmul_rn(d_crz, s[CZ][j])),
              gy2);
          acc[0] = __fadd_rn(acc[0], fabsf(gx));
          acc[1] = __fadd_rn(acc[1], fabsf(gy));
        }
        T[i] = U;
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
        for (int r = 0; r < W; ++r) s_part[warp][j][r] = acc[r];
      }
    }
    __syncthreads();

    // sum the warp partials in warp order and write each slot's row once
    float* dst = out + static_cast<size_t>(start + base) * W;
    for (int idx = threadIdx.x; idx < n * W; idx += THREADS) {
      const int j = idx / W;
      const int r = idx - j * W;
      float sum = s_part[0][j][r];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) sum = __fadd_rn(sum, s_part[w][j][r]);
      if (M::FULL && r == OPA) sum = __fdiv_rn(sum, fmaxf(s[OPA][j], 1e-12f));
      dst[idx] = sum;
    }
  }
}

template <int MODE>
int launch(const float* table, const int* sorted_ids, const int* tile_starts,
           const int* tile_counts, const float* planes, const float* cot8,
           const float* aux5, float* out, int num_tiles, int tiles_x,
           int tile_size, cudaStream_t st) {
  if (tile_size == 16) {
    surfel_bwd_kernel<16, MODE><<<num_tiles, THREADS, 0, st>>>(
        table, sorted_ids, tile_starts, tile_counts, planes, cot8, aux5, out,
        tiles_x);
  } else if (tile_size == 32) {
    surfel_bwd_kernel<32, MODE><<<num_tiles, THREADS, 0, st>>>(
        table, sorted_ids, tile_starts, tile_counts, planes, cot8, aux5, out,
        tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
      return launch<MODE_FULL>(table, sorted_ids, tile_starts, tile_counts,
                               planes, cot8, aux5, out, num_tiles, tiles_x,
                               tile_size, st);
    case MODE_SELONLY:
      return launch<MODE_SELONLY>(table, sorted_ids, tile_starts, tile_counts,
                                  planes, cot8, aux5, out, num_tiles, tiles_x,
                                  tile_size, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
