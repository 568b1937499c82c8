// 2DGS surfel forward compositor for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel `pallas_surfel_fwd` / `_fwd_kernel` of
// generativedensification_tpu/splat/pallas_surfel.py, with the semantics of
// the JAX package's `_xla_scan_fwd` (splat/surfel.py): per tile, walk the
// tile's depth-sorted segment front to back and, per pixel (X, Y) in global
// coordinates,
//   cr    = acr + X bcr + Y ccr            (the ray-plane cross product)
//   rz    = 1 / cr_z  (cr_z replaced by 1e-8 where |cr_z| < 1e-8)
//   power = max(-1/2 ((cr_x rz)^2 + (cr_y rz)^2), -1/4 |(X, Y) - center|^2)
//   z     = det rz
//   alpha = min(0.99, opacity exp(power)), skipped below 1/255, at z <= 0.2
//           and outside the circle |(X, Y) - center| <= rad
//   a pixel stops before the slot whose U = T (1 - alpha) < 1e-4
// and accumulate color, view normal, expected depth, the median depth (z at
// the slot where T crosses 0.5), and the moments sum w, sum w m, sum w m^2 of
// the mapped depth m = zfar/(zfar - znear) (1 - znear/z), from which the
// distortion is the closed form dist = sum w * sum w m^2 - (sum w m)^2.
//
// Design.  The forward compositor's (composite_fwd.cu): one CTA per tile, 256
// threads, ts*ts/256 pixels per thread.  The CTA stages BATCH slots of its
// segment in shared memory (each thread loads one slot's id from sorted_ids
// and gathers that surfel's 96-byte row, five 16-byte loads); the table of
// 262,144 surfels is 25 MB and stays in the 50 MB L2 cache.  The block leaves
// the segment as soon as every pixel is done (__syncthreads_count).  The
// circle test comes first: it is the cheapest and culls most (slot, pixel)
// pairs before the division and the exponential.
//
// Bound on an H100.  The bytes are small (the table read once, the live ids,
// the 13-row output: ~45 MB at 262,144 surfels in a 512^2 view, ~0.014 ms at
// 3.35 TB/s).  The work is a 6-operation circle test per (slot, live pixel),
// ~30 more operations inside the circle and ~30 per contribution, so the
// kernel is bound by f32 operations (chip_smoke.py computes the bound from
// each run's own counts).  No tensor cores: every operation on the path from
// the coefficients to the accumulators is an explicitly rounded intrinsic (no
// FMA contraction) in the same order as the plain PyTorch version in
// splat/surfel_kernels.py, so the two agree to the last bit wherever expf
// agrees.  Build without --use_fast_math: approximate exp, flushed denormals
// or approximate division would move the alpha >= 1/255, z > 0.2, circle and
// T < 1e-4 edges.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BATCH = 256;      // slots staged per round, one per thread
constexpr int ROW = 24;         // table row (96 bytes), see surfel_kernels.py
constexpr int NV = 20;          // live attributes of a row
constexpr int OUT_ROWS = 13;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float NEAR_CULL = 0.2f;

// attribute rows of the table and of the shared-memory batch
enum { AX, AY, AZ, BX, BY, BZ, CX, CY, CZ, DET, PX, PY, OPA, CR, CG, CB, NX, NY,
       NZ, RAD };

template <int TS>
__global__ void __launch_bounds__(THREADS)
surfel_fwd_kernel(const float* __restrict__ table,
                  const int* __restrict__ sorted_ids,
                  const int* __restrict__ tile_starts,
                  const int* __restrict__ tile_counts,
                  const float* __restrict__ planes,
                  float* __restrict__ out, int tiles_x) {
  constexpr int NPIX = TS * TS;
  constexpr int PPT = NPIX / THREADS;
  static_assert(PPT * THREADS == NPIX, "tile must be a multiple of 256 px");

  __shared__ float s[NV][BATCH];   // row RAD holds rad * rad

  const int tile = blockIdx.x;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const int ox = (tile % tiles_x) * TS;
  const int oy = (tile / tiles_x) * TS;
  const float znear = planes[0];
  const float zfar = planes[1];
  const float F = __fdiv_rn(zfar, __fsub_rn(zfar, znear));

  float X[PPT], Y[PPT], T[PPT], acc[6][PPT], dexp[PPT], dmed[PPT], wsum[PPT],
      m1[PPT], m2[PPT];
  bool alive[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    X[i] = static_cast<float>(ox + p % TS);
    Y[i] = static_cast<float>(oy + p / TS);
    T[i] = 1.0f;
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[r][i] = 0.0f;
    dexp[i] = dmed[i] = wsum[i] = m1[i] = m2[i] = 0.0f;
    alive[i] = true;
  }

  for (int base = 0; base < count; base += BATCH) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) any |= alive[i];
    // barrier: the previous batch is fully read before it is overwritten
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
        const float safe = fabsf(crz) < 1e-8f ? 1e-8f : crz;
        const float rz = __fdiv_rn(1.0f, safe);
        const float u = __fmul_rn(crx, rz);
        const float v = __fmul_rn(cry, rz);
        const float g3d = __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)));
        const float g2d = __fmul_rn(-0.25f, d2);
        const float power = g3d >= g2d ? g3d : g2d;
        const float z = __fmul_rn(s[DET][j], rz);
        const float alpha = fminf(ALPHA_MAX, __fmul_rn(s[OPA][j], expf(power)));
        if (!(alpha >= ALPHA_MIN) || !(z > NEAR_CULL)) continue;
        const float U = __fmul_rn(T[i], __fsub_rn(1.0f, alpha));
        if (U < T_EPS) {  // done before this slot
          alive[i] = false;
          continue;
        }
        if (T[i] > 0.5f && U < 0.5f) dmed[i] = z;   // the median crossing
        const float w = __fmul_rn(alpha, T[i]);
#pragma unroll
        for (int r = 0; r < 6; ++r)
          acc[r][i] = __fadd_rn(acc[r][i], __fmul_rn(w, s[CR + r][j]));
        dexp[i] = __fadd_rn(dexp[i], __fmul_rn(w, z));
        const float m = __fmul_rn(
            F, __fsub_rn(1.0f, __fdiv_rn(znear, fmaxf(z, 1e-6f))));
        const float wm = __fmul_rn(w, m);
        wsum[i] = __fadd_rn(wsum[i], w);
        m1[i] = __fadd_rn(m1[i], wm);
        m2[i] = __fadd_rn(m2[i], __fmul_rn(wm, m));
        T[i] = U;
      }
    }
  }

  float* o = out + static_cast<size_t>(tile) * OUT_ROWS * NPIX;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
#pragma unroll
    for (int r = 0; r < 6; ++r) o[r * NPIX + p] = acc[r][i];
    o[6 * NPIX + p] = dexp[i];
    o[7 * NPIX + p] = dmed[i];
    o[8 * NPIX + p] = __fsub_rn(__fmul_rn(wsum[i], m2[i]), __fmul_rn(m1[i], m1[i]));
    o[9 * NPIX + p] = wsum[i];
    o[10 * NPIX + p] = m1[i];
    o[11 * NPIX + p] = m2[i];
    o[12 * NPIX + p] = T[i];
  }
}

}  // namespace

// table (N, 24) f32 row-major, 16-byte aligned; sorted_ids (P,) i32;
// tile_starts / tile_counts (num_tiles,) i32 with counts already clamped;
// planes (2,) f32 [znear, zfar]; out (num_tiles, 13, ts*ts) f32 rows r, g, b,
// nx, ny, nz, expected depth, median depth, dist, sum w, M1, M2, T_final.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gd_surfel_fwd(const float* table, const int* sorted_ids,
                             const int* tile_starts, const int* tile_counts,
                             const float* planes, float* out, int num_tiles,
                             int tiles_x, int tile_size, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_size == 16) {
    surfel_fwd_kernel<16><<<num_tiles, THREADS, 0, st>>>(
        table, sorted_ids, tile_starts, tile_counts, planes, out, tiles_x);
  } else if (tile_size == 32) {
    surfel_fwd_kernel<32><<<num_tiles, THREADS, 0, st>>>(
        table, sorted_ids, tile_starts, tile_counts, planes, out, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
