// The body of the 2DGS surfel forward compositor, templated on a stage,
// shared by the production kernel (csrc/surfel_fwd.cu) and its stage probes
// (csrc/surfel_fwd_probe.cu).
//
// The production instantiation is surfel_fwd_kernel<TS> (STAGE = FULL):
// each `if constexpr` below then keeps exactly the production statements,
// so that the production kernel compiles to the same machine code as before
// the probes existed (tools/sass_check.py checks this against a parent's
// sources).  Anyone editing this file edits the production kernel: keep the
// production path's statements and their order.
//
// The probes switch stages off, as the JAX package's
// scripts/dev_surfel_break.py does; each stripped stage writes a defined
// per-pixel quantity (its plain version is splat/probe_kernels.py).  Every
// stage writes all 13 rows from its registers, so a row the stage does not
// reach keeps its initial value (0, and T = 1 in row 12):
//   NOOP   no input read
//   LOAD   the production staging; row 0, pixel p < 256: the sum of the 20
//          staged values (rad squared) of the slot at lane p over all batches
//   ALPHA  + the circle test, the ray-plane cross product, 1/cr_z, the
//          power, exp, opacity and the 1/255 cull, no z; row 0: sum of alpha
//   GEOMD  + z = det / cr_z, the z > 0.2 cull and the mapped depth m; row 0:
//          sum of alpha over the pairs that pass both culls, row 1: sum of m
//   TRANS  + the transmittance chain and the stops; row 12 = T_final
//          (bitwise production)
//   ACC    + the color and normal rows and sum w (rows 0-5, 9 and 12
//          bitwise production)
//   FULL   + expected and median depth, the moments and the distortion: the
//          production kernel

#pragma once

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

enum Stage : int { NOOP, LOAD, ALPHA, GEOMD, TRANS, ACC, FULL };

template <int TS, int STAGE = FULL>
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

  if constexpr (STAGE != NOOP) {   // NOOP: the loads above are unused
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

    if constexpr (STAGE == LOAD) {
      if (threadIdx.x < n) {
        const int t = threadIdx.x;
        float v = s[0][t];
#pragma unroll
        for (int q = 1; q < NV; ++q) v = __fadd_rn(v, s[q][t]);
        acc[0][0] = __fadd_rn(acc[0][0], v);
      }
    } else {
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
        const float z = __fmul_rn(s[DET][j], rz);   // unused by ALPHA
        const float alpha = fminf(ALPHA_MAX, __fmul_rn(s[OPA][j], expf(power)));
        if constexpr (STAGE == ALPHA) {
          if (!(alpha >= ALPHA_MIN)) continue;
          acc[0][i] = __fadd_rn(acc[0][i], alpha);
        } else {
        if (!(alpha >= ALPHA_MIN) || !(z > NEAR_CULL)) continue;
        if constexpr (STAGE == GEOMD) {
          acc[0][i] = __fadd_rn(acc[0][i], alpha);
          acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(
              F, __fsub_rn(1.0f, __fdiv_rn(znear, fmaxf(z, 1e-6f)))));
        } else {
        const float U = __fmul_rn(T[i], __fsub_rn(1.0f, alpha));
        if (U < T_EPS) {  // done before this slot
          alive[i] = false;
          continue;
        }
        if constexpr (STAGE == FULL) {
        if (T[i] > 0.5f && U < 0.5f) dmed[i] = z;   // the median crossing
        }
        if constexpr (STAGE >= ACC) {
        const float w = __fmul_rn(alpha, T[i]);
#pragma unroll
        for (int r = 0; r < 6; ++r)
          acc[r][i] = __fadd_rn(acc[r][i], __fmul_rn(w, s[CR + r][j]));
        if constexpr (STAGE == FULL) {
        dexp[i] = __fadd_rn(dexp[i], __fmul_rn(w, z));
        const float m = __fmul_rn(
            F, __fsub_rn(1.0f, __fdiv_rn(znear, fmaxf(z, 1e-6f))));
        const float wm = __fmul_rn(w, m);
        wsum[i] = __fadd_rn(wsum[i], w);
        m1[i] = __fadd_rn(m1[i], wm);
        m2[i] = __fadd_rn(m2[i], __fmul_rn(wm, m));
        } else {
        wsum[i] = __fadd_rn(wsum[i], w);
        }
        }
        T[i] = U;
        }
        }
      }
    }
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
