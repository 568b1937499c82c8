// The body of the 3DGS forward compositor, templated on a stage and on its
// launch shape, shared by the production kernel (csrc/composite_fwd.cu) and
// its stage probes (csrc/composite_fwd_probe.cu).
//
// The production instantiation is composite_fwd_kernel<TS> with every other
// parameter at its default: each `if constexpr` below then keeps exactly the
// production statements, so that the production kernel compiles to the same
// machine code as before the probes existed (tools/sass_check.py checks
// this against a parent's sources).  Anyone editing this file edits the
// production kernel: keep the production path's statements and their order.
//
// The probes switch stages off, as the JAX package's
// scripts/dev_kernel_break.py does, but each stripped stage writes a defined
// per-pixel quantity (its plain version is splat/probe_kernels.py), so that
// nvcc cannot drop the stage's work and a wrong probe is caught:
//   NOOP   no input read; rows 0-4 zero
//   LOAD   the production staging (ids, 48-byte row gathers, shared memory,
//          barriers); row 0, pixel p < 256: the sum of the ten staged values
//          of the slot at lane p over all batches (the checksum)
//   POWER  + the power form of every (slot, pixel); row 0: sum of power.
//          No stop: T never moves
//   ALPHA  + exp, opacity, the 0.99 clamp and the 1/255 cull; row 0: sum of
//          the alphas that pass the cull
//   TRANS  + the transmittance chain and the per-pixel and per-tile stops;
//          row 4 = 1 - T_final (bitwise production), rows 0-3 zero
//   TRIPS  TRANS, and per tile the executed and the assigned staging
//          batches in rows 0 and 1 (every pixel of the tile)
//   FULL   + the color and depth accumulation: the production kernel
// and the launch shape: NB slots staged per batch (production 256), TPB
// tiles composited in turn by one CTA (production 1), EXIT (the CTA leaves
// its segment once every pixel is done; without it only the per-pixel stops
// remain), BULK (the tile's 5 x ts^2 outputs staged in shared memory and
// written by one bulk asynchronous copy, which with TPB > 1 overlaps the
// next tile's compositing).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BATCH = 256;     // slots staged per round, one per thread
constexpr int ROW = 12;        // table row: x y a b | c opa r g | b z valid -
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

enum Stage : int { NOOP, LOAD, POWER, ALPHA, TRANS, TRIPS, FULL };

// 1-D bulk copy shared -> global (Hopper's asynchronous copy engine): the
// issuing thread commits it as one bulk group and must wait for the group
// to finish reading shared memory before the buffer is written again.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  const unsigned long long g =
      static_cast<unsigned long long>(__cvta_generic_to_global(dst));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(g), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the generic-proxy writes of this thread to shared memory become visible
// to the asynchronous proxy (the bulk copy)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int TS, int STAGE = FULL, int NB = BATCH, int TPB = 1,
          bool EXIT = true, bool BULK = false>
__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ sorted_ids,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     float* __restrict__ out, int tiles_x) {
  constexpr int NPIX = TS * TS;
  constexpr int PPT = NPIX / THREADS;
  static_assert(PPT * THREADS == NPIX, "tile must be a multiple of 256 px");
  static_assert(NB <= THREADS, "one staged slot per thread");

  __shared__ float s_x[NB], s_y[NB], s_a[NB], s_b[NB],
      s_c[NB], s_o[NB], s_r[NB], s_g[NB], s_bl[NB], s_z[NB];

  for (int k = 0; k < TPB; ++k) {
  const int tile = blockIdx.x * TPB + k;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];
  const float ox = static_cast<float>((tile % tiles_x) * TS);
  const float oy = static_cast<float>((tile / tiles_x) * TS);

  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT], dz[PPT];
  bool alive[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    px[i] = static_cast<float>(p % TS);
    py[i] = static_cast<float>(p / TS);
    T[i] = 1.0f;
    cr[i] = cg[i] = cb[i] = dz[i] = 0.0f;
    alive[i] = true;
  }

  if constexpr (STAGE != NOOP) {   // NOOP: the loads above are dead code
  [[maybe_unused]] int trips = 0;

  for (int base = 0; base < count; base += NB) {
    if constexpr (EXIT) {
      int any = 0;
#pragma unroll
      for (int i = 0; i < PPT; ++i) any |= alive[i];
      // barrier: the previous batch is fully read before it is overwritten
      if (__syncthreads_count(any) == 0) break;
    } else {
      __syncthreads();
    }
    if constexpr (STAGE == TRIPS) ++trips;

    const int n = min(NB, count - base);
    if (threadIdx.x < n) {
      const int t = threadIdx.x;
      const int g = sorted_ids[start + base + t];
      const float4* row =
          reinterpret_cast<const float4*>(table + static_cast<size_t>(g) * ROW);
      const float4 r0 = row[0], r1 = row[1], r2 = row[2];
      s_x[t] = __fsub_rn(r0.x, ox);      // tile-local center
      s_y[t] = __fsub_rn(r0.y, oy);
      s_a[t] = r0.z;
      s_b[t] = r0.w;
      s_c[t] = r1.x;
      s_o[t] = r2.z > 0.0f ? r1.y : 0.0f;  // valid flag folded into opacity
      s_r[t] = r1.z;
      s_g[t] = r1.w;
      s_bl[t] = r2.x;
      s_z[t] = r2.y;
    }
    __syncthreads();

    if constexpr (STAGE == LOAD) {
      if (threadIdx.x < n) {
        const int t = threadIdx.x;
        float v = __fadd_rn(s_x[t], s_y[t]);
        v = __fadd_rn(v, s_a[t]);
        v = __fadd_rn(v, s_b[t]);
        v = __fadd_rn(v, s_c[t]);
        v = __fadd_rn(v, s_o[t]);
        v = __fadd_rn(v, s_r[t]);
        v = __fadd_rn(v, s_g[t]);
        v = __fadd_rn(v, s_bl[t]);
        v = __fadd_rn(v, s_z[t]);
        cr[0] = __fadd_rn(cr[0], v);
      }
    } else {
    for (int j = 0; j < n; ++j) {
      const float gx = s_x[j], gy = s_y[j];
      const float a = s_a[j], b = s_b[j], c = s_c[j], opa = s_o[j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!alive[i]) continue;
        const float dx = __fsub_rn(px[i], gx);
        const float dy = __fsub_rn(py[i], gy);
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                  __fmul_rn(__fmul_rn(c, dy), dy));
        const float power = fminf(
            __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy)),
            0.0f);
        if constexpr (STAGE == POWER) {
          cr[i] = __fadd_rn(cr[i], power);
        } else {
        const float alpha = fminf(ALPHA_MAX, __fmul_rn(opa, expf(power)));
        if (alpha < ALPHA_MIN) continue;
        if constexpr (STAGE == ALPHA) {
          cr[i] = __fadd_rn(cr[i], alpha);
        } else {
        const float U = __fmul_rn(T[i], __fsub_rn(1.0f, alpha));
        if (U < T_EPS) {  // done before this gaussian
          alive[i] = false;
          continue;
        }
        if constexpr (STAGE == FULL) {
        const float w = __fmul_rn(alpha, T[i]);
        cr[i] = __fadd_rn(cr[i], __fmul_rn(w, s_r[j]));
        cg[i] = __fadd_rn(cg[i], __fmul_rn(w, s_g[j]));
        cb[i] = __fadd_rn(cb[i], __fmul_rn(w, s_bl[j]));
        dz[i] = __fadd_rn(dz[i], __fmul_rn(w, s_z[j]));
        }
        T[i] = U;
        }
        }
      }
    }
    }
  }

  if constexpr (STAGE == TRIPS) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      cr[i] = static_cast<float>(trips);
      cg[i] = static_cast<float>((count + NB - 1) / NB);
    }
  }
  }

  if constexpr (BULK) {
    __shared__ __align__(128) float s_out[5 * NPIX];
    if (k > 0) {   // the previous tile's copy has read s_out
      if (threadIdx.x == 0) bulk_wait_read();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = threadIdx.x + i * THREADS;
      s_out[p] = cr[i];
      s_out[NPIX + p] = cg[i];
      s_out[2 * NPIX + p] = cb[i];
      s_out[3 * NPIX + p] = dz[i];
      s_out[4 * NPIX + p] = __fsub_rn(1.0f, T[i]);
    }
    fence_proxy_async_shared();
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_store(out + static_cast<size_t>(tile) * 5 * NPIX, s_out,
                 5 * NPIX * sizeof(float));
  } else {
  float* o = out + static_cast<size_t>(tile) * 5 * NPIX;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * THREADS;
    o[p] = cr[i];
    o[NPIX + p] = cg[i];
    o[2 * NPIX + p] = cb[i];
    o[3 * NPIX + p] = dz[i];
    o[4 * NPIX + p] = __fsub_rn(1.0f, T[i]);
  }
  }
  }

  if constexpr (BULK) {   // shared memory stays until the last copy read it
    if (threadIdx.x == 0) bulk_wait_read();
  }
}

}  // namespace
