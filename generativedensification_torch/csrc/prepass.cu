// The renders' pre-pass for Hopper (sm_90a), plain C interface for ctypes:
// the 3DGS projection (splat/projection.py) and the tile binning that the
// 3DGS and 2DGS renderers share (splat/binning.py), in four kernels.
//
// Replaces no TPU kernel: the JAX package leaves project_gaussians and
// bin_gaussians to XLA, which fuses each op chain into a few loops.  Eager
// PyTorch ran the same chains as ~200 launches a view, each ~20 us of host
// dispatch for well under 1 us of work, so the renders waited on the host's
// launches and not on the card.  These kernels were added for the launch
// count: a view's pre-pass is gd_project, the depth sort key (one
// elementwise op), the library's stable depth sort, gd_depth_rank,
// gd_tile_keys, the library's stable key sort and gd_tile_ranges.
//
//   gd_project      one thread per Gaussian: the quaternion normalisation,
//                   the view and clip transforms, the EWA 2D covariance and
//                   its conic, the screen radius and the culling, degree 0-3
//                   SH colour and the opacity folded with validity.
//   gd_depth_rank   one thread per depth rank: the int32 order and its
//                   inverse rank[order[i]] = i; zeroes the two counters.
//   gd_tile_keys    one thread per Gaussian: the tile rectangle, the E-slot
//                   enumeration, the SAFE max-alpha bound of each tile and
//                   the stable compaction into max_tiles slots; writes the
//                   d-major (max_tiles, N) keys tile * N_pow2 + rank, dead
//                   slots DEAD_KEY, and adds the block's overflow to counter
//                   0 with one atomic (an integer sum: the same in any
//                   order).
//   gd_tile_ranges  one thread per position of the sorted keys (3DGS
//                   identifyTileRanges): the int32 ids, slots, ranks and the
//                   live flag of each sorted slot; each tile's first slot
//                   where the tile changes; then the last block to finish
//                   (counter 1) derives the counts, clamps them to the
//                   per-tile cap and writes both overflow totals.
//
// Bound on an H100: bytes, and at serving sizes not even those.  The
// projection reads ~80 B and writes ~50 B a Gaussian (45 MB at 331,744
// Gaussians, ~14 us at 3.35 TB/s); the binning's elementwise passes move
// ~60 B a Gaussian.  What the design does about the launch bound: the
// camera is read from its device tensors through strides (no host copy, no
// sync), the counters live on the card, and no wrapper reads a value back.
//
// Exactness.  The binning must give the same integers as the op chain, so
// its arithmetic is the chain's, operation for operation, in IEEE-rounded
// intrinsics (nvcc would contract a*b+c into one FMA where the chain rounds
// twice) with sqrtf / logf, the library functions the chain's kernels call;
// torch.clamp and torch.maximum propagate NaN, so clamp_min / maximum do.
// The projection follows the chain the same way; its 4-term dot products
// and vector norms are library GEMMs and reductions on the chain's side,
// whose summation order this kernel repeats as measured (dot4 / norm3 /
// norm4): bit for bit at the serving shapes, and within rounding wherever
// the library picks another order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DEAD_KEY = 0x7fffffff;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, min=lo), torch.clamp(v, lo, hi) and torch.maximum on the
// card: NaN propagates
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// The chain's library calls, in the summation order measured on the card
// (torch 2.11, CUDA 12.8: the projection of 262,144 and 331,744 Gaussians
// bit for bit; other orders differ in 6-45% of the outputs).
// [x, y, z, 1] . (m0, m1, m2, m3), the GEMM: an FMA chain over k from the
// first product
__device__ __forceinline__ float dot4(float x, float y, float z, float m0,
                                      float m1, float m2, float m3) {
  return __fadd_rn(__fmaf_rn(z, m2, __fmaf_rn(y, m1, __fmul_rn(x, m0))), m3);
}
// torch.linalg.norm over the last dim: each square rounded, then a tree
// over a power-of-two width of lanes, the halves added first
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(add(add(mul(x, x), mul(z, z)), mul(y, y)));
}
__device__ __forceinline__ float norm4(float w, float x, float y, float z) {
  return sqrtf(add(add(mul(w, w), mul(y, y)), add(mul(x, x), mul(z, z))));
}

template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T part[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < THREADS / 32 ? part[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;   // thread 0 holds the block's sum
}

// ---------------------------------------------------------------- project

struct ProjectArgs {
  const float* means;     // (N, 3)
  const float* shs;       // (N, K, 3), row stride sh_stride floats
  const float* opacity;   // (N,) activated
  const float* scales;    // (N, 3) activated
  const float* rot;       // (N, 4) wxyz, not normalised
  const float* offset;    // (N, 2) added to the screen means, or null
  const float* wvt;       // world_view_transform (4, 4), strides wvt_r / wvt_c
  const float* fpt;       // full_proj_transform (4, 4), strides fpt_r / fpt_c
  const float* center;    // camera_center (3,), stride center_s
  const float* tanx;      // tan_half_fovx ()
  const float* tany;      // tan_half_fovy ()
  float* xy;              // (N, 2)
  float* depth;           // (N,)
  float* conic;           // (N, 3)
  float* color;           // (N, 3)
  float* opa_eff;         // (N,) opacity where valid, else 0
  float* radius;          // (N,) 0 where culled
  bool* valid;            // (N,)
  int sh_stride, wvt_r, wvt_c, fpt_r, fpt_c, center_s, n, width, height;
};

// SH constants of core/sh.py (double literals rounded to f32, as the chain
// rounds a Python float against an f32 tensor)
constexpr float C0 = 0.28209479177387814;
constexpr float C1 = 0.4886025119029199;
constexpr float C2_0 = 1.0925484305920792, C2_1 = -1.0925484305920792,
                C2_2 = 0.31539156525252005, C2_3 = -1.0925484305920792,
                C2_4 = 0.5462742152960396;
constexpr float C3_0 = -0.5900435899266435, C3_1 = 2.890611442640554,
                C3_2 = -0.4570457994644658, C3_3 = 0.3731763325901154,
                C3_4 = -0.4570457994644658, C3_5 = 1.445305721320277,
                C3_6 = -0.5900435899266435;

template <int DEG>
__global__ void __launch_bounds__(THREADS) project_kernel(ProjectArgs a) {
  // the camera, read once per block: W (4x4), F (4x4), centre, tan x / y
  __shared__ float cam[37];
  const int t = threadIdx.x;
  if (t < 16) cam[t] = a.wvt[(t >> 2) * a.wvt_r + (t & 3) * a.wvt_c];
  else if (t < 32) cam[t] = a.fpt[((t - 16) >> 2) * a.fpt_r + ((t - 16) & 3) * a.fpt_c];
  else if (t < 35) cam[t] = a.center[(t - 32) * a.center_s];
  else if (t == 35) cam[t] = *a.tanx;
  else if (t == 36) cam[t] = *a.tany;
  __syncthreads();
  const int i = blockIdx.x * THREADS + t;
  if (i >= a.n) return;
  const float* W = cam;
  const float* F = cam + 16;
  const float tanx = cam[35], tany = cam[36];
  const float fw = static_cast<float>(a.width), fh = static_cast<float>(a.height);

  const float px = a.means[3 * i], py = a.means[3 * i + 1], pz = a.means[3 * i + 2];
  const float v0 = dot4(px, py, pz, W[0], W[4], W[8], W[12]);
  const float v1 = dot4(px, py, pz, W[1], W[5], W[9], W[13]);
  const float z = dot4(px, py, pz, W[2], W[6], W[10], W[14]);
  const float c0 = dot4(px, py, pz, F[0], F[4], F[8], F[12]);
  const float c1 = dot4(px, py, pz, F[1], F[5], F[9], F[13]);
  const float w = dot4(px, py, pz, F[3], F[7], F[11], F[15]);
  const float sgn = static_cast<float>((w > 0.f) - (w < 0.f));
  const float safe_w = fabsf(w) < 1e-7f ? add(mul(sgn, 1e-7f), 1e-12f) : w;
  float x = mul(sub(mul(add(dvd(c0, safe_w), 1.f), fw), 1.f), 0.5f);
  float y = mul(sub(mul(add(dvd(c1, safe_w), 1.f), fh), 1.f), 0.5f);
  if (a.offset != nullptr) {
    x = add(x, a.offset[2 * i]);
    y = add(y, a.offset[2 * i + 1]);
  }

  // Σ = R diag(s²) Rᵀ from the normalised quaternion
  const float* q = a.rot + 4 * i;
  const float qn = add(norm4(q[0], q[1], q[2], q[3]), 1e-8f);
  const float qw = dvd(q[0], qn), qx = dvd(q[1], qn), qy = dvd(q[2], qn),
              qz = dvd(q[3], qn);
  const float r[3][3] = {
      {sub(1.f, mul(2.f, add(mul(qy, qy), mul(qz, qz)))),
       mul(2.f, sub(mul(qx, qy), mul(qw, qz))), mul(2.f, add(mul(qx, qz), mul(qw, qy)))},
      {mul(2.f, add(mul(qx, qy), mul(qw, qz))),
       sub(1.f, mul(2.f, add(mul(qx, qx), mul(qz, qz)))), mul(2.f, sub(mul(qy, qz), mul(qw, qx)))},
      {mul(2.f, sub(mul(qx, qz), mul(qw, qy))), mul(2.f, add(mul(qy, qz), mul(qw, qx))),
       sub(1.f, mul(2.f, add(mul(qx, qx), mul(qy, qy))))}};
  const float s[3] = {a.scales[3 * i], a.scales[3 * i + 1], a.scales[3 * i + 2]};
  float m[3][3];
  for (int j = 0; j < 3; ++j)
    for (int k = 0; k < 3; ++k) m[j][k] = mul(r[j][k], s[k]);
  auto dot3 = [](const float* u, const float* v) {
    return add(add(mul(u[0], v[0]), mul(u[1], v[1])), mul(u[2], v[2]));
  };
  const float s00 = dot3(m[0], m[0]), s01 = dot3(m[0], m[1]), s02 = dot3(m[0], m[2]),
              s11 = dot3(m[1], m[1]), s12 = dot3(m[1], m[2]), s22 = dot3(m[2], m[2]);

  // EWA: Σ₂ = J W Σ Wᵀ Jᵀ + 0.3 I, with W = world_view_transform[:3, :3]ᵀ
  const float lim_x = mul(1.3f, tanx), lim_y = mul(1.3f, tany);
  const float tx = mul(clamp2(dvd(v0, z), -lim_x, lim_x), z);
  const float ty = mul(clamp2(dvd(v1, z), -lim_y, lim_y), z);
  const float inv_z = dvd(1.f, z);
  const float focal_x = mul(dvd(1.f, mul(2.f, tanx)), fw);
  const float focal_y = mul(dvd(1.f, mul(2.f, tany)), fh);
  const float fxz = mul(focal_x, inv_z), fyz = mul(focal_y, inv_z);
  const float gx = mul(mul(mul(focal_x, tx), inv_z), inv_z);
  const float gy = mul(mul(mul(focal_y, ty), inv_z), inv_z);
  float t0[3], t1[3];
  for (int k = 0; k < 3; ++k) {
    t0[k] = sub(mul(fxz, W[4 * k]), mul(gx, W[4 * k + 2]));
    t1[k] = sub(mul(fyz, W[4 * k + 1]), mul(gy, W[4 * k + 2]));
  }
  auto quad = [&](const float* u, const float* v) {
    float acc = add(mul(mul(u[0], v[0]), s00), mul(mul(u[1], v[1]), s11));
    acc = add(acc, mul(mul(u[2], v[2]), s22));
    acc = add(acc, mul(add(mul(u[0], v[1]), mul(u[1], v[0])), s01));
    acc = add(acc, mul(add(mul(u[0], v[2]), mul(u[2], v[0])), s02));
    return add(acc, mul(add(mul(u[1], v[2]), mul(u[2], v[1])), s12));
  };
  const float ca = add(quad(t0, t0), 0.3f);
  const float cb = quad(t0, t1);
  const float cc = add(quad(t1, t1), 0.3f);

  const float det = sub(mul(ca, cc), mul(cb, cb));
  bool valid = (z > 0.2f) && (det > 0.f);
  const float inv_det = dvd(1.f, valid ? det : 1.f);
  const float mid = mul(0.5f, add(ca, cc));
  const float lam1 = add(mid, sqrtf(clamp_min(sub(mul(mid, mid), det), 0.1f)));
  const float rad = ceilf(mul(3.f, sqrtf(clamp_min(lam1, 0.f))));
  valid = valid && (add(x, rad) > 0.f) && (sub(x, rad) < fw) && (add(y, rad) > 0.f) &&
          (sub(y, rad) < fh) && (rad > 0.f);

  // view-dependent colour, SH degree DEG
  const float dx = sub(px, cam[32]), dy = sub(py, cam[33]), dz = sub(pz, cam[34]);
  const float dn = add(norm3(dx, dy, dz), 1e-12f);
  const float X = dvd(dx, dn), Y = dvd(dy, dn), Z = dvd(dz, dn);
  constexpr int NB = (DEG + 1) * (DEG + 1) - 1;
  float basis[NB > 0 ? NB : 1];
  if constexpr (DEG >= 1) {
    basis[0] = mul(-C1, Y);
    basis[1] = mul(C1, Z);
    basis[2] = mul(-C1, X);
  }
  if constexpr (DEG >= 2) {
    const float xx = mul(X, X), yy = mul(Y, Y), zz = mul(Z, Z);
    const float xy_ = mul(X, Y), yz = mul(Y, Z), xz = mul(X, Z);
    basis[3] = mul(C2_0, xy_);
    basis[4] = mul(C2_1, yz);
    basis[5] = mul(C2_2, sub(sub(mul(2.f, zz), xx), yy));
    basis[6] = mul(C2_3, xz);
    basis[7] = mul(C2_4, sub(xx, yy));
    if constexpr (DEG >= 3) {
      basis[8] = mul(mul(C3_0, Y), sub(mul(3.f, xx), yy));
      basis[9] = mul(mul(C3_1, xy_), Z);
      basis[10] = mul(mul(C3_2, Y), sub(sub(mul(4.f, zz), xx), yy));
      basis[11] = mul(mul(C3_3, Z), sub(sub(mul(2.f, zz), mul(3.f, xx)), mul(3.f, yy)));
      basis[12] = mul(mul(C3_4, X), sub(sub(mul(4.f, zz), xx), yy));
      basis[13] = mul(mul(C3_5, Z), sub(xx, yy));
      basis[14] = mul(mul(C3_6, X), sub(xx, mul(3.f, yy)));
    }
  }
  const float* sh = a.shs + static_cast<int64_t>(i) * a.sh_stride;
  for (int c = 0; c < 3; ++c) {
    float acc = mul(C0, sh[c]);
    for (int k = 0; k < NB; ++k) acc = add(acc, mul(basis[k], sh[3 * (k + 1) + c]));
    a.color[3 * i + c] = clamp_min(add(acc, 0.5f), 0.f);
  }

  a.xy[2 * i] = x;
  a.xy[2 * i + 1] = y;
  a.depth[i] = z;
  a.conic[3 * i] = mul(cc, inv_det);
  a.conic[3 * i + 1] = mul(-cb, inv_det);
  a.conic[3 * i + 2] = mul(ca, inv_det);
  a.opa_eff[i] = valid ? a.opacity[i] : 0.f;
  a.radius[i] = valid ? rad : 0.f;
  a.valid[i] = valid;
}

// ------------------------------------------------------------- depth rank

__global__ void __launch_bounds__(THREADS) depth_rank_kernel(
    const int64_t* order64, int* order, int* rank, int n, long long* counters) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < 2) counters[i] = 0;
  if (i >= n) return;
  const int g = static_cast<int>(order64[i]);
  order[i] = g;
  rank[g] = i;
}

// --------------------------------------------------------------- tile keys

struct KeyArgs {
  const float* xy;        // (N, 2)
  const float* radius;    // (N,)
  const float* conic;     // (N, 3)
  const float* opacity;   // (N,) activated (not folded with validity)
  const bool* valid;      // (N,)
  const int* rank;        // (N,) depth rank of each Gaussian
  int* keys;              // (max_tiles, N) d-major
  int* n_slots;           // (N,) live slots of each Gaussian, or null
  long long* counters;    // [0] += the binning overflow
  int n, tiles_x, tiles_y, tile_size, max_tiles, enum_tiles, n_pow2;
};

// torch.clamp((v / tile_size).to(int32), 0, n): the chain divides by a
// scalar as a product with its rounded reciprocal, and truncates
__device__ __forceinline__ int rect_tile(float v, float inv_ts, int n) {
  return min(max(__float2int_rz(mul(v, inv_ts)), 0), n);
}

__global__ void __launch_bounds__(THREADS) tile_keys_kernel(KeyArgs a) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  long long over = 0;
  if (n < a.n) {
    const int D = a.max_tiles, E = a.enum_tiles;
    const bool compact = E > D;
    int live = 0;     // slots written live (compaction) / touching tiles
    int n_touch = 0;
    if (a.valid[n]) {
      const float ts = static_cast<float>(a.tile_size);
      const float inv_ts = dvd(1.f, ts);
      const float x = a.xy[2 * n], y = a.xy[2 * n + 1], r = a.radius[n];
      const int rmin_x = rect_tile(sub(x, r), inv_ts, a.tiles_x);
      const int rmin_y = rect_tile(sub(y, r), inv_ts, a.tiles_y);
      const int rmax_x = rect_tile(sub(add(add(x, r), ts), 1.f), inv_ts, a.tiles_x);
      const int rmax_y = rect_tile(sub(add(add(y, r), ts), 1.f), inv_ts, a.tiles_y);
      const int rect_w = max(rmax_x - rmin_x, 0), rect_h = max(rmax_y - rmin_y, 0);
      const int n_cover = rect_w * rect_h;
      const int safe_w = max(rect_w, 1);

      // the SAFE max-alpha bound over a tile: circle + major eigenvector
      const float ca = a.conic[3 * n], cb = a.conic[3 * n + 1], cc = a.conic[3 * n + 2];
      const float m = mul(0.5f, add(ca, cc));
      const float h = mul(0.5f, sub(ca, cc));
      const float rr = sqrtf(clamp_min(add(mul(h, h), mul(cb, cb)), 0.f));
      const float lam_min = clamp_min(sub(m, rr), 0.f);
      const float lam_max = add(m, rr);
      const float v1x = cb, v1y = sub(lam_max, ca), v2x = sub(lam_max, cc), v2y = cb;
      const float n1 = add(mul(v1x, v1x), mul(v1y, v1y));
      const float n2 = add(mul(v2x, v2x), mul(v2y, v2y));
      const bool use1 = n1 >= n2;
      const float un = sqrtf(maximum(n1, n2));
      const bool degen = un < 1e-20f;
      const float un_safe = degen ? 1.f : un;
      const float ux = degen ? 1.f : dvd(use1 ? v1x : v2x, un_safe);
      const float uy = degen ? 0.f : dvd(use1 ? v1y : v2y, un_safe);
      const float tau = logf(mul(clamp_min(a.opacity[n], 1e-12f), 255.f));
      const float half = (a.tile_size - 1) * 0.5f;
      const float hl_min = mul(0.5f, lam_min), hl_max = mul(0.5f, lam_max);
      const float spread = mul(half, add(fabsf(ux), fabsf(uy)));
      const int key_rank = a.rank[n];

      const int stop = min(E, n_cover);
      for (int e = 0; e < stop; ++e) {
        const int tile_x = rmin_x + e % safe_w, tile_y = rmin_y + e / safe_w;
        const float cx = sub(x, add(mul(static_cast<float>(tile_x), ts), half));
        const float cy = sub(y, add(mul(static_cast<float>(tile_y), ts), half));
        const float dxr = clamp_min(sub(fabsf(cx), half), 0.f);
        const float dyr = clamp_min(sub(fabsf(cy), half), 0.f);
        float bound = mul(hl_min, add(mul(dxr, dxr), mul(dyr, dyr)));
        const float du = clamp_min(sub(fabsf(add(mul(cx, ux), mul(cy, uy))), spread), 0.f);
        bound = maximum(bound, mul(mul(hl_max, du), du));
        const bool touch = bound <= tau;
        n_touch += touch;
        const int key = (tile_y * a.tiles_x + tile_x) * a.n_pow2 + key_rank;
        if (compact) {
          if (touch && live < D) a.keys[live++ * a.n + n] = key;
        } else {
          a.keys[e * a.n + n] = touch ? key : DEAD_KEY;
        }
      }
      if (!compact) {
        for (int e = stop; e < D; ++e) a.keys[e * a.n + n] = DEAD_KEY;
        live = n_touch;
      }
      over = static_cast<long long>(max(n_touch - D, 0)) + max(n_cover - E, 0);
    } else if (!compact) {
      for (int e = 0; e < D; ++e) a.keys[e * a.n + n] = DEAD_KEY;
    }
    if (compact)
      for (int d = live; d < D; ++d) a.keys[d * a.n + n] = DEAD_KEY;
    if (a.n_slots != nullptr) a.n_slots[n] = live;
  }
  over = block_sum(over);
  if (threadIdx.x == 0 && over != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.counters),
              static_cast<unsigned long long>(over));
}

// ------------------------------------------------------------- tile ranges

struct RangeArgs {
  const int* keys;         // (>= P,) sorted keys
  const int64_t* perm;     // (>= P,) the key sort's permutation: o = d * N + n
  int* sorted_ids;         // (P,) n
  int* sorted_o;           // (P,) o
  int* sorted_rank;        // (P,) key % N_pow2
  bool* sorted_valid;      // (P,) key != DEAD_KEY
  int* starts;             // (num_tiles + 1,) first sorted slot of each tile
  int* counts;             // (num_tiles,) slots of each tile
  int* capped;             // (num_tiles,) counts clamped to max_per_tile
  int* overflow;           // () the binning overflow
  int* overflow_total;     // () binning + per-tile cap overflow
  long long* counters;     // [0] binning overflow, [1] blocks done
  int p, n, n_pow2, num_tiles, max_per_tile;
};

__device__ __forceinline__ int tile_of(const RangeArgs& a, int i) {
  if (i >= a.p) return a.num_tiles;
  const int k = a.keys[i];
  return k == DEAD_KEY ? a.num_tiles : k / a.n_pow2;
}

__global__ void __launch_bounds__(THREADS) tile_ranges_kernel(RangeArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.p) {
    const int k = a.keys[i];
    const int o = static_cast<int>(a.perm[i]);
    a.sorted_o[i] = o;
    a.sorted_ids[i] = o % a.n;
    a.sorted_rank[i] = k % a.n_pow2;
    a.sorted_valid[i] = k != DEAD_KEY;
  }
  if (i <= a.p) {
    // position i starts every tile in (tile(i - 1), tile(i)]: the
    // searchsorted insertion point of each, empty tiles included
    const int prev = i == 0 ? -1 : tile_of(a, i - 1);
    const int cur = tile_of(a, i);
    for (int t = prev + 1; t <= cur; ++t) a.starts[t] = i;
  }
  // the last block to finish derives the counts from the starts
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long done = atomicAdd(
        reinterpret_cast<unsigned long long*>(a.counters + 1), 1ull);
    last = done == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  long long cap = 0;
  for (int t = threadIdx.x; t < a.num_tiles; t += THREADS) {
    const int c = __ldcg(a.starts + t + 1) - __ldcg(a.starts + t);
    const int kept = min(c, a.max_per_tile);
    a.counts[t] = c;
    a.capped[t] = kept;
    cap += c - kept;
  }
  cap = block_sum(cap);
  if (threadIdx.x == 0) {
    const unsigned bin = static_cast<unsigned>(__ldcg(a.counters));
    a.overflow[0] = static_cast<int>(bin);
    a.overflow_total[0] = static_cast<int>(bin + static_cast<unsigned>(cap));
  }
}

int blocks(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  Tensors are contiguous unless strides are given.

extern "C" int gd_project(const float* means, const float* shs, int sh_stride,
                          const float* opacity, const float* scales, const float* rot,
                          const float* offset, const float* wvt, int wvt_r, int wvt_c,
                          const float* fpt, int fpt_r, int fpt_c, const float* center,
                          int center_s, const float* tanx, const float* tany, int n,
                          int width, int height, int degree, float* xy, float* depth,
                          float* conic, float* color, float* opa_eff, float* radius,
                          bool* valid, void* stream) {
  if (n <= 0) return 0;
  ProjectArgs a{means, shs, opacity, scales, rot, offset, wvt, fpt, center, tanx, tany,
                xy, depth, conic, color, opa_eff, radius, valid,
                sh_stride, wvt_r, wvt_c, fpt_r, fpt_c, center_s, n, width, height};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: project_kernel<0><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 1: project_kernel<1><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 2: project_kernel<2><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 3: project_kernel<3><<<blocks(n), THREADS, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// order64 (N,) the stable depth sort's permutation; order / rank (N,) i32;
// counters (2,) i64, zeroed here for gd_tile_keys / gd_tile_ranges.
extern "C" int gd_depth_rank(const int64_t* order64, int* order, int* rank, int n,
                             long long* counters, void* stream) {
  depth_rank_kernel<<<blocks(n > 0 ? n : 1), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      order64, order, rank, n, counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gd_tile_keys(const float* xy, const float* radius, const float* conic,
                            const float* opacity, const bool* valid, const int* rank,
                            int* keys, int* n_slots, long long* counters, int n,
                            int tiles_x, int tiles_y, int tile_size, int max_tiles,
                            int enum_tiles, int n_pow2, void* stream) {
  if (n <= 0) return 0;
  KeyArgs a{xy, radius, conic, opacity, valid, rank, keys, n_slots, counters,
            n, tiles_x, tiles_y, tile_size, max_tiles, enum_tiles, n_pow2};
  tile_keys_kernel<<<blocks(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gd_tile_ranges(const int* keys, const int64_t* perm, int* sorted_ids,
                              int* sorted_o, int* sorted_rank, bool* sorted_valid,
                              int* starts, int* counts, int* capped, int* overflow,
                              int* overflow_total, long long* counters, int p, int n,
                              int n_pow2, int num_tiles, int max_per_tile, void* stream) {
  RangeArgs a{keys, perm, sorted_ids, sorted_o, sorted_rank, sorted_valid, starts, counts,
              capped, overflow, overflow_total, counters, p, n, n_pow2, num_tiles,
              max_per_tile};
  tile_ranges_kernel<<<blocks(static_cast<long long>(p) + 1), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
