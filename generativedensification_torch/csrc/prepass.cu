// The renders' pre-pass for Hopper (sm_90a), plain C interface for ctypes:
// the 3DGS projection (splat/projection.py), the 2DGS surfel set-up
// (splat/surfel.py) and the tile binning that the 3DGS and 2DGS renderers
// share (splat/binning.py), in five kernels, and the projection's backward.
//
// Replaces no TPU kernel: the JAX package leaves project_gaussians,
// _surfel_setup and bin_gaussians to XLA, which fuses each op chain into a
// few loops.  Eager
// PyTorch ran the same chains as ~200 launches a view, each ~20 us of host
// dispatch for well under 1 us of work, so the renders waited on the host's
// launches and not on the card.  These kernels were added for the launch
// count: a view's pre-pass is gd_project, the depth sort key (one
// elementwise op), the library's stable depth sort, gd_depth_rank,
// gd_tile_keys, the library's stable key sort and gd_tile_ranges; a 2DGS
// view's begins with gd_surfel_setup in gd_project's place.  A 3DGS view
// that autograd records runs gd_project_bwd in its backward, where eager
// PyTorch recomputed the chain and ran autograd through it (~960 ops).
//
//   gd_project      one thread per Gaussian: the quaternion normalisation,
//                   the view and clip transforms, the EWA 2D covariance and
//                   its conic, the screen radius and the culling, degree 0-3
//                   SH colour and the opacity folded with validity.
//   gd_project_bwd  one thread per Gaussian: the vector-Jacobian product of
//                   gd_project's differentiable outputs (xy, depth, conic,
//                   colour, opacity_eff) for the gradients of the means, SH,
//                   opacity, scales, quaternions and screen offset, from the
//                   forward's values recomputed in registers by the same
//                   device functions, so every branch (the culls, the FOV
//                   clamp, the colour clamp, the w guard) is the forward's.
//   gd_surfel_setup one thread per surfel: the rotation's columns, the
//                   view-space centre, tangent axes and normal (flipped
//                   toward the camera), the homogeneous map M and its ray
//                   coefficients acr / bcr / ccr / det, the centre's pixel,
//                   the ±3σ endpoint radius and the culling, degree 0-3 SH
//                   colour, the binning's circular conic and the opacity
//                   folded with validity.
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
// Gaussians, ~14 us at 3.35 TB/s); its backward reads the inputs and five
// cotangents and writes six gradients, ~236 B a Gaussian at SH degree 1 (78
// MB, ~23 us); the binning's elementwise passes move ~60 B a Gaussian.  What the design does about the launch bound: the
// camera is read from its device tensors through strides (no host copy, no
// sync), the counters live on the card, and no wrapper reads a value back.
//
// Exactness.  The binning must give the same integers as the op chain, so
// its arithmetic is the chain's, operation for operation, in IEEE-rounded
// intrinsics (nvcc would contract a*b+c into one FMA where the chain rounds
// twice) with sqrtf / logf, the library functions the chain's kernels call;
// torch.clamp and torch.maximum propagate NaN, so clamp_min / maximum do.
// The projection and the surfel set-up follow their chains the same way;
// their dot products, cross products, sums and vector norms are library
// GEMMs, kernels and reductions on the chain's side, whose summation order
// and contraction these kernels repeat as measured (dot4 / norm3 / norm4,
// gemm3 / sum3 / cross_term / norm2): bit for bit at the serving shapes,
// and within rounding wherever the library picks another order.

#include <cuda_bf16.h>
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

// core/sh.py::eval_sh_color's view direction (dx, dy, dz) = mean - centre,
// normalised by its norm + 1e-12: the norm in nrm, the unit vector in X, Y, Z
__device__ __forceinline__ void sh_dir(float dx, float dy, float dz, float& nrm, float& X,
                                       float& Y, float& Z) {
  nrm = norm3(dx, dy, dz);
  const float dn = add(nrm, 1e-12f);
  X = dvd(dx, dn);
  Y = dvd(dy, dn);
  Z = dvd(dz, dn);
}

// the (DEG + 1)² - 1 basis functions past the constant one, at (X, Y, Z)
template <int DEG>
__device__ __forceinline__ void sh_basis(float X, float Y, float Z, float* basis) {
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
}

template <int DEG>
constexpr int SH_REST = (DEG + 1) * (DEG + 1) - 1;

// core/sh.py::eval_sh_color at degree DEG of one row of SH coefficients
// `sh` ((DEG + 1)², 3) in the view direction (dx, dy, dz) = mean - centre,
// into color[0..2]
template <int DEG>
__device__ __forceinline__ void sh_color(const float* sh, float dx, float dy, float dz,
                                         float* color) {
  float nrm, X, Y, Z;
  sh_dir(dx, dy, dz, nrm, X, Y, Z);
  constexpr int NB = SH_REST<DEG>;
  float basis[NB > 0 ? NB : 1];
  sh_basis<DEG>(X, Y, Z, basis);
  for (int c = 0; c < 3; ++c) {
    float acc = mul(C0, sh[c]);
    for (int k = 0; k < NB; ++k) acc = add(acc, mul(basis[k], sh[3 * (k + 1) + c]));
    color[c] = clamp_min(add(acc, 0.5f), 0.f);
  }
}

// The camera of gd_project / gd_project_bwd in shared memory: W (4x4) at 0,
// F (4x4) at 16, the centre at 32, tan x / y at 35 / 36
template <typename A>
__device__ __forceinline__ void load_projection_camera(const A& a, float* cam) {
  const int t = threadIdx.x;
  if (t < 16) cam[t] = a.wvt[(t >> 2) * a.wvt_r + (t & 3) * a.wvt_c];
  else if (t < 32) cam[t] = a.fpt[((t - 16) >> 2) * a.fpt_r + ((t - 16) & 3) * a.fpt_c];
  else if (t < 35) cam[t] = a.center[(t - 32) * a.center_s];
  else if (t == 35) cam[t] = *a.tanx;
  else if (t == 36) cam[t] = *a.tany;
}

// One Gaussian's projection, every value the forward writes or the backward
// differentiates, as the plain chain rounds it
struct ProjectValues {
  float v0, v1, z;            // view space
  float c0, c1, w, safe_w;    // clip space: x, y, w and w kept off zero
  float x, y;                 // the screen mean, offset added
  float nq, qn, qh[4];        // |q|, |q| + 1e-8, the normalised quaternion
  float r[3][3], m[3][3];     // R and M = R diag(s)
  float sig[6];               // Σ = M Mᵀ: s00, s01, s02, s11, s12, s22
  float rx, ry, lim_x, lim_y; // x / z, y / z and their FOV clamp
  float txz, tyz, tx, ty;     // the clamped ratios and their products with z
  float inv_z, focal_x, focal_y, fxz, fyz, gx, gy;
  float t0[3], t1[3];         // the rows of J W
  float ca, cb, cc, det, inv_det, rad;
  bool valid0, valid;         // z > 0.2 and det > 0; and on screen, radius > 0
};

__device__ __forceinline__ void project_values(const float* cam, float fw, float fh,
                                               float px, float py, float pz, const float* q,
                                               const float* s, bool has_offset, float ox,
                                               float oy, ProjectValues& v) {
  const float* W = cam;
  const float* F = cam + 16;
  const float tanx = cam[35], tany = cam[36];
  v.v0 = dot4(px, py, pz, W[0], W[4], W[8], W[12]);
  v.v1 = dot4(px, py, pz, W[1], W[5], W[9], W[13]);
  v.z = dot4(px, py, pz, W[2], W[6], W[10], W[14]);
  v.c0 = dot4(px, py, pz, F[0], F[4], F[8], F[12]);
  v.c1 = dot4(px, py, pz, F[1], F[5], F[9], F[13]);
  v.w = dot4(px, py, pz, F[3], F[7], F[11], F[15]);
  const float sgn = static_cast<float>((v.w > 0.f) - (v.w < 0.f));
  v.safe_w = fabsf(v.w) < 1e-7f ? add(mul(sgn, 1e-7f), 1e-12f) : v.w;
  v.x = mul(sub(mul(add(dvd(v.c0, v.safe_w), 1.f), fw), 1.f), 0.5f);
  v.y = mul(sub(mul(add(dvd(v.c1, v.safe_w), 1.f), fh), 1.f), 0.5f);
  if (has_offset) {
    v.x = add(v.x, ox);
    v.y = add(v.y, oy);
  }

  // Σ = R diag(s²) Rᵀ from the normalised quaternion
  v.nq = norm4(q[0], q[1], q[2], q[3]);
  v.qn = add(v.nq, 1e-8f);
  for (int k = 0; k < 4; ++k) v.qh[k] = dvd(q[k], v.qn);
  const float qw = v.qh[0], qx = v.qh[1], qy = v.qh[2], qz = v.qh[3];
  const float r[3][3] = {
      {sub(1.f, mul(2.f, add(mul(qy, qy), mul(qz, qz)))),
       mul(2.f, sub(mul(qx, qy), mul(qw, qz))), mul(2.f, add(mul(qx, qz), mul(qw, qy)))},
      {mul(2.f, add(mul(qx, qy), mul(qw, qz))),
       sub(1.f, mul(2.f, add(mul(qx, qx), mul(qz, qz)))), mul(2.f, sub(mul(qy, qz), mul(qw, qx)))},
      {mul(2.f, sub(mul(qx, qz), mul(qw, qy))), mul(2.f, add(mul(qy, qz), mul(qw, qx))),
       sub(1.f, mul(2.f, add(mul(qx, qx), mul(qy, qy))))}};
  for (int j = 0; j < 3; ++j)
    for (int k = 0; k < 3; ++k) {
      v.r[j][k] = r[j][k];
      v.m[j][k] = mul(r[j][k], s[k]);
    }
  auto dot3 = [](const float* u, const float* w) {
    return add(add(mul(u[0], w[0]), mul(u[1], w[1])), mul(u[2], w[2]));
  };
  v.sig[0] = dot3(v.m[0], v.m[0]);
  v.sig[1] = dot3(v.m[0], v.m[1]);
  v.sig[2] = dot3(v.m[0], v.m[2]);
  v.sig[3] = dot3(v.m[1], v.m[1]);
  v.sig[4] = dot3(v.m[1], v.m[2]);
  v.sig[5] = dot3(v.m[2], v.m[2]);
  const float s00 = v.sig[0], s01 = v.sig[1], s02 = v.sig[2], s11 = v.sig[3],
              s12 = v.sig[4], s22 = v.sig[5];

  // EWA: Σ₂ = J W Σ Wᵀ Jᵀ + 0.3 I, with W = world_view_transform[:3, :3]ᵀ
  v.lim_x = mul(1.3f, tanx);
  v.lim_y = mul(1.3f, tany);
  v.rx = dvd(v.v0, v.z);
  v.ry = dvd(v.v1, v.z);
  v.txz = clamp2(v.rx, -v.lim_x, v.lim_x);
  v.tyz = clamp2(v.ry, -v.lim_y, v.lim_y);
  v.tx = mul(v.txz, v.z);
  v.ty = mul(v.tyz, v.z);
  v.inv_z = dvd(1.f, v.z);
  v.focal_x = mul(dvd(1.f, mul(2.f, tanx)), fw);
  v.focal_y = mul(dvd(1.f, mul(2.f, tany)), fh);
  v.fxz = mul(v.focal_x, v.inv_z);
  v.fyz = mul(v.focal_y, v.inv_z);
  v.gx = mul(mul(mul(v.focal_x, v.tx), v.inv_z), v.inv_z);
  v.gy = mul(mul(mul(v.focal_y, v.ty), v.inv_z), v.inv_z);
  for (int k = 0; k < 3; ++k) {
    v.t0[k] = sub(mul(v.fxz, W[4 * k]), mul(v.gx, W[4 * k + 2]));
    v.t1[k] = sub(mul(v.fyz, W[4 * k + 1]), mul(v.gy, W[4 * k + 2]));
  }
  auto quad = [&](const float* u, const float* w) {
    float acc = add(mul(mul(u[0], w[0]), s00), mul(mul(u[1], w[1]), s11));
    acc = add(acc, mul(mul(u[2], w[2]), s22));
    acc = add(acc, mul(add(mul(u[0], w[1]), mul(u[1], w[0])), s01));
    acc = add(acc, mul(add(mul(u[0], w[2]), mul(u[2], w[0])), s02));
    return add(acc, mul(add(mul(u[1], w[2]), mul(u[2], w[1])), s12));
  };
  v.ca = add(quad(v.t0, v.t0), 0.3f);
  v.cb = quad(v.t0, v.t1);
  v.cc = add(quad(v.t1, v.t1), 0.3f);

  v.det = sub(mul(v.ca, v.cc), mul(v.cb, v.cb));
  v.valid0 = (v.z > 0.2f) && (v.det > 0.f);
  v.inv_det = dvd(1.f, v.valid0 ? v.det : 1.f);
  const float mid = mul(0.5f, add(v.ca, v.cc));
  const float lam1 = add(mid, sqrtf(clamp_min(sub(mul(mid, mid), v.det), 0.1f)));
  v.rad = ceilf(mul(3.f, sqrtf(clamp_min(lam1, 0.f))));
  v.valid = v.valid0 && (add(v.x, v.rad) > 0.f) && (sub(v.x, v.rad) < fw) &&
            (add(v.y, v.rad) > 0.f) && (sub(v.y, v.rad) < fh) && (v.rad > 0.f);
}

template <int DEG>
__global__ void __launch_bounds__(THREADS) project_kernel(ProjectArgs a) {
  // the camera, read once per block
  __shared__ float cam[37];
  load_projection_camera(a, cam);
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const float fw = static_cast<float>(a.width), fh = static_cast<float>(a.height);

  const float px = a.means[3 * i], py = a.means[3 * i + 1], pz = a.means[3 * i + 2];
  const float s[3] = {a.scales[3 * i], a.scales[3 * i + 1], a.scales[3 * i + 2]};
  const bool has_offset = a.offset != nullptr;
  ProjectValues v;
  project_values(cam, fw, fh, px, py, pz, a.rot + 4 * i, s, has_offset,
                 has_offset ? a.offset[2 * i] : 0.f, has_offset ? a.offset[2 * i + 1] : 0.f, v);

  // view-dependent colour, SH degree DEG
  sh_color<DEG>(a.shs + static_cast<int64_t>(i) * a.sh_stride, sub(px, cam[32]),
                sub(py, cam[33]), sub(pz, cam[34]), a.color + 3 * i);

  a.xy[2 * i] = v.x;
  a.xy[2 * i + 1] = v.y;
  a.depth[i] = v.z;
  a.conic[3 * i] = mul(v.cc, v.inv_det);
  a.conic[3 * i + 1] = mul(-v.cb, v.inv_det);
  a.conic[3 * i + 2] = mul(v.ca, v.inv_det);
  a.opa_eff[i] = v.valid ? a.opacity[i] : 0.f;
  a.radius[i] = v.valid ? v.rad : 0.f;
  a.valid[i] = v.valid;
}

// ------------------------------------------------------- project backward

struct ProjectBwdArgs {
  // the forward's inputs in their stored dtype (f32, or bf16 where bit k of
  // bf16 is set: 0 means, 1 shs, 2 opacity, 3 scales, 4 rot, 5 offset), rows
  // *_s elements apart, each row packed; offset may be null
  const void* means;      // (N, 3)
  const void* shs;        // (N, K, 3)
  const void* scales;     // (N, 3)
  const void* rot;        // (N, 4)
  const void* offset;     // (N, 2)
  // the cotangents of xy (N, 2), depth (N,), conic (N, 3), color (N, 3) and
  // opacity_eff (N,), f32, packed; null where autograd gave none (zero)
  const float* g_xy;
  const float* g_depth;
  const float* g_conic;
  const float* g_color;
  const float* g_opa;
  // the gradients, packed, each in its input's dtype; null where not asked
  void* d_means;          // (N, 3)
  void* d_shs;            // (N, K, 3): zero past the degree's coefficients
  void* d_opa;            // (N,)
  void* d_scales;         // (N, 3)
  void* d_rot;            // (N, 4)
  void* d_off;            // (N, 2)
  const float* wvt;
  const float* fpt;
  const float* center;
  const float* tanx;
  const float* tany;
  int means_s, shs_s, sh_k, scales_s, rot_s, off_s, bf16;
  int wvt_r, wvt_c, fpt_r, fpt_c, center_s, n, width, height;
};

__device__ __forceinline__ float load_as_f32(const void* p, bool bf16, int64_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_as(void* p, bool bf16, int64_t i, float v) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(p)[i] = v;
}
__device__ __forceinline__ float cotangent(const float* g, int64_t i) {
  return g != nullptr ? g[i] : 0.f;
}

// d(X, Y, Z) of sum_k db[k] * basis[k]
template <int DEG>
__device__ __forceinline__ void sh_basis_vjp(float X, float Y, float Z, const float* db,
                                             float& dX, float& dY, float& dZ) {
  dX = dY = dZ = 0.f;
  if constexpr (DEG >= 1) {
    dY -= C1 * db[0];
    dZ += C1 * db[1];
    dX -= C1 * db[2];
  }
  if constexpr (DEG >= 2) {
    dX += C2_0 * Y * db[3];
    dY += C2_0 * X * db[3];
    dY += C2_1 * Z * db[4];
    dZ += C2_1 * Y * db[4];
    dX -= 2.f * C2_2 * X * db[5];
    dY -= 2.f * C2_2 * Y * db[5];
    dZ += 4.f * C2_2 * Z * db[5];
    dX += C2_3 * Z * db[6];
    dZ += C2_3 * X * db[6];
    dX += 2.f * C2_4 * X * db[7];
    dY -= 2.f * C2_4 * Y * db[7];
  }
  if constexpr (DEG >= 3) {
    const float xx = X * X, yy = Y * Y, zz = Z * Z;
    dX += C3_0 * 6.f * X * Y * db[8];
    dY += C3_0 * (3.f * xx - 3.f * yy) * db[8];
    dX += C3_1 * Y * Z * db[9];
    dY += C3_1 * X * Z * db[9];
    dZ += C3_1 * X * Y * db[9];
    dX -= C3_2 * 2.f * X * Y * db[10];
    dY += C3_2 * (4.f * zz - xx - 3.f * yy) * db[10];
    dZ += C3_2 * 8.f * Y * Z * db[10];
    dX -= C3_3 * 6.f * X * Z * db[11];
    dY -= C3_3 * 6.f * Y * Z * db[11];
    dZ += C3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * db[11];
    dX += C3_4 * (4.f * zz - 3.f * xx - yy) * db[12];
    dY -= C3_4 * 2.f * X * Y * db[12];
    dZ += C3_4 * 8.f * X * Z * db[12];
    dX += C3_5 * 2.f * X * Z * db[13];
    dY -= C3_5 * 2.f * Y * Z * db[13];
    dZ += C3_5 * (xx - yy) * db[13];
    dX += C3_6 * (3.f * xx - 3.f * yy) * db[14];
    dY -= C3_6 * 6.f * X * Y * db[14];
  }
}

// The backward follows autograd's rule at every branch of the plain chain:
// torch.clamp passes the gradient where its input lies within the bounds,
// ends included (the FOV clamp, the colour's max(· + 0.5, 0)); torch.where
// routes it to the chosen branch (safe_w, 1 / where(valid0, det, 1),
// opacity_eff); a norm's gradient is 0 at a zero vector; the radius (a
// ceil) passes none.  Its own sums are plain f32 arithmetic.
template <int DEG>
__global__ void __launch_bounds__(THREADS) project_bwd_kernel(ProjectBwdArgs a) {
  __shared__ float cam[37];
  load_projection_camera(a, cam);
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const float* W = cam;
  const float* F = cam + 16;
  const float fw = static_cast<float>(a.width), fh = static_cast<float>(a.height);
  const bool bf_means = a.bf16 & 1, bf_shs = a.bf16 & 2, bf_opa = a.bf16 & 4,
             bf_scales = a.bf16 & 8, bf_rot = a.bf16 & 16, bf_off = a.bf16 & 32;

  const int64_t im = static_cast<int64_t>(i) * a.means_s;
  const float px = load_as_f32(a.means, bf_means, im);
  const float py = load_as_f32(a.means, bf_means, im + 1);
  const float pz = load_as_f32(a.means, bf_means, im + 2);
  float q[4], s[3];
  for (int k = 0; k < 4; ++k)
    q[k] = load_as_f32(a.rot, bf_rot, static_cast<int64_t>(i) * a.rot_s + k);
  for (int k = 0; k < 3; ++k)
    s[k] = load_as_f32(a.scales, bf_scales, static_cast<int64_t>(i) * a.scales_s + k);
  const bool has_offset = a.offset != nullptr;
  const int64_t io = static_cast<int64_t>(i) * a.off_s;
  ProjectValues v;
  project_values(cam, fw, fh, px, py, pz, q, s, has_offset,
                 has_offset ? load_as_f32(a.offset, bf_off, io) : 0.f,
                 has_offset ? load_as_f32(a.offset, bf_off, io + 1) : 0.f, v);

  const float gx = cotangent(a.g_xy, 2 * i), gy = cotangent(a.g_xy, 2 * i + 1);
  if (a.d_opa != nullptr) store_as(a.d_opa, bf_opa, i, v.valid ? cotangent(a.g_opa, i) : 0.f);
  if (a.d_off != nullptr) {
    store_as(a.d_off, bf_off, 2 * i, gx);
    store_as(a.d_off, bf_off, 2 * i + 1, gy);
  }
  const bool want_means = a.d_means != nullptr;
  const bool want_cov = a.d_scales != nullptr || a.d_rot != nullptr;
  if (!want_means && !want_cov && a.d_shs == nullptr) return;

  // the conic (c, -b, a) / where(valid0, det, 1)
  const float gA = cotangent(a.g_conic, 3 * i), gB = cotangent(a.g_conic, 3 * i + 1),
              gC = cotangent(a.g_conic, 3 * i + 2);
  float da = gC * v.inv_det, db = -gB * v.inv_det, dc = gA * v.inv_det;
  if (v.valid0) {
    const float ddet = -(gA * v.cc - gB * v.cb + gC * v.ca) * v.inv_det * v.inv_det;
    da += ddet * v.cc;
    dc += ddet * v.ca;
    db -= 2.f * v.cb * ddet;
  }
  // a = t0ᵀ Σ t0 + 0.3, b = t0ᵀ Σ t1, c = t1ᵀ Σ t1 + 0.3
  const float* S = v.sig;
  const float Sm[3][3] = {{S[0], S[1], S[2]}, {S[1], S[3], S[4]}, {S[2], S[4], S[5]}};
  float dt0[3], dt1[3];
  for (int k = 0; k < 3; ++k) {
    float st0 = 0.f, st1 = 0.f;
    for (int l = 0; l < 3; ++l) {
      st0 += Sm[k][l] * v.t0[l];
      st1 += Sm[k][l] * v.t1[l];
    }
    dt0[k] = 2.f * da * st0 + db * st1;
    dt1[k] = 2.f * dc * st1 + db * st0;
  }

  float dp[3] = {0.f, 0.f, 0.f};
  if (want_means) {
    // t0 = fxz W[:, 0] - gx W[:, 2], t1 = fyz W[:, 1] - gy W[:, 2] (W[k][j] at 4k + j)
    float dfxz = 0.f, dfyz = 0.f, dgx = 0.f, dgy = 0.f;
    for (int k = 0; k < 3; ++k) {
      dfxz += dt0[k] * W[4 * k];
      dgx -= dt0[k] * W[4 * k + 2];
      dfyz += dt1[k] * W[4 * k + 1];
      dgy -= dt1[k] * W[4 * k + 2];
    }
    // fxz = f_x / z, gx = f_x tx / z², tx = clamp(v0 / z) z
    const float iz = v.inv_z;
    const float dinv = dfxz * v.focal_x + dfyz * v.focal_y +
                       2.f * iz * (dgx * v.focal_x * v.tx + dgy * v.focal_y * v.ty);
    const float dtx = dgx * v.focal_x * iz * iz, dty = dgy * v.focal_y * iz * iz;
    float dz = cotangent(a.g_depth, i) - dinv * iz * iz + dtx * v.txz + dty * v.tyz;
    float dv0 = 0.f, dv1 = 0.f;
    if (v.rx >= -v.lim_x && v.rx <= v.lim_x) {
      const float g = dtx * v.z;
      dv0 = g / v.z;
      dz -= g * v.v0 / (v.z * v.z);
    }
    if (v.ry >= -v.lim_y && v.ry <= v.lim_y) {
      const float g = dty * v.z;
      dv1 = g / v.z;
      dz -= g * v.v1 / (v.z * v.z);
    }
    // xy = ((c / safe_w + 1) size - 1) / 2 + offset; safe_w is w unless |w| < 1e-7
    const float dn0 = gx * 0.5f * fw, dn1 = gy * 0.5f * fh;
    const float dc0 = dn0 / v.safe_w, dc1 = dn1 / v.safe_w;
    const float dw = fabsf(v.w) < 1e-7f
                         ? 0.f
                         : -(dn0 * v.c0 + dn1 * v.c1) / (v.safe_w * v.safe_w);
    // the view and clip transforms: [p, 1] @ W[:, :3], [p, 1] @ F
    for (int k = 0; k < 3; ++k)
      dp[k] = dv0 * W[4 * k] + dv1 * W[4 * k + 1] + dz * W[4 * k + 2] + dc0 * F[4 * k] +
              dc1 * F[4 * k + 1] + dw * F[4 * k + 3];
  }

  if (want_cov) {
    // Σ = M Mᵀ: dM = G M with G = 2 (da t0 t0ᵀ + dc t1 t1ᵀ) + db (t0 t1ᵀ + t1 t0ᵀ)
    float G[3][3];
    for (int p = 0; p < 3; ++p)
      for (int r = 0; r < 3; ++r)
        G[p][r] = 2.f * (da * v.t0[p] * v.t0[r] + dc * v.t1[p] * v.t1[r]) +
                  db * (v.t0[p] * v.t1[r] + v.t0[r] * v.t1[p]);
    float dr[3][3], ds[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) {
        const float dm = G[j][0] * v.m[0][k] + G[j][1] * v.m[1][k] + G[j][2] * v.m[2][k];
        dr[j][k] = dm * s[k];
        ds[k] += dm * v.r[j][k];
      }
    if (a.d_scales != nullptr)
      for (int k = 0; k < 3; ++k)
        store_as(a.d_scales, bf_scales, 3 * static_cast<int64_t>(i) + k, ds[k]);
    if (a.d_rot != nullptr) {
      // R of the normalised quaternion (w, x, y, z)
      const float w = v.qh[0], x = v.qh[1], y = v.qh[2], z = v.qh[3];
      const float dqh[4] = {
          2.f * (-z * dr[0][1] + y * dr[0][2] + z * dr[1][0] - x * dr[1][2] - y * dr[2][0] +
                 x * dr[2][1]),
          2.f * (y * dr[0][1] + z * dr[0][2] + y * dr[1][0] - 2.f * x * dr[1][1] -
                 w * dr[1][2] + z * dr[2][0] + w * dr[2][1] - 2.f * x * dr[2][2]),
          2.f * (-2.f * y * dr[0][0] + x * dr[0][1] + w * dr[0][2] + x * dr[1][0] +
                 z * dr[1][2] - w * dr[2][0] + z * dr[2][1] - 2.f * y * dr[2][2]),
          2.f * (-2.f * z * dr[0][0] - w * dr[0][1] + x * dr[0][2] + w * dr[1][0] -
                 2.f * z * dr[1][1] + y * dr[1][2] + x * dr[2][0] + y * dr[2][1])};
      // qh = q / (|q| + 1e-8)
      float gq = 0.f;
      for (int k = 0; k < 4; ++k) gq += dqh[k] * q[k];
      const float rn = v.nq > 0.f ? gq / (v.qn * v.qn) / v.nq : 0.f;
      for (int k = 0; k < 4; ++k)
        store_as(a.d_rot, bf_rot, 4 * static_cast<int64_t>(i) + k, dqh[k] / v.qn - rn * q[k]);
    }
  }

  // the colour: clamp(C0 sh0 + sum_k basis_k sh_k + 0.5, min=0) in the
  // direction (p - centre) / (|p - centre| + 1e-12)
  if (want_means || a.d_shs != nullptr) {
    const float dx = sub(px, cam[32]), dy = sub(py, cam[33]), dz = sub(pz, cam[34]);
    float nrm, X, Y, Z;
    sh_dir(dx, dy, dz, nrm, X, Y, Z);
    constexpr int NB = SH_REST<DEG>;
    float basis[NB > 0 ? NB : 1], dbasis[NB > 0 ? NB : 1];
    sh_basis<DEG>(X, Y, Z, basis);
    const int64_t is = static_cast<int64_t>(i) * a.shs_s;
    float gc[3];
    for (int k = 0; k < NB; ++k) dbasis[k] = 0.f;
    for (int c = 0; c < 3; ++c) {
      float acc = mul(C0, load_as_f32(a.shs, bf_shs, is + c));
      float sh[NB > 0 ? NB : 1];
      for (int k = 0; k < NB; ++k) {
        sh[k] = load_as_f32(a.shs, bf_shs, is + 3 * (k + 1) + c);
        acc = add(acc, mul(basis[k], sh[k]));
      }
      gc[c] = add(acc, 0.5f) >= 0.f ? cotangent(a.g_color, 3 * i + c) : 0.f;
      for (int k = 0; k < NB; ++k) dbasis[k] += gc[c] * sh[k];
    }
    if (a.d_shs != nullptr) {
      const int64_t o = static_cast<int64_t>(i) * a.sh_k * 3;
      for (int c = 0; c < 3; ++c) store_as(a.d_shs, bf_shs, o + c, C0 * gc[c]);
      for (int k = 1; k < a.sh_k; ++k)
        for (int c = 0; c < 3; ++c)
          store_as(a.d_shs, bf_shs, o + 3 * k + c, k <= NB ? basis[k - 1] * gc[c] : 0.f);
    }
    if (want_means) {
      float dX, dY, dZ;
      sh_basis_vjp<DEG>(X, Y, Z, dbasis, dX, dY, dZ);
      const float dn = add(nrm, 1e-12f);
      const float proj = (dX * dx + dY * dy + dZ * dz) / (dn * dn);
      const float rn = nrm > 0.f ? proj / nrm : 0.f;
      dp[0] += dX / dn - rn * dx;
      dp[1] += dY / dn - rn * dy;
      dp[2] += dZ / dn - rn * dz;
      for (int k = 0; k < 3; ++k)
        store_as(a.d_means, bf_means, 3 * static_cast<int64_t>(i) + k, dp[k]);
    }
  }
}

// ------------------------------------------------------------ surfel setup

struct SurfelArgs {
  const float* means;     // (N, 3)
  const float* scales;    // (N, 2) activated, row stride scale_stride floats
  const float* rot;       // (N, 4) wxyz, not normalised
  const float* opacity;   // (N,) activated
  const float* shs;       // (N, K, 3), row stride sh_stride floats
  const float* wvt;       // world_view_transform (4, 4), strides wvt_r / wvt_c
  const float* center;    // camera_center (3,), stride center_s
  const float* tanx;      // tan_half_fovx ()
  const float* tany;      // tan_half_fovy ()
  float* acr;             // (N, 3) cr = acr + X·bcr + Y·ccr
  float* bcr;             // (N, 3)
  float* ccr;             // (N, 3)
  float* det;             // (N,) det(M)
  float* xy;              // (N, 2) the projected centre
  float* depth;           // (N,) the centre's view-space z
  float* conic;           // (N, 3) the binning's circle (lam, 0, lam)
  float* color;           // (N, 3)
  float* opa_eff;         // (N,) opacity where valid, else 0
  float* radius;          // (N,) 0 where culled
  bool* valid;            // (N,)
  float* normal;          // (N, 3) view-space normal, flipped toward the camera
  int scale_stride, sh_stride, wvt_r, wvt_c, center_s, n, width, height;
  float margin;           // 3·sqrt(FILTER_2D_VAR) in f32
};

// The chain's library calls, in the summation order measured on the card
// (torch 2.11, CUDA 12.8, at 262,144 and 331,744 surfels).
// (x, y, z) @ (m0, m1, m2)ᵀ, the (N, 3) @ (3, 3) GEMM: an FMA chain over k
// from the first product
__device__ __forceinline__ float gemm3(float x, float y, float z, float m0, float m1,
                                       float m2) {
  return __fmaf_rn(z, m2, __fmaf_rn(y, m1, __fmul_rn(x, m0)));
}
// torch.sum over a last dim of 3: norm3's lane tree
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, c), b);
}
// torch.linalg.cross's a·d − b·c, as nvcc contracts it in the library's
// kernel: b·c rounded, then one FMA
__device__ __forceinline__ float cross_term(float a, float d, float b, float c) {
  return __fmaf_rn(a, d, -mul(b, c));
}
// torch.linalg.vector_norm over a last dim of 2
__device__ __forceinline__ float norm2(float x, float y) {
  return sqrtf(add(mul(x, x), mul(y, y)));
}
// amax / amin: NaN propagates
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

template <int DEG>
__global__ void __launch_bounds__(THREADS) surfel_setup_kernel(SurfelArgs a) {
  // the camera, read once per block: W (4x4), centre, tan x / y
  __shared__ float cam[21];
  const int t = threadIdx.x;
  if (t < 16) cam[t] = a.wvt[(t >> 2) * a.wvt_r + (t & 3) * a.wvt_c];
  else if (t < 19) cam[t] = a.center[(t - 16) * a.center_s];
  else if (t == 19) cam[t] = *a.tanx;
  else if (t == 20) cam[t] = *a.tany;
  __syncthreads();
  const int i = blockIdx.x * THREADS + t;
  if (i >= a.n) return;
  const float* W = cam;   // Rv = W[0:3, 0:3], tv = W[3, 0:3]
  const float fw = static_cast<float>(a.width), fh = static_cast<float>(a.height);

  // the rotation's columns of the normalised quaternion (_rot_cols)
  const float* q = a.rot + 4 * i;
  const float qn = add(norm4(q[0], q[1], q[2], q[3]), 1e-8f);
  const float qw = dvd(q[0], qn), qx = dvd(q[1], qn), qy = dvd(q[2], qn),
              qz = dvd(q[3], qn);
  const float su = a.scales[static_cast<int64_t>(i) * a.scale_stride];
  const float sv = a.scales[static_cast<int64_t>(i) * a.scale_stride + 1];
  const float tu[3] = {mul(sub(1.f, mul(2.f, add(mul(qy, qy), mul(qz, qz)))), su),
                       mul(mul(2.f, add(mul(qx, qy), mul(qw, qz))), su),
                       mul(mul(2.f, sub(mul(qx, qz), mul(qw, qy))), su)};
  const float tv[3] = {mul(mul(2.f, sub(mul(qx, qy), mul(qw, qz))), sv),
                       mul(sub(1.f, mul(2.f, add(mul(qx, qx), mul(qz, qz)))), sv),
                       mul(mul(2.f, add(mul(qy, qz), mul(qw, qx))), sv)};
  const float nw[3] = {mul(2.f, add(mul(qx, qz), mul(qw, qy))),
                       mul(2.f, sub(mul(qy, qz), mul(qw, qx))),
                       sub(1.f, mul(2.f, add(mul(qx, qx), mul(qy, qy))))};

  // view space: p = means @ Rv + tv, the axes and the normal @ Rv
  const float px = a.means[3 * i], py = a.means[3 * i + 1], pz = a.means[3 * i + 2];
  float p[3], u[3], v[3], nv[3];
  for (int j = 0; j < 3; ++j) {
    p[j] = add(gemm3(px, py, pz, W[j], W[4 + j], W[8 + j]), W[12 + j]);
    u[j] = gemm3(tu[0], tu[1], tu[2], W[j], W[4 + j], W[8 + j]);
    v[j] = gemm3(tv[0], tv[1], tv[2], W[j], W[4 + j], W[8 + j]);
    nv[j] = gemm3(nw[0], nw[1], nw[2], W[j], W[4 + j], W[8 + j]);
  }
  // n = -sign(n·p) n: toward the camera (zero where n·p is 0)
  const float np_ = sum3(mul(nv[0], p[0]), mul(nv[1], p[1]), mul(nv[2], p[2]));
  const float flip = -static_cast<float>((np_ > 0.f) - (np_ < 0.f));

  // M's rows, the (x·w, y·w, w) forms over (u, v, 1): cx = (W - 1) / 2
  const float fx = mul(dvd(1.f, mul(2.f, cam[19])), fw);
  const float fy = mul(dvd(1.f, mul(2.f, cam[20])), fh);
  const float cx = (a.width - 1) * 0.5f, cy = (a.height - 1) * 0.5f;
  const float Mx[3] = {add(mul(fx, u[0]), mul(cx, u[2])), add(mul(fx, v[0]), mul(cx, v[2])),
                       add(mul(fx, p[0]), mul(cx, p[2]))};
  const float My[3] = {add(mul(fy, u[1]), mul(cy, u[2])), add(mul(fy, v[1]), mul(cy, v[2])),
                       add(mul(fy, p[1]), mul(cy, p[2]))};
  const float Mw[3] = {u[2], v[2], p[2]};
  // _surfel_coeffs: acr = Mx × My, bcr = My × Mw, ccr = Mw × Mx, det = Mw · acr
  auto cross = [](const float* x, const float* y, float* out) {
    out[0] = cross_term(x[1], y[2], x[2], y[1]);
    out[1] = cross_term(x[2], y[0], x[0], y[2]);
    out[2] = cross_term(x[0], y[1], x[1], y[0]);
  };
  float acr[3], bcr[3], ccr[3];
  cross(Mx, My, acr);
  cross(My, Mw, bcr);
  cross(Mw, Mx, ccr);
  const float det = sum3(mul(Mw[0], acr[0]), mul(Mw[1], acr[1]), mul(Mw[2], acr[2]));

  // the centre on the screen, and the radius over the four ±3σ endpoints
  const float z = p[2];
  const float w = clamp_min(z, 1e-6f);
  const float cxy = add(dvd(mul(fx, p[0]), w), cx);
  const float cyy = add(dvd(mul(fy, p[1]), w), cy);
  float rad = 0.f, zmin = 0.f;
  for (int e = 0; e < 4; ++e) {
    const float* axis = e < 2 ? u : v;
    float end[3];
    for (int j = 0; j < 3; ++j) {
      const float d = mul(3.f, axis[j]);
      end[j] = (e & 1) ? sub(p[j], d) : add(p[j], d);
    }
    const float ze = clamp_min(end[2], 1e-6f);
    const float ex = add(dvd(mul(fx, end[0]), ze), cx);
    const float ey = add(dvd(mul(fy, end[1]), ze), cy);
    const float r = norm2(sub(ex, cxy), sub(ey, cyy));
    rad = e == 0 ? r : maximum(rad, r);
    zmin = e == 0 ? end[2] : minimum(zmin, end[2]);
  }
  rad = ceilf(add(rad, a.margin));
  const bool valid = (z > 0.2f) && (zmin > 0.05f) && (add(cxy, rad) > 0.f) &&
                     (sub(cxy, rad) < fw) && (add(cyy, rad) > 0.f) && (sub(cyy, rad) < fh);
  const float radius = valid ? rad : 0.f;

  // the binning's isotropic conic lam = 2·tau / R², tau floored at 1e-6
  const float opa = a.opacity[i];
  const float tau = logf(mul(clamp_min(opa, 1e-12f), 255.f));
  const float rc = clamp_min(radius, 1.f);
  const float lam = dvd(mul(2.f, clamp_min(tau, 1e-6f)), mul(rc, rc));

  sh_color<DEG>(a.shs + static_cast<int64_t>(i) * a.sh_stride, sub(px, cam[16]),
                sub(py, cam[17]), sub(pz, cam[18]), a.color + 3 * i);
  for (int j = 0; j < 3; ++j) {
    a.acr[3 * i + j] = acr[j];
    a.bcr[3 * i + j] = bcr[j];
    a.ccr[3 * i + j] = ccr[j];
    a.normal[3 * i + j] = mul(flip, nv[j]);
  }
  a.det[i] = det;
  a.xy[2 * i] = cxy;
  a.xy[2 * i + 1] = cyy;
  a.depth[i] = z;
  a.conic[3 * i] = lam;
  a.conic[3 * i + 1] = 0.f;
  a.conic[3 * i + 2] = lam;
  a.opa_eff[i] = valid ? opa : 0.f;
  a.radius[i] = radius;
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

// The gradients of gd_project's inputs from the cotangents of its
// differentiable outputs (see ProjectBwdArgs); camera and sizes as gd_project.
extern "C" int gd_project_bwd(const void* means, int means_s, const void* shs, int shs_s,
                              int sh_k, const void* scales, int scales_s, const void* rot,
                              int rot_s, const void* offset, int off_s, int bf16,
                              const float* g_xy, const float* g_depth, const float* g_conic,
                              const float* g_color, const float* g_opa, void* d_means,
                              void* d_shs, void* d_opa, void* d_scales, void* d_rot,
                              void* d_off, const float* wvt, int wvt_r, int wvt_c,
                              const float* fpt, int fpt_r, int fpt_c, const float* center,
                              int center_s, const float* tanx, const float* tany, int n,
                              int width, int height, int degree, void* stream) {
  if (n <= 0) return 0;
  ProjectBwdArgs a{means, shs, scales, rot, offset, g_xy, g_depth, g_conic, g_color, g_opa,
                   d_means, d_shs, d_opa, d_scales, d_rot, d_off, wvt, fpt, center, tanx,
                   tany, means_s, shs_s, sh_k, scales_s, rot_s, off_s, bf16, wvt_r, wvt_c,
                   fpt_r, fpt_c, center_s, n, width, height};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: project_bwd_kernel<0><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 1: project_bwd_kernel<1><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 2: project_bwd_kernel<2><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 3: project_bwd_kernel<3><<<blocks(n), THREADS, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gd_surfel_setup(const float* means, const float* scales, int scale_stride,
                               const float* rot, const float* opacity, const float* shs,
                               int sh_stride, const float* wvt, int wvt_r, int wvt_c,
                               const float* center, int center_s, const float* tanx,
                               const float* tany, int n, int width, int height, int degree,
                               float margin, float* acr, float* bcr, float* ccr, float* det,
                               float* xy, float* depth, float* conic, float* color,
                               float* opa_eff, float* radius, bool* valid, float* normal,
                               void* stream) {
  if (n <= 0) return 0;
  SurfelArgs a{means, scales, rot, opacity, shs, wvt, center, tanx, tany, acr, bcr, ccr,
               det, xy, depth, conic, color, opa_eff, radius, valid, normal,
               scale_stride, sh_stride, wvt_r, wvt_c, center_s, n, width, height, margin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: surfel_setup_kernel<0><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 1: surfel_setup_kernel<1><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 2: surfel_setup_kernel<2><<<blocks(n), THREADS, 0, s>>>(a); break;
    case 3: surfel_setup_kernel<3><<<blocks(n), THREADS, 0, s>>>(a); break;
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
