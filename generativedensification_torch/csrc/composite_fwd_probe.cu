// Stage probes of the 3DGS forward compositor for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replace the TPU probe kernels of the JAX package's
// scripts/dev_kernel_break.py: `make_fwd` (the stage ladder of
// pallas_composite_fwd), `make_fwd_hbm` (its output written by a manual
// double-buffered DMA) and `make_fwd_tpb` (tiles per grid program).  Those
// are copies of the Pallas kernel with stages switched off; here every
// variant is an instantiation of the production sub-tile body of kernel #1
// (composite_subtile.cuh::composite_fwd_kernel), so a probe times exactly
// the code that serves and trains minus the stages it leaves out, and
// `full` is the production kernel.  What each stage writes is in the
// header; the plain PyTorch versions are splat/probe_kernels.py.
//
// Variants, by the index the wrapper passes (probe_kernels.COMPOSITE_VARIANTS):
//    0 noop    1 load    2 skip    3 power   4 alpha   5 trans   6 full
//    7 noexit (no per-sub-tile exit)   8 noskip (no footprint skip)
//    9 b128 (128 slots staged per batch)   10 trips
//   11 noop_bulk   12 full_bulk (the output by bulk asynchronous copies)
//   13 tpb2   14 tpb4 (2 or 4 consecutive sub-tiles per CTA, in turn; at
//      32 px tpb4 is one whole tile per CTA)   15 tpb2_bulk   16 tpb4_bulk
// The TPU variants pvpu / fullvpu / _high / _dflt have no counterpart: the
// power form is computed elementwise in f32 on CUDA cores here (power and
// full are that form), and no matrix unit precision is involved.
//
// Bound on an H100: as the production kernel, by f32 operations for every
// stage past load (the stage's own counts, tools/kernel_break.py).

#include "composite_subtile.cuh"

namespace {

using namespace subtile;

template <int TS, int STAGE, bool EXIT = true, bool SKIP = true, int NB = BATCH,
          int TPB = 1, bool BULK = false>
int launch(const float* table, const int* sorted_ids, const int* tile_starts,
           const int* tile_counts, float* out, int num_tiles, int tiles_x,
           cudaStream_t s) {
  const int ctas = num_tiles * SubTile<TS>::CTAS;
  if (ctas % TPB) return static_cast<int>(cudaErrorInvalidValue);
  composite_fwd_kernel<TS, EXIT, SKIP, STAGE, NB, TPB, BULK>
      <<<ctas / TPB, THREADS, 0, s>>>(table, sorted_ids, tile_starts,
                                      tile_counts, out, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int TS>
int dispatch(int variant, const float* table, const int* ids,
             const int* starts, const int* counts, float* out, int num_tiles,
             int tiles_x, cudaStream_t s) {
#define GD_ARGS table, ids, starts, counts, out, num_tiles, tiles_x, s
  switch (variant) {
    case 0: return launch<TS, stage::NOOP>(GD_ARGS);
    case 1: return launch<TS, stage::LOAD>(GD_ARGS);
    case 2: return launch<TS, stage::SKIP>(GD_ARGS);
    case 3: return launch<TS, stage::POWER>(GD_ARGS);
    case 4: return launch<TS, stage::ALPHA>(GD_ARGS);
    case 5: return launch<TS, stage::TRANS>(GD_ARGS);
    case 6: return launch<TS, stage::FULL>(GD_ARGS);
    case 7: return launch<TS, stage::FULL, false>(GD_ARGS);
    case 8: return launch<TS, stage::FULL, true, false>(GD_ARGS);
    case 9: return launch<TS, stage::FULL, true, true, 128>(GD_ARGS);
    case 10: return launch<TS, stage::TRIPS>(GD_ARGS);
    case 11: return launch<TS, stage::NOOP, true, true, BATCH, 1, true>(GD_ARGS);
    case 12: return launch<TS, stage::FULL, true, true, BATCH, 1, true>(GD_ARGS);
    case 13: return launch<TS, stage::FULL, true, true, BATCH, 2>(GD_ARGS);
    case 14: return launch<TS, stage::FULL, true, true, BATCH, 4>(GD_ARGS);
    case 15: return launch<TS, stage::FULL, true, true, BATCH, 2, true>(GD_ARGS);
    case 16: return launch<TS, stage::FULL, true, true, BATCH, 4, true>(GD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GD_ARGS
}

}  // namespace

// As gd_composite_fwd, with the variant's index first; out (num_tiles, 5,
// ts*ts) f32 holds what the variant writes.  tpb variants need the sub-tile
// count (num_tiles at 16 px, 4 num_tiles at 32 px) a multiple of their
// sub-tiles per CTA.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int gd_composite_fwd_probe(int variant, const float* table,
                                      const int* sorted_ids,
                                      const int* tile_starts,
                                      const int* tile_counts, float* out,
                                      int num_tiles, int tiles_x,
                                      int tile_size, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16)
    return dispatch<16>(variant, table, sorted_ids, tile_starts, tile_counts,
                        out, num_tiles, tiles_x, s);
  if (tile_size == 32)
    return dispatch<32>(variant, table, sorted_ids, tile_starts, tile_counts,
                        out, num_tiles, tiles_x, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
