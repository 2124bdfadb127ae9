// build_niels_table: the partition table of a fixed-generator handle.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_build_split_tiled (:806) /
// build_split_table (:843), niels form (body :773-780, batch inversion
// _lane_batch_invert :709). Entry v of group g is the sum of the generators
// g*w + j over the set bits j of v (entry 0 is the identity), stored affine
// as (y + x, y - x, 2d*x*y): 24 canonical words, 96 bytes. There is no byte
// split: that only fed the TPU's matrix unit.
//
// Bound: integer multiplies. A group of 256 entries needs ~4.3k field
// multiplies (247 adds, one Montgomery batch inversion, 4 multiplies an
// entry to the affine form); one inversion an entry would cost 265
// multiplies each, ~76k a group.
//
// Design (table_build.cuh): a run is a group's 2^w entries (w <= 8) or 256
// consecutive entries of a wider group, spread over 2^L lanes (L = min(w,
// 2); 32 >> L runs a warp). (1) Each lane forms its row 0 (at w = 8: 2 adds
// in step with the other lanes), then walks its other 63 rows in Gray-code
// order, one add each with all lanes at work, only the running sum live;
// it parks each row as (X c, Y c, Z) in the row's own 96 bytes of the table
// (c: the product of the Z walked before), so the build needs no memory
// beside the table. (2) The run's lanes scan their Z products with
// shuffles both ways. (3) One inversion for the block's runs: their
// products (32 at w = 8) are inverted side by side, one a thread of the
// first warp, between two block barriers. (4) Each lane walks back:
// x = (X c) / (c Z), y likewise, two multiplies to 1/(c Z) and four to the
// niels entry, which overwrites the parked one. A run of a group wider
// than 8 starts from the sum of its points 8 and up over the set bits of
// its index (each lane forms it). One add in one loop, and one multiply
// body for all the multiplies, keep the kernel small for the instruction
// cache and the registers few.
#include <cuda_runtime.h>

#include "table_build.cuh"

using namespace btt;

namespace {

constexpr int kWarps = 4;                   // warps a block
constexpr int kBlockRuns = kWarps * 16;     // most runs a block: kWarps * (32 >> L)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ fe shfl_up_fe(const fe& a, int d, int width) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_up_sync(kFull, a.v[i], d, width);
  return r;
}

__device__ __forceinline__ fe shfl_down_fe(const fe& a, int d, int width) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_down_sync(kFull, a.v[i], d, width);
  return r;
}

__global__ void __launch_bounds__(32 * kWarps)
build_niels_table_kernel(point_ptrs pts, int w, int64_t runs, uint32_t* table) {
  __shared__ ge_cached gens[kWarps][kWarpPoints];
  __shared__ fe totals[kBlockRuns];
  const run_shape shape = run_shape_of(w);
  const int L = shape.L, bits = shape.bits, width = 1 << L;
  const int wide = w - bits;  // a group has 2^wide runs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = 32 >> L;
  const int64_t first = ((int64_t)blockIdx.x * kWarps + warp) * per_warp;
  for (int i = lane; i < per_warp * bits; i += 32) {
    int64_t r = first + i / bits;
    if (r < runs) gens[warp][i] = ge_to_cached(ge_load(pts, (r >> wide) * w + i % bits), fe_mul_call_op());
  }
  __syncwarp();
  const int seg = lane >> L, t = lane & (width - 1);
  const int64_t r = first + seg;
  const bool live = r < runs;
  // run r's first entry is entry r * 2^bits of the table
  const niels_rows rows{reinterpret_cast<word4*>(table) + (live ? r << bits : 0) * 6, L, t};
  fe c = fe_one();
  if (live) {
    group_point point{pts, (r >> wide) * w};
    c = niels_lane_park(gens[warp] + seg * bits, L, shape.H, run_start(point, w, r & ((1 << wide) - 1)), rows);
  }
  // the products of the run's lanes before (E) and after (S) this one
  fe incl = c, sufx = c;
  for (int d = 1; d < width; d <<= 1) {
    fe up = shfl_up_fe(incl, d, width);
    fe down = shfl_down_fe(sufx, d, width);
    if (t >= d) incl = fe_mul_call(incl, up);
    if (t + d < width) sufx = fe_mul_call(sufx, down);
  }
  fe E = shfl_up_fe(incl, 1, width);
  fe S = shfl_down_fe(sufx, 1, width);
  if (t == 0) E = fe_one();
  if (t == width - 1) {
    S = fe_one();
    totals[warp * per_warp + seg] = incl;
  }
  __syncthreads();
  if (threadIdx.x < kWarps * per_warp) totals[threadIdx.x] = fe_invert(totals[threadIdx.x], fe_mul_call_op());
  __syncthreads();
  if (live) niels_lane_store(shape.H, fe_mul_call(fe_mul_call(totals[warp * per_warp + seg], S), E), rows);
}

}  // namespace

// points: four (16, groups * w) int32 coordinate arrays with the given limb
// stride; table: (groups, 2^w, 3, 8) 32-bit words; 1 <= w <= 16.
extern "C" int btt_build_niels_table(const void* x, const void* y, const void* z,
                                     const void* t, int64_t limb_stride, int w,
                                     int64_t groups, void* table, void* stream) {
  if (w < 1 || w > 16) return (int)cudaErrorInvalidValue;
  point_ptrs pts;
  pts.c[0] = (const int32_t*)x;
  pts.c[1] = (const int32_t*)y;
  pts.c[2] = (const int32_t*)z;
  pts.c[3] = (const int32_t*)t;
  pts.limb_stride = limb_stride;
  if (groups > 0) {
    run_shape s = run_shape_of(w);
    int64_t runs = groups << (w - s.bits);
    int64_t per_block = (int64_t)kWarps * (32 >> s.L);
    unsigned blocks = (unsigned)((runs + per_block - 1) / per_block);
    build_niels_table_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(pts, w, runs,
                                                                            (uint32_t*)table);
  }
  return (int)cudaGetLastError();
}
