// ed_to_niels, ed_file_rows, ed_file_entries, ed_niels_points, ed_affine,
// ed_from_affine_rows: a ristretto255 table's conversions between extended
// points, niels words and the reference's raw file rows, and the generator
// disk cache's affine form and its load, one launch a chunk each
// (ed_convert.cuh holds the bodies).
//
// Replace, on the handle files' paths, the conversions that ran as chains
// of blitzar_tpu/ops/pallas_point.py:_fmul_tiled (:130) launches:
// - ed_to_niels: a point table's z inverted by a batch inversion of 3 x 255
//   fmul scan launches over rows of 256 entries a chunk, one
//   _finvert_tiled (:172) launch of the row totals, then 3 fmul for x / z,
//   y / z and 2d x y (blitzar_tpu/msm/fixed.py:197-220, the npz read);
// - ed_file_rows: 3 fmul a chunk around plain unpack and word passes
//   (blitzar_tpu/msm/interop.py's raw write);
// - ed_file_entries: 2 fmul a chunk (the raw read);
// - ed_niels_points: 3 fmul a chunk around a plain unpack, F.sub / F.add
//   and 4 plain canonicalize passes (blitzar_tpu/msm/fixed.py:397-414's
//   ed.niels_to_p3, the npz write);
// - ed_affine: _finvert_tiled (:172) of z and 2 fmul, then plain
//   canonicalize passes (blitzar_tpu/generators.py:132-144, the disk
//   cache's save), or 3 fmul (a legacy extended file's load);
// - ed_from_affine_rows: a device-side astype of the file's uint16 rows and
//   one fmul for t (blitzar_tpu/generators.py:62-72, _affine_to_p3_chunk,
//   the cache's load), where the port widened the rows to int32 on the host,
//   copied twice the file's bytes and launched fmul on them.
//
// Design. ed_to_niels follows w_affine.cu: thread t of a warp inverts the z
// of entries t + 32 j of the warp's tile of 32 x per entries by
// Montgomery's trick, the prefixes parked in the words it writes later, one
// inversion (fe_invert, ~265 multiplies) a thread; per is the chunk over
// 2^15 threads, a compile-time 32, 64 or 128 (a run-time count spilled in
// w_affine). 7 multiplies an entry, every one a call of the one
// non-inlined body fe_mul_call. Bound: bytes at the function's least work
// (x, y, z read and 96 bytes written an entry, against 7 multiplies); a
// thread's own inversion adds about 4 multiplies an entry at 64 entries a
// thread. 64 and 32 entries a thread tied at a 2^21 chunk, 128 (2^14
// threads, the card half empty) took 1.5x as long (PERF.md §6).
// ed_file_rows and ed_file_entries: one thread an entry in a grid-stride
// loop over int64_t indices (a 2^20 handle has 2^25 entries), 3 and 2
// multiplies inlined. Bound: bytes (64 read and 120 written an entry, or
// 80 and 96), which the public 16-bit limbs of the fmul chains doubled.
// The 120-byte rows go through shared memory, a block's rows at a time, so
// that a warp reads and writes them as consecutive words: a thread's own
// 8-byte accesses at a 120-byte stride used a quarter of each 32-byte
// sector (ed_file_rows then took 1.46 ms at a 2^22 chunk, 6.4x its bound;
// PERF.md §6).
// ed_niels_points: one thread an entry in a grid-stride loop, as
// ed_file_rows, 3 multiplies inlined; it writes z = 1 too, so the caller
// makes no pass of its own. Bound: bytes (64 of the entry's 96 read, four
// coordinates of 16 int32 limbs written). ed_affine: ed_to_niels's batch
// inversion, the prefixes parked in the output's t, 8, 16, 32 or 64 entries
// a thread, the fewest that keep the launch within 2^15 threads (a thread's
// inversion chain is its latency: 8 a thread took 0.211 ms at 2^16 where
// 16 took 0.267, 32 took 0.478 at 2^20 where 16 took 0.515; PERF.md §6),
// 6 multiplies an entry and a thread's inversion. Bound: bytes (x, y, z
// read, four coordinates written) over operations.
// ed_from_affine_rows: one thread an entry in a grid-stride loop, as
// ed_niels_points; each of the 32 limb rows read as 16-bit words, a warp's
// 64 consecutive bytes, and widened in registers; one multiply inlined.
// Bound: bytes (64 read, four coordinates of 16 int32 limbs written an
// entry).
#include <cuda_runtime.h>

#include "ed_convert.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTargetThreads = 1 << 15;
// ed_file_entries_kernel's blocks: its tiles of rows in and words out
// take 27 KB of shared memory
constexpr int kEntryThreads = 128;
// the grid-stride loops' blocks: enough to fill 132 SMs several times over
constexpr int64_t kMaxBlocks = 132 * 32;

template <int kPer>
__global__ void __launch_bounds__(kThreads) ed_to_niels_kernel(point_ptrs p, int64_t count, uint32_t* out) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * 32 * kPer;
  const int64_t left = count - tile - lane;
  if (left <= 0) return;
  const int n = (int)(left < 32LL * kPer ? (left + 31) / 32 : kPer);
  niels_entries<fe_mul_call_op>(p, out, tile + lane, 32, n);
}

template <int kPer>
void launch_to_niels(const point_ptrs& p, int64_t count, uint32_t* out, cudaStream_t stream) {
  const int64_t threads = (count + 32LL * kPer - 1) / (32LL * kPer) * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  ed_to_niels_kernel<kPer><<<(unsigned)blocks, kThreads, 0, stream>>>(p, count, out);
}

unsigned blocks_for(int64_t count, int threads) {
  const int64_t blocks = (count + threads - 1) / threads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// the entries of a block's tile from base: at most a block's threads
__device__ int tile_entries(int64_t count, int64_t base, int threads) {
  return (int)(count - base < threads ? count - base : threads);
}

// Each thread writes its entry's row into the block's tile of rows, then
// the block copies the tile out, consecutive threads on consecutive words.
__global__ void __launch_bounds__(kThreads) ed_file_rows_kernel(const uint32_t* words, int64_t count, uint64_t* rows) {
  __shared__ uint64_t tile[kThreads * kFileWords];  // 30 KB
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < count; base += (int64_t)gridDim.x * kThreads) {
    const int n = tile_entries(count, base, kThreads);
    if (threadIdx.x < n) {
      niels_file_row(words + kNielsWords * (base + threadIdx.x), tile + kFileWords * threadIdx.x, fe_mul_op());
    }
    __syncthreads();
    uint64_t* dst = rows + kFileWords * base;
    for (int i = threadIdx.x; i < n * kFileWords; i += kThreads) dst[i] = tile[i];
    __syncthreads();
  }
}

// The block reads its tile of rows in, consecutive threads on consecutive
// words; each thread converts its row into the tile of entries, which the
// block writes out as 16-byte words.
__global__ void __launch_bounds__(kEntryThreads)
ed_file_entries_kernel(const uint64_t* rows, int64_t count, uint32_t* words) {
  __shared__ uint64_t in[kEntryThreads * kFileWords];                   // 15 KB
  __shared__ __align__(16) uint32_t out[kEntryThreads * kNielsWords];  // 12 KB
  for (int64_t base = (int64_t)blockIdx.x * kEntryThreads; base < count; base += (int64_t)gridDim.x * kEntryThreads) {
    const int n = tile_entries(count, base, kEntryThreads);
    const unsigned long long* src = reinterpret_cast<const unsigned long long*>(rows + kFileWords * base);
    for (int i = threadIdx.x; i < n * kFileWords; i += kEntryThreads) in[i] = __ldg(src + i);
    __syncthreads();
    if (threadIdx.x < n) file_row_niels(in + kFileWords * threadIdx.x, out + kNielsWords * threadIdx.x, fe_mul_op());
    __syncthreads();
    word4* dst = reinterpret_cast<word4*>(words + kNielsWords * base);
    for (int i = threadIdx.x; i < n * kNielsWords / 4; i += kEntryThreads) dst[i] = reinterpret_cast<const word4*>(out)[i];
    __syncthreads();
  }
}

// One thread an entry; the output coordinates at their own limb stride (a
// chunk's slice of a whole table's point coordinates).
__global__ void __launch_bounds__(kThreads)
ed_niels_points_kernel(const uint32_t* words, int64_t count, point_out_ptrs out) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < count; e += (int64_t)gridDim.x * kThreads) {
    niels_point_store(words + kNielsWords * e, out, e, fe_mul_op());
  }
}

__global__ void __launch_bounds__(kThreads)
ed_from_affine_rows_kernel(const uint16_t* rows, int64_t count, point_out_ptrs out) {
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < count; e += (int64_t)gridDim.x * kThreads) {
    affine_row_point_store(rows, count, out, e, fe_mul_op());
  }
}

template <int kPer>
__global__ void __launch_bounds__(kThreads) ed_affine_kernel(point_ptrs p, int64_t count, point_out_ptrs out) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * 32 * kPer;
  const int64_t left = count - tile - lane;
  if (left <= 0) return;
  const int n = (int)(left < 32LL * kPer ? (left + 31) / 32 : kPer);
  ed_affine_entries<fe_mul_call_op>(p, out, tile + lane, 32, n);
}

template <int kPer>
void launch_affine(const point_ptrs& p, int64_t count, const point_out_ptrs& out, cudaStream_t stream) {
  const int64_t threads = (count + 32LL * kPer - 1) / (32LL * kPer) * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  ed_affine_kernel<kPer><<<(unsigned)blocks, kThreads, 0, stream>>>(p, count, out);
}

}  // namespace

// x, y, z: (16, count) int32 limbs at limb_stride (a point chunk's first
// three coordinates); out: (count, 3, 8) words, 16-byte aligned.
extern "C" int btt_ed_to_niels(const void* x, const void* y, const void* z, int64_t limb_stride, int64_t count,
                               void* out, void* stream) {
  if (count > 0) {
    const point_ptrs p = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z, nullptr}, limb_stride};
    uint32_t* o = (uint32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (count <= 32 * kTargetThreads) {
      launch_to_niels<32>(p, count, o, s);
    } else if (count <= 64 * kTargetThreads) {
      launch_to_niels<64>(p, count, o, s);
    } else {
      launch_to_niels<128>(p, count, o, s);
    }
  }
  return (int)cudaGetLastError();
}

// words: (count, 3, 8) niels words, 16-byte aligned; rows: (count, 15) u64.
extern "C" int btt_ed_file_rows(const void* words, int64_t count, void* rows, void* stream) {
  if (count > 0) {
    ed_file_rows_kernel<<<blocks_for(count, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, count, (uint64_t*)rows);
  }
  return (int)cudaGetLastError();
}

// rows: (count, 15) u64; words: (count, 3, 8), 16-byte aligned.
extern "C" int btt_ed_file_entries(const void* rows, int64_t count, void* words, void* stream) {
  if (count > 0) {
    ed_file_entries_kernel<<<blocks_for(count, kEntryThreads), kEntryThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)rows, count, (uint32_t*)words);
  }
  return (int)cudaGetLastError();
}

// words: (count, 3, 8) niels words, 16-byte aligned; ox, oy, oz, ot:
// (16, count) int32 coordinates at out_stride.
extern "C" int btt_ed_niels_points(const void* words, int64_t count, void* ox, void* oy, void* oz, void* ot,
                                   int64_t out_stride, void* stream) {
  if (count > 0) {
    const point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, out_stride};
    ed_niels_points_kernel<<<blocks_for(count, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, count, out);
  }
  return (int)cudaGetLastError();
}

// x, y, z: (16, count) int32 limbs at in_stride, no z 0; ox, oy, oz, ot:
// (16, count) int32 coordinates at out_stride, apart from the input.
extern "C" int btt_ed_affine(const void* x, const void* y, const void* z, int64_t in_stride, int64_t count, void* ox,
                             void* oy, void* oz, void* ot, int64_t out_stride, void* stream) {
  if (count > 0) {
    const point_ptrs p = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z, nullptr}, in_stride};
    const point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, out_stride};
    cudaStream_t s = (cudaStream_t)stream;
    if (count <= 8 * kTargetThreads) {
      launch_affine<8>(p, count, out, s);
    } else if (count <= 16 * kTargetThreads) {
      launch_affine<16>(p, count, out, s);
    } else if (count <= 32 * kTargetThreads) {
      launch_affine<32>(p, count, out, s);
    } else {
      launch_affine<64>(p, count, out, s);
    }
  }
  return (int)cudaGetLastError();
}

// rows: (2, 16, count) uint16 limbs (x, y), contiguous; ox, oy, oz, ot:
// (16, count) int32 coordinates at out_stride.
extern "C" int btt_ed_from_affine_rows(const void* rows, int64_t count, void* ox, void* oy, void* oz, void* ot,
                                       int64_t out_stride, void* stream) {
  if (count > 0) {
    const point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, out_stride};
    ed_from_affine_rows_kernel<<<blocks_for(count, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)rows, count, out);
  }
  return (int)cudaGetLastError();
}
