// Exclusive complex cumulative product for Hopper (sm_90a): kernel D.
//
// Replaces audiotools_tpu/ops/pallas_kernels.py::rotation_cumprod (Pallas
// body _rot_scan_kernel). For every row of the real-pair planes (ur, ui):
//     P[0] = c,   P[s + 1] = P[s] u[s],
// kernel B's phasor recurrence without the magnitudes.
//
// What bounds it: memory. Each step reads one complex value and writes one
// (16 bytes for 6 FLOP); at 65,600 rows x 432 steps that is ~0.45 GB of
// traffic, and the recurrence is sequential in s.
//
// Design: one thread per row carries P in registers through all steps, in
// the operation order of the plain PyTorch version, built without FMA
// contraction (see _build.py), so the two agree bit for bit. The planes are
// row-major (rows, n), so a thread walking its row would read with stride
// n. Instead a block of R rows (R threads) stages tiles of STEPS steps of
// its rows in shared memory, coalesced; the threads scan the tile's steps
// out of shared memory, BATCH rotations read before BATCH steps advance,
// and write P back into the same slots; the block stores the tile the way
// it copied it.
//
// The copies are asynchronous (cp.async) into a ring of STAGES tiles:
// while tile k is scanned, tiles k + 1 .. k + STAGES - 1 are in flight and
// the stores of tile k - 1 drain. Each thread copies and stores the same
// slots, so it refills the stage it has just stored without waiting for
// the others, and one barrier a tile (all copies of tile k landed, all
// scans of tile k - 1 done) is the only synchronisation.
//
// Two layouts of a tile (struct Tile). Wide, when every row starts on 16
// bytes (n % 4 == 0 and aligned planes, as at the pitch shift's 432
// steps): 16-byte copies that bypass L1 (cp.async.cg), row-major with a
// pitch of STEPS + 4 words, so that 16-byte reads of eight neighbouring
// rows fall in distinct bank groups. Narrow, for any n: 4-byte copies (the
// only size besides 8 and 16, all of which must go through L1), transposed
// [step][R + 1], a warp copying 32 steps of one row at a time. Measured on
// an H100, the copies that allocate in L1 hold the reads to about half the
// memory rate; the wide route reaches ~72% of the bound where the narrow
// one reaches ~66% (PERF.md). The route comes from
// ops/hopper_kernels.py::rotation_plan, which takes R = 128, STEPS and
// STAGES from the build's -D flags (_build.DEFINES): three stages of
// 128-row tiles take 108 KB, so an SM holds two blocks.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = ROT_ROWS;  // rows a block, one thread each
constexpr int STEPS = ROT_STEPS;  // steps per tile
constexpr int STAGES = ROT_STAGES;  // tiles in the ring: two in flight while one is scanned
static_assert(STEPS == 32, "a warp's lanes, or eight 16-byte chunks, copy a tile's steps");
static_assert(ROWS % 32 == 0 && ROWS <= 1024 && STAGES >= 2, "whole warps, one block, a ring");
constexpr int BATCH = 8;  // steps whose rotations a thread reads before it scans them
constexpr int WIDE_PITCH = STEPS + 4;  // words a row of a wide tile takes

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A stage holds one tile of ROWS rows x STEPS steps in two planes (re, im).
// Narrow (any n): 4-byte copies, transposed, [step][ROWS + 1]; a warp
// copies 32 steps of one row at a time. Wide (n % 4 == 0, 16-byte aligned
// planes): 16-byte copies that bypass L1, row-major, [row][WIDE_PITCH];
// eight lanes copy one row's 32 steps, a warp four rows at a time.
template <bool WIDE>
struct Tile {
  static constexpr int PLANE = WIDE ? ROWS * WIDE_PITCH : STEPS * (ROWS + 1);
  static constexpr int STAGE = 2 * PLANE;
  static constexpr int SMEM_PER_STAGE = STAGE * static_cast<int>(sizeof(float));
  // the word of step k of row r in a plane
  __device__ static int at(int r, int k) { return WIDE ? r * WIDE_PITCH + k : k * (ROWS + 1) + r; }
};

template <bool WIDE>
__global__ void __launch_bounds__(ROWS)
rotation_cumprod_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
                        const float* __restrict__ cr, const float* __restrict__ ci,
                        float* __restrict__ pr, float* __restrict__ pi, int rows, int n) {
  using L = Tile<WIDE>;
  constexpr int WARPS = ROWS / 32;
  extern __shared__ __align__(16) float ring[];  // [STAGES][2 planes][L::PLANE]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int live = static_cast<int>(min(static_cast<long long>(ROWS), rows - r0));
  const int tiles = (n + STEPS - 1) / STEPS;

  // Each thread copies, and later stores, the same slots of every tile.
  // Narrow: step (tile * STEPS + lane) of the rows warp, warp + WARPS, ...
  // Wide: 16-byte chunk c & 7 of row c >> 3, c = threadIdx.x + j * ROWS.
  auto copy_tile = [&](int t, float* stage) {
    if constexpr (WIDE) {
#pragma unroll
      for (int j = 0; j < STEPS / 4; ++j) {
        const int c = threadIdx.x + j * ROWS;
        const int r = c >> 3;
        const int k = 4 * (c & 7);
        if (r < live && t * STEPS + k < n) {
          const long long g = (r0 + r) * n + t * STEPS + k;
          copy16(stage + L::at(r, k), ur + g);
          copy16(stage + L::PLANE + L::at(r, k), ui + g);
        }
      }
    } else {
      const int s = t * STEPS + lane;
      if (s >= n) return;
      const long long first = (r0 + warp) * n + s;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int r = warp + j * WARPS;
        if (r < live) {
          const long long g = first + static_cast<long long>(j * WARPS) * n;
          copy4(stage + L::at(r, lane), ur + g);
          copy4(stage + L::PLANE + L::at(r, lane), ui + g);
        }
      }
    }
  };
  auto store_tile = [&](int t, const float* stage) {
    if constexpr (WIDE) {
#pragma unroll
      for (int j = 0; j < STEPS / 4; ++j) {
        const int c = threadIdx.x + j * ROWS;
        const int r = c >> 3;
        const int k = 4 * (c & 7);
        if (r < live && t * STEPS + k < n) {
          const long long g = (r0 + r) * n + t * STEPS + k;
          *reinterpret_cast<float4*>(pr + g) = *reinterpret_cast<const float4*>(stage + L::at(r, k));
          *reinterpret_cast<float4*>(pi + g) =
              *reinterpret_cast<const float4*>(stage + L::PLANE + L::at(r, k));
        }
      }
    } else {
      const int s = t * STEPS + lane;
      if (s >= n) return;
      const long long first = (r0 + warp) * n + s;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int r = warp + j * WARPS;
        if (r < live) {
          const long long g = first + static_cast<long long>(j * WARPS) * n;
          pr[g] = stage[L::at(r, lane)];
          pi[g] = stage[L::PLANE + L::at(r, lane)];
        }
      }
    }
  };

  float ar = 1.0f;
  float ai = 0.0f;
  if (static_cast<int>(threadIdx.x) < live) {
    ar = cr[r0 + threadIdx.x];
    ai = ci[r0 + threadIdx.x];
  }

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) copy_tile(t, ring + t * L::STAGE);
    commit();
  }
  int cur = 0;  // stage of tile t
  for (int t = 0; t < tiles; ++t) {
    wait_copies<STAGES - 2>();  // this thread's copies of tile t landed
    __syncthreads();  // everyone's copies of tile t landed, scans of tile t - 1 done
    const int prev = cur == 0 ? STAGES - 1 : cur - 1;
    float* prev_stage = ring + prev * L::STAGE;
    if (t > 0) store_tile(t - 1, prev_stage);
    // tile t + STAGES - 1 goes into the stage this thread has just stored
    if (t + STAGES - 1 < tiles) copy_tile(t + STAGES - 1, prev_stage);
    commit();

    // the scan: BATCH rotations read, then BATCH steps advanced, each
    // emitting P into the slot its rotation came from
    float* sr = ring + cur * L::STAGE;
    float* si = sr + L::PLANE;
    const int steps = min(STEPS, n - t * STEPS);
#pragma unroll
    for (int k0 = 0; k0 < STEPS; k0 += BATCH) {
      if (k0 >= steps) break;
      float u_r[BATCH];
      float u_i[BATCH];
      float o_r[BATCH];
      float o_i[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; j += 4) {
        if constexpr (WIDE) {  // 16-byte reads; n % 4 == 0, so whole quads
          const float4 a = *reinterpret_cast<const float4*>(sr + L::at(threadIdx.x, k0 + j));
          const float4 b = *reinterpret_cast<const float4*>(si + L::at(threadIdx.x, k0 + j));
          u_r[j] = a.x, u_r[j + 1] = a.y, u_r[j + 2] = a.z, u_r[j + 3] = a.w;
          u_i[j] = b.x, u_i[j + 1] = b.y, u_i[j + 2] = b.z, u_i[j + 3] = b.w;
        } else {
#pragma unroll
          for (int q = j; q < j + 4; ++q) {
            u_r[q] = sr[L::at(threadIdx.x, k0 + q)];
            u_i[q] = si[L::at(threadIdx.x, k0 + q)];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        o_r[j] = ar;  // emit before advancing
        o_i[j] = ai;
        const float nr = ar * u_r[j] - ai * u_i[j];
        const float ni = ar * u_i[j] + ai * u_r[j];
        ar = nr;
        ai = ni;
      }
      // steps past the row's end advanced a carry nobody reads again; their
      // slots are written but never stored
#pragma unroll
      for (int j = 0; j < BATCH; j += 4) {
        if constexpr (WIDE) {
          *reinterpret_cast<float4*>(sr + L::at(threadIdx.x, k0 + j)) =
              make_float4(o_r[j], o_r[j + 1], o_r[j + 2], o_r[j + 3]);
          *reinterpret_cast<float4*>(si + L::at(threadIdx.x, k0 + j)) =
              make_float4(o_i[j], o_i[j + 1], o_i[j + 2], o_i[j + 3]);
        } else {
#pragma unroll
          for (int q = j; q < j + 4; ++q) {
            sr[L::at(threadIdx.x, k0 + q)] = o_r[q];
            si[L::at(threadIdx.x, k0 + q)] = o_i[q];
          }
        }
      }
    }
    cur = cur == STAGES - 1 ? 0 : cur + 1;
  }
  __syncthreads();  // scans of the last tile done
  store_tile(tiles - 1, ring + (cur == 0 ? STAGES - 1 : cur - 1) * L::STAGE);
}

template <bool WIDE>
int launch(const float* ur, const float* ui, const float* cr, const float* ci, float* pr,
           float* pi, int rows, int n, int smem, int blocks, cudaStream_t stream) {
  if (smem < STAGES * Tile<WIDE>::SMEM_PER_STAGE) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rotation_cumprod_kernel<WIDE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, ROWS, smem, stream>>>(ur, ui, cr, ci, pr, pi, rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ur, ui, pr, pi: (rows, n) float32; cr, ci: (rows,) float32; all contiguous
// on the current device. wide (1: 16-byte copies, which need n % 4 == 0 and
// 16-byte aligned planes; 0: 4-byte copies, any n), smem (the ring's bytes
// a block) and blocks (one per ROWS rows) as rotation_plan gives them; a
// plan that does not match this build is refused. Launches on `stream`;
// returns a CUDA error code (0 on success).
extern "C" int rotation_cumprod(const float* ur, const float* ui, const float* cr,
                                const float* ci, float* pr, float* pi, int rows, int n,
                                int wide, int smem, int blocks, cudaStream_t stream) {
  if (rows < 1 || n < 1 || blocks != (rows + ROWS - 1) / ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (wide) {
    const bool aligned = ((reinterpret_cast<unsigned long long>(ur) |
                           reinterpret_cast<unsigned long long>(ui) |
                           reinterpret_cast<unsigned long long>(pr) |
                           reinterpret_cast<unsigned long long>(pi)) & 15) == 0;
    if (n % 4 != 0 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
    return launch<true>(ur, ui, cr, ci, pr, pi, rows, n, smem, blocks, stream);
  }
  return launch<false>(ur, ui, cr, ci, pr, pi, rows, n, smem, blocks, stream);
}
