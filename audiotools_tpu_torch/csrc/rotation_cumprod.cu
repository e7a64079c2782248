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
// Design: one thread per row carries P in registers through all steps, as
// kernel B does. The planes are row-major (rows, n), so a thread walking
// its row would read with stride n. Instead a block of ROWS threads stages
// a tile of STEPS steps of its ROWS rows in shared memory: each warp reads
// STEPS consecutive steps of one row at a time (coalesced) and stores them
// transposed, the threads run the tile's steps out of shared memory, write
// P back into the same slots, and the warps store the tile the way they
// loaded it. The tile's row pitch of ROWS + 1 words keeps both the
// transposed stores and the per-thread reads free of bank conflicts. Built
// without FMA contraction (see _build.py): each product and sum rounds on
// its own, in the operation order of the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;  // rows per block, one thread each
constexpr int STEPS = 32;  // steps per staged tile, one warp lane each

__global__ void __launch_bounds__(ROWS)
rotation_cumprod_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
                        const float* __restrict__ cr, const float* __restrict__ ci,
                        float* __restrict__ pr, float* __restrict__ pi, int rows, int n) {
  __shared__ float s_r[STEPS][ROWS + 1];
  __shared__ float s_i[STEPS][ROWS + 1];

  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = r0 + threadIdx.x;
  float ar = 1.0f;
  float ai = 0.0f;
  if (row < rows) {
    ar = cr[row];
    ai = ci[row];
  }

  for (int s0 = 0; s0 < n; s0 += STEPS) {
    const int s = s0 + lane;
    for (int rr = warp; rr < ROWS; rr += ROWS / 32) {
      const long long g = r0 + rr;
      float vr = 0.0f;
      float vi = 0.0f;
      if (g < rows && s < n) {
        vr = ur[g * n + s];
        vi = ui[g * n + s];
      }
      s_r[lane][rr] = vr;
      s_i[lane][rr] = vi;
    }
    __syncthreads();

    const int steps = min(STEPS, n - s0);
    for (int k = 0; k < steps; ++k) {
      const float u_r = s_r[k][threadIdx.x];
      const float u_i = s_i[k][threadIdx.x];
      s_r[k][threadIdx.x] = ar;  // emit before advancing
      s_i[k][threadIdx.x] = ai;
      const float nr = ar * u_r - ai * u_i;
      const float ni = ar * u_i + ai * u_r;
      ar = nr;
      ai = ni;
    }
    __syncthreads();

    for (int rr = warp; rr < ROWS; rr += ROWS / 32) {
      const long long g = r0 + rr;
      if (g < rows && s < n) {
        pr[g * n + s] = s_r[lane][rr];
        pi[g * n + s] = s_i[lane][rr];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ur, ui, pr, pi: (rows, n) float32; cr, ci: (rows,) float32; all contiguous
// on the current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int rotation_cumprod(const float* ur, const float* ui, const float* cr,
                                const float* ci, float* pr, float* pi, int rows, int n,
                                cudaStream_t stream) {
  if (rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((rows + ROWS - 1) / ROWS);
  rotation_cumprod_kernel<<<blocks, ROWS, 0, stream>>>(ur, ui, cr, ci, pr, pi, rows, n);
  return static_cast<int>(cudaGetLastError());
}
