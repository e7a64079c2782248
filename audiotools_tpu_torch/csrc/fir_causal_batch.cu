// Per-item causal FIR for Hopper (sm_90a).
//
// Replaces audiotools_tpu/ops/pallas_kernels.py::fir_conv_causal_batch
// (Pallas body _make_kernel(per_item=True)):
//     y[r, n] = sum_k h[r, k] x[r, n - k],   n < T,
// with one kernel h[r] of L <= 2048 taps per row r.
//
// What bounds it: fp32 multiply-adds on the CUDA cores. The equalizer's
// call (64 rows x 221,140 samples x 641 taps) is ~18 GFLOP against ~57 MB
// of input and output, about 320 FLOP per byte, so memory is not the limit.
// The TPU kernel reached fp32 accuracy with multi-pass Toeplitz matmuls on
// its matrix unit; here every product is an fp32 FMA, so neither TF32 nor
// bf16 rounding can enter.
//
// Design: a block owns one row and a tile of TILE consecutive outputs. It
// stages the row's kernel, reversed, and the tile's input with its (L - 1)
// sample causal halo in shared memory (zero outside [0, T)). Each thread
// then accumulates OUT_PER_THREAD outputs spaced THREADS apart, so at every
// tap the warp reads consecutive shared-memory words (no bank conflicts) and
// the tap itself is a broadcast. Shared-memory reads, about one per FMA,
// bound this first version; register blocking over taps is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int OUT_PER_THREAD = 8;
constexpr int TILE = THREADS * OUT_PER_THREAD;
constexpr int MAX_TAPS = 2048;

__global__ void __launch_bounds__(THREADS)
fir_causal_batch_kernel(const float* __restrict__ x, const float* __restrict__ h,
                        float* __restrict__ y, int T, int L) {
  __shared__ float s_h[MAX_TAPS];
  __shared__ float s_x[TILE + MAX_TAPS - 1];

  const long long row = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * TILE;
  const float* xr = x + row * T;
  const float* hr = h + row * L;

  // s_h[j] = h[L - 1 - j], so output i of the tile is sum_j s_h[j] s_x[i + j]
  for (int j = threadIdx.x; j < L; j += THREADS) s_h[j] = hr[L - 1 - j];
  // s_x[j] = x[n0 - (L - 1) + j], zero before the row's start and past its end
  const int span = TILE + L - 1;
  for (int j = threadIdx.x; j < span; j += THREADS) {
    const long long g = n0 - (L - 1) + j;
    s_x[j] = (g >= 0 && g < T) ? xr[g] : 0.0f;
  }
  __syncthreads();

  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int m = 0; m < OUT_PER_THREAD; ++m) acc[m] = 0.0f;
  const float* sx = s_x + threadIdx.x;
#pragma unroll 4
  for (int j = 0; j < L; ++j) {
    const float hj = s_h[j];
#pragma unroll
    for (int m = 0; m < OUT_PER_THREAD; ++m) {
      acc[m] = fmaf(hj, sx[m * THREADS + j], acc[m]);
    }
  }

  float* yr = y + row * T;
#pragma unroll
  for (int m = 0; m < OUT_PER_THREAD; ++m) {
    const long long n = n0 + threadIdx.x + m * THREADS;
    if (n < T) yr[n] = acc[m];
  }
}

}  // namespace

// x, y: (rows, T) float32, h: (rows, L) float32, all contiguous on the
// current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int fir_causal_batch(const float* x, const float* h, float* y,
                                int rows, int T, int L, cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || T < 1 || L < 1 || L > MAX_TAPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((T + TILE - 1) / TILE, rows);
  fir_causal_batch_kernel<<<grid, THREADS, 0, stream>>>(x, h, y, T, L);
  return static_cast<int>(cudaGetLastError());
}
