// Causal FIR for Hopper (sm_90a): kernels A and C.
//
//     y[r, n] = sum_k h[r, k] x[r, n - k],   n < T.
//
// A replaces audiotools_tpu/ops/pallas_kernels.py::fir_conv_causal_batch
// (Pallas body _make_kernel(per_item=True)): one kernel h[r] of L <= 2048
// taps per row r (the equalizer's per-item FIR).
// C replaces pallas_kernels.py::fir_conv_causal: one kernel of L <= 8192
// taps shared by every row (the FIR loudness meter: 1023 taps, or 4095 at
// zeros=2048). Both run the same code; C passes a row stride of 0 for h.
//
// What bounds them: fp32 multiply-adds on the CUDA cores. The equalizer's
// call (64 rows x 221,140 samples x 641 taps) is ~18 GFLOP and the meter's
// (64 x 220,500 x 1023) ~29 GFLOP, against ~57 MB of input and output:
// hundreds of FLOP per byte, so memory is not the limit. The TPU kernels
// reached fp32 accuracy with multi-pass Toeplitz matmuls on the matrix
// unit; here every product is an fp32 FMA, so neither TF32 nor bf16
// rounding can enter.
//
// Design: a block owns one row and a tile of TILE consecutive outputs. It
// stages the row's kernel, reversed, and the tile's input with its (L - 1)
// sample causal halo in dynamic shared memory (zero outside [0, T)):
// (TILE + 2 L - 1) floats, 20 KB at A's 2048 taps and 69 KB at C's 8192,
// above the 48 KB a block gets without opting in. Each thread then
// accumulates OUT_PER_THREAD outputs spaced THREADS apart, so at every tap
// the warp reads consecutive shared-memory words (no bank conflicts) and
// the tap itself is a broadcast. Shared-memory reads, about one per FMA,
// bound this first version; register blocking over taps is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int OUT_PER_THREAD = 8;
constexpr int TILE = THREADS * OUT_PER_THREAD;
constexpr int MAX_TAPS_BATCH = 2048;
constexpr int MAX_TAPS = 8192;

__global__ void __launch_bounds__(THREADS)
fir_causal_kernel(const float* __restrict__ x, const float* __restrict__ h,
                  float* __restrict__ y, int T, int L, int h_row_stride) {
  extern __shared__ float smem[];
  float* s_h = smem;      // L reversed taps
  float* s_x = smem + L;  // TILE + L - 1 input samples

  const long long row = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * TILE;
  const float* xr = x + row * T;
  const float* hr = h + row * h_row_stride;

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

int launch(const float* x, const float* h, float* y, int rows, int T, int L,
           int h_row_stride, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TILE + 2 * L - 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fir_causal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TILE - 1) / TILE, rows);
  fir_causal_kernel<<<grid, THREADS, smem, stream>>>(x, h, y, T, L, h_row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A. x, y: (rows, T) float32, h: (rows, L) float32, all contiguous on
// the current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int fir_causal_batch(const float* x, const float* h, float* y,
                                int rows, int T, int L, cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || T < 1 || L < 1 || L > MAX_TAPS_BATCH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(x, h, y, rows, T, L, L, stream);
}

// Kernel C. x, y: (rows, T) float32, h: (L,) float32 shared by every row,
// all contiguous on the current device. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fir_causal(const float* x, const float* h, float* y,
                          int rows, int T, int L, cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || T < 1 || L < 1 || L > MAX_TAPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(x, h, y, rows, T, L, 0, stream);
}
