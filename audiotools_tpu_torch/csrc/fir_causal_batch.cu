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
// Design: register blocking, since an SM serves 32 shared-memory words per
// clock against 128 fp32 FMAs, so one word per FMA would cap it at 25%. A block owns one row and a tile of TILE =
// THREADS x P consecutive outputs; it stages the row's kernel, reversed and
// zero-padded to whole chunks of P taps, and the tile's input with its
// (L - 1)-sample causal halo in dynamic shared memory (zero outside
// [0, T)). Each thread owns P consecutive outputs. For a chunk of P taps
// they read a window of 2P consecutive inputs, held in registers: two
// arrays of P that take turns (the loop is unrolled by two chunks, so the
// window slides without register moves). A chunk then costs P^2 FMAs
// against P new input words and P tap words, both read as float4 (the
// taps as broadcasts): the FMA pipes, not shared memory, set the pace.
// Neighbouring threads read windows P words apart, which would put a
// quarter-warp's float4 loads on 2 of the 8 bank groups; a pad of 4 words
// after every 32 staged samples (skew()) spreads them over all 8. With
// TILE = 4096 the staged halo is a quarter of the tile at C's 1023 taps.
//
// Numerics: each output sums its taps in a fixed order (h[L - 1] first,
// h[0] last), one fmaf each from 0.0f, in fp32
// without fast math; the taps of a final partial chunk are skipped, not
// multiplied by zero. The rows agree bit for bit with cuDNN's conv1d with
// TF32 off (the plain version).
//
// Tensor cores are left out on purpose. fp32 accuracy from them needs three
// TF32 passes (hi*hi + hi*lo + lo*hi) over Toeplitz blocks 13-20% wider
// than the taps: ~3.5x the FLOPs at 7.4x the rate (495 against 67 TFLOP/s),
// at most ~2x over this kernel at its full rate, and no longer bit-equal.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int P = 16;                // consecutive outputs per thread = taps per chunk
constexpr int TILE = THREADS * P;    // outputs per block
constexpr int MAX_TAPS_BATCH = 2048;
constexpr int MAX_TAPS = 8192;

// Shared-memory word of staged sample i: 4 pad words after every 32, so the
// float4 windows of 8 neighbouring threads (16 samples apart) fall in
// different bank groups. A float4 at a multiple of 4 never straddles a pad.
__device__ __forceinline__ int skew(int i) { return i + ((i >> 5) << 2); }

__host__ __device__ constexpr int skewed_size(int n) { return n + ((n + 31) / 32) * 4; }

// w[q] = staged sample i + q, i a multiple of 4
__device__ __forceinline__ void load_window(float (&w)[P], const float* s_x, int i) {
#pragma unroll
  for (int q = 0; q < P; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s_x + skew(i + q));
    w[q] = v.x;
    w[q + 1] = v.y;
    w[q + 2] = v.z;
    w[q + 3] = v.w;
  }
}

// Taps t < n of one chunk (all P when FULL): output p += hs[t] * window[p + t],
// the window being lo (samples 0..P-1 of the chunk) then hi (P..2P-1).
template <bool FULL>
__device__ __forceinline__ void chunk(float (&acc)[P], const float (&lo)[P], const float (&hi)[P],
                                      const float* hs, int n) {
#pragma unroll
  for (int t4 = 0; t4 < P; t4 += 4) {
    const float4 hv = *reinterpret_cast<const float4*>(hs + t4);
    const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t4 + u;
      if (FULL || t < n) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          acc[p] = fmaf(hq[u], t + p < P ? lo[t + p] : hi[t + p - P], acc[p]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
fir_causal_kernel(const float* __restrict__ x, const float* __restrict__ h,
                  float* __restrict__ y, int T, int L, int h_row_stride) {
  extern __shared__ __align__(16) float smem[];
  const int Lp = (L + P - 1) / P * P;  // taps in whole chunks
  float* s_h = smem;                   // Lp reversed taps, zero past L
  float* s_x = smem + Lp;              // TILE + Lp samples, skewed

  const long long row = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * TILE;
  const float* xr = x + row * T;
  const float* hr = h + row * h_row_stride;

  // s_h[j] = h[L - 1 - j], so output i of the tile is sum_j s_h[j] x_tile[i + j]
  for (int j = threadIdx.x; j < Lp; j += THREADS) s_h[j] = j < L ? hr[L - 1 - j] : 0.0f;
  // sample j = x[n0 - (L - 1) + j], zero before the row's start and past its end
  const int span = TILE + Lp;
  for (int j = threadIdx.x; j < span; j += THREADS) {
    const long long g = n0 - (L - 1) + j;
    s_x[skew(j)] = (g >= 0 && g < T) ? xr[g] : 0.0f;
  }
  __syncthreads();

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;
  const int i0 = threadIdx.x * P;
  const int full = L / P;
  const int rem = L - full * P;
  float wa[P], wb[P];
  load_window(wa, s_x, i0);
  int c = 0;
  for (; c + 2 <= full; c += 2) {
    load_window(wb, s_x, i0 + (c + 1) * P);
    chunk<true>(acc, wa, wb, s_h + c * P, P);
    load_window(wa, s_x, i0 + (c + 2) * P);
    chunk<true>(acc, wb, wa, s_h + (c + 1) * P, P);
  }
  if (c < full) {  // one whole chunk left (window in wa), then the partial one
    load_window(wb, s_x, i0 + (c + 1) * P);
    chunk<true>(acc, wa, wb, s_h + c * P, P);
    if (rem) {
      load_window(wa, s_x, i0 + (c + 2) * P);
      chunk<false>(acc, wb, wa, s_h + (c + 1) * P, rem);
    }
  } else if (rem) {
    load_window(wb, s_x, i0 + (c + 1) * P);
    chunk<false>(acc, wa, wb, s_h + c * P, rem);
  }

  float* yr = y + row * T;
  const long long n = n0 + i0;
  if ((row * T) % 4 == 0 && n + P <= T) {  // 16-byte aligned and whole: float4 stores
#pragma unroll
    for (int p = 0; p < P; p += 4) {
      *reinterpret_cast<float4*>(yr + n + p) = make_float4(acc[p], acc[p + 1], acc[p + 2], acc[p + 3]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (n + p < T) yr[n + p] = acc[p];
    }
  }
}

int launch(const float* x, const float* h, float* y, int rows, int T, int L,
           int h_row_stride, cudaStream_t stream) {
  const int Lp = (L + P - 1) / P * P;
  const size_t smem = static_cast<size_t>(Lp + skewed_size(TILE + Lp)) * sizeof(float);
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
