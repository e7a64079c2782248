// Fused bf16 iSTFT synthesis for Hopper (sm_90a): kernel E.
//
// Replaces audiotools_tpu/ops/pallas_kernels.py::istft_synthesis_fused
// (Pallas body _syn_kernel). With hop H, r = n_fft / H <= 8 and S the
// spectrum rows [Re | Im] of frame m, output hop-row m is
//     out[m H : (m + 1) H] = (sum_j S[m - j] @ W[:, j H : (j + 1) H]) inv_env,
// W the window-fused inverse DFT; frames with an index outside [0, nt)
// are zero, and `edge` zero frames lead the spectrum (istft's match_stride
// pads two at each end: the kernel reads past them instead of a padded
// copy). Operands are bf16 (rounded to nearest even, as the plain
// version's tensor.to(torch.bfloat16)), sums fp32: the numerics of
// istft(method="matmul_bf16"). Each output sample is written once, by one
// block, with no atomics, and the (B, nt, n_fft) frame tensor is never
// built: at 64 x 432 frames of 2048 it would be 226 MB.
//
// What bounds it: tensor-core products, 2 B (nt + r - 1) K2 n_fft FLOP
// (~232 GFLOP at 64 x 5 s with n_fft 2048) against ~0.3 GB of spectrum
// and output. The spectrum is read in the layout kernel B writes, (B, nt,
// n_freq) complex64 with re and im interleaved: the contraction runs over
// the interleaved pairs, and the weights' rows are interleaved to match
// (row 2k = Ci[k], row 2k + 1 = Si[k]; hopper_kernels.synthesis_weights,
// cached per window and hop by ops/fft.py), so no
// transpose or plane split sits between the vocoder and this kernel.
//
// Design: a block computes TM hop-rows x TN columns of one item with 4
// warps of bf16 WMMA fragments (m16n16k16, fp32 accumulators; 32 x 32 per
// warp). For each contraction chunk of KC values it stages the TM + r - 1
// frames the r shifted products need (converted to bf16 on the way in,
// zero outside [0, nt) and past n_freq) and the chunk of each of the r
// column blocks of W, then accumulates all r products in registers. The
// weights' column blocks are padded to a multiple of TN (zeros), so no
// load is masked. The envelope multiplies on the way out. This first
// version does not overlap loads with products (no cp.async or TMA
// pipeline) and uses mma.sync-class WMMA rather than wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int TM = 64;        // output hop-rows per block
constexpr int TN = 64;        // output columns per block
constexpr int KC = 32;        // contraction values per staged chunk
constexpr int MAX_R = 8;      // n_fft / hop
constexpr int THREADS = 128;  // 4 warps in a 2 x 2 grid of 32 x 32
constexpr int LDA = KC + 16;  // 96-byte rows: every row start is 32-byte aligned for WMMA
constexpr int LDB = TN + 8;
constexpr int LDC = TN + 4;
constexpr int A_ROWS = TM + MAX_R - 1;
constexpr int B_BYTES = MAX_R * KC * LDB * 2;
static_assert(TM * LDC * 4 <= B_BYTES, "the epilogue tile reuses the weight tile");

__global__ void __launch_bounds__(THREADS)
istft_synthesis_kernel(const float2* __restrict__ spec, const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ inv_env, float* __restrict__ out,
                       int nt, int edge, int F, int K2, int r, int H, int Hp,
                       int M_total) {
  __shared__ __align__(128) __nv_bfloat16 s_a[A_ROWS * LDA];
  __shared__ __align__(128) unsigned char s_raw[B_BYTES];
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(s_raw);
  float* s_c = reinterpret_cast<float*>(s_raw);

  const int m0 = blockIdx.x * TM;
  const int c0 = blockIdx.y * TN;
  const long long b = blockIdx.z;
  const float2* sb = spec + b * nt * F;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const long long w_cols = static_cast<long long>(r) * Hp;
  const int f_base = m0 - (r - 1) - edge;  // frame of staged row 0
  const int a_rows = TM + r - 1;
  constexpr int PAIRS = KC / 2;    // complex bins per chunk
  constexpr int VECS = TN / 8;     // 16-byte weight vectors per chunk row

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[i][n], 0.0f);

  for (int k0 = 0; k0 < K2; k0 += KC) {
    for (int idx = threadIdx.x; idx < a_rows * PAIRS; idx += THREADS) {
      const int row = idx / PAIRS;
      const int p = idx - row * PAIRS;
      const int f = f_base + row;
      const int bin = k0 / 2 + p;
      float2 v = make_float2(0.0f, 0.0f);
      if (f >= 0 && f < nt && bin < F) v = sb[static_cast<long long>(f) * F + bin];
      *reinterpret_cast<__nv_bfloat162*>(&s_a[row * LDA + 2 * p]) =
          __floats2bfloat162_rn(v.x, v.y);
    }
    for (int idx = threadIdx.x; idx < r * KC * VECS; idx += THREADS) {
      const int j = idx / (KC * VECS);
      const int rem = idx - j * (KC * VECS);
      const int kk = rem / VECS;
      const int v = rem - kk * VECS;
      const uint4 val = *reinterpret_cast<const uint4*>(
          w + static_cast<long long>(k0 + kk) * w_cols + j * Hp + c0 + v * 8);
      *reinterpret_cast<uint4*>(&s_b[(j * KC + kk) * LDB + v * 8]) = val;
    }
    __syncthreads();

    for (int j = 0; j < r; ++j) {
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // output row m uses frame m - edge - j: staged row m - m0 + (r - 1) - j
          wmma::load_matrix_sync(fa[i], s_a + (wm + 16 * i + (r - 1) - j) * LDA + ks, LDA);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          wmma::load_matrix_sync(fb[n], s_b + (j * KC + ks) * LDB + wn + 16 * n, LDB);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) wmma::mma_sync(acc[i][n], fa[i], fb[n], acc[i][n]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      wmma::store_matrix_sync(s_c + (wm + 16 * i) * LDC + wn + 16 * n, acc[i][n], LDC,
                              wmma::mem_row_major);
    }
  __syncthreads();

  float* ob = out + b * M_total * H;
  for (int idx = threadIdx.x; idx < TM * TN; idx += THREADS) {
    const int mm = idx / TN;
    const int cc = idx - mm * TN;
    const int m = m0 + mm;
    const int c = c0 + cc;
    if (m < M_total && c < H) {
      const long long o = static_cast<long long>(m) * H + c;
      ob[o] = s_c[mm * LDC + cc] * inv_env[o];
    }
  }
}

}  // namespace

// spec: (B, nt, F) complex64; w: (K2, r * Hp) bf16 with K2 a multiple of 32
// and Hp of 64 (zero padded); inv_env: (M_total * H,) float32; out: (B,
// M_total * H) float32, M_total = nt + 2 edge + r - 1. All contiguous on the
// current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int istft_synthesis_fused(const void* spec, const void* w, const float* inv_env,
                                     float* out, int B, int nt, int edge, int F, int K2, int r,
                                     int H, int Hp, int M_total, cudaStream_t stream) {
  if (B < 1 || B > 65535 || nt < 1 || edge < 0 || F < 1 || r < 1 || r > MAX_R || H < 1 ||
      K2 % KC != 0 || K2 < 2 * F || Hp % TN != 0 || Hp < H ||
      M_total != nt + 2 * edge + r - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((M_total + TM - 1) / TM, Hp / TN, B);
  istft_synthesis_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float2*>(spec), static_cast<const __nv_bfloat16*>(w), inv_env, out,
      nt, edge, F, K2, r, H, Hp, M_total);
  return static_cast<int>(cudaGetLastError());
}
