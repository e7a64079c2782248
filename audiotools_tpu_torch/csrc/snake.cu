// Snake activation for Hopper (sm_90a): kernel G, forward and backward.
//
// Replaces no Pallas kernel. It stands in for the eager expression of
// audiotools_tpu_torch/models/dac.py::snake (the JAX package's
// audiotools_tpu/models/dac.py::snake, which XLA fuses into one loop):
//     y = x + r s^2,  s = sin(alpha_c x),  r = 1 / (alpha_c + 1e-9),
// over fp32 (B, C, T) with one alpha a channel. Eager PyTorch runs it as
// five elementwise kernels forward (alpha x, sin, the square, r s^2, the
// sum; two of them broadcast over alpha and not vectorised), about 44 bytes
// of device memory an element, and autograd saves four tensors the size of
// x. Here the forward reads x and writes y (8 bytes an element), and the
// backward reads x and the output's gradient g and writes x's gradient (12
// bytes), so autograd keeps only x.
//
// What bounds it: bytes. A precise sinf (or sincosf) and a few products an
// element are ~30-60 instructions, under the ~120 an element that the SMs
// can issue in the time HBM takes to move one.
//
// Design: a warp takes one SEGMENT of one row (b, c), so alpha_c and r are
// two scalars in registers and no element needs a division for its
// channel. Each lane first issues all its UNROLL 16-byte loads, then
// computes and stores, so a warp keeps 2 KB (4 KB backward) in flight. A
// row whose start is not 16-byte aligned (T not a multiple of 4, or a
// storage offset) takes its first elements and its last one by one; when
// the input and output do not share their alignment the whole segment goes
// one element a lane at a time.
//
// The arithmetic is the eager expression's, operation for operation:
// precise sinf and cosf (sincosf, the same values), each product and sum
// rounded on its own (__fmul_rn, __fadd_rn, which the compiler never
// contracts into an FMA), r as a correctly rounded 1 / (alpha + 1e-9). The
// forward then equals the eager chain bit for bit, and x's gradient is the
// eager backward's own product chain,
//     gx = g + (((g r) (2 s)) cos(alpha x)) alpha.
// The source builds without --fmad=false so that sinf compiles as in
// PyTorch's own kernels.
//
// alpha's gradient, sum over b and t of (g r 2 s c) x - r^2 g s^2, is
// kept as its two sums, A = sum g_t x and S = sum g s^2 (g_t = g r 2 s c),
// as the eager graph forms them. Each warp reduces its segment's terms in
// fp32 and writes them to partial[(k C + c) P + b n_seg + seg] (k = 0 for
// A, 1 for S; P = B n_seg), with no atomics; a second launch sums each
// channel's P partials in fp64 in a fixed order and writes A - r^2 S. Two
// backward runs on the same inputs give the same bits.
//
// The launch (ops/hopper_kernels.py::snake_plan, which takes THREADS and
// UNROLL from the build's -D flags, _build.DEFINES): SEGMENT = 128 UNROLL
// elements a warp, n_seg = ceil(T / SEGMENT) warps a row, blocks of
// THREADS / 32 warps. A plan that does not match this build is refused.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = SNAKE_THREADS;  // threads a block
constexpr int UNROLL = SNAKE_UNROLL;  // 16-byte loads a lane issues before it computes
constexpr int WARPS = THREADS / 32;
constexpr int SEGMENT = 32 * 4 * UNROLL;  // elements of a row a warp takes
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps, one block");

struct Segment {
  long long base;  // element offset of the segment in the (B, C, T) tensor
  long long slot;  // b * n_seg + seg: its column of the partial sums
  int channel;
  int n;  // elements in the segment
};

// The warp's segment; false for a warp past the last one.
__device__ __forceinline__ bool segment_of(int B, int C, int T, int n_seg, Segment& s) {
  const long long warp = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (warp >= static_cast<long long>(B) * C * n_seg) return false;
  const long long row = warp / n_seg;
  const int seg = static_cast<int>(warp - row * n_seg);
  const int start = seg * SEGMENT;
  s.base = row * T + start;
  s.slot = (row / C) * n_seg + seg;
  s.channel = static_cast<int>(row % C);
  s.n = min(SEGMENT, T - start);
  return true;
}

// Elements before the first 16-byte boundary of a segment that starts at
// p: all of them when the tensors of the call do not share p's alignment.
__device__ __forceinline__ int head_of(const float* p, int n, bool same_alignment) {
  if (!same_alignment) return n;
  const int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2);
  return min(head, n);
}

__device__ __forceinline__ float reciprocal(float alpha) {
  return 1.0f / __fadd_rn(alpha, 1e-9f);
}

__device__ __forceinline__ float snake_of(float x, float a, float r) {
  const float s = sinf(__fmul_rn(a, x));
  return __fadd_rn(x, __fmul_rn(r, __fmul_rn(s, s)));
}

__global__ void __launch_bounds__(THREADS) snake_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ alpha,
                                                        float* __restrict__ y, int B, int C,
                                                        int T, int n_seg, bool same_alignment) {
  Segment s;
  if (!segment_of(B, C, T, n_seg, s)) return;
  const int lane = threadIdx.x & 31;
  const float a = alpha[s.channel];
  const float r = reciprocal(a);
  const float* xs = x + s.base;
  float* ys = y + s.base;
  const int head = head_of(xs, s.n, same_alignment);
  const int n_vec = (s.n - head) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(xs + head);
  float4* yv = reinterpret_cast<float4*>(ys + head);

  float4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = lane + 32 * u;
    if (j < n_vec) v[u] = __ldcs(xv + j);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = lane + 32 * u;
    if (j < n_vec) {
      float4 o;
      o.x = snake_of(v[u].x, a, r);
      o.y = snake_of(v[u].y, a, r);
      o.z = snake_of(v[u].z, a, r);
      o.w = snake_of(v[u].w, a, r);
      yv[j] = o;
    }
  }
  for (int i = lane; i < head; i += 32) ys[i] = snake_of(xs[i], a, r);
  for (int i = head + 4 * n_vec + lane; i < s.n; i += 32) ys[i] = snake_of(xs[i], a, r);
}

// One element of the backward: x's gradient, and the element's terms of
// alpha's two sums added to `sum_a` and `sum_s`.
__device__ __forceinline__ float snake_grad(float x, float g, float a, float r, float& sum_a,
                                            float& sum_s) {
  float s, c;
  sincosf(__fmul_rn(a, x), &s, &c);
  const float g_t = __fmul_rn(__fmul_rn(__fmul_rn(g, r), __fmul_rn(2.0f, s)), c);
  sum_a = __fadd_rn(sum_a, __fmul_rn(g_t, x));
  sum_s = __fadd_rn(sum_s, __fmul_rn(g, __fmul_rn(s, s)));
  return __fadd_rn(g, __fmul_rn(g_t, a));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) snake_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ alpha, const float* __restrict__ g,
    float* __restrict__ gx, float* __restrict__ partial, int B, int C, int T, int n_seg,
    bool same_alignment) {
  Segment s;
  if (!segment_of(B, C, T, n_seg, s)) return;
  const int lane = threadIdx.x & 31;
  const float a = alpha[s.channel];
  const float r = reciprocal(a);
  const float* xs = x + s.base;
  const float* gs = g + s.base;
  float* os = gx + s.base;
  const int head = head_of(xs, s.n, same_alignment);
  const int n_vec = (s.n - head) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(xs + head);
  const float4* gv = reinterpret_cast<const float4*>(gs + head);
  float4* ov = reinterpret_cast<float4*>(os + head);

  float sum_a = 0.0f, sum_s = 0.0f;
  float4 xr[UNROLL], gr[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = lane + 32 * u;
    if (j < n_vec) {
      xr[u] = __ldcs(xv + j);
      gr[u] = __ldcs(gv + j);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = lane + 32 * u;
    if (j < n_vec) {
      float4 o;
      o.x = snake_grad(xr[u].x, gr[u].x, a, r, sum_a, sum_s);
      o.y = snake_grad(xr[u].y, gr[u].y, a, r, sum_a, sum_s);
      o.z = snake_grad(xr[u].z, gr[u].z, a, r, sum_a, sum_s);
      o.w = snake_grad(xr[u].w, gr[u].w, a, r, sum_a, sum_s);
      ov[j] = o;
    }
  }
  for (int i = lane; i < head; i += 32) os[i] = snake_grad(xs[i], gs[i], a, r, sum_a, sum_s);
  for (int i = head + 4 * n_vec + lane; i < s.n; i += 32) {
    os[i] = snake_grad(xs[i], gs[i], a, r, sum_a, sum_s);
  }
  sum_a = warp_sum(sum_a);
  sum_s = warp_sum(sum_s);
  if (lane == 0) {
    const long long P = static_cast<long long>(B) * n_seg;
    partial[static_cast<long long>(s.channel) * P + s.slot] = sum_a;
    partial[static_cast<long long>(C + s.channel) * P + s.slot] = sum_s;
  }
}

// A warp a channel: its P partials of each sum, in fp64, lane-strided and
// then a fixed shuffle tree; alpha's gradient A - r^2 S rounded once.
__global__ void __launch_bounds__(THREADS) snake_alpha_grad_kernel(
    const float* __restrict__ alpha, const float* __restrict__ partial,
    float* __restrict__ galpha, int C, long long P) {
  const int c = blockIdx.x * WARPS + threadIdx.x / 32;
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  const float* pa = partial + static_cast<long long>(c) * P;
  const float* ps = partial + static_cast<long long>(C + c) * P;
  double sum_a = 0.0, sum_s = 0.0;
  for (long long p = lane; p < P; p += 32) {
    sum_a += pa[p];
    sum_s += ps[p];
  }
  sum_a = warp_sum(sum_a);
  sum_s = warp_sum(sum_s);
  if (lane == 0) {
    const double r = reciprocal(alpha[c]);
    galpha[c] = static_cast<float>(sum_a - r * r * sum_s);
  }
}

bool plan_matches(int B, int C, int T, int n_seg, int blocks) {
  if (B < 1 || C < 1 || T < 1 || n_seg != (T + SEGMENT - 1) / SEGMENT) return false;
  const long long warps = static_cast<long long>(B) * C * n_seg;
  return blocks == (warps + WARPS - 1) / WARPS;
}

bool aligned_alike(const void* p, const void* q) {
  return ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(q)) & 15) == 0;
}

}  // namespace

// Forward. x, y: (B, C, T) float32, alpha: (C,) float32, contiguous on the
// current device; n_seg and blocks from snake_plan. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int snake(const float* x, const float* alpha, float* y, int B, int C, int T,
                     int n_seg, int blocks, cudaStream_t stream) {
  if (!plan_matches(B, C, T, n_seg, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  snake_kernel<<<blocks, THREADS, 0, stream>>>(x, alpha, y, B, C, T, n_seg,
                                               aligned_alike(x, y));
  return static_cast<int>(cudaGetLastError());
}

// Backward. x, g, gx: (B, C, T), alpha and galpha: (C,), partial: (2, C,
// B n_seg) scratch, all float32 and contiguous on the current device. Two
// launches on `stream`: the elementwise pass with the partial sums, then
// alpha's gradient. Returns cudaGetLastError() of the first failing one.
extern "C" int snake_backward(const float* x, const float* alpha, const float* g, float* gx,
                              float* partial, float* galpha, int B, int C, int T, int n_seg,
                              int blocks, cudaStream_t stream) {
  if (!plan_matches(B, C, T, n_seg, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  snake_backward_kernel<<<blocks, THREADS, 0, stream>>>(
      x, alpha, g, gx, partial, B, C, T, n_seg, aligned_alike(x, g) && aligned_alike(x, gx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  snake_alpha_grad_kernel<<<(C + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      alpha, partial, galpha, C, static_cast<long long>(B) * n_seg);
  return static_cast<int>(cudaGetLastError());
}
