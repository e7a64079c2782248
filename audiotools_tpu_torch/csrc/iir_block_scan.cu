// Block-state recurrence of the exact blocked IIR cascade for Hopper
// (sm_90a): kernel F.
//
// Replaces no Pallas kernel. It stands in for the JAX package's lax.scan
// over block states in audiotools_tpu/ops/filters.py:597-606
// (iir_cascade_blocked), which the port first ran as a Python loop of one
// addmm a block (three device operations each: a copy of u[k] into the
// output, a small sgemm and a split-K reduce). For each row r it writes the
// state before every block,
//     s_pre[r, 0]     = 0
//     s_pre[r, k + 1] = s_pre[r, k] (A^L)^T + u[r, k],
// reading u (rows, n_blk, ns), each block's own contribution to the next
// state, in the layout xb @ Psi_x^T produces, and writing s_pre in the same
// layout, which the epilogue s_pre @ Phi_s^T takes.
//
// What bounds it: the dependency chain, not bytes or operations. At the
// meter's shapes (128 rows, 431 blocks of 512 samples, 4 states) it reads
// and writes 0.88 MB (0.26 us at 3.35 TB/s) for 1.8 MFLOP, but every step
// needs the step before: 430 steps, each ns dependent FMAs deep. The
// recurrence stays sequential over blocks: a tree or chunked scan would
// form explicit powers of A^L and amplify rounding about 20x (the JAX
// source's note).
//
// Design: one thread a row keeps its ns states and (A^L)^T in registers,
// so a step is ns independent FMA chains of depth ns, each from u[k, j]
// over the states, and nothing else sits on the chain: the state before a
// step is stored and not waited for, and the step's input is already in
// registers. The inputs arrive DEPTH steps ahead of their use through a
// ring in shared memory, a slot a step for each thread, filled by cp.async
// copies, one commit group a step: step k waits only for step k + 1's
// group (cp.async.wait_group DEPTH - 2), reads it into registers while its
// own FMAs run, and refills the slot it has used with step k + DEPTH. No
// thread reads another's slots, so the ring needs no barrier. A row's
// inputs and outputs are one contiguous run of n_blk * ns values, moved a
// step at a time in the widest words a step's bytes allow (16 bytes for 4
// fp32 or 2 fp64 states; the wrapper gives 16-byte aligned tensors), the
// slots laid out word-major over the block's threads so that a warp's
// reads of the ring are free of bank conflicts. Rows spread over blocks of
// THREADS threads, so the meter's 64 or 128 rows occupy 2 or 4 SMs and a
// batch of thousands of rows fills more with no change. Larger states keep
// (A^L)^T in shared memory, read by broadcast, so that a thread's
// registers never spill. fp32 and fp64 are one template: the float64
// biquads run it too.
//
// Measured at the meter's stacked shape (PERF.md), a step costs ~85 cycles
// against the chain's ~16: one warp a scheduler issues a step's ~38
// instructions in order, and each warp-wide copy or store of a row a
// thread touches 32 lines. Two other designs were measured: a ring of
// registers fed by plain loads (86 us: the compiler tracks a warp's loads
// in flight on a few scoreboards, so each step waited for loads issued
// long after its own), and a warp's rows moved in coalesced chunk tiles
// (15.4-16.2 us against 18.7, with cross-lane barriers and up to 212
// registers a thread): the ring is the simplest within 20% of the best.
//
// The launch (ops/hopper_kernels.py::scan_plan, which takes the block, the
// ring's bytes a thread and its deepest prefetch from the build's -D
// flags, _build.DEFINES): blocks of THREADS rows; inputs DEPTH =
// min(MAX_DEPTH, max(2, RING_BYTES / bytes a step)) steps ahead, 32 at the
// meter's 4 fp32 states. A plan that does not match this build is refused.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = SCAN_THREADS;  // rows a block, one thread each
constexpr int RING_BYTES = SCAN_RING_BYTES;  // shared memory of prefetched inputs a thread
constexpr int MAX_DEPTH = SCAN_DEPTH;  // steps an input is fetched ahead of its use, at most
// (A^L)^T in registers up to this many 32-bit words (8 fp32 or 5 fp64
// states), which with the state, its input and the next input stays well
// inside 255 registers a thread; larger transitions (the float64 biquads
// of 3 to 8 stages) are read from shared memory
constexpr int A_REG_WORDS = 64;
constexpr int MAX_STATES = 16;  // the wrapper's limit (ops/hopper_kernels.py)
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps, one block");
static_assert(THREADS * RING_BYTES <= 40 * 1024, "the ring fits static shared memory");

template <typename T, int NS>
struct Geometry {
  static constexpr int kBytes = NS * static_cast<int>(sizeof(T));  // one step of a row
  static constexpr int kDepth =
      RING_BYTES / kBytes < 2 ? 2 : (RING_BYTES / kBytes > MAX_DEPTH ? MAX_DEPTH : RING_BYTES / kBytes);
  static constexpr bool kARegs = NS * kBytes / 4 <= A_REG_WORDS;
  static constexpr int kVec = kBytes % 16 == 0 ? 16 : (kBytes % 8 == 0 ? 8 : 4);
  static constexpr int kWords = kBytes / kVec;  // words a step
};

template <int BYTES>
struct Word;
template <>
struct Word<16> {
  using type = int4;
};
template <>
struct Word<8> {
  using type = int2;
};
template <>
struct Word<4> {
  using type = int;
};

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, int NS>
__global__ void __launch_bounds__(THREADS)
iir_block_scan_kernel(const T* __restrict__ u, const T* __restrict__ a_l_t,
                      T* __restrict__ s_pre, int rows, int n_blk) {
  using G = Geometry<T, NS>;
  using W = typename Word<G::kVec>::type;
  constexpr int DEPTH = G::kDepth;
  constexpr int PER = G::kVec / static_cast<int>(sizeof(T));  // values a word
  static_assert(PER >= 1 && NS % PER == 0, "a step is whole words");

  __shared__ T a_sh[NS * NS];
  __shared__ W ring[DEPTH][G::kWords][THREADS];  // [slot][word of the step][thread]
  for (int i = threadIdx.x; i < NS * NS; i += THREADS) a_sh[i] = a_l_t[i];
  __syncthreads();
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= rows) return;

  T a_reg[G::kARegs ? NS * NS : 1];
  if constexpr (G::kARegs) {
#pragma unroll
    for (int i = 0; i < NS * NS; ++i) a_reg[i] = a_sh[i];
  }
  auto a_at = [&](int i, int j) -> T {  // (A^L)^T[i, j]
    if constexpr (G::kARegs) {
      return a_reg[i * NS + j];
    } else {
      return a_sh[i * NS + j];
    }
  };
  const size_t start = static_cast<size_t>(row) * n_blk * NS;
  const W* ur = reinterpret_cast<const W*>(u + start);  // step k: words ur[k * kWords + w]
  W* sr = reinterpret_cast<W*>(s_pre + start);

  union Pun {
    W word;
    T v[PER];
  };
  auto fetch = [&](int k, int slot) {
#pragma unroll
    for (int w = 0; w < G::kWords; ++w) {
      copy_async<G::kVec>(&ring[slot][w][threadIdx.x], ur + static_cast<size_t>(k) * G::kWords + w);
    }
  };
  auto read = [&](int slot, T (&dst)[NS]) {
#pragma unroll
    for (int w = 0; w < G::kWords; ++w) {
      Pun p;
      p.word = ring[slot][w][threadIdx.x];
#pragma unroll
      for (int e = 0; e < PER; ++e) dst[w * PER + e] = p.v[e];
    }
  };
  auto store = [&](int k, const T (&src)[NS]) {
#pragma unroll
    for (int w = 0; w < G::kWords; ++w) {
      Pun p;
#pragma unroll
      for (int e = 0; e < PER; ++e) p.v[e] = src[w * PER + e];
      sr[static_cast<size_t>(k) * G::kWords + w] = p.word;
    }
  };

  // steps 0 .. DEPTH - 1 in slots 0 .. DEPTH - 1, one group each
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    if (d < n_blk) fetch(d, d);
    commit();
  }
  T s[NS], in[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j] = T(0);
  wait_copies<DEPTH - 1>();  // step 0's group has landed
  read(0, in);

  int slot = 0;  // step k's slot
  for (int k = 0; k < n_blk; ++k) {
    store(k, s);
    // step k + 1's input, read while this step's FMAs run: DEPTH + k groups
    // are committed and group g holds step g, so DEPTH - 2 may still pend
    const int next = slot + 1 == DEPTH ? 0 : slot + 1;
    T nxt[NS];
    wait_copies<DEPTH - 2>();
    read(next, nxt);
    // s <- s (A^L)^T + u[k]: output j is one chain from u[k, j] over the ns states
    T out[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      T acc = in[j];
#pragma unroll
      for (int i = 0; i < NS; ++i) acc = fma_rn(s[i], a_at(i, j), acc);
      out[j] = acc;
    }
    // the slot step k used takes step k + DEPTH; an empty group past the end
    if (k + DEPTH < n_blk) fetch(k + DEPTH, slot);
    commit();
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j] = out[j];
      in[j] = nxt[j];
    }
    slot = next;
  }
  wait_copies<0>();  // no copy outlives the block
}

template <typename T, int NS>
int launch(const void* u, const void* a_l_t, void* s_pre, int rows, int n_blk, int depth,
           int blocks, cudaStream_t stream) {
  if (depth != Geometry<T, NS>::kDepth || blocks != (rows + THREADS - 1) / THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  iir_block_scan_kernel<T, NS><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a_l_t), static_cast<T*>(s_pre), rows,
      n_blk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_states(const void* u, const void* a_l_t, void* s_pre, int rows, int n_blk, int ns,
                  int depth, int blocks, cudaStream_t stream) {
  switch (ns) {
#define IIR_SCAN_CASE(N) \
  case N:                \
    return launch<T, N>(u, a_l_t, s_pre, rows, n_blk, depth, blocks, stream);
    IIR_SCAN_CASE(1) IIR_SCAN_CASE(2) IIR_SCAN_CASE(3) IIR_SCAN_CASE(4)
    IIR_SCAN_CASE(5) IIR_SCAN_CASE(6) IIR_SCAN_CASE(7) IIR_SCAN_CASE(8)
    IIR_SCAN_CASE(9) IIR_SCAN_CASE(10) IIR_SCAN_CASE(11) IIR_SCAN_CASE(12)
    IIR_SCAN_CASE(13) IIR_SCAN_CASE(14) IIR_SCAN_CASE(15) IIR_SCAN_CASE(16)
#undef IIR_SCAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// u: (rows, n_blk, ns); a_l_t: (ns, ns), (A^L)^T; s_pre: (rows, n_blk, ns)
// written. All contiguous on the current device, of one type: float32
// (itemsize 4) or float64 (itemsize 8); u and s_pre 16-byte aligned;
// 1 <= ns <= 16; depth and blocks as scan_plan gives them. Launches on
// `stream`; returns a CUDA error code (0 on success).
extern "C" int iir_block_scan(const void* u, const void* a_l_t, void* s_pre, int rows,
                              int n_blk, int ns, int itemsize, int depth, int blocks,
                              cudaStream_t stream) {
  if (rows < 1 || n_blk < 1 || ns < 1 || ns > MAX_STATES ||
      (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(s_pre)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (itemsize == 4) {
    return launch_states<float>(u, a_l_t, s_pre, rows, n_blk, ns, depth, blocks, stream);
  }
  if (itemsize == 8) {
    return launch_states<double>(u, a_l_t, s_pre, rows, n_blk, ns, depth, blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
