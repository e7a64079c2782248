// Fused phasor phase vocoder for Hopper (sm_90a): kernel B.
//
// Replaces audiotools_tpu/ops/pallas_kernels.py::phase_vocoder_fused
// (Pallas body _pv_kernel). For every spectrogram row (item b, bin f) it
// carries the unit phasor P through the output steps s:
//     out[s]  = ((1 - frac[s]) |z[i0[s]]| + frac[s] |z[i1[s]]|) P[s]
//     P[0]    = z[0] / |z[0]|                     (1 for a zero frame)
//     P[s+1]  = P[s] z[i1] conj(z[i0]) / (|z0| |z1|)  (identity for a zero frame)
// and optionally writes the track P itself (the residual a backward needs).
//
// What bounds it: memory. Each step reads two complex frames and writes one
// (two with the track); at the pitch shift's shapes (64 x 1025 rows, 384
// frames, 432 steps) that is 0.43 GB (0.65 GB with the track) for ~0.9
// GFLOP, and the recurrence is sequential in s: one thread per row, 65,600
// threads, about 16 warps an SM, and nothing else to run while a step
// waits on its frames.
//
// Design: one thread per row keeps P in registers through all steps, as the
// TPU kernel kept it in vector registers. The spectrum is read in the layout
// the STFT produces, time-major within each item, (items, T, F) complex, so
// at every step a warp's loads of z[i0[s]] and z[i1[s]] are 32 consecutive
// bins: coalesced, with no transpose pass. The frames arrive DEPTH steps
// ahead of their use: each thread keeps a ring of DEPTH + 1 steps' two
// frames in shared memory, filled by 8-byte cp.async copies (a frame is
// F * 8 bytes, 8200 at F = 1025: only 8-byte aligned, so no TMA or bulk
// copy can describe it), one commit group a step, each asking L2 for the
// 256 bytes around it. Step s waits for its own group, reads its slot, and
// refills the slot step s - 1 read (whose values it has already used) with
// step s + DEPTH. No thread reads another's slots. Each step loads both of
// its frames, so any table the plain version takes is right, monotone or
// not. The step is branch-free: the zero-frame identity and the seed are
// selects on the same computed values, as the Pallas body's jnp.where; the
// track is a template parameter. The output (items, n_steps, F), which
// kernel E reads in place, is written with plain stores. Built without fast
// math and without FMA contraction (see _build.py): each product and sum
// rounds on its own, in the operation order of the plain PyTorch version,
// so the two agree bit for bit.
//
// The launch (ops/hopper_kernels.py::pv_plan, which takes THREADS and DEPTH
// from the build's -D flags, _build.DEFINES): blocks of 512 rows, so that a
// block's rows are one long span of each frame; a block's ring takes 136 KB,
// so an SM holds one, and the pitch shift's 65,600 rows make 129 blocks, one
// wave on an H100 SXM's 132 SMs. A thread past the last row scans a row at
// the start without storing it, so every thread reaches the block's
// barriers; with the track, a barrier every sync_every steps keeps a
// block's warps writing neighbouring bins together (on an H100 it helps
// with the track's second output and costs without it: PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = PV_THREADS;  // rows a block, one thread each
constexpr int DEPTH = PV_DEPTH;  // steps a frame is fetched ahead of its use
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps, one block");
constexpr int SMEM = (DEPTH + 1) * 2 * THREADS * static_cast<int>(sizeof(float2));

__device__ __forceinline__ void copy8(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <bool WITH_PHASOR>
__global__ void __launch_bounds__(THREADS)
phase_vocoder_kernel(const float2* __restrict__ z, const int* __restrict__ i0,
                     const int* __restrict__ i1, const float* __restrict__ frac,
                     float2* __restrict__ out, float2* __restrict__ phasor,
                     long long rows, int F, int T, int n_steps, int sync_every) {
  extern __shared__ float2 ring[];  // [DEPTH + 1 slots][2 frames][THREADS]
  // a thread past the last row runs the scan of a row at the start (whose
  // own thread writes it) and stores nothing, so that every thread reaches
  // the block's barriers; its loads spread as any other thread's do
  const long long wanted = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool valid = wanted < rows;
  const long long row = valid ? wanted : wanted % rows;
  const long long b = row / F;
  const long long f = row - b * F;
  const float2* zr = z + b * T * F + f;  // frame t of this row: zr[t * F]
  float2* outr = out + b * n_steps * F + f;  // step s of this row: outr[s * F]
  float2* pr = WITH_PHASOR ? phasor + b * n_steps * F + f : nullptr;
  float2* mine = ring + threadIdx.x;  // slot k, frame j: mine[(2 * k + j) * THREADS]

  auto fetch = [&](int a, int c, int slot) {
    copy8(mine + (2 * slot) * THREADS, zr + static_cast<long long>(a) * F);
    copy8(mine + (2 * slot + 1) * THREADS, zr + static_cast<long long>(c) * F);
  };
#pragma unroll
  for (int s = 0; s < DEPTH; ++s) {
    if (s < n_steps) fetch(__ldg(i0 + s), __ldg(i1 + s), s);
    commit();
  }
  // the table entries of the next refill, read a step ahead of their use
  int next0 = DEPTH < n_steps ? __ldg(i0 + DEPTH) : 0;
  int next1 = DEPTH < n_steps ? __ldg(i1 + DEPTH) : 0;

  const float2 seed = __ldg(zr);
  const float smag = sqrtf(seed.x * seed.x + seed.y * seed.y);
  const bool live = smag > 0.0f;
  const float safe = live ? smag : 1.0f;
  float acc_r = live ? seed.x / safe : 1.0f;
  float acc_i = live ? seed.y / safe : 0.0f;

  int slot = 0;  // slot of step s; the slot of step s - 1 is refilled
  int until_sync = sync_every;
  for (int s = 0; s < n_steps; ++s) {
    const float fr = __ldg(frac + s);
    const bool more = s + DEPTH + 1 < n_steps;
    const int after0 = more ? __ldg(i0 + s + DEPTH + 1) : 0;
    const int after1 = more ? __ldg(i1 + s + DEPTH + 1) : 0;
    wait_copies<DEPTH - 1>();  // step s's group has landed
    const float2 z0 = mine[(2 * slot) * THREADS];
    const float2 z1 = mine[(2 * slot + 1) * THREADS];
    const int refill = slot == 0 ? DEPTH : slot - 1;
    if (s + DEPTH < n_steps) fetch(next0, next1, refill);
    commit();
    next0 = after0;
    next1 = after1;
    slot = slot == DEPTH ? 0 : slot + 1;

    const float a0 = sqrtf(z0.x * z0.x + z0.y * z0.y);
    const float a1 = sqrtf(z1.x * z1.x + z1.y * z1.y);
    // emit before advancing: out[s] = mag[s] * prod_{k<s} u[k]
    const float mag = (1.0f - fr) * a0 + fr * a1;
    if (valid) outr[static_cast<long long>(s) * F] = make_float2(mag * acc_r, mag * acc_i);
    if (WITH_PHASOR && valid) pr[static_cast<long long>(s) * F] = make_float2(acc_r, acc_i);

    // unit rotation u = z1 conj(z0) / (|z0||z1|); a zero frame is the identity
    const float wr = z1.x * z0.x + z1.y * z0.y;
    const float wi = z1.y * z0.x - z1.x * z0.y;
    const float norm = a0 * a1;
    const bool ok = norm > 0.0f;
    const float inv = 1.0f / (ok ? norm : 1.0f);
    const float ur = ok ? wr * inv : 1.0f;
    const float ui = ok ? wi * inv : 0.0f;
    const float nr = acc_r * ur - acc_i * ui;
    const float ni = acc_r * ui + acc_i * ur;
    acc_r = nr;
    acc_i = ni;
    if (sync_every && --until_sync == 0) {  // the block's warps kept in step
      __syncthreads();
      until_sync = sync_every;
    }
  }
}

template <bool WITH_PHASOR>
int launch(const float2* z, const int* i0, const int* i1, const float* frac, float2* out,
           float2* phasor, long long rows, int F, int T, int n_steps, int sync_every, int smem,
           int blocks, cudaStream_t stream) {
  auto kernel = phase_vocoder_kernel<WITH_PHASOR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, THREADS, smem, stream>>>(z, i0, i1, frac, out, phasor, rows, F, T, n_steps,
                                            sync_every);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: (items, T, F) complex64; i0, i1: (n_steps,) int32 in [0, T);
// frac: (n_steps,) float32; out and, unless null, phasor: (items, n_steps, F)
// complex64. All contiguous on the current device. sync_every (0: no
// barrier), smem (the ring's bytes a block) and blocks (one per THREADS
// rows) as pv_plan gives them; a plan that does not match this build is
// refused. Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int phase_vocoder_fused(const void* z, const int* i0, const int* i1,
                                   const float* frac, void* out, void* phasor,
                                   int items, int F, int T, int n_steps, int sync_every,
                                   int smem, int blocks, cudaStream_t stream) {
  const long long rows = static_cast<long long>(items) * F;
  if (items < 1 || F < 1 || T < 1 || n_steps < 1 || sync_every < 0 || smem < SMEM ||
      blocks != (rows + THREADS - 1) / THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* zc = static_cast<const float2*>(z);
  auto* o = static_cast<float2*>(out);
  auto* p = static_cast<float2*>(phasor);
  return p ? launch<true>(zc, i0, i1, frac, o, p, rows, F, T, n_steps, sync_every, smem, blocks,
                          stream)
           : launch<false>(zc, i0, i1, frac, o, p, rows, F, T, n_steps, sync_every, smem, blocks,
                           stream);
}
