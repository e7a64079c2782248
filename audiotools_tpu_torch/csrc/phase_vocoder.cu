// Fused phasor phase vocoder for Hopper (sm_90a).
//
// Replaces audiotools_tpu/ops/pallas_kernels.py::phase_vocoder_fused
// (Pallas body _pv_kernel). For every spectrogram row (item b, bin f) it
// carries the unit phasor P through the output steps s:
//     out[s]  = ((1 - frac[s]) |z[i0[s]]| + frac[s] |z[i1[s]]|) P[s]
//     P[0]    = z[0] / |z[0]|                     (1 for a zero frame)
//     P[s+1]  = P[s] z[i1] conj(z[i0]) / (|z0| |z1|)  (identity for a zero frame)
// and optionally writes the track P itself (the residual a backward needs).
//
// What bounds it: memory and latency. Each step reads two complex frames
// and writes one (two with the track); at the pitch shift's shapes (64 x
// 1025 rows, 384 frames, 432 steps) that is ~0.5 GB of traffic for
// ~0.7 GFLOP, and the recurrence is sequential in s.
//
// Design: one thread per row keeps P in registers through all steps, as the
// TPU kernel kept it in vector registers. The spectrum is read in the layout
// the matmul STFT produces, time-major within each item, (items, T, F)
// complex, so at every step a warp's loads of z[i0[s]] and z[i1[s]] are 32
// consecutive bins: coalesced, with no transpose pass. The step tables are
// the same for every thread and are read through the read-only cache. The
// output is written in the same (items, n_steps, F) layout, which is what
// the synthesis matmul reads. Built without fast math and without FMA
// contraction (see _build.py): each product and sum rounds on its own, in
// the operation order of the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
phase_vocoder_kernel(const float2* __restrict__ z, const int* __restrict__ i0,
                     const int* __restrict__ i1, const float* __restrict__ frac,
                     float2* __restrict__ out, float2* __restrict__ phasor,
                     long long rows, int F, int T, int n_steps) {
  const long long row = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row >= rows) return;
  const long long b = row / F;
  const long long f = row - b * F;
  const float2* zr = z + b * T * F + f;        // frame t of this row: zr[t * F]
  float2* outr = out + b * n_steps * F + f;    // step s of this row: outr[s * F]
  float2* pr = phasor ? phasor + b * n_steps * F + f : nullptr;

  const float2 seed = zr[0];
  const float smag = sqrtf(seed.x * seed.x + seed.y * seed.y);
  float acc_r = 1.0f;
  float acc_i = 0.0f;
  if (smag > 0.0f) {
    acc_r = seed.x / smag;
    acc_i = seed.y / smag;
  }

#pragma unroll 4
  for (int s = 0; s < n_steps; ++s) {
    const long long a = __ldg(i0 + s);
    const long long c = __ldg(i1 + s);
    const float fr = __ldg(frac + s);
    const float2 z0 = zr[a * F];
    const float2 z1 = zr[c * F];
    const float a0 = sqrtf(z0.x * z0.x + z0.y * z0.y);
    const float a1 = sqrtf(z1.x * z1.x + z1.y * z1.y);

    // emit before advancing: out[s] = mag[s] * prod_{k<s} u[k]
    const float mag = (1.0f - fr) * a0 + fr * a1;
    outr[static_cast<long long>(s) * F] = make_float2(mag * acc_r, mag * acc_i);
    if (pr) pr[static_cast<long long>(s) * F] = make_float2(acc_r, acc_i);

    // unit rotation u = z1 conj(z0) / (|z0||z1|); a zero frame is the identity
    const float wr = z1.x * z0.x + z1.y * z0.y;
    const float wi = z1.y * z0.x - z1.x * z0.y;
    const float norm = a0 * a1;
    float ur = 1.0f;
    float ui = 0.0f;
    if (norm > 0.0f) {
      const float inv = 1.0f / norm;
      ur = wr * inv;
      ui = wi * inv;
    }
    const float nr = acc_r * ur - acc_i * ui;
    const float ni = acc_r * ui + acc_i * ur;
    acc_r = nr;
    acc_i = ni;
  }
}

}  // namespace

// z: (items, T, F) complex64; i0, i1: (n_steps,) int32 in [0, T);
// frac: (n_steps,) float32; out and, unless null, phasor: (items, n_steps, F)
// complex64. All contiguous on the current device. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int phase_vocoder_fused(const void* z, const int* i0, const int* i1,
                                   const float* frac, void* out, void* phasor,
                                   int items, int F, int T, int n_steps,
                                   cudaStream_t stream) {
  if (items < 1 || F < 1 || T < 1 || n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(items) * F;
  const unsigned blocks = static_cast<unsigned>((rows + THREADS - 1) / THREADS);
  phase_vocoder_kernel<<<blocks, THREADS, 0, stream>>>(
      static_cast<const float2*>(z), i0, i1, frac, static_cast<float2*>(out),
      static_cast<float2*>(phasor), rows, F, T, n_steps);
  return static_cast<int>(cudaGetLastError());
}
