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
// thread, with no atomics, and the (B, nt, n_fft) frame tensor is never
// built: at 64 x 432 frames of 2048 it would be 226 MB.
//
// What bounds it: tensor-core products, 2 B (nt + r - 1) K2 n_fft FLOP
// (~232 GFLOP at 64 x 5 s with n_fft 2048) against ~0.3 GB of spectrum
// and output. The spectrum is read in the layout kernel B writes, (B, nt,
// n_freq) complex64 with re and im interleaved: the contraction runs over
// the interleaved pairs, and the weights' rows are interleaved to match
// (row 2k = Ci[k], row 2k + 1 = Si[k]; hopper_kernels.synthesis_weights,
// cached per window and hop by ops/fft.py), so no transpose or plane split
// sits between the vocoder and this kernel.
//
// Design:
// - Rows. The output hop-rows of all items are laid end to end, each item
//   given r - 1 leading rows that are computed and dropped (V = M_total +
//   r - 1 rows an item). Output row g then needs frame rows g - j of the
//   same flat space for j < r, whatever the item, so a tile of TM rows
//   stages one chunk of TM + r - 1 frame rows for all r shifted products,
//   and tiles cross item boundaries (64 items of 435 rows are 110 tiles of
//   256, none mostly padding).
// - Tile. A block is two warpgroups and computes TM = 256 rows x TN = 128
//   columns; each warpgroup owns two 64-row blocks, each one chain of
//   wgmma.mma_async m64n128k16 (bf16 products, fp32 accumulators in
//   registers). Per FLOP a block fetches weights in proportion to 1 / TM
//   and spectrum in proportion to 1 / TN, so the tile is as large as the
//   accumulators' registers allow.
// - Weights (B). One TMA box per shift and chunk (8 columns x KC rows x
//   16 column groups of a 3-D view of the weights) lands as the 8 x 8
//   core matrices of a no-swizzle wgmma operand: k rows 16 bytes apart,
//   column groups KC x 16 bytes apart. wgmma reads them n-major, in the
//   layout they have in device memory, through the descriptor's transpose
//   bit. One thread issues the copies; an mbarrier a stage counts their
//   bytes, and a wait that never ends traps.
// - Spectrum (A). Each thread loads its pairs of a chunk (fp32, 8 bytes:
//   rows of an odd n_freq are only 8-byte aligned, which TMA refuses) from
//   global memory into registers two chunks ahead, and rounds them to bf16
//   into shared memory, a k-major operand whose rows are uniformly 16
//   bytes apart within a k group: the shift by j rows is then an offset of
//   the descriptor's start address. The spectrum is never stored as bf16
//   in device memory (113 MB more at the chain's shape), and only its bf16
//   form crosses shared memory: staging the fp32 pairs there too (cp.async)
//   added two fp32 passes to the shared-memory traffic the wgmmas already
//   load it with, and cost more time than the products.
// - Pipeline. Chunks of KC = 16 values. A chunk's wgmmas are issued, the
//   next chunk's spectrum is converted while they run, and a warpgroup
//   then waits only for the previous chunk's products (wait_group 1).
//   Weights run W_STAGES - 2 chunks ahead in a ring of as many stages as
//   fit (8 at r <= 4, 4 at r = 8), the converted spectrum in a ring of
//   three: the block barrier at the top of each chunk is what tells a
//   buffer is free (every warpgroup has waited for the products two
//   chunks back) and that the converted chunk is visible. One kernel is
//   built for each r, so the shifts' products are unrolled.
// - Epilogue: the envelope multiplies on the way out, straight from the
//   accumulators. Column blocks run side by side in the grid, so the
//   blocks that share a spectrum tile read it from L2 together.
//
// What bounds it now: shared memory and the per-chunk barrier. The
// products read each chunk's weights once for every 64-row block (4x per
// block) and the spectrum from shared memory too; each chunk ends on a
// block barrier. The chain's shape reaches ~38% of the bf16 peak.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// TN and KC are also the weights' padding (hopper_kernels._syn_layout):
// each shift's column block is whole tiles of TN, the rows whole chunks of KC
constexpr int TM = 256;       // output hop-rows per block (flat over items)
constexpr int TN = 128;       // output columns per block
constexpr int KC = 16;        // contraction values per chunk (one wgmma k step)
constexpr int BINS = KC / 2;  // complex bins per chunk
constexpr int MAX_R = 8;      // n_fft / hop
constexpr int A_ROWS = TM + MAX_R - 1;
constexpr int THREADS = 256;  // 2 warpgroups
constexpr int A_STAGES = 3;   // converted spectrum ring
constexpr int B_BLOCK = KC * TN * 2;    // bytes of one shift's weights in a stage
constexpr int PAIRS = (A_ROWS * BINS + THREADS - 1) / THREADS;  // spectrum pairs a thread stages
static_assert(THREADS % BINS == 0, "a thread stages one bin of every chunk");
// bytes between the two k groups of a converted chunk: 16 a row, then
// 64 mod 128, so a warp's conversion stores cover all banks
constexpr int KQ_STRIDE = (A_ROWS * 16 + 127) / 128 * 128 + 64;
constexpr int A_BYTES = (2 * KQ_STRIDE + 127) / 128 * 128;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90
constexpr int STATIC_BYTES = A_ROWS * 8 + 8 * 8;  // the row table and the barriers
constexpr int MAX_W_STAGES = 8;
// weights ring: as many stages as fit, at most 8; the copies run
// W_STAGES - 2 chunks ahead
__host__ __device__ constexpr int w_stages(int r) {
  return (SMEM_MAX - STATIC_BYTES - A_STAGES * A_BYTES) / (r * B_BLOCK) < MAX_W_STAGES
             ? (SMEM_MAX - STATIC_BYTES - A_STAGES * A_BYTES) / (r * B_BLOCK)
             : MAX_W_STAGES;
}
__host__ __device__ constexpr int smem_bytes(int r) {
  return w_stages(r) * r * B_BLOCK + A_STAGES * A_BYTES;
}
static_assert(w_stages(MAX_R) >= 4, "the weights run two chunks ahead at any r");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits for phase `parity` of the barrier to complete; a wait that never
// ends (a byte count that does not match) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 24)) __trap();
  }
}
// a box of the weights' tensor map (8 columns, KC rows, TN / 8 column
// groups from `group`) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_w(uint32_t dst, const CUtensorMap* map, int k0, int group,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(k0), "r"(group), "r"(bar)
      : "memory");
}

// the wgmma shared-memory descriptor of a no-swizzle operand at `addr`:
// lbo between core matrices along k, sbo along m or n
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// pins `v` to its register at this point: the epilogue's reads may not move
// above the last wgmma wait
__device__ __forceinline__ void fence_reg(float& v) { asm volatile("" : "+f"(v)::"memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 128, fp32, in registers) += A (64 x 16 bf16, shared memory,
// k-major) x B (16 x 128 bf16, shared memory, n-major: rows of k with n
// contiguous, read through the transposing descriptor)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int R>  // R = r
__global__ void __launch_bounds__(THREADS, 1)
istft_synthesis_kernel(const float2* __restrict__ spec, const __grid_constant__ CUtensorMap w_map,
                       const float* __restrict__ inv_env, float* __restrict__ out, int B,
                       int nt, int edge, int F, int K2, int H, int Hp, int M_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long s_row[A_ROWS];  // spectrum offset of each staged row, -1: zeros
  __shared__ __align__(8) uint64_t s_full[MAX_W_STAGES];  // a stage's weights have landed
  constexpr int W_STAGES = w_stages(R);
  constexpr int W_AHEAD = W_STAGES - 2;
  constexpr int r = R;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_col = Hp / TN;
  const int c0 = (blockIdx.x % n_col) * TN;
  const long long g0 = static_cast<long long>(blockIdx.x / n_col) * TM;  // first flat row
  const int V = M_total + r - 1;  // flat rows an item
  const long long rows_total = static_cast<long long>(B) * V;
  const int a_rows = TM + r - 1;
  const uint32_t w_ring = smem_addr(smem);
  const uint32_t a_ring = w_ring + W_STAGES * r * B_BLOCK;
  const uint32_t full0 = smem_addr(&s_full[0]);

  // staged row s is flat row g = g0 - (r - 1) + s: item g / V, frame
  // g mod V - (r - 1) - edge, zero outside [0, nt)
  for (int s = tid; s < a_rows; s += THREADS) {
    const long long g = g0 - (r - 1) + s;
    long long off = -1;
    if (g >= 0 && g < rows_total) {
      const long long b = g / V;
      const long long f = g - b * V - (r - 1) - edge;
      if (f >= 0 && f < nt) off = (b * nt + f) * F;
    }
    s_row[s] = off;
  }
  if (tid == 0) {
    for (int i = 0; i < W_STAGES; ++i) mbar_init(full0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = K2 / KC;
  // chunk kc's weights: one box a shift, into ring stage kc % W_STAGES
  auto load_w = [&](int kc) {
    if (tid == 0) {
      const int st = kc % W_STAGES;
      const uint32_t bar = full0 + 8 * st;
      mbar_expect_tx(bar, r * B_BLOCK);
      for (int j = 0; j < r; ++j) {
        tma_load_w(w_ring + (st * r + j) * B_BLOCK, &w_map, kc * KC, (j * Hp + c0) / 8, bar);
      }
    }
  };
  // the spectrum: thread tid loads, then converts, bin p = tid % BINS of
  // every chunk, in rows tid / BINS + i THREADS / BINS; where each pair
  // comes from (null: zeros) and goes is the same in every chunk
  const int p = tid % BINS;
  const float2* src[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int s = tid / BINS + i * (THREADS / BINS);
    const long long off = s < a_rows ? s_row[s] : -1;
    src[i] = off >= 0 ? spec + off + p : nullptr;
  }
  const int a_dst = (p / 4) * KQ_STRIDE + (tid / BINS) * 16 + (p % 4) * 4;  // pair 0 of a chunk
  // chunk kc's spectrum pairs into registers, zeros outside the frames and bins
  auto load_spec = [&](int kc, float2 (&pre)[PAIRS]) {
    const bool in_bins = kc < nk && kc * BINS + p < F;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      pre[i] = in_bins && src[i] != nullptr ? __ldg(src[i] + kc * BINS) : make_float2(0.0f, 0.0f);
    }
  };
  // this thread's pairs of chunk kc to bf16: pair (s, p) goes to k group
  // p / 4, row s, position p % 4
  auto convert = [&](int kc, const float2 (&pre)[PAIRS]) {
    unsigned char* a = smem + (a_ring - w_ring) + (kc % A_STAGES) * A_BYTES + a_dst;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      if (tid / BINS + i * (THREADS / BINS) < a_rows) {
        *reinterpret_cast<__nv_bfloat162*>(a + i * (THREADS / BINS) * 16) =
            __floats2bfloat162_rn(pre[i].x, pre[i].y);
      }
    }
  };

  // warpgroup w owns row blocks 2 w and 2 w + 1 of 64 rows
  const int wg_rows = (warp >> 2) * 128;
  float acc[2][64];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0.0f;

  for (int kc = 0; kc < W_AHEAD; ++kc) {
    if (kc < nk) load_w(kc);
  }
  // chunk c's spectrum waits in registers pre<c % 2>, loaded two chunks
  // before it is converted (the chunk loop is unrolled by two so that the
  // buffers keep fixed registers)
  float2 pre0[PAIRS], pre1[PAIRS];
  load_spec(0, pre0);
  load_spec(1, pre1);
  convert(0, pre0);
  load_spec(2, pre0);

  auto step = [&](int kc, float2 (&next)[PAIRS]) {
    mbar_wait(full0 + 8 * (kc % W_STAGES), (kc / W_STAGES) & 1);
    // the converted chunk kc (generic stores) is read by wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kc + W_AHEAD < nk) load_w(kc + W_AHEAD);
    const uint32_t a = a_ring + (kc % A_STAGES) * A_BYTES;
    const uint32_t w = w_ring + (kc % W_STAGES) * r * B_BLOCK;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // output row m uses frame row m - j: staged row m - g0 + (r - 1) - j
        const uint32_t a_rows_at = a + (wg_rows + 64 * t + r - 1 - j) * 16;
        wgmma_m64n128k16(acc[t], desc(a_rows_at, KQ_STRIDE, 128),
                         desc(w + j * B_BLOCK, 128, KC / 8 * 128));
      }
    }
    wgmma_commit();
    if (kc + 1 < nk) {
      convert(kc + 1, next);
      load_spec(kc + 3, next);
    }
    wgmma_wait<1>();
  };
  int kc = 0;
  for (; kc + 2 <= nk; kc += 2) {
    step(kc, pre1);
    step(kc + 1, pre0);
  }
  if (kc < nk) step(kc, pre1);
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(acc[t][i]);

  // out[b, m H + c] = acc * inv_env[m H + c]; accumulator 4 i + e holds
  // n8 tile i, row lane / 4 (+ 8 for e >= 2), column 2 (lane % 4) + e % 2
  const int lane = tid & 31;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long g = g0 + wg_rows + 64 * t + (warp & 3) * 16 + (lane >> 2) + 8 * half;
      const long long b = g / V;
      const int m = static_cast<int>(g - b * V) - (r - 1);
      if (b >= B || m < 0) continue;
      float* orow = out + (b * M_total + m) * H;
      const float* erow = inv_env + static_cast<long long>(m) * H;
#pragma unroll
      for (int ni = 0; ni < TN / 8; ++ni) {
        const int c = c0 + 8 * ni + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e < H) orow[c + e] = acc[t][4 * ni + 2 * half + e] * erow[c + e];
        }
      }
    }
  }
}

template <int R>
int launch(const float2* spec, const CUtensorMap& w_map, const float* inv_env, float* out, int B,
           int nt, int edge, int F, int K2, int H, int Hp, int M_total, cudaStream_t stream) {
  constexpr int r = R;
  const int smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(istft_synthesis_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_total = static_cast<long long>(B) * (M_total + r - 1);
  const long long blocks = (rows_total + TM - 1) / TM * (Hp / TN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  istft_synthesis_kernel<R><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      spec, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// spec: (B, nt, F) complex64; w: (K2, r * Hp) bf16 with K2 a multiple of KC
// and Hp of TN (zero padded); inv_env: (M_total * H,) float32; out: (B,
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
  // the weights (K2, r Hp) bf16 seen as 8 columns x K2 rows x r Hp / 8
  // column groups, so that one box (8, KC, TN / 8) lands in shared memory
  // as the core matrices the descriptor reads; with Hp a multiple of TN a
  // box never reaches past one shift's columns
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return static_cast<int>(cudaErrorNotSupported);
    }
  }
  CUtensorMap w_map;
  const cuuint64_t dims[3] = {8, static_cast<cuuint64_t>(K2), static_cast<cuuint64_t>(r) * Hp / 8};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(r) * Hp * 2, 16};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {8, KC, TN / 8};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* s = static_cast<const float2*>(spec);
  // one kernel for each r: the shifts' products are unrolled
  switch (r) {
    case 1: return launch<1>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
    case 2: return launch<2>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
    case 3: return launch<3>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
    case 4: return launch<4>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
    case 5: return launch<5>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
    case 6: return launch<6>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
    case 7: return launch<7>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
    default: return launch<8>(s, w_map, inv_env, out, B, nt, edge, F, K2, H, Hp, M_total, stream);
  }
}
