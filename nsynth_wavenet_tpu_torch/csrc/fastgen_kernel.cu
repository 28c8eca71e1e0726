// Autoregressive WaveNet generation on Hopper (sm_90a): bf16 weights, and the
// W8A8 serving mode (int8 weights, static activation and gate scales), each
// one-shot or streamed in chunks with carried state.
//
// Replaces the Pallas TPU kernel nsynth_wavenet_tpu/ops/fastgen_kernel.py
// make_generate_fn (pallas_call at :815, kernel body :365-738): its bf16
// branch (:561-571, :605-615), its W8A8 act_scale="static" +
// gate_scale="static" branches (:448-452, :474-475, :487-516, :582-592,
// :625-626, :638-639) and its streaming state (:416-427, :737-738, :840-879);
// greedy or in-kernel sampling for the CE, MoL and Gauss heads, teacher
// forcing, and collection of the head's output parameters.
//
// Per generated sample t, for every batch row:
//   l = conv_start(x(t-2), x(t-1), x(t)),  s = skip_start(l)
//   per layer i (dilation d = 2^(i % num_stages), ring of 2d rows):
//     dpre = [l(t-2d), l(t-d), l, enc(t)] @ w_comb[i] + b_comb[i]
//     gate = sigmoid(dpre[:m]) * tanh(dpre[m:])
//     rs   = gate @ w_rs[i] + b_rs[i]
//     ring[t mod 2d] = l;  l += rs[:W];  s += rs[W:]
//   out = relu(relu(s) @ w_out1[:S] + enc(t) @ w_out1[S:] + b_out1) @ w_out2 + b_out2
//   sample (or take the greedy choice), decode, feed back as x(t+1).
// bf16 mode: matrices are bf16, every product accumulates in f32, and l, s and
// the gate nonlinearity stay f32; the matmul operands l, gate, relu(s) and o1
// are rounded to bf16 exactly where ops/fastgen_kernel.py generate_plain
// rounds them.
// W8A8 mode: w_comb and w_rs are int8 with per-column f32 scales; l is
// quantised per layer with the calibrated multiplier s_act_inv[i] =
// 127/amax_i (clip(rint(l * s_act_inv[i]), +-127)), so the ring rows of layer
// i are int8 at layer i's scale; enc(t) is quantised per row (scale r_enc);
// the products are int8 x int8 -> int32, exact, and
//     dpre = float(mm) * s_main[i] + float(acc_enc) * r_enc * s_comb[i] + b_comb[i]
// with the 3W part (mm) and the enc part (acc_enc) kept as separate sums;
// the gate leaves as int8 rint(gate * 127) and rs = float(acc) * s_rs[i] +
// b_rs[i] (s_rs holds the 1/127).  l, s, the gate nonlinearity and the head
// stay as in bf16 mode.  Rounding is to nearest even (rintf) everywhere, and
// the dequantising multiplies and adds are kept unfused (__fmul_rn,
// __fadd_rn) so that they round where the plain version rounds.
//
// Design (simple and right first):
//   gate_kernel     one launch per layer: a 64-row x (16 sigmoid + 16 tanh)
//                   column tile, so the gate is formed in the epilogue; the
//                   stacked operand is gathered on the fly from the two ring
//                   rows, l and enc(t).  K = 3W+DW is split over GA_KSPAN-wide
//                   slices, one block each, so that a block walks 4 chunks
//                   instead of 28; the last block of a tile to finish sums
//                   the slices' partial tiles in slice order (deterministic),
//                   adds the bias and forms the gate.
//   resskip_kernel  one launch per layer: 64x64 tiles of gate @ w_rs; the
//                   epilogue writes the PRE-residual l to ring slot t mod 2d
//                   (the slot gate_kernel just read as the t-2d tap, so the
//                   read finishes before the write by stream order) and
//                   updates l and s.
//   head_kernel     one launch per step, 16 batch rows per block: out head,
//                   sampler (Philox4x32-10 keyed by seed, t0 + t, row, lane),
//                   decode, feedback, then conv_start and skip_start of the
//                   next step (W8A8: and layer 0's quantised l).
//   gate_kernel_i8, resskip_kernel_i8   the W8A8 twins in the same tile
//                   structure on mma.sync.m16n8k32.s8 with int32 sums.  The
//                   int8 matrices are stored with four consecutive k of a
//                   column in one 32-bit word ([K/4, N, 4]), the B-fragment
//                   layout of that instruction.  K slices never straddle the
//                   3W boundary (the 3W part and the enc part are sliced
//                   separately), the partial tiles are int32, so their sum is
//                   exact in any order.  resskip_kernel_i8 copies the current
//                   int8 l to the ring and writes the next layer's.
//   quant_enc_kernel  W8A8 pre-pass, once per call: enc [L, B, DW] bf16 ->
//                   int8 rows and their f32 scales (a warp per row).
// The time and layer loops live in fastgen_generate: one host call per
// utterance or chunk enqueues 2*NL+1 launches per step on PyTorch's current
// stream.  Streaming: the ring and the three input taps come in and go out as
// state, and every ring phase and random counter runs on t0 + t, so chained
// calls repeat the one-shot call's arithmetic bit for bit.
// bf16 products use warp-level WMMA 16x16x16 bf16 tensor-core tiles.
//
// Bound per step (MoL teacher, W=512, GW=512, S=256, DW=256, NL=30):
//   operations 2 * B * 33.4 M (w_comb 30*1792*512 + w_rs 30*256*768 + head);
//   bf16: ~67 MB of weights, which exceed the 50 MB L2 and so stream from HBM
//   every step, plus ~92 KB * B of ring reads and writes; at 3.35 TB/s and
//   989 TFLOP/s the weight stream (~20 us) bounds B < ~300, the tensor-core
//   rate bounds larger B.
//   W8A8: 33.4 MB of int8 layer weights (they fit L2) + 0.5 MB of bf16 head,
//   ~46 KB * B of int8 ring traffic; at 1979 TOP/s int8 the layer products
//   take half the bf16 time, so the weight stream (~10 us) bounds B < ~600.
// Measured on an H100 (chip_smoke.py, see PERF.md): both modes run far above
// these bounds: the step is 61 latency-bound launches.  Left on the table:
// every 64-row batch tile re-reads the layer's weights, the head runs on B/16
// blocks, the K loop is register-double-buffered but has no cp.async/TMA
// pipeline, and no wgmma.  A persistent whole-utterance kernel with TMA-fed
// wgmma, and CUDA graphs of the launches, are later work.

#include "fastgen_kernel.cuh"

#include <math.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kLog256 = 5.545177444479562f;
constexpr float kTwoPi = 6.283185307179586f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;


// ---------------------------------------------------------------------------
// gate_kernel: gate[B, m] of one layer
// ---------------------------------------------------------------------------
// Every loop below issues all of a thread's global loads before it uses any
// of them, and the next K chunk is loaded into registers while the current
// one is in the tensor cores: a load used right after it is issued would
// serialize a memory round trip per element.
constexpr int GA_BM = 64, GA_BN = 16, GA_KC = 64, GA_KSPAN = 256, GA_THREADS = 128;
constexpr int GA_TILE = GA_BM * 2 * GA_BN;  // floats of one partial tile
constexpr int GA_LDA = GA_KC + 8;
constexpr int GA_LDB = 2 * GA_BN + 8;
constexpr int GA_LDC = 2 * GA_BN + 4;
constexpr int GA_AV = GA_BM * GA_KC / 8 / GA_THREADS;  // 16-byte A vectors per thread per chunk
constexpr int GA_BV = GA_KC * 4 / GA_THREADS;          // 16-byte B vectors per thread per chunk
constexpr int GA_RED = GA_TILE / GA_THREADS;            // partial-tile floats per thread
constexpr int GA_OUT = GA_BM * GA_BN / GA_THREADS;      // gate values per thread

__global__ void __launch_bounds__(GA_THREADS)
gate_kernel(const bf16* __restrict__ tap2, const bf16* __restrict__ tap1,
            const bf16* __restrict__ l_bf, const bf16* __restrict__ enc,
            const bf16* __restrict__ w, const float* __restrict__ bias,
            bf16* __restrict__ gate, float* __restrict__ part, unsigned* __restrict__ counters,
            int B, int W, int DW, int GW) {
  __shared__ __align__(32) bf16 As[GA_BM * GA_LDA];
  __shared__ __align__(32) bf16 Bs[GA_KC * GA_LDB];
  __shared__ __align__(32) float Cs[GA_BM * GA_LDC];
  __shared__ float bias_s[2 * GA_BN];
  __shared__ unsigned is_last;
  const int m = GW / 2;
  const int j0 = blockIdx.x * GA_BN;
  const int row0 = blockIdx.y * GA_BM;
  const int warp = threadIdx.x / 32;
  const int K = 3 * W + DW;
  const int nsplit = gridDim.z;
  const int k_end = min(K, ((int)blockIdx.z + 1) * GA_KSPAN);
  if (threadIdx.x < 2 * GA_BN)
    bias_s[threadIdx.x] = bias[threadIdx.x < GA_BN ? j0 + threadIdx.x : m + j0 + threadIdx.x - GA_BN];

  // stacked operand [tap(t-2d) | tap(t-d) | bf16(l) | enc(t)] and the weight
  // columns j0..j0+15 (sigmoid half) and m+j0..m+j0+15 (tanh half)
  uint4 ra[GA_AV], rb[GA_BV];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < GA_AV; ++i) {
      const int v = threadIdx.x + i * GA_THREADS;
      const int b = row0 + v / (GA_KC / 8), k = k0 + (v % (GA_KC / 8)) * 8;
      const bf16* src = k < W       ? tap2 + (size_t)b * W + k
                        : k < 2 * W ? tap1 + (size_t)b * W + (k - W)
                        : k < 3 * W ? l_bf + (size_t)b * W + (k - 2 * W)
                                    : enc + (size_t)b * DW + (k - 3 * W);
      ra[i] = b < B ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < GA_BV; ++i) {
      const int v = threadIdx.x + i * GA_THREADS;
      const int r = v / 4, q = v % 4;
      const int col = q < 2 ? j0 + q * 8 : m + j0 + (q - 2) * 8;
      rb[i] = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * GW + col);
    }
  };

  FragC acc_sig, acc_tanh;
  wmma::fill_fragment(acc_sig, 0.0f);
  wmma::fill_fragment(acc_tanh, 0.0f);
  load_chunk(blockIdx.z * GA_KSPAN);
  for (int k0 = blockIdx.z * GA_KSPAN; k0 < k_end; k0 += GA_KC) {
#pragma unroll
    for (int i = 0; i < GA_AV; ++i) {
      const int v = threadIdx.x + i * GA_THREADS;
      *reinterpret_cast<uint4*>(As + (v / (GA_KC / 8)) * GA_LDA + (v % (GA_KC / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < GA_BV; ++i) {
      const int v = threadIdx.x + i * GA_THREADS;
      *reinterpret_cast<uint4*>(Bs + (v / 4) * GA_LDB + (v % 4) * 8) = rb[i];
    }
    __syncthreads();
    if (k0 + GA_KC < k_end) load_chunk(k0 + GA_KC);
#pragma unroll
    for (int kk = 0; kk < GA_KC; kk += 16) {
      FragA a;
      FragB bs, bt;
      wmma::load_matrix_sync(a, As + warp * 16 * GA_LDA + kk, GA_LDA);
      wmma::load_matrix_sync(bs, Bs + kk * GA_LDB, GA_LDB);
      wmma::load_matrix_sync(bt, Bs + kk * GA_LDB + GA_BN, GA_LDB);
      wmma::mma_sync(acc_sig, a, bs, acc_sig);
      wmma::mma_sync(acc_tanh, a, bt, acc_tanh);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(Cs + warp * 16 * GA_LDC, acc_sig, GA_LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(Cs + warp * 16 * GA_LDC + GA_BN, acc_tanh, GA_LDC, wmma::mem_row_major);
  __syncthreads();
  if (nsplit > 1) {
    // publish this slice's partial tile; the last slice to arrive sums all
    // slices in slice order (deterministic) and forms the gate
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* mine = part + ((size_t)tile * nsplit + blockIdx.z) * GA_TILE;
#pragma unroll
    for (int i = 0; i < GA_RED; ++i) {
      const int e = threadIdx.x + i * GA_THREADS;
      mine[e] = Cs[(e / (2 * GA_BN)) * GA_LDC + e % (2 * GA_BN)];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(&counters[tile], 1u) == (unsigned)nsplit - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* tiles = part + (size_t)tile * nsplit * GA_TILE;
    float sum[GA_RED];
#pragma unroll
    for (int i = 0; i < GA_RED; ++i) sum[i] = 0.0f;
    for (int z = 0; z < nsplit; ++z) {
      float v[GA_RED];
#pragma unroll
      for (int i = 0; i < GA_RED; ++i) v[i] = __ldcg(tiles + (size_t)z * GA_TILE + threadIdx.x + i * GA_THREADS);
#pragma unroll
      for (int i = 0; i < GA_RED; ++i) sum[i] += v[i];
    }
#pragma unroll
    for (int i = 0; i < GA_RED; ++i) {
      const int e = threadIdx.x + i * GA_THREADS;
      Cs[(e / (2 * GA_BN)) * GA_LDC + e % (2 * GA_BN)] = sum[i];
    }
    if (threadIdx.x == 0) counters[tile] = 0u;  // ready for the next layer
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < GA_OUT; ++i) {
    const int e = threadIdx.x + i * GA_THREADS;
    const int r = e / GA_BN, c = e % GA_BN, b = row0 + r;
    if (b < B) {
      const float xs = Cs[r * GA_LDC + c] + bias_s[c];
      const float xt = Cs[r * GA_LDC + GA_BN + c] + bias_s[GA_BN + c];
      const float g = (1.0f / (1.0f + expf(-xs))) * tanhf(xt);
      gate[(size_t)b * m + j0 + c] = __float2bfloat16(g);
    }
  }
}

// ---------------------------------------------------------------------------
// resskip_kernel: rs = gate @ w_rs + b_rs; ring write; l += rs[:W]; s += rs[W:]
// ---------------------------------------------------------------------------
constexpr int RS_BM = 64, RS_BN = 64, RS_KC = 64, RS_THREADS = 128;
constexpr int RS_LDA = RS_KC + 8;
constexpr int RS_LDB = RS_BN + 8;
constexpr int RS_LDC = RS_BN + 4;
constexpr int RS_AV = RS_BM * RS_KC / 8 / RS_THREADS;
constexpr int RS_BV = RS_KC * RS_BN / 8 / RS_THREADS;
constexpr int RS_OUT = RS_BM * RS_BN / RS_THREADS;

__global__ void __launch_bounds__(RS_THREADS)
resskip_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ l, bf16* __restrict__ l_bf,
               float* __restrict__ s, bf16* __restrict__ ring_row, int B, int W, int S, int m) {
  __shared__ __align__(32) bf16 As[RS_BM * RS_LDA];
  __shared__ __align__(32) bf16 Bs[RS_KC * RS_LDB];
  __shared__ __align__(32) float Cs[RS_BM * RS_LDC];
  __shared__ float bias_s[RS_BN];
  const int N = W + S;
  const int n0 = blockIdx.x * RS_BN;
  const int row0 = blockIdx.y * RS_BM;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x < RS_BN) bias_s[threadIdx.x] = bias[n0 + threadIdx.x];
  // the epilogue's l / s operands, fetched now so their latency hides behind the MMAs
  float old[RS_OUT];
#pragma unroll
  for (int i = 0; i < RS_OUT; ++i) {
    const int e = threadIdx.x + i * RS_THREADS;
    const int b = row0 + e / RS_BN, c = n0 + e % RS_BN;
    old[i] = b >= B ? 0.0f : c < W ? l[(size_t)b * W + c] : s[(size_t)b * S + (c - W)];
  }

  uint4 ra[RS_AV], rb[RS_BV];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < RS_AV; ++i) {
      const int v = threadIdx.x + i * RS_THREADS;
      const int b = row0 + v / (RS_KC / 8);
      ra[i] = b < B ? *reinterpret_cast<const uint4*>(gate + (size_t)b * m + k0 + (v % (RS_KC / 8)) * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < RS_BV; ++i) {
      const int v = threadIdx.x + i * RS_THREADS;
      rb[i] = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + v / (RS_BN / 8)) * N + n0 +
                                              (v % (RS_BN / 8)) * 8);
    }
  };

  FragC acc[RS_BN / 16];
#pragma unroll
  for (int j = 0; j < RS_BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  load_chunk(0);
  for (int k0 = 0; k0 < m; k0 += RS_KC) {
#pragma unroll
    for (int i = 0; i < RS_AV; ++i) {
      const int v = threadIdx.x + i * RS_THREADS;
      *reinterpret_cast<uint4*>(As + (v / (RS_KC / 8)) * RS_LDA + (v % (RS_KC / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < RS_BV; ++i) {
      const int v = threadIdx.x + i * RS_THREADS;
      *reinterpret_cast<uint4*>(Bs + (v / (RS_BN / 8)) * RS_LDB + (v % (RS_BN / 8)) * 8) = rb[i];
    }
    __syncthreads();
    if (k0 + RS_KC < m) load_chunk(k0 + RS_KC);
#pragma unroll
    for (int kk = 0; kk < RS_KC; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, As + warp * 16 * RS_LDA + kk, RS_LDA);
#pragma unroll
      for (int j = 0; j < RS_BN / 16; ++j) {
        FragB bf;
        wmma::load_matrix_sync(bf, Bs + kk * RS_LDB + j * 16, RS_LDB);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RS_BN / 16; ++j)
    wmma::store_matrix_sync(Cs + warp * 16 * RS_LDC + j * 16, acc[j], RS_LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RS_OUT; ++i) {
    const int e = threadIdx.x + i * RS_THREADS;
    const int r = e / RS_BN, cc = e % RS_BN, b = row0 + r, c = n0 + cc;
    if (b < B) {
      const float v = Cs[r * RS_LDC + cc] + bias_s[cc];
      if (c < W) {
        const size_t idx = (size_t)b * W + c;
        const float now = old[i] + v;
        ring_row[idx] = __float2bfloat16(old[i]);
        l[idx] = now;
        l_bf[idx] = __float2bfloat16(now);
      } else {
        s[(size_t)b * S + (c - W)] = old[i] + v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// W8A8 kernels: int8 x int8 -> int32 on mma.sync.m16n8k32
// ---------------------------------------------------------------------------
// One warp-level product: C[16, 8] += A[16, 32] @ B[32, 8], s8 operands, s32
// sums.  With g = lane / 4 and q = lane % 4 a thread holds
//   a[0] = A[g, 4q..4q+3]   a[1] = A[g+8, 4q..4q+3]   a[2], a[3]: columns + 16
//   b0 = B[4q..4q+3, g]     b1 = B[16+4q..16+4q+3, g]
//   c[0], c[1] = C[g, 2q], C[g, 2q+1]     c[2], c[3] = C[g+8, 2q], C[g+8, 2q+1]
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(rint(x * inv), +-127): the static activation quantiser (round half to even)
__device__ __forceinline__ signed char quant_static(float x, float inv) {
  return (signed char)(int)fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f);
}

// ---- quant_enc_kernel: per-row dynamic quantisation of the conditioning ----
// amax, the multiplier 127/amax and the product x * mult are rounded to bf16
// where the reference rounds them (its enc is bf16 and the product is a bf16
// product, which can reach 127.5: the clip keeps the int8 from wrapping).
constexpr int QE_THREADS = 128;

__global__ void __launch_bounds__(QE_THREADS)
quant_enc_kernel(const bf16* __restrict__ enc, signed char* __restrict__ q_enc,
                 float* __restrict__ r_enc, long long rows, int DW) {
  const long long row = (long long)blockIdx.x * (QE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  const bf16* x = enc + row * DW;
  float amax = 0.0f;
  for (int i = lane; i < DW; i += 32) amax = fmaxf(amax, fabsf(__bfloat162float(x[i])));
  for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  amax = fmaxf(amax, 1e-8f);
  const float mult = __bfloat162float(__float2bfloat16(__fdiv_rn(127.0f, amax)));
  for (int i = lane; i < DW; i += 32) {
    const float prod = __bfloat162float(__float2bfloat16(__fmul_rn(__bfloat162float(x[i]), mult)));
    q_enc[row * DW + i] = (signed char)(int)fminf(fmaxf(rintf(prod), -127.0f), 127.0f);
  }
  if (lane == 0) r_enc[row] = __fmul_rn(amax, (float)(1.0 / 127.0));
}

// ---- gate_kernel_i8: int8 gate[B, m] of one layer ----
constexpr int GI_BM = 64, GI_BN = 16, GI_KC = 64, GI_KSPAN = 256, GI_THREADS = 128;
constexpr int GI_TILE = GI_BM * 2 * GI_BN;  // int32 of one partial tile
constexpr int GI_LDA = GI_KC + 16;          // bytes: 20 words, so the 8 rows of a fragment hit 8 bank groups
constexpr int GI_LDB = 2 * GI_BN + 8;       // words (4 k each): 40, so 4 k-words x 8 columns hit 32 banks
constexpr int GI_AV = GI_BM * GI_KC / 16 / GI_THREADS;              // 16-byte A vectors per thread per chunk
constexpr int GI_BV = (GI_KC / 4) * 2 * GI_BN * 4 / 16 / GI_THREADS;  // 16-byte B vectors per thread per chunk
constexpr int GI_OUT = GI_BM * GI_BN / GI_THREADS;                  // gate values per thread
static_assert(GI_BV == 1, "one weight vector per thread per chunk");

__host__ __device__ inline int gi_slices(int k) { return (k + GI_KSPAN - 1) / GI_KSPAN; }

__global__ void __launch_bounds__(GI_THREADS)
gate_kernel_i8(const signed char* __restrict__ tap2, const signed char* __restrict__ tap1,
               const signed char* __restrict__ q_l, const signed char* __restrict__ q_enc,
               const float* __restrict__ r_enc, const uint32_t* __restrict__ w,
               const float* __restrict__ s_main, const float* __restrict__ s_comb,
               const float* __restrict__ bias, signed char* __restrict__ gate,
               int* __restrict__ part, unsigned* __restrict__ counters, int B, int W, int DW, int GW) {
  __shared__ __align__(16) signed char As[GI_BM * GI_LDA];
  __shared__ __align__(16) uint32_t Bs[(GI_KC / 4) * GI_LDB];
  __shared__ unsigned is_last;
  const int m = GW / 2;
  const int j0 = blockIdx.x * GI_BN;
  const int row0 = blockIdx.y * GI_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  // K slices: the 3W part and the enc part are cut separately, because they
  // dequantise with different multipliers and their sums must stay apart
  const int nz_main = gi_slices(3 * W), nsplit = gridDim.z;
  const bool is_enc = (int)blockIdx.z >= nz_main;
  const int k_begin = is_enc ? 3 * W + ((int)blockIdx.z - nz_main) * GI_KSPAN : (int)blockIdx.z * GI_KSPAN;
  const int k_end = min(is_enc ? 3 * W + DW : 3 * W, k_begin + GI_KSPAN);

  // stacked operand [tap(t-2d) | tap(t-d) | q_l | q_enc(t)] and the weight
  // columns j0..j0+15 (sigmoid half) and m+j0..m+j0+15 (tanh half)
  uint4 ra[GI_AV], rb;
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < GI_AV; ++i) {
      const int v = threadIdx.x + i * GI_THREADS;
      const int b = row0 + v / (GI_KC / 16), k = k0 + (v % (GI_KC / 16)) * 16;
      const signed char* src = k < W       ? tap2 + (size_t)b * W + k
                               : k < 2 * W ? tap1 + (size_t)b * W + (k - W)
                               : k < 3 * W ? q_l + (size_t)b * W + (k - 2 * W)
                                           : q_enc + (size_t)b * DW + (k - 3 * W);
      ra[i] = b < B ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
    }
    const int r = threadIdx.x / 8, c = threadIdx.x % 8;  // k-word row, 4-column group
    const int col = c < 4 ? j0 + c * 4 : m + j0 + (c - 4) * 4;
    rb = *reinterpret_cast<const uint4*>(w + (size_t)(k0 / 4 + r) * GW + col);
  };

  int acc[4][4];  // n-tiles 0, 1: sigmoid columns; 2, 3: tanh columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  const uint32_t* Aw = reinterpret_cast<const uint32_t*>(As);
  load_chunk(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += GI_KC) {
#pragma unroll
    for (int i = 0; i < GI_AV; ++i) {
      const int v = threadIdx.x + i * GI_THREADS;
      *reinterpret_cast<uint4*>(As + (v / (GI_KC / 16)) * GI_LDA + (v % (GI_KC / 16)) * 16) = ra[i];
    }
    *reinterpret_cast<uint4*>(Bs + (threadIdx.x / 8) * GI_LDB + (threadIdx.x % 8) * 4) = rb;
    __syncthreads();
    if (k0 + GI_KC < k_end) load_chunk(k0 + GI_KC);
#pragma unroll
    for (int kk = 0; kk < GI_KC; kk += 32) {
      uint32_t a[4];
      const uint32_t* ar = Aw + (warp * 16 + g) * (GI_LDA / 4) + kk / 4 + q;
      a[0] = ar[0];
      a[1] = ar[8 * (GI_LDA / 4)];
      a[2] = ar[4];
      a[3] = ar[8 * (GI_LDA / 4) + 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* br = Bs + (kk / 4 + q) * GI_LDB + j * 8 + g;
        mma_s8(acc[j], a, br[0], br[4 * GI_LDB]);
      }
    }
    __syncthreads();
  }
  // publish this slice's partial tile [64, 32] int32; the last slice to arrive
  // sums the main slices and the enc slices apart and forms the gate
  const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
  int* mine = part + ((size_t)tile * nsplit + blockIdx.z) * GI_TILE;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = warp * 16 + g, c = j * 8 + q * 2;
    *reinterpret_cast<int2*>(mine + r * 2 * GI_BN + c) = make_int2(acc[j][0], acc[j][1]);
    *reinterpret_cast<int2*>(mine + (r + 8) * 2 * GI_BN + c) = make_int2(acc[j][2], acc[j][3]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&counters[tile], 1u) == (unsigned)nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) counters[tile] = 0u;  // ready for the next layer
  const int* tiles = part + (size_t)tile * nsplit * GI_TILE;
  int sum[2][2][GI_OUT];  // [main | enc][sigmoid | tanh][value]
#pragma unroll
  for (int i = 0; i < GI_OUT; ++i) sum[0][0][i] = sum[0][1][i] = sum[1][0][i] = sum[1][1][i] = 0;
  for (int z = 0; z < nsplit; ++z) {
    int vs[GI_OUT], vt[GI_OUT];
#pragma unroll
    for (int i = 0; i < GI_OUT; ++i) {
      const int e = threadIdx.x + i * GI_THREADS;
      const int* p = tiles + (size_t)z * GI_TILE + (e / GI_BN) * 2 * GI_BN + e % GI_BN;
      vs[i] = __ldcg(p);
      vt[i] = __ldcg(p + GI_BN);
    }
    if (z < nz_main) {
#pragma unroll
      for (int i = 0; i < GI_OUT; ++i) sum[0][0][i] += vs[i], sum[0][1][i] += vt[i];
    } else {
#pragma unroll
      for (int i = 0; i < GI_OUT; ++i) sum[1][0][i] += vs[i], sum[1][1][i] += vt[i];
    }
  }
#pragma unroll
  for (int i = 0; i < GI_OUT; ++i) {
    const int e = threadIdx.x + i * GI_THREADS;
    const int c = e % GI_BN, b = row0 + e / GI_BN;
    if (b < B) {
      const float re = r_enc[b];
      float x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * m + j0 + c;
        const float main_part = __fmul_rn((float)sum[0][h][i], s_main[col]);
        const float enc_part = __fmul_rn(__fmul_rn((float)sum[1][h][i], re), s_comb[col]);
        x[h] = __fadd_rn(__fadd_rn(main_part, enc_part), bias[col]);
      }
      const float gv = __fmul_rn(1.0f / (1.0f + expf(-x[0])), tanhf(x[1]));
      gate[(size_t)b * m + j0 + c] = (signed char)__float2int_rn(__fmul_rn(gv, 127.0f));
    }
  }
}

// ---- resskip_kernel_i8: rs = q_gate @ w_rs * s_rs + b_rs; ring write; l, s, next q_l ----
constexpr int RI_BM = 64, RI_BN = 64, RI_KC = 64, RI_THREADS = 128;
constexpr int RI_LDA = RI_KC + 16;  // bytes
constexpr int RI_LDB = RI_BN + 8;   // words (4 k each)
constexpr int RI_LDC = RI_BN + 4;   // int32
constexpr int RI_AV = RI_BM * RI_KC / 16 / RI_THREADS;
constexpr int RI_BV = (RI_KC / 4) * RI_BN * 4 / 16 / RI_THREADS;
constexpr int RI_OUT = RI_BM * RI_BN / 4 / RI_THREADS;  // 4-column groups per thread

__global__ void __launch_bounds__(RI_THREADS)
resskip_kernel_i8(const signed char* __restrict__ gate, const uint32_t* __restrict__ w,
                  const float* __restrict__ s_rs, const float* __restrict__ bias,
                  float* __restrict__ l, signed char* __restrict__ q_l, float* __restrict__ s,
                  signed char* __restrict__ ring_row, const float* __restrict__ inv_next_p, int B,
                  int W, int S, int m) {
  __shared__ __align__(16) signed char As[RI_BM * RI_LDA];
  __shared__ __align__(16) uint32_t Bs[(RI_KC / 4) * RI_LDB];
  __shared__ __align__(16) int Cs[RI_BM * RI_LDC];
  const int N = W + S;
  const int n0 = blockIdx.x * RI_BN;
  const int row0 = blockIdx.y * RI_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const bool is_l = n0 < W;  // W % 64 == 0: a tile lies wholly in the res or in the skip columns
  const bool has_next = inv_next_p != nullptr;  // null for the last layer: no next int8 l
  const float inv_next = has_next ? *inv_next_p : 0.0f;
  // the epilogue's l / s operands, fetched now so their latency hides behind the MMAs
  float4 old[RI_OUT];
#pragma unroll
  for (int i = 0; i < RI_OUT; ++i) {
    const int e = threadIdx.x + i * RI_THREADS;
    const int b = row0 + e / (RI_BN / 4), c = n0 + (e % (RI_BN / 4)) * 4;
    old[i] = b >= B ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
             : is_l ? *reinterpret_cast<const float4*>(l + (size_t)b * W + c)
                    : *reinterpret_cast<const float4*>(s + (size_t)b * S + (c - W));
  }

  uint4 ra[RI_AV], rb[RI_BV];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < RI_AV; ++i) {
      const int v = threadIdx.x + i * RI_THREADS;
      const int b = row0 + v / (RI_KC / 16);
      ra[i] = b < B ? *reinterpret_cast<const uint4*>(gate + (size_t)b * m + k0 + (v % (RI_KC / 16)) * 16)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < RI_BV; ++i) {
      const int v = threadIdx.x + i * RI_THREADS;
      rb[i] = *reinterpret_cast<const uint4*>(w + (size_t)(k0 / 4 + v / (RI_BN / 4)) * N + n0 +
                                              (v % (RI_BN / 4)) * 4);
    }
  };

  int acc[RI_BN / 8][4];
#pragma unroll
  for (int j = 0; j < RI_BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  const uint32_t* Aw = reinterpret_cast<const uint32_t*>(As);
  load_chunk(0);
  for (int k0 = 0; k0 < m; k0 += RI_KC) {
#pragma unroll
    for (int i = 0; i < RI_AV; ++i) {
      const int v = threadIdx.x + i * RI_THREADS;
      *reinterpret_cast<uint4*>(As + (v / (RI_KC / 16)) * RI_LDA + (v % (RI_KC / 16)) * 16) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < RI_BV; ++i) {
      const int v = threadIdx.x + i * RI_THREADS;
      *reinterpret_cast<uint4*>(Bs + (v / (RI_BN / 4)) * RI_LDB + (v % (RI_BN / 4)) * 4) = rb[i];
    }
    __syncthreads();
    if (k0 + RI_KC < m) load_chunk(k0 + RI_KC);
#pragma unroll
    for (int kk = 0; kk < RI_KC; kk += 32) {
      uint32_t a[4];
      const uint32_t* ar = Aw + (warp * 16 + g) * (RI_LDA / 4) + kk / 4 + q;
      a[0] = ar[0];
      a[1] = ar[8 * (RI_LDA / 4)];
      a[2] = ar[4];
      a[3] = ar[8 * (RI_LDA / 4) + 4];
#pragma unroll
      for (int j = 0; j < RI_BN / 8; ++j) {
        const uint32_t* br = Bs + (kk / 4 + q) * RI_LDB + j * 8 + g;
        mma_s8(acc[j], a, br[0], br[4 * RI_LDB]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RI_BN / 8; ++j) {
    int* cr = Cs + (warp * 16 + g) * RI_LDC + j * 8 + q * 2;
    *reinterpret_cast<int2*>(cr) = make_int2(acc[j][0], acc[j][1]);
    *reinterpret_cast<int2*>(cr + 8 * RI_LDC) = make_int2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  // each (row, 4 columns) is owned by one thread: it copies the current int8 l
  // to the ring, updates l and writes the next layer's int8 l in place
#pragma unroll
  for (int i = 0; i < RI_OUT; ++i) {
    const int e = threadIdx.x + i * RI_THREADS;
    const int r = e / (RI_BN / 4), cc = (e % (RI_BN / 4)) * 4, b = row0 + r, c = n0 + cc;
    if (b >= B) continue;
    const int4 sums = *reinterpret_cast<const int4*>(Cs + r * RI_LDC + cc);
    const float4 sc = *reinterpret_cast<const float4*>(s_rs + c);
    const float4 bi = *reinterpret_cast<const float4*>(bias + c);
    float4 now;
    now.x = __fadd_rn(old[i].x, __fadd_rn(__fmul_rn((float)sums.x, sc.x), bi.x));
    now.y = __fadd_rn(old[i].y, __fadd_rn(__fmul_rn((float)sums.y, sc.y), bi.y));
    now.z = __fadd_rn(old[i].z, __fadd_rn(__fmul_rn((float)sums.z, sc.z), bi.z));
    now.w = __fadd_rn(old[i].w, __fadd_rn(__fmul_rn((float)sums.w, sc.w), bi.w));
    if (is_l) {
      const size_t idx = (size_t)b * W + c;
      *reinterpret_cast<char4*>(ring_row + idx) = *reinterpret_cast<const char4*>(q_l + idx);
      *reinterpret_cast<float4*>(l + idx) = now;
      if (has_next)
        *reinterpret_cast<char4*>(q_l + idx) =
            make_char4(quant_static(now.x, inv_next), quant_static(now.y, inv_next),
                       quant_static(now.z, inv_next), quant_static(now.w, inv_next));
    } else {
      *reinterpret_cast<float4*>(s + (size_t)b * S + (c - W)) = now;
    }
  }
}

// ---------------------------------------------------------------------------
// head_kernel: out head + sampler + feedback, then the next step's start
// ---------------------------------------------------------------------------
constexpr int HD_ROWS = 16, HD_THREADS = 256;

// Cs[16, N] = As[16, K] @ Wg[K, N] (Wg row-major bf16 in global memory)
__device__ void rowtile_gemm(const bf16* As, int lda, const bf16* __restrict__ Wg, int K, int N,
                             float* Cs, int ldc) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int nt = warp; nt < N / 16; nt += nwarps) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      FragA a;
      FragB bf;
      wmma::load_matrix_sync(a, As + k, lda);
      wmma::load_matrix_sync(bf, Wg + (size_t)k * N + nt * 16, N);
      wmma::mma_sync(acc, a, bf, acc);
    }
    wmma::store_matrix_sync(Cs + nt * 16, acc, ldc, wmma::mem_row_major);
  }
}

struct HeadLayout {
  int lda, ldc, a_bytes, bytes;
};

__host__ __device__ inline HeadLayout head_layout(const FastgenArgs& a) {
  HeadLayout h;
  const int ka = a.S + a.DW > a.W ? a.S + a.DW : a.W;
  const int nc = a.out_pad > a.S ? a.out_pad : a.S;
  h.lda = ka + 8;
  h.ldc = nc + 4;
  h.a_bytes = (HD_ROWS * h.lda * 2 + 127) / 128 * 128;
  h.bytes = h.a_bytes + HD_ROWS * h.ldc * 4;
  return h;
}

__device__ __forceinline__ void warp_argmax(float& best, int& idx) {
  for (int off = 16; off; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

__device__ __forceinline__ float sign_of(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

__global__ void __launch_bounds__(HD_THREADS)
head_kernel(const FastgenArgs a, int t, int do_head, int do_start) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadLayout hl = head_layout(a);
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + hl.a_bytes);
  const int B = a.B, W = a.W, S = a.S, DW = a.DW, P = a.out_pad;
  const int row0 = blockIdx.x * HD_ROWS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  float* xh = static_cast<float*>(a.xh);

  if (do_head) {
    const float* s = static_cast<const float*>(a.s);
    const bf16* enc = static_cast<const bf16*>(a.enc) + (size_t)t * B * DW;
    for (int e = threadIdx.x; e < HD_ROWS * (S + DW); e += blockDim.x) {
      const int r = e / (S + DW), c = e % (S + DW), b = row0 + r;
      bf16 v = __float2bfloat16(0.0f);
      if (b < B) v = c < S ? __float2bfloat16(fmaxf(s[(size_t)b * S + c], 0.0f))
                           : enc[(size_t)b * DW + (c - S)];
      As[r * hl.lda + c] = v;
    }
    __syncthreads();
    rowtile_gemm(As, hl.lda, static_cast<const bf16*>(a.w_out1), S + DW, S, Cs, hl.ldc);
    __syncthreads();
    const float* b_out1 = static_cast<const float*>(a.b_out1);
    for (int e = threadIdx.x; e < HD_ROWS * S; e += blockDim.x) {
      const int r = e / S, c = e % S;
      As[r * hl.lda + c] = __float2bfloat16(fmaxf(Cs[r * hl.ldc + c] + b_out1[c], 0.0f));
    }
    __syncthreads();
    rowtile_gemm(As, hl.lda, static_cast<const bf16*>(a.w_out2), S, P, Cs, hl.ldc);
    __syncthreads();
    const float* b_out2 = static_cast<const float*>(a.b_out2);
    float* outp = static_cast<float*>(a.out_params);
    for (int e = threadIdx.x; e < HD_ROWS * P; e += blockDim.x) {
      const int r = e / P, c = e % P, b = row0 + r;
      const float v = Cs[r * hl.ldc + c] + b_out2[c];
      Cs[r * hl.ldc + c] = v;
      if (outp != nullptr && b < B) outp[((size_t)t * B + b) * P + c] = v;
    }
    __syncthreads();

    // ---- sampling: one warp per batch row ----
    const uint32_t k0 = (uint32_t)((unsigned long long)a.seed & 0xffffffffull);
    const uint32_t k1 = (uint32_t)((unsigned long long)a.seed >> 32);
    const float half = (float)(a.quant_chann / 2);
    const uint32_t tg = (uint32_t)(a.t0 + t);  // the random counter runs on the global step
    float* audio = static_cast<float*>(a.audio);
    const float* tf = static_cast<const float*>(a.tf);
    for (int r = warp; r < HD_ROWS; r += nwarps) {
      const int b = row0 + r;
      if (b >= B) continue;  // warp-uniform
      const float* o = Cs + r * hl.ldc;
      float qv = 0.0f, x = 0.0f;
      if (a.head == HEAD_GAUSS) {
        x = o[0];
        if (!a.greedy) {
          const float u1 = uniform_from_bits(philox_bits(0u, b, tg, 0u, k0, k1));
          const float u2 = uniform_from_bits(philox_bits(0u, b, tg, 1u, k0, k1));
          const float z = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
          x = x + expf(fmaxf(o[1], -7.0f)) * z;
        }
      } else {
        const int n = a.head == HEAD_MOL ? a.out_seg : P;
        float best = -INFINITY;
        int idx = 0x7fffffff;
        for (int i = lane; i < n; i += 32) {
          float sc = o[i];
          if (!a.greedy) sc = sc - logf(-logf(uniform_from_bits(philox_bits(i, b, tg, 0u, k0, k1))));
          if (sc > best) {
            best = sc;
            idx = i;
          }
        }
        warp_argmax(best, idx);
        if (a.head == HEAD_MOL) {
          x = o[a.out_seg + idx];
          if (!a.greedy) {
            const float log_sc = fminf(fmaxf(o[2 * a.out_seg + idx], -7.0f), 7.0f);
            const float u2 = uniform_from_bits(philox_bits(0u, b, tg, 1u, k0, k1));
            x = x + expf(log_sc) * (logf(u2) - logf(1.0f - u2));
          }
        } else {
          qv = (float)idx - half;
        }
      }
      if (a.head != HEAD_CE) {
        x = fminf(fmaxf(x, -1.0f), 1.0f - 2.0f / (float)a.quant_chann);
        qv = floorf(x * half);
      }
      float au;
      if (a.use_mu_law) {
        const float y = (qv + 0.5f) * 2.0f / 256.0f;
        au = qv == 0.0f ? 0.0f : sign_of(y) / 255.0f * (powf(256.0f, fabsf(y)) - 1.0f);
      } else {
        au = qv / half;
      }
      if (lane == 0) {
        audio[(size_t)t * B + b] = au;
        const float fb = tf != nullptr ? tf[(size_t)t * B + b] : au;
        const float xn =
            a.use_mu_law ? floorf(sign_of(fb) * log1pf(255.0f * fabsf(fb)) / kLog256 * 128.0f) / half
                         : fb;
        xh[b] = xh[B + b];
        xh[B + b] = xh[2 * B + b];
        xh[2 * B + b] = xn;
      }
    }
  }

  if (do_start) {
    __syncthreads();
    const float* ws = static_cast<const float*>(a.w_start);
    const float* bs = static_cast<const float*>(a.b_start);
    float* l = static_cast<float*>(a.l);
    bf16* l_bf = static_cast<bf16*>(a.l_bf);
    signed char* q_l = static_cast<signed char*>(a.q_l);
    const float inv0 = a.w8a8 ? static_cast<const float*>(a.s_act_inv)[0] : 0.0f;
    for (int e = threadIdx.x; e < HD_ROWS * W; e += blockDim.x) {
      const int r = e / W, c = e % W, b = row0 + r;
      float v = 0.0f;
      if (b < B) {
        v = xh[b] * ws[c] + xh[B + b] * ws[W + c] + xh[2 * B + b] * ws[2 * W + c] + bs[c];
        l[(size_t)b * W + c] = v;
        if (a.w8a8)
          q_l[(size_t)b * W + c] = quant_static(v, inv0);  // layer 0's operand and ring row
        else
          l_bf[(size_t)b * W + c] = __float2bfloat16(v);
      }
      As[r * hl.lda + c] = __float2bfloat16(v);
    }
    __syncthreads();
    rowtile_gemm(As, hl.lda, static_cast<const bf16*>(a.w_skip0), W, S, Cs, hl.ldc);
    __syncthreads();
    const float* b_skip0 = static_cast<const float*>(a.b_skip0);
    float* s = static_cast<float*>(a.s);
    for (int e = threadIdx.x; e < HD_ROWS * S; e += blockDim.x) {
      const int r = e / S, c = e % S, b = row0 + r;
      if (b < B) s[(size_t)b * S + c] = Cs[r * hl.ldc + c] + b_skip0[c];
    }
  }
}

__global__ void philox_uniform_kernel(float* out, int rows, int lanes, int t, int draw,
                                      uint32_t k0, uint32_t k1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)rows * lanes) {
    const int r = (int)(i / lanes), c = (int)(i % lanes);
    out[i] = uniform_from_bits(philox_bits(c, r, t, draw, k0, k1));
  }
}

}  // namespace

extern "C" int fastgen_generate(const FastgenArgs* args) {
  const FastgenArgs& a = *args;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int m = a.GW / 2, K = 3 * a.W + a.DW, N = a.W + a.S;
  const HeadLayout hl = head_layout(a);
  if (hl.bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hl.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_rs(N / RS_BN, (a.B + RS_BM - 1) / RS_BM);
  const dim3 grid_head((a.B + HD_ROWS - 1) / HD_ROWS);
  const float* b_comb = static_cast<const float*>(a.b_comb);
  const float* b_rs = static_cast<const float*>(a.b_rs);
  const size_t row_elems = (size_t)a.B * a.W;

  if (a.w8a8) {
    const dim3 grid_gate(m / GI_BN, (a.B + GI_BM - 1) / GI_BM, gi_slices(3 * a.W) + gi_slices(a.DW));
    signed char* lbuf = static_cast<signed char*>(a.lbuf);
    const signed char* q_enc = static_cast<const signed char*>(a.q_enc);
    const float* r_enc = static_cast<const float*>(a.r_enc);
    const uint32_t* w_comb = static_cast<const uint32_t*>(a.w_comb);
    const uint32_t* w_rs = static_cast<const uint32_t*>(a.w_rs);
    const float* s_comb = static_cast<const float*>(a.s_comb);
    const float* s_main = static_cast<const float*>(a.s_main);
    const float* s_rs = static_cast<const float*>(a.s_rs);
    const float* s_act_inv = static_cast<const float*>(a.s_act_inv);
    const long long rows = (long long)a.L * a.B;
    quant_enc_kernel<<<(unsigned)((rows + QE_THREADS / 32 - 1) / (QE_THREADS / 32)), QE_THREADS, 0, st>>>(
        static_cast<const bf16*>(a.enc), static_cast<signed char*>(a.q_enc),
        static_cast<float*>(a.r_enc), rows, a.DW);
    head_kernel<<<grid_head, HD_THREADS, hl.bytes, st>>>(a, 0, 0, 1);
    for (int t = 0; t < a.L; ++t) {
      const long long tg = (long long)a.t0 + t;
      size_t base = 0;
      for (int li = 0; li < a.NL; ++li) {
        const int d = 1 << (li % a.num_stages);
        const size_t row2 = base + tg % (2 * d);        // state at t - 2d, overwritten this step
        const size_t row1 = base + (tg + d) % (2 * d);  // state at t - d
        gate_kernel_i8<<<grid_gate, GI_THREADS, 0, st>>>(
            lbuf + row2 * row_elems, lbuf + row1 * row_elems, static_cast<const signed char*>(a.q_l),
            q_enc + (size_t)t * a.B * a.DW, r_enc + (size_t)t * a.B, w_comb + (size_t)li * (K / 4) * a.GW,
            s_main + (size_t)li * a.GW, s_comb + (size_t)li * a.GW, b_comb + (size_t)li * a.GW,
            static_cast<signed char*>(a.gate), static_cast<int*>(a.part),
            static_cast<unsigned*>(a.counters), a.B, a.W, a.DW, a.GW);
        resskip_kernel_i8<<<grid_rs, RI_THREADS, 0, st>>>(
            static_cast<const signed char*>(a.gate), w_rs + (size_t)li * (m / 4) * N,
            s_rs + (size_t)li * N, b_rs + (size_t)li * N, static_cast<float*>(a.l),
            static_cast<signed char*>(a.q_l), static_cast<float*>(a.s), lbuf + row2 * row_elems,
            li + 1 < a.NL ? s_act_inv + li + 1 : nullptr, a.B, a.W, a.S, m);
        base += 2 * d;
      }
      head_kernel<<<grid_head, HD_THREADS, hl.bytes, st>>>(a, t, 1, t + 1 < a.L);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
  }

  const dim3 grid_gate(m / GA_BN, (a.B + GA_BM - 1) / GA_BM, (K + GA_KSPAN - 1) / GA_KSPAN);
  const bf16* lbuf = static_cast<const bf16*>(a.lbuf);
  const bf16* enc = static_cast<const bf16*>(a.enc);
  const bf16* w_comb = static_cast<const bf16*>(a.w_comb);
  const bf16* w_rs = static_cast<const bf16*>(a.w_rs);

  head_kernel<<<grid_head, HD_THREADS, hl.bytes, st>>>(a, 0, 0, 1);
  for (int t = 0; t < a.L; ++t) {
    const long long tg = (long long)a.t0 + t;
    size_t base = 0;
    for (int li = 0; li < a.NL; ++li) {
      const int d = 1 << (li % a.num_stages);
      const size_t row2 = base + tg % (2 * d);        // state at t - 2d, overwritten this step
      const size_t row1 = base + (tg + d) % (2 * d);  // state at t - d
      gate_kernel<<<grid_gate, GA_THREADS, 0, st>>>(
          lbuf + row2 * row_elems, lbuf + row1 * row_elems, static_cast<const bf16*>(a.l_bf),
          enc + (size_t)t * a.B * a.DW, w_comb + (size_t)li * K * a.GW, b_comb + (size_t)li * a.GW,
          static_cast<bf16*>(a.gate), static_cast<float*>(a.part),
          static_cast<unsigned*>(a.counters), a.B, a.W, a.DW, a.GW);
      resskip_kernel<<<grid_rs, RS_THREADS, 0, st>>>(
          static_cast<const bf16*>(a.gate), w_rs + (size_t)li * m * N, b_rs + (size_t)li * N,
          static_cast<float*>(a.l), static_cast<bf16*>(a.l_bf), static_cast<float*>(a.s),
          const_cast<bf16*>(lbuf) + row2 * row_elems, a.B, a.W, a.S, m);
      base += 2 * d;
    }
    head_kernel<<<grid_head, HD_THREADS, hl.bytes, st>>>(a, t, 1, t + 1 < a.L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int philox_uniform(float* out, int rows, int lanes, int t, int draw, long long seed,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)rows * lanes;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  philox_uniform_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, rows, lanes, t, draw, (uint32_t)((unsigned long long)seed & 0xffffffffull),
      (uint32_t)((unsigned long long)seed >> 32));
  return (int)cudaGetLastError();
}

extern "C" void fastgen_workspace(int B, int W, int GW, int DW, int w8a8, long long* part_words,
                                  long long* counters) {
  // 32-bit words of the split-K partial tiles (f32, or int32 in W8A8 mode) and
  // the count of per-tile arrival counters
  if (w8a8) {
    const long long tiles = (long long)(GW / 2 / GI_BN) * ((B + GI_BM - 1) / GI_BM);
    *part_words = tiles * (gi_slices(3 * W) + gi_slices(DW)) * GI_TILE;
    *counters = tiles;
    return;
  }
  const long long tiles = (long long)(GW / 2 / GA_BN) * ((B + GA_BM - 1) / GA_BM);
  const long long nsplit = (3LL * W + DW + GA_KSPAN - 1) / GA_KSPAN;
  *part_words = nsplit > 1 ? tiles * nsplit * GA_TILE : 0;
  *counters = tiles;
}

extern "C" const char* fastgen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
