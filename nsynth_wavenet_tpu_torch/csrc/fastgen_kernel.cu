// Autoregressive WaveNet generation on Hopper (sm_90a), bf16 weights.
//
// Replaces the Pallas TPU kernel nsynth_wavenet_tpu/ops/fastgen_kernel.py
// make_generate_fn (pallas_call at :815, kernel body :365-738) in its bf16
// weight mode: greedy or in-kernel sampling for the CE, MoL and Gauss heads,
// teacher forcing, and collection of the head's output parameters.
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
// Matrices are bf16, every product accumulates in f32, and l, s and the gate
// nonlinearity stay f32; the matmul operands l, gate, relu(s) and o1 are
// rounded to bf16 exactly where ops/fastgen_kernel.py generate_plain rounds
// them.
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
//                   sampler (Philox4x32-10 keyed by seed, t, row, lane),
//                   decode, feedback, then conv_start and skip_start of the
//                   next step.
// The time and layer loops live in fastgen_generate: one host call per
// utterance enqueues 2*NL+1 launches per step on PyTorch's current stream.
// Products use warp-level WMMA 16x16x16 bf16 tensor-core tiles.
//
// Bound per step (MoL teacher, W=512, GW=512, S=256, DW=256, NL=30):
//   FLOPs 2 * B * 33.4 M (w_comb 30*1792*512 + w_rs 30*256*768 + head);
//   bytes ~67 MB of bf16 weights, which exceed the 50 MB L2 and so stream
//   from HBM every step, plus ~92 KB * B of ring reads and writes.
//   At 3.35 TB/s and 989 TFLOP/s the weight stream (~20 us) bounds B < ~300,
//   the tensor-core rate bounds larger B.
// Measured on an H100 (chip_smoke.py, see PERF.md): about 0.7 ms per step
// at B=64 and 1.0 ms at B=512, far above that bound: the step is 61
// latency-bound launches.  Left on the table: every 64-row batch tile
// re-reads the layer's weights, the head runs on B/16 blocks, the K loop is
// register-double-buffered but has no cp.async/TMA pipeline, and no wgmma.
// A persistent whole-utterance kernel with TMA-fed wgmma, and CUDA graphs
// of the launches, are later work.

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
          const float u1 = uniform_from_bits(philox_bits(0u, b, t, 0u, k0, k1));
          const float u2 = uniform_from_bits(philox_bits(0u, b, t, 1u, k0, k1));
          const float z = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
          x = x + expf(fmaxf(o[1], -7.0f)) * z;
        }
      } else {
        const int n = a.head == HEAD_MOL ? a.out_seg : P;
        float best = -INFINITY;
        int idx = 0x7fffffff;
        for (int i = lane; i < n; i += 32) {
          float sc = o[i];
          if (!a.greedy) sc = sc - logf(-logf(uniform_from_bits(philox_bits(i, b, t, 0u, k0, k1))));
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
            const float u2 = uniform_from_bits(philox_bits(0u, b, t, 1u, k0, k1));
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
    for (int e = threadIdx.x; e < HD_ROWS * W; e += blockDim.x) {
      const int r = e / W, c = e % W, b = row0 + r;
      float v = 0.0f;
      if (b < B) {
        v = xh[b] * ws[c] + xh[B + b] * ws[W + c] + xh[2 * B + b] * ws[2 * W + c] + bs[c];
        l[(size_t)b * W + c] = v;
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
  const dim3 grid_gate(m / GA_BN, (a.B + GA_BM - 1) / GA_BM, (K + GA_KSPAN - 1) / GA_KSPAN);
  const dim3 grid_rs(N / RS_BN, (a.B + RS_BM - 1) / RS_BM);
  const dim3 grid_head((a.B + HD_ROWS - 1) / HD_ROWS);

  const bf16* lbuf = static_cast<const bf16*>(a.lbuf);
  const bf16* enc = static_cast<const bf16*>(a.enc);
  const bf16* w_comb = static_cast<const bf16*>(a.w_comb);
  const float* b_comb = static_cast<const float*>(a.b_comb);
  const bf16* w_rs = static_cast<const bf16*>(a.w_rs);
  const float* b_rs = static_cast<const float*>(a.b_rs);
  const size_t row_elems = (size_t)a.B * a.W;

  head_kernel<<<grid_head, HD_THREADS, hl.bytes, st>>>(a, 0, 0, 1);
  for (int t = 0; t < a.L; ++t) {
    size_t base = 0;
    for (int li = 0; li < a.NL; ++li) {
      const int d = 1 << (li % a.num_stages);
      const size_t row2 = base + t % (2 * d);        // state at t - 2d, overwritten this step
      const size_t row1 = base + (t + d) % (2 * d);  // state at t - d
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

extern "C" void fastgen_workspace(int B, int W, int GW, int DW, long long* part_floats,
                                  long long* counters) {
  const long long tiles = (long long)(GW / 2 / GA_BN) * ((B + GA_BM - 1) / GA_BM);
  const long long nsplit = (3LL * W + DW + GA_KSPAN - 1) / GA_KSPAN;
  *part_floats = nsplit > 1 ? tiles * nsplit * GA_TILE : 0;
  *counters = tiles;
}

extern "C" const char* fastgen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
