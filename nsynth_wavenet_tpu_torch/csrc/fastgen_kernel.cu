// Autoregressive WaveNet generation on Hopper (sm_90a) in every mode of the
// reference kernel: bf16 or int8 (W8A8) layer matrices, calibrated or per-row
// activation scales, bf16 or int8 res/skip product with a fixed or per-row
// gate scale; each one-shot or streamed in chunks with carried state.
//
// Replaces the Pallas TPU kernel nsynth_wavenet_tpu/ops/fastgen_kernel.py
// make_generate_fn (pallas_call at :815, kernel body :365-738): its bf16
// branch (:561-571, :605-615), its W8A8 act_scale="static" branches
// (:448-452, :474-475, :487-516, :625-626, :638-639), its W8A8
// act_scale="row" branches (_quant_log8 :229-241, :477, :517-560, :627-629,
// :641, with int8_combine :446), its gate_scale="static" (:582-592) and
// gate_scale="row" (:593-604) res/skip branches, rs_dtype=bf16 under int8
// weights (:605-615) and its streaming state (:416-427, :737-738, :840-879);
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
// A mode is a pair (ActMode, RsMode), fastgen_kernel.cuh.
// ACT_BF16: matrices are bf16, every product accumulates in f32, and l, s and
// the gate nonlinearity stay f32; the matmul operands l, gate, relu(s) and o1
// are rounded to bf16 exactly where ops/fastgen_kernel.py generate_plain
// rounds them.
// ACT_STATIC: w_comb is int8 with per-column f32 scales; l is quantised per
// layer with the calibrated multiplier s_act_inv[i] = 127/amax_i
// (clip(rint(l * s_act_inv[i]), +-127)), so the ring rows of layer i are int8
// at layer i's scale; enc(t) is quantised per row (scale r_enc); the products
// are int8 x int8 -> int32, exact, and
//     dpre = float(mm) * s_main[i] + float(acc_enc) * r_enc * s_comb[i] + b_comb[i]
// with the 3W part (mm) and the enc part (acc_enc) kept as separate sums.
// ACT_ROW: no calibration.  l is quantised per batch row with the scale
// r = 2^(e/8): e is the least code in [-120, 126] for which 2^(e/8) reaches
// max|l| / 127, and q = clip(rint(l * 2^(-e/8)), +-127) (log8_pow, log8_code).
// A ring row holds q and, in lane W, e.  enc, l and the two taps are four
// exact int32 sums, each with its own row scale, combined in the reference's
// order
//     acc = enc * r_enc;  acc += l * r_l;  acc += tap(t-2d) * r_t2;  acc += tap(t-d) * r_t1
//     dpre = acc * s_comb[i] + b_comb[i]
// in f32 or (combine_bf16) in bf16 with every operand, product and sum rounded.
// RS_BF16: the gate is rounded to bf16 and rs accumulates in f32.
// RS_STATIC: the gate leaves as int8 rint(gate * 127) and rs = float(acc) *
// s_rs[i] + b_rs[i] (s_rs holds the 1/127).
// RS_ROW: the gate leaves as f32 beside its row maximum; the res/skip launch
// quantises it while loading (mult = 127 / amax, clip(rint(gate * mult),
// +-127)) and rs = float(acc) * (amax / 127 * s_rs[i]) + b_rs[i].
// Rounding is to nearest even (rintf) everywhere, and the dequantising
// multiplies and adds are kept unfused (__fmul_rn, __fadd_rn) so that they
// round where the plain version rounds.
//
// Design (simple and right first):
//   gate kernels    one launch per layer: a 64-row x (16 sigmoid + 16 tanh)
//                   column tile, so the gate is formed in the epilogue; the
//                   stacked operand is gathered on the fly from the two ring
//                   rows, l and enc(t).  K = 3W+DW is split over 256-wide
//                   slices, one block each, so that a block walks 4 chunks
//                   instead of 28; the last block of a tile to finish sums
//                   the slices' partial tiles in slice order (deterministic),
//                   adds the bias and forms the gate.  gate_kernel is the bf16
//                   product (WMMA 16x16x16), gate_kernel_i8 the int8 one
//                   (mma.sync.m16n8k32.s8, int32 sums).  The int8 matrices are
//                   stored with four consecutive k of a column in one 32-bit
//                   word ([K/4, N, 4]), the B-fragment layout of that
//                   instruction.  K slices never straddle two sums that
//                   dequantise differently (ACT_STATIC: the 3W part and the
//                   enc part; ACT_ROW: each of the four segments is sliced on
//                   its own), and the partial tiles are int32, so their sums
//                   are exact in any order.
//   res/skip kernels one launch per layer: 64x64 tiles of gate @ w_rs
//                   (resskip_kernel bf16, resskip_kernel_i8 int8); one
//                   epilogue (rs_epilogue) for both writes the PRE-residual l
//                   to ring slot t mod 2d (the slot the gate launch just read
//                   as the t-2d tap, so the read finishes before the write by
//                   stream order), updates l and s, and leaves the next
//                   layer's operand in the ring's type.
//   row maxima      no block sees a whole row of the gate (16 column tiles)
//                   or of l (8 column tiles), so a per-row quantiser cannot
//                   sit in the producer's epilogue.  The producer writes f32
//                   values, and each of its blocks stores the maximum of its
//                   tile's share of a row in a slot of its own ([tiles, B] f32
//                   per layer; max is exact in any order, nothing is atomic and
//                   nothing needs a reset).  The consumer takes the maximum
//                   over a row's slots once per block, before its product, and
//                   quantises its A operand while loading it (each res/skip
//                   block reads all m of its 64 gate rows, each gate block its
//                   K slice of l); the res/skip epilogue quantises the same l
//                   once more for the ring row.  Every reader derives the same
//                   code from the same maximum, so the ring holds exactly what
//                   the gate product read.
//   head_kernel     one launch per step, 16 batch rows per block: out head,
//                   sampler (Philox4x32-10 keyed by seed, t0 + t, row, lane),
//                   decode, feedback, then conv_start and skip_start of the
//                   next step and layer 0's operand (bf16 l, static int8 l, or
//                   the row maximum of l).
//   quant_enc_kernel  int8 pre-pass, once per call: enc [L, B, DW] bf16 ->
//                   int8 rows and their f32 scales (a warp per row).
// The time and layer loops live in fastgen_generate: one host call per
// utterance or chunk enqueues 2*NL+1 launches per step on PyTorch's current
// stream, in every mode.  Streaming: the ring and the three input taps come in
// and go out as state, and every ring phase and random counter runs on
// t0 + t, so chained calls repeat the one-shot call's arithmetic bit for bit.
//
// Bound per step (MoL teacher, W=512, GW=512, S=256, DW=256, NL=30):
//   operations 2 * B * 33.4 M (w_comb 30*1792*512 + w_rs 30*256*768 + head);
//   bf16: ~67 MB of weights, which exceed the 50 MB L2 and so stream from HBM
//   every step, plus ~92 KB * B of ring reads and writes; at 3.35 TB/s and
//   989 TFLOP/s the weight stream (~20 us) bounds B < ~300, the tensor-core
//   rate bounds larger B.
//   int8: 33.4 MB of int8 layer weights (they fit L2) + 0.5 MB of bf16 head,
//   ~46 KB * B of int8 ring traffic (one more byte per ring row in ACT_ROW);
//   at 1979 TOP/s int8 the layer products take half the bf16 time, so the
//   weight stream (~10 us) bounds B < ~600.
// Measured on an H100 (chip_smoke.py, see PERF.md): every mode runs far above
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
constexpr float kInv127 = (float)(1.0 / 127.0);

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// ---------------------------------------------------------------------------
// quantisers shared by the kernels
// ---------------------------------------------------------------------------
// clip(rint(x * inv), +-127): round half to even, clipped symmetrically
__device__ __forceinline__ signed char quant_i8(float x, float inv) {
  return (signed char)(int)fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t quant_i8x4(float4 v, float inv) {
  return (uint32_t)(uint8_t)quant_i8(v.x, inv) | (uint32_t)(uint8_t)quant_i8(v.y, inv) << 8 |
         (uint32_t)(uint8_t)quant_i8(v.z, inv) << 16 | (uint32_t)(uint8_t)quant_i8(v.w, inv) << 24;
}

// round to bf16, held as f32
__device__ __forceinline__ float bf_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

// 2^(e/8) for a log8 code e (|e| <= 127): the f32 value of 2^((e mod 8)/8)
// from the eight entries the wrapper passes, times a whole power of two, which
// is exact.  ops/fastgen_kernel.py log8_tables builds its tables by the same
// rule, so the plain version holds the same bits, and no launch reads a table
// from device memory.
__device__ __forceinline__ float log8_pow(const Log8& t, int e) {
  return __fmul_rn(__int_as_float((127 + (e >> 3)) << 23), t.frac[e & 7]);
}

// The log8 exponent code of a row whose abs-max is amax:
// the least e in [LOG8_MIN, LOG8_MAX] with 2^(e/8) >= max(amax, 1e-8) / 127.
// log2f gives a first guess, at most one code off (its error times 8 is far
// below one code), and the comparison with 2^(e/8) itself decides between the
// guess and its neighbours without a branch, so the code is the plain
// version's whatever log2f returns in its last bit.
__device__ __forceinline__ int log8_code(float amax, const Log8& t) {
  const float x = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  const int e = min(max((int)ceilf(8.0f * log2f(x)), LOG8_MIN), LOG8_MAX);
  const float below = log8_pow(t, max(e - 1, LOG8_MIN)), at = log8_pow(t, e);
  return e - (e > LOG8_MIN && below >= x) + (e < LOG8_MAX && at < x);
}

// Row maxima across tiles.  No block sees a whole row of the gate or of l, so
// every producer block stores the maximum of its tile's share of a row in a
// slot of its own, [tiles, B] f32 per layer, and a consumer takes the maximum
// over a row's slots (max is exact in any order).  Every slot is written anew
// in every step before it is read, so nothing is reset and nothing is atomic.
// In the epilogues below a tile row is owned by LANES neighbouring lanes, a
// share of its columns each: lanes_max gives all of them the row's maximum.
template <int LANES>
__device__ __forceinline__ float lanes_max(float mx) {
#pragma unroll
  for (int off = LANES / 2; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  return mx;
}

__device__ __forceinline__ float row_max(const float* __restrict__ slots, int tiles, int B, int b) {
  float mx = 0.0f;
  for (int t = 0; t < tiles; ++t) mx = fmaxf(mx, __ldg(slots + (size_t)t * B + b));
  return mx;
}

// ---------------------------------------------------------------------------
// gate epilogue: the gate in the res/skip product's operand type
// ---------------------------------------------------------------------------
// RS_BF16: bf16.  RS_STATIC: int8 rint(gate * 127); |gate| < 1, so no clip.
// RS_ROW: f32, and the tile's row maxima stored in the tile's slots gmax[b].
// A thread owns GATE_OUT consecutive columns of one row, a lane pair the row;
// every thread of the block calls it.
constexpr int GATE_OUT = 8;

template <int RS>
__device__ __forceinline__ void store_gate(void* __restrict__ gate, float* __restrict__ gmax,
                                           bool valid, int b, int m, int col,
                                           const float (&gv)[GATE_OUT]) {
  if (RS == RS_ROW) {
    float mx = 0.0f;
#pragma unroll
    for (int i = 0; i < GATE_OUT; ++i) mx = fmaxf(mx, fabsf(gv[i]));
    mx = lanes_max<2>(mx);
    if (valid && threadIdx.x % 2 == 0) gmax[b] = mx;
  }
  if (!valid) return;
  const size_t idx = (size_t)b * m + col;
#pragma unroll
  for (int i = 0; i < GATE_OUT; ++i) {
    if (RS == RS_BF16) static_cast<bf16*>(gate)[idx + i] = __float2bfloat16(gv[i]);
    if (RS == RS_STATIC)
      static_cast<signed char*>(gate)[idx + i] = (signed char)__float2int_rn(__fmul_rn(gv[i], 127.0f));
    if (RS == RS_ROW) static_cast<float*>(gate)[idx + i] = gv[i];
  }
}

// ---------------------------------------------------------------------------
// gate_kernel: gate[B, m] of one layer, bf16 product
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
static_assert(GA_THREADS == 2 * GA_BM && GA_OUT == GATE_OUT && GA_BN == 2 * GATE_OUT,
              "the epilogue gives a tile row to a lane pair");

struct GateArgs {
  const bf16 *tap2, *tap1, *l_bf, *enc, *w;  // ring rows t-2d and t-d, bf16(l), enc(t), w_comb[i]
  const float* bias;
  void* gate;       // [B, m] in the RsMode's type
  float* gmax;      // RS_ROW: [tiles, B] slots of the layer's gate maxima
  float* part;
  unsigned* counters;
  int B, W, DW, GW;
};

template <int RS>
__global__ void __launch_bounds__(GA_THREADS) gate_kernel(const GateArgs g) {
  __shared__ __align__(32) bf16 As[GA_BM * GA_LDA];
  __shared__ __align__(32) bf16 Bs[GA_KC * GA_LDB];
  __shared__ __align__(32) float Cs[GA_BM * GA_LDC];
  __shared__ float bias_s[2 * GA_BN];
  __shared__ unsigned is_last;
  const int B = g.B, W = g.W, DW = g.DW, GW = g.GW;
  const int m = GW / 2;
  const int j0 = blockIdx.x * GA_BN;
  const int row0 = blockIdx.y * GA_BM;
  const int warp = threadIdx.x / 32;
  const int K = 3 * W + DW;
  const int nsplit = gridDim.z;
  const int k_end = min(K, ((int)blockIdx.z + 1) * GA_KSPAN);
  if (threadIdx.x < 2 * GA_BN)
    bias_s[threadIdx.x] = g.bias[threadIdx.x < GA_BN ? j0 + threadIdx.x : m + j0 + threadIdx.x - GA_BN];

  // stacked operand [tap(t-2d) | tap(t-d) | bf16(l) | enc(t)] and the weight
  // columns j0..j0+15 (sigmoid half) and m+j0..m+j0+15 (tanh half)
  uint4 ra[GA_AV], rb[GA_BV];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < GA_AV; ++i) {
      const int v = threadIdx.x + i * GA_THREADS;
      const int b = row0 + v / (GA_KC / 8), k = k0 + (v % (GA_KC / 8)) * 8;
      const bf16* src = k < W       ? g.tap2 + (size_t)b * W + k
                        : k < 2 * W ? g.tap1 + (size_t)b * W + (k - W)
                        : k < 3 * W ? g.l_bf + (size_t)b * W + (k - 2 * W)
                                    : g.enc + (size_t)b * DW + (k - 3 * W);
      ra[i] = b < B ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < GA_BV; ++i) {
      const int v = threadIdx.x + i * GA_THREADS;
      const int r = v / 4, q = v % 4;
      const int col = q < 2 ? j0 + q * 8 : m + j0 + (q - 2) * 8;
      rb[i] = *reinterpret_cast<const uint4*>(g.w + (size_t)(k0 + r) * GW + col);
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
    float* mine = g.part + ((size_t)tile * nsplit + blockIdx.z) * GA_TILE;
#pragma unroll
    for (int i = 0; i < GA_RED; ++i) {
      const int e = threadIdx.x + i * GA_THREADS;
      mine[e] = Cs[(e / (2 * GA_BN)) * GA_LDC + e % (2 * GA_BN)];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(&g.counters[tile], 1u) == (unsigned)nsplit - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* tiles = g.part + (size_t)tile * nsplit * GA_TILE;
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
    if (threadIdx.x == 0) g.counters[tile] = 0u;  // ready for the next layer
    __syncthreads();
  }
  const int r = threadIdx.x / 2, c0 = (threadIdx.x % 2) * GA_OUT, b = row0 + r;
  float gv[GA_OUT];
#pragma unroll
  for (int i = 0; i < GA_OUT; ++i) {
    const int c = c0 + i;
    const float xs = Cs[r * GA_LDC + c] + bias_s[c];
    const float xt = Cs[r * GA_LDC + GA_BN + c] + bias_s[GA_BN + c];
    gv[i] = (1.0f / (1.0f + expf(-xs))) * tanhf(xt);
  }
  store_gate<RS>(g.gate, g.gmax + (size_t)blockIdx.x * B, b < B, b, m, j0 + c0, gv);
}

// ---------------------------------------------------------------------------
// rs_epilogue: ring write, l += rs[:W], s += rs[W:], the next layer's operand
// ---------------------------------------------------------------------------
struct RingOut {
  void* ring_row;               // slot t mod 2d of this layer: bf16 [B, W], or int8 [B, ring_ld]
  bf16* l_bf;                   // ACT_BF16: the next layer's bf16 l
  signed char* q_l;             // ACT_STATIC: this layer's int8 l, replaced by the next layer's
  const float* inv_next_p;      // ACT_STATIC: the next layer's 127/amax; null for the last layer
  const float* lmax_cur;        // ACT_ROW: [l_tiles, B] slots of max|l| entering this layer
  float* lmax_next;             // ACT_ROW: the same for the next layer; null for the last layer
  int l_tiles;                  // ACT_ROW: W / 64, the res column tiles
  Log8 log8;                    // ACT_ROW: 2^(k/8), k = 0..7
  int ring_ld;                  // ACT_ROW: W + ROW_LANES
};

struct ResskipArgs {
  const void* gate;    // [B, m] in the RsMode's type
  const float* gmax;   // RS_ROW: [g_tiles, B] slots of the gate's row maxima
  int g_tiles;         // RS_ROW: m / 16, the gate's column tiles
  const void* w;       // w_rs[i]: bf16 [m, W+S], or int8 [m/4, W+S, 4]
  const float* s_rs;   // int8: [W+S] column scales
  const float* bias;
  float *l, *s;
  RingOut ring;
  int B, W, S, m;
};

// What a 64-row res/skip block needs of each of its rows, worked out once by
// its first 64 threads before the product (so that neither the slots' loads
// nor the arithmetic sit in the epilogue, where every instruction of these
// latency-bound launches shows).
constexpr int RS_ROWS = 64;

struct RsShared {
  int code[RS_ROWS];    // ACT_ROW, res tiles: log8 code of l entering this layer
  float inv[RS_ROWS];   // and its quantising multiplier 2^(-code/8)
  float rg[RS_ROWS];    // RS_ROW: the gate's row scale amax / 127
  float mult[RS_ROWS];  // and its quantising multiplier 127 / amax
};

template <int ACT, int RS>
__device__ __forceinline__ void rs_prepare(RsShared& sh, const ResskipArgs& r, int row0, bool is_l) {
  if (threadIdx.x < RS_ROWS) {
    const int b = row0 + threadIdx.x;
    const bool valid = b < r.B;
    if (ACT == ACT_ROW && is_l) {
      const RingOut& ro = r.ring;
      const int code = valid ? log8_code(row_max(ro.lmax_cur, ro.l_tiles, r.B, b), ro.log8) : 0;
      sh.code[threadIdx.x] = code;
      sh.inv[threadIdx.x] = log8_pow(ro.log8, -code);
    }
    if (RS == RS_ROW) {
      const float amax = valid ? fmaxf(row_max(r.gmax, r.g_tiles, r.B, b), 1e-8f) : 1.0f;
      sh.rg[threadIdx.x] = __fmul_rn(amax, kInv127);
      sh.mult[threadIdx.x] = __fdiv_rn(127.0f, amax);
    }
  }
  if ((ACT == ACT_ROW && is_l) || RS == RS_ROW) __syncthreads();
}

// The epilogue of a 64x64 res/skip tile on 128 threads: a thread owns the
// four columns (tid % 16) * 4 .. + 3 in the RS_GROUPS rows tid / 16 + 8 i, so
// that 16 neighbouring lanes read and write one row's 256 contiguous bytes.
constexpr int RS_GROUPS = 8;

__device__ __forceinline__ int rs_tile_row(int i) { return threadIdx.x / 16 + 8 * i; }

struct RsRows {
  int cc;                  // first of the thread's four columns in the tile
  bool valid[RS_GROUPS];   // batch row b(i) < B
  int b[RS_GROUPS];        // batch rows
  float4 old[RS_GROUPS];   // l (is_l) or s there before this layer
  float inv_next;          // ACT_STATIC: the next layer's 127/amax (0 for the last layer)
  float next_mx[RS_GROUPS];  // ACT_ROW: largest |l| leaving this layer over the thread's columns
};

// The thread's rows with what the epilogue needs of them, read before the
// product so that the latency hides behind the MMAs.
template <int ACT>
__device__ __forceinline__ void rs_rows(RsRows& rr, const RingOut& ro, const float* __restrict__ l,
                                        const float* __restrict__ s, bool is_l, int row0, int n0,
                                        int B, int W, int S) {
  rr.cc = (threadIdx.x % 16) * 4;
  rr.inv_next = ACT == ACT_STATIC && ro.inv_next_p != nullptr ? __ldg(ro.inv_next_p) : 0.0f;
  const int c = n0 + rr.cc;
#pragma unroll
  for (int i = 0; i < RS_GROUPS; ++i) {
    const int b = row0 + rs_tile_row(i);
    rr.b[i] = b;
    rr.valid[i] = b < B;
    rr.old[i] = b >= B ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                : is_l ? *reinterpret_cast<const float4*>(l + (size_t)b * W + c)
                       : *reinterpret_cast<const float4*>(s + (size_t)b * S + (c - W));
    rr.next_mx[i] = 0.0f;
  }
}

// Row i of the thread: v holds the rs values of its four columns with their
// bias.  Writes the ring slot, l or s, and the next layer's operand in the
// ring's type; ACT_ROW keeps the row's next maximum in rr.
template <int ACT>
__device__ __forceinline__ void rs_epilogue(const RingOut& ro, const RsShared& sh, RsRows& rr, int i,
                                            float* __restrict__ l, float* __restrict__ s, bool is_l,
                                            int n0, int W, int S, float4 v) {
  const float4 old = rr.old[i];
  float4 now;
  now.x = __fadd_rn(old.x, v.x);
  now.y = __fadd_rn(old.y, v.y);
  now.z = __fadd_rn(old.z, v.z);
  now.w = __fadd_rn(old.w, v.w);
  if (!rr.valid[i]) return;
  const int b = rr.b[i], c = n0 + rr.cc;
  if (!is_l) {  // block-uniform: W % 64 == 0, a tile lies wholly in the res or in the skip columns
    *reinterpret_cast<float4*>(s + (size_t)b * S + (c - W)) = now;
    return;
  }
  const size_t idx = (size_t)b * W + c;
  *reinterpret_cast<float4*>(l + idx) = now;
  if (ACT == ACT_BF16) {
    bf16* ring = static_cast<bf16*>(ro.ring_row) + idx;
    *reinterpret_cast<__nv_bfloat162*>(ring) = __floats2bfloat162_rn(old.x, old.y);
    *reinterpret_cast<__nv_bfloat162*>(ring + 2) = __floats2bfloat162_rn(old.z, old.w);
    *reinterpret_cast<__nv_bfloat162*>(ro.l_bf + idx) = __floats2bfloat162_rn(now.x, now.y);
    *reinterpret_cast<__nv_bfloat162*>(ro.l_bf + idx + 2) = __floats2bfloat162_rn(now.z, now.w);
  }
  if (ACT == ACT_STATIC) {
    // copy the current int8 l to the ring and write the next layer's in place
    *reinterpret_cast<char4*>(static_cast<signed char*>(ro.ring_row) + idx) =
        *reinterpret_cast<const char4*>(ro.q_l + idx);
    if (ro.inv_next_p != nullptr)
      *reinterpret_cast<uint32_t*>(ro.q_l + idx) = quant_i8x4(now, rr.inv_next);
  }
  if (ACT == ACT_ROW) {
    // the ring row is l as this layer's gate product read it: the same code
    // from the same maximum, and the code itself in lane W
    signed char* ring = static_cast<signed char*>(ro.ring_row) + (size_t)b * ro.ring_ld;
    *reinterpret_cast<uint32_t*>(ring + c) = quant_i8x4(old, sh.inv[rs_tile_row(i)]);
    if (c == 0) ring[W] = (signed char)sh.code[rs_tile_row(i)];
    rr.next_mx[i] = fmaxf(fmaxf(fabsf(now.x), fabsf(now.y)), fmaxf(fabsf(now.z), fabsf(now.w)));
  }
}

// After the last row: ACT_ROW stores the tile's share of the rows' next maxima
// in the tile's slots (every thread calls it; kept out of the loop above, whose
// loads and stores a shuffle would fence)
template <int ACT>
__device__ __forceinline__ void rs_finish(const RingOut& ro, const RsRows& rr, bool is_l, int B) {
  if (ACT == ACT_ROW && is_l && ro.lmax_next != nullptr) {
    float mx[RS_GROUPS];  // the eight shuffle chains side by side, then the stores
#pragma unroll
    for (int i = 0; i < RS_GROUPS; ++i) mx[i] = lanes_max<16>(rr.next_mx[i]);
    if (threadIdx.x % 16 == 0) {
#pragma unroll
      for (int i = 0; i < RS_GROUPS; ++i)
        if (rr.valid[i]) ro.lmax_next[(size_t)blockIdx.x * B + rr.b[i]] = mx[i];
    }
  }
}

// ---------------------------------------------------------------------------
// resskip_kernel: rs = bf16(gate) @ w_rs + b_rs, bf16 product
// ---------------------------------------------------------------------------
constexpr int RS_BM = 64, RS_BN = 64, RS_KC = 64, RS_THREADS = 128;
constexpr int RS_LDA = RS_KC + 8;
constexpr int RS_LDB = RS_BN + 8;
constexpr int RS_LDC = RS_BN + 4;
constexpr int RS_AV = RS_BM * RS_KC / 8 / RS_THREADS;
constexpr int RS_BV = RS_KC * RS_BN / 8 / RS_THREADS;
static_assert(RS_THREADS == 128 && RS_BM == RS_ROWS && RS_BM == 8 * RS_GROUPS && RS_BN == 64,
              "rs_epilogue's tile");

template <int ACT>
__global__ void __launch_bounds__(RS_THREADS) resskip_kernel(const ResskipArgs r) {
  __shared__ __align__(32) bf16 As[RS_BM * RS_LDA];
  __shared__ __align__(32) bf16 Bs[RS_KC * RS_LDB];
  __shared__ __align__(32) float Cs[RS_BM * RS_LDC];
  const int B = r.B, W = r.W, S = r.S, m = r.m;
  const int N = W + S;
  const int n0 = blockIdx.x * RS_BN;
  const int row0 = blockIdx.y * RS_BM;
  const int warp = threadIdx.x / 32;
  const bool is_l = n0 < W;
  const bf16* gate = static_cast<const bf16*>(r.gate);
  const bf16* w = static_cast<const bf16*>(r.w);
  __shared__ RsShared sh;
  RsRows rr;
  rs_rows<ACT>(rr, r.ring, r.l, r.s, is_l, row0, n0, B, W, S);
  const float4 bi = *reinterpret_cast<const float4*>(r.bias + n0 + rr.cc);

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
  rs_prepare<ACT, RS_BF16>(sh, r, row0, is_l);  // while the first chunk is on its way
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
  for (int i = 0; i < RS_GROUPS; ++i) {
    const float4 sums =
        *reinterpret_cast<const float4*>(Cs + (threadIdx.x / 16 + 8 * i) * RS_LDC + rr.cc);
    const float4 v = make_float4(__fadd_rn(sums.x, bi.x), __fadd_rn(sums.y, bi.y),
                                 __fadd_rn(sums.z, bi.z), __fadd_rn(sums.w, bi.w));
    rs_epilogue<ACT>(r.ring, sh, rr, i, r.l, r.s, is_l, n0, W, S, v);
  }
  rs_finish<ACT>(r.ring, rr, is_l, B);
}

// ---------------------------------------------------------------------------
// int8 kernels: int8 x int8 -> int32 on mma.sync.m16n8k32
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
  const float mult = bf_round(__fdiv_rn(127.0f, amax));
  for (int i = lane; i < DW; i += 32) {
    const float prod = bf_round(__fmul_rn(__bfloat162float(x[i]), mult));
    q_enc[row * DW + i] = (signed char)(int)fminf(fmaxf(rintf(prod), -127.0f), 127.0f);
  }
  if (lane == 0) r_enc[row] = __fmul_rn(amax, kInv127);
}

// ---- gate_kernel_i8: gate[B, m] of one layer, int8 product ----
constexpr int GI_BM = 64, GI_BN = 16, GI_KC = 64, GI_KSPAN = 256, GI_THREADS = 128;
constexpr int GI_TILE = GI_BM * 2 * GI_BN;  // int32 of one partial tile
constexpr int GI_LDA = GI_KC + 16;          // bytes: 20 words, so the 8 rows of a fragment hit 8 bank groups
constexpr int GI_LDB = 2 * GI_BN + 8;       // words (4 k each): 40, so 4 k-words x 8 columns hit 32 banks
constexpr int GI_AV = GI_BM * GI_KC / 16 / GI_THREADS;              // 16-byte A vectors per thread per chunk
constexpr int GI_BV = (GI_KC / 4) * 2 * GI_BN * 4 / 16 / GI_THREADS;  // 16-byte B vectors per thread per chunk
constexpr int GI_OUT = GI_BM * GI_BN / GI_THREADS;                  // gate values per thread
static_assert(GI_BV == 1, "one weight vector per thread per chunk");
static_assert(GI_THREADS == 2 * GI_BM && GI_OUT == GATE_OUT && GI_BN == 2 * GATE_OUT && GI_BN == GA_BN,
              "the epilogue gives a tile row to a lane pair");

__host__ __device__ inline int gi_slices(int k) { return (k + GI_KSPAN - 1) / GI_KSPAN; }

// K slices of one gate tile.  A slice never straddles two sums that dequantise
// with different multipliers.  ACT_STATIC: the 3W part, then the enc part.
// ACT_ROW: tap t-2d, tap t-d, l and enc, each cut on its own.
__host__ __device__ inline int gi_nsplit(int act, int W, int DW) {
  return (act == ACT_ROW ? 3 * gi_slices(W) : gi_slices(3 * W)) + gi_slices(DW);
}

struct GateI8Args {
  const signed char *tap2, *tap1;  // ring rows t-2d and t-d, row stride ring_ld
  const signed char* q_l;          // ACT_STATIC: [B, W] int8 l
  const float* l;                  // ACT_ROW: [B, W] f32 l, quantised while it is loaded
  const float* lmax;               // ACT_ROW: [l_tiles, B] slots of max|l| entering this layer
  int l_tiles;                     // ACT_ROW: W / 64
  const signed char* q_enc;        // [B, DW] int8 enc(t)
  const float* r_enc;              // [B] its row scales
  const uint32_t* w;               // w_comb[i], k4 layout
  const float *s_main, *s_comb, *bias;
  Log8 log8;                       // ACT_ROW: 2^(k/8), k = 0..7
  void* gate;                      // [B, m] in the RsMode's type
  float* gmax;                     // RS_ROW: [tiles, B] slots of the layer's gate maxima
  int* part;
  unsigned* counters;
  int B, W, DW, GW, ring_ld, combine_bf16;
};

template <int ACT, int RS>
__global__ void __launch_bounds__(GI_THREADS) gate_kernel_i8(const GateI8Args g) {
  __shared__ __align__(16) signed char As[GI_BM * GI_LDA];
  __shared__ __align__(16) uint32_t Bs[(GI_KC / 4) * GI_LDB];
  __shared__ float inv_row[GI_BM];  // ACT_ROW, l slices: the quantising multipliers of the block's rows
  __shared__ unsigned is_last;
  const int B = g.B, W = g.W, DW = g.DW, GW = g.GW;
  const int m = GW / 2;
  const int j0 = blockIdx.x * GI_BN;
  const int row0 = blockIdx.y * GI_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, q = lane % 4;
  const int nsplit = gridDim.z;
  // this block's K slice: segment seg (ACT_STATIC: 0 the 3W part, 3 enc; ACT_ROW:
  // 0 tap t-2d, 1 tap t-d, 2 l, 3 enc) and the slice's place in it
  const int nz_seg = ACT == ACT_ROW ? gi_slices(W) : gi_slices(3 * W);
  const int nz_main = ACT == ACT_ROW ? 3 * nz_seg : nz_seg;
  const int z = blockIdx.z;
  const int seg = z >= nz_main ? 3 : ACT == ACT_ROW ? z / nz_seg : 0;
  const int seg_begin = seg == 3 ? 3 * W : seg * W;
  const int seg_end = seg == 3 ? 3 * W + DW : ACT == ACT_ROW ? seg_begin + W : 3 * W;
  const int k_begin = seg_begin + (seg == 3 ? z - nz_main : z - seg * nz_seg) * GI_KSPAN;
  const int k_end = min(seg_end, k_begin + GI_KSPAN);
  const bool from_f32 = ACT == ACT_ROW && seg == 2;  // block-uniform

  // stacked operand [tap(t-2d) | tap(t-d) | int8 l | q_enc(t)] and the weight
  // columns j0..j0+15 (sigmoid half) and m+j0..m+j0+15 (tanh half)
  uint4 ra[GI_AV], rb;
  float4 rf[GI_AV][4];   // ACT_ROW, l slices: the f32 l of a vector
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < GI_AV; ++i) {
      const int v = threadIdx.x + i * GI_THREADS;
      const int b = row0 + v / (GI_KC / 16), k = k0 + (v % (GI_KC / 16)) * 16;
      if (from_f32) {
        const float4* src = reinterpret_cast<const float4*>(g.l + (size_t)b * W + (k - 2 * W));
#pragma unroll
        for (int j = 0; j < 4; ++j) rf[i][j] = b < B ? src[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        const signed char* src = k < W       ? g.tap2 + (size_t)b * g.ring_ld + k
                                 : k < 2 * W ? g.tap1 + (size_t)b * g.ring_ld + (k - W)
                                 : k < 3 * W ? g.q_l + (size_t)b * W + (k - 2 * W)
                                             : g.q_enc + (size_t)b * DW + (k - 3 * W);
        ra[i] = b < B ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    const int r = threadIdx.x / 8, c = threadIdx.x % 8;  // k-word row, 4-column group
    const int col = c < 4 ? j0 + c * 4 : m + j0 + (c - 4) * 4;
    rb = *reinterpret_cast<const uint4*>(g.w + (size_t)(k0 / 4 + r) * GW + col);
  };

  int acc[4][4];  // n-tiles 0, 1: sigmoid columns; 2, 3: tanh columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  const uint32_t* Aw = reinterpret_cast<const uint32_t*>(As);
  load_chunk(k_begin);
  float inv_l[GI_AV];
  if (from_f32) {  // block-uniform; worked out once per row while the first chunk is on its way
    if (threadIdx.x < GI_BM) {
      const int b = row0 + threadIdx.x;
      inv_row[threadIdx.x] =
          b < B ? log8_pow(g.log8, -log8_code(row_max(g.lmax, g.l_tiles, B, b), g.log8)) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < GI_AV; ++i) inv_l[i] = inv_row[(threadIdx.x + i * GI_THREADS) / (GI_KC / 16)];
  }
  for (int k0 = k_begin; k0 < k_end; k0 += GI_KC) {
#pragma unroll
    for (int i = 0; i < GI_AV; ++i) {
      const int v = threadIdx.x + i * GI_THREADS;
      if (from_f32)
        ra[i] = make_uint4(quant_i8x4(rf[i][0], inv_l[i]), quant_i8x4(rf[i][1], inv_l[i]),
                           quant_i8x4(rf[i][2], inv_l[i]), quant_i8x4(rf[i][3], inv_l[i]));
      *reinterpret_cast<uint4*>(As + (v / (GI_KC / 16)) * GI_LDA + (v % (GI_KC / 16)) * 16) = ra[i];
    }
    *reinterpret_cast<uint4*>(Bs + (threadIdx.x / 8) * GI_LDB + (threadIdx.x % 8) * 4) = rb;
    __syncthreads();
    if (k0 + GI_KC < k_end) load_chunk(k0 + GI_KC);
#pragma unroll
    for (int kk = 0; kk < GI_KC; kk += 32) {
      uint32_t a[4];
      const uint32_t* ar = Aw + (warp * 16 + gq) * (GI_LDA / 4) + kk / 4 + q;
      a[0] = ar[0];
      a[1] = ar[8 * (GI_LDA / 4)];
      a[2] = ar[4];
      a[3] = ar[8 * (GI_LDA / 4) + 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* br = Bs + (kk / 4 + q) * GI_LDB + j * 8 + gq;
        mma_s8(acc[j], a, br[0], br[4 * GI_LDB]);
      }
    }
    __syncthreads();
  }
  // publish this slice's partial tile [64, 32] int32; the last slice to arrive
  // sums the slices of each segment apart and forms the gate
  const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
  int* mine = g.part + ((size_t)tile * nsplit + z) * GI_TILE;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = warp * 16 + gq, c = j * 8 + q * 2;
    *reinterpret_cast<int2*>(mine + r * 2 * GI_BN + c) = make_int2(acc[j][0], acc[j][1]);
    *reinterpret_cast<int2*>(mine + (r + 8) * 2 * GI_BN + c) = make_int2(acc[j][2], acc[j][3]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&g.counters[tile], 1u) == (unsigned)nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) g.counters[tile] = 0u;  // ready for the next layer
  const int* tiles = g.part + (size_t)tile * nsplit * GI_TILE;
  // a thread owns GI_OUT consecutive sigmoid columns of one row and the tanh columns beside them
  const int row = threadIdx.x / 2, c0 = (threadIdx.x % 2) * GI_OUT, b = row0 + row;
  const bool valid = b < B;
  // sums by segment: ACT_STATIC [3W part | enc], ACT_ROW [tap t-2d | tap t-d | l | enc]
  constexpr int NSUM = ACT == ACT_ROW ? 4 : 2;
  int sum[NSUM][2][GI_OUT];  // [segment][sigmoid | tanh][value]
#pragma unroll
  for (int k = 0; k < NSUM; ++k)
#pragma unroll
    for (int i = 0; i < GI_OUT; ++i) sum[k][0][i] = sum[k][1][i] = 0;
  for (int zz = 0; zz < nsplit; ++zz) {
    const int4* p = reinterpret_cast<const int4*>(tiles + (size_t)zz * GI_TILE + row * 2 * GI_BN + c0);
    const int4 v4[4] = {__ldcg(p), __ldcg(p + 1), __ldcg(p + GI_BN / 4), __ldcg(p + GI_BN / 4 + 1)};
    const int k = zz >= nz_main ? NSUM - 1 : ACT == ACT_ROW ? zz / nz_seg : 0;
#pragma unroll
    for (int kk = 0; kk < NSUM; ++kk)
      if (kk == k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[kk][h][0] += v4[2 * h].x, sum[kk][h][1] += v4[2 * h].y;
          sum[kk][h][2] += v4[2 * h].z, sum[kk][h][3] += v4[2 * h].w;
          sum[kk][h][4] += v4[2 * h + 1].x, sum[kk][h][5] += v4[2 * h + 1].y;
          sum[kk][h][6] += v4[2 * h + 1].z, sum[kk][h][7] += v4[2 * h + 1].w;
        }
      }
  }
  // the row's scales: enc(t)'s, and in ACT_ROW those of l and of the two taps (from their codes)
  float re = 0.0f, rl = 0.0f, rt2 = 0.0f, rt1 = 0.0f;
  if (valid) {
    re = __ldg(g.r_enc + b);
    if (ACT == ACT_ROW) {
      rl = log8_pow(g.log8, log8_code(row_max(g.lmax, g.l_tiles, B, b), g.log8));
      rt2 = log8_pow(g.log8, __ldg(g.tap2 + (size_t)b * g.ring_ld + W));
      rt1 = log8_pow(g.log8, __ldg(g.tap1 + (size_t)b * g.ring_ld + W));
    }
  }
  float gv[GI_OUT];
#pragma unroll
  for (int i = 0; i < GI_OUT; ++i) {
    float x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * m + j0 + c0 + i;
      const float sc = __ldg(g.s_comb + col), bi = __ldg(g.bias + col);
      if constexpr (ACT == ACT_ROW) {
        // the reference's order: enc, l, tap t-2d, tap t-d; the sums are below 2^24, exact in f32
        const float se = (float)sum[3][h][i], sl = (float)sum[2][h][i];
        const float st2 = (float)sum[0][h][i], st1 = (float)sum[1][h][i];
        if (g.combine_bf16) {
          float a = bf_round(__fmul_rn(bf_round(se), bf_round(re)));
          a = bf_round(__fadd_rn(a, bf_round(__fmul_rn(bf_round(sl), bf_round(rl)))));
          a = bf_round(__fadd_rn(a, bf_round(__fmul_rn(bf_round(st2), bf_round(rt2)))));
          a = bf_round(__fadd_rn(a, bf_round(__fmul_rn(bf_round(st1), bf_round(rt1)))));
          x[h] = bf_round(__fadd_rn(bf_round(__fmul_rn(a, bf_round(sc))), bf_round(bi)));
        } else {
          float a = __fmul_rn(se, re);
          a = __fadd_rn(a, __fmul_rn(sl, rl));
          a = __fadd_rn(a, __fmul_rn(st2, rt2));
          a = __fadd_rn(a, __fmul_rn(st1, rt1));
          x[h] = __fadd_rn(__fmul_rn(a, sc), bi);
        }
      } else {
        const float main_part = __fmul_rn((float)sum[0][h][i], __ldg(g.s_main + col));
        const float enc_part = __fmul_rn(__fmul_rn((float)sum[1][h][i], re), sc);
        x[h] = __fadd_rn(__fadd_rn(main_part, enc_part), bi);
      }
    }
    gv[i] = __fmul_rn(1.0f / (1.0f + expf(-x[0])), tanhf(x[1]));
  }
  store_gate<RS>(g.gate, g.gmax + (size_t)blockIdx.x * B, valid, b, m, j0 + c0, gv);
}

// ---- resskip_kernel_i8: rs = q_gate @ w_rs * scale + b_rs, int8 product ----
constexpr int RI_BM = 64, RI_BN = 64, RI_KC = 64, RI_THREADS = 128;
constexpr int RI_LDA = RI_KC + 16;  // bytes
constexpr int RI_LDB = RI_BN + 8;   // words (4 k each)
constexpr int RI_LDC = RI_BN + 4;   // int32
constexpr int RI_AV = RI_BM * RI_KC / 16 / RI_THREADS;
constexpr int RI_BV = (RI_KC / 4) * RI_BN * 4 / 16 / RI_THREADS;
static_assert(RI_THREADS == 128 && RI_BM == RS_ROWS && RI_BM == 8 * RS_GROUPS && RI_BN == 64,
              "rs_epilogue's tile");

// RS_STATIC: the gate arrives as int8.  RS_ROW: it arrives as f32 beside its
// row maxima, and every block quantises all m columns of its 64 rows while
// loading them: amax = max(the row's slots of gmax, 1e-8), q = clip(rint(gate *
// (127 / amax)), +-127), and the row's scale amax / 127 joins s_rs in the
// epilogue (rs_prepare).
template <int ACT, int RS>
__global__ void __launch_bounds__(RI_THREADS) resskip_kernel_i8(const ResskipArgs r) {
  static_assert(RS == RS_STATIC || RS == RS_ROW, "an int8 res/skip product");
  __shared__ __align__(16) signed char As[RI_BM * RI_LDA];
  __shared__ __align__(16) uint32_t Bs[(RI_KC / 4) * RI_LDB];
  __shared__ __align__(16) int Cs[RI_BM * RI_LDC];
  const int B = r.B, W = r.W, S = r.S, m = r.m;
  const int N = W + S;
  const int n0 = blockIdx.x * RI_BN;
  const int row0 = blockIdx.y * RI_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, q = lane % 4;
  const bool is_l = n0 < W;
  const uint32_t* w = static_cast<const uint32_t*>(r.w);
  __shared__ RsShared sh;
  RsRows rr;
  rs_rows<ACT>(rr, r.ring, r.l, r.s, is_l, row0, n0, B, W, S);
  const float4 s_rs = *reinterpret_cast<const float4*>(r.s_rs + n0 + rr.cc);
  const float4 bi = *reinterpret_cast<const float4*>(r.bias + n0 + rr.cc);

  uint4 ra[RI_AV], rb[RI_BV];
  float4 rf[RI_AV][4];  // RS_ROW: the f32 gate of a vector
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < RI_AV; ++i) {
      const int v = threadIdx.x + i * RI_THREADS;
      const int b = row0 + v / (RI_KC / 16);
      const size_t at = (size_t)b * m + k0 + (v % (RI_KC / 16)) * 16;
      if (RS == RS_ROW) {
        const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(r.gate) + at);
#pragma unroll
        for (int j = 0; j < 4; ++j) rf[i][j] = b < B ? src[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        ra[i] = b < B ? *reinterpret_cast<const uint4*>(static_cast<const signed char*>(r.gate) + at)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
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
  rs_prepare<ACT, RS>(sh, r, row0, is_l);  // while the first chunk is on its way
  float mult[RI_AV];  // RS_ROW: the quantising multipliers of the thread's vectors' rows
#pragma unroll
  for (int i = 0; i < RI_AV; ++i)
    mult[i] = RS == RS_ROW ? sh.mult[(threadIdx.x + i * RI_THREADS) / (RI_KC / 16)] : 0.0f;
  for (int k0 = 0; k0 < m; k0 += RI_KC) {
#pragma unroll
    for (int i = 0; i < RI_AV; ++i) {
      const int v = threadIdx.x + i * RI_THREADS;
      if (RS == RS_ROW)
        ra[i] = make_uint4(quant_i8x4(rf[i][0], mult[i]), quant_i8x4(rf[i][1], mult[i]),
                           quant_i8x4(rf[i][2], mult[i]), quant_i8x4(rf[i][3], mult[i]));
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
      const uint32_t* ar = Aw + (warp * 16 + gq) * (RI_LDA / 4) + kk / 4 + q;
      a[0] = ar[0];
      a[1] = ar[8 * (RI_LDA / 4)];
      a[2] = ar[4];
      a[3] = ar[8 * (RI_LDA / 4) + 4];
#pragma unroll
      for (int j = 0; j < RI_BN / 8; ++j) {
        const uint32_t* br = Bs + (kk / 4 + q) * RI_LDB + j * 8 + gq;
        mma_s8(acc[j], a, br[0], br[4 * RI_LDB]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RI_BN / 8; ++j) {
    int* cr = Cs + (warp * 16 + gq) * RI_LDC + j * 8 + q * 2;
    *reinterpret_cast<int2*>(cr) = make_int2(acc[j][0], acc[j][1]);
    *reinterpret_cast<int2*>(cr + 8 * RI_LDC) = make_int2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RS_GROUPS; ++i) {
    const int4 sums =
        *reinterpret_cast<const int4*>(Cs + (threadIdx.x / 16 + 8 * i) * RI_LDC + rr.cc);
    float4 sc = s_rs;
    if (RS == RS_ROW)  // the row's gate scale meets the column scales before it meets the sum
      sc = make_float4(__fmul_rn(sh.rg[rs_tile_row(i)], sc.x), __fmul_rn(sh.rg[rs_tile_row(i)], sc.y),
                       __fmul_rn(sh.rg[rs_tile_row(i)], sc.z), __fmul_rn(sh.rg[rs_tile_row(i)], sc.w));
    const float4 v = make_float4(__fadd_rn(__fmul_rn((float)sums.x, sc.x), bi.x),
                                 __fadd_rn(__fmul_rn((float)sums.y, sc.y), bi.y),
                                 __fadd_rn(__fmul_rn((float)sums.z, sc.z), bi.z),
                                 __fadd_rn(__fmul_rn((float)sums.w, sc.w), bi.w));
    rs_epilogue<ACT>(r.ring, sh, rr, i, r.l, r.s, is_l, n0, W, S, v);
  }
  rs_finish<ACT>(r.ring, rr, is_l, B);
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
    const float inv0 = a.act_mode == ACT_STATIC ? static_cast<const float*>(a.s_act_inv)[0] : 0.0f;
    for (int e = threadIdx.x; e < HD_ROWS * W; e += blockDim.x) {
      const int r = e / W, c = e % W, b = row0 + r;
      float v = 0.0f;
      if (b < B) {
        v = xh[b] * ws[c] + xh[B + b] * ws[W + c] + xh[2 * B + b] * ws[2 * W + c] + bs[c];
        l[(size_t)b * W + c] = v;
        // layer 0's operand: its ring row too
        if (a.act_mode == ACT_STATIC)
          q_l[(size_t)b * W + c] = quant_i8(v, inv0);
        else if (a.act_mode == ACT_BF16)
          l_bf[(size_t)b * W + c] = __float2bfloat16(v);
      }
      As[r * hl.lda + c] = __float2bfloat16(v);
    }
    __syncthreads();
    // ACT_ROW: the row maxima of layer 0's l, in the first of its slots (the
    // others hold zero): a warp per row reads back what the block just wrote
    float* lmax = static_cast<float*>(a.lmax);
    if (lmax != nullptr) {
      for (int r = warp; r < HD_ROWS; r += nwarps) {
        const int b = row0 + r;
        if (b >= B) continue;  // warp-uniform
        float mx = 0.0f;
        for (int c = lane; c < W; c += 32) mx = fmaxf(mx, fabsf(l[(size_t)b * W + c]));
        mx = lanes_max<32>(mx);
        for (int t = lane; t < W / RS_BN; t += 32) lmax[(size_t)t * B + b] = t == 0 ? mx : 0.0f;
      }
    }
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

// every instantiation by its mode codes: [ActMode] or [RsMode]
typedef void (*GateKernel)(GateArgs);
typedef void (*GateI8Kernel)(GateI8Args);
typedef void (*ResskipKernel)(ResskipArgs);
GateKernel const kGate[3] = {gate_kernel<RS_BF16>, gate_kernel<RS_STATIC>, gate_kernel<RS_ROW>};
GateI8Kernel const kGateI8[2][3] = {
    {gate_kernel_i8<ACT_STATIC, RS_BF16>, gate_kernel_i8<ACT_STATIC, RS_STATIC>,
     gate_kernel_i8<ACT_STATIC, RS_ROW>},
    {gate_kernel_i8<ACT_ROW, RS_BF16>, gate_kernel_i8<ACT_ROW, RS_STATIC>,
     gate_kernel_i8<ACT_ROW, RS_ROW>}};
ResskipKernel const kResskip[3] = {resskip_kernel<ACT_BF16>, resskip_kernel<ACT_STATIC>,
                                   resskip_kernel<ACT_ROW>};
ResskipKernel const kResskipI8[3][2] = {
    {resskip_kernel_i8<ACT_BF16, RS_STATIC>, resskip_kernel_i8<ACT_BF16, RS_ROW>},
    {resskip_kernel_i8<ACT_STATIC, RS_STATIC>, resskip_kernel_i8<ACT_STATIC, RS_ROW>},
    {resskip_kernel_i8<ACT_ROW, RS_STATIC>, resskip_kernel_i8<ACT_ROW, RS_ROW>}};

}  // namespace

extern "C" int fastgen_generate(const FastgenArgs* args) {
  const FastgenArgs& a = *args;
  if (a.act_mode < ACT_BF16 || a.act_mode > ACT_ROW || a.rs_mode < RS_BF16 || a.rs_mode > RS_ROW)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const int act = a.act_mode, rs = a.rs_mode;
  const int m = a.GW / 2, K = 3 * a.W + a.DW, N = a.W + a.S;
  const HeadLayout hl = head_layout(a);
  if (hl.bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hl.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_rs(N / RS_BN, (a.B + RS_BM - 1) / RS_BM);
  const dim3 grid_head((a.B + HD_ROWS - 1) / HD_ROWS);
  const dim3 grid_gate = act == ACT_BF16
      ? dim3(m / GA_BN, (a.B + GA_BM - 1) / GA_BM, (K + GA_KSPAN - 1) / GA_KSPAN)
      : dim3(m / GI_BN, (a.B + GI_BM - 1) / GI_BM, gi_nsplit(act, a.W, a.DW));
  // bytes of a ring row of one batch row, and of a whole ring slot
  const size_t ring_ld = act == ACT_ROW ? a.W + ROW_LANES : a.W;
  const size_t slot_bytes = (size_t)a.B * ring_ld * (act == ACT_BF16 ? sizeof(bf16) : 1);
  unsigned char* lbuf = static_cast<unsigned char*>(a.lbuf);
  const float* b_comb = static_cast<const float*>(a.b_comb);
  const float* b_rs = static_cast<const float*>(a.b_rs);
  const float* s_comb = static_cast<const float*>(a.s_comb);
  const float* s_main = static_cast<const float*>(a.s_main);
  const float* s_rs = static_cast<const float*>(a.s_rs);
  const float* s_act_inv = static_cast<const float*>(a.s_act_inv);
  // row maxima: per layer [tiles, B] slots, one per producer column tile
  float* lmax = static_cast<float*>(a.lmax);
  float* gmax = static_cast<float*>(a.gmax);
  const int l_tiles = a.W / RS_BN, g_tiles = m / GI_BN;
  const size_t lmax_layer = (size_t)l_tiles * a.B, gmax_layer = (size_t)g_tiles * a.B;

  if (act != ACT_BF16) {
    const long long rows = (long long)a.L * a.B;
    quant_enc_kernel<<<(unsigned)((rows + QE_THREADS / 32 - 1) / (QE_THREADS / 32)), QE_THREADS, 0, st>>>(
        static_cast<const bf16*>(a.enc), static_cast<signed char*>(a.q_enc),
        static_cast<float*>(a.r_enc), rows, a.DW);
  }
  head_kernel<<<grid_head, HD_THREADS, hl.bytes, st>>>(a, 0, 0, 1);
  for (int t = 0; t < a.L; ++t) {
    const long long tg = (long long)a.t0 + t;
    size_t base = 0;
    for (int li = 0; li < a.NL; ++li) {
      const int d = 1 << (li % a.num_stages);
      unsigned char* row2 = lbuf + (base + tg % (2 * d)) * slot_bytes;              // state at t - 2d, overwritten this step
      const unsigned char* row1 = lbuf + (base + (tg + d) % (2 * d)) * slot_bytes;  // state at t - d
      float* gmax_li = rs == RS_ROW ? gmax + li * gmax_layer : nullptr;
      if (act == ACT_BF16) {
        GateArgs g;
        g.tap2 = reinterpret_cast<const bf16*>(row2);
        g.tap1 = reinterpret_cast<const bf16*>(row1);
        g.l_bf = static_cast<const bf16*>(a.l_bf);
        g.enc = static_cast<const bf16*>(a.enc) + (size_t)t * a.B * a.DW;
        g.w = static_cast<const bf16*>(a.w_comb) + (size_t)li * K * a.GW;
        g.bias = b_comb + (size_t)li * a.GW;
        g.gate = a.gate;
        g.gmax = gmax_li;
        g.part = static_cast<float*>(a.part);
        g.counters = static_cast<unsigned*>(a.counters);
        g.B = a.B, g.W = a.W, g.DW = a.DW, g.GW = a.GW;
        kGate[rs]<<<grid_gate, GA_THREADS, 0, st>>>(g);
      } else {
        GateI8Args g;
        g.tap2 = reinterpret_cast<const signed char*>(row2);
        g.tap1 = reinterpret_cast<const signed char*>(row1);
        g.q_l = static_cast<const signed char*>(a.q_l);
        g.l = static_cast<const float*>(a.l);
        g.lmax = act == ACT_ROW ? lmax + li * lmax_layer : nullptr;
        g.l_tiles = l_tiles;
        g.q_enc = static_cast<const signed char*>(a.q_enc) + (size_t)t * a.B * a.DW;
        g.r_enc = static_cast<const float*>(a.r_enc) + (size_t)t * a.B;
        g.w = static_cast<const uint32_t*>(a.w_comb) + (size_t)li * (K / 4) * a.GW;
        g.s_main = act == ACT_STATIC ? s_main + (size_t)li * a.GW : nullptr;
        g.s_comb = s_comb + (size_t)li * a.GW;
        g.bias = b_comb + (size_t)li * a.GW;
        g.log8 = a.log8;
        g.gate = a.gate;
        g.gmax = gmax_li;
        g.part = static_cast<int*>(a.part);
        g.counters = static_cast<unsigned*>(a.counters);
        g.B = a.B, g.W = a.W, g.DW = a.DW, g.GW = a.GW;
        g.ring_ld = (int)ring_ld, g.combine_bf16 = a.combine_bf16;
        kGateI8[act - ACT_STATIC][rs]<<<grid_gate, GI_THREADS, 0, st>>>(g);
      }
      ResskipArgs r;
      r.gate = a.gate;
      r.gmax = gmax_li;
      r.g_tiles = g_tiles;
      r.w = rs == RS_BF16
          ? static_cast<const void*>(static_cast<const bf16*>(a.w_rs) + (size_t)li * m * N)
          : static_cast<const void*>(static_cast<const uint32_t*>(a.w_rs) + (size_t)li * (m / 4) * N);
      r.s_rs = rs == RS_BF16 ? nullptr : s_rs + (size_t)li * N;
      r.bias = b_rs + (size_t)li * N;
      r.l = static_cast<float*>(a.l);
      r.s = static_cast<float*>(a.s);
      r.ring.ring_row = row2;
      r.ring.l_bf = static_cast<bf16*>(a.l_bf);
      r.ring.q_l = static_cast<signed char*>(a.q_l);
      r.ring.inv_next_p = act == ACT_STATIC && li + 1 < a.NL ? s_act_inv + li + 1 : nullptr;
      r.ring.lmax_cur = act == ACT_ROW ? lmax + li * lmax_layer : nullptr;
      r.ring.lmax_next = act == ACT_ROW && li + 1 < a.NL ? lmax + (li + 1) * lmax_layer : nullptr;
      r.ring.l_tiles = l_tiles;
      r.ring.log8 = a.log8;
      r.ring.ring_ld = (int)ring_ld;
      r.B = a.B, r.W = a.W, r.S = a.S, r.m = m;
      if (rs == RS_BF16)
        kResskip[act]<<<grid_rs, RS_THREADS, 0, st>>>(r);
      else
        kResskipI8[act][rs - RS_STATIC]<<<grid_rs, RI_THREADS, 0, st>>>(r);
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

extern "C" void fastgen_workspace(int B, int W, int GW, int DW, int act_mode, long long* part_words,
                                  long long* counters, int* l_tiles, int* g_tiles) {
  // the slots per batch row and layer of the row maxima of l and of the gate
  *l_tiles = W / RS_BN;
  *g_tiles = GW / 2 / GI_BN;
  // 32-bit words of the split-K partial tiles (f32, or int32 with an int8 gate
  // product) and the count of per-tile arrival counters
  if (act_mode != ACT_BF16) {
    const long long tiles = (long long)(GW / 2 / GI_BN) * ((B + GI_BM - 1) / GI_BM);
    *part_words = tiles * gi_nsplit(act_mode, W, DW) * GI_TILE;
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
