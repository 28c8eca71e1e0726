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
// Design: one persistent cooperative launch per call.
//   The time loop and the layer loop run on the card.  fastgen_persistent is
//   launched once per generate call (cudaLaunchCooperativeKernel, grid = the
//   blocks that fit at once: occupancy x SM count), after quant_enc_kernel in
//   the int8 modes.  Each step runs its phases in order, a grid-wide barrier
//   between each two that depend on each other:
//     gate_i, rs_i for every layer i (layer 0's gate phase also forms
//     s = skip_start(l)), out1, out2, then sample + start (the sampler,
//     decode and feedback, and conv_start of the next step with layer 0's
//     operand): 2 * NL + 3 barriers a step.
//   The barrier (grid_barrier) is a count in global memory that only grows:
//   a block adds one (after a fence) and waits until the count reaches
//   (barriers passed) x grid.  It is zeroed once per call by the wrapper, so
//   chained chunk calls start clean.
//   Work table.  ops/fastgen_kernel.py schedule builds it on the host, and
//   every block copies it to shared memory at the start: every phase's
//   product is cut into items, an item being a slice of the layer's weight
//   columns (gate: 32 sigmoid + the 32 matching tanh columns; res/skip: 32;
//   out1, out2, skip_start: 16 columns), a range of
//   128-row tiles and, for the gate product, a K slice that never straddles
//   two sums that dequantise apart (ACT_STATIC: the 3W part and the enc part;
//   ACT_ROW: tap t-2d, tap t-d, l and enc; 512 operand bytes a row).  Item j
//   of a phase belongs to block j mod grid.  Where the blocks are enough, an
//   item walks every batch row, so each weight byte is read by one block,
//   once a step; where blocks would idle (a large batch), its rows are cut
//   into up to 4 groups, and a weight slice is read by as many blocks, while
//   the batch rows, which then outweigh the weights many times, are read by
//   fewer.
//   Weight stages.  A block's slice of a phase's weights (at most 24 KB at
//   full width) sits in one of two shared-memory stages.  Before it arrives
//   at a barrier, the block starts the copy of its slice of the NEXT phase
//   into the other stage (cp.async, 16-byte pieces: a slice is rows of 32 or
//   64 contiguous bytes, too short for a bulk copy each), so the weight stream
//   overlaps the wait.  The batch rows' operand comes through a ring of
//   4 chunks of 128 rows x 128 bytes (cp.async, zero-filled past B) that runs on
//   across the item's row tiles; an f32 operand (ACT_ROW's l, RS_ROW's gate)
//   is quantised from its chunk into an int8 tile in shared memory.  The
//   epilogues' own operands (bias, scales, the old l or s) are loaded when a
//   tile's first chunk arrives, so no epilogue waits on a round trip.
//   Tensor cores: bf16 WMMA 16x16x16 and int8 mma.sync.m16n8k32.s8 on the
//   [K/4, N, 4] k4 weights, the fragment layouts of the per-layer kernels
//   before; a block (8 warps) takes a tile of 128 rows, one 16-row band a warp.  wgmma needs a
//   64-row band per warpgroup and a shared-memory operand layout of its own;
//   with 16 or 32 columns an item it would not raise a rate that the operand
//   stream bounds (every block reads every row), so it is left out.
//   Split K: a gate item stores its partial 128 x 32 tiles ([column item, row
//   tile, slice] f32, or int32 in the int8 modes) without waiting; then the
//   item's slices meet once (a count per column item that only grows), and
//   slice z sums batch rows z, z + nsplit, ... over all slices in slice order,
//   so the result does not depend on timing, adds the bias, dequantises
//   (int8: the segments' sums apart) and forms the gate.
//   Row maxima: the producer items store the maximum of their share of a row
//   in a slot of their own ([items, B] f32 per layer), nothing atomic; after
//   the barrier every block that needs a row's scale takes the maximum over
//   its slots, for all B rows at once, at the start of the phase, into two
//   [B] f32 arrays in shared memory for each per-row scale (l's code and
//   multiplier, the gate's scale and multiplier).  They cap B in those modes
//   (ops/fastgen_kernel.py launch_plan raises past SMEM_LIMIT); the bf16 and
//   static modes take any B.
//   Epilogues: res/skip writes the PRE-residual l to ring slot t mod 2d (the
//   gate phase read it as the t-2d tap before the barrier), l += rs[:W],
//   s += rs[W:], the next layer's operand in the ring's type, and after the
//   last layer bf16(relu(s)) for out1.
// Streaming: the ring and the three input taps come in and go out as state,
// and every ring phase and random counter runs on t0 + t, so chained calls
// repeat the one-shot call's arithmetic bit for bit.
// Perf probes (make_generate_fn probe=, :325-331, :572-577, :619-633,
// :643-646): a third template parameter, PROBE (fastgen_kernel.cuh Probe),
// that is PROBE_NONE in the serving library, where it compiles away.
// PROBE_CHEAP_GATE forms the gate from two clips in gate_bf16 / gate_i8;
// PROBE_NO_RING_WRITE drops the ring-row stores of rs_phase's epilogue (the
// ring reads, their L2 prefetches and the next layer's operand stay).  Both
// keep the 2 * NL + 3 grid barriers a step, so that timing a probe against
// the full kernel isolates the work it drops.
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
// What holds this design back (PERF.md has the measurements): each item
// re-reads its rows' operand from L2 (the gate's 8 column items, res/skip's
// 24), which bounds a large batch; every phase is a chain of dependent L2
// round trips (operand wait, split-K meeting and reduction, barrier), which
// bounds a small one; 2 * NL + 3 barriers a step; one block of 8 warps an SM.

#include "fastgen_kernel.cuh"

// the probe whose variant this library builds (Probe): none in the serving library
#ifndef KERNEL_PROBE
#define KERNEL_PROBE PROBE_NONE
#endif

#include <math.h>
#include <mma.h>

#include <algorithm>

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

// PROBE_CHEAP_GATE's gate: clip(xs, 0, 1) * clip(xt, -1, 1) in place of sigmoid(xs) * tanh(xt)
__device__ __forceinline__ float clip_gate(float xs, float xt) {
  return __fmul_rn(fminf(fmaxf(xs, 0.0f), 1.0f), fminf(fmaxf(xt, -1.0f), 1.0f));
}

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

// In the epilogues below a tile row is owned by LANES neighbouring lanes, a
// share of its columns each: lanes_max gives all of them the row's maximum.
template <int LANES>
__device__ __forceinline__ float lanes_max(float mx) {
#pragma unroll
  for (int off = LANES / 2; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  return mx;
}

// ---------------------------------------------------------------------------
// int8 x int8 -> int32 on mma.sync.m16n8k32
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

// ---------------------------------------------------------------------------
// gate epilogue: the gate in the res/skip product's operand type
// ---------------------------------------------------------------------------
// RS_BF16: bf16.  RS_STATIC: int8 rint(gate * 127); |gate| < 1, so no clip.
// RS_ROW: f32, and the tile's row maxima stored in the item's slots gmax[b].
// A thread owns GATE_OUT consecutive columns of one row, LPR neighbouring
// lanes the row; every thread of the block calls it.
constexpr int GATE_OUT = 8;

template <int RS, int LPR>
__device__ __forceinline__ void store_gate(void* __restrict__ gate, float* __restrict__ gmax,
                                           bool valid, int b, int m, int col,
                                           const float (&gv)[GATE_OUT]) {
  if (RS == RS_ROW) {
    float mx = 0.0f;
#pragma unroll
    for (int i = 0; i < GATE_OUT; ++i) mx = fmaxf(mx, fabsf(gv[i]));
    mx = lanes_max<LPR>(mx);
    if (valid && threadIdx.x % LPR == 0) gmax[b] = mx;
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
// layout (mirrored by ops/fastgen_kernel.py schedule)
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;  // 8 warps, one 16-row band of a 128-row tile each
constexpr int TM = 128;       // rows of a tile
constexpr int KC = 64;        // k of an operand chunk
constexpr int BN = 16;        // columns of an out1, out2 or skip_start item
constexpr int RC = 32;        // columns of a res/skip item
constexpr int RL = RC / 8;    // lanes of a res/skip tile row, 8 columns each
constexpr int AS_LD = KC + 16;   // bytes of a row of the quantised int8 operand tile
constexpr int HDR = 16;          // ints of the work table's header
constexpr int ITEM = 6;          // ints of an item: column item, k_begin, k_end, slice, first and end row tile
static_assert(THREADS == 2 * TM && TM * BN / THREADS == GATE_OUT, "an epilogue row belongs to a lane pair");

// work table header (schedule): item counts per phase, the gate's slices, where the slices' segments are
enum { T_GATE = 0, T_NSPLIT = 1, T_SKIP0 = 2, T_RS = 3, T_OUT1 = 4, T_OUT2 = 5, T_SEGS = 6 };
enum Phase { PH_GATE = 0, PH_RS = 1, PH_OUT1 = 2, PH_OUT2 = 3 };

__device__ __forceinline__ int phase_count(const int* tab, int ph, int li) {
  return ph == PH_GATE ? tab[T_GATE] + (li == 0 ? tab[T_SKIP0] : 0)
       : ph == PH_RS   ? tab[T_RS]
       : ph == PH_OUT1 ? tab[T_OUT1]
                       : tab[T_OUT2];
}

// operand chunk slots (a chunk row is at most 128 bytes: 64 k of bf16 or int8, 32 of f32)
constexpr int NS = 4;

// A gate item is GNG groups of 16 columns: GC sigmoid columns and the tanh
// columns m apart; a row of its tile belongs to GLANES neighbouring lanes,
// GATE_OUT columns each; GTILE words a partial tile.
constexpr int GNG = 4, GC = GNG * BN / 2, GLANES = GC / GATE_OUT, GTILE = TM * 2 * GC;
// A gate item's column constants ride at the end of its weight stage, f32
// [6][GC]: b_comb, s_comb and (ACT_STATIC) s_main of its sigmoid columns,
// then of its tanh columns, each pair side by side
constexpr int CST_WORDS = 6 * GC;
enum { CST_BIAS = 0, CST_SCALE = 2, CST_MAIN = 4 };

// the ITEM ints of item idx of a phase; the gate phase's skip_start items
// follow its gate items
__device__ __forceinline__ const int* phase_item(const int* tab, int ph, int idx) {
  int base = 0;
  if (ph >= PH_RS) base += tab[T_GATE] + tab[T_SKIP0];
  if (ph >= PH_OUT1) base += tab[T_RS];
  if (ph >= PH_OUT2) base += tab[T_OUT1];
  return tab + HDR + ITEM * (base + idx);
}

struct Smem {
  unsigned char* stage[2];  // weight slices: this phase's and the next one's
  unsigned char* slots;     // NS operand chunks
  int slot_stride;
  signed char* As;          // [TM, AS_LD] int8 operand quantised from an f32 chunk
  float* Cs;                // [TM, GNG * 16 + 4] product tile (f32 or int32)
  int* l_code;              // ACT_ROW: [B] log8 code of l entering the layer
  float* l_inv;             // and its multiplier 2^(-code/8)
  float* g_rg;              // RS_ROW: [B] the gate's row scale amax / 127
  float* g_mult;            // and its multiplier 127 / amax
  const int* tab;           // the work table
};

// ---------------------------------------------------------------------------
// asynchronous copies and the grid barrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ unsigned ld_acquire_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives before any leaves.  count only grows: after
// the n-th barrier of a call it holds n * gridDim.x, so no reset is needed
// between barriers, and the wrapper zeroes it once per call.  A wait longer
// than BARRIER_TIMEOUT clocks (seconds; a barrier takes microseconds) traps,
// so that a fault shows as a launch error and not as a hung card.
constexpr long long BARRIER_TIMEOUT = 20000000000LL;

__device__ __forceinline__ void grid_barrier(unsigned long long* count, unsigned long long& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1ull);
    const long long start = clock64();
    while (ld_acquire(count) < target)
      if (clock64() - start > BARRIER_TIMEOUT) __trap();
    __threadfence();
  }
  __syncthreads();
}

// the grid's share of [p, p + bytes) towards L2 (rows another phase reads soon)
__device__ __forceinline__ void l2_prefetch(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = ((size_t)blockIdx.x * THREADS + threadIdx.x) * 128; off < bytes;
       off += (size_t)gridDim.x * THREADS * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
}

// ---------------------------------------------------------------------------
// weight stages: a block's slice of a phase's weights, rows of NG * 16 columns
// padded by 8 (bf16 elements, or 32-bit words of four int8 k)
// ---------------------------------------------------------------------------
template <int NG>
__host__ __device__ constexpr int w_ld() { return NG * BN + 8; }

// bf16 [K, ld] rows k0..k1 of NG * 16 columns from col_a, or (PAIR, the gate)
// of NG * 8 columns from col_a and as many from col_b
template <int NG, bool PAIR>
__device__ __forceinline__ void stage_bf16(unsigned char* dst, const bf16* w, int ld, int k0, int k1,
                                           int col_a, int col_b) {
  constexpr int VPR = 2 * NG;  // 16-byte pieces a row
  const int n = (k1 - k0) * VPR;
  for (int v = threadIdx.x; v < n; v += THREADS) {
    const int r = v / VPR, p = v % VPR;
    const int col = PAIR && p >= NG ? col_b + (p - NG) * 8 : col_a + p * 8;
    cp16(dst + (size_t)r * w_ld<NG>() * 2 + p * 16, w + (size_t)(k0 + r) * ld + col, true);
  }
}

// int8 k4 [K/4, ld] words, word rows q0..q1, columns as above
template <int NG, bool PAIR>
__device__ __forceinline__ void stage_i8(unsigned char* dst, const uint32_t* w, int ld, int q0, int q1,
                                         int col_a, int col_b) {
  constexpr int VPR = 4 * NG;
  const int n = (q1 - q0) * VPR;
  for (int v = threadIdx.x; v < n; v += THREADS) {
    const int r = v / VPR, p = v % VPR;
    const int col = PAIR && p >= 2 * NG ? col_b + (p - 2 * NG) * 4 : col_a + p * 4;
    cp16(dst + (size_t)r * w_ld<NG>() * 4 + p * 16, w + (size_t)(q0 + r) * ld + col, true);
  }
}

template <int ACT, int RS>
__device__ void stage_item(const FastgenArgs& a, const int* tab, int ph, int li, int idx, unsigned char* dst) {
  const int W = a.W, S = a.S, DW = a.DW, GW = a.GW, m = GW / 2, N = W + S, K = 3 * W + DW;
  const int* it = phase_item(tab, ph, idx);
  const int n0 = it[0] * BN;
  if (ph == PH_GATE && idx < tab[T_GATE]) {
    const int g0 = it[0] * GC;
    // the column constants: b_comb, s_comb, s_main rows of GC floats, sigmoid then tanh
    float* cst = reinterpret_cast<float*>(dst + a.stage_bytes) - CST_WORDS;
    const float* srcs[3] = {static_cast<const float*>(a.b_comb), static_cast<const float*>(a.s_comb),
                            static_cast<const float*>(a.s_main)};
    const int n_src = ACT == ACT_BF16 ? 1 : ACT == ACT_STATIC ? 3 : 2;
    for (int v = threadIdx.x; v < n_src * 2 * GC / 4; v += THREADS) {
      const int row = v / (GC / 4), p = v % (GC / 4);  // row: 2 * source + (tanh)
      cp16(cst + row * GC + p * 4, srcs[row / 2] + (size_t)li * GW + (row % 2) * m + g0 + p * 4, true);
    }
    if (ACT == ACT_BF16)
      stage_bf16<GNG, true>(dst, static_cast<const bf16*>(a.w_comb) + (size_t)li * K * GW, GW, it[1], it[2],
                            g0, m + g0);
    else
      stage_i8<GNG, true>(dst, static_cast<const uint32_t*>(a.w_comb) + (size_t)li * (K / 4) * GW, GW,
                          it[1] / 4, it[2] / 4, g0, m + g0);
  } else if (ph == PH_GATE) {
    stage_bf16<1, false>(dst, static_cast<const bf16*>(a.w_skip0), S, 0, W, n0, 0);
  } else if (ph == PH_RS) {
    const int r0 = it[0] * RC;
    if (RS == RS_BF16)
      stage_bf16<RC / BN, false>(dst, static_cast<const bf16*>(a.w_rs) + (size_t)li * m * N, N, 0, m, r0, 0);
    else
      stage_i8<RC / BN, false>(dst, static_cast<const uint32_t*>(a.w_rs) + (size_t)li * (m / 4) * N, N, 0, m / 4,
                               r0, 0);
  } else if (ph == PH_OUT1) {
    stage_bf16<1, false>(dst, static_cast<const bf16*>(a.w_out1), S, 0, S + DW, n0, 0);
  } else {
    stage_bf16<1, false>(dst, static_cast<const bf16*>(a.w_out2), a.out_pad, 0, S, n0, 0);
  }
  cp_commit();
}

// the block's first item of a phase, into the stage that phase will use
template <int ACT, int RS>
__device__ __forceinline__ void prefetch(const FastgenArgs& a, const Smem& sm, int ph, int li, int buf) {
  if ((int)blockIdx.x < phase_count(sm.tab, ph, li)) stage_item<ACT, RS>(a, sm.tab, ph, li, blockIdx.x, sm.stage[buf]);
}

// ---------------------------------------------------------------------------
// run_item: [rows of tiles rt0..rt1, kspan] @ [kspan, NG * 16]
// ---------------------------------------------------------------------------
enum SrcKind { SRC_BF16 = 0, SRC_I8 = 1, SRC_F32 = 2 };
struct Src {
  const unsigned char* p;  // batch row 0 at the chunk's first column
  int ld;                  // bytes a batch row
};

// The operand comes in chunks of TM rows x KC columns through NS slots; the
// chunk sequence runs over the item's row tiles, so the next tile's first
// chunks are in flight while a tile ends.  The weights are the block's stage
// wst.  start() runs on every thread once the first chunks are on their way
// (the phase's own loads; it ends in a barrier of the block if it writes
// shared memory).  pre(row tile) runs on every thread when a tile's first chunk has
// arrived (to start the epilogue's own loads early).  After the last chunk of
// a tile the sums go to sm.Cs ([TM, NG*16 + 4], f32 or int32) and epi(row
// tile) runs on every thread.  KIND SRC_F32 (int8 product only): each chunk
// row is quantised with mult[b] into sm.As first.
template <bool I8, int NG, int KIND, int NS, class SrcFn, class Start, class Pre, class Epi>
__device__ void run_item(const Smem& sm, int B, int rt0, int rt1, int kspan, const float* mult,
                         const unsigned char* wst, SrcFn src_of, Start start, Pre pre, Epi epi) {
  constexpr int LDW = w_ld<NG>();
  constexpr int CLD = NG * BN + 4;
  constexpr int ESZ = KIND == SRC_F32 ? 4 : KIND == SRC_BF16 ? 2 : 1;
  constexpr int KCK = KIND == SRC_F32 ? KC / 2 : KC;  // k of a chunk: 128 bytes a row at most
  constexpr int VPR = KCK * ESZ / 16;  // 16-byte pieces of a chunk row
  constexpr int SLD = KCK * ESZ + 16;  // bytes of a slot row
  static_assert(I8 || KIND == SRC_BF16, "a bf16 product takes a bf16 operand");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, q = lane % 4;
  const int n_kc = kspan / KCK, total = (rt1 - rt0) * n_kc;

  int issue_rt = rt0, issue_kc = 0;  // the next chunk to issue
  auto issue = [&](int c) {
    if (c < total) {
      const Src s = src_of(issue_kc * KCK);
      unsigned char* dst = sm.slots + (c % NS) * sm.slot_stride;
#pragma unroll
      for (int i = 0; i < TM * VPR / THREADS; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const int r = v / VPR, p = v % VPR, b = issue_rt * TM + r;
        cp16(dst + r * SLD + p * 16, s.p + (size_t)(b < B ? b : 0) * s.ld + p * 16, b < B);
      }
      if (++issue_kc == n_kc) issue_kc = 0, ++issue_rt;
    }
    cp_commit();
  };

  FragC acc[NG];
  int acci[2 * NG][4];
  auto zero = [&]() {
    if constexpr (I8) {
#pragma unroll
      for (int j = 0; j < 2 * NG; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acci[j][i] = 0;
    } else {
#pragma unroll
      for (int g = 0; g < NG; ++g) wmma::fill_fragment(acc[g], 0.0f);
    }
  };
  zero();
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) issue(c);
  start();  // while the first chunks are on their way
  int rt = rt0, kc = 0;
  for (int c = 0; c < total; ++c) {
    cp_wait<NS - 2>();
    __syncthreads();
    issue(c + NS - 1);
    if (kc == 0) pre(rt);
    const unsigned char* slot = sm.slots + (c % NS) * sm.slot_stride;
    if constexpr (I8) {
      const unsigned char* at = slot;
      int ald = SLD;
      if constexpr (KIND == SRC_F32) {
        const int r = threadIdx.x / 2, h = threadIdx.x % 2, b = rt * TM + r;
        const float inv = b < B ? mult[b] : 0.0f;
        const float4* src = reinterpret_cast<const float4*>(slot + r * SLD + h * 64);
        uint32_t* dst = reinterpret_cast<uint32_t*>(sm.As + r * AS_LD + h * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[i] = quant_i8x4(src[i], inv);
        __syncthreads();
        at = reinterpret_cast<const unsigned char*>(sm.As);
        ald = AS_LD;
      }
      const uint32_t* aw = reinterpret_cast<const uint32_t*>(at);
      const uint32_t* bw = reinterpret_cast<const uint32_t*>(wst);
#pragma unroll
      for (int kk = 0; kk < KCK; kk += 32) {
        uint32_t af[4];
        const uint32_t* ar = aw + (warp * 16 + gq) * (ald / 4) + kk / 4 + q;
        af[0] = ar[0];
        af[1] = ar[8 * (ald / 4)];
        af[2] = ar[4];
        af[3] = ar[8 * (ald / 4) + 4];
#pragma unroll
        for (int j = 0; j < 2 * NG; ++j) {
          const uint32_t* br = bw + ((kc * KCK + kk) / 4 + q) * LDW + j * 8 + gq;
          mma_s8(acci[j], af, br[0], br[4 * LDW]);
        }
      }
    } else {
      const bf16* ab = reinterpret_cast<const bf16*>(slot);
      const bf16* wb = reinterpret_cast<const bf16*>(wst);
#pragma unroll
      for (int kk = 0; kk < KCK; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, ab + warp * 16 * (SLD / 2) + kk, SLD / 2);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          FragB fb;
          wmma::load_matrix_sync(fb, wb + (kc * KCK + kk) * LDW + g * BN, LDW);
          wmma::mma_sync(acc[g], fa, fb, acc[g]);
        }
      }
    }
    if (kc == n_kc - 1) {
      if constexpr (I8) {
        int* ci = reinterpret_cast<int*>(sm.Cs);
#pragma unroll
        for (int j = 0; j < 2 * NG; ++j) {
          int* cr = ci + (warp * 16 + gq) * CLD + j * 8 + q * 2;
          *reinterpret_cast<int2*>(cr) = make_int2(acci[j][0], acci[j][1]);
          *reinterpret_cast<int2*>(cr + 8 * CLD) = make_int2(acci[j][2], acci[j][3]);
        }
      } else {
#pragma unroll
        for (int g = 0; g < NG; ++g)
          wmma::store_matrix_sync(sm.Cs + warp * 16 * CLD + g * BN, acc[g], CLD, wmma::mem_row_major);
      }
      zero();
      __syncthreads();
      epi(rt);
      __syncthreads();
    }
    if (++kc == n_kc) kc = 0, ++rt;
  }
}

// eight values as bf16 in one 16-byte word, and as int8 in one 8-byte word
__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return w;
}

__device__ __forceinline__ uint2 pack_i8x8(const float (&v)[8], float inv) {
  return make_uint2(quant_i8x4(make_float4(v[0], v[1], v[2], v[3]), inv),
                    quant_i8x4(make_float4(v[4], v[5], v[6], v[7]), inv));
}

// ---------------------------------------------------------------------------
// per-row scales at the start of a phase, for all B rows: the maximum over a
// row's slots, then the log8 code (ACT_ROW's l) or the gate's scale (RS_ROW)
// ---------------------------------------------------------------------------
__device__ void prep_l_rows(const Smem& sm, const float* slots, int tiles, int B, const Log8& lg) {
  for (int b = threadIdx.x; b < B; b += THREADS) {
    float mx = 0.0f;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) mx = fmaxf(mx, __ldcg(slots + (size_t)t * B + b));
    const int code = log8_code(mx, lg);
    sm.l_code[b] = code;
    sm.l_inv[b] = log8_pow(lg, -code);
  }
}

__device__ void prep_g_rows(const Smem& sm, const float* slots, int tiles, int B) {
  for (int b = threadIdx.x; b < B; b += THREADS) {
    float mx = 0.0f;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) mx = fmaxf(mx, __ldcg(slots + (size_t)t * B + b));
    const float amax = fmaxf(mx, 1e-8f);
    sm.g_rg[b] = __fmul_rn(amax, kInv127);
    sm.g_mult[b] = __fdiv_rn(127.0f, amax);
  }
}

// the ring rows of the current layer and step
struct Step {
  int t;                      // step of the call
  const unsigned char* tap1;  // ring row t - d
  unsigned char* row2;        // ring row t - 2d: read as a tap, then overwritten with this step's l
};

// ---------------------------------------------------------------------------
// the gate of one row's 16 + 16 columns from its sums: sig[i], tanh[i] are the
// products of columns j0 + c0 + i and m + j0 + c0 + i of row b; a thread owns
// GATE_OUT columns of one row, a lane pair the row; every thread calls it,
// valid says whether the thread's row is its to write
// ---------------------------------------------------------------------------
template <int RS, int PROBE>
__device__ __forceinline__ void gate_bf16(const FastgenArgs& a, const float* cst, float* gmax_ct, bool valid,
                                          int b, int j0, int c0, const float (&sig)[GATE_OUT],
                                          const float (&tnh)[GATE_OUT]) {
  const int m = a.GW / 2;
  float gv[GATE_OUT];
#pragma unroll
  for (int i = 0; i < GATE_OUT; ++i) {
    const float xs = sig[i] + cst[CST_BIAS * GC + c0 + i];
    const float xt = tnh[i] + cst[(CST_BIAS + 1) * GC + c0 + i];
    if constexpr (PROBE == PROBE_CHEAP_GATE)
      gv[i] = clip_gate(xs, xt);
    else
      gv[i] = (1.0f / (1.0f + expf(-xs))) * tanhf(xt);
  }
  store_gate<RS, GLANES>(a.gate, gmax_ct, valid, b, m, j0 + c0, gv);
}

// int8 product: the segments' exact sums sum[segment][sigmoid | tanh][i],
// dequantised and combined as the reference does
// (re: enc(t)'s row scale; ACT_ROW: rl, rt2, rt1 those of l and of the two taps)
template <int ACT, int RS, int PROBE>
__device__ __forceinline__ void gate_i8(const FastgenArgs& a, const float* cst, float* gmax_ct, bool valid,
                                        int b, int j0, int c0,
                                        const int (&sum)[ACT == ACT_ROW ? 4 : 2][2][GATE_OUT], float re,
                                        float rl, float rt2, float rt1) {
  const int m = a.GW / 2;
  float gv[GATE_OUT];
#pragma unroll
  for (int i = 0; i < GATE_OUT; ++i) {
    float x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sc = cst[(CST_SCALE + h) * GC + c0 + i], bi = cst[(CST_BIAS + h) * GC + c0 + i];
      if constexpr (ACT == ACT_ROW) {
        // the reference's order: enc, l, tap t-2d, tap t-d; the sums are below 2^24, exact in f32
        const float se = (float)sum[3][h][i], sl = (float)sum[2][h][i];
        const float st2 = (float)sum[0][h][i], st1 = (float)sum[1][h][i];
        if (a.combine_bf16) {
          float acc = bf_round(__fmul_rn(bf_round(se), bf_round(re)));
          acc = bf_round(__fadd_rn(acc, bf_round(__fmul_rn(bf_round(sl), bf_round(rl)))));
          acc = bf_round(__fadd_rn(acc, bf_round(__fmul_rn(bf_round(st2), bf_round(rt2)))));
          acc = bf_round(__fadd_rn(acc, bf_round(__fmul_rn(bf_round(st1), bf_round(rt1)))));
          x[h] = bf_round(__fadd_rn(bf_round(__fmul_rn(acc, bf_round(sc))), bf_round(bi)));
        } else {
          float acc = __fmul_rn(se, re);
          acc = __fadd_rn(acc, __fmul_rn(sl, rl));
          acc = __fadd_rn(acc, __fmul_rn(st2, rt2));
          acc = __fadd_rn(acc, __fmul_rn(st1, rt1));
          x[h] = __fadd_rn(__fmul_rn(acc, sc), bi);
        }
      } else {
        const float main_part = __fmul_rn((float)sum[0][h][i], cst[(CST_MAIN + h) * GC + c0 + i]);
        const float enc_part = __fmul_rn(__fmul_rn((float)sum[1][h][i], re), sc);
        x[h] = __fadd_rn(__fadd_rn(main_part, enc_part), bi);
      }
    }
    if constexpr (PROBE == PROBE_CHEAP_GATE)
      gv[i] = clip_gate(x[0], x[1]);
    else
      gv[i] = __fmul_rn(1.0f / (1.0f + expf(-x[0])), tanhf(x[1]));
  }
  store_gate<RS, GLANES>(a.gate, gmax_ct, valid, b, m, j0 + c0, gv);
}

// Batch row b of column item ct (mine: the lane pair's row is b): every
// slice's partial in slice order (the int8 product by segment), then the gate.
template <int ACT, int RS, int PROBE>
__device__ void gate_reduce(const FastgenArgs& a, const Smem& sm, const float* cst, const Step& st,
                            float* gmax_ct, int ct, int b, bool mine, int n_rt, int nsplit) {
  const int row = b % TM, c0 = (threadIdx.x % GLANES) * GATE_OUT;
  const size_t tile = (size_t)ct * n_rt + b / TM;
  if constexpr (ACT == ACT_BF16) {
    const float* tiles = static_cast<const float*>(a.part) + tile * nsplit * GTILE;
    float sig[GATE_OUT], tnh[GATE_OUT];
#pragma unroll
    for (int i = 0; i < GATE_OUT; ++i) sig[i] = tnh[i] = 0.0f;
#pragma unroll 4
    for (int zz = 0; zz < (mine ? nsplit : 0); ++zz) {
      const float4* p = reinterpret_cast<const float4*>(tiles + (size_t)zz * GTILE + row * 2 * GC + c0);
      const float4 v4[4] = {__ldcg(p), __ldcg(p + 1), __ldcg(p + GC / 4), __ldcg(p + GC / 4 + 1)};
      sig[0] += v4[0].x, sig[1] += v4[0].y, sig[2] += v4[0].z, sig[3] += v4[0].w;
      sig[4] += v4[1].x, sig[5] += v4[1].y, sig[6] += v4[1].z, sig[7] += v4[1].w;
      tnh[0] += v4[2].x, tnh[1] += v4[2].y, tnh[2] += v4[2].z, tnh[3] += v4[2].w;
      tnh[4] += v4[3].x, tnh[5] += v4[3].y, tnh[6] += v4[3].z, tnh[7] += v4[3].w;
    }
    gate_bf16<RS, PROBE>(a, cst, gmax_ct, mine, b, ct * GC, c0, sig, tnh);
  } else {
    const int* tiles = static_cast<const int*>(a.part) + tile * nsplit * GTILE;
    // the row's scales, loaded beside the partials: enc(t)'s, and in ACT_ROW
    // those of l and of the two taps (from their codes)
    float re = 0.0f, rl = 0.0f, rt2 = 0.0f, rt1 = 0.0f;
    if (mine) {
      const int ring_ld = ACT == ACT_ROW ? a.W + ROW_LANES : a.W;
      re = __ldg(static_cast<const float*>(a.r_enc) + (size_t)st.t * a.B + b);
      if (ACT == ACT_ROW) {
        rl = log8_pow(a.log8, sm.l_code[b]);
        rt2 = log8_pow(a.log8, __ldcg(reinterpret_cast<const signed char*>(st.row2) + (size_t)b * ring_ld + a.W));
        rt1 = log8_pow(a.log8, __ldcg(reinterpret_cast<const signed char*>(st.tap1) + (size_t)b * ring_ld + a.W));
      }
    }
    // sums by segment: ACT_STATIC [3W part | enc], ACT_ROW [tap t-2d | tap t-d | l | enc]
    constexpr int NSUM = ACT == ACT_ROW ? 4 : 2;
    int sum[NSUM][2][GATE_OUT];
#pragma unroll
    for (int k = 0; k < NSUM; ++k)
#pragma unroll
      for (int i = 0; i < GATE_OUT; ++i) sum[k][0][i] = sum[k][1][i] = 0;
#pragma unroll 4
    for (int zz = 0; zz < (mine ? nsplit : 0); ++zz) {
      const int4* p = reinterpret_cast<const int4*>(tiles + (size_t)zz * GTILE + row * 2 * GC + c0);
      const int4 v4[4] = {__ldcg(p), __ldcg(p + 1), __ldcg(p + GC / 4), __ldcg(p + GC / 4 + 1)};
      const int k = sm.tab[sm.tab[T_SEGS] + zz];  // the slice's segment
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
    gate_i8<ACT, RS, PROBE>(a, cst, gmax_ct, mine, b, ct * GC, c0, sum, re, rl, rt2, rt1);
  }
}

// ---------------------------------------------------------------------------
// gate phase: gate = sigmoid(dpre[:m]) * tanh(dpre[m:]) of layer li (and, in
// layer 0, s = skip_start(bf16(l)))
// ---------------------------------------------------------------------------
template <int ACT, int RS, int PROBE>
__device__ void gate_phase(const FastgenArgs& a, const Smem& sm, int li, const Step& st, int buf) {
  const int B = a.B, W = a.W, DW = a.DW, S = a.S, m = a.GW / 2;
  const int* tab = sm.tab;
  const int n_gate = tab[T_GATE], nsplit = tab[T_NSPLIT];
  const int count = phase_count(tab, PH_GATE, li);
  if ((int)blockIdx.x >= count) return;
  const int n_rt = (B + TM - 1) / TM;
  const int ring_ld = ACT == ACT_ROW ? W + ROW_LANES : W;
  const unsigned char* tap2 = st.row2;
  const unsigned char* tap1 = st.tap1;
  float* gmax_li = RS == RS_ROW ? static_cast<float*>(a.gmax) + (size_t)li * (m / GC) * B : nullptr;
  bool prepped = false;  // ACT_ROW: the rows' l codes, once a phase, behind the first item's first chunks
  auto start = [&]() {
    if (ACT == ACT_ROW && !prepped) {
      prep_l_rows(sm, static_cast<const float*>(a.lmax) + (size_t)li * (W / RC) * B, W / RC, B, a.log8);
      __syncthreads();
      prepped = true;
    }
  };
  const int r = threadIdx.x / 2, cc = (threadIdx.x % 2) * 8;
  for (int idx = blockIdx.x; idx < count; idx += gridDim.x) {
    unsigned char* wst = sm.stage[buf];
    if (idx != (int)blockIdx.x) {
      __syncthreads();
      stage_item<ACT, RS>(a, tab, PH_GATE, li, idx, wst);
    }
    const int* it = phase_item(tab, PH_GATE, idx);
    const int ct = it[0], k0 = it[1], k1 = it[2], z = it[3], rt0 = it[4], rt1 = it[5];
    auto nothing = [](int) {};
    if (idx >= n_gate) {  // s = bf16(l) @ w_skip0 + b_skip0
      const unsigned char* lb = static_cast<const unsigned char*>(a.l_bf);
      const int j0 = ct * BN;
      float bias[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) bias[i] = __ldg(static_cast<const float*>(a.b_skip0) + j0 + cc + i);
      run_item<false, 1, SRC_BF16, NS>(
          sm, B, rt0, rt1, W, nullptr, wst, [&](int kk) { return Src{lb + kk * 2, W * 2}; }, start, nothing,
          [&](int rt) {
            const int b = rt * TM + r;
            if (b >= B) return;
            float* s = static_cast<float*>(a.s) + (size_t)b * S + j0 + cc;
#pragma unroll
            for (int i = 0; i < 8; ++i) s[i] = sm.Cs[r * (BN + 4) + cc + i] + bias[i];
          });
      continue;
    }
    float* gmax_ct = gmax_li + (size_t)ct * B;  // RS_ROW: the column item's slots
    const float* cst = reinterpret_cast<const float*>(wst + a.stage_bytes) - CST_WORDS;
    // nsplit > 1: each row tile's partial goes out at once, and the slices meet
    // after the item's last tile (gate_reduce), so no tile waits on a round trip
    auto publish = [&](int rt) {
      const size_t tile = (size_t)ct * n_rt + rt;
      uint4* mine = reinterpret_cast<uint4*>(static_cast<uint32_t*>(a.part) + (tile * nsplit + z) * GTILE);
      const uint32_t* cs = reinterpret_cast<const uint32_t*>(sm.Cs);
#pragma unroll
      for (int i = 0; i < GTILE / 4 / THREADS; ++i) {  // 16-byte pieces, GC / 2 a row
        const int e = threadIdx.x + i * THREADS;
        __stcg(mine + e, *reinterpret_cast<const uint4*>(cs + (e / (GC / 2)) * (2 * GC + 4) + (e % (GC / 2)) * 4));
      }
    };
    if constexpr (ACT == ACT_BF16) {
      const unsigned char* lb = static_cast<const unsigned char*>(a.l_bf);
      const unsigned char* enc = static_cast<const unsigned char*>(a.enc) + (size_t)st.t * B * DW * 2;
      run_item<false, GNG, SRC_BF16, NS>(
          sm, B, rt0, rt1, k1 - k0, nullptr, wst,
          [&](int kk) {
            const int k = k0 + kk;
            return k < W       ? Src{tap2 + k * 2, W * 2}
                 : k < 2 * W   ? Src{tap1 + (k - W) * 2, W * 2}
                 : k < 3 * W   ? Src{lb + (k - 2 * W) * 2, W * 2}
                               : Src{enc + (k - 3 * W) * 2, DW * 2};
          },
          start, nothing,
          [&](int rt) {
            if (nsplit > 1) {
              publish(rt);
              return;
            }
            const int c0 = (threadIdx.x % GLANES) * GATE_OUT;
            for (int rr = threadIdx.x / GLANES; rr < TM; rr += THREADS / GLANES) {  // block-uniform trips
              float sig[GATE_OUT], tnh[GATE_OUT];
#pragma unroll
              for (int i = 0; i < GATE_OUT; ++i) {
                sig[i] = sm.Cs[rr * (2 * GC + 4) + c0 + i];
                tnh[i] = sm.Cs[rr * (2 * GC + 4) + GC + c0 + i];
              }
              gate_bf16<RS, PROBE>(a, cst, gmax_ct, rt * TM + rr < B, rt * TM + rr, ct * GC, c0, sig, tnh);
            }
          });
    } else {
      const unsigned char* ql = static_cast<const unsigned char*>(a.q_l);
      const unsigned char* lf = static_cast<const unsigned char*>(a.l);
      const unsigned char* qe = static_cast<const unsigned char*>(a.q_enc) + (size_t)st.t * B * DW;
      auto src = [&](int kk) {
        const int k = k0 + kk;
        return k < W       ? Src{tap2 + k, ring_ld}
             : k < 2 * W   ? Src{tap1 + (k - W), ring_ld}
             : k < 3 * W   ? (ACT == ACT_ROW ? Src{lf + (size_t)(k - 2 * W) * 4, W * 4} : Src{ql + (k - 2 * W), W})
                           : Src{qe + (k - 3 * W), DW};
      };
      if (ACT == ACT_ROW && k0 >= 2 * W && k0 < 3 * W)  // ACT_ROW's l: f32, quantised per row
        run_item<true, GNG, ACT == ACT_ROW ? SRC_F32 : SRC_I8, NS>(sm, B, rt0, rt1, k1 - k0, sm.l_inv, wst,
                                                                    src, start, nothing, publish);
      else
        run_item<true, GNG, SRC_I8, NS>(sm, B, rt0, rt1, k1 - k0, nullptr, wst, src, start, nothing, publish);
    }
    if (nsplit > 1) {
      // the item's slices meet once: each arrives on the count of its columns
      // and rows (it only grows, nsplit a gate phase) and waits for the
      // others; then slice z reduces rows z, z + nsplit, ...  The slices
      // of an item are nsplit consecutive items, on distinct blocks that are
      // all resident, so the wait ends.
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned* count = static_cast<unsigned*>(a.counters) + (size_t)ct * n_rt + rt0;
        const unsigned target = (unsigned)(st.t * a.NL + li + 1) * (unsigned)nsplit;
        __threadfence();
        atomicAdd(count, 1u);
        const long long start = clock64();
        while (ld_acquire_u32(count) < target)
          if (clock64() - start > BARRIER_TIMEOUT) __trap();
        __threadfence();
      }
      __syncthreads();
      // GLANES lanes a row: rows z, z + nsplit, ... of the item's rows
      const int r0 = rt0 * TM, span = min(rt1 * TM, B) - r0;
      const int rows = span > z ? (span - z + nsplit - 1) / nsplit : 0;
      for (int jb = 0; jb < rows; jb += THREADS / GLANES) {  // block-uniform
        const int j = jb + threadIdx.x / GLANES;
        gate_reduce<ACT, RS, PROBE>(a, sm, cst, st, gmax_ct, ct, r0 + z + nsplit * j, j < rows, n_rt, nsplit);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// res/skip phase: rs = gate @ w_rs[li] + b_rs[li]; ring write, l += rs[:W],
// s += rs[W:], the next layer's operand
// ---------------------------------------------------------------------------
template <int ACT, int RS, int PROBE>
__device__ void rs_phase(const FastgenArgs& a, const Smem& sm, int li, const Step& st, int buf) {
  const int B = a.B, W = a.W, S = a.S, GW = a.GW, m = GW / 2, N = W + S, NL = a.NL;
  const int* tab = sm.tab;
  const int count = tab[T_RS];
  if ((int)blockIdx.x >= count) return;
  const int ring_ld = ACT == ACT_ROW ? W + ROW_LANES : W;
  bool prepped = false;  // the rows' l codes and gate scales, once a phase, behind the first chunks
  auto start = [&]() {
    if ((ACT == ACT_ROW || RS == RS_ROW) && !prepped) {
      if (ACT == ACT_ROW)
        prep_l_rows(sm, static_cast<const float*>(a.lmax) + (size_t)li * (W / RC) * B, W / RC, B, a.log8);
      if (RS == RS_ROW) prep_g_rows(sm, static_cast<const float*>(a.gmax) + (size_t)li * (m / GC) * B, m / GC, B);
      __syncthreads();
      prepped = true;
    }
  };
  const float inv_next = ACT == ACT_STATIC && li + 1 < NL ? __ldg(static_cast<const float*>(a.s_act_inv) + li + 1) : 0.0f;
  float* lmax_next = ACT == ACT_ROW && li + 1 < NL ? static_cast<float*>(a.lmax) + (size_t)(li + 1) * (W / RC) * B : nullptr;
  const unsigned char* gate = static_cast<const unsigned char*>(a.gate);
  // RL lanes a row, 8 columns each; a thread takes rows lr and lr + THREADS / RL of a tile
  constexpr int RP = TM * RL / THREADS;
  const int lr = threadIdx.x / RL, cc = (threadIdx.x % RL) * 8;
  for (int idx = blockIdx.x; idx < count; idx += gridDim.x) {
    unsigned char* wst = sm.stage[buf];
    if (idx != (int)blockIdx.x) {
      __syncthreads();
      stage_item<ACT, RS>(a, tab, PH_RS, li, idx, wst);
    }
    const int* it = phase_item(tab, PH_RS, idx);
    const int ct = it[0], rt0 = it[4], rt1 = it[5];
    const int n0 = ct * RC, c = n0 + cc;
    const bool is_l = n0 < W;  // item-uniform: W % 32 == 0
    // the thread's columns' bias and scales, and (pre) its rows' old l or s and
    // static int8 l, loaded when the row tile's first chunk is in
    float bias[8], scale[8], old[RP][8];
    uint2 q_old[RP];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bias[i] = __ldg(static_cast<const float*>(a.b_rs) + (size_t)li * N + c + i);
      scale[i] = RS == RS_BF16 ? 0.0f : __ldg(static_cast<const float*>(a.s_rs) + (size_t)li * N + c + i);
    }
    auto pre = [&](int rt) {
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        const int b = rt * TM + lr + p * (THREADS / RL);
        if (b >= B) continue;
        const float4* src = reinterpret_cast<const float4*>(
            is_l ? static_cast<const float*>(a.l) + (size_t)b * W + c : static_cast<const float*>(a.s) + (size_t)b * S + (c - W));
        const float4 v0 = __ldcg(src), v1 = __ldcg(src + 1);
        old[p][0] = v0.x, old[p][1] = v0.y, old[p][2] = v0.z, old[p][3] = v0.w;
        old[p][4] = v1.x, old[p][5] = v1.y, old[p][6] = v1.z, old[p][7] = v1.w;
        if (ACT == ACT_STATIC && is_l)
          q_old[p] = __ldcg(reinterpret_cast<const uint2*>(static_cast<const signed char*>(a.q_l) + (size_t)b * W + c));
      }
    };
    auto epi = [&](int rt) {
#pragma unroll
      for (int p = 0; p < RP; ++p) {
        const int r = lr + p * (THREADS / RL), b = rt * TM + r;
        const bool valid = b < B;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if constexpr (RS == RS_BF16) {
            v[i] = __fadd_rn(sm.Cs[r * (RC + 4) + cc + i], bias[i]);
          } else {
            float sc = scale[i];
            if (RS == RS_ROW) sc = __fmul_rn(valid ? sm.g_rg[b] : 0.0f, sc);  // the row's gate scale meets the column scale first
            v[i] = __fadd_rn(__fmul_rn((float)reinterpret_cast<const int*>(sm.Cs)[r * (RC + 4) + cc + i], sc), bias[i]);
          }
        }
        float now[8], mx = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) now[i] = __fadd_rn(old[p][i], v[i]);
        if (valid && !is_l) {
          float4* sp = reinterpret_cast<float4*>(static_cast<float*>(a.s) + (size_t)b * S + (c - W));
          sp[0] = make_float4(now[0], now[1], now[2], now[3]);
          sp[1] = make_float4(now[4], now[5], now[6], now[7]);
          if (li == NL - 1) {  // the out1 operand
            float rl[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) rl[i] = fmaxf(now[i], 0.0f);
            *reinterpret_cast<uint4*>(static_cast<bf16*>(a.s_bf) + (size_t)b * S + (c - W)) = pack_bf16x8(rl);
          }
        }
        if (valid && is_l) {
          const size_t idx_l = (size_t)b * W + c;
          float4* lp = reinterpret_cast<float4*>(static_cast<float*>(a.l) + idx_l);
          lp[0] = make_float4(now[0], now[1], now[2], now[3]);
          lp[1] = make_float4(now[4], now[5], now[6], now[7]);
          if (ACT == ACT_BF16) {
            if constexpr (PROBE != PROBE_NO_RING_WRITE)
              *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(st.row2) + idx_l) = pack_bf16x8(old[p]);
            *reinterpret_cast<uint4*>(static_cast<bf16*>(a.l_bf) + idx_l) = pack_bf16x8(now);
          }
          if (ACT == ACT_STATIC) {
            // the current int8 l to the ring, and the next layer's in its place
            if constexpr (PROBE != PROBE_NO_RING_WRITE)
              *reinterpret_cast<uint2*>(st.row2 + idx_l) = q_old[p];
            if (li + 1 < NL)
              *reinterpret_cast<uint2*>(static_cast<signed char*>(a.q_l) + idx_l) = pack_i8x8(now, inv_next);
          }
          if (ACT == ACT_ROW) {
            // the ring row is l as this layer's gate product read it: the same
            // code from the same maximum, and the code itself in lane W
            if constexpr (PROBE != PROBE_NO_RING_WRITE) {
              signed char* ring = reinterpret_cast<signed char*>(st.row2) + (size_t)b * ring_ld;
              *reinterpret_cast<uint2*>(ring + c) = pack_i8x8(old[p], sm.l_inv[b]);
              if (c == 0) ring[W] = (signed char)sm.l_code[b];
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(now[i]));
          }
        }
        if (ACT == ACT_ROW && is_l && lmax_next != nullptr) {
          mx = lanes_max<RL>(mx);
          if (valid && threadIdx.x % RL == 0) lmax_next[(size_t)ct * B + b] = mx;
        }
      }
    };
    if constexpr (RS == RS_BF16)
      run_item<false, RC / BN, SRC_BF16, NS>(sm, B, rt0, rt1, m, nullptr, wst,
                                             [&](int kk) { return Src{gate + kk * 2, m * 2}; }, start, pre, epi);
    else if constexpr (RS == RS_STATIC)
      run_item<true, RC / BN, SRC_I8, NS>(sm, B, rt0, rt1, m, nullptr, wst,
                                          [&](int kk) { return Src{gate + kk, m}; }, start, pre, epi);
    else
      run_item<true, RC / BN, SRC_F32, NS>(sm, B, rt0, rt1, m, sm.g_mult, wst,
                                           [&](int kk) { return Src{gate + (size_t)kk * 4, m * 4}; }, start, pre, epi);
  }
}

// ---------------------------------------------------------------------------
// head phases: o1 = bf16(relu([bf16(relu(s)) | enc(t)] @ w_out1 + b_out1)),
// then out = o1 @ w_out2 + b_out2
// ---------------------------------------------------------------------------
template <int ACT, int RS>
__device__ void out1_phase(const FastgenArgs& a, const Smem& sm, int t, int buf) {
  const int B = a.B, S = a.S, DW = a.DW;
  const int* tab = sm.tab;
  const int count = tab[T_OUT1];
  const unsigned char* sb = static_cast<const unsigned char*>(a.s_bf);
  const unsigned char* enc = static_cast<const unsigned char*>(a.enc) + (size_t)t * B * DW * 2;
  const int r = threadIdx.x / 2, cc = (threadIdx.x % 2) * 8;
  for (int idx = blockIdx.x; idx < count; idx += gridDim.x) {
    unsigned char* wst = sm.stage[buf];
    if (idx != (int)blockIdx.x) {
      __syncthreads();
      stage_item<ACT, RS>(a, tab, PH_OUT1, 0, idx, wst);
    }
    const int* it = phase_item(tab, PH_OUT1, idx);
    const int n0 = it[0] * BN;
    float bias[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) bias[i] = __ldg(static_cast<const float*>(a.b_out1) + n0 + cc + i);
    run_item<false, 1, SRC_BF16, NS>(
        sm, B, it[4], it[5], S + DW, nullptr, wst,
        [&](int kk) { return kk < S ? Src{sb + kk * 2, S * 2} : Src{enc + (kk - S) * 2, DW * 2}; },
        []() {}, [](int) {},
        [&](int rt) {
          const int b = rt * TM + r;
          if (b >= B) return;
          bf16* o1 = static_cast<bf16*>(a.o1) + (size_t)b * S + n0 + cc;
#pragma unroll
          for (int i = 0; i < 8; ++i) o1[i] = __float2bfloat16(fmaxf(sm.Cs[r * (BN + 4) + cc + i] + bias[i], 0.0f));
        });
  }
}

template <int ACT, int RS>
__device__ void out2_phase(const FastgenArgs& a, const Smem& sm, int t, int buf) {
  const int B = a.B, S = a.S, P = a.out_pad;
  const int* tab = sm.tab;
  const int count = tab[T_OUT2];
  const unsigned char* o1 = static_cast<const unsigned char*>(a.o1);
  float* outp = static_cast<float*>(a.out_params);
  const int r = threadIdx.x / 2, cc = (threadIdx.x % 2) * 8;
  for (int idx = blockIdx.x; idx < count; idx += gridDim.x) {
    unsigned char* wst = sm.stage[buf];
    if (idx != (int)blockIdx.x) {
      __syncthreads();
      stage_item<ACT, RS>(a, tab, PH_OUT2, 0, idx, wst);
    }
    const int* it = phase_item(tab, PH_OUT2, idx);
    const int n0 = it[0] * BN;
    float bias[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) bias[i] = __ldg(static_cast<const float*>(a.b_out2) + n0 + cc + i);
    run_item<false, 1, SRC_BF16, NS>(
        sm, B, it[4], it[5], S, nullptr, wst, [&](int kk) { return Src{o1 + kk * 2, S * 2}; },
        []() {}, [](int) {},
        [&](int rt) {
          const int b = rt * TM + r;
          if (b >= B) return;
          float* out = static_cast<float*>(a.outv) + (size_t)b * P + n0 + cc;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v = sm.Cs[r * (BN + 4) + cc + i] + bias[i];
            out[i] = v;
            if (outp != nullptr) outp[((size_t)t * B + b) * P + n0 + cc + i] = v;
          }
        });
  }
}

// ---------------------------------------------------------------------------
// sample + start: one warp per batch row
// ---------------------------------------------------------------------------
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

// l = conv_start(x0, x1, x2) of row b, bf16(l) for skip_start (and ACT_BF16's
// gate), layer 0's operand: ACT_STATIC int8 l, ACT_ROW its row maximum in the
// first of layer 0's slots (the others hold zero)
template <int ACT>
__device__ __forceinline__ void start_row(const FastgenArgs& a, int b, float x0, float x1, float x2) {
  const int B = a.B, W = a.W, lane = threadIdx.x % 32;
  const float* ws = static_cast<const float*>(a.w_start);
  const float* bs = static_cast<const float*>(a.b_start);
  float* l = static_cast<float*>(a.l) + (size_t)b * W;
  bf16* l_bf = static_cast<bf16*>(a.l_bf) + (size_t)b * W;
  signed char* q_l = static_cast<signed char*>(a.q_l) + (size_t)b * W;
  const float inv0 = ACT == ACT_STATIC ? __ldg(static_cast<const float*>(a.s_act_inv)) : 0.0f;
  float mx = 0.0f;
  for (int c = lane; c < W; c += 32) {
    const float v = x0 * __ldg(ws + c) + x1 * __ldg(ws + W + c) + x2 * __ldg(ws + 2 * W + c) + __ldg(bs + c);
    l[c] = v;
    l_bf[c] = __float2bfloat16(v);
    if (ACT == ACT_STATIC) q_l[c] = quant_i8(v, inv0);
    mx = fmaxf(mx, fabsf(v));
  }
  if (ACT == ACT_ROW) {
    mx = lanes_max<32>(mx);
    float* lmax = static_cast<float*>(a.lmax);
    for (int t = lane; t < W / RC; t += 32) lmax[(size_t)t * B + b] = t == 0 ? mx : 0.0f;
  }
}

template <int ACT>
__device__ void sample_phase(const FastgenArgs& a, int t, bool do_start) {
  const int B = a.B, P = a.out_pad;
  const int lane = threadIdx.x % 32;
  const int nw = gridDim.x * (THREADS / 32);
  float* xh = static_cast<float*>(a.xh);
  const uint32_t k0 = (uint32_t)((unsigned long long)a.seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)((unsigned long long)a.seed >> 32);
  const float half = (float)(a.quant_chann / 2);
  const uint32_t tg = (uint32_t)(a.t0 + t);  // the random counter runs on the global step
  float* audio = static_cast<float*>(a.audio);
  const float* tf = static_cast<const float*>(a.tf);
  for (int b = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; b < B; b += nw) {
    const float* o = static_cast<const float*>(a.outv) + (size_t)b * P;
    float qv = 0.0f, x = 0.0f;
    if (a.head == HEAD_GAUSS) {
      x = __ldcg(o);
      if (!a.greedy) {
        const float u1 = uniform_from_bits(philox_bits(0u, b, tg, 0u, k0, k1));
        const float u2 = uniform_from_bits(philox_bits(0u, b, tg, 1u, k0, k1));
        const float z = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
        x = x + expf(fmaxf(__ldcg(o + 1), -7.0f)) * z;
      }
    } else {
      const int n = a.head == HEAD_MOL ? a.out_seg : P;
      float best = -INFINITY;
      int idx = 0x7fffffff;
      for (int i = lane; i < n; i += 32) {
        float sc = __ldcg(o + i);
        if (!a.greedy) sc = sc - logf(-logf(uniform_from_bits(philox_bits(i, b, tg, 0u, k0, k1))));
        if (sc > best) {
          best = sc;
          idx = i;
        }
      }
      warp_argmax(best, idx);
      if (a.head == HEAD_MOL) {
        x = __ldcg(o + a.out_seg + idx);
        if (!a.greedy) {
          const float log_sc = fminf(fmaxf(__ldcg(o + 2 * a.out_seg + idx), -7.0f), 7.0f);
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
    const float fb = tf != nullptr ? __ldg(tf + (size_t)t * B + b) : au;
    const float xn =
        a.use_mu_law ? floorf(sign_of(fb) * log1pf(255.0f * fabsf(fb)) / kLog256 * 128.0f) / half : fb;
    const float x0 = xh[B + b], x1 = xh[2 * B + b];
    __syncwarp();
    if (lane == 0) {
      audio[(size_t)t * B + b] = au;
      xh[b] = x0;
      xh[B + b] = x1;
      xh[2 * B + b] = xn;
    }
    if (do_start) start_row<ACT>(a, b, x0, x1, xn);
  }
}

// ---------------------------------------------------------------------------
// the persistent kernel: the whole call, every step, every layer
// ---------------------------------------------------------------------------
template <int ACT, int RS, int PROBE>
__global__ void __launch_bounds__(THREADS) fastgen_persistent(const __grid_constant__ FastgenArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm;
  sm.stage[0] = smem;
  sm.stage[1] = smem + a.stage_bytes;
  sm.slots = smem + 2 * a.stage_bytes;
  sm.slot_stride = a.slot_bytes;
  sm.As = reinterpret_cast<signed char*>(sm.slots + NS * a.slot_bytes);
  sm.Cs = reinterpret_cast<float*>(sm.slots + NS * a.slot_bytes + TM * AS_LD);
  // the per-row scales, [B] each, only in the modes that read them; then the table
  float* rows = sm.Cs + TM * (GNG * BN + 4);
  sm.l_code = nullptr, sm.l_inv = sm.g_rg = sm.g_mult = nullptr;
  if (ACT == ACT_ROW) {
    sm.l_code = reinterpret_cast<int*>(rows);
    sm.l_inv = rows + a.B;
    rows += 2 * a.B;
  }
  if (RS == RS_ROW) {
    sm.g_rg = rows;
    sm.g_mult = rows + a.B;
    rows += 2 * a.B;
  }
  int* stab = reinterpret_cast<int*>(rows);
  for (int i = threadIdx.x; i < a.table_words; i += THREADS) stab[i] = static_cast<const int*>(a.table)[i];
  sm.tab = stab;
  __syncthreads();
  unsigned long long* bar = static_cast<unsigned long long*>(a.bar);
  unsigned long long target = 0;
  const int B = a.B, NL = a.NL;
  const size_t ring_ld = ACT == ACT_ROW ? a.W + ROW_LANES : a.W;
  const size_t slot_bytes = (size_t)B * ring_ld * (ACT == ACT_BF16 ? sizeof(bf16) : 1);
  unsigned char* lbuf = static_cast<unsigned char*>(a.lbuf);
  float* xh = static_cast<float*>(a.xh);

  int buf = 0;
  prefetch<ACT, RS>(a, sm, PH_GATE, 0, buf);
  // the first step's start from the carried input taps
  for (int b = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; b < B; b += gridDim.x * (THREADS / 32))
    start_row<ACT>(a, b, xh[b], xh[B + b], xh[2 * B + b]);
  grid_barrier(bar, target);
  for (int t = 0; t < a.L; ++t) {
    const long long tg = (long long)a.t0 + t;
    size_t base = 0;
    for (int li = 0; li < NL; ++li) {
      const int d = 1 << (li % a.num_stages);
      Step st;
      st.t = t;
      st.row2 = lbuf + (base + tg % (2 * d)) * slot_bytes;             // state at t - 2d, overwritten this step
      st.tap1 = lbuf + (base + (tg + d) % (2 * d)) * slot_bytes;       // state at t - d
      gate_phase<ACT, RS, PROBE>(a, sm, li, st, buf);
      prefetch<ACT, RS>(a, sm, PH_RS, li, buf ^ 1);
      grid_barrier(bar, target);
      buf ^= 1;
      {  // the ring rows the next gate phase reads (cold after 2d steps) towards L2
        const bool last = li + 1 == NL;
        const int d2 = last ? 1 : 1 << ((li + 1) % a.num_stages);
        const size_t base2 = last ? 0 : base + 2 * d;
        const long long tg2 = last ? tg + 1 : tg;
        l2_prefetch(lbuf + (base2 + tg2 % (2 * d2)) * slot_bytes, slot_bytes);
        l2_prefetch(lbuf + (base2 + (tg2 + d2) % (2 * d2)) * slot_bytes, slot_bytes);
      }
      rs_phase<ACT, RS, PROBE>(a, sm, li, st, buf);
      if (li + 1 < NL)
        prefetch<ACT, RS>(a, sm, PH_GATE, li + 1, buf ^ 1);
      else
        prefetch<ACT, RS>(a, sm, PH_OUT1, 0, buf ^ 1);
      grid_barrier(bar, target);
      buf ^= 1;
      base += 2 * d;
    }
    out1_phase<ACT, RS>(a, sm, t, buf);
    prefetch<ACT, RS>(a, sm, PH_OUT2, 0, buf ^ 1);
    grid_barrier(bar, target);
    buf ^= 1;
    out2_phase<ACT, RS>(a, sm, t, buf);
    const bool more = t + 1 < a.L;
    if (more) prefetch<ACT, RS>(a, sm, PH_GATE, 0, buf ^ 1);
    grid_barrier(bar, target);
    buf ^= 1;
    if (more) {  // the next step's conditioning (gate and out1 operands) towards L2
      l2_prefetch(static_cast<const bf16*>(a.enc) + (size_t)(t + 1) * B * a.DW, (size_t)B * a.DW * 2);
      if (ACT != ACT_BF16)
        l2_prefetch(static_cast<const signed char*>(a.q_enc) + (size_t)(t + 1) * B * a.DW, (size_t)B * a.DW);
    }
    sample_phase<ACT>(a, t, more);
    if (more) grid_barrier(bar, target);
  }
  cp_wait<0>();
}

// ---- quant_enc_kernel: the int8 modes' conditioning pre-pass ----
// Replaces the per-step conditioning quantisation of the TPU kernel
// (nsynth_wavenet_tpu/ops/fastgen_kernel.py :447-452, _quant_rows_dyn :201),
// hoisted out of the time loop: one launch before fastgen_persistent covers
// every (t, b) row of the call.  From the encoding window where the caller
// holds it (a strided [C, B, DW] view, bf16 or f32) it writes, in one pass,
// the contiguous time-major bf16 copy enc [C, B, DW] that fastgen_persistent
// reads, q_enc [C, B, DW] int8 and r_enc [C, B] f32.  Per row:
//   amax = max(max|bf16 x|, 1e-8),  mult = bf16(127 / amax),
//   q = clip(rint(bf16(x * mult)), +-127),  r = amax * (1/127),
// rounded where the reference rounds (its enc is bf16 and the product is a
// bf16 product, which can reach 127.5: the clip keeps the int8 from wrapping).
// Two layouts of the window (ops/fastgen_kernel.py enc_layout):
//   rows      DW contiguous (a time-major tensor): a tile is 32 rows t * B + b
//             in that order, each row read as 16-byte vectors;
//   channels  time contiguous (the deconv's own output, [B, T, DW] held
//             channel by channel): a tile is 32 time steps of one batch row,
//             each channel's 64 bytes (bf16) read as 16-byte vectors that
//             start on a 16-byte boundary (the window's first step may not:
//             the tile is laid on the aligned grid and the steps outside the
//             window are left out).
// Bound: bytes.  Each value is read once (2 B in bf16) and written twice
// (2 B bf16 + 1 B int8), with 4 B a row: at B = 896 x C = 16 000 x DW = 256
// 18.4 GB, 5.5 ms at 3.35 TB/s.  The design before read each row twice (the
// amax pass, then the quantise pass) with 2-byte loads and byte stores, after
// a PyTorch pass that copied the window time-major: 25.7 GB.
// Design: persistent blocks (the grid is the blocks that fit at once) of
// 8 warps walk the tiles.  A tile's 16-byte vectors are loaded into
// registers one tile ahead, so the next tile's loads are in flight while
// this one is reduced; they land in shared memory as [32 rows][DW] bf16
// (an f32 window rounded to bf16 on the way), the 16-byte chunks of row r
// rotated by r / (values a vector) so that neither the vectors' stores nor
// the rows' loads meet a bank conflict.  A warp then takes a row at a time:
// a lane holds 8 values a chunk (DW / 8 chunks a row), the warp's shuffle
// reduction gives amax, and the lane writes its chunks' 16 bf16 bytes and
// 8 int8 bytes, lane 0 the row's r.
constexpr int QE_THREADS = 256;
constexpr int QE_ROWS = 32;          // rows of a tile
constexpr int QE_MAX_DW = 512;       // ops/fastgen_kernel.py ENC_MAX_WIDTH

struct QuantEncParams {
  const void* src;     // the window's element (0, 0, 0)
  long long st, sb, sk;  // its element strides: time step, batch row, channel
  bf16* enc;           // [C, B, DW] out
  signed char* q;      // [C, B, DW] out
  float* r;            // [C, B] out
  int C, B, DW;
  int mis;             // channels: the window's first step's place in its 16-byte block
  int tiles_per_row;   // channels: tiles of one batch row
  long long n_tiles;
};

// Element offset in the tile of value (row, k): chunk k / 8 of the row sits
// at chunk (k / 8 + row / VEC) % (DW / 8).
template <int VEC>
__device__ __forceinline__ int qe_at(int row, int k, int DW) {
  const int nc = DW >> 3;
  return row * DW + ((((k >> 3) + row / VEC) % nc) << 3) + (k & 7);
}

// The (t, b) of row r of tile z, or t = -1 past the window.
template <bool TIME_CONTIG>
__device__ __forceinline__ void qe_row(const QuantEncParams& p, long long z, int r, int& t, int& b) {
  if constexpr (TIME_CONTIG) {
    b = (int)(z / p.tiles_per_row);
    t = (int)(z % p.tiles_per_row) * QE_ROWS + r - p.mis;
    if (t >= p.C) t = -1;
  } else {
    const long long row = z * QE_ROWS + r;
    t = row < (long long)p.C * p.B ? (int)(row / p.B) : -1;
    b = (int)(row % p.B);
  }
}

// DWMAX: the widest deconv width an instantiation takes (256 or QE_MAX_DW),
// which sizes the registers that stage a tile
template <typename T, bool TIME_CONTIG, int DWMAX>
__global__ void __launch_bounds__(QE_THREADS, DWMAX * sizeof(T) <= 512 ? 3 : DWMAX * sizeof(T) <= 1024 ? 2 : 1)
    quant_enc_kernel(const QuantEncParams p) {
  constexpr int VEC = 16 / (int)sizeof(T);                   // values a 16-byte vector
  constexpr int MAXV = QE_ROWS * DWMAX / VEC / QE_THREADS;  // vectors a thread at most
  extern __shared__ __align__(16) unsigned char qe_smem[];
  bf16* tile = reinterpret_cast<bf16*>(qe_smem);
  const int DW = p.DW, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = QE_ROWS * DW / VEC;  // vectors a tile
  const T* src = static_cast<const T*>(p.src);
  uint4 staged[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) staged[i] = make_uint4(0u, 0u, 0u, 0u);

  // vector v of a tile: its first (row, channel) in the tile; it holds VEC
  // steps of one channel (channels) or VEC channels of one row (rows)
  auto place = [&](int v, int& row, int& k) {
    if constexpr (TIME_CONTIG) {
      k = v / (QE_ROWS / VEC);
      row = (v % (QE_ROWS / VEC)) * VEC;
    } else {
      row = v / (DW / VEC);
      k = (v % (DW / VEC)) * VEC;
    }
  };
  // tile z's vectors that hold a value of the window, into registers
  auto load = [&](long long z) {
    int b = 0, t0 = 0;
    if constexpr (TIME_CONTIG) {
      b = (int)(z / p.tiles_per_row);
      t0 = (int)(z % p.tiles_per_row) * QE_ROWS - p.mis;
    }
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int v = tid + i * QE_THREADS;
      if (v >= nv) break;
      int row, k;
      place(v, row, k);
      if constexpr (TIME_CONTIG) {
        const int t = t0 + row;
        if (t < p.C && t + VEC > 0)
          staged[i] = __ldg(reinterpret_cast<const uint4*>(src + b * p.sb + k * p.sk + t));
      } else {
        int t, bb;
        qe_row<false>(p, z, row, t, bb);
        if (t >= 0)
          staged[i] = __ldg(reinterpret_cast<const uint4*>(src + (long long)t * p.st + bb * p.sb + k));
      }
    }
  };
  // the registers into the tile, rounded to bf16
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int v = tid + i * QE_THREADS;
      if (v >= nv) break;
      int row, k;
      place(v, row, k);
      bf16 vals[VEC];
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(vals) = staged[i];
      } else {
        const float4 f = *reinterpret_cast<const float4*>(&staged[i]);
        vals[0] = __float2bfloat16_rn(f.x);
        vals[1] = __float2bfloat16_rn(f.y);
        vals[2] = __float2bfloat16_rn(f.z);
        vals[3] = __float2bfloat16_rn(f.w);
      }
      bf16* at = tile + qe_at<VEC>(row, k, DW);
      if constexpr (TIME_CONTIG) {  // VEC steps of channel k: one chunk position (row / VEC fixed)
#pragma unroll
        for (int e = 0; e < VEC; ++e) at[e * DW] = vals[e];
      } else if constexpr (sizeof(T) == 2) {  // one chunk of the row
        *reinterpret_cast<uint4*>(at) = *reinterpret_cast<uint4*>(vals);
      } else {  // half a chunk
        *reinterpret_cast<uint2*>(at) = *reinterpret_cast<uint2*>(vals);
      }
    }
  };

  long long z = blockIdx.x;
  if (z < p.n_tiles) load(z);
  for (; z < p.n_tiles; z += gridDim.x) {
    stage();
    __syncthreads();
    if (z + gridDim.x < p.n_tiles) load(z + gridDim.x);  // in flight while this tile is reduced
    for (int r = warp; r < QE_ROWS; r += QE_THREADS / 32) {
      int t, b;
      qe_row<TIME_CONTIG>(p, z, r, t, b);
      if (t < 0) continue;  // warp-uniform
      uint4 chunk[DWMAX / 256];
      float amax = 0.0f;
#pragma unroll
      for (int h = 0; h < DWMAX / 256; ++h) {
        const int k = 8 * (lane + 32 * h);
        chunk[h] = make_uint4(0u, 0u, 0u, 0u);
        if (k < DW) chunk[h] = *reinterpret_cast<const uint4*>(tile + qe_at<VEC>(r, k, DW));
        const bf16* x = reinterpret_cast<const bf16*>(&chunk[h]);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__bfloat162float(x[e])));
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      amax = fmaxf(amax, 1e-8f);
      const float mult = bf_round(__fdiv_rn(127.0f, amax));
      const long long row = (long long)t * p.B + b;
#pragma unroll
      for (int h = 0; h < DWMAX / 256; ++h) {
        const int k = 8 * (lane + 32 * h);
        if (k >= DW) break;
        const bf16* x = reinterpret_cast<const bf16*>(&chunk[h]);
        uint32_t qw[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float prod = bf_round(__fmul_rn(__bfloat162float(x[e]), mult));
          const uint32_t qb = (uint32_t)(uint8_t)(signed char)(int)fminf(fmaxf(rintf(prod), -127.0f), 127.0f);
          qw[e >> 2] |= qb << (8 * (e & 3));
        }
        *reinterpret_cast<uint4*>(p.enc + row * DW + k) = chunk[h];
        *reinterpret_cast<uint2*>(p.q + row * DW + k) = make_uint2(qw[0], qw[1]);
      }
      if (lane == 0) p.r[row] = __fmul_rn(amax, kInv127);
    }
    __syncthreads();  // the tile is read before the next one is staged over it
  }
}

typedef void (*QuantEncKernel)(QuantEncParams);
template <typename T>
QuantEncKernel quant_enc_of(bool time_contig, bool wide) {
  if (wide) return time_contig ? quant_enc_kernel<T, true, QE_MAX_DW> : quant_enc_kernel<T, false, QE_MAX_DW>;
  return time_contig ? quant_enc_kernel<T, true, 256> : quant_enc_kernel<T, false, 256>;
}

__global__ void __launch_bounds__(THREADS) barrier_probe_kernel(unsigned long long* bar, int iters) {
  unsigned long long target = 0;
  for (int i = 0; i < iters; ++i) grid_barrier(bar, target);
}

// philox_uniform_kernel: out[row, lane] = uniform_from_bits(philox_bits(lane,
// row, t, draw, seed)), bit for bit, the generator that fastgen_persistent's
// sampler draws from.  Replaces the TPU's hardware PRNG check
// (benchmarks/tpu_kernel_parity.py:141, check_prng), which has no
// counterpart on this card: this is the port's own stream.
//
// What bounds it: each value is one Philox4x32-10 of which word 0 is kept, and
// 4 bytes written.  Written out, the rounds need 18 32x32->64 products and 19
// three-input XORs a value; at 64 products and 64 logic results a clock an SM
// (132 SMs at 1.98 GHz) that is 0.072 / 0.076 ms for [65536, 1024], against
// 0.0801 ms for its 256 MiB at 3.35 TB/s: the bytes and the integer pipes bind
// together.  On this card IMAD.WIDE and IMAD.HI issue at about half IMAD's
// rate (development measurements), so products on the integer pipe alone
// would take longer than the bytes.  (philox_bits, which the sampler runs,
// is left as it is.)
//
// The design takes work off the integer pipe:
//  * the round keys come in as parameters (PhiloxArgs, from the host's
//    philox_round_keys); round 1's product M1 * t, the same for every value,
//    is folded into three words on the host (PhiloxArgs::row_key, ...);
//  * through round 3 a word depends on the lane alone or the row alone: round
//    1's product and round 2's M1 product and round 3's M0 product are the
//    lane's (4 words a lane kept, made again only when a thread's lanes
//    change, never on the [rows, 1024] walk), round 2's M0 product is the
//    row's (one for the thread's 4 values);
//  * rounds 8-10 make only what word 0 needs: round 10 the high half of one
//    product and one XOR, round 9 one high and one low half, round 8 one
//    product and one high half;
//  leaving 10 full products, 4 halves and 15 XORs a value.
//  * From round 3 on, a high half comes from the FP64 pipe, idle otherwise
//    (hi_of): a word a is carried as the double 2^84 + a * 2^32 (low word a,
//    high word kPhiloxHiWord), and fma_rz(that, M * 2^-32, 2^84 - M * 2^52)
//    is exactly 2^84 + a * M rounded toward zero onto the 2^32 grid of
//    [2^84, 2^85): its low word is hi(a * M) and its high word again
//    kPhiloxHiWord, so the next XOR writes the low word in place.  A low
//    half is one IMAD.  13 DFMA, 11 IMAD and 15 LOP3 a value.
//  * A thread takes a unit of 4 neighbouring lanes of a row (4 independent
//    chains, one 16-byte streaming store) and walks units with a grid stride
//    from a persistent grid (a few blocks an SM); row and unit lane carry
//    forward in 32 bits, with one division a thread.  A lane count that 4
//    does not divide leaves the last unit of a row short: it is stored value
//    by value and nothing is padded.
struct PhiloxArgs {
  float* out;
  uint32_t lanes, groups;          // lanes a row; units a row, ceil(lanes / 4)
  uint32_t units;                  // rows * groups (< 2^31)
  uint32_t step_rows, step_groups; // a grid stride (gridDim.x * PHILOX_THREADS units) as rows and units
  uint32_t k0[10], k1[10];         // round keys
  uint32_t row_key;                // round 1: c0 = row ^ hi(M1 t) ^ k0[0]
  uint32_t t_key;                  // round 2: c0 = hi1 ^ lo(M1 t) ^ k0[1]
  uint32_t draw_key;               // round 1: c2 = hi(M0 lane) ^ draw ^ k1[0]
};

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr int PHILOX_THREADS = 256;  // a block; ops/fastgen_kernel.py PHILOX_THREADS
constexpr int kPhiloxHiWord = 0x45300000;  // high word of 2^84 + a * 2^32, a < 2^32

__device__ __forceinline__ void mul_wide(uint32_t a, uint32_t m, uint32_t& hi, uint32_t& lo) {
  const uint64_t p = (uint64_t)m * a;
  hi = (uint32_t)(p >> 32);
  lo = (uint32_t)p;
}

// a word carried as the double 2^84 + a * 2^32, and back
__device__ __forceinline__ double as_carried(uint32_t a) { return __hiloint2double(kPhiloxHiWord, (int)a); }
__device__ __forceinline__ uint32_t word_of(double x) { return (uint32_t)__double2loint(x); }
// x with its word replaced (the high word kept where it lies)
__device__ __forceinline__ double with_word(double x, uint32_t a) {
  return __hiloint2double(__double2hiint(x), (int)a);
}

// the carried hi(a * M) of a carried a, for M = kPhiloxM0 (M1 false) or kPhiloxM1
template <bool M1>
__device__ __forceinline__ double hi_of(double a) {
  constexpr double m = (M1 ? kPhiloxM1 : kPhiloxM0);
  return __fma_rz(a, m * 0x1p-32, 0x1p84 - m * 0x1p52);
}

__global__ void __launch_bounds__(PHILOX_THREADS, 1) philox_uniform_kernel(const __grid_constant__ PhiloxArgs a) {
  uint32_t u = blockIdx.x * PHILOX_THREADS + threadIdx.x;
  if (u >= a.units) return;
  const uint32_t step = gridDim.x * PHILOX_THREADS;
  uint32_t row = u / a.groups, g = u % a.groups;
  uint32_t have = 0xFFFFFFFFu;  // the unit lane whose words L1-L4 hold
  uint32_t L1[4], L2[4], L3[4], L4[4];
  for (; u < a.units; u += step) {
    if (g != have) {  // lane words: rounds 1-3 as far as the lane alone decides them
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t h, l, h2, l2;
        mul_wide(4 * g + j, kPhiloxM0, h, l);     // round 1, M0 * lane
        L1[j] = l ^ a.k1[1];                      // round 2: c2 = hi(M0 c0) ^ c3 ^ k1[1]
        mul_wide(h ^ a.draw_key, kPhiloxM1, h2, l2);  // round 2, M1 * c2
        L2[j] = l2 ^ a.k0[2];                     // round 3: c0 = hi(M1 c2) ^ c1 ^ k0[2]
        mul_wide(h2 ^ a.t_key, kPhiloxM0, h, l);  // round 3, M0 * c0
        L3[j] = h ^ a.k1[2];                      // round 3: c2 = hi(M0 c0) ^ c3 ^ k1[2]
        L4[j] = l;                                // round 3: c3
      }
      have = g;
    }
    uint32_t rh, rl;  // the row's round-2 M0 product
    mul_wide(row ^ a.row_key, kPhiloxM0, rh, rl);
    double c0[4], c2[4];  // carried
    uint32_t c1[4], c3[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // round 3
      const uint32_t c2_2 = rh ^ L1[j];
      const double h = hi_of<true>(as_carried(c2_2));
      c0[j] = with_word(h, word_of(h) ^ L2[j]);
      c1[j] = c2_2 * kPhiloxM1;
      c2[j] = as_carried(L3[j] ^ rl);
      c3[j] = L4[j];
    }
#pragma unroll
    for (int r = 3; r < 7; ++r) {  // rounds 4-7 in full
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double h0 = hi_of<false>(c0[j]), h1 = hi_of<true>(c2[j]);
        const uint32_t l0 = word_of(c0[j]) * kPhiloxM0, l1 = word_of(c2[j]) * kPhiloxM1;
        c0[j] = with_word(h1, word_of(h1) ^ c1[j] ^ a.k0[r]);
        c1[j] = l1;
        c2[j] = with_word(h0, word_of(h0) ^ c3[j] ^ a.k1[r]);
        c3[j] = l0;
      }
    }
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double h0 = hi_of<false>(c0[j]), h1 = hi_of<true>(c2[j]);  // round 8: c1 is not needed
      const uint32_t l0 = word_of(c0[j]) * kPhiloxM0;
      const double c0_8 = with_word(h1, word_of(h1) ^ c1[j] ^ a.k0[7]);
      const uint32_t c2_8 = word_of(h0) ^ c3[j] ^ a.k1[7];
      const double h = hi_of<false>(c0_8);  // round 9: c2 and c1 alone
      const double c2_9 = with_word(h, word_of(h) ^ l0 ^ a.k1[8]);
      const uint32_t c1_9 = c2_8 * kPhiloxM1;
      v[j] = uniform_from_bits(word_of(hi_of<true>(c2_9)) ^ c1_9 ^ a.k0[9]);  // round 10: word 0
    }
    const uint32_t at = row * a.lanes + 4 * g;
    if ((a.lanes & 3u) == 0) {
      __stcs(reinterpret_cast<float4*>(a.out + at), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < a.lanes) __stcs(a.out + at + j, v[j]);
    }
    g += a.step_groups;  // advance by the grid stride, carrying the unit lane into the row
    row += a.step_rows;
    if (g >= a.groups) {
      g -= a.groups;
      ++row;
    }
  }
}

// every instantiation of the library's probe (KERNEL_PROBE) by its mode codes [ActMode][RsMode]
typedef void (*GenKernel)(FastgenArgs);
constexpr int kProbe = KERNEL_PROBE;
GenKernel const kGen[3][3] = {
    {fastgen_persistent<ACT_BF16, RS_BF16, kProbe>, fastgen_persistent<ACT_BF16, RS_STATIC, kProbe>,
     fastgen_persistent<ACT_BF16, RS_ROW, kProbe>},
    {fastgen_persistent<ACT_STATIC, RS_BF16, kProbe>, fastgen_persistent<ACT_STATIC, RS_STATIC, kProbe>,
     fastgen_persistent<ACT_STATIC, RS_ROW, kProbe>},
    {fastgen_persistent<ACT_ROW, RS_BF16, kProbe>, fastgen_persistent<ACT_ROW, RS_STATIC, kProbe>,
     fastgen_persistent<ACT_ROW, RS_ROW, kProbe>}};

bool valid_mode(int act, int rs) { return act >= ACT_BF16 && act <= ACT_ROW && rs >= RS_BF16 && rs <= RS_ROW; }

}  // namespace

// info[0..5]: blocks per SM, SMs, registers a thread, local (spill) bytes a
// thread, static shared bytes, max dynamic shared bytes the card allows
extern "C" int fastgen_grid(int act_mode, int rs_mode, int smem_bytes, int device, int* info) {
  if (!valid_mode(act_mode, rs_mode)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const GenKernel k = kGen[act_mode][rs_mode];
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, optin = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = (int)attr.sharedSizeBytes;
  info[5] = optin;
  return 0;
}

extern "C" int fastgen_generate(const FastgenArgs* args, int* launched) {
  const FastgenArgs& a = *args;
  if (!valid_mode(a.act_mode, a.rs_mode) || a.grid <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const GenKernel k = kGen[a.act_mode][a.rs_mode];
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  FastgenArgs copy = a;
  void* params[] = {&copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k), dim3(a.grid), dim3(THREADS), params,
                                    (size_t)a.smem_bytes, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[0];
  return (int)err;
}

// The int8 modes' conditioning pre-pass (quant_enc_kernel) over a window of
// C x B rows of DW values: src its element (0, 0, 0), bf16 (src_f32 = 0) or
// f32, with element strides st (time step), sb (batch row) and sk (channel);
// time_contig: st == 1 (the channels layout), else sk == 1 (the rows
// layout).  Writes enc [C, B, DW] bf16, q [C, B, DW] int8 and r [C, B] f32,
// all contiguous.  launched[0] counts the launch.
extern "C" int fastgen_quant_enc(const void* src, int src_f32, int time_contig, long long st,
                                 long long sb, long long sk, int C, int B, int DW, void* enc, void* q,
                                 void* r, int device, void* stream, int* launched) {
  const int es = src_f32 ? 4 : 2;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  // the strides that move between 16-byte vectors must keep them aligned
  const bool aligned =
      time_contig ? (st == 1 && addr % es == 0 && (B == 1 || (sb * es) % 16 == 0) && (sk * es) % 16 == 0)
                  : (sk == 1 && addr % 16 == 0 && (C == 1 || (st * es) % 16 == 0) &&
                     (B == 1 || (sb * es) % 16 == 0));
  if (C < 1 || B < 1 || DW < 8 || DW % 8 || DW > QE_MAX_DW || !aligned) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  QuantEncParams p;
  p.src = src;
  p.st = st;
  p.sb = sb;
  p.sk = sk;
  p.enc = static_cast<bf16*>(enc);
  p.q = static_cast<signed char*>(q);
  p.r = static_cast<float*>(r);
  p.C = C;
  p.B = B;
  p.DW = DW;
  p.mis = time_contig ? (int)((addr % 16) / es) : 0;
  p.tiles_per_row = (C + p.mis + QE_ROWS - 1) / QE_ROWS;
  p.n_tiles = time_contig ? (long long)B * p.tiles_per_row
                          : ((long long)C * B + QE_ROWS - 1) / QE_ROWS;
  const QuantEncKernel k = src_f32 ? quant_enc_of<float>(time_contig != 0, DW > 256)
                                   : quant_enc_of<bf16>(time_contig != 0, DW > 256);
  const int smem = QE_ROWS * DW * 2;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, QE_THREADS, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = std::min<long long>(p.n_tiles, (long long)std::max(per_sm, 1) * sms);
  k<<<(unsigned)grid, QE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[0];
  return (int)err;
}

// iters empty grid barriers on grid blocks of THREADS, for timing one barrier
extern "C" int fastgen_barrier_probe(int grid, int iters, void* bar, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* b = static_cast<unsigned long long*>(bar);
  void* params[] = {&b, &iters};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_probe_kernel), dim3(grid),
                                    dim3(THREADS), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// blocks of philox_uniform_kernel an SM can hold (the persistent grid's factor)
extern "C" int philox_blocks_per_sm(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, philox_uniform_kernel, PHILOX_THREADS, 0);
}

// plan: lanes, groups, units, step_rows, step_groups, grid (ops/fastgen_kernel.py philox_plan);
// keys: the ten round keys (k0, k1) in order (philox_round_keys)
extern "C" int philox_uniform(float* out, const unsigned* plan, int t, int draw, const unsigned* keys,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  PhiloxArgs a;
  a.out = out;
  a.lanes = plan[0];
  a.groups = plan[1];
  a.units = plan[2];
  a.step_rows = plan[3];
  a.step_groups = plan[4];
  for (int r = 0; r < 10; ++r) {
    a.k0[r] = keys[2 * r];
    a.k1[r] = keys[2 * r + 1];
  }
  const uint64_t pt = (uint64_t)kPhiloxM1 * (uint32_t)t;  // round 1's product, the same for every value
  a.row_key = (uint32_t)(pt >> 32) ^ a.k0[0];
  a.t_key = (uint32_t)pt ^ a.k0[1];
  a.draw_key = (uint32_t)draw ^ a.k1[0];
  philox_uniform_kernel<<<plan[5], PHILOX_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* fastgen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
