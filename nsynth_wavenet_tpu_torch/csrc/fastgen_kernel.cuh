// Shared declarations of the autoregressive generation kernels
// (fastgen_kernel.cu) and their plain-C entry points, loaded with ctypes by
// nsynth_wavenet_tpu_torch/ops/fastgen_kernel.py.  The Python side mirrors
// FastgenArgs field for field (ctypes.Structure _FastgenArgs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum HeadType { HEAD_CE = 0, HEAD_MOL = 1, HEAD_GAUSS = 2 };

// How the residual stream enters the gate product (act_mode) and how the gate
// enters the res/skip product (rs_mode); the codes are those of _MODE_CODES in
// ops/fastgen_kernel.py.
//   ACT_BF16    bf16 w_comb, bf16 ring rows of W.
//   ACT_STATIC  int8 w_comb (k4 layout), l quantised with calibrated per-layer
//               scales, int8 ring rows of W.
//   ACT_ROW     int8 w_comb, l quantised per batch row with a scale 2^(e/8)
//               (log8 code e, see Log8); int8 ring rows
//               of W + ROW_LANES bytes: W payload bytes, then the code in lane W.
//   RS_BF16     bf16 w_rs, bf16 gate.
//   RS_STATIC   int8 w_rs, int8 gate rint(gate * 127), 1/127 folded into s_rs.
//   RS_ROW      int8 w_rs, f32 gate quantised per batch row where it is read.
// The head matrices are bf16 in every mode.
enum ActMode { ACT_BF16 = 0, ACT_STATIC = 1, ACT_ROW = 2 };
enum RsMode { RS_BF16 = 0, RS_STATIC = 1, RS_ROW = 2 };
// The perf probes (make_generate_fn's probe=, reference :325-331): each is a
// variant of every kernel, compiled into a library of its own
// (kernels/build.py PROBES, -DKERNEL_PROBE=code), whose fastgen_generate and
// fastgen_grid launch and describe that variant.  Their output is wrong by
// design: they take work away to time it.
//   PROBE_CHEAP_GATE     clip(dpre[:m], 0, 1) * clip(dpre[m:], -1, 1) in place of
//                        sigmoid * tanh, in every mode (reference :572-577)
//   PROBE_NO_RING_WRITE  no layer writes its ring row: the ring keeps what it held
//                        when the call began (reference :619-633, :643-646)
enum Probe { PROBE_NONE = 0, PROBE_CHEAP_GATE = 1, PROBE_NO_RING_WRITE = 2 };
constexpr int LOG8_MIN = -120, LOG8_MAX = 126;  // range of the log8 exponent code
constexpr int ROW_LANES = 16;                   // bytes behind the payload of an ACT_ROW ring row

// 2^(k/8) for k = 0..7 as f32: every log8 scale 2^(e/8) and multiplier 2^(-e/8)
// is one of these times a whole power of two (log8_pow in fastgen_kernel.cu,
// log8_tables in ops/fastgen_kernel.py).
struct Log8 {
  float frac[8];
};

struct FastgenArgs {
  // packed weights (ops/fastgen_kernel.py build_kernel_weights), f32 biases
  const void* w_comb;   // bf16 [NL, 3W+DW, GW]: dilated taps (t-2d, t-d, t) stacked over the mel-cond 1x1;
                        // int8: [NL, (3W+DW)/4, GW, 4], four consecutive k of a column in one word
  const void* b_comb;   // [NL, GW] f32
  const void* w_rs;     // bf16 [NL, m, W+S]: res | skip 1x1; int8: [NL, m/4, W+S, 4]
  const void* b_rs;     // [NL, W+S] f32
  // scales (null where the mode has none)
  const void* s_comb;     // [NL, GW] f32 per-column scales of an int8 w_comb
  const void* s_main;     // ACT_STATIC: [NL, GW] f32 (act_amax/127) * s_comb, dequantises the 3W part in one multiply
  const void* s_rs;       // [NL, W+S] f32 per-column scales of an int8 w_rs; RS_STATIC: already divided by 127
  const void* s_act_inv;  // ACT_STATIC: [NL] f32 127 / act_amax, quantises l entering layer i
  const void* w_start;  // [3, W] f32 conv_start taps
  const void* b_start;  // [W] f32
  const void* w_skip0;  // [W, S] bf16
  const void* b_skip0;  // [S] f32
  const void* w_out1;   // [S+DW, S] bf16, out1 stacked over the out1 mel-cond
  const void* b_out1;   // [S] f32
  const void* w_out2;   // [S, out_pad] bf16, head columns padded to 16
  const void* b_out2;   // [out_pad] f32 (padded logit lanes at -1e9)
  // inputs
  const void* enc;      // [L, B, DW] bf16 upsampled conditioning, offset-trimmed
  const void* tf;       // [L, B] f32 teacher-forced feedback, or null
  // carried state (zeros for a fresh utterance, else the previous chunk's; updated in place)
  void* lbuf;           // [sum(2d), B, lrow] ring buffers of every layer's input: bf16 rows of W,
                        // ACT_STATIC int8 rows of W at layer i's scale, ACT_ROW int8 rows of W + ROW_LANES
  void* xh;             // [3, B] f32 input taps x(t-2), x(t-1), x(t)
  // scratch (allocated by the wrapper; l, s and the layer-0 operand are rebuilt from xh at the start of a call)
  void* l;              // [B, W] f32 residual stream
  void* l_bf;           // [B, W] bf16 copy of l: ACT_BF16's current-row operand, every mode's skip_start operand
  void* q_l;            // ACT_STATIC: [B, W] int8 l quantised at the current layer's scale
  void* q_enc;          // int8 act: [L, B, DW] int8 per-row quantised conditioning (written by the pre-pass)
  void* r_enc;          // int8 act: [L, B] f32 its per-row scales
  void* lmax;           // ACT_ROW: [NL, W/32, B] f32: per res column item, max|l| entering layer i
  void* gmax;           // RS_ROW: [NL, m/gate_cols, B] f32: per gate column item, max|gate| of layer i
                        // (every slot is rewritten in every step before it is read)
  void* s;              // [B, S] f32 skip sum
  void* s_bf;           // [B, S] bf16 relu(s) after the last layer: the out1 operand
  void* o1;             // [B, S] bf16 relu(out1): the out2 operand
  void* outv;           // [B, out_pad] f32 head output of the current step
  void* gate;           // [B, m] gated activation of the current layer: bf16, RS_STATIC int8, RS_ROW f32
  void* part;           // split-K partial tiles of the gate product: f32, int8 act int32
  void* counters;       // u32 per (gate column item, row tile), zeroed once per call: its slices' arrivals
  const void* table;    // int32 work table (ops/fastgen_kernel.py schedule)
  void* bar;            // u64 grid-barrier count, zeroed once per call; it only grows
  // outputs
  void* audio;          // [L, B] f32
  void* out_params;     // [L, B, out_pad] f32, or null
  void* stream;         // cudaStream_t (PyTorch's current stream)
  long long seed;
  int device;
  int B, L, W, GW, S, DW, NL, num_stages;
  int out_pad, out_seg, head, use_mu_law, quant_chann, greedy;
  int t0;            // global index of the call's first step: ring phase and random counter run on t0 + t
  int act_mode;      // ActMode
  int rs_mode;       // RsMode
  int combine_bf16;  // ACT_ROW: combine the four dequantised sums in bf16 (every product and sum rounded)
  Log8 log8;         // ACT_ROW: the fractional powers behind every row scale
  int grid;          // blocks of the cooperative launch (all resident at once)
  int stage_bytes;   // bytes of one weight stage in shared memory (schedule)
  int slot_bytes;    // bytes of one A-chunk slot in shared memory (schedule)
  int smem_bytes;    // dynamic shared memory of a block (schedule)
  int table_words;   // ints of the work table, copied to shared memory at the start
};

// Philox4x32-10 (Salmon et al., SC'11), first output word.  Counter
// (lane, batch row, t, draw), key (seed low word, seed high word).
__host__ __device__ inline uint32_t philox_bits(uint32_t c0, uint32_t c1, uint32_t c2,
                                                uint32_t c3, uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// Top 24 bits of an UNSIGNED word -> uniform on [1e-5, 1 - 1e-5].
__host__ __device__ inline float uniform_from_bits(uint32_t bits) {
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return fminf(fmaxf(u, 1e-5f), 0.99999f);
}

extern "C" {
// launched[0] / [1]: one added for each launch of fastgen_persistent /
// quant_enc_kernel this call enqueued
int fastgen_generate(const FastgenArgs* args, int* launched);
int fastgen_grid(int act_mode, int rs_mode, int smem_bytes, int device, int* info);
int fastgen_barrier_probe(int grid, int iters, void* bar, int device, void* stream);
int philox_blocks_per_sm(int device, int* blocks);
int philox_uniform(float* out, const unsigned* plan, int t, int draw, const unsigned* keys, int device,
                   void* stream);
const char* fastgen_error_string(int code);
}
