// One IAF flow's dilated trunk on Hopper (sm_90a): the student's serving kernel.
//
// Replaces the Pallas TPU kernel nsynth_wavenet_tpu/ops/flow_kernel.py
// make_flow_stack_fn (pallas_call at :383, kernel body :184-337) with fused
// taps, time-major streams, one-shot or with a carried state, in every
// conditioning mode the reference takes:
//   ENC_BF16     compact: bf16 encoding and w_cond, the cond product in bf16
//                (:286-294 with mm_dt bf16); also fuse_cond, whose one
//                K = 3W + DW product rounds both to bf16 whatever compact is
//                (:231-252, :283-284);
//   ENC_F32      non-compact: f32 encoding and w_cond, the cond product in
//                full f32 (:285-295 with mm_dt f32);
//   STREAM_BF16  the precomputed-conditioning stream (cond_features = 0,
//   STREAM_F32   :297, :344, :410-412), bf16 when compact, else f32, added
//                after the tap product with the bias b alone.
// Widths W = 32, 64, 128 and 256 (:168-171); any deconv width that is a
// multiple of 8; any number of layers a call (layers_per_call,
// nsynth_wavenet_tpu/models/parallelgen.py:126-136); and the bf16 carries
// (carry_dtype, :104-109, :333-335): a tap is rounded to bf16 at its product
// anyway, so only the exported state changes, rounded to bf16 and held in
// f32.  fuse_taps=False, tile / b_tile and time_major=False compute the same
// function (the wrapper in ops/flow_kernel.py says how).
//
// One call of flow_stack runs n_layers layers over a whole stream.  With l the
// f32 residual stream [L, B, W], row r = t * B + b, and
// d = 2^(layer % num_stages), per layer:
//   a    = bf16([l(t-2d), l(t-d), l(t)])       rows before t = 0: zeros, or the state
//   taps = a @ w_tap[3W, W]                                            f32 sums
//   pre  = taps + enc(t) @ w_cond[DW, W] + (b + b_cond)    (encoding modes)
//   pre  = (taps + cond(t)) + b                            (stream modes)
//   g    = sigmoid(pre[:W/2]) * tanh(pre[W/2:])
//   l'   = l + bf16(g) @ w_res[W/2, W] + b_res
// and, with a state, the layer's new history: the last 2d time steps of
// (old history ++ this call's input to the layer), f32 (rounded to bf16 with
// bf16 carries).  Operands are rounded to bf16 exactly where
// ops/flow_kernel.py flow_stack_plain rounds them; every product sums in f32.
// ENC_BF16 sums taps and cond in one accumulator; the other modes add the
// tap sum, then the cond sum, then the bias, as the plain version does.
//
// What bounds it (W = 64, DW = 256, B = 32 x L = 64 000, a 10-layer call).
// The whole call must read l once and the encoding once and write l once:
// 1 024 B a row, 2.1 GB, 0.63 ms at 3.35 TB/s; its 30 720 MACs a row and
// layer take 1.27 ms at 989 TFLOP/s, so the ideal call is bound by
// operations (1.27 ms; chip_smoke.time_flow computes it).  A design with one
// launch a layer must move l(t) in, the encoding in and l' out for EVERY
// layer: at least 1 024 B a row and layer, 6.26 ms a call at 3.35 TB/s.  The
// f32 conditioning product's 16 384 f32 MACs a row and layer run on the FMA
// units (67 TFLOP/s): 10.61 ms a call.  One launch a call, with the stream and
// the history on chip across layers, does not fit: a 10-layer cycle's
// history is 2 046 steps x B rows x W (8.4 MB in bf16 at B = 32), a block
// has 227 KB.  So a layer is one launch, and the kernel for W = 32 and 64 is
// built to stream at the device's memory rate:
//
//   flow_persist_kernel<W, COND>  (W = 32, 64) one launch a layer of
//     persistent blocks: the grid is the blocks that fit at once (the
//     occupancy API's blocks a SM times the SMs, read by the wrapper), and
//     block b walks the 64-row tiles b, b + grid, ...  It answers the three
//     causes that held the per-block design (flow_layer_kernel) well above
//     torch.mm at W 64 (PERF.md):
//     1. Weights read once a block, not once a tile.  w_tap, w_cond (bf16, or
//        f32 for ENC_F32), w_res and the biases are copied into shared memory
//        when the block starts and stay there (61 952 B at W 64 in bf16,
//        94 720 B with an f32 w_cond).  A deconv width too wide for that is
//        streamed with its encoding columns instead (the plan says which).
//     2. Each row byte read once.  A tile is a sequence of chunks: tap
//        l(t-2d), tap l(t-d), the conditioning columns (encoding chunks or
//        the layer's cond-stream columns), and last l(t), which is both the
//        third tap (rounded to bf16 as it enters the product) and the
//        residual of the epilogue; no row is read twice by its tile.
//     3. An asynchronous ring fed by the copy engine.  A producer warp
//        fills ring slots a chunk at a time with tensor copies (TMA, 2-D
//        boxes of 64 rows x 128 B from tensor maps the host encodes a
//        launch, in the 128-byte swizzle; rows before the stream or past it
//        land as zeros, history rows come from the state's own map),
//        counted on the slot's `full` mbarrier.  Two groups of four
//        consumer warps take alternate tiles, each with its own part of
//        the ring; a group waits on `full`, computes, and frees the slot on
//        its `empty` mbarrier, so that up to `stages` chunks are in flight
//        while the tensor cores and the epilogues work.  The stages and the
//        chunk widths come from the host's plan (ops/flow_kernel.py
//        persist_plan), which keeps every mode within 227 KB.  What was
//        tried on the way is in PERF.md: cp.async from every thread, or one
//        bulk copy a row, streamed no faster than the per-block kernel.
//     Products are mma.sync m16n8k16 bf16 with f32 sums.  wgmma would need
//     the operand tiles in its own shared layout, while the tap operand
//     arrives as f32 and is rounded in registers; PERF.md has what bounds
//     the kernel now.  Each consumer warp owns 16 rows and all W columns,
//     so the gate's sigmoid and tanh halves meet in one thread's
//     accumulators, and the gate, rounded to bf16, is the A operand of the
//     res product straight from registers (no shared round trip).  B
//     operands come from the resident weights by ldmatrix.trans, their rows
//     swizzled at W 64 (padded at W 32) so that no load meets a bank
//     conflict.  ENC_F32's cond product runs on the FMA units in full f32,
//     k in order; a lane owns 16 W / 256 rows x 8 columns there, so each
//     float4 of w_cond read from shared memory serves that many rows (the
//     accumulator layout's two rows a lane would leave the product bound by
//     shared-memory loads), and the sums reach the accumulator layout
//     through the warp's own rows of the l(t) slot once the residual is read.
//     The stream modes read their cond columns into registers when their
//     chunk lands.  A row's arithmetic does not depend on the block, tile or
//     call that computes it, so chained chunk calls equal one-shot calls bit
//     for bit.
//   flow_wide_kernel<W, COND>  (W = 128, 256) one launch a layer of
//     persistent blocks (one an SM: grid = SMs, cut to the tiles), a
//     producer warp feeding a TMA ring as in flow_persist_kernel, two
//     consumer warpgroups, and the products on wgmma.  It replaces the
//     per-block flow_layer_kernel (a block per 64 rows, WMMA through shared
//     memory), which read the whole layer's weights from L2 for every 64
//     rows: at W 256 576 KiB a tile, 9 KiB a row, 36x the rows' own bytes.
//     What bounds a layer (B = 8 x L = 15 872, a 10-layer call): the row
//     bytes, l(t) in f32, the encoding in bf16 and l' out, 1 536 B a row at
//     W 128 and 2 560 B at W 256, 0.58 / 0.97 ms at 3.35 TB/s; the bf16
//     products, 0.23 / 0.76 ms at 989 TFLOP/s; in f32-cond the f32 cond
//     product on the FMA units (32 768 / 65 536 MACs a row and layer,
//     1.39 / 3.07 ms at 67 TFLOP/s).  The design:
//     1. Tiles of 128 rows, rows 0..63 to warpgroup 0 and 64..127 to
//        warpgroup 1, which wait on the same ring slots: each product is an
//        m64nWk16 wgmma (m64n128 for the res product, a panel of 128 output
//        columns at a time) with the A operand in registers (the f32 taps
//        rounded to bf16 as they leave the slot, the bf16 encoding by
//        ldmatrix, the gate) and B a weight box in shared memory, K-major
//        in the copy engine's 128-byte swizzle, so a weight byte in shared
//        memory serves 128 rows.
//     2. A tile is a walk of chunks of 64 K columns: the three taps (two
//        f32 boxes each), the encoding (a bf16 box, or 32 f32 columns), and
//        w_res^T (W/128 boxes, held through the epilogue).  W 128: w_tap^T
//        (96 KiB, six boxes of 128 output columns x 64 K values) stays
//        resident, copied when the block starts; each encoding chunk brings
//        its box of w_cond^T (512 B a row from L2), each tile its w_res^T
//        box; shared memory 98 KiB resident + 4 slots of 32 KiB.  W 256: the
//        weights (576 KiB) do not fit a block, so w_tap^T and w_cond^T ride
//        beside every chunk as wgmma's B operand (a GEMM-style main loop
//        over K = 3W + DW: 576 KiB a 128-row tile, 4.5 KiB a row from L2,
//        half the per-block kernel's 9 KiB); 3 slots of 64 KiB.  A
//        four-CTA cluster holding a quarter of the weights each (multicast
//        row chunks, the res sums reduced through distributed shared
//        memory) would read no weights at all, but needs 64 KiB of partial
//        sums a CTA beside the ring; it is left for later.
//     3. Every chunk of a tile is read by the copy engine from device
//        memory or L2 (l(t-d) and l(t-2d) are L2 hits at the student's
//        shapes); the epilogue reads the residual l(t) from L2 (its tap
//        chunk has just passed) and a cond stream's columns from device
//        memory, in batches whose first is in flight during the res product.
//        Measured (PERF.md), the bf16 calls stream some 4-5 TB/s of such
//        row, weight and residual bytes from L2 and device memory together,
//        which is what bounds them now.
//     4. The sigmoid column j and the tanh column j + W/2 meet in one
//        thread: wgmma's accumulator gives a thread columns 8i + 2 t4 and
//        8i + 2 t4 + 1 of every n8 block i, so blocks j / 8 and j / 8 +
//        W / 16 are its own in the natural column order.  The gate, rounded
//        to bf16, is the A operand of the res product from registers.
//     5. ENC_F32's cond product runs on the FMA units in full f32, k in
//        order, accumulated onto the tap sums in wgmma's accumulator layout
//        (pre = taps + sum_k enc_k w_k + bias: the plain version's terms,
//        its cond sum added in one piece); its w_cond is stored with the
//        columns in wide_cond_order (ops/flow_kernel.py), so that one
//        16-byte shared load serves 8 FMAs a row.
//     Registers: a block of 384 threads (the consumer warpgroups and a
//     producer warpgroup of which one warp works) is held to 168 a thread
//     by the register file; a consumer holds 64 (W 128) or 128 (W 256) f32
//     sums, 16 A-fragment registers a chunk, and 16 / 32 gate fragments
//     beside 64 res sums; setmaxnreg moves registers from the producer
//     warpgroup to the consumers.  Each chunk's wgmmas are committed and
//     waited for before its slot is freed.
//   The state (the carry twins flow_persist_carry_kernel and
//     flow_wide_carry_kernel, launched with a state): a layer's new history,
//     the last 2d time steps of (old history ++ the layer's input), is
//     written by the layer's own trunk launch: in both kernels the producer
//     warp, which waits on the ring most of the time, copies its block's
//     share between ring refills, a round of loads issued as a tile starts
//     and stored as the next one starts (Carry); what its rounds leave (a
//     call shorter than the history is long) every warp of the block copies
//     once its tiles are done.  (Giving the copy to the three idle warps of
//     flow_wide_kernel's producer warpgroup instead made the stateful call
//     slower at W 128 / 256 in a development check.)  It replaces flow_state_kernel,
//     a launch a layer of its own after the trunk: a stateful call launched
//     2 n_layers kernels, a one-shot call n_layers, and most of those copies
//     move a few KB to a few MB, so they cost a launch each rather than
//     their bytes (2 x 2 046 x B x W x 4 B a 10-layer call: 33.5 MB, 10 us
//     at 3.35 TB/s at B = 32, W = 64).  The twins are the trunk kernels'
//     bodies (persist_layer, wide_layer) with CARRY set; the one-shot
//     entry points instantiate them with CARRY clear, where the copy
//     compiles away.
// A layer never updates l in place (other blocks still read rows t-d and
// t-2d of its input): flow_stack alternates between two buffers so that the
// last layer writes out.  flow_stack counts every launch it enqueues, by
// kernel.  Measured times are in PERF.md.  Left on the table: several layers a
// launch with the small-dilation history on chip, wgmma at W 32 / 64, a
// four-CTA cluster at W 256, overlapping one chunk's wgmmas with the next
// chunk's A fragments, the f32 cond product on tensor cores (it must pass
// the f32 precision probe of chip_smoke.py).

#ifndef FLOW_WARPS
#error "build through nsynth_wavenet_tpu_torch/kernels/build.py: it passes the launch plan's constants"
#endif

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Mirrored field for field by ops/flow_kernel.py _FlowArgs.
struct FlowArgs {
  const void* x;       // [L, B, W] f32 input stream
  const void* cond;    // encoding [L, B, DW] or stream [L, B, n_layers * W], bf16 or f32 by mode
  const void* w_tap;   // [n_layers, 3, W, W] bf16, tap 0 = t-2d (W 128 / 256: [n_layers, W, 3W])
  const void* w_cond;  // [n_layers, DW, W] bf16 (ENC_BF16) or f32 (ENC_F32); null for a stream
                       // (W 128 / 256: bf16 [n_layers, W, DW], f32 in wide_cond_order)
  const void* bias;    // [n_layers, W] f32: b + b_cond with an encoding, b with a stream
  const void* w_res;   // [n_layers, W/2, W] bf16 (W 128 / 256: [n_layers, W, W/2])
  const void* b_res;   // [n_layers, W] f32
  const void* state;   // [sum(2d), B, W] f32 carried history, or null (zeros)
  void* new_state;     // [sum(2d), B, W] f32, or null
  void* tmp;           // [L, B, W] f32 second stream buffer (null when n_layers == 1)
  void* out;           // [L, B, W] f32
  void* stream;        // cudaStream_t (PyTorch's current stream)
  int device;
  int L, B, W;
  int cond_cols;       // columns of a cond row: DW, or n_layers * W for a stream
  int n_layers, first_layer, num_stages;
  int cond_mode;       // CondMode
  int carry_bf16;      // round the exported state to bf16
  // the trunk kernel's launch plan (ops/flow_kernel.py persist_plan and
  // persist_args at W 32 / 64, wide_plan and wide_args at W 128 / 256)
  int grid;
  int n_tiles;         // row tiles of the stream, the last one ragged: blocks walk b, b + grid, ...
  int smem_bytes, stages, slot_bytes;
  int enc_cols;        // conditioning columns a chunk (encoding modes)
  int wc_resident;     // w_cond resident in shared memory, else streamed with its chunk
  int off_w_cond, off_w_res, off_bias, off_bars, off_ring, off_wchunk;  // byte offsets in shared memory
};

enum CondMode { ENC_BF16 = 0, ENC_F32 = 1, STREAM_BF16 = 2, STREAM_F32 = 3 };
// The perf probes (make_flow_stack_fn's probe=, reference :132-138): each is a
// variant of every trunk kernel, compiled into a library of its own
// (kernels/build.py PROBES, -DKERNEL_PROBE=code) whose entry points launch and
// describe that variant.  Their output is wrong by design: they take work away
// to time it.
//   PROBE_NO_GATE   clip(pre[:W/2], 0, 1) * clip(pre[W/2:], -1, 1) in place of
//                   sigmoid * tanh (reference :303-306)
//   PROBE_NO_SLIDE  the two dilated taps are not loaded: l(t) is read once and
//                   multiplies all three tap bands of w_tap.  The reference's
//                   no_slide (:323-328) skips the copies that slide its VMEM
//                   carry window; this port keeps no such window (each tile's
//                   taps come from the layer's input stream by the copy
//                   engine), so its counterpart drops those loads instead.
enum FlowProbe { PROBE_NONE = 0, PROBE_NO_GATE = 1, PROBE_NO_SLIDE = 2 };
// the probe whose variant this library builds: none in the serving library
#ifndef KERNEL_PROBE
#define KERNEL_PROBE PROBE_NONE
#endif
// flow_stack's launched[]: ops/flow_kernel.py KERNEL_NAMES
enum KernelId { K_PERSIST = 0, K_WIDE = 1 };

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// PROBE_NO_GATE's gate: clip(xs, 0, 1) * clip(xt, -1, 1) in place of sigmoid(xs) * tanh(xt)
__device__ __forceinline__ float clip_gate(float xs, float xt) {
  return __fmul_rn(fminf(fmaxf(xs, 0.0f), 1.0f), fminf(fmaxf(xt, -1.0f), 1.0f));
}

// With a state, a layer's new history: the last 2 * shift rows (2d time
// steps of B rows) of (old history ++ the layer's input), f32, rounded to
// bf16 for bf16 carries.  The trunk launch of the layer writes it (the carry
// twins of the trunk kernels): neither source is written by that launch
// (flow_stack alternates the stream buffers, and old and new state are
// different buffers), so any block may copy any rows at any time.  Block b
// of the grid copies float4s [b n / grid, (b + 1) n / grid) of the n of the
// history, in rounds of CARRY_VECS a thread: a round's loads land in
// registers and are stored by a later call, so that the loads of a round
// fly while the copying warp does other work.  Loads and stores are
// streaming (evict first): the copy passes through L2 beside the rows the
// layer's dilated taps read back from it.
// The producer warp takes a round a tile between its ring refills; what a
// block's tiles leave (a call shorter than the history is long, where one
// warp an SM would take longer than the layer) is copied by its producer
// and consumer warps together once each is done with its tiles (carry_rest).
struct CarryArgs {
  float* new_hist;  // the layer's rows of new_state, or null
  int round;        // round to bf16 (bf16 carries)
};

constexpr int CARRY_VECS = 4;  // float4s a thread holds a round

template <int W>
struct Carry {
  const float* l_in;
  const float* hist;
  float* out;
  long long n_rows, hist_rows, next, end;
  bool round;
  float4 v[CARRY_VECS];

  __device__ __forceinline__ Carry(const float* l_in_, const float* hist_, const CarryArgs& cc,
                                   long long n_rows_, long long shift)
      : l_in(l_in_), hist(hist_), out(cc.new_hist), n_rows(n_rows_), hist_rows(2 * shift),
        round(cc.round != 0) {
    const long long n = hist_rows * (W / 4);
    next = n * blockIdx.x / gridDim.x;
    end = n * (blockIdx.x + 1) / gridDim.x;
  }

  __device__ __forceinline__ bool more() const { return next < end; }

  // The first `rounds` rounds of 32 threads (lead) or what follows them.
  __device__ __forceinline__ void split(int rounds, bool lead) {
    const long long cut = min(end, next + (long long)rounds * 32 * CARRY_VECS);
    if (lead)
      end = cut;
    else
      next = cut;
  }

  // float4 i of the new history: row n_rows + i / (W / 4) of (hist ++ l_in)
  __device__ __forceinline__ float4 fetch(long long i) const {
    const long long pos = n_rows + i / (W / 4);
    const float* row = pos < hist_rows ? hist + pos * W : l_in + (pos - hist_rows) * W;
    return __ldcs(reinterpret_cast<const float4*>(row) + i % (W / 4));
  }

  // the round from next on: thread t of `threads` loads float4s next + t + i threads
  __device__ __forceinline__ void load(int t, int threads) {
#pragma unroll
    for (int i = 0; i < CARRY_VECS; ++i) {
      const long long k = next + t + (long long)i * threads;
      if (k < end) v[i] = fetch(k);
    }
  }

  __device__ __forceinline__ void store(int t, int threads) {
#pragma unroll
    for (int i = 0; i < CARRY_VECS; ++i) {
      const long long k = next + t + (long long)i * threads;
      if (k < end) {
        float4 x = v[i];
        if (round) {
          x.x = bf16_round(x.x);
          x.y = bf16_round(x.y);
          x.z = bf16_round(x.z);
          x.w = bf16_round(x.w);
        }
        __stcs(reinterpret_cast<float4*>(out) + k, x);
      }
    }
    next += (long long)threads * CARRY_VECS;
  }
};

// ---------------------------------------------------------------------------
// flow_persist_kernel: W = 32 and 64
// ---------------------------------------------------------------------------

constexpr int PW = FLOW_WARPS;          // consumer warps of a persistent block
constexpr int PG = FLOW_GROUPS;         // consumer groups: group i takes the block's tiles i, i + PG, ...
constexpr int PBM = FLOW_TILE_ROWS;     // rows of a tile: one 16-row band a warp of a group
constexpr int PT = 32 * (PW + 1);       // threads: the consumers and one producer warp
static_assert(PBM * PG == 16 * PW, "one m16 row band a consumer warp");

constexpr int BOX = PBM * 128;         // bytes of a copy box: a tile's rows of 128 B

// What a one-shot instantiation holds in Carry's place: nothing, so that its
// code is the trunk kernel's alone.
struct NoCarry {
  __device__ __forceinline__ NoCarry(const float*, const float*, const CarryArgs&, long long, long long) {}
  __device__ __forceinline__ void split(int, bool) {}
  __device__ __forceinline__ void load(int, int) {}
  __device__ __forceinline__ void store(int, int) {}
};

template <bool CARRY, int W>
struct CarryOf {
  typedef NoCarry type;
};
template <int W>
struct CarryOf<true, W> {
  typedef Carry<W> type;
};

// The part of the block's share that its producer warp's rounds (one a tile,
// `tiles` of them) leave, by the block's PT producer and consumer threads,
// t this one's index.
template <int W>
__device__ __forceinline__ void carry_rest(const float* l_in, const float* hist, const CarryArgs& cc,
                                           long long n_rows, long long shift, int tiles, int t) {
  Carry<W> rest(l_in, hist, cc, n_rows, shift);
  rest.split(tiles, false);
  while (rest.more()) {
    rest.load(t, PT);
    rest.store(t, PT);
  }
}

struct PersistParams {
  const float* l_in;
  const float* hist;    // the layer's 2 * shift history rows, or null (zeros)
  const bf16* w_tap;    // [3W, W]
  const void* w_cond;   // [DW, W], null for a stream
  const float* bias;    // [W]
  const bf16* w_res;    // [W/2, W]
  const float* b_res;   // [W]
  float* l_out;
  long long shift;      // d * B rows
  int n_rows, n_tiles, cond_col0, DW;  // cond_col0: the layer's first cond-stream column
  int stages, slot_bytes, enc_cols, wc_resident;
  int off_w_cond, off_w_res, off_bias, off_ring, off_wchunk, off_bars;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// bytes (a multiple of 16) global -> shared by the copy engine, counted on mbar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// one box of a 2-D tensor map (x: column, y: row; rows and columns outside
// the tensor, negative ones too, land as zeros) into shared memory, counted on mbar
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y, unsigned mbar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(mbar)
      : "memory");
}

// Byte offset of element (row, col) of a chunk in a ring slot.  A chunk is
// boxes of 128 rows x 128 B (128 / ES columns each) side by side, each
// written by the copy engine with the 128-byte swizzle: the 16-byte piece c
// of row r sits at piece c ^ (r % 8), so that the eight rows of a fragment
// load fall in distinct banks.
template <int ES>
__device__ __forceinline__ int sw(int row, int col) {
  constexpr int BC = 128 / ES;
  const int b = (col % BC) * ES;
  return (col / BC) * BOX + row * 128 + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void mbar_init(unsigned mbar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar), "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` of mbar has completed; a wait that
// never ends (a fault) traps after 2^27 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 27)) __trap();
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Element offset of weight (k, n) of a [K][W] bf16 matrix in shared memory.
// At W 64 a row is 128 B and its 16-byte pieces are swizzled by k % 8, so
// that the eight rows an ldmatrix reads fall in distinct banks without
// padding; at W 32 rows are padded to 40 elements instead.
template <int W>
__device__ __forceinline__ int wo(int k, int n) {
  if constexpr (W == 64)
    return k * 64 + ((((n >> 3) ^ k) & 7) << 3) + (n & 7);
  else
    return k * (W + 8) + n;
}

// The element offsets, from a step's row k0 (a multiple of 16, so that
// k0 % 8 == 0 leaves the swizzle alone), of the rows a lane addresses in the
// ldmatrix.trans loads of one k16 step over all W columns: one a pair of n-tiles.
template <int W>
struct BLanes {
  int off[W / 16];
  __device__ explicit BLanes(int lane) {
    const int k = (lane & 7) + ((lane >> 3) & 1) * 8, n = (lane >> 4) * 8;
#pragma unroll
    for (int np = 0; np < W / 16; ++np) off[np] = wo<W>(k, n + 16 * np);
  }
};

// acc[n-tile] += a (16 rows x k16) @ w[k0 .. k0 + 16, all W columns], w a
// [K][W] bf16 matrix in shared memory laid out by wo; wk points at its row k0
template <int W>
__device__ __forceinline__ void mma_row_band(float (&acc)[W / 8][4], const unsigned (&a)[4],
                                             const bf16* wk, const BLanes<W>& bl) {
#pragma unroll
  for (int np = 0; np < W / 16; ++np) {
    unsigned b[4];
    ldsm_x4_t(b, wk + bl.off[np]);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// One layer over the stream.  A tile is nch chunks (tap t-2d, tap t-d, the
// conditioning chunks, tap t), each one ring slot; the producer warp (the
// last) walks the block's tiles in order and fills each chunk into the
// ring part (SG slots) of the consumer group whose tile it is, with tensor
// copies of whole boxes counted on the slot's `full` barrier; the group's
// warps (16 rows each) free a slot on its `empty` barrier when they are
// done with it.  map_l is the layer's input
// [n_rows, W] f32 (boxes of 32 columns), map_h its history [2 shift, W] f32
// (a state only), map_c the encoding [n_rows, DW] or the cond stream
// [n_rows, n_layers W] (boxes of 128 / ES columns).
//
// The accumulator layout of m16n8k16: a consumer thread (g = lane / 4,
// t4 = lane % 4) holds, for n-tile j, rows g and g + 8 of its warp's band at
// columns 8j + 2 t4 and 8j + 2 t4 + 1: acc[j] = {(g, c), (g, c + 1), (g + 8, c), (g + 8, c + 1)}.
// CARRY (flow_persist_carry_kernel): the producer warp also writes the
// block's share of the layer's new history (Carry), a round of loads issued
// as each tile starts and stored as the next one starts, so that they fly
// while the producer waits on the ring; what its rounds leave, every warp
// copies once its tiles are done (carry_rest).
template <int W, int COND, int PROBE, bool CARRY>
__device__ __forceinline__ void persist_layer(const PersistParams p, const CUtensorMap& map_l,
                                              const CUtensorMap& map_h, const CUtensorMap& map_c,
                                              const CarryArgs cc) {
  constexpr int M = W / 2, NT = W / 8;
  constexpr bool F32C = COND == ENC_F32;
  constexpr bool STREAM = COND == STREAM_BF16 || COND == STREAM_F32;
  constexpr int ES = COND == ENC_F32 || COND == STREAM_F32 ? 4 : 2;  // cond element bytes
  // PROBE_NO_SLIDE: a tile is its conditioning chunks, then l(t) for all three taps
  constexpr bool NO_SLIDE = PROBE == PROBE_NO_SLIDE;
  constexpr int FIRST_COND = NO_SLIDE ? 0 : 2;  // the tile's first conditioning chunk
  // the f32 cond product's own layout: a lane owns CR rows (band + rg + RG i)
  // and 8 columns (4 cg .. 4 cg + 3 and M + 4 cg .. M + 4 cg + 3)
  constexpr int CG = W / 8, RG = 32 / CG, CR = 16 / RG;
  constexpr int RW = W == 64 ? 64 : W + 8;  // elements of a resident weight row (wo)
  extern __shared__ __align__(1024) unsigned char psmem[];
  unsigned char* smem = psmem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* s_wtap = reinterpret_cast<const bf16*>(smem);
  unsigned char* s_wc = smem + p.off_w_cond;
  const bf16* s_wres = reinterpret_cast<const bf16*>(smem + p.off_w_res);
  const float* s_bias = reinterpret_cast<const float*>(smem + p.off_bias);  // [bias | b_res]
  unsigned char* ring = smem + p.off_ring;  // 1024-aligned: the swizzle follows address bits 7-9
  if (smem_addr(ring) & 1023) __trap();
  const unsigned bars = smem_addr(smem + p.off_bars);  // full[stages], then empty[stages]
  const int n_cc = STREAM ? 1 : (p.DW + p.enc_cols - 1) / p.enc_cols;  // cond chunks a tile
  const int nch = (NO_SLIDE ? 1 : 3) + n_cc;                            // chunks a tile
  const int SG = p.stages / PG;  // slots of a group's own ring: group g has slots g SG .. g SG + SG - 1
  const int my_tiles = (p.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  // the layer's weights, once a block, by every thread
  {
    bf16* wt = reinterpret_cast<bf16*>(smem);
    for (int v = tid; v < 3 * W * (W / 8); v += PT) {
      const int k = v / (W / 8), c = (v % (W / 8)) * 8;
      cp16(wt + wo<W>(k, c), p.w_tap + k * W + c);
    }
    bf16* wr = reinterpret_cast<bf16*>(smem + p.off_w_res);
    for (int v = tid; v < M * (W / 8); v += PT) {
      const int k = v / (W / 8), c = (v % (W / 8)) * 8;
      cp16(wr + wo<W>(k, c), p.w_res + k * W + c);
    }
    float* bs = reinterpret_cast<float*>(smem + p.off_bias);
    for (int v = tid; v < W / 2; v += PT)
      cp16(bs + 4 * v, v < W / 4 ? p.bias + 4 * v : p.b_res + 4 * (v - W / 4));
    if (!STREAM && p.wc_resident) {
      if constexpr (F32C) {  // [DW][W] as it is
        const float* wc = static_cast<const float*>(p.w_cond);
        for (int v = tid; v < p.DW * (W / 4); v += PT)
          cp16(reinterpret_cast<float*>(s_wc) + 4 * v, wc + 4 * v);
      } else {  // [DW up to 16][W], rows past DW zero
        const bf16* wc = static_cast<const bf16*>(p.w_cond);
        bf16* d = reinterpret_cast<bf16*>(s_wc);
        const int rows16 = (p.DW + 15) & ~15;
        for (int v = tid; v < rows16 * (W / 8); v += PT) {
          const int k = v / (W / 8), c = (v % (W / 8)) * 8;
          if (k < p.DW)
            cp16(d + wo<W>(k, c), wc + (size_t)k * W + c);
          else
            *reinterpret_cast<uint4*>(d + wo<W>(k, c)) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    if (tid == 0) {
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(bars + 8 * s, 32);                    // full: the producer's lanes
        mbar_init(bars + 8 * (p.stages + s), PW / PG); // empty: one arrival a warp of a group
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  if (warp == PW) {
    // ---- the producer: the block's tiles in order, each chunk into the ring
    // of the group whose tile it is ----
    // a round of the block's share a tile: loaded as the tile starts and
    // stored as the next one starts, when the loads have long landed
    typename CarryOf<CARRY, W>::type carry(p.l_in, p.hist, cc, p.n_rows, p.shift);
    carry.split(my_tiles, true);
    for (int i = 0; i < my_tiles; ++i) {
      if (i > 0) carry.store(lane, 32);
      carry.load(lane, 32);
      const int gi = i % PG;
      const long long row0 = ((long long)blockIdx.x + (long long)i * gridDim.x) * PBM;
      for (int c = 0; c < nch; ++c) {
        const int qg = (i / PG) * nch + c;  // the chunk's place in its group's walk
        const int s = gi * SG + qg % SG;
        const unsigned full = bars + 8 * s;
        mbar_wait(bars + 8 * (p.stages + s), (unsigned)((qg / SG) & 1) ^ 1u);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        unsigned char* slot = ring + (size_t)s * p.slot_bytes;
        unsigned bytes = 0;
        if (NO_SLIDE ? c == nch - 1 : (c < 2 || c == nch - 1)) {
          // tap l(t - (2 - tap) d): rows r - (2 - tap) * shift of the input,
          // rows before it from the 2 * shift history rows, or zeros
          const long long y = row0 - (long long)(c == nch - 1 ? 0 : 2 - c) * p.shift;
          if (p.hist == nullptr || y >= 0 || y + PBM <= 0) {
            if (lane == 0) {
              const bool hist = p.hist != nullptr && y < 0;  // then every row is a history row
              for (int h = 0; h < W / 32; ++h)
                tma_box(slot + h * BOX, hist ? &map_h : &map_l, 32 * h,
                        (int)(hist ? y + 2 * p.shift : y), full);
              bytes = W / 32 * BOX;
            }
          } else {
            // the tile straddles the history's end (once a layer at most):
            // the producer's lanes copy it row by row
            for (int e = lane; e < PBM * (W / 4); e += 32) {
              const int row = e / (W / 4), col = (e % (W / 4)) * 4;
              const long long src = y + row;
              float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (src < 0)
                v = *reinterpret_cast<const float4*>(p.hist + (src + 2 * p.shift) * W + col);
              else if (row0 + row < p.n_rows)
                v = *reinterpret_cast<const float4*>(p.l_in + src * W + col);
              *reinterpret_cast<float4*>(slot + sw<4>(row, col)) = v;
            }
          }
        } else if constexpr (STREAM) {
          // the layer's W columns of each cond-stream row (at W 32 in bf16 the
          // box also holds the next 32 columns, unused)
          if (lane == 0) {
            for (int h = 0; h < (W * ES + 127) / 128; ++h)
              tma_box(slot + h * BOX, &map_c, p.cond_col0 + h * (128 / ES), (int)row0, full);
            bytes = (W * ES + 127) / 128 * BOX;
          }
        } else {
          // encoding columns k0 .. k0 + enc_cols (zeros past DW)
          const int k0 = (c - FIRST_COND) * p.enc_cols, kc = min(p.enc_cols, p.DW - k0);
          if (lane == 0) {
            for (int h = 0; h < p.enc_cols / (128 / ES); ++h)
              tma_box(slot + h * BOX, &map_c, k0 + h * (128 / ES), (int)row0, full);
            bytes = p.enc_cols / (128 / ES) * BOX;
          }
          if (!p.wc_resident) {  // the chunk's w_cond rows beside its encoding columns
            unsigned char* wd = slot + p.off_wchunk;
            if constexpr (F32C) {
              if (lane == 0) {
                bulk_copy(wd, static_cast<const float*>(p.w_cond) + (size_t)k0 * W, kc * W * 4, full);
                bytes += kc * W * 4;
              }
            } else {  // laid out by wo, through the producer's registers
              const bf16* wc = static_cast<const bf16*>(p.w_cond) + (size_t)k0 * W;
              for (int e = lane; e < ((kc + 15) & ~15) * (W / 8); e += 32) {
                const int kk = e / (W / 8), n = (e % (W / 8)) * 8;
                *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(wd) + wo<W>(kk, n)) =
                    kk < kc ? *reinterpret_cast<const uint4*>(wc + (size_t)kk * W + n)
                            : make_uint4(0u, 0u, 0u, 0u);
              }
            }
          }
        }
        mbar_arrive_tx(full, bytes);
      }
    }
    carry.store(lane, 32);  // the last round
    if constexpr (CARRY) carry_rest<W>(p.l_in, p.hist, cc, p.n_rows, p.shift, my_tiles, tid);
    return;
  }

  // ---- the consumers ----
  const int g = lane >> 2, t4 = lane & 3;
  const int group = warp / (PW / PG), band = (warp % (PW / PG)) * 16;
  // fragment row g (and g + 8) is row sg (sg + 8) of the band: with rows
  // 0, 2, 4, 6 for g = 0..3 the float2 loads of a half warp fall in distinct
  // pieces of the swizzled boxes (rows g would pair pieces two by two)
  const int sg = ((g & 3) << 1) | (g >> 2);
  // byte offset of the f32 element (band + sg, C + 2 t4) of a chunk for a
  // column C that is a multiple of 8 (known when unrolled); + 1024 for row
  // band + sg + 8, which has the same swizzle
  const int rb = (band + sg) * 128 + (t4 & 1) * 8, rp = (t4 >> 1) ^ sg;
  auto f32_at = [&](int C) { return (C / 32) * BOX + rb + ((rp ^ ((C % 32) / 4)) << 4); };
  const BLanes<W> bl(lane);
  const int rg = lane / CG, cg = lane % CG;  // the f32 cond product's layout
  float acc[NT][4], cnd[NT][4], cl[CR][8];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = cnd[j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < CR; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) cl[i][e] = 0.0f;

  int cs = 0;          // the group's ring position
  unsigned cph = 0;    // and the parity of its pass
  for (int i = group; i < my_tiles; i += PG)  // the group's tiles of this block
  for (int c = 0; c < nch; ++c) {
    const int s = group * SG + cs;
    mbar_wait(bars + 8 * s, cph);
    unsigned char* slot = ring + (size_t)s * p.slot_bytes;
    if (NO_SLIDE ? c == nch - 1 : (c < 2 || c == nch - 1)) {
      // a tap: 16 rows x W of f32, rounded to bf16 as they enter the product
      const int tap = c == nch - 1 ? 2 : c;
#pragma unroll
      for (int kk = 0; kk < W; kk += 16) {
        const float2 x0 = *reinterpret_cast<const float2*>(slot + f32_at(kk));
        const float2 x1 = *reinterpret_cast<const float2*>(slot + f32_at(kk) + 1024);
        const float2 x2 = *reinterpret_cast<const float2*>(slot + f32_at(kk + 8));
        const float2 x3 = *reinterpret_cast<const float2*>(slot + f32_at(kk + 8) + 1024);
        const unsigned a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y), pack_bf16(x2.x, x2.y),
                               pack_bf16(x3.x, x3.y)};
        if constexpr (NO_SLIDE) {  // l(t) against the bands of taps t-2d, t-d and t
#pragma unroll
          for (int band3 = 0; band3 < 3; ++band3) mma_row_band<W>(acc, a, s_wtap + (band3 * W + kk) * RW, bl);
        } else {
          mma_row_band<W>(acc, a, s_wtap + (tap * W + kk) * RW, bl);
        }
      }
    } else if constexpr (STREAM) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float2 v0, v1;
        if constexpr (COND == STREAM_F32) {
          v0 = *reinterpret_cast<const float2*>(slot + f32_at(8 * j));
          v1 = *reinterpret_cast<const float2*>(slot + f32_at(8 * j) + 1024);
        } else {  // bf16 (band + sg, 8j + 2 t4): piece j % 8 of its box
          const int o = (j / 8) * BOX + (band + sg) * 128 + ((((j & 7) ^ sg)) << 4) + 4 * t4;
          v0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(slot + o));
          v1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(slot + o + 1024));
        }
        cnd[j][0] = v0.x;
        cnd[j][1] = v0.y;
        cnd[j][2] = v1.x;
        cnd[j][3] = v1.y;
      }
    } else {
      const int k0 = (c - FIRST_COND) * p.enc_cols, kc = min(p.enc_cols, p.DW - k0);
      if constexpr (F32C) {
        // enc @ w_cond in f32 on the FMA units, k in order, CR rows x 8
        // columns a lane: each float4 of w serves CR rows
        const float* wk = p.wc_resident ? reinterpret_cast<const float*>(s_wc) + (size_t)k0 * W
                                        : reinterpret_cast<const float*>(slot + p.off_wchunk);
        wk += 4 * cg;
#pragma unroll 2
        for (int k = 0; k < kc; k += 4) {
          const int kb = (k >> 5) * BOX, kp = (k >> 2) & 7;
          float a[CR][4];
#pragma unroll
          for (int r = 0; r < CR; ++r) {
            const int row = band + rg + RG * r;
            const float4 x = *reinterpret_cast<const float4*>(slot + kb + row * 128 + ((kp ^ (row & 7)) << 4));
            a[r][0] = x.x;
            a[r][1] = x.y;
            a[r][2] = x.z;
            a[r][3] = x.w;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w0 = *reinterpret_cast<const float4*>(wk + (k + kk) * W);
            const float4 w1 = *reinterpret_cast<const float4*>(wk + (k + kk) * W + M);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int r = 0; r < CR; ++r)
#pragma unroll
              for (int e2 = 0; e2 < 8; ++e2) cl[r][e2] = fmaf(a[r][kk], wv[e2], cl[r][e2]);
          }
        }
      } else {
        // bf16 encoding columns into the tap accumulators (one K = 3W + DW
        // sum); ldmatrix: lane l gives the address of fragment row l % 16,
        // row sg-permuted like the rest, at column half l / 16
        const int erow = band + (lane & 8) + (((lane & 3) << 1) | ((lane >> 2) & 1));
        const int eb = erow * 128, ep = (lane >> 4) ^ (erow & 7);
        const bf16* wk = reinterpret_cast<const bf16*>(p.wc_resident ? s_wc : slot + p.off_wchunk) +
                         (p.wc_resident ? k0 : 0) * RW;
#pragma unroll 4
        for (int kk = 0; kk < kc; kk += 16) {
          unsigned a[4];
          ldsm_x4(a, slot + (kk >> 6) * BOX + eb + ((((kk >> 3) & 7) ^ ep) << 4));
          mma_row_band<W>(acc, a, wk + kk * RW, bl);
        }
      }
    }

    if (c == nch - 1) {
      // the tile's epilogue: l(t), the residual, is still in this slot
      float2 res_in[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        res_in[j][0] = *reinterpret_cast<const float2*>(slot + f32_at(8 * j));
        res_in[j][1] = *reinterpret_cast<const float2*>(slot + f32_at(8 * j) + 1024);
      }
      if constexpr (F32C) {
        // the f32 cond sums to the accumulator layout through the warp's own
        // rows of this slot (read above, so free now)
        __syncwarp();
#pragma unroll
        for (int r = 0; r < CR; ++r) {
          const int row = band + rg + RG * r;
          *reinterpret_cast<float4*>(slot + sw<4>(row, 4 * cg)) =
              make_float4(cl[r][0], cl[r][1], cl[r][2], cl[r][3]);
          *reinterpret_cast<float4*>(slot + sw<4>(row, M + 4 * cg)) =
              make_float4(cl[r][4], cl[r][5], cl[r][6], cl[r][7]);
#pragma unroll
          for (int e2 = 0; e2 < 8; ++e2) cl[r][e2] = 0.0f;
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 v0 = *reinterpret_cast<const float2*>(slot + f32_at(8 * j));
          const float2 v1 = *reinterpret_cast<const float2*>(slot + f32_at(8 * j) + 1024);
          cnd[j][0] = v0.x;
          cnd[j][1] = v0.y;
          cnd[j][2] = v1.x;
          cnd[j][3] = v1.y;
        }
      }
      unsigned ga[M / 16][4];  // bf16(g) as the A operand of the res product
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float xs = acc[j][e], xt = acc[j + NT / 2][e];
          if constexpr (COND != ENC_BF16) {
            xs = xs + cnd[j][e];
            xt = xt + cnd[j + NT / 2][e];
          }
          const int col = 8 * j + 2 * t4 + (e & 1);
          xs = xs + s_bias[col];
          xt = xt + s_bias[M + col];
          if constexpr (PROBE == PROBE_NO_GATE)
            gv[e] = clip_gate(xs, xt);
          else
            gv[e] = __frcp_rn(1.0f + expf(-xs)) * tanhf(xt);  // 1 / x, correctly rounded
        }
        ga[j >> 1][(j & 1) * 2] = pack_bf16(gv[0], gv[1]);
        ga[j >> 1][(j & 1) * 2 + 1] = pack_bf16(gv[2], gv[3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = cnd[j][e] = 0.0f;
      float res[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) res[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < M / 16; ++kk) mma_row_band<W>(res, ga[kk], s_wres + kk * 16 * RW, bl);
      const long long rA = ((long long)blockIdx.x + (long long)i * gridDim.x) * PBM + band + sg;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * t4;
        const float2 b = *reinterpret_cast<const float2*>(s_bias + W + col);
        if (rA < p.n_rows)
          *reinterpret_cast<float2*>(p.l_out + rA * W + col) =
              make_float2(res_in[j][0].x + res[j][0] + b.x, res_in[j][0].y + res[j][1] + b.y);
        if (rA + 8 < p.n_rows)
          *reinterpret_cast<float2*>(p.l_out + (rA + 8) * W + col) =
              make_float2(res_in[j][1].x + res[j][2] + b.x, res_in[j][1].y + res[j][3] + b.y);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (p.stages + s));
    if (++cs == SG) {
      cs = 0;
      cph ^= 1u;
    }
  }
  if constexpr (CARRY) carry_rest<W>(p.l_in, p.hist, cc, p.n_rows, p.shift, my_tiles, tid);
}

template <int W, int COND, int PROBE>
__global__ void __launch_bounds__(PT, W <= 32 ? 2 : 1)
    flow_persist_kernel(const PersistParams p, const __grid_constant__ CUtensorMap map_l,
                        const __grid_constant__ CUtensorMap map_h,
                        const __grid_constant__ CUtensorMap map_c) {
  persist_layer<W, COND, PROBE, false>(p, map_l, map_h, map_c, CarryArgs{nullptr, 0});
}

// the same layer with a state: it also writes the layer's new history
template <int W, int COND, int PROBE>
__global__ void __launch_bounds__(PT, W <= 32 ? 2 : 1)
    flow_persist_carry_kernel(const PersistParams p, const __grid_constant__ CUtensorMap map_l,
                              const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_c, const CarryArgs cc) {
  persist_layer<W, COND, PROBE, true>(p, map_l, map_h, map_c, cc);
}

// ---------------------------------------------------------------------------
// flow_wide_kernel: W = 128 and 256
// ---------------------------------------------------------------------------

constexpr int WTR = FLOW_WIDE_TILE_ROWS;  // rows of a wide tile: 64 a consumer warpgroup
constexpr int WKC = FLOW_WIDE_KC;         // K columns of a chunk of a bf16 operand: one 128-byte row
constexpr int WBOX = WTR * 128;           // bytes of a wide copy box: a tile's rows of 128 B
// threads: the consumer warpgroups and a producer warpgroup, whose first warp
// feeds the ring.  A block of 384 threads starts at 168 registers a thread
// (a W 256 consumer holds 128 f32 sums); setmaxnreg asks for the producer
// warpgroup's spare ones for the consumers.
constexpr int WPT = 32 * (PW + 4);
constexpr int WIDE_PRODUCER_REGS = 96, WIDE_CONSUMER_REGS = 200;
static_assert(WTR == 64 * (PW / 4) && WKC == 64, "one 64-row wgmma band a consumer warpgroup");
static_assert(PW % 4 == 0 && WIDE_PRODUCER_REGS * 128 + WIDE_CONSUMER_REGS * 32 * PW <= 65536,
              "the register file of an SM");

struct WideParams {
  const float* l_in;
  const float* hist;     // the layer's 2 * shift history rows, or null (zeros)
  const void* cond;      // stream modes: the layer's first cond-stream column
  const float* w_cond;   // ENC_F32: [DW, W] f32, columns in the wide order (wide_cond_order)
  const float* bias;     // [W]
  const float* b_res;    // [W]
  float* l_out;
  long long shift;       // d * B rows
  int n_rows, n_tiles;
  int cond_cols;         // DW (an encoding), or a cond-stream row's n_layers * W
  int stages, slot_bytes, off_bias, off_bars, off_ring;
};

// d (a warpgroup's 64 x 128 f32 sums) += a (bf16 A fragments in registers) x
// B (128 x 16, K-major in shared memory, 128-byte swizzle) described by desc
__device__ __forceinline__ void wgmma_128(float (&d)[64], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (a warpgroup's 64 x 256 f32 sums) += a (bf16 A fragments in registers) x
// B (256 x 16, K-major in shared memory, 128-byte swizzle) described by desc
__device__ __forceinline__ void wgmma_256(float (&d)[128], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A wgmma descriptor of a K-major bf16 operand in shared memory written by
// the copy engine in the 128-byte swizzle: rows of 128 B (64 K values),
// eight-row groups 1024 B apart (stride byte offset), the leading byte
// offset unused under that swizzle; addr + 32 k16 steps along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* addr) {
  return (uint64_t)((smem_addr(addr) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int W>
__device__ __forceinline__ void wgmma_w(float (&d)[W / 2], const unsigned (&a)[4], const void* b) {
  if constexpr (W == 128)
    wgmma_128(d, a, sw128_desc(b));
  else
    wgmma_256(d, a, sw128_desc(b));
}

// One layer over the stream.  Tiles of WTR rows; the two consumer
// warpgroups take rows 0..63 and 64..127 of every tile of the block and
// share each chunk of it, so that a streamed weight chunk serves 128 rows.
// A tile is nch chunks, each one ring slot: the taps l(t-2d), l(t-d), l(t)
// in WKC-column chunks (two boxes of 32 f32 columns each; at W 256 the
// chunk's w_tap^T rows beside them), then the encoding's chunks (bf16: one
// box of 64 columns and its w_cond^T rows; f32: one box of 32 columns and
// its w_cond rows, for the FMA units); a cond stream is read by the
// epilogue itself.  map_l is the layer's input [n_rows, W] f32, map_h its
// history [2 shift, W] (a state only), map_c the encoding [n_rows, DW],
// map_w w_tap^T [W, 3W] bf16, map_wc w_cond^T [W, DW] bf16 (ENC_BF16), and
// map_r w_res^T [W, W/2] bf16, every weight box W rows x 64 K values.
//
// The accumulator of a consumer thread (g = lane / 4, t4 = lane % 4, warp q
// of its warpgroup) is wgmma's: d[4j .. 4j + 3] = rows (r, r, r + 8, r + 8)
// of its warp's 16 at columns (8j + 2 t4, 8j + 2 t4 + 1) twice, for every
// n8 block j, with fragment row r holding tile row band + sg (the same
// permutation as flow_persist_kernel's, so that the f32 tap loads meet no
// bank conflict).  Sigmoid column c and tanh column c + W/2 are blocks j
// and j + W/16 of one thread.
//
// CARRY (flow_wide_carry_kernel): the producer warp also writes the block's
// share of the layer's new history (Carry), as flow_persist_kernel's does.
template <int W, int COND, int PROBE, bool CARRY>
__device__ __forceinline__ void wide_layer(const WideParams p, const CUtensorMap& map_l,
                                           const CUtensorMap& map_h, const CUtensorMap& map_c,
                                           const CUtensorMap& map_w, const CUtensorMap& map_wc,
                                           const CUtensorMap& map_r, const CarryArgs cc) {
  constexpr int M = W / 2, NA = W / 2;  // NA: sums a consumer thread
  constexpr bool TAPS_RES = W == 128;   // w_tap^T resident; at W 256 streamed with its chunk
  constexpr bool F32C = COND == ENC_F32;
  constexpr bool STREAM = COND == STREAM_BF16 || COND == STREAM_F32;
  constexpr int CPT = W / WKC, NTAP = 3 * CPT;  // chunks a tap, tap chunks a tile
  // PROBE_NO_SLIDE: l(t)'s CPT chunks alone, each against the three tap bands
  // (W 128: the resident boxes; W 256: the chunk brings tap 0's box, and two
  // chunks after it bring taps 1 and 2's, the A fragments held meanwhile)
  constexpr bool NO_SLIDE = PROBE == PROBE_NO_SLIDE;
  constexpr int NTAPC = NO_SLIDE && TAPS_RES ? CPT : NTAP;  // tap chunks a tile
  constexpr int WROWS = W * 128;                // bytes of a weight box: W rows x 64 K values
  constexpr int EC = F32C ? 32 : WKC;           // encoding columns a chunk
  constexpr int NRES = W / 2 / WKC;             // w_res^T chunks a tile, after the encoding's
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* smem = wsmem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned char* s_wtap = smem;  // W 128: w_tap^T, box c at c * WROWS
  float* s_bias = reinterpret_cast<float*>(smem + p.off_bias);  // [bias | b_res]
  unsigned char* ring = smem + p.off_ring;
  if (((smem_addr(smem) | smem_addr(ring) | p.slot_bytes) & 1023) != 0) __trap();
  const unsigned bars = smem_addr(smem + p.off_bars);  // full[stages], empty[stages], weights
  const unsigned wbar = bars + 16 * p.stages;
  const int DW = p.cond_cols;
  const int n_cc = STREAM ? 0 : (DW + EC - 1) / EC;
  const int nch = NTAPC + n_cc + NRES;
  const int my_tiles = (p.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  for (int v = tid; v < 2 * W; v += WPT) s_bias[v] = v < W ? p.bias[v] : p.b_res[v - W];
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 32);                // full: the producer's lanes
      mbar_init(bars + 8 * (p.stages + s), PW);   // empty: one arrival a consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= PW) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WIDE_PRODUCER_REGS));
    if (warp > PW) return;
    // ---- the producer: the resident weights once, then the block's tiles'
    // chunks in order into the ring ----
    if (lane == 0) {
      mbar_arrive_tx(wbar, TAPS_RES ? NTAP * WROWS : 0);
      if constexpr (TAPS_RES)
        for (int b = 0; b < NTAP; ++b) tma_box(smem + b * WROWS, &map_w, b * WKC, 0, wbar);
    }
    int q = 0;  // the chunk's place in the block's walk
    // a round of the block's share a tile: loaded as the tile starts and
    // stored as the next one starts, when the loads have long landed
    typename CarryOf<CARRY, W>::type carry(p.l_in, p.hist, cc, p.n_rows, p.shift);
    carry.split(my_tiles, true);
    for (int i = 0; i < my_tiles; ++i) {
      if (i > 0) carry.store(lane, 32);
      carry.load(lane, 32);
      const long long row0 = ((long long)blockIdx.x + (long long)i * gridDim.x) * WTR;
      for (int c = 0; c < nch; ++c, ++q) {
        const int s = q % p.stages;
        const unsigned full = bars + 8 * s;
        mbar_wait(bars + 8 * (p.stages + s), (unsigned)((q / p.stages) & 1) ^ 1u);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        unsigned char* slot = ring + (size_t)s * p.slot_bytes;
        unsigned bytes = 0;
        if (c < NTAPC) {
          // tap l(t - (2 - tap) d), columns col0 .. col0 + 63: rows
          // r - (2 - tap) * shift of the input, rows before it from the
          // 2 * shift history rows, or zeros.  NO_SLIDE: l(t)'s columns
          // (at W 256, then tap 1 and 2's weight-only chunks of them)
          const int tap = !NO_SLIDE ? c / CPT : TAPS_RES ? 2 : c % 3;
          const int col0 = (!NO_SLIDE ? c % CPT : TAPS_RES ? c : c / 3) * WKC;
          const long long y = row0 - (long long)(NO_SLIDE ? 0 : 2 - tap) * p.shift;
          if (NO_SLIDE && !TAPS_RES && tap != 0) {
            // the weights alone
          } else if (p.hist == nullptr || y >= 0 || y + WTR <= 0) {
            if (lane == 0) {
              const bool hist = p.hist != nullptr && y < 0;
              for (int h = 0; h < 2; ++h)
                tma_box(slot + h * WBOX, hist ? &map_h : &map_l, col0 + 32 * h,
                        (int)(hist ? y + 2 * p.shift : y), full);
              bytes = 2 * WBOX;
            }
          } else {
            // the tile straddles the history's end (once a layer at most)
            for (int e = lane; e < WTR * (WKC / 4); e += 32) {
              const int row = e / (WKC / 4), col = (e % (WKC / 4)) * 4;
              const long long src = y + row;
              float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (src < 0)
                v = *reinterpret_cast<const float4*>(p.hist + (src + 2 * p.shift) * W + col0 + col);
              else if (row0 + row < p.n_rows)
                v = *reinterpret_cast<const float4*>(p.l_in + src * W + col0 + col);
              *reinterpret_cast<float4*>(slot + (col / 32) * WBOX + row * 128 +
                                         ((((col % 32) >> 2) ^ (row & 7)) << 4)) = v;
            }
          }
          if (!TAPS_RES && lane == 0) {  // the chunk's w_tap^T rows
            tma_box(slot + 2 * WBOX, &map_w, tap * W + col0, 0, full);
            bytes += WROWS;
          }
        } else if (c >= NTAPC + n_cc) {
          if (lane == 0) {  // a w_res^T box: K values 64 r .. 64 r + 63 of every output column
            tma_box(slot, &map_r, (c - NTAPC - n_cc) * WKC, 0, full);
            bytes = WROWS;
          }
        } else if (lane == 0) {
          const int k0 = (c - NTAPC) * EC;
          tma_box(slot, &map_c, k0, (int)row0, full);  // rows past n_rows, columns past DW: zeros
          bytes = WBOX;
          if constexpr (F32C) {  // the chunk's w_cond rows, as they are
            const int kc = min(EC, DW - k0);
            bulk_copy(slot + WBOX, p.w_cond + (size_t)k0 * W, kc * W * 4, full);
            bytes += kc * W * 4;
          } else {  // the chunk's w_cond^T rows (columns past DW: zeros)
            tma_box(slot + WBOX, &map_wc, k0, 0, full);
            bytes += WROWS;
          }
        }
        mbar_arrive_tx(full, bytes);
      }
    }
    carry.store(lane, 32);  // the last round
    if constexpr (CARRY) carry_rest<W>(p.l_in, p.hist, cc, p.n_rows, p.shift, my_tiles, tid);
  } else {
  // ---- the consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WIDE_CONSUMER_REGS));
  const int g = lane >> 2, t4 = lane & 3;
  const int band = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's 16 rows of the tile
  const int sg = ((g & 3) << 1) | (g >> 2);
  // byte offset of the f32 element (band + sg, C + 2 t4) of a tap chunk for
  // a column C that is a multiple of 8; + 1024 for row band + sg + 8
  const int rb = (band + sg) * 128 + (t4 & 1) * 8, rp = (t4 >> 1) ^ sg;
  auto f32_at = [&](int C) { return (C / 32) * WBOX + rb + ((rp ^ ((C % 32) / 4)) << 4); };
  // ldmatrix of a bf16 encoding chunk: lane l addresses fragment row l % 16
  // (tile row band + its sg permutation) at column half l / 16
  const int erow = band + (lane & 8) + (((lane & 3) << 1) | ((lane >> 2) & 1));
  const int eb = erow * 128, ep = (lane >> 4) ^ (erow & 7);
  const int arow = band + sg;  // the thread's rows arow and arow + 8
  const float* __restrict__ l_in = p.l_in;
  float* __restrict__ l_out = p.l_out;
  mbar_wait(wbar, 0);

  float acc[NA];
  unsigned held[4][4];  // NO_SLIDE: l(t)'s A fragments (at W 256 held for taps 1 and 2)
  int cs = 0;        // ring position
  unsigned cph = 0;  // and the parity of its pass
  for (int i = 0; i < my_tiles; ++i) {
#pragma unroll
    for (int e = 0; e < NA; ++e) acc[e] = 0.0f;
    for (int c = 0; c < nch - NRES; ++c) {
      mbar_wait(bars + 8 * cs, cph);
      const unsigned char* slot = ring + (size_t)cs * p.slot_bytes;
      if (NO_SLIDE && c < NTAPC) {
        if (TAPS_RES || c % 3 == 0) {
          // 16 rows x 64 f32 of l(t), rounded to bf16 as they enter the product
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float2 x0 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk));
            const float2 x1 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk) + 1024);
            const float2 x2 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk + 8));
            const float2 x3 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk + 8) + 1024);
            held[kk][0] = pack_bf16(x0.x, x0.y);
            held[kk][1] = pack_bf16(x1.x, x1.y);
            held[kk][2] = pack_bf16(x2.x, x2.y);
            held[kk][3] = pack_bf16(x3.x, x3.y);
          }
        }
        wgmma_fence();
        if constexpr (TAPS_RES) {
#pragma unroll
          for (int band3 = 0; band3 < 3; ++band3)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_w<W>(acc, held[kk], s_wtap + (band3 * CPT + c) * WROWS + 32 * kk);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_w<W>(acc, held[kk], slot + 2 * WBOX + 32 * kk);
        }
        wgmma_commit_wait();
      } else if (c < NTAPC) {
        // 16 rows x 64 f32 of the warp, rounded to bf16 as they enter the product
        unsigned a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float2 x0 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk));
          const float2 x1 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk) + 1024);
          const float2 x2 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk + 8));
          const float2 x3 = *reinterpret_cast<const float2*>(slot + f32_at(16 * kk + 8) + 1024);
          a[kk][0] = pack_bf16(x0.x, x0.y);
          a[kk][1] = pack_bf16(x1.x, x1.y);
          a[kk][2] = pack_bf16(x2.x, x2.y);
          a[kk][3] = pack_bf16(x3.x, x3.y);
        }
        const unsigned char* wb = TAPS_RES ? s_wtap + c * WROWS : slot + 2 * WBOX;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_w<W>(acc, a[kk], wb + 32 * kk);
        wgmma_commit_wait();
      } else if constexpr (F32C) {
        // enc @ w_cond in f32 on the FMA units, k in order, onto the tap sums
        const int k0 = (c - NTAPC) * EC, kc = min(EC, DW - k0);
        const float* wk = reinterpret_cast<const float*>(slot + WBOX) + 4 * t4;
        const unsigned char* ea = slot + arow * 128;  // row arow + 8: 1024 B on, the same swizzle
#pragma unroll 1
        for (int k = 0; k < kc; ++k) {
          // enc (arow, k) and (arow + 8, k): piece k / 4 of the row, swizzled by arow % 8
          const int o = ((((k >> 2) ^ arow) & 7) << 4) + (k & 3) * 4;
          const float e0 = *reinterpret_cast<const float*>(ea + o);
          const float e1 = *reinterpret_cast<const float*>(ea + o + 1024);
#pragma unroll
          for (int jj = 0; jj < W / 16; ++jj) {
            // columns 16 jj + 2 t4 + (0, 1) and 16 jj + 8 + 2 t4 + (0, 1); the
            // loads of two jj at a time (the sums hold most of the registers)
            if (jj % 2 == 0) asm volatile("" ::: "memory");
            const float4 w = *reinterpret_cast<const float4*>(wk + k * W + 16 * jj);
            float* d0 = acc + 8 * jj;
            d0[0] = fmaf(e0, w.x, d0[0]);
            d0[1] = fmaf(e0, w.y, d0[1]);
            d0[2] = fmaf(e1, w.x, d0[2]);
            d0[3] = fmaf(e1, w.y, d0[3]);
            d0[4] = fmaf(e0, w.z, d0[4]);
            d0[5] = fmaf(e0, w.w, d0[5]);
            d0[6] = fmaf(e1, w.z, d0[6]);
            d0[7] = fmaf(e1, w.w, d0[7]);
          }
        }
      } else {
        // bf16 encoding columns into the tap sums (one K = 3W + DW product);
        // columns past DW are zeros in both operands (the copy engine's fill)
        unsigned a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], slot + eb + ((((2 * kk) & 7) ^ ep) << 4));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_w<W>(acc, a[kk], slot + WBOX + 32 * kk);
        wgmma_commit_wait();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (p.stages + cs));
      if (++cs == p.stages) {
        cs = 0;
        cph ^= 1u;
      }
    }

    // ---- the tile's epilogue ----
    const long long rA = ((long long)blockIdx.x + (long long)i * gridDim.x) * WTR + arow;
    const long long rB = rA + 8;
    unsigned ga[M / 16][4];  // bf16(g) as the A operand of the res product
#pragma unroll
    for (int j = 0; j < M / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      float cnd[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};  // [s, t][e]
      if constexpr (STREAM) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = h ? rB : rA;
          if (r < p.n_rows) {
#pragma unroll
            for (int st = 0; st < 2; ++st) {
              const long long o = r * p.cond_cols + col + st * M;
              float2 v;
              if constexpr (COND == STREAM_F32)
                v = *reinterpret_cast<const float2*>(static_cast<const float*>(p.cond) + o);
              else
                v = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p.cond) + o));
              cnd[st][2 * h] = v.x;
              cnd[st][2 * h + 1] = v.y;
            }
          }
        }
      }
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xs = acc[4 * j + e], xt = acc[4 * (j + M / 8) + e];
        if constexpr (STREAM) {
          xs = xs + cnd[0][e];
          xt = xt + cnd[1][e];
        }
        xs = xs + s_bias[col + (e & 1)];
        xt = xt + s_bias[M + col + (e & 1)];
        if constexpr (PROBE == PROBE_NO_GATE)
          gv[e] = clip_gate(xs, xt);
        else
          gv[e] = __frcp_rn(1.0f + expf(-xs)) * tanhf(xt);  // 1 / x, correctly rounded
      }
      ga[j >> 1][(j & 1) * 2] = pack_bf16(gv[0], gv[1]);
      ga[j >> 1][(j & 1) * 2 + 1] = pack_bf16(gv[2], gv[3]);
    }
    // l' = l(t) + bf16(g) @ w_res + b_res in panels of 128 output columns
    // (one at W 128, two at W 256, so that a thread holds 64 sums), each an
    // m64n128 wgmma over K = W/2; the residual l(t) comes from L2 (its tap
    // chunk has just passed through), RB n8 blocks of both rows a batch, all
    // loads of a batch before its stores, the panel's first batch in flight
    // during its product
    constexpr int RB = W == 128 ? 16 : 8;
    const unsigned char* wres[NRES];  // the tile's w_res^T chunks, held until the products end
    int wslot[NRES];
#pragma unroll
    for (int r = 0; r < NRES; ++r) {
      mbar_wait(bars + 8 * cs, cph);
      wres[r] = ring + (size_t)cs * p.slot_bytes;
      wslot[r] = cs;
      if (++cs == p.stages) {
        cs = 0;
        cph ^= 1u;
      }
    }
    float racc[64];
    float2 xa[RB], xb[RB];
    auto load_res = [&](int j0) {
#pragma unroll
      for (int jj = 0; jj < RB; ++jj) {
        const int col = 8 * (j0 + jj) + 2 * t4;
        xa[jj] = rA < p.n_rows ? __ldg(reinterpret_cast<const float2*>(l_in + rA * W + col))
                               : make_float2(0.0f, 0.0f);
        xb[jj] = rB < p.n_rows ? __ldg(reinterpret_cast<const float2*>(l_in + rB * W + col))
                               : make_float2(0.0f, 0.0f);
      }
    };
#pragma unroll
    for (int pn = 0; pn < W / 128; ++pn) {
      load_res(16 * pn);
#pragma unroll
      for (int e = 0; e < 64; ++e) racc[e] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < M / 16; ++kk)
        wgmma_128(racc, ga[kk], sw128_desc(wres[kk / 4] + pn * 128 * 128 + 32 * (kk % 4)));
      wgmma_commit_wait();
      if (pn == W / 128 - 1) {
        __syncwarp();
#pragma unroll
        for (int r = 0; r < NRES; ++r)
          if (lane == 0) mbar_arrive(bars + 8 * (p.stages + wslot[r]));
      }
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += RB) {
        if (j0 > 0) load_res(16 * pn + j0);
#pragma unroll
        for (int jj = 0; jj < RB; ++jj) {
          const int j = j0 + jj, col = 8 * (16 * pn + j) + 2 * t4;
          const float2 b = *reinterpret_cast<const float2*>(s_bias + W + col);
          if (rA < p.n_rows)
            *reinterpret_cast<float2*>(l_out + rA * W + col) =
                make_float2(xa[jj].x + racc[4 * j] + b.x, xa[jj].y + racc[4 * j + 1] + b.y);
          if (rB < p.n_rows)
            *reinterpret_cast<float2*>(l_out + rB * W + col) =
                make_float2(xb[jj].x + racc[4 * j + 2] + b.x, xb[jj].y + racc[4 * j + 3] + b.y);
        }
      }
    }
  }
  if constexpr (CARRY) carry_rest<W>(p.l_in, p.hist, cc, p.n_rows, p.shift, my_tiles, tid);
  }
}

template <int W, int COND, int PROBE>
__global__ void __launch_bounds__(WPT, 1)
    flow_wide_kernel(const WideParams p, const __grid_constant__ CUtensorMap map_l,
                     const __grid_constant__ CUtensorMap map_h,
                     const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_wc,
                     const __grid_constant__ CUtensorMap map_r) {
  wide_layer<W, COND, PROBE, false>(p, map_l, map_h, map_c, map_w, map_wc, map_r, CarryArgs{nullptr, 0});
}

// the same layer with a state: it also writes the layer's new history
template <int W, int COND, int PROBE>
__global__ void __launch_bounds__(WPT, 1)
    flow_wide_carry_kernel(const WideParams p, const __grid_constant__ CUtensorMap map_l,
                           const __grid_constant__ CUtensorMap map_h,
                           const __grid_constant__ CUtensorMap map_c,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_wc,
                           const __grid_constant__ CUtensorMap map_r, const CarryArgs cc) {
  wide_layer<W, COND, PROBE, true>(p, map_l, map_h, map_c, map_w, map_wc, map_r, cc);
}

// one layer's launch: (args, input, old history or null, output, new history
// or null, layer index within the call, d * B, stream)
typedef cudaError_t (*LayerFn)(const FlowArgs&, const float*, const float*, float*, float*, int,
                               long long, cudaStream_t);

// the conditioning pointers of layer li: a stream's columns of the layer, or
// the layer's w_cond
const char* layer_cond(const FlowArgs& a, int li, int W, bool f32) {
  const char* cond = static_cast<const char*>(a.cond);
  if (a.cond_mode == STREAM_BF16 || a.cond_mode == STREAM_F32)
    cond += (size_t)li * W * (f32 ? 4 : 2);  // the layer's columns of each stream row
  return cond;
}

const void* layer_w_cond(const FlowArgs& a, int li, int W, bool f32) {
  if (a.cond_mode == STREAM_BF16 || a.cond_mode == STREAM_F32) return nullptr;
  return static_cast<const char*>(a.w_cond) + (size_t)li * a.cond_cols * W * (f32 ? 4 : 2);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no link to libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a [rows, cols] row-major tensor in boxes of box_rows rows x 128 B, 128-byte swizzle
cudaError_t box_map(CUtensorMap* map, const void* base, bool f32, long long rows, long long cols,
                    int box_rows = PBM) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int es = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * es)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / es), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// one layer's launch of the persistent kernel (its carry twin when new_hist
// is given): li is the layer's index within the call
template <int W, int COND>
cudaError_t launch_persist(const FlowArgs& a, const float* src, const float* hist, float* dst,
                           float* new_hist, int li, long long shift, cudaStream_t st) {
  const void* kernel = new_hist != nullptr ? (const void*)flow_persist_carry_kernel<W, COND, KERNEL_PROBE>
                                           : (const void*)flow_persist_kernel<W, COND, KERNEL_PROBE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return err;
  const bool stream = COND == STREAM_BF16 || COND == STREAM_F32;
  const bool f32 = COND == ENC_F32 || COND == STREAM_F32;
  const long long n_rows = (long long)a.L * a.B;
  CUtensorMap map_l, map_h, map_c;
  err = box_map(&map_l, src, true, n_rows, W);
  if (err == cudaSuccess) err = box_map(&map_h, hist != nullptr ? hist : src, true,
                                        hist != nullptr ? 2 * shift : n_rows, W);
  if (err == cudaSuccess) err = box_map(&map_c, a.cond, f32, n_rows, a.cond_cols);
  if (err != cudaSuccess) return err;
  PersistParams p;
  p.l_in = src;
  p.hist = hist;
  p.w_tap = static_cast<const bf16*>(a.w_tap) + (size_t)li * 3 * W * W;
  p.w_cond = layer_w_cond(a, li, W, f32);
  p.bias = static_cast<const float*>(a.bias) + (size_t)li * W;
  p.w_res = static_cast<const bf16*>(a.w_res) + (size_t)li * (W / 2) * W;
  p.b_res = static_cast<const float*>(a.b_res) + (size_t)li * W;
  p.l_out = dst;
  p.shift = shift;
  p.n_rows = (int)n_rows;
  p.n_tiles = a.n_tiles;
  p.cond_col0 = stream ? li * W : 0;
  p.DW = a.cond_cols;
  p.stages = a.stages;
  p.slot_bytes = a.slot_bytes;
  p.enc_cols = a.enc_cols;
  p.wc_resident = a.wc_resident;
  p.off_w_cond = a.off_w_cond;
  p.off_w_res = a.off_w_res;
  p.off_bias = a.off_bias;
  p.off_bars = a.off_bars;
  p.off_ring = a.off_ring;
  p.off_wchunk = a.off_wchunk;
  if (new_hist != nullptr)
    flow_persist_carry_kernel<W, COND, KERNEL_PROBE><<<a.grid, PT, a.smem_bytes, st>>>(
        p, map_l, map_h, map_c, CarryArgs{new_hist, a.carry_bf16});
  else
    flow_persist_kernel<W, COND, KERNEL_PROBE><<<a.grid, PT, a.smem_bytes, st>>>(p, map_l, map_h, map_c);
  return cudaGetLastError();
}

// one layer's launch of the wide kernel: li is the layer's index within the
// call; w_tap, w_cond and w_res hold the wide layout (ops/flow_kernel.py
// wide_weights): w_tap^T [W, 3W], w_cond^T [W, DW] bf16 or w_cond [DW, W] f32
// in the wide column order, w_res^T [W, W/2], a layer after another
template <int W, int COND>
cudaError_t launch_wide(const FlowArgs& a, const float* src, const float* hist, float* dst,
                        float* new_hist, int li, long long shift, cudaStream_t st) {
  const void* kernel = new_hist != nullptr ? (const void*)flow_wide_carry_kernel<W, COND, KERNEL_PROBE>
                                           : (const void*)flow_wide_kernel<W, COND, KERNEL_PROBE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return err;
  const bool stream = COND == STREAM_BF16 || COND == STREAM_F32;
  const bool f32 = COND == ENC_F32 || COND == STREAM_F32;
  const long long n_rows = (long long)a.L * a.B;
  const bf16* w_tap = static_cast<const bf16*>(a.w_tap) + (size_t)li * 3 * W * W;
  const bf16* w_res = static_cast<const bf16*>(a.w_res) + (size_t)li * (W / 2) * W;
  const void* w_cond = layer_w_cond(a, li, W, f32);
  CUtensorMap map_l, map_h, map_c, map_w, map_wc, map_r;
  err = box_map(&map_l, src, true, n_rows, W, WTR);
  if (err == cudaSuccess) err = box_map(&map_h, hist != nullptr ? hist : src, true,
                                        hist != nullptr ? 2 * shift : n_rows, W, WTR);
  if (err == cudaSuccess)
    err = stream ? box_map(&map_c, src, true, n_rows, W, WTR)
                 : box_map(&map_c, a.cond, f32, n_rows, a.cond_cols, WTR);
  if (err == cudaSuccess) err = box_map(&map_w, w_tap, false, W, 3 * W, W);
  if (err == cudaSuccess)
    err = COND == ENC_BF16 ? box_map(&map_wc, w_cond, false, W, a.cond_cols, W)
                           : box_map(&map_wc, w_tap, false, W, 3 * W, W);
  if (err == cudaSuccess) err = box_map(&map_r, w_res, false, W, W / 2, W);
  if (err != cudaSuccess) return err;
  WideParams p;
  p.l_in = src;
  p.hist = hist;
  p.cond = stream ? static_cast<const void*>(layer_cond(a, li, W, f32)) : nullptr;
  p.w_cond = COND == ENC_F32 ? static_cast<const float*>(w_cond) : nullptr;
  p.bias = static_cast<const float*>(a.bias) + (size_t)li * W;
  p.b_res = static_cast<const float*>(a.b_res) + (size_t)li * W;
  p.l_out = dst;
  p.shift = shift;
  p.n_rows = (int)n_rows;
  p.n_tiles = a.n_tiles;
  p.cond_cols = a.cond_cols;
  p.stages = a.stages;
  p.slot_bytes = a.slot_bytes;
  p.off_bias = a.off_bias;
  p.off_bars = a.off_bars;
  p.off_ring = a.off_ring;
  if (new_hist != nullptr)
    flow_wide_carry_kernel<W, COND, KERNEL_PROBE><<<a.grid, WPT, a.smem_bytes, st>>>(
        p, map_l, map_h, map_c, map_w, map_wc, map_r, CarryArgs{new_hist, a.carry_bf16});
  else
    flow_wide_kernel<W, COND, KERNEL_PROBE><<<a.grid, WPT, a.smem_bytes, st>>>(
        p, map_l, map_h, map_c, map_w, map_wc, map_r);
  return cudaGetLastError();
}

template <int W>
LayerFn persist_fn(int cond_mode) {
  switch (cond_mode) {
    case ENC_BF16: return launch_persist<W, ENC_BF16>;
    case ENC_F32: return launch_persist<W, ENC_F32>;
    case STREAM_BF16: return launch_persist<W, STREAM_BF16>;
    case STREAM_F32: return launch_persist<W, STREAM_F32>;
    default: return nullptr;
  }
}

template <int W>
LayerFn wide_fn(int cond_mode) {
  switch (cond_mode) {
    case ENC_BF16: return launch_wide<W, ENC_BF16>;
    case ENC_F32: return launch_wide<W, ENC_F32>;
    case STREAM_BF16: return launch_wide<W, STREAM_BF16>;
    case STREAM_F32: return launch_wide<W, STREAM_F32>;
    default: return nullptr;
  }
}

// The kernel of a width (the dispatch is by width alone): the persistent
// kernel at W = 32 and 64, the wide kernel at W = 128 and 256.
LayerFn pick_layer_fn(int W, int cond_mode, int* kernel_id) {
  *kernel_id = W <= 64 ? K_PERSIST : K_WIDE;
  switch (W) {
    case 32: return persist_fn<32>(cond_mode);
    case 64: return persist_fn<64>(cond_mode);
    case 128: return wide_fn<128>(cond_mode);
    case 256: return wide_fn<256>(cond_mode);
    default: return nullptr;
  }
}

// a trunk kernel of the persistent (PERSIST) or the wide family, or its carry twin
template <int W, int COND, bool PERSIST>
const void* trunk_of(bool carry) {
  if constexpr (PERSIST)
    return carry ? (const void*)flow_persist_carry_kernel<W, COND, KERNEL_PROBE>
                 : (const void*)flow_persist_kernel<W, COND, KERNEL_PROBE>;
  else
    return carry ? (const void*)flow_wide_carry_kernel<W, COND, KERNEL_PROBE>
                 : (const void*)flow_wide_kernel<W, COND, KERNEL_PROBE>;
}

template <int W>
const void* trunk_of_mode(int cond_mode, bool carry) {
  constexpr bool P = W <= 64;
  switch (cond_mode) {
    case ENC_BF16: return trunk_of<W, ENC_BF16, P>(carry);
    case ENC_F32: return trunk_of<W, ENC_F32, P>(carry);
    case STREAM_BF16: return trunk_of<W, STREAM_BF16, P>(carry);
    case STREAM_F32: return trunk_of<W, STREAM_F32, P>(carry);
    default: return nullptr;
  }
}

// The trunk kernel of a width, as flow_stack picks it (carry: its twin that
// also writes the new history, launched with a state).
const void* trunk_kernel(int W, int cond_mode, bool carry) {
  switch (W) {
    case 32: return trunk_of_mode<32>(cond_mode, carry);
    case 64: return trunk_of_mode<64>(cond_mode, carry);
    case 128: return trunk_of_mode<128>(cond_mode, carry);
    case 256: return trunk_of_mode<256>(cond_mode, carry);
    default: return nullptr;
  }
}

}  // namespace

namespace {

// info[0..7]: blocks per SM at smem_bytes of dynamic shared memory, SMs,
// registers a thread, local (spill) bytes a thread, static shared bytes, the
// dynamic shared bytes a block may opt in to, threads a block, and the
// kernel's dynamic shared memory opt-in as it stands.
cudaError_t persist_facts(int W, int cond_mode, bool carry, bool set, int smem_bytes, int device,
                          int* info) {
  const void* k = trunk_kernel(W, cond_mode, carry);
  if (k == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && set)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return err;
  if (!set) smem_bytes = attr.maxDynamicSharedSizeBytes;
  const int threads = W >= 128 ? WPT : PT;
  int per_sm = 0, sms = 0, optin = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem_bytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = (int)attr.sharedSizeBytes;
  info[5] = optin;
  info[6] = threads;
  info[7] = attr.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

}  // namespace

// What the card makes of the trunk kernel of width W (flow_persist_kernel at
// W 32 and 64, flow_wide_kernel at W 128 and 256; with carry, its carry twin)
// in cond_mode with smem_bytes of dynamic shared memory, opted in to first
// (persist_facts' info[0..7]).
extern "C" int flow_persist_info(int W, int cond_mode, int carry, int smem_bytes, int device,
                                 int* info) {
  return (int)persist_facts(W, cond_mode, carry != 0, true, smem_bytes, device, info);
}

// The same facts as the kernel stands, setting nothing: the dynamic shared
// memory is the opt-in its last launch set, the occupancy taken at it.
extern "C" int flow_persist_attrs(int W, int cond_mode, int carry, int device, int* info) {
  return (int)persist_facts(W, cond_mode, carry != 0, false, 0, device, info);
}

// Runs the call's layers; launched[KernelId] counts the launches enqueued.
extern "C" int flow_stack(const FlowArgs* args, int* launched) {
  const FlowArgs& a = *args;
  int kid = K_WIDE;
  const LayerFn layer = pick_layer_fn(a.W, a.cond_mode, &kid);
  const bool stream_mode = a.cond_mode == STREAM_BF16 || a.cond_mode == STREAM_F32;
  if (layer == nullptr || a.L < 1 || a.B < 1 || a.n_layers < 1 || a.num_stages < 1 ||
      a.num_stages > 30 || a.first_layer < 0 ||
      (stream_mode ? (a.cond_cols != a.n_layers * a.W || a.w_cond != nullptr)
                   : (a.cond_cols < 8 || a.cond_cols % 8 || a.w_cond == nullptr)) ||
      (a.n_layers > 1 && a.tmp == nullptr) || (a.state == nullptr) != (a.new_state == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kid == K_PERSIST &&
      (a.grid < 1 || a.grid > a.n_tiles || (long long)a.n_tiles * PBM < (long long)a.L * a.B ||
       (long long)(a.n_tiles - 1) * PBM >= (long long)a.L * a.B || a.stages < 2 * PG ||
       a.stages % PG || a.slot_bytes < 1 || a.smem_bytes < a.off_ring + a.stages * a.slot_bytes ||
       (!stream_mode && (a.enc_cols < 1 || a.enc_cols % (a.cond_mode == ENC_F32 ? 32 : 64)))))
    return (int)cudaErrorInvalidValue;
  if (kid == K_WIDE &&
      (a.grid < 1 || a.grid > a.n_tiles || (long long)a.n_tiles * WTR < (long long)a.L * a.B ||
       (long long)(a.n_tiles - 1) * WTR >= (long long)a.L * a.B || a.stages < 2 ||
       a.stages > 16 || a.slot_bytes < 1 || a.smem_bytes < a.off_ring + a.stages * a.slot_bytes ||
       a.off_bars + 16 * a.stages + 8 > a.off_ring ||
       (!stream_mode && a.enc_cols != (a.cond_mode == ENC_F32 ? 32 : WKC))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const float* state = static_cast<const float*>(a.state);
  float* new_state = static_cast<float*>(a.new_state);
  if (state != nullptr && static_cast<const void*>(state) == static_cast<const void*>(new_state))
    return (int)cudaErrorInvalidValue;  // the carry twins read the old state while writing the new

  const float* src = static_cast<const float*>(a.x);
  size_t off = 0;  // first state row of the layer
  for (int li = 0; li < a.n_layers; ++li) {
    const long long d = 1LL << ((a.first_layer + li) % a.num_stages);
    const long long shift = d * a.B;
    // alternate so that the last layer writes out and no layer writes its input
    float* dst = static_cast<float*>((a.n_layers - 1 - li) % 2 == 0 ? a.out : a.tmp);
    const float* hist = state == nullptr ? nullptr : state + off * a.B * a.W;
    float* new_hist = new_state == nullptr ? nullptr : new_state + off * a.B * a.W;
    err = layer(a, src, hist, dst, new_hist, li, shift, st);
    if (err != cudaSuccess) return (int)err;
    ++launched[kid];
    off += 2 * d;
    src = dst;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
