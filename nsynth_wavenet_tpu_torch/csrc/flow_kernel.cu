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
// Widths W = 32, 64, 128 and 256 are compiled (:168-171); any deconv width
// that is a multiple of 8; any number of layers a call (layers_per_call,
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
// Design (simple and right first).  The TPU kernel walks the length tiles in
// order on one core and keeps every layer's window in VMEM.  Here blocks run
// in any order and one 10-layer cycle's f32 history (2046 rows x W for each
// batch row) is over twice a block's shared memory, so the stream goes
// through device memory once per layer:
//   flow_layer_kernel<W, COND>  one launch per layer, a block per BM
//                      consecutive rows (128 up to W = 64, else 64).  Time-
//                      major makes a tap a pure row shift (row r - k*d*B),
//                      also into the history rows.  The bf16 product runs in
//                      K chunks of min(W, 64) columns (3W/KC tap chunks
//                      converted from f32, then, for ENC_BF16, the enc chunks
//                      with a masked tail when DW % KC != 0) through shared
//                      memory with the next chunk's loads in flight during
//                      the MMAs.  8 warps: 16 rows each, and from W = 128 on
//                      two warps split a row band's columns, so that a warp
//                      holds at most 8 accumulator tiles.  The gate is formed
//                      in shared memory, the K = W/2 product follows, and the
//                      epilogue adds the residual.  A layer never updates l in
//                      place (other blocks still read rows t-d and t-2d of its
//                      input): flow_stack alternates between two buffers so
//                      that the last layer writes out.
//                      ENC_F32 first runs the cond product on the CUDA cores
//                      (f32 FMA, SIMT, not TF32: a TF32 product keeps about
//                      three digits and is not the reference's function): K
//                      chunks of 32 of the encoding (transposed in shared
//                      memory) and w_cond, a TM x TN register tile a thread,
//                      into a second f32 tile in shared memory.  The stream
//                      modes copy their rows of the layer's cond columns
//                      there instead.  Shared memory is dynamic (up to
//                      149 KB at W = 256 with ENC_F32).
//   flow_state_kernel<ROUND>  with a state, one launch per layer: copies the
//                      new history out of (old history ++ input), which is a
//                      shifted copy of the old state where the call is shorter
//                      than 2d, rounding to bf16 for bf16 carries.  Old and
//                      new state are different buffers.
// Products use warp-level WMMA 16x16x16 bf16 tensor-core tiles.
//
// Bound (W = 64, DW = 256, a 10-layer call).  ENC_BF16: per row and layer
// 30 720 MACs = 61 440 FLOP at 989 TFLOP/s against 1 024 bytes that must move
// for the whole call (l read once, enc read once, l written once): the
// tensor cores bound the ideal kernel.  ENC_F32: the cond product's
// 16 384 MACs a row and layer run at the f32 FMA rate, 67 TFLOP/s on the H100
// SXM, which bounds the call (about 15x the bf16 products' time at these
// shapes); the f32 encoding doubles the bytes (1 536 a row).  This design does
// not reach either bound: it moves about 1.5 KB per row for EVERY layer
// (three f32 tap rows, the enc row, the residual re-read and the write; 2 KB
// with an f32 encoding), its SIMT product re-reads w_cond from L2 per block,
// and the measured times are in PERF.md.  Left on the table: several layers
// per launch with the small-dilation history in shared memory, bf16 tap
// reads, TMA-fed wgmma, a 3xTF32 cond product, one CUDA graph per synthesis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// Mirrored field for field by ops/flow_kernel.py _FlowArgs.
struct FlowArgs {
  const void* x;       // [L, B, W] f32 input stream
  const void* cond;    // encoding [L, B, DW] or stream [L, B, n_layers * W], bf16 or f32 by mode
  const void* w_tap;   // [n_layers, 3, W, W] bf16, tap 0 = t-2d
  const void* w_cond;  // [n_layers, DW, W] bf16 (ENC_BF16) or f32 (ENC_F32); null for a stream
  const void* bias;    // [n_layers, W] f32: b + b_cond with an encoding, b with a stream
  const void* w_res;   // [n_layers, W/2, W] bf16
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
};

enum CondMode { ENC_BF16 = 0, ENC_F32 = 1, STREAM_BF16 = 2, STREAM_F32 = 3 };

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int THREADS = 256;
constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }
constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// Tile shapes and the shared-memory layout of one width.
template <int W_>
struct Cfg {
  static constexpr int W = W_, M = W / 2;
  static constexpr int KC = W < 64 ? W : 64;     // K chunk of the bf16 products
  static constexpr int CPT = W / KC;             // K chunks per tap
  static constexpr int BM = W <= 64 ? 128 : 64;  // rows per block
  static constexpr int WARPS_M = BM / 16, WARPS_N = THREADS / 32 / WARPS_M;
  static constexpr int NW = W / WARPS_N, NFRAG = NW / 16;  // columns of a warp
  static constexpr int LDA = KC + 8, LDB = W + 8, LDC = W + 4, LDG = M + 8;
  // the f32 cond product: K chunks of KF, a TM x TN tile of sums a thread
  static constexpr int KF = 32, LDE = BM + 4;
  static constexpr int TN = W == 256 ? 8 : 4, TM = BM * W / THREADS / TN, TX = W / TN;
  // 16-byte vectors a thread moves per chunk or tile
  static constexpr int TAP_V = BM * KC / 4 / THREADS;   // f32 tap rows
  static constexpr int ENC_V = BM * KC / 8 / THREADS;   // bf16 enc rows
  static constexpr int WB_N = KC * W / 8;               // bf16 weight chunk
  static constexpr int WB_V = (WB_N + THREADS - 1) / THREADS;
  static constexpr int LIN_V = BM * W / 4 / THREADS;    // f32 stream tile
  static constexpr int SB_V = BM * W / 8 / THREADS;     // bf16 cond-stream tile
  static constexpr int EF_V = BM * KF / 4 / THREADS;    // f32 enc chunk
  static constexpr int WF_V = KF * W / 4 / THREADS;     // f32 w_cond chunk
  static constexpr int GATE_E = BM * M / THREADS;       // gate values
  // shared memory: region 1 holds As + Bs during the bf16 K loop, Es + Wf
  // during the f32 one, and Cs after either; Ds (the cond sums) only outside
  // ENC_BF16
  static constexpr int A_BYTES = align128(BM * LDA * 2), B_BYTES = align128(KC * LDB * 2);
  static constexpr int C_BYTES = align128(BM * LDC * 4);
  static constexpr int E_BYTES = align128(KF * LDE * 4), WF_BYTES = align128(KF * W * 4);
  static constexpr int R1 = max3(A_BYTES + B_BYTES, C_BYTES, E_BYTES + WF_BYTES);
  static constexpr int G_OFF = R1, BIAS_OFF = G_OFF + align128(BM * LDG * 2);
  static constexpr int D_OFF = BIAS_OFF + align128(2 * W * 4);
  static constexpr int smem_bytes(int cond) { return D_OFF + (cond == ENC_BF16 ? 0 : C_BYTES); }

  static_assert(BM == 16 * WARPS_M && W == NW * WARPS_N && NW % 16 == 0, "warp tiling");
  static_assert(W == KC * CPT && KC % 16 == 0 && M % 16 == 0, "K chunks");
  static_assert(TAP_V * THREADS * 4 == BM * KC && ENC_V * THREADS * 8 == BM * KC, "chunk split");
  static_assert(LIN_V * THREADS * 4 == BM * W && SB_V * THREADS * 8 == BM * W, "tile split");
  static_assert(EF_V * THREADS * 4 == BM * KF && WF_V * THREADS * 4 == KF * W, "f32 chunk split");
  static_assert(GATE_E * THREADS == BM * M && TM * TN * THREADS == BM * W, "thread split");
  static_assert(TM % 4 == 0 && TN % 4 == 0 && TX * (BM / TM) == THREADS, "SIMT tile");
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Every loop starts all of a thread's global loads before it uses any of
// them, and the next chunk is loaded into registers while the current one is
// in the tensor cores (or the FMA units).
template <int W, int COND>
__global__ void __launch_bounds__(THREADS, W >= 256 ? 1 : 2)
flow_layer_kernel(const float* __restrict__ l_in, const void* __restrict__ cond_v,
                  const float* __restrict__ hist, const bf16* __restrict__ w_tap,
                  const void* __restrict__ w_cond_v, const float* __restrict__ bias,
                  const bf16* __restrict__ w_res, const float* __restrict__ b_res,
                  float* __restrict__ l_out, int n_rows, long long shift, int cond_cols) {
  typedef Cfg<W> C;
  constexpr int M = C::M, KC = C::KC, LDA = C::LDA, LDB = C::LDB, LDC = C::LDC, LDG = C::LDG;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + C::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + C::G_OFF);
  float* bias_s = reinterpret_cast<float*>(smem + C::BIAS_OFF);
  float* Ds = reinterpret_cast<float*>(smem + C::D_OFF);
  const int row0 = blockIdx.x * C::BM;
  const int warp = threadIdx.x / 32, wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < 2 * W; i += THREADS) bias_s[i] = i < W ? bias[i] : b_res[i - W];

  if constexpr (COND == ENC_F32) {
    // Ds = enc @ w_cond in f32 on the CUDA cores; k runs in order in each sum
    const float* enc = static_cast<const float*>(cond_v);
    const float* wc = static_cast<const float*>(w_cond_v);
    const int DW = cond_cols;
    constexpr int KF = C::KF, LDE = C::LDE, TM = C::TM, TN = C::TN;
    float* Es = reinterpret_cast<float*>(smem);  // [KF][LDE]: the chunk transposed
    float* Wf = reinterpret_cast<float*>(smem + C::E_BYTES);  // [KF][W]
    const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    float4 re[C::EF_V], rw[C::WF_V];
    auto load_f = [&](int e) {
      const int k0 = e * KF;
#pragma unroll
      for (int i = 0; i < C::EF_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const long long r = (long long)row0 + v / (KF / 4);
        const int c = k0 + (v % (KF / 4)) * 4;
        re[i] = r < n_rows && c < DW ? *reinterpret_cast<const float4*>(enc + r * DW + c) : zero4;
      }
#pragma unroll
      for (int i = 0; i < C::WF_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const int kr = k0 + v / (W / 4);
        rw[i] = kr < DW ? *reinterpret_cast<const float4*>(wc + (size_t)kr * W + (v % (W / 4)) * 4)
                        : zero4;
      }
    };
    const int n_kf = (DW + KF - 1) / KF;
    load_f(0);
    for (int e = 0; e < n_kf; ++e) {
#pragma unroll
      for (int i = 0; i < C::EF_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const int row = v / (KF / 4), c = (v % (KF / 4)) * 4;
        Es[(c + 0) * LDE + row] = re[i].x;
        Es[(c + 1) * LDE + row] = re[i].y;
        Es[(c + 2) * LDE + row] = re[i].z;
        Es[(c + 3) * LDE + row] = re[i].w;
      }
#pragma unroll
      for (int i = 0; i < C::WF_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        *reinterpret_cast<float4*>(Wf + (v / (W / 4)) * W + (v % (W / 4)) * 4) = rw[i];
      }
      __syncthreads();
      if (e + 1 < n_kf) load_f(e + 1);
#pragma unroll 4
      for (int k = 0; k < KF; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(Es + k * LDE + ty * TM + 4 * q);
          a[4 * q] = t.x; a[4 * q + 1] = t.y; a[4 * q + 2] = t.z; a[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(Wf + k * W + tx * TN + 4 * q);
          b[4 * q] = t.x; b[4 * q + 1] = t.y; b[4 * q + 2] = t.z; b[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // Es and Wf are refilled, then taken over by As and Bs
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q)
        *reinterpret_cast<float4*>(Ds + (ty * TM + i) * LDC + tx * TN + 4 * q) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
  } else if constexpr (COND == STREAM_F32) {
    // cond_v points at this layer's first column; rows are cond_cols long
    const float* cs = static_cast<const float*>(cond_v);
#pragma unroll
    for (int i = 0; i < C::LIN_V; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int row = v / (W / 4), c = (v % (W / 4)) * 4;
      const long long r = (long long)row0 + row;
      *reinterpret_cast<float4*>(Ds + row * LDC + c) =
          r < n_rows ? *reinterpret_cast<const float4*>(cs + r * cond_cols + c) : zero4;
    }
  } else if constexpr (COND == STREAM_BF16) {
    const bf16* cs = static_cast<const bf16*>(cond_v);
#pragma unroll
    for (int i = 0; i < C::SB_V; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int row = v / (W / 8), c = (v % (W / 8)) * 8;
      const long long r = (long long)row0 + row;
      const uint4 raw = r < n_rows ? *reinterpret_cast<const uint4*>(cs + r * cond_cols + c) : zero;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(Ds + row * LDC + c) = make_float4(f0.x, f0.y, f1.x, f1.y);
      *reinterpret_cast<float4*>(Ds + row * LDC + c + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }

  // the bf16 product: chunk c < 3 * CPT is columns (c % CPT) * KC of the tap
  // at t - (2 - c / CPT) * d: row r - (2 - tap) * shift of the input, or of the
  // 2 * shift history rows that precede it; with ENC_BF16 later chunks are KC
  // columns of the enc row, zero past DW
  const bf16* enc = static_cast<const bf16*>(cond_v);
  const bf16* w_cond = static_cast<const bf16*>(w_cond_v);
  const int DW = cond_cols;
  const int n_chunks = 3 * C::CPT + (COND == ENC_BF16 ? (DW + KC - 1) / KC : 0);
  uint4 ra[C::TAP_V], rb[C::WB_V];
  auto load_chunk = [&](int c) {
    const bf16* wsrc;
    int wrows = KC;
    if (c < 3 * C::CPT) {
      const int tap = c / C::CPT, col0 = (c % C::CPT) * KC;
      const long long back = (long long)(2 - tap) * shift;
#pragma unroll
      for (int i = 0; i < C::TAP_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const long long r = (long long)row0 + v / (KC / 4);
        const long long src = r - back;
        const int col = col0 + (v % (KC / 4)) * 4;
        uint4 val = zero;
        if (r < n_rows) {
          if (src >= 0)
            val = *reinterpret_cast<const uint4*>(l_in + src * W + col);
          else if (hist != nullptr)
            val = *reinterpret_cast<const uint4*>(hist + (src + 2 * shift) * W + col);
        }
        ra[i] = val;
      }
      wsrc = w_tap + (size_t)c * KC * W;  // rows c * KC .. of the [3W, W] tap matrix
    } else {
      const int k0 = (c - 3 * C::CPT) * KC;
#pragma unroll
      for (int i = 0; i < C::ENC_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const long long r = (long long)row0 + v / (KC / 8);
        const int col = k0 + (v % (KC / 8)) * 8;
        ra[i] = r < n_rows && col < DW ? *reinterpret_cast<const uint4*>(enc + r * DW + col) : zero;
      }
      wsrc = w_cond + (size_t)k0 * W;
      wrows = DW - k0;
    }
#pragma unroll
    for (int i = 0; i < C::WB_V; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int kr = v / (W / 8);
      rb[i] = (C::WB_N % THREADS == 0 || v < C::WB_N) && kr < wrows
                  ? *reinterpret_cast<const uint4*>(wsrc + kr * W + (v % (W / 8)) * 8)
                  : zero;
    }
  };
  auto store_chunk = [&](int c) {
    if (c < 3 * C::CPT) {
#pragma unroll
      for (int i = 0; i < C::TAP_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(__uint_as_float(ra[i].x), __uint_as_float(ra[i].y));
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(__uint_as_float(ra[i].z), __uint_as_float(ra[i].w));
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(As + (v / (KC / 4)) * LDA + (v % (KC / 4)) * 4) = packed;
      }
    } else {
#pragma unroll
      for (int i = 0; i < C::ENC_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        *reinterpret_cast<uint4*>(As + (v / (KC / 8)) * LDA + (v % (KC / 8)) * 8) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < C::WB_V; ++i) {
      const int v = threadIdx.x + i * THREADS;
      if (C::WB_N % THREADS == 0 || v < C::WB_N)
        *reinterpret_cast<uint4*>(Bs + (v / (W / 8)) * LDB + (v % (W / 8)) * 8) = rb[i];
    }
  };

  FragC acc[C::NFRAG];
#pragma unroll
  for (int j = 0; j < C::NFRAG; ++j) wmma::fill_fragment(acc[j], 0.0f);
  load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    store_chunk(c);
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, As + wm * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < C::NFRAG; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + wn * C::NW + j * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }

  // the residual operand of the epilogue, fetched now so that its latency
  // hides behind the gate and the second product
  float4 lin[C::LIN_V];
#pragma unroll
  for (int i = 0; i < C::LIN_V; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const long long r = (long long)row0 + v / (W / 4);
    lin[i] = r < n_rows ? *reinterpret_cast<const float4*>(l_in + r * W + (v % (W / 4)) * 4) : zero4;
  }

#pragma unroll
  for (int j = 0; j < C::NFRAG; ++j)
    wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn * C::NW + j * 16, acc[j], LDC,
                            wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::GATE_E; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / M, c = e % M;
    float xs = Cs[r * LDC + c], xt = Cs[r * LDC + M + c];
    if constexpr (COND != ENC_BF16) {
      xs = xs + Ds[r * LDC + c];
      xt = xt + Ds[r * LDC + M + c];
    }
    xs = xs + bias_s[c];
    xt = xt + bias_s[M + c];
    Gs[r * LDG + c] = __float2bfloat16((1.0f / (1.0f + expf(-xs))) * tanhf(xt));
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < C::NFRAG; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < M; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, Gs + wm * 16 * LDG + kk, LDG);
#pragma unroll
    for (int j = 0; j < C::NFRAG; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, w_res + kk * W + wn * C::NW + j * 16, W);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < C::NFRAG; ++j)
    wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn * C::NW + j * 16, acc[j], LDC,
                            wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::LIN_V; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = v / (W / 4), col = (v % (W / 4)) * 4;
    const long long r = (long long)row0 + row;
    if (r < n_rows) {
      const float4 p = *reinterpret_cast<const float4*>(Cs + row * LDC + col);
      const float4 b = *reinterpret_cast<const float4*>(bias_s + W + col);
      float4 o;
      o.x = lin[i].x + p.x + b.x;
      o.y = lin[i].y + p.y + b.y;
      o.z = lin[i].z + p.z + b.z;
      o.w = lin[i].w + p.w + b.w;
      *reinterpret_cast<float4*>(l_out + r * W + col) = o;
    }
  }
}

// new_hist = the last hist_rows rows of (hist ++ l_in), rows of wv float4
// vectors; ROUND rounds every value to bf16 (bf16 carries).
template <bool ROUND>
__global__ void flow_state_kernel(const float4* __restrict__ l_in, const float4* __restrict__ hist,
                                  float4* __restrict__ new_hist, long long n_rows,
                                  long long hist_rows, int wv) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hist_rows * wv) return;
  const long long pos = n_rows + i / wv;  // row in (hist ++ l_in)
  const int q = (int)(i % wv);
  float4 v = pos < hist_rows ? hist[pos * wv + q] : l_in[(pos - hist_rows) * wv + q];
  if (ROUND) {
    v.x = bf16_round(v.x);
    v.y = bf16_round(v.y);
    v.z = bf16_round(v.z);
    v.w = bf16_round(v.w);
  }
  new_hist[i] = v;
}

typedef cudaError_t (*LayerFn)(const FlowArgs&, const float*, const float*, float*, int, long long,
                               cudaStream_t);

// one layer's launch: li is the layer's index within the call
template <int W, int COND>
cudaError_t launch_layer(const FlowArgs& a, const float* src, const float* hist, float* dst,
                         int li, long long shift, cudaStream_t st) {
  typedef Cfg<W> C;
  const int smem = C::smem_bytes(COND);
  auto kernel = flow_layer_kernel<W, COND>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long n_rows = (long long)a.L * a.B;
  const unsigned grid = (unsigned)((n_rows + C::BM - 1) / C::BM);
  const bool f32 = COND == ENC_F32 || COND == STREAM_F32;
  const char* cond = static_cast<const char*>(a.cond);
  const char* w_cond = static_cast<const char*>(a.w_cond);
  if (COND == STREAM_BF16 || COND == STREAM_F32)
    cond += (size_t)li * W * (f32 ? 4 : 2);  // the layer's columns of each stream row
  else
    w_cond += (size_t)li * a.cond_cols * W * (f32 ? 4 : 2);
  kernel<<<grid, THREADS, smem, st>>>(
      src, cond, hist, static_cast<const bf16*>(a.w_tap) + (size_t)li * 3 * W * W,
      COND == STREAM_BF16 || COND == STREAM_F32 ? nullptr : w_cond,
      static_cast<const float*>(a.bias) + (size_t)li * W,
      static_cast<const bf16*>(a.w_res) + (size_t)li * (W / 2) * W,
      static_cast<const float*>(a.b_res) + (size_t)li * W, dst, (int)n_rows, shift, a.cond_cols);
  return cudaGetLastError();
}

template <int W>
LayerFn layer_fn(int cond_mode) {
  switch (cond_mode) {
    case ENC_BF16: return launch_layer<W, ENC_BF16>;
    case ENC_F32: return launch_layer<W, ENC_F32>;
    case STREAM_BF16: return launch_layer<W, STREAM_BF16>;
    case STREAM_F32: return launch_layer<W, STREAM_F32>;
    default: return nullptr;
  }
}

LayerFn pick_layer_fn(int W, int cond_mode) {
  switch (W) {
    case 32: return layer_fn<32>(cond_mode);
    case 64: return layer_fn<64>(cond_mode);
    case 128: return layer_fn<128>(cond_mode);
    case 256: return layer_fn<256>(cond_mode);
    default: return nullptr;
  }
}

}  // namespace

extern "C" int flow_stack(const FlowArgs* args) {
  const FlowArgs& a = *args;
  const LayerFn layer = pick_layer_fn(a.W, a.cond_mode);
  const bool stream_mode = a.cond_mode == STREAM_BF16 || a.cond_mode == STREAM_F32;
  if (layer == nullptr || a.L < 1 || a.B < 1 || a.n_layers < 1 || a.num_stages < 1 ||
      a.num_stages > 30 || a.first_layer < 0 ||
      (stream_mode ? (a.cond_cols != a.n_layers * a.W || a.w_cond != nullptr)
                   : (a.cond_cols < 8 || a.cond_cols % 8 || a.w_cond == nullptr)) ||
      (a.n_layers > 1 && a.tmp == nullptr) || (a.state == nullptr) != (a.new_state == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const long long n_rows = (long long)a.L * a.B;
  const float* state = static_cast<const float*>(a.state);
  float* new_state = static_cast<float*>(a.new_state);
  const int wv = a.W / 4;

  const float* src = static_cast<const float*>(a.x);
  size_t off = 0;  // first state row of the layer
  for (int li = 0; li < a.n_layers; ++li) {
    const long long d = 1LL << ((a.first_layer + li) % a.num_stages);
    const long long shift = d * a.B;
    // alternate so that the last layer writes out and no layer writes its input
    float* dst = static_cast<float*>((a.n_layers - 1 - li) % 2 == 0 ? a.out : a.tmp);
    const float* hist = state == nullptr ? nullptr : state + off * a.B * a.W;
    err = layer(a, src, hist, dst, li, shift, st);
    if (err != cudaSuccess) return (int)err;
    if (new_state != nullptr) {
      const long long vecs = 2 * shift * wv;
      const unsigned blocks = (unsigned)((vecs + 255) / 256);
      const float4* in4 = reinterpret_cast<const float4*>(src);
      const float4* hist4 = reinterpret_cast<const float4*>(hist);
      float4* out4 = reinterpret_cast<float4*>(new_state + off * a.B * a.W);
      if (a.carry_bf16)
        flow_state_kernel<true><<<blocks, 256, 0, st>>>(in4, hist4, out4, n_rows, 2 * shift, wv);
      else
        flow_state_kernel<false><<<blocks, 256, 0, st>>>(in4, hist4, out4, n_rows, 2 * shift, wv);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    off += 2 * d;
    src = dst;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
