// One IAF flow's dilated trunk on Hopper (sm_90a): the student's serving kernel.
//
// Replaces the Pallas TPU kernel nsynth_wavenet_tpu/ops/flow_kernel.py
// make_flow_stack_fn (pallas_call at :383, kernel body :184-337) in its
// shipped configuration: fused taps, mel conditioning computed in the kernel
// from the raw deconv encoding, time-major streams, compact (bf16 enc and
// weights), one-shot or with a carried state.
//
// One call of flow_stack runs n_layers <= num_stages layers over a whole
// stream.  With l the f32 residual stream [L, B, W], row r = t * B + b, and
// d = 2^(layer % num_stages), per layer:
//   a   = bf16([l(t-2d), l(t-d), l(t)])        rows before t = 0: zeros, or the state
//   pre = a @ w_tap[3W, W] + enc(t) @ w_cond[DW, W] + b_eff          f32 sums
//   g   = sigmoid(pre[:W/2]) * tanh(pre[W/2:])
//   l'  = l + bf16(g) @ w_res[W/2, W] + b_res
// and, with a state, the layer's new history: the last 2d time steps of
// (old history ++ this call's input to the layer), f32.  The operands l, enc
// and g are rounded to bf16 exactly where ops/flow_kernel.py flow_stack_plain
// rounds them; every product accumulates in f32 and l stays f32.
//
// Design (simple and right first).  The TPU kernel walks the length tiles in
// order on one core and keeps every layer's window in VMEM.  Here blocks run
// in any order and one 10-layer cycle's f32 history (2046 rows x W for each
// batch row) is over twice a block's shared memory, so the stream goes
// through device memory once per layer:
//   flow_layer_kernel  one launch per layer, a block per 128 consecutive rows.
//                      Time-major makes a tap a pure row shift (row r - k*d*B),
//                      also into the history rows.  The K = 3W + DW product
//                      runs in 64-wide chunks (three tap chunks converted from
//                      f32, then the enc chunks) through shared memory with
//                      the next chunk's loads in flight during the MMAs; the
//                      gate is formed in shared memory, the K = W/2 product
//                      follows, and the epilogue adds the residual.  A layer
//                      never updates l in place (other blocks still read rows
//                      t-d and t-2d of its input): flow_stack alternates
//                      between two buffers so that the last layer writes out.
//   flow_state_kernel  with a state, one launch per layer: copies the new
//                      history out of (old history ++ input), which is a
//                      shifted copy of the old state where the call is shorter
//                      than 2d.  Old and new state are different buffers.
// Products use warp-level WMMA 16x16x16 bf16 tensor-core tiles.
//
// Bound (W = 64, DW = 256): per row and layer 30 720 MACs = 61 440 FLOP
// against 1 024 bytes that must move for a whole call (l read once, enc read
// once, l written once), i.e. 600 FLOP per byte for a 10-layer call: the
// tensor cores bound the ideal kernel (989 TFLOP/s bf16 against 3.35 TB/s).
// This design instead moves about 1.5 KB per row for EVERY layer (three f32
// tap rows, the enc row, the residual re-read and the write), so it is bound
// by bytes, about ten times the ideal traffic; how much of it L2 absorbs and
// the measured times are in PERF.md.  Left on the table: several layers per
// launch with the small-dilation history in shared memory, bf16 tap reads,
// TMA-fed wgmma, and one CUDA graph per synthesis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// Mirrored field for field by ops/flow_kernel.py _FlowArgs.
struct FlowArgs {
  const void* x;       // [L, B, W] f32 input stream
  const void* enc;     // [L, B, DW] bf16 conditioning
  const void* w_tap;   // [n_layers, 3, W, W] bf16, tap 0 = t-2d
  const void* w_cond;  // [n_layers, DW, W] bf16
  const void* b_eff;   // [n_layers, W] f32, dilated-conv bias + mel-cond bias
  const void* w_res;   // [n_layers, W/2, W] bf16
  const void* b_res;   // [n_layers, W] f32
  const void* state;   // [sum(2d), B, W] f32 carried history, or null (zeros)
  void* new_state;     // [sum(2d), B, W] f32, or null
  void* tmp;           // [L, B, W] f32 second stream buffer (null when n_layers == 1)
  void* out;           // [L, B, W] f32
  void* stream;        // cudaStream_t (PyTorch's current stream)
  int device;
  int L, B, W, DW, n_layers, first_layer, num_stages;
};

namespace {

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int W = 64, M = W / 2;  // stream width and gate half, fixed at compile time
constexpr int BM = 128, KC = 64, THREADS = 256;
constexpr int LDA = KC + 8;  // bf16 elements
constexpr int LDB = W + 8;   // bf16
constexpr int LDC = W + 4;   // f32
constexpr int LDG = M + 8;   // bf16
constexpr int A_BYTES = BM * LDA * 2, B_BYTES = KC * LDB * 2, C_BYTES = BM * LDC * 4;
constexpr int AB_BYTES = A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
constexpr int G_BYTES = BM * LDG * 2;
constexpr int TAP_V = BM * W / 4 / THREADS;   // 16-byte f32 vectors per thread per tap chunk
constexpr int ENC_V = BM * KC / 8 / THREADS;  // 16-byte bf16 vectors per thread per enc chunk
constexpr int WB_V = KC * W / 8 / THREADS;    // 16-byte weight vectors per thread per chunk
constexpr int GATE_E = BM * M / THREADS;      // gate values per thread
static_assert(W == KC && BM == 16 * (THREADS / 32), "a warp owns 16 rows; a tap chunk is a row");

// Every loop starts all of a thread's global loads before it uses any of
// them, and the next chunk is loaded into registers while the current one is
// in the tensor cores.
__global__ void __launch_bounds__(THREADS, 2)
flow_layer_kernel(const float* __restrict__ l_in, const bf16* __restrict__ enc,
                  const float* __restrict__ hist, const bf16* __restrict__ w_tap,
                  const bf16* __restrict__ w_cond, const float* __restrict__ b_eff,
                  const bf16* __restrict__ w_res, const float* __restrict__ b_res,
                  float* __restrict__ l_out, int n_rows, long long shift, int DW) {
  // Cs takes the place of As and Bs once the K loop is over
  __shared__ __align__(128) unsigned char smem[AB_BYTES + G_BYTES];
  __shared__ __align__(16) float bias_s[2 * W];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + AB_BYTES);
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int n_chunks = 3 + DW / KC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x < 2 * W)
    bias_s[threadIdx.x] = threadIdx.x < W ? b_eff[threadIdx.x] : b_res[threadIdx.x - W];

  // chunk c < 3 is the tap at t - (2 - c) * d: row r - (2 - c) * shift of the
  // input, or of the 2 * shift history rows that precede it; later chunks are
  // 64 columns of the enc row
  uint4 ra[TAP_V], rb[WB_V];
  auto load_chunk = [&](int c) {
    if (c < 3) {
      const long long back = (long long)(2 - c) * shift;
#pragma unroll
      for (int i = 0; i < TAP_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const long long r = (long long)row0 + (v >> 4);
        const long long src = r - back;
        const int col = (v & 15) * 4;
        uint4 val = zero;
        if (r < n_rows) {
          if (src >= 0)
            val = *reinterpret_cast<const uint4*>(l_in + src * W + col);
          else if (hist != nullptr)
            val = *reinterpret_cast<const uint4*>(hist + (src + 2 * shift) * W + col);
        }
        ra[i] = val;
      }
    } else {
      const int k0 = (c - 3) * KC;
#pragma unroll
      for (int i = 0; i < ENC_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const long long r = (long long)row0 + (v >> 3);
        ra[i] = r < n_rows ? *reinterpret_cast<const uint4*>(enc + r * DW + k0 + (v & 7) * 8) : zero;
      }
    }
    const bf16* wsrc = c < 3 ? w_tap + (size_t)c * KC * W : w_cond + (size_t)(c - 3) * KC * W;
#pragma unroll
    for (int i = 0; i < WB_V; ++i) {
      const int v = threadIdx.x + i * THREADS;
      rb[i] = *reinterpret_cast<const uint4*>(wsrc + (v >> 3) * W + (v & 7) * 8);
    }
  };
  auto store_chunk = [&](int c) {
    if (c < 3) {
#pragma unroll
      for (int i = 0; i < TAP_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(__uint_as_float(ra[i].x), __uint_as_float(ra[i].y));
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(__uint_as_float(ra[i].z), __uint_as_float(ra[i].w));
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(As + (v >> 4) * LDA + (v & 15) * 4) = packed;
      }
    } else {
#pragma unroll
      for (int i = 0; i < ENC_V; ++i) {
        const int v = threadIdx.x + i * THREADS;
        *reinterpret_cast<uint4*>(As + (v >> 3) * LDA + (v & 7) * 8) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < WB_V; ++i) {
      const int v = threadIdx.x + i * THREADS;
      *reinterpret_cast<uint4*>(Bs + (v >> 3) * LDB + (v & 7) * 8) = rb[i];
    }
  };

  FragC acc[W / 16];
#pragma unroll
  for (int j = 0; j < W / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  load_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    store_chunk(c);
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, As + warp * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + j * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }

  // the residual operand of the epilogue, fetched now so that its latency
  // hides behind the gate and the second product
  float4 lin[TAP_V];
#pragma unroll
  for (int i = 0; i < TAP_V; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const long long r = (long long)row0 + (v >> 4);
    lin[i] = r < n_rows ? *reinterpret_cast<const float4*>(l_in + r * W + (v & 15) * 4)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

#pragma unroll
  for (int j = 0; j < W / 16; ++j)
    wmma::store_matrix_sync(Cs + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < GATE_E; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / M, c = e % M;
    const float xs = Cs[r * LDC + c] + bias_s[c];
    const float xt = Cs[r * LDC + M + c] + bias_s[M + c];
    Gs[r * LDG + c] = __float2bfloat16((1.0f / (1.0f + expf(-xs))) * tanhf(xt));
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < W / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < M; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, Gs + warp * 16 * LDG + kk, LDG);
#pragma unroll
    for (int j = 0; j < W / 16; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, w_res + kk * W + j * 16, W);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < W / 16; ++j)
    wmma::store_matrix_sync(Cs + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TAP_V; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int row = v >> 4, col = (v & 15) * 4;
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

// new_hist = the last hist_rows rows of (hist ++ l_in), rows of W floats.
__global__ void flow_state_kernel(const float4* __restrict__ l_in, const float4* __restrict__ hist,
                                  float4* __restrict__ new_hist, long long n_rows,
                                  long long hist_rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hist_rows * (W / 4)) return;
  const long long pos = n_rows + i / (W / 4);  // row in (hist ++ l_in), W/4 vectors a row
  const int q = (int)(i % (W / 4));
  new_hist[i] = pos < hist_rows ? hist[pos * (W / 4) + q] : l_in[(pos - hist_rows) * (W / 4) + q];
}

}  // namespace

extern "C" int flow_stack(const FlowArgs* args) {
  const FlowArgs& a = *args;
  if (a.W != W || a.DW < KC || a.DW % KC || a.L < 1 || a.B < 1 || a.n_layers < 1 ||
      a.n_layers > a.num_stages || (a.n_layers > 1 && a.tmp == nullptr) ||
      (a.state == nullptr) != (a.new_state == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const long long n_rows = (long long)a.L * a.B;
  const unsigned grid = (unsigned)((n_rows + BM - 1) / BM);
  const bf16* w_tap = static_cast<const bf16*>(a.w_tap);
  const bf16* w_cond = static_cast<const bf16*>(a.w_cond);
  const bf16* w_res = static_cast<const bf16*>(a.w_res);
  const float* b_eff = static_cast<const float*>(a.b_eff);
  const float* b_res = static_cast<const float*>(a.b_res);
  const float* state = static_cast<const float*>(a.state);
  float* new_state = static_cast<float*>(a.new_state);

  const float* src = static_cast<const float*>(a.x);
  size_t off = 0;  // first state row of the layer
  for (int li = 0; li < a.n_layers; ++li) {
    const long long d = 1LL << ((a.first_layer + li) % a.num_stages);
    const long long shift = d * a.B;
    // alternate so that the last layer writes out and no layer writes its input
    float* dst = static_cast<float*>((a.n_layers - 1 - li) % 2 == 0 ? a.out : a.tmp);
    const float* hist = state == nullptr ? nullptr : state + off * a.B * W;
    flow_layer_kernel<<<grid, THREADS, 0, st>>>(
        src, static_cast<const bf16*>(a.enc), hist, w_tap + (size_t)li * 3 * W * W,
        w_cond + (size_t)li * a.DW * W, b_eff + (size_t)li * W, w_res + (size_t)li * M * W,
        b_res + (size_t)li * W, dst, (int)n_rows, shift, a.DW);
    if (new_state != nullptr) {
      const long long vecs = 2 * shift * (W / 4);
      flow_state_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>(
          reinterpret_cast<const float4*>(src), reinterpret_cast<const float4*>(hist),
          reinterpret_cast<float4*>(new_state + off * a.B * W), n_rows, 2 * shift);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    off += 2 * d;
    src = dst;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
