// Q8_0 matrix products: x [T, in] times int8 weights with one f32 scale per
// (32-row block, column), dequantized on chip.
//
// Replaces, from qwen3_asr_tpu/ops/q8_matmul.py:
//   K5 q8_matmul.py::_q8_kernel       (x @ W),
//   K6 q8_matmul.py::_q8_norm_kernel  (RMSNorm(x) * norm_w @ W),
//   K7 q8_matmul.py::_q8_mlp_kernel   (the whole SwiGLU MLP: norm, gate and
//      up, silu(g) * u rounded to bf16, down).
// Numerics follow the Pallas bodies: the weight is dequantized as q * s in
// f32, or, where the reference picks bf16 (`_tile_for`: outputs of 2,048
// columns or more, and all of K7), as bf16(q * bf16(s)) with x rounded to
// bf16; products summed in f32. The norm is f32: x * rsqrt(mean(x^2) + eps)
// * w. Only the f32 summation order differs from the reference.
//
// What bounds them on an H100: bytes. At T = 1 (the decode step) each weight
// byte is used once and a column costs ~5 instructions per byte, far below
// the card's compute, so the floor is the int8 codes plus 1/8 of their size in
// scales over 3.35 TB/s (the 1,024 x 155,648 lm head: 179 MB, 53 us). The
// design for T = 1 (`q8_gemv`) reads each weight row segment as one 16-byte
// vector (16 neighbouring columns of int8 `[in, out]`, which is row major in
// `out`), loads the 16 column scales once per 8-row slice, keeps 8 row loads
// of a thread in flight at once, and splits `in` over 128 row slices per
// block (32 columns per block) so that even the 1,024-column products have 32
// blocks; the slices are summed in shared memory in a fixed order. For 1 < T
// <= 256 (short-prompt prefill) `q8_tiled` keeps a dequantized 32 x 64 weight
// tile in shared memory and reads it once for all T rows; it is simple and
// not yet fast. K7 is two launches behind one entry point: gate/up with the
// norm prologue and silu * mul into a bf16 [T, FF] buffer (the TPU kept it in
// VMEM scratch across its sequential grid), then down.
#include "common.cuh"

namespace {

constexpr int Q8_BLOCK = 32;
constexpr int GEMV_THREADS = 256;
constexpr int GEMV_SEGS = 2;                          // 16-column segments per block
constexpr int GEMV_COLS = 16 * GEMV_SEGS;             // 32 columns per block
constexpr int GEMV_SLICES = GEMV_THREADS / GEMV_SEGS; // 128 row slices
constexpr int GEMV_ROWS = 8;                          // rows per slice step
constexpr int MAX_IN = 4096;                          // widest x row of the GEMV
constexpr int TILE_THREADS = 256;
constexpr int TILE_COLS = 64;
constexpr int TILE_K = 32;
constexpr int MAX_T = 256;                            // rows of the tiled kernel

struct Q8Args {
  const void* x;     // [T, in] bf16 (x_bf16) or f32
  const void* nw;    // [in] norm weight (bf16 if nw_bf16, else f32), or null
  const int8_t* q;   // [in, ldq]
  const float* s;    // [in / 32, ldq]
  void* out;         // f32 [T, N]; in the gate/up mode bf16 [T, gu_ff]
  int T, in, N, ldq;
  int x_bf16, nw_bf16;
  int gu_ff;         // > 0: gate columns [0, FF), up columns [FF, 2FF)
  float eps;
};

__device__ __forceinline__ float load_f(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? bf2f(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// One weight column's dequantized value.
template <bool BF16>
__device__ __forceinline__ float deq(int8_t q, float s) {
  const float w = (float)q * s;  // exact in f32 when s is a bf16 value
  return BF16 ? bf16_round(w) : w;
}

// -- T = 1 --------------------------------------------------------------------
//
// Block x: output columns [32x, 32x + 32), or, in the gate/up mode, gate
// columns [16x, 16x + 16) (segment 0) and the same up columns (segment 1).
// Thread (slice, seg) sums rows of 8-row slices slice, slice + 128, ... for its
// 16 columns; the slices are then reduced in shared memory.
template <bool BF16>
__global__ void __launch_bounds__(GEMV_THREADS) q8_gemv(Q8Args a) {
  __shared__ float xs[MAX_IN];
  __shared__ float red[GEMV_SLICES][GEMV_COLS + 1];
  __shared__ float red2[GEMV_THREADS / GEMV_COLS][GEMV_COLS];
  __shared__ float tot[GEMV_COLS];
  __shared__ float scratch[32];
  const int tid = threadIdx.x;

  // the x row: f32, the norm prologue, rounding to the dequant dtype
  float ss = 0.f;
  for (int k = tid; k < a.in; k += blockDim.x) {
    const float v = load_f(a.x, k, a.x_bf16);
    xs[k] = v;
    ss += v * v;
  }
  float r = 1.f;
  if (a.nw) r = rsqrtf(block_sum(ss, scratch) / (float)a.in + a.eps);
  for (int k = tid; k < a.in; k += blockDim.x) {
    float v = xs[k];
    if (a.nw) v = v * r * load_f(a.nw, k, a.nw_bf16);
    xs[k] = BF16 ? bf16_round(v) : v;
  }
  __syncthreads();

  const int seg = tid % GEMV_SEGS, slice = tid / GEMV_SEGS;
  const int col = a.gu_ff ? (seg ? a.gu_ff : 0) + blockIdx.x * 16
                          : blockIdx.x * GEMV_COLS + seg * 16;
  float acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0.f;
  for (int r0 = slice * GEMV_ROWS; r0 < a.in; r0 += GEMV_SLICES * GEMV_ROWS) {
    float sc[16];
    const float4* sp = reinterpret_cast<const float4*>(
        a.s + (size_t)(r0 / Q8_BLOCK) * a.ldq + col);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 f = sp[v];
      sc[4 * v] = f.x;
      sc[4 * v + 1] = f.y;
      sc[4 * v + 2] = f.z;
      sc[4 * v + 3] = f.w;
    }
    if (BF16) {
#pragma unroll
      for (int c = 0; c < 16; ++c) sc[c] = bf16_round(sc[c]);
    }
    uint4 w[GEMV_ROWS];
#pragma unroll
    for (int i = 0; i < GEMV_ROWS; ++i)
      w[i] = *reinterpret_cast<const uint4*>(a.q + (size_t)(r0 + i) * a.ldq + col);
#pragma unroll
    for (int i = 0; i < GEMV_ROWS; ++i) {
      const float xv = xs[r0 + i];
      const uint32_t words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int8_t qv = (int8_t)((words[c >> 2] >> (8 * (c & 3))) & 0xffu);
        acc[c] = fmaf(xv, deq<BF16>(qv, sc[c]), acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) red[slice][seg * 16 + c] = acc[c];
  __syncthreads();
  {
    const int j = tid % GEMV_COLS, part = tid / GEMV_COLS;
    constexpr int PER = GEMV_SLICES / (GEMV_THREADS / GEMV_COLS);
    float v = 0.f;
    for (int sl = part * PER; sl < (part + 1) * PER; ++sl) v += red[sl][j];
    red2[part][j] = v;
  }
  __syncthreads();
  if (tid < GEMV_COLS) {
    float v = 0.f;
    for (int p = 0; p < GEMV_THREADS / GEMV_COLS; ++p) v += red2[p][tid];
    if (a.gu_ff) tot[tid] = v;
    else reinterpret_cast<float*>(a.out)[blockIdx.x * GEMV_COLS + tid] = v;
  }
  if (a.gu_ff) {
    __syncthreads();
    if (tid < 16) {
      reinterpret_cast<__nv_bfloat16*>(a.out)[blockIdx.x * 16 + tid] =
          __float2bfloat16_rn(silu_mul(tot[tid], tot[16 + tid]));
    }
  }
}

// -- 1 < T <= 256 -------------------------------------------------------------
//
// Block x: 64 weight columns (in the gate/up mode 32 gate and the same 32 up
// columns) for all T rows. Per 32-row chunk of `in`: the normed, rounded x
// chunk [T, 32] and the dequantized weight tile [32, 64] go to shared memory;
// warp w accumulates rows w, w + 8, ... for tile columns lane and lane + 32.
template <bool BF16>
__global__ void __launch_bounds__(TILE_THREADS) q8_tiled(Q8Args a) {
  __shared__ float xs[MAX_T][TILE_K + 1];
  __shared__ float ws[TILE_K][TILE_COLS];
  __shared__ float rs[MAX_T];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = TILE_THREADS / 32;
  if (a.nw) {
    for (int t = warp; t < a.T; t += nwarps) {
      float ss = 0.f;
      for (int k = lane; k < a.in; k += 32) {
        const float v = load_f(a.x, (size_t)t * a.in + k, a.x_bf16);
        ss += v * v;
      }
      ss = warp_sum(ss);
      if (lane == 0) rs[t] = rsqrtf(ss / (float)a.in + a.eps);
    }
    __syncthreads();
  }
  auto wcol = [&](int cc) {
    if (a.gu_ff) return (cc < 32 ? 0 : a.gu_ff) + blockIdx.x * 32 + (cc & 31);
    return blockIdx.x * TILE_COLS + cc;
  };
  float acc0[MAX_T / 8], acc1[MAX_T / 8];
#pragma unroll
  for (int i = 0; i < MAX_T / 8; ++i) acc0[i] = acc1[i] = 0.f;
  for (int k0 = 0; k0 < a.in; k0 += TILE_K) {
    for (int idx = tid; idx < a.T * TILE_K; idx += TILE_THREADS) {
      const int t = idx / TILE_K, kk = idx % TILE_K;
      float v = load_f(a.x, (size_t)t * a.in + k0 + kk, a.x_bf16);
      if (a.nw) v = v * rs[t] * load_f(a.nw, k0 + kk, a.nw_bf16);
      xs[t][kk] = BF16 ? bf16_round(v) : v;
    }
    for (int idx = tid; idx < TILE_K * TILE_COLS; idx += TILE_THREADS) {
      const int kk = idx / TILE_COLS, cc = idx % TILE_COLS;
      const int c = wcol(cc);
      float s = a.s[(size_t)(k0 / Q8_BLOCK) * a.ldq + c];
      if (BF16) s = bf16_round(s);
      ws[kk][cc] = deq<BF16>(a.q[(size_t)(k0 + kk) * a.ldq + c], s);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TILE_K; ++kk) {
      const float w0 = ws[kk][lane], w1 = ws[kk][lane + 32];
#pragma unroll
      for (int i = 0; i < MAX_T / 8; ++i) {
        const int t = warp + 8 * i;
        if (t < a.T) {
          const float xv = xs[t][kk];
          acc0[i] = fmaf(xv, w0, acc0[i]);
          acc1[i] = fmaf(xv, w1, acc1[i]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MAX_T / 8; ++i) {
    const int t = warp + 8 * i;
    if (t >= a.T) break;
    if (a.gu_ff) {
      reinterpret_cast<__nv_bfloat16*>(a.out)[(size_t)t * a.gu_ff + blockIdx.x * 32 + lane] =
          __float2bfloat16_rn(silu_mul(acc0[i], acc1[i]));
    } else {
      float* o = reinterpret_cast<float*>(a.out) + (size_t)t * a.N + blockIdx.x * TILE_COLS;
      o[lane] = acc0[i];
      o[lane + 32] = acc1[i];
    }
  }
}

bool args_ok(const Q8Args& a) {
  if (a.T < 1 || a.T > MAX_T || a.in <= 0 || a.in % Q8_BLOCK) return false;
  if (a.T == 1 && a.in > MAX_IN) return false;
  if (a.ldq % TILE_COLS) return false;
  if (a.gu_ff) return a.gu_ff % 32 == 0 && a.ldq >= 2 * a.gu_ff;
  return a.N % TILE_COLS == 0 && a.ldq >= a.N;
}

void launch(const Q8Args& a, bool bf16, cudaStream_t st) {
  if (a.T == 1) {
    const int blocks = a.gu_ff ? a.gu_ff / 16 : a.N / GEMV_COLS;
    if (bf16) q8_gemv<true><<<blocks, GEMV_THREADS, 0, st>>>(a);
    else q8_gemv<false><<<blocks, GEMV_THREADS, 0, st>>>(a);
  } else {
    const int blocks = a.gu_ff ? a.gu_ff / 32 : a.N / TILE_COLS;
    if (bf16) q8_tiled<true><<<blocks, TILE_THREADS, 0, st>>>(a);
    else q8_tiled<false><<<blocks, TILE_THREADS, 0, st>>>(a);
  }
}

}  // namespace

// K5 (nw null) and K6 (nw given): out f32 [T, n_out] = (RMSNorm(x) * nw or x)
// @ dequant(q, s); q int8 [n_in, n_out], s f32 [n_in / 32, n_out]. deq_bf16
// selects the bf16 dequant of the reference's wide-output tiles. Returns a
// cudaError_t code.
extern "C" int qw_q8_matmul(const void* x, int x_bf16, const void* nw, int nw_bf16,
                            float eps, const void* q, const void* s, void* out, int T,
                            int n_in, int n_out, int deq_bf16, void* stream) {
  Q8Args a{x, nw, (const int8_t*)q, (const float*)s, out, T, n_in, n_out, n_out,
           x_bf16, nw_bf16, 0, eps};
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  launch(a, deq_bf16 != 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K7: out f32 [T, n_out] = (bf16(silu(g) * u)) @ dequant(qd, sd), with g, u
// = bf16(RMSNorm(x) * nw) @ dequant(qgu, sgu) over the gate and up halves of
// the fused [n_in, 2 FF] weight; bf16 dequant throughout. `ffn` is the
// caller's bf16 [T, FF] buffer between the two launches.
extern "C" int qw_q8_mlp(const void* x, int x_bf16, const void* nw, int nw_bf16, float eps,
                         const void* qgu, const void* sgu, const void* qd, const void* sd,
                         void* ffn, void* out, int T, int n_in, int FF, int n_out,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Q8Args gu{x, nw, (const int8_t*)qgu, (const float*)sgu, ffn, T, n_in, FF, 2 * FF,
            x_bf16, nw_bf16, FF, eps};
  Q8Args dn{ffn, nullptr, (const int8_t*)qd, (const float*)sd, out, T, FF, n_out, n_out,
            1, 0, 0, eps};
  if (!nw || !args_ok(gu) || !args_ok(dn)) return (int)cudaErrorInvalidValue;
  launch(gu, true, st);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  launch(dn, true, st);
  return (int)cudaGetLastError();
}
