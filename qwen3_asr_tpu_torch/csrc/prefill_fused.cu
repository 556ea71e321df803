// The int8pc prefill's passes around its int8 products, fused: one launch
// each for what the op-by-op chain (`models/decoder.py::_prefill_layers`)
// runs as tens of PyTorch kernels a layer.
//
// Replaces no TPU kernel. In the JAX package XLA fuses these ops around the
// int8 dots of the prefill (qwen3_asr_tpu/models/decoder.py, the int8pc
// `_pc_matmul`). The products themselves stay `torch._int_mm`, as the JAX
// package leaves them to XLA. Four kernels, one row of the flattened B * P
// prompt rows a block:
//   pf_norm_quant          RMSNorm (optional), then the row's int8 codes and
//                          scale: the first layer's QKV input, and every
//                          layer's attention output (no norm) for Wo;
//   pf_qkv_epilogue        the QKV product dequantized, the per-head
//                          RMSNorm of q and k, NEOX RoPE; q, k, v in bf16;
//   pf_residual_norm_quant x + the product dequantized, then the codes of
//                          RMSNorm(that) for the next product (gate-up, or
//                          the next layer's QKV; none after the last layer);
//   pf_swiglu_quant        the gate-up product dequantized, silu(g) * u,
//                          then its codes for the down product;
//   pf_moe_combine         in an MoE layer (moe.cu's experts) in place of the
//                          last residual pass: x + the row's weighted expert
//                          outputs, then the next layer's codes.
// Codes land in the caller's zeroed buffer of `_int_mm`'s padded row count,
// so the product reads them as they lie (no pad copy).
//
// Numerics: the eager chain's operations at its rounding points. A row's
// scale is max(amax * f32(1/127), 1e-12), a code rint(x / sx) (a division,
// not a product with the reciprocal) clamped to +-127; a product element is
// bf16(f32(acc) * (sx * s)); bf16 adds and products round once each (the
// `__f*_rn` intrinsics keep nvcc from fusing a multiply into an add that the
// eager chain rounds in between); silu rounds to bf16 after each of its
// ops as `models/decoder.py::silu` does; RoPE's angle is f32(position) *
// inv_freq and its cos / sin are `cosf` / `sinf`, the functions PyTorch's
// own kernels call. The one freedom is the order of each norm's f32 sum of
// squares, which can move a bf16 rounding and so an int8 code.
//
// What bounds them on an H100: bytes. Each pass reads a product's int32
// output once (4 bytes a column: 16 KB a row for QKV, 24 KB for gate-up) and
// writes bf16 or int8 once; the operations are a few per byte. So a row
// lives in registers between its loads and its stores (8 columns a thread,
// 16-byte loads), its sums and maxima meet in shared memory, and nothing
// goes back to device memory between the dequantization, the norms, RoPE,
// the residual and the quantization, which the eager chain wrote and read
// again between each of its kernels.
#include "common.cuh"

namespace {

constexpr int MAXCH = 4;          // 8-column chunks a thread holds
constexpr int MAX_THREADS = 512;  // so a row of up to 16,384 columns
constexpr int QKV_THREADS = 256;
constexpr int MAX_HALF = 128;     // head_dim up to 256

// An 8-column chunk: bf16 in, bf16 out, int32 and f32 in.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void load8(const int* p, int (&v)[8]) {
  const int4 a = reinterpret_cast<const int4*>(p)[0], b = reinterpret_cast<const int4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One element of an int8pc product in bf16: bf16(f32(acc) * (sx * s)).
__device__ __forceinline__ float deq(int acc, float sx, float s) {
  return bf16_round(__fmul_rn((float)acc, __fmul_rn(sx, s)));
}

// A row of n columns, chunk c = threadIdx.x + k * blockDim.x (columns 8c ..
// 8c + 7) in v[k]; chunks past the row hold zeros.
struct Row {
  float v[MAXCH][8];
  int n8;

  __device__ __forceinline__ bool has(int k) const {
    return threadIdx.x + k * blockDim.x < n8;
  }
  __device__ __forceinline__ int col(int k) const {
    return 8 * (threadIdx.x + k * blockDim.x);
  }

  // RMSNorm as models/decoder.py::rms_norm: y = bf16(x * rsqrt(mean(x^2) +
  // eps)), then bf16(y * w).
  __device__ __forceinline__ void rms_norm(const __nv_bfloat16* w, float eps, int n,
                                           float* red) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < MAXCH; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = __fadd_rn(ss, __fmul_rn(v[k][i], v[k][i]));
    ss = block_sum(ss, red);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)n), eps));
#pragma unroll
    for (int k = 0; k < MAXCH; ++k) {
      if (!has(k)) continue;
      float wk[8];
      load8(w + col(k), wk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[k][i] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(v[k][i], r)), wk[i]));
    }
  }

  // The row's int8 codes and scale, as ops/q8_matmul.py::quantize_rows.
  __device__ __forceinline__ void quantize(int8_t* codes, float* sx_out, float inv127,
                                           float* red) {
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < MAXCH; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[k][i]));
    m = block_max(m, red);
    const float sx = fmaxf(__fmul_rn(m, inv127), 1e-12f);
#pragma unroll
    for (int k = 0; k < MAXCH; ++k) {
      if (!has(k)) continue;
      uint2 raw;
      int8_t* q = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        q[i] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[k][i], sx)), -127.f), 127.f);
      *reinterpret_cast<uint2*>(codes + col(k)) = raw;
    }
    if (threadIdx.x == 0) *sx_out = sx;
  }
};

__global__ void __launch_bounds__(MAX_THREADS)
pf_norm_quant(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
              float eps, float inv127, int n, int8_t* __restrict__ codes,
              float* __restrict__ sx) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  Row r;
  r.n8 = n >> 3;
#pragma unroll
  for (int k = 0; k < MAXCH; ++k) {
    if (r.has(k)) {
      load8(x + row * n + r.col(k), r.v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) r.v[k][i] = 0.f;
    }
  }
  if (w) r.rms_norm(w, eps, n, red);
  r.quantize(codes + row * n, sx + row, inv127, red);
}

__global__ void __launch_bounds__(MAX_THREADS)
pf_residual_norm_quant(const __nv_bfloat16* __restrict__ res, const int* __restrict__ acc,
                       const float* __restrict__ sx, const float* __restrict__ s,
                       const __nv_bfloat16* __restrict__ w, float eps, float inv127, int n,
                       __nv_bfloat16* __restrict__ out, int8_t* __restrict__ codes,
                       float* __restrict__ sx_out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const float sxr = sx[row];
  Row r;
  r.n8 = n >> 3;
#pragma unroll
  for (int k = 0; k < MAXCH; ++k) {
    if (!r.has(k)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) r.v[k][i] = 0.f;
      continue;
    }
    const int c = r.col(k);
    int a[8];
    float sc[8];
    load8(res + row * n + c, r.v[k]);
    load8(acc + row * n + c, a);
    load8(s + c, sc);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[k][i] = bf16_round(__fadd_rn(r.v[k][i], deq(a[i], sxr, sc[i])));
    store8(out + row * n + c, r.v[k]);
  }
  if (!w) return;
  r.rms_norm(w, eps, n, red);
  r.quantize(codes + row * n, sx_out + row, inv127, red);
}

__global__ void __launch_bounds__(MAX_THREADS)
pf_swiglu_quant(const int* __restrict__ acc, const float* __restrict__ sx,
                const float* __restrict__ s, float inv127, int F,
                int8_t* __restrict__ codes, float* __restrict__ sx_out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const float sxr = sx[row];
  const int* ar = acc + row * 2 * F;
  Row r;
  r.n8 = F >> 3;
#pragma unroll
  for (int k = 0; k < MAXCH; ++k) {
    if (!r.has(k)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) r.v[k][i] = 0.f;
      continue;
    }
    const int c = r.col(k);
    int ag[8], au[8];
    float sg[8], su[8];
    load8(ar + c, ag);
    load8(ar + F + c, au);
    load8(s + c, sg);
    load8(s + F + c, su);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float g = deq(ag[i], sxr, sg[i]), u = deq(au[i], sxr, su[i]);
      const float e = bf16_round(expf(-g));
      const float rc = bf16_round(__fdiv_rn(1.0f, bf16_round(__fadd_rn(1.0f, e))));
      r.v[k][i] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(g, rc)), u));
    }
  }
  r.quantize(codes + row * F, sx_out + row, inv127, red);
}

// The MoE layer's residual (moe.cu's experts): x = bf16(res + bf16(sum_k
// ys[row K + k])), the row's K weighted expert outputs summed in f32 in
// order k = 0 .. K - 1, then as pf_residual_norm_quant.
__global__ void __launch_bounds__(MAX_THREADS)
pf_moe_combine(const __nv_bfloat16* __restrict__ res, const float* __restrict__ ys, int K,
               const __nv_bfloat16* __restrict__ w, float eps, float inv127, int n,
               __nv_bfloat16* __restrict__ out, int8_t* __restrict__ codes,
               float* __restrict__ sx_out) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  Row r;
  r.n8 = n >> 3;
#pragma unroll
  for (int k = 0; k < MAXCH; ++k) {
    if (!r.has(k)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) r.v[k][i] = 0.f;
      continue;
    }
    const int c = r.col(k);
    float t[8], y[8];
    load8(ys + row * K * n + c, t);
    for (int e = 1; e < K; ++e) {
      load8(ys + (row * K + e) * n + c, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = __fadd_rn(t[i], y[i]);
    }
    load8(res + row * n + c, r.v[k]);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[k][i] = bf16_round(__fadd_rn(r.v[k][i], bf16_round(t[i])));
    store8(out + row * n + c, r.v[k]);
  }
  if (!w) return;
  r.rms_norm(w, eps, n, red);
  r.quantize(codes + row * n, sx_out + row, inv127, red);
}

// One warp a head: lane l holds the pairs (j, j + D/2) for j = l + 32 t.
__global__ void __launch_bounds__(QKV_THREADS)
pf_qkv_epilogue(const int* __restrict__ acc, const float* __restrict__ sx,
                const float* __restrict__ s, const __nv_bfloat16* __restrict__ qn,
                const __nv_bfloat16* __restrict__ kn, const float* __restrict__ inv_freq,
                int P, int NH, int NKV, int D, float eps, __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ v) {
  __shared__ float cs[MAX_HALF], sn[MAX_HALF];
  const size_t row = blockIdx.x;
  const int half = D >> 1, heads = NH + 2 * NKV;
  const float pos = (float)(int)(row % P);
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const float a = __fmul_rn(pos, inv_freq[j]);
    cs[j] = cosf(a);
    sn[j] = sinf(a);
  }
  __syncthreads();
  const float sxr = sx[row], inv_d = 1.0f / (float)D;
  const int lane = threadIdx.x & 31;
  const int* ar = acc + row * heads * D;
  for (int h = threadIdx.x >> 5; h < heads; h += blockDim.x >> 5) {
    const int c0 = h * D;
    float y1[MAX_HALF / 32], y2[MAX_HALF / 32], ss = 0.f;
#pragma unroll
    for (int t = 0; t < MAX_HALF / 32; ++t) {
      const int j = lane + 32 * t;
      y1[t] = y2[t] = 0.f;
      if (j < half) {
        y1[t] = deq(ar[c0 + j], sxr, s[c0 + j]);
        y2[t] = deq(ar[c0 + half + j], sxr, s[c0 + half + j]);
      }
      ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(y1[t], y1[t]), __fmul_rn(y2[t], y2[t])));
    }
    if (h >= NH + NKV) {   // v: the product as it is
      __nv_bfloat16* dst = v + (row * NKV + (h - NH - NKV)) * D;
#pragma unroll
      for (int t = 0; t < MAX_HALF / 32; ++t) {
        const int j = lane + 32 * t;
        if (j < half) {
          dst[j] = __float2bfloat16_rn(y1[t]);
          dst[half + j] = __float2bfloat16_rn(y2[t]);
        }
      }
      continue;
    }
    ss = warp_sum(ss);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
    const __nv_bfloat16* w = h < NH ? qn : kn;
    __nv_bfloat16* dst = h < NH ? q + (row * NH + h) * D : k + (row * NKV + (h - NH)) * D;
#pragma unroll
    for (int t = 0; t < MAX_HALF / 32; ++t) {
      const int j = lane + 32 * t;
      if (j >= half) continue;
      const float z1 = bf16_round(__fmul_rn(bf16_round(__fmul_rn(y1[t], r)), bf2f(w[j])));
      const float z2 =
          bf16_round(__fmul_rn(bf16_round(__fmul_rn(y2[t], r)), bf2f(w[half + j])));
      dst[j] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(z1, cs[j]), __fmul_rn(z2, sn[j])));
      dst[half + j] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(z2, cs[j]), __fmul_rn(z1, sn[j])));
    }
  }
}

// Threads for a row of n columns: 8 columns a thread, whole warps, at most
// MAX_THREADS; 0 if the row does not fit MAXCH chunks a thread.
int row_threads(int n) {
  if (n <= 0 || n % 8) return 0;
  const int n8 = n / 8;
  const int t = n8 < MAX_THREADS ? (n8 + 31) / 32 * 32 : MAX_THREADS;
  return (n8 + t - 1) / t <= MAXCH ? t : 0;
}

}  // namespace

// codes int8 [>= N, n] rows < N, sx f32 [N] = the int8 codes and row scales
// of RMSNorm(x) * w (w given) or of x; x bf16 [N, n]. Returns a cudaError_t
// code.
extern "C" int qw_pf_norm_quant(const void* x, const void* w, float eps, float inv127,
                                void* codes, void* sx, int N, int n, void* stream) {
  const int t = row_threads(n);
  if (!t || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  pf_norm_quant<<<N, t, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, eps, inv127, n, (int8_t*)codes,
      (float*)sx);
  return (int)cudaGetLastError();
}

// q [N, NH, D], k / v [N, NKV, D] bf16 from acc int32 [>= N, (NH + 2 NKV) D]
// (row scales sx [N], column scales s): q and k RMSNormed per head with qn /
// kn, then roped at position row % P with inv_freq f32 [D / 2].
extern "C" int qw_pf_qkv_epilogue(const void* acc, const void* sx, const void* s,
                                  const void* qn, const void* kn, const void* inv_freq,
                                  void* q, void* k, void* v, int N, int P, int NH, int NKV,
                                  int D, float eps, void* stream) {
  if (N < 0 || P <= 0 || NH <= 0 || NKV <= 0 || D <= 0 || D % 2 || D / 2 > MAX_HALF)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  pf_qkv_epilogue<<<N, QKV_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)acc, (const float*)sx, (const float*)s, (const __nv_bfloat16*)qn,
      (const __nv_bfloat16*)kn, (const float*)inv_freq, P, NH, NKV, D, eps,
      (__nv_bfloat16*)q, (__nv_bfloat16*)k, (__nv_bfloat16*)v);
  return (int)cudaGetLastError();
}

// out bf16 [N, n] = res + the product acc int32 [>= N, n] (scales sx [N], s
// [n]) in bf16; with w, codes / sx_out as qw_pf_norm_quant's of out.
extern "C" int qw_pf_residual_norm_quant(const void* res, const void* acc, const void* sx,
                                         const void* s, const void* w, float eps,
                                         float inv127, void* out, void* codes,
                                         void* sx_out, int N, int n, void* stream) {
  const int t = row_threads(n);
  if (!t || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  pf_residual_norm_quant<<<N, t, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)res, (const int*)acc, (const float*)sx, (const float*)s,
      (const __nv_bfloat16*)w, eps, inv127, n, (__nv_bfloat16*)out, (int8_t*)codes,
      (float*)sx_out);
  return (int)cudaGetLastError();
}

// codes int8 [>= N, F] rows < N, sx_out [N]: the codes of bf16 silu(g) * u,
// g and u the gate and up halves of acc int32 [>= N, 2 F] in bf16.
extern "C" int qw_pf_swiglu_quant(const void* acc, const void* sx, const void* s,
                                  float inv127, void* codes, void* sx_out, int N, int F,
                                  void* stream) {
  const int t = row_threads(F);
  if (!t || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  pf_swiglu_quant<<<N, t, 0, (cudaStream_t)stream>>>(
      (const int*)acc, (const float*)sx, (const float*)s, inv127, F, (int8_t*)codes,
      (float*)sx_out);
  return (int)cudaGetLastError();
}

// out bf16 [N, n] = res + bf16 of the sum of each row's K expert outputs ys
// f32 [N K, n] (pf_moe_combine); with w, codes / sx_out as
// qw_pf_norm_quant's of out.
extern "C" int qw_pf_moe_combine(const void* res, const void* ys, int K, const void* w,
                                 float eps, float inv127, void* out, void* codes, void* sx_out,
                                 int N, int n, void* stream) {
  const int t = row_threads(n);
  if (!t || N < 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  pf_moe_combine<<<N, t, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)res, (const float*)ys, K, (const __nv_bfloat16*)w, eps, inv127, n,
      (__nv_bfloat16*)out, (int8_t*)codes, (float*)sx_out);
  return (int)cudaGetLastError();
}
