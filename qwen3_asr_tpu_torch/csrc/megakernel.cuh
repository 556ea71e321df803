// Device code shared by the single-sequence decode step (megakernel.cu, K1)
// and the batched one (megakernel_batch.cu, K3): the per-row norm /
// quantization kernel, the element math of the rows (resid_of, silu_of)
// and K1's GEMV input prologues that compute the same codes, attention and
// the lm-head argmax of one Qwen3 decode step on int4 or int8 weights over
// an int8, bf16 or (K1 only) int4 KV cache.
//
// Every kernel here works on one sequence ("row") per block index along its
// row axis and never mixes rows, so the batched step computes each row with
// the same instructions and the same f32 summation orders as the
// single-sequence step: K3's rows equal K1 run on the row's slab alone, bit
// for bit. Both read each row's position from a device array (`pos_arr`,
// one int32 for K1), so a step does not depend on a host value and K1's can
// be captured once in a CUDA graph and replayed at every position;
// MegaDims::pos is the host's upper bound of the positions, which sizes the
// attention grid (K1: S - 1, blocks past the row's position exit).
#pragma once

#include <cuda_pipeline.h>

#include <type_traits>

#include "common.cuh"

// The C entry points' arguments (plain structs with external linkage: a type
// from the anonymous namespace would hide the extern "C" functions). For the
// batched step every activation pointer is [B, ...] and the caches are
// [B, L, S, ...]: slab b is a single-sequence cache.
struct MegaPtrs {
  const void* embd;        // [V, H] bf16 token embedding (for token input)
  const void* attn_norm;   // [L, H] f32
  const void* ffn_norm;    // [L, H] f32
  const void* q_norm;      // [L, D] f32
  const void* k_norm;      // [L, D] f32
  const void* out_norm;    // [H] f32
  const void* qkv_q;       // [L, H/2, DQ+2DKV] packed int4, or [L, H, ...] int8
  const void* qkv_s;       // [L, H/g_qkv, DQ+2DKV] f32 (int8: [L, DQ+2DKV])
  const void* wo_q;        // [L, DQ/2, H]
  const void* wo_s;
  const void* gu_q;        // [L, H/2, 2FF]
  const void* gu_s;
  const void* wd_q;        // [L, FF/2, H]
  const void* wd_s;
  const void* head_q;      // [H/2, Vp] (int8: [H, Vp])
  const void* head_s;      // [H/g_head, Vp] (int8: [Vp])
  void* k_cache;           // [L, S, DKV] int8 or bf16, or [L, S/2, DKV] int4 pairs
  void* v_cache;
  void* k_scale;           // [L, S, NKV] f32 (int8 / int4 cache; null for bf16)
  void* v_scale;
  const void* token_in;    // [1] int32, or null when x_in is given
  const void* x_in;        // [H] bf16, or null
  void* token_out;         // [1] int32
  void* h_out;             // [H] f32: hidden state before the final norm
  void* scratch;           // qw_mega_scratch_bytes(dims) bytes
};

// pos: the host's upper bound of the rows' positions, which sizes the
// attention grid (the positions themselves are on the device). wbits: 4
// (the int4 pack, scale groups g_*) or 8 (the int8 pack: one scale per
// column, every g_* equal to its product's input dim). pdl: K1 launches its
// GEMVs with programmatic dependent launch (K3 always launches its products
// so).
struct MegaDims {
  int L, H, NH, NKV, D, FF, V, Vp, S, pos;
  int g_qkv, g_wo, g_gu, g_wd, g_head;
  int wbits, pdl;
  float eps, rope_coef, scale;
};

namespace {

constexpr int NORM_THREADS = 1024;
constexpr int NORM_MAX = 4096;     // widest row the norm/quant kernels take
constexpr int ATTN_THREADS = 256;
constexpr int ATTN_ROWS = 64;      // cache rows per attention chunk block
constexpr int ARGMAX_THREADS = 256;
constexpr int ARGMAX_COLS = 4096;  // vocab columns per argmax block
constexpr int I8_SPLIT = 512;      // input rows per block of an int8 GEMV
constexpr int I8_MAX_SPLIT = 1024; // largest unsplit input dim it takes

// The int4 cache's element: one byte holding column e of two neighbouring
// cache rows, row 2r in the low nibble and row 2r + 1 in the high one (the
// order of qwen3_asr_tpu/ops/megakernel.py::pack_kv_int4 and of the port's
// unpack_nibbles). A cache of nib2 is [L, S/2, DKV] with f32 scales per
// (row, head), [L, S, NKV], as the int8 cache has.
struct nib2 {
  uint8_t b;
};

// Cache rows per stored row (2 for nib2) and whether rows carry scales.
template <typename CT>
__host__ __device__ constexpr int rows_per_elem() {
  return std::is_same<CT, nib2>::value ? 2 : 1;
}
template <typename CT>
__host__ __device__ constexpr bool scaled_cache() {
  return !std::is_same<CT, __nv_bfloat16>::value;
}

__host__ __device__ inline int n_attn_chunks(int rows) {
  return (rows + ATTN_ROWS - 1) / ATTN_ROWS;
}

inline size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

inline int n_argmax_blocks(const MegaDims& d) { return (d.V + ARGMAX_COLS - 1) / ARGMAX_COLS; }

// floats of one row's GEMV group terms: the largest [in/G, out] product
inline size_t terms_floats(const MegaDims& d) {
  const int DQ = d.NH * d.D, DKV = d.NKV * d.D;
  size_t m = (size_t)(d.H / d.g_qkv) * (DQ + 2 * DKV);
  m = m > (size_t)(DQ / d.g_wo) * d.H ? m : (size_t)(DQ / d.g_wo) * d.H;
  m = m > (size_t)(d.H / d.g_gu) * 2 * d.FF ? m : (size_t)(d.H / d.g_gu) * 2 * d.FF;
  m = m > (size_t)(d.FF / d.g_wd) * d.H ? m : (size_t)(d.FF / d.g_wd) * d.H;
  m = m > (size_t)(d.H / d.g_head) * d.Vp ? m : (size_t)(d.H / d.g_head) * d.Vp;
  return m;
}

// The widest output of the step's products (the lm head's Vp in practice).
inline int widest_out(const MegaDims& d) {
  const int DQ = d.NH * d.D, NQKV = DQ + 2 * d.NKV * d.D;
  int w = NQKV > 2 * d.FF ? NQKV : 2 * d.FF;
  w = w > d.H ? w : d.H;
  return w > d.Vp ? w : d.Vp;
}

// Input rows per block of an int8 GEMV over n_in rows: I8_SPLIT when it
// divides n_in, else all of them (one block row, no cross-block sum).
__host__ __device__ inline int split_rows(int n_in) {
  return n_in % I8_SPLIT == 0 ? I8_SPLIT : n_in;
}

inline int widest_row(const MegaDims& d) {
  const int DQ = d.NH * d.D;
  int w = d.H > DQ ? d.H : DQ;
  return w > d.FF ? w : d.FF;
}

// The checks both entry points make on their dimensions.
inline bool dims_ok(const MegaDims& d, int gemv_cols, int max_group) {
  const int DQ = d.NH * d.D, DKV = d.NKV * d.D, NQKV = DQ + 2 * DKV;
  if (d.H > NORM_MAX || DQ > NORM_MAX || d.FF > NORM_MAX) return false;
  if (d.NH % d.NKV || d.D % 16 || d.pos < 1 || d.pos >= d.S) return false;
  const int gs[5] = {d.g_qkv, d.g_wo, d.g_gu, d.g_wd, d.g_head};
  const int ins[5] = {d.H, DQ, d.H, d.FF, d.H};
  for (int i = 0; i < 5; ++i) {
    if (d.wbits == 4) {
      if (gs[i] <= 0 || gs[i] % 4 || gs[i] > max_group) return false;
    } else if (d.wbits == 8) {
      const int kc = split_rows(ins[i]);
      if (gs[i] != ins[i] || kc % 4 || kc > I8_MAX_SPLIT) return false;
    } else {
      return false;
    }
  }
  if (NQKV % gemv_cols || d.H % gemv_cols || (2 * d.FF) % gemv_cols || d.Vp % gemv_cols)
    return false;
  return true;
}

// A chunk stages ATTN_ROWS cache rows of K and of V: at D = 128, 32 KB of
// bf16 rows (under the 48 KB static limit), 16 KB of int8, 8 KB of int4;
// then floats vec[(GROUP + 2) * D] (q, k, v), p[GROUP][ATTN_ROWS] (the
// merge's misc[3 * GROUP] after), ml[2 * GROUP], kss, vss[ATTN_ROWS].
template <typename CT>
inline size_t attn_smem(const MegaDims& d) {
  const int GROUP = d.NH / d.NKV;
  return 2 * (size_t)(ATTN_ROWS / rows_per_elem<CT>()) * d.D * sizeof(CT) +
         sizeof(float) * ((size_t)(GROUP + 2) * d.D + GROUP * (ATTN_ROWS + 2) +
                          2 * ATTN_ROWS);
}


// -- per-row RMSNorm + residual + int8 quantization ------------------------
//
// The element math of the row kernels below and of the GEMV prologues that
// replace them on K1's path (RowIn, row_codes): one definition, so both give
// the same codes.

// The residual sum from the row's value x and its product's group sum t:
// bf16(x + bf16(t)).
__device__ __forceinline__ float resid_of(float x, float t) {
  return bf16_round(x + bf16_round(t));
}

// The SwiGLU activation from the gate and up group sums:
// bf16(silu(bf16(g)) * bf16(u)).
__device__ __forceinline__ float silu_of(float g, float u) {
  g = bf16_round(g);
  u = bf16_round(u);
  return bf16_round((g * (1.f / (1.f + expf(-g)))) * u);
}

// x = base (+ bf16(sum_g terms[g]) when terms is given, rounded to bf16)
__device__ __forceinline__ float resid_elem(const __nv_bfloat16* __restrict__ base,
                                            const float* __restrict__ terms, int n_g, int N,
                                            int n) {
  float x = bf2f(base[n]);
  if (terms) {
    float t = terms[n];
    for (int g = 1; g < n_g; ++g) t += terms[(size_t)g * N + n];
    x = resid_of(x, t);
  }
  return x;
}

// act = bf16(silu(bf16(gate)) * bf16(up)) in f32 from the gate-up terms [n_g][2FF]
__device__ __forceinline__ float silu_elem(const float* __restrict__ terms, int n_g, int FF,
                                           int n) {
  const int N2 = 2 * FF;
  float g = terms[n], u = terms[FF + n];
  for (int k = 1; k < n_g; ++k) {
    g += terms[(size_t)k * N2 + n];
    u += terms[(size_t)k * N2 + FF + n];
  }
  return silu_of(g, u);
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax * (1.f / 127.f), 1e-12f);
}

__device__ __forceinline__ int8_t quant_code(float y, float sx) {
  return (int8_t)fminf(fmaxf(rintf(y / sx), -127.f), 127.f);
}

// Block = row. x = resid_elem(...), y = bf16(rms(x) * w) (or x when w is
// null), then xq = rint(y / sx) with sx = max(amax / 127, 1e-12). `base` is
// a bf16 [N] row, or the embedding row of token[row] when token is
// non-null. Row strides: N for base / x_out / h_out, ts for terms, qs for
// xq. The sum of squares is each thread's strided sum, then block_sum: the
// order row_codes reproduces with fewer threads.
__global__ void __launch_bounds__(NORM_THREADS) norm_quant(
    const __nv_bfloat16* __restrict__ base, const __nv_bfloat16* __restrict__ embd,
    const int* __restrict__ token, const float* __restrict__ terms, int n_g,
    int N, const float* __restrict__ w, float eps, __nv_bfloat16* __restrict__ x_out,
    float* __restrict__ h_out, int8_t* __restrict__ xq, float* __restrict__ sx_out,
    size_t ts, size_t qs) {
  __shared__ float xs[NORM_MAX];
  __shared__ float red[32];
  const int row = blockIdx.x;
  if (token) base = embd + (size_t)token[row] * N;
  else base += (size_t)row * N;
  if (terms) terms += row * ts;
  if (x_out) x_out += (size_t)row * N;
  if (h_out) h_out += (size_t)row * N;
  xq += row * qs;
  float sq = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float x = resid_elem(base, terms, n_g, N, n);
    if (x_out) x_out[n] = __float2bfloat16_rn(x);
    if (h_out) h_out[n] = x;
    xs[n] = x;
    sq = fmaf(x, x, sq);
  }
  float r = 1.f;
  if (w) {
    const float tot = block_sum(sq, red);
    r = rsqrtf(tot / (float)N + eps);
  }
  float amax = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float y = xs[n];
    if (w) y = bf16_round(y * r * w[n]);
    xs[n] = y;
    amax = fmaxf(amax, fabsf(y));
  }
  amax = block_max(amax, red);
  const float sx = quant_scale(amax);
  for (int n = threadIdx.x; n < N; n += blockDim.x) xq[n] = quant_code(xs[n], sx);
  if (threadIdx.x == 0) sx_out[row] = sx;
}

// -- GEMV input prologues (K1) -------------------------------------------------
//
// On K1's path no kernel of its own quantizes a GEMV's input row: each GEMV
// block recomputes the whole row from its f32 terms and bf16 rows in L2 (4-12
// KB), its RMS and its amax, and keeps the int8 codes of the input rows it
// reads. The codes and the scale equal norm_quant's (the SwiGLU row's:
// silu_elem's act, quantized as norm_quant quantizes) bit for bit: the same
// element functions, max reductions (exact in any order) and
// the sum of squares in norm_quant's order, the NORM_THREADS virtual
// threads' strided sums reduced by the same warp butterflies (four virtual
// threads per thread of a 256-thread block). Kinds:
enum RowKind {
  ROW_CODES = 0,  // codes and scale already in memory (xq, sx): the lm head
  ROW_NORM = 1,   // x = resid_elem(base, terms), y = bf16(rms(x) * w)
  ROW_QUANT = 2,  // y = base (the attention row)
  ROW_SILU = 3,   // y = silu_elem(terms)
};

struct RowIn {
  int kind, N, n_g;
  const __nv_bfloat16* base;  // [N] bf16, or null: the embedding row of *token
  const __nv_bfloat16* embd;
  const int* token;
  const float* terms;         // [n_g][N] (SILU: [n_g][2N])
  const float* w;             // norm weight [N] (NORM)
  float eps;
  __nv_bfloat16* x_out;       // NORM: x, written by block (0, 0) (the residual)
  const int8_t* xq;           // CODES
  const float* sx;
};

constexpr int PRO_THREADS = 256;                      // the GEMVs' block size
constexpr int PRO_VIRT = NORM_THREADS / PRO_THREADS;  // virtual threads a thread plays

// The codes of input rows [r0, r0 + n) into codes[0 .. n) (shared), and the
// row's scale, returned to every thread. ys: shared scratch of NORM_MAX
// floats; red: 32. Every thread of the (PRO_THREADS) block calls it.
__device__ float row_codes(const RowIn& in, int r0, int n, int8_t* codes, float* ys,
                           float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (in.kind == ROW_CODES) {
    for (int i = tid; i < n; i += PRO_THREADS) codes[i] = in.xq[r0 + i];
    __syncthreads();
    return *in.sx;
  }
  const int N = in.N;
  float amax = 0.f;
  if (in.kind == ROW_SILU) {
    for (int i = tid; i < N; i += PRO_THREADS) {
      const float a = silu_elem(in.terms, in.n_g, N, i);
      ys[i] = a;
      amax = fmaxf(amax, fabsf(a));
    }
  } else {
    const __nv_bfloat16* base = in.base ? in.base : in.embd + (size_t)(*in.token) * N;
    const bool norm = in.kind == ROW_NORM;
    const bool write = norm && in.x_out && blockIdx.x == 0 && blockIdx.y == 0;
    float sq[PRO_VIRT];
#pragma unroll
    for (int j = 0; j < PRO_VIRT; ++j) {
      sq[j] = 0.f;
      for (int i = tid + j * PRO_THREADS; i < N; i += NORM_THREADS) {
        const float x = norm ? resid_elem(base, in.terms, in.n_g, N, i) : bf2f(base[i]);
        if (write) in.x_out[i] = __float2bfloat16_rn(x);
        ys[i] = x;
        sq[j] = fmaf(x, x, sq[j]);
      }
    }
    float r = 1.f;
    if (norm) {
      // block_sum over NORM_THREADS threads: virtual thread tid + 256 j is
      // lane `lane` of virtual warp warp + 8 j
#pragma unroll
      for (int j = 0; j < PRO_VIRT; ++j) {
        const float v = warp_sum(sq[j]);
        if (lane == 0) red[warp + j * (PRO_THREADS / 32)] = v;
      }
      __syncthreads();
      const float tot = warp_sum(red[lane]);
      r = rsqrtf(tot / (float)N + in.eps);
    }
    for (int i = tid; i < N; i += PRO_THREADS) {
      float y = ys[i];
      if (norm) y = bf16_round(y * r * in.w[i]);
      ys[i] = y;
      amax = fmaxf(amax, fabsf(y));
    }
  }
  amax = warp_max(amax);
  __syncthreads();  // red is free again, and ys complete
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = warp_max(lane < PRO_THREADS / 32 ? red[lane] : 0.f);
  const float sx = quant_scale(amax);
  for (int i = tid; i < n; i += PRO_THREADS) codes[i] = quant_code(ys[r0 + i], sx);
  __syncthreads();
  return sx;
}

// Programmatic dependent launch: a kernel launched with it may start while
// its predecessor runs; it waits here before it reads anything the
// predecessor writes (a no-op for a kernel launched without it). A kernel
// lets its dependents start early once all its blocks have begun.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// -- attention ------------------------------------------------------------------
//
// One kernel, attn_step, split over cache rows: block (kvh, c, row) takes
// ATTN_ROWS cache rows < pos for the GROUP q heads that share KV head kvh
// and writes the chunk's max m, unscaled sum l = sum exp(s - m) and o = sum
// exp(s - m) * v_scale * v. The last of the row's n_attn_chunks(pos) chunk
// blocks of head kvh to finish (an atomic count per (row, kvh), as
// i8_tile_done counts a GEMV's tiles) then merges the chunks with the fresh
// column, writes the bf16 attention rows and the fresh K/V row at pos.
// Partial layout: part[row][kvh][c][j] = {m, l, o[D]} with gridDim.y chunks
// per (row, kvh). The caches' row strides are slab_kv (K/V elements) and
// slab_s (scale floats).

// q (times the softmax scale), k and v of KV head kvh into vec[nvec][D]
// (nvec = GROUP: the q heads only; GROUP + 2: q, k, v): bf16(sum of the
// QKV group terms), RMSNorm of q (q_norm) and k (k_norm), NEOX RoPE at pos.
__device__ void prep_qkv(const float* __restrict__ terms, int n_g,
                         const float* __restrict__ qn, const float* __restrict__ kn,
                         const MegaDims& d, int pos, int kvh, int nvec, float* vec) {
  const int D = d.D, GROUP = d.NH / d.NKV;
  const int DQ = d.NH * D, DKV = d.NKV * D, NQKV = DQ + 2 * DKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < nvec * D; i += blockDim.x) {
    const int j = i / D, e = i % D;
    int col;
    if (j < GROUP) col = (kvh * GROUP + j) * D + e;
    else if (j == GROUP) col = DQ + kvh * D + e;
    else col = DQ + DKV + kvh * D + e;
    float t = terms[col];
    for (int g = 1; g < n_g; ++g) t += terms[(size_t)g * NQKV + col];
    vec[i] = bf16_round(t);
  }
  __syncthreads();
  const int n_norm = min(nvec, GROUP + 1);  // q heads and k; v is not normed
  for (int j = warp; j < n_norm; j += nwarps) {
    float* x = vec + j * D;
    const float* w = j < GROUP ? qn : kn;
    float s = 0.f;
    for (int e = lane; e < D; e += 32) s += x[e] * x[e];
    s = warp_sum(s);
    const float r = rsqrtf(s / (float)D + d.eps);
    __syncwarp();
    for (int e = lane; e < D; e += 32) x[e] = x[e] * r * w[e];
  }
  __syncthreads();
  const int half = D / 2;
  for (int i = tid; i < n_norm * half; i += blockDim.x) {
    const int j = i / half, e = i % half;
    float* x = vec + j * D;
    const float inv = expf((float)e * d.rope_coef);
    const float ang = (float)pos * inv;
    const float c = cosf(ang), s = sinf(ang);
    const float x1 = x[e], x2 = x[e + half];
    float y1 = x1 * c - x2 * s, y2 = x2 * c + x1 * s;
    if (j < GROUP) {
      y1 *= d.scale;
      y2 *= d.scale;
    }
    x[e] = y1;
    x[e + half] = y2;
  }
  __syncthreads();
}

// Elements of cache row r of a staged chunk (rows of D elements) as f32:
// four at e .. e + 3 (e a multiple of 4), or one at e. An int4 row is the low
// or high nibble of byte row r / 2, sign-extended.
__device__ __forceinline__ void row4(const int8_t* rows, int r, int D, int e, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(rows + r * D + e);
  f[0] = (float)c.x;
  f[1] = (float)c.y;
  f[2] = (float)c.z;
  f[3] = (float)c.w;
}

__device__ __forceinline__ void row4(const __nv_bfloat16* rows, int r, int D, int e,
                                     float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(rows + r * D + e);
  const float2 a = __bfloat1622float2(p[0]);
  const float2 b = __bfloat1622float2(p[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ float nibble(uint32_t bits, int shift) {
  return (float)((int)((bits >> shift) << 28) >> 28);
}

__device__ __forceinline__ void row4(const nib2* rows, int r, int D, int e, float* f) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(rows + (r >> 1) * D + e);
  const int sh = (r & 1) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = nibble(w, 8 * k + sh);
}

template <typename CT>
__device__ __forceinline__ float row1(const CT* rows, int r, int D, int e) {
  return to_f(rows[r * D + e]);
}

template <>
__device__ __forceinline__ float row1(const nib2* rows, int r, int D, int e) {
  return nibble(rows[(r >> 1) * D + e].b, (r & 1) * 4);
}

// The chunk's K and V rows are copied into shared memory with cp.async
// (16-byte pieces, all in flight at once: D / 16 pieces a stored row for
// int8 and int4, D / 8 for bf16; an int4 chunk is ATTN_ROWS / 2 byte rows)
// while q, k and v are prepared (k and v for the merge, if this block does
// it); everything after reads shared memory. Dynamic shared memory (attn_smem):
// kv[2][ATTN_ROWS / rows_per_elem][D] of the cache type CT, then floats
// vec[GROUP + 2][D], p[GROUP][ATTN_ROWS], ml[2 * GROUP], kss[ATTN_ROWS],
// vss[ATTN_ROWS]. An int8 or int4 cache's row scales multiply the scores and
// the probabilities of the V sum (the denominator takes the unscaled sum); a
// bf16 cache has no scales (ksc / vsc null).
template <typename CT>
__device__ void attn_chunk(const float* __restrict__ terms, int n_g,
                           const float* __restrict__ qn, const float* __restrict__ kn,
                           const MegaDims& d, const CT* __restrict__ kc,
                           const CT* __restrict__ vc, const float* __restrict__ ksc,
                           const float* __restrict__ vsc, float* __restrict__ part, int pos,
                           int kvh, int c, int row, unsigned char* smem_raw) {
  constexpr bool QUANT = scaled_cache<CT>();
  constexpr int RPB = rows_per_elem<CT>();
  constexpr int CR = ATTN_ROWS / RPB;   // stored rows per chunk
  const int D = d.D, NKV = d.NKV, GROUP = d.NH / NKV, DKV = NKV * D;
  const int r0 = c * ATTN_ROWS;
  const int nr = min(ATTN_ROWS, pos - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  CT* kv = reinterpret_cast<CT*>(smem_raw);   // [2][CR][D]
  float* q = reinterpret_cast<float*>(smem_raw + 2 * CR * D * sizeof(CT));
  float* p = q + (GROUP + 2) * D;       // [GROUP][ATTN_ROWS]
  float* ml = p + GROUP * ATTN_ROWS;    // m[GROUP], l[GROUP]
  float* kss = ml + 2 * GROUP;          // [ATTN_ROWS]
  float* vss = kss + ATTN_ROWS;         // [ATTN_ROWS]

  const int pieces = D * (int)sizeof(CT) / 16;
  const int ns = (nr + RPB - 1) / RPB;  // stored rows holding the live rows
  for (int i = tid; i < 2 * ns * pieces; i += blockDim.x) {
    const int which = i / (ns * pieces), rem = i % (ns * pieces);
    const int r = rem / pieces, piece = rem % pieces;
    const CT* src = (which ? vc : kc) + (size_t)(r0 / RPB + r) * DKV + kvh * D;
    __pipeline_memcpy_async(
        reinterpret_cast<unsigned char*>(kv + (which * CR + r) * D) + piece * 16,
        reinterpret_cast<const unsigned char*>(src) + piece * 16, 16);
  }
  __pipeline_commit();
  if constexpr (QUANT) {
    for (int r = tid; r < nr; r += blockDim.x) {
      kss[r] = ksc[(size_t)(r0 + r) * NKV + kvh];
      vss[r] = vsc[(size_t)(r0 + r) * NKV + kvh];
    }
  }
  prep_qkv(terms, n_g, qn, kn, d, pos, kvh, GROUP + 2, q);
  __pipeline_wait_prior(0);
  __syncthreads();
  const CT* ks_rows = kv;
  const CT* vs_rows = kv + CR * D;

  // scores (times the row's k scale): one warp per row, 4 elements per lane
  for (int r = warp; r < nr; r += nwarps) {
    for (int j = 0; j < GROUP; ++j) {
      const float* qj = q + j * D;
      float s = 0.f;
      for (int e = 4 * lane; e < D; e += 128) {
        float k4[4];
        row4(ks_rows, r, D, e, k4);
        s += qj[e] * k4[0] + qj[e + 1] * k4[1] + qj[e + 2] * k4[2] + qj[e + 3] * k4[3];
      }
      s = warp_sum(s);
      if (lane == 0) p[j * ATTN_ROWS + r] = QUANT ? s * kss[r] : s;
    }
  }
  __syncthreads();

  // per q head (one warp each): chunk max, p = exp(s - m), unscaled sum,
  // then the row's v scale folded into p
  for (int j = warp; j < GROUP; j += nwarps) {
    float* pj = p + j * ATTN_ROWS;
    float mx = QW_NEG;
    for (int r = lane; r < nr; r += 32) mx = fmaxf(mx, pj[r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < nr; r += 32) {
      const float e = expf(pj[r] - mx);
      sum += e;
      pj[r] = QUANT ? e * vss[r] : e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[j] = mx;
      ml[GROUP + j] = sum;
    }
  }
  __syncthreads();

  float* out = part + (((size_t)row * NKV + kvh) * gridDim.y + c) * GROUP * (D + 2);
  for (int pr = tid; pr < GROUP * D; pr += blockDim.x) {
    const int j = pr / D, e = pr % D;
    const float* pj = p + j * ATTN_ROWS;
    float o = 0.f;
#pragma unroll 8
    for (int r = 0; r < nr; ++r) o = fmaf(pj[r], row1(vs_rows, r, D, e), o);
    out[j * (D + 2) + 2 + e] = o;
  }
  if (tid < GROUP) {
    out[tid * (D + 2)] = ml[tid];
    out[tid * (D + 2) + 1] = ml[GROUP + tid];
  }
}

// The merge of (kvh, row)'s n_attn_chunks(pos) partials with the fresh
// column, by the chunk block that finished last: vec[(GROUP + 2) * D] holds
// the chunk's q, k and v (prep_qkv's values for any nvec); misc[3 * GROUP]
// and wc[nchunks * GROUP] are shared scratch (wc in the chunk's K/V staging
// bytes); attn_out is the row's [DQ]. The partials of the other blocks are
// read from L2 (ld.cg). The
// fresh K/V row enters the max and the sum in f32 and is stored at cache
// row pos: quantized with its scale (int8: amax / 127, codes in [-127, 127];
// int4: amax / 7, codes in [-7, 7] written into their nibble of byte row
// pos / 2, the other nibble kept), or rounded to nearest even (bf16).
template <typename CT>
__device__ void attn_merge(const MegaDims& d, const float* part, CT* __restrict__ kc,
                           CT* __restrict__ vc, float* __restrict__ ksc,
                           float* __restrict__ vsc, __nv_bfloat16* __restrict__ attn_out,
                           int pos, int kvh, int row, const float* vec, float* misc,
                           float* wc) {
  const int D = d.D, NKV = d.NKV, GROUP = d.NH / NKV, DKV = NKV * D;
  const int nchunks = n_attn_chunks(pos);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // misc: p_fresh[GROUP], m[GROUP], den[GROUP]
  const float* kf = vec + GROUP * D;
  const float* vf = kf + D;
  const float* pk = part + ((size_t)row * NKV + kvh) * gridDim.y * GROUP * (D + 2);

  // per q head (one warp each): fresh score, overall max, each chunk's
  // weight exp(m_c - max) (kept in wc[c][j]) and the denominator
  for (int j = warp; j < GROUP; j += nwarps) {
    float sf = 0.f;
    for (int e = lane; e < D; e += 32) sf += vec[j * D + e] * kf[e];
    sf = warp_sum(sf);
    float mx = sf;
    for (int c = lane; c < nchunks; c += 32)
      mx = fmaxf(mx, __ldcg(pk + ((size_t)c * GROUP + j) * (D + 2)));
    mx = warp_max(mx);
    float den = 0.f;
    for (int c = lane; c < nchunks; c += 32) {
      const float* pc = pk + ((size_t)c * GROUP + j) * (D + 2);
      const float w = expf(__ldcg(pc) - mx);
      wc[c * GROUP + j] = w;
      den += __ldcg(pc + 1) * w;
    }
    den = warp_sum(den);
    const float pf = expf(sf - mx);
    if (lane == 0) {
      misc[j] = pf;
      misc[GROUP + j] = mx;
      misc[2 * GROUP + j] = den + pf;
    }
  }
  __syncthreads();

  for (int pr = tid; pr < GROUP * D; pr += blockDim.x) {
    const int j = pr / D, e = pr % D;
    float o = 0.f;
#pragma unroll 4
    for (int c = 0; c < nchunks; ++c)
      o = fmaf(__ldcg(pk + ((size_t)c * GROUP + j) * (D + 2) + 2 + e), wc[c * GROUP + j], o);
    const float res = (o + misc[j] * vf[e]) / misc[2 * GROUP + j];
    attn_out[(kvh * GROUP + j) * D + e] = __float2bfloat16_rn(res);
  }

  // the fresh K and V rows of this head (warps 0 and 1) into cache row pos;
  // the chunk blocks read only rows < pos
  if (warp < 2) {
    const float* x = warp == 0 ? kf : vf;
    CT* dst = (warp == 0 ? kc : vc) + (size_t)(pos / rows_per_elem<CT>()) * DKV + kvh * D;
    if constexpr (scaled_cache<CT>()) {
      // s = amax / qmax as the reference computes it under jit: a multiply
      // by f32(1 / qmax)
      constexpr bool I4 = std::is_same<CT, nib2>::value;
      constexpr float QMAX = I4 ? 7.f : 127.f;
      float amax = 0.f;
      for (int e = lane; e < D; e += 32) amax = fmaxf(amax, fabsf(x[e]));
      amax = warp_max(amax);
      const float s = fmaxf(amax * (1.f / QMAX), 1e-12f);
      for (int e = lane; e < D; e += 32) {
        const float qv = fminf(fmaxf(rintf(x[e] / s), -QMAX), QMAX);
        if constexpr (I4) {
          const int sh = (pos & 1) * 4;   // even pos: low nibble; odd: high
          const uint32_t keep = dst[e].b & (0xF0u >> sh);
          dst[e].b = (uint8_t)(keep | (((uint32_t)(int)qv & 0xFu) << sh));
        } else {
          dst[e] = (int8_t)qv;
        }
      }
      if (lane == 0) (warp == 0 ? ksc : vsc)[(size_t)pos * NKV + kvh] = s;
    } else {
      for (int e = lane; e < D; e += 32) dst[e] = __float2bfloat16_rn(x[e]);
    }
  }
}

// Block (kvh, c, row): chunk c of (kvh, row), then the merge in the last of
// the row's chunk blocks to finish. A chunk at or past the row's pos exits
// at once (the grid is sized for the host's bound of the positions). cnt
// [B][NKV] is zero between steps: the last block resets its count.
template <typename CT>
__global__ void __launch_bounds__(ATTN_THREADS) attn_step(
    const float* __restrict__ terms, int n_g, const float* __restrict__ qn,
    const float* __restrict__ kn, MegaDims d, CT* __restrict__ kc, CT* __restrict__ vc,
    float* __restrict__ ksc, float* __restrict__ vsc, float* part, int* __restrict__ cnt,
    __nv_bfloat16* __restrict__ attn_out, const int* __restrict__ pos_arr, size_t ts,
    size_t slab_kv, size_t slab_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  pdl_trigger();
  const int kvh = blockIdx.x, c = blockIdx.y, row = blockIdx.z;
  const int pos = pos_arr[row];
  if (c * ATTN_ROWS >= pos) return;
  terms += row * ts;
  kc += row * slab_kv;
  vc += row * slab_kv;
  if (ksc) {
    ksc += row * slab_s;
    vsc += row * slab_s;
  }
  attn_chunk<CT>(terms, n_g, qn, kn, d, kc, vc, ksc, vsc, part, pos, kvh, c, row, smem_raw);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* n = cnt + row * d.NKV + kvh;
    last = atomicAdd(n, 1) == n_attn_chunks(pos) - 1;
    if (last) *n = 0;
  }
  __syncthreads();
  if (!last) return;
  const int RPB = rows_per_elem<CT>();
  float* vec = reinterpret_cast<float*>(smem_raw + 2 * (ATTN_ROWS / RPB) * d.D * sizeof(CT));
  attn_merge<CT>(d, part, kc, vc, ksc, vsc, attn_out + (size_t)row * d.NH * d.D, pos, kvh,
                 row, vec, vec + (d.NH / d.NKV + 2) * d.D,
                 reinterpret_cast<float*>(smem_raw));
}

// -- lm-head argmax -----------------------------------------------------------
//
// logits[n] = sum_g terms[g, n] for n < V (padding columns masked); pass 1
// (blocks (x, row)) reduces each block's columns to (max, first index),
// pass 2 (block = row) the blocks.
__global__ void __launch_bounds__(ARGMAX_THREADS) argmax_partial(
    const float* __restrict__ terms, int n_g, int Vp, int V,
    float* __restrict__ pmax, int* __restrict__ pidx, size_t ts) {
  __shared__ float bm[ARGMAX_THREADS];
  __shared__ int bi[ARGMAX_THREADS];
  const int row = blockIdx.y;
  terms += row * ts;
  float best = QW_NEG;
  int idx = 0x7fffffff;
  const int c0 = blockIdx.x * ARGMAX_COLS;
  const int c1 = min(c0 + ARGMAX_COLS, V);
  for (int n = c0 + threadIdx.x; n < c1; n += blockDim.x) {
    float t = terms[n];
    for (int g = 1; g < n_g; ++g) t += terms[(size_t)g * Vp + n];
    if (t > best) {  // ascending n per thread: keeps the first index on ties
      best = t;
      idx = n;
    }
  }
  bm[threadIdx.x] = best;
  bi[threadIdx.x] = idx;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) {
      const float m2 = bm[threadIdx.x + o];
      const int i2 = bi[threadIdx.x + o];
      if (m2 > bm[threadIdx.x] || (m2 == bm[threadIdx.x] && i2 < bi[threadIdx.x])) {
        bm[threadIdx.x] = m2;
        bi[threadIdx.x] = i2;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    pmax[(size_t)row * gridDim.x + blockIdx.x] = bm[0];
    pidx[(size_t)row * gridDim.x + blockIdx.x] = bi[0];
  }
}

__global__ void __launch_bounds__(ARGMAX_THREADS) argmax_final(
    const float* __restrict__ pmax, const int* __restrict__ pidx, int nb,
    int* __restrict__ token_out) {
  __shared__ float bm[ARGMAX_THREADS];
  __shared__ int bi[ARGMAX_THREADS];
  const int row = blockIdx.x;
  pmax += (size_t)row * nb;
  pidx += (size_t)row * nb;
  float best = QW_NEG;
  int idx = 0x7fffffff;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    if (pmax[b] > best || (pmax[b] == best && pidx[b] < idx)) {
      best = pmax[b];
      idx = pidx[b];
    }
  }
  bm[threadIdx.x] = best;
  bi[threadIdx.x] = idx;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) {
      const float m2 = bm[threadIdx.x + o];
      const int i2 = bi[threadIdx.x + o];
      if (m2 > bm[threadIdx.x] || (m2 == bm[threadIdx.x] && i2 < bi[threadIdx.x])) {
        bm[threadIdx.x] = m2;
        bi[threadIdx.x] = i2;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) token_out[row] = bi[0] == 0x7fffffff ? 0 : bi[0];
}

// -- int8-weight GEMVs: the cross-block sum ----------------------------------
//
// An int8 GEMV splits its input rows over gridDim.y blocks (split_rows). Each
// block adds its exact int32 column sums into iacc; the block that finishes a
// 64-column tile last (counted in tiles[blockIdx.x]) applies the scales to
// the whole sum, `f32(dot) * (sx * s[n])` as the TPU kernel does once per
// output column, and leaves iacc and the counter zero for the next GEMV.
// Integer sums are exact in any order, so every split and every batch row
// gives the same bits. Called by every thread of the block after its
// atomicAdds; true in the block that writes the tile.
__device__ __forceinline__ bool i8_tile_done(int* tiles) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tiles[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  return last;
}

// -- scratch layout -------------------------------------------------------------

// Per-row activations of B rows: row b of each array at b * (its row size).
// The GEMVs write their f32 group terms into terms[0] and terms[1] in turn,
// so a GEMV that rebuilds its input from its predecessor's terms never
// writes over them.
struct Scratch {
  __nv_bfloat16 *x, *h1, *attn;  // [B][H], [B][H], [B][DQ]
  int8_t* xq;                    // [B][widest_row]
  float* sx;                     // [B]
  float* terms[2];               // [B][terms_floats] each
  float* part;                   // [B][NKV][n_attn_chunks(S)][GROUP][D + 2]
  float* pmax;                   // [B][n_argmax_blocks]
  int* pidx;
  int* iacc;                     // [B][widest_out] int8 GEMVs' column sums
  int* tiles;                    // [widest_out / 64] their tile counters
  int* acnt;                     // [B][NKV] attention chunks done
  size_t zero_bytes;             // bytes of iacc, tiles and acnt (zeroed per step)
};

inline size_t layout(const MegaDims& d, int B, char* base, Scratch* s) {
  const int DQ = d.NH * d.D;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align_up(bytes);
    return p;
  };
  s->x = (__nv_bfloat16*)take(2 * (size_t)B * d.H);
  s->h1 = (__nv_bfloat16*)take(2 * (size_t)B * d.H);
  s->attn = (__nv_bfloat16*)take(2 * (size_t)B * DQ);
  s->xq = (int8_t*)take((size_t)B * widest_row(d));
  s->sx = (float*)take(4 * (size_t)B);
  s->terms[0] = (float*)take(4 * (size_t)B * terms_floats(d));
  s->terms[1] = (float*)take(4 * (size_t)B * terms_floats(d));
  s->part = (float*)take(4 * (size_t)B * d.NH * n_attn_chunks(d.S) * (d.D + 2));
  s->pmax = (float*)take(4 * (size_t)B * n_argmax_blocks(d));
  s->pidx = (int*)take(4 * (size_t)B * n_argmax_blocks(d));
  const size_t zero_off = off;
  s->iacc = (int*)take(4 * (size_t)B * widest_out(d));
  s->tiles = (int*)take(4 * (size_t)(widest_out(d) / 64 + 1));
  s->acnt = (int*)take(4 * (size_t)B * d.NKV);
  s->zero_bytes = off - zero_off;
  return off;
}

// One decode step of B rows over a cache of element type CT (int8_t or nib2
// with f32 row scales, or __nv_bfloat16): K1's launch sequence (K3 has its
// own, megakernel_batch.cu's batch_step, whose products also do the row
// work in their epilogues). `gemv(wq, ws, layer, n_in, N, G, in, terms_out,
// first)` launches the product (int4 or int8 weights) of all B rows of the
// input row `in` (RowIn: how its int8 codes are made) into terms_out; K1
// launches one GEMV whose blocks make the codes themselves (row_codes).
// `first` marks the step's first GEMV. Per layer: the QKV
// GEMV, attn_step, then the Wo, gate-up and down GEMVs; then the final norm
// (h_out = the pre-norm hidden state), the lm head and the argmax. pos_arr:
// the rows' positions [B] on the device.
template <typename CT, typename Gemv>
void decode_step(const MegaPtrs* p, const MegaDims& d, const int* pos_arr, int B,
                 const Scratch& s, cudaStream_t st, Gemv gemv) {
  constexpr bool QUANT = scaled_cache<CT>();
  const int DQ = d.NH * d.D, DKV = d.NKV * d.D;
  const int SE = d.S / rows_per_elem<CT>();   // stored rows per layer
  const int nchunks = n_attn_chunks(d.pos);
  const size_t ts = terms_floats(d), qs = (size_t)widest_row(d);
  const size_t slab_kv = (size_t)d.L * SE * DKV, slab_s = (size_t)d.L * d.S * d.NKV;
  const size_t smem_attn = attn_smem<CT>(d);

  const float* attn_norm = (const float*)p->attn_norm;
  const float* ffn_norm = (const float*)p->ffn_norm;
  const float* q_norm = (const float*)p->q_norm;
  const float* k_norm = (const float*)p->k_norm;
  CT* kc = (CT*)p->k_cache;
  CT* vc = (CT*)p->v_cache;
  float* ksc = (float*)p->k_scale;
  float* vsc = (float*)p->v_scale;
  float* ta = s.terms[0];
  float* tb = s.terms[1];
  cudaMemsetAsync(s.iacc, 0, s.zero_bytes, st);

  for (int l = 0; l < d.L; ++l) {
    // x = embedding row (layer 0) or h1 + bf16(wd); codes of bf16(rms(x) * attn_norm)
    RowIn in{};
    in.kind = ROW_NORM;
    in.N = d.H;
    in.embd = (const __nv_bfloat16*)p->embd;
    if (l == 0) {
      in.base = (const __nv_bfloat16*)p->x_in;
      in.token = (const int*)p->token_in;
    } else {
      in.base = s.h1;
      in.terms = tb;
      in.n_g = d.FF / d.g_wd;
    }
    in.w = attn_norm + (size_t)l * d.H;
    in.eps = d.eps;
    in.x_out = s.x;
    gemv(p->qkv_q, p->qkv_s, l, d.H, DQ + 2 * DKV, d.g_qkv, in, ta, l == 0);
    const float* qn = q_norm + (size_t)l * d.D;
    const float* kn = k_norm + (size_t)l * d.D;
    CT* kl = kc + (size_t)l * SE * DKV;
    CT* vl = vc + (size_t)l * SE * DKV;
    float* ksl = QUANT ? ksc + (size_t)l * d.S * d.NKV : nullptr;
    float* vsl = QUANT ? vsc + (size_t)l * d.S * d.NKV : nullptr;
    attn_step<CT><<<dim3(d.NKV, nchunks, B), ATTN_THREADS, smem_attn, st>>>(
        ta, d.H / d.g_qkv, qn, kn, d, kl, vl, ksl, vsl, s.part, s.acnt, s.attn, pos_arr, ts,
        slab_kv, slab_s);
    in = RowIn{};
    in.kind = ROW_QUANT;
    in.N = DQ;
    in.base = s.attn;
    gemv(p->wo_q, p->wo_s, l, DQ, d.H, d.g_wo, in, tb, false);
    // h1 = x + bf16(wo); codes of bf16(rms(h1) * ffn_norm)
    in = RowIn{};
    in.kind = ROW_NORM;
    in.N = d.H;
    in.base = s.x;
    in.terms = tb;
    in.n_g = DQ / d.g_wo;
    in.w = ffn_norm + (size_t)l * d.H;
    in.eps = d.eps;
    in.x_out = s.h1;
    gemv(p->gu_q, p->gu_s, l, d.H, 2 * d.FF, d.g_gu, in, ta, false);
    in = RowIn{};
    in.kind = ROW_SILU;
    in.N = d.FF;
    in.terms = ta;
    in.n_g = d.H / d.g_gu;
    gemv(p->wd_q, p->wd_s, l, d.FF, d.H, d.g_wd, in, tb, false);
  }
  norm_quant<<<B, NORM_THREADS, 0, st>>>(s.h1, nullptr, nullptr, tb, d.FF / d.g_wd, d.H,
                                         (const float*)p->out_norm, d.eps, nullptr,
                                         (float*)p->h_out, s.xq, s.sx, ts, qs);
  RowIn in{};
  in.kind = ROW_CODES;
  in.xq = s.xq;
  in.sx = s.sx;
  gemv(p->head_q, p->head_s, 0, d.H, d.Vp, d.g_head, in, ta, false);
  const int nb = n_argmax_blocks(d);
  argmax_partial<<<dim3(nb, B), ARGMAX_THREADS, 0, st>>>(ta, d.H / d.g_head, d.Vp, d.V,
                                                         s.pmax, s.pidx, ts);
  argmax_final<<<B, ARGMAX_THREADS, 0, st>>>(s.pmax, s.pidx, nb, (int*)p->token_out);
}

// The checks both entry points make before a step over a cache of type CT.
template <typename CT>
inline bool step_ok(const MegaDims& d, int gemv_cols, int max_group) {
  const size_t staging = 2 * (size_t)(ATTN_ROWS / rows_per_elem<CT>()) * d.D * sizeof(CT);
  return dims_ok(d, gemv_cols, max_group) && d.S % rows_per_elem<CT>() == 0 &&
         attn_smem<CT>(d) <= 48 * 1024 &&
         sizeof(float) * n_attn_chunks(d.S) * (d.NH / d.NKV) <= staging;
}

}  // namespace
