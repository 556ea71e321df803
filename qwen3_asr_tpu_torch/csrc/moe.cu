// The Qwen3-MoE feed-forward on int8 experts (Qwen3-Omni's thinker): the
// prefill's grouped expert products and the decode step's expert-indexed
// GEMVs, with the decode step that runs them between K1's kernels.
//
// Replaces no TPU kernel: the JAX package has no mixture-of-experts model.
// Experts are int8 with one f32 scale an output channel, stored output-
// major: gate | up [E, 2F, H] and down [E, H, F] a layer, so a row of an
// expert's matrix is one output channel's H (or F) input bytes, contiguous.
//
// Prefill (one launch each a layer, after the router's device-side sort
// of the (row, expert) pairs by expert, `ops/moe.py::route`):
//   moe_gate_up  block (column tile, expert): the expert's pairs in tiles
//                of 32 against 32 gate and 32 up columns, int8 tensor-core
//                products (mma.sync m16n8k32 s8) on the row codes that the
//                layer's residual pass left (F3's output, a row's codes read
//                once for each of its experts); the epilogue dequantizes
//                and forms bf16 silu(g) * u, whose rows F1
//                (`pf_norm_quant`, no norm) turns into codes;
//   moe_down     block (column tile, expert): the down product on those
//                codes; the epilogue dequantizes, weights each pair by its
//                renormalised router probability and writes it to the
//                pair's slot, which `pf_moe_combine` (prefill_fused.cu)
//                sums over the row's experts in order into the residual.
// Decode (the MoE step, `qw_moe_decode_step_*`): per layer
//   moe_gemv_dense the QKV and Wo products on output-major copies of the
//                  int8pc codes, with K1's input prologue (row_codes) and
//                  its epilogue (megakernel.cuh);
//   moe_attn       K1's attention with a KV head's 8 q heads split over 4
//                  blocks;
//   moe_router     the Wo residual and the FFN norm's row codes (K1's
//                  prologue, row_codes), 16 experts' logits a block, and in
//                  the block that finishes last the top-k with its
//                  renormalised weights;
//   moe_gemv_gu    the k routed experts' gate-up rows against the codes:
//                  block (row tile, k) reads expert ids[k] from the device;
//   moe_gemv_down  the experts' down rows against the codes of their SwiGLU
//                  rows (K1's ROW_SILU prologue), each product weighted by
//                  its expert's weight into a slice per expert; the block
//                  that finishes a row tile last sums the tile's k slices
//                  in order into the next layer's residual terms.
// then K1's final norm, lm head GEMV and argmax (megakernel.cu / .cuh).
// Nothing reads the host: the position, the expert ids and the pair counts
// stay on the device, so the step is captured once in a CUDA graph.
//
// What bounds them on an H100: bytes. A prefill of 80-430 rows touches
// nearly all 128 experts a layer (29 GB of int8 a prefill); a decode step
// reads 8 experts a layer (1.8 GB of 3.1). The grouped products keep an
// expert's column tile streaming with 16-byte loads two chunks deep and
// take the few rows a tile has on tensor cores; the GEMVs give each warp a
// few output rows with all their loads in flight at once. The step is six
// dependent launches a layer, each ~11-15 us at the thinker's widths (its
// bytes ~17 us a layer at 3.35 TB/s): it is bound by their latency.
// Programmatic dependent launch made the graphed step slower (8 layers:
// 0.87 ms against 0.75), so the step launches plainly.
#include "megakernel.cuh"

// The MoE step's arguments beyond K1's (MegaPtrs / MegaDims, whose gate-up
// and down pointers it leaves unused and whose FF is the experts' width).
struct MoePtrs {
  const void* qkv_t;   // [L, DQ + 2 DKV, H] int8: the QKV leaf's codes, output-major
  const void* wo_t;    // [L, H, DQ] int8: Wo's, output-major
  const void* router;  // [L, H, E] bf16
  const void* gu_q;    // [L, E, 2F, H] int8 (gate rows, then up rows)
  const void* gu_s;    // [L, E, 2F] f32
  const void* dn_q;    // [L, E, H, F] int8
  const void* dn_s;    // [L, E, H] f32
  void* part;          // [H / 256][E] f32: the router's slice sums
  void* ids;           // [K] int32: the routed experts
  void* wts;           // [K] f32: their weights
  void* cnt;           // [1] int32, zero between steps: router blocks done
  void* slices;        // [K][H] f32: each expert's weighted down product
  void* tcnt;          // [H / 32] int32, zero between steps: down blocks done
  void* acnt;          // [NH] int32, zero between steps: attention chunks done
  void* gu_terms;      // [K][2F] f32: the routed experts' gate-up terms
};

struct MoeDims {
  int E, K;
};

// K1's int8 GEMV (megakernel.cu), for this file's step.
extern "C" int qw_k1_gemv_i8(const void* row_in, const void* wq, const void* ws, int n_in,
                             int N, void* iacc, void* tiles, void* terms, void* stream);

namespace {

// -- grouped products (prefill) ---------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int KCH = 128;          // input bytes a chunk: 4 k-steps of 32
constexpr int MF = 2;             // m16 fragments a tile: 32 pairs
constexpr int TILE = 16 * MF;
constexpr int GU_COLS = 32;       // gate (and as many up) columns a block
constexpr int DN_COLS = 64;       // down columns a block

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ld32(const int8_t* p, uint32_t (&w)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p + 16));
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// The int32 products of one tile: acc[mf][nf] += A rows x B rows over n_in
// input bytes, both row-major with the input dim contiguous. Thread (g, t)
// (g = lane / 4, t = lane % 4) reads 32 contiguous bytes at 32t of each
// 128-byte chunk of its A rows (a[mf][0]: tile row 16 mf + g, a[mf][1]: +8)
// and its B rows (b[nf]: output column g of fragment nf); within a chunk,
// k-step s takes the bytes 8s .. 8s + 7 of each thread's 32 as its k slots
// 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3. A and B are permuted alike, so the
// dot product is the plain one. Loads run one chunk ahead of the products,
// in two register sets named at compile time (a set indexed at run time
// would live in local memory).
template <int NF>
struct Chunk {
  uint32_t a[MF][2][8];
  uint32_t b[NF][8];

  __device__ __forceinline__ void load(const int8_t* (&pa)[MF][2], const int8_t* (&pb)[NF],
                                       int nmf, int c) {
#pragma unroll
    for (int n = 0; n < NF; ++n) ld32(pb[n] + c * KCH, b[n]);
#pragma unroll
    for (int m = 0; m < MF; ++m)
      if (m < nmf) {
        ld32(pa[m][0] + c * KCH, a[m][0]);
        ld32(pa[m][1] + c * KCH, a[m][1]);
      }
  }

  __device__ __forceinline__ void mma(int nmf, int (&acc)[MF][NF][4]) const {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        if (m >= nmf) continue;
#pragma unroll
        for (int n = 0; n < NF; ++n)
          mma_s8(acc[m][n], a[m][0][2 * s], a[m][1][2 * s], a[m][0][2 * s + 1],
                 a[m][1][2 * s + 1], b[n][2 * s], b[n][2 * s + 1]);
      }
  }
};

template <int NF>
__device__ __forceinline__ void tile_products(const int8_t* (&a)[MF][2],
                                              const int8_t* (&b)[NF], int nmf, int n_in,
                                              int (&acc)[MF][NF][4]) {
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0;
  Chunk<NF> x, y;
  const int nch = n_in / KCH;
  x.load(a, b, nmf, 0);
  for (int c = 0; c < nch; c += 2) {
    if (c + 1 < nch) y.load(a, b, nmf, c + 1);
    x.mma(nmf, acc);
    if (c + 1 < nch) {
      if (c + 2 < nch) x.load(a, b, nmf, c + 2);
      y.mma(nmf, acc);
    }
  }
}

// One element of an int8 product in bf16: bf16(f32(acc) * (sx * s)).
__device__ __forceinline__ float deq(int acc, float sx, float s) {
  return bf16_round(__fmul_rn((float)acc, __fmul_rn(sx, s)));
}

// bf16 silu(g) * u with a bf16 rounding after each op (prefill_fused.cu's
// pf_swiglu_quant, models/decoder.py::silu).
__device__ __forceinline__ float swiglu_bf16(float g, float u) {
  const float e = bf16_round(expf(-g));
  const float rc = bf16_round(__fdiv_rn(1.0f, bf16_round(__fadd_rn(1.0f, e))));
  return bf16_round(__fmul_rn(bf16_round(__fmul_rn(g, rc)), u));
}

// Block (j, e): gate columns [32j, 32j + 32) and up columns F + the same of
// expert e, over the expert's pairs [off[e], off[e + 1]) of the sorted
// order (pair p = row * K + k). Warp w takes gate columns 32j + 8w .. + 7 and
// the up columns beside them, so a thread holds g and u of the same
// elements: act [P, F] bf16 takes the SwiGLU rows, in slot order (their
// codes for the down product are F1's, `pf_norm_quant` without a norm).
// stats[0] counts the experts with a pair, stats[1] keeps the most pairs
// of one.
__global__ void __launch_bounds__(MMA_THREADS) moe_gate_up(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int* __restrict__ order,
    const int* __restrict__ off, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    int H, int F, int K, __nv_bfloat16* __restrict__ act, int* __restrict__ stats) {
  const int e = blockIdx.y, j = blockIdx.x;
  const int p0 = off[e], n = off[e + 1] - p0;
  if (n == 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  if (j == 0 && threadIdx.x == 0) {
    atomicAdd(&stats[0], 1);
    atomicMax(&stats[1], n);
  }
  const int col = GU_COLS * j + 8 * warp;     // this warp's gate column 0
  const int8_t* b[2];
  b[0] = wq + ((size_t)e * 2 * F + col + g) * H + 32 * t;
  b[1] = b[0] + (size_t)F * H;
  const float* sg = ws + (size_t)e * 2 * F;
  for (int tb = 0; tb < n; tb += TILE) {
    const int rows = min(TILE, n - tb), nmf = (rows + 15) / 16;
    const int8_t* a[MF][2];
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = min(tb + 16 * m + g + 8 * h, n - 1);
        a[m][h] = xq + (size_t)(order[p0 + r] / K) * H + 32 * t;
      }
    int acc[MF][2][4];
    tile_products<2>(a, b, nmf, H, acc);
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      if (m >= nmf) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tb + 16 * m + g + 8 * h;
        if (r >= n) continue;
        const float sxr = sx[order[p0 + r] / K];
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int f = col + 2 * t + c;
          v[c] = swiglu_bf16(deq(acc[m][0][2 * h + c], sxr, sg[f]),
                             deq(acc[m][1][2 * h + c], sxr, sg[F + f]));
        }
        *reinterpret_cast<__nv_bfloat162*>(act + (size_t)(p0 + r) * F + col + 2 * t) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

// Block (j, e): down columns [64j, 64j + 64) of expert e over its pairs'
// codes fq (sorted order) -> ys[pair] = w[pair] * bf16(f32(acc) * (fs * s)),
// pair = order[slot], f32 [P, H]. Warp w takes columns 64j + 16w .. + 15.
__global__ void __launch_bounds__(MMA_THREADS) moe_down(
    const int8_t* __restrict__ fq, const float* __restrict__ fs, const int* __restrict__ order,
    const int* __restrict__ off, const float* __restrict__ wts, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, int H, int F, float* __restrict__ ys) {
  const int e = blockIdx.y, j = blockIdx.x;
  const int p0 = off[e], n = off[e + 1] - p0;
  if (n == 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int col = DN_COLS * j + 16 * warp;
  const int8_t* b[2];
  b[0] = wq + ((size_t)e * H + col + g) * F + 32 * t;
  b[1] = b[0] + (size_t)8 * F;
  const float* sd = ws + (size_t)e * H;
  for (int tb = 0; tb < n; tb += TILE) {
    const int rows = min(TILE, n - tb), nmf = (rows + 15) / 16;
    const int8_t* a[MF][2];
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[m][h] = fq + (size_t)(p0 + min(tb + 16 * m + g + 8 * h, n - 1)) * F + 32 * t;
    int acc[MF][2][4];
    tile_products<2>(a, b, nmf, F, acc);
#pragma unroll
    for (int m = 0; m < MF; ++m) {
      if (m >= nmf) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tb + 16 * m + g + 8 * h;
        if (r >= n) continue;
        const int pair = order[p0 + r];
        const float sr = fs[p0 + r], w = wts[pair];
#pragma unroll
        for (int nf = 0; nf < 2; ++nf) {
          const int c0 = col + 8 * nf + 2 * t;
          float2 o;
          o.x = __fmul_rn(w, deq(acc[m][nf][2 * h], sr, sd[c0]));
          o.y = __fmul_rn(w, deq(acc[m][nf][2 * h + 1], sr, sd[c0 + 1]));
          *reinterpret_cast<float2*>(ys + (size_t)pair * H + c0) = o;
        }
      }
    }
  }
}

// -- the prefill's routing --------------------------------------------------------

constexpr int ROUTE_THREADS = 1024;
constexpr int ROUTE_MAX_E = 256;
constexpr int ROUTE_MAX_K = 16;

// One block: row r's top k of logits[r] * sx[r] (ties to the lower expert)
// with weights exp(l - max) over their sum (renormalised), pair
// p = r * k + j its j-th expert; the experts' pair counts, their offsets
// off [E + 1], and order [N k]: the pairs sorted by expert (within an
// expert in no fixed order: every pair's products are its own).
__global__ void __launch_bounds__(ROUTE_THREADS) moe_route(
    const float* __restrict__ logits, const float* __restrict__ sx, int N, int E, int K,
    float* __restrict__ wts, int* __restrict__ ids, int* __restrict__ order,
    int* __restrict__ off) {
  __shared__ int count[ROUTE_MAX_E], start[ROUTE_MAX_E + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < E; e += ROUTE_THREADS) count[e] = 0;
  __syncthreads();
  for (int r = warp; r < N; r += ROUTE_THREADS / 32) {
    float lg[ROUTE_MAX_E / 32];
#pragma unroll
    for (int i = 0; i < ROUTE_MAX_E / 32; ++i) {
      const int x = lane + 32 * i;
      lg[i] = x < E ? logits[(size_t)r * E + x] * sx[r] : QW_NEG;
    }
    float top = 0.f, sel = 0.f, wk = 0.f;
    int idk = 0;
    for (int j = 0; j < K; ++j) {
      float bv = QW_NEG;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < ROUTE_MAX_E / 32; ++i)
        if (lane + 32 * i < E && lg[i] > bv) {
          bv = lg[i];
          bi = lane + 32 * i;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
        if (v2 > bv || (v2 == bv && i2 < bi)) {
          bv = v2;
          bi = i2;
        }
      }
      if (j == 0) top = bv;
      const float ex = expf(bv - top);
      sel += ex;
      if (lane == j) {
        wk = ex;
        idk = bi;
      }
#pragma unroll
      for (int i = 0; i < ROUTE_MAX_E / 32; ++i)
        if (lane + 32 * i == bi) lg[i] = QW_NEG;
    }
    if (lane < K) {
      wts[(size_t)r * K + lane] = wk / sel;
      ids[(size_t)r * K + lane] = idk;
      atomicAdd(&count[idk], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0;
    for (int e = 0; e < E; ++e) {
      start[e] = a;
      off[e] = a;
      a += count[e];
    }
    off[E] = a;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < N * K; p += ROUTE_THREADS)
    order[atomicAdd(&start[ids[p]], 1)] = p;
}

// -- the decode step's attention -------------------------------------------------
//
// K1's attention (megakernel.cuh, attn_step) with a KV head's q heads split
// over blocks: the thinker has 8 q heads a KV head (the 0.6B models 2),
// and attn_step's block per (KV head, chunk) would run 8 heads' scores and
// sums alone over 4 KV heads' chunks. Block (kvh * QS + qs, c) takes chunk
// c of KV head kvh for the q heads qs * GS .. qs * GS + GS - 1 (GS = 2 when
// the group is even, QS = group / GS): the same operations on each head as
// attn_step (bf16 q / k / v from the QKV terms, RMSNorm, RoPE at pos, the
// chunk's max, sums and V sum, the merge with the fresh column by the
// chunk block that finishes last), with the fresh K/V row stored by the
// merge of qs = 0. Partials: part[(kvh QS + qs) nchunks + c][GS][D + 2].
template <typename CT>
__global__ void __launch_bounds__(ATTN_THREADS) moe_attn(
    const float* __restrict__ terms, const float* __restrict__ qn,
    const float* __restrict__ kn, MegaDims d, CT* __restrict__ kc, CT* __restrict__ vc,
    float* __restrict__ ksc, float* __restrict__ vsc, float* part, int* __restrict__ cnt,
    __nv_bfloat16* __restrict__ attn_out, const int* __restrict__ pos_arr) {
  constexpr bool QUANT = scaled_cache<CT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int D = d.D, NKV = d.NKV, G = d.NH / NKV, DKV = NKV * D, DQ = d.NH * D;
  const int GS = G % 2 ? 1 : 2, QS = G / GS;
  const int vh = blockIdx.x, kvh = vh / QS, qs = vh % QS, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int pos = pos_arr[0];
  if (c * ATTN_ROWS >= pos) return;
  const int r0 = c * ATTN_ROWS, nr = min(ATTN_ROWS, pos - r0);
  CT* kv = reinterpret_cast<CT*>(smem_raw);   // [2][ATTN_ROWS][D]
  float* vec = reinterpret_cast<float*>(smem_raw + 2 * ATTN_ROWS * D * sizeof(CT));
  float* p = vec + (GS + 2) * D;        // [GS][ATTN_ROWS]
  float* ml = p + GS * ATTN_ROWS;       // m[GS], l[GS]
  float* kss = ml + 2 * GS;             // [ATTN_ROWS]
  float* vss = kss + ATTN_ROWS;
  const int pieces = D * (int)sizeof(CT) / 16;
  for (int i = tid; i < 2 * nr * pieces; i += blockDim.x) {
    const int which = i / (nr * pieces), rem = i % (nr * pieces);
    const int r = rem / pieces, piece = rem % pieces;
    const CT* src = (which ? vc : kc) + (size_t)(r0 + r) * DKV + kvh * D;
    __pipeline_memcpy_async(
        reinterpret_cast<unsigned char*>(kv + (which * ATTN_ROWS + r) * D) + piece * 16,
        reinterpret_cast<const unsigned char*>(src) + piece * 16, 16);
  }
  __pipeline_commit();
  if constexpr (QUANT) {
    for (int r = tid; r < nr; r += blockDim.x) {
      kss[r] = ksc[(size_t)(r0 + r) * NKV + kvh];
      vss[r] = vsc[(size_t)(r0 + r) * NKV + kvh];
    }
  }
  // q heads kvh G + qs GS + j (j < GS), then k and v of kvh: bf16 of the
  // terms, RMSNorm of q (q_norm) and k (k_norm), NEOX RoPE at pos, q scaled
  for (int i = tid; i < (GS + 2) * D; i += blockDim.x) {
    const int j = i / D, e = i % D;
    const int col = j < GS ? (kvh * G + qs * GS + j) * D + e
                           : (j == GS ? DQ + kvh * D + e : DQ + DKV + kvh * D + e);
    vec[i] = bf16_round(terms[col]);
  }
  __syncthreads();
  for (int j = warp; j < GS + 1; j += nwarps) {
    float* x = vec + j * D;
    const float* w = j < GS ? qn : kn;
    float ss = 0.f;
    for (int e = lane; e < D; e += 32) ss += x[e] * x[e];
    ss = warp_sum(ss);
    const float r = rsqrtf(ss / (float)D + d.eps);
    __syncwarp();
    for (int e = lane; e < D; e += 32) x[e] = x[e] * r * w[e];
  }
  __syncthreads();
  const int half = D / 2;
  for (int i = tid; i < (GS + 1) * half; i += blockDim.x) {
    const int j = i / half, e = i % half;
    float* x = vec + j * D;
    const float inv = expf((float)e * d.rope_coef);
    const float ang = (float)pos * inv;
    const float cs = cosf(ang), sn = sinf(ang);
    const float x1 = x[e], x2 = x[e + half];
    float y1 = x1 * cs - x2 * sn, y2 = x2 * cs + x1 * sn;
    if (j < GS) {
      y1 *= d.scale;
      y2 *= d.scale;
    }
    x[e] = y1;
    x[e + half] = y2;
  }
  __syncthreads();
  __pipeline_wait_prior(0);
  __syncthreads();
  const CT* ks_rows = kv;
  const CT* vs_rows = kv + ATTN_ROWS * D;
  for (int r = warp; r < nr; r += nwarps) {
    for (int j = 0; j < GS; ++j) {
      const float* qj = vec + j * D;
      float sc = 0.f;
      for (int e = 4 * lane; e < D; e += 128) {
        float k4[4];
        row4(ks_rows, r, D, e, k4);
        sc += qj[e] * k4[0] + qj[e + 1] * k4[1] + qj[e + 2] * k4[2] + qj[e + 3] * k4[3];
      }
      sc = warp_sum(sc);
      if (lane == 0) p[j * ATTN_ROWS + r] = QUANT ? sc * kss[r] : sc;
    }
  }
  __syncthreads();
  for (int j = warp; j < GS; j += nwarps) {
    float* pj = p + j * ATTN_ROWS;
    float mx = QW_NEG;
    for (int r = lane; r < nr; r += 32) mx = fmaxf(mx, pj[r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < nr; r += 32) {
      const float ex = expf(pj[r] - mx);
      sum += ex;
      pj[r] = QUANT ? ex * vss[r] : ex;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[j] = mx;
      ml[GS + j] = sum;
    }
  }
  __syncthreads();
  float* out = part + ((size_t)vh * gridDim.y + c) * GS * (D + 2);
  for (int pr = tid; pr < GS * D; pr += blockDim.x) {
    const int j = pr / D, e = pr % D;
    const float* pj = p + j * ATTN_ROWS;
    float o = 0.f;
#pragma unroll 8
    for (int r = 0; r < nr; ++r) o = fmaf(pj[r], row1(vs_rows, r, D, e), o);
    out[j * (D + 2) + 2 + e] = o;
  }
  if (tid < GS) {
    out[tid * (D + 2)] = ml[tid];
    out[tid * (D + 2) + 1] = ml[GS + tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(cnt + vh, 1) == n_attn_chunks(pos) - 1;
    if (last) cnt[vh] = 0;
  }
  __syncthreads();
  if (!last) return;
  // the merge (attn_merge's, for this block's q heads)
  const int nchunks = n_attn_chunks(pos);
  float* wc = reinterpret_cast<float*>(smem_raw);   // [nchunks][GS], over the staging
  float* misc = kss;                                // p_fresh[GS], m[GS], den[GS]
  const float* kf = vec + GS * D;
  const float* vf = kf + D;
  const float* pk = part + (size_t)vh * gridDim.y * GS * (D + 2);
  __syncthreads();
  for (int j = warp; j < GS; j += nwarps) {
    float sf = 0.f;
    for (int e = lane; e < D; e += 32) sf += vec[j * D + e] * kf[e];
    sf = warp_sum(sf);
    float mx = sf;
    for (int cc = lane; cc < nchunks; cc += 32)
      mx = fmaxf(mx, __ldcg(pk + ((size_t)cc * GS + j) * (D + 2)));
    mx = warp_max(mx);
    float den = 0.f;
    for (int cc = lane; cc < nchunks; cc += 32) {
      const float* pc = pk + ((size_t)cc * GS + j) * (D + 2);
      const float w = expf(__ldcg(pc) - mx);
      wc[cc * GS + j] = w;
      den += __ldcg(pc + 1) * w;
    }
    den = warp_sum(den);
    const float pf = expf(sf - mx);
    if (lane == 0) {
      misc[j] = pf;
      misc[GS + j] = mx;
      misc[2 * GS + j] = den + pf;
    }
  }
  __syncthreads();
  for (int pr = tid; pr < GS * D; pr += blockDim.x) {
    const int j = pr / D, e = pr % D;
    float o = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < nchunks; ++cc)
      o = fmaf(__ldcg(pk + ((size_t)cc * GS + j) * (D + 2) + 2 + e), wc[cc * GS + j], o);
    const float res = (o + misc[j] * vf[e]) / misc[2 * GS + j];
    attn_out[(kvh * G + qs * GS + j) * D + e] = __float2bfloat16_rn(res);
  }
  if (qs != 0 || warp >= 2) return;
  // the fresh K and V rows of this KV head into cache row pos (attn_merge's)
  const float* x = warp == 0 ? kf : vf;
  CT* dst = (warp == 0 ? kc : vc) + (size_t)pos * DKV + kvh * D;
  if constexpr (QUANT) {
    float amax = 0.f;
    for (int e = lane; e < D; e += 32) amax = fmaxf(amax, fabsf(x[e]));
    amax = warp_max(amax);
    const float sc = fmaxf(amax * (1.f / 127.f), 1e-12f);
    for (int e = lane; e < D; e += 32) dst[e] = (int8_t)fminf(fmaxf(rintf(x[e] / sc), -127.f), 127.f);
    if (lane == 0) (warp == 0 ? ksc : vsc)[(size_t)pos * NKV + kvh] = sc;
  } else {
    for (int e = lane; e < D; e += 32) dst[e] = __float2bfloat16_rn(x[e]);
  }
}

// Dynamic shared memory of moe_attn: the chunk's K and V rows, then
// vec[(GS + 2) D], p[GS][ATTN_ROWS], ml[2 GS], kss and vss[ATTN_ROWS]; the
// merge's weights [nchunks][GS] reuse the rows' bytes.
template <typename CT>
inline size_t moe_attn_smem(const MegaDims& d) {
  const int G = d.NH / d.NKV, GS = G % 2 ? 1 : 2;
  return 2 * (size_t)ATTN_ROWS * d.D * sizeof(CT) +
         sizeof(float) * ((size_t)(GS + 2) * d.D + GS * (ATTN_ROWS + 2) + 2 * ATTN_ROWS);
}

// -- the decode step's expert kernels -------------------------------------------

constexpr int GV_THREADS = 256;    // = PRO_THREADS: the blocks run row_codes
constexpr int GV_MAX_IN = 4096;    // widest input row of a GEMV here (Wo's)
constexpr int ROUTER_EXPERTS = 16;                          // experts a router block
constexpr int ROUTER_SUBS = GV_THREADS / ROUTER_EXPERTS;     // threads an expert
constexpr int ROUTER_SLICE = 256;                            // input rows a router block
constexpr int MAX_EXPERTS = 256;
constexpr int MAX_TOPK = 16;
// (rows a warp, 16-byte pieces a lane a row) of each GEMV: every load of a
// block's rows is in flight at once (16 pieces a lane)
constexpr int QKV_ROWS = 4, QKV_CPL = 4;   // input 2,048
constexpr int WO_ROWS = 2, WO_CPL = 8;     // input 4,096
constexpr int GU_ROWS = 4, GU_CPL = 4;     // input 2,048
constexpr int DN_ROWS = 8, DN_CPL = 2;     // input 768
__host__ __device__ constexpr int block_rows(int rows) { return rows * GV_THREADS / 32; }
__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct GvSmem {
  float ys[NORM_MAX];
  float red[32];
  __align__(16) int8_t codes[GV_MAX_IN];
};

// Rows n0 .. n0 + ROWS - 1 of w [*, n_in] int8 (rows past `rows` left out),
// CPL 16-byte pieces a lane a row (n_in <= 512 CPL): the loads are issued
// before the caller's prologue and summed against its codes after.
template <int ROWS, int CPL>
struct GvRows {
  uint4 v[ROWS][CPL];

  __device__ __forceinline__ void load(const int8_t* w, int n_in, int n0, int rows) {
    const int lane = threadIdx.x & 31, nch = n_in / 16;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (n0 + r < rows && c < nch)
          v[r][i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * n_in) + c);
      }
  }

  // the exact int32 dots with the codes, summed over the warp
  __device__ __forceinline__ void dots(const int8_t* codes, int n_in, int n0, int rows,
                                       int (&acc)[ROWS]) const {
    const int lane = threadIdx.x & 31, nch = n_in / 16;
    const int* xw = reinterpret_cast<const int*>(codes);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      int a = 0;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (n0 + r < rows && c < nch) {
          a = __dp4a((int)v[r][i].x, xw[4 * c], a);
          a = __dp4a((int)v[r][i].y, xw[4 * c + 1], a);
          a = __dp4a((int)v[r][i].z, xw[4 * c + 2], a);
          a = __dp4a((int)v[r][i].w, xw[4 * c + 3], a);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[r] = a;
    }
  }
};

// The attention's QKV and Wo products (block x: output rows [x B, x B + B),
// B = block_rows(ROWS)) on the output-major int8 copies of the pack (wt
// [N, n_in], the rows of the int8pc leaf's columns), the input row's codes
// made by K1's prologue (row_codes of `in`): terms[n] = f32(acc) * (sx *
// ws[n]), K1's gemv_i8 epilogue. The weight loads go out before the
// prologue.
template <int ROWS, int CPL>
__global__ void __launch_bounds__(GV_THREADS) moe_gemv_dense(
    RowIn in, const int8_t* __restrict__ wt, const float* __restrict__ ws, int n_in, int N,
    float* __restrict__ terms) {
  __shared__ GvSmem sm;
  const int n0 = blockIdx.x * block_rows(ROWS) + (threadIdx.x >> 5) * ROWS;
  GvRows<ROWS, CPL> rows;
  rows.load(wt, n_in, n0, N);
  const float sx = row_codes(in, 0, n_in, sm.codes, sm.ys, sm.red);
  int acc[ROWS];
  rows.dots(sm.codes, n_in, n0, N, acc);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (n0 + r < N) terms[n0 + r] = (float)acc[r] * (sx * ws[n0 + r]);
}

// Block (g, b): the row codes of `in` (the Wo residual under the FFN norm;
// block (0, 0) also leaves them, and x = h1, for the expert GEMVs), and the
// sums of experts [16g, 16g + 16) over input rows [256b, 256b + 256):
// thread (sub, e) adds code[r] * router[r][e] over its 16 rows in order,
// the 16 subs meet in order into part[b][e]. The block that finishes last
// forms logits[e] = sx * the sum over b in order, and takes the top K by
// logit (ties to the lower index), with weights exp(l - max) over their sum
// (renormalised over the k).
__global__ void __launch_bounds__(GV_THREADS) moe_router(
    RowIn in, const __nv_bfloat16* __restrict__ router, int H, int E, int K,
    int8_t* __restrict__ xq_out, float* __restrict__ sx_out, float* __restrict__ part,
    int* __restrict__ cnt, int* __restrict__ ids, float* __restrict__ wts) {
  __shared__ GvSmem sm;
  __shared__ float sums[GV_THREADS];
  __shared__ int last;
  const float sx = row_codes(in, 0, H, sm.codes, sm.ys, sm.red);
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int i = threadIdx.x; i < H; i += GV_THREADS) xq_out[i] = sm.codes[i];
    if (threadIdx.x == 0) *sx_out = sx;
  }
  const int e = blockIdx.x * ROUTER_EXPERTS + threadIdx.x % ROUTER_EXPERTS;
  const int sub = threadIdx.x / ROUTER_EXPERTS, per = ROUTER_SLICE / ROUTER_SUBS;
  const int r0 = blockIdx.y * ROUTER_SLICE + sub * per;
  const __nv_bfloat16* w = router + (size_t)r0 * E + e;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < per; ++r) acc = fmaf((float)sm.codes[r0 + r], bf2f(w[(size_t)r * E]), acc);
  sums[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < ROUTER_EXPERTS) {
    float tot = sums[threadIdx.x];
    for (int j = 1; j < ROUTER_SUBS; ++j) tot += sums[threadIdx.x + j * ROUTER_EXPERTS];
    part[(size_t)blockIdx.y * E + e] = tot;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt, 1) == (int)(gridDim.x * gridDim.y) - 1;
    if (last) *cnt = 0;
  }
  __syncthreads();
  if (!last) return;
  // the slices' sums into shared memory, every load in flight at once, then
  // each expert's logit with the slices in order
  float* ps = sm.ys;   // [gridDim.y][E], free after the prologue
  for (int i = threadIdx.x; i < (int)gridDim.y * E; i += GV_THREADS) ps[i] = __ldcg(part + i);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float lg[MAX_EXPERTS / 32];
#pragma unroll
  for (int i = 0; i < MAX_EXPERTS / 32; ++i) {
    const int x = lane + 32 * i;
    lg[i] = QW_NEG;
    if (x < E) {
      float tot = ps[x];
      for (int b = 1; b < (int)gridDim.y; ++b) tot += ps[b * E + x];
      lg[i] = tot * sx;
    }
  }
  float top = 0.f, wk = 0.f, sel = 0.f;
  for (int k = 0; k < K; ++k) {
    float bv = QW_NEG;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < MAX_EXPERTS / 32; ++i) {
      const int x = lane + 32 * i;
      if (x < E && lg[i] > bv) {  // ascending x per lane: the lower index on ties
        bv = lg[i];
        bi = x;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
      if (v2 > bv || (v2 == bv && i2 < bi)) {
        bv = v2;
        bi = i2;
      }
    }
    if (k == 0) top = bv;
    const float ex = expf(bv - top);
    sel += ex;
    if (lane == k) wk = ex;
    if (lane == 0) ids[k] = bi;
#pragma unroll
    for (int i = 0; i < MAX_EXPERTS / 32; ++i)
      if (lane + 32 * i == bi) lg[i] = QW_NEG;
  }
  if (lane < K) wts[lane] = wk / sel;
}

// Block (x, k): gate-up rows [32x, 32x + 32) of expert ids[k] against the
// row codes the router left (xq, sx) -> terms[k][n] = f32(acc) * (sx * s[n]).
__global__ void __launch_bounds__(GV_THREADS) moe_gemv_gu(
    const int* __restrict__ ids, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    int H, int N2, const int8_t* __restrict__ xq, const float* __restrict__ sxp,
    float* __restrict__ terms) {
  __shared__ __align__(16) int8_t codes[GV_MAX_IN];
  const int k = blockIdx.y, e = ids[k];
  const int n0 = blockIdx.x * block_rows(GU_ROWS) + (threadIdx.x >> 5) * GU_ROWS;
  const int8_t* w = wq + (size_t)e * N2 * H;
  GvRows<GU_ROWS, GU_CPL> rows;
  rows.load(w, H, n0, N2);
  for (int i = threadIdx.x; i < H / 16; i += GV_THREADS)
    reinterpret_cast<uint4*>(codes)[i] = reinterpret_cast<const uint4*>(xq)[i];
  __syncthreads();
  int acc[GU_ROWS];
  rows.dots(codes, H, n0, N2, acc);
  const float sx = *sxp;
  const float* s = ws + (size_t)e * N2;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < GU_ROWS; ++r)
      if (n0 + r < N2) terms[(size_t)k * N2 + n0 + r] = (float)acc[r] * (sx * s[n0 + r]);
}

// Block (x, k): down rows [64x, 64x + 64) of expert ids[k] against the codes
// of its SwiGLU row (K1's ROW_SILU prologue over its gate-up terms) ->
// slices[k][n] = wts[k] * bf16(f32(acc) * (sx * s[n])); the block that
// finishes row tile x last (tcnt[x], left zero) writes out[n] = the sum of
// the tile's k slices in order k = 0 .. K - 1 (f32).
__global__ void __launch_bounds__(GV_THREADS) moe_gemv_down(
    const int* __restrict__ ids, const float* __restrict__ wts, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, int H, int F, const float* __restrict__ gu_terms,
    float* __restrict__ slices, int* __restrict__ tcnt, float* __restrict__ out) {
  __shared__ GvSmem sm;
  __shared__ int last;
  const int k = blockIdx.y, e = ids[k];
  const int n0 = blockIdx.x * block_rows(DN_ROWS) + (threadIdx.x >> 5) * DN_ROWS;
  GvRows<DN_ROWS, DN_CPL> rows;
  rows.load(wq + (size_t)e * H * F, F, n0, H);
  RowIn in{};
  in.kind = ROW_SILU;
  in.N = F;
  in.n_g = 1;
  in.terms = gu_terms + (size_t)k * 2 * F;
  const float sx = row_codes(in, 0, F, sm.codes, sm.ys, sm.red);
  int acc[DN_ROWS];
  rows.dots(sm.codes, F, n0, H, acc);
  const float* s = ws + (size_t)e * H;
  const float wk = wts[k];
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < DN_ROWS; ++r)
      if (n0 + r < H)
        slices[(size_t)k * H + n0 + r] = wk * bf16_round((float)acc[r] * (sx * s[n0 + r]));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&tcnt[blockIdx.x], 1) == (int)gridDim.y - 1;
    if (last) tcnt[blockIdx.x] = 0;
  }
  __syncthreads();
  const int n = blockIdx.x * block_rows(DN_ROWS) + threadIdx.x;
  if (!last || threadIdx.x >= block_rows(DN_ROWS) || n >= H) return;
  float v[MAX_TOPK];
#pragma unroll
  for (int j = 0; j < MAX_TOPK; ++j)
    if (j < (int)gridDim.y) v[j] = __ldcg(slices + (size_t)j * H + n);
  float t = v[0];
#pragma unroll
  for (int j = 1; j < MAX_TOPK; ++j)
    if (j < (int)gridDim.y) t += v[j];
  out[n] = t;
}

// The checks of the MoE step's dimensions beyond K1's.
inline bool moe_ok(const MegaDims& d, const MoeDims& m) {
  const int DQ = d.NH * d.D;
  return m.E > 0 && m.E <= MAX_EXPERTS && m.E % ROUTER_EXPERTS == 0 && m.K > 0 &&
         m.K <= m.E && m.K <= MAX_TOPK && m.K <= 32 && d.H % ROUTER_SLICE == 0 &&
         d.H % 16 == 0 && d.FF % 16 == 0 && DQ % 16 == 0 && d.wbits == 8 &&
         d.H <= 512 * QKV_CPL && d.H <= 512 * GU_CPL && DQ <= 512 * WO_CPL &&
         d.FF <= 512 * DN_CPL && d.H <= GV_MAX_IN && DQ <= GV_MAX_IN && d.FF <= NORM_MAX &&
         (2 * d.FF) % block_rows(GU_ROWS) == 0 && d.H % block_rows(DN_ROWS) == 0 &&
         d.H / ROUTER_SLICE * m.E <= NORM_MAX;
}

// One MoE decode step over a cache of element type CT.
template <typename CT>
int moe_step(const MegaPtrs* p, const MegaDims* dp, const MoePtrs* mp, const MoeDims* mdp,
             const int* pos, void* stream) {
  const MegaDims d = *dp;
  const MoeDims md = *mdp;
  cudaStream_t st = (cudaStream_t)stream;
  if (!pos || !step_ok<CT>(d, 64, 1024) || !moe_ok(d, md) || moe_attn_smem<CT>(d) > 48 * 1024 ||
      sizeof(float) * n_attn_chunks(d.S) * 2 > 2 * ATTN_ROWS * d.D * sizeof(CT))
    return (int)cudaErrorInvalidValue;
  constexpr bool QUANT = scaled_cache<CT>();
  const int DQ = d.NH * d.D, DKV = d.NKV * d.D, F = d.FF, H = d.H, E = md.E, K = md.K;
  const int SE = d.S / rows_per_elem<CT>();
  const int nchunks = n_attn_chunks(d.pos);
  const size_t ts = terms_floats(d), qs = (size_t)widest_row(d);
  const int GS = (d.NH / d.NKV) % 2 ? 1 : 2;
  Scratch s;
  layout(d, 1, (char*)p->scratch, &s);
  float* ta = s.terms[0];
  float* tb = s.terms[1];
  cudaMemsetAsync(s.iacc, 0, s.zero_bytes, st);
  const __nv_bfloat16* router = (const __nv_bfloat16*)mp->router;
  const int8_t* gu_q = (const int8_t*)mp->gu_q;
  const float* gu_s = (const float*)mp->gu_s;
  const int8_t* dn_q = (const int8_t*)mp->dn_q;
  const float* dn_s = (const float*)mp->dn_s;
  const int NQKV = DQ + 2 * DKV;
  for (int l = 0; l < d.L; ++l) {
    RowIn in{};
    in.kind = ROW_NORM;
    in.N = H;
    in.embd = (const __nv_bfloat16*)p->embd;
    if (l == 0) {
      in.base = (const __nv_bfloat16*)p->x_in;
      in.token = (const int*)p->token_in;
    } else {
      in.base = s.h1;
      in.terms = tb;
      in.n_g = 1;
    }
    in.w = (const float*)p->attn_norm + (size_t)l * H;
    in.eps = d.eps;
    in.x_out = s.x;
    moe_gemv_dense<QKV_ROWS, QKV_CPL><<<ceil_div(NQKV, block_rows(QKV_ROWS)), GV_THREADS, 0, st>>>(
        in, (const int8_t*)mp->qkv_t + (size_t)l * NQKV * H,
        (const float*)p->qkv_s + (size_t)l * NQKV, H, NQKV, ta);
    CT* kl = (CT*)p->k_cache + (size_t)l * SE * DKV;
    CT* vl = (CT*)p->v_cache + (size_t)l * SE * DKV;
    float* ksl = QUANT ? (float*)p->k_scale + (size_t)l * d.S * d.NKV : nullptr;
    float* vsl = QUANT ? (float*)p->v_scale + (size_t)l * d.S * d.NKV : nullptr;
    moe_attn<CT><<<dim3(d.NH / GS, nchunks), ATTN_THREADS, moe_attn_smem<CT>(d), st>>>(
        ta, (const float*)p->q_norm + (size_t)l * d.D, (const float*)p->k_norm + (size_t)l * d.D,
        d, kl, vl, ksl, vsl, s.part, (int*)mp->acnt, s.attn, pos);
    in = RowIn{};
    in.kind = ROW_QUANT;
    in.N = DQ;
    in.base = s.attn;
    moe_gemv_dense<WO_ROWS, WO_CPL><<<ceil_div(H, block_rows(WO_ROWS)), GV_THREADS, 0, st>>>(
        in, (const int8_t*)mp->wo_t + (size_t)l * H * DQ, (const float*)p->wo_s + (size_t)l * H,
        DQ, H, tb);
    // h1 = x + bf16(wo): the router's prologue, which leaves h1 and its codes
    in = RowIn{};
    in.kind = ROW_NORM;
    in.N = H;
    in.base = s.x;
    in.terms = tb;
    in.n_g = 1;
    in.w = (const float*)p->ffn_norm + (size_t)l * H;
    in.eps = d.eps;
    in.x_out = s.h1;
    moe_router<<<dim3(E / ROUTER_EXPERTS, H / ROUTER_SLICE), GV_THREADS, 0, st>>>(
        in, router + (size_t)l * H * E, H, E, K, s.xq, s.sx, (float*)mp->part, (int*)mp->cnt,
        (int*)mp->ids, (float*)mp->wts);
    moe_gemv_gu<<<dim3(2 * F / block_rows(GU_ROWS), K), GV_THREADS, 0, st>>>(
        (const int*)mp->ids, gu_q + (size_t)l * E * 2 * F * H, gu_s + (size_t)l * E * 2 * F, H,
        2 * F, s.xq, s.sx, (float*)mp->gu_terms);
    moe_gemv_down<<<dim3(H / block_rows(DN_ROWS), K), GV_THREADS, 0, st>>>(
        (const int*)mp->ids, (const float*)mp->wts, dn_q + (size_t)l * E * H * F,
        dn_s + (size_t)l * E * H, H, F, (const float*)mp->gu_terms, (float*)mp->slices,
        (int*)mp->tcnt, tb);
  }
  norm_quant<<<1, NORM_THREADS, 0, st>>>(s.h1, nullptr, nullptr, tb, 1, H,
                                         (const float*)p->out_norm, d.eps, nullptr,
                                         (float*)p->h_out, s.xq, s.sx, ts, qs);
  RowIn in{};
  in.kind = ROW_CODES;
  in.xq = s.xq;
  in.sx = s.sx;
  const int rc = qw_k1_gemv_i8(&in, p->head_q, p->head_s, H, d.Vp, s.iacc, s.tiles, ta, st);
  const int nb = n_argmax_blocks(d);
  argmax_partial<<<dim3(nb, 1), ARGMAX_THREADS, 0, st>>>(ta, 1, d.Vp, d.V, s.pmax, s.pidx, ts);
  argmax_final<<<1, ARGMAX_THREADS, 0, st>>>(s.pmax, s.pidx, nb, (int*)p->token_out);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

// The prefill's routing of N rows from the router's logits [N, E] f32
// before their row scales sx [N]: wts f32 and ids int32 [N K] by pair, order
// int32 [N K] and off int32 [E + 1] (moe_route).
extern "C" int qw_moe_route(const void* logits, const void* sx, int N, int E, int K,
                            void* wts, void* ids, void* order, void* off, void* stream) {
  if (N < 0 || E <= 0 || E > ROUTE_MAX_E || K <= 0 || K > ROUTE_MAX_K || K > E || K > 32)
    return (int)cudaErrorInvalidValue;
  moe_route<<<1, ROUTE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)sx, N, E, K, (float*)wts, (int*)ids,
      (int*)order, (int*)off);
  return (int)cudaGetLastError();
}

// The prefill's gate-up products of one layer: xq int8 [>= N, H] row codes
// with scales sx [N]; order int32 [N K] (sorted slot -> pair row * K + k) and
// off int32 [E + 1] the experts' slot ranges; wq int8 [E, 2F, H], ws f32
// [E, 2F] -> act bf16 [N K, F], the SwiGLU rows in slot order; stats int32
// [2] accumulates (experts with a pair, most pairs of one).
extern "C" int qw_moe_gate_up(const void* xq, const void* sx, const void* order,
                              const void* off, const void* wq, const void* ws, int H, int F,
                              int E, int K, void* act, void* stats, void* stream) {
  if (H <= 0 || H % KCH || F <= 0 || F % GU_COLS || E <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  moe_gate_up<<<dim3(F / GU_COLS, E), MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)sx, (const int*)order, (const int*)off,
      (const int8_t*)wq, (const float*)ws, H, F, K, (__nv_bfloat16*)act, (int*)stats);
  return (int)cudaGetLastError();
}

// The prefill's down products: fq int8 [N K, F] / fs f32 [N K] in slot
// order, order / off as above, wts f32 [N K] the pairs' weights, wq int8 [E,
// H, F], ws f32 [E, H] -> ys f32 [N K, H], pair rows (every pair written).
extern "C" int qw_moe_down(const void* fq, const void* fs, const void* order, const void* off,
                           const void* wts, const void* wq, const void* ws, int H, int F, int E,
                           void* ys, void* stream) {
  if (H <= 0 || H % DN_COLS || F <= 0 || F % KCH || E <= 0) return (int)cudaErrorInvalidValue;
  moe_down<<<dim3(H / DN_COLS, E), MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)fq, (const float*)fs, (const int*)order, (const int*)off,
      (const float*)wts, (const int8_t*)wq, (const float*)ws, H, F, (float*)ys);
  return (int)cudaGetLastError();
}

// One greedy MoE decode step over an int8 (scales set) or a bf16 KV cache at
// the position pos[0] on the device, as qw_mega_decode_step_i8 /
// qw_mega_decode_step take it (the int8 pack's attention and head: dp's
// FF is the experts' width, g_gu = H, g_wd = FF), with the experts and the
// router of mp. Nothing is allocated or read on the host: capturable.
extern "C" int qw_moe_decode_step_i8(const MegaPtrs* p, const MegaDims* dp, const MoePtrs* mp,
                                     const MoeDims* md, const int* pos, void* stream) {
  return moe_step<int8_t>(p, dp, mp, md, pos, stream);
}

extern "C" int qw_moe_decode_step(const MegaPtrs* p, const MegaDims* dp, const MoePtrs* mp,
                                  const MoeDims* md, const int* pos, void* stream) {
  return moe_step<__nv_bfloat16>(p, dp, mp, md, pos, stream);
}

