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
//   moe_attn_layer the attention half in one persistent launch, one block
//                  an SM: the attention norm's row codes (norm_quant's
//                  arithmetic, as K1's prologue) and the QKV product on
//                  output-major copies of the int8pc codes, K1's attention
//                  with a KV head's 8 q heads split over 4 tasks, the Wo
//                  product, and h1 with the FFN norm's row codes, written
//                  once; the layer's QKV and Wo rows stream into shared
//                  memory while the codes and the attention run;
//   moe_router     16 experts' logits a block on those codes, and in the
//                  block that finishes last the top-k with its
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
// few output rows with all their loads in flight at once. A step's layer
// is four dependent launches (~17 us of bytes a layer at 3.35 TB/s): it is
// bound by their latency, which is why the attention half is one launch.
// Programmatic dependent launch made the graphed step slower (8 layers:
// 0.87 ms against 0.75, six launches a layer), so the step launches plainly.
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
  void* bar;           // [1] uint32: moe_attn_layer's grid barrier, never reset
  void* done;          // [1] int32, zero between steps: moe_attn_layer's Wo blocks done
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
// over tasks: the thinker has 8 q heads a KV head (the 0.6B models 2), and
// attn_step's block per (KV head, chunk) would run 8 heads' scores and sums
// alone over 4 KV heads' chunks. Task (vh = kvh * QS + qs, c) takes chunk c
// of KV head kvh for the q heads qs * GS .. qs * GS + GS - 1 (GS = 2 when
// the group is even, QS = group / GS): the same operations on each head as
// attn_step (bf16 q / k / v from the QKV terms, RMSNorm, RoPE at pos, the
// chunk's max, sums and V sum, the merge with the fresh column by the task
// that finishes last), with the fresh K/V row stored by the merge of qs =
// 0. Partials: part[vh stride + c][GS][D + 2]. The QKV terms and the
// partials come from other blocks of the same launch. Every global input
// is staged into shared memory by cp.async.cg (from L2) in one batch: the
// terms, norms and row scales, then the chunk's rows; the merge stages the
// partials MERGE_TILE chunks at a time. Each batch costs one round trip to
// memory, where a load in a loop beside a shared store costs one a turn.

constexpr int MERGE_TILE = 16;   // chunks of partials a merge stages at once

// One 16-byte cp.async from global memory (at L2: never a stale L1 line of
// data another block of the launch wrote) into shared memory.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// n bytes (a multiple of 16) of global src into shared dst, 16-byte pieces
// over the block's threads; the caller commits and waits.
__device__ __forceinline__ void stage(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
    cp16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i);
}

// Commits the block's cp.async copies and waits for all of them.
__device__ __forceinline__ void staged() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Chunk c's K and V rows (< pos) of KV head kvh into kv [2][ATTN_ROWS][D]
// by cp.async; the caller commits.
template <typename CT>
__device__ __forceinline__ void stage_chunk(CT* kv, const CT* kc, const CT* vc,
                                            const MegaDims& d, int pos, int kvh, int c) {
  const int D = d.D, DKV = d.NKV * D, r0 = c * ATTN_ROWS, nr = min(ATTN_ROWS, pos - r0);
  const int pieces = D * (int)sizeof(CT) / 16;
  for (int i = threadIdx.x; i < 2 * nr * pieces; i += blockDim.x) {
    const int which = i / (nr * pieces), rem = i % (nr * pieces);
    const int r = rem / pieces, piece = rem % pieces;
    const CT* src = (which ? vc : kc) + (size_t)(r0 + r) * DKV + kvh * D;
    cp16(reinterpret_cast<unsigned char*>(kv + (which * ATTN_ROWS + r) * D) + piece * 16,
         reinterpret_cast<const unsigned char*>(src) + piece * 16);
  }
}

// Task (vh, c) in shared memory smem_raw (attn_task_smem), its chunk's rows
// staged here, or already in pre (stage_chunk, committed) where pre is given.
template <typename CT>
__device__ void attn_task(const float* terms, const float* qn, const float* kn,
                          const MegaDims& d, CT* kc, CT* vc, float* ksc, float* vsc,
                          float* part, int stride, int* cnt, __nv_bfloat16* attn_out, int pos,
                          int vh, int c, const float* rope, unsigned char* smem_raw,
                          const CT* pre) {
  constexpr bool QUANT = scaled_cache<CT>();
  __shared__ int last;
  const int D = d.D, NKV = d.NKV, G = d.NH / NKV, DKV = NKV * D, DQ = d.NH * D;
  const int GS = G % 2 ? 1 : 2, QS = G / GS, PW = GS * (D + 2);
  const int kvh = vh / QS, qs = vh % QS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int r0 = c * ATTN_ROWS, nr = min(ATTN_ROWS, pos - r0);
  CT* kv = reinterpret_cast<CT*>(smem_raw);   // [2][ATTN_ROWS][D]
  const CT* rows = pre ? pre : kv;
  float* vec = reinterpret_cast<float*>(smem_raw + 2 * ATTN_ROWS * D * sizeof(CT));
  float* p = vec + (GS + 2) * D;        // [GS][ATTN_ROWS]
  float* ml = p + GS * ATTN_ROWS;       // m[GS], l[GS] (4 floats: keeps what follows 16-aligned)
  float* kss = ml + 4;                  // [ATTN_ROWS]
  float* vss = kss + ATTN_ROWS;
  float* nw = vss + ATTN_ROWS;          // q_norm [D], k_norm [D]
  float* ob = nw + 2 * D;               // the merge's running V sums [GS D]
  float* pt = ob + GS * D;              // the merge's staged partials [MERGE_TILE][PW]
  // the task's q heads kvh G + qs GS + j (j < GS), k and v of kvh, the norms
  // and the chunk's row scales; then the chunk's K and V rows
  stage(vec, terms + (kvh * G + qs * GS) * D, 4 * GS * D);
  stage(vec + GS * D, terms + DQ + kvh * D, 4 * D);
  stage(vec + (GS + 1) * D, terms + DQ + DKV + kvh * D, 4 * D);
  stage(nw, qn, 4 * D);
  stage(nw + D, kn, 4 * D);
  if constexpr (QUANT) {
    for (int r = tid; r < nr; r += blockDim.x) {
      __pipeline_memcpy_async(kss + r, ksc + (size_t)(r0 + r) * NKV + kvh, 4);
      __pipeline_memcpy_async(vss + r, vsc + (size_t)(r0 + r) * NKV + kvh, 4);
    }
  }
  __pipeline_commit();
  if (pre) {
    __pipeline_wait_prior(0);
  } else {
    stage_chunk(kv, kc, vc, d, pos, kvh, c);
    __pipeline_commit();
    __pipeline_wait_prior(1);
  }
  __syncthreads();
  // bf16 of the terms, RMSNorm of q (q_norm) and k (k_norm), NEOX RoPE at
  // pos, q scaled
  for (int i = tid; i < (GS + 2) * D; i += blockDim.x) vec[i] = bf16_round(vec[i]);
  __syncthreads();
  for (int j = warp; j < GS + 1; j += nwarps) {
    float* x = vec + j * D;
    const float* w = j < GS ? nw : nw + D;
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
    const float cs = rope[e], sn = rope[half + e];
    const float x1 = x[e], x2 = x[e + half];
    float y1 = x1 * cs - x2 * sn, y2 = x2 * cs + x1 * sn;
    if (j < GS) {
      y1 *= d.scale;
      y2 *= d.scale;
    }
    x[e] = y1;
    x[e + half] = y2;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  const CT* ks_rows = rows;
  const CT* vs_rows = rows + ATTN_ROWS * D;
  // scores (times the row's k scale): a warp a row, 4 elements a lane (D <=
  // 256: two pieces), the lane's q elements of both heads in registers, both
  // heads from one load of the row, their warp sums interleaved
  float qr[2][2][4];
#pragma unroll
  for (int pc = 0; pc < 2; ++pc)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * lane + 128 * pc;
        qr[pc][j][k] = j < GS && e < D ? vec[j * D + e + k] : 0.f;
      }
  for (int r = warp; r < nr; r += nwarps) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      const int e = 4 * lane + 128 * pc;
      if (e >= D) continue;
      float k4[4];
      row4(ks_rows, r, D, e, k4);
      s0 += qr[pc][0][0] * k4[0] + qr[pc][0][1] * k4[1] + qr[pc][0][2] * k4[2] +
            qr[pc][0][3] * k4[3];
      s1 += qr[pc][1][0] * k4[0] + qr[pc][1][1] * k4[1] + qr[pc][1][2] * k4[2] +
            qr[pc][1][3] * k4[3];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane == 0) {
      p[r] = QUANT ? s0 * kss[r] : s0;
      if (GS > 1) p[ATTN_ROWS + r] = QUANT ? s1 * kss[r] : s1;
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
  float* out = part + ((size_t)vh * stride + c) * PW;
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
  // the merge (attn_merge's, for this task's q heads), over the partials
  // staged a tile of chunks at a time; a lane's chunks (cc = lane mod 32)
  // and a thread's V sums run in attn_merge's order across the tiles
  const int nchunks = n_attn_chunks(pos);
  float* wc = reinterpret_cast<float*>(smem_raw);   // [nchunks][GS], over the staging
  float* misc = kss;                                // p_fresh[GS], m[GS], den[GS]
  const float* kf = vec + GS * D;
  const float* vf = kf + D;
  const float* pk = part + (size_t)vh * stride * PW;
  stage(pt, pk, 4 * min(MERGE_TILE, nchunks) * PW);
  staged();
  for (int j = warp; j < GS; j += nwarps) {
    float sf = 0.f;
    for (int e = lane; e < D; e += 32) sf += vec[j * D + e] * kf[e];
    sf = warp_sum(sf);
    float mx = sf;
    for (int cc = lane; cc < nchunks; cc += 32)
      mx = fmaxf(mx, cc < MERGE_TILE ? pt[cc * PW + j * (D + 2)]
                                     : __ldcg(pk + (size_t)cc * PW + j * (D + 2)));
    mx = warp_max(mx);
    if (lane == 0) {
      misc[j] = expf(sf - mx);
      misc[GS + j] = mx;
    }
  }
  for (int pr = tid; pr < GS * D; pr += blockDim.x) ob[pr] = 0.f;
  float den = 0.f;   // warp j < GS: its lane's share of head j's denominator
  for (int c0 = 0; c0 < nchunks; c0 += MERGE_TILE) {
    const int c1 = min(c0 + MERGE_TILE, nchunks);
    if (c0 > 0) {
      __syncthreads();
      stage(pt, pk + (size_t)c0 * PW, 4 * (c1 - c0) * PW);
    }
    staged();
    if (warp < GS) {
      const int j = warp;
      const float mx = misc[GS + j];
      for (int cc = c0 + (lane - c0 % 32 + 32) % 32; cc < c1; cc += 32) {
        const float* pc = pt + (cc - c0) * PW + j * (D + 2);
        const float w = expf(pc[0] - mx);
        wc[cc * GS + j] = w;
        den += pc[1] * w;
      }
    }
    __syncthreads();
    for (int pr = tid; pr < GS * D; pr += blockDim.x) {
      const int j = pr / D, e = pr % D;
      float o = ob[pr];
#pragma unroll 4
      for (int cc = c0; cc < c1; ++cc) o = fmaf(pt[(cc - c0) * PW + j * (D + 2) + 2 + e],
                                                 wc[cc * GS + j], o);
      ob[pr] = o;
    }
  }
  if (warp < GS) {
    den = warp_sum(den);
    if (lane == 0) misc[2 * GS + warp] = den + misc[warp];
  }
  __syncthreads();
  for (int pr = tid; pr < GS * D; pr += blockDim.x) {
    const int j = pr / D, e = pr % D;
    const float res = (ob[pr] + misc[j] * vf[e]) / misc[2 * GS + j];
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

// Shared memory of an attention task: the chunk's K and V rows (the merge's
// weights [nchunks][GS] reuse their bytes), then vec[(GS + 2) D],
// p[GS][ATTN_ROWS], ml[4], kss and vss[ATTN_ROWS], the norms [2 D], the
// merge's V sums [GS D] and a tile of partials [MERGE_TILE][GS (D + 2)].
template <typename CT>
inline size_t attn_task_smem(const MegaDims& d) {
  const int G = d.NH / d.NKV, GS = G % 2 ? 1 : 2;
  return 2 * (size_t)ATTN_ROWS * d.D * sizeof(CT) +
         sizeof(float) * ((size_t)(GS + 2) * d.D + GS * ATTN_ROWS + 4 + 2 * ATTN_ROWS +
                          2 * d.D + GS * d.D + (size_t)MERGE_TILE * GS * (d.D + 2));
}

// -- the decode step's expert kernels -------------------------------------------

constexpr int GV_THREADS = 256;    // = PRO_THREADS: the blocks run row_codes
constexpr int GV_MAX_IN = 4096;    // widest input row of a product here (Wo's)
constexpr int ROUTER_EXPERTS = 16;                          // experts a router block
constexpr int ROUTER_SUBS = GV_THREADS / ROUTER_EXPERTS;     // threads an expert
constexpr int ROUTER_SLICE = 256;                            // input rows a router block
constexpr int MAX_EXPERTS = 256;
constexpr int MAX_TOPK = 16;
// (rows a warp, 16-byte pieces a lane a row) of each expert GEMV: every
// load of a block's rows is in flight at once (16 pieces a lane)
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

// -- the attention half of a layer: one persistent launch ----------------------
//
// moe_attn_layer runs a layer's attention half on one block an SM, all of
// them resident (a cooperative launch), in four phases:
//   1  the attention norm's row codes (every block), then the QKV product
//      of the block's share of output rows;
//   2  the attention tasks (attn_task) over the blocks in turn;
//   3  the attention row's codes (every block), the Wo product of the
//      block's share of rows and h1 = x + bf16(wo) for them;
//   4  in the block that finishes Wo last: the FFN norm's row codes xq /
//      sx of h1, written once for the router and the experts' gate-up GEMV.
// Grid barriers separate 1 | 2 | 3 (flags a block and a head group, so
// that a task waits only for its own inputs, measured no faster); a ticket
// hands 3 to 4. What bounds it is the chain of round trips to memory and
// the bytes: every phase stages its inputs into shared memory in batches
// that each cost one round trip (the QKV rows and the block's first cache
// chunk are on their way while the codes are made; the Wo rows, 8 MB a
// layer, stream in by TMA from the end of phase 1). The codes are
// norm_quant's and row_codes' bits (block_codes), the products and
// epilogues moe_gemv_dense's were: exact int32 dots, f32(acc) * (sx *
// ws[n]). Data written by another block of the launch is read from L2
// (cp.async.cg), never from a possibly stale L1 line.

constexpr int AL_THREADS = 512;
constexpr int AL_VIRT = NORM_THREADS / AL_THREADS;   // norm_quant's threads a thread plays
constexpr int AL_PER = NORM_MAX / NORM_THREADS;      // elements a norm_quant thread takes at most

// Byte offsets of the dynamic shared memory: the block's Wo rows, then one
// region for its QKV rows (phase 1), an attention task's staging (2) or the
// attention row (3), then a row's codes, a norm row's staged inputs (1, 4),
// the rows of the block's first attention chunk (staged in 1 for 2) and
// RoPE's cos and sin at pos [D].
struct AlLayout {
  int qkv, codes, row, pre, rope, bytes;
};

struct AlArgs {
  const __nv_bfloat16* base;     // [H] phase 1's row: h1, or x_in, or null: embd[*token]
  const __nv_bfloat16* embd;     // [V, H]
  const int* token;              // [1]
  const float* terms;            // [H] the down product's terms to add to h1, or null
  const float* attn_w;           // [H] the attention norm
  const int8_t* qkv_t;           // [NQKV, H] int8, output-major
  const float* qkv_s;            // [NQKV]
  const int8_t* wo_t;            // [H, DQ]
  const float* wo_s;             // [H]
  const float* qn;               // [D] q_norm, k_norm
  const float* kn;
  const float* ffn_w;            // [H] the FFN norm
  void* kc;                      // the layer's cache (CT) and scales
  void* vc;
  float* ksc;
  float* vsc;
  float* qkv_terms;              // [NQKV]
  float* part;                   // the attention's partials
  int* acnt;                     // [NH] attention chunks done, zero between launches
  __nv_bfloat16* attn;           // [DQ] the attention row
  __nv_bfloat16* h1;             // [H] out: x + bf16(wo), a block's Wo rows each
  int8_t* xq;                    // [H] out: the FFN norm's row codes
  float* sx;                     // [1] out: their scale
  unsigned* bar;                 // [1] the grid barrier's word, never reset
  int* done;                     // [1] Wo blocks done, zero between launches
  const int* pos;                // [1] the position
  int stride;                    // the partials' chunks a vh: n_attn_chunks(d.pos)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Bytes [0, n) of global src into shared dst (n a multiple of 16, under
// the mbarrier's 1 MB of transactions) by one bulk copy (TMA) that
// completes on the mbarrier mb (one arrival expected). One thread calls it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t n, uint64_t* mb) {
  const uint32_t bar = smem_u32(mb);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(n)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(n), "r"(bar)
      : "memory");
}

// Waits for the mbarrier's first phase (every thread that reads the bytes).
__device__ __forceinline__ void bulk_wait(uint64_t* mb) {
  const uint32_t bar = smem_u32(mb);
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(0u)
        : "memory");
}

// Every block of the (co-resident) grid waits here for all the others. The
// word gains 2^31 a barrier (block 0 adds 2^31 - (blocks - 1), the others
// 1): its top bit flips when the last block arrives and its low bits come
// back to where they were, so nothing resets it between launches or graph
// replays.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    while (((old ^ *(volatile unsigned*)bar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// t[r] = f32(rows[r] . codes) * (sx * ws[r]) for the n shared rows of n_in
// int8 (a multiple of 16): a warp a row, 16-byte pieces a lane; out[r] = t
// (f32), or with x (shared bf16), h[r] = bf16(x[r] + bf16(t)), the
// residual (resid_of).
__device__ __forceinline__ void smem_dots(const int8_t* rows, int n, int n_in,
                                          const int8_t* codes, float sx,
                                          const float* __restrict__ ws, float* out,
                                          const __nv_bfloat16* x = nullptr,
                                          __nv_bfloat16* h = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, np = n_in / 16;
  const int4* xw = reinterpret_cast<const int4*>(codes);
  for (int r = warp; r < n; r += AL_THREADS / 32) {
    const int4* w = reinterpret_cast<const int4*>(rows + (size_t)r * n_in);
    int a = 0;
#pragma unroll 4
    for (int c = lane; c < np; c += 32) {
      const int4 wv = w[c], xv = xw[c];
      a = __dp4a(wv.x, xv.x, a);
      a = __dp4a(wv.y, xv.y, a);
      a = __dp4a(wv.z, xv.z, a);
      a = __dp4a(wv.w, xv.w, a);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane != 0) continue;
    const float t = (float)a * (sx * ws[r]);
    if (x)
      h[r] = __float2bfloat16_rn(resid_of(bf2f(x[r]), t));
    else
      out[r] = t;
  }
}

// The int8 codes of a row of N bf16 values xs (shared memory) into codes,
// and its scale, returned to every thread: with a norm weight ws, x =
// resid_of(xs, ts) (ts the residual terms, or none: x = xs) and y =
// bf16(rms(x) * ws), else y = xs. norm_quant's arithmetic and its sum of
// squares in its order: thread tid plays its threads tid + AL_THREADS j,
// whose strided sums meet in its warp butterflies, the codes and scale of
// row_codes bit for bit; the row stays in registers, and with ts the sum x
// goes back into xs (bf16, exact).
__device__ float block_codes(__nv_bfloat16* xs, const float* ts, const float* ws, float eps,
                            int N, int8_t* codes, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v[AL_VIRT][AL_PER], sq[AL_VIRT];
#pragma unroll
  for (int j = 0; j < AL_VIRT; ++j) {
    sq[j] = 0.f;
#pragma unroll
    for (int k = 0; k < AL_PER; ++k) {
      const int i = tid + j * AL_THREADS + k * NORM_THREADS;
      if (i < N) {
        float x = bf2f(xs[i]);
        if (ts) {
          x = resid_of(x, ts[i]);
          xs[i] = __float2bfloat16_rn(x);
        }
        v[j][k] = x;
        sq[j] = fmaf(x, x, sq[j]);
      }
    }
  }
  float r = 1.f;
  if (ws) {
#pragma unroll
    for (int j = 0; j < AL_VIRT; ++j) {
      const float s = warp_sum(sq[j]);
      if (lane == 0) red[warp + j * (AL_THREADS / 32)] = s;
    }
    __syncthreads();
    const float tot = warp_sum(red[lane]);
    r = rsqrtf(tot / (float)N + eps);
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < AL_VIRT; ++j)
#pragma unroll
    for (int k = 0; k < AL_PER; ++k) {
      const int i = tid + j * AL_THREADS + k * NORM_THREADS;
      if (i < N) {
        float y = v[j][k];
        if (ws) y = bf16_round(y * r * ws[i]);
        v[j][k] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  amax = warp_max(amax);
  __syncthreads();   // red is free again
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = warp_max(lane < AL_THREADS / 32 ? red[lane] : 0.f);
  const float sx = quant_scale(amax);
#pragma unroll
  for (int j = 0; j < AL_VIRT; ++j)
#pragma unroll
    for (int k = 0; k < AL_PER; ++k) {
      const int i = tid + j * AL_THREADS + k * NORM_THREADS;
      if (i < N) codes[i] = quant_code(v[j][k], sx);
    }
  __syncthreads();
  return sx;
}

template <typename CT>
__global__ void __launch_bounds__(AL_THREADS, 1) moe_attn_layer(AlArgs a, MegaDims d,
                                                                  AlLayout lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t mb;   // the Wo rows
  __shared__ float red[32];
  __shared__ int last;
  const int H = d.H, DQ = d.NH * d.D, DKV = d.NKV * d.D, NQKV = DQ + 2 * DKV;
  const int nb = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int q0 = (int)((long long)b * NQKV / nb), q1 = (int)((long long)(b + 1) * NQKV / nb);
  const int o0 = (int)((long long)b * H / nb), o1 = (int)((long long)(b + 1) * H / nb);
  int8_t* wo_rows = reinterpret_cast<int8_t*>(smem);
  unsigned char* region = smem + lay.qkv;
  int8_t* codes = reinterpret_cast<int8_t*>(smem + lay.codes);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + lay.row);
  float* ts = reinterpret_cast<float*>(smem + lay.row + 2 * H);
  float* ws = ts + H;
  CT* pre = reinterpret_cast<CT*>(smem + lay.pre);
  float* rope = reinterpret_cast<float*>(smem + lay.rope);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&mb)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int pos = a.pos[0];
  const int G = d.NH / d.NKV, GS = G % 2 ? 1 : 2, QS = G / GS, nvh = d.NH / GS;
  const int nch = n_attn_chunks(pos);
  // 1: staged in three batches, each on its way before the last lands: the
  // attention norm's row (x: h1 + the down terms, or the input row) and
  // weight; the block's QKV rows; the rows of its first attention chunk
  // (cache rows < pos, which no block of this launch writes). The codes (x
  // stays in xs), QKV, then the Wo rows sent for (TMA) while the rest runs.
  stage(xs, a.base ? a.base : a.embd + (size_t)(*a.token) * H, 2 * H);
  if (a.terms) stage(ts, a.terms, 4 * H);
  stage(ws, a.attn_w, 4 * H);
  __pipeline_commit();
  stage(region, a.qkv_t + (size_t)q0 * H, (q1 - q0) * H);
  __pipeline_commit();
  if (b < nvh * nch) stage_chunk(pre, (const CT*)a.kc, (const CT*)a.vc, d, pos, b / nch / QS,
                                 b % nch);
  __pipeline_commit();
  __pipeline_wait_prior(2);
  __syncthreads();
  float sx = block_codes(xs, a.terms ? ts : nullptr, ws, d.eps, H, codes, red);
  for (int e = tid; e < d.D / 2; e += AL_THREADS) {   // every task's RoPE, once
    const float inv = expf((float)e * d.rope_coef);
    const float ang = (float)pos * inv;
    rope[e] = cosf(ang);
    rope[d.D / 2 + e] = sinf(ang);
  }
  __pipeline_wait_prior(1);
  __syncthreads();
  if (tid == 0) bulk_load(wo_rows, a.wo_t + (size_t)o0 * DQ, (uint32_t)(o1 - o0) * DQ, &mb);
  smem_dots(reinterpret_cast<const int8_t*>(region), q1 - q0, H, codes, sx, a.qkv_s + q0,
            a.qkv_terms + q0);
  grid_barrier(a.bar);
  // 2: the attention tasks
  for (int t = b; t < nvh * nch; t += nb) {
    attn_task<CT>(a.qkv_terms, a.qn, a.kn, d, (CT*)a.kc, (CT*)a.vc, a.ksc, a.vsc, a.part,
                  a.stride, a.acnt, a.attn, pos, t / nch, t % nch, rope, region,
                  t == b ? pre : nullptr);
    __syncthreads();
  }
  grid_barrier(a.bar);
  // 3: the attention row's codes (the FFN norm's weight staged beside it),
  // then Wo and h1 = x + bf16(wo), the block's rows
  __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(region);
  stage(row, a.attn, 2 * DQ);
  stage(ws, a.ffn_w, 4 * H);
  staged();
  sx = block_codes(row, nullptr, nullptr, 0.f, DQ, codes, red);
  bulk_wait(&mb);
  smem_dots(wo_rows, o1 - o0, DQ, codes, sx, a.wo_s + o0, nullptr, xs + o0, a.h1 + o0);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(a.done, 1) == nb - 1;
    if (last) *a.done = 0;
  }
  __syncthreads();
  if (!last) return;
  // 4: the FFN norm's codes of h1, once
  stage(xs, a.h1, 2 * H);
  staged();
  sx = block_codes(xs, nullptr, ws, d.eps, H, codes, red);
  for (int i = tid; i < H / 16; i += AL_THREADS)
    reinterpret_cast<uint4*>(a.xq)[i] = reinterpret_cast<const uint4*>(codes)[i];
  if (tid == 0) *a.sx = sx;
}

// The layout of moe_attn_layer's dynamic shared memory at nb blocks.
template <typename CT>
inline AlLayout al_layout(const MegaDims& d, int nb) {
  const int H = d.H, DQ = d.NH * d.D, NQKV = DQ + 2 * d.NKV * d.D;
  auto up = [](size_t n) { return (int)((n + 127) & ~(size_t)127); };
  size_t region = (size_t)ceil_div(NQKV, nb) * H;
  const size_t other[2] = {attn_task_smem<CT>(d), 2 * (size_t)DQ};
  for (size_t o : other) region = region > o ? region : o;
  AlLayout l;
  l.qkv = up((size_t)ceil_div(H, nb) * DQ);
  l.codes = l.qkv + up(region);
  l.row = l.codes + up(H > DQ ? H : DQ);
  l.pre = l.row + up(10 * (size_t)H);
  l.rope = l.pre + up(2 * (size_t)ATTN_ROWS * d.D * sizeof(CT));
  l.bytes = l.rope + up(4 * (size_t)d.D);
  return l;
}

// The grid of moe_attn_layer (one block an SM of the current device) and
// its layout; an error when a block does not fit on an SM.
template <typename CT>
int al_grid(const MegaDims& d, int* nb, AlLayout* lay) {
  int dev = 0, nsm = 0, occ = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (!rc) rc = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (rc) return (int)rc;
  *lay = al_layout<CT>(d, nsm);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, moe_attn_layer<CT>, AL_THREADS,
                                                     lay->bytes);
  if (rc) return (int)rc;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *nb = nsm;
  return 0;
}

// Block (g, b): the sums of experts [16g, 16g + 16) over input rows [256b,
// 256b + 256) of the FFN norm's row codes (xq, sx; moe_attn_layer's phase
// 4): thread (sub, e) adds code[r] * router[r][e] over its 16 rows in
// order, its router weights loaded before the codes; the 16 subs meet in
// order into part[b][e]. The block that finishes last forms logits[e] = sx
// * the sum over b in order, and takes the top K by logit (ties to the
// lower index), with weights exp(l - max) over their sum (renormalised
// over the k).
__global__ void __launch_bounds__(GV_THREADS) moe_router(
    const int8_t* __restrict__ xq, const float* __restrict__ sxp,
    const __nv_bfloat16* __restrict__ router, int H, int E, int K, float* __restrict__ part,
    int* __restrict__ cnt, int* __restrict__ ids, float* __restrict__ wts) {
  constexpr int PER = ROUTER_SLICE / ROUTER_SUBS;
  __shared__ int8_t codes[ROUTER_SLICE];
  __shared__ float sums[GV_THREADS];
  __shared__ float ps[NORM_MAX];
  __shared__ int last;
  const int e = blockIdx.x * ROUTER_EXPERTS + threadIdx.x % ROUTER_EXPERTS;
  const int sub = threadIdx.x / ROUTER_EXPERTS, rb = blockIdx.y * ROUTER_SLICE;
  const __nv_bfloat16* w = router + (size_t)(rb + sub * PER) * E + e;
  float wv[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) wv[r] = bf2f(w[(size_t)r * E]);
  for (int i = threadIdx.x; i < ROUTER_SLICE; i += GV_THREADS) codes[i] = xq[rb + i];
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < PER; ++r) acc = fmaf((float)codes[sub * PER + r], wv[r], acc);
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
  for (int i = threadIdx.x; i < (int)gridDim.y * E; i += GV_THREADS) ps[i] = __ldcg(part + i);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const float sx = *sxp;
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
         d.H <= 512 * GU_CPL && d.FF <= 512 * DN_CPL && d.H <= GV_MAX_IN &&
         DQ <= GV_MAX_IN && d.FF <= NORM_MAX && (2 * d.FF) % block_rows(GU_ROWS) == 0 &&
         d.H % block_rows(DN_ROWS) == 0 && d.H / ROUTER_SLICE * m.E <= NORM_MAX && d.D <= 256;
}

// One MoE decode step over a cache of element type CT.
template <typename CT>
int moe_step(const MegaPtrs* p, const MegaDims* dp, const MoePtrs* mp, const MoeDims* mdp,
             const int* pos, void* stream) {
  const MegaDims d = *dp;
  const MoeDims md = *mdp;
  cudaStream_t st = (cudaStream_t)stream;
  const int GS = (d.NH / d.NKV) % 2 ? 1 : 2;
  if (!pos || !step_ok<CT>(d, 64, 1024) || !moe_ok(d, md) || (GS * (d.D + 2)) % 4 ||
      (uintptr_t)p->x_in % 16 ||
      sizeof(float) * n_attn_chunks(d.S) * GS > 2 * ATTN_ROWS * d.D * sizeof(CT))
    return (int)cudaErrorInvalidValue;
  int nb = 0;
  AlLayout lay;
  int rc = al_grid<CT>(d, &nb, &lay);
  if (rc) return rc;
  constexpr bool QUANT = scaled_cache<CT>();
  const int DQ = d.NH * d.D, DKV = d.NKV * d.D, F = d.FF, H = d.H, E = md.E, K = md.K;
  const int SE = d.S / rows_per_elem<CT>();
  const size_t ts = terms_floats(d), qs = (size_t)widest_row(d);
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
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(AL_THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int l = 0; l < d.L; ++l) {
    AlArgs a{};
    a.embd = (const __nv_bfloat16*)p->embd;
    if (l == 0) {
      a.base = (const __nv_bfloat16*)p->x_in;
      a.token = (const int*)p->token_in;
    } else {
      a.base = s.h1;
      a.terms = tb;
    }
    a.attn_w = (const float*)p->attn_norm + (size_t)l * H;
    a.qkv_t = (const int8_t*)mp->qkv_t + (size_t)l * NQKV * H;
    a.qkv_s = (const float*)p->qkv_s + (size_t)l * NQKV;
    a.wo_t = (const int8_t*)mp->wo_t + (size_t)l * H * DQ;
    a.wo_s = (const float*)p->wo_s + (size_t)l * H;
    a.qn = (const float*)p->q_norm + (size_t)l * d.D;
    a.kn = (const float*)p->k_norm + (size_t)l * d.D;
    a.ffn_w = (const float*)p->ffn_norm + (size_t)l * H;
    a.kc = (CT*)p->k_cache + (size_t)l * SE * DKV;
    a.vc = (CT*)p->v_cache + (size_t)l * SE * DKV;
    a.ksc = QUANT ? (float*)p->k_scale + (size_t)l * d.S * d.NKV : nullptr;
    a.vsc = QUANT ? (float*)p->v_scale + (size_t)l * d.S * d.NKV : nullptr;
    a.qkv_terms = ta;
    a.part = s.part;
    a.acnt = (int*)mp->acnt;
    a.attn = s.attn;
    a.h1 = s.h1;
    a.xq = s.xq;
    a.sx = s.sx;
    a.bar = (unsigned*)mp->bar;
    a.done = (int*)mp->done;
    a.pos = pos;
    a.stride = n_attn_chunks(d.pos);
    rc = (int)cudaLaunchKernelEx(&cfg, moe_attn_layer<CT>, a, d, lay);
    if (rc) return rc;
    moe_router<<<dim3(E / ROUTER_EXPERTS, H / ROUTER_SLICE), GV_THREADS, 0, st>>>(
        s.xq, s.sx, router + (size_t)l * H * E, H, E, K, (float*)mp->part, (int*)mp->cnt,
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
  rc = qw_k1_gemv_i8(&in, p->head_q, p->head_s, H, d.Vp, s.iacc, s.tiles, ta, st);
  const int nab = n_argmax_blocks(d);
  argmax_partial<<<dim3(nab, 1), ARGMAX_THREADS, 0, st>>>(ta, 1, d.Vp, d.V, s.pmax, s.pidx, ts);
  argmax_final<<<1, ARGMAX_THREADS, 0, st>>>(s.pmax, s.pidx, nab, (int*)p->token_out);
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

// Raises moe_attn_layer's dynamic shared memory limit to what the device
// leaves beside its static bytes (once, at load: not inside a graph's
// capture).
template <typename CT>
static int al_init(int optin) {
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, moe_attn_layer<CT>);
  if (!rc)
    rc = cudaFuncSetAttribute(moe_attn_layer<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)fa.sharedSizeBytes);
  return (int)rc;
}

extern "C" int qw_moe_init() {
  int dev = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (!rc) rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc) return (int)rc;
  const int r8 = al_init<int8_t>(optin);
  return r8 ? r8 : al_init<__nv_bfloat16>(optin);
}

// The blocks of the step's persistent attention launch (moe_attn_layer) for
// dp over an int8 (int8_cache != 0) or a bf16 cache, into *blocks: one an
// SM; an error when a block does not fit.
extern "C" int qw_moe_attn_blocks(const MegaDims* dp, int int8_cache, int* blocks) {
  AlLayout lay;
  return int8_cache ? al_grid<int8_t>(*dp, blocks, &lay)
                    : al_grid<__nv_bfloat16>(*dp, blocks, &lay);
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

