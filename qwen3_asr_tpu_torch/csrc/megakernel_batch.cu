// One greedy decode step of up to 16 sequences at once: int4 or int8
// weights, an int8 or a bf16 KV cache, each sequence at its own position.
//
// Replaces: qwen3_asr_tpu/ops/megakernel_batch.py::_mega_batch_kernel in its
// resident-KV mode on either pack (entry mega_decode_step_batch), and adds a
// bf16-cache mode that the reference leaves to its vmapped XLA step
// (qwen3_asr_tpu/parallel/mesh.py:304-329). It computes
// what the Pallas body computes (megakernel_batch.py:351-567): for each row b
// the single-sequence step of megakernel.cu at position pos[b] on cache slab
// b, with per-row activation quantization scales, per-row RoPE, masks and
// first-index argmax. Rows never mix.
//
// What bounds it on an H100: the single-sequence step streams ~0.30 GB of
// int4 weights per token; B sequences stepping together read those bytes
// once, so the weight term per token falls as 1/B while each row's own int8
// cache (~2 KB of K/V per layer per cached row) is read by that row alone.
// The one kernel that differs from megakernel.cu is the GEMV, which becomes
// a skinny int4 GEMM: a block takes 64 output columns of one 512-row scale
// group for all B rows, each thread expands the nibbles of 4 columns x 4
// rows once (32-bit loads from two byte rows, a byte transpose with
// __byte_perm) and feeds them to one dp4a per (batch row, column). Register
// pressure is what shapes it: 16 rows x 4 columns = 64 int32 sums a thread
// (16 columns, as K1's thread holds, would take 256). Everything else is the
// launch sequence of megakernel.cuh with one block row per sequence: each
// GEMV's input codes come from a norm_quant / silu_quant launch with a block
// per row (K1's GEMVs make the same codes in their prologue), and attention
// launches a block per (KV head, 64-row chunk, sequence) over the host's
// upper bound of the positions, chunks at or past a row's own position
// exiting at once.
//
// Numerics: each row equals megakernel.cu run on that row alone, bit for
// bit. The products are int32 sums, exact in any order; the f32 terms are
// formed as K1 forms them, `f32(dot) * (sx_b * s_g)` (int4, per group) or
// `f32(dot) * (sx_b * s[n])` (int8); the codes are norm_quant's, which K1's
// prologue reproduces in the same f32 order, and the rest is the same
// device code.
#include "megakernel.cuh"

namespace {

constexpr int BGEMV_COLS = 64;       // output columns per block
constexpr int BGEMV_THREADS = 256;   // 16 column quads x 16 row slices
constexpr int BGEMV_SLICES = BGEMV_THREADS / (BGEMV_COLS / 4);
constexpr int BGEMV_WARPS = BGEMV_THREADS / 32;
constexpr int BGEMV_MAX_ROWS = 16;   // batch rows per block (and per launch)
constexpr int BGEMV_MAX_GROUP = 1024;
constexpr int BGEMV_SMEM = 32768;    // max(xs [BT][G] int8, part [warps][BT][64] int32)

// The block's int32 sums of B rows, one per (row, column): lanes l and l ^ 16
// hold the same columns; fold them, then one partial per warp into shared
// memory (which no longer holds xs), then the warps' partials of (b, nn) for
// i = b * 64 + nn, handed to out(b, nn, sum).
template <int BT, typename Out>
__device__ __forceinline__ void batch_sums(int (&acc)[BT][4], int* part, int cq, int B,
                                           Out out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[b][k] += __shfl_xor_sync(0xffffffffu, acc[b][k], 16);
  __syncthreads();
  if (lane < 16) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) part[(warp * BT + b) * BGEMV_COLS + cq * 4 + k] = acc[b][k];
  }
  __syncthreads();
  for (int i = tid; i < B * BGEMV_COLS; i += blockDim.x) {
    const int b = i / BGEMV_COLS, nn = i % BGEMV_COLS;
    int tot = 0;
    for (int v = 0; v < BGEMV_WARPS; ++v) tot += part[(v * BT + b) * BGEMV_COLS + nn];
    out(b, nn, tot);
  }
}

// Block (x, g): columns [64x, 64x+64) of scale group g, for all B <= BT rows.
// terms[b][g][n] = f32(sum_{r in group g} xq[b][r] * w4[r][n]) * (sx[b] *
// s[g][n]). Thread t owns columns 4 (t % 16) .. +3 and row quads q = t / 16,
// t / 16 + 16, ... of the group; a quad is byte rows 2q and 2q+1 (weight
// rows 4q .. 4q+3). Nibbles are expanded as (nibble << 4) in a signed byte,
// i.e. 16 x the weight, so the sums are 16 x the dot product (exact: |sum| <
// 2^24) and are shifted back before scaling.
template <int BT>
__global__ void __launch_bounds__(BGEMV_THREADS) gemv_i4_batch(
    const int8_t* __restrict__ xq, size_t qs, const float* __restrict__ sx,
    const uint8_t* __restrict__ wq, const float* __restrict__ ws, int G, int N,
    float* __restrict__ terms, size_t ts, int B) {
  __shared__ __align__(16) unsigned char smem[BGEMV_SMEM];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);   // [BT][G]
  int* part = reinterpret_cast<int*>(smem);       // [warps][BT][64], after the loop
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int cq = tid % (BGEMV_COLS / 4), slice = tid / (BGEMV_COLS / 4);
  const int col0 = blockIdx.x * BGEMV_COLS + cq * 4;
  for (int i = tid; i < BT * G; i += blockDim.x) {
    const int b = i / G, r = i % G;
    xs[i] = b < B ? xq[b * qs + (size_t)g * G + r] : (int8_t)0;
  }
  __syncthreads();

  int acc[BT][4];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0;
  const uint8_t* wg = wq + (size_t)g * (G / 2) * N + col0;
  const int* xs32 = reinterpret_cast<const int*>(xs);
  const int nq = G / 4;
#pragma unroll 4
  for (int q = slice; q < nq; q += BGEMV_SLICES) {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(wg + (size_t)(2 * q) * N);
    const uint32_t c = *reinterpret_cast<const uint32_t*>(wg + (size_t)(2 * q + 1) * N);
    // 16 x weight of rows 4q (a lo), 4q+1 (a hi), 4q+2 (c lo), 4q+3 (c hi),
    // four columns per word
    const uint32_t alo = (a << 4) & 0xf0f0f0f0u, ahi = a & 0xf0f0f0f0u;
    const uint32_t clo = (c << 4) & 0xf0f0f0f0u, chi = c & 0xf0f0f0f0u;
    const uint32_t p01 = __byte_perm(alo, ahi, 0x5140), p23 = __byte_perm(alo, ahi, 0x7362);
    const uint32_t q01 = __byte_perm(clo, chi, 0x5140), q23 = __byte_perm(clo, chi, 0x7362);
    // column word k: bytes = rows 4q .. 4q+3 of column col0 + k
    const int w[4] = {(int)__byte_perm(p01, q01, 0x5410), (int)__byte_perm(p01, q01, 0x7632),
                      (int)__byte_perm(p23, q23, 0x5410), (int)__byte_perm(p23, q23, 0x7632)};
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const int xw = xs32[b * nq + q];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[b][k] = __dp4a(w[k], xw, acc[b][k]);
    }
  }
  batch_sums<BT>(acc, part, cq, B, [&](int b, int nn, int tot) {
    const int n = blockIdx.x * BGEMV_COLS + nn;
    terms[b * ts + (size_t)g * N + n] = (float)(tot >> 4) * (sx[b] * ws[(size_t)g * N + n]);
  });
}

// int8 weights [in, N], one scale per column. Block (x, c): columns [64x,
// 64x+64) of input rows [c KC, c KC + KC), for all B <= BT rows. Thread t
// owns columns 4 (t % 16) .. +3 and row quads q = t / 16, t / 16 + 16, ...
// (rows 4q .. 4q+3: four 32-bit loads, byte-transposed into one word per
// column). The sums of a one-slice product are scaled here; otherwise they
// meet in iacc[b][N] and the tile's last block scales them.
template <int BT>
__global__ void __launch_bounds__(BGEMV_THREADS) gemv_i8_batch(
    const int8_t* __restrict__ xq, size_t qs, const float* __restrict__ sx,
    const int8_t* __restrict__ wq, const float* __restrict__ ws, int KC, int N,
    int* __restrict__ iacc, int* __restrict__ tiles, float* __restrict__ terms, size_t ts,
    int B) {
  __shared__ __align__(16) unsigned char smem[BGEMV_SMEM];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);   // [BT][KC]
  int* part = reinterpret_cast<int*>(smem);       // [warps][BT][64], after the loop
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int cq = tid % (BGEMV_COLS / 4), slice = tid / (BGEMV_COLS / 4);
  const int col0 = blockIdx.x * BGEMV_COLS + cq * 4;
  for (int i = tid; i < BT * KC; i += blockDim.x) {
    const int b = i / KC, r = i % KC;
    xs[i] = b < B ? xq[b * qs + (size_t)c * KC + r] : (int8_t)0;
  }
  __syncthreads();

  int acc[BT][4];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[b][k] = 0;
  const int8_t* wc = wq + (size_t)c * KC * N + col0;
  const int* xs32 = reinterpret_cast<const int*>(xs);
  const int nq = KC / 4;
#pragma unroll 4
  for (int q = slice; q < nq; q += BGEMV_SLICES) {
    const int8_t* w = wc + (size_t)(4 * q) * N;
    const uint32_t a = *reinterpret_cast<const uint32_t*>(w);
    const uint32_t bb = *reinterpret_cast<const uint32_t*>(w + N);
    const uint32_t e = *reinterpret_cast<const uint32_t*>(w + 2 * (size_t)N);
    const uint32_t f = *reinterpret_cast<const uint32_t*>(w + 3 * (size_t)N);
    const uint32_t t0 = __byte_perm(a, bb, 0x5140), t1 = __byte_perm(a, bb, 0x7362);
    const uint32_t t2 = __byte_perm(e, f, 0x5140), t3 = __byte_perm(e, f, 0x7362);
    // column word k: bytes = rows 4q .. 4q+3 of column col0 + k
    const int wk[4] = {(int)__byte_perm(t0, t2, 0x5410), (int)__byte_perm(t0, t2, 0x7632),
                       (int)__byte_perm(t1, t3, 0x5410), (int)__byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const int xw = xs32[b * nq + q];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[b][k] = __dp4a(wk[k], xw, acc[b][k]);
    }
  }
  const bool split = gridDim.y > 1;
  batch_sums<BT>(acc, part, cq, B, [&](int b, int nn, int tot) {
    const int n = blockIdx.x * BGEMV_COLS + nn;
    if (split) atomicAdd(&iacc[(size_t)b * N + n], tot);
    else terms[b * ts + n] = (float)tot * (sx[b] * ws[n]);
  });
  if (split && i8_tile_done(tiles)) {
    for (int i = tid; i < B * BGEMV_COLS; i += blockDim.x) {
      const int b = i / BGEMV_COLS, n = blockIdx.x * BGEMV_COLS + i % BGEMV_COLS;
      terms[b * ts + n] = (float)atomicExch(&iacc[(size_t)b * N + n], 0) * (sx[b] * ws[n]);
    }
    if (tid == 0) tiles[blockIdx.x] = 0;
  }
}

// One GEMV of the step at batch tile BT (the smallest of 1, 2, 4, 8, 16 that
// holds B): the int4 or the int8 kernel by d.wbits, from s.xq / s.sx into
// terms.
template <int BT>
void launch_gemv(const MegaDims& d, const Scratch& s, cudaStream_t st, const void* wq,
                 const float* sc, size_t l, int n_in, int N, int G, int B, float* terms) {
  const size_t qs = (size_t)widest_row(d), ts = terms_floats(d);
  if (d.wbits == 8) {
    const int kc = split_rows(n_in);
    gemv_i8_batch<BT><<<dim3(N / BGEMV_COLS, n_in / kc), BGEMV_THREADS, 0, st>>>(
        s.xq, qs, s.sx, (const int8_t*)wq + l * (size_t)n_in * N, sc, kc, N, s.iacc,
        s.tiles, terms, ts, B);
  } else {
    gemv_i4_batch<BT><<<dim3(N / BGEMV_COLS, n_in / G), BGEMV_THREADS, 0, st>>>(
        s.xq, qs, s.sx, (const uint8_t*)wq + l * (size_t)(n_in / 2) * N, sc, G, N,
        terms, ts, B);
  }
}

// The codes of a GEMV's input rows (RowIn) for all B rows into s.xq / s.sx:
// one norm_quant or silu_quant launch, a block per row (nothing for codes
// already there). K1's GEMVs make the same codes in their prologue.
void row_kernel(const RowIn& in, const MegaDims& d, const Scratch& s, cudaStream_t st,
                int B) {
  const size_t qs = (size_t)widest_row(d), ts = terms_floats(d);
  if (in.kind == ROW_NORM || in.kind == ROW_QUANT) {
    norm_quant<<<B, NORM_THREADS, 0, st>>>(in.base, in.embd, in.token, in.terms, in.n_g,
                                           in.N, in.w, in.eps, in.x_out, nullptr, s.xq,
                                           s.sx, ts, qs);
  } else if (in.kind == ROW_SILU) {
    silu_quant<<<B, NORM_THREADS, 0, st>>>(in.terms, in.n_g, in.N, s.xq, s.sx, ts, qs);
  }
}

}  // namespace

extern "C" size_t qw_mega_batch_scratch_bytes(const MegaDims* d, int B) {
  Scratch s;
  return layout(*d, B, nullptr, &s);
}

namespace {

// One decode step of B sequences over a cache of element type CT, on either
// pack: decode_step's launch sequence with a norm_quant / silu_quant launch
// and the batched GEMV per product.
template <typename CT>
int run_batch(const MegaPtrs* p, const MegaDims* dp, const int* pos, int B, void* stream) {
  const MegaDims d = *dp;
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > BGEMV_MAX_ROWS || !pos) return (int)cudaErrorInvalidValue;
  if (!step_ok<CT>(d, BGEMV_COLS, BGEMV_MAX_GROUP)) return (int)cudaErrorInvalidValue;
  Scratch s;
  layout(d, B, (char*)p->scratch, &s);
  auto gemv = [&](const void* wq, const void* ws, size_t l, int n_in, int N, int G,
                  const RowIn& in, float* terms, bool) {
    row_kernel(in, d, s, st, B);
    // G = n_in for int8 weights, so the scale offset is l * N for both packs
    const float* sc = (const float*)ws + l * (size_t)(n_in / G) * N;
    if (B <= 1) launch_gemv<1>(d, s, st, wq, sc, l, n_in, N, G, B, terms);
    else if (B <= 2) launch_gemv<2>(d, s, st, wq, sc, l, n_in, N, G, B, terms);
    else if (B <= 4) launch_gemv<4>(d, s, st, wq, sc, l, n_in, N, G, B, terms);
    else if (B <= 8) launch_gemv<8>(d, s, st, wq, sc, l, n_in, N, G, B, terms);
    else launch_gemv<16>(d, s, st, wq, sc, l, n_in, N, G, B, terms);
  };
  decode_step<CT>(p, d, pos, B, s, st, gemv);
  return (int)cudaGetLastError();
}

}  // namespace

// One decode step of B sequences, on either pack. p's activation pointers
// are [B, ...] (the token input [B] int32 or x_in [B, H] bf16; token_out [B];
// h_out [B, H]), its caches [B, L, S, ...] int8 with f32 scales; pos [B]
// int32 on the device, each in [1, S) and at most dp->pos, which sizes the
// attention grid. Everything runs on `stream`; nothing is allocated and the
// host is never waited on. Returns a cudaError_t code.
extern "C" int qw_mega_decode_step_batch_i8(const MegaPtrs* p, const MegaDims* dp,
                                            const int* pos, int B, void* stream) {
  return run_batch<int8_t>(p, dp, pos, B, stream);
}

// The same step over bf16 cache slabs [B, L, S, DKV] with no scales
// (k_scale / v_scale null): row b is K1's bf16-cache step (megakernel.cu
// qw_mega_decode_step) on slab b, bit for bit. The reference keeps bf16
// batches off its batched kernel because B bf16 slabs would not fit the
// TPU core's VMEM; here a block stages one 64-row chunk of one row's slab
// (attn_smem<bf16>, 35.9 KB at D 128, whatever B), so B bf16 slabs cost only
// their bytes.
extern "C" int qw_mega_decode_step_batch(const MegaPtrs* p, const MegaDims* dp,
                                         const int* pos, int B, void* stream) {
  return run_batch<__nv_bfloat16>(p, dp, pos, B, stream);
}
