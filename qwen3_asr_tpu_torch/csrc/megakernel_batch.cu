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
// What bounds it on an H100: bytes. B sequences stepping together read the
// pack's weights once (0.6 GB a step on the int8 pack, 0.3 GB on the int4
// one, the same for every B <= 16) while each row's own cache (~2 KB of
// int8 K/V per layer per cached row) is read by that row alone; at ~2
// operations per weight byte and row, B = 16 does 32 operations a byte,
// far under the tensor cores' ~590 int8 operations a byte of HBM. So the
// products are skinny GEMMs whose time should be the weights' bytes,
// whatever B is. The step is five kernels a layer, as K1's (the QKV
// product, K1's own attn_step, the Wo, gate-up and down products), then
// the final norm, the lm head's product and the argmax (batch_step). The
// products' design:
// - The tensor cores, mma.sync m16n8k32 s8 x s8 -> s32: M = 16 output
//   columns, N = 8 batch rows (two n-tiles for B > 8; padding rows get zero
//   codes and are never stored), K = 32 input rows. The 8-bit MMA takes both
//   operands K-contiguous and the pack is [in, N] with N contiguous (K1
//   reads the same pack), so the kernel transposes: a lane reads 16
//   neighbouring columns of 4 input rows as four 16-byte vectors and
//   __byte_perm turns them into 16 words of 4 consecutive input rows, one
//   per column, which are the A fragments as they stand (an MMA's M index
//   stands for any permutation of the tile's columns; the epilogue writes
//   each sum to its true column). The int4 pack's nibbles are expanded to
//   s8 as 16 x the weight and the int32 sums shifted back (>> 4) before
//   scaling. The activation codes [B][K] in shared memory are the B
//   operand as they are.
// - Weights in flight: a block takes 128 output columns of a 256-row slice
//   (int8; all rows when 256 does not divide them or when the column tiles
//   alone fill the card, as the lm head's do) or of one scale group (int4),
//   its 8 warps 32-row rounds in turn. Each lane copies its share of a
//   warp's next two rounds into a ring in shared memory with 16-byte
//   cp.async (its own bytes: no barrier), the first two before anything
//   else; products are launched with programmatic dependent launch, so
//   these loads are issued under the previous kernel's tail.
// - Codes in the prologue, as K1 makes them: no norm / quantization launch
//   before a product. Every block makes the int8 codes and scales of its B
//   input rows itself (batch_codes), from bf16 rows it copies whole into
//   shared memory with cp.async: the residual stream (the QKV and gate-up
//   inputs), the attention rows (Wo's) or the SwiGLU act (down's). The sum
//   of squares of each row follows norm_quant's order (its 1,024 threads'
//   strided sums and warp butterflies, replayed by one thread per virtual
//   warp), so the codes equal norm_quant's and K1's row_codes' bit for bit.
//   The final norm before the lm head stays a norm_quant launch (it also
//   writes h_out), and the head reads its codes.
// - The epilogues do the row work that K1's prologues do, once: the Wo and
//   down products add their f32 terms to the residual stream (resid_of,
//   int8 once a column, int4 over the groups in order by the last of the
//   tile's group blocks) and write the next bf16 row; the gate-up product
//   takes the gate and the matching up columns in one tile and writes the
//   SwiGLU act (silu_of, as silu_elem forms it). Only the QKV product
//   writes f32 terms, for attention: f32(dot) * (sx_b * s[n]) (int8, the 8
//   warps' int32 sums met in shared memory and the slices' through plain
//   stores that the tile's last block adds) or f32(dot >> 4) * (sx_b *
//   s_g[n]) per group (int4), K1's terms.
//
// Numerics: each row equals megakernel.cu run on that row alone, bit for
// bit. Integer sums are exact in any order, the f32 terms and the rows made
// from them are K1's, the codes are norm_quant's, and attention, the final
// norm and the argmax are the same device code.
#include "megakernel.cuh"

namespace {

constexpr int BMMA_THREADS = 256;                      // 8 warps
constexpr int BMMA_WARPS = BMMA_THREADS / 32;
constexpr int BMMA_COLS = 128;                         // output columns per block
constexpr int BMMA_ROUND = 32;                         // input rows per warp round (MMA K)
constexpr int BMMA_SLICE = 256;                        // int8 input rows per block
constexpr int BMMA_WIDE = 2 * 132;                     // column tiles that fill an H100 alone
constexpr int BMMA_STAGES = 2;                         // rounds a warp has in flight
constexpr int BMMA_MAX_ROWS = 16;                      // batch rows per launch
constexpr int BMMA_MAX_GROUP = 1024;
constexpr int BMMA_SMEM_MAX = 224 * 1024;              // dynamic shared memory a block may use
constexpr int CODES_PAD = 16;                          // bytes past each code row (banks)

// Input rows of one block of an int8 product of n_in rows and N columns:
// all of them (one block row, no cross-block sum) when the column tiles
// alone fill the card (the lm head) or BMMA_SLICE does not divide n_in,
// else BMMA_SLICE (the slices' sums meet through the step's scratch).
__host__ __device__ inline int slice_rows(int n_in, int N) {
  const bool wide = (N + BMMA_COLS - 1) / BMMA_COLS >= BMMA_WIDE;
  return wide || n_in % BMMA_SLICE ? n_in : BMMA_SLICE;
}

// A product block's dynamic shared memory, in bytes from 0: the weight
// ring (rounds in flight x 256 lanes x loads a round x 16 B), which the
// warps' int32 sums take over after the last round ([8][BT / 8 x 32][33]:
// one plane a warp, fragments x lanes, padded against bank conflicts), the
// codes [BT][kcp], the input rows as bf16 [B][n_xs] (none for ready codes),
// the norm weight w[n_w] (f32), then the floats red[BT * 32], rr[BT] and
// sxs[BT].
struct ProdLayout {
  int codes, xs, w, red, total;
};

__host__ __device__ inline int up16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline ProdLayout prod_layout(int BT, int B, bool i4, int KC, int n_xs,
                                                  int n_w) {
  const int rounds = KC / BMMA_ROUND;
  const int rpw = (rounds + BMMA_WARPS - 1) / BMMA_WARPS;
  const int stages = rpw < BMMA_STAGES ? rpw : BMMA_STAGES;
  const int ring = stages * BMMA_THREADS * (i4 ? 4 : 8) * 16;
  const int part = BMMA_WARPS * (BT / 8) * 32 * 33 * 4;
  ProdLayout L;
  L.codes = up16(ring > part ? ring : part);
  L.xs = L.codes + up16(BT * (KC + CODES_PAD));
  L.w = L.xs + up16(B * n_xs * 2);
  L.red = L.w + up16(n_w * 4);
  L.total = L.red + up16(BT * 34 * 4);
  return L;
}

// Elements of a product block's input rows and of its norm weight in
// shared memory.
__host__ __device__ inline int rows_elems(const RowIn& in) {
  return in.kind == ROW_CODES ? 0 : in.N;
}
__host__ __device__ inline int w_floats(const RowIn& in) {
  return in.kind == ROW_NORM ? in.N : 0;
}

// Four bf16 (two words, element 0 in the low half) to f32, exactly.
__device__ __forceinline__ void bf4(uint2 raw, float* f) {
  f[0] = __uint_as_float(raw.x << 16);
  f[1] = __uint_as_float(raw.x & 0xffff0000u);
  f[2] = __uint_as_float(raw.y << 16);
  f[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// Four f32 to bf16 (round to nearest even), packed as bf4 reads them.
__device__ __forceinline__ uint32_t bf2_bits(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint2 to_bf4(const float* f) {
  return make_uint2(bf2_bits(f[0], f[1]), bf2_bits(f[2], f[3]));
}

// The int8 codes of input rows [r0, r0 + KC) of the B batch rows of `in`
// into codes[b * kcp + k] (rows b >= B zero) and each row's scale into
// sxs[b], every code and scale equal to norm_quant's and K1's row_codes'
// bit for bit. The rows are bf16 [B][N] at in.base (or, with in.token, the
// embedding rows of token[b]): y = bf16(rms(x) * w) for ROW_NORM (w already
// in shared memory, wsm), y = x for ROW_QUANT; ready codes (ROW_CODES) at
// in.xq, row stride qs, with scales in.sx. Every thread of the block calls
// it; it ends with the block synchronised.
//   1. the B rows into xs with cp.async (16 bytes a copy, all in flight
//      together), then the residual (in.x_out, layer 0's embedding rows) by
//      block (0, 0);
//   2. NORM: the sum of squares of row b in norm_quant's order: its virtual
//      thread v of 1,024 sums x^2 over i = v, v + 1024, ... with fmaf, a
//      warp's 32 sums meet in the xor butterfly of warp_sum (here the same
//      tree, added by one thread per virtual warp), and the 32 warp sums in
//      one more warp_sum; rr[b] = rsqrt(sum / N + eps);
//   3. y = bf16(x * rr[b] * w) (NORM) or x, its amax (one warp a row) and
//      sx = quant_scale(amax);
//   4. the codes of the block's slice, quant_code(y, sx).
template <int BT>
__device__ void batch_codes(const RowIn& in, int B, size_t qs, int r0, int KC, int kcp,
                            int8_t* codes, __nv_bfloat16* xs, const float* wsm, float* red,
                            float* rr, float* sxs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (in.kind == ROW_CODES) {
    constexpr int U = 4;   // copies a thread has in flight together
    const int k16 = KC / 16;
    for (int i0 = tid; i0 < BT * k16; i0 += U * BMMA_THREADS) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * BMMA_THREADS, b = i / k16, k = 16 * (i - b * k16);
        v[u] = i < BT * k16 && b < B
                   ? __ldg(reinterpret_cast<const uint4*>(in.xq + b * qs + r0 + k))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * BMMA_THREADS, b = i / k16, k = 16 * (i - b * k16);
        if (i < BT * k16) *reinterpret_cast<uint4*>(codes + b * kcp + k) = v[u];
      }
    }
    if (tid < BT) sxs[tid] = tid < B && in.sx ? in.sx[tid] : 0.f;
    __syncthreads();
    return;
  }
  const int N = in.N, n8 = N / 8, n4 = N / 4;
  const bool norm = in.kind == ROW_NORM;
  for (int c = tid; c < B * n8; c += BMMA_THREADS) {
    const int b = c / n8, i = 8 * (c - b * n8);
    const __nv_bfloat16* row =
        in.token ? in.embd + (size_t)in.token[b] * N : in.base + (size_t)b * N;
    __pipeline_memcpy_async(xs + (size_t)b * N + i, row + i, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (in.x_out && blockIdx.x == 0 && blockIdx.y == 0)
    for (int c = tid; c < B * n8; c += BMMA_THREADS)
      reinterpret_cast<uint4*>(in.x_out)[c] = reinterpret_cast<const uint4*>(xs)[c];

  if (norm) {
    for (int u = tid; u < B * 32; u += BMMA_THREADS) {
      const int b = u >> 5, vw = u & 31;
      float v[32];
#pragma unroll
      for (int l = 0; l < 32; ++l) v[l] = 0.f;
      for (int i0 = vw * 32; i0 < N; i0 += NORM_THREADS) {
        const uint4* p = reinterpret_cast<const uint4*>(xs + (size_t)b * N + i0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 w = p[q];
          float f[8];
          bf4(make_uint2(w.x, w.y), f);
          bf4(make_uint2(w.z, w.w), f + 4);
#pragma unroll
          for (int m = 0; m < 8; ++m) v[8 * q + m] = fmaf(f[m], f[m], v[8 * q + m]);
        }
      }
      // warp_sum's butterfly as seen by lane 0: at offset o, v[l] += v[l + o]
#pragma unroll
      for (int l = 0; l < 16; ++l) v[l] = v[l] + v[l + 16];
#pragma unroll
      for (int l = 0; l < 8; ++l) v[l] = v[l] + v[l + 8];
#pragma unroll
      for (int l = 0; l < 4; ++l) v[l] = v[l] + v[l + 4];
      v[0] = v[0] + v[2];
      v[1] = v[1] + v[3];
      red[u] = v[0] + v[1];
    }
    __syncthreads();
    for (int b = warp; b < B; b += BMMA_WARPS) {
      const float tot = warp_sum(red[b * 32 + lane]);
      if (lane == 0) rr[b] = rsqrtf(tot / (float)N + in.eps);
    }
    __syncthreads();
  }

  for (int b = warp; b < B; b += BMMA_WARPS) {
    const float r = norm ? rr[b] : 1.f;
    __nv_bfloat16* xr = xs + (size_t)b * N;
    float amax = 0.f;
    for (int q = lane; q < n4; q += 32) {
      float y[4];
      bf4(*reinterpret_cast<const uint2*>(xr + 4 * q), y);
      if (norm) {
        const float4 w = *reinterpret_cast<const float4*>(wsm + 4 * q);
        y[0] = bf16_round(y[0] * r * w.x);
        y[1] = bf16_round(y[1] * r * w.y);
        y[2] = bf16_round(y[2] * r * w.z);
        y[3] = bf16_round(y[3] * r * w.w);
        *reinterpret_cast<uint2*>(xr + 4 * q) = to_bf4(y);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) amax = fmaxf(amax, fabsf(y[c]));
    }
    amax = warp_max(amax);
    if (lane == 0) sxs[b] = quant_scale(amax);
  }
  __syncthreads();

  const int k4 = KC / 4;
  for (int i = tid; i < BT * k4; i += BMMA_THREADS) {
    const int b = i / k4, k = 4 * (i - b * k4);
    char4 c = make_char4(0, 0, 0, 0);
    if (b < B) {
      float y[4];
      bf4(*reinterpret_cast<const uint2*>(xs + (size_t)b * N + r0 + k), y);
      const float sx = sxs[b];
      c = make_char4(quant_code(y[0], sx), quant_code(y[1], sx), quant_code(y[2], sx),
                     quant_code(y[3], sx));
    }
    *reinterpret_cast<char4*>(codes + b * kcp + k) = c;
  }
  __syncthreads();
}

// Rows a, b, e, f of 4 columns (a word each) -> one word per column holding
// its 4 rows in order (byte 0 = row a).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t e, uint32_t f,
                                           uint32_t* out) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);
  const uint32_t t2 = __byte_perm(e, f, 0x5140), t3 = __byte_perm(e, f, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One product's arguments. Its weights wq are [n_in, N] int8 (one scale a
// column, ws [N]) or [n_in / 2, N] int4 nibbles (ws [n_in / KC][N], KC the
// group); ws null (int8 only): the int32 sums themselves go to terms.
struct ProdArgs {
  RowIn in;                     // the B input rows and how their codes are made
  int B;
  size_t ts, qs;                // row strides: terms (floats), ready codes (bytes)
  const uint8_t* wq;
  const float* ws;
  int KC, N;                    // input rows per block; output columns
  int pair;                     // the gate-up product: FF (see prod_batch), else 0
  const __nv_bfloat16* rbase;   // with rout: the residual stream's rows [B][N]
  __nv_bfloat16* rout;          // the next residual rows resid_of(rbase, terms), or null
  int* ipart;                   // int8 slices' sums [n_in / KC][B][N]
  int* tiles;                   // a counter per column tile, zero between products
  float* terms;                 // [B][ts]: f32 terms ([groups][N] a row for int4)
  __nv_bfloat16* act;           // pair: the SwiGLU act [B][FF] (bf16 values)
};

// Output column of tile column nn (0..127) of block column x, and whether
// it exists: 128 neighbouring columns, or with pair = FF the gate columns
// 64x .. 64x + 63 (nn < 64) and the up columns FF + 64x .. (nn >= 64).
__device__ __forceinline__ int tile_col(const ProdArgs& a, int nn) {
  return a.pair ? (nn < 64 ? 0 : a.pair) + 64 * (int)blockIdx.x + (nn & 63)
                : BMMA_COLS * (int)blockIdx.x + nn;
}
__device__ __forceinline__ bool tile_live(const ProdArgs& a, int nn) {
  return a.pair ? 64 * (int)blockIdx.x + (nn & 63) < a.pair
                : BMMA_COLS * (int)blockIdx.x + nn < a.N;
}

// One product of B <= BT batch rows on the tensor cores. Block (x, y):
// 128 output columns of block column x (tile_col) of input rows [y KC, y KC
// + KC): an int8 slice, or int4 scale group y (KC = G). Lane (g, t) =
// (lane / 4, lane % 4) of warp w takes, in each of the warp's rounds r (w,
// w + 8, ... < KC / 32), tile columns 16g .. 16g + 15 of the rows 32r + 4kq
// .. 32r + 4kq + 3 for the MMA's k-quads kq = t and t + 4: four 16-byte
// vectors a quad (int8; int4: two byte rows), through the cp.async ring,
// transposed into W[h][c] = the quad's 4 rows of tile column 16g + c (h:
// kq = t + 4h). MMA j of a round takes tile columns 16g + 2j (as M row g)
// and 16g + 2j + 1 (M row g + 8): A = {W[0][2j], W[0][2j+1], W[1][2j],
// W[1][2j+1]}, and B = the codes of batch row g (+ 8 in the second n-tile)
// at the same two k-quads. D's (c0, c1, c2, c3) are then (tile column 16g +
// 2j, batch row 2t), (16g + 2j, 2t + 1), (16g + 2j + 1, 2t), (16g + 2j + 1,
// 2t + 1). The warps' sums meet in shared memory (one plane a warp, in that
// fragment order), the int8 slices' in a.ipart (plain stores; the tile's
// last block, i8_tile_done, adds them). A column's f32 term is then K1's
// (int4: each group block writes its group's, and the last of the tile's
// group blocks sums them in order), and the epilogue writes it to terms,
// or its int32 sum (ws null), or the residual resid_of(rbase, term) (rout),
// or, for the gate-up product (pair = FF: 64 gate and the matching 64 up
// columns a tile), the SwiGLU act silu_of(gate, up) as silu_elem forms it.
template <int BT, bool I4>
__global__ void __launch_bounds__(BMMA_THREADS, 2) prod_batch(ProdArgs a) {
  constexpr int NT = BT / 8;       // n-tiles of 8 batch rows
  constexpr int LPR = I4 ? 4 : 8;  // 16-byte loads a lane makes per round
  constexpr int F = NT * 32;       // accumulator registers a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const RowIn& in = a.in;
  const int B = a.B, N = a.N, KC = a.KC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rounds = KC / BMMA_ROUND;
  const int rpw = (rounds + BMMA_WARPS - 1) / BMMA_WARPS;
  const int kcp = KC + CODES_PAD;
  const ProdLayout L = prod_layout(BT, B, I4, KC, rows_elems(in), w_floats(in));
  uint4* stage = reinterpret_cast<uint4*>(smem);
  int* part = reinterpret_cast<int*>(smem);   // after the last round
  int8_t* codes = reinterpret_cast<int8_t*>(smem + L.codes);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  float* wsm = reinterpret_cast<float*>(smem + L.w);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* rr = red + BT * 32;
  float* sxs = rr + BT;

  const int col = tile_col(a, 16 * g);   // this lane group's 16 columns
  const bool live = tile_live(a, 16 * g);
  const size_t r0 = (size_t)blockIdx.y * KC;
  // the warp's round s into ring slot s % BMMA_STAGES (this lane's own
  // bytes: only it reads them back), one commit group a round, empty ones
  // included, so that round s's group is complete once at most
  // BMMA_STAGES - 1 groups are pending
  auto issue = [&](int s) {
    const int r = warp + BMMA_WARPS * s;
    if (s < rpw && r < rounds && live) {
#pragma unroll
      for (int i = 0; i < LPR; ++i) {
        const int kq = t + 4 * (i / (LPR / 2));
        const size_t row = I4 ? (r0 + BMMA_ROUND * r) / 2 + 2 * kq + (i & 1)
                              : r0 + BMMA_ROUND * r + 4 * kq + (i & 3);
        __pipeline_memcpy_async(stage + ((s % BMMA_STAGES) * LPR + i) * BMMA_THREADS + tid,
                                a.wq + row * N + col, 16);
      }
    }
    __pipeline_commit();
  };
  pdl_trigger();
  for (int s = 0; s < BMMA_STAGES; ++s) issue(s);
  for (int c = tid; c < w_floats(in) / 4; c += BMMA_THREADS)   // the norm weight, constant
    __pipeline_memcpy_async(wsm + 4 * c, in.w + 4 * c, 16);
  pdl_wait();   // everything below may read what the kernel before this one wrote
  batch_codes<BT>(in, B, a.qs, (int)r0, KC, kcp, codes, xs, wsm, red, rr, sxs);

  int acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][j][c] = 0;
  const int* c32 = reinterpret_cast<const int*>(codes);
  for (int s = 0; s < rpw; ++s) {
    const int r = warp + BMMA_WARPS * s;
    if (r >= rounds) break;
    __pipeline_wait_prior(BMMA_STAGES - 1);
    const uint4* slot = stage + (s % BMMA_STAGES) * LPR * BMMA_THREADS + tid;
    uint32_t W[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (I4) {
        const uint4 A = slot[(2 * h) * BMMA_THREADS];
        const uint4 C = slot[(2 * h + 1) * BMMA_THREADS];
        const uint32_t wa[4] = {A.x, A.y, A.z, A.w}, wc[4] = {C.x, C.y, C.z, C.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)   // rows 4kq, 4kq+1 (wa lo, hi), 4kq+2, 4kq+3 (wc), x16
          transpose4((wa[k] << 4) & 0xf0f0f0f0u, wa[k] & 0xf0f0f0f0u,
                     (wc[k] << 4) & 0xf0f0f0f0u, wc[k] & 0xf0f0f0f0u, &W[h][4 * k]);
      } else {
        const uint4 A = slot[(4 * h) * BMMA_THREADS];
        const uint4 Bv = slot[(4 * h + 1) * BMMA_THREADS];
        const uint4 E = slot[(4 * h + 2) * BMMA_THREADS];
        const uint4 Fv = slot[(4 * h + 3) * BMMA_THREADS];
        transpose4(A.x, Bv.x, E.x, Fv.x, &W[h][0]);
        transpose4(A.y, Bv.y, E.y, Fv.y, &W[h][4]);
        transpose4(A.z, Bv.z, E.z, Fv.z, &W[h][8]);
        transpose4(A.w, Bv.w, E.w, Fv.w, &W[h][12]);
      }
    }
    issue(s + BMMA_STAGES);   // the slot's bytes are in registers now
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int* crow = c32 + ((g + 8 * nt) * kcp + BMMA_ROUND * r) / 4;
      const int b0 = crow[t], b1 = crow[t + 4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t wj[4] = {W[0][2 * j], W[0][2 * j + 1], W[1][2 * j], W[1][2 * j + 1]};
        mma_s8(acc[nt][j], wj, b0, b1);
      }
    }
  }
  __syncthreads();   // every warp is done with the ring, which part takes over
  if (warp < rounds) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[(warp * F + (nt * 8 + j) * 4 + c) * 33 + lane] = acc[nt][j][c];
  }
  __syncthreads();

  // the block's int32 sum of (batch row b, tile column nn): the fragment
  // (nt, j, c) and lane that hold it, over the warps that had rounds
  const int nw = rounds < BMMA_WARPS ? rounds : BMMA_WARPS;
  auto own_sum = [&](int b, int nn) {
    const int c = ((nn & 1) << 1) | (b & 1), f = ((b >> 3) * 8 + ((nn & 15) >> 1)) * 4 + c;
    const int ln = ((nn >> 4) << 2) | ((b & 7) >> 1);
    int tot = 0;
    for (int w = 0; w < nw; ++w) tot += part[(w * F + f) * 33 + ln];
    return tot;
  };
  const float* ws = a.ws;
  // a column's row work from its f32 term: the next residual row, or the term
  auto finish = [&](int b, int nn, float term) {
    const int n = tile_col(a, nn);
    if (a.rout) {
      const size_t i = (size_t)b * N + n;
      a.rout[i] = __float2bfloat16_rn(resid_of(bf2f(a.rbase[i]), term));
    } else {
      a.terms[b * a.ts + n] = term;
    }
  };
  if constexpr (I4) {
    for (int i = tid; i < B * BMMA_COLS; i += BMMA_THREADS) {
      const int b = i / BMMA_COLS, nn = i % BMMA_COLS;
      if (!tile_live(a, nn)) continue;
      const size_t gn = (size_t)blockIdx.y * N + tile_col(a, nn);
      a.terms[b * a.ts + gn] = (float)(own_sum(b, nn) >> 4) * (sxs[b] * ws[gn]);
    }
    if (!(a.pair || a.rout) || !i8_tile_done(a.tiles)) return;
    if (tid == 0) a.tiles[blockIdx.x] = 0;
    // the last group block of the tile: the groups' terms summed in order
    auto term = [&](int b, int nn) {
      const float* tr = a.terms + b * a.ts + tile_col(a, nn);
      float x = __ldcg(tr);
      for (int k = 1; k < (int)gridDim.y; ++k) x += __ldcg(tr + (size_t)k * N);
      return x;
    };
    if (a.pair) {
      for (int i = tid; i < B * 64; i += BMMA_THREADS) {
        const int b = i / 64, m = i % 64;
        if (tile_live(a, m))
          a.act[(size_t)b * a.pair + tile_col(a, m)] =
              __float2bfloat16_rn(silu_of(term(b, m), term(b, 64 + m)));
      }
      return;
    }
    for (int i = tid; i < B * BMMA_COLS; i += BMMA_THREADS) {
      const int b = i / BMMA_COLS, nn = i % BMMA_COLS;
      if (tile_live(a, nn)) finish(b, nn, term(b, nn));
    }
  } else {
    const bool split = gridDim.y > 1;
    if (split) {
      for (int i = tid; i < B * BMMA_COLS; i += BMMA_THREADS) {
        const int b = i / BMMA_COLS, nn = i % BMMA_COLS;
        if (tile_live(a, nn))
          a.ipart[((size_t)blockIdx.y * B + b) * N + tile_col(a, nn)] = own_sum(b, nn);
      }
      if (!i8_tile_done(a.tiles)) return;
      if (tid == 0) a.tiles[blockIdx.x] = 0;
    }
    // the tile's whole int32 sum: this block's, or the slices' (exact in any order)
    auto sum = [&](int b, int nn) {
      if (!split) return own_sum(b, nn);
      int tot = 0;
      for (int y = 0; y < (int)gridDim.y; ++y)
        tot += __ldcg(&a.ipart[((size_t)y * B + b) * N + tile_col(a, nn)]);
      return tot;
    };
    auto term = [&](int b, int nn) {
      return (float)sum(b, nn) * (sxs[b] * ws[tile_col(a, nn)]);
    };
    if (a.pair) {
      for (int i = tid; i < B * 64; i += BMMA_THREADS) {
        const int b = i / 64, m = i % 64;
        if (tile_live(a, m))
          a.act[(size_t)b * a.pair + tile_col(a, m)] =
              __float2bfloat16_rn(silu_of(term(b, m), term(b, 64 + m)));
      }
      return;
    }
    int* sums = reinterpret_cast<int*>(a.terms);
    for (int i = tid; i < B * BMMA_COLS; i += BMMA_THREADS) {
      const int b = i / BMMA_COLS, nn = i % BMMA_COLS;
      if (!tile_live(a, nn)) continue;
      if (ws) finish(b, nn, term(b, nn));
      else sums[b * a.ts + tile_col(a, nn)] = sum(b, nn);
    }
  }
}

// Rows per block (KC) of a product over n_in input rows and N columns with
// scale group G.
inline int prod_rows(const MegaDims& d, int n_in, int N, int G) {
  return d.wbits == 4 ? G : slice_rows(n_in, N);
}

// The step's products: input rows, output columns, scale group, and
// whether the input rows are normed (QKV and gate-up: a norm weight of
// n_in floats).
struct StepProds {
  int in[5], out[5], g[5], normed[5];
};

inline StepProds step_prods(const MegaDims& d) {
  const int DQ = d.NH * d.D;
  return {{d.H, DQ, d.H, d.FF, d.H},
          {DQ + 2 * d.NKV * d.D, d.H, 2 * d.FF, d.H, d.Vp},
          {d.g_qkv, d.g_wo, d.g_gu, d.g_wd, d.g_head},
          {1, 0, 1, 0, 0}};
}

// Dynamic shared memory of the step's largest product at B rows.
inline int batch_smem(const MegaDims& d, int B) {
  const int BT = B <= 8 ? 8 : 16;
  const StepProds P = step_prods(d);
  int most = 0;
  for (int i = 0; i < 5; ++i) {
    const int kc = prod_rows(d, P.in[i], P.out[i], P.g[i]);
    const int n = prod_layout(BT, B, d.wbits == 4, kc, i == 4 ? 0 : P.in[i],
                              P.normed[i] ? P.in[i] : 0).total;
    most = n > most ? n : most;
  }
  return most;
}

// The batched step's scratch beyond the Scratch layout: the SwiGLU act
// [B][FF] bf16, then the int8 slices' sums of the largest split product.
inline size_t act_bytes(const MegaDims& d, int B) {
  return align_up(2 * (size_t)B * d.FF);
}

inline size_t batch_extra_bytes(const MegaDims& d, int B) {
  const StepProds P = step_prods(d);
  size_t most = 0;
  for (int i = 0; i < 5 && d.wbits == 8; ++i) {
    const int kc = prod_rows(d, P.in[i], P.out[i], P.g[i]);
    const size_t n = 4 * (size_t)(P.in[i] / kc) * B * P.out[i];
    if (P.in[i] / kc > 1 && n > most) most = n;
  }
  return act_bytes(d, B) + align_up(most);
}

// The batched step's own conditions on top of step_ok: row widths in
// 32-element pieces (the prologue's copies and virtual warps), every
// product's rows per block in 32-row rounds, and shared memory.
inline bool batch_ok(const MegaDims& d, int B) {
  const int DQ = d.NH * d.D;
  if (d.H % 32 || DQ % 32 || d.FF % 32) return false;
  const StepProds P = step_prods(d);
  for (int i = 0; i < 5; ++i)
    if (prod_rows(d, P.in[i], P.out[i], P.g[i]) % BMMA_ROUND) return false;
  return batch_smem(d, B) <= BMMA_SMEM_MAX;
}

// Launch one product at batch tile BT (8 or 16) with `a` filled but for
// KC, with programmatic dependent launch (pdl: all but the step's first
// product, which follows the memset), as K1 launches its GEMVs: its blocks
// start under the predecessor's tail and have their first weight rounds in
// flight when pdl_wait returns. n_in: the product's input rows; G: int4's
// scale group.
template <int BT>
void launch_prod(ProdArgs a, bool i4, int n_in, int G, bool pdl, cudaStream_t st) {
  a.KC = i4 ? G : slice_rows(n_in, a.N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.pair ? (a.pair + 63) / 64 : (a.N + BMMA_COLS - 1) / BMMA_COLS,
                     n_in / a.KC);
  cfg.blockDim = dim3(BMMA_THREADS);
  cfg.dynamicSmemBytes =
      prod_layout(BT, a.B, i4, a.KC, rows_elems(a.in), w_floats(a.in)).total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  if (i4) cudaLaunchKernelEx(&cfg, prod_batch<BT, true>, a);
  else cudaLaunchKernelEx(&cfg, prod_batch<BT, false>, a);
}

// One decode step of B rows over a cache of element type CT: per layer the
// QKV product (f32 terms for attention; its input, the residual stream
// s.x, normed in its prologue; layer 0's the embedding rows, which block
// (0, 0) also writes to s.x), attn_step (K1's), the Wo product (h1 = x +
// bf16(wo) into s.h1), the gate-up product (its input h1 normed; the
// SwiGLU act out), the down product (x = h1 + bf16(wd) into s.x); then the
// final norm (h_out = x), the lm head's product and the argmax.
template <typename CT>
void batch_step(const MegaPtrs* p, const MegaDims& d, const int* pos_arr, int B,
                const Scratch& s, __nv_bfloat16* act, int* ipart, cudaStream_t st) {
  constexpr bool QUANT = scaled_cache<CT>();
  const int DQ = d.NH * d.D, DKV = d.NKV * d.D;
  const int SE = d.S / rows_per_elem<CT>();   // stored rows per layer
  const int nchunks = n_attn_chunks(d.pos);
  const size_t ts = terms_floats(d), qs = (size_t)widest_row(d);
  const size_t slab_kv = (size_t)d.L * SE * DKV, slab_s = (size_t)d.L * d.S * d.NKV;
  const size_t smem_attn = attn_smem<CT>(d);
  const bool i4 = d.wbits == 4;
  float* ta = s.terms[0];
  cudaMemsetAsync(s.iacc, 0, s.zero_bytes, st);

  // product (wq, ws) of layer l, n_in rows -> N columns, scale group G
  auto prod = [&](const void* wq, const void* ws, size_t l, int n_in, int N, int G,
                  const RowIn& in, bool pdl, int pair, const __nv_bfloat16* rbase,
                  __nv_bfloat16* rout) {
    ProdArgs a{};
    a.in = in;
    a.B = B;
    a.ts = ts;
    a.qs = qs;
    a.wq = (const uint8_t*)wq + l * (size_t)(i4 ? n_in / 2 : n_in) * N;
    // G = n_in for int8 weights, so the scale offset is l * N for both packs
    a.ws = (const float*)ws + l * (size_t)(n_in / G) * N;
    a.N = N;
    a.pair = pair;
    a.rbase = rbase;
    a.rout = rout;
    a.ipart = ipart;
    a.tiles = s.tiles;
    a.terms = ta;
    a.act = act;
    if (B <= 8) launch_prod<8>(a, i4, n_in, G, pdl, st);
    else launch_prod<16>(a, i4, n_in, G, pdl, st);
  };
  for (int l = 0; l < d.L; ++l) {
    RowIn in{};
    in.kind = ROW_NORM;
    in.N = d.H;
    in.w = (const float*)p->attn_norm + (size_t)l * d.H;
    in.eps = d.eps;
    if (l == 0) {
      in.base = (const __nv_bfloat16*)p->x_in;
      in.embd = (const __nv_bfloat16*)p->embd;
      in.token = (const int*)p->token_in;
      in.x_out = s.x;
    } else {
      in.base = s.x;
    }
    prod(p->qkv_q, p->qkv_s, l, d.H, DQ + 2 * DKV, d.g_qkv, in, l > 0, 0, nullptr, nullptr);
    CT* kl = (CT*)p->k_cache + (size_t)l * SE * DKV;
    CT* vl = (CT*)p->v_cache + (size_t)l * SE * DKV;
    float* ksl = QUANT ? (float*)p->k_scale + (size_t)l * d.S * d.NKV : nullptr;
    float* vsl = QUANT ? (float*)p->v_scale + (size_t)l * d.S * d.NKV : nullptr;
    attn_step<CT><<<dim3(d.NKV, nchunks, B), ATTN_THREADS, smem_attn, st>>>(
        ta, d.H / d.g_qkv, (const float*)p->q_norm + (size_t)l * d.D,
        (const float*)p->k_norm + (size_t)l * d.D, d, kl, vl, ksl, vsl, s.part, s.acnt,
        s.attn, pos_arr, ts, slab_kv, slab_s);
    in = RowIn{};
    in.kind = ROW_QUANT;
    in.N = DQ;
    in.base = s.attn;
    prod(p->wo_q, p->wo_s, l, DQ, d.H, d.g_wo, in, true, 0, s.x, s.h1);
    in = RowIn{};
    in.kind = ROW_NORM;
    in.N = d.H;
    in.base = s.h1;
    in.w = (const float*)p->ffn_norm + (size_t)l * d.H;
    in.eps = d.eps;
    prod(p->gu_q, p->gu_s, l, d.H, 2 * d.FF, d.g_gu, in, true, d.FF, nullptr, nullptr);
    in = RowIn{};
    in.kind = ROW_QUANT;
    in.N = d.FF;
    in.base = act;
    prod(p->wd_q, p->wd_s, l, d.FF, d.H, d.g_wd, in, true, 0, s.h1, s.x);
  }
  norm_quant<<<B, NORM_THREADS, 0, st>>>(s.x, nullptr, nullptr, nullptr, 0, d.H,
                                         (const float*)p->out_norm, d.eps, nullptr,
                                         (float*)p->h_out, s.xq, s.sx, ts, qs);
  RowIn in{};
  in.kind = ROW_CODES;
  in.xq = s.xq;
  in.sx = s.sx;
  prod(p->head_q, p->head_s, 0, d.H, d.Vp, d.g_head, in, true, 0, nullptr, nullptr);
  const int nb = n_argmax_blocks(d);
  argmax_partial<<<dim3(nb, B), ARGMAX_THREADS, 0, st>>>(ta, d.H / d.g_head, d.Vp, d.V,
                                                         s.pmax, s.pidx, ts);
  argmax_final<<<B, ARGMAX_THREADS, 0, st>>>(s.pmax, s.pidx, nb, (int*)p->token_out);
}

}  // namespace

extern "C" size_t qw_mega_batch_scratch_bytes(const MegaDims* d, int B) {
  Scratch s;
  return layout(*d, B, nullptr, &s) + batch_extra_bytes(*d, B);
}

// Sets the products' dynamic shared-memory limit (above the 48 KB default);
// called once when the library is loaded, never inside a captured step.
extern "C" int qw_mega_batch_init() {
  cudaFuncSetAttribute(prod_batch<8, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BMMA_SMEM_MAX);
  cudaFuncSetAttribute(prod_batch<16, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BMMA_SMEM_MAX);
  cudaFuncSetAttribute(prod_batch<8, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BMMA_SMEM_MAX);
  cudaFuncSetAttribute(prod_batch<16, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       BMMA_SMEM_MAX);
  return (int)cudaGetLastError();
}

// int32 scratch of qw_mega_batch_product_i8 at these sizes: the slices'
// sums and a counter a column tile, zero.
extern "C" size_t qw_mega_batch_product_scratch(int B, int K, int N) {
  const int kc = slice_rows(K, N);
  return (size_t)(K / kc > 1 ? K / kc : 0) * B * N + N / BMMA_COLS + 1;
}

// One int8 product alone on the tensor cores, as the step runs it on codes
// already made: out[b][n] = sum_k xq[b][k] * w[k][n] as int32, for B <= 16
// rows of codes xq [B][K] and an int8 weight w [K][N] (N a multiple of 64,
// K a multiple of 32, and of 256 above 1,024). scratch:
// qw_mega_batch_product_scratch(B, K, N) int32, zero (left zero). For the
// comparison with a library product.
extern "C" int qw_mega_batch_product_i8(const int8_t* xq, const int8_t* w, int* out,
                                        int* scratch, int B, int K, int N, void* stream) {
  const int kc = slice_rows(K, N);
  if (B < 1 || B > BMMA_MAX_ROWS || N % (BMMA_COLS / 2) || kc % BMMA_ROUND ||
      kc > BMMA_MAX_GROUP)
    return (int)cudaErrorInvalidValue;
  ProdArgs a{};
  a.in.kind = ROW_CODES;
  a.in.xq = xq;
  a.B = B;
  a.ts = N;
  a.qs = K;
  a.wq = (const uint8_t*)w;
  a.N = N;
  a.ipart = scratch;
  a.tiles = scratch + (K / kc > 1 ? (size_t)(K / kc) * B * N : 0);
  a.terms = reinterpret_cast<float*>(out);
  if (B <= 8) launch_prod<8>(a, false, K, 0, false, (cudaStream_t)stream);
  else launch_prod<16>(a, false, K, 0, false, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

namespace {

template <typename CT>
int run_batch(const MegaPtrs* p, const MegaDims* dp, const int* pos, int B, void* stream) {
  const MegaDims d = *dp;
  if (B < 1 || B > BMMA_MAX_ROWS || !pos) return (int)cudaErrorInvalidValue;
  if (!step_ok<CT>(d, BMMA_COLS / 2, BMMA_MAX_GROUP) || !batch_ok(d, B))
    return (int)cudaErrorInvalidValue;
  Scratch s;
  char* extra = (char*)p->scratch + layout(d, B, (char*)p->scratch, &s);
  batch_step<CT>(p, d, pos, B, s, reinterpret_cast<__nv_bfloat16*>(extra),
                 reinterpret_cast<int*>(extra + act_bytes(d, B)), (cudaStream_t)stream);
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
