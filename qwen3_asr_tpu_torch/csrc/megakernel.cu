// One greedy decode step of the Qwen3 decoder: int4 or int8 weights, an
// int8, bf16 or int4 KV cache.
//
// Replaces: qwen3_asr_tpu/ops/megakernel.py::_mega_kernel on either pack,
// int4 weights (the `int4=True` pack) or int8 weights (the default pack),
// with an int8 KV cache (entry mega_decode_step_i8), a bf16 one (entry
// mega_decode_step) or a nibble-packed int4 one (entry mega_decode_step_i4,
// `kv_i4=True`), in its resident mode and its streamed-KV one (`kv_stream`,
// an online softmax over 256-row tiles, which only a VMEM budget needs:
// here one attention path reads any S). It computes what the Pallas body computes
// (megakernel.py:669-1058): per layer RMSNorm, per-row int8 activation
// quantization, the QKV product (int4: per-(512-row group, column) scales,
// groups summed in f32; int8: one int32 dot over the whole input dim, then
// one scale per column, megakernel.py:728-738), QK-RMSNorm, NEOX RoPE at
// `pos`, GQA attention over the cache rows < pos plus the fresh K/V column,
// the in-place write of the fresh K/V row at row `pos` (int8 codes and their
// scales, bf16 rounded to nearest even, or int4 codes and their scales
// merged into the row's nibble of its byte row, which the reference leaves
// to XLA outside the kernel, megakernel.py:1420-1440), the output
// projection, the residual, the SwiGLU MLP; then the final norm, the lm head
// over the padded vocab (padding masked) and the first-index argmax.
//
// What bounds it on an H100: bytes. A step streams ~0.30 GB of int4 weights
// and scales (0.60 GB as int8) plus the live cache (int8: 2 KB of K/V and
// 64 B of scales per layer per row, ~70 MB at pos 1200; bf16: 4 KB, ~140 MB)
// and does ~1-2 operations per weight byte, so the floor is ~100 us (int4,
// int4 cache: 1 KB of K/V per layer per row) to ~220 us (int8, bf16 cache)
// at 3.35 TB/s. The TPU kernel was one launch because its per-op dispatch
// gaps starved HBM; on the H100 the step is a fixed sequence of five kernels
// per layer (144 a step at 28 layers) behind the one C entry point below:
// the QKV GEMV, attention, then the Wo, gate-up and down GEMVs, and after
// the layers the final norm, the lm head and a two-pass argmax. The
// position is read on the device, so the caller captures the whole step
// once in a CUDA graph and replays it, which takes the host's launches off
// the critical path. The design attacks bytes and
// parallelism: weights stay nibble-packed in device memory and are
// expanded in registers (no dequantized copy); each GEMV makes its own
// input codes (RMSNorm + residual, or the SwiGLU, and the int8
// quantization) in a prologue that every block runs on the row in L2,
// instead of a single-block kernel of its own, so a layer's row work costs
// no launch and no SM sits alone; the GEMV splits work over (64-column
// tile, 512-row group) so even the narrow wo / wd products fill the SMs,
// reads them as 16-byte vectors with a round of loads in flight before the
// prologue, and may start under its predecessor's tail (programmatic
// dependent launch); attention splits the cache rows < pos into 64-row
// chunks (one block per KV head and chunk, its K/V rows copied to shared
// memory with cp.async; the chunk that finishes last merges them) so the
// cache read is spread over the SMs; an int4 chunk stages its 64 rows as 32
// byte rows and sign-extends the nibbles where the scores and the V sum
// read them.
//
// Numerics follow the Pallas body exactly where it is exact: int32 group
// dots, f32 `part * (sx * s_g)` terms summed over groups in order, bf16
// roundings at the same places, quantization with round-half-even
// (rintf) and IEEE division. Only reduction orders of f32 sums (RMS, softmax)
// differ.
//
// The int8 GEMV splits the input dim into 512-row slices across blocks, as
// the int4 one splits it by scale group, so the narrow wo / wd products still
// fill the SMs; the slices' int32 sums meet in device memory through atomics
// (exact in any order) and the last block of a column tile scales them
// (megakernel.cuh, i8_tile_done). It reads a row quad of 16 columns as four
// 16-byte vectors, transposes the bytes into 4-row words and feeds dp4a.
//
// This file holds K1's GEMVs and its C entry points; the other kernels and
// the launch sequence live in megakernel.cuh, shared with the batched step
// (megakernel_batch.cu), which launches them with one block row per sequence.
#include "megakernel.cuh"

namespace {

constexpr int GEMV_COLS = 64;      // output columns per GEMV block
constexpr int GEMV_THREADS = 256;  // 4 threads x 16 columns, 64 row slices
constexpr int GEMV_SLICES = GEMV_THREADS / (GEMV_COLS / 16);
constexpr int GEMV_MAX_GROUP = 1024;
static_assert(GEMV_THREADS == PRO_THREADS, "row_codes plays norm_quant's threads");

// A GEMV block's shared memory: the input prologue's row as f32 and its
// reduction buffer (row_codes), then, in the same bytes, the row slices'
// column sums; the block's codes apart, read in between.
struct GemvSmem {
  union {
    struct {
      float ys[NORM_MAX];
      float red[32];
    } pro;
    int part[GEMV_SLICES][GEMV_COLS + 1];  // +1: fewer bank conflicts
  } u;
  __align__(16) int8_t codes[GEMV_MAX_GROUP];
};

// -- int4 GEMV with fused group scales ---------------------------------------
//
// Block (x, g): columns [64x, 64x+64) of group g. terms[g, n] =
// f32(sum_{r in group g} xq[r] * w4[r, n]) * (sx * s[g, n]), xq the codes of
// `in` (row_codes). Weight bytes [in/2, N]: row 2r is the low nibble of byte
// row r, row 2r+1 the high one. Each thread reads 16-byte vectors = 16
// neighbouring columns of one row pair, from G/128 row pairs (4 at G = 512):
// the first round's loads are issued before the prologue (and, launched
// with programmatic dependent launch, before the wait for the predecessor),
// so the weights stream while the codes are made; 64 row slices are then
// summed per column in shared memory.
__global__ void __launch_bounds__(GEMV_THREADS) gemv_i4(
    RowIn in, const uint8_t* __restrict__ wq, const float* __restrict__ ws, int G, int N,
    float* __restrict__ terms) {
  constexpr int RPR = 4;  // row pairs a thread loads per round
  __shared__ GemvSmem sm;
  pdl_trigger();
  const int g = blockIdx.y;
  const int seg = threadIdx.x % (GEMV_COLS / 16);
  const int slice = threadIdx.x / (GEMV_COLS / 16);
  const int col0 = blockIdx.x * GEMV_COLS + seg * 16;
  const uint8_t* wg = wq + (size_t)g * (G / 2) * N + col0;
  const int npairs = G / 2;
  const int rounds = (npairs + RPR * GEMV_SLICES - 1) / (RPR * GEMV_SLICES);
  int acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0;
  float sx = 0.f;
  for (int rd = 0; rd < rounds; ++rd) {
    uint4 v[RPR];
#pragma unroll
    for (int i = 0; i < RPR; ++i) {
      const int rp = (rd * RPR + i) * GEMV_SLICES + slice;
      if (rp < npairs) v[i] = *reinterpret_cast<const uint4*>(wg + (size_t)rp * N);
    }
    if (rd == 0) {
      pdl_wait();
      sx = row_codes(in, g * G, G, sm.codes, sm.u.pro.ys, sm.u.pro.red);
    }
#pragma unroll
    for (int i = 0; i < RPR; ++i) {
      const int rp = (rd * RPR + i) * GEMV_SLICES + slice;
      if (rp >= npairs) continue;
      const int x0 = sm.codes[2 * rp], x1 = sm.codes[2 * rp + 1];
      const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t b = (words[w] >> (8 * k)) & 0xffu;
          const int lo = ((int)(int8_t)(uint8_t)((b << 4) & 0xf0u)) >> 4;
          const int hi = ((int)(int8_t)(uint8_t)(b & 0xf0u)) >> 4;
          acc[4 * w + k] += x0 * lo + x1 * hi;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 16; ++c) sm.u.part[slice][seg * 16 + c] = acc[c];
  __syncthreads();
  if (threadIdx.x < GEMV_COLS) {
    int tot = 0;
    for (int s = 0; s < GEMV_SLICES; ++s) tot += sm.u.part[s][threadIdx.x];
    const int n = blockIdx.x * GEMV_COLS + threadIdx.x;
    terms[(size_t)g * N + n] = (float)tot * (sx * ws[(size_t)g * N + n]);
  }
}

// -- int8 GEMV, one scale per column ------------------------------------------
//
// Block (x, c): columns [64x, 64x+64) of input rows [c KC, c KC + KC) of an
// [in, N] int8 weight. Thread t takes 16 columns (t % 4) and the row quads
// q = t / 4, t / 4 + 64, ...: four 16-byte loads (rows 4q .. 4q+3), a byte
// transpose into one 4-row word per column, and a dp4a with the quad's four
// activation codes (row_codes of `in`; the first round's loads are in flight
// meanwhile, as in gemv_i4). The block's int32 column sums are exact; with
// one block row (KC = in) it writes terms[n] = f32(sum) * (sx * s[n])
// itself, else the sums meet in iacc and the tile's last block writes terms
// (i8_tile_done).
__global__ void __launch_bounds__(GEMV_THREADS) gemv_i8(
    RowIn in, const int8_t* __restrict__ wq, const float* __restrict__ ws, int KC, int N,
    int* __restrict__ iacc, int* __restrict__ tiles, float* __restrict__ terms) {
  constexpr int QPR = 2;  // row quads a thread loads per round
  __shared__ GemvSmem sm;
  pdl_trigger();
  const int c = blockIdx.y;
  const int seg = threadIdx.x % (GEMV_COLS / 16);
  const int slice = threadIdx.x / (GEMV_COLS / 16);
  const int col0 = blockIdx.x * GEMV_COLS + seg * 16;
  const int nq = KC / 4;
  const int rounds = (nq + QPR * GEMV_SLICES - 1) / (QPR * GEMV_SLICES);
  const int8_t* wc = wq + (size_t)c * KC * N + col0;
  const int* xs = reinterpret_cast<const int*>(sm.codes);
  int acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0;
  float sx = 0.f;
  for (int rd = 0; rd < rounds; ++rd) {
    uint4 r[QPR][4];
#pragma unroll
    for (int i = 0; i < QPR; ++i) {
      const int q = (rd * QPR + i) * GEMV_SLICES + slice;
      if (q >= nq) continue;
      const int8_t* w = wc + (size_t)(4 * q) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = *reinterpret_cast<const uint4*>(w + j * (size_t)N);
    }
    if (rd == 0) {
      pdl_wait();
      sx = row_codes(in, c * KC, KC, sm.codes, sm.u.pro.ys, sm.u.pro.red);
    }
#pragma unroll
    for (int i = 0; i < QPR; ++i) {
      const int q = (rd * QPR + i) * GEMV_SLICES + slice;
      if (q >= nq) continue;
      const uint32_t a[4] = {r[i][0].x, r[i][0].y, r[i][0].z, r[i][0].w};
      const uint32_t b[4] = {r[i][1].x, r[i][1].y, r[i][1].z, r[i][1].w};
      const uint32_t e[4] = {r[i][2].x, r[i][2].y, r[i][2].z, r[i][2].w};
      const uint32_t f[4] = {r[i][3].x, r[i][3].y, r[i][3].z, r[i][3].w};
      const int xw = xs[q];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // word k holds columns 4k .. 4k+3 of each row; regroup by column
        const uint32_t t0 = __byte_perm(a[k], b[k], 0x5140), t1 = __byte_perm(a[k], b[k], 0x7362);
        const uint32_t t2 = __byte_perm(e[k], f[k], 0x5140), t3 = __byte_perm(e[k], f[k], 0x7362);
        acc[4 * k] = __dp4a((int)__byte_perm(t0, t2, 0x5410), xw, acc[4 * k]);
        acc[4 * k + 1] = __dp4a((int)__byte_perm(t0, t2, 0x7632), xw, acc[4 * k + 1]);
        acc[4 * k + 2] = __dp4a((int)__byte_perm(t1, t3, 0x5410), xw, acc[4 * k + 2]);
        acc[4 * k + 3] = __dp4a((int)__byte_perm(t1, t3, 0x7632), xw, acc[4 * k + 3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) sm.u.part[slice][seg * 16 + k] = acc[k];
  __syncthreads();
  const int n = blockIdx.x * GEMV_COLS + threadIdx.x;
  int tot = 0;
  if (threadIdx.x < GEMV_COLS)
    for (int sl = 0; sl < GEMV_SLICES; ++sl) tot += sm.u.part[sl][threadIdx.x];
  if (gridDim.y == 1) {
    if (threadIdx.x < GEMV_COLS) terms[n] = (float)tot * (sx * ws[n]);
    return;
  }
  if (threadIdx.x < GEMV_COLS) atomicAdd(&iacc[n], tot);
  if (i8_tile_done(tiles)) {
    if (threadIdx.x < GEMV_COLS) terms[n] = (float)atomicExch(&iacc[n], 0) * (sx * ws[n]);
    if (threadIdx.x == 0) tiles[blockIdx.x] = 0;
  }
}

// Launch kernel<<<grid, GEMV_THREADS>>>(args...) on st, with programmatic
// dependent launch when pdl is set: the GEMV may start while its
// predecessor drains and waits for it in pdl_wait, after its first weight
// loads are issued. The edge survives CUDA-graph capture.
template <typename... Params, typename... Args>
void launch_gemv(void (*kernel)(Params...), dim3 grid, cudaStream_t st, bool pdl,
                 Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace

// K1's int8 GEMV for the MoE decode step (moe.cu), which launches it between
// its own kernels (the lm head): the product of the input row `row_in` (a
// RowIn) with wq int8 [n_in, N] and its column scales ws [N] into terms
// [N], over the step's iacc / tiles scratch, as run_step launches it for
// the int8 pack (without programmatic dependent launch).
extern "C" int qw_k1_gemv_i8(const void* row_in, const void* wq, const void* ws, int n_in,
                             int N, void* iacc, void* tiles, void* terms, void* stream) {
  const int kc = split_rows(n_in);
  launch_gemv(gemv_i8, dim3(N / GEMV_COLS, n_in / kc), (cudaStream_t)stream, false,
              *(const RowIn*)row_in, (const int8_t*)wq, (const float*)ws, kc, N, (int*)iacc,
              (int*)tiles, (float*)terms);
  return 0;
}

extern "C" size_t qw_mega_scratch_bytes(const MegaDims* d) {
  Scratch s;
  return layout(*d, 1, nullptr, &s);
}

namespace {

// One decode step over a cache of element type CT: decode_step's sequence
// with one GEMV launch per product (each making its own input codes).
template <typename CT>
int run_step(const MegaPtrs* p, const MegaDims* dp, const int* pos, void* stream) {
  const MegaDims d = *dp;
  cudaStream_t st = (cudaStream_t)stream;
  if (!pos || !step_ok<CT>(d, GEMV_COLS, GEMV_MAX_GROUP)) return (int)cudaErrorInvalidValue;
  Scratch s;
  layout(d, 1, (char*)p->scratch, &s);
  auto gemv = [&](const void* wq, const void* ws, size_t l, int n_in, int N, int G,
                  const RowIn& in, float* terms, bool first) {
    // G = n_in for int8 weights, so the scale offset is l * N for both packs
    const float* sc = (const float*)ws + l * (size_t)(n_in / G) * N;
    const bool pdl = d.pdl && !first;   // the first GEMV follows the memset
    if (d.wbits == 8) {
      const int kc = split_rows(n_in);
      launch_gemv(gemv_i8, dim3(N / GEMV_COLS, n_in / kc), st, pdl, in,
                  (const int8_t*)wq + l * (size_t)n_in * N, sc, kc, N, s.iacc, s.tiles, terms);
    } else {
      launch_gemv(gemv_i4, dim3(N / GEMV_COLS, n_in / G), st, pdl, in,
                  (const uint8_t*)wq + l * (size_t)(n_in / 2) * N, sc, G, N, terms);
    }
  };
  decode_step<CT>(p, d, pos, 1, s, st, gemv);
  return (int)cudaGetLastError();
}

}  // namespace

// One decode step over an int8 KV cache (k_scale / v_scale set), on either
// pack, at the position pos[0] (int32 on the device, in [1, S)); dp->pos is
// S - 1 or any bound >= pos[0]. Everything runs on `stream`; nothing is
// allocated and the host is never waited on or read from the device, so the
// call can be captured in a CUDA graph and replayed at other positions.
// Returns a cudaError_t code.
extern "C" int qw_mega_decode_step_i8(const MegaPtrs* p, const MegaDims* dp, const int* pos,
                                      void* stream) {
  return run_step<int8_t>(p, dp, pos, stream);
}

// The same step over a bf16 KV cache (no scales).
extern "C" int qw_mega_decode_step(const MegaPtrs* p, const MegaDims* dp, const int* pos,
                                   void* stream) {
  return run_step<__nv_bfloat16>(p, dp, pos, stream);
}

// The same step over a nibble-packed int4 KV cache ([L, S/2, DKV] bytes, S
// even) with f32 scales [L, S, NKV], on either pack.
extern "C" int qw_mega_decode_step_i4(const MegaPtrs* p, const MegaDims* dp, const int* pos,
                                      void* stream) {
  return run_step<nib2>(p, dp, pos, stream);
}
