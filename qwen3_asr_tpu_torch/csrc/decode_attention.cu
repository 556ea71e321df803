// Single-token decode attention for one layer, in one launch, with the fresh
// K/V row stored into the cache.
//
// Replaces: qwen3_asr_tpu/ops/decode_attention.py::_decode_attn_kernel (bf16
// cache) and ::_decode_attn_kernel_q (int8 cache with f32 scales per (row,
// head)), body `_decode_attn_body`. For one token: split the qkv row; per-head
// RMSNorm of q and k in f32; NEOX RoPE at `pos`; q times the softmax scale;
// GQA attention over the cache rows < offset plus the fresh K/V as one extra
// column in one softmax, all f32, the int8 cache dequantized as q * scale
// before the dot. Outputs attn [NH * D] f32 and the fresh (normed, roped) k
// and the raw v [NKV * D] f32. With `store` on, the same launch also writes
// that k and v into cache row `offset` in the cache's format (bf16 rounded to
// nearest even; int8 codes rint(x / s), clamped to +-127, with s = max(amax *
// f32(1 / 127), 1e-12) and an IEEE divide: models/decoder.py::_store's bits),
// as the JAX step's dynamic_update_slice does after the kernel.
//
// What bounds it on an H100: bytes, the live cache rows (bf16: 4 KB per row
// of K and V at 8 KV heads x 128; int8: 2 KB plus 64 B of scales), ~2 FLOP
// per byte: 5.1 MB at offset 1,248 on a bf16 cache, 1.5 us of HBM. At that
// size the call is latency: the launch, one HBM round trip and one meeting.
// The design, against each:
//  - One launch. Block (KV head, 64-row chunk, row) scores and sums its chunk
//    and writes the chunk's max, sum and weighted V; it then takes a ticket
//    (a global counter per (row, KV head) after __threadfence, as the decode
//    megakernel's attn_step does); the last of the row's chunk blocks to take
//    one merges the chunks with the fresh column and resets the counter to 0,
//    so a CUDA graph can replay the launch. offset 0 has no chunk: block 0
//    merges the fresh column alone.
//  - One HBM round trip. A block starts all its K and V loads (16-byte
//    pieces, into registers: each element is read once) before anything
//    else, then prepares q, k and v while they are in flight: one warp per
//    vector (norm, RoPE), no block barrier inside, every block running the
//    same code so every block's q has the same bits.
//  - Parallel inner loops. Scores: four threads a row, each a quarter of the
//    pieces, met in two shuffles. Weighted V: each thread one piece of a few
//    rows, the row groups met in shared memory in row-group order. int8
//    codes become f32 by a byte permute and a subtract (full FP32 rate).
//    The merge: the chunks' maxima and sums read once, their weights
//    exp(m_c - M) computed once per (chunk, q head), then one thread per
//    output element over the chunks. 80 registers a thread keep three
//    blocks on an SM, which the batched grid needs more than the merge
//    needs a deeper prefetch (both measured on an H100).
// Row order: row b's outputs and the cache row it writes depend on row b's
// qkv, slab, offset and pos only. A row's cache rows are split into 64-row
// chunks by the row index alone, every sum inside a chunk has one order, and
// the merge walks the chunks in chunk order, whatever block merges, whatever
// B or the grid's bound is, and whichever block finishes first. Nothing in
// the launch reads cache row `offset`: every block reads rows < offset, and
// only head kvh's merge block writes head kvh's part of that row.
//
// Batched mode (the reference runs the Pallas kernel under jax.vmap in its
// per-layer batched decode): the grid's third dimension takes B rows, each
// with its own qkv row, cache slab [S, NKV, D] and offset / pos, read from the
// device as int32 [B]. Slab b starts `slab` (row, head) pairs after slab b -
// 1 (S * NKV for slabs side by side; L * S * NKV for layer l of a cache
// [B, L, S, NKV * D], the batched decode's layout). The grid is sized by the
// host's bound of the offsets (any bound >= max offset: S works, so a graph
// can replay it at later positions); chunks at or past a row's own offset
// exit at once. So row b computes exactly what the one-row launch computes
// on slab b: the one-row entry is the B = 1 case of the same kernel with host
// scalars. A row whose offset is S (possible only with a bound of S) stores
// nothing: the slab has no row S.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int DA_THREADS = 256;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_ROWS = 64;                    // cache rows per chunk block
constexpr int DA_TPR = DA_THREADS / DA_ROWS;   // threads per row in the scores
constexpr int DA_MAX_CHUNKS = 1024;            // the merge's m, l, w fit `red`
constexpr int DA_MIN_BLOCKS = 3;               // blocks an SM holds (a register cap)

struct DaArgs {
  const void* qkv;     // [B][(NH + 2 NKV) * D] bf16 (qkv_bf16) or f32
  void* kc;            // [B][S, NKV, D] bf16 or int8
  void* vc;
  float* ks;           // [B][S, NKV] f32 (int8 cache), or null (bf16 cache)
  float* vs;
  const void* qn;      // [D] q_norm, bf16 (norm_bf16) or f32
  const void* kn;      // [D] k_norm
  float* part;         // [B][NKV][nchunks][GROUP][D + 2]
  int* cnt;            // [B][NKV] tickets, zero between launches
  float* attn;         // [B][NH * D]
  float* k_new;        // [B][NKV * D]
  float* v_new;
  const int* offs;     // [B] on the device, or null: `offset` for the one row
  const int* poss;     // [B] on the device, or null: `pos`
  size_t slab;         // (row, head) pairs from one row's slab to the next
  int qkv_bf16, norm_bf16, store;
  int NH, NKV, S, offset, pos, nchunks;  // nchunks: the grid's chunks per row
  float eps, rope_coef, scale;
};

// A 16-byte piece of a cache row: EPP elements (8 bf16 or 16 int8).
template <typename CT, int D>
struct Shape {
  static constexpr int EPP = 16 / (int)sizeof(CT);
  static constexpr int P = D / EPP;                      // pieces per row
  static constexpr int KP = (P + DA_TPR - 1) / DA_TPR;   // K pieces a thread
  static constexpr int RG = DA_THREADS / P;              // V row groups
  static constexpr int VR = (DA_ROWS + RG - 1) / RG;     // V rows a thread
  static_assert(P >= 1 && DA_THREADS % P == 0, "D: 16 .. 256, a power of two");
  static_assert(RG * D >= 2 * DA_MAX_CHUNKS, "the merge's m and l fit red");
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// int8 codes as f32 at the full FP32 rate (an I2F is a quarter): the code
// biased to an unsigned byte b, placed in the mantissa of 2^23 (2^23 + b is
// exact), minus 2^23 + 128.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                         u.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    f[k] = __uint_as_float(__byte_perm(w[k / 4], 0x4B00u, 0x5440u | (k % 4))) - 8388736.f;
}

__device__ __forceinline__ float ld(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? bf2f(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// vec[j][D] for j < GROUP + 2: the GROUP q heads of KV head kvh of row b
// (normed, roped at pos, times scale), then its k (normed, roped) and its raw
// v. One warp a vector, lane l holding elements l + 32 i, its row and norm
// weights loaded at once; no block barrier: the caller syncs.
template <int D>
__device__ void prep(const DaArgs& a, int b, int pos, int kvh, float* vec) {
  constexpr int PER_LANE = (D + 31) / 32, half = D / 2;
  const int GROUP = a.NH / a.NKV;
  const size_t qkv0 = (size_t)b * (a.NH + 2 * a.NKV) * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < GROUP + 2; j += DA_WARPS) {
    const int row = j < GROUP ? kvh * GROUP + j : (j == GROUP ? a.NH : a.NH + a.NKV) + kvh;
    const void* w = j < GROUP ? a.qn : a.kn;
    float* x = vec + j * D;
    float xv[PER_LANE], wv[PER_LANE], ss = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + 32 * i;
      xv[i] = wv[i] = 0.f;
      if (e < D) {
        xv[i] = ld(a.qkv, qkv0 + (size_t)row * D + e, a.qkv_bf16);
        if (j <= GROUP) wv[i] = ld(w, e, a.norm_bf16);
        ss += xv[i] * xv[i];
      }
    }
    if (j > GROUP) {   // v is not normed
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (lane + 32 * i < D) x[lane + 32 * i] = xv[i];
      continue;
    }
    ss = warp_sum(ss);
    const float r = rsqrtf(ss / (float)D + a.eps);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (lane + 32 * i < D) x[lane + 32 * i] = xv[i] * r * wv[i];
    __syncwarp();
    for (int e = lane; e < half; e += 32) {
      const float ang = (float)pos * expf((float)e * a.rope_coef);
      float s, c;
      sincosf(ang, &s, &c);
      const float x1 = x[e], x2 = x[e + half];
      float y1 = x1 * c - x2 * s, y2 = x2 * c + x1 * s;
      if (j < GROUP) {
        y1 *= a.scale;
        y2 *= a.scale;
      }
      x[e] = y1;
      x[e + half] = y2;
    }
    __syncwarp();
  }
}

// Dynamic shared memory in floats: vec[GROUP + 2][D], sc[GROUP][DA_ROWS],
// ml[4][GROUP] (chunk max and sum; the merge's fresh weight and
// denominator), red[RG][GROUP][D] (the V partials by row group; the merge's
// chunk maxima and weights w[nch][GROUP] and sums l[nch][GROUP], which fit:
// RG * D = 256 * EPP >= 2 * DA_MAX_CHUNKS).
template <typename CT, int D>
size_t smem_bytes(int GROUP) {
  return sizeof(float) * ((size_t)(GROUP + 2) * D + (size_t)GROUP * DA_ROWS + 4 * GROUP +
                          (size_t)Shape<CT, D>::RG * GROUP * D);
}

// Block (kvh, chunk c, row b). See the note at the top.
template <typename CT, int D>
__global__ void __launch_bounds__(DA_THREADS, DA_MIN_BLOCKS) dattn_step(DaArgs a) {
  using Sh = Shape<CT, D>;
  constexpr bool QUANT = std::is_same<CT, int8_t>::value;
  constexpr int EPP = Sh::EPP;
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  const int GROUP = a.NH / a.NKV, NKV = a.NKV;
  const int kvh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int offset = a.offs ? a.offs[b] : a.offset;
  const int nch = (offset + DA_ROWS - 1) / DA_ROWS;   // this row's chunks
  if (nch > a.nchunks) __trap();   // an offset past the host's bound: no merge
  if (c >= max(nch, 1)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* vec = sm;
  float* sc = vec + (GROUP + 2) * D;
  float* ml = sc + GROUP * DA_ROWS;
  float* red = ml + 4 * GROUP;
  const size_t slab = (size_t)b * a.slab;
  const CT* kc = static_cast<const CT*>(a.kc);
  const CT* vc = static_cast<const CT*>(a.vc);

  // the chunk's K and V pieces, all in flight before anything else
  const int r0 = c * DA_ROWS, nr = min(DA_ROWS, offset - r0);
  const int rk = tid / DA_TPR, pk = tid % DA_TPR;   // scores: row, quarter
  const int pv = tid % Sh::P, rg = tid / Sh::P;     // weighted V: piece, row group
  const bool krow = rk < nr;
  uint4 kr[Sh::KP], vr[Sh::VR];
  float ksr = 1.f, vsr[Sh::VR];
#pragma unroll
  for (int i = 0; i < Sh::KP; ++i) kr[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < Sh::VR; ++k) {
    vr[k] = make_uint4(0, 0, 0, 0);
    vsr[k] = 1.f;
  }
  if (krow) {
    const size_t kh = slab + (size_t)(r0 + rk) * NKV + kvh;
    const uint4* src = reinterpret_cast<const uint4*>(kc + kh * D);
#pragma unroll
    for (int i = 0; i < Sh::KP; ++i)
      if (pk + DA_TPR * i < Sh::P) kr[i] = __ldg(src + pk + DA_TPR * i);
    if (QUANT) ksr = __ldg(a.ks + kh);
  }
#pragma unroll
  for (int k = 0; k < Sh::VR; ++k) {
    const int r = rg + Sh::RG * k;
    if (r < nr) {
      const size_t vh = slab + (size_t)(r0 + r) * NKV + kvh;
      vr[k] = __ldg(reinterpret_cast<const uint4*>(vc + vh * D) + pv);
      if (QUANT) vsr[k] = __ldg(a.vs + vh);
    }
  }
  prep<D>(a, b, a.poss ? a.poss[b] : a.pos, kvh, vec);
  __syncthreads();

  if (nch > 0) {
    // scores: thread (rk, pk) sums its pieces for each q head (an int8 code
    // times its row's scale, then the dot), the row's DA_TPR threads meet in
    // shuffles
    for (int j = 0; j < GROUP; ++j) {
      const float* qj = vec + j * D;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < Sh::KP; ++i) {
        const int pc = pk + DA_TPR * i;
        if (krow && pc < Sh::P) {
          float f[EPP];
          unpack(kr[i], f);
#pragma unroll
          for (int e = 0; e < EPP; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qj + pc * EPP + e);
            s = fmaf(q4.x, QUANT ? f[e] * ksr : f[e], s);
            s = fmaf(q4.y, QUANT ? f[e + 1] * ksr : f[e + 1], s);
            s = fmaf(q4.z, QUANT ? f[e + 2] * ksr : f[e + 2], s);
            s = fmaf(q4.w, QUANT ? f[e + 3] * ksr : f[e + 3], s);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < DA_TPR; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (pk == 0 && krow) sc[j * DA_ROWS + rk] = s;
    }
    __syncthreads();

    // the chunk's max and sum per q head; scores become exp(s - m)
    for (int j = warp; j < GROUP; j += DA_WARPS) {
      float* pj = sc + j * DA_ROWS;
      float mx = QW_NEG;
      for (int r = lane; r < nr; r += 32) mx = fmaxf(mx, pj[r]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int r = lane; r < nr; r += 32) {
        const float e = expf(pj[r] - mx);
        sum += e;
        pj[r] = e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        ml[j] = mx;
        ml[GROUP + j] = sum;
      }
    }
    __syncthreads();

    // weighted V: thread (pv, rg) over rows rg, rg + RG, ...; row groups
    // met in shared memory in row-group order
    for (int j = 0; j < GROUP; ++j) {
      const float* pj = sc + j * DA_ROWS;
      float o[EPP];
#pragma unroll
      for (int e = 0; e < EPP; ++e) o[e] = 0.f;
#pragma unroll
      for (int k = 0; k < Sh::VR; ++k) {
        const int r = rg + Sh::RG * k;
        if (r < nr) {
          float f[EPP];
          unpack(vr[k], f);
          const float p = pj[r];
#pragma unroll
          for (int e = 0; e < EPP; ++e) o[e] = fmaf(p, QUANT ? f[e] * vsr[k] : f[e], o[e]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(red + ((size_t)rg * GROUP + j) * D + pv * EPP);
#pragma unroll
      for (int e = 0; e < EPP; e += 4)
        dst[e / 4] = make_float4(o[e], o[e + 1], o[e + 2], o[e + 3]);
    }
    __syncthreads();
    float* out = a.part + (((size_t)b * NKV + kvh) * a.nchunks + c) * GROUP * (D + 2);
    for (int i = tid; i < GROUP * D; i += DA_THREADS) {
      float o = red[i];
#pragma unroll 4
      for (int g = 1; g < Sh::RG; ++g) o += red[(size_t)g * GROUP * D + i];
      out[(i / D) * (D + 2) + 2 + i % D] = o;
    }
    if (tid < GROUP) {
      out[tid * (D + 2)] = ml[tid];
      out[tid * (D + 2) + 1] = ml[GROUP + tid];
    }

    // the ticket: the last of the row's chunk blocks for this head merges
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* n = a.cnt + (size_t)b * NKV + kvh;
      last = atomicAdd(n, 1) == nch - 1;
      if (last) *n = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  }

  // the merge: the fresh column's score, the row's max M over it and the
  // chunks' maxima, the chunks' weights exp(m_c - M) and the denominator,
  // all in chunk order
  const float* pkc = a.part + ((size_t)b * NKV + kvh) * a.nchunks * GROUP * (D + 2);
  const size_t cstep = (size_t)GROUP * (D + 2);
  const float* kf = vec + GROUP * D;
  const float* vf = kf + D;
  float* w = red;                             // [nch][GROUP]: m_c, then exp(m_c - M)
  float* lc = red + DA_MAX_CHUNKS * GROUP;    // [nch][GROUP]: l_c
  for (int j = warp; j < GROUP; j += DA_WARPS) {
    float sf = 0.f;
    for (int e = lane; e < D; e += 32) sf = fmaf(vec[j * D + e], kf[e], sf);
    sf = warp_sum(sf);
    float mx = sf;
    for (int cc = lane; cc < nch; cc += 32) {   // one read of the partials' m and l
      const float* pc = pkc + cc * cstep + j * (D + 2);
      const float m = __ldcg(pc);
      w[cc * GROUP + j] = m;
      lc[cc * GROUP + j] = __ldcg(pc + 1);
      mx = fmaxf(mx, m);
    }
    mx = warp_max(mx);
    float den = 0.f;
    for (int cc = lane; cc < nch; cc += 32) {
      const float wc = expf(w[cc * GROUP + j] - mx);
      w[cc * GROUP + j] = wc;
      den = fmaf(lc[cc * GROUP + j], wc, den);
    }
    den = warp_sum(den);
    const float pf = expf(sf - mx);
    if (lane == 0) {
      ml[2 * GROUP + j] = pf;
      ml[3 * GROUP + j] = den + pf;
    }
  }
  __syncthreads();

  float* attn = a.attn + (size_t)b * a.NH * D + (size_t)kvh * GROUP * D;
  for (int i = tid; i < GROUP * D; i += DA_THREADS) {
    const int j = i / D, e = i % D;
    const float* src = pkc + (size_t)j * (D + 2) + 2 + e;
    float o = 0.f;
#pragma unroll 8
    for (int n = 0; n < nch; ++n) {
      const int cc = n;   // chunk order
      o = fmaf(__ldcg(src + cc * cstep), w[cc * GROUP + j], o);
    }
    attn[i] = (o + ml[2 * GROUP + j] * vf[e]) / ml[3 * GROUP + j];
  }
  for (int e = tid; e < D; e += DA_THREADS) {
    a.k_new[(size_t)b * NKV * D + kvh * D + e] = kf[e];
    a.v_new[(size_t)b * NKV * D + kvh * D + e] = vf[e];
  }

  // the store: warp 0 the K row, warp 1 the V row, at cache row `offset`
  if (a.store && offset < a.S && warp < 2) {
    const float* x = warp == 0 ? kf : vf;
    const size_t h = slab + (size_t)offset * NKV + kvh;
    CT* dst = static_cast<CT*>(warp == 0 ? a.kc : a.vc) + h * D;
    if constexpr (QUANT) {
      float amax = 0.f;
      for (int e = lane; e < D; e += 32) amax = fmaxf(amax, fabsf(x[e]));
      amax = warp_max(amax);
      const float s = fmaxf(amax * (1.f / 127.f), 1e-12f);
      for (int e = lane; e < D; e += 32)
        dst[e] = (int8_t)fminf(fmaxf(rintf(x[e] / s), -127.f), 127.f);
      if (lane == 0) (warp == 0 ? a.ks : a.vs)[h] = s;
    } else {
      for (int e = lane; e < D; e += 32) dst[e] = __float2bfloat16_rn(x[e]);
    }
  }
}

template <typename CT, int D>
int launch_t(const DaArgs& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes<CT, D>(a.NH / a.NKV);
  dattn_step<CT, D><<<dim3(a.NKV, max(a.nchunks, 1), B), DA_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_d(const DaArgs& a, int D, int B, cudaStream_t st) {
  switch (D) {
    case 16: return launch_t<CT, 16>(a, B, st);
    case 32: return launch_t<CT, 32>(a, B, st);
    case 64: return launch_t<CT, 64>(a, B, st);
    case 128: return launch_t<CT, 128>(a, B, st);
    case 256: return launch_t<CT, 256>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The one launch of a call: B rows, nchunks chunk blocks per row and head.
int launch(const DaArgs& a, int D, int B, bool quant, cudaStream_t st) {
  if (a.nchunks > DA_MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  return quant ? launch_d<int8_t>(a, D, B, st) : launch_d<__nv_bfloat16>(a, D, B, st);
}

bool dims_ok(int NH, int NKV, int D) {
  return NKV > 0 && NH % NKV == 0 && (D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}

// The dynamic shared memory an instantiation may take: the opt-in limit less
// its static shared memory.
template <typename CT, int D>
int set_smem(int bytes) {
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, dattn_step<CT, D>);
  if (!rc)
    rc = (int)cudaFuncSetAttribute(dattn_step<CT, D>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes - (int)fa.sharedSizeBytes);
  return rc;
}

template <typename CT>
int set_smem_all(int bytes) {
  int rc = set_smem<CT, 16>(bytes);
  if (!rc) rc = set_smem<CT, 32>(bytes);
  if (!rc) rc = set_smem<CT, 64>(bytes);
  if (!rc) rc = set_smem<CT, 128>(bytes);
  if (!rc) rc = set_smem<CT, 256>(bytes);
  return rc;
}

}  // namespace

// Run once at load (never inside a capture): lets every instantiation take up
// to the device's opt-in shared memory (a wide GQA group needs > 48 KB).
extern "C" int qw_decode_attention_init() {
  int dev = 0, bytes = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!rc) rc = set_smem_all<__nv_bfloat16>(bytes);
  if (!rc) rc = set_smem_all<int8_t>(bytes);
  return rc;
}

// Floats of partial-result scratch the entry points need for B rows whose
// offsets are at most `offset`.
extern "C" size_t qw_decode_attention_scratch(int NH, int NKV, int D, int offset, int B) {
  return (size_t)B * NKV * ((offset + DA_ROWS - 1) / DA_ROWS) * (NH / NKV) * (D + 2);
}

// One layer's single-token attention for one row, offset and pos host ints.
// ks / vs null: the cache is bf16; else int8 with f32 scales [S, NKV]. cnt:
// NKV int32 tickets, zero (and left zero). store: also write the fresh k / v
// into cache row offset (< S). Returns a cudaError_t code.
extern "C" int qw_decode_attention(const void* qkv, int qkv_bf16, void* kc, void* vc,
                                   void* ks, void* vs, const void* qn, const void* kn,
                                   int norm_bf16, void* part, void* cnt, void* attn,
                                   void* k_new, void* v_new, int S, int offset, int pos,
                                   int NH, int NKV, int D, float eps, float rope_coef,
                                   float scale, int store, void* stream) {
  const bool quant = ks != nullptr;
  if (!dims_ok(NH, NKV, D) || offset < 0 || offset > S || (store && offset == S) || !cnt ||
      (quant != (vs != nullptr)))
    return (int)cudaErrorInvalidValue;
  DaArgs a{qkv, kc, vc, (float*)ks, (float*)vs, qn, kn, (float*)part, (int*)cnt,
           (float*)attn, (float*)k_new, (float*)v_new, nullptr, nullptr,
           (size_t)S * NKV, qkv_bf16, norm_bf16, store ? 1 : 0, NH, NKV, S, offset, pos,
           (offset + DA_ROWS - 1) / DA_ROWS, eps, rope_coef, scale};
  return launch(a, D, 1, quant, (cudaStream_t)stream);
}

// The same attention for B rows: qkv [B][(NH + 2 NKV) D], caches of B slabs
// [S, NKV, D] `slab` (row, head) pairs apart (scales [S, NKV] at the same
// stride), outputs [B][...]; offs / poss int32 [B] on the device, every
// offset in [0, bound] with bound <= S (the host's bound sizes the grid);
// cnt: B * NKV int32 tickets, zero (and left zero). Nothing is read back to
// the host. Returns a cudaError_t code.
extern "C" int qw_decode_attention_batch(const void* qkv, int qkv_bf16, void* kc, void* vc,
                                         void* ks, void* vs, const void* qn, const void* kn,
                                         int norm_bf16, void* part, void* cnt, void* attn,
                                         void* k_new, void* v_new, const int* offs,
                                         const int* poss, int B, int S, long long slab,
                                         int bound, int NH, int NKV, int D, float eps,
                                         float rope_coef, float scale, int store,
                                         void* stream) {
  const bool quant = ks != nullptr;
  if (!dims_ok(NH, NKV, D) || B < 1 || B > 65535 || !offs || !poss || !cnt || bound < 0 ||
      bound > S || slab < (long long)S * NKV || (quant != (vs != nullptr)))
    return (int)cudaErrorInvalidValue;
  DaArgs a{qkv, kc, vc, (float*)ks, (float*)vs, qn, kn, (float*)part, (int*)cnt,
           (float*)attn, (float*)k_new, (float*)v_new, offs, poss, (size_t)slab,
           qkv_bf16, norm_bf16, store ? 1 : 0, NH, NKV, S, 0, 0,
           (bound + DA_ROWS - 1) / DA_ROWS, eps, rope_coef, scale};
  return launch(a, D, B, quant, (cudaStream_t)stream);
}
