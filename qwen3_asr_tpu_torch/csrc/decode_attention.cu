// Single-token decode attention for one layer.
//
// Replaces: qwen3_asr_tpu/ops/decode_attention.py::_decode_attn_kernel (bf16
// cache) and ::_decode_attn_kernel_q (int8 cache with f32 scales per (row,
// head)), body `_decode_attn_body`. For one token: split the qkv row; per-head
// RMSNorm of q and k in f32; NEOX RoPE at `pos`; q times the softmax scale;
// GQA attention over the cache rows < offset plus the fresh K/V as one extra
// column in one softmax, all f32. Outputs attn [NH * D] f32 and the fresh
// (normed, roped) k and the raw v [NKV * D] f32; the caller stores them in the
// cache's format.
//
// What bounds it on an H100: bytes, the live cache rows (bf16: 4 KB per row
// of K and V at 8 KV heads x 128; int8: 2 KB plus 64 B of scales), ~2 FLOP
// per byte. The TPU body is one program looping over the KV heads and
// reading all S rows under a mask; on the card that would be 8 blocks for
// 132 SMs. So the work is split as in the decode megakernel's attention
// (csrc/megakernel.cuh): `dattn_partial` blocks (KV head, 64-row chunk) read
// only rows < offset, stage the chunk's K and V rows in shared memory with
// cp.async, and write the chunk's max, sum and weighted V; one `dattn_combine`
// block per KV head merges the chunks with the fresh column, which takes part
// in the max and the sum exactly as at decode_attention.py:103-112. offset 0
// launches no partial block. Numerics: the cache dequantizes as q * scale in
// f32 before the dot, as the Pallas body does; only f32 summation orders
// differ.
//
// Batched mode (the reference runs the Pallas kernel under jax.vmap in its
// per-layer batched decode): a third grid dimension takes B rows, each with
// its own qkv row, cache slab [S, NKV, D] and offset / pos, read from the
// device as int32 [B]. Slab b starts `slab` (row, head) pairs after slab b -
// 1 (S * NKV for slabs side by side; L * S * NKV for layer l of a cache
// [B, L, S, NKV * D], the batched decode's layout). The grid is sized by the
// host's bound of the offsets (any bound >= max offset: S works, so a graph
// can replay it at later positions); chunks at or past a row's own offset
// exit at once, as the decode megakernel's attn_step does, and a row's
// combine walks only its own chunks. So row b computes exactly what the
// one-row launch computes on slab b: the one-row entry is the B = 1 case of
// the same kernels with host scalars.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int DA_THREADS = 256;
constexpr int DA_ROWS = 64;  // cache rows per partial block

struct DaArgs {
  const void* qkv;     // [B][(NH + 2 NKV) * D] bf16 (qkv_bf16) or f32
  const void* kc;      // [B][S, NKV, D] bf16 or int8
  const void* vc;
  const float* ks;     // [B][S, NKV] f32 (int8 cache), or null (bf16 cache)
  const float* vs;
  const void* qn;      // [D] q_norm, bf16 (norm_bf16) or f32
  const void* kn;      // [D] k_norm
  float* part;         // [B][NKV][nchunks][GROUP][D + 2]
  float* attn;         // [B][NH * D]
  float* k_new;        // [B][NKV * D]
  float* v_new;
  const int* offs;     // [B] on the device, or null: `offset` for the one row
  const int* poss;     // [B] on the device, or null: `pos`
  size_t slab;         // (row, head) pairs from one row's slab to the next
  int qkv_bf16, norm_bf16;
  int NH, NKV, D, S, offset, pos, nchunks;  // nchunks: the grid's chunks per row
  float eps, rope_coef, scale;
};

__device__ __forceinline__ float ld(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? bf2f(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ int row_offset(const DaArgs& a, int b) {
  return a.offs ? a.offs[b] : a.offset;
}

__device__ __forceinline__ int row_pos(const DaArgs& a, int b) {
  return a.poss ? a.poss[b] : a.pos;
}

// vec[j][D] for j < nvec: the GROUP q heads of KV head kvh of row b (normed,
// roped at pos, times scale), then (nvec = GROUP + 2) its k (normed, roped)
// and v.
__device__ void prep(const DaArgs& a, int b, int pos, int kvh, int nvec, float* vec) {
  const int D = a.D, GROUP = a.NH / a.NKV;
  const size_t qkv0 = (size_t)b * (a.NH + 2 * a.NKV) * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < nvec * D; i += blockDim.x) {
    const int j = i / D, e = i % D;
    int row;
    if (j < GROUP) row = kvh * GROUP + j;
    else if (j == GROUP) row = a.NH + kvh;
    else row = a.NH + a.NKV + kvh;
    vec[i] = ld(a.qkv, qkv0 + row * D + e, a.qkv_bf16);
  }
  __syncthreads();
  const int n_norm = min(nvec, GROUP + 1);  // q heads and k; v is not normed
  for (int j = warp; j < n_norm; j += nwarps) {
    float* x = vec + j * D;
    const void* w = j < GROUP ? a.qn : a.kn;
    float s = 0.f;
    for (int e = lane; e < D; e += 32) s += x[e] * x[e];
    s = warp_sum(s);
    const float r = rsqrtf(s / (float)D + a.eps);
    __syncwarp();
    for (int e = lane; e < D; e += 32) x[e] = x[e] * r * ld(w, e, a.norm_bf16);
  }
  __syncthreads();
  const int half = D / 2;
  for (int i = tid; i < n_norm * half; i += blockDim.x) {
    const int j = i / half, e = i % half;
    float* x = vec + j * D;
    const float ang = (float)pos * expf((float)e * a.rope_coef);
    const float c = cosf(ang), s = sinf(ang);
    const float x1 = x[e], x2 = x[e + half];
    float y1 = x1 * c - x2 * s, y2 = x2 * c + x1 * s;
    if (j < GROUP) {
      y1 *= a.scale;
      y2 *= a.scale;
    }
    x[e] = y1;
    x[e + half] = y2;
  }
  __syncthreads();
}

// Block (kvh, chunk c, row b). Dynamic shared memory: K and V rows
// [2][DA_ROWS][D] of the cache type, then floats q[GROUP][D], p[GROUP][DA_ROWS],
// ml[2 GROUP], kss[DA_ROWS], vss[DA_ROWS].
template <typename CT>
__global__ void __launch_bounds__(DA_THREADS) dattn_partial(DaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, NKV = a.NKV, GROUP = a.NH / NKV;
  const int kvh = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int offset = row_offset(a, b);
  const int r0 = c * DA_ROWS;
  if (r0 >= offset) return;   // past this row's live rows (uniform per block)
  const int nr = min(DA_ROWS, offset - r0);
  const size_t slab = a.slab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  CT* kv = reinterpret_cast<CT*>(smem_raw);
  float* q = reinterpret_cast<float*>(smem_raw + 2 * DA_ROWS * D * sizeof(CT));
  float* p = q + GROUP * D;
  float* ml = p + GROUP * DA_ROWS;
  float* kss = ml + 2 * GROUP;
  float* vss = kss + DA_ROWS;

  const int pieces = D * (int)sizeof(CT) / 16;  // 16-byte pieces per row
  for (int i = tid; i < 2 * nr * pieces; i += blockDim.x) {
    const int which = i / (nr * pieces), rem = i % (nr * pieces);
    const int r = rem / pieces, piece = rem % pieces;
    const CT* src = reinterpret_cast<const CT*>(which ? a.vc : a.kc) +
                    (b * slab + (size_t)(r0 + r) * NKV + kvh) * D;
    __pipeline_memcpy_async(reinterpret_cast<unsigned char*>(kv + (which * DA_ROWS + r) * D) +
                                piece * 16,
                            reinterpret_cast<const unsigned char*>(src) + piece * 16, 16);
  }
  __pipeline_commit();
  for (int r = tid; r < nr; r += blockDim.x) {
    kss[r] = a.ks ? a.ks[b * slab + (size_t)(r0 + r) * NKV + kvh] : 1.f;
    vss[r] = a.vs ? a.vs[b * slab + (size_t)(r0 + r) * NKV + kvh] : 1.f;
  }
  prep(a, b, row_pos(a, b), kvh, GROUP, q);
  __pipeline_wait_prior(0);
  __syncthreads();
  const CT* krows = kv;
  const CT* vrows = kv + DA_ROWS * D;
  const bool quant = a.ks != nullptr;

  // scores: one warp per row, the row dequantized per element as the
  // reference does (k * scale, then the dot)
  for (int r = warp; r < nr; r += nwarps) {
    const CT* kr = krows + r * D;
    for (int j = 0; j < GROUP; ++j) {
      const float* qj = q + j * D;
      float s = 0.f;
      for (int e = lane; e < D; e += 32) {
        const float kf = quant ? to_f(kr[e]) * kss[r] : to_f(kr[e]);
        s = fmaf(qj[e], kf, s);
      }
      s = warp_sum(s);
      if (lane == 0) p[j * DA_ROWS + r] = s;
    }
  }
  __syncthreads();

  for (int j = warp; j < GROUP; j += nwarps) {
    float* pj = p + j * DA_ROWS;
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

  float* out = a.part + (((size_t)b * NKV + kvh) * a.nchunks + c) * GROUP * (D + 2);
  for (int pr = tid; pr < GROUP * D; pr += blockDim.x) {
    const int j = pr / D, e = pr % D;
    const float* pj = p + j * DA_ROWS;
    float o = 0.f;
    for (int r = 0; r < nr; ++r) {
      const float vf = quant ? to_f(vrows[r * D + e]) * vss[r] : to_f(vrows[r * D + e]);
      o = fmaf(pj[r], vf, o);
    }
    out[j * (D + 2) + 2 + e] = o;
  }
  if (tid < GROUP) {
    out[tid * (D + 2)] = ml[tid];
    out[tid * (D + 2) + 1] = ml[GROUP + tid];
  }
}

// Block (kvh, row b). Dynamic shared memory: vec[(GROUP + 2) * D],
// misc[3 * GROUP].
__global__ void __launch_bounds__(DA_THREADS) dattn_combine(DaArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, NKV = a.NKV, GROUP = a.NH / NKV;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* vec = smem;
  float* misc = vec + (GROUP + 2) * D;  // p_fresh[GROUP], m[GROUP], den[GROUP]
  prep(a, b, row_pos(a, b), kvh, GROUP + 2, vec);
  const float* kf = vec + GROUP * D;
  const float* vf = kf + D;
  const float* pk = a.part + ((size_t)b * NKV + kvh) * a.nchunks * GROUP * (D + 2);
  const int nch = (row_offset(a, b) + DA_ROWS - 1) / DA_ROWS;   // this row's chunks

  for (int j = warp; j < GROUP; j += nwarps) {
    float sf = 0.f;
    for (int e = lane; e < D; e += 32) sf = fmaf(vec[j * D + e], kf[e], sf);
    sf = warp_sum(sf);
    float mx = sf;
    for (int c = lane; c < nch; c += 32) mx = fmaxf(mx, pk[((size_t)c * GROUP + j) * (D + 2)]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int c = lane; c < nch; c += 32) {
      const float* pc = pk + ((size_t)c * GROUP + j) * (D + 2);
      den += pc[1] * expf(pc[0] - mx);
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
    const float mx = misc[GROUP + j];
    float o = 0.f;
    for (int c = 0; c < nch; ++c) {
      const float* pc = pk + ((size_t)c * GROUP + j) * (D + 2);
      o = fmaf(pc[2 + e], expf(pc[0] - mx), o);
    }
    a.attn[(size_t)b * a.NH * D + (kvh * GROUP + j) * D + e] =
        (o + misc[j] * vf[e]) / misc[2 * GROUP + j];
  }
  for (int e = tid; e < D; e += blockDim.x) {
    a.k_new[(size_t)b * NKV * D + kvh * D + e] = kf[e];
    a.v_new[(size_t)b * NKV * D + kvh * D + e] = vf[e];
  }
}

size_t partial_smem(int D, int GROUP, size_t elt) {
  return 2 * (size_t)DA_ROWS * D * elt +
         sizeof(float) * ((size_t)GROUP * (D + DA_ROWS + 2) + 2 * DA_ROWS);
}

// The launches of one call: B rows, nchunks chunk blocks per row and head.
int launch(const DaArgs& a, int B, bool quant, cudaStream_t st) {
  const int GROUP = a.NH / a.NKV;
  const size_t smem_p = partial_smem(a.D, GROUP, quant ? 1 : 2);
  const size_t smem_c = sizeof(float) * ((size_t)(GROUP + 2) * a.D + 3 * GROUP);
  if (smem_p > 48 * 1024 || smem_c > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (a.nchunks > 0) {
    const dim3 grid(a.NKV, a.nchunks, B);
    if (quant)
      dattn_partial<int8_t><<<grid, DA_THREADS, smem_p, st>>>(a);
    else
      dattn_partial<__nv_bfloat16><<<grid, DA_THREADS, smem_p, st>>>(a);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  dattn_combine<<<dim3(a.NKV, B), DA_THREADS, smem_c, st>>>(a);
  return (int)cudaGetLastError();
}

bool dims_ok(int NH, int NKV, int D) {
  return NKV > 0 && NH % NKV == 0 && D % 16 == 0 && D <= 256;
}

}  // namespace

// Floats of partial-result scratch the entry points need for B rows whose
// offsets are at most `offset`.
extern "C" size_t qw_decode_attention_scratch(int NH, int NKV, int D, int offset, int B) {
  return (size_t)B * NKV * ((offset + DA_ROWS - 1) / DA_ROWS) * (NH / NKV) * (D + 2);
}

// One layer's single-token attention for one row, offset and pos host ints.
// ks / vs null: the cache is bf16; else int8 with f32 scales [S, NKV].
// Returns a cudaError_t code.
extern "C" int qw_decode_attention(const void* qkv, int qkv_bf16, const void* kc,
                                   const void* vc, const void* ks, const void* vs,
                                   const void* qn, const void* kn, int norm_bf16,
                                   void* part, void* attn, void* k_new, void* v_new,
                                   int S, int offset, int pos, int NH, int NKV, int D,
                                   float eps, float rope_coef, float scale, void* stream) {
  const bool quant = ks != nullptr;
  if (!dims_ok(NH, NKV, D) || offset < 0 || offset > S || (quant != (vs != nullptr)))
    return (int)cudaErrorInvalidValue;
  DaArgs a{qkv, kc, vc, (const float*)ks, (const float*)vs, qn, kn, (float*)part,
           (float*)attn, (float*)k_new, (float*)v_new, nullptr, nullptr,
           (size_t)S * NKV, qkv_bf16, norm_bf16, NH, NKV, D, S, offset, pos, (offset + DA_ROWS - 1) / DA_ROWS,
           eps, rope_coef, scale};
  return launch(a, 1, quant, (cudaStream_t)stream);
}

// The same attention for B rows: qkv [B][(NH + 2 NKV) D], caches of B slabs
// [S, NKV, D] `slab` (row, head) pairs apart (scales [S, NKV] at the same
// stride), outputs [B][...]; offs / poss int32 [B] on the device, every
// offset in [0, bound] with bound <= S (the host's bound sizes the grid).
// Nothing is read back to the host. Returns a cudaError_t code.
extern "C" int qw_decode_attention_batch(const void* qkv, int qkv_bf16, const void* kc,
                                         const void* vc, const void* ks, const void* vs,
                                         const void* qn, const void* kn, int norm_bf16,
                                         void* part, void* attn, void* k_new, void* v_new,
                                         const int* offs, const int* poss, int B, int S,
                                         long long slab, int bound, int NH, int NKV, int D,
                                         float eps, float rope_coef, float scale,
                                         void* stream) {
  const bool quant = ks != nullptr;
  if (!dims_ok(NH, NKV, D) || B < 1 || B > 65535 || !offs || !poss || bound < 0 ||
      bound > S || slab < (long long)S * NKV || (quant != (vs != nullptr)))
    return (int)cudaErrorInvalidValue;
  DaArgs a{qkv, kc, vc, (const float*)ks, (const float*)vs, qn, kn, (float*)part,
           (float*)attn, (float*)k_new, (float*)v_new, offs, poss, (size_t)slab,
           qkv_bf16, norm_bf16,
           NH, NKV, D, S, 0, 0, (bound + DA_ROWS - 1) / DA_ROWS, eps, rope_coef, scale};
  return launch(a, B, quant, (cudaStream_t)stream);
}
