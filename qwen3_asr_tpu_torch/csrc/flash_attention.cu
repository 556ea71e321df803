// Flash attention (streaming softmax) for the decoder prefill and the
// encoder, on Hopper's tensor cores.
//
// Replaces: qwen3_asr_tpu/ops/pallas_attention.py::_flash_kernel (entries
// flash_attention_batch / flash_attention). Same contract: q [B,T,NH,D],
// k/v [B,S,NKV,D] bf16, GQA by h / (NH/NKV), a valid key length per item,
// causal or bidirectional, f32 scores / running max / running sum /
// accumulator, masked scores set to QW_NEG, output acc / max(l, 1e-30) in
// bf16. The K loop stops at min(ceil(valid/BN), last causal row/BN + 1), so
// tiles past the valid length or the causal diagonal are never read.
//
// What bounds it on an H100: operations. At the decoder's prefill shape
// (causal T = 1,280, 16 heads, D = 128) one call needs ~6.7 GFLOP of dot
// products against ~16 MB of bf16 q/k/v/out, far above the ~295 FLOP a byte
// at which an H100 SXM's bf16 tensor cores (989 TFLOP/s) outrun its memory
// (3.35 TB/s; NVIDIA's data sheet), so the design feeds the tensor cores:
// - Both products are mma.sync.m16n8k16 bf16 instructions with f32
//   accumulators: S = Q K^T from Q fragments held in registers and K
//   fragments read with ldmatrix, O += P V with V fragments read with
//   ldmatrix.trans.
// - K and V stay bf16 in shared memory in 64-key tiles, brought in by
//   cp.async into a two-stage ring: the next tile loads while this one
//   multiplies. Rows are XOR-swizzled by 16-byte chunk (chunk ^ row % 8) so
//   the eight row addresses of an ldmatrix hit eight different banks.
// - GQA is packed into the tile's rows: a block takes 64 "m-rows", m =
//   t * G + j for the G = NH / NKV q heads j of one KV head, so the q heads
//   of a group share every K / V tile a block loads.
// - The softmax lives in registers (each thread holds two rows' slices; a
//   row's max and sum are reduced across the four threads of a quad) and
//   runs in base 2: the scores take one f32 multiply by scale * log2(e), so
//   Q K^T sees the bf16 inputs unrounded, and exp2f replaces expf.
// - P enters the tensor cores as bf16, split into a high and a low part (p
//   = hi + lo, both bf16, PV = hi V + lo V): one bf16 rounding of p (2^-9
//   relative) moves an output of a few keys by up to ~4e-3 at |v| ~ 2,
//   more than the 1e-3 absolute tolerance the kernel is held to; the split
//   leaves ~2^-17 at the cost of a second PV product.
// - Only tiles that reach past the valid length or the first row's causal
//   limit apply a mask; the others skip the compare.
// - Causal blocks run in reverse row order (the longest rows start first),
//   so the last wave is short.
#include "common.cuh"

namespace {

constexpr int BM = 64;          // m-rows (q row x group head) per block
constexpr int BN = 64;          // keys per K / V tile
constexpr int NWARPS = 4;       // 16 m-rows per warp
constexpr int THREADS = 32 * NWARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {
  return (BM + 4 * BN) * D * 2;  // Q, then K and V in two stages each
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c[4] += a[4] (16x16 bf16, row) * b[2] (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element offset of (row, col) in a swizzled [rows][D] bf16 tile: 16-byte
// chunk c of row r is stored at chunk c ^ (r & 7).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 3) ^ r) & 7) | ((c >> 3) & ~7)) * 8 + (c & 7);
}

// The rows [0, n) of a tile from `rows(r)` (a global pointer, or null for a
// zero row: then `any`, a valid global address, is named and nothing read)
// into swizzled shared memory.
template <int D, typename RowPtr>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int n, RowPtr rows,
                                          const __nv_bfloat16* any) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const __nv_bfloat16* src = rows(r);
    cp16(smem_u32(dst + swz<D>(r, c * 8)), src ? src + c * 8 : any, src ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
    __nv_bfloat16* __restrict__ out, int T, int S, int NH, int NKV, int causal,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BM * D;   // [2][BN][D]
  __nv_bfloat16* vs = ks + 2 * BN * D;

  const int G = NH / NKV;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = tile * BM;
  const int M = T * G;  // m-rows of this (item, KV head)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int n_valid = min(valid[b], S);

  const int t_lo = m0 / G, t_hi = min((m0 + BM - 1) / G, T - 1);
  const int n_keys = causal ? min(n_valid, t_hi + 1) : n_valid;
  const int n_tiles = (n_keys + BN - 1) / BN;
  // keys below this need no mask in any row of the block
  const int clean = causal ? min(n_valid, t_lo + 1) : n_valid;

  const size_t kv_row = (size_t)NKV * D;  // elements between neighbouring keys
  const __nv_bfloat16* kb = k + ((size_t)b * S * NKV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * NKV + kvh) * D;
  auto q_row = [&](int m) -> const __nv_bfloat16* {
    const int mm = m0 + m;
    if (mm >= M) return nullptr;
    return q + (((size_t)b * T + mm / G) * NH + kvh * G + mm % G) * D;
  };
  auto kv_tile = [&](int kt, int stage) {
    const int k0 = kt * BN;
    load_tile<D>(ks + stage * BN * D, BN, [&](int r) -> const __nv_bfloat16* {
      return k0 + r < S ? kb + (size_t)(k0 + r) * kv_row : nullptr;
    }, kb);
    load_tile<D>(vs + stage * BN * D, BN, [&](int r) -> const __nv_bfloat16* {
      return k0 + r < S ? vb + (size_t)(k0 + r) * kv_row : nullptr;
    }, vb);
  };

  load_tile<D>(qs, BM, q_row, q);
  if (n_tiles > 0) kv_tile(0, 0);
  cp_commit();

  // this thread's two m-rows (g and g + 8 of the warp's 16) and their q rows
  const int mr0 = m0 + warp * 16 + g;
  const int tr[2] = {mr0 / G, (mr0 + 8) / G};
  const float sl2 = scale * LOG2E;

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mx[2] = {QW_NEG, QW_NEG}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) kv_tile(kt + 1, (kt + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = warp * 16 + (lane & 15), c = kk * 16 + (lane >> 4) * 8;
        ldsm_x4(smem_u32(qs + swz<D>(r, c)), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      }
    }
    const __nv_bfloat16* kst = ks + (kt & 1) * BN * D;
    const __nv_bfloat16* vst = vs + (kt & 1) * BN * D;

    // S = Q K^T: 16 m-rows x 64 keys per warp
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kst + swz<D>(r, c)), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qf[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // scale into base 2, mask where this tile needs it, online softmax
    const int k0 = kt * BN;
    const bool masked = k0 + BN > clean;
    float tmax[2] = {QW_NEG, QW_NEG};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (masked) {
          const int col = k0 + n * 8 + 2 * tig + (e & 1);
          const bool ok = col < n_valid && (!causal || col <= tr[e >> 1]);
          x = ok ? x : QW_NEG;
        }
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(mx[i], tmax[i]);
      alpha[i] = exp2f(mx[i] - m_new);
      mx[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P as bf16 high + low parts, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[2 * kk][e] - mx[e >> 1]);
        p[4 + e] = exp2f(s[2 * kk + 1][e] - mx[e >> 1]);
        l[e >> 1] += p[e] + p[4 + e];
      }
      uint32_t hi[4], lo[4];
      // A fragment: a0 (row g, keys 2tig..), a1 (row g+8), a2 (row g, keys 8+2tig..), a3
      const int order[4][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x0 = p[order[a][0]], x1 = p[order[a][1]];
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        hi[a] = *reinterpret_cast<const uint32_t*>(&h);
        const float2 hf = __bfloat1622float2(h);
        lo[a] = pack_bf16(x0 - hf.x, x1 - hf.y);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = dp * 16 + (lane >> 4) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(vst + swz<D>(r, c)), b0, b1, b2, b3);
        mma_bf16(o[2 * dp], hi, b0, b1);
        mma_bf16(o[2 * dp], lo, b0, b1);
        mma_bf16(o[2 * dp + 1], hi, b2, b3);
        mma_bf16(o[2 * dp + 1], lo, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_wait<0>();  // no copy outlives the block (n_tiles = 0 leaves Q's in flight)

  // the row sums over the quad, then out = o / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mm = mr0 + 8 * i;
    if (mm >= M) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* op = out + (((size_t)b * T + mm / G) * NH + kvh * G + mm % G) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8 + 2 * tig) =
          __floats2bfloat162_rn(o[n][2 * i] / den, o[n][2 * i + 1] / den);
    }
  }
}

}  // namespace

// Sets the kernels' dynamic shared-memory limit (above the 48 KB default);
// called once when the library is loaded, never inside a captured step.
extern "C" int qw_flash_init() {
  cudaFuncSetAttribute(flash_fwd<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes<128>());
  cudaFuncSetAttribute(flash_fwd<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes<64>());
  return (int)cudaGetLastError();
}

// q [B,T,NH,D], k/v [B,S,NKV,D] bf16 contiguous; valid [B] int32 on the
// device; out [B,T,NH,D] bf16. Returns a cudaError_t code.
extern "C" int qw_flash_attention(const void* q, const void* k, const void* v,
                                  const void* valid, void* out, int B, int T,
                                  int S, int NH, int NKV, int D, int causal,
                                  float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || NKV <= 0 || NH % NKV) return (int)cudaErrorInvalidValue;
  const dim3 grid((T * (NH / NKV) + BM - 1) / BM, NKV, B);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)q;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)k;
  const __nv_bfloat16* vb = (const __nv_bfloat16*)v;
  __nv_bfloat16* ob = (__nv_bfloat16*)out;
  if (D == 128) {
    flash_fwd<128><<<grid, THREADS, smem_bytes<128>(), st>>>(
        qb, kb, vb, (const int*)valid, ob, T, S, NH, NKV, causal, scale);
  } else if (D == 64) {
    flash_fwd<64><<<grid, THREADS, smem_bytes<64>(), st>>>(
        qb, kb, vb, (const int*)valid, ob, T, S, NH, NKV, causal, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
