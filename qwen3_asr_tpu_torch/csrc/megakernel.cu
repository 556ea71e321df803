// One greedy decode step of the Qwen3 decoder: int4 weights, int8 KV cache.
//
// Replaces: qwen3_asr_tpu/ops/megakernel.py::_mega_kernel in its int4-weight
// / int8-KV / resident mode (entry mega_decode_step_i8). It computes what the
// Pallas body computes (megakernel.py:669-1058): per layer RMSNorm, per-row
// int8 activation quantization, the int4 QKV product with per-(512-row group,
// column) scales, QK-RMSNorm, NEOX RoPE at `pos`, GQA attention over the
// int8 cache rows < pos plus the fresh K/V column, the in-place write of the
// fresh int8 K/V row and its scales at row `pos`, the output projection, the
// residual, the SwiGLU MLP; then the final norm, the int4 lm head over the
// padded vocab (padding masked) and the first-index argmax.
//
// What bounds it on an H100: bytes. A step streams ~0.30 GB of int4 weights
// and scales plus the live int8 cache (2 KB of K/V and 64 B of scales per
// layer per row: ~70 MB at pos 1200) and does ~1 FLOP per weight byte, so
// the floor is ~110 us at 3.35 TB/s. The TPU kernel was one launch because
// its per-op dispatch gaps starved HBM; on the H100 this first version is a
// fixed sequence of ten simple kernels per layer behind the one C entry
// point below, and the design attacks bytes and parallelism: weights stay
// nibble-packed in device memory and are expanded in registers (no
// dequantized copy), the GEMV splits work over (64-column tile, 512-row
// group) so even the narrow wo / wd products fill the SMs and reads them as
// 16-byte vectors with every load of a thread in flight at once, and
// attention splits the cache rows < pos into 64-row chunks (one block per
// KV head and chunk, its K/V rows copied to shared memory with cp.async,
// then a combine block per KV head) so the cache read is spread over the
// SMs. Launch overhead (~280 launches per step, which now bounds the step
// from the host) is what a CUDA graph or a persistent kernel removes in a
// later PR.
//
// Numerics follow the Pallas body exactly where it is exact: int32 group
// dots, f32 `part * (sx * s_g)` terms summed over groups in order, bf16
// roundings at the same places, quantization with round-half-even
// (rintf) and IEEE division. Only reduction orders of f32 sums (RMS, softmax)
// differ.
//
// This file holds K1's GEMV and its C entry point; the other kernels and the
// launch sequence live in megakernel.cuh, shared with the batched step
// (megakernel_batch.cu), which launches them with one block row per sequence.
#include "megakernel.cuh"

namespace {

constexpr int GEMV_COLS = 64;      // output columns per GEMV block
constexpr int GEMV_THREADS = 256;  // 4 threads x 16 columns, 64 row slices
constexpr int GEMV_SLICES = GEMV_THREADS / (GEMV_COLS / 16);
constexpr int GEMV_MAX_GROUP = 1024;

// -- int4 GEMV with fused group scales ---------------------------------------
//
// Block (x, g): columns [64x, 64x+64) of group g. terms[g, n] =
// f32(sum_{r in group g} xq[r] * w4[r, n]) * (sx * s[g, n]). Weight bytes
// [in/2, N]: row 2r is the low nibble of byte row r, row 2r+1 the high one.
// Each thread reads 16-byte vectors = 16 neighbouring columns of one row
// pair, from G/128 row pairs (4 at G = 512) whose loads are all in flight
// at once; 64 row slices are then summed per column in shared memory.
__global__ void __launch_bounds__(GEMV_THREADS) gemv_i4(
    const int8_t* __restrict__ xq, const float* __restrict__ sx_ptr,
    const uint8_t* __restrict__ wq, const float* __restrict__ ws, int G, int N,
    float* __restrict__ terms) {
  __shared__ int xs[GEMV_MAX_GROUP];
  __shared__ int part[GEMV_SLICES][GEMV_COLS + 1];  // +1: fewer bank conflicts
  const int g = blockIdx.y;
  const int seg = threadIdx.x % (GEMV_COLS / 16);
  const int slice = threadIdx.x / (GEMV_COLS / 16);
  const int col0 = blockIdx.x * GEMV_COLS + seg * 16;
  for (int r = threadIdx.x; r < G; r += blockDim.x) xs[r] = xq[(size_t)g * G + r];
  __syncthreads();
  int acc[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = 0;
  const uint8_t* wg = wq + (size_t)g * (G / 2) * N + col0;
#pragma unroll 4
  for (int rp = slice; rp < G / 2; rp += GEMV_SLICES) {
    const uint4 v = *reinterpret_cast<const uint4*>(wg + (size_t)rp * N);
    const int x0 = xs[2 * rp], x1 = xs[2 * rp + 1];
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
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
#pragma unroll
  for (int c = 0; c < 16; ++c) part[slice][seg * 16 + c] = acc[c];
  __syncthreads();
  if (threadIdx.x < GEMV_COLS) {
    int tot = 0;
    for (int s = 0; s < GEMV_SLICES; ++s) tot += part[s][threadIdx.x];
    const int n = blockIdx.x * GEMV_COLS + threadIdx.x;
    const float sx = *sx_ptr;
    terms[(size_t)g * N + n] = (float)tot * (sx * ws[(size_t)g * N + n]);
  }
}

}  // namespace

extern "C" size_t qw_mega_scratch_bytes(const MegaDims* d) {
  Scratch s;
  return layout(*d, 1, nullptr, &s);
}

// One decode step. Everything runs on `stream`; nothing is allocated and the
// host is never waited on. Returns a cudaError_t code.
extern "C" int qw_mega_decode_step_i8(const MegaPtrs* p, const MegaDims* dp, void* stream) {
  const MegaDims d = *dp;
  cudaStream_t st = (cudaStream_t)stream;
  if (!dims_ok(d, GEMV_COLS, GEMV_MAX_GROUP)) return (int)cudaErrorInvalidValue;
  if (attn_partial_smem(d) > 48 * 1024 || attn_combine_smem(d) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  Scratch s;
  layout(d, 1, (char*)p->scratch, &s);
  auto gemv = [&](const void* wq, const void* ws, size_t l, int n_in, int N, int G) {
    const uint8_t* q = (const uint8_t*)wq + l * (size_t)(n_in / 2) * N;
    const float* sc = (const float*)ws + l * (size_t)(n_in / G) * N;
    gemv_i4<<<dim3(N / GEMV_COLS, n_in / G), GEMV_THREADS, 0, st>>>(
        s.xq, s.sx, q, sc, G, N, s.terms);
  };
  decode_step(p, d, nullptr, 1, s, st, gemv);
  return (int)cudaGetLastError();
}
