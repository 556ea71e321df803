// Weight-stream microbenchmarks of the decode step on Hopper: how fast the
// step's weight bytes can be read, alone and with the GEMV attached.
//
// Replaces (K9) scripts/microbench_stream.py::_stream_kernel, (K10)
// scripts/probe_int4.py's ring benches (T4, ring_kernel_factory) and (K11)
// scripts/probe_int4b.py's int4 probes (P0/P1 bitcast order, P2 shift
// unpack, P3 ring bench). Those measured a TPU's HBM -> VMEM DMA ring inside
// one pallas_call. On the card the same question is asked of device memory
// -> registers (or -> shared memory through cp.async), by modes:
//
// - read (vector loads): every 16-byte vector of the weights once, its bytes
//   summed with dp4a into a live int64 total. The route gemv_i4 takes.
// - read_ring: the same sum through a cp.async ring of RING_NBUF stages in
//   shared memory, each thread's 16-byte pieces in flight RING_NBUF - 1
//   stages ahead of its reads: the TPU's DMA ring, on Hopper.
// - int8_m1 / int8_m8: out[m, c] = f32(sum_{i, r} x[m, r] w[i, r, c]) * s[c]
//   over n_chunks [1024, C] int8 chunks, the x rows shared by every chunk:
//   the int8 pack's GEMV (megakernel.cu::gemv_i8) at M = 1 and its batched
//   form (megakernel_batch.cu::gemv_i8_batch) at M = 8. dp4a on 4-row words;
//   the chunks split over blocks whose exact int32 sums meet through atomics,
//   and the last block of a column tile scales them.
// - bf16_m8: the same product with each weight converted to bf16 and an f32
//   FMA (the TPU's fallback when its int8 GEMV did not lower); f32 sums, so
//   it is not exact.
// - int4_m1: out[i, c] = f32(dot_0) * s[i, 0, c] + f32(dot_1) * s[i, 1, c]
//   over n_chunks [512, C] byte chunks of the port's nibble pack (1,024 rows,
//   row 2r in the low nibble of byte row r), with a scale per (512-row group,
//   column): the int4 pack's GEMV (megakernel.cu::gemv_i4).
// - unpack_nibbles: bytes [R, N] -> int8 [2R, N], row 2r the sign-extended
//   low nibble and row 2r+1 the high one: the port's pack contract, which
//   K11's P0/P1 found as the TPU's bitcast order.
//
// What bounds every mode on an H100: bytes (3.35 TB/s); the GEMVs do 2
// operations per weight byte (int8) or 4 (int4), far under the 1,979 TOP/s
// of int8 at these widths. Each entry launches one kernel on `stream`,
// allocates nothing (outputs and scratch come zeroed from the wrapper where
// the mode says so) and returns a cudaError_t code.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int MB_THREADS = 256;
constexpr int MB_IN = 1024;          // rows of one int8 chunk (the TPU's IN)
constexpr int MB_COLS = 64;          // output columns per GEMV block
constexpr int RING_NBUF = 4;         // stages of the cp.async ring
constexpr int RING_VEC = 2;          // 16-byte pieces per thread per stage

__device__ __forceinline__ int sum_bytes(uint32_t w, int acc) {
  return __dp4a((int)w, 0x01010101, acc);
}

// The block's int32 total into a 64-bit global sum (two's complement adds).
__device__ __forceinline__ void block_total(int acc, unsigned long long* out) {
  __shared__ long long red[MB_THREADS / 32];
  long long v = acc;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < MB_THREADS / 32; ++w) t += red[w];
    atomicAdd(out, (unsigned long long)t);
  }
}

// read: a grid-stride pass over n16 16-byte vectors, 4 loads in flight a
// thread.
__global__ void __launch_bounds__(MB_THREADS) mb_read(const uint4* __restrict__ w,
                                                      size_t n16,
                                                      unsigned long long* out) {
  int acc = 0;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n16; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = w[i + k * stride];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc = sum_bytes(v[k].x, sum_bytes(v[k].y, sum_bytes(v[k].z, sum_bytes(v[k].w, acc))));
  }
  for (; i < n16; i += stride) {
    const uint4 v = w[i];
    acc = sum_bytes(v.x, sum_bytes(v.y, sum_bytes(v.z, sum_bytes(v.w, acc))));
  }
  block_total(acc, out);
}

// read_ring: block b takes stages b, b + gridDim.x, ...; a stage is
// MB_THREADS * RING_VEC 16-byte pieces, thread t copying and then reading
// its own RING_VEC pieces, so a thread waits only on its own copies.
__global__ void __launch_bounds__(MB_THREADS) mb_read_ring(const uint4* __restrict__ w,
                                                           size_t n16,
                                                           unsigned long long* out) {
  __shared__ __align__(16) uint4 ring[RING_NBUF][MB_THREADS * RING_VEC];
  constexpr int STAGE = MB_THREADS * RING_VEC;
  const size_t n_stages = (n16 + STAGE - 1) / STAGE;
  const size_t mine = n_stages > blockIdx.x ? (n_stages - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  auto issue = [&](size_t k) {
    if (k < mine) {
      const size_t base = (blockIdx.x + k * gridDim.x) * (size_t)STAGE;
#pragma unroll
      for (int j = 0; j < RING_VEC; ++j) {
        const size_t e = base + threadIdx.x + j * MB_THREADS;
        if (e < n16)
          __pipeline_memcpy_async(&ring[k % RING_NBUF][threadIdx.x + j * MB_THREADS], &w[e], 16);
      }
    }
    __pipeline_commit();  // an empty group keeps the wait count uniform
  };
  for (int k = 0; k < RING_NBUF - 1; ++k) issue(k);
  int acc = 0;
  for (size_t k = 0; k < mine; ++k) {
    issue(k + RING_NBUF - 1);
    __pipeline_wait_prior(RING_NBUF - 1);
    const size_t base = (blockIdx.x + k * gridDim.x) * (size_t)STAGE;
#pragma unroll
    for (int j = 0; j < RING_VEC; ++j) {
      if (base + threadIdx.x + j * MB_THREADS < n16) {
        const uint4 v = ring[k % RING_NBUF][threadIdx.x + j * MB_THREADS];
        acc = sum_bytes(v.x, sum_bytes(v.y, sum_bytes(v.z, sum_bytes(v.w, acc))));
      }
    }
  }
  block_total(acc, out);
}

// The last block of a column tile (counted in tiles[blockIdx.x]) finds the
// whole sums in acc; it leaves acc and its counter zero.
__device__ __forceinline__ bool tile_done(int* tiles) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tiles[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  return last;
}

// int8_mM: block (x, y) takes columns [64x, 64x+64) of chunks [y CPB, y CPB +
// CPB). V bytes a load: thread t takes V columns (t % (64 / V)) and row quads
// q = t / (64 / V) + k * SLICES of each chunk; a quad's four rows (V bytes
// each) are byte-transposed into one 4-row word per column for dp4a.
template <int M, int V>
__global__ void __launch_bounds__(MB_THREADS) mb_gemv_i8(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ s,
    int n_chunks, int CPB, int C, int* __restrict__ iacc, int* __restrict__ tiles,
    float* __restrict__ out) {
  constexpr int SEGS = MB_COLS / V, SLICES = MB_THREADS / SEGS, NW = V / 4;
  __shared__ int xs[M][MB_IN / 4];
  __shared__ int part[SLICES][M][MB_COLS + 1];
  const int seg = threadIdx.x % SEGS, slice = threadIdx.x / SEGS;
  const int col0 = blockIdx.x * MB_COLS + seg * V;
  for (int i = threadIdx.x; i < M * MB_IN / 4; i += blockDim.x)
    xs[i / (MB_IN / 4)][i % (MB_IN / 4)] = reinterpret_cast<const int*>(x)[i];
  __syncthreads();
  int acc[M][V];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[m][k] = 0;
  const int i0 = blockIdx.y * CPB, i1 = min(n_chunks, i0 + CPB);
  for (int i = i0; i < i1; ++i) {
    const int8_t* wc = w + (size_t)i * MB_IN * C + col0;
#pragma unroll 2
    for (int q = slice; q < MB_IN / 4; q += SLICES) {
      const int8_t* p = wc + (size_t)(4 * q) * C;
      uint32_t r[4][NW];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (V == 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(p + (size_t)j * C);
          r[j][0] = v.x;
          r[j][1] = v.y;
          r[j][2] = v.z;
          r[j][3] = v.w;
        } else {
          r[j][0] = *reinterpret_cast<const uint32_t*>(p + (size_t)j * C);
        }
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const uint32_t t0 = __byte_perm(r[0][k], r[1][k], 0x5140);
        const uint32_t t1 = __byte_perm(r[0][k], r[1][k], 0x7362);
        const uint32_t t2 = __byte_perm(r[2][k], r[3][k], 0x5140);
        const uint32_t t3 = __byte_perm(r[2][k], r[3][k], 0x7362);
        const int cw[4] = {(int)__byte_perm(t0, t2, 0x5410), (int)__byte_perm(t0, t2, 0x7632),
                           (int)__byte_perm(t1, t3, 0x5410), (int)__byte_perm(t1, t3, 0x7632)};
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][4 * k + c] = __dp4a(cw[c], xs[m][q], acc[m][4 * k + c]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < V; ++k) part[slice][m][seg * V + k] = acc[m][k];
  __syncthreads();
  for (int e = threadIdx.x; e < M * MB_COLS; e += blockDim.x) {
    const int m = e / MB_COLS, nn = e % MB_COLS;
    int tot = 0;
    for (int sl = 0; sl < SLICES; ++sl) tot += part[sl][m][nn];
    atomicAdd(&iacc[(size_t)m * C + blockIdx.x * MB_COLS + nn], tot);
  }
  if (tile_done(tiles)) {
    for (int e = threadIdx.x; e < M * MB_COLS; e += blockDim.x) {
      const int m = e / MB_COLS, n = blockIdx.x * MB_COLS + e % MB_COLS;
      out[(size_t)m * C + n] = (float)atomicExch(&iacc[(size_t)m * C + n], 0) * s[n];
    }
    if (threadIdx.x == 0) tiles[blockIdx.x] = 0;
  }
}

// bf16_m8: the int8_m8 layout (V = 4) with each weight byte converted to
// bf16 and multiplied into f32 sums; blocks meet through f32 atomics.
__global__ void __launch_bounds__(MB_THREADS) mb_gemv_bf16(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ s,
    int n_chunks, int CPB, int C, float* __restrict__ facc, int* __restrict__ tiles,
    float* __restrict__ out) {
  constexpr int M = 8, V = 4, SEGS = MB_COLS / V, SLICES = MB_THREADS / SEGS;
  // xs [M][MB_IN] during the loop, then part [SLICES][M][MB_COLS + 1]
  __shared__ float smem[SLICES * M * (MB_COLS + 1)];
  float (*xs)[MB_IN] = reinterpret_cast<float (*)[MB_IN]>(smem);
  float (*part)[M][MB_COLS + 1] = reinterpret_cast<float (*)[M][MB_COLS + 1]>(smem);
  const int seg = threadIdx.x % SEGS, slice = threadIdx.x / SEGS;
  const int col0 = blockIdx.x * MB_COLS + seg * V;
  for (int i = threadIdx.x; i < M * MB_IN; i += blockDim.x)
    xs[i / MB_IN][i % MB_IN] = bf2f(__float2bfloat16_rn((float)x[i]));
  __syncthreads();
  float acc[M][V];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[m][k] = 0.f;
  const int i0 = blockIdx.y * CPB, i1 = min(n_chunks, i0 + CPB);
  for (int i = i0; i < i1; ++i) {
    const int8_t* wc = w + (size_t)i * MB_IN * C + col0;
#pragma unroll 4
    for (int r = slice; r < MB_IN; r += SLICES) {
      const char4 b = *reinterpret_cast<const char4*>(wc + (size_t)r * C);
      const float wf[4] = {bf2f(__int2bfloat16_rn(b.x)), bf2f(__int2bfloat16_rn(b.y)),
                           bf2f(__int2bfloat16_rn(b.z)), bf2f(__int2bfloat16_rn(b.w))};
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int k = 0; k < V; ++k) acc[m][k] = fmaf(xs[m][r], wf[k], acc[m][k]);
    }
  }
  __syncthreads();  // part overwrites xs
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int k = 0; k < V; ++k) part[slice][m][seg * V + k] = acc[m][k];
  __syncthreads();
  for (int e = threadIdx.x; e < M * MB_COLS; e += blockDim.x) {
    const int m = e / MB_COLS, nn = e % MB_COLS;
    float tot = 0.f;
    for (int sl = 0; sl < SLICES; ++sl) tot += part[sl][m][nn];
    atomicAdd(&facc[(size_t)m * C + blockIdx.x * MB_COLS + nn], tot);
  }
  if (tile_done(tiles)) {
    for (int e = threadIdx.x; e < M * MB_COLS; e += blockDim.x) {
      const int m = e / MB_COLS, n = blockIdx.x * MB_COLS + e % MB_COLS;
      out[(size_t)m * C + n] = atomicExch(&facc[(size_t)m * C + n], 0.f) * s[n];
    }
    if (threadIdx.x == 0) tiles[blockIdx.x] = 0;
  }
}

// int4_m1: block (x, i) takes columns [64x, 64x+64) of chunk i, [512, C]
// bytes = 1,024 nibble rows in two 512-row scale groups. Thread t takes 16
// columns (t % 4) and byte rows t / 4 + 64 k (16-byte loads, as gemv_i4).
__global__ void __launch_bounds__(MB_THREADS) mb_gemv_i4(
    const int8_t* __restrict__ x, const uint8_t* __restrict__ w, const float* __restrict__ s,
    int C, float* __restrict__ out) {
  constexpr int SEGS = MB_COLS / 16, SLICES = MB_THREADS / SEGS, BR = MB_IN / 2;
  __shared__ int xs[MB_IN];
  __shared__ int part[2][SLICES][MB_COLS + 1];
  const int seg = threadIdx.x % SEGS, slice = threadIdx.x / SEGS;
  const int col0 = blockIdx.x * MB_COLS + seg * 16;
  const int i = blockIdx.y;
  for (int r = threadIdx.x; r < MB_IN; r += blockDim.x) xs[r] = x[r];
  __syncthreads();
  int acc[2][16];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[g][c] = 0;
  const uint8_t* wc = w + (size_t)i * BR * C + col0;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll 4
    for (int rp = g * BR / 2 + slice; rp < (g + 1) * BR / 2; rp += SLICES) {
      const uint4 v = *reinterpret_cast<const uint4*>(wc + (size_t)rp * C);
      const int x0 = xs[2 * rp], x1 = xs[2 * rp + 1];
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t by = (words[k] >> (8 * b)) & 0xffu;
          const int lo = ((int)(int8_t)(uint8_t)((by << 4) & 0xf0u)) >> 4;
          const int hi = ((int)(int8_t)(uint8_t)(by & 0xf0u)) >> 4;
          acc[g][4 * k + b] += x0 * lo + x1 * hi;
        }
    }
  }
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int c = 0; c < 16; ++c) part[g][slice][seg * 16 + c] = acc[g][c];
  __syncthreads();
  if (threadIdx.x < MB_COLS) {
    const int n = blockIdx.x * MB_COLS + threadIdx.x;
    int t0 = 0, t1 = 0;
    for (int sl = 0; sl < SLICES; ++sl) {
      t0 += part[0][sl][threadIdx.x];
      t1 += part[1][sl][threadIdx.x];
    }
    const float* si = s + (size_t)i * 2 * C;
    // the group terms summed in order, uncontracted, as the twin sums them
    out[(size_t)i * C + n] = __fadd_rn(__fmul_rn((float)t0, si[n]), __fmul_rn((float)t1, si[C + n]));
  }
}

// unpack_nibbles: thread = 16 columns of one byte row: one 16-byte load,
// two 16-byte stores (rows 2r and 2r + 1).
__global__ void __launch_bounds__(MB_THREADS) mb_unpack(const uint4* __restrict__ b,
                                                        uint4* __restrict__ out,
                                                        int R, int N16) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)R * N16) return;
  const size_t r = e / N16, c = e % N16;
  const uint4 v = b[e];
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // low nibbles: shift into the high half of each byte, then an
    // arithmetic shift right by 4 per byte (sign extension)
    const uint32_t l = (in[k] << 4) & 0xf0f0f0f0u, h = in[k] & 0xf0f0f0f0u;
    uint32_t lw = 0, hw = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lw |= (uint32_t)(uint8_t)((int8_t)(uint8_t)(l >> (8 * j)) >> 4) << (8 * j);
      hw |= (uint32_t)(uint8_t)((int8_t)(uint8_t)(h >> (8 * j)) >> 4) << (8 * j);
    }
    lo[k] = lw;
    hi[k] = hw;
  }
  out[(2 * r) * N16 + c] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  out[(2 * r + 1) * N16 + c] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
}

}  // namespace

// n16 16-byte vectors of w summed into *out (int64, zeroed by the caller).
extern "C" int qw_mb_read(const void* w, size_t n16, void* out, int ring, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int grid = 4 * sms;
  if (ring)
    mb_read_ring<<<grid, MB_THREADS, 0, st>>>((const uint4*)w, n16, (unsigned long long*)out);
  else
    mb_read<<<grid, MB_THREADS, 0, st>>>((const uint4*)w, n16, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// mode 1: int8_m1, 8: int8_m8, 0: bf16_m8. x [M, 1024] int8, w [n_chunks,
// 1024, C] int8, s [C] f32, out [M, C] f32; acc [M, C] (int32, or f32 for
// bf16) and tiles [C / 64] int32 zeroed by the caller (left zero).
extern "C" int qw_mb_gemv(int mode, const void* x, const void* w, const void* s,
                          int n_chunks, int C, void* acc, void* tiles, void* out,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % MB_COLS || n_chunks < 1) return (int)cudaErrorInvalidValue;
  const int cpb = 4;  // chunks per block: 4 x 64 KB of a column tile
  const dim3 grid(C / MB_COLS, (n_chunks + cpb - 1) / cpb);
  const int8_t* xi = (const int8_t*)x;
  const int8_t* wi = (const int8_t*)w;
  const float* sf = (const float*)s;
  if (mode == 1)
    mb_gemv_i8<1, 16><<<grid, MB_THREADS, 0, st>>>(xi, wi, sf, n_chunks, cpb, C, (int*)acc,
                                                   (int*)tiles, (float*)out);
  else if (mode == 8)
    mb_gemv_i8<8, 4><<<grid, MB_THREADS, 0, st>>>(xi, wi, sf, n_chunks, cpb, C, (int*)acc,
                                                  (int*)tiles, (float*)out);
  else if (mode == 0)
    mb_gemv_bf16<<<grid, MB_THREADS, 0, st>>>(xi, wi, sf, n_chunks, cpb, C, (float*)acc,
                                              (int*)tiles, (float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// int4_m1: x [1024] int8, w [n_chunks, 512, C] nibble bytes, s [n_chunks, 2,
// C] f32 -> out [n_chunks, C] f32.
extern "C" int qw_mb_gemv_i4(const void* x, const void* w, const void* s, int n_chunks,
                             int C, void* out, void* stream) {
  if (C % MB_COLS || n_chunks < 1) return (int)cudaErrorInvalidValue;
  mb_gemv_i4<<<dim3(C / MB_COLS, n_chunks), MB_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const uint8_t*)w, (const float*)s, C, (float*)out);
  return (int)cudaGetLastError();
}

// bytes [R, N] -> int8 [2R, N]; N a multiple of 16.
extern "C" int qw_mb_unpack(const void* b, void* out, int R, int N, void* stream) {
  if (N % 16 || R < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)R * (N / 16);
  mb_unpack<<<(unsigned)((n + MB_THREADS - 1) / MB_THREADS), MB_THREADS, 0,
              (cudaStream_t)stream>>>((const uint4*)b, (uint4*)out, R, N / 16);
  return (int)cudaGetLastError();
}
