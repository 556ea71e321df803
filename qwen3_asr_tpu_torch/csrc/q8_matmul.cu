// Q8_0 matrix products: x [T, in] times int8 weights with one f32 scale per
// (32-row block, column), dequantized on chip.
//
// Replaces, from qwen3_asr_tpu/ops/q8_matmul.py:
//   K5 q8_matmul.py::_q8_kernel       (x @ W),
//   K6 q8_matmul.py::_q8_norm_kernel  (RMSNorm(x) * norm_w @ W),
//   K7 q8_matmul.py::_q8_mlp_kernel   (the whole SwiGLU MLP: norm, gate and
//      up, silu(g) * u rounded to bf16, down).
// Numerics follow the Pallas bodies: the weight is dequantized as q * s in
// f32, or, where the reference picks bf16 (`_tile_for`: outputs of 2,048
// columns or more, and all of K7), as bf16(q * bf16(s)) with x rounded to
// bf16; products summed in f32. The norm is f32: x * rsqrt(mean(x^2) + eps)
// * w. Only the f32 summation order differs from the reference.
//
// What bounds them on an H100: bytes. For T up to 16 rows (the decode step,
// one row or a batch's) a weight byte feeds 2T operations, far under the
// card's f32 rate, so the floor is the int8 codes plus 1/8 of their size in
// scales over 3.35 TB/s (the 1,024 x 155,648 lm head: 179 MB, 53 us). One
// body, `q8_rows`, serves every 1 <= T <= 256: K5, K6 and both launches of
// K7. There is no separate one-row GEMV: on an H100 80GB HBM3 (700 W) this
// body at T = 1 was faster than the GEMV it replaced for Wo, the lm head
// and K7, and ~12% slower for QKV (7.5 against 6.7 us, both far above the
// bytes' 1.4 us), so one body and one sum order were kept. The design:
// - Blocks: 64 output columns (gate/up: 32 gate and the same 32 up columns,
//   so the SwiGLU is the epilogue) of one slice of `in` for one group of R
//   <= 16 rows (R the power of two >= T up to 16; T > 16 takes more groups,
//   whose blocks find the layer's weights in L2). `in` is split over S <= 8
//   blocks (a thread block cluster) until the column tiles times S reach 128
//   blocks, each slice keeping >= 256 rows: Wo and down 16 tiles x 8, QKV
//   64 x 2, gate-up 96 x 2, the lm head 2,432 x 1.
// - Weights: 16-byte cp.async copies of 128-row stages into a ring of 4 in
//   shared memory (3 at R 16), all but one issued before the prologue, so
//   loads stay in flight across the FMAs. Each weight is dequantized once
//   per block (its int8 code turned into f32 through the exponent field,
//   not a slow conversion) and applied to every row of the group.
// - x: each row's norm factor is computed by every block over the whole row,
//   the same way in every block; only the block's slice of x, normed and
//   rounded, is kept in shared memory ([k][R], 1,024 rows a window), read
//   in 16-byte pieces with a thread's loads in flight together.
// - The S slices' partials meet through distributed shared memory: after a
//   cluster barrier each block sums a share of the outputs over the S
//   blocks' partials in rank order and writes them. No float atomics.
// Row order: an output element's f32 sum has one order, a function of its
// column and the `in` index alone. Thread (column group, k lane kl) sums rows
// 32b + kl, then 32b + 16 + kl, over the slice's 32-row blocks b in order;
// the 16 k lanes meet as pairs (a shuffle) and then the 8 warps in a fixed
// tree; the S slices in rank order. None of it depends on T, R, the row
// group or the other rows, so row t of a T-row launch equals a one-row
// launch on row t, bit for bit, and two launches give the same bits.
// K7 is two launches behind one entry point: gate/up with the norm prologue
// and silu * mul into a bf16 [T, FF] buffer (the TPU kept it in VMEM scratch
// across its sequential grid), then down.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int Q8_BLOCK = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 64;                  // output columns per block
constexpr int CPT = 4;                    // columns per thread
constexpr int CGROUPS = COLS / CPT;       // 16 column groups
constexpr int KLANES = THREADS / CGROUPS; // 16 k lanes
constexpr int KC = 128;                   // input rows per ring stage
constexpr int STAGE_BYTES = KC * COLS + (KC / Q8_BLOCK) * COLS * 4;
constexpr int XS_ROWS = 1024;             // input rows of an x window
constexpr int MAX_SPLIT = 8;              // blocks of a cluster (the portable maximum)
constexpr int FILL = 128;                 // blocks a split product reaches (~one an SM)
constexpr int MIN_SLICE = 256;            // input rows a split slice keeps at least
constexpr int MAX_R = 16;                 // rows of a group
constexpr int MAX_T = 256;                // rows of a launch

static_assert(KLANES == 16 && CGROUPS == 16, "the k lanes pair up across half warps");
static_assert(XS_ROWS % KC == 0, "an x window starts at a stage");

struct Q8Args {
  const void* x;     // [T, in] bf16 (x_bf16) or f32
  const void* nw;    // [in] norm weight (bf16 if nw_bf16, else f32), or null
  const int8_t* q;   // [in, ldq]
  const float* s;    // [in / 32, ldq]
  void* out;         // f32 [T, N]; in the gate/up mode bf16 [T, gu_ff]
  int T, in, N, ldq;
  int x_bf16, nw_bf16;
  int gu_ff;         // > 0: gate columns [0, FF), up columns [FF, 2FF)
  float eps;
};

// Ring stages (3 at R 16, so that two blocks of 16 rows share an SM), the
// x window's row stride in floats (a multiple of 4 from R 4: float4 reads)
__host__ __device__ constexpr int ring_stages(int R) { return R < MAX_R ? 4 : 3; }
__host__ __device__ constexpr int xs_stride(int R) { return R < 4 ? R : R + 4; }

// Dynamic shared memory of a block: the ring (whose first bytes the warps'
// partials [4][R][COLS] take over after the last stage), the x window
// [rows][stride], the block's partial [R][COLS], the norm's warp sums
// [R][WARPS] and the rows' norm factors [R].
__host__ __device__ inline int smem_bytes(int R, int slice) {
  const int xrows = slice < XS_ROWS ? slice : XS_ROWS;
  return ring_stages(R) * STAGE_BYTES + 4 * (xrows * xs_stride(R) + R * COLS + R * WARPS + R);
}
static_assert(WARPS / 2 * MAX_R * COLS * 4 <= ring_stages(MAX_R) * STAGE_BYTES,
              "the warps' partials fit in the ring");

// Blocks a product's `in` is split over: a function of in and the column
// tiles alone (never of T), so that every launch sums in the same order.
__host__ __device__ inline int splits_for(int in, int tiles) {
  int S = 1;
  while (2 * S <= MAX_SPLIT && tiles * S < FILL && in % (2 * S * Q8_BLOCK) == 0 &&
         in / (2 * S) >= MIN_SLICE)
    S *= 2;
  return S;
}

// Eight neighbouring elements of a bf16 or f32 vector from element i (a
// multiple of 8, 16-byte aligned): one or two 16-byte loads, read back as
// f32 by elem8, so that a thread's loads are issued before its values are
// used.
struct Raw8 {
  uint4 a, b;
};

__device__ __forceinline__ Raw8 load8(const void* p, size_t i, int is_bf16) {
  Raw8 r;
  if (is_bf16) {
    r.a = *reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
    r.b = r.a;
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(p) + i);
    r.a = q[0];
    r.b = q[1];
  }
  return r;
}

__device__ __forceinline__ float elem8(const Raw8& r, int e, int is_bf16) {
  const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
  if (is_bf16) return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  return __uint_as_float(w[e]);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// float -> bf16 -> float, round to nearest even, in integer operations:
// equal to bf16_round for every finite value (a dequantized weight is one).
__device__ __forceinline__ float bf16_rne(float v) {
  uint32_t u = __float_as_uint(v);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// Four weight columns of one input row: their codes (a little-endian word)
// and scales -> f32 weights, q * s or bf16(q * s) (s already bf16 then).
// Code c becomes 2^23 + (c + 128) through the exponent field, minus 2^23 +
// 128: exact.
template <bool BF16>
__device__ __forceinline__ void deq4(uint32_t word, const float* sc, float* w) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float q = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | c)) - 8388736.f;
    const float v = q * sc[c];
    w[c] = BF16 ? bf16_rne(v) : v;
  }
}

// Block (tile x, split y, group z): output columns of tile x (gcol), input
// rows [y slice, (y + 1) slice) with slice = in / S, rows [z R, z R + R) of
// x. Thread tid = 16 kl + cg: columns 4cg .. 4cg + 3 of the tile, k lane
// kl. The split's blocks form one cluster (S > 1).
template <int R, bool BF16>
__global__ void __launch_bounds__(THREADS, 2) q8_rows(Q8Args a, int S) {
  constexpr int RS = xs_stride(R);
  constexpr int STAGES = ring_stages(R);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgi = tid % CGROUPS, kl = tid / CGROUPS;
  const int slice = a.in / S;
  const int k0 = blockIdx.y * slice;
  const int t0 = blockIdx.z * R;
  const int nrows = min(R, a.T - t0);
  const int xrows = min(XS_ROWS, slice);
  float* xs = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* part = xs + xrows * RS;
  float* red = part + R * COLS;
  float* rs = red + R * WARPS;
  const int half = COLS / 2;
  auto gcol = [&](int c) {
    return a.gu_ff ? (c < half ? 0 : a.gu_ff) + blockIdx.x * half + (c & (half - 1))
                   : blockIdx.x * COLS + c;
  };

  // stage st (slice rows [st KC, st KC + rows)) into ring slot st % STAGES:
  // the codes [KC][COLS], then the scales [KC / 32][COLS]; one commit group
  // a stage, empty past the last
  const int nst = (slice + KC - 1) / KC;
  auto issue = [&](int st) {
    if (st < nst) {
      const int r0 = k0 + st * KC;
      const int rows = min(KC, slice - st * KC);
      unsigned char* slot = smem + (st % STAGES) * STAGE_BYTES;
      for (int i = tid; i < rows * (COLS / 16); i += THREADS) {
        const int r = i / (COLS / 16), p = i % (COLS / 16);
        __pipeline_memcpy_async(slot + r * COLS + 16 * p,
                                a.q + (size_t)(r0 + r) * a.ldq + gcol(16 * p), 16);
      }
      float* ss = reinterpret_cast<float*>(slot + KC * COLS);
      for (int i = tid; i < (rows / Q8_BLOCK) * (COLS / 4); i += THREADS) {
        const int b = i / (COLS / 4), p = i % (COLS / 4);
        __pipeline_memcpy_async(ss + b * COLS + 4 * p,
                                a.s + (size_t)(r0 / Q8_BLOCK + b) * a.ldq + gcol(4 * p), 16);
      }
    }
    __pipeline_commit();
  };
  for (int st = 0; st < STAGES - 1; ++st) issue(st);

  // each row's norm factor over the whole row: 8-element pieces, the warp's
  // butterfly, the warps in order
  if (a.nw) {
    float ss[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ss[r] = 0.f;
    for (int j = 8 * tid; j < a.in; j += 8 * THREADS) {
#pragma unroll
      for (int r0 = 0; r0 < R; r0 += 4) {
        Raw8 raw[4];
#pragma unroll
        for (int r = r0; r < r0 + 4 && r < R; ++r)
          if (r < nrows) raw[r - r0] = load8(a.x, (size_t)(t0 + r) * a.in + j, a.x_bf16);
#pragma unroll
        for (int r = r0; r < r0 + 4 && r < R; ++r) {
          if (r < nrows) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float v = elem8(raw[r - r0], e, a.x_bf16);
              ss[r] = fmaf(v, v, ss[r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = warp_sum(ss[r]);
      if (lane == 0) red[r * WARPS + warp] = v;
    }
    __syncthreads();
    if (tid < R) {
      float v = red[tid * WARPS];
      for (int w = 1; w < WARPS; ++w) v += red[tid * WARPS + w];
      rs[tid] = rsqrtf(v / (float)a.in + a.eps);
    }
  }

  // slice rows [w0, w0 + xrows) of the group's x, normed and rounded to the
  // dequant dtype, as xs[k][r] (rows past T zero): pieces of 8 elements of
  // one row, row r fastest across threads, two pieces of a thread in flight
  auto stage_x = [&](int w0) {
    const int pieces = min(xrows, slice - w0) / 8 * R;
    for (int i0 = tid; i0 < pieces; i0 += 2 * THREADS) {
      Raw8 xv[2], wv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = i0 + j * THREADS, r = i % R, kk = k0 + w0 + 8 * (i / R);
        if (i < pieces && r < nrows) {
          xv[j] = load8(a.x, (size_t)(t0 + r) * a.in + kk, a.x_bf16);
          if (a.nw) wv[j] = load8(a.nw, kk, a.nw_bf16);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = i0 + j * THREADS, r = i % R, k = 8 * (i / R);
        if (i < pieces) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float v = 0.f;
            if (r < nrows) {
              v = elem8(xv[j], e, a.x_bf16);
              if (a.nw) v = v * rs[r] * elem8(wv[j], e, a.nw_bf16);
              if (BF16) v = bf16_round(v);
            }
            xs[(k + e) * RS + r] = v;
          }
        }
      }
    }
  };

  float acc[R][CPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  for (int st = 0; st < nst; ++st) {
    const int srow = st * KC;
    if (srow % XS_ROWS == 0) {
      __syncthreads();   // the last window read (and, first, rs written)
      stage_x(srow);
    }
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();     // stage st and the window visible; slot st - 1 free
    issue(st + STAGES - 1);
    const unsigned char* slot = smem + (st % STAGES) * STAGE_BYTES;
    const float* ssm = reinterpret_cast<const float*>(slot + KC * COLS);
    const int rows = min(KC, slice - srow);
    const int xo = srow % XS_ROWS;
    for (int b = 0; b < rows / Q8_BLOCK; ++b) {
      const float4 s4 = *reinterpret_cast<const float4*>(ssm + b * COLS + CPT * cgi);
      float sc[CPT] = {s4.x, s4.y, s4.z, s4.w};
      if (BF16) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) sc[c] = bf16_round(sc[c]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = Q8_BLOCK * b + 16 * h + kl;
        float w[CPT];
        deq4<BF16>(*reinterpret_cast<const uint32_t*>(slot + kk * COLS + CPT * cgi), sc, w);
        const float* xr = xs + (xo + kk) * RS;
        float xv[R];
        if constexpr (R >= 4) {
#pragma unroll
          for (int r = 0; r < R; r += 4) {
            const float4 v = *reinterpret_cast<const float4*>(xr + r);
            xv[r] = v.x;
            xv[r + 1] = v.y;
            xv[r + 2] = v.z;
            xv[r + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) xv[r] = xr[r];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(xv[r], w[c], acc[r][c]);
      }
    }
  }

  // the block's partial: k lanes 2w and 2w + 1 (lanes l and l ^ 16) meet by
  // a shuffle; then the warps' sums p_w as a fixed tree, ((p0 + p4) + (p2 +
  // p6)) + ((p1 + p5) + (p3 + p7)), through planes [4][R][COLS] over the ring
  __pipeline_wait_prior(0);
  float v[R][CPT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      v[r][c] = acc[r][c] + __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  float* wp = reinterpret_cast<float*>(smem);
  for (int span = WARPS / 2; span >= 1; span /= 2) {
    __syncthreads();   // the ring's last readers done; the last round's plane read
    if (warp >= span && warp < 2 * span && lane < 16) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(wp + ((warp - span) * R + r) * COLS + CPT * cgi) =
            make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
    }
    __syncthreads();
    if (warp < span && lane < 16) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 o = *reinterpret_cast<const float4*>(wp + (warp * R + r) * COLS + CPT * cgi);
        v[r][0] += o.x;
        v[r][1] += o.y;
        v[r][2] += o.z;
        v[r][3] += o.w;
      }
    }
  }
  if (warp == 0 && lane < 16) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(part + r * COLS + CPT * cgi) =
          make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
  }

  // the S slices meet: block `rank` sums outputs rank * THREADS + tid, ...
  // over the cluster's partials in rank order and writes them
  int rank = 0;
  if (S > 1) {
    cg::this_cluster().sync();
    rank = (int)cg::this_cluster().block_rank();
  } else {
    __syncthreads();
  }
  auto meet = [&](int i) {
    if (S == 1) return part[i];
    cg::cluster_group cl = cg::this_cluster();
    float m = *cl.map_shared_rank(part + i, 0);
    for (int s = 1; s < S; ++s) m += *cl.map_shared_rank(part + i, s);
    return m;
  };
  if (a.gu_ff) {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(a.out);
    for (int i = rank * THREADS + tid; i < nrows * half; i += S * THREADS) {
      const int r = i / half, j = i % half;
      o[(size_t)(t0 + r) * a.gu_ff + blockIdx.x * half + j] =
          __float2bfloat16_rn(silu_mul(meet(r * COLS + j), meet(r * COLS + half + j)));
    }
  } else {
    float* o = reinterpret_cast<float*>(a.out);
    for (int i = rank * THREADS + tid; i < nrows * COLS; i += S * THREADS) {
      const int r = i / COLS, c = i % COLS;
      o[(size_t)(t0 + r) * a.N + blockIdx.x * COLS + c] = meet(i);
    }
  }
  if (S > 1) cg::this_cluster().sync();   // no block leaves while another reads its partial
}

bool args_ok(const Q8Args& a) {
  if (a.T < 1 || a.T > MAX_T || a.in <= 0 || a.in % Q8_BLOCK) return false;
  if (a.ldq % COLS) return false;
  if ((uintptr_t)a.x % 16 || (uintptr_t)a.nw % 16 || (uintptr_t)a.q % 16 || (uintptr_t)a.s % 16)
    return false;
  if (a.gu_ff) return a.gu_ff % (COLS / 2) == 0 && a.ldq >= 2 * a.gu_ff;
  return a.N % COLS == 0 && a.ldq >= a.N;
}

template <int R, bool BF16>
void launch_r(const Q8Args& a, int tiles, int S, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, S, (a.T + R - 1) / R);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(R, a.in / S);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, q8_rows<R, BF16>, a, S);
}

template <bool BF16>
void launch_t(const Q8Args& a, int tiles, int S, cudaStream_t st) {
  if (a.T <= 1) launch_r<1, BF16>(a, tiles, S, st);
  else if (a.T <= 2) launch_r<2, BF16>(a, tiles, S, st);
  else if (a.T <= 4) launch_r<4, BF16>(a, tiles, S, st);
  else if (a.T <= 8) launch_r<8, BF16>(a, tiles, S, st);
  else launch_r<MAX_R, BF16>(a, tiles, S, st);
}

void launch(const Q8Args& a, bool bf16, cudaStream_t st) {
  const int tiles = a.gu_ff ? a.gu_ff / (COLS / 2) : a.N / COLS;
  const int S = splits_for(a.in, tiles);
  if (bf16) launch_t<true>(a, tiles, S, st);
  else launch_t<false>(a, tiles, S, st);
}

template <int R, bool BF16>
void set_smem() {
  cudaFuncSetAttribute(q8_rows<R, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes(R, XS_ROWS));   // the widest window
}

}  // namespace

// Sets the products' dynamic shared-memory limits (above the 48 KB default);
// called once when the library is loaded, never inside a captured graph.
extern "C" int qw_q8_init() {
  set_smem<1, false>();
  set_smem<2, false>();
  set_smem<4, false>();
  set_smem<8, false>();
  set_smem<MAX_R, false>();
  set_smem<1, true>();
  set_smem<2, true>();
  set_smem<4, true>();
  set_smem<8, true>();
  set_smem<MAX_R, true>();
  return (int)cudaGetLastError();
}

// K5 (nw null) and K6 (nw given): out f32 [T, n_out] = (RMSNorm(x) * nw or x)
// @ dequant(q, s); q int8 [n_in, n_out], s f32 [n_in / 32, n_out]. deq_bf16
// selects the bf16 dequant of the reference's wide-output tiles. Returns a
// cudaError_t code.
extern "C" int qw_q8_matmul(const void* x, int x_bf16, const void* nw, int nw_bf16,
                            float eps, const void* q, const void* s, void* out, int T,
                            int n_in, int n_out, int deq_bf16, void* stream) {
  Q8Args a{x, nw, (const int8_t*)q, (const float*)s, out, T, n_in, n_out, n_out,
           x_bf16, nw_bf16, 0, eps};
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  launch(a, deq_bf16 != 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K7: out f32 [T, n_out] = (bf16(silu(g) * u)) @ dequant(qd, sd), with g, u
// = bf16(RMSNorm(x) * nw) @ dequant(qgu, sgu) over the gate and up halves of
// the fused [n_in, 2 FF] weight; bf16 dequant throughout. `ffn` is the
// caller's bf16 [T, FF] buffer between the two launches.
extern "C" int qw_q8_mlp(const void* x, int x_bf16, const void* nw, int nw_bf16, float eps,
                         const void* qgu, const void* sgu, const void* qd, const void* sd,
                         void* ffn, void* out, int T, int n_in, int FF, int n_out,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Q8Args gu{x, nw, (const int8_t*)qgu, (const float*)sgu, ffn, T, n_in, FF, 2 * FF,
            x_bf16, nw_bf16, FF, eps};
  Q8Args dn{ffn, nullptr, (const int8_t*)qd, (const float*)sd, out, T, FF, n_out, n_out,
            1, 0, 0, eps};
  if (!nw || !args_ok(gu) || !args_ok(dn)) return (int)cudaErrorInvalidValue;
  launch(gu, true, st);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  launch(dn, true, st);
  return (int)cudaGetLastError();
}
