// SRA attention for Hopper (sm_90a): SegFormer's spatial-reduction
// attention, O = softmax(Q K^T * D^-1/2) V, one head at a time, and its
// backward.  Built by hiast_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with a plain C interface, loaded with ctypes.  No
// --use_fast_math: the exponentials (exp2f) and the softmax keep full float
// accuracy.
//
// Replaces hiast_tpu/ops/pallas/attention.py:_attn_fwd_kernel (the forward
// of sra_attention; its reference math is sra_attention_reference) and
// :_attn_bwd_kernel (the backward of its custom VJP, via _bwd_pallas).
//
// ---------------------------------------------------------------- forward
// Rounding points, as the JAX kernel has them: S = Q K^T in f32 from bf16
// products, scaled in f32 (q is never pre-scaled in bf16), pad KV columns
// masked out of the softmax, P = exp(S - max) / sum normalised in f32 BEFORE
// it is cast to bf16, O = P V accumulated in f32 and cast to bf16 once.  A
// FlashAttention-2 style online softmax would cast the unnormalised exp to
// bf16 and divide at the end, which rounds at another place.  So the kernel
// makes two passes over the K tiles: the first takes each row's max m and
// sum l = sum exp(s - m) (l rescaled online as m grows), the second
// recomputes S, forms p = exp(s - m) * (1 / l), casts p to bf16 and
// accumulates P V.  The reciprocal differs from the JAX division by at most
// one f32 ulp, far below the bf16 cast that follows.  When autograd needs
// them, the first pass also writes m and l per row as f32 [B*H, N_q]
// residuals; the serving path passes null pointers and writes nothing.
//
// Where the TPU design breaks: the Pallas kernel keeps all of K and V
// resident in VMEM (it assumes N_kv <= ~512).  At 768x1536 every MiT stage
// reduces K/V to a 24x48 grid, N_kv = 1152: K + V of one head are 294,912 B
// in bf16, above the 232,448 B a block may opt into.  Here K and V stream
// through shared memory in 64-row tiles, double-buffered with cp.async
// (zero-filled past N_kv), and nothing but the output leaves the SM.
//
// Layout: q, o are [B, N_q, H, D] and k, v [B, N_kv, H, D], read in place
// through their batch and row strides (the head dim must be D apart and the
// last dim contiguous), so the k and v halves of the fused kv projection go
// in without a copy.  One block of 4 warps takes 64 query rows of one
// (batch, head); each warp owns 16 rows.  QK^T and PV run on the tensor
// cores as mma.sync m16n8k16 bf16 -> f32; P stays in registers between the
// two products (the S accumulator layout is the A operand layout), and the K
// and V operands come from shared memory by ldmatrix (V transposed on the
// way).  Shared rows are padded by 16 B so those loads hit distinct banks.
// Only the last K tile, when N_kv is not a multiple of 64, is masked.
//
// Bound on an H100 SXM: per (batch, head) the work is 4 N_q N_kv D matmul
// FLOPs and N_q N_kv exponentials against 2 (N_q + N_kv) D bf16 values of
// traffic; at D = 64 the exponentials (16 per SM per clock on the MUFU) are
// as large a floor as the matmuls at 989 TFLOP/s, and memory is far below
// both.  This simple kernel pays for its rounding fidelity with a second
// QK^T and a second exp per score, and uses mma.sync rather than wgmma.
//
// --------------------------------------------------------------- backward
// The JAX kernel recomputes P, then dV = P_lo^T dO (P_lo = bf16(P)),
// dP = dO V^T in f32, delta = rowsum(P * dP), dS = bf16(P * (dP - delta) *
// scale), dQ = dS K and dK = dS^T Q, all accumulated in f32 and cast to the
// input dtype.  Its grid runs the query tiles of one head in order and adds
// each tile's dK/dV into one VMEM block.  Hopper blocks run in parallel and
// in no order, so the work is split by what each output is a sum over:
//
//   1. sra_attn_bwd_dq: query-parallel, like the forward (64 query rows per
//      block, K and V streamed in 64-row tiles, double-buffered).  It
//      rebuilds P = exp(s - m) / l from the forward's row statistics (no
//      pass to find them), forms dP and dS in registers and accumulates
//      dQ = dS K.  It also writes each row's (m log2 e, 1 / l, delta) for
//      kernel 2.
//   2. sra_attn_bwd_dkv: KV-parallel.  One block owns one 64-row K/V tile of
//      one head (16 rows per warp, K and V held as mma A operands in
//      registers) and walks a chunk of the query tiles, streaming Q and dO
//      (double-buffered): S^T = K Q^T, P^T, dV += P_lo^T dO, dP^T = V dO^T,
//      dS^T, dK += dS^T Q.  At a training step's stage 1 (B*H = 6,
//      N_kv = 512) one block per KV tile would be 48 blocks for 132 SMs,
//      each walking 32,768 query rows, so the query range is cut into
//      chunks (about four blocks per SM in all).  Each chunk writes f32
//      partial sums; no atomics.
//   3. sra_attn_bwd_reduce: adds the chunks' partials in a fixed order (so
//      the result is deterministic), casts to bf16 and writes dK and dV
//      into the two halves of one d(kv) buffer [B, N_kv, 2 H D], the layout
//      of the fused kv projection whose gradient it is.
//
// delta: the FlashAttention-2 form, rowsum(dO * O) with the forward's bf16
// output O, not the JAX form rowsum(P * dP), which would need a second pass
// over K and V in kernel 1.  The two differ by the rounding of P to P_lo
// and of O to bf16 (relative 2^-9 each, in a sum), far inside the bf16
// gradient tolerance; the plain PyTorch version keeps the JAX form.
//
// Bound: per (batch, head) the JAX backward does 10 N_q N_kv D matmul FLOPs
// (the recomputed S and four products) and N_q N_kv exponentials; this
// design does 14 (kernel 1 recomputes S and dP for dQ, kernel 2 again for
// dK/dV) and 2 N_q N_kv exponentials.  At the training shapes (N_kv = 512,
// D = 64) the matmuls bound it; bytes are far below.
//
// The launchers run on the caller's stream, never synchronise, allocate
// nothing (the wrapper passes the scratch buffers), and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block (forward, kernel 1) or per step (kernel 2)
constexpr int kBlockKV = 64;  // K/V rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 of padding per shared row (16 B)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlockQ == kBlockKV, "load_tile copies 64-row tiles of Q as of K and V");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 B with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c f32.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.  Without .trans lane l gets (row l / 4, columns
// 2 (l % 4), +1) of each matrix, the mma B layout for a [n][k] tile; with
// .trans it gets (rows 2 (l % 4), +1, column l / 4), the B layout for [k][n].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two floats rounded to bf16 in one 32-bit register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies rows [row0, row0 + 64) of one head (row stride `stride` elements)
// into a padded shared tile; rows at or past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* __restrict__ base,
                                          long long stride, int row0, int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBlockKV * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* src = valid ? base + (row0 + r) * stride + col : base;
    cp_async16(&dst[r][col], src, valid);
  }
}

// The mma A operand (16 rows x D, row-major) of one warp's rows r and r + 8
// of a shared tile, r = warp * 16 + lane / 4.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16 (*tile)[D + kPad], int r,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = *reinterpret_cast<const uint32_t*>(&tile[r][kk * 16 + 2 * t]);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(&tile[r + 8][kk * 16 + 2 * t]);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(&tile[r][kk * 16 + 8 + 2 * t]);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(&tile[r + 8][kk * 16 + 8 + 2 * t]);
  }
}

// One warp's 16 x 64 product C = A B^T, A in registers (16 x D), B a shared
// tile of 64 rows x D.  c[j] holds columns 8j..8j+7 in the mma C layout:
// c[j][0..1] row g, c[j][2..3] row g + 8, columns 2t and 2t + 1.  One
// ldmatrix.x4 brings the B operands of two 16-deep k-steps.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[kBlockKV / 8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16 (*bt)[D + kPad], int lane) {
#pragma unroll
  for (int j = 0; j < kBlockKV / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp) {
      uint32_t bk[4];
      ldmatrix_x4(bk, &bt[j * 8 + (lane & 7)][kp * 32 + (lane >> 3) * 8]);
      mma_16816(c[j], a[2 * kp], bk[0], bk[1]);
      mma_16816(c[j], a[2 * kp + 1], bk[2], bk[3]);
    }
  }
}

// One warp's 16 x 64 score tile S = (Q K^T) * scale with KV columns at or
// past n_kv set to -inf.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[kBlockKV / 8][4],
                                           const uint32_t (&qf)[D / 16][4],
                                           const __nv_bfloat16 (*ks)[D + kPad], int kv0,
                                           int n_kv, float scale, int lane) {
  mma_abt<D>(s, qf, ks, lane);
  if (kv0 + kBlockKV <= n_kv) {
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= scale;
  } else {  // the ragged last tile
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + j * 8 + 2 * t + (i & 1);
        s[j][i] = col < n_kv ? s[j][i] * scale : -CUDART_INF_F;
      }
  }
}

// acc (16 x D, C layout) += P B, P one warp's 16 x 64 f32 tile in the C
// layout (rounded to bf16 here, as the A operand), B a shared tile of 64
// rows (the k dim) x D.  One ldmatrix.x4.trans brings the B operands of two
// 8-wide n-tiles.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4], const float (&p)[kBlockKV / 8][4],
                                       const __nv_bfloat16 (*b)[D + kPad], int lane) {
#pragma unroll
  for (int kk = 0; kk < kBlockKV / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, &b[row][np * 16 + (lane >> 4) * 8]);
      mma_16816(acc[2 * np], pa, bv[0], bv[1]);
      mma_16816(acc[2 * np + 1], pa, bv[2], bv[3]);
    }
  }
}

// exp(x - m) as exp2 of a log2(e)-scaled argument, ml = m * log2(e): within
// a few f32 ulps of expf, far below the bf16 cast of P.
__device__ __forceinline__ float exp_shifted(float x, float ml) {
  return exp2f(fmaf(x, kLog2e, -ml));
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// Writes one warp's 16 x D f32 accumulator rows (row, row + 8) as bf16,
// rows at or past n_rows skipped.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base, long long stride, int row,
                                                int n_rows, int t, const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row < n_rows)
      *reinterpret_cast<uint32_t*>(base + row * stride + col) = pack_bf16(acc[n][0], acc[n][1]);
    if (row + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (row + 8) * stride + col) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sra_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ stats_m, float* __restrict__ stats_l, int heads,
                         int n_q, int n_kv, long long q_sb, long long q_sn, long long k_sb,
                         long long k_sn, long long v_sb, long long v_sn, long long o_sb,
                         long long o_sn, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockQ][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBlockKV][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBlockKV][D + kPad];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const __nv_bfloat16* qb = q + b * q_sb + h * D;
  const __nv_bfloat16* kb = k + b * k_sb + h * D;
  const __nv_bfloat16* vb = v + b * v_sb + h * D;
  __nv_bfloat16* ob = o + b * o_sb + h * D;

  const int n_tiles = (n_kv + kBlockKV - 1) / kBlockKV;
  const int n_steps = 2 * n_tiles;  // pass 1: K tiles; pass 2: K and V tiles

  // group 0: the query tile (zero-filled past n_q) and the first K tile
  load_tile<D>(qs, qb, q_sn, q0, n_q);
  load_tile<D>(ks[0], kb, k_sn, 0, n_kv);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8 of this warp
  float l[2] = {0.0f, 0.0f};
  float inv_l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
  zero_acc<D>(acc);

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const bool second = step >= n_tiles;
    const int kv0 = (second ? step - n_tiles : step) * kBlockKV;
    if (step + 1 < n_steps) {  // prefetch the next step's tiles into the other buffer
      const int next = step + 1;
      const int nkv0 = (next >= n_tiles ? next - n_tiles : next) * kBlockKV;
      load_tile<D>(ks[buf ^ 1], kb, k_sn, nkv0, n_kv);
      if (next >= n_tiles) load_tile<D>(vs[buf ^ 1], vb, v_sn, nkv0, n_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (step == 0) load_a_frags<D>(qf, qs, warp * 16 + g, t);

    float s[kBlockKV / 8][4];
    score_tile<D>(s, qf, ks[buf], kv0, n_kv, scale, lane);

    if (!second) {
      // pass 1: running row max and rescaled row sum
      float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < kBlockKV / 8; ++j) {
        tile_max[0] = fmaxf(tile_max[0], fmaxf(s[j][0], s[j][1]));
        tile_max[1] = fmaxf(tile_max[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      }
      // the first tile always holds column 0, so m is finite from here on
      const float m_new[2] = {fmaxf(m[0], tile_max[0]), fmaxf(m[1], tile_max[1])};
      const float ml[2] = {m_new[0] * kLog2e, m_new[1] * kLog2e};
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kBlockKV / 8; ++j) {
        sum[0] += exp_shifted(s[j][0], ml[0]) + exp_shifted(s[j][1], ml[0]);
        sum[1] += exp_shifted(s[j][2], ml[1]) + exp_shifted(s[j][3], ml[1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * exp_shifted(m[r], ml[r]) + sum[r];
        m[r] = m_new[r];
      }
      if (step == n_tiles - 1) {
        if (stats_m != nullptr && t == 0) {  // the residuals of the backward
          const int row = q0 + warp * 16 + g;
          float* sm = stats_m + static_cast<long long>(blockIdx.y) * n_q;
          float* sl = stats_l + static_cast<long long>(blockIdx.y) * n_q;
          if (row < n_q) { sm[row] = m[0]; sl[row] = l[0]; }
          if (row + 8 < n_q) { sm[row + 8] = m[1]; sl[row + 8] = l[1]; }
        }
        inv_l[0] = 1.0f / l[0];
        inv_l[1] = 1.0f / l[1];
        m[0] *= kLog2e;  // pass 2 needs only m * log2(e)
        m[1] *= kLog2e;
      }
    } else {
      // pass 2: P normalised in f32, cast to bf16, O += P V
#pragma unroll
      for (int j = 0; j < kBlockKV / 8; ++j) {
        s[j][0] = exp_shifted(s[j][0], m[0]) * inv_l[0];
        s[j][1] = exp_shifted(s[j][1], m[0]) * inv_l[0];
        s[j][2] = exp_shifted(s[j][2], m[1]) * inv_l[1];
        s[j][3] = exp_shifted(s[j][3], m[1]) * inv_l[1];
      }
      mma_pv<D>(acc, s, vs[buf], lane);
    }
    __syncthreads();  // the next step's prefetch overwrites this buffer
  }

  store_rows_bf16<D>(ob, o_sn, q0 + warp * 16 + g, n_q, t, acc);
}

// Backward kernel 1 (query-parallel): dQ and each row's (m log2 e, 1 / l,
// delta) for kernel 2.  Grid (ceil(n_q / 64), B * H).
template <int D>
__global__ void __launch_bounds__(kThreads)
    sra_attn_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats_m,
                    const float* __restrict__ stats_l, __nv_bfloat16* __restrict__ dq,
                    float4* __restrict__ rowstats, int heads, int n_q, int n_kv, long long q_sb,
                    long long q_sn, long long k_sb, long long k_sn, long long v_sb,
                    long long v_sn, long long o_sb, long long o_sn, long long do_sb,
                    long long do_sn, long long dq_sb, long long dq_sn, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockQ][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBlockKV][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBlockKV][D + kPad];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const __nv_bfloat16* qb = q + b * q_sb + h * D;
  const __nv_bfloat16* kb = k + b * k_sb + h * D;
  const __nv_bfloat16* vb = v + b * v_sb + h * D;
  const __nv_bfloat16* ob = o + b * o_sb + h * D;
  const __nv_bfloat16* dob = dout + b * do_sb + h * D;
  const int n_tiles = (n_kv + kBlockKV - 1) / kBlockKV;

  // prologue: the Q tile, the dO and O tiles (in the second K/V buffers,
  // free until step 0 prefetches into them) and the first K and V tiles
  load_tile<D>(qs, qb, q_sn, q0, n_q);
  load_tile<D>(ks[1], dob, do_sn, q0, n_q);
  load_tile<D>(vs[1], ob, o_sn, q0, n_q);
  load_tile<D>(ks[0], kb, k_sn, 0, n_kv);
  load_tile<D>(vs[0], vb, v_sn, 0, n_kv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r = warp * 16 + g;
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags<D>(qf, qs, r, t);
  load_a_frags<D>(dof, ks[1], r, t);
  float delta[2], ml[2], il[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    // delta = rowsum(dO * O) in f32: each of the group's 4 lanes sums D / 4
    float sum = 0.0f;
#pragma unroll
    for (int c = t * (D / 4); c < (t + 1) * (D / 4); ++c)
      sum += __bfloat162float(ks[1][r + 8 * rr][c]) * __bfloat162float(vs[1][r + 8 * rr][c]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[rr] = sum;
    const int row = q0 + r + 8 * rr;
    ml[rr] = 0.0f;
    il[rr] = 0.0f;
    if (row < n_q) {
      const long long at = static_cast<long long>(bh) * n_q + row;
      ml[rr] = stats_m[at] * kLog2e;  // as the forward's pass 2 forms them
      il[rr] = 1.0f / stats_l[at];
      if (t == 0) rowstats[at] = make_float4(ml[rr], il[rr], delta[rr], 0.0f);
    }
  }
  __syncthreads();  // step 0 prefetches into the buffers dO and O were in

  float acc[D / 8][4];
  zero_acc<D>(acc);
  for (int step = 0; step < n_tiles; ++step) {
    const int buf = step & 1;
    const int kv0 = step * kBlockKV;
    if (step + 1 < n_tiles) {
      load_tile<D>(ks[buf ^ 1], kb, k_sn, kv0 + kBlockKV, n_kv);
      load_tile<D>(vs[buf ^ 1], vb, v_sn, kv0 + kBlockKV, n_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kBlockKV / 8][4], dp[kBlockKV / 8][4];
    score_tile<D>(s, qf, ks[buf], kv0, n_kv, scale, lane);  // pad columns: -inf, so P = 0
    mma_abt<D>(dp, dof, vs[buf], lane);                     // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp_shifted(s[j][i], ml[i >> 1]) * il[i >> 1];
        dp[j][i] = p * (dp[j][i] - delta[i >> 1]) * scale;  // dS, rounded to bf16 in mma_pv
      }
    mma_pv<D>(acc, dp, ks[buf], lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows_bf16<D>(dq + b * dq_sb + h * D, dq_sn, q0 + r, n_q, t, acc);
}

// Copies the row statistics of query rows [row0, row0 + 64) into shared
// memory; rows at or past n_q are zero-filled (so P = 0 there).
__device__ __forceinline__ void load_rowstats(float4* dst, const float4* __restrict__ src,
                                              int row0, int n_q) {
  const int r = threadIdx.x;
  if (r < kBlockQ) {
    const bool valid = row0 + r < n_q;
    cp_async16(&dst[r], valid ? src + row0 + r : src, valid);
  }
}

// Backward kernel 2 (KV-parallel): f32 partial dK and dV of one 64-row K/V
// tile over one chunk of query tiles.  Grid (ceil(n_kv / 64), B * H,
// chunks); partial is [chunks, 2, B * H, n_kv, D] (dK, then dV).
template <int D>
__global__ void __launch_bounds__(kThreads)
    sra_attn_bwd_dkv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float4* __restrict__ rowstats, float* __restrict__ partial, int heads,
                     int n_q, int n_kv, int tiles_per_chunk, long long q_sb, long long q_sn,
                     long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                     long long do_sb, long long do_sn, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[2][kBlockQ][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 dos[2][kBlockQ][D + kPad];
  __shared__ __align__(16) float4 rs[2][kBlockQ];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kv0 = blockIdx.x * kBlockKV;
  const __nv_bfloat16* qb = q + b * q_sb + h * D;
  const __nv_bfloat16* kb = k + b * k_sb + h * D;
  const __nv_bfloat16* vb = v + b * v_sb + h * D;
  const __nv_bfloat16* dob = dout + b * do_sb + h * D;
  const float4* rsb = rowstats + static_cast<long long>(bh) * n_q;
  const int q_tiles = (n_q + kBlockQ - 1) / kBlockQ;
  const int tile0 = blockIdx.z * tiles_per_chunk;
  const int n_steps = min(q_tiles - tile0, tiles_per_chunk);

  // prologue: this block's K and V tiles (in the second buffers, read into
  // registers before step 0 prefetches there), the first Q and dO tiles
  load_tile<D>(qs[1], kb, k_sn, kv0, n_kv);
  load_tile<D>(dos[1], vb, v_sn, kv0, n_kv);
  load_tile<D>(qs[0], qb, q_sn, tile0 * kBlockQ, n_q);
  load_tile<D>(dos[0], dob, do_sn, tile0 * kBlockQ, n_q);
  load_rowstats(rs[0], rsb, tile0 * kBlockQ, n_q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r = warp * 16 + g;  // this warp's K/V rows r and r + 8 of the tile
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, qs[1], r, t);
  load_a_frags<D>(vf, dos[1], r, t);
  __syncthreads();

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
  zero_acc<D>(acc_dk);
  zero_acc<D>(acc_dv);
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) {
      const int nq0 = (tile0 + step + 1) * kBlockQ;
      load_tile<D>(qs[buf ^ 1], qb, q_sn, nq0, n_q);
      load_tile<D>(dos[buf ^ 1], dob, do_sn, nq0, n_q);
      load_rowstats(rs[buf ^ 1], rsb, nq0, n_q);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T * scale: rows are this warp's K rows, columns query rows
    float s[kBlockQ / 8][4], dp[kBlockQ / 8][4];
    score_tile<D>(s, kf, qs[buf], 0, kBlockQ, scale, lane);
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 st = rs[buf][j * 8 + 2 * t + (i & 1)];
        s[j][i] = exp_shifted(s[j][i], st.x) * st.y;  // P^T
      }
    mma_pv<D>(acc_dv, s, dos[buf], lane);  // dV += P_lo^T dO
    mma_abt<D>(dp, vf, dos[buf], lane);    // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float delta = rs[buf][j * 8 + 2 * t + (i & 1)].z;
        dp[j][i] = s[j][i] * (dp[j][i] - delta) * scale;  // dS^T
      }
    mma_pv<D>(acc_dk, dp, qs[buf], lane);  // dK += dS^T Q
    __syncthreads();
  }

  const long long n_bh = static_cast<long long>(gridDim.y);
  float* pk = partial + ((static_cast<long long>(blockIdx.z) * 2 * n_bh + bh) * n_kv) * D;
  float* pv = pk + n_bh * n_kv * D;
  const int row = kv0 + r;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row < n_kv) {
      *reinterpret_cast<float2*>(pk + row * D + col) = make_float2(acc_dk[n][0], acc_dk[n][1]);
      *reinterpret_cast<float2*>(pv + row * D + col) = make_float2(acc_dv[n][0], acc_dv[n][1]);
    }
    if (row + 8 < n_kv) {
      *reinterpret_cast<float2*>(pk + (row + 8) * D + col) = make_float2(acc_dk[n][2], acc_dk[n][3]);
      *reinterpret_cast<float2*>(pv + (row + 8) * D + col) = make_float2(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

// Backward kernel 3: sums the chunks' partials in chunk order and writes dK
// and dV as bf16 through their batch and row strides.
template <int D>
__global__ void __launch_bounds__(256)
    sra_attn_bwd_reduce(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int heads, int n_bh, int n_kv, int chunks,
                        long long sb, long long sn) {
  const long long pairs = static_cast<long long>(n_bh) * n_kv * D / 2;
  const long long plane = static_cast<long long>(n_bh) * n_kv * D;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < pairs;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = 2 * i;
    const int d = static_cast<int>(e % D);
    const int row = static_cast<int>((e / D) % n_kv);
    const int bh = static_cast<int>(e / (static_cast<long long>(D) * n_kv));
    const int b = bh / heads, h = bh % heads;
    float2 sk = make_float2(0.0f, 0.0f), sv = make_float2(0.0f, 0.0f);
    for (int c = 0; c < chunks; ++c) {
      const float2 pk = *reinterpret_cast<const float2*>(partial + 2 * c * plane + e);
      const float2 pv = *reinterpret_cast<const float2*>(partial + (2 * c + 1) * plane + e);
      sk.x += pk.x;
      sk.y += pk.y;
      sv.x += pv.x;
      sv.y += pv.y;
    }
    const long long at = b * sb + row * sn + h * D + d;
    *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(sk.x, sk.y);
    *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(sv.x, sv.y);
  }
}

template <int D>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* stats_m,
               const float* stats_l, __nv_bfloat16* dq, float4* rowstats, float* partial,
               __nv_bfloat16* dk, __nv_bfloat16* dv, int batch, int heads, int n_q, int n_kv,
               int tiles_per_chunk, long long q_sb, long long q_sn, long long k_sb,
               long long k_sn, long long v_sb, long long v_sn, long long o_sb, long long o_sn,
               long long do_sb, long long do_sn, long long dq_sb, long long dq_sn,
               long long dkv_sb, long long dkv_sn, float scale, cudaStream_t s) {
  const int n_bh = batch * heads;
  const int q_tiles = (n_q + kBlockQ - 1) / kBlockQ;
  const int chunks = (q_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  sra_attn_bwd_dq<D><<<dim3(q_tiles, n_bh), kThreads, 0, s>>>(
      q, k, v, o, dout, stats_m, stats_l, dq, rowstats, heads, n_q, n_kv, q_sb, q_sn, k_sb, k_sn,
      v_sb, v_sn, o_sb, o_sn, do_sb, do_sn, dq_sb, dq_sn, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sra_attn_bwd_dkv<D><<<dim3((n_kv + kBlockKV - 1) / kBlockKV, n_bh, chunks), kThreads, 0, s>>>(
      q, k, v, dout, rowstats, partial, heads, n_q, n_kv, tiles_per_chunk, q_sb, q_sn, k_sb, k_sn,
      v_sb, v_sn, do_sb, do_sn, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = static_cast<long long>(n_bh) * n_kv * D / 2;
  const int blocks = static_cast<int>((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  sra_attn_bwd_reduce<D><<<blocks, 256, 0, s>>>(partial, dk, dv, heads, n_bh, n_kv, chunks,
                                                 dkv_sb, dkv_sn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sra_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* stats_m, void* stats_l, int batch, int heads, int n_q,
                                 int n_kv, int head_dim, long long q_sb, long long q_sn,
                                 long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                                 long long o_sb, long long o_sn, float scale, void* stream) {
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, batch * heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* mp = static_cast<float*>(stats_m);
  auto* lp = static_cast<float*>(stats_l);
  if (head_dim == 64) {
    sra_attention_kernel<64><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, mp, lp, heads, n_q, n_kv,
                                                        q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb,
                                                        o_sn, scale);
  } else if (head_dim == 32) {
    sra_attention_kernel<32><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, mp, lp, heads, n_q, n_kv,
                                                        q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb,
                                                        o_sn, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dq [B, N_q, H, D] and the dk, dv halves of d(kv) are written; rowstats
// (f32 [B*H, N_q, 4]) and partial (f32 [chunks, 2, B*H, N_kv, D], chunks =
// ceil(ceil(N_q / 64) / tiles_per_chunk)) are the caller's scratch.
extern "C" int sra_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* stats_m, const void* stats_l,
                                 void* dq, void* rowstats, void* partial, void* dk, void* dv,
                                 int batch, int heads, int n_q, int n_kv, int head_dim,
                                 int tiles_per_chunk, long long q_sb, long long q_sn,
                                 long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                                 long long o_sb, long long o_sn, long long do_sb, long long do_sn,
                                 long long dq_sb, long long dq_sn, long long dkv_sb,
                                 long long dkv_sn, float scale, void* stream) {
  if (tiles_per_chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(o);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* mp = static_cast<const float*>(stats_m);
  const auto* lp = static_cast<const float*>(stats_l);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* rsp = static_cast<float4*>(rowstats);
  auto* pp = static_cast<float*>(partial);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_bwd<64>(qp, kp, vp, op, dop, mp, lp, dqp, rsp, pp, dkp, dvp, batch, heads, n_q,
                          n_kv, tiles_per_chunk, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                          do_sb, do_sn, dq_sb, dq_sn, dkv_sb, dkv_sn, scale, s);
  if (head_dim == 32)
    return launch_bwd<32>(qp, kp, vp, op, dop, mp, lp, dqp, rsp, pp, dkp, dvp, batch, heads, n_q,
                          n_kv, tiles_per_chunk, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                          do_sb, do_sn, dq_sb, dq_sn, dkv_sb, dkv_sn, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
