// SRA attention forward for Hopper (sm_90a): SegFormer's spatial-reduction
// attention, O = softmax(Q K^T * D^-1/2) V, one head at a time.  Built by
// hiast_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with a plain C interface, loaded with ctypes.  No
// --use_fast_math: the exponentials (exp2f) and the softmax keep full float
// accuracy.
//
// Replaces hiast_tpu/ops/pallas/attention.py:_attn_fwd_kernel (the forward
// of sra_attention; its reference math is sra_attention_reference).
//
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
// one f32 ulp, far below the bf16 cast that follows.
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
// The launcher runs on the caller's stream, never synchronises, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block, 16 per warp
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

// One warp's 16 x 64 score tile S = (Q K^T) * scale with KV columns at or
// past n_kv set to -inf.  s[j] holds columns 8j..8j+7 in the mma C layout:
// s[j][0..1] row g, s[j][2..3] row g + 8, columns 2t and 2t + 1.  One
// ldmatrix.x4 brings the K operands of two 16-deep k-steps.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[kBlockKV / 8][4],
                                           const uint32_t (&qf)[D / 16][4],
                                           const __nv_bfloat16 (*ks)[D + kPad], int kv0,
                                           int n_kv, float scale, int lane) {
#pragma unroll
  for (int j = 0; j < kBlockKV / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp) {
      uint32_t bk[4];
      ldmatrix_x4(bk, &ks[j * 8 + (lane & 7)][kp * 32 + (lane >> 3) * 8]);
      mma_16816(s[j], qf[2 * kp], bk[0], bk[1]);
      mma_16816(s[j], qf[2 * kp + 1], bk[2], bk[3]);
    }
  }
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

// exp(x - m) as exp2 of a log2(e)-scaled argument, ml = m * log2(e): within
// a few f32 ulps of expf, far below the bf16 cast of P.
__device__ __forceinline__ float exp_shifted(float x, float ml) {
  return exp2f(fmaf(x, kLog2e, -ml));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sra_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         int heads, int n_q, int n_kv, long long q_sb, long long q_sn,
                         long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                         long long o_sb, long long o_sn, float scale) {
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
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

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

    if (step == 0) {
      const int r = warp * 16 + g;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(&qs[r][kk * 16 + 2 * t]);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(&qs[r + 8][kk * 16 + 2 * t]);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(&qs[r][kk * 16 + 8 + 2 * t]);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(&qs[r + 8][kk * 16 + 8 + 2 * t]);
      }
    }

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
        inv_l[0] = 1.0f / l[0];
        inv_l[1] = 1.0f / l[1];
        m[0] *= kLog2e;  // pass 2 needs only m * log2(e)
        m[1] *= kLog2e;
      }
    } else {
      // pass 2: P normalised in f32, cast to bf16, O += P V
#pragma unroll
      for (int kk = 0; kk < kBlockKV / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(exp_shifted(s[2 * kk][0], m[0]) * inv_l[0],
                          exp_shifted(s[2 * kk][1], m[0]) * inv_l[0]);
        pa[1] = pack_bf16(exp_shifted(s[2 * kk][2], m[1]) * inv_l[1],
                          exp_shifted(s[2 * kk][3], m[1]) * inv_l[1]);
        pa[2] = pack_bf16(exp_shifted(s[2 * kk + 1][0], m[0]) * inv_l[0],
                          exp_shifted(s[2 * kk + 1][1], m[0]) * inv_l[0]);
        pa[3] = pack_bf16(exp_shifted(s[2 * kk + 1][2], m[1]) * inv_l[1],
                          exp_shifted(s[2 * kk + 1][3], m[1]) * inv_l[1]);
        // one ldmatrix.x4.trans brings the V operands of two 8-wide n-tiles
        const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, &vs[buf][vrow][np * 16 + (lane >> 4) * 8]);
          mma_16816(acc[2 * np], pa, bv[0], bv[1]);
          mma_16816(acc[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the next step's prefetch overwrites this buffer
  }

  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row < n_q)
      *reinterpret_cast<uint32_t*>(ob + row * o_sn + col) = pack_bf16(acc[n][0], acc[n][1]);
    if (row + 8 < n_q)
      *reinterpret_cast<uint32_t*>(ob + (row + 8) * o_sn + col) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

}  // namespace

extern "C" int sra_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                 int heads, int n_q, int n_kv, int head_dim, long long q_sb,
                                 long long q_sn, long long k_sb, long long k_sn, long long v_sb,
                                 long long v_sn, long long o_sb, long long o_sn, float scale,
                                 void* stream) {
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, batch * heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (head_dim == 64) {
    sra_attention_kernel<64><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, heads, n_q, n_kv, q_sb,
                                                        q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                                                        scale);
  } else if (head_dim == 32) {
    sra_attention_kernel<32><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, heads, n_q, n_kv, q_sb,
                                                        q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn,
                                                        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
