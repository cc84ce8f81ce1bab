// SRA attention for Hopper (sm_90a): SegFormer's spatial-reduction
// attention, O = softmax(Q K^T * D^-1/2) V, one head at a time, and its
// backward.  Built by hiast_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with a plain C interface, loaded with ctypes.  No
// --use_fast_math: the softmax keeps f32 throughout, and the exponentials
// are the MUFU's ex2.approx (within 2 ulps, as exp2f).  No -lcuda either:
// cuTensorMapEncodeTiled, the one libcuda function used, comes through
// cudaGetDriverEntryPoint.
//
// Replaces hiast_tpu/ops/pallas/attention.py:_attn_fwd_kernel (the forward
// of sra_attention; its reference math is sra_attention_reference) with
// sra_attn_fwd, and :_attn_bwd_kernel (the backward of its custom VJP, via
// _bwd_pallas) with sra_attn_bwd_dq, sra_attn_bwd_dkv and, where the query
// range is cut into chunks, sra_attn_bwd_reduce.
//
// ------------------------------------------------------------ the machine
// Every kernel has one shape.  A persistent grid of one block per SM (at
// most one per work item) walks the work items in a fixed stride, so a
// stage whose items are not a multiple of 132 loses at most one round
// (serving stage 3: 240 items of the forward, 1.82 rounds, where 128-row
// blocks four to an SM ran 1.36 waves).  A block is 2 or 3 consumer
// warpgroups and one producer warpgroup, of which one thread works: it
// issues TMA loads of whole tiles into rings of shared-memory stages, each
// with a `full` mbarrier (the TMA's byte count) and an `empty` one (one
// arrival per consumer warp).  TMA rather than a cp.async ring: one thread
// per block moves every byte, the swizzle is the hardware's, rows past N
// read as zeros (no ragged-edge code), and the tensor maps cost one host
// call each per launch.  They read q, k, v, dO in place as 4-D maps over
// [B, N, H, D] with the caller's batch and row strides (the kv halves at
// row stride 2HD), with the 128-byte swizzle (D = 64; 64-byte at D = 32).
// The consumers run wgmma.mma_async m64nNk16 bf16 -> f32: both operands of
// a Q K^T-type product come from shared memory (K-major), and every product
// whose A is a softmax-shaped tile (P, dS) takes it from registers -- the
// f32 accumulator fragment, rounded to bf16 pairs, is the A fragment --
// with B from shared memory, MN-major.  So a K or V tile read from L2
// serves 128 or 192 rows, and each wgmma reads its B tile once for 64 rows,
// where a warp-level MMA reads it once per 16: a quarter of the
// shared-memory bytes per FLOP.  ptxas budgets a 384-thread block at 168
// registers a thread and a 512-thread one at 128; setmaxnreg moves the
// producer warpgroup's registers to the consumers (232 each with two, 160
// with three), which the dK/dV kernel needs for its four accumulators.
// Built with -DSRA_PROF, the forward also counts clock64 cycles by phase
// (scripts/profile_sra_attention.py reads them).
//
// ---------------------------------------------------------------- forward
// Rounding points, as the JAX kernel has them: S = Q K^T in f32 from bf16
// products, scaled in f32 (q is never pre-scaled in bf16), pad KV columns
// set to -inf, P = exp(S - max) / sum normalised in f32 BEFORE it is cast to
// bf16, O = P V accumulated in f32 and cast to bf16 once.  A one-pass online
// softmax would cast the unnormalised exp and divide at the end, which
// rounds at another place.  So each query tile makes two passes over the K
// tiles: the first takes each row's max m and sum l = sum exp(s - m)
// (rescaled online as m grows), the second recomputes S, forms p = exp(s -
// m) * (1 / l), casts p to bf16 and accumulates P V.  Under autograd the
// first pass also writes m and l per row as f32 [B*H, N_q]; the serving
// path passes null pointers and writes nothing.
//
// Work item: 192 query rows of one (batch, head), 64 per warpgroup; the
// producer streams 128-row K tiles (pass 1), then K and V tiles (pass 2),
// four stages deep, and double-buffers Q so the next item's Q is in flight
// while this one finishes.  At N_kv = 1152 (every MiT stage at 768x1536)
// K + V of one head do not fit in shared memory, so they stream twice
// rather than stay resident as on the TPU.  In pass 2 each step issues S of
// tile j and P V of tile j - 1 together and forms P of tile j while P V
// runs; the three warpgroups run unsynchronised, so one's exponentials
// overlap another's products.
//
// Bound on an H100 SXM: per (batch, head) the algorithm needs 4 N_q N_kv D
// matmul FLOPs and N_q N_kv exponentials against 4 (N_q + N_kv) D bytes.
// This design does 6 N_q N_kv D (QK^T twice) and 2 N_q N_kv exponentials,
// at 16 per SM per clock on the MUFU: about 1.5 ms per serving batch of 2
// at 768x1536, above the matmuls' 1.25 ms at the bf16 peak.  The MUFU is
// the wall; an FMA-pipe polynomial for a share of the exponentials did not
// move the time, since the other softmax instructions share the issue slots.
//
// --------------------------------------------------------------- backward
// The JAX kernel recomputes P, then dV = P_lo^T dO (P_lo = bf16(P)),
// dP = dO V^T in f32, delta = rowsum(P * dP), dS = bf16(P * (dP - delta) *
// scale), dQ = dS K and dK = dS^T Q, all accumulated in f32 and cast to the
// input dtype.  Its grid runs the query tiles of one head in order and adds
// each tile's dK/dV into one VMEM block.  Hopper blocks run in parallel and
// in no order, so the work is split by what each output is a sum over:
//
//   1. sra_attn_bwd_dq: query-parallel, 128 query rows per work item.  The
//      producer brings Q and dO (double-buffered), then 64-row K and V
//      tiles.  The consumers rebuild P = exp(s - m) / l from the forward's
//      row statistics, form S = Q K^T and dP = dO V^T (shared x shared),
//      dS in registers, and accumulate dQ += dS K (K MN-major).  They also
//      write each row's (m log2 e, 1 / l, delta) for kernel 2.
//   2. sra_attn_bwd_dkv: KV-parallel, 128 K/V rows per work item (64 per
//      warpgroup, held in shared memory) over a range of query tiles that
//      stream in as 64-row Q, dO and row-statistics stages: S^T = K Q^T and
//      dP^T = V dO^T (shared x shared), P^T and dS^T in registers, dV +=
//      P_lo^T dO and dK += dS^T Q (registers x shared).  Where the 64-row
//      K/V tiles of all heads fill the card (a training step's stages 3 and
//      4), one range covers all query tiles and dK, dV are written as bf16
//      straight into the two halves of d(kv).  Where they do not (stages 1
//      and 2: 48 and 96 tiles for 132 SMs), the query range is cut into
//      chunks that write f32 partials, and
//   3. sra_attn_bwd_reduce adds the partials in chunk order and writes d(kv).
//   Every sum runs in a fixed order: no atomics, the same bits every call.
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
// nothing (the wrapper passes the scratch buffers), and return a CUDA error
// code (cudaErrorInvalidValue when a tensor map cannot be encoded).

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifdef SRA_PROF
// The forward's cycles by phase, summed over the first two warpgroups of
// every block (thread 0 of each): pass 1 waiting for K, its S product, its
// softmax; pass 2 waiting for K and V, issuing S and P V and waiting for S,
// the exponentials, waiting for P V; [8] the whole kernel, [9] the count of
// warpgroups summed.  sra_prof_read copies them out and zeroes them.
__device__ unsigned long long g_prof[16];
extern "C" int sra_prof_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  const unsigned long long zeros[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros)));
}
#define PROF_T(var) const long long var = clock64()
#define PROF_ADD(i, a, b) prof[i] += (b) - (a)
#else
#define PROF_T(var)
#define PROF_ADD(i, a, b)
#endif

namespace {

constexpr int kWgRows = 64;  // rows of one warpgroup's wgmma tile

// A block of WGS consumer warpgroups and one producer warpgroup (one warp
// of it works).  setmaxnreg moves registers from the producer to the
// consumers: WGS * 128 * consumer_regs + 128 * producer_regs <= 64 K.
template <int WGS>
struct Block {
  static constexpr int kConsumerWarps = 4 * WGS;  // arrivals that free a buffer
  static constexpr int kThreads = 128 * WGS + 128;
  static constexpr int kRows = WGS * kWgRows;     // query rows (forward, dQ) or K/V rows (dK/dV) per item
  static constexpr int kProducerRegs = WGS == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = WGS == 2 ? 232 : 160;
};
constexpr int kFwdWGs = 3;  // the forward: 192 query rows per K/V tile read
constexpr int kBwdWGs = 2;  // the backward kernels, whose accumulators need 232 registers
constexpr int kConsumerWarps = Block<kBwdWGs>::kConsumerWarps;
constexpr int kThreads = Block<kBwdWGs>::kThreads;
constexpr int kBlockRows = Block<kBwdWGs>::kRows;  // query rows (dQ) or K/V rows (dK/dV) per item
constexpr int kFwdKV = 128;                          // K/V rows per forward stage
constexpr int kBwdTile = 64;                         // K/V rows per dQ stage, query rows per dK/dV stage
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The producer's arrival on a `full` barrier, announcing the TMA bytes it waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One tile of a [B, N, H, D] tensor: rows row0.. of head h of batch b.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(row0), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// Rows row0.. of the f32 [B*H, N_q, 4] row statistics of head bh.
__device__ __forceinline__ void tma_rowstats(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int row0, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row0), "r"(bh), "r"(smem_u32(bar))
      : "memory");
}

// The wgmma descriptor of a tile of rows of D bf16 as TMA wrote it (128-byte
// swizzle at D = 64, 64-byte at D = 32): 8-row groups 8 * 2D bytes apart.
// The group stride goes in both offset fields: K-major reads only the stride
// one; MN-major tiles here are one swizzle atom wide (N = D), so whichever
// field strides along N is never used.  Tiles start 1024-byte aligned, so
// the base offset is 0.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t kGroup = (8 * D * 2) >> 4;  // 16-byte units
  constexpr uint64_t kLayout = D == 64 ? 1 : 2;  // 128-byte or 64-byte swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) | (kGroup << 32) |
         (kLayout << 62);
}

// Hands registers from the producer warpgroup to the consumers.  ptxas
// budgets a 384-thread block at 168 registers a thread and a 512-thread one
// at 128; the consumers need more, the producer far fewer.
template <int WGS = kBwdWGs>
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Block<WGS>::kProducerRegs));
}

template <int WGS = kBwdWGs>
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Block<WGS>::kConsumerRegs));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}


// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B^T (+ d if scale_d) for one m64n64k16 step: A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A B^T (+ d if scale_d) for one m64n128k16 step: A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = A B (+ d if scale_d) for one m64n32k16 step: A from registers (bf16
// pairs in the mma A fragment layout), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d = A B (+ d if scale_d) for one m64n64k16 step: A from registers (bf16
// pairs in the mma A fragment layout), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


// --------------------------------------------------------------- helpers

// The dynamic shared memory as the kernel's storage, 1024-byte aligned (the
// 128-byte swizzle's period), with 1024 bytes of slack allocated for it.
template <class S>
__device__ __forceinline__ S& shared_storage() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t misalign = smem_u32(smem_raw) & 1023;
  return *reinterpret_cast<S*>(smem_raw + ((1024 - misalign) & 1023));
}

// Position in a ring of kStages buffers: the stage and the parity of its use.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void publish_barriers() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Issues d = A B^T over the D-deep k dim: A a 64-row tile, B a tile of
// 2 * N rows (N the accumulator's floats per thread), both as TMA wrote them.
template <int D, int N>
__device__ __forceinline__ void issue_abt(float (&d)[N], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(d, desc<D>(a + kk * 32), desc<D>(b + kk * 32), kk > 0);
}

// Issues acc += A B: A in registers as KT k-steps of 16, B the tile of
// 16 KT rows of D at b (MN-major: k runs down the rows).
template <int D, int KT>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 2], const uint32_t (&a)[KT][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) wgmma_rs(acc, a[kk], desc<D>(b + kk * 16 * D * 2), 1);
}

// Two floats rounded to bf16 in one 32-bit register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An f32 tile of NC columns in the accumulator layout (element 4j + i: row
// r + 8 (i / 2), column 8j + 2c + i % 2) as bf16 A fragments over those
// columns, 16 per k-step.
template <int NC>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[NC / 16][4], const float (&x)[NC / 2]) {
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Scales a score tile of NC columns starting at col0 in f32 and sets the
// columns at or past n_cols to -inf.
template <int NC>
__device__ __forceinline__ void scale_mask(float (&s)[NC / 2], int col0, int n_cols, float scale, int c) {
  if (col0 + NC <= n_cols) {
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) s[e] *= scale;
  } else {  // the ragged last tile
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) {
      const int col = col0 + 8 * (e >> 2) + 2 * c + (e & 1);
      s[e] = col < n_cols ? s[e] * scale : -CUDART_INF_F;
    }
  }
}

// 2^x on the MUFU in one instruction (max relative error 2^-22; results
// below 2^-126 flush to 0, far below anything a bf16 P or an f32 sum keeps).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) as exp2 of a log2(e)-scaled argument, ml = m * log2(e): within
// a few f32 ulps of expf, far below the bf16 cast of P.
__device__ __forceinline__ float exp_shifted(float x, float ml) { return exp2_approx(fmaf(x, kLog2e, -ml)); }


template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// Writes a warpgroup's 64 x D f32 accumulator as bf16: this thread's rows
// row and row + 8, those at or past n_rows skipped.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base, long long stride, int row, int n_rows,
                                                int c, const float (&acc)[D / 2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (row < n_rows)
      *reinterpret_cast<uint32_t*>(base + row * stride + col) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (row + 8) * stride + col) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------- forward

// Issues and commits S = Q K^T for one 128-row K tile (not waited for).
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kFwdKV / 2], uint32_t qa, uint32_t ka) {
  fence_acc(s);
  wgmma_fence();
  issue_abt<D>(s, qa, ka);
  wgmma_commit();
}

// Folds one scaled, masked score tile into the running row max m and sum
// l = sum exp(s - m) of this thread's rows (l rescaled as m grows).
__device__ __forceinline__ void fold_row_stats(float (&s)[kFwdKV / 2], float (&m)[2], float (&l)[2]) {
  float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int e = 0; e < kFwdKV / 2; e += 2) {
    const int rr = (e >> 1) & 1;
    tile_max[rr] = fmaxf(tile_max[rr], fmaxf(s[e], s[e + 1]));
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    tile_max[rr] = fmaxf(tile_max[rr], __shfl_xor_sync(0xffffffffu, tile_max[rr], 1));
    tile_max[rr] = fmaxf(tile_max[rr], __shfl_xor_sync(0xffffffffu, tile_max[rr], 2));
  }
  // the first tile always holds column 0, so m is finite from here on
  const float m_new[2] = {fmaxf(m[0], tile_max[0]), fmaxf(m[1], tile_max[1])};
  const float ml[2] = {m_new[0] * kLog2e, m_new[1] * kLog2e};
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < kFwdKV / 2; e += 2) {
    const int rr = (e >> 1) & 1;
    sum[rr] += exp_shifted(s[e], ml[rr]) + exp_shifted(s[e + 1], ml[rr]);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
    l[rr] = l[rr] * exp_shifted(m[rr], ml[rr]) + sum[rr];
    m[rr] = m_new[rr];
  }
}

// P = exp(s - m) * (1 / l) in f32 for one scaled, masked score tile, in place.
__device__ __forceinline__ void normalised_exp(float (&s)[kFwdKV / 2], const float (&ml)[2], const float (&inv_l)[2]) {
#pragma unroll
  for (int e = 0; e < kFwdKV / 2; ++e) {
    const int rr = (e >> 1) & 1;
    s[e] = exp_shifted(s[e], ml[rr]) * inv_l[rr];
  }
}

template <int D>
struct FwdShared {
  __nv_bfloat16 q[2][Block<kFwdWGs>::kRows * D];
  __nv_bfloat16 k[kStages][kFwdKV * D];
  __nv_bfloat16 v[kStages][kFwdKV * D];
  uint64_t q_full[2], q_empty[2], full[kStages], empty[kStages];
};

// Work item w: query rows [192 (w % q_tiles), +192) of head w / q_tiles.
template <int D>
__global__ void __launch_bounds__(Block<kFwdWGs>::kThreads, 1)
    sra_attn_fwd(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ stats_m, float* __restrict__ stats_l, int heads, int n_bh, int n_q,
                 int n_kv, long long o_sb, long long o_sn, float scale) {
  using Blk = Block<kFwdWGs>;
  constexpr int kBlockRows = Blk::kRows, kConsumerWarps = Blk::kConsumerWarps;
  auto& sm = shared_storage<FwdShared<D>>();
  const int q_tiles = (n_q + kBlockRows - 1) / kBlockRows;
  const int kv_tiles = (n_kv + kFwdKV - 1) / kFwdKV;
  const int n_work = q_tiles * n_bh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], kConsumerWarps);
    }
    publish_barriers();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: Q per item, then K tiles, then K and V tiles
    producer_registers<kFwdWGs>();
    if (warp != kConsumerWarps || lane != 0) return;
    constexpr uint32_t kTileBytes = kFwdKV * D * 2;
    Ring ring;
    uint32_t it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      const int bh = w / q_tiles, b = bh / heads, h = bh % heads;
      const int qb = it & 1;
      mbar_wait(&sm.q_empty[qb], ((it >> 1) & 1) ^ 1);
      mbar_expect_tx(&sm.q_full[qb], kBlockRows * D * 2);
      tma_rows(sm.q[qb], &q_map, &sm.q_full[qb], h, (w % q_tiles) * kBlockRows, b);
      for (int step = 0; step < 2 * kv_tiles; ++step, ring.next()) {
        const bool second = step >= kv_tiles;
        const int kv0 = (second ? step - kv_tiles : step) * kFwdKV;
        mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
        mbar_expect_tx(&sm.full[ring.stage], second ? 2 * kTileBytes : kTileBytes);
        tma_rows(sm.k[ring.stage], &k_map, &sm.full[ring.stage], h, kv0, b);
        if (second) tma_rows(sm.v[ring.stage], &v_map, &sm.full[ring.stage], h, kv0, b);
      }
    }
    return;
  }

  consumer_registers<kFwdWGs>();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's rows r and r + 8 of its warpgroup's 64
  const int c = lane % 4;
#ifdef SRA_PROF
  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t_start = clock64();
#endif
  Ring ring;
  uint32_t it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
    const int bh = w / q_tiles, b = bh / heads, h = bh % heads;
    const int q0 = (w % q_tiles) * kBlockRows + wg * kWgRows;
    const int qb = it & 1;
    mbar_wait(&sm.q_full[qb], (it >> 1) & 1);
    const uint32_t qa = smem_u32(sm.q[qb] + wg * kWgRows * D);

    // pass 1: running row max and rescaled row sum
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.0f, 0.0f};
    float s[kFwdKV / 2];
    for (int j = 0; j < kv_tiles; ++j, ring.next()) {
      PROF_T(t0);
      mbar_wait(&sm.full[ring.stage], ring.phase);
      PROF_T(t1);
      issue_scores<D>(s, qa, smem_u32(sm.k[ring.stage]));
      wgmma_wait<0>();
      fence_acc(s);
      PROF_T(t2);
      if (lane == 0) mbar_arrive(&sm.empty[ring.stage]);
      scale_mask<kFwdKV>(s, j * kFwdKV, n_kv, scale, c);
      fold_row_stats(s, m, l);
      PROF_T(t3);
      PROF_ADD(0, t0, t1); PROF_ADD(1, t1, t2); PROF_ADD(2, t2, t3);
    }
    if (stats_m != nullptr && c == 0) {  // the residuals of the backward
      float* sm_row = stats_m + static_cast<long long>(bh) * n_q;
      float* sl_row = stats_l + static_cast<long long>(bh) * n_q;
      if (q0 + r < n_q) {
        sm_row[q0 + r] = m[0];
        sl_row[q0 + r] = l[0];
      }
      if (q0 + r + 8 < n_q) {
        sm_row[q0 + r + 8] = m[1];
        sl_row[q0 + r + 8] = l[1];
      }
    }
    const float inv_l[2] = {1.0f / l[0], 1.0f / l[1]};
    const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};

    // pass 2: P normalised in f32, cast to bf16, O += P V.  Each step issues
    // S of tile j and P V of tile j - 1, and forms P of tile j while the
    // tensor cores run P V.
    float acc[D / 2];
    zero(acc);
    uint32_t pf[kFwdKV / 16][4];
    mbar_wait(&sm.full[ring.stage], ring.phase);
    issue_scores<D>(s, qa, smem_u32(sm.k[ring.stage]));
    wgmma_wait<0>();
    fence_acc(s);
    if (kv_tiles == 1 && lane == 0) mbar_arrive(&sm.q_empty[qb]);  // Q is read no more
    scale_mask<kFwdKV>(s, 0, n_kv, scale, c);
    normalised_exp(s, ml, inv_l);
    to_a_frags<kFwdKV>(pf, s);
    int prev = ring.stage;
    ring.next();
    for (int j = 1; j < kv_tiles; ++j, ring.next()) {
      PROF_T(t0);
      mbar_wait(&sm.full[ring.stage], ring.phase);
      PROF_T(t1);
      issue_scores<D>(s, qa, smem_u32(sm.k[ring.stage]));
      fence_acc(acc);
      issue_ab<D>(acc, pf, smem_u32(sm.v[prev]));
      wgmma_commit();
      wgmma_wait<1>();  // S of tile j is in; P V of tile j - 1 may run on
      fence_acc(s);
      PROF_T(t2);
      if (j == kv_tiles - 1 && lane == 0) mbar_arrive(&sm.q_empty[qb]);
      scale_mask<kFwdKV>(s, j * kFwdKV, n_kv, scale, c);
      normalised_exp(s, ml, inv_l);
      PROF_T(t3);
      wgmma_wait<0>();  // P V of tile j - 1 is done with pf and with its stage
      fence_acc(acc);
      PROF_T(t4);
      PROF_ADD(3, t0, t1); PROF_ADD(4, t1, t2); PROF_ADD(5, t2, t3); PROF_ADD(6, t3, t4);
      if (lane == 0) mbar_arrive(&sm.empty[prev]);
      to_a_frags<kFwdKV>(pf, s);
      prev = ring.stage;
    }
    fence_acc(acc);
    wgmma_fence();
    issue_ab<D>(acc, pf, smem_u32(sm.v[prev]));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    store_rows_bf16<D>(o + b * o_sb + h * D, o_sn, q0 + r, n_q, c, acc);
  }
#ifdef SRA_PROF
  if (threadIdx.x == 0 || threadIdx.x == 128) {
    for (int i = 0; i < 7; ++i) atomicAdd(&g_prof[i], static_cast<unsigned long long>(prof[i]));
    atomicAdd(&g_prof[8], static_cast<unsigned long long>(clock64() - t_start));
    atomicAdd(&g_prof[9], 1ull);
  }
#endif
}

// --------------------------------------------------------------- backward

template <int D>
struct DqShared {
  __nv_bfloat16 q[2][kBlockRows * D];
  __nv_bfloat16 dout[2][kBlockRows * D];
  __nv_bfloat16 k[kStages][kBwdTile * D];
  __nv_bfloat16 v[kStages][kBwdTile * D];
  uint64_t q_full[2], q_empty[2], full[kStages], empty[kStages];
};

// Backward kernel 1 (query-parallel): dQ and each row's (m log2 e, 1 / l,
// delta) for kernel 2.  Work item w: query rows [128 (w % q_tiles), +128)
// of head w / q_tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    sra_attn_bwd_dq(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ stats_m, const float* __restrict__ stats_l,
                    __nv_bfloat16* __restrict__ dq, float4* __restrict__ rowstats, int heads, int n_bh,
                    int n_q, int n_kv, long long o_sb, long long o_sn, long long do_sb, long long do_sn,
                    long long dq_sb, long long dq_sn, float scale) {
  auto& sm = shared_storage<DqShared<D>>();
  const int q_tiles = (n_q + kBlockRows - 1) / kBlockRows;
  const int kv_tiles = (n_kv + kBwdTile - 1) / kBwdTile;
  const int n_work = q_tiles * n_bh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], kConsumerWarps);
    }
    publish_barriers();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: Q and dO per item, then K and V tiles
    producer_registers();
    if (warp != kConsumerWarps || lane != 0) return;
    Ring ring;
    uint32_t it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      const int bh = w / q_tiles, b = bh / heads, h = bh % heads;
      const int qb = it & 1;
      mbar_wait(&sm.q_empty[qb], ((it >> 1) & 1) ^ 1);
      mbar_expect_tx(&sm.q_full[qb], 2 * kBlockRows * D * 2);
      tma_rows(sm.q[qb], &q_map, &sm.q_full[qb], h, (w % q_tiles) * kBlockRows, b);
      tma_rows(sm.dout[qb], &do_map, &sm.q_full[qb], h, (w % q_tiles) * kBlockRows, b);
      for (int j = 0; j < kv_tiles; ++j, ring.next()) {
        mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
        mbar_expect_tx(&sm.full[ring.stage], 2 * kBwdTile * D * 2);
        tma_rows(sm.k[ring.stage], &k_map, &sm.full[ring.stage], h, j * kBwdTile, b);
        tma_rows(sm.v[ring.stage], &v_map, &sm.full[ring.stage], h, j * kBwdTile, b);
      }
    }
    return;
  }

  consumer_registers();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int c = lane % 4;
  Ring ring;
  uint32_t it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
    const int bh = w / q_tiles, b = bh / heads, h = bh % heads;
    const int q0 = (w % q_tiles) * kBlockRows + wg * kWgRows;
    const int qb = it & 1;

    // delta = rowsum(dO * O) in f32 from global memory (each of a row's 4
    // lanes sums D / 4 columns), and the forward's statistics
    float delta[2], ml[2], il[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = q0 + r + 8 * rr;
      float sum = 0.0f;
      if (row < n_q) {
        const __nv_bfloat16* orow = o + b * o_sb + row * o_sn + h * D + c * (D / 4);
        const __nv_bfloat16* drow = dout + b * do_sb + row * do_sn + h * D + c * (D / 4);
#pragma unroll
        for (int e = 0; e < D / 4; e += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + e);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + e);
          const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 a = __bfloat1622float2(op[u]), g = __bfloat1622float2(dp[u]);
            sum += g.x * a.x;
            sum += g.y * a.y;
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      delta[rr] = sum;
      ml[rr] = 0.0f;
      il[rr] = 0.0f;
      if (row < n_q) {
        const long long at = static_cast<long long>(bh) * n_q + row;
        ml[rr] = stats_m[at] * kLog2e;  // as the forward's pass 2 forms them
        il[rr] = 1.0f / stats_l[at];
        if (c == 0) rowstats[at] = make_float4(ml[rr], il[rr], delta[rr], 0.0f);
      }
    }

    mbar_wait(&sm.q_full[qb], (it >> 1) & 1);
    const uint32_t qa = smem_u32(sm.q[qb] + wg * kWgRows * D);
    const uint32_t da = smem_u32(sm.dout[qb] + wg * kWgRows * D);
    float acc[D / 2];
    zero(acc);
    for (int j = 0; j < kv_tiles; ++j, ring.next()) {
      mbar_wait(&sm.full[ring.stage], ring.phase);
      const uint32_t ka = smem_u32(sm.k[ring.stage]), va = smem_u32(sm.v[ring.stage]);
      float s[kBwdTile / 2], dp[kBwdTile / 2];
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
      issue_abt<D>(s, qa, ka);   // S = Q K^T
      issue_abt<D>(dp, da, va);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      if (j == kv_tiles - 1 && lane == 0) mbar_arrive(&sm.q_empty[qb]);  // Q and dO are read no more
      scale_mask<kBwdTile>(s, j * kBwdTile, n_kv, scale, c);  // pad columns: -inf, so P = 0
#pragma unroll
      for (int e = 0; e < kBwdTile / 2; ++e) {
        const int rr = (e >> 1) & 1;
        const float p = exp_shifted(s[e], ml[rr]) * il[rr];
        dp[e] = p * (dp[e] - delta[rr]) * scale;  // dS
      }
      uint32_t dsf[kBwdTile / 16][4];
      to_a_frags<kBwdTile>(dsf, dp);
      fence_acc(acc);
      wgmma_fence();
      issue_ab<D>(acc, dsf, ka);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&sm.empty[ring.stage]);
    }
    store_rows_bf16<D>(dq + b * dq_sb + h * D, dq_sn, q0 + r, n_q, c, acc);
  }
}

template <int D>
struct DkvShared {
  __nv_bfloat16 k[kBlockRows * D];
  __nv_bfloat16 v[kBlockRows * D];
  __nv_bfloat16 q[kStages][kBwdTile * D];
  __nv_bfloat16 dout[kStages][kBwdTile * D];
  float4 rs[kStages][kBwdTile];
  uint64_t kv_full, kv_empty, full[kStages], empty[kStages];
};

// Backward kernel 2 (KV-parallel): dK and dV of 128 K/V rows over one
// chunk of 64-row query tiles.  Work item w: K/V rows [128 (w % kv_blocks),
// +128) of head (w / kv_blocks) % n_bh, chunk w / (kv_blocks n_bh).  With
// one chunk it writes dK and dV as bf16 into d(kv); with more, f32 partials
// [chunks, 2, B * H, n_kv, D] (dK, then dV) for kernel 3.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    sra_attn_bwd_dkv(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap rs_map, float* __restrict__ partial,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int heads, int n_bh,
                     int n_q, int n_kv, int tiles_per_chunk, int chunks, long long dkv_sb,
                     long long dkv_sn, float scale) {
  auto& sm = shared_storage<DkvShared<D>>();
  const int q_tiles = (n_q + kBwdTile - 1) / kBwdTile;
  const int kv_blocks = (n_kv + kBlockRows - 1) / kBlockRows;
  const int n_work = kv_blocks * n_bh * chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, kConsumerWarps);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], kConsumerWarps);
    }
    publish_barriers();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: K and V per item, then Q, dO and row statistics
    producer_registers();
    if (warp != kConsumerWarps || lane != 0) return;
    Ring ring;
    uint32_t it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      const int bh = (w / kv_blocks) % n_bh, b = bh / heads, h = bh % heads;
      const int tile0 = (w / (kv_blocks * n_bh)) * tiles_per_chunk;
      const int tile1 = min(q_tiles, tile0 + tiles_per_chunk);
      mbar_wait(&sm.kv_empty, (it & 1) ^ 1);
      mbar_expect_tx(&sm.kv_full, 2 * kBlockRows * D * 2);
      tma_rows(sm.k, &k_map, &sm.kv_full, h, (w % kv_blocks) * kBlockRows, b);
      tma_rows(sm.v, &v_map, &sm.kv_full, h, (w % kv_blocks) * kBlockRows, b);
      for (int t = tile0; t < tile1; ++t, ring.next()) {
        mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
        mbar_expect_tx(&sm.full[ring.stage], 2 * kBwdTile * D * 2 + kBwdTile * 16);
        tma_rows(sm.q[ring.stage], &q_map, &sm.full[ring.stage], h, t * kBwdTile, b);
        tma_rows(sm.dout[ring.stage], &do_map, &sm.full[ring.stage], h, t * kBwdTile, b);
        tma_rowstats(sm.rs[ring.stage], &rs_map, &sm.full[ring.stage], t * kBwdTile, bh);
      }
    }
    return;
  }

  consumer_registers();
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's K/V rows r and r + 8 of its warpgroup's 64
  const int c = lane % 4;
  Ring ring;
  uint32_t it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
    const int bh = (w / kv_blocks) % n_bh, b = bh / heads, h = bh % heads;
    const int chunk = w / (kv_blocks * n_bh);
    const int tile0 = chunk * tiles_per_chunk;
    const int tile1 = min(q_tiles, tile0 + tiles_per_chunk);
    mbar_wait(&sm.kv_full, it & 1);
    const uint32_t ka = smem_u32(sm.k + wg * kWgRows * D), va = smem_u32(sm.v + wg * kWgRows * D);
    float acc_dk[D / 2], acc_dv[D / 2];
    zero(acc_dk);
    zero(acc_dv);
    for (int t = tile0; t < tile1; ++t, ring.next()) {
      mbar_wait(&sm.full[ring.stage], ring.phase);
      const uint32_t qa = smem_u32(sm.q[ring.stage]), da = smem_u32(sm.dout[ring.stage]);
      float s[kBwdTile / 2], dp[kBwdTile / 2];
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
      issue_abt<D>(s, ka, qa);   // S^T = K Q^T: rows are K rows, columns query rows
      issue_abt<D>(dp, va, da);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      if (t == tile1 - 1 && lane == 0) mbar_arrive(&sm.kv_empty);  // K and V are read no more
      const float4* rs = sm.rs[ring.stage];
#pragma unroll
      for (int e = 0; e < kBwdTile / 2; ++e) {
        const float4 st = rs[8 * (e >> 2) + 2 * c + (e & 1)];  // (m log2 e, 1 / l, delta) of the column's row
        s[e] = exp_shifted(s[e] * scale, st.x) * st.y;          // P^T
        dp[e] = s[e] * (dp[e] - st.z) * scale;                  // dS^T
      }
      uint32_t pf[kBwdTile / 16][4], dsf[kBwdTile / 16][4];
      to_a_frags<kBwdTile>(pf, s);
      to_a_frags<kBwdTile>(dsf, dp);
      fence_acc(acc_dv);
      fence_acc(acc_dk);
      wgmma_fence();
      issue_ab<D>(acc_dv, pf, da);   // dV += P_lo^T dO
      issue_ab<D>(acc_dk, dsf, qa);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc_dv);
      fence_acc(acc_dk);
      if (lane == 0) mbar_arrive(&sm.empty[ring.stage]);
    }

    const int row = (w % kv_blocks) * kBlockRows + wg * kWgRows + r;
    if (chunks == 1) {
      store_rows_bf16<D>(dk + b * dkv_sb + h * D, dkv_sn, row, n_kv, c, acc_dk);
      store_rows_bf16<D>(dv + b * dkv_sb + h * D, dkv_sn, row, n_kv, c, acc_dv);
    } else {
      float* pk = partial + ((static_cast<long long>(chunk) * 2 * n_bh + bh) * n_kv) * D;
      float* pv = pk + static_cast<long long>(n_bh) * n_kv * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * c;
        if (row < n_kv) {
          *reinterpret_cast<float2*>(pk + row * D + col) = make_float2(acc_dk[4 * j], acc_dk[4 * j + 1]);
          *reinterpret_cast<float2*>(pv + row * D + col) = make_float2(acc_dv[4 * j], acc_dv[4 * j + 1]);
        }
        if (row + 8 < n_kv) {
          *reinterpret_cast<float2*>(pk + (row + 8) * D + col) = make_float2(acc_dk[4 * j + 2], acc_dk[4 * j + 3]);
          *reinterpret_cast<float2*>(pv + (row + 8) * D + col) = make_float2(acc_dv[4 * j + 2], acc_dv[4 * j + 3]);
        }
      }
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
    for (int ch = 0; ch < chunks; ++ch) {
      const float2 pk = *reinterpret_cast<const float2*>(partial + 2 * ch * plane + e);
      const float2 pv = *reinterpret_cast<const float2*>(partial + (2 * ch + 1) * plane + e);
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

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a bf16 [B, N, H, D] tensor (batch stride sb, row stride
// sn, in elements; heads D apart), read in boxes of box_rows rows of one
// head, swizzled for wgmma.  Rows past N read as zeros.
bool rows_map(CUtensorMap* map, const void* base, int batch, int heads, int n, int d, long long sb,
              long long sn, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d), 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, d == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of the f32 [B*H, N_q, 4] row statistics, 64 rows a box.
bool rowstats_map(CUtensorMap* map, void* base, int n_bh, int n_q) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {4, static_cast<cuuint64_t>(n_q), static_cast<cuuint64_t>(n_bh)};
  const cuuint64_t strides[2] = {16, static_cast<cuuint64_t>(n_q) * 16};
  const cuuint32_t box[3] = {4, kBwdTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SM count of the current device.  cudaSetDevice also makes its
// context current on this thread: the tensor-map encoder (libcuda) needs
// one, and a thread that has only asked the runtime for cached
// memory (autograd's backward thread, say) may not have it yet.
int bind_device() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaSetDevice(dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Launches a persistent kernel: one block per SM, at most one per work item.
template <int THREADS = kThreads, typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int n_work, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = bind_device();
  kernel<<<n_work < sms ? n_work : sms, THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* stats_m, float* stats_l, int batch,
               int heads, int n_q, int n_kv, long long q_sb, long long q_sn, long long k_sb, long long k_sn,
               long long v_sb, long long v_sn, long long o_sb, long long o_sn, float scale, cudaStream_t s) {
  bind_device();
  CUtensorMap qm, km, vm;
  if (!rows_map(&qm, q, batch, heads, n_q, D, q_sb, q_sn, Block<kFwdWGs>::kRows) ||
      !rows_map(&km, k, batch, heads, n_kv, D, k_sb, k_sn, kFwdKV) ||
      !rows_map(&vm, v, batch, heads, n_kv, D, v_sb, v_sn, kFwdKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bh = batch * heads;
  constexpr int rows = Block<kFwdWGs>::kRows;
  return launch<Block<kFwdWGs>::kThreads>(sra_attn_fwd<D>, sizeof(FwdShared<D>) + 1024, (n_q + rows - 1) / rows * n_bh, s, qm,
                km, vm, static_cast<__nv_bfloat16*>(o), stats_m, stats_l, heads, n_bh, n_q, n_kv, o_sb, o_sn,
                scale);
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* stats_m,
               const float* stats_l, void* dq, void* rowstats, float* partial, void* dk, void* dv, int batch,
               int heads, int n_q, int n_kv, int tiles_per_chunk, long long q_sb, long long q_sn, long long k_sb,
               long long k_sn, long long v_sb, long long v_sn, long long o_sb, long long o_sn, long long do_sb,
               long long do_sn, long long dq_sb, long long dq_sn, long long dkv_sb, long long dkv_sn, float scale,
               cudaStream_t s) {
  const int n_bh = batch * heads;
  const int chunks = ((n_q + kBwdTile - 1) / kBwdTile + tiles_per_chunk - 1) / tiles_per_chunk;
  if (chunks > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  bind_device();
  CUtensorMap q_rows, do_rows, k_tile, v_tile, q_tile, do_tile, k_rows, v_rows, rs;
  if (!rows_map(&q_rows, q, batch, heads, n_q, D, q_sb, q_sn, kBlockRows) ||
      !rows_map(&do_rows, dout, batch, heads, n_q, D, do_sb, do_sn, kBlockRows) ||
      !rows_map(&k_tile, k, batch, heads, n_kv, D, k_sb, k_sn, kBwdTile) ||
      !rows_map(&v_tile, v, batch, heads, n_kv, D, v_sb, v_sn, kBwdTile) ||
      !rows_map(&q_tile, q, batch, heads, n_q, D, q_sb, q_sn, kBwdTile) ||
      !rows_map(&do_tile, dout, batch, heads, n_q, D, do_sb, do_sn, kBwdTile) ||
      !rows_map(&k_rows, k, batch, heads, n_kv, D, k_sb, k_sn, kBlockRows) ||
      !rows_map(&v_rows, v, batch, heads, n_kv, D, v_sb, v_sn, kBlockRows) ||
      !rowstats_map(&rs, rowstats, n_bh, n_q))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  int err = launch(sra_attn_bwd_dq<D>, sizeof(DqShared<D>) + 1024, (n_q + kBlockRows - 1) / kBlockRows * n_bh, s,
                   q_rows, do_rows, k_tile, v_tile, static_cast<const __nv_bfloat16*>(o),
                   static_cast<const __nv_bfloat16*>(dout), stats_m, stats_l, static_cast<__nv_bfloat16*>(dq),
                   static_cast<float4*>(rowstats), heads, n_bh, n_q, n_kv, o_sb, o_sn, do_sb, do_sn, dq_sb, dq_sn,
                   scale);
  if (err != 0) return err;
  err = launch(sra_attn_bwd_dkv<D>, sizeof(DkvShared<D>) + 1024,
               (n_kv + kBlockRows - 1) / kBlockRows * n_bh * chunks, s, q_tile, do_tile, k_rows, v_rows, rs,
               partial, dkp, dvp, heads, n_bh, n_q, n_kv, tiles_per_chunk, chunks, dkv_sb, dkv_sn, scale);
  if (err != 0 || chunks == 1) return err;
  const long long pairs = static_cast<long long>(n_bh) * n_kv * D / 2;
  const int blocks = static_cast<int>((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  sra_attn_bwd_reduce<D><<<blocks, 256, 0, s>>>(partial, dkp, dvp, heads, n_bh, n_kv, chunks, dkv_sb, dkv_sn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sra_attention_fwd(const void* q, const void* k, const void* v, void* o, void* stats_m,
                                 void* stats_l, int batch, int heads, int n_q, int n_kv, int head_dim,
                                 long long q_sb, long long q_sn, long long k_sb, long long k_sn, long long v_sb,
                                 long long v_sn, long long o_sb, long long o_sn, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* mp = static_cast<float*>(stats_m);
  auto* lp = static_cast<float*>(stats_l);
  if (head_dim == 64)
    return launch_fwd<64>(q, k, v, o, mp, lp, batch, heads, n_q, n_kv, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb,
                          o_sn, scale, s);
  if (head_dim == 32)
    return launch_fwd<32>(q, k, v, o, mp, lp, batch, heads, n_q, n_kv, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb,
                          o_sn, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq [B, N_q, H, D] and the dk, dv halves of d(kv) are written; rowstats
// (f32 [B*H, N_q, 4]) and partial (f32 [chunks, 2, B*H, N_kv, D], chunks =
// ceil(ceil(N_q / 64) / tiles_per_chunk); null when that is 1) are the
// caller's scratch.
extern "C" int sra_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* stats_m, const void* stats_l, void* dq, void* rowstats, void* partial,
                                 void* dk, void* dv, int batch, int heads, int n_q, int n_kv, int head_dim,
                                 int tiles_per_chunk, long long q_sb, long long q_sn, long long k_sb,
                                 long long k_sn, long long v_sb, long long v_sn, long long o_sb, long long o_sn,
                                 long long do_sb, long long do_sn, long long dq_sb, long long dq_sn,
                                 long long dkv_sb, long long dkv_sn, float scale, void* stream) {
  if (tiles_per_chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const float*>(stats_m);
  const auto* lp = static_cast<const float*>(stats_l);
  auto* pp = static_cast<float*>(partial);
  if (head_dim == 64)
    return launch_bwd<64>(q, k, v, o, dout, mp, lp, dq, rowstats, pp, dk, dv, batch, heads, n_q, n_kv,
                          tiles_per_chunk, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, do_sb, do_sn, dq_sb,
                          dq_sn, dkv_sb, dkv_sn, scale, s);
  if (head_dim == 32)
    return launch_bwd<32>(q, k, v, o, dout, mp, lp, dq, rowstats, pp, dk, dv, batch, heads, n_q, n_kv,
                          tiles_per_chunk, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn, do_sb, do_sn, dq_sb,
                          dq_sn, dkv_sb, dkv_sn, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
