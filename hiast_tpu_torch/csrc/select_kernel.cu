// IAS pseudo-label kernels for Hopper (sm_90a): confidence histogram and
// thresholded selection.  Built by hiast_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into a shared library with a plain C interface, loaded with ctypes.
// No --use_fast_math: p is binned at 1/num_bins and compared with thresholds
// at float precision, so expf/logf keep their full accuracy.
//
// ias_hist replaces hiast_tpu/ops/pallas/select_kernel.py:_hist_kernel.
// ias_select replaces hiast_tpu/ops/pallas/select_kernel.py:_select_kernel,
// with the per-sample [B, C] counts (an XLA reduce after the TPU kernel)
// folded in.
//
// Both read the logits in NCHW, [B, C, H*W] float32, as the model emits
// them.  Per pixel both compute the first-max argmax and
// p = exp(m - (m + log(sum exp(x - m)))), summing the classes in order: the
// formula of the plain PyTorch versions and of the JAX package's
// policies.confidences.
//
// Bound on an H100 SXM (3.35 TB/s): both are memory-bound.  At the main
// path's shapes (B=2, C=19, 768x1536) each reads 179.3 MB of logits, about
// 54 us; ias_select writes 2.4 MB of uint8 labels more.  The arithmetic (C
// accurate exps, a log and an exp per pixel: some 300 instructions) is
// about a quarter of that in issue slots and has to hide under the loads.
//
// Design.  A 2D grid over (pixel tiles, B); each block walks its sample's
// tiles with a stride.  A thread takes VEC = 2 consecutive pixels and reads
// each class plane with one float2 load (a warp: 256 B a plane, read-only,
// no L1 allocation, L2 256 B prefetch), and __launch_bounds__ holds it to 64
// registers, so 4 blocks of 256 threads share an SM: 32 warps, each with
// 19 x 256 B in flight while others compute.  (Measured on an H100:
// float4 loads at 2 blocks an SM, and a 4-stage ring of bulk async copies
// into shared memory, were both slower; PERF.md, PR 5.)  Scalar loads
// (VEC = 1) where H*W is odd or the logits are not 8-byte aligned.
// Per-class statistics are gathered per warp: __match_any_sync on the key
// and one add by the group's lowest lane.  So a region of one class (a
// trained model's road or sky, where most pixels fall in the last bin)
// costs one update per warp and pixel slot, not 32 on one address.
//
// ias_hist: one [C, nb] u32 histogram per thread-block cluster, spread over
// the cluster's shared memory (bin k lives in block k % cs at k / cs).  The
// cluster size cs is the least power of two that keeps a block's slice
// under 24 KB (8 at 19 x 2048; 16, a non-portable size, at 19 x 4096; past
// that 16, with larger slices up to the shared-memory opt-in), so several
// blocks fit an SM and only one histogram per cluster is zeroed and
// flushed.  Leaders add into the owning block's slice through distributed
// shared memory; after a cluster barrier each block writes its slice
// plainly to scratch, and ias_hist_reduce, a second small launch, adds the
// clusters' histograms in order and writes the float32 output whole.
// (Global atomics from every cluster onto one zeroed [C, nb], then a cast,
// were slower on Gaussian logits; PERF.md, PR 5.)  Counts are integers:
// exact.
//
// ias_select: labels go out as one 16-bit store per thread, maxprob as one
// float2.  Each class group of a warp sums its confidences in fixed point
// (units of 2^-26, one __reduce_add_sync); each block writes its [C] counts
// and sums plainly into scratch, and ias_select_reduce, a second small
// launch, adds them up and writes each sum as a double, exactly (below 2^53
// units): sums of several calls, or of several ranks' shares, round once,
// where their caller rounds.  Integer sums are the same in any order: two
// calls give the same bits.
//
// Launchers read device attributes and set function attributes once per
// device, run on the caller's stream, never synchronise, allocate nothing,
// and return the launch's error.
//
// Built with -DIAS_PROF, both kernels also sum clock64 cycles by phase over
// every warp (lane 0 of each) into g_ias_prof: [0..4] ias_hist's phases
// (zero and cluster barrier, loads up to the max, confidence arithmetic,
// binning and atomics, cluster barrier and flush), [5] its whole kernel,
// [6] its warps; [8..14] the same for ias_select (set-up, loads, confidence
// arithmetic, label stores and stat accumulation, block sums and partial
// writes).  ias_prof_read copies them out and zeroes them
// (scripts/profile_select_kernel.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

#ifdef IAS_PROF
__device__ unsigned long long g_ias_prof[16];
extern "C" int ias_prof_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_ias_prof, sizeof(g_ias_prof));
  const unsigned long long zeros[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_ias_prof, zeros, sizeof(zeros)));
}
#define PROF_DECL                                 \
  unsigned long long prof[5] = {0, 0, 0, 0, 0};   \
  const long long prof_t0 = clock64();            \
  long long prof_t = prof_t0
#define PROF_LAP(i)                   \
  do {                                \
    const long long now_ = clock64(); \
    prof[i] += now_ - prof_t;         \
    prof_t = now_;                    \
  } while (0)
#define PROF_END(base)                                                                        \
  if ((threadIdx.x & 31) == 0) {                                                              \
    for (int i_ = 0; i_ < 5; ++i_) atomicAdd(&g_ias_prof[(base) + i_], prof[i_]);            \
    atomicAdd(&g_ias_prof[(base) + 5], static_cast<unsigned long long>(clock64() - prof_t0)); \
    atomicAdd(&g_ias_prof[(base) + 6], 1ull);                                                 \
  }
#else
#define PROF_DECL
#define PROF_LAP(i)
#define PROF_END(base)
#endif

namespace {

constexpr int kMaxClasses = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxClusterLog2 = 4;  // clusters of up to 16 blocks
constexpr int kSliceBytes = 24 * 1024;
constexpr int kMaxDevices = 64;
// Confidence sums are taken in fixed point, units of 2^-26: a warp's 32
// sums fit 32 bits, and integer sums are the same in any order.
constexpr float kSumScale = 67108864.0f;  // 2^26
constexpr int kVec = 2;        // pixels a thread on the fast path
constexpr int kMinBlocks = 4;  // blocks an SM the register budget is set for

// A read-once float2 load: read-only path, no L1 allocation, and a hint
// to fetch the surrounding 256 B into L2 (a warp reads 256 B of a plane).
__device__ __forceinline__ float2 load_stream(const float2* p) {
  float2 q;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.f32 {%0, %1}, [%2];" : "=f"(q.x), "=f"(q.y) : "l"(p));
  return q;
}

// Loads the C logits of VEC consecutive pixels: v[c][j] is class c of pixel
// j.  MAXC is C rounded up to an instantiated size; the c < C guards fold
// away when MAXC == C.
template <int MAXC, int VEC>
__device__ __forceinline__ void load_pixels(const float* __restrict__ base, long long plane, int C,
                                            float (&v)[MAXC][VEC]) {
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      if constexpr (VEC == 2) {
        const float2 q = load_stream(reinterpret_cast<const float2*>(base + c * plane));
        v[c][0] = q.x;
        v[c][1] = q.y;
      } else {
        v[c][0] = __ldg(base + c * plane);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[c][j] = 0.0f;
    }
  }
}

// First-max argmax (ties keep the smallest class id) and confidence of each
// of VEC pixels.
#ifdef IAS_PROF
#define PROF_PARAMS , unsigned long long (&prof)[5], long long &prof_t
#define PROF_ARGS , prof, prof_t
#else
#define PROF_PARAMS
#define PROF_ARGS
#endif
template <int MAXC, int VEC>
__device__ __forceinline__ void confidences(const float (&v)[MAXC][VEC], int C, float (&prob)[VEC],
                                            int (&pred)[VEC] PROF_PARAMS) {
  float m[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = v[0][j];
    pred[j] = 0;
  }
#pragma unroll
  for (int c = 1; c < MAXC; ++c) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (c < C && v[c][j] > m[j]) {
        m[j] = v[c][j];
        pred[j] = c;
      }
    }
  }
  PROF_LAP(1);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) s += expf(v[c][j] - m[j]);
    }
    const float lse = m[j] + logf(s);
    prob[j] = expf(m[j] - lse);
  }
  PROF_LAP(2);
}

// Walks this block's tiles t = t0, t0 + stride, ... below nvec (t is the
// same for the whole block), handing body(v, t) the C logits of the
// thread's VEC pixels at vector t + threadIdx.x (zeros past nvec or where
// fetch(vector) is false).
template <int MAXC, int VEC, typename Fetch, typename Body>
__device__ __forceinline__ void stream_tiles(const float* __restrict__ base, long long plane, int C,
                                             long long nvec, long long t0, long long stride,
                                             Fetch fetch, Body body) {
  auto get = [&](float (&v)[MAXC][VEC], long long t) {
    const long long vi = t + threadIdx.x;
    if (vi < nvec && fetch(vi)) {
      load_pixels<MAXC, VEC>(base + vi * VEC, plane, C, v);
    } else {
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[c][j] = 0.0f;
    }
  };
  for (long long t = t0; t < nvec; t += stride) {
    float v[MAXC][VEC];
    get(v, t);
    body(v, t);
  }
}

// grid: (blocks over H*W, B), a multiple of cs blocks along x, in clusters
// of (cs, 1, 1).  Counts the pixels p = b * hw_size + i with p < nvalid.
// Dynamic shared memory: this block's slice of the cluster's histogram,
// written at the end to row (blockIdx.y * gridDim.x + blockIdx.x) of
// scratch [blocks, slice]; a cluster's rows are consecutive.
template <int MAXC, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ias_hist_kernel(const float* __restrict__ logits, int C, long long hw_size, long long nvalid,
                int nb, int cs_log2, int slice, unsigned int* __restrict__ scratch) {
  PROF_DECL;
  extern __shared__ unsigned int s_slice[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < slice; i += kThreads) s_slice[i] = 0u;
  cluster.sync();  // no block adds into a slice before it is zeroed
  PROF_LAP(0);

  const long long b = blockIdx.y;
  const long long pix0 = b * hw_size;
  long long valid = nvalid - pix0;  // valid pixels of this sample
  valid = valid < 0 ? 0 : (valid > hw_size ? hw_size : valid);
  const long long nvec = (valid + VEC - 1) / VEC;
  const float* base = logits + b * C * hw_size;
  const int cs_mask = (1 << cs_log2) - 1;
  auto body = [&](const float (&v)[MAXC][VEC], long long t) {
    const long long vi = t + tid;
    const bool in = vi < nvec;
    float prob[VEC];
    int pred[VEC];
    confidences<MAXC, VEC>(v, C, prob, pred PROF_ARGS);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      int bin = static_cast<int>(prob[j] * nb);
      bin = bin < 0 ? 0 : (bin > nb - 1 ? nb - 1 : bin);
      const int key = (in && vi * VEC + j < valid) ? pred[j] * nb + bin : -1;
      const unsigned peers = __match_any_sync(kFullWarp, key);
      if (key >= 0 && lane == __ffs(peers) - 1) {
        unsigned int* dst = cluster.map_shared_rank(s_slice, key & cs_mask);
        atomicAdd(dst + (key >> cs_log2), static_cast<unsigned int>(__popc(peers)));
      }
    }
    PROF_LAP(3);
  };
  stream_tiles<MAXC, VEC>(base, hw_size, C, nvec, static_cast<long long>(blockIdx.x) * kThreads,
                          static_cast<long long>(gridDim.x) * kThreads, [](long long) { return true; },
                          body);

  cluster.sync();  // every add into this block's slice has landed
  unsigned int* row = scratch + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * slice;
  for (int i = tid; i < slice; i += kThreads) row[i] = s_slice[i];
  PROF_LAP(4);
  PROF_END(0);
}

// grid: (nx blocks over H*W, B).  Writes every label (and maxprob), and
// this block's selected counts and confidence sums per class into
// part_cnt / part_sum [B, nx, C].
template <int MAXC, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ias_select_kernel(const float* __restrict__ logits, const float* __restrict__ thresholds, int C,
                  long long hw_size, long long nvalid, uint8_t* __restrict__ labels,
                  float* __restrict__ maxprob, int* __restrict__ part_cnt,
                  unsigned long long* __restrict__ part_sum) {
  PROF_DECL;
  __shared__ float s_thr[MAXC];
  __shared__ int s_cnt[kWarps][MAXC];
  __shared__ unsigned long long s_sum[kWarps][MAXC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < C) s_thr[tid] = thresholds[tid];
  for (int i = tid; i < kWarps * MAXC; i += kThreads) {
    s_cnt[i / MAXC][i % MAXC] = 0;
    s_sum[i / MAXC][i % MAXC] = 0ull;
  }
  __syncthreads();
  PROF_LAP(0);

  const long long b = blockIdx.y;
  const long long pix0 = b * hw_size;
  const long long nvec = (hw_size + VEC - 1) / VEC;  // VEC divides hw_size
  const float* base = logits + b * C * hw_size;
  auto body = [&](const float (&v)[MAXC][VEC], long long t) {
    const long long vi = t + tid;
    const long long p = pix0 + vi * VEC;  // this thread's first pixel
    const bool in = vi < nvec;
    float prob[VEC];
    int pred[VEC];
    confidences<MAXC, VEC>(v, C, prob, pred PROF_ARGS);
    int key[VEC];
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const bool sel = in && p + j < nvalid && prob[j] >= s_thr[pred[j]];
      key[j] = sel ? pred[j] : -1;
      packed |= static_cast<uint32_t>(sel ? pred[j] : 255) << (8 * j);
    }
    if (in) {
      if constexpr (VEC == 2) {
        *reinterpret_cast<uint16_t*>(labels + p) = static_cast<uint16_t>(packed);
        if (maxprob != nullptr) *reinterpret_cast<float2*>(maxprob + p) = make_float2(prob[0], prob[1]);
      } else {
        labels[p] = static_cast<uint8_t>(packed);
        if (maxprob != nullptr) maxprob[p] = prob[0];
      }
    }
    // per warp and pixel slot: each class group sums its confidences
    // (fixed point, one redux) and its lowest lane adds count and sum
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const unsigned peers = __match_any_sync(kFullWarp, key[j]);
      const unsigned q = key[j] >= 0 ? __float2uint_rn(prob[j] * kSumScale) : 0u;
      const unsigned group = __reduce_add_sync(peers, q);
      if (key[j] >= 0 && lane == __ffs(peers) - 1) {
        s_cnt[warp][key[j]] += __popc(peers);
        s_sum[warp][key[j]] += group;
      }
    }
    PROF_LAP(3);
  };
  // a vector past nvalid needs its logits only for maxprob: its labels are 255
  auto fetch = [&](long long vi) { return maxprob != nullptr || pix0 + vi * VEC < nvalid; };
  stream_tiles<MAXC, VEC>(base, hw_size, C, nvec, static_cast<long long>(blockIdx.x) * kThreads,
                          static_cast<long long>(gridDim.x) * kThreads, fetch, body);

  __syncthreads();
  const long long part = (b * gridDim.x + blockIdx.x) * C;
  for (int c = tid; c < C; c += kThreads) {
    int n = 0;
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n += s_cnt[w][c];
      s += s_sum[w][c];
    }
    part_cnt[part + c] = n;
    part_sum[part + c] = s;
  }
  PROF_LAP(4);
  PROF_END(8);
}

// hist[k] for each bin k = (i << cs_log2) | rank: the sum over the clusters,
// in order, of entry i of their block `rank`'s slice; one thread per entry
// j = rank * slice + i of a cluster's rows.  Integer sums, rounded once to
// float as the plain version's bincount is.
__global__ void __launch_bounds__(kThreads)
ias_hist_reduce(const unsigned int* __restrict__ scratch, int clusters, int cs_log2, int slice,
                int nbins, float* __restrict__ hist) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const long long width = static_cast<long long>(slice) << cs_log2;  // a cluster's words
  if (j >= width) return;
  const int rank = j / slice, i = j - rank * slice;
  const int k = (i << cs_log2) | rank;
  if (k >= nbins) return;
  unsigned int n = 0;
  for (int q = 0; q < clusters; ++q) n += scratch[q * width + j];
  hist[k] = static_cast<float>(n);
}

// One warp per output: counts[b, c] = sum over x of part_cnt[b, x, c]
// (outputs 0 .. B*C-1), sums[c] = 2^-26 * sum over b, x of part_sum[b, x, c]
// (outputs B*C .. B*C+C-1), exact as a double.  Integer sums: the same bits
// on every call.
__global__ void __launch_bounds__(kThreads)
ias_select_reduce(const int* __restrict__ part_cnt, const unsigned long long* __restrict__ part_sum,
                  int B, int nx, int C, int* __restrict__ counts, double* __restrict__ sums) {
  const long long out = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (out >= static_cast<long long>(B) * C + C) return;  // whole warps leave
  if (out < static_cast<long long>(B) * C) {
    const long long b = out / C, c = out % C;
    int n = 0;
    for (int x = lane; x < nx; x += 32) n += part_cnt[(b * nx + x) * C + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(kFullWarp, n, off);
    if (lane == 0) counts[out] = n;
  } else {
    const long long c = out - static_cast<long long>(B) * C;
    unsigned long long s = 0;
    for (long long i = lane; i < static_cast<long long>(B) * nx; i += 32) s += part_sum[i * C + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullWarp, s, off);
    if (lane == 0) sums[c] = static_cast<double>(s) * (1.0 / kSumScale);
  }
}

struct DeviceInfo {
  int sms;
  int smem_optin;
};

// The current device and its attributes, read once per device.
cudaError_t device_info(int* dev, DeviceInfo* info) {
  static DeviceInfo cache[kMaxDevices] = {};
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = cache[*dev];
  if (d.sms == 0) {
    int smem = 0, sms = 0;
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return e;
    d.smem_optin = smem;
    d.sms = sms;  // written last: a non-zero sms marks the entry filled
  }
  *info = d;
  return cudaSuccess;
}

// How ias_hist runs for these shapes on the current device: the cluster
// size, a block's slice and dynamic shared memory, the blocks per sample.
struct HistPlan {
  int cs_log2, slice, nx;
  size_t smem;
};

template <int MAXC, int VEC>
cudaError_t hist_plan(int B, int C, long long hw_size, int nb, HistPlan* plan) {
  // per device: function attributes set, and for each cluster size the
  // slice last probed and the clusters of it that fit at once
  struct Fit {
    size_t smem;
    int clusters;
  };
  static bool attrs_set[kMaxDevices] = {};
  static Fit fits[kMaxDevices][kMaxClusterLog2 + 1] = {};
  int dev = 0;
  DeviceInfo info;
  cudaError_t e = device_info(&dev, &info);
  if (e != cudaSuccess) return e;
  auto kernel = ias_hist_kernel<MAXC, VEC>;
  if (!attrs_set[dev]) {
    cudaFuncAttributes fa;  // the opt-in covers static and dynamic shared memory
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             info.smem_optin - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs_set[dev] = true;
  }
  const long long nbins = static_cast<long long>(C) * nb;
  int cs_log2 = 0;
  while (cs_log2 < kMaxClusterLog2 && ((nbins + (1 << cs_log2) - 1) >> cs_log2) * 4 > kSliceBytes)
    ++cs_log2;
  const int cs = 1 << cs_log2;
  const long long slice = (nbins + cs - 1) >> cs_log2;
  const size_t smem = static_cast<size_t>(slice) * sizeof(unsigned int);
  if (smem > static_cast<size_t>(info.smem_optin)) return cudaErrorInvalidValue;

  Fit& fit = fits[dev][cs_log2];
  if (fit.clusters == 0 || fit.smem != smem) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t probe = {};
    probe.gridDim = dim3(cs, 1, 1);
    probe.blockDim = dim3(kThreads, 1, 1);
    probe.dynamicSmemBytes = smem;
    probe.attrs = attr;
    probe.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &probe);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    fit = Fit{smem, clusters};
  }
  // the clusters that fit at once, shared among the samples; no more than
  // the tiles of a sample need
  const long long tiles = ((hw_size + VEC - 1) / VEC + kThreads - 1) / kThreads;
  long long per_sample = fit.clusters / B;
  per_sample = per_sample < 1 ? 1 : per_sample;
  const long long need = (tiles + cs - 1) / cs;
  per_sample = per_sample > need ? need : per_sample;
  *plan = HistPlan{cs_log2, static_cast<int>(slice), static_cast<int>(per_sample * cs), smem};
  return cudaSuccess;
}

template <int MAXC, int VEC>
cudaError_t launch_hist(const float* logits, int B, int C, long long hw_size, long long nvalid, int nb,
                        float* hist, unsigned int* scratch, long long scratch_words, cudaStream_t stream) {
  HistPlan plan;
  cudaError_t e = hist_plan<MAXC, VEC>(B, C, hw_size, nb, &plan);
  if (e != cudaSuccess) return e;
  if (static_cast<long long>(plan.nx) * B * plan.slice > scratch_words) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << plan.cs_log2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(plan.nx), static_cast<unsigned>(B), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ias_hist_kernel<MAXC, VEC>, logits, C, hw_size, nvalid, nb, plan.cs_log2,
                         plan.slice, scratch);
  if (e != cudaSuccess) return e;
  const int width = plan.slice << plan.cs_log2;
  ias_hist_reduce<<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      scratch, (plan.nx >> plan.cs_log2) * B, plan.cs_log2, plan.slice, C * nb, hist);
  return cudaGetLastError();
}

// Blocks per sample of ias_select: as many as fit on the card at once,
// shared among the samples, no more than the tiles of a sample.
template <int MAXC, int VEC>
cudaError_t select_blocks(int B, long long hw_size, int* nx) {
  static int per_sm[kMaxDevices] = {};
  int dev = 0;
  DeviceInfo info;
  cudaError_t e = device_info(&dev, &info);
  if (e != cudaSuccess) return e;
  if (per_sm[dev] == 0) {
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ias_select_kernel<MAXC, VEC>, kThreads, 0);
    if (e != cudaSuccess) return e;
    per_sm[dev] = n < 1 ? 1 : n;
  }
  const long long tiles = ((hw_size + VEC - 1) / VEC + kThreads - 1) / kThreads;
  long long n = static_cast<long long>(per_sm[dev]) * info.sms / B;
  n = n < 1 ? 1 : (n > tiles ? tiles : n);
  *nx = static_cast<int>(n);
  return cudaSuccess;
}

template <int MAXC, int VEC>
cudaError_t launch_select(const float* logits, const float* thresholds, int B, int C,
                          long long hw_size, long long nvalid, uint8_t* labels, float* maxprob,
                          int* counts, double* sums, int* part_cnt, unsigned long long* part_sum, long long parts,
                          cudaStream_t stream) {
  int nx = 0;
  cudaError_t e = select_blocks<MAXC, VEC>(B, hw_size, &nx);
  if (e != cudaSuccess) return e;
  if (static_cast<long long>(nx) * B > parts) return cudaErrorInvalidValue;
  ias_select_kernel<MAXC, VEC><<<dim3(nx, B), kThreads, 0, stream>>>(
      logits, thresholds, C, hw_size, nvalid, labels, maxprob, part_cnt, part_sum);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long outputs = static_cast<long long>(B) * C + C;
  const long long blocks = (outputs * 32 + kThreads - 1) / kThreads;
  ias_select_reduce<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      part_cnt, part_sum, B, nx, C, counts, sums);
  return cudaGetLastError();
}

// Calls fn(MAXC, VEC), both as std::integral_constant, for the
// instantiation that serves these logits: 19 and 9 classes exactly, others
// at 32; kVec pixels a thread where every class plane starts aligned to
// them, else 1.
template <typename Fn>
cudaError_t dispatch(const void* logits, int C, long long hw_size, Fn fn) {
  using C19 = std::integral_constant<int, 19>;
  using C9 = std::integral_constant<int, 9>;
  using Vec = std::integral_constant<int, kVec>;
  using One = std::integral_constant<int, 1>;
  const bool vec = hw_size % kVec == 0 && reinterpret_cast<uintptr_t>(logits) % (4 * kVec) == 0;
  if (C == 19) return vec ? fn(C19{}, Vec{}) : fn(C19{}, One{});
  if (C == 9) return vec ? fn(C9{}, Vec{}) : fn(C9{}, One{});
  return fn(std::integral_constant<int, kMaxClasses>{}, One{});
}

}  // namespace

extern "C" {

// Words of uint32 scratch that ias_hist needs for these shapes on the
// current device, or minus a CUDA error (cudaErrorInvalidValue when a
// cluster of 16 blocks cannot hold the [C, nb] histogram).
long long ias_hist_scratch(const void* logits, int B, int C, long long hw_size, int nb) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxClasses || hw_size < 1 || nb < 1)
    return -static_cast<long long>(cudaErrorInvalidValue);
  HistPlan plan;
  const cudaError_t e = dispatch(logits, C, hw_size, [&](auto maxc, auto vec) {
    return hist_plan<decltype(maxc)::value, decltype(vec)::value>(B, C, hw_size, nb, &plan);
  });
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(plan.nx) * B * plan.slice;
}

// logits: float32 [B, C, hw_size] contiguous; hist: float32 [C, nb], written
// whole; scratch: uint32 [scratch_words] from ias_hist_scratch.  Counts
// pixels p (in b-major order) with p < nvalid.
int ias_hist(const void* logits, int B, int C, long long hw_size, long long nvalid, int nb,
             void* hist, void* scratch, long long scratch_words, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxClasses || hw_size < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(logits);
  float* h = static_cast<float*>(hist);
  unsigned int* w = static_cast<unsigned int*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(logits, C, hw_size, [&](auto maxc, auto vec) {
    return launch_hist<decltype(maxc)::value, decltype(vec)::value>(x, B, C, hw_size, nvalid, nb, h, w,
                                                                    scratch_words, s);
  }));
}

// Rows of scratch ([rows, C] int32 and uint64) that ias_select needs for
// these shapes on the current device, or minus a CUDA error.
long long ias_select_parts(const void* logits, int B, int C, long long hw_size) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxClasses || hw_size < 1)
    return -static_cast<long long>(cudaErrorInvalidValue);
  int nx = 0;
  const cudaError_t e = dispatch(logits, C, hw_size, [&](auto maxc, auto vec) {
    return select_blocks<decltype(maxc)::value, decltype(vec)::value>(B, hw_size, &nx);
  });
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(nx) * B;
}

// logits: float32 [B, C, hw_size]; thresholds: float32 [C]; labels: uint8
// [B, hw_size]; maxprob: float32 [B, hw_size] or null; counts: int32 [B, C]
// and sums: float64 [C], both written whole; part_cnt: int32 and part_sum:
// uint64 [parts, C] scratch, parts from ias_select_parts.  The label and
// maxprob vector stores need the alignment torch gives a new tensor.
int ias_select(const void* logits, const void* thresholds, int B, int C, long long hw_size,
               long long nvalid, void* labels, void* maxprob, void* counts, void* sums,
               void* part_cnt, void* part_sum, long long parts, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxClasses || hw_size < 1 || parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(labels) % 2 != 0 || reinterpret_cast<uintptr_t>(maxprob) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float* x = static_cast<const float*>(logits);
  const float* t = static_cast<const float*>(thresholds);
  uint8_t* l = static_cast<uint8_t*>(labels);
  float* mp = static_cast<float*>(maxprob);
  int* n = static_cast<int*>(counts);
  double* sm = static_cast<double*>(sums);
  int* pc = static_cast<int*>(part_cnt);
  unsigned long long* ps = static_cast<unsigned long long*>(part_sum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(logits, C, hw_size, [&](auto maxc, auto vec) {
    return launch_select<decltype(maxc)::value, decltype(vec)::value>(x, t, B, C, hw_size, nvalid, l, mp,
                                                                      n, sm, pc, ps, parts, s);
  }));
}

}  // extern "C"
