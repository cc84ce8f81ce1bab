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
// them: one thread per pixel loops over the C class planes, so at each class
// the 32 threads of a warp read one coalesced 128-byte line.  Per pixel both
// compute the first-max argmax and p = exp(m - (m + log(sum exp(x - m)))),
// the formula of the plain PyTorch versions and of the JAX package's
// policies.confidences.
//
// Bound on an H100 SXM (3.35 TB/s): both are memory-bound.  At the main
// path's shapes (B=2, C=19, 768x1536) each reads 179.3 MB of logits, about
// 54 us; ias_select writes 2.4 MB of uint8 labels more.  The arithmetic
// (C exps, one log, C compares per pixel) is a few percent of that.
//
// What the TPU design did and this one does not: the TPU kernels binned by a
// hi/lo one-hot matmul on the MXU, kept argmax and floor in f32 (Mosaic had
// no f32->i32 vector cast) and looked thresholds up by a one-hot
// contraction.  Here a bin is an integer and the histogram lives in shared
// memory: each block keeps its own [C, nb] u32 histogram (19 * 2048 * 4 =
// 155,648 B, above the 48 KB default, so the kernel opts in), takes shared
// atomics per pixel, and flushes its non-zero bins with one global atomic
// each.  When C * nb * 4 exceeds the card's opt-in limit the same kernel
// counts straight into global memory.  Counts are integers, so the atomics
// leave them exact whatever the order.  The selection's per-class confidence
// sums are float atomics: their order varies from run to run.
//
// Every launcher runs on the caller's stream, never synchronises, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxClasses = 32;
constexpr int kHistThreads = 512;
constexpr int kSelectThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;

// Confidence and first-max argmax of one pixel whose C logits lie `plane`
// floats apart.  MAXC is C rounded up to an instantiated size; the c < C
// guards fold away when MAXC == C.
template <int MAXC>
__device__ __forceinline__ void pixel_confidence(const float* __restrict__ base,
                                                 long long plane, int C,
                                                 float& prob, int& pred) {
  float v[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) v[c] = (c < C) ? __ldg(base + c * plane) : 0.0f;
  float m = v[0];
  int arg = 0;
#pragma unroll
  for (int c = 1; c < MAXC; ++c) {
    if (c < C && v[c] > m) {  // strict: ties keep the smallest class id
      m = v[c];
      arg = c;
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) s += expf(v[c] - m);
  }
  const float lse = m + logf(s);
  prob = expf(m - lse);
  pred = arg;
}

template <int MAXC>
__global__ void __launch_bounds__(kHistThreads)
ias_hist_kernel(const float* __restrict__ logits, int C, long long hw_size,
                long long npix, int nb, unsigned int* __restrict__ hist,
                int use_smem) {
  extern __shared__ unsigned int s_hist[];
  const int nbins = C * nb;
  if (use_smem) {
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) s_hist[i] = 0u;
    __syncthreads();
  }
  unsigned int* dst = use_smem ? s_hist : hist;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < npix; p += stride) {
    const long long b = p / hw_size;
    const long long hw = p - b * hw_size;
    float prob;
    int pred;
    pixel_confidence<MAXC>(logits + b * C * hw_size + hw, hw_size, C, prob, pred);
    int bin = static_cast<int>(prob * nb);
    bin = bin < 0 ? 0 : (bin > nb - 1 ? nb - 1 : bin);
    atomicAdd(dst + pred * nb + bin, 1u);
  }
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
      const unsigned int n = s_hist[i];
      if (n) atomicAdd(hist + i, n);
    }
  }
}

// grid: (blocks over H*W, B).  Each thread keeps per-class selected counts
// and confidence sums in registers; a block reduces them through warp
// shuffles and shared atomics, then adds one global atomic per entry.
template <int MAXC>
__global__ void __launch_bounds__(kSelectThreads)
ias_select_kernel(const float* __restrict__ logits,
                  const float* __restrict__ thresholds, int C, long long hw_size,
                  long long nvalid, uint8_t* __restrict__ labels,
                  float* __restrict__ maxprob, int* __restrict__ counts,
                  float* __restrict__ sums) {
  __shared__ float s_thr[MAXC];
  __shared__ int s_cnt[MAXC];
  __shared__ float s_sum[MAXC];
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  if (tid < C) {
    s_thr[tid] = thresholds[tid];
    s_cnt[tid] = 0;
    s_sum[tid] = 0.0f;
  }
  __syncthreads();

  int cnt[MAXC];
  float sum[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    cnt[c] = 0;
    sum[c] = 0.0f;
  }
  const float* base = logits + b * C * hw_size;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long hw = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
       hw < hw_size; hw += stride) {
    float prob;
    int pred;
    pixel_confidence<MAXC>(base + hw, hw_size, C, prob, pred);
    const long long p = b * hw_size + hw;
    const bool sel = p < nvalid && prob >= s_thr[pred];
    labels[p] = sel ? static_cast<uint8_t>(pred) : static_cast<uint8_t>(255);
    if (maxprob != nullptr) maxprob[p] = prob;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (sel && pred == c) {
        cnt[c] += 1;
        sum[c] += prob;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < C) {
      int n = cnt[c];
      float s = sum[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        n += __shfl_down_sync(kFullWarp, n, off);
        s += __shfl_down_sync(kFullWarp, s, off);
      }
      if ((tid & 31) == 0 && n) {
        atomicAdd(&s_cnt[c], n);
        atomicAdd(&s_sum[c], s);
      }
    }
  }
  __syncthreads();
  if (tid < C && s_cnt[tid]) {
    atomicAdd(&counts[b * C + tid], s_cnt[tid]);
    atomicAdd(&sums[tid], s_sum[tid]);
  }
}

cudaError_t device_attrs(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <int MAXC>
cudaError_t launch_hist(const float* logits, int C, long long hw_size, long long npix,
                        int nb, unsigned int* hist, cudaStream_t stream) {
  int sms = 0, smem_optin = 0;
  cudaError_t e = device_attrs(&sms, &smem_optin);
  if (e != cudaSuccess) return e;
  const size_t smem = static_cast<size_t>(C) * nb * sizeof(unsigned int);
  const int use_smem = smem <= static_cast<size_t>(smem_optin);
  const size_t dyn = use_smem ? smem : 0;
  if (dyn > 48 * 1024) {
    e = cudaFuncSetAttribute(ias_hist_kernel<MAXC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
    if (e != cudaSuccess) return e;
  }
  // about one block per SM (the shared histogram allows one); fewer for a
  // small grid, since every block zeroes and flushes the whole histogram
  const long long per_block = static_cast<long long>(kHistThreads) * 8;
  long long blocks = (npix + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * (use_smem ? 1 : 4);
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  ias_hist_kernel<MAXC><<<static_cast<int>(blocks), kHistThreads, dyn, stream>>>(
      logits, C, hw_size, npix, nb, hist, use_smem);
  return cudaGetLastError();
}

template <int MAXC>
cudaError_t launch_select(const float* logits, const float* thresholds, int B, int C,
                          long long hw_size, long long nvalid, uint8_t* labels,
                          float* maxprob, int* counts, float* sums,
                          cudaStream_t stream) {
  int sms = 0, smem_optin = 0;
  cudaError_t e = device_attrs(&sms, &smem_optin);
  if (e != cudaSuccess) return e;
  long long bx = (hw_size + kSelectThreads - 1) / kSelectThreads;
  const long long cap = (static_cast<long long>(sms) * 8 + B - 1) / B;
  bx = bx < 1 ? 1 : (bx > cap ? cap : bx);
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(B));
  ias_select_kernel<MAXC><<<grid, kSelectThreads, 0, stream>>>(
      logits, thresholds, C, hw_size, nvalid, labels, maxprob, counts, sums);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits: float32 [B, C, hw_size] contiguous; hist: uint32 [C, nb], zeroed
// by the caller.  Counts pixels p (in b-major order) with p < nvalid.
int ias_hist(const void* logits, int B, int C, long long hw_size, long long nvalid,
             int nb, void* hist, void* stream) {
  if (B < 1 || C < 1 || C > kMaxClasses || hw_size < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long npix = static_cast<long long>(B) * hw_size;
  if (nvalid < npix) npix = nvalid < 0 ? 0 : nvalid;
  const float* x = static_cast<const float*>(logits);
  unsigned int* h = static_cast<unsigned int*>(hist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 19: return static_cast<int>(launch_hist<19>(x, C, hw_size, npix, nb, h, s));
    case 9: return static_cast<int>(launch_hist<9>(x, C, hw_size, npix, nb, h, s));
    default: return static_cast<int>(launch_hist<kMaxClasses>(x, C, hw_size, npix, nb, h, s));
  }
}

// logits: float32 [B, C, hw_size]; thresholds: float32 [C]; labels: uint8
// [B, hw_size]; maxprob: float32 [B, hw_size] or null; counts: int32 [B, C]
// and sums: float32 [C], both zeroed by the caller.
int ias_select(const void* logits, const void* thresholds, int B, int C,
               long long hw_size, long long nvalid, void* labels, void* maxprob,
               void* counts, void* sums, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxClasses || hw_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(logits);
  const float* t = static_cast<const float*>(thresholds);
  uint8_t* l = static_cast<uint8_t*>(labels);
  float* mp = static_cast<float*>(maxprob);
  int* n = static_cast<int*>(counts);
  float* sm = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 19: return static_cast<int>(launch_select<19>(x, t, B, C, hw_size, nvalid, l, mp, n, sm, s));
    case 9: return static_cast<int>(launch_select<9>(x, t, B, C, hw_size, nvalid, l, mp, n, sm, s));
    default:
      return static_cast<int>(launch_select<kMaxClasses>(x, t, B, C, hw_size, nvalid, l, mp, n, sm, s));
  }
}

}  // extern "C"
