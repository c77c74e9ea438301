// Fused self-attention forward for Hopper (sm_90a): softmax(q·kᵀ/√d)·v.
//
// Replaces spectrogramgenai_tpu/ops/attention.py::_fwd_kernel, the Pallas
// kernel behind the UNet's self-attention sites with ≥ 1024 tokens. Same
// function: non-causal, unmasked, f32 accumulation, output in the input type.
//
// What bounds it on Hopper. At the serving shapes (B·H = 216, N = 1024 or
// 4096, d = 16 or 32) the inputs are a few MB, but the score matrix is N wide
// per query row: N·N·(2d + 1) flops and N·N exponentials per head. At d = 16
// that is ~33 operations per (query, key) pair against 64 input bytes per key
// row, so the work is compute on the scores and the exp, not bytes. The one
// thing that must not happen is writing the (N, N) scores to device memory,
// which is what the plain PyTorch version does (14.5 GB of f32 scores at
// N = 4096, B·H = 216).
//
// What the design does about it. One block per (b·h, 128-query tile), one
// thread per query row; the scores of a row live only in that thread's
// registers. K and V are streamed through shared memory in 64-key tiles (as
// f32) and read back as warp-wide broadcasts, so every key row is fetched from
// L2 once per block and feeds 128 queries. The softmax is the ordinary online
// softmax: a running row max and row sum, with the accumulator rescaled once
// per 16-key chunk. It is exact for any logits (no clipping window and no
// fallback branch, which the TPU kernel needed to keep its vector unit to one
// pass), and a NaN score propagates to the output. Scores are taken in the
// exp2 domain by folding log2(e)/√d into q. The arithmetic is scalar f32 FMA;
// moving the two products onto the tensor cores (mma.sync or wgmma) is the
// next step for speed.
//
// Residuals for the backward (csrc/attention_bwd.cu), written only when the
// caller passes their pointers (training under autograd; serving passes
// null and runs the kernel it always ran): the row log-sum-exp in the exp2
// domain, lse = m + log2(l), and the output in f32. Then the score is taken
// as the backward's tensor-core kernels take it, the dot product first and
// log2(e)/√d applied as a product rounded on its own, so that P = exp2(s −
// lse) in the backward is the forward's P (exactly 1/N in a row of equal
// logits, where a folded scale would round differently).
//
// Built by spectrogramgenai_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlockQ = 128;  // query rows per block, one thread each
constexpr int kBlockK = 64;   // keys staged in shared memory per tile
constexpr int kChunk = 16;    // keys scored between two online-softmax rescales

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// q_row · key, with the key row read from shared memory (a broadcast: every
// lane of the warp reads the same address).
template <int D>
__device__ __forceinline__ float dot_row(const float (&q_row)[D], const float* key) {
  float acc = 0.f;
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(key + c);
      acc = fmaf(q_row[c], kk.x, acc);
      acc = fmaf(q_row[c + 1], kk.y, acc);
      acc = fmaf(q_row[c + 2], kk.z, acc);
      acc = fmaf(q_row[c + 3], kk.w, acc);
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) acc = fmaf(q_row[c], key[c], acc);
  }
  return acc;
}

// acc += p · value_row
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float p, const float* value) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 vv = *reinterpret_cast<const float4*>(value + c);
      acc[c] = fmaf(p, vv.x, acc[c]);
      acc[c + 1] = fmaf(p, vv.y, acc[c + 1]);
      acc[c + 2] = fmaf(p, vv.z, acc[c + 2]);
      acc[c + 3] = fmaf(p, vv.w, acc[c + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = fmaf(p, value[c], acc[c]);
  }
}

// q, k, v, o: (bh, n, D) contiguous; with RES, lse: (bh, n) and o32: (bh, n,
// D) f32. Grid: bh · (n / kBlockQ) blocks, the query tiles of one (b, h)
// adjacent so that its K and V stay hot in L2.
template <typename T, int D, bool RES>
__global__ void __launch_bounds__(kBlockQ)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, float* __restrict__ o32, int n,
                     float scale_log2) {
  __shared__ __align__(16) float sk[kBlockK * D];
  __shared__ __align__(16) float sv[kBlockK * D];

  const int tiles = n / kBlockQ;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kBlockQ + threadIdx.x;
  const size_t head = static_cast<size_t>(bh) * n * D;

  float q_row[D];
  float acc[D];
  const T* qp = q + head + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    q_row[c] = RES ? to_f32(qp[c]) : to_f32(qp[c]) * scale_log2;
    acc[c] = 0.f;
  }
  float m = -INFINITY;  // running row max, log2 domain
  float l = 0.f;        // running row sum of exp2(s - m)

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    const T* kt = k + head + static_cast<size_t>(k0) * D;
    const T* vt = v + head + static_cast<size_t>(k0) * D;
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      sk[i] = to_f32(kt[i]);
      sv[i] = to_f32(vt[i]);
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < kBlockK; j0 += kChunk) {
      float s[kChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = dot_row<D>(q_row, sk + (j0 + j) * D);
        if constexpr (RES) s[j] = __fmul_rn(s[j], scale_log2);  // not contracted into s − m
        chunk_max = fmaxf(chunk_max, s[j]);
      }
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = exp2f(m - m_new);  // 0 on the first chunk (m = -inf)
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
      m = m_new;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(s[j] - m);
        l += p;
        axpy_row<D>(acc, p, sv + (j0 + j) * D);
      }
    }
  }

  const float inv_l = 1.f / l;
  T* op = o + head + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) op[c] = from_f32<T>(acc[c] * inv_l);
  if constexpr (RES) {
    lse[static_cast<size_t>(bh) * n + row] = m + log2f(l);
    float* o32p = o32 + head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) o32p[c] = acc[c] * inv_l;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bh,
                   int n, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(bh) * (n / kBlockQ);
  if (blocks <= 0 || blocks > INT32_MAX || (lse == nullptr) != (o32 == nullptr)) return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  if (lse == nullptr)
    attention_fwd_kernel<T, D, false><<<static_cast<unsigned>(blocks), kBlockQ, 0, stream>>>(
        tq, tk, tv, static_cast<T*>(o), nullptr, nullptr, n, scale_log2);
  else
    attention_fwd_kernel<T, D, true><<<static_cast<unsigned>(blocks), kBlockQ, 0, stream>>>(
        tq, tk, tv, static_cast<T*>(o), lse, o32, n, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bh,
                       int n, int d, cudaStream_t stream) {
  switch (d) {
    case 2: return launch<T, 2>(q, k, v, o, lse, o32, bh, n, stream);
    case 4: return launch<T, 4>(q, k, v, o, lse, o32, bh, n, stream);
    case 8: return launch<T, 8>(q, k, v, o, lse, o32, bh, n, stream);
    case 16: return launch<T, 16>(q, k, v, o, lse, o32, bh, n, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, o32, bh, n, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, o32, bh, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse ((bh, n) f32) and o32 ((bh, n, d)
// f32) are both null (no residuals) or both set. Returns a cudaError_t (0 =
// success) taken with cudaGetLastError() right after the launch. Does not
// synchronise.
int attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* o32, int bh, int n,
                  int d, int dtype, void* stream) {
  if (n <= 0 || n % kBlockQ != 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* o2 = static_cast<float*>(o32);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, l, o2, bh, n, d, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, l, o2, bh, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
