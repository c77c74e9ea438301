// Fused self-attention backward for Hopper (sm_90a): the softmax VJP of
// o = softmax(q·kᵀ/√d)·v, given dO.
//
// Replaces spectrogramgenai_tpu/ops/attention.py::_bwd_kernel, the Pallas
// kernel behind fused_attention's custom VJP on the training path. Same
// function: P is recomputed from q and k (never stored), then
//   dV = Pᵀ·dO;  dP = dO·Vᵀ;  c = rowsum(dP ∘ P);  dS = P ∘ (dP − c);
//   dQ = scale·dS·K;  dK = scale·dSᵀ·Q,
// with f32 accumulation and dq, dk, dv written in the input type.
//
// What bounds it on Hopper. At the training shapes (B·H = 128, N = 1024 or
// 4096, d = 16 or 32) the inputs are a few MB, but every (query, key) pair
// costs the recomputed score, dP and the two or three products it feeds: about
// 9·d FMAs and, in this design, three exponentials per pair. It is compute on
// the pairs, not bytes; the one thing that must not happen is writing an
// (N, N) matrix to device memory.
//
// What the design does about it. The TPU kernel sums dK and dV over its
// q-block grid axis, which runs in order there; on the GPU blocks run in no
// order. Instead of atomics, the work is split by who owns what:
//   1. attention_bwd_dq_kernel — one thread per query row (128 per block).
//      Pass 1 streams K and V through shared memory and keeps the online row
//      max m, the row sum l and c = Σ p̃·dP / l (rowsum(dP∘P) from dP, as the
//      JAX kernel computes it, rescaled with the running max). Pass 2
//      recomputes P = exp2(s − m)/l, dP and dS and accumulates dQ in
//      registers. The row statistics (m, 1/l, c) go to a small f32 scratch.
//   2. attention_bwd_dkdv_kernel — one thread per key row. It owns its key's
//      dK and dV in registers and streams Q, dO and the row statistics of all
//      queries through shared memory, so no sum crosses a block: the result
//      is deterministic and needs no zeroed buffer.
// P is exact for any logit (max subtracted, l ≥ 1: no clip window, no NaN from
// an underflowing row). The arithmetic is scalar f32 FMA; scores are taken in
// the exp2 domain, q·k scaled by log2(e)/√d after the dot product (folding the
// scale into an operand first doubled the error at logits of ~150). Row sums
// (l and c) add each 16-key chunk's partial sum, which keeps their rounding
// small where a row's terms are all alike. Tensor cores (mma.sync / wgmma)
// and fewer recomputes of P are later work.
//
// Built by spectrogramgenai_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlockRows = 128;  // query rows (kernel 1) or key rows (kernel 2) per block
constexpr int kTile = 64;        // rows staged in shared memory per tile
constexpr int kChunk = 16;       // keys scored between two online-softmax rescales

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// a · row, with the row read from shared memory (a broadcast: every lane of
// the warp reads the same address).
template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D], const float* row) {
  float acc = 0.f;
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 r = *reinterpret_cast<const float4*>(row + c);
      acc = fmaf(a[c], r.x, acc);
      acc = fmaf(a[c + 1], r.y, acc);
      acc = fmaf(a[c + 2], r.z, acc);
      acc = fmaf(a[c + 3], r.w, acc);
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) acc = fmaf(a[c], row[c], acc);
  }
  return acc;
}

// acc += p · row
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float p, const float* row) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 r = *reinterpret_cast<const float4*>(row + c);
      acc[c] = fmaf(p, r.x, acc[c]);
      acc[c + 1] = fmaf(p, r.y, acc[c + 1]);
      acc[c + 2] = fmaf(p, r.z, acc[c + 2]);
      acc[c + 3] = fmaf(p, r.w, acc[c + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = fmaf(p, row[c], acc[c]);
  }
}

// The score in the exp2 domain, rounded as a product on its own: a multiply
// contracted into the FMA of "score − m" would differ from the rounded score
// that m was taken from, and P of a row's largest logit would not be 1.
__device__ __forceinline__ float score(float dot, float scale_log2) { return __fmul_rn(dot, scale_log2); }

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int count) {
  for (int i = threadIdx.x; i < count; i += kBlockRows) dst[i] = to_f32(src[i]);
}

// Kernel 1: dQ and the row statistics. q, k, v, dout, dq: (bh, n, D)
// contiguous; row_m, row_inv_l, row_c: (bh, n) f32. Grid: bh · (n / 128)
// blocks, the query tiles of one (b, h) adjacent so that its K and V stay hot
// in L2.
template <typename T, int D>
__global__ void __launch_bounds__(kBlockRows)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ row_m,
                        float* __restrict__ row_inv_l, float* __restrict__ row_c, int n,
                        float scale_log2, float scale) {
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ __align__(16) float sv[kTile * D];

  const int tiles = n / kBlockRows;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kBlockRows + threadIdx.x;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const size_t stat = static_cast<size_t>(bh) * n + row;

  float q_row[D], do_row[D];
  const T* qp = q + head + static_cast<size_t>(row) * D;
  const T* dop = dout + head + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    q_row[c] = to_f32(qp[c]);
    do_row[c] = to_f32(dop[c]);
  }

  // pass 1: row max m and row sum l of exp2(s - m), and Σ exp2(s - m)·dP
  float m = -INFINITY, l = 0.f, acc_c = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage(sk, k + head + static_cast<size_t>(k0) * D, kTile * D);
    stage(sv, v + head + static_cast<size_t>(k0) * D, kTile * D);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kChunk) {
      float s[kChunk], dp[kChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = score(dot_row<D>(q_row, sk + (j0 + j) * D), scale_log2);
        dp[j] = dot_row<D>(do_row, sv + (j0 + j) * D);
        chunk_max = fmaxf(chunk_max, s[j]);
      }
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = exp2f(m - m_new);  // 0 on the first chunk (m = -inf)
      m = m_new;
      float chunk_l = 0.f, chunk_c = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(s[j] - m);
        chunk_l += p;
        chunk_c = fmaf(p, dp[j], chunk_c);
      }
      l = fmaf(l, alpha, chunk_l);
      acc_c = fmaf(acc_c, alpha, chunk_c);
    }
  }
  const float inv_l = 1.f / l;
  const float c_row = acc_c * inv_l;  // rowsum(dP ∘ P)

  // pass 2: dQ = scale · Σ_j P_j (dP_j − c) k_j
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage(sk, k + head + static_cast<size_t>(k0) * D, kTile * D);
    stage(sv, v + head + static_cast<size_t>(k0) * D, kTile * D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float p = exp2f(score(dot_row<D>(q_row, sk + j * D), scale_log2) - m) * inv_l;
      const float ds = p * (dot_row<D>(do_row, sv + j * D) - c_row);
      axpy_row<D>(acc, ds, sk + j * D);
    }
  }

  T* dqp = dq + head + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) dqp[c] = from_f32<T>(acc[c] * scale);
  row_m[stat] = m;
  row_inv_l[stat] = inv_l;
  row_c[stat] = c_row;
}

// Kernel 2: dK and dV, one thread per key row; reads kernel 1's row
// statistics. Same grid as kernel 1, over key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kBlockRows)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                          const float* __restrict__ row_m, const float* __restrict__ row_inv_l,
                          const float* __restrict__ row_c, int n, float scale_log2, float scale) {
  __shared__ __align__(16) float sq[kTile * D];
  __shared__ __align__(16) float sdo[kTile * D];
  __shared__ float sm[kTile], sl[kTile], sc[kTile];

  const int tiles = n / kBlockRows;
  const int bh = blockIdx.x / tiles;
  const int key = (blockIdx.x % tiles) * kBlockRows + threadIdx.x;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const size_t stats = static_cast<size_t>(bh) * n;

  float k_row[D], v_row[D], acc_k[D], acc_v[D];
  const T* kp = k + head + static_cast<size_t>(key) * D;
  const T* vp = v + head + static_cast<size_t>(key) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    k_row[c] = to_f32(kp[c]);
    v_row[c] = to_f32(vp[c]);
    acc_k[c] = 0.f;
    acc_v[c] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage(sq, q + head + static_cast<size_t>(q0) * D, kTile * D);
    stage(sdo, dout + head + static_cast<size_t>(q0) * D, kTile * D);
    if (threadIdx.x < kTile) {
      sm[threadIdx.x] = row_m[stats + q0 + threadIdx.x];
      sl[threadIdx.x] = row_inv_l[stats + q0 + threadIdx.x];
      sc[threadIdx.x] = row_c[stats + q0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float p = exp2f(score(dot_row<D>(k_row, sq + j * D), scale_log2) - sm[j]) * sl[j];
      axpy_row<D>(acc_v, p, sdo + j * D);
      const float ds = p * (dot_row<D>(v_row, sdo + j * D) - sc[j]);
      axpy_row<D>(acc_k, ds, sq + j * D);
    }
  }

  T* dkp = dk + head + static_cast<size_t>(key) * D;
  T* dvp = dv + head + static_cast<size_t>(key) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dkp[c] = from_f32<T>(acc_k[c] * scale);
    dvp[c] = from_f32<T>(acc_v[c]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                   void* dv, float* stats, int bh, int n, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(bh) * (n / kBlockRows);
  if (blocks <= 0 || blocks > INT32_MAX) return cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float scale_log2 = 1.4426950408889634f * scale;
  const size_t rows = static_cast<size_t>(bh) * n;
  float* row_m = stats;
  float* row_inv_l = stats + rows;
  float* row_c = stats + 2 * rows;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  attention_bwd_dq_kernel<T, D><<<static_cast<unsigned>(blocks), kBlockRows, 0, stream>>>(
      tq, tk, tv, tdo, static_cast<T*>(dq), row_m, row_inv_l, row_c, n, scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T, D><<<static_cast<unsigned>(blocks), kBlockRows, 0, stream>>>(
      tq, tk, tv, tdo, static_cast<T*>(dk), static_cast<T*>(dv), row_m, row_inv_l, row_c, n,
      scale_log2, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, float* stats, int bh, int n, int d, cudaStream_t stream) {
  switch (d) {
    case 2: return launch<T, 2>(q, k, v, dout, dq, dk, dv, stats, bh, n, stream);
    case 4: return launch<T, 4>(q, k, v, dout, dq, dk, dv, stats, bh, n, stream);
    case 8: return launch<T, 8>(q, k, v, dout, dq, dk, dv, stats, bh, n, stream);
    case 16: return launch<T, 16>(q, k, v, dout, dq, dk, dv, stats, bh, n, stream);
    case 32: return launch<T, 32>(q, k, v, dout, dq, dk, dv, stats, bh, n, stream);
    case 64: return launch<T, 64>(q, k, v, dout, dq, dk, dv, stats, bh, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: (bh, n, d) contiguous, all of one dtype (0 =
// float32, 1 = bfloat16). stats: 3·bh·n float32 scratch (row max, 1/row sum,
// rowsum(dP∘P)), written by the first kernel and read by the second. Returns a
// cudaError_t (0 = success) taken with cudaGetLastError() after each launch.
// Does not synchronise.
int attention_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                  void* dv, void* stats, int bh, int n, int d, int dtype, void* stream) {
  if (n <= 0 || n % kBlockRows != 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, dout, dq, dk, dv, st, bh, n, d, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, st, bh, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
