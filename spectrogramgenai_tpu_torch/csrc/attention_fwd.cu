// Fused self-attention forward for Hopper (sm_90a): softmax(q·kᵀ/√d)·v.
//
// Replaces spectrogramgenai_tpu/ops/attention.py::_fwd_kernel, the Pallas
// kernel behind the UNet's self-attention sites with ≥ 1024 tokens. Same
// function: non-causal, unmasked, f32 accumulation, output in the input type.
//
// What bounds it on Hopper. At the serving shapes (B·H = 216, N = 1024 or
// 4096, d = 16 or 32, bf16) the inputs are a few MB, but every (query, key)
// pair costs 4·d flops in the two products and one exponential. On the bf16
// tensor cores the products take 0.28 ms over the three sites; the
// exponentials (MUFU, 16 a clock per SM, ~4.2e12/s) take ~0.97 ms, and each
// score needs ~5 more f32 operations (scale, max, rescale, cast). At d = 16
// the exponentials, not the products, are the floor. The one thing that
// must not happen is writing the (N, N) scores to device memory, which is
// what the plain PyTorch version does.
//
// What the design does about it (bf16, d ∈ {16, 32, 64}: the main path).
//  - attention_fwd_mma: the flash-attention-2 shape on mma.sync.m16n8k16
//    (bf16 in, f32 accumulation). A block is 8 warps; a warp owns 16 query
//    rows and keeps their Q fragments in registers. K and V stream through
//    shared memory as bf16 in 64-key tiles, double-buffered with cp.async,
//    and are read with ldmatrix (.trans for V). Per tile a warp takes
//    S = Q·Kᵀ (one k-step at d = 16, two at d = 32), the online softmax on
//    the accumulator fragments (row max by two quad shuffles, O rescaled
//    once per tile), and O += P·V with the accumulators of S reused as the
//    A fragments of P (two n8 tiles make one k16 step): P never leaves
//    registers.
//  - Serving (no residuals) follows the JAX kernel's rounding: P enters P·V
//    as one bf16, and the denominator is the f32 sum of those bf16 values
//    (the JAX kernel's ones row): here one more mma per k-step against a B
//    of ones. The scale is applied in the exponent, 2^(dot·c − max·c) as
//    one FMA.
//  - Training (residuals: the row log-sum-exp lse in the exp2 domain and
//    the f32 output O₃₂, which the backward in csrc/attention_bwd.cu
//    reads). One bf16 P would move O₃₂ by ~2⁻⁹, and the backward's
//    c = rowsum(dO∘O₃₂) with it, which loses Σ_j dS_ij = 0. So P enters P·V
//    as bf16 hi + lo (two products against the exact bf16 V), and l and lse
//    are summed from the f32 P. The score is the dot product times
//    log2(e)/√d as a product rounded on its own (__fmul_rn), exactly as the
//    backward takes it, so that P = exp2(s − lse) there is the forward's P
//    (exactly 1/N in a row of equal logits).
//  - The softmax is exact for any logits (no clipping window and no
//    fallback branch, which the TPU kernel needed to keep its vector unit
//    to one pass), and a NaN score propagates to the output.
//
// float32 inputs and bf16 with d ∈ {2, 4, 8} (no main path) keep the first
// design, attention_fwd_kernel: one thread per query row, scalar f32 FMA,
// K and V widened to f32 in shared memory. The route is fixed by the type
// and d, never by a failure.
//
// Built by spectrogramgenai_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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
cudaError_t launch_scalar(const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bh,
                          int n, float scale_log2, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(bh) * (n / kBlockQ));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  if (lse == nullptr)
    attention_fwd_kernel<T, D, false><<<blocks, kBlockQ, 0, stream>>>(tq, tk, tv, static_cast<T*>(o), nullptr,
                                                                       nullptr, n, scale_log2);
  else
    attention_fwd_kernel<T, D, true><<<blocks, kBlockQ, 0, stream>>>(tq, tk, tv, static_cast<T*>(o), lse, o32,
                                                                      n, scale_log2);
  return cudaGetLastError();
}

// ------------------------------------------------- bfloat16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMmaRows = 128;     // query rows per block
constexpr int kMmaThreads = 256;  // 8 warps × 16 rows
constexpr int kMmaTile = 64;      // keys per staged tile: 8 n8 tiles of S, 4 k16 steps of P·V
constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0: the B fragment of the denominator's mma

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8×8 bf16 matrices from shared memory; lanes 8i … 8i + 7 give the
// row addresses of matrix i, register i gets its fragment (row lane / 4,
// columns 2·(lane % 4) and + 1; with .trans, of the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// 2^x on the MUFU unit alone: exp2f adds a range guard for results under
// 2^-126, which only flush a P that adds nothing to any sum here.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) { return *reinterpret_cast<const uint32_t*>(&h); }

// Rows [0, 64) of a (·, D) bf16 matrix into a shared tile of row stride
// D + 8 (conflict-free ldmatrix), in 16-byte cp.async chunks.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kMmaTile * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    cp_async16(dst + r * (D + 8) + c, src + static_cast<size_t>(r) * D + c);
  }
}

// q, k, v, o: (bh, n, D) bf16 contiguous; with RES, lse: (bh, n) and o32:
// (bh, n, D) f32. Grid: bh · (n / 128) blocks, the query blocks of one
// (b, h) adjacent so that its K and V stay hot in L2.
template <int D, bool RES>
__global__ void __launch_bounds__(kMmaThreads, D <= 32 ? 2 : 1)
attention_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  bf16* __restrict__ o, float* __restrict__ lse, float* __restrict__ o32, int n,
                  float scale_log2) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) bf16 sk[2][kMmaTile * kStride];
  __shared__ __align__(16) bf16 sv[2][kMmaTile * kStride];

  const int blocks = n / kMmaRows;
  const int bh = blockIdx.x / blocks;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int row = (blockIdx.x % blocks) * kMmaRows + warp * 16;  // the warp's first query row

  stage_tile<D>(sk[0], k + head);
  stage_tile<D>(sv[0], v + head);
  cp_async_commit();

  // the warp's Q fragments (16 rows × D, k-steps of 16): a[r] holds rows
  // g + 8·(r & 1), columns 16·kk + 2·qd + 8·(r >> 1) and + 1
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      qa[kk][r] = *reinterpret_cast<const uint32_t*>(
          q + head + static_cast<size_t>(row + g + 8 * (r & 1)) * D + 16 * kk + 2 * qd + 8 * (r >> 1));

  // accumulator layout: {c0, c1} at row g, {c2, c3} at row g + 8; index h = row half
  float acc[D / 8][4] = {};
  float den[4] = {};  // serving: the denominator's n8 tile (every column the row sum)
  float l[2] = {0.f, 0.f};  // residuals: this lane's share of the row sums of the f32 P
  // the running row max: of the rounded score s (residuals), of the dot
  // product (serving, where the score is dot·c with c = scale_log2 > 0);
  // and the shift of the exponentials, that max in the exp2 domain
  float m[2] = {-INFINITY, -INFINITY}, shift[2] = {-INFINITY, -INFINITY};

  // non-transposed x4 on K: matrices (keys +0…7, d +0…7), (+0…7, +8…15), (+8…15, +0…7), (+8…15, +8…15)
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * kStride + (((lane >> 3) & 1) << 3);
  // transposed x4 on V: matrices (keys +0…7, d +0…7), (+8…15, +0…7), (+0…7, +8…15), (+8…15, +8…15)
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kStride + ((lane >> 4) << 3);

  const int tiles = n / kMmaTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {  // the next tile streams in while this one is used
      stage_tile<D>(sk[buf ^ 1], k + head + static_cast<size_t>(t + 1) * kMmaTile * D);
      stage_tile<D>(sv[buf ^ 1], v + head + static_cast<size_t>(t + 1) * kMmaTile * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q·Kᵀ: 16 rows × 64 keys, n8 tile j = keys 8j … 8j + 7
    float s[kMmaTile / 8][4] = {};
#pragma unroll
    for (int j2 = 0; j2 < kMmaTile / 16; ++j2)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, sk[buf] + k_off + 16 * j2 * kStride + 16 * kk);
        mma_bf16(s[2 * j2], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * j2 + 1], qa[kk], b[2], b[3]);
      }

    // online softmax: the tile's row max (each row lives in one quad)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (RES) s[j][e] = __fmul_rn(s[j][e], scale_log2);  // not contracted into s − m
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float next = RES ? mx[h] : __fmul_rn(mx[h], scale_log2);
      alpha[h] = ex2(shift[h] - next);  // 0 on the first tile (shift = -inf)
      shift[h] = next;
      m[h] = mx[h];
      if constexpr (RES) l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) den[e] *= alpha[e >> 1];

    // P as the A operand of P·V: n8 tile j's {c0, c1} and {c2, c3} are
    // registers 2·(j % 2) and 2·(j % 2) + 1 of k-step j / 2
    uint32_t hi[kMmaTile / 16][4], lo[kMmaTile / 16][4];
#pragma unroll
    for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p0, p1;
        if constexpr (RES) {
          p0 = ex2(s[j][2 * h] - shift[h]);
          p1 = ex2(s[j][2 * h + 1] - shift[h]);
        } else {
          p0 = ex2(fmaf(s[j][2 * h], scale_log2, -shift[h]));
          p1 = ex2(fmaf(s[j][2 * h + 1], scale_log2, -shift[h]));
        }
        const __nv_bfloat162 ph = __floats2bfloat162_rn(p0, p1);
        hi[j / 2][2 * (j % 2) + h] = bits(ph);
        if constexpr (RES) {
          lo[j / 2][2 * (j % 2) + h] = bits(__floats2bfloat162_rn(p0 - __low2float(ph), p1 - __high2float(ph)));
          l[h] += p0 + p1;
        }
      }

    // O += P·V (and, serving, the denominator += P·1)
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < D / 16; ++j2) {
        uint32_t b[4];
        ldsm_x4_trans(b, sv[buf] + v_off + 16 * kk * kStride + 16 * j2);
        mma_bf16(acc[2 * j2], hi[kk], b[0], b[1]);
        mma_bf16(acc[2 * j2 + 1], hi[kk], b[2], b[3]);
        if constexpr (RES) {
          mma_bf16(acc[2 * j2], lo[kk], b[0], b[1]);
          mma_bf16(acc[2 * j2 + 1], lo[kk], b[2], b[3]);
        }
      }
      if constexpr (!RES) mma_bf16(den, hi[kk], kOnes, kOnes);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  float inv[2], sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (RES) {
      sum[h] = l[h];
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    } else {
      sum[h] = den[2 * h];
    }
    inv[h] = 1.f / sum[h];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = head + static_cast<size_t>(row + g + 8 * h) * D + 8 * j + 2 * qd;
      const float x0 = acc[j][2 * h] * inv[h], x1 = acc[j][2 * h + 1] * inv[h];
      *reinterpret_cast<__nv_bfloat162*>(o + at) = __floats2bfloat162_rn(x0, x1);
      if constexpr (RES) *reinterpret_cast<float2*>(o32 + at) = make_float2(x0, x1);
    }
  if constexpr (RES) {
    if (qd == 0) {
      const size_t at = static_cast<size_t>(bh) * n + row + g;
      lse[at] = m[0] + log2f(sum[0]);
      lse[at + 8] = m[1] + log2f(sum[1]);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bh,
                       int n, float scale_log2, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(bh) * (n / kMmaRows));
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  if (lse == nullptr)
    attention_fwd_mma<D, false><<<blocks, kMmaThreads, 0, stream>>>(tq, tk, tv, static_cast<bf16*>(o), nullptr,
                                                                     nullptr, n, scale_log2);
  else
    attention_fwd_mma<D, true><<<blocks, kMmaThreads, 0, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, o32,
                                                                    n, scale_log2);
  return cudaGetLastError();
}

// bf16 at d ≥ 16 runs on the tensor cores, everything else on the scalar
// kernel; *route says which one was launched (1 tensor cores, 0 scalar)
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bh, int n,
                   float scale_log2, cudaStream_t stream, int* route) {
  if constexpr (std::is_same_v<T, bf16> && D >= 16) {
    *route = 1;
    return launch_mma<D>(q, k, v, o, lse, o32, bh, n, scale_log2, stream);
  } else {
    *route = 0;
    return launch_scalar<T, D>(q, k, v, o, lse, o32, bh, n, scale_log2, stream);
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, float* o32, int bh,
                       int n, int d, cudaStream_t stream, int* route) {
  // as csrc/attention_bwd.cu forms it: the residual score must round alike there
  const float scale_log2 = 1.4426950408889634f * (1.f / sqrtf(static_cast<float>(d)));
  switch (d) {
    case 2: return launch<T, 2>(q, k, v, o, lse, o32, bh, n, scale_log2, stream, route);
    case 4: return launch<T, 4>(q, k, v, o, lse, o32, bh, n, scale_log2, stream, route);
    case 8: return launch<T, 8>(q, k, v, o, lse, o32, bh, n, scale_log2, stream, route);
    case 16: return launch<T, 16>(q, k, v, o, lse, o32, bh, n, scale_log2, stream, route);
    case 32: return launch<T, 32>(q, k, v, o, lse, o32, bh, n, scale_log2, stream, route);
    case 64: return launch<T, 64>(q, k, v, o, lse, o32, bh, n, scale_log2, stream, route);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lse ((bh, n) f32) and o32 ((bh, n, d)
// f32) are both null (no residuals) or both set. bf16 with d ∈ {16, 32, 64}
// runs attention_fwd_mma, everything else attention_fwd_kernel; *route is
// set to the kernel launched (1 = attention_fwd_mma, 0 = attention_fwd_kernel,
// −1 = none). Returns a cudaError_t (0 = success) taken with
// cudaGetLastError() right after the launch. Does not synchronise.
int attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* o32, int bh, int n,
                  int d, int dtype, void* stream, int* route) {
  *route = -1;
  if (bh <= 0 || n <= 0 || n % kBlockQ != 0 || static_cast<int64_t>(bh) * (n / kBlockQ) > INT32_MAX ||
      (lse == nullptr) != (o32 == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* o2 = static_cast<float*>(o32);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, l, o2, bh, n, d, s, route);
    case 1: return dispatch_d<bf16>(q, k, v, o, l, o2, bh, n, d, s, route);
    default: return cudaErrorInvalidValue;
  }
}

const char* attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
