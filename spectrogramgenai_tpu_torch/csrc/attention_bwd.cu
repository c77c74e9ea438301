// Fused self-attention backward for Hopper (sm_90a): the softmax VJP of
// o = softmax(q·kᵀ/√d)·v, given dO.
//
// Replaces spectrogramgenai_tpu/ops/attention.py::_bwd_kernel, the Pallas
// kernel behind fused_attention's custom VJP on the training path. Same
// function, with P recomputed from q and k (never stored):
//   dV = Pᵀ·dO;  dP = dO·Vᵀ;  c = rowsum(dP ∘ P);  dS = P ∘ (dP − c);
//   dQ = scale·dS·K;  dK = scale·dSᵀ·Q,
// with f32 accumulation and dq, dk, dv written in the input type.
//
// What bounds it on Hopper. At the training shapes (B·H = 128, N = 1024 or
// 4096, d = 16 or 32) the inputs are a few MB, but every (query, key) pair
// costs five d-long products and the elementwise work on P and dS. On the
// bf16 tensor cores the products are cheap (0.41 ms over the three sites at
// 989 TFLOP/s); what is left per pair is the exponential (MUFU, ~4.2e12/s on
// an H100) and ~10 f32 operations. At d = 16 that elementwise work, not the
// products, is the floor: two exponentials per pair over 2.42e9 pairs is
// ~1.15 ms. The one thing that must not happen is writing an (N, N) matrix
// to device memory.
//
// What the design does about it.
//  - Residuals. Under autograd the forward (csrc/attention_fwd.cu) saves
//    the row log-sum-exp lse (exp2 domain) and its output in f32, O₃₂. Then
//    P = exp2(s − lse) needs no row statistics pass, and c = rowsum(dP∘P) =
//    rowsum(dO∘O₃₂), from the f32 output (the bf16 one would leave 2⁻⁹ of
//    rounding in c). P is recomputed twice, once per kernel, instead of
//    three times.
//  - bf16 (the training path): two kernels on mma.sync.m16n8k16 (bf16 in,
//    f32 accumulation) for all five products. A block is 8 warps of 16 rows.
//    attention_bwd_dq_mma owns 128 query rows: it forms c for them, then
//    streams K and V through shared memory (cp.async, double-buffered) and
//    per 64-key tile computes S = Q·Kᵀ and dP = dO·Vᵀ, P and dS in the
//    accumulator registers, and dQ += dS·K. attention_bwd_dkdv_mma owns 128
//    key rows and streams Q, dO, lse and c: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, then
//    dV += Pᵀ·dO and dK += dSᵀ·Q. The accumulators of S and dP are already
//    laid out as the A operand of the next product (two n8 tiles make one
//    k16 step), so P and dS never leave registers. No sum crosses a block:
//    no atomics, the same result from run to run.
//  - Rounding. P and dS enter the products as bf16 hi + lo pairs
//    (x = hi + lo, each bf16; two products against the exact bf16 operand).
//    With one bf16 each, a plain emulation on the CPU
//    (tools/port_bwd_rounding.py) reads up to 6.6e-3 (dQ) and 5.4e-3 (dV)
//    per row against float64 at the training shapes, above the 5e-3
//    tolerance, and 0.24–0.49 for dQ of a large-logit head (Σ dS = 0 is lost
//    when dS is rounded, and a key component of 200 amplifies it); with the
//    pairs it reads the bf16 rounding of the outputs alone.
//  - The score is s = (q·k)·log2(e)/√d, the product rounded on its own
//    (__fmul_rn), exactly as the forward takes it when it writes lse, so that
//    P of a row of equal logits is 1/N exactly.
//  - float32 inputs, on no main path, keep the scalar kernels: one thread per
//    row, a dQ kernel whose first pass recomputes the row max, sum and c,
//    and a dK/dV kernel that reads them (P three times, no tensor cores).
//
// Built by spectrogramgenai_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ------------------------------------------------------ float32: scalar

constexpr int kBlockRows = 128;  // query rows (kernel 1) or key rows (kernel 2) per block
constexpr int kTile = 64;        // rows staged in shared memory per tile
constexpr int kChunk = 16;       // keys scored between two online-softmax rescales

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

__device__ __forceinline__ void stage(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count; i += kBlockRows) dst[i] = src[i];
}

// Kernel 1: dQ and the row statistics. q, k, v, dout, dq: (bh, n, D)
// contiguous; row_m, row_inv_l, row_c: (bh, n) f32. Grid: bh · (n / 128)
// blocks, the query tiles of one (b, h) adjacent so that its K and V stay hot
// in L2.
template <int D>
__global__ void __launch_bounds__(kBlockRows)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ row_m,
                        float* __restrict__ row_inv_l, float* __restrict__ row_c, int n, float scale_log2,
                        float scale) {
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ __align__(16) float sv[kTile * D];

  const int tiles = n / kBlockRows;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kBlockRows + threadIdx.x;
  const size_t head = static_cast<size_t>(bh) * n * D;
  const size_t stat = static_cast<size_t>(bh) * n + row;

  float q_row[D], do_row[D];
  const float* qp = q + head + static_cast<size_t>(row) * D;
  const float* dop = dout + head + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    q_row[c] = qp[c];
    do_row[c] = dop[c];
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

  float* dqp = dq + head + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) dqp[c] = acc[c] * scale;
  row_m[stat] = m;
  row_inv_l[stat] = inv_l;
  row_c[stat] = c_row;
}

// Kernel 2: dK and dV, one thread per key row; reads kernel 1's row
// statistics. Same grid as kernel 1, over key tiles.
template <int D>
__global__ void __launch_bounds__(kBlockRows)
attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
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
  const float* kp = k + head + static_cast<size_t>(key) * D;
  const float* vp = v + head + static_cast<size_t>(key) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    k_row[c] = kp[c];
    v_row[c] = vp[c];
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

  float* dkp = dk + head + static_cast<size_t>(key) * D;
  float* dvp = dv + head + static_cast<size_t>(key) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dkp[c] = acc_k[c] * scale;
    dvp[c] = acc_v[c];
  }
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout, float* dq, float* dk,
                       float* dv, float* stats, int bh, int n, float scale_log2, float scale,
                       cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(bh) * (n / kBlockRows));
  const size_t rows = static_cast<size_t>(bh) * n;
  float* row_m = stats;
  float* row_inv_l = stats + rows;
  float* row_c = stats + 2 * rows;
  attention_bwd_dq_kernel<D><<<blocks, kBlockRows, 0, stream>>>(q, k, v, dout, dq, row_m, row_inv_l, row_c, n,
                                                                scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<D><<<blocks, kBlockRows, 0, stream>>>(q, k, v, dout, dk, dv, row_m, row_inv_l,
                                                                  row_c, n, scale_log2, scale);
  return cudaGetLastError();
}

// ------------------------------------------------- bfloat16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMmaRows = 128;    // query rows (dq kernel) or key rows (dk/dv kernel) per block
constexpr int kMmaThreads = 256;  // 8 warps × 16 rows
constexpr int kMmaTile = 64;     // keys (dq kernel) or queries (dk/dv kernel) per staged tile
constexpr int kMmaSub = 32;      // of which a warp scores this many at a time (register pressure)

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

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x0, x1 → bf16 pairs hi (round to nearest even) and lo = bf16(x − hi).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Rows [0, 64) of a (·, d) bf16 matrix into a shared tile of row stride
// DP + 8 (conflict-free ldmatrix), columns d … DP − 1 zero. Whole 16-byte
// rows go by cp.async; a head dim under 16 is widened element by element.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int d) {
  constexpr int kStride = DP + 8;
  if (d == DP) {
    constexpr int kChunks = DP / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kMmaTile * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      cp_async16(dst + r * kStride + c, src + static_cast<size_t>(r) * DP + c);
    }
  } else {
    for (int i = threadIdx.x; i < kMmaTile * DP; i += kMmaThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * kStride + c] = c < d ? src[static_cast<size_t>(r) * d + c] : __float2bfloat16(0.f);
    }
  }
}

// The A fragments (16 rows × DP, k-steps of 16) of rows [0, 16) of a (·, d)
// bf16 matrix in device memory, for lane (g, qd).
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[DP / 16][4], const bf16* src, int d, int g, int qd) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1), col = 16 * kk + 2 * qd + 8 * (r >> 1);
      const bf16* p = src + static_cast<size_t>(row) * d + col;
      if (d == DP) {
        a[kk][r] = *reinterpret_cast<const uint32_t*>(p);
      } else {
        const float x0 = col < d ? __bfloat162float(p[0]) : 0.f;
        const float x1 = col + 1 < d ? __bfloat162float(p[1]) : 0.f;
        a[kk][r] = pack_bf16(x0, x1);
      }
    }
}

// acc (16 rows × 8·kMmaSub/8 columns of one warp) += A · Bᵀ, with B's rows
// [0, kMmaSub) read from a shared tile (rows = the product's columns).
template <int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[kMmaSub / 8][4], const uint32_t (&a)[DP / 16][4],
                                        const bf16* tile, int lane) {
  constexpr int kStride = DP + 8;
  // non-transposed x4: matrices (rows +0…7, cols +0…7), (+0…7, +8…15), (+8…15, +0…7), (+8…15, +8…15)
  const bf16* base = tile + ((lane & 7) + ((lane >> 4) << 3)) * kStride + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int j2 = 0; j2 < kMmaSub / 16; ++j2)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, base + 16 * j2 * kStride + 16 * kk);
      mma_bf16(acc[2 * j2], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * j2 + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 rows × DP) += (hi + lo) · B, with the k-steps of hi and lo (16
// columns each, kMmaSub in all) taken against rows [0, kMmaSub) of a shared
// tile (rows = the product's k index).
template <int DP>
__device__ __forceinline__ void mma_ab2(float (&acc)[DP / 8][4], const uint32_t (&hi)[kMmaSub / 16][4],
                                        const uint32_t (&lo)[kMmaSub / 16][4], const bf16* tile, int lane) {
  constexpr int kStride = DP + 8;
  // transposed x4: matrices (k +0…7, n +0…7), (k +8…15, n +0…7), (k +0…7, n +8…15), (k +8…15, n +8…15)
  const bf16* base = tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kStride + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < kMmaSub / 16; ++kk)
#pragma unroll
    for (int j2 = 0; j2 < DP / 16; ++j2) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + 16 * kk * kStride + 16 * j2);
      mma_bf16(acc[2 * j2], hi[kk], b[0], b[1]);
      mma_bf16(acc[2 * j2 + 1], hi[kk], b[2], b[3]);
      mma_bf16(acc[2 * j2], lo[kk], b[0], b[1]);
      mma_bf16(acc[2 * j2 + 1], lo[kk], b[2], b[3]);
    }
}

// Stores a warp's 16 × DP accumulator (times mul) as bf16 rows of a (·, d) matrix.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DP / 8][4], float mul, int d, int g,
                                           int qd) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * j + 2 * qd;
      bf16* p = dst + static_cast<size_t>(g + 8 * h) * d + col;
      const float x0 = acc[j][2 * h] * mul, x1 = acc[j][2 * h + 1] * mul;
      if (d == DP) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) p[0] = __float2bfloat16(x0);
        if (col + 1 < d) p[1] = __float2bfloat16(x1);
      }
    }
}

// dQ and c. q, k, v, dout, dq: (bh, n, d) bf16; lse, row_c: (bh, n) f32;
// o32: (bh, n, d) f32. DP is d rounded up to a multiple of 16. Grid: bh ·
// (n / 128) blocks, the query blocks of one (b, h) adjacent (K and V hot in
// L2).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, DP <= 32 ? 2 : 1)
attention_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ o32,
                     bf16* __restrict__ dq, float* __restrict__ row_c, int n, int d, float scale_log2,
                     float scale) {
  constexpr int kStride = DP + 8;
  __shared__ __align__(16) bf16 sk[2][kMmaTile * kStride];
  __shared__ __align__(16) bf16 sv[2][kMmaTile * kStride];
  __shared__ float s_lse[kMmaRows], s_c[kMmaRows];

  const int blocks = n / kMmaRows;
  const int bh = blockIdx.x / blocks;
  const int row0 = (blockIdx.x % blocks) * kMmaRows;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const size_t stat = static_cast<size_t>(bh) * n + row0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;

  stage_rows<DP>(sk[0], k + head, d);
  stage_rows<DP>(sv[0], v + head, d);
  cp_async_commit();

  // c = rowsum(dO ∘ O₃₂) of the block's rows, for this kernel and the next
  if (threadIdx.x < kMmaRows) {
    const size_t r = head + static_cast<size_t>(row0 + threadIdx.x) * d;
    float c = 0.f;
    for (int i = 0; i < d; ++i) c = fmaf(__bfloat162float(dout[r + i]), o32[r + i], c);
    s_c[threadIdx.x] = c;
    row_c[stat + threadIdx.x] = c;
    s_lse[threadIdx.x] = lse[stat + threadIdx.x];
  }
  const int wrow = warp * 16;
  uint32_t qa[DP / 16][4], doa[DP / 16][4];
  load_a<DP>(qa, q + head + static_cast<size_t>(row0 + wrow) * d, d, g, qd);
  load_a<DP>(doa, dout + head + static_cast<size_t>(row0 + wrow) * d, d, g, qd);
  __syncthreads();
  const float lse_r[2] = {s_lse[wrow + g], s_lse[wrow + g + 8]};
  const float c_r[2] = {s_c[wrow + g], s_c[wrow + g + 8]};

  float acc[DP / 8][4] = {};
  const int tiles = n / kMmaTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {  // the next tile streams in while this one is used
      stage_rows<DP>(sk[buf ^ 1], k + head + static_cast<size_t>(t + 1) * kMmaTile * d, d);
      stage_rows<DP>(sv[buf ^ 1], v + head + static_cast<size_t>(t + 1) * kMmaTile * d, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int sub = 0; sub < kMmaTile; sub += kMmaSub) {
      const bf16* tk = sk[buf] + sub * kStride;
      float s[kMmaSub / 8][4] = {}, dp[kMmaSub / 8][4] = {};
      mma_abt<DP>(s, qa, tk, lane);
      mma_abt<DP>(dp, doa, sv[buf] + sub * kStride, lane);
      // dS as the A operand of dS·K: n8 tile j's {c0, c1} and {c2, c3} are
      // registers 2·(j % 2) and 2·(j % 2) + 1 of k-step j / 2
      uint32_t hi[kMmaSub / 16][4], lo[kMmaSub / 16][4];
#pragma unroll
      for (int j = 0; j < kMmaSub / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(__fmul_rn(s[j][2 * h + e], scale_log2) - lse_r[h]);
            ds[e] = p * (dp[j][2 * h + e] - c_r[h]);
          }
          split_pair(ds[0], ds[1], hi[j / 2][2 * (j % 2) + h], lo[j / 2][2 * (j % 2) + h]);
        }
      mma_ab2<DP>(acc, hi, lo, tk, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<DP>(dq + head + static_cast<size_t>(row0 + wrow) * d, acc, scale, d, g, qd);
}

// dK and dV; reads the dq kernel's c. Same shapes and grid, over key blocks.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, DP <= 32 ? 2 : 1)
attention_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ row_c, bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int d,
                       float scale_log2, float scale) {
  constexpr int kStride = DP + 8;
  __shared__ __align__(16) bf16 sq[2][kMmaTile * kStride];
  __shared__ __align__(16) bf16 sdo[2][kMmaTile * kStride];
  __shared__ __align__(16) float s_lse[2][kMmaTile];
  __shared__ __align__(16) float s_c[2][kMmaTile];

  const int blocks = n / kMmaRows;
  const int bh = blockIdx.x / blocks;
  const int key0 = (blockIdx.x % blocks) * kMmaRows;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const size_t stats = static_cast<size_t>(bh) * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;

  auto stage = [&](int t, int buf) {
    stage_rows<DP>(sq[buf], q + head + static_cast<size_t>(t) * kMmaTile * d, d);
    stage_rows<DP>(sdo[buf], dout + head + static_cast<size_t>(t) * kMmaTile * d, d);
    constexpr int kChunks = kMmaTile / 4;  // 16-byte chunks of one statistic
    if (threadIdx.x < kChunks)
      cp_async16(s_lse[buf] + 4 * threadIdx.x, lse + stats + t * kMmaTile + 4 * threadIdx.x);
    else if (threadIdx.x < 2 * kChunks)
      cp_async16(s_c[buf] + 4 * (threadIdx.x - kChunks), row_c + stats + t * kMmaTile + 4 * (threadIdx.x - kChunks));
    cp_async_commit();
  };
  stage(0, 0);

  const int wkey = key0 + warp * 16;
  uint32_t ka[DP / 16][4], va[DP / 16][4];
  load_a<DP>(ka, k + head + static_cast<size_t>(wkey) * d, d, g, qd);
  load_a<DP>(va, v + head + static_cast<size_t>(wkey) * d, d, g, qd);

  float acc_k[DP / 8][4] = {}, acc_v[DP / 8][4] = {};
  const int tiles = n / kMmaTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int sub = 0; sub < kMmaTile; sub += kMmaSub) {
      const bf16* tq = sq[buf] + sub * kStride;
      const bf16* tdo = sdo[buf] + sub * kStride;
      float s[kMmaSub / 8][4] = {}, dp[kMmaSub / 8][4] = {};
      mma_abt<DP>(s, ka, tq, lane);    // Sᵀ: keys × queries
      mma_abt<DP>(dp, va, tdo, lane);  // dPᵀ
      uint32_t p_hi[kMmaSub / 16][4], p_lo[kMmaSub / 16][4], ds_hi[kMmaSub / 16][4], ds_lo[kMmaSub / 16][4];
#pragma unroll
      for (int j = 0; j < kMmaSub / 8; ++j) {
        // this lane's two query columns of n8 tile j
        const int col = sub + 8 * j + 2 * qd;
        const float2 l2 = *reinterpret_cast<const float2*>(s_lse[buf] + col);
        const float2 c2 = *reinterpret_cast<const float2*>(s_c[buf] + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = ex2(__fmul_rn(s[j][2 * h], scale_log2) - l2.x);
          const float p1 = ex2(__fmul_rn(s[j][2 * h + 1], scale_log2) - l2.y);
          const int r = 2 * (j % 2) + h;
          split_pair(p0, p1, p_hi[j / 2][r], p_lo[j / 2][r]);
          split_pair(p0 * (dp[j][2 * h] - c2.x), p1 * (dp[j][2 * h + 1] - c2.y), ds_hi[j / 2][r], ds_lo[j / 2][r]);
        }
      }
      mma_ab2<DP>(acc_v, p_hi, p_lo, tdo, lane);  // dV += Pᵀ·dO
      mma_ab2<DP>(acc_k, ds_hi, ds_lo, tq, lane);  // dK += dSᵀ·Q
    }
    __syncthreads();
  }
  store_rows<DP>(dk + head + static_cast<size_t>(wkey) * d, acc_k, scale, d, g, qd);
  store_rows<DP>(dv + head + static_cast<size_t>(wkey) * d, acc_v, 1.f, d, g, qd);
}

template <int DP>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                        const float* o32, bf16* dq, bf16* dk, bf16* dv, float* row_c, int bh, int n, int d,
                        float scale_log2, float scale, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(bh) * (n / kMmaRows));
  attention_bwd_dq_mma<DP><<<blocks, kMmaThreads, 0, stream>>>(q, k, v, dout, lse, o32, dq, row_c, n, d,
                                                               scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_mma<DP><<<blocks, kMmaThreads, 0, stream>>>(q, k, v, dout, lse, row_c, dk, dv, n, d,
                                                                 scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: (bh, n, d) contiguous, all of one dtype.
//   dtype 0 = float32: lse and o32 are not read; scratch is 3·bh·n float32
//     (row max, 1/row sum, rowsum(dP∘P)), written by the first kernel and
//     read by the second.
//   dtype 1 = bfloat16: lse (bh, n) and o32 (bh, n, d) float32 are the
//     forward's residuals; scratch is bh·n float32 (c), written by the first
//     kernel and read by the second.
// Returns a cudaError_t (0 = success) taken with cudaGetLastError() after
// each launch. Does not synchronise.
int attention_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* o32,
                  void* dq, void* dk, void* dv, void* scratch, int bh, int n, int d, int dtype, void* stream) {
  if (bh <= 0 || n <= 0 || n % kBlockRows != 0 || static_cast<int64_t>(bh) * (n / kBlockRows) > INT32_MAX)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf(static_cast<float>(d));
  const float scale_log2 = 1.4426950408889634f * scale;
  float* st = static_cast<float*>(scratch);
  if (dtype == 0) {
    const auto* a = static_cast<const float*>(q);
    const auto* b = static_cast<const float*>(k);
    const auto* c = static_cast<const float*>(v);
    const auto* e = static_cast<const float*>(dout);
    auto* x = static_cast<float*>(dq);
    auto* y = static_cast<float*>(dk);
    auto* z = static_cast<float*>(dv);
    switch (d) {
      case 2: return launch_f32<2>(a, b, c, e, x, y, z, st, bh, n, scale_log2, scale, s);
      case 4: return launch_f32<4>(a, b, c, e, x, y, z, st, bh, n, scale_log2, scale, s);
      case 8: return launch_f32<8>(a, b, c, e, x, y, z, st, bh, n, scale_log2, scale, s);
      case 16: return launch_f32<16>(a, b, c, e, x, y, z, st, bh, n, scale_log2, scale, s);
      case 32: return launch_f32<32>(a, b, c, e, x, y, z, st, bh, n, scale_log2, scale, s);
      case 64: return launch_f32<64>(a, b, c, e, x, y, z, st, bh, n, scale_log2, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || lse == nullptr || o32 == nullptr) return cudaErrorInvalidValue;
  const auto* a = static_cast<const bf16*>(q);
  const auto* b = static_cast<const bf16*>(k);
  const auto* c = static_cast<const bf16*>(v);
  const auto* e = static_cast<const bf16*>(dout);
  const auto* l = static_cast<const float*>(lse);
  const auto* o = static_cast<const float*>(o32);
  auto* x = static_cast<bf16*>(dq);
  auto* y = static_cast<bf16*>(dk);
  auto* z = static_cast<bf16*>(dv);
  switch (d) {
    case 2:
    case 4:
    case 8:
    case 16: return launch_bf16<16>(a, b, c, e, l, o, x, y, z, st, bh, n, d, scale_log2, scale, s);
    case 32: return launch_bf16<32>(a, b, c, e, l, o, x, y, z, st, bh, n, d, scale_log2, scale, s);
    case 64: return launch_bf16<64>(a, b, c, e, l, o, x, y, z, st, bh, n, d, scale_log2, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
