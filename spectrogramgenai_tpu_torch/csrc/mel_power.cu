// Fused mel power spectrogram for Hopper (sm_90a):
//   (B, N) f32 audio → centred zero-padded frames → Hann-folded real DFT →
//   re² + im² → mel filterbank → (B, T, n_mels) f32.
//
// Replaces the two Pallas kernels behind spectrogramgenai_tpu/ops/mel_kernel.py
// fused_mel_power, one kernel per precision rung:
//   mel_power_exact_kernel       _mel_kernel (:94) with exact=True (HIGHEST):
//                                float32 operands, scalar FMA outside the
//                                tensor cores, the DFT sums in float64.
//   mel_power_mma_kernel<2>      _mel_kernel_3pass (:147), exact="high": each
//                                product as three bf16 tensor-core products of
//                                hi/lo splits, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi.
//   mel_power_mma_kernel<1>      _mel_kernel (:94) with exact=False (DEFAULT):
//                                each product as one bf16 tensor-core product
//                                of operands rounded to bf16.
//
// What bounds it on Hopper. At the front end's batch (64 clips of 6 s at
// 22,050 Hz, n_fft 2048, hop 384: T = 345 frames, 1,025 bins) the DFT product
// is 2·2·T·n_fft·bins = 2.9e9 flop per clip and the mel product 1.8e8, about
// 2e11 flop per batch, against ~34 MB of audio in, 23 MB out and 17–35 MB of
// constants (by rung) that stay in the 50 MB L2. So every rung is bound by issue, not
// bytes: scalar FMA for the exact rung (67 TFLOP/s in float32, half that in
// float64), about 3 ms at best; bf16 tensor cores (989 TFLOP/s) for the
// others: ~0.2 ms for one product ("fast"), ×3 for "high".
//
// Why the exact rung sums in float64. Far from a loud tone the DFT's running
// sums swing far above their final value, and float32 rounding of those
// partial sums (not of the products, which an FMA keeps exact) leaves
// 0.001–0.004 dB at the quiet bins after the log, above the rung's bound of
// 0.0005 dB typical / 0.0014 dB adversarial, even with the sums blocked in
// chunks of 4 to 64 samples. A product of two float32 values is exact in
// float64, so DFMA accumulation leaves only the float32 rounding of the DFT
// matrices themselves (~3e-4 dB).
//
// What the design does about it.
//  - No framing copy: frame f of a clip starts at sample f·hop of the padded
//    signal, so a block stages the stretch of audio its 64 frames cover in
//    shared memory once and reads every frame as a strided view of it.
//  - The power stays on chip: one block owns one (clip, 64-frame tile) and
//    walks all frequency blocks in a loop (the TPU kernel's sequential
//    "arbitrary" grid dimension). For each it computes re and im, the power,
//    and adds power·fbᵀ into a mel accumulator held in registers. The (B, T,
//    bins) power never reaches device memory, and no atomics are used, so a
//    result is the same from run to run.
//  - The constant matrices are laid out on the host in the order the threads
//    read them (ops/mel_kernel.py), so each lane loads its operands with
//    16-byte loads straight from L2/L1, with no shared-memory staging.
//  - Exact: the staged audio is widened to float64 once (no conversion in
//    the loop), and the DFT matrices' float32 values are stored as float64.
//    A warp owns 8 frames and a lane one bin of a 32-bin block; two samples
//    of a frame are one warp-wide broadcast load from shared memory, and a
//    lane's Wc and Ws values for them two 16-byte loads.
//  - high / fast: a warp owns 16 frames; per 16-bin block it runs
//    mma.sync.m16n8k16 (bf16 in, f32 accumulation) for re and im, forms the
//    power in the accumulator registers, which are already laid out as the A
//    operand of the next m16n8k16, and multiplies by the filterbank there.
//    "high" splits the audio into bf16 hi + lo as it is staged and the power
//    in registers, and sums the DFT terms with a lo part in their own
//    accumulators; "fast" rounds both to bf16. wgmma and TMA are later work.
//
// Built by spectrogramgenai_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileFrames = 64;  // frames per block
constexpr int kMels = 256;       // mel columns of the accumulator (n_mels ≤ 256, zero-padded)

// ---------------------------------------------------------------- exact rung

constexpr int kExactThreads = 256;      // 8 warps × 8 frames
constexpr int kExactWarpFrames = 8;
constexpr int kExactBins = 32;          // one bin per lane
constexpr int kExactPStride = kTileFrames + 4;  // power tile row stride (floats), conflict-free stores

// audio: (B, n). wx: (n_fft/2, nbp, 2) double2, [k/2][bin][m] = (W_m[k][bin], W_m[k+1][bin]) for
// m = Wc, Ws (float32 values held as float64). fbt: (nbp, kMels) float32 = filterbankᵀ,
// zero-padded. out: (B, t_frames, n_mels).
__global__ void __launch_bounds__(kExactThreads, 1)
mel_power_exact_kernel(const float* __restrict__ audio, const double2* __restrict__ wx,
                       const float* __restrict__ fbt, float* __restrict__ out, int n, int t_frames,
                       int n_fft, int hop, int pad, int nbp, int n_mels) {
  extern __shared__ double2 smem_exact[];
  const int span_len = (kTileFrames - 1) * hop + n_fft;
  double* span = reinterpret_cast<double*>(smem_exact);
  float* ptile = reinterpret_cast<float*>(span + span_len);  // (kExactBins, kExactPStride)

  const int b = blockIdx.y;
  const int f_base = blockIdx.x * kTileFrames;
  const float* x = audio + static_cast<size_t>(b) * n;
  const long first = static_cast<long>(f_base) * hop - pad;
  for (int i = threadIdx.x; i < span_len; i += kExactThreads) {
    const long s = first + i;
    span[i] = (s >= 0 && s < n) ? static_cast<double>(x[s]) : 0.0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fw = warp * kExactWarpFrames;  // the warp's first frame in the tile
  const double* wspan = span + fw * hop;

  float mel[kExactWarpFrames][8];  // frames fw+i, mels lane + 32·m
#pragma unroll
  for (int i = 0; i < kExactWarpFrames; ++i)
#pragma unroll
    for (int m = 0; m < 8; ++m) mel[i][m] = 0.f;

  const size_t w_row = static_cast<size_t>(nbp) * 2;  // double2 per 2 samples
  for (int jb = 0; jb < nbp / kExactBins; ++jb) {
    const int bin = jb * kExactBins + lane;
    double re[kExactWarpFrames], im[kExactWarpFrames];
#pragma unroll
    for (int i = 0; i < kExactWarpFrames; ++i) re[i] = im[i] = 0.0;

    const double2* wp = wx + static_cast<size_t>(bin) * 2;
#pragma unroll 4
    for (int k = 0; k < n_fft; k += 2) {
      const double2 wc = __ldg(wp + (k / 2) * w_row);
      const double2 ws = __ldg(wp + (k / 2) * w_row + 1);
#pragma unroll
      for (int i = 0; i < kExactWarpFrames; ++i) {
        const double2 a = *reinterpret_cast<const double2*>(wspan + i * hop + k);  // broadcast
        re[i] = fma(a.x, wc.x, re[i]);
        re[i] = fma(a.y, wc.y, re[i]);
        im[i] = fma(a.x, ws.x, im[i]);
        im[i] = fma(a.y, ws.y, im[i]);
      }
    }

    float* prow = ptile + lane * kExactPStride + fw;
#pragma unroll
    for (int i = 0; i < kExactWarpFrames; i += 4) {
      float4 p;
      p.x = static_cast<float>(re[i] * re[i] + im[i] * im[i]);
      p.y = static_cast<float>(re[i + 1] * re[i + 1] + im[i + 1] * im[i + 1]);
      p.z = static_cast<float>(re[i + 2] * re[i + 2] + im[i + 2] * im[i + 2]);
      p.w = static_cast<float>(re[i + 3] * re[i + 3] + im[i + 3] * im[i + 3]);
      *reinterpret_cast<float4*>(prow + i) = p;
    }
    __syncthreads();  // the whole power tile of this bin block is in shared memory

    const float* fb = fbt + static_cast<size_t>(jb) * kExactBins * kMels + lane;
#pragma unroll 2
    for (int j = 0; j < kExactBins; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(ptile + j * kExactPStride + fw);
      const float4 p1 = *reinterpret_cast<const float4*>(ptile + j * kExactPStride + fw + 4);
      const float p[kExactWarpFrames] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float f = __ldg(fb + j * kMels + 32 * m);
#pragma unroll
        for (int i = 0; i < kExactWarpFrames; ++i) mel[i][m] = fmaf(p[i], f, mel[i][m]);
      }
    }
    __syncthreads();  // the power tile is read before the next bin block overwrites it
  }

#pragma unroll
  for (int i = 0; i < kExactWarpFrames; ++i) {
    const int f = f_base + fw + i;
    if (f >= t_frames) break;
    float* o = out + (static_cast<size_t>(b) * t_frames + f) * n_mels;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int col = lane + 32 * m;
      if (col < n_mels) o[col] = mel[i][m];
    }
  }
}

// --------------------------------------------------------- high / fast rungs

constexpr int kMmaThreads = 128;  // 4 warps × 16 frames
constexpr int kMmaBins = 16;      // bins per block step: two n8 tiles
constexpr int kRowPad = 8;        // bf16 of padding per span row: conflict-free A loads

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_k, __nv_bfloat16 hi_k) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_k)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi_k)) << 16);
}

// Splits two f32 values into bf16 hi (round to nearest even) and lo = x − hi.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// PARTS is the number of bf16 parts of every operand: 2 for "high" (hi, lo:
// a·b as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi), 1 for "fast" (one bf16 product).
// wf: per (16-bin block jb, 16-sample step s, part, matrix m ∈ {Wc, Ws}), 32 lanes × uint4:
//   the lane's B fragments {n8 tile 0: b01, b23; n8 tile 1: b01, b23}.
// fbf: per (jb, mel tile pair u2, part), 32 lanes × uint4: {tile 2·u2: b01, b23; tile 2·u2+1: b01, b23}.
// For "fast", asking for two blocks per SM makes ptxas keep 222 registers
// instead of 172, and the kernel then takes 2.1 ms instead of 5.6 ms at the
// front end's batch on an H100; "high" keeps its 255 either way.
template <int PARTS>
__global__ void __launch_bounds__(kMmaThreads, PARTS == 1 ? 2 : 1)
mel_power_mma_kernel(const float* __restrict__ audio, const uint4* __restrict__ wf,
                     const uint4* __restrict__ fbf, float* __restrict__ out, int n, int t_frames,
                     int n_fft, int hop, int pad, int n_jb, int n_mels) {
  extern __shared__ uint4 smem_mma[];
  const int span_rows = kTileFrames + (n_fft - 1) / hop;
  const int stride = hop + kRowPad;  // bf16 per span row
  __nv_bfloat16* span_hi = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* span_lo = span_hi + span_rows * stride;

  // row r, column c of the span is sample (f_base + r)·hop + c of the padded
  // clip, so frame f (local), sample k is at row f + k / hop, column k % hop
  const int b = blockIdx.y;
  const int f_base = blockIdx.x * kTileFrames;
  const float* x = audio + static_cast<size_t>(b) * n;
  const long first = static_cast<long>(f_base) * hop - pad;
  for (int i = threadIdx.x; i < span_rows * hop; i += kMmaThreads) {
    const long s = first + i;
    const float v = (s >= 0 && s < n) ? x[s] : 0.f;
    const int r = i / hop, c = i - r * hop;
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    span_hi[r * stride + c] = h;
    if constexpr (PARTS == 2) span_lo[r * stride + c] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
  __syncthreads();  // the only barrier: a warp with no frames may leave after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fw = warp * 16;
  if (f_base + fw >= t_frames) return;
  const int g = lane / 4, q = lane % 4;  // fragment row group and column pair

  float mel[kMels / 8][4];
#pragma unroll
  for (int u = 0; u < kMels / 8; ++u) mel[u][0] = mel[u][1] = mel[u][2] = mel[u][3] = 0.f;

  const int steps = n_fft / 16;
  for (int jb = 0; jb < n_jb; ++jb) {
    float re[2][4] = {}, im[2][4] = {};
    float re_c[2][4] = {}, im_c[2][4] = {};  // the terms with a lo part, summed apart
    const uint4* wp = wf + static_cast<size_t>(jb) * steps * PARTS * 64 + lane;
    // the lane's A elements of step s: row fw + g + 16s / hop, column 16s % hop + 2q
    int off = (fw + g) * stride + 2 * q, col = 0;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)  // rows g, g + 8; columns 2q, 2q + 8
        a[r] = *reinterpret_cast<const uint32_t*>(span_hi + off + (r & 1) * 8 * stride + (r >> 1) * 8);
      const uint4* ws = wp + static_cast<size_t>(s) * PARTS * 64;
      const uint4 bc = __ldg(ws), bs = __ldg(ws + 32);
      mma_bf16(re[0], a, bc.x, bc.y);
      mma_bf16(re[1], a, bc.z, bc.w);
      mma_bf16(im[0], a, bs.x, bs.y);
      mma_bf16(im[1], a, bs.z, bs.w);
      if constexpr (PARTS == 2) {
        uint32_t al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          al[r] = *reinterpret_cast<const uint32_t*>(span_lo + off + (r & 1) * 8 * stride + (r >> 1) * 8);
        mma_bf16(re_c[0], al, bc.x, bc.y);
        mma_bf16(re_c[1], al, bc.z, bc.w);
        mma_bf16(im_c[0], al, bs.x, bs.y);
        mma_bf16(im_c[1], al, bs.z, bs.w);
        const uint4 lc = __ldg(ws + 64), ls = __ldg(ws + 96);
        mma_bf16(re_c[0], a, lc.x, lc.y);
        mma_bf16(re_c[1], a, lc.z, lc.w);
        mma_bf16(im_c[0], a, ls.x, ls.y);
        mma_bf16(im_c[1], a, ls.z, ls.w);
      }
      off += 16;
      col += 16;
      if (col == hop) {  // on to the next span row
        col = 0;
        off += kRowPad;
      }
    }

    // power, in the accumulator layout of the two n8 tiles, is the A operand
    // (16 frames × 16 bins) of the filterbank product: tile t's {c0, c1} and
    // {c2, c3} are a[2t] and a[2t + 1]
    float pw[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = re[t][e] + re_c[t][e], i = im[t][e] + im_c[t][e];
        pw[t][e] = r * r + i * i;
      }
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if constexpr (PARTS == 2) {
        split2(pw[t][0], pw[t][1], ph[2 * t], pl[2 * t]);
        split2(pw[t][2], pw[t][3], ph[2 * t + 1], pl[2 * t + 1]);
      } else {
        ph[2 * t] = pack_bf16(__float2bfloat16_rn(pw[t][0]), __float2bfloat16_rn(pw[t][1]));
        ph[2 * t + 1] = pack_bf16(__float2bfloat16_rn(pw[t][2]), __float2bfloat16_rn(pw[t][3]));
      }
    }
    const uint4* fp = fbf + static_cast<size_t>(jb) * (kMels / 16) * PARTS * 32 + lane;
#pragma unroll
    for (int u2 = 0; u2 < kMels / 16; ++u2) {
      const uint4 fh = __ldg(fp + u2 * PARTS * 32);
      mma_bf16(mel[2 * u2], ph, fh.x, fh.y);
      mma_bf16(mel[2 * u2 + 1], ph, fh.z, fh.w);
      if constexpr (PARTS == 2) {
        const uint4 fl = __ldg(fp + u2 * PARTS * 32 + 32);
        mma_bf16(mel[2 * u2], ph, fl.x, fl.y);
        mma_bf16(mel[2 * u2 + 1], ph, fl.z, fl.w);
        mma_bf16(mel[2 * u2], pl, fh.x, fh.y);
        mma_bf16(mel[2 * u2 + 1], pl, fh.z, fh.w);
      }
    }
  }

  // accumulator layout: {c0, c1} at row g, columns 2q, 2q+1 of the n8 tile; {c2, c3} at row g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f_base + fw + g + 8 * h;
    if (f >= t_frames) continue;
    float* o = out + (static_cast<size_t>(b) * t_frames + f) * n_mels;
#pragma unroll
    for (int u = 0; u < kMels / 8; ++u) {
      const int col = u * 8 + 2 * q;
      if (col < n_mels) o[col] = mel[u][2 * h];
      if (col + 1 < n_mels) o[col + 1] = mel[u][2 * h + 1];
    }
  }
}

template <int PARTS>
cudaError_t launch_mma(const float* audio, const void* w, const void* fb, float* out, int batch, int n,
                       int t_frames, int n_fft, int hop, int pad, int nbp, int n_mels, cudaStream_t stream) {
  if (nbp % kMmaBins != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(__nv_bfloat16) * PARTS * (kTileFrames + (n_fft - 1) / hop) * (hop + kRowPad);
  cudaError_t err = cudaFuncSetAttribute(mel_power_mma_kernel<PARTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_frames + kTileFrames - 1) / kTileFrames, batch);
  mel_power_mma_kernel<PARTS><<<grid, kMmaThreads, smem, stream>>>(
      audio, static_cast<const uint4*>(w), static_cast<const uint4*>(fb), out, n, t_frames, n_fft, hop, pad,
      nbp / kMmaBins, n_mels);
  return cudaGetLastError();
}

cudaError_t launch_exact(const float* audio, const void* w, const void* fb, float* out, int batch, int n,
                         int t_frames, int n_fft, int hop, int pad, int nbp, int n_mels, cudaStream_t stream) {
  if (nbp % kExactBins != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * ((kTileFrames - 1) * hop + n_fft) + sizeof(float) * kExactBins * kExactPStride;
  cudaError_t err = cudaFuncSetAttribute(mel_power_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_frames + kTileFrames - 1) / kTileFrames, batch);
  mel_power_exact_kernel<<<grid, kExactThreads, smem, stream>>>(
      audio, static_cast<const double2*>(w), static_cast<const float*>(fb), out, n, t_frames, n_fft, hop, pad,
      nbp, n_mels);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rung: 0 = exact, 1 = high, 2 = fast. w and fb are the rung's constants as
// laid out by ops/mel_kernel.py; nbp is the bin count they are padded to.
// Returns a cudaError_t (0 = success) taken with cudaGetLastError() right
// after the launch. Does not synchronise.
int mel_power(const float* audio, const void* w, const void* fb, float* out, int batch, int n, int t_frames,
              int n_fft, int hop, int pad, int nbp, int n_mels, int rung, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || t_frames <= 0 || n_fft <= 0 || n_fft % 16 != 0 ||
      hop <= 0 || hop % 16 != 0 || pad < 0 || n_mels <= 0 || n_mels > kMels || nbp <= 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case 0: return launch_exact(audio, w, fb, out, batch, n, t_frames, n_fft, hop, pad, nbp, n_mels, s);
    case 1: return launch_mma<2>(audio, w, fb, out, batch, n, t_frames, n_fft, hop, pad, nbp, n_mels, s);
    case 2: return launch_mma<1>(audio, w, fb, out, batch, n, t_frames, n_fft, hop, pad, nbp, n_mels, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* mel_power_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
