// Fused mel power spectrogram for Hopper (sm_90a):
//   (B, N) f32 audio → centred zero-padded frames → Hann window → power
//   spectrum re² + im² → mel filterbank → (B, T, n_mels) f32.
//
// Replaces the two Pallas kernels behind spectrogramgenai_tpu/ops/mel_kernel.py
// fused_mel_power, one kernel per precision rung:
//   mel_power_fft_kernel<LOG2N>  _mel_kernel (:94) with exact=True (HIGHEST):
//                                a float64 FFT of two frames at once, the
//                                power and the mel sums in float64.
//   mel_power_mma_kernel<2>      _mel_kernel_3pass (:147), exact="high": each
//                                product as three bf16 tensor-core products of
//                                hi/lo splits, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi.
//   mel_power_mma_kernel<1>      _mel_kernel (:94) with exact=False (DEFAULT):
//                                each product as one bf16 tensor-core product
//                                of operands rounded to bf16.
//
// The exact rung is defined by its error against the float64 oracle
// (0.0005 dB typical, 0.0014 dB adversarial), not by the TPU kernel's DFT
// matmul, so it computes the oracle's own arithmetic: frames widened to
// float64 times the float32 Hann values, a float64 FFT with float64
// twiddles, float64 power and filterbank sums, one rounding to float32.
//
// What bounds it on Hopper. At the front end's batch (64 clips of 6 s at
// 22,050 Hz, n_fft 2048, hop 384: T = 345 frames, 1,025 bins) an FFT needs
// ~5·N·log2(N) = 1.1e5 flop per complex transform, and two real frames share
// one: ~1.5e9 float64 flop per batch with the windowing, unpacking, power and
// mel sums, 0.045 ms at the H100's 34 TFLOP/s float64 vector rate, against
// 34 MB of audio in and 23 MB out (0.017 ms at 3.35 TB/s). The DFT as a
// matmul is 2e11 flop, 130× more: the algorithm, not tuning, is the gain.
// The likely limit of this first design is shared memory: every radix-4
// stage reads and writes the 32 KB transform once, ~4 GB per batch.
//
// What the design does about it (exact rung).
//  - One block of 256 threads per pair of frames of one clip: frame 2j is
//    the real part and frame 2j + 1 the imaginary part of one complex
//    n_fft-point signal, read straight from the clip with the centre padding
//    as zeros (an odd last frame pairs with zeros).
//  - A Stockham autosort FFT in shared memory, double2 ping-pong buffers
//    (2·16·n_fft bytes), radix-4 stages after one radix-2 stage when log2
//    n_fft is odd; twiddles come from a host table built in float64
//    (np.exp), read through L1.
//  - The two spectra are split from Z as A[k] = (Z[k] + Z*[N−k])/2 and
//    B[k] = (Z[k] − Z*[N−k])/2i; their power goes to shared memory.
//  - The filterbank product is not dense: a Slaney filter covers a short
//    contiguous bin range, so one thread per mel sums its own range from a
//    host table (first bin, count, weights), in float64 with FMA.
//  - No atomics: the result is the same from run to run.
//
// high / fast rungs. The audio stays on chip: one block owns one (clip,
// 64-frame tile), stages the stretch of audio its frames cover in shared
// memory once and reads every frame as a strided view of it, then walks all
// frequency blocks in a loop (the TPU kernel's sequential "arbitrary" grid
// dimension). A warp owns 16 frames; per 16-bin block it runs
// mma.sync.m16n8k16 (bf16 in, f32 accumulation) for re and im, forms the
// power in the accumulator registers, which are already laid out as the A
// operand of the next m16n8k16, and multiplies by the filterbank there. The
// constant matrices are laid out on the host in the order the lanes read
// them (ops/mel_kernel.py), so each lane loads its B operands with 16-byte
// loads from L2/L1. "high" splits the audio into bf16 hi + lo as it is staged
// and the power in registers, and sums the DFT terms with a lo part in their
// own accumulators; "fast" rounds both to bf16. These rungs' bf16 rounding is
// what defines them; they are bound by tensor-core issue (~2e11 flop per
// batch at 989 TFLOP/s: ~0.2 ms for one product, ×3 for "high").
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

// ------------------------------------------------ exact rung: float64 FFT

constexpr int kFftThreads = 256;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }

// One Stockham autosort stage of radix R (2 or 4) over an N-point signal
// whose sub-transforms of length p are done: butterfly i (of N/R) takes
// src[i + r·N/R], turns input r by exp(−2πi·r·k/(R·p)), k = i mod p, and
// writes the R-point DFT to dst[(i − k)·R + k + r·p].
template <int N, int R>
__device__ __forceinline__ void fft_stage(const double2* __restrict__ src, double2* __restrict__ dst,
                                          const double2* __restrict__ tw, int p) {
  constexpr int T = N / R;
  for (int i = threadIdx.x; i < T; i += kFftThreads) {
    const int k = i & (p - 1);
    const int step = k * (N / (R * p));  // twiddle index of input 1
    double2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = src[i + r * T];
#pragma unroll
    for (int r = 1; r < R; ++r) u[r] = cmul(u[r], __ldg(tw + r * step));
    const int j = (i - k) * R + k;
    if constexpr (R == 2) {
      dst[j] = cadd(u[0], u[1]);
      dst[j + p] = csub(u[0], u[1]);
    } else {
      const double2 a = cadd(u[0], u[2]), b = csub(u[0], u[2]);
      const double2 c = cadd(u[1], u[3]), d = csub(u[1], u[3]);
      dst[j] = cadd(a, c);
      dst[j + p] = make_double2(b.x + d.y, b.y - d.x);  // b − i·d
      dst[j + 2 * p] = csub(a, c);
      dst[j + 3 * p] = make_double2(b.x - d.y, b.y + d.x);  // b + i·d
    }
  }
}

// One block per pair of frames (2·blockIdx.x, 2·blockIdx.x + 1) of clip
// blockIdx.y. win: (N) float64 holding the float32 Hann values. tw: (N)
// double2, tw[m] = exp(−2πi·m/N). mel: (n_mels) int4 {first bin, bin count,
// offset into mel_w}; mel_w: float64 holding the float32 filterbank values of
// each filter's nonzero bin range. out: (B, t_frames, n_mels).
template <int LOG2N>
__global__ void __launch_bounds__(kFftThreads)
mel_power_fft_kernel(const float* __restrict__ audio, const double* __restrict__ win,
                     const double2* __restrict__ tw, const int4* __restrict__ mel,
                     const double* __restrict__ mel_w, float* __restrict__ out, int n, int t_frames, int hop,
                     int pad, int n_mels) {
  constexpr int N = 1 << LOG2N;
  constexpr int K = N / 2 + 1;  // bins per frame
  extern __shared__ double2 smem_fft[];
  double2* cur = smem_fft;
  double2* nxt = smem_fft + N;

  const int b = blockIdx.y;
  const int f0 = 2 * blockIdx.x, f1 = f0 + 1;
  const bool has1 = f1 < t_frames;
  const float* x = audio + static_cast<size_t>(b) * n;
  const long s0 = static_cast<long>(f0) * hop - pad, s1 = s0 + hop;
  // frame f0 windowed as the real part, frame f1 as the imaginary part
  for (int i = threadIdx.x; i < N; i += kFftThreads) {
    const double w = win[i];
    const long a = s0 + i, c = s1 + i;
    const double re = (a >= 0 && a < n) ? static_cast<double>(x[a]) * w : 0.0;
    const double im = (has1 && c >= 0 && c < n) ? static_cast<double>(x[c]) * w : 0.0;
    cur[i] = make_double2(re, im);
  }
  __syncthreads();

  int p = 1;
  if constexpr (LOG2N % 2 == 1) {
    fft_stage<N, 2>(cur, nxt, tw, p);
    p = 2;
    double2* t = cur; cur = nxt; nxt = t;
    __syncthreads();
  }
#pragma unroll 1
  for (; p < N; p *= 4) {
    fft_stage<N, 4>(cur, nxt, tw, p);
    double2* t = cur; cur = nxt; nxt = t;
    __syncthreads();
  }

  // the two real frames' spectra from Z = FFT(a + i·b):
  // A[k] = (Z[k] + conj Z[N−k]) / 2, B[k] = (Z[k] − conj Z[N−k]) / 2i
  double* pw = reinterpret_cast<double*>(nxt);  // (2, K) power
  for (int k = threadIdx.x; k < K; k += kFftThreads) {
    const double2 z = cur[k], w = cur[(N - k) & (N - 1)];
    const double ar = 0.5 * (z.x + w.x), ai = 0.5 * (z.y - w.y);
    const double br = 0.5 * (z.y + w.y), bi = 0.5 * (w.x - z.x);
    pw[k] = ar * ar + ai * ai;
    pw[K + k] = br * br + bi * bi;
  }
  __syncthreads();

  float* o0 = out + (static_cast<size_t>(b) * t_frames + f0) * n_mels;
  for (int m = threadIdx.x; m < n_mels; m += kFftThreads) {
    const int4 r = mel[m];
    double sa = 0.0, sb = 0.0;
    for (int j = 0; j < r.y; ++j) {
      const double w = __ldg(mel_w + r.z + j);
      sa = fma(w, pw[r.x + j], sa);
      sb = fma(w, pw[K + r.x + j], sb);
    }
    o0[m] = static_cast<float>(sa);
    if (has1) o0[n_mels + m] = static_cast<float>(sb);
  }
}

template <int LOG2N>
cudaError_t launch_fft_n(const float* audio, const double* win, const double2* tw, const int4* mel,
                         const double* mel_w, float* out, int batch, int n, int t_frames, int hop, int pad,
                         int n_mels, cudaStream_t stream) {
  const size_t smem = sizeof(double2) * 2 * (size_t{1} << LOG2N);
  cudaError_t err = cudaFuncSetAttribute(mel_power_fft_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_frames + 1) / 2, batch);
  mel_power_fft_kernel<LOG2N><<<grid, kFftThreads, smem, stream>>>(audio, win, tw, mel, mel_w, out, n, t_frames,
                                                                  hop, pad, n_mels);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// The high and fast rungs. rung: 1 = high, 2 = fast. w and fb are the rung's
// constants as laid out by ops/mel_kernel.py; nbp is the bin count they are
// padded to. Returns a cudaError_t (0 = success) taken with
// cudaGetLastError() right after the launch. Does not synchronise.
int mel_power(const float* audio, const void* w, const void* fb, float* out, int batch, int n, int t_frames,
              int n_fft, int hop, int pad, int nbp, int n_mels, int rung, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || t_frames <= 0 || n_fft <= 0 || n_fft % 16 != 0 ||
      hop <= 0 || hop % 16 != 0 || pad < 0 || n_mels <= 0 || n_mels > kMels || nbp <= 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case 1: return launch_mma<2>(audio, w, fb, out, batch, n, t_frames, n_fft, hop, pad, nbp, n_mels, s);
    case 2: return launch_mma<1>(audio, w, fb, out, batch, n, t_frames, n_fft, hop, pad, nbp, n_mels, s);
    default: return cudaErrorInvalidValue;
  }
}

// The exact rung: n_fft a power of two from 64 to 4096. win (n_fft) float64,
// tw (n_fft) double2, mel (n_mels) int4 and mel_w float64 as laid out by
// ops/mel_kernel.py (fft_constants). Same return and stream rules as above.
int mel_power_fft(const float* audio, const void* win, const void* tw, const void* mel, const void* mel_w,
                  float* out, int batch, int n, int t_frames, int n_fft, int hop, int pad, int n_mels,
                  void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || t_frames <= 0 || hop <= 0 || pad < 0 || n_mels <= 0 ||
      n_mels > kMels)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const double*>(win);
  const auto* t = static_cast<const double2*>(tw);
  const auto* m = static_cast<const int4*>(mel);
  const auto* mw = static_cast<const double*>(mel_w);
  switch (n_fft) {
    case 64: return launch_fft_n<6>(audio, a, t, m, mw, out, batch, n, t_frames, hop, pad, n_mels, s);
    case 128: return launch_fft_n<7>(audio, a, t, m, mw, out, batch, n, t_frames, hop, pad, n_mels, s);
    case 256: return launch_fft_n<8>(audio, a, t, m, mw, out, batch, n, t_frames, hop, pad, n_mels, s);
    case 512: return launch_fft_n<9>(audio, a, t, m, mw, out, batch, n, t_frames, hop, pad, n_mels, s);
    case 1024: return launch_fft_n<10>(audio, a, t, m, mw, out, batch, n, t_frames, hop, pad, n_mels, s);
    case 2048: return launch_fft_n<11>(audio, a, t, m, mw, out, batch, n, t_frames, hop, pad, n_mels, s);
    case 4096: return launch_fft_n<12>(audio, a, t, m, mw, out, batch, n, t_frames, hop, pad, n_mels, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* mel_power_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
