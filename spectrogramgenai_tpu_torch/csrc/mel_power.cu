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
// high / fast rungs (mel_power_mma_kernel<PARTS>). Their bf16 rounding is
// what defines them; the work is ~2e11 flop per batch of 64 clips on the
// bf16 tensor cores (0.2 ms at 989 TFLOP/s for one product, ×3 for "high").
// The first design was not bound by that: every warp streamed all of the DFT
// operands W (8.3 MB per part) from L2 for its own 16 frames (~12 GB, "fast",
// and ~24 GB, "high", of L2 reads per batch).
//
// What the design does about it.
//  - A block owns one (clip, tile of up to 96 frames), a warp per 16 frames:
//    4 blocks per 345-frame clip, 256 per batch of 64, two even waves on
//    132 SMs. It stages the stretch of audio its frames cover in shared
//    memory once (bf16, hi and lo for "high") and reads every frame as a
//    strided view of it with ldmatrix.
//  - W is read from L2 once per block, not once per warp: chunks of 16
//    k-steps of one 16-bin block (16 KB per part, laid out on the host in
//    the order the lanes read them, so one chunk is one contiguous run)
//    stream through a 64 KB ring in shared memory by the TMA's 1-D bulk
//    copy, with an mbarrier per slot for "landed" and one for "every warp
//    is done with it". No block-wide barrier in the loop: warps run up to
//    the ring's depth apart, and warp 0 refills a slot once all have left
//    it. L2 reads of W drop to ~2.1 / 4.3 GB per batch.
//  - A warp walks all frequency blocks in a loop (the TPU kernel's
//    sequential "arbitrary" grid dimension). Per 16-bin block it runs
//    mma.sync.m16n8k16 (bf16 in, f32 accumulation) for re and im, forms the
//    power in the accumulator registers, which are already laid out as the A
//    operand of the next m16n8k16, and multiplies by the filterbank there
//    (its B fragments through L1). The 256-mel accumulator holds 128
//    registers a thread, so one block fits an SM.
//  - "high" splits the audio into bf16 hi + lo as it is staged and the power
//    in registers, and sums the DFT terms with a lo part in their own
//    accumulators; "fast" rounds both to bf16.
// What bounds it now is shared memory: every warp reads each k-step's B
// fragments (1 KB per part) and its A fragment (512 B per part) for 4 (or
// 12) mma, ~3 (or 2) clocks of the SM's 128 B/clock per mma against ~1 on
// the tensor cores. wgmma (m64n32k16, A from registers, B read by the
// tensor cores once per warpgroup) was tried and was no faster: N is 32
// (16 bins, re and im), and a wider N needs more accumulator registers than
// the 256-mel accumulator leaves.
//
// Built by spectrogramgenai_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

constexpr int kMmaThreads = 256;   // at most 8 warps × 16 frames
constexpr int kMmaBins = 16;       // bins per block step: two n8 tiles
constexpr int kRowPad = 8;         // bf16 of padding per span row: conflict-free ldmatrix
constexpr int kMinChunk = 4;       // k-steps per chunk where 16 do not divide n_fft / 16 (n_fft % 64 == 0)
constexpr int kSlotSteps = 16;     // k-steps of W per ring slot: a chunk is 16 steps, or 4 if n_fft % 256 != 0
constexpr int kRingBytes = 65536;  // the ring: 4 slots of 16 KB ("fast"), 2 of 32 KB ("high")
constexpr int kMaxStages = 4;
// frames per block, a warp per 16: 4 tiles of a 345-frame clip, 256 blocks
// per batch of 64 in two even waves on 132 SMs (3 tiles of 128 leave 60 of
// 192 blocks to a second wave)
constexpr int kMaxTile = 96;
constexpr int kMaxSharedBytes = 232448;  // an sm_90 block's shared memory (227 KB), static included
static_assert(2 * kMaxTile <= kMmaThreads, "a warp per 16 frames");

// not volatile: the compiler may move the products past the next step's loads
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of one 16 × 16 bf16 tile in shared memory: lane l gives
// the address of row l % 16, column 8·(l / 16); registers {rows 0–7, cols
// 0–7}, {rows 8–15, cols 0–7}, {rows 0–7, cols 8–15}, {rows 8–15, cols 8–15}.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const auto a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The ring's barriers (mbarrier, in shared memory) and the TMA's 1-D bulk copy.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Blocks until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; the copy completes a transaction count of bar, which the
// same call arms
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
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
//   the lane's B fragments {n8 tile 0: b01, b23; n8 tile 1: b01, b23}. In
//   (jb, s) order, so the chunk of 4 steps c = jb·steps/4 + s/4 is one
//   contiguous run of 4·PARTS·64 uint4.
// fbf: per (jb, mel tile pair u2, part), 32 lanes × uint4: {tile 2·u2: b01, b23; tile 2·u2+1: b01, b23}.
// tile: frames per block, a multiple of 16 up to kMaxTile that fits shared
// memory (mma_tile below); the block has tile / 16 warps.
template <int PARTS>
__global__ void __launch_bounds__(kMmaThreads, 1)
mel_power_mma_kernel(const float* __restrict__ audio, const uint4* __restrict__ wf,
                     const uint4* __restrict__ fbf, float* __restrict__ out, int n, int t_frames,
                     int n_fft, int hop, int pad, int n_jb, int n_mels, int tile) {
  constexpr int kStep = PARTS * 64;                   // uint4 of W per k-step
  constexpr int kSlot = kSlotSteps * kStep;           // uint4 per ring slot
  constexpr int kStages = kRingBytes / (16 * kSlot);  // slots in the ring
  static_assert(kStages >= 2 && kStages <= kMaxStages, "ring of 2 to 4 slots");
  extern __shared__ uint4 smem_mma[];
  // full[s]: chunk in slot s has landed (one arrival, the copy's bytes);
  // empty[s]: every warp is done with it (one arrival per warp)
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  uint4* ring = smem_mma;
  const int span_rows = tile + (n_fft - 1) / hop;
  const int stride = hop + kRowPad;  // bf16 per span row
  __nv_bfloat16* span_hi = reinterpret_cast<__nv_bfloat16*>(smem_mma + kStages * kSlot);
  __nv_bfloat16* span_lo = span_hi + span_rows * stride;

  const int steps = n_fft / 16;
  const int n_warps = blockDim.x / 32;  // tile / 16: warp w owns frames 16w … 16w + 15
  const int chunk = steps % kSlotSteps == 0 ? kSlotSteps : kMinChunk;  // k-steps per chunk
  const int per_jb = steps / chunk;                                     // chunks per bin block
  const int n_chunks = n_jb * per_jb;
  // chunk c (contiguous in wf) into ring slot c % kStages, one bulk copy
  auto issue = [&](int c) {
    const int slot = c % kStages;
    bulk_load(ring + slot * kSlot, wf + static_cast<size_t>(c) * chunk * kStep, chunk * kStep * 16, &full[slot]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = 0; c < kStages && c < n_chunks; ++c) issue(c);

  // row r, column c of the span is sample (f_base + r)·hop + c of the padded
  // clip, so frame f (local), sample k is at row f + k / hop, column k % hop
  const int b = blockIdx.y;
  const int f_base = blockIdx.x * tile;
  const float* x = audio + static_cast<size_t>(b) * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < span_rows; r += n_warps) {
    const long row_first = static_cast<long>(f_base + r) * hop - pad;
    for (int c = lane; c < hop; c += 32) {
      const long s = row_first + c;
      const float v = (s >= 0 && s < n) ? x[s] : 0.f;
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      span_hi[r * stride + c] = h;
      if constexpr (PARTS == 2) span_lo[r * stride + c] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
  __syncthreads();  // the span is read by every warp

  const int fw = warp * 16;
  const bool active = f_base + fw < t_frames;  // warp-uniform
  const int g = lane / 4, q = lane % 4;  // fragment row group and column pair
  // this lane's ldmatrix row address: frame fw + lane % 16, column 8·(lane / 16)
  const int a_lane = (fw + (lane & 15)) * stride + ((lane >> 4) << 3);

  float mel[kMels / 8][4];
#pragma unroll
  for (int u = 0; u < kMels / 8; ++u) mel[u][0] = mel[u][1] = mel[u][2] = mel[u][3] = 0.f;

  int c = 0;
#pragma unroll 1
  for (int jb = 0; jb < n_jb; ++jb) {
    float re[2][4] = {}, im[2][4] = {};
    float re_c[2][4] = {}, im_c[2][4] = {};  // the terms with a lo part, summed apart
    int off = a_lane, col = 0;  // step s: span row + 16s / hop, column 16s % hop
#pragma unroll 1
    for (int s0 = 0; s0 < steps; s0 += chunk, ++c) {
      // the slot of chunk c − 1 takes chunk c − 1 + kStages once every warp has left it; warp 0
      // waits for that, the other warps run up to kStages − 1 chunks ahead of the slowest
      if (warp == 0) {
        if (lane == 0 && c >= 1 && c - 1 + kStages < n_chunks) {
          mbar_wait(&empty[(c - 1) % kStages], ((c - 1) / kStages) & 1);
          issue(c - 1 + kStages);
        }
        __syncwarp();
      }
      const int slot = c % kStages;
      mbar_wait(&full[slot], (c / kStages) & 1);
      if (active) {
        const uint4* wp = ring + slot * kSlot + lane;
#pragma unroll 4
        for (int i = 0; i < chunk; ++i) {
          uint32_t a[4];
          ldsm_x4(a, span_hi + off);
          const uint4* ws = wp + i * kStep;
          const uint4 bc = ws[0], bs = ws[32];
          mma_bf16(re[0], a, bc.x, bc.y);
          mma_bf16(re[1], a, bc.z, bc.w);
          mma_bf16(im[0], a, bs.x, bs.y);
          mma_bf16(im[1], a, bs.z, bs.w);
          if constexpr (PARTS == 2) {
            uint32_t al[4];
            ldsm_x4(al, span_lo + off);
            mma_bf16(re_c[0], al, bc.x, bc.y);
            mma_bf16(re_c[1], al, bc.z, bc.w);
            mma_bf16(im_c[0], al, bs.x, bs.y);
            mma_bf16(im_c[1], al, bs.z, bs.w);
            const uint4 lc = ws[64], ls = ws[96];
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
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    if (!active) continue;

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
  if (!active) return;

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

// The dynamic shared memory of a block of `tile` frames: the W ring, then the
// audio span (bf16, hi and lo for "high", rows padded by kRowPad).
template <int PARTS>
size_t mma_shared_bytes(int tile, int n_fft, int hop) {
  return kRingBytes + sizeof(__nv_bfloat16) * PARTS * static_cast<size_t>(tile + (n_fft - 1) / hop) *
                          (hop + kRowPad);
}

// Frames per block: the largest multiple of 16 up to kMaxTile whose shared
// memory fits beside the ring's barriers; 0 if none does.
template <int PARTS>
int mma_tile(int n_fft, int hop) {
  constexpr size_t kBarrierBytes = 2 * kMaxStages * sizeof(uint64_t);  // full and empty, static
  for (int tile = kMaxTile; tile > 0; tile -= 16)
    if (mma_shared_bytes<PARTS>(tile, n_fft, hop) + kBarrierBytes <= kMaxSharedBytes) return tile;
  return 0;
}

template <int PARTS>
cudaError_t launch_mma(const float* audio, const void* w, const void* fb, float* out, int batch, int n,
                       int t_frames, int n_fft, int hop, int pad, int nbp, int n_mels, cudaStream_t stream) {
  const int tile = mma_tile<PARTS>(n_fft, hop);
  if (nbp % kMmaBins != 0 || n_fft % (16 * kMinChunk) != 0 || tile == 0) return cudaErrorInvalidValue;
  const size_t smem = mma_shared_bytes<PARTS>(tile, n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(mel_power_mma_kernel<PARTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_frames + tile - 1) / tile, batch);
  mel_power_mma_kernel<PARTS><<<grid, 2 * tile, smem, stream>>>(
      audio, static_cast<const uint4*>(w), static_cast<const uint4*>(fb), out, n, t_frames, n_fft, hop, pad,
      nbp / kMmaBins, n_mels, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The high and fast rungs. rung: 1 = high, 2 = fast. w and fb are the rung's
// constants as laid out by ops/mel_kernel.py; nbp is the bin count they are
// padded to. The frames per block are chosen here (mma_tile). Returns a
// cudaError_t (0 = success) taken with cudaGetLastError() right after the
// launch. Does not synchronise.
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
