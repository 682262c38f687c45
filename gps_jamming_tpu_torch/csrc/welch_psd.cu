// Fused Welch PSD (kernel B2 of the port).
//
// Replaces the TPU kernel gps_jamming_tpu/ops/pallas_psd.py:_make_kernel
// (launched by _run and welch_psd_fused). Per segment: complex-mean
// detrend -> Hann window -> nperseg-point FFT -> |X[k]|^2, summed over all
// segments, then scaled by 1/(fs * sum(w^2)) / n_segs.
//
// What bounds it: memory. A 512k-sample block is 4 MB of complex64 in for a
// 4 KB result, and the FFT work (~5 n log2 nperseg flops) is small beside
// it. The design reads every segment straight from device memory at offset
// seg*hop (the 50 % overlap is a second read of the same lines, served from
// L2), keeps the window, twiddles and the segment in shared memory and the
// running |X|^2 in registers, so nothing but the input and one
// (n_tiles, nperseg) partial table touches device memory. The TPU's
// even/odd two-framing exists only because BlockSpecs cannot overlap; it is
// not needed here.
//
// Deterministic: each block sums its tile of consecutive segments into a
// row of `partial`; a second launch adds the rows in a fixed order and
// applies the scale. No atomics.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace {

constexpr int kMaxPerThread = 8;

__global__ void __launch_bounds__(gjt::kMaxThreads)
welch_partial_kernel(const float2* __restrict__ x,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw,
                     float* __restrict__ partial, int nperseg, int log2n,
                     int hop, int n_segs, int segs_per_tile, int detrend) {
  extern __shared__ float2 smem[];
  float2* buf = smem;                 // nperseg
  float2* tw_s = smem + nperseg;      // nperseg / 2
  float* red = reinterpret_cast<float*>(tw_s + (nperseg >> 1));  // 32
  const int T = blockDim.x;
  const int per = nperseg / T;
  gjt::stage_twiddles(tw_s, tw, nperseg);

  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;

  const int seg0 = blockIdx.x * segs_per_tile;
  const int seg1 = min(seg0 + segs_per_tile, n_segs);
  for (int seg = seg0; seg < seg1; ++seg) {
    const float2* xs = x + static_cast<long long>(seg) * hop;
    float2 v[kMaxPerThread];
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j < per) {
        v[j] = xs[threadIdx.x + j * T];
        sr += v[j].x;
        si += v[j].y;
      }
    }
    float mr = 0.f, mi = 0.f;
    if (detrend) {
      mr = gjt::block_sum(sr, red) / static_cast<float>(nperseg);
      mi = gjt::block_sum(si, red) / static_cast<float>(nperseg);
    }
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j < per) {
        const int t = threadIdx.x + j * T;
        const float w = win[t];
        buf[gjt::bitrev(t, log2n)] =
            make_float2((v[j].x - mr) * w, (v[j].y - mi) * w);
      }
    }
    __syncthreads();
    gjt::fft_radix2<false>(buf, tw_s, nperseg, log2n);
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j < per) {
        const float2 b = buf[threadIdx.x + j * T];
        acc[j] += b.x * b.x + b.y * b.y;
      }
    }
    __syncthreads();
  }
  float* row = partial + static_cast<long long>(blockIdx.x) * nperseg;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j)
    if (j < per) row[threadIdx.x + j * T] = acc[j];
}

__global__ void welch_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n_tiles,
                                    int nperseg, float scale) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nperseg) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t)
    s += partial[static_cast<long long>(t) * nperseg + k];
  out[k] = s * scale;
}

}  // namespace

// x: (n,) complex64; win: (nperseg,) float32; tw: (nperseg/2,) complex64;
// partial: (n_tiles, nperseg) float32 scratch; out: (nperseg,) float32.
// Returns a cudaError_t (0 on success).
extern "C" int gjt_welch_psd(const void* x, const void* win, const void* tw,
                             void* partial, void* out, int nperseg, int hop,
                             int n_segs, int segs_per_tile, int n_tiles,
                             int detrend, float scale, void* stream) {
  if (nperseg < 64 || nperseg > 8192 || (nperseg & (nperseg - 1)) ||
      n_segs < 1 || segs_per_tile < 1 ||
      n_tiles * segs_per_tile < n_segs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = nperseg / 4;
  if (threads < 32) threads = 32;
  if (threads > gjt::kMaxThreads) threads = gjt::kMaxThreads;
  const size_t smem = sizeof(float2) * (nperseg + nperseg / 2) +
                      sizeof(float) * 32;
  cudaError_t err = gjt::allow_smem(
      reinterpret_cast<const void*>(welch_partial_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  welch_partial_kernel<<<n_tiles, threads, smem, s>>>(
      static_cast<const float2*>(x), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<float*>(partial), nperseg,
      gjt::ilog2(nperseg), hop, n_segs, segs_per_tile, detrend);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  welch_reduce_kernel<<<(nperseg + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_tiles,
      nperseg, scale);
  return static_cast<int>(cudaGetLastError());
}
