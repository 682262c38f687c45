// Post-correlation-FFT (PCF) acquisition search (kernel B1 of the port).
//
// Replaces the TPU kernel gps_jamming_tpu/ops/pallas_caf.py:_make_kernel_v3
// as launched by _pcf_single_launch (from caf_accumulate_pcf_fused),
// including its in-kernel statistics mode.
//
// Input: the combined coherent-group signals y[(s, f), g](t) that the
// wrapper builds (a small einsum), the natural-order conj replica spectra
// rep[p, k], and the coarse-shift count n_c. Two launches:
//   1. pcf_forward:   one block per (s, f, g) row: n-point FFT -> Y.
//   2. pcf_correlate: one block per (PRN p, coarse c, row r = s*F + f):
//      for each group g, Y[r, g, k] * rep[p, (k - shift_c) mod n] ->
//      inverse FFT (with the 1/n of ifft) -> |.|^2, summed over groups in
//      registers. The coarse shift is index arithmetic on the replica, so
//      no shifted table exists.
// Epilogue modes: the surface row out[p, c*R + r, :]; or per-(p, row)
// statistics (max, arg-lag with the lowest lag winning ties, max outside
// the circular window min(d, n-d) <= excl, total sum, window sum) as five
// (P, n_c*R) planes; excl < 0 is peak-only (the last three are zeros).
//
// What bounds it: the inverse FFTs. The GPS search (32 PRN x 15 coarse x
// 6 rows x 2 groups) runs 5760 inverse transforms of 2048 points for every
// block of input, against 12 forward ones. Each inverse stays in shared
// memory from the replica product to |.|^2, and in statistics mode the
// delay x Doppler surface never reaches device memory: the only output is
// 5 x (P, rows) floats.
#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace {

constexpr int kMaxPerThread = 16;

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

__global__ void __launch_bounds__(gjt::kMaxThreads)
pcf_forward_kernel(const float2* __restrict__ y, float2* __restrict__ Y,
                   const float2* __restrict__ tw, int n, int log2n) {
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw_s = smem + n;
  gjt::stage_twiddles(tw_s, tw, n);
  const float2* src = y + static_cast<long long>(blockIdx.x) * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    buf[gjt::bitrev(t, log2n)] = src[t];
  __syncthreads();
  gjt::fft_radix2<false>(buf, tw_s, n, log2n);
  float2* dst = Y + static_cast<long long>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = buf[k];
}

__global__ void __launch_bounds__(gjt::kMaxThreads)
pcf_correlate_kernel(const float2* __restrict__ Y,
                     const float2* __restrict__ rep,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int R, int G, int n_c, int P, int n, int log2n, int stats,
                     int excl) {
  const int b = blockIdx.x;
  const int r = b % R;
  const int c = (b / R) % n_c;
  const int p = b / (R * n_c);
  const int shift = c - n_c / 2;

  extern __shared__ float2 smem[];
  float2* buf = smem;                                  // n
  float2* tw_s = smem + n;                             // n / 2
  float* red = reinterpret_cast<float*>(tw_s + (n >> 1));   // 32
  int* redi = reinterpret_cast<int*>(red + 32);              // 32
  gjt::stage_twiddles(tw_s, tw, n);

  const int T = blockDim.x;
  const int per = n / T;
  const float inv_n = 1.f / static_cast<float>(n);
  const float2* rp = rep + static_cast<long long>(p) * n;

  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const float2* yg = Y + (static_cast<long long>(r) * G + g) * n;
    for (int k = threadIdx.x; k < n; k += T)
      buf[gjt::bitrev(k, log2n)] =
          gjt::cmul(yg[k], rp[(k - shift) & (n - 1)]);
    __syncthreads();
    gjt::fft_radix2<true>(buf, tw_s, n, log2n);
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j < per) {
        const float2 v = buf[threadIdx.x + j * T];
        const float re = v.x * inv_n, im = v.y * inv_n;
        acc[j] += re * re + im * im;
      }
    }
    __syncthreads();
  }

  const long long n_rows = static_cast<long long>(n_c) * R;
  const long long cell = static_cast<long long>(p) * n_rows + c * R + r;
  if (!stats) {
    float* o = out + cell * n;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j)
      if (j < per) o[threadIdx.x + j * T] = acc[j];
    return;
  }

  // k = threadIdx.x + j*T increases with j, so a strict '>' keeps the
  // lowest lag of this thread; block_max_arg keeps the lowest across threads
  float bv = neg_inf();
  int ba = n;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    if (j < per && acc[j] > bv) {
      bv = acc[j];
      ba = threadIdx.x + j * T;
    }
  }
  float mx;
  int arg;
  gjt::block_max_arg(bv, ba, red, redi, &mx, &arg);

  float ex = 0.f, tot = 0.f, ws = 0.f;
  if (excl >= 0) {
    float exl = neg_inf(), tl = 0.f, wl = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j < per) {
        const int k = threadIdx.x + j * T;
        const int d = (k - arg + n) & (n - 1);
        const int dist = min(d, n - d);
        if (dist <= excl) {
          wl += acc[j];
        } else {
          exl = fmaxf(exl, acc[j]);
        }
        tl += acc[j];
      }
    }
    ex = gjt::block_max(exl, red);
    tot = gjt::block_sum(tl, red);
    ws = gjt::block_sum(wl, red);
  }
  if (threadIdx.x == 0) {
    const long long plane = static_cast<long long>(P) * n_rows;
    out[cell] = mx;
    out[plane + cell] = static_cast<float>(arg);
    out[2 * plane + cell] = ex;
    out[3 * plane + cell] = tot;
    out[4 * plane + cell] = ws;
  }
}

int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// y: (R*G, n) complex64, rows ordered (r, g); Y: same-shape scratch;
// rep: (P, n) complex64; tw: (n/2,) complex64; out: the surface
// (P, n_c*R, n) float32 when stats == 0, else (5, P, n_c*R) float32.
// Returns a cudaError_t (0 on success).
extern "C" int gjt_pcf(const void* y, void* Y, const void* rep,
                       const void* tw, void* out, int R, int G, int n_c,
                       int P, int n, int stats, int excl, void* stream) {
  if (n < 256 || n > 16384 || (n & (n - 1)) || R < 1 || G < 1 || P < 1 ||
      n_c < 1 || (n_c & 1) == 0 || n_c / 2 >= n ||
      (stats && excl >= n / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = n / 8;
  if (threads < 32) threads = 32;
  if (threads > gjt::kMaxThreads) threads = gjt::kMaxThreads;
  const int log2n = ilog2(n);

  const size_t smem_fwd = sizeof(float2) * (n + n / 2);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(pcf_forward_kernel), smem_fwd);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcf_forward_kernel<<<R * G, threads, smem_fwd, s>>>(
      static_cast<const float2*>(y), static_cast<float2*>(Y),
      static_cast<const float2*>(tw), n, log2n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_cor = smem_fwd + sizeof(float) * 32 + sizeof(int) * 32;
  err = allow_smem(reinterpret_cast<const void*>(pcf_correlate_kernel),
                   smem_cor);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcf_correlate_kernel<<<R * n_c * P, threads, smem_cor, s>>>(
      static_cast<const float2*>(Y), static_cast<const float2*>(rep),
      static_cast<const float2*>(tw), static_cast<float*>(out), R, G, n_c, P,
      n, log2n, stats, excl);
  return static_cast<int>(cudaGetLastError());
}
