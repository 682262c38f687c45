// The correlate stage shared by kernel B1 (pcf.cu) and kernel B3
// (caf_std.cu): product with the replica spectrum -> inverse FFT -> |.|^2,
// summed over groups in registers, then a surface row or row statistics.
//
// One thread block per (PRN p, coarse bin c, row r). For each group g it
// multiplies the forward spectrum Y[r, g, k] by rep[p, (k - shift_c) mod n]
// (shift_c = c - n_c/2, so n_c = 1 is no shift), runs the inverse FFT with
// the 1/n of ifft, and adds |.|^2 into per-thread registers. Epilogue: the
// surface row out[p, c*R + r, :], or per-(p, row) statistics (max, arg-lag
// with the lowest lag winning ties, max outside the circular window
// min(d, n-d) <= excl, total sum, window sum) as five (P, n_c*R) planes;
// excl < 0 is peak-only (the last three are zeros).
//
// n is any length in [256, 16384] whose prime factors are all <= 127
// (row_plan): a power of two takes the radix-2 FFT, any other n the
// mixed-radix one (pcf_correlate_kernel<true>).
//
// Every symbol here has internal linkage: each source that includes the
// header compiles its own copy, and the copies link into one library.
#pragma once

#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace gjt {

// Values per thread: at most 16 (n <= 16384 at 1024 threads; below that
// fft_threads gives each thread at most 8).
constexpr int kMaxPerThread = 16;
static_assert(kMaxPerThread * kMaxThreads >= kMaxN,
              "kMaxN needs more values per thread");

static __device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// v mod n for v in (-n, 2n); a mask when n is a power of two (!MIXED).
template <bool MIXED>
static __device__ __forceinline__ int wrap(int v, int n) {
  if (!MIXED) return v & (n - 1);
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// Does this thread's j-th value exist? j < per, and k < n at a mixed n.
template <bool MIXED>
static __device__ __forceinline__ bool owns(int j, int per, int k, int n) {
  return j < per && (!MIXED || k < n);
}

// MIXED: the row FFTs are mixed-radix (fft_smem.cuh), else radix-2. A
// thread owns the lags k = threadIdx.x + j*T, j < per; a mixed-radix n
// need not divide among the threads, so there each loop also needs k < n
// (`owns`).
template <bool MIXED>
static __global__ void __launch_bounds__(kMaxThreads)
pcf_correlate_kernel(const float2* __restrict__ Y,
                     const float2* __restrict__ rep,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int R, int G, int n_c, int P, FftPlan plan, int stats,
                     int excl) {
  const int n = plan.n;
  const int b = blockIdx.x;
  const int r = b % R;
  const int c = (b / R) % n_c;
  const int p = b / (R * n_c);
  const int shift = c - n_c / 2;

  extern __shared__ float2 smem[];
  float2* buf = smem;                                  // n
  float2* tw_s = smem + n;                             // tw_len(n)
  float* red = reinterpret_cast<float*>(tw_s + tw_len(n));   // 32
  int* redi = reinterpret_cast<int*>(red + 32);              // 32
  stage_twiddles(tw_s, tw, n);

  const int T = blockDim.x;
  const int per = MIXED ? (n + T - 1) / T : n / T;
  const float inv_n = 1.f / static_cast<float>(n);
  const float2* rp = rep + static_cast<long long>(p) * n;

  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const float2* yg = Y + (static_cast<long long>(r) * G + g) * n;
    for (int k = threadIdx.x; k < n; k += T)
      buf[load_pos<MIXED>(k, plan)] =
          cmul(yg[k], rp[wrap<MIXED>(k - shift, n)]);
    __syncthreads();
    fft_row<MIXED, true>(buf, tw_s, plan);
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int k = threadIdx.x + j * T;
      if (owns<MIXED>(j, per, k, n)) {
        const float2 v = buf[k];
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
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int k = threadIdx.x + j * T;
      if (owns<MIXED>(j, per, k, n)) o[k] = acc[j];
    }
    return;
  }

  // k = threadIdx.x + j*T increases with j, so a strict '>' keeps the
  // lowest lag of this thread; block_max_arg keeps the lowest across threads
  float bv = neg_inf();
  int ba = n;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int k = threadIdx.x + j * T;
    if (owns<MIXED>(j, per, k, n) && acc[j] > bv) {
      bv = acc[j];
      ba = k;
    }
  }
  float mx;
  int arg;
  block_max_arg(bv, ba, red, redi, &mx, &arg);

  float ex = 0.f, tot = 0.f, ws = 0.f;
  if (excl >= 0) {
    float exl = neg_inf(), tl = 0.f, wl = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int k = threadIdx.x + j * T;
      if (owns<MIXED>(j, per, k, n)) {
        const int d = wrap<MIXED>(k - arg, n);
        const int dist = min(d, n - d);
        if (dist <= excl) {
          wl += acc[j];
        } else {
          exl = fmaxf(exl, acc[j]);
        }
        tl += acc[j];
      }
    }
    ex = block_max(exl, red);
    tot = block_sum(tl, red);
    ws = block_sum(wl, red);
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

// Threads per block for an n-point row: about 8 values each, a multiple of
// 32 (the block reductions shuffle whole warps), 32 to 1024.
static inline int fft_threads(int n) {
  int threads = ((n / 8 + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return threads;
}

// Shared memory of a row FFT: the row and its twiddle table.
static inline size_t fft_smem_bytes(int n) {
  return sizeof(float2) * (n + tw_len(n));
}

// The plan of an n the correlate stage and its forward kernels take: n in
// [kMinN, kMaxN] with every prime factor <= kMaxRadix. False otherwise.
static inline bool row_plan(int n, FftPlan* pl) {
  return n >= kMinN && n <= kMaxN && make_plan(n, pl);
}

static inline bool is_pow2(int n) { return (n & (n - 1)) == 0; }

// Launches pcf_correlate_kernel over R * n_c * P blocks; `plan` from
// row_plan, checked by the caller.
static inline cudaError_t launch_correlate(const float2* Y, const float2* rep,
                                           const float2* tw, float* out,
                                           int R, int G, int n_c, int P,
                                           const FftPlan& plan, int stats,
                                           int excl, cudaStream_t s) {
  const int n = plan.n;
  const size_t smem = fft_smem_bytes(n) + sizeof(float) * 32 +
                      sizeof(int) * 32;
  const void* fn = is_pow2(n)
      ? reinterpret_cast<const void*>(pcf_correlate_kernel<false>)
      : reinterpret_cast<const void*>(pcf_correlate_kernel<true>);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  if (is_pow2(n)) {
    pcf_correlate_kernel<false><<<R * n_c * P, fft_threads(n), smem, s>>>(
        Y, rep, tw, out, R, G, n_c, P, plan, stats, excl);
  } else {
    pcf_correlate_kernel<true><<<R * n_c * P, fft_threads(n), smem, s>>>(
        Y, rep, tw, out, R, G, n_c, P, plan, stats, excl);
  }
  return cudaGetLastError();
}

}  // namespace gjt
