// The correlate stage shared by kernel B1 (pcf.cu) and kernel B3
// (caf_std.cu): product with the replica spectrum -> inverse FFT -> |.|^2,
// summed over groups in registers, then a surface row or row statistics.
//
// One thread block per (PRN p, coarse bin c, row r). For each group g it
// multiplies the forward spectrum Y[r, g, k] by rep[p, (k - shift_c) mod n]
// (shift_c = c - n_c/2, so n_c = 1 is no shift), runs the inverse FFT and
// adds |.|^2 into per-thread registers; the 1/n of ifft is applied once,
// as 1/n^2 on the sums. Epilogue: the surface row out[p, c*R + r, :], or
// per-(p, row) statistics (max, arg-lag with the lowest lag winning ties,
// max outside the circular window min(d, n-d) <= excl, total sum, window
// sum) as five (P, n_c*R) planes; excl < 0 is peak-only (the last three
// are zeros).
//
// A power-of-two n (256..16384) takes pcf_correlate_reg_kernel<n>, built
// on the register FFT of fft_reg.cuh:
// - thread t owns the lags k = t + j*T, j < P, from the product (Y and the
//   replica read coalesced from device memory straight into registers) to
//   |.|^2, which the last FFT pass leaves in the same registers, in natural
//   order; no row ever goes through shared memory whole, only the FFT's
//   exchanges (2 at 2048, 3 at 16384), conflict-free;
// - occupancy (ptxas registers, shared memory per block): 2048 takes 128
//   threads of 128 registers and 33 KB (two exchange buffers, one barrier
//   per exchange), so 4 blocks (16 warps) share an SM and one block's
//   barriers and loads hide behind another's arithmetic; 4096: 256 threads,
//   2 blocks per SM; 8192: 512 threads, one 64 KB buffer; 16384: 1024
//   threads of 64 registers, one 128 KB buffer plus the 2.5 KB table and
//   the |.|^2 sums in 64 KB of shared memory (in registers they spill), so
//   ONE block per SM: two 128 KB rows do not fit the SM's 227 KB, and 1024
//   threads already put 32 warps in flight. With one buffer each load of
//   an exchange is followed by a barrier (the buffer is rewritten in place);
// - no prefetch of the next group's row: loading it into registers while
//   the current group transforms, and holding the replica row in
//   registers, were measured on the H100 and bought nothing up to 4096
//   (the other resident blocks already hide the loads) and spilled at
//   8192 and 16384 (16384 twice as slow). A cp.async copy into a second
//   row buffer in shared memory is not used: up to 4096 that measurement
//   says the loads are already hidden, and at 16384 a second 128 KB row
//   does not fit. So each group reads its Y row and the (L1-resident)
//   replica row when it starts.
// Any other n in [256, 16384] whose prime factors are all <= 127
// (row_plan) takes pcf_correlate_kernel, on the mixed-radix shared-memory
// FFT of fft_smem.cuh.
//
// Every symbol here has internal linkage: each source that includes the
// header compiles its own copy, and the copies link into one library.
#pragma once

#include <cuda_runtime.h>

#include "fft_reg.cuh"
#include "fft_smem.cuh"

namespace gjt {

// Values per thread of the mixed-radix kernel: at most 16 (n <= 16384 at
// 1024 threads; below that fft_threads gives each thread at most 8).
constexpr int kMaxPerThread = 16;
static_assert(kMaxPerThread * kMaxThreads >= kMaxN,
              "kMaxN needs more values per thread");

static __device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// v mod n for v in (-n, 2n).
static __device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The epilogue of a block whose thread owns acc[j] of lag k = t + j*T for
// j < per and k < n: the surface row or the five statistics of `cell`.
template <int NV>
static __device__ void correlate_epilogue(const float (&acc)[NV], int per,
                                          int n, long long cell,
                                          long long n_cells, int stats,
                                          int excl, float* out, float* red,
                                          int* redi) {
  const int T = blockDim.x;
  if (!stats) {
    float* o = out + cell * n;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = threadIdx.x + j * T;
      if (j < per && k < n) o[k] = acc[j];
    }
    return;
  }

  // k = threadIdx.x + j*T increases with j, so a strict '>' keeps the
  // lowest lag of this thread; block_max_arg keeps the lowest across threads
  float bv = neg_inf();
  int ba = n;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = threadIdx.x + j * T;
    if (j < per && k < n && acc[j] > bv) {
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
    for (int j = 0; j < NV; ++j) {
      const int k = threadIdx.x + j * T;
      if (j < per && k < n) {
        const int d = wrap(k - arg, n);
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
    out[cell] = mx;
    out[n_cells + cell] = static_cast<float>(arg);
    out[2 * n_cells + cell] = ex;
    out[3 * n_cells + cell] = tot;
    out[4 * n_cells + cell] = ws;
  }
}

// Does the n-point correlate kernel keep its |.|^2 sums in shared memory?
// At 16384 (1024 threads, 64 registers each) the sums in registers spill.
static __host__ __device__ constexpr bool reg_acc_smem(int n) {
  return n == 16384;
}

// Power-of-two N: the register FFT (fft_reg.cuh). Block b = (p, c, r).
template <int N>
static __global__ void __launch_bounds__(RegShape<N>::T)
pcf_correlate_reg_kernel(const float2* __restrict__ Y,
                         const float2* __restrict__ rep,
                         const float2* __restrict__ tab,
                         float* __restrict__ out, int R, int G, int n_c,
                         int n_prn, int stats, int excl) {
  using S = RegShape<N>;
  constexpr int P = S::P, T = S::T;
  constexpr bool kAccSmem = reg_acc_smem(N);
  const int b = blockIdx.x;
  const int r = b % R;
  const int c = (b / R) % n_c;
  const int p = b / (R * n_c);
  const int shift = c - n_c / 2;

  extern __shared__ float2 smem[];
  float2* buf0 = smem;
  float2* buf1 = S::kBuffers == 2 ? smem + N : smem;
  float2* tab_s = smem + S::kBuffers * N;
  float* red = reinterpret_cast<float*>(tab_s + reg_tw_len(N));   // 32
  int* redi = reinterpret_cast<int*>(red + 32);                    // 32
  float* acc_s = reinterpret_cast<float*>(redi + 32);   // N (kAccSmem)
  stage_reg_twiddles(tab_s, tab, N);

  const int t = threadIdx.x;
  const float2* rp = rep + static_cast<long long>(p) * N;
  const float2* yr = Y + static_cast<long long>(r) * G * N + t;
  // replica point j of this thread: rep[p, (t + j*T - shift) mod N]
  auto rep_at = [&](int j) { return rp[(t + j * T - shift) & (N - 1)]; };
  float2 v[P];
  float acc[kAccSmem ? 1 : P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if constexpr (kAccSmem) {
      acc_s[t + j * T] = 0.f;
    } else {
      acc[j] = 0.f;
    }
    v[j] = cmul(yr[j * T], rep_at(j));
  }
  __syncthreads();                       // the table is staged

  int phase = 0;
  for (int g = 0; g < G; ++g) {
    reg_fft<N, true>(v, buf0, buf1, tab_s, phase);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float e = v[j].x * v[j].x + v[j].y * v[j].y;
      if constexpr (kAccSmem) {
        acc_s[t + j * T] += e;
      } else {
        acc[j] += e;
      }
    }
    if (g + 1 < G) {
      const float2* yn = yr + static_cast<long long>(g + 1) * N;
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = cmul(yn[j * T], rep_at(j));
    }
  }
  // ifft's 1/n, squared: exact for a power of two
  constexpr float kScale = 1.f / (static_cast<float>(N) * N);
  float sums[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if constexpr (kAccSmem) {
      sums[j] = acc_s[t + j * T] * kScale;
    } else {
      sums[j] = acc[j] * kScale;
    }
  }

  const long long n_rows = static_cast<long long>(n_c) * R;
  correlate_epilogue<P>(sums, P, N, static_cast<long long>(p) * n_rows +
                        c * R + r, static_cast<long long>(n_prn) * n_rows,
                        stats, excl, out, red, redi);
}

// Any other n: the mixed-radix shared-memory FFT of fft_smem.cuh. A thread
// owns the lags k = threadIdx.x + j*T, j < per, k < n (n need not divide
// among the threads).
static __global__ void __launch_bounds__(kMaxThreads)
pcf_correlate_kernel(const float2* __restrict__ Y,
                     const float2* __restrict__ rep,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int R, int G, int n_c, int n_prn, FftPlan plan,
                     int stats, int excl) {
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
  const int per = (n + T - 1) / T;
  const float inv_n = 1.f / static_cast<float>(n);
  const float2* rp = rep + static_cast<long long>(p) * n;

  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const float2* yg = Y + (static_cast<long long>(r) * G + g) * n;
    for (int k = threadIdx.x; k < n; k += T)
      buf[digit_rev(k, plan)] = cmul(yg[k], rp[wrap(k - shift, n)]);
    __syncthreads();
    fft_mixed<true>(buf, tw_s, plan);
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int k = threadIdx.x + j * T;
      if (j < per && k < n) {
        const float2 v = buf[k];
        const float re = v.x * inv_n, im = v.y * inv_n;
        acc[j] += re * re + im * im;
      }
    }
    __syncthreads();
  }

  const long long n_rows = static_cast<long long>(n_c) * R;
  correlate_epilogue<kMaxPerThread>(
      acc, per, n, static_cast<long long>(p) * n_rows + c * R + r,
      static_cast<long long>(n_prn) * n_rows, stats, excl, out, red, redi);
}

// Threads per block for the mixed-radix FFT of an n-point row: about 8
// values each, a multiple of 32 (the block reductions shuffle whole
// warps), 32 to 1024.
static inline int fft_threads(int n) {
  int threads = ((n / 8 + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return threads;
}

// Shared memory of a mixed-radix row FFT: the row and its twiddle table.
static inline size_t fft_smem_bytes(int n) {
  return sizeof(float2) * (n + tw_len(n));
}

// The plan of an n the correlate stage and its forward kernels take: n in
// [kMinN, kMaxN] with every prime factor <= kMaxRadix. False otherwise.
static inline bool row_plan(int n, FftPlan* pl) {
  return n >= kMinN && n <= kMaxN && make_plan(n, pl);
}

static inline bool is_pow2(int n) { return (n & (n - 1)) == 0; }

// Launches the correlate stage over R * n_c * P blocks; `plan` from
// row_plan, checked by the caller. tw: the two-level table of fft_reg.cuh
// for a power-of-two n, else the half table of fft_smem.cuh.
static inline cudaError_t launch_correlate(const float2* Y, const float2* rep,
                                           const float2* tw, float* out,
                                           int R, int G, int n_c, int P,
                                           const FftPlan& plan, int stats,
                                           int excl, cudaStream_t s) {
  const int n = plan.n;
  const int blocks = R * n_c * P;
  const size_t red = sizeof(float) * 32 + sizeof(int) * 32;
  cudaError_t err;
  if (!is_pow2(n)) {
    const size_t smem = fft_smem_bytes(n) + red;
    err = allow_smem(reinterpret_cast<const void*>(pcf_correlate_kernel),
                     smem);
    if (err != cudaSuccess) return err;
    pcf_correlate_kernel<<<blocks, fft_threads(n), smem, s>>>(
        Y, rep, tw, out, R, G, n_c, P, plan, stats, excl);
    return cudaGetLastError();
  }
  const size_t smem = reg_smem_bytes(n) + red +
                      (reg_acc_smem(n) ? sizeof(float) * n : 0);
#define GJT_CORR(NN)                                                        \
  if (n == NN) {                                                            \
    err = allow_smem(                                                       \
        reinterpret_cast<const void*>(pcf_correlate_reg_kernel<NN>), smem); \
    if (err != cudaSuccess) return err;                                     \
    pcf_correlate_reg_kernel<NN><<<blocks, RegShape<NN>::T, smem, s>>>(     \
        Y, rep, tw, out, R, G, n_c, P, stats, excl);                        \
    return cudaGetLastError();                                              \
  }
  GJT_REG_SIZES(GJT_CORR)
#undef GJT_CORR
  return cudaErrorInvalidValue;
}

}  // namespace gjt
