// Shared-memory FFTs and block reductions for the port's kernels.
//
// One thread block transforms one n-point row held in shared memory, in
// place, decimation in time. The row is written in digit-reversed order and
// comes back in natural order:
// - fft_radix2: the radix-2 stages of a bit-reversed row (bitrev);
// - fft_mixed: any n = 2^a * p_1 * ... * p_k with odd primes p_i <=
//   kMaxRadix (FftPlan) from a mixed-radix digit-reversed load (digit_rev):
//   a radix-2 stages (fft_radix2), then one radix-p stage per odd prime,
//   ascending. B1 and B3 take it at every n that is not one of
//   GJT_CORR_SIZES (pcf_correlate.cuh; those rows take the register FFT of
//   fft_reg.cuh). The rows of the four-step FFT (fft_large.cuh) also take
//   odd primes up to kRowMaxRadix (1021): a prime above kMaxRadix runs
//   fft_radix_p_direct, one output per thread and slot, so no thread holds
//   p values.
// The twiddle table tw[k] = exp(-2*pi*i*k/n), k < (n+1)/2, is float32
// computed in float64 on the host and staged into shared memory by the
// caller; `twiddle` reads the rest of the circle from its conjugate
// symmetry, so the table stays half a row (n = 16383: 64 KB beside the
// 128 KB row).
#pragma once

#include <cuda_runtime.h>

namespace gjt {

#if !defined(GJT_FFT_MIN_N) || !defined(GJT_FFT_MAX_N) || \
    !defined(GJT_FFT_MAX_RADIX) || !defined(GJT_FFT_ROW_MAX_RADIX)
#error "kernels/build.py defines the FFT's size rule (GJT_FFT_*)"
#endif

// Every kernel is compiled for blocks of up to this many threads, so
// ptxas keeps it within the SM's 64K registers at that size.
constexpr int kMaxThreads = 1024;
// The n the FFT takes: [kMinN, kMaxN], every prime factor <= kMaxRadix
// (kernels/build.py's FFT_* constants, the rule cuda_pcf.supported reads).
constexpr int kMinN = GJT_FFT_MIN_N;
constexpr int kMaxN = GJT_FFT_MAX_N;
constexpr int kMaxRadix = GJT_FFT_MAX_RADIX;
// The largest odd prime of a four-step row (fft_large.cuh): the JAX
// package's v1 takes n = n1 * 128 * m with n1 <= 256, so up to 262144 m
// (and n) has prime factors up to 1021.
constexpr int kRowMaxRadix = GJT_FFT_ROW_MAX_RADIX;
// Outputs per thread of fft_radix_p_direct: the block has at least n/16
// threads (n <= kMaxN at kMaxThreads).
constexpr int kDirectPer = 16;
static_assert(kDirectPer * kMaxThreads >= kMaxN,
              "fft_radix_p_direct needs more outputs per thread");
// The most odd prime factors (with multiplicity) of an n <= kMaxN
// (16384: 3^8 = 6561).
constexpr int kMaxOddFactors = 8;

constexpr long long ipow(long long b, int e) {
  return e == 0 ? 1 : b * ipow(b, e - 1);
}
static_assert(ipow(3, kMaxOddFactors + 1) > kMaxN,
              "kMaxOddFactors cannot hold every odd factor of kMaxN");

// The factorization of a mixed-radix n: a = log2p2 radix-2 stages, then
// one stage per odd prime factor, ascending.
struct FftPlan {
  int n;
  int log2p2;
  int n_odd;
  int odd[kMaxOddFactors];
};

// Fills `pl` for n (host side); false when n has a prime factor above
// max_radix (kMaxRadix for a one-block row, kRowMaxRadix for a four-step
// row).
static inline bool make_plan(int n, FftPlan* pl, int max_radix = kMaxRadix) {
  pl->n = n;
  pl->log2p2 = 0;
  pl->n_odd = 0;
  if (n < 2) return false;
  int m = n;
  while ((m & 1) == 0) {
    m >>= 1;
    ++pl->log2p2;
  }
  for (int p = 3; p <= max_radix && m > 1; p += 2) {
    while (m % p == 0) {
      if (pl->n_odd == kMaxOddFactors) return false;
      pl->odd[pl->n_odd++] = p;
      m /= p;
    }
  }
  return m == 1;
}

static __device__ __forceinline__ unsigned bitrev(unsigned i, int log2n) {
  return __brev(i) >> (32 - log2n);
}

// Position of input sample i in the mixed-radix DIT buffer: i's digits,
// the last stage's radix least significant, written with the first
// stage's radix least significant (weights 1, p_1, p_1*p_2, ...).
static __device__ __forceinline__ int digit_rev(int i, const FftPlan& pl) {
  int pos = 0, r = i, w = pl.n;
#pragma unroll
  for (int s = kMaxOddFactors - 1; s >= 0; --s) {
    if (s < pl.n_odd) {
      const int p = pl.odd[s];
      const int q = r / p;
      w /= p;
      pos += (r - q * p) * w;
      r = q;
    }
  }
  // the radix-2 digits left in r reverse as bits (w == 2^log2p2 here)
  return pl.log2p2 ? pos + static_cast<int>(bitrev(r, pl.log2p2)) : pos;
}

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-2*pi*i*k/n) for k in [0, n) from the half table.
static __device__ __forceinline__ float2 twiddle(const float2* tw, int k,
                                                 int n) {
  if (k < ((n + 1) >> 1)) return tw[k];
  if (2 * k == n) return make_float2(-1.f, 0.f);
  const float2 w = tw[n - k];
  return make_float2(w.x, -w.y);
}

// In-place decimation-in-time radix-2 stages 1..log2n of an n-point
// transform (all of it when n = 2^log2n; the first log2p2 stages of a
// mixed-radix n). INVERSE conjugates the twiddles (no 1/n scaling). The
// caller synchronises after filling buf; this returns after a final
// __syncthreads (none when log2n is 0).
template <bool INVERSE>
static __device__ void fft_radix2(float2* buf, const float2* tw, int n,
                                  int log2n) {
  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    const int tstride = n >> s;
    for (int j = threadIdx.x; j < (n >> 1); j += blockDim.x) {
      const int pos = j & (half - 1);
      const int i0 = ((j >> (s - 1)) << s) + pos;
      const int i1 = i0 + half;
      float2 w = tw[pos * tstride];
      if (INVERSE) w.y = -w.y;
      const float2 a = buf[i0];
      const float2 b = cmul(buf[i1], w);
      buf[i0] = make_float2(a.x + b.x, a.y + b.y);
      buf[i1] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

// One radix-p DIT stage over sub-transforms of length Lp: each of the n/p
// butterflies (group g, position j) reads x_m = buf[g*L + j + m*Lp],
// m < p (L = Lp*p), scales x_m by W_L^(j*m), and writes the direct p-point
// DFT y_q = sum_m x_m W_p^(q*m) back to the same places. P > 0 fixes the
// radix at compile time (unrolled, in registers); P == 0 takes p_rt at run
// time (p_rt <= kMaxRadix; the p values spill to local memory).
template <bool INVERSE, int P>
static __device__ void fft_radix_p(float2* buf, const float2* tw, int n,
                                   int Lp, int p_rt) {
  constexpr int kCap = P > 0 ? P : kMaxRadix;
  const int p = P > 0 ? P : p_rt;
  const int L = Lp * p;
  const int stride_l = n / L, stride_p = n / p;
  float2 wp[kCap];
#pragma unroll
  for (int m = 0; m < p; ++m) {
    wp[m] = twiddle(tw, m * stride_p, n);
    if (INVERSE) wp[m].y = -wp[m].y;
  }
  for (int b = threadIdx.x; b < stride_p; b += blockDim.x) {
    const int g = b / Lp;
    const int j = b - g * Lp;
    const int base = g * L + j;
    float2 v[kCap];
    v[0] = buf[base];
#pragma unroll
    for (int m = 1; m < p; ++m) {
      float2 w = twiddle(tw, j * m * stride_l, n);
      if (INVERSE) w.y = -w.y;
      v[m] = cmul(buf[base + m * Lp], w);
    }
#pragma unroll
    for (int q = 0; q < p; ++q) {
      float2 acc = v[0];
      int e = 0;
#pragma unroll
      for (int m = 1; m < p; ++m) {
        e += q;
        if (e >= p) e -= p;
        const float2 t = cmul(v[m], wp[e]);
        acc.x += t.x;
        acc.y += t.y;
      }
      buf[base + q * Lp] = acc;
    }
  }
  __syncthreads();
}

// One radix-p DIT stage for an odd prime p in (kMaxRadix, kRowMaxRadix]:
// the stage of fft_radix_p, out of place through registers. Slot k =
// g*L + j + q*Lp (j < Lp, q < p) receives y_q of butterfly (g, j) =
// sum_m x_m W_L^(j*m) W_p^(q*m) = sum_m buf[g*L + j + m*Lp] W_L^(m*r),
// r = j + q*Lp; each thread computes the slots threadIdx.x +
// i*blockDim.x (i < kDirectPer, so the block has at least n/kDirectPer
// threads) from the row in shared memory, and writes them back after
// every thread has read its inputs. No thread holds p values, so nothing
// spills at p = 1021. The twiddle W_L^(m*r) is the row's table entry at
// every kDirectRun-th m and a product by W_L^r between: read from the
// table at every m, whose addresses m*r stride the banks, it made B3 at
// 261376 = 256 * 1021 2.4 times slower (574 against 237 ms at 8 PRN x 35
// bins x 4 on the H100), and kDirectRun = 16 products keep the twiddle
// within about 2e-6 of the table's.
constexpr int kDirectRun = 16;

template <bool INVERSE>
static __device__ void fft_radix_p_direct(float2* buf, const float2* tw,
                                          int n, int Lp, int p) {
  const int L = Lp * p;
  const int stride_l = n / L;
  float2 y[kDirectPer];
#pragma unroll
  for (int i = 0; i < kDirectPer; ++i) {
    const int k = threadIdx.x + i * blockDim.x;
    if (k < n) {
      const int g = k / L;
      const int r = k - g * L;
      const int q = r / Lp;
      const float2* x = buf + g * L + (r - q * Lp);
      float2 ws = twiddle(tw, r * stride_l, n);
      if (INVERSE) ws.y = -ws.y;
      // e = m0*r mod L at each run's first m0; er = kDirectRun*r mod L
      const int er = static_cast<int>(
          (static_cast<long long>(kDirectRun) * r) % L);
      float2 acc = make_float2(0.f, 0.f);
      int e = 0;
#pragma unroll 1
      for (int m0 = 0; m0 < p; m0 += kDirectRun) {
        float2 w = twiddle(tw, e * stride_l, n);
        if (INVERSE) w.y = -w.y;
        const int m1 = m0 + kDirectRun < p ? m0 + kDirectRun : p;
#pragma unroll 4
        for (int m = m0; m < m1; ++m) {
          const float2 t = cmul(x[m * Lp], w);
          acc.x += t.x;
          acc.y += t.y;
          w = cmul(w, ws);
        }
        e += er;
        if (e >= L) e -= L;
      }
      y[i] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kDirectPer; ++i) {
    const int k = threadIdx.x + i * blockDim.x;
    if (k < n) buf[k] = y[i];
  }
  __syncthreads();
}

// The whole mixed-radix transform of a digit-reversed row; returns after a
// final __syncthreads. kRowPrimes: the row of a four-step plan, whose odd
// primes go up to kRowMaxRadix (fft_radix_p_direct above kMaxRadix); the
// one-block rows (false) keep the stages up to kMaxRadix alone, so the
// direct stage's registers do not count against them.
template <bool INVERSE, bool kRowPrimes = false>
static __device__ void fft_mixed(float2* buf, const float2* tw,
                                 const FftPlan& pl) {
  fft_radix2<INVERSE>(buf, tw, pl.n, pl.log2p2);
  int Lp = 1 << pl.log2p2;
#pragma unroll 1
  for (int s = 0; s < pl.n_odd; ++s) {
    const int p = pl.odd[s];
    if (p == 3) {
      fft_radix_p<INVERSE, 3>(buf, tw, pl.n, Lp, p);
    } else if (p == 5) {
      fft_radix_p<INVERSE, 5>(buf, tw, pl.n, Lp, p);
    } else if (p == 7) {
      fft_radix_p<INVERSE, 7>(buf, tw, pl.n, Lp, p);
    } else if (!kRowPrimes || p <= kMaxRadix) {
      fft_radix_p<INVERSE, 0>(buf, tw, pl.n, Lp, p);
    } else {
      fft_radix_p_direct<INVERSE>(buf, tw, pl.n, Lp, p);
    }
    Lp *= p;
  }
}

// Lets `fn` take `bytes` of dynamic shared memory: above 48 KB a kernel
// must opt in before its launch.
static inline cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Entries of an n-point twiddle table: (n+1)/2, n/2 for even n.
static __host__ __device__ __forceinline__ int tw_len(int n) {
  return (n + 1) >> 1;
}

// Copies the twiddle table into shared memory (no sync).
static __device__ __forceinline__ void stage_twiddles(float2* tw_s,
                                                      const float2* tw,
                                                      int n) {
  for (int k = threadIdx.x; k < tw_len(n); k += blockDim.x) tw_s[k] = tw[k];
}

// The lanes that shuffle: a warp, or the whole block where it is smaller
// (a power of two: the register FFT's 128-point rows run 16 threads). A
// shuffle's width of blockDim.x keeps its reads inside the block.
static __device__ __forceinline__ int shfl_width() {
  return blockDim.x < 32 ? static_cast<int>(blockDim.x) : 32;
}

static __device__ __forceinline__ unsigned shfl_mask() {
  return blockDim.x < 32 ? (1u << blockDim.x) - 1u : 0xffffffffu;
}

static __device__ __forceinline__ float warp_sum(float v) {
  const int w = shfl_width();
  for (int off = w >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(shfl_mask(), v, off, w);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
  const int w = shfl_width();
  for (int off = w >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(shfl_mask(), v, off, w));
  return v;
}

// Block-wide sum in a fixed order (lane tree, then warps 0..W-1), so the
// result is the same on every run. red holds >= 32 floats. Every thread
// gets the result. blockDim.x is a multiple of 32, or a power of two
// below it.
static __device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < nw; ++w) t += red[w];
    red[0] = t;
  }
  __syncthreads();
  return red[0];
}

static __device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
    for (int w = 1; w < nw; ++w) t = fmaxf(t, red[w]);
    red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// Block-wide (max, argmax) where the LOWEST index wins ties. red holds
// >= 32 floats and redi >= 32 ints. Every thread gets the result.
static __device__ void block_max_arg(float v, int a, float* red, int* redi,
                                     float* out_v, int* out_a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int width = shfl_width();
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(shfl_mask(), v, off, width);
    const int oa = __shfl_down_sync(shfl_mask(), a, off, width);
    if (ov > v || (ov == v && oa < a)) {
      v = ov;
      a = oa;
    }
  }
  __syncthreads();
  if (lane == 0) {
    red[warp] = v;
    redi[warp] = a;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = red[0];
    int ba = redi[0];
    for (int w = 1; w < nw; ++w) {
      if (red[w] > bv || (red[w] == bv && redi[w] < ba)) {
        bv = red[w];
        ba = redi[w];
      }
    }
    red[0] = bv;
    redi[0] = ba;
  }
  __syncthreads();
  *out_v = red[0];
  *out_a = redi[0];
}


// block_max_arg and block_sum in one pass: (max of v, its a, the lowest a
// winning ties; sum of s, in block_sum's order). red holds >= 64 floats,
// redi >= 32 ints. Every thread gets the results.
static __device__ void block_max_arg_sum(float v, int a, float s, float* red,
                                         int* redi, float* out_v, int* out_a,
                                         float* out_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int width = shfl_width();
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(shfl_mask(), v, off, width);
    const int oa = __shfl_down_sync(shfl_mask(), a, off, width);
    s += __shfl_down_sync(shfl_mask(), s, off, width);
    if (ov > v || (ov == v && oa < a)) {
      v = ov;
      a = oa;
    }
  }
  __syncthreads();
  if (lane == 0) {
    red[warp] = v;
    red[32 + warp] = s;
    redi[warp] = a;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = red[0], bs = 0.f;
    int ba = redi[0];
    for (int w = 0; w < nw; ++w) {
      if (red[w] > bv || (red[w] == bv && redi[w] < ba)) {
        bv = red[w];
        ba = redi[w];
      }
      bs += red[32 + w];
    }
    red[0] = bv;
    red[32] = bs;
    redi[0] = ba;
  }
  __syncthreads();
  *out_v = red[0];
  *out_a = redi[0];
  *out_s = red[32];
}

// block_max of a and block_sum of b in one pass, each in that function's
// order. red holds >= 64 floats. Every thread gets the results.
static __device__ void block_max_sum(float* a, float* b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int width = shfl_width();
  float x = *a, y = *b;
  for (int off = width >> 1; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_down_sync(shfl_mask(), x, off, width));
    y += __shfl_down_sync(shfl_mask(), y, off, width);
  }
  __syncthreads();
  if (lane == 0) {
    red[warp] = x;
    red[32 + warp] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    x = red[0];
    y = 0.f;
    for (int w = 0; w < nw; ++w) {
      x = fmaxf(x, red[w]);
      y += red[32 + w];
    }
    red[0] = x;
    red[32] = y;
  }
  __syncthreads();
  *a = red[0];
  *b = red[32];
}

}  // namespace gjt
