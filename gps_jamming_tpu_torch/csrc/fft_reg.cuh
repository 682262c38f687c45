// Register-resident Stockham FFT of one power-of-two row per thread block,
// for the correlate stage of kernels B1 and B3 and their forward kernels.
//
// n = T * P: each of the T threads holds P points in registers (P = 8 for
// n <= 512, else 16; RegShape). Every power of two n is its own template
// instantiation, so n, T, the radices, the strides and every register and
// address offset are compile-time constants. The transform is a Stockham
// autosort of
// radix-P passes and, where log2(n) is no multiple of log2(P), one last
// pass of radix n / P^a (2, 4 or 8):
// - a pass of radix R has n/R butterflies; thread t owns i = t + u*T,
//   u < P/R. Butterfly i reads in[i + r*n/R] (r < R), multiplies point r
//   by w^r, w = exp(+-2*pi*i * m / (Ns*R)), m = i % Ns, Ns the product of
//   the earlier radices, runs the R-point DFT in registers (radix-2 steps
//   with constant twiddles) and writes out[(i - m)*R + m + r*Ns];
// - so input and output are in natural order: the first pass reads thread
//   t's points x[t + j*T] straight from device memory (coalesced: the
//   caller's replica product goes from global memory into registers), and
//   the last pass leaves X[t + j*T] in register j (coalesced stores, and
//   the statistics epilogue knows each register's lag). There is no
//   bit-reversed scatter.
// - Between passes the points go through shared memory at the float2 slot
//   reg_slot(a) = a ^ ((a >> log2 P) & 15). Reads (consecutive i) and
//   writes (stride R at Ns = 1, blocks of Ns after) of every pass then
//   touch 16 distinct bank pairs per half-warp: no bank conflicts
//   (kernels/fft_plan.py:bank_ways checks every n).
// - 2048 = 16*16*8 takes 3 passes and 2 exchanges (11 radix-2 passes
//   before), 16384 = 16*16*16*4 takes 4 passes and 3 exchanges (14).
// - Twiddles: w = coarse[e >> 6] * fine[e & 63] (e = m*n/(Ns*R)) from a
//   two-level table of n/64 + 64 entries (2.5 KB at 16384, built in float64
//   on the host, stored as float32, staged in shared memory with the fine
//   entries swizzled so that no read conflicts), then w^r by repeated
//   products; no half-row twiddle table in shared memory.
//
// kernels/fft_plan.py mirrors this schedule and its index maps in Python,
// and tests/test_torch_fft_plan.py runs them in NumPy against np.fft.
#pragma once

#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace gjt {

constexpr int kFineBits = 6;
constexpr int kFine = 1 << kFineBits;     // fine table entries

// Exchange buffers of an n-point row: two up to 4096 (one barrier per
// exchange), else one (two 128 KB rows of 16384 do not fit the SM's
// 227 KB, and 8192's 512 threads fill the SM's registers alone).
static __host__ __device__ constexpr int reg_buffers(int n) {
  return n <= 4096 ? 2 : 1;
}

// The shape of an N-point row (kernels/fft_plan.py has its twin): P points
// per thread, T threads.
template <int N>
struct RegShape {
  static_assert(N >= 256 && N <= 16384 && (N & (N - 1)) == 0,
                "a power of two in [256, 16384]");
  static constexpr int P = N <= 512 ? 8 : 16;
  static constexpr int T = N / P;
  static constexpr int kBuffers = reg_buffers(N);
};

// The radix of the pass after earlier radices of product NS: P while at
// least P points per sub-transform remain, else the rest.
template <int N, int NS>
constexpr int kRadix = N / NS >= RegShape<N>::P ? RegShape<N>::P : N / NS;

// Entries of the two-level table: n/64 coarse, then 64 fine.
static __host__ __device__ __forceinline__ int reg_tw_len(int n) {
  return (n >> kFineBits) + kFine;
}

// Shared-memory slot of fine entry l < 64: l XOR its two high bits. A
// pass's half-warp reads the fine entries at a stride of 1-32; the XOR
// spreads each stride over distinct bank pairs (4-way conflicts at 2048
// and 16384 without it). The coarse reads never conflict.
static __device__ __forceinline__ int fine_slot(int l) { return l ^ (l >> 4); }

template <int P>
static __device__ __forceinline__ int reg_slot(int a) {
  constexpr int kShift = P == 16 ? 4 : 3;
  static_assert(P == 8 || P == 16, "P is 8 or 16");
  return a ^ ((a >> kShift) & 15);
}

// The bits of r < 2^bits reversed, bits <= 4: closed form, so that an
// unrolled loop's constant r folds to a constant register index (a loop or
// a recursion here would leave the index to run time, and the register
// array in local memory).
static __host__ __device__ __forceinline__ constexpr int brev4(int r,
                                                               int bits) {
  return (((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) |
          ((r & 8) >> 3)) >> (4 - bits);
}

// log2 of a radix R in {2, 4, 8, 16}.
template <int R>
constexpr int kLog2 = R == 16 ? 4 : (R == 8 ? 3 : (R == 4 ? 2 : 1));

// cos(2*pi*k/16), k < 16.
static __device__ __forceinline__ float cos16(int k) {
  constexpr float c1 = 0.92387953251128674f, c2 = 0.70710678118654752f,
                  c3 = 0.38268343236508978f;
  switch (k & 15) {
    case 0: return 1.f;
    case 1: case 15: return c1;
    case 2: case 14: return c2;
    case 3: case 13: return c3;
    case 4: case 12: return 0.f;
    case 5: case 11: return -c3;
    case 6: case 10: return -c2;
    case 7: case 9: return -c1;
    default: return -1.f;
  }
}

// a * exp(-+2*pi*i*k/16) (INV: +); k is a constant once the caller's
// loops are unrolled, so the branches fold away and the quarter turns
// cost no multiply.
template <bool INV>
static __device__ __forceinline__ float2 rot16(float2 a, int k) {
  k &= 15;
  if (k == 0) return a;
  if (k == 8) return make_float2(-a.x, -a.y);
  if (k == 4)
    return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  if (k == 12)
    return INV ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
  const float s = cos16(k + 12);       // sin(2*pi*k/16)
  return cmul(a, make_float2(cos16(k), INV ? s : -s));
}

// One radix-2 decimation-in-frequency stage of span LEN over v[0..R),
// then the next (LEN/2) down to 2: every loop has a compile-time trip
// count, so the register array never needs a run-time index.
template <int R, int LEN, bool INV>
static __device__ __forceinline__ void dif_stages(float2* v) {
  constexpr int kHalf = LEN / 2;
#pragma unroll
  for (int b = 0; b < R; b += LEN) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const float2 a = v[b + j], c = v[b + j + kHalf];
      v[b + j] = make_float2(a.x + c.x, a.y + c.y);
      v[b + j + kHalf] =
          rot16<INV>(make_float2(a.x - c.x, a.y - c.y), j * (16 / LEN));
    }
  }
  if constexpr (LEN > 2) dif_stages<R, kHalf, INV>(v);
}

// In-register R-point DFT of v[0..R) by radix-2 decimation in frequency:
// X[k] lands in v[brev4(k, log2 R)].
template <int R, bool INV>
static __device__ __forceinline__ void dft_reg(float2* v) {
  static_assert(R == 2 || R == 4 || R == 8 || R == 16, "R: 2, 4, 8 or 16");
  dif_stages<R, R, INV>(v);
}

// exp(-+2*pi*i*e/N) from the two-level table in shared memory.
template <int N, bool INV>
static __device__ __forceinline__ float2 reg_twiddle(const float2* tab,
                                                     int e) {
  float2 w = cmul(tab[e >> kFineBits],
                  tab[(N >> kFineBits) + fine_slot(e & (kFine - 1))]);
  if (INV) w.y = -w.y;
  return w;
}

// The butterflies of the pass of radix R after earlier radices of product
// NS on the thread's registers: twiddles (NS > 1), then the R-point DFTs.
// Leaves X[r] of butterfly u in v[u*R + brev(r)].
template <int N, int NS, int R, bool INV>
static __device__ __forceinline__ void reg_butterflies(
    float2 (&v)[RegShape<N>::P], const float2* tab) {
  constexpr int P = RegShape<N>::P, T = RegShape<N>::T;
#pragma unroll
  for (int u = 0; u < P / R; ++u) {
    if constexpr (NS > 1) {
      const int m = (threadIdx.x + u * T) & (NS - 1);
      const float2 w = reg_twiddle<N, INV>(tab, m * (N / (NS * R)));
      float2 wr = w;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[u * R + r] = cmul(v[u * R + r], wr);
        if (r + 1 < R) wr = cmul(wr, w);
      }
    }
    dft_reg<R, INV>(v + u * R);
  }
}

// A pass's outputs into the exchange buffer at their Stockham places.
template <int N, int NS, int R>
static __device__ __forceinline__ void reg_store(
    const float2 (&v)[RegShape<N>::P], float2* buf) {
  constexpr int P = RegShape<N>::P, T = RegShape<N>::T;
#pragma unroll
  for (int u = 0; u < P / R; ++u) {
    const int i = threadIdx.x + u * T;
    const int m = i & (NS - 1);
    const int base = (i - m) * R + m;
#pragma unroll
    for (int r = 0; r < R; ++r)
      buf[reg_slot<P>(base + r * NS)] = v[u * R + brev4(r, kLog2<R>)];
  }
}

// The next pass's inputs (radix R): v[u*R + r] = in[t + u*T + r*N/R].
template <int N, int R>
static __device__ __forceinline__ void reg_load(float2 (&v)[RegShape<N>::P],
                                                const float2* buf) {
  constexpr int P = RegShape<N>::P, T = RegShape<N>::T;
#pragma unroll
  for (int u = 0; u < P / R; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[u * R + r] = buf[reg_slot<P>(threadIdx.x + u * T + r * (N / R))];
}

// The passes from the one after earlier radices of product NS to the end.
// The last leaves its outputs in registers, in natural order: v[j] =
// X[t + j*T]. Every other stores, waits, and loads the next one's inputs.
template <int N, int NS, bool INV>
static __device__ __forceinline__ void reg_passes(
    float2 (&v)[RegShape<N>::P], float2* buf0, float2* buf1,
    const float2* tab, int& phase) {
  constexpr int P = RegShape<N>::P, R = kRadix<N, NS>;
  reg_butterflies<N, NS, R, INV>(v, tab);
  if constexpr (NS * R == N) {
    float2 o[P];
#pragma unroll
    for (int u = 0; u < P / R; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r)
        o[u + r * (P / R)] = v[u * R + brev4(r, kLog2<R>)];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = o[j];
  } else {
    float2* buf = (phase++ & 1) ? buf1 : buf0;
    reg_store<N, NS, R>(v, buf);
    __syncthreads();
    reg_load<N, kRadix<N, NS * R>>(v, buf);
    if constexpr (RegShape<N>::kBuffers == 1) __syncthreads();
    reg_passes<N, NS * R, INV>(v, buf0, buf1, tab, phase);
  }
}

// The whole transform of the row whose points x[t + j*T] are in v[j] on
// entry; X[t + j*T] in v[j] on return (INV: inverse, no 1/n). Exchanges
// alternate between buf0 and buf1 (`phase` counts them across calls);
// with one buffer each load is followed by a barrier, so the next store
// cannot overwrite points still to be read. tab: the two-level table in
// shared memory, visible to every thread.
template <int N, bool INV>
static __device__ __forceinline__ void reg_fft(float2 (&v)[RegShape<N>::P],
                                               float2* buf0, float2* buf1,
                                               const float2* tab,
                                               int& phase) {
  reg_passes<N, 1, INV>(v, buf0, buf1, tab, phase);
}

// Copies the two-level table into shared memory, the fine entries at
// their fine_slot (no sync).
static __device__ __forceinline__ void stage_reg_twiddles(float2* tab_s,
                                                          const float2* tab,
                                                          int n) {
  const int n_coarse = n >> kFineBits;
  for (int k = threadIdx.x; k < reg_tw_len(n); k += blockDim.x)
    tab_s[k < n_coarse ? k : n_coarse + fine_slot(k - n_coarse)] = tab[k];
}

// Every power of two the register FFT takes, one instantiation each.
#define GJT_REG_SIZES(X) \
  X(256) X(512) X(1024) X(2048) X(4096) X(8192) X(16384)

// Exchange buffers and table of an n-point row, bytes.
static inline size_t reg_smem_bytes(int n) {
  return sizeof(float2) * (static_cast<size_t>(reg_buffers(n)) * n +
                           reg_tw_len(n));
}

// Forward transform of rows: row b of x (nb rows per phasor row when osc is
// given: Y[b] = FFT(x[b % nb] * osc[b / nb]), else Y[b] = FFT(x[b])).
template <int N>
static __global__ void __launch_bounds__(RegShape<N>::T)
reg_forward_kernel(const float2* __restrict__ x,
                   const float2* __restrict__ osc, float2* __restrict__ Y,
                   const float2* __restrict__ tab, int nb) {
  using S = RegShape<N>;
  extern __shared__ float2 smem[];
  float2* buf0 = smem;
  float2* buf1 = S::kBuffers == 2 ? smem + N : smem;
  float2* tab_s = smem + S::kBuffers * N;
  stage_reg_twiddles(tab_s, tab, N);
  const int row = blockIdx.x, t = threadIdx.x;
  float2 v[S::P];
  if (osc != nullptr) {
    const float2* xb = x + static_cast<long long>(row % nb) * N + t;
    const float2* of = osc + static_cast<long long>(row / nb) * N + t;
#pragma unroll
    for (int j = 0; j < S::P; ++j) v[j] = cmul(xb[j * S::T], of[j * S::T]);
  } else {
    const float2* src = x + static_cast<long long>(row) * N + t;
#pragma unroll
    for (int j = 0; j < S::P; ++j) v[j] = src[j * S::T];
  }
  __syncthreads();                       // the table is staged
  int phase = 0;
  reg_fft<N, false>(v, buf0, buf1, tab_s, phase);
  float2* dst = Y + static_cast<long long>(row) * N + t;
#pragma unroll
  for (int j = 0; j < S::P; ++j) dst[j * S::T] = v[j];
}

// Launches reg_forward_kernel over `rows` rows of a power-of-two n in
// [256, 16384]; osc may be null.
static inline cudaError_t launch_reg_forward(const float2* x,
                                             const float2* osc, float2* Y,
                                             const float2* tab, int rows,
                                             int nb, int n, cudaStream_t s) {
  const size_t smem = reg_smem_bytes(n);
  cudaError_t err = cudaErrorInvalidValue;
#define GJT_FWD(NN)                                                         \
  if (n == NN) {                                                            \
    err = allow_smem(reinterpret_cast<const void*>(reg_forward_kernel<NN>), \
                     smem);                                                 \
    if (err != cudaSuccess) return err;                                     \
    reg_forward_kernel<NN><<<rows, RegShape<NN>::T, smem, s>>>(x, osc, Y,   \
                                                               tab, nb);    \
    return cudaGetLastError();                                              \
  }
  GJT_REG_SIZES(GJT_FWD)
#undef GJT_FWD
  return err;
}

}  // namespace gjt
