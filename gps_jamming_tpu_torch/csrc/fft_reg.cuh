// Register-resident Stockham FFT of one row, n = 2^a 3^b 5^c 7^d, for the
// correlate stage and the forward rows of kernels B1 and B3 and for the
// segments of kernel B2: the sizes of GJT_REG_SCHEDULES, one template
// instantiation each (each kernel instantiates its own list of them). Any
// other n keeps the shared-memory FFT of fft_smem.cuh.
//
// The schedule of each size is a compile-time constant: T threads, the
// exchange slot's swizzle, and the radices in pass order. A pass of radix R
// has B = n/R butterflies; thread t runs butterflies i = t + u*T, u < U =
// ceil(B/T) (a thread past B idles in its last one), and holds its U*R
// points in registers v[u*R + r]. Butterfly i reads in[i + r*B], multiplies
// point r by w^r (w = exp(-+2*pi*i*m/(Ns*R)), m = i % Ns, Ns the product of
// the earlier radices), runs the R-point DFT in registers and writes
// out[(i - m)*R + m + q*Ns]; so input and output are in natural order: the
// first pass reads x[i + r*B0] from device memory into v[u*R0 + r]
// (coalesced, no scatter), and the last pass leaves X[i + r*BL] in register
// RegShape::out_reg(u, r) (BL = n/RL), so an epilogue knows each register's
// lag. Every register index is a constant once the loops unroll (a run-time
// index puts the register array in local memory).
// - A power of two: P = 8 points per thread up to 512, else 16, T = n/P,
//   radix-P passes, then the rest (2048 = 16*16*8: 3 passes, 2 exchanges;
//   16384 = 16*16*16*4: 4 passes, 3), swizzled by the four bits above
//   log2 P. The other sizes: per n a thread count, a swizzle and radices
//   from {2..16, 3, 5, 7, and composites like 10, 12, 15, 20}, chosen by a
//   search in Python over factorizations (idle lanes, passes, bank_ways).
// - R-point DFTs: radix 2, 4, 8, 16 by radix-2 decimation in frequency
//   with constant twiddles (then a bit reversal, a renaming of registers);
//   3, 5 and 7 directly, pairing x_m with x_{R-m}, with constant roots; a
//   composite R = A*B as B-point DFTs, the twiddles W_R^(n1*k2) (read from
//   the row's table) and A-point DFTs, A the largest power-of-two factor of
//   R, else its smallest prime.
// - Exchanges go through shared memory at slot(a) = a ^ ((a >> s) & 15)
//   or a + (a >> s) (the schedule's swizzle): kernels/fft_plan.py's
//   bank_ways checks each with the twiddle reads: one access per bank pair
//   per half-warp, or two at 896, 2400, 2800, 3200 and 10368 (the 5^2 and
//   3^4 orders, and 896's and 2400's fine twiddles, which no swizzle of
//   these kinds tried cleared).
// - Twiddles: coarse[e >> 6] * fine[e & 63] from a two-level table of
//   ceil(n/64) + 64 entries (2.5 KB at 16384, built in float64 on the host,
//   stored as float32), staged in shared memory at swizzled slots, then w^r
//   by repeated products; no half-row table.
// - Two exchange buffers up to 4096 (one barrier per exchange), else one
//   (two 128 KB rows of 16384 do not fit the SM's 227 KB, and 8192's 512
//   threads fill the SM's registers alone).
//
// kernels/fft_plan.py reads the table below and runs each schedule in NumPy
// (tests/test_torch_fft_plan.py, against np.fft).
#pragma once

#include <cuda_runtime.h>

#include "fft_smem.cuh"

namespace gjt {

constexpr int kFineBits = 6;
constexpr int kFine = 1 << kFineBits;     // fine table entries

// X(n, threads, pad, shift, radices...): pad 0 swizzles the exchange
// slots by XOR, pad 1 pads one slot per 2^shift.
#define GJT_REG_SCHEDULES(X)         \
  X(64, 8, 0, 3, 8, 8)               \
  X(128, 16, 0, 3, 8, 8, 2)          \
  X(256, 32, 0, 3, 8, 8, 4)          \
  X(512, 64, 0, 3, 8, 8, 8)          \
  X(1024, 64, 0, 4, 16, 16, 4)       \
  X(2048, 128, 0, 4, 16, 16, 8)      \
  X(4096, 256, 0, 4, 16, 16, 16)     \
  X(8192, 512, 0, 4, 16, 16, 16, 2)  \
  X(16384, 1024, 0, 4, 16, 16, 16, 4) \
  X(384, 32, 0, 2, 4, 12, 8)         \
  X(640, 32, 0, 2, 4, 20, 8)         \
  X(768, 32, 0, 3, 8, 8, 12)         \
  X(896, 64, 0, 3, 8, 8, 14)         \
  X(1280, 64, 0, 3, 8, 8, 20)        \
  X(1536, 96, 1, 4, 16, 6, 16)       \
  X(1792, 128, 1, 4, 16, 7, 16)      \
  X(2400, 160, 0, 2, 8, 15, 20)      \
  X(2560, 160, 1, 4, 8, 16, 20)      \
  X(2800, 160, 0, 6, 20, 7, 20)      \
  X(3072, 192, 1, 4, 16, 12, 16)     \
  X(3200, 160, 0, 4, 8, 20, 20)      \
  X(3584, 256, 1, 4, 16, 14, 16)     \
  X(5120, 320, 1, 4, 16, 16, 20)     \
  X(6144, 256, 0, 3, 8, 8, 8, 12)    \
  X(7168, 512, 1, 4, 2, 16, 14, 16)  \
  X(10240, 640, 1, 4, 8, 16, 5, 16)  \
  X(10368, 864, 0, 2, 12, 12, 6, 12) \
  X(12288, 768, 1, 4, 16, 3, 16, 16) \
  X(14336, 896, 1, 4, 8, 16, 7, 16)

template <int... Rs>
struct Radices {};

template <int N>
struct RegSchedule;

#define GJT_REG_DEF(NN, TT, PAD, SHIFT, ...)                  \
  template <>                                                 \
  struct RegSchedule<NN> {                                    \
    static constexpr int T = TT, kPad = PAD, kShift = SHIFT;  \
    using Rad = Radices<__VA_ARGS__>;                         \
  };
GJT_REG_SCHEDULES(GJT_REG_DEF)
#undef GJT_REG_DEF

// Butterflies per thread of a radix-R pass.
template <int N, int T, int R>
constexpr int kUse = (N / R + T - 1) / T;

template <int N, int T, int... Rs>
__host__ __device__ constexpr int max_points(Radices<Rs...>) {
  int m = 0;
  ((m = kUse<N, T, Rs> * Rs > m ? kUse<N, T, Rs> * Rs : m), ...);
  return m;
}

template <int R, int... Rs>
__host__ __device__ constexpr int first_radix(Radices<R, Rs...>) {
  return R;
}

template <int... Rs>
__host__ __device__ constexpr int last_radix(Radices<Rs...>) {
  int l = 0;
  ((l = Rs), ...);
  return l;
}

template <int N>
static __host__ __device__ __forceinline__ constexpr int reg_slot(int a) {
  return RegSchedule<N>::kPad ? a + (a >> RegSchedule<N>::kShift)
                              : a ^ ((a >> RegSchedule<N>::kShift) & 15);
}

// The shape of an N-point row: T threads, P registers (the most points of
// any pass), the first pass (radix R0, B0 butterflies, U0 per thread) and
// the last (RL, BL, UL).
template <int N>
struct RegShape {
  using Sc = RegSchedule<N>;
  using Rad = typename Sc::Rad;
  static constexpr int T = Sc::T;
  static constexpr int P = max_points<N, T>(Rad{});
  static constexpr int R0 = first_radix(Rad{}), B0 = N / R0;
  static constexpr int U0 = kUse<N, T, R0>;
  static constexpr int RL = last_radix(Rad{}), BL = N / RL;
  static constexpr int UL = kUse<N, T, RL>;
  // the last pass leaves the registers X[t + j*T]: every power of two
  static constexpr bool kFullL = UL * T == BL;
  // the lags of a thread's registers ascend with j
  static constexpr bool kAscending = kFullL || UL == 1;
  static constexpr int kBuffers = N <= 4096 ? 2 : 1;
  // float2 slots: the XOR stays within each aligned 16 (N % 16 == 0)
  static constexpr int kBufLen = Sc::kPad ? reg_slot<N>(N - 1) + 1 : N;
  static constexpr int kCoarse = (N + kFine - 1) >> kFineBits;
  // the table in shared memory: coarse slots rounded up to 16, then fine
  static constexpr int kCoarseSlots = (kCoarse + 15) / 16 * 16;
  static constexpr int kTabLen = kCoarseSlots + kFine;
  static_assert(T <= 1024 && (T % 32 == 0 || (T >= 8 && (T & (T - 1)) == 0)),
                "whole warps, or a power of two below a warp");
  static_assert(Sc::kPad || N % 16 == 0, "an XOR swizzle needs N % 16 == 0");

  // The register that holds X[i + r*BL] of the last pass's butterfly
  // i = t + u*T after the transform.
  static __host__ __device__ constexpr int out_reg(int u, int r) {
    return kFullL ? u + r * UL : u * RL + r;
  }
  // The index X holds in register j < UL*RL of thread t (N: none).
  static __device__ __forceinline__ int out_index(int t, int j) {
    if constexpr (kFullL) {
      return t + j * T;
    } else {
      const int i = t + (j / RL) * T;
      return i < BL ? i + (j % RL) * BL : N;
    }
  }
};

// Who runs a row: its thread index t < T and the barrier of its threads.
// BlockRow: the whole block (B1, B3). GroupRow<T>: the G = blockDim / T
// groups of T consecutive threads each run their own row (B2), each with
// its own barrier, so that one group's exchange does not stall the others:
// a masked __syncwarp below a warp, else the named barrier 1 + group.
struct BlockRow {
  static __device__ __forceinline__ int t() { return threadIdx.x; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};

template <int T>
struct GroupRow {
  static_assert(T <= 1024 && (T % 32 == 0 || (T >= 8 && (T & (T - 1)) == 0)),
                "T: whole warps, or a power of two below a warp");
  static __device__ __forceinline__ int t() { return threadIdx.x % T; }
  static __device__ __forceinline__ int group() { return threadIdx.x / T; }
  // the lanes of this thread's group within its warp
  static __device__ __forceinline__ unsigned mask() {
    return T >= 32 ? 0xffffffffu
                   : ((1u << (T & 31)) - 1u) << (threadIdx.x & 31 & ~(T - 1));
  }
  static __device__ __forceinline__ void sync() {
    if constexpr (T < 32) {
      __syncwarp(mask());
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + group()), "n"(T) : "memory");
    }
  }
};

// Shared-memory slot of fine entry l < 64: l XOR its two high bits. A
// pass's half-warp reads the fine entries at a stride of 1-32; the XOR
// spreads each stride over distinct bank pairs (4-way conflicts at 2048
// and 16384 without it).
static __device__ __forceinline__ int fine_slot(int l) { return l ^ (l >> 4); }

// Shared-memory slot of coarse entry h of an N-point table. A mixed size:
// h XOR its next four bits, which spreads the stride-4 coarse reads of
// 12288's radix-3 pass over distinct bank pairs. A power of two: h, as no
// pass's coarse reads conflict there, and a thread's twiddles of one pass
// then sit at one address plus constants.
template <int N>
static __device__ __forceinline__ int coarse_slot(int h) {
  if constexpr ((N & (N - 1)) == 0) {
    return h;
  } else {
    return h ^ ((h >> 4) & 15);
  }
}

// exp(-+2*pi*i*e/N) from the two-level table in shared memory.
template <int N, bool INV>
static __device__ __forceinline__ float2 reg_twiddle(const float2* tab,
                                                     int e) {
  float2 w = cmul(tab[coarse_slot<N>(e >> kFineBits)],
                  tab[RegShape<N>::kCoarseSlots + fine_slot(e & (kFine - 1))]);
  if (INV) w.y = -w.y;
  return w;
}

// Copies an N-point row's two-level table (ceil(N/64) + 64 entries) into
// shared memory at coarse_slot and fine_slot (no sync).
template <int N>
static __device__ __forceinline__ void stage_reg_twiddles(float2* tab_s,
                                                          const float2* tab) {
  constexpr int kC = RegShape<N>::kCoarse;
  for (int k = threadIdx.x; k < kC + kFine; k += blockDim.x)
    tab_s[k < kC ? coarse_slot<N>(k)
                 : RegShape<N>::kCoarseSlots + fine_slot(k - kC)] = tab[k];
}

// The bits of r < 2^bits reversed, bits <= 4: closed form, so that an
// unrolled loop's constant r folds to a constant register index.
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

// (cos, sin)(2*pi*j/R) for R in {3, 5, 7} and 0 < j < R: constants once j
// is.
template <int R>
static __device__ __forceinline__ float2 prime_root(int j) {
  const int h = j <= R / 2 ? j : R - j;
  const float sg = j <= R / 2 ? 1.f : -1.f;
  float c, s;
  if constexpr (R == 3) {
    c = -0.5f;
    s = 0.86602540378443865f;
  } else if constexpr (R == 5) {
    c = h == 1 ? 0.30901699437494742f : -0.80901699437494742f;
    s = h == 1 ? 0.95105651629515357f : 0.58778525229247313f;
  } else {
    static_assert(R == 7, "a prime radix is 3, 5 or 7");
    c = h == 1 ? 0.62348980185873353f
               : (h == 2 ? -0.22252093395631440f : -0.90096886790241913f);
    s = h == 1 ? 0.78183148246802981f
               : (h == 2 ? 0.97492791218182361f : 0.43388373911755812f);
  }
  return make_float2(c, sg * s);
}

// In-register R-point DFT of v[0..R), R in {3, 5, 7}, natural order out:
// y_q = x_0 + sum_m (x_m + x_{R-m}) cos(2 pi q m/R) -+ i (x_m - x_{R-m})
// sin(2 pi q m/R), m = 1..R/2, and y_{R-q} with the sine's sign flipped.
template <int R, bool INV>
static __device__ __forceinline__ void dft_prime(float2* v) {
  constexpr int H = R / 2;
  float2 a[H], b[H], o[R];
  o[0] = v[0];
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    a[m - 1] = make_float2(v[m].x + v[R - m].x, v[m].y + v[R - m].y);
    b[m - 1] = make_float2(v[m].x - v[R - m].x, v[m].y - v[R - m].y);
    o[0].x += a[m - 1].x;
    o[0].y += a[m - 1].y;
  }
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    float2 tq = v[0], uq = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      const float2 cs = prime_root<R>((q * m) % R);
      tq.x += a[m - 1].x * cs.x;
      tq.y += a[m - 1].y * cs.x;
      uq.x += b[m - 1].x * cs.y;
      uq.y += b[m - 1].y * cs.y;
    }
    const float2 lo = make_float2(tq.x + uq.y, tq.y - uq.x);
    const float2 hi = make_float2(tq.x - uq.y, tq.y + uq.x);
    o[q] = INV ? hi : lo;
    o[R - q] = INV ? lo : hi;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = o[k];
}

static __host__ __device__ constexpr bool pow2_radix(int r) {
  return (r & (r - 1)) == 0;
}

// A of a composite R = A*B: its largest power-of-two factor, else its
// smallest (odd) prime factor.
static __host__ __device__ constexpr int split_radix(int r) {
  if ((r & -r) > 1) return r & -r;
  int f = 3;
  while (r % f) f += 2;
  return f;
}

// In-register R-point DFT of v[0..R), natural order out; composite
// internal twiddles W_R^k = W_N^(k*N/R) from the row's table.
template <int R, bool INV, int N>
static __device__ __forceinline__ void dft_nat(float2* v, const float2* tab) {
  if constexpr (pow2_radix(R)) {
    dft_reg<R, INV>(v);
    float2 o[R];
#pragma unroll
    for (int k = 0; k < R; ++k) o[k] = v[brev4(k, kLog2<R>)];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = o[k];
  } else if constexpr (R == 3 || R == 5 || R == 7) {
    dft_prime<R, INV>(v);
  } else {
    constexpr int A = split_radix(R), B = R / A;
    static_assert(A > 1 && B > 1, "a composite radix");
    // x[n1 + A*n2]: B-point DFTs over n2 -> Y[n1][k2] at v[n1 + A*k2]
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) {
      float2 s[B];
#pragma unroll
      for (int n2 = 0; n2 < B; ++n2) s[n2] = v[n1 + A * n2];
      dft_nat<B, INV, N>(s, tab);
#pragma unroll
      for (int k2 = 0; k2 < B; ++k2) v[n1 + A * k2] = s[k2];
    }
#pragma unroll
    for (int n1 = 1; n1 < A; ++n1)
#pragma unroll
      for (int k2 = 1; k2 < B; ++k2)
        v[n1 + A * k2] = cmul(v[n1 + A * k2],
                              reg_twiddle<N, INV>(tab, (n1 * k2 % R) * (N / R)));
    // A-point DFTs over n1 -> X[k2 + B*k1]
    float2 o[R];
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) {
      float2 s[A];
#pragma unroll
      for (int n1 = 0; n1 < A; ++n1) s[n1] = v[n1 + A * k2];
      dft_nat<A, INV, N>(s, tab);
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) o[k2 + B * k1] = s[k1];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = o[k];
  }
}

// The butterflies of the radix-R pass after earlier radices of product NS:
// twiddles (NS > 1), then the R-point DFTs.
template <int N, int NS, int R, bool INV, class Row>
static __device__ __forceinline__ void reg_butterflies(
    float2 (&v)[RegShape<N>::P], const float2* tab) {
  constexpr int T = RegShape<N>::T, U = kUse<N, T, R>;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if constexpr (NS > 1) {
      // unsigned: a power-of-two NS is a mask, not a signed remainder
      const int m = static_cast<int>(static_cast<unsigned>(Row::t() + u * T) % NS);
      const float2 w = reg_twiddle<N, INV>(tab, m * (N / (NS * R)));
      float2 wr = w;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[u * R + r] = cmul(v[u * R + r], wr);
        if (r + 1 < R) wr = cmul(wr, w);
      }
    }
    dft_nat<R, INV, N>(v + u * R, tab);
  }
}

// A pass's outputs into the exchange buffer at their Stockham places.
template <int N, int NS, int R, class Row>
static __device__ __forceinline__ void reg_store(
    const float2 (&v)[RegShape<N>::P], float2* buf) {
  constexpr int T = RegShape<N>::T, B = N / R, U = kUse<N, T, R>;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = Row::t() + u * T;
    if (U * T == B || i < B) {
      const int m = static_cast<int>(static_cast<unsigned>(i) % NS);
      const int base = (i - m) * R + m;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[reg_slot<N>(base + r * NS)] = v[u * R + r];
    }
  }
}

// The next pass's inputs (radix R): v[u*R + r] = in[i + r*N/R], zero past
// the pass's last butterfly.
template <int N, int R, class Row>
static __device__ __forceinline__ void reg_load(float2 (&v)[RegShape<N>::P],
                                                const float2* buf) {
  constexpr int T = RegShape<N>::T, B = N / R, U = kUse<N, T, R>;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = Row::t() + u * T;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (U * T == B || i < B) {
        v[u * R + r] = buf[reg_slot<N>(i + r * B)];
      } else {
        v[u * R + r] = make_float2(0.f, 0.f);
      }
    }
  }
}

// The passes from the one after earlier radices of product NS to the end.
// Every pass but the last stores, waits, and loads the next one's inputs;
// the last leaves its outputs in registers at RegShape::out_reg.
template <int N, int NS, bool INV, class Row, int R, int... Rest>
static __device__ __forceinline__ void reg_passes(
    float2 (&v)[RegShape<N>::P], float2* buf0, float2* buf1,
    const float2* tab, int& phase) {
  using S = RegShape<N>;
  reg_butterflies<N, NS, R, INV, Row>(v, tab);
  if constexpr (sizeof...(Rest) > 0) {
    float2* buf = (phase++ & 1) ? buf1 : buf0;
    reg_store<N, NS, R, Row>(v, buf);
    Row::sync();
    reg_load<N, first_radix(Radices<Rest...>{}), Row>(v, buf);
    if constexpr (S::kBuffers == 1) Row::sync();
    reg_passes<N, NS * R, INV, Row, Rest...>(v, buf0, buf1, tab, phase);
  } else if constexpr (S::kFullL && S::UL > 1) {
    // a whole last pass: rename the registers so that v[j] = X[t + j*T]
    float2 o[S::UL * R];
#pragma unroll
    for (int u = 0; u < S::UL; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) o[S::out_reg(u, r)] = v[u * R + r];
#pragma unroll
    for (int j = 0; j < S::UL * R; ++j) v[j] = o[j];
  }
}

template <int N, bool INV, class Row, int... Rs>
static __device__ __forceinline__ void reg_fft_sched(
    float2 (&v)[RegShape<N>::P], float2* buf0, float2* buf1,
    const float2* tab, int& phase, Radices<Rs...>) {
  reg_passes<N, 1, INV, Row, Rs...>(v, buf0, buf1, tab, phase);
}

// The whole transform of the row whose points x[i + r*B0] are in
// v[u*R0 + r] on entry (zero past B0); X[i + r*BL] in v[out_reg(u, r)] on
// return (INV: inverse, no 1/n). Exchanges alternate between buf0 and buf1
// (`phase` counts them across calls); with one buffer each load is
// followed by a barrier, so the next store cannot overwrite points still
// to be read. tab: the two-level table in shared memory, visible to every
// thread. Row: who runs the row (BlockRow or a GroupRow<T>).
template <int N, bool INV, class Row = BlockRow>
static __device__ __forceinline__ void reg_fft(float2 (&v)[RegShape<N>::P],
                                               float2* buf0, float2* buf1,
                                               const float2* tab, int& phase) {
  reg_fft_sched<N, INV, Row>(v, buf0, buf1, tab, phase,
                             typename RegShape<N>::Rad{});
}

// The first pass's points of thread t: v[u*R0 + r] = at(i + r*B0) for its
// butterflies i = t + u*T, zero past B0 (`at(k)` reads point k of the row).
template <int N, class At>
static __device__ __forceinline__ void reg_first(float2 (&v)[RegShape<N>::P],
                                                 int t, At at) {
  using S = RegShape<N>;
#pragma unroll
  for (int u = 0; u < S::U0; ++u) {
    const int i = t + u * S::T;
#pragma unroll
    for (int r = 0; r < S::R0; ++r) {
      if (S::U0 * S::T == S::B0 || i < S::B0) {
        v[u * S::R0 + r] = at(i + r * S::B0);
      } else {
        v[u * S::R0 + r] = make_float2(0.f, 0.f);
      }
    }
  }
}

// Exchange buffers and table of an N-point row, bytes.
template <int N>
static inline size_t reg_smem_bytes() {
  using S = RegShape<N>;
  return sizeof(float2) * (static_cast<size_t>(S::kBuffers) * S::kBufLen +
                           S::kTabLen);
}

// Forward transform of rows: Y[b] = FFT of the N points src.at(b, k), k <
// N. Src is a row source of pcf_correlate.cuh (SrcMix for kernel B3,
// SrcFold for B1), so a device record names the rows it read.
template <int N, class Src>
static __global__ void __launch_bounds__(RegShape<N>::T)
reg_forward_kernel(Src src, float2* __restrict__ Y,
                   const float2* __restrict__ tab) {
  using S = RegShape<N>;
  extern __shared__ float2 smem[];
  float2* buf0 = smem;
  float2* buf1 = S::kBuffers == 2 ? smem + S::kBufLen : smem;
  float2* tab_s = smem + S::kBuffers * S::kBufLen;
  stage_reg_twiddles<N>(tab_s, tab);
  const int row = blockIdx.x, t = threadIdx.x;
  float2 v[S::P];
  reg_first<N>(v, t, [&](int k) { return src.at(row, k); });
  __syncthreads();                       // the table is staged
  int phase = 0;
  reg_fft<N, false>(v, buf0, buf1, tab_s, phase);
  float2* dst = Y + static_cast<long long>(row) * N;
#pragma unroll
  for (int j = 0; j < S::UL * S::RL; ++j) {
    const int k = S::out_index(t, j);
    if (S::kFullL || k < N) dst[k] = v[j];
  }
}

}  // namespace gjt
