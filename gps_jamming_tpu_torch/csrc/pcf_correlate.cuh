// The correlate stage shared by kernel B1 (pcf.cu) and kernel B3
// (caf_std.cu): product with the replica spectrum -> inverse FFT -> |.|^2,
// summed over groups in registers, then a surface row or row statistics.
//
// One thread block per (PRN p, coarse bin c, row r). For each group g it
// multiplies the forward spectrum Y[r, g, k] by rep[p, (k - shift_c) mod n]
// (shift_c = c - n_c/2, so n_c = 1 is no shift), runs the inverse FFT and
// adds |.|^2 into per-thread registers; the 1/n of ifft is applied once,
// as 1/n^2 on the sums. Epilogue, by `stats`: 0, the surface row
// out[p, c*R + r, :]; 1, per-(p, row) statistics (max, arg-lag with the
// lowest lag winning ties, max outside the circular window min(d, n-d) <=
// excl, total sum, window sum) as five (P, n_c*R) planes, excl < 0
// peak-only (the last three are zeros); 2, the per-PRN peak out[p], the
// max over every row and lag of PRN p: each block takes an atomicMax of
// its max's float bits into out[p], which the caller zeroed (the powers
// are >= 0, so the integer order of their bits is the float order, and
// the result is exact and the same in any order of the blocks).
//
// A size of GJT_CORR_SIZES (the powers of two 128..16384; 2400, 2560,
// 2800, 3200, 10368) takes pcf_correlate_reg_kernel<n>, built on the
// register FFT of fft_reg.cuh (128: 16 threads, the block's reductions
// shuffle within it):
// - thread t owns the lags of its last pass's registers (t + j*T, j < P,
//   at a power of two), from the product (Y and the replica read coalesced
//   from device memory straight into registers) to |.|^2, which the last
//   FFT pass leaves in the same registers, in natural order; no row ever
//   goes through shared memory whole, only the FFT's exchanges (2 at 2048,
//   3 at 16384), conflict-free;
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
// Any other n in [128, 16384] whose prime factors are all <= 127
// (row_plan) takes pcf_correlate_kernel, on the mixed-radix shared-memory
// FFT of fft_smem.cuh.
//
// Above 16384 lags the correlate stage runs on the four-step split n = n1
// * n2 of fft_large.cuh: in one thread-block cluster per cell
// (pcf_correlate_cluster, n1 <= 8), else in two passes through scratch in
// device memory (launch_large_correlate); the notes below say which n
// takes which.
//
// Every symbol here has internal linkage: each source that includes the
// header compiles its own copy, and the copies link into one library.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_large.cuh"
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

// out[prn] = max(out[prn], v) for v >= 0, by thread 0 of the block: on
// the float bits, whose integer order is the float order there.
static __device__ __forceinline__ void prn_peak(float* out, int prn,
                                                float v) {
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<int*>(out) + prn, __float_as_int(v));
}

// Row sources of the forward transforms (reg_forward_kernel of fft_reg.cuh,
// pcf.cu's pcf_forward_kernel, the four-step's large_cols_fwd): at(row, j)
// is point j of row `row`. Each is a kernel's template argument, so the
// device record of a forward names the rows it read.
//
// Kernel B1: row (s, f, g) = (s*F + f)*G + g is
// mix[s, j] * sum_b w[row, b] * x[g*gl + b, j], the group's gl code
// periods combined by the row's weights (e^{-j2pi (fine_f + s*set_off)
// b*T}, ops/cuda_pcf.py's `prologue_consts`) and mixed by set s's sub-bin
// phasor, built as the forward loads it; the sum runs in float32, b
// ascending, over chunks of kFoldChunk periods whose loads are all in
// flight together (B1's callers take 4-5 periods a group: one chunk).
constexpr int kFoldChunk = 8;

struct SrcFold {
  const float2* x;       // (G*gl, n) code periods
  const float2* w;       // (S*F*G, gl) group weights, rows as above
  const float2* mix;     // (S, n) sub-bin mixes
  int n;
  int G;
  int gl;
  int FG;                // rows of one set: F*G
  __device__ __forceinline__ float2 at(int row, int j) const {
    const float2* xg = x + static_cast<long long>(row % G) * gl * n + j;
    const float2* wr = w + static_cast<long long>(row) * gl;
    float2 acc = make_float2(0.f, 0.f);
    for (int b0 = 0; b0 < gl; b0 += kFoldChunk) {
      // the loads past gl read period gl - 1 again, so none is
      // conditional, and their products are not added
      float2 xb[kFoldChunk], wb[kFoldChunk];
#pragma unroll
      for (int u = 0; u < kFoldChunk; ++u) {
        const int b = min(b0 + u, gl - 1);
        xb[u] = __ldg(xg + static_cast<long long>(b) * n);
        wb[u] = __ldg(wr + b);
      }
#pragma unroll
      for (int u = 0; u < kFoldChunk; ++u) {
        const float2 p = cmul(wb[u], xb[u]);
        if (b0 + u < gl) {
          acc.x += p.x;
          acc.y += p.y;
        }
      }
    }
    return cmul(__ldg(mix + static_cast<long long>(row / FG) * n + j), acc);
  }
};

// Kernel B3: row (f, b) = f*nb + b is block x_b mixed by the phasor row
// osc_f.
struct SrcMix {
  const float2* x;
  const float2* osc;
  int n;
  int nb;
  __device__ __forceinline__ float2 at(int row, int j) const {
    const int f = row / nb;
    return cmul(x[static_cast<long long>(row - f * nb) * n + j],
                osc[static_cast<long long>(f) * n + j]);
  }
};

// The epilogue of a block whose thread owns acc[j] of lag lag[j] (lag[j]
// >= n: no lag): the surface row or the five statistics of `cell`, or (stats
// 2) its max into the peak of PRN `prn`.
// kAscending: lag[j] grows with j, so a strict '>' alone keeps the lowest
// lag of a thread (RegShape::kAscending, and the shared-memory kernel; the
// lag compare of the other layouts cost B1 5 % at 2048, measured on the
// H100).
template <int NV, bool kAscending>
static __device__ void correlate_epilogue(const float (&acc)[NV],
                                          const int (&lag)[NV], int n,
                                          long long cell, long long n_cells,
                                          int prn, int stats, int excl,
                                          float* out, float* red, int* redi) {
  if (!stats) {
    float* o = out + cell * n;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lag[j] < n) o[lag[j]] = acc[j];
    return;
  }
  if (stats == 2) {
    float bv = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lag[j] < n) bv = fmaxf(bv, acc[j]);
    prn_peak(out, prn, block_max(bv, red));
    return;
  }

  // the lowest lag wins ties, in this thread and (block_max_arg) across
  float bv = neg_inf();
  int ba = n;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lag[j] < n &&
        (acc[j] > bv || (!kAscending && acc[j] == bv && lag[j] < ba))) {
      bv = acc[j];
      ba = lag[j];
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
      const int k = lag[j];
      if (k < n) {
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

// The code periods whose forward and correlate rows run the register FFT
// (fft_reg.cuh), one instantiation each: the powers of two, GPS at 2.4,
// 2.56, 2.8 and 3.2 MS/s, and v1's 81*128. kernels/fft_plan.py reads the
// list (CORRELATE_SIZES); every other n takes the shared-memory FFT.
#define GJT_CORR_SIZES(X)                                                \
  X(128) X(256) X(512) X(1024) X(2048) X(4096) X(8192) X(16384) X(2400) \
  X(2560) X(2800) X(3200) X(10368)

// Is n one of GJT_CORR_SIZES? (host side)
static inline bool corr_reg_size(int n) {
#define GJT_IS(NN) n == NN ||
  return GJT_CORR_SIZES(GJT_IS) false;
#undef GJT_IS
}

// Does the N-point correlate kernel keep its |.|^2 sums in shared memory?
// Above 512 threads a thread has at most 64 registers (16384) or 75
// (10368); the row and the sums do not fit them and spill.
template <int N>
static __host__ __device__ constexpr bool reg_acc_smem() {
  using S = RegShape<N>;
  return S::T > 512 && 2 * S::P + S::UL * S::RL > 40;
}

// Blocks per SM the correlate kernel asks ptxas for: as many as 128
// registers a thread leave room for (2048: 4 blocks of 128 threads; the
// GPS sizes 2400-3200, 160 threads: 3), and one from 512 threads up (8192,
// 10368, 16384), where the thread count alone bounds the registers. Left
// alone, ptxas gave 2400-3200 166-225 registers (one or two blocks per SM)
// and 1024-4096 143-147 (one block fewer); the cap made 2400-3200 3-32 %
// and 2048-4096 5-15 % faster on an H100 80GB HBM3 at 700 W (A/B,
// PERF.md).
template <int N>
static __host__ __device__ constexpr int reg_min_blocks() {
  constexpr int T = RegShape<N>::T;
  return 65536 / (T * 128) > 1 ? 65536 / (T * 128) : 1;
}

// (k - shift) mod N for k - shift in (-N, 2N).
template <int N>
static __device__ __forceinline__ int mod_n(int v) {
  if constexpr ((N & (N - 1)) == 0) {
    return v & (N - 1);
  } else {
    return wrap(v, N);
  }
}

// A size of GJT_CORR_SIZES: the register FFT. Block b = (p, c, r).
template <int N>
static __global__ void __launch_bounds__(RegShape<N>::T, reg_min_blocks<N>())
pcf_correlate_reg_kernel(const float2* __restrict__ Y,
                         const float2* __restrict__ rep,
                         const float2* __restrict__ tab,
                         float* __restrict__ out, int R, int G, int n_c,
                         int n_prn, int stats, int excl) {
  using S = RegShape<N>;
  constexpr int T = S::T;
  constexpr int PL = S::UL * S::RL;        // the last pass's points
  constexpr bool kAccSmem = reg_acc_smem<N>();
  static_assert(T % 32 == 0 || T < 32,
                "the block reductions shuffle whole warps, or one part-warp");
  const int b = blockIdx.x;
  const int r = b % R;
  const int c = (b / R) % n_c;
  const int p = b / (R * n_c);
  const int shift = c - n_c / 2;

  extern __shared__ float2 smem[];
  float2* buf0 = smem;
  float2* buf1 = S::kBuffers == 2 ? smem + S::kBufLen : smem;
  float2* tab_s = smem + S::kBuffers * S::kBufLen;
  float* red = reinterpret_cast<float*>(tab_s + S::kTabLen);      // 32
  int* redi = reinterpret_cast<int*>(red + 32);                    // 32
  float* acc_s = reinterpret_cast<float*>(redi + 32);   // N (kAccSmem)
  stage_reg_twiddles<N>(tab_s, tab);

  const int t = threadIdx.x;
  const float2* rp = rep + static_cast<long long>(p) * N;
  const float2* yr = Y + static_cast<long long>(r) * G * N;
  float2 v[S::P];
  // the first pass's points of group row yg times the shifted replica
  auto load = [&](const float2* yg) {
    reg_first<N>(v, t, [&](int k) {
      return cmul(yg[k], rp[mod_n<N>(k - shift)]);
    });
  };
  // the lag of the last pass's register j is S::out_index(t, j) (N: none),
  // recomputed where it is needed: an array of them, live across the
  // group loop, cost 2048 20 registers and a block per SM
  float acc[kAccSmem ? 1 : PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    if constexpr (kAccSmem) {
      const int k = S::out_index(t, j);
      if (S::kFullL || k < N) acc_s[k] = 0.f;
    } else {
      acc[j] = 0.f;
    }
  }
  load(yr);
  __syncthreads();                       // the table is staged

  int phase = 0;
  for (int g = 0; g < G; ++g) {
    reg_fft<N, true>(v, buf0, buf1, tab_s, phase);
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const float e = v[j].x * v[j].x + v[j].y * v[j].y;
      if constexpr (kAccSmem) {
        const int k = S::out_index(t, j);
        if (S::kFullL || k < N) acc_s[k] += e;
      } else {
        acc[j] += e;
      }
    }
    if (g + 1 < G) load(yr + static_cast<long long>(g + 1) * N);
  }
  // ifft's 1/n, squared (exact for a power of two)
  constexpr float kScale = 1.f / (static_cast<float>(N) * N);
  float sums[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    if constexpr (kAccSmem) {
      const int k = S::out_index(t, j);
      sums[j] = S::kFullL || k < N ? acc_s[k] * kScale : 0.f;
    } else {
      sums[j] = acc[j] * kScale;
    }
  }
  int lags[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) lags[j] = S::out_index(t, j);
  const long long n_rows = static_cast<long long>(n_c) * R;
  correlate_epilogue<PL, S::kAscending>(
      sums, lags, N, static_cast<long long>(p) * n_rows + c * R + r,
      static_cast<long long>(n_prn) * n_rows, p, stats, excl, out, red,
      redi);
}

// Launches reg_forward_kernel (fft_reg.cuh) over `rows` rows of src, a
// size of GJT_CORR_SIZES.
template <class Src>
static inline cudaError_t launch_reg_forward(const Src& src, float2* Y,
                                             const float2* tab, int rows,
                                             int n, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
#define GJT_FWD(NN)                                                      \
  if (n == NN) {                                                         \
    const size_t smem = reg_smem_bytes<NN>();                            \
    err = allow_smem(                                                    \
        reinterpret_cast<const void*>(reg_forward_kernel<NN, Src>), smem); \
    if (err != cudaSuccess) return err;                                  \
    reg_forward_kernel<NN, Src><<<rows, RegShape<NN>::T, smem, s>>>(     \
        src, Y, tab);                                                    \
    return cudaGetLastError();                                           \
  }
  GJT_CORR_SIZES(GJT_FWD)
#undef GJT_FWD
  return err;
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

  int lags[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int k = threadIdx.x + j * T;
    lags[j] = j < per && k < n ? k : n;
  }
  const long long n_rows = static_cast<long long>(n_c) * R;
  correlate_epilogue<kMaxPerThread, true>(
      acc, lags, n, static_cast<long long>(p) * n_rows + c * R + r,
      static_cast<long long>(n_prn) * n_rows, p, stats, excl, out, red,
      redi);
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
// [kMinN, kMaxN] (128 to 16384) with every prime factor <= kMaxRadix.
// False otherwise.
static inline bool row_plan(int n, FftPlan* pl) {
  return n >= kMinN && n <= kMaxN && make_plan(n, pl);
}

// Launches the correlate stage over R * n_c * P blocks; `plan` from
// row_plan, checked by the caller. tw: the two-level table of fft_reg.cuh
// for a size of GJT_CORR_SIZES, else the half table of fft_smem.cuh.
static inline cudaError_t launch_correlate(const float2* Y, const float2* rep,
                                           const float2* tw, float* out,
                                           int R, int G, int n_c, int P,
                                           const FftPlan& plan, int stats,
                                           int excl, cudaStream_t s) {
  const int n = plan.n;
  const int blocks = R * n_c * P;
  const size_t red = sizeof(float) * 32 + sizeof(int) * 32;
  cudaError_t err;
#define GJT_CORR(NN)                                                        \
  if (n == NN) {                                                            \
    const size_t smem = reg_smem_bytes<NN>() + red +                        \
                        (reg_acc_smem<NN>() ? sizeof(float) * NN : 0);      \
    err = allow_smem(                                                       \
        reinterpret_cast<const void*>(pcf_correlate_reg_kernel<NN>), smem); \
    if (err != cudaSuccess) return err;                                     \
    pcf_correlate_reg_kernel<NN><<<blocks, RegShape<NN>::T, smem, s>>>(     \
        Y, rep, tw, out, R, G, n_c, P, stats, excl);                        \
    return cudaGetLastError();                                              \
  }
  GJT_CORR_SIZES(GJT_CORR)
#undef GJT_CORR
  const size_t smem = fft_smem_bytes(n) + red;
  err = allow_smem(reinterpret_cast<const void*>(pcf_correlate_kernel), smem);
  if (err != cudaSuccess) return err;
  pcf_correlate_kernel<<<blocks, fft_threads(n), smem, s>>>(
      Y, rep, tw, out, R, G, n_c, P, plan, stats, excl);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Above 16384 lags (n = n1 * n2 of fft_large.cuh; B1 up to 32768, B3 up to
// kStdMaxN): the forward spectra Y come from launch_large_forward in the
// permuted order Y[row*n + k1*n2 + k2] = X[k1 + n1*k2]. Up to 131072 the
// correlate stage runs in a thread-block cluster (pcf_correlate_cluster,
// below). A plan the cluster does not take (cluster_n1: n1 = 16, B3 above
// 131072; the surface only) runs, per chunk of cells (p, c, r), two
// passes through a scratch Bs of (cells, G, n1, n2) complex64:
// 1. the row pass (RowsCorr): for each group g and each k1, the n2-point
//    inverse FFT over k2 of Y[r, g][k1 + n1*k2] * rep[p, (k1 + n1*k2 -
//    shift_c) mod n], times w_n^-(k1*t2), -> Bs[cell, g, k1, t2];
// 2. the column pass (large_cols_corr): for each t2, the n1-point inverse
//    DFT over k1 of every group's Bs[cell, g, :, t2] gives lags t2 + n2*t1,
//    and |.|^2 is summed over the groups in registers (1/n^2 once); the
//    surface row is written in natural lag order, coalesced.
// ---------------------------------------------------------------------------

// The row pass of the correlate stage: block b = (cell - c0, g, k1).
// Cells are (p, c, r), r fastest, over R rows and n_c coarse bins.
struct RowsCorr {
  static constexpr bool kInverse = true;
  const float2* Y;
  const float2* rep;
  float2* Bs;
  const float2* twn;
  int n, n1, n2, G, R, n_c, c0;
  struct Row {
    const float2* y;       // row (r, g) of Y, at its k1-th n2 points
    const float2* rp;      // the replica spectrum of PRN p
    float2* dst;           // Bs row b
    const float2* twn;
    int n, n1, k1, base;   // base = k1 - shift_c
    __device__ __forceinline__ float2 load(int k2) const {
      return cmul(y[k2], rp[large_wrap(base + n1 * k2, n)]);
    }
    __device__ __forceinline__ void store(int t2, float2 v) const {
      dst[t2] = k1 ? cmul(v, large_twiddle<true>(twn, k1 * t2, n)) : v;
    }
  };
  __device__ __forceinline__ Row row(int b) const {
    const int k1 = b % n1;
    const int g = (b / n1) % G;
    const int cell = c0 + b / (n1 * G);
    const int r = cell % R;
    const int c = (cell / R) % n_c;
    const int p = cell / (R * n_c);
    return Row{Y + static_cast<long long>(r * G + g) * n +
                   static_cast<long long>(k1) * n2,
               rep + static_cast<long long>(p) * n,
               Bs + static_cast<long long>(b) * n2, twn, n, n1, k1,
               k1 - (c - n_c / 2)};
  }
};

// The column pass of the correlate stage over cells c0.. of a chunk: block
// (cell - c0) * tiles + tile, a thread per t2, the row written to
// out[orow, :], orow = (p*n_c + c)*R_total + r0 + r: this chunk's R rows
// sit at r0.. of the output's R_total.
template <int N1>
static __global__ void __launch_bounds__(kColThreads)
large_cols_corr(const float2* __restrict__ Bs, float* __restrict__ out,
                int n2, int G, int R, int R_total, int r0, int n_c, int c0,
                int tiles) {
  const int n = N1 * n2;
  const int cl = blockIdx.x / tiles;
  const int t2 = (blockIdx.x - cl * tiles) * kColThreads + threadIdx.x;
  if (t2 >= n2) return;
  const int cell = c0 + cl;
  const int r = cell % R;
  const int c = (cell / R) % n_c;
  const int p = cell / (R * n_c);
  const long long orow =
      (static_cast<long long>(p) * n_c + c) * R_total + r0 + r;
  // ifft's 1/n, squared
  const float scale = 1.f / (static_cast<float>(n) * static_cast<float>(n));
  const float2* b = Bs + static_cast<long long>(cl) * G * n;
  float acc[N1];
#pragma unroll
  for (int t1 = 0; t1 < N1; ++t1) acc[t1] = 0.f;
  for (int g = 0; g < G; ++g) {
    float2 v[N1];
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1)
      v[k1] = b[(static_cast<long long>(g) * N1 + k1) * n2 + t2];
    small_dft<N1, true>(v);
#pragma unroll
    for (int t1 = 0; t1 < N1; ++t1)
      acc[t1] += v[t1].x * v[t1].x + v[t1].y * v[t1].y;
  }
#pragma unroll
  for (int t1 = 0; t1 < N1; ++t1)
    out[orow * n + t2 + n2 * t1] = acc[t1] * scale;
}

// The surface of the correlate stage of a plan with n1 = 16 (the only one
// the cluster does not take) over the R * n_c * P cells of forward spectra
// Y (R*G rows, permuted order), `cells_chunk` cells per pass through Bs
// (cells_chunk * G * n complex64). out: the surface (P, n_c*R_total, n);
// this call's rows sit at r0.. of R_total.
static inline cudaError_t launch_large_correlate(
    const float2* Y, const float2* rep, const float2* tw2, const float2* twn,
    float* out, float2* Bs, int R, int R_total, int r0, int G, int n_c, int P,
    const LargePlan& lp, int cells_chunk, cudaStream_t s) {
  if (lp.n1 != 16) return cudaErrorInvalidValue;
  const int cells = R * n_c * P;
  const int tiles = (lp.n2 + kColThreads - 1) / kColThreads;
  for (int c0 = 0; c0 < cells; c0 += cells_chunk) {
    const int cc = cells - c0 < cells_chunk ? cells - c0 : cells_chunk;
    cudaError_t err = launch_large_rows(
        RowsCorr{Y, rep, Bs, twn, lp.n, lp.n1, lp.n2, G, R, n_c, c0},
        cc * G * lp.n1, tw2, lp, s);
    if (err != cudaSuccess) return err;
    large_cols_corr<16><<<cc * tiles, kColThreads, 0, s>>>(
        Bs, out, lp.n2, G, R, R_total, r0, n_c, c0, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Above 16384 lags with n1 <= 8 (16384 < n <= 131072): the correlate stage
// in one thread-block cluster per cell (p, c, r), no scratch. The
// four-step's two passes wrote every group's row to device memory and read
// it back (B1 at 32768: 12.9 GB per call); on Hopper a cluster's CTAs read
// each other's shared memory, and n1 CTAs hold the n1 rows of n2 points
// (at 32768: 2 x 128 KB, where one block takes at most 227 KB). Per group
// g:
// 1. CTA k1 (its rank) runs the n2-point inverse FFT over k2 of
//    Y[r, g][k1*n2 + k2] * rep[p, (k1 - shift_c + n1*k2) mod n] (the
//    product folded into its load), into its own shared memory: on the
//    register FFT at GJT_LARGE_REG_SIZES, whose exchange buffer is the
//    row, else on the mixed-radix shared-memory FFT;
// 2. cluster.sync; CTA k1 owns the columns t2 = k1*S + j, j < S = n2/n1:
//    thread t takes j = t + i*T (i < 16/n1: n2 <= 16 T), reads the n1
//    values B[q][t2] at t2 from the n1 CTAs (map_shared_rank), multiplies
//    each by the four-step's twiddle w_n^-(q*t2) (from the n-point
//    two-level table staged in shared memory), runs the n1-point inverse
//    DFT, which gives lags t2 + n2*t1 in natural order, and adds |.|^2
//    into its power slice: in shared memory beside the register FFT's row
//    (its 64 registers a thread are taken), in 16 registers a thread
//    beside the shared-memory FFT's. (The twiddle at the row's store, as
//    the two passes apply it, made B1's surface at 32768 8.51-8.62 ms
//    against 7.91-8.01 here, measured on the H100.)
// 3. the cluster barrier, so that no CTA overwrites its row while another
//    reads it: each CTA arrives after its column step and waits only
//    before it next writes its row, so the next group's loads (into
//    registers, on the register FFT) run while the other CTAs finish.
// 1/n^2 is applied once. Epilogue: in surface mode each thread writes the
// sums it holds, coalesced; in per-PRN mode each CTA takes the max of its
// slice into out[p] (prn_peak), with no exchange; in statistics mode each
// CTA reduces its slice
// to (max, arg-lag, total sum), the lowest lag winning ties, the cluster
// takes the global (max, arg-lag) through DSMEM, and only then (the window
// needs the global arg-lag) a CTA whose slice meets the window takes its
// window sum and its max outside the window (any other CTA: 0 and its
// slice's max); rank 0 combines the n1 partials in rank order and writes
// correlate_epilogue's five statistics (excl < 0: peak-only). The CTAs
// store their statistics into each other's shared memory before a
// cluster barrier, so none reads another's after the last one.
//
// What stays on the two passes, by the plan and not by a switch
// (cluster_n1): n1 = 16 (B3 above 131072; a cluster of 16 is not
// portable). No n the gates take below has an n2 that is not a multiple of
// n1 or a CTA over 227 KB of shared memory (at 131072 a CTA of 16384-point
// rows holds 211.5 KB with both tables; a shared-memory row of n2 points
// with its half table 12*n2 bytes); such a plan is refused. A launch the
// card refuses returns its error: the wrappers raise, and nothing falls
// back to the two passes.
// ---------------------------------------------------------------------------

// Words after a cluster CTA's row, tables and power slice: red (64
// floats), redi (32 ints) and a slot of 5 words per CTA of the cluster
// (up to 8) for the statistics each publishes (max, arg-lag, excluded
// max, total sum, window sum).
constexpr int kClusterWords = 136;
constexpr size_t kSmemPerBlock = 227 * 1024;
// Columns of a cluster CTA per thread, times n1: n2 <= 16 * threads.
constexpr int kClusterPer = 16;

// The n2-point inverse row of a cluster CTA on the register FFT (a size
// of GJT_LARGE_REG_SIZES). `inverse` transforms the points load(k2) and
// hands output t2 to store(t2, X[t2]) once no thread reads the row's
// exchange buffer, which is the row itself (one buffer above 4096); it
// calls wait() after its loads and before it first writes the row. The
// power slice lives in shared memory (kSliceSmem).
template <int N2>
struct ClusterRow {
  using S = RegShape<N2>;
  static_assert(S::kBuffers == 1, "the exchange buffer is the row");
  static_assert(N2 <= kClusterPer * S::T, "a thread's columns");
  static constexpr int T = S::T;
  static constexpr bool kSliceSmem = true;
  static __host__ __device__ constexpr int row_len(int) { return S::kBufLen; }
  static __host__ __device__ constexpr int tab_len(int) { return S::kTabLen; }
  static __device__ __forceinline__ void stage(float2* tab, const float2* tw2,
                                               int) {
    stage_reg_twiddles<N2>(tab, tw2);
  }
  template <class Load, class Store, class Wait>
  static __device__ __forceinline__ void inverse(float2* row,
                                                 const float2* tab,
                                                 const FftPlan&, Load load,
                                                 Store store, Wait wait) {
    const int t = threadIdx.x;
    float2 v[S::P];
    reg_first<N2>(v, t, load);
    wait();
    __syncthreads();                     // the table (first group) is staged
    int phase = 0;
    reg_fft<N2, true>(v, row, row, tab, phase);
#pragma unroll
    for (int j = 0; j < S::UL * S::RL; ++j) {
      const int k = S::out_index(t, j);
      if (S::kFullL || k < N2) store(k, v[j]);
    }
  }
};

// Any other n2 (<= 16384): the mixed-radix shared-memory FFT, in place,
// on kMaxThreads threads; the power slice in registers.
template <>
struct ClusterRow<0> {
  static constexpr int T = kMaxThreads;
  static constexpr bool kSliceSmem = false;
  static __host__ __device__ int row_len(int n2) { return n2; }
  static __host__ __device__ int tab_len(int n2) { return tw_len(n2); }
  static __device__ __forceinline__ void stage(float2* tab, const float2* tw2,
                                               int n2) {
    stage_twiddles(tab, tw2, n2);
  }
  template <class Load, class Store, class Wait>
  static __device__ __forceinline__ void inverse(float2* row,
                                                 const float2* tab,
                                                 const FftPlan& plan,
                                                 Load load, Store store,
                                                 Wait wait) {
    wait();
    for (int k = threadIdx.x; k < plan.n; k += blockDim.x)
      row[digit_rev(k, plan)] = load(k);
    __syncthreads();
    fft_mixed<true, true>(row, tab, plan);
    for (int k = threadIdx.x; k < plan.n; k += blockDim.x) store(k, row[k]);
  }
};

// Shared memory of a cluster CTA of an n = n1*n2 plan: the row and its
// table, the n-point two-level table, the power slice where it lives there
// (n2 floats), and kClusterWords.
template <int N2>
static inline size_t cluster_smem_bytes(int n1, int n2) {
  using Row = ClusterRow<N2>;
  return sizeof(float2) * (static_cast<size_t>(Row::row_len(n2)) +
                           Row::tab_len(n2) + large_coarse(n1 * n2) +
                           kFine) +
         sizeof(float) * ((Row::kSliceSmem ? static_cast<size_t>(n2) : 0) +
                          kClusterWords);
}

// The cluster size that runs the correlate stage of plan lp, or 0 where it
// stays on the two passes (the note above). kernels/fft_plan.py's
// `cluster_split` is its twin.
static inline int cluster_n1(const LargePlan& lp) {
  if (lp.n1 > 8 || lp.n2 % lp.n1) return 0;
  size_t bytes = 0;
#define GJT_CBYTES(NN) \
  if (lp.n2 == NN) bytes = cluster_smem_bytes<NN>(lp.n1, NN);
  GJT_LARGE_REG_SIZES(GJT_CBYTES)
#undef GJT_CBYTES
  if (bytes == 0) bytes = cluster_smem_bytes<0>(lp.n1, lp.n2);
  return bytes <= kSmemPerBlock ? lp.n1 : 0;
}

// The two halves of cluster.sync(): a thread's arrival releases its
// earlier accesses of shared memory to the cluster; the wait returns once
// every thread of the cluster has arrived.
static __device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block (cell, k1): CTA k1 of cell's cluster of N1. N2: the row's register
// FFT size, 0 for the shared-memory FFT of plan. out and its rows as
// large_cols_corr's: this call's R rows of cells sit at r0.. of R_total.
template <int N1, int N2>
static __global__ void __launch_bounds__(ClusterRow<N2>::T)
pcf_correlate_cluster(const float2* __restrict__ Y,
                      const float2* __restrict__ rep,
                      const float2* __restrict__ tw2,
                      const float2* __restrict__ twn, float* __restrict__ out,
                      FftPlan plan, int G, int R, int R_total, int r0,
                      int n_c, int n_prn, int stats, int excl) {
  namespace cg = cooperative_groups;
  using Row = ClusterRow<N2>;
  constexpr int kI = kClusterPer / N1;   // columns a thread takes
  cg::cluster_group cluster = cg::this_cluster();
  const int k1 = static_cast<int>(cluster.block_rank());
  const int cell = blockIdx.x / N1;
  const int n2 = N2 > 0 ? N2 : plan.n;
  const int n = N1 * n2;
  const int S = n2 / N1;                 // this CTA's columns lo + j
  const int lo = k1 * S;
  const int r = cell % R;
  const int c = (cell / R) % n_c;
  const int p = cell / (R * n_c);
  const int base = k1 - (c - n_c / 2);
  const int t = threadIdx.x, T = blockDim.x;

  extern __shared__ float2 smem[];
  float2* row = smem;
  float2* tab = row + Row::row_len(n2);
  float2* tabn = tab + Row::tab_len(n2);   // the n-point two-level table
  const int coarse = large_coarse(n);
  float* pw = reinterpret_cast<float*>(tabn + coarse + kFine);
  float* red = pw + (Row::kSliceSmem ? n2 : 0);
  int* redi = reinterpret_cast<int*>(red + 64);
  float* xs = reinterpret_cast<float*>(redi + 32);
  Row::stage(tab, tw2, n2);
  for (int k = t; k < coarse + kFine; k += T) tabn[k] = twn[k];
  // the power of slot (t1, i), column j = t + i*T: pw[t1*S + j] or
  // acc[t1*kI + i]; every index is a constant once the loops unroll
  float acc[Row::kSliceSmem ? 1 : kClusterPer];
#pragma unroll
  for (int t1 = 0; t1 < N1; ++t1) {
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      if constexpr (Row::kSliceSmem) {
        if (t + i * T < S) pw[t1 * S + t + i * T] = 0.f;
      } else {
        acc[t1 * kI + i] = 0.f;
      }
    }
  }

  const float2* rp = rep + static_cast<long long>(p) * n;
  for (int g = 0; g < G; ++g) {
    const float2* y = Y + static_cast<long long>(r * G + g) * n +
                      static_cast<long long>(k1) * n2;
    Row::inverse(
        row, tab, plan,
        [&](int k2) { return cmul(y[k2], rp[large_wrap(base + N1 * k2, n)]); },
        [&](int t2, float2 v) { row[t2] = v; },
        [&] {
          if (g > 0) cluster_wait();     // no CTA still reads a row
        });
    cluster.sync();                      // every CTA's row is complete
    // the column step: one column at a time on the register FFT's CTA,
    // whose threads have at most 64-96 registers (unrolled, B1's surface
    // at 32768 took 7.92-8.06 ms against 6.47-6.50, measured on the
    // H100); unrolled beside the shared-memory FFT, whose power slice
    // lives in registers at constant indices
    auto column = [&](int i) {
      const int j = t + i * T;
      if (j < S) {
        float2 v[N1];
        v[0] = cluster.map_shared_rank(row, 0)[lo + j];
#pragma unroll
        for (int q = 1; q < N1; ++q) {
          const int e = q * (lo + j);
          float2 w = cmul(tabn[e >> kFineBits],
                          tabn[coarse + (e & (kFine - 1))]);
          w.y = -w.y;
          v[q] = cmul(cluster.map_shared_rank(row, q)[lo + j], w);
        }
        small_dft<N1, true>(v);
#pragma unroll
        for (int t1 = 0; t1 < N1; ++t1) {
          const float e = v[t1].x * v[t1].x + v[t1].y * v[t1].y;
          if constexpr (Row::kSliceSmem) {
            pw[t1 * S + j] += e;
          } else {
            acc[t1 * kI + i] += e;
          }
        }
      }
    };
    if constexpr (Row::kSliceSmem) {
#pragma unroll 1
      for (int i = 0; i < kI; ++i) column(i);
    } else {
#pragma unroll
      for (int i = 0; i < kI; ++i) column(i);
    }
    cluster_arrive();                    // this CTA read every row
  }
  cluster_wait();

  // ifft's 1/n, squared; each thread's sums, scaled, into sums[t1*kI + i]
  const float scale = 1.f / (static_cast<float>(n) * static_cast<float>(n));
  float sums[kClusterPer];
#pragma unroll
  for (int t1 = 0; t1 < N1; ++t1) {
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int j = t + i * T;
      if constexpr (Row::kSliceSmem) {
        sums[t1 * kI + i] = j < S ? pw[t1 * S + j] * scale : 0.f;
      } else {
        sums[t1 * kI + i] = acc[t1 * kI + i] * scale;
      }
    }
  }
  const long long orow =
      (static_cast<long long>(p) * n_c + c) * R_total + r0 + r;
  if (!stats) {
    float* o = out + orow * n + lo;
#pragma unroll
    for (int t1 = 0; t1 < N1; ++t1) {
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const int j = t + i * T;
        if (j < S) o[static_cast<long long>(t1) * n2 + j] = sums[t1 * kI + i];
      }
    }
    return;
  }
  if (stats == 2) {
    // no CTA reads another's shared memory after the loop's last wait
    float bv = 0.f;
#pragma unroll
    for (int t1 = 0; t1 < N1; ++t1) {
#pragma unroll
      for (int i = 0; i < kI; ++i)
        if (t + i * T < S) bv = fmaxf(bv, sums[t1 * kI + i]);
    }
    prn_peak(out, p, block_max(bv, red));
    return;
  }
  // a thread's lags t1*n2 + lo + j ascend with (t1, i), so a strict '>'
  // keeps its lowest
  float bv = neg_inf(), tl = 0.f;
  int ba = n;
#pragma unroll
  for (int t1 = 0; t1 < N1; ++t1) {
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int j = t + i * T;
      if (j < S) {
        tl += sums[t1 * kI + i];
        if (sums[t1 * kI + i] > bv) {
          bv = sums[t1 * kI + i];
          ba = t1 * n2 + lo + j;
        }
      }
    }
  }
  float mx_cta, tot_cta;
  int arg;
  block_max_arg_sum(bv, ba, tl, red, redi, &mx_cta, &arg, &tot_cta);
  // each CTA stores its (max, arg-lag, total) into slot k1 of every CTA's
  // xs (5 words a slot), and later its (excluded max, window sum) into
  // rank 0's: every access of another CTA's shared memory precedes a
  // cluster barrier, so a CTA may exit after the last one
  if (t == 0) {
    for (int q = 0; q < N1; ++q) {
      float* o = cluster.map_shared_rank(xs, q) + 5 * k1;
      o[0] = mx_cta;
      reinterpret_cast<int*>(o)[1] = arg;
      o[3] = tot_cta;
    }
  }
  cluster.sync();                        // every CTA's (max, arg) is here
  float mx = neg_inf();
  arg = n;
  for (int q = 0; q < N1; ++q) {
    const float v = xs[5 * q];
    const int a = reinterpret_cast<const int*>(xs)[5 * q + 1];
    if (v > mx || (v == mx && a < arg)) {
      mx = v;
      arg = a;
    }
  }
  if (excl >= 0) {
    // does the window min(d, n - d) <= excl around arg meet a run
    // [t1*n2 + lo, t1*n2 + lo + S) of this slice? (a run without arg is
    // nearest to it at an end)
    bool meets = false;
    for (int t1 = 0; t1 < N1; ++t1) {
      const int a0 = t1 * n2 + lo;
      const int d0 = wrap(arg - a0, n);
      const int d1 = wrap(a0 + S - 1 - arg, n);
      meets |= d0 < S || min(d0, n - d0) <= excl || min(d1, n - d1) <= excl;
    }
    float exl = mx_cta, wl = 0.f;
    if (meets) {
      exl = neg_inf();
#pragma unroll
      for (int t1 = 0; t1 < N1; ++t1) {
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          const int j = t + i * T;
          if (j < S) {
            const float a = sums[t1 * kI + i];
            const int d = wrap(t1 * n2 + lo + j - arg, n);
            if (min(d, n - d) <= excl) {
              wl += a;
            } else {
              exl = fmaxf(exl, a);
            }
          }
        }
      }
      block_max_sum(&exl, &wl, red);
    }
    if (t == 0) {
      float* o = cluster.map_shared_rank(xs, 0) + 5 * k1;
      o[2] = exl;
      o[4] = wl;
    }
    cluster.sync();                      // every CTA's partials are at rank 0
  }
  if (k1 == 0 && t == 0) {
    float ex = neg_inf(), tot = 0.f, ws = 0.f;
    for (int q = 0; q < N1; ++q) {
      ex = fmaxf(ex, xs[5 * q + 2]);
      tot += xs[5 * q + 3];
      ws += xs[5 * q + 4];
    }
    if (excl < 0) ex = tot = ws = 0.f;
    const long long n_cells = static_cast<long long>(n_prn) * n_c * R_total;
    out[orow] = mx;
    out[n_cells + orow] = static_cast<float>(arg);
    out[2 * n_cells + orow] = ex;
    out[3 * n_cells + orow] = tot;
    out[4 * n_cells + orow] = ws;
  }
}

template <int N1, int N2>
static inline cudaError_t launch_cluster_nn(
    const float2* Y, const float2* rep, const float2* tw2, const float2* twn,
    float* out, int R, int R_total, int r0, int G, int n_c, int P,
    const LargePlan& lp, int stats, int excl, cudaStream_t s) {
  const auto kern = pcf_correlate_cluster<N1, N2>;
  const size_t smem = cluster_smem_bytes<N2>(N1, lp.n2);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R * n_c * P * N1));
  cfg.blockDim = dim3(ClusterRow<N2>::T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, Y, rep, tw2, twn, out, lp.row, G, R,
                           R_total, r0, n_c, P, stats, excl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int N1>
static inline cudaError_t launch_cluster_n1(
    const float2* Y, const float2* rep, const float2* tw2, const float2* twn,
    float* out, int R, int R_total, int r0, int G, int n_c, int P,
    const LargePlan& lp, int stats, int excl, cudaStream_t s) {
#define GJT_CLUSTER(NN)                                                    \
  if (lp.n2 == NN)                                                         \
    return launch_cluster_nn<N1, NN>(Y, rep, tw2, twn, out, R, R_total, r0, \
                                     G, n_c, P, lp, stats, excl, s);
  GJT_LARGE_REG_SIZES(GJT_CLUSTER)
#undef GJT_CLUSTER
  return launch_cluster_nn<N1, 0>(Y, rep, tw2, twn, out, R, R_total, r0, G,
                                  n_c, P, lp, stats, excl, s);
}

// The correlate stage of plan lp (cluster_n1(lp) > 0) over the R * n_c * P
// cells of forward spectra Y, one launch, one cluster per cell; out as
// launch_large_correlate's.
static inline cudaError_t launch_cluster_correlate(
    const float2* Y, const float2* rep, const float2* tw2, const float2* twn,
    float* out, int R, int R_total, int r0, int G, int n_c, int P,
    const LargePlan& lp, int stats, int excl, cudaStream_t s) {
  switch (cluster_n1(lp)) {
    case 2:
      return launch_cluster_n1<2>(Y, rep, tw2, twn, out, R, R_total, r0, G,
                                  n_c, P, lp, stats, excl, s);
    case 4:
      return launch_cluster_n1<4>(Y, rep, tw2, twn, out, R, R_total, r0, G,
                                  n_c, P, lp, stats, excl, s);
    case 8:
      return launch_cluster_n1<8>(Y, rep, tw2, twn, out, R, R_total, r0, G,
                                  n_c, P, lp, stats, excl, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace gjt
