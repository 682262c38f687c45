// The four-step (Bailey) FFT of rows longer than one block holds: kernels
// B1 and B3 above 16384 lags (pcf_correlate.cuh) and kernel B2 above 16384
// points per segment (welch_psd.cu).
//
// A 32768-point complex64 row is 256 KB, more than the 227 KB of shared
// memory one block can take, so the one-block-per-row FFTs of fft_reg.cuh
// and fft_smem.cuh stop at kMaxN = 16384. Above it, n = n1 * n2 with n1
// the least of 2, 4, 8 and 16 that leaves n2 <= 16384 (large_plan; n1 =
// 16 only above 131072, kernel B3's sizes up to kStdMaxN = 262144), and
// the transform goes through device memory in two passes built from the
// FFTs the port already has:
// - the column pass: thread j2 < n2 runs the n1-point DFT (in registers)
//   of the strided column x[j2 + n2*j1], j1 < n1, and multiplies output k1
//   by the twiddle w_n^(k1*j2); the row (k1) layout A[k1*n2 + j2] is
//   written coalesced, each thread one column;
// - the row pass: n1 rows of n2 points, one block each, on the register
//   FFT at the sizes of GJT_LARGE_REG_SIZES (the B2 schedules 10240, 12288
//   and 14336, and 16384), else on the mixed-radix shared-memory FFT,
//   whose odd primes go up to kRowMaxRadix (1021) here.
// Forward, columns then rows, this leaves X[k1 + n1*k2] at A[k1*n2 + k2]:
// the spectrum in a permuted order, with no transpose. The inverse of the
// correlate stage runs the other way round on that order: rows first
// (the replica product folded into their load, the twiddle w_n^-(k1*t2)
// into their store), then the n1-point columns, whose outputs
// x[t2 + n2*t1] come out in natural lag order (pcf_correlate.cuh; for n1
// <= 8 the correlate stage runs both in one thread-block cluster instead,
// the rows in the CTAs' shared memory, pcf_correlate_cluster). So
// neither direction transposes, and kernels/fft_plan.py's four_step_*
// run the same index arithmetic in NumPy against np.fft.
//
// Twiddles w_n^e come from the n-point two-level table of fft_reg.cuh
// (ceil(n/64) coarse, then 64 fine entries, computed in float64 on the
// host), read from device memory through the read-only cache: one product
// of two table entries, never a repeated product.
//
// What bounds it: device memory. Each pass reads and writes the row
// (n * 8 bytes) once more than a one-block FFT would; the wrappers chunk
// their scratch (ops/cuda_pcf.py, cuda_caf.py, cuda_psd.py) to at most
// 512 MB per call.
#pragma once

#include <cuda_runtime.h>

#include "fft_reg.cuh"
#include "fft_smem.cuh"

#if !defined(GJT_FFT_LARGE_MAX_N) || !defined(GJT_FFT_STD_MAX_N)
#error "kernels/build.py defines the four-step FFT's largest n"
#endif

namespace gjt {

// The largest n of kernels B1 and B2 (their gates take less: v3's 32768,
// `pallas_psd`'s 131072), and of kernel B3.
constexpr int kLargeMaxN = GJT_FFT_LARGE_MAX_N;
constexpr int kStdMaxN = GJT_FFT_STD_MAX_N;
constexpr int kMaxN1 = 16;
static_assert(kStdMaxN <= kMaxN1 * kMaxN && kLargeMaxN <= kStdMaxN,
              "the four-step splits n into at most 16 rows of kMaxN");
constexpr int kColThreads = 256;     // threads per column-pass block

// The row lengths n2 whose row pass runs the register FFT (each a size of
// GJT_REG_SCHEDULES); every other n2 runs the shared-memory FFT.
// kernels/fft_plan.py reads the list (LARGE_REG_SIZES).
#define GJT_LARGE_REG_SIZES(X) X(10240) X(12288) X(14336) X(16384)

// n = n1 * n2 and the plan of the n2-point rows.
struct LargePlan {
  int n;
  int n1;
  int n2;
  FftPlan row;
};

// Fills `lp` for kMaxN < n <= max_n (host side; max_n kLargeMaxN or
// kStdMaxN): n1 the least of 2, 4, 8 and 16 with n2 = n/n1 <= kMaxN, n2
// every prime factor <= kRowMaxRadix. False otherwise.
static inline bool large_plan(int n, int max_n, LargePlan* lp) {
  if (n <= kMaxN || n > max_n) return false;
  for (int n1 = 2; n1 <= kMaxN1; n1 *= 2) {
    if (n % n1 == 0 && n / n1 <= kMaxN) {
      lp->n = n;
      lp->n1 = n1;
      lp->n2 = n / n1;
      return make_plan(lp->n2, &lp->row, kRowMaxRadix);
    }
  }
  return false;
}

// Entries of the n-point table before its 64 fine ones.
static __host__ __device__ __forceinline__ int large_coarse(int n) {
  return (n + kFine - 1) >> kFineBits;
}

// exp(-+2*pi*i*e/n), 0 <= e < n, from the n-point two-level table in
// device memory (INV: +).
template <bool INV>
static __device__ __forceinline__ float2 large_twiddle(const float2* twn,
                                                       int e, int n) {
  float2 w = cmul(__ldg(twn + (e >> kFineBits)),
                  __ldg(twn + large_coarse(n) + (e & (kFine - 1))));
  if (INV) w.y = -w.y;
  return w;
}

// v mod n for v in (-n, 2n).
static __device__ __forceinline__ int large_wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The R-point DFT of v in registers, natural order out (R: 2, 4, 8 or 16).
template <int R, bool INV>
static __device__ __forceinline__ void small_dft(float2 (&v)[R]) {
  static_assert(R == 2 || R == 4 || R == 8 || R == 16,
                "n1 is 2, 4, 8 or 16");
  dft_nat<R, INV, 16384>(v, nullptr);
}

// The column pass of a forward transform: rows of src (Src::at(row, j),
// j < n) -> A[row*n + k1*n2 + j2] = w_n^(k1*j2) * sum_j1 x[j2 + n2*j1]
// w_n1^(j1*k1). Block (blockIdx.x, blockIdx.y = row), a thread per j2.
template <int N1, class Src>
static __global__ void __launch_bounds__(kColThreads)
large_cols_fwd(Src src, float2* __restrict__ A,
               const float2* __restrict__ twn, int n2) {
  const int j2 = blockIdx.x * kColThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (j2 >= n2) return;
  const int n = N1 * n2;
  float2 v[N1];
#pragma unroll
  for (int j1 = 0; j1 < N1; ++j1) v[j1] = src.at(row, j2 + j1 * n2);
  small_dft<N1, false>(v);
  float2* a = A + static_cast<long long>(row) * n + j2;
  a[0] = v[0];
#pragma unroll
  for (int k1 = 1; k1 < N1; ++k1)
    a[k1 * n2] = cmul(v[k1], large_twiddle<false>(twn, k1 * j2, n));
}

// The row pass on the register FFT: block b transforms the N2 points
// op.row(b).load(k) and hands output k to op.row(b).store(k, X[k]).
template <int N2, class Op>
static __global__ void __launch_bounds__(RegShape<N2>::T)
large_rows_reg(Op op, const float2* __restrict__ tab) {
  using S = RegShape<N2>;
  extern __shared__ float2 smem[];
  float2* buf0 = smem;
  float2* buf1 = S::kBuffers == 2 ? smem + S::kBufLen : smem;
  float2* tab_s = smem + S::kBuffers * S::kBufLen;
  stage_reg_twiddles<N2>(tab_s, tab);
  const auto row = op.row(blockIdx.x);
  const int t = threadIdx.x;
  float2 v[S::P];
  // every load of the block precedes this barrier and every store follows
  // the transform's last one, so a row may be transformed in place
  reg_first<N2>(v, t, [&](int k) { return row.load(k); });
  __syncthreads();                       // the table is staged
  int phase = 0;
  reg_fft<N2, Op::kInverse>(v, buf0, buf1, tab_s, phase);
#pragma unroll
  for (int j = 0; j < S::UL * S::RL; ++j) {
    const int k = S::out_index(t, j);
    if (S::kFullL || k < N2) row.store(k, v[j]);
  }
}

// The row pass on the mixed-radix shared-memory FFT (any other n2; n2 >
// 8192 here, so a block of kMaxThreads, which fft_radix_p_direct needs).
template <class Op>
static __global__ void __launch_bounds__(kMaxThreads)
large_rows_smem(Op op, const float2* __restrict__ tw, FftPlan plan) {
  const int n2 = plan.n;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw_s = smem + n2;
  stage_twiddles(tw_s, tw, n2);
  const auto row = op.row(blockIdx.x);
  for (int k = threadIdx.x; k < n2; k += blockDim.x)
    buf[digit_rev(k, plan)] = row.load(k);
  __syncthreads();
  fft_mixed<Op::kInverse, true>(buf, tw_s, plan);
  for (int k = threadIdx.x; k < n2; k += blockDim.x) row.store(k, buf[k]);
}

// Launches the row pass over `rows` rows of n2 points. tw2: the two-level
// table of n2 (fft_reg.cuh) at a size of GJT_LARGE_REG_SIZES, else its half
// table (fft_smem.cuh): `build.large_row_twiddles`.
template <class Op>
static inline cudaError_t launch_large_rows(const Op& op, int rows,
                                            const float2* tw2,
                                            const LargePlan& lp,
                                            cudaStream_t s) {
  cudaError_t err;
#define GJT_LROWS(NN)                                                       \
  if (lp.n2 == NN) {                                                        \
    const size_t smem = reg_smem_bytes<NN>();                               \
    err = allow_smem(reinterpret_cast<const void*>(large_rows_reg<NN, Op>), \
                     smem);                                                 \
    if (err != cudaSuccess) return err;                                     \
    large_rows_reg<NN, Op><<<rows, RegShape<NN>::T, smem, s>>>(op, tw2);    \
    return cudaGetLastError();                                              \
  }
  GJT_LARGE_REG_SIZES(GJT_LROWS)
#undef GJT_LROWS
  const size_t smem = sizeof(float2) * (lp.n2 + tw_len(lp.n2));
  err = allow_smem(reinterpret_cast<const void*>(large_rows_smem<Op>), smem);
  if (err != cudaSuccess) return err;
  large_rows_smem<Op><<<rows, kMaxThreads, smem, s>>>(op, tw2, lp.row);
  return cudaGetLastError();
}

// Launches the column pass of a forward transform over `rows` rows.
template <class Src>
static inline cudaError_t launch_large_cols_fwd(const Src& src, float2* A,
                                                const float2* twn, int rows,
                                                const LargePlan& lp,
                                                cudaStream_t s) {
  const dim3 grid((lp.n2 + kColThreads - 1) / kColThreads, rows);
  switch (lp.n1) {
    case 2:
      large_cols_fwd<2, Src><<<grid, kColThreads, 0, s>>>(src, A, twn, lp.n2);
      break;
    case 4:
      large_cols_fwd<4, Src><<<grid, kColThreads, 0, s>>>(src, A, twn, lp.n2);
      break;
    case 8:
      large_cols_fwd<8, Src><<<grid, kColThreads, 0, s>>>(src, A, twn, lp.n2);
      break;
    case 16:
      large_cols_fwd<16, Src><<<grid, kColThreads, 0, s>>>(src, A, twn,
                                                           lp.n2);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The row pass of a forward transform, in place: A[b*n2 + k] -> its
// n2-point FFT.
struct RowsInPlace {
  static constexpr bool kInverse = false;
  float2* a;
  int n2;
  struct Row {
    float2* p;
    __device__ __forceinline__ float2 load(int k) const { return p[k]; }
    __device__ __forceinline__ void store(int k, float2 v) const {
      p[k] = v;
    }
  };
  __device__ __forceinline__ Row row(int b) const {
    return Row{a + static_cast<long long>(b) * n2};
  }
};

// The forward FFT of `rows` rows of src into A (rows, n), in the permuted
// order A[row*n + k1*n2 + k2] = X[k1 + n1*k2]: the column pass, then the
// row pass in place.
template <class Src>
static inline cudaError_t launch_large_forward(const Src& src, float2* A,
                                               const float2* tw2,
                                               const float2* twn, int rows,
                                               const LargePlan& lp,
                                               cudaStream_t s) {
  cudaError_t err = launch_large_cols_fwd(src, A, twn, rows, lp, s);
  if (err != cudaSuccess) return err;
  return launch_large_rows(RowsInPlace{A, lp.n2}, rows * lp.n1, tw2, lp, s);
}

}  // namespace gjt
