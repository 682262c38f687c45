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
//   2. pcf_correlate (pcf_correlate.cuh, shared with kernel B3): one block
//      per (PRN p, coarse c, row r = s*F + f): for each group g,
//      Y[r, g, k] * rep[p, (k - shift_c) mod n] -> inverse FFT (with the
//      1/n of ifft) -> |.|^2, summed over groups in registers. The coarse
//      shift is index arithmetic on the replica, so no shifted table exists.
// Epilogue modes: the surface row out[p, c*R + r, :]; or per-(p, row)
// statistics (max, arg-lag with the lowest lag winning ties, max outside
// the circular window min(d, n-d) <= excl, total sum, window sum) as five
// (P, n_c*R) planes; excl < 0 is peak-only (the last three are zeros).
//
// What bounds it: the inverse FFTs. The GPS search (32 PRN x 15 coarse x
// 6 rows x 2 groups) runs 5760 inverse transforms of 2048 points for every
// block of input, against 12 forward ones: 0.77 GFLOP of float32 at 5 n
// log2 n each, 0.011 ms at the card's 67 TFLOP/s. Each inverse stays on
// chip from the replica product to |.|^2 (the register FFT of
// fft_reg.cuh: 3 passes at 2048, 2 conflict-free exchanges through shared
// memory), and in statistics mode the delay x Doppler surface never
// reaches device memory: the only output is 5 x (P, rows) floats.
//
// n: every length in [128, 16384] whose prime factors are all <= 127; a
// power of two and 2400, 2560, 2800, 3200 and 10368 (GJT_CORR_SIZES) run
// the register FFT, any other n the mixed-radix shared-memory one
// (fft_smem.cuh). Above 16384 (gjt_pcf_large: 20480 ... 32768, the sizes
// of the TPU kernel's v3; Galileo E1B at 8.192 MS/s is 32768) a row no
// longer fits one block: the forward transforms run the four-step FFT of
// fft_large.cuh through device memory, and the correlate stage runs in one
// thread-block cluster of two CTAs per cell, the two 16384-point halves of
// each row in the CTAs' shared memory (pcf_correlate.cuh,
// pcf_correlate_cluster), so no row goes back to device memory.
#include <cuda_runtime.h>

#include "pcf_correlate.cuh"

namespace {

// Any other n: one block per row, digit-reversed load, fft_mixed.
__global__ void __launch_bounds__(gjt::kMaxThreads)
pcf_forward_kernel(const float2* __restrict__ y, float2* __restrict__ Y,
                   const float2* __restrict__ tw, gjt::FftPlan plan) {
  const int n = plan.n;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw_s = smem + n;
  gjt::stage_twiddles(tw_s, tw, n);
  const float2* src = y + static_cast<long long>(blockIdx.x) * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    buf[gjt::digit_rev(t, plan)] = src[t];
  __syncthreads();
  gjt::fft_mixed<false>(buf, tw_s, plan);
  float2* dst = Y + static_cast<long long>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = buf[k];
}

cudaError_t launch_forward(const float2* y, float2* Y, const float2* tw,
                           int rows, const gjt::FftPlan& plan,
                           cudaStream_t s) {
  if (gjt::corr_reg_size(plan.n))
    return gjt::launch_reg_forward(y, nullptr, Y, tw, rows, 1, plan.n, s);
  const size_t smem = gjt::fft_smem_bytes(plan.n);
  cudaError_t err = gjt::allow_smem(
      reinterpret_cast<const void*>(pcf_forward_kernel), smem);
  if (err != cudaSuccess) return err;
  pcf_forward_kernel<<<rows, gjt::fft_threads(plan.n), smem, s>>>(y, Y, tw,
                                                                  plan);
  return cudaGetLastError();
}

}  // namespace

// y: (R*G, n) complex64, rows ordered (r, g); Y: same-shape scratch;
// rep: (P, n) complex64; tw: the twiddle table of `build.row_twiddles(n)`
// (the two-level table of fft_reg.cuh for a size of GJT_CORR_SIZES, else
// the half table of fft_smem.cuh), complex64; out: the surface
// (P, n_c*R, n) float32 when stats == 0, else (5, P, n_c*R) float32.
// n in [128, 16384] with every prime factor <= 127. Returns a cudaError_t
// (0 on success).
extern "C" int gjt_pcf(const void* y, void* Y, const void* rep,
                       const void* tw, void* out, int R, int G, int n_c,
                       int P, int n, int stats, int excl, void* stream) {
  gjt::FftPlan plan;
  if (!gjt::row_plan(n, &plan) || R < 1 || G < 1 || P < 1 || n_c < 1 ||
      (n_c & 1) == 0 || n_c / 2 >= n || (stats && excl >= n / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* y2 = static_cast<const float2*>(y);
  float2* Y2 = static_cast<float2*>(Y);
  const float2* tw2 = static_cast<const float2*>(tw);
  cudaError_t err = launch_forward(y2, Y2, tw2, R * G, plan, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gjt::launch_correlate(
      Y2, static_cast<const float2*>(rep), tw2, static_cast<float*>(out), R,
      G, n_c, P, plan, stats, excl, s));
}

// n above 16384 (fft_large.cuh; kernels B1 take it up to 32768): y as
// above; Y: (R*G, n) complex64 scratch, left in the permuted order of
// launch_large_forward; tw2: the table of the n2-point rows
// (`build.large_row_twiddles`); twn: the n-point two-level table
// (`build.reg_twiddles(n)`); out as gjt_pcf. The correlate stage runs in
// one thread-block cluster per cell (pcf_correlate_cluster); an n whose
// plan the cluster does not take is refused. Returns a cudaError_t (0 on
// success).
extern "C" int gjt_pcf_large(const void* y, void* Y, const void* rep,
                             const void* tw2, const void* twn, void* out,
                             int R, int G, int n_c, int P, int n, int stats,
                             int excl, void* stream) {
  gjt::LargePlan lp;
  if (!gjt::large_plan(n, gjt::kLargeMaxN, &lp) ||
      gjt::cluster_n1(lp) == 0 || R < 1 || G < 1 || P < 1 || n_c < 1 ||
      (n_c & 1) == 0 || n_c / 2 >= n || (stats && excl >= n / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* Y2 = static_cast<float2*>(Y);
  const float2* tw2_ = static_cast<const float2*>(tw2);
  const float2* twn_ = static_cast<const float2*>(twn);
  cudaError_t err = gjt::launch_large_forward(
      gjt::SrcRows{static_cast<const float2*>(y), n}, Y2, tw2_, twn_, R * G,
      lp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gjt::launch_cluster_correlate(
      Y2, static_cast<const float2*>(rep), tw2_, twn_,
      static_cast<float*>(out), R, R, 0, G, n_c, P, lp, stats, excl, s));
}
