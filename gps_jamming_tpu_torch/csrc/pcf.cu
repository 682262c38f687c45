// Post-correlation-FFT (PCF) acquisition search (kernel B1 of the port).
//
// Replaces the TPU kernel gps_jamming_tpu/ops/pallas_caf.py:_make_kernel_v3
// as launched by _pcf_single_launch (from caf_accumulate_pcf_fused),
// including its in-kernel statistics mode.
//
// Input: the code periods x (G groups of gl), the group weights w and the
// sub-bin mixes of ops/cuda_pcf.py's `prologue_consts`, the natural-order
// conj replica spectra rep[p, k], and the coarse-shift count n_c. Two
// launches:
//   1. the forward: one block per (s, f, g) row; the row
//      y[(s, f), g](t) = mix[s, t] * sum_b w[s, f, g, b] x[g*gl + b, t]
//      (the prologue, pcf_correlate.cuh's SrcFold) is built as it is
//      loaded, then its n-point FFT -> Y. No y exists in device memory.
//   2. pcf_correlate (pcf_correlate.cuh, shared with kernel B3): one block
//      per (PRN p, coarse c, row r = s*F + f): for each group g,
//      Y[r, g, k] * rep[p, (k - shift_c) mod n] -> inverse FFT (with the
//      1/n of ifft) -> |.|^2, summed over groups in registers. The coarse
//      shift is index arithmetic on the replica, so no shifted table exists.
// Epilogue modes (`mode`): 0, the surface row out[p, c*R + r, :]; 1,
// per-(p, row) statistics (max, arg-lag with the lowest lag winning ties,
// max outside the circular window min(d, n-d) <= excl, total sum, window
// sum) as five (P, n_c*R) planes, excl < 0 peak-only (the last three are
// zeros); 2, the per-PRN peak (P,), the max over every row and lag, which
// the entry zeroes on the stream before the launches and each correlate
// block raises by an atomicMax.
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
template <class Src>
__global__ void __launch_bounds__(gjt::kMaxThreads)
pcf_forward_kernel(Src src, float2* __restrict__ Y,
                   const float2* __restrict__ tw, gjt::FftPlan plan) {
  const int n = plan.n;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw_s = smem + n;
  gjt::stage_twiddles(tw_s, tw, n);
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    buf[gjt::digit_rev(t, plan)] = src.at(blockIdx.x, t);
  __syncthreads();
  gjt::fft_mixed<false>(buf, tw_s, plan);
  float2* dst = Y + static_cast<long long>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = buf[k];
}

template <class Src>
cudaError_t launch_forward(const Src& src, float2* Y, const float2* tw,
                           int rows, const gjt::FftPlan& plan,
                           cudaStream_t s) {
  if (gjt::corr_reg_size(plan.n))
    return gjt::launch_reg_forward(src, Y, tw, rows, plan.n, s);
  const size_t smem = gjt::fft_smem_bytes(plan.n);
  cudaError_t err = gjt::allow_smem(
      reinterpret_cast<const void*>(pcf_forward_kernel<Src>), smem);
  if (err != cudaSuccess) return err;
  pcf_forward_kernel<Src><<<rows, gjt::fft_threads(plan.n), smem, s>>>(
      src, Y, tw, plan);
  return cudaGetLastError();
}

// The checks both entries share: R rows in S sets, G groups of gl periods,
// an odd n_c below 2n, a mode of 0-2 and, in mode 1, excl < n/2.
bool valid(int R, int S, int G, int gl, int n_c, int P, int n, int mode,
           int excl) {
  return R >= 1 && S >= 1 && R % S == 0 && G >= 1 && gl >= 1 && P >= 1 &&
         n_c >= 1 && (n_c & 1) == 1 && n_c / 2 < n && mode >= 0 &&
         mode <= 2 && !(mode == 1 && excl >= n / 2);
}

// B1's row source over the G*gl periods x, for F fine rows a set.
gjt::SrcFold fold(const void* x, const void* w, const void* mix, int n,
                  int G, int gl, int F) {
  return gjt::SrcFold{static_cast<const float2*>(x),
                      static_cast<const float2*>(w),
                      static_cast<const float2*>(mix), n, G, gl, F * G};
}

// Mode 2: zero the (P,) peaks that the correlate blocks raise.
cudaError_t zero_peaks(void* out, int P, int mode, cudaStream_t s) {
  return mode == 2 ? cudaMemsetAsync(out, 0, sizeof(float) * P, s)
                   : cudaSuccess;
}

}  // namespace

// x: the G*gl code periods, (G*gl, n) complex64 (the first G*gl*n
// samples at x); w: (S*F*G, gl) complex64 group weights, rows ordered
// ((s, f), g); mix: (S, n) complex64 sub-bin mixes; R = S*F rows; Y:
// (R*G, n) complex64 scratch; rep: (P, n) complex64; tw: the twiddle
// table of `build.row_twiddles(n)` (the two-level table of fft_reg.cuh for
// a size of GJT_CORR_SIZES, else the half table of fft_smem.cuh),
// complex64; out: by mode, the surface (P, n_c*R, n), the statistics
// (5, P, n_c*R) or the peaks (P,), float32. n in [128, 16384] with every
// prime factor <= 127. Returns a cudaError_t (0 on success).
extern "C" int gjt_pcf(const void* x, const void* w, const void* mix,
                       void* Y, const void* rep, const void* tw, void* out,
                       int R, int S, int G, int gl, int n_c, int P, int n,
                       int mode, int excl, void* stream) {
  gjt::FftPlan plan;
  if (!gjt::row_plan(n, &plan) || !valid(R, S, G, gl, n_c, P, n, mode, excl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* Y2 = static_cast<float2*>(Y);
  const float2* tw2 = static_cast<const float2*>(tw);
  cudaError_t err = zero_peaks(out, P, mode, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_forward(fold(x, w, mix, n, G, gl, R / S), Y2, tw2, R * G,
                       plan, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gjt::launch_correlate(
      Y2, static_cast<const float2*>(rep), tw2, static_cast<float*>(out), R,
      G, n_c, P, plan, mode, excl, s));
}

// n above 16384 (fft_large.cuh; kernels B1 take it up to 32768): x, w,
// mix, rep, out and the sizes as gjt_pcf; Y: (R*G, n) complex64 scratch,
// left in the permuted order of launch_large_forward, whose column pass
// builds the rows from the periods (large_cols_fwd<n1, SrcFold>); tw2: the
// table of the n2-point rows (`build.large_row_twiddles`); twn: the
// n-point two-level table (`build.reg_twiddles(n)`). The correlate stage
// runs in one thread-block cluster per cell (pcf_correlate_cluster); an n
// whose plan the cluster does not take is refused. Returns a cudaError_t
// (0 on success).
extern "C" int gjt_pcf_large(const void* x, const void* w, const void* mix,
                             void* Y, const void* rep, const void* tw2,
                             const void* twn, void* out, int R, int S, int G,
                             int gl, int n_c, int P, int n, int mode,
                             int excl, void* stream) {
  gjt::LargePlan lp;
  if (!gjt::large_plan(n, gjt::kLargeMaxN, &lp) ||
      gjt::cluster_n1(lp) == 0 || !valid(R, S, G, gl, n_c, P, n, mode, excl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* Y2 = static_cast<float2*>(Y);
  const float2* tw2_ = static_cast<const float2*>(tw2);
  const float2* twn_ = static_cast<const float2*>(twn);
  cudaError_t err = zero_peaks(out, P, mode, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gjt::launch_large_forward(fold(x, w, mix, n, G, gl, R / S), Y2,
                                  tw2_, twn_, R * G, lp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gjt::launch_cluster_correlate(
      Y2, static_cast<const float2*>(rep), tw2_, twn_,
      static_cast<float*>(out), R, R, 0, G, n_c, P, lp, mode, excl, s));
}
