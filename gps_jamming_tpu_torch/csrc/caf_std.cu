// Per-Doppler ("std") acquisition search (kernel B3 of the port).
//
// Replaces the three TPU layouts of one computation in
// gps_jamming_tpu/ops/pallas_caf.py: caf_accumulate_fused (v1, body
// _make_kernel), caf_accumulate_fused_v2 (_make_kernel_v2) and
// caf_accumulate_fused_v3 (_make_kernel_v3 on the (freq, block) grid):
//
//   out[p, f, :] = sum_b |IFFT(FFT(x_b * osc_f) * rep[p])|^2
//
// with osc_f[t] = exp(-2*pi*i*f*t/fs), the reference's non-coherent sum of
// n_blocks code periods (sdracq.c:15-27). Two launches:
//   1. mix + forward FFT: one block per (bin f, block b): x_b * osc_f ->
//      n-point FFT -> Y[f*nb + b]. The phasor rows come from a table the
//      wrapper builds once per shape (float64 on the host, cast to
//      complex64).
//   2. pcf_correlate (pcf_correlate.cuh, the correlate stage of kernel B1)
//      with R = F rows, G = nb groups, one coarse bin (no shift) and the
//      surface epilogue: one block per (PRN p, bin f) runs product ->
//      inverse FFT -> |.|^2, summed over the blocks in registers ->
//      out[p*F + f, :], already the (P, F, n) layout.
//
// What bounds it: the inverse FFTs, P*F*nb of them against F*nb forward
// ones (the GPS search, 32 PRN x 71 bins x 10 periods, runs 22720 inverse
// transforms of 2048 points, 3.1 GFLOP of float32 at 5 n log2 n each, and
// writes an 18.6 MB surface: 0.046 ms on the card; Galileo E1B, 36 x 71 x
// 10, 25560 of 16384, 34.4 GFLOP and 167.5 MB: 0.51 ms). Each inverse
// stays on chip from the replica product to |.|^2, and the sum over blocks
// stays in registers, so the only device-memory traffic per (p, f) is nb
// spectrum rows in and one surface row out. A power-of-two n runs the
// register FFT of fft_reg.cuh (2048: 3 passes, 2 conflict-free exchanges;
// 16384: 4 passes, 3 exchanges, one 1024-thread block per SM, the note of
// pcf_correlate.cuh says why).
//
// n: every length in [128, 16384] whose prime factors are all <= 127, as
// v1 takes every multiple of 128 with a divisor <= 256 (3200 = 25*128 at
// 3.2 MS/s GPS, 10368 = 81*128) and the RTL-SDR rates give 2400, 2560 and
// 2800: a power of two and these five (GJT_CORR_SIZES) run the register
// FFT, any other n the mixed-radix one of fft_smem.cuh (radix-2 stages,
// then a direct radix-p stage per odd prime factor). Above 16384
// (gjt_caf_std_large: every multiple of 128 up to 262144 whose prime
// factors are all <= 1021, so every n that v1 and v2 take there) the
// mix-forward runs the four-step FFT of fft_large.cuh through device
// memory, the Doppler bins in chunks; the correlate stage runs in one
// thread-block cluster of n1 CTAs per (PRN, bin) cell up to 131072
// (pcf_correlate_cluster), and above it (n1 = 16) on the four-step's two
// passes through scratch, the cells in chunks (pcf_correlate.cuh,
// cluster_n1).
#include <cuda_runtime.h>

#include "pcf_correlate.cuh"

namespace {

// Any other n: one block per (f, b), digit-reversed load, fft_mixed.
__global__ void __launch_bounds__(gjt::kMaxThreads)
caf_mix_forward_kernel(const float2* __restrict__ x,
                       const float2* __restrict__ osc,
                       float2* __restrict__ Y, const float2* __restrict__ tw,
                       int nb, gjt::FftPlan plan) {
  const int n = plan.n;
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw_s = smem + n;
  gjt::stage_twiddles(tw_s, tw, n);
  const int f = blockIdx.x / nb;
  const int b = blockIdx.x % nb;
  const float2* xb = x + static_cast<long long>(b) * n;
  const float2* of = osc + static_cast<long long>(f) * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    buf[gjt::digit_rev(t, plan)] = gjt::cmul(xb[t], of[t]);
  __syncthreads();
  gjt::fft_mixed<false>(buf, tw_s, plan);
  float2* dst = Y + static_cast<long long>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = buf[k];
}

cudaError_t launch_mix_forward(const float2* x, const float2* osc, float2* Y,
                               const float2* tw, int F, int nb,
                               const gjt::FftPlan& plan, cudaStream_t s) {
  if (gjt::corr_reg_size(plan.n))
    return gjt::launch_reg_forward(gjt::SrcMix{x, osc, plan.n, nb}, Y, tw,
                                   F * nb, plan.n, s);
  const size_t smem = gjt::fft_smem_bytes(plan.n);
  cudaError_t err = gjt::allow_smem(
      reinterpret_cast<const void*>(caf_mix_forward_kernel), smem);
  if (err != cudaSuccess) return err;
  caf_mix_forward_kernel<<<F * nb, gjt::fft_threads(plan.n), smem, s>>>(
      x, osc, Y, tw, nb, plan);
  return cudaGetLastError();
}

}  // namespace

// x: (nb, n) complex64 blocks; osc: (F, n) complex64 phasor rows; Y:
// (F*nb, n) complex64 scratch, rows ordered (f, b); rep: (P, n) complex64
// natural-order conj replica spectra; tw: the table of
// `build.row_twiddles(n)` (two-level for a size of GJT_CORR_SIZES, else
// half), complex64; out: the
// (P, F, n) float32 surface. n in [128, 16384] with every prime factor
// <= 127. Returns a cudaError_t (0 on success).
extern "C" int gjt_caf_std(const void* x, const void* osc, void* Y,
                           const void* rep, const void* tw, void* out, int F,
                           int nb, int P, int n, void* stream) {
  gjt::FftPlan plan;
  if (!gjt::row_plan(n, &plan) || F < 1 || nb < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* x2 = static_cast<const float2*>(x);
  const float2* osc2 = static_cast<const float2*>(osc);
  float2* Y2 = static_cast<float2*>(Y);
  const float2* tw2 = static_cast<const float2*>(tw);
  cudaError_t err = launch_mix_forward(x2, osc2, Y2, tw2, F, nb, plan, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gjt::launch_correlate(
      Y2, static_cast<const float2*>(rep), tw2, static_cast<float*>(out), F,
      nb, 1, P, plan, 0, 0, s));
}

// n above 16384 (fft_large.cuh, up to GJT_FFT_STD_MAX_N): x, osc, rep
// and out as gjt_caf_std; the Doppler bins run in chunks of f_chunk: Y:
// (f_chunk*nb, n) complex64 scratch, the chunk's forward spectra in the
// permuted order of launch_large_forward; Bs: (cells_chunk, nb, n)
// complex64 scratch, the cells (p, f) of one pass of the two-pass
// correlate stage, unused (cells_chunk 0, Bs null) where the cluster plan
// takes n (gjt_corr_cluster_n1); tw2: the table of the n2-point rows
// (`build.large_row_twiddles`); twn: the n-point two-level table
// (`build.reg_twiddles(n)`). Returns a cudaError_t (0 on success).
extern "C" int gjt_caf_std_large(const void* x, const void* osc, void* Y,
                                 void* Bs, const void* rep, const void* tw2,
                                 const void* twn, void* out, int F, int nb,
                                 int P, int n, int f_chunk, int cells_chunk,
                                 void* stream) {
  gjt::LargePlan lp;
  if (!gjt::large_plan(n, gjt::kStdMaxN, &lp) || F < 1 || nb < 1 || P < 1 ||
      f_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cluster = gjt::cluster_n1(lp) > 0;
  if (!cluster && cells_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* Y2 = static_cast<float2*>(Y);
  const float2* tw2_ = static_cast<const float2*>(tw2);
  const float2* twn_ = static_cast<const float2*>(twn);
  for (int f0 = 0; f0 < F; f0 += f_chunk) {
    const int fc = F - f0 < f_chunk ? F - f0 : f_chunk;
    const gjt::SrcMix src{static_cast<const float2*>(x),
                          static_cast<const float2*>(osc) +
                              static_cast<long long>(f0) * n,
                          n, nb};
    cudaError_t err =
        gjt::launch_large_forward(src, Y2, tw2_, twn_, fc * nb, lp, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cluster) {
      err = gjt::launch_cluster_correlate(
          Y2, static_cast<const float2*>(rep), tw2_, twn_,
          static_cast<float*>(out), fc, F, f0, nb, 1, P, lp, 0, 0, s);
    } else {
      err = gjt::launch_large_correlate(
          Y2, static_cast<const float2*>(rep), tw2_, twn_,
          static_cast<float*>(out), static_cast<float2*>(Bs), fc, F, f0, nb,
          1, P, lp, cells_chunk, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The cluster size of the correlate stage of an n-point search above
// 16384 (kernels B1 and B3), or 0 where it runs the two passes through
// scratch, or where no four-step plan takes n: `cluster_n1` of the plan,
// which kernels/fft_plan.py's `cluster_split` mirrors.
extern "C" int gjt_corr_cluster_n1(int n) {
  gjt::LargePlan lp;
  return gjt::large_plan(n, gjt::kStdMaxN, &lp) ? gjt::cluster_n1(lp) : 0;
}
