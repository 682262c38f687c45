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
// block of input, against 12 forward ones. Each inverse stays in shared
// memory from the replica product to |.|^2, and in statistics mode the
// delay x Doppler surface never reaches device memory: the only output is
// 5 x (P, rows) floats.
#include <cuda_runtime.h>

#include "pcf_correlate.cuh"

namespace {

__global__ void __launch_bounds__(gjt::kMaxThreads)
pcf_forward_kernel(const float2* __restrict__ y, float2* __restrict__ Y,
                   const float2* __restrict__ tw, int n, int log2n) {
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tw_s = smem + n;
  gjt::stage_twiddles(tw_s, tw, n);
  const float2* src = y + static_cast<long long>(blockIdx.x) * n;
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    buf[gjt::bitrev(t, log2n)] = src[t];
  __syncthreads();
  gjt::fft_radix2<false>(buf, tw_s, n, log2n);
  float2* dst = Y + static_cast<long long>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = buf[k];
}

}  // namespace

// y: (R*G, n) complex64, rows ordered (r, g); Y: same-shape scratch;
// rep: (P, n) complex64; tw: (n/2,) complex64; out: the surface
// (P, n_c*R, n) float32 when stats == 0, else (5, P, n_c*R) float32.
// Returns a cudaError_t (0 on success).
extern "C" int gjt_pcf(const void* y, void* Y, const void* rep,
                       const void* tw, void* out, int R, int G, int n_c,
                       int P, int n, int stats, int excl, void* stream) {
  if (n < 256 || n > 16384 || (n & (n - 1)) || R < 1 || G < 1 || P < 1 ||
      n_c < 1 || (n_c & 1) == 0 || n_c / 2 >= n ||
      (stats && excl >= n / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = gjt::fft_smem_bytes(n);
  cudaError_t err = gjt::allow_smem(
      reinterpret_cast<const void*>(pcf_forward_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcf_forward_kernel<<<R * G, gjt::fft_threads(n), smem, s>>>(
      static_cast<const float2*>(y), static_cast<float2*>(Y),
      static_cast<const float2*>(tw), n, gjt::ilog2(n));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gjt::launch_correlate(
      static_cast<const float2*>(Y), static_cast<const float2*>(rep),
      static_cast<const float2*>(tw), static_cast<float*>(out), R, G, n_c, P,
      n, stats, excl, s));
}
