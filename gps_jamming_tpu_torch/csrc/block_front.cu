// The block front of the monitor step (kernel F1 of the port).
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses it into a few HLO loops. In the port the same stage was five
// plain PyTorch steps (`iq.int8_to_complex`, `power.chunk_power`,
// `power.power_baseline` through `torch.quantile`,
// `power.power_threshold_linear`, the compare), 23 operators and 26
// launches whose host dispatch took about half of a block's time in the
// closed-loop monitor. F1 does the same work in one launch:
//   x[s]   = (i_s + 0.5, q_s + 0.5)                    complex64 (n,)
//   pm[c]  = mean over chunk c of |x|^2, + 1e-10        float32 (k,)
//   flags  = pm > (the 5th percentile of pm, 1 where it is <= 0)
//                 * 10^(rise_db / 10)                 bool (k,)
// with k = ceil(n / chunk), the last partial chunk included.
//
// What bounds it: memory. A 512k-sample block is 1 MB of int8 in and
// 4 MB of complex64 out (1.6 us at 3.35 TB/s); the power is a few integer
// operations a sample. So it is one pass with 16-byte loads and stores:
// - A CTA of 256 threads takes a tile of kTile = 2048 samples (one int4
//   load of 8 samples a thread, four float4 stores) that lies inside one
//   chunk: the grid is (chunk, tile of the chunk), ceil(chunk / kTile)
//   tiles a chunk, so a tile never straddles a chunk edge even where
//   chunk % kTile != 0 (the chunk's last tile is then short). The layout
//   it takes: chunk % 8 == 0 and 16-byte aligned bytes (a tile then starts
//   on an int4); only the last chunk may end in fewer than 8 samples.
// - The chunk sums are exact: 4|x|^2 = (2i+1)^2 + (2q+1)^2 is an integer
//   (at most 130050), summed per thread and CTA in 32 bits (a tile is at
//   most 2.7e8) and per chunk in 64 bits by integer atomics, so the sum
//   does not depend on the order the CTAs finish in. pm is that sum over
//   4 * len rounded once to float32 (round to odd in double, then to
//   nearest float: the correctly rounded mean), then + 1e-10f as the
//   plain version adds it. torch's float32 reduction rounds at every add.
// - The percentile runs in the same launch: each CTA adds its tile's sum
//   to its chunk's, then, after __threadfence, takes a ticket; the last
//   CTA forms pm, sorts it in shared memory (bitonic, padded with +inf to
//   a power of two: 10 barriers at k = 16, 91 at the most chunks), takes
//   torch.quantile's linear interpolation in its float32 arithmetic
//   (rank q * (k - 1), weight rank - floor(rank), its two-branch lerp
//   with fused multiply-adds as nvcc contracts it), clamps a baseline
//   <= 0 to 1, multiplies by the rise factor, writes the flags, and resets
//   the chunk sums and the ticket for the next call (the same pattern as
//   B2's welch_finish). Scratch: kHeadBytes of ticket, baseline and
//   threshold, then GJT_FRONT_MAX_CHUNKS 64-bit sums; all zero between
//   calls, so calls on one stream may share it.
#include <cuda_runtime.h>

#include <cstdint>

#ifndef GJT_FRONT_MAX_CHUNKS
#error "GJT_FRONT_MAX_CHUNKS comes from kernels/build.py"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8 * kThreads;     // samples per CTA
constexpr int kMaxChunks = GJT_FRONT_MAX_CHUNKS;
constexpr int kHeadBytes = 16;          // ticket, baseline, threshold
static_assert((kMaxChunks & (kMaxChunks - 1)) == 0,
              "the sort pads k to a power of two up to kMaxChunks");

__device__ __forceinline__ unsigned power4(int i, int q) {
  const int a = 2 * i + 1, b = 2 * q + 1;
  return static_cast<unsigned>(a * a + b * b);
}

__device__ __forceinline__ float half_up(int v) {
  return __int2float_rn(v) + 0.5f;
}

__device__ __forceinline__ int byte_at(unsigned w, int b) {
  return static_cast<signed char>(w >> (8 * b));
}

// Four interleaved I/Q bytes (two samples, the first in the low byte) ->
// x, and their 4|x|^2.
__device__ __forceinline__ unsigned decode_word(int word, float4* dst) {
  const unsigned w = static_cast<unsigned>(word);
  const int i0 = byte_at(w, 0), q0 = byte_at(w, 1);
  const int i1 = byte_at(w, 2), q1 = byte_at(w, 3);
  *dst = make_float4(half_up(i0), half_up(q0), half_up(i1), half_up(q1));
  return power4(i0, q0) + power4(i1, q1);
}

// sum / len4 (sum < 2^53) correctly rounded to float32: the quotient
// rounded to odd in double (toward zero, the last bit set where inexact),
// then to nearest float, which two rounding steps would not always give.
__device__ __forceinline__ float mean_f32(unsigned long long sum,
                                          long long len4) {
  const double s = static_cast<double>(sum), l = static_cast<double>(len4);
  double d = __ddiv_rz(s, l);
  if (__fma_rn(-d, l, s) != 0.0)
    d = __longlong_as_double(__double_as_longlong(d) | 1ll);
  return __double2float_rn(d);
}

__global__ void __launch_bounds__(kThreads)
block_front_kernel(const signed char* __restrict__ raw, float2* __restrict__ x,
                   float* __restrict__ pm, unsigned char* __restrict__ flags,
                   unsigned* __restrict__ head,
                   unsigned long long* __restrict__ sums, long long n,
                   int chunk, int tiles, int k, int pow2, float q,
                   float factor) {
  extern __shared__ float sorted_s[];               // pow2 floats
  __shared__ unsigned warp_s[kThreads / 32];
  __shared__ int last_s;
  const int c = blockIdx.x / tiles;
  const long long c0 = static_cast<long long>(c) * chunk;
  const long long start = c0 + static_cast<long long>(blockIdx.x % tiles) *
                                   kTile;
  const long long c1 = c0 + chunk < n ? c0 + chunk : n;
  const long long end = start + kTile < c1 ? start + kTile : c1;

  unsigned acc = 0;
  if (start >= end) {
    // a tile past the end of a short last chunk: it only takes its ticket
  } else {
    // start % 8 == 0: whole int4 loads of 8 samples, then the last
    // chunk's ragged tail (fewer than 8 samples) one sample a thread
    const long long vend = start + ((end - start) & ~7ll);
    const long long s = start + 8ll * threadIdx.x;
    if (s < vend) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(raw + 2 * s));
      float4* dst = reinterpret_cast<float4*>(x + s);
      float4 o;
      acc += decode_word(v.x, &o);
      dst[0] = o;
      acc += decode_word(v.y, &o);
      dst[1] = o;
      acc += decode_word(v.z, &o);
      dst[2] = o;
      acc += decode_word(v.w, &o);
      dst[3] = o;
    }
    const long long t = vend + threadIdx.x;
    if (t < end) {
      const int i = raw[2 * t], qq = raw[2 * t + 1];
      x[t] = make_float2(half_up(i), half_up(qq));
      acc += power4(i, qq);
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_s[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned tile_sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) tile_sum += warp_s[w];
    if (start < end)
      atomicAdd(sums + c, static_cast<unsigned long long>(tile_sum));
    __threadfence();
    last_s = atomicAdd(head, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // The last CTA: pm, the percentile, the threshold and the flags.
  for (int i = threadIdx.x; i < pow2; i += kThreads) {
    float v = __int_as_float(0x7f800000);           // +inf pads the sort
    if (i < k) {
      const long long c0i = static_cast<long long>(i) * chunk;
      const long long len = c0i + chunk < n ? chunk : n - c0i;
      v = __fadd_rn(mean_f32(__ldcg(sums + i), 4 * len), 1e-10f);
      pm[i] = v;
      sums[i] = 0ull;
    }
    sorted_s[i] = v;
  }
  __syncthreads();
  for (int size = 2; size <= pow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < pow2 / 2; t += kThreads) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const float a = sorted_s[lo], b = sorted_s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          sorted_s[lo] = b;
          sorted_s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  __shared__ float thr_s;
  if (threadIdx.x == 0) {
    const float rank = __fmul_rn(q, static_cast<float>(k - 1));
    const int below = static_cast<int>(rank);
    const int above = static_cast<int>(ceilf(rank));
    const float w = __fsub_rn(rank, static_cast<float>(below));
    const float lo = sorted_s[below], hi = sorted_s[above];
    const float d = __fsub_rn(hi, lo);
    float base = fabsf(w) < 0.5f ? __fmaf_rn(w, d, lo)
                                 : __fmaf_rn(-d, __fsub_rn(1.f, w), hi);
    if (base <= 0.f) base = 1.f;
    const float thr = __fmul_rn(base, factor);
    reinterpret_cast<float*>(head)[1] = base;
    reinterpret_cast<float*>(head)[2] = thr;
    thr_s = thr;
    head[0] = 0u;                                   // ready for the next call
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += kThreads)
    flags[i] = pm[i] > thr_s;
}

}  // namespace

extern "C" int gjt_front_scratch_bytes() {
  return kHeadBytes + static_cast<int>(sizeof(unsigned long long)) *
                          kMaxChunks;
}

// raw: (2n,) int8 interleaved I/Q; x: (n,) complex64; pm: (k,) float32;
// flags: (k,) bool; k = ceil(n / chunk) in [1, GJT_FRONT_MAX_CHUNKS];
// chunk % 8 == 0; raw and x 16-byte aligned;
// scratch: gjt_front_scratch_bytes() bytes, zero between calls; q: the
// percentile / 100 as float32; factor: 10^(rise_db / 10) as float32. One
// launch on `stream`. Returns a cudaError_t (0 on success).
extern "C" int gjt_block_front(const void* raw, void* x, void* pm,
                               void* flags, void* scratch, long long n,
                               int chunk, float q, float factor,
                               void* stream) {
  if (n < 1 || chunk < 1 || chunk % 8 != 0 ||
      reinterpret_cast<std::uintptr_t>(raw) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long k = (n + chunk - 1) / chunk;
  if (k > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (chunk + kTile - 1) / kTile;
  if (k * tiles > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  int pow2 = 1;
  while (pow2 < k) pow2 <<= 1;
  unsigned* head = static_cast<unsigned*>(scratch);
  unsigned long long* sums = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + kHeadBytes);
  block_front_kernel<<<static_cast<unsigned>(k * tiles), kThreads,
                       pow2 * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(raw), static_cast<float2*>(x),
      static_cast<float*>(pm), static_cast<unsigned char*>(flags), head, sums,
      n, chunk, tiles, static_cast<int>(k), pow2, q, factor);
  return static_cast<int>(cudaGetLastError());
}
