// Shared-memory radix-2 FFT and block reductions for the port's kernels.
//
// One thread block transforms one power-of-two row held in shared memory.
// The row is written in bit-reversed order (bitrev) and comes back in
// natural order after fft_radix2. The twiddle table tw[k] = exp(-2*pi*i*k/n),
// k < n/2, is float32 computed in float64 on the host and staged into shared
// memory by the caller.
#pragma once

#include <cuda_runtime.h>

namespace gjt {

// Every kernel is compiled for blocks of up to this many threads, so
// ptxas keeps it within the SM's 64K registers at that size.
constexpr int kMaxThreads = 1024;

static __device__ __forceinline__ unsigned bitrev(unsigned i, int log2n) {
  return __brev(i) >> (32 - log2n);
}

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place decimation-in-time FFT of buf[0..n). INVERSE conjugates the
// twiddles (no 1/n scaling). The caller synchronises after filling buf;
// this returns after a final __syncthreads.
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

// log2 of a power of two (host side).
static inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// Lets `fn` take `bytes` of dynamic shared memory: above 48 KB a kernel
// must opt in before its launch.
static inline cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Copies the n/2-entry twiddle table into shared memory (no sync).
static __device__ __forceinline__ void stage_twiddles(float2* tw_s,
                                                      const float2* tw,
                                                      int n) {
  for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) tw_s[k] = tw[k];
}

static __device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide sum in a fixed order (lane tree, then warps 0..W-1), so the
// result is the same on every run. red holds >= 32 floats. Every thread
// gets the result. blockDim.x is a multiple of 32.
static __device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
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
  const int nw = blockDim.x >> 5;
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
  const int nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oa = __shfl_down_sync(0xffffffffu, a, off);
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

}  // namespace gjt
