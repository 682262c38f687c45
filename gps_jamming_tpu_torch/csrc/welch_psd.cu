// Fused Welch PSD (kernel B2 of the port).
//
// Replaces the TPU kernel gps_jamming_tpu/ops/pallas_psd.py:_make_kernel
// (launched by _run and welch_psd_fused). Per segment of nperseg = N
// samples at hop N/2: complex-mean detrend -> periodic Hann window ->
// N-point FFT -> |X[k]|^2, summed over all segments, then scaled by
// 1/(fs * sum(w^2)) / n_segs. Natural FFT order out.
//
// What bounds it: memory. A 512k-sample block is 4 MB of complex64 in for a
// 4 KB result (1.3 us at 3.35 TB/s); the FFTs (5 N log2 N flops per
// segment) take 0.8 us at 67 TFLOP/s. So the design keeps everything but
// the input and a few partial rows out of device memory, and keeps the SM
// busy with several segments at once:
// - Every N (a power of two 64..16384, or one of the 16 mixed-radix sizes
//   of the TPU kernel, 384 = 3*128 ... 14336 = 7*2048) runs the register
//   FFT of fft_reg.cuh: it reads the first pass's points x[s*hop + i +
//   r*B0] (butterfly i = t + u*T, B0 = N/R0) straight from device memory
//   into registers (natural order, coalesced, no scatter), and leaves bin
//   i + r*BL in register RegShape::out_reg(u, r) after the last pass, so
//   each thread sums |X|^2 for its fixed bins in registers across all its
//   segments.
// - A block holds G = 256/T groups of T threads (1024: 4 x 64; G = 1 from
//   256 threads up), each walking its own run of consecutive segments with
//   its own exchange buffers and named barrier (GroupRow), so one
//   segment's exchange does not idle the SM. The second half of segment s
//   is the first half of segment s+1: the first pass's radix R0 is even,
//   so registers u*R0 + R0/2.. (raw samples) carry over as u*R0 + 0..,
//   and each sample of a run is read once (up to 512 threads; above, the
//   threads' registers hold no spare half, and the overlap is read again,
//   from L2).
// - The detrend is applied after the FFT, by linearity: the periodic Hann
//   window's DFT has three nonzero bins, W[0] = N/2 and W[1] = W[N-1] =
//   -N/4, so with S the segment's sum (mean m = S/N) the detrended
//   spectrum is X[k] - m W[k]: X[0] - S/2, X[1] + S/4, X[N-1] + S/4. S is
//   summed alongside the load by warp shuffles (and, above a warp, one
//   slot per warp in shared memory, read after the FFT's barriers): no
//   block-wide barrier before the transform.
// - One launch, deterministic, no float atomics. Blocks come in clusters
//   of 8: each block sums its groups' rows in a fixed order into its
//   shared memory; block r of a cluster then sums slice r (N/8 bins) of the
//   8 blocks' rows through distributed shared memory into the cluster's
//   partial row in device memory; the last cluster to finish slice r (an
//   integer ticket per slice, after __threadfence) sums slice r of every
//   cluster's row in cluster order, applies the scale and resets its
//   ticket for the next call. The tile count depends on N and the number
//   of segments only (at most kMaxTiles blocks), so the sum order, and the
//   result, is the same on every card and every call.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fft_large.cuh"
#include "fft_reg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;          // blocks per cluster = final-sum slices
constexpr int kBlockThreads = 256;   // threads per block, up to T
// The most blocks of one launch, a multiple of kCluster: 1024 at 512k
// samples is 128 blocks of 4 groups x 2 segments (caps of 32, 64, 256
// and 512 were slower on an H100 80GB HBM3 at 700 W; PERF.md).
constexpr int kMaxTiles = 128;
// Scratch: kCluster slice tickets, then the clusters' partial rows.
constexpr int kTicketBytes = 256;

// The layout of an N-point Welch block.
template <int N>
struct WelchShape {
  using L = gjt::RegShape<N>;
  static constexpr int T = L::T;
  static constexpr int G = T >= kBlockThreads ? 1 : kBlockThreads / T;
  static constexpr int kThreads = G * T;
  // the overlapped half carried in registers (not above 512 threads)
  static constexpr bool kKeep = T <= 512;
  // the |X|^2 sums in shared memory (above 512 threads they spill)
  static constexpr bool kAccSmem = T > 512;
  static constexpr int kWarps = T >= 32 ? T / 32 : 1;   // warps per group
  using Row = std::conditional_t<G == 1, gjt::BlockRow, gjt::GroupRow<T>>;
  static_assert(L::R0 % 2 == 0, "the first radix carries the half over");
};

// Shared memory of an N-point Welch block: the groups' exchange buffers,
// the twiddle table, the detrend sums (2 parities x G x warps), the block's
// partial row (N floats) and the last-cluster flag.
template <int N>
size_t welch_smem_bytes() {
  using W = WelchShape<N>;
  using L = typename W::L;
  return sizeof(float2) * (static_cast<size_t>(W::G) * L::kBuffers *
                               L::kBufLen +
                           L::kTabLen + 2 * W::G * W::kWarps) +
         sizeof(float) * N + 16;
}

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// The end of every block: part_s holds the block's row (N floats, summed
// over its segments); see the note at the top. Every thread calls it.
static __device__ void welch_finish(const float* part_s, float* partial,
                                    unsigned* ticket, float* out, int n,
                                    float scale, int* flag_s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / kCluster;
  const int c = blockIdx.x / kCluster;
  const int lo = rank * n / kCluster, hi = (rank + 1) * n / kCluster;
  cluster.sync();                        // every block's row is complete
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < kCluster; ++b)
      s += cluster.map_shared_rank(part_s, b)[k];
    partial[static_cast<long long>(c) * n + k] = s;
  }
  cluster.sync();                        // no block leaves while read
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag_s = atomicAdd(ticket + rank, 1u) == static_cast<unsigned>(
                                                  n_clusters - 1);
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    float s = 0.f;
    for (int cc = 0; cc < n_clusters; ++cc)
      s += __ldcg(partial + static_cast<long long>(cc) * n + k);
    out[k] = s * scale;
  }
  if (threadIdx.x == 0) ticket[rank] = 0u;   // ready for the next call
}

// Groups of T threads, the register FFT of RegShape<N>.
template <int N>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(WelchShape<N>::kThreads)
welch_kernel(const float2* __restrict__ x, const float* __restrict__ win,
             const float2* __restrict__ tab, float* __restrict__ partial,
             unsigned* __restrict__ ticket, float* __restrict__ out,
             int n_segs, int seg_run, int detrend, float scale) {
  using W = WelchShape<N>;
  using L = typename W::L;
  using Row = typename W::Row;
  constexpr int T = L::T, G = W::G, kHop = N / 2;
  constexpr int U0 = L::U0, R0 = L::R0, B0 = L::B0;
  constexpr int UL = L::UL, RL = L::RL, BL = L::BL, PL = UL * RL;
  constexpr bool kAll0 = U0 * T == B0;
  // the owners of bins 0, 1 (thread 0, 1, register 0) and N-1
  constexpr int kTLast = (BL - 1) % T;
  constexpr int kJLast = L::out_reg((BL - 1) / T, RL - 1);
  extern __shared__ float2 smem[];
  const int g = G == 1 ? 0 : static_cast<int>(threadIdx.x) / T;
  const int t = Row::t();
  float2* buf0 = smem + g * (L::kBuffers * L::kBufLen);
  float2* buf1 = L::kBuffers == 2 ? buf0 + L::kBufLen : buf0;
  float2* tab_s = smem + G * L::kBuffers * L::kBufLen;
  float2* sums_s = tab_s + L::kTabLen;                   // [2][G][kWarps]
  float* part_s = reinterpret_cast<float*>(sums_s + 2 * G * W::kWarps);
  int* flag_s = reinterpret_cast<int*>(part_s + N);
  gjt::stage_reg_twiddles<N>(tab_s, tab);

  // bin of the last pass's register j (N: none)
  int bins[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) bins[j] = L::out_index(t, j);
  float acc[W::kAccSmem ? 1 : PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    if constexpr (W::kAccSmem) {
      if (bins[j] < N) part_s[bins[j]] = 0.f;   // G == 1: part_s is the sums
    } else {
      acc[j] = 0.f;
    }
  }
  __syncthreads();                        // the table is staged

  const int run = blockIdx.x * G + g;
  const int s0 = min(run * seg_run, n_segs);
  const int s1 = min(s0 + seg_run, n_segs);
  float2 keep[W::kKeep ? U0 * R0 / 2 : 1];
  int phase = 0;
  for (int s = s0; s < s1; ++s) {
    const float2* xs = x + static_cast<long long>(s) * kHop;
    float2 v[L::P];
#pragma unroll
    for (int u = 0; u < U0; ++u) {
      const int i = t + u * T;
      const bool ok = kAll0 || i < B0;
#pragma unroll
      for (int q = R0 / 2; q < R0; ++q)
        v[u * R0 + q] = ok ? xs[i + q * B0] : make_float2(0.f, 0.f);
      if constexpr (W::kKeep) {
        if (s > s0) {
#pragma unroll
          for (int q = 0; q < R0 / 2; ++q) v[u * R0 + q] = keep[u * R0 / 2 + q];
        } else {
#pragma unroll
          for (int q = 0; q < R0 / 2; ++q)
            v[u * R0 + q] = ok ? xs[i + q * B0] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < R0 / 2; ++q)
          keep[u * R0 / 2 + q] = v[u * R0 + q + R0 / 2];
      } else {
#pragma unroll
        for (int q = 0; q < R0 / 2; ++q)
          v[u * R0 + q] = ok ? xs[i + q * B0] : make_float2(0.f, 0.f);
      }
    }
    // the segment's sum S, for the detrend after the transform
    float2 sum = make_float2(0.f, 0.f);
    if (detrend) {
#pragma unroll
      for (int j = 0; j < U0 * R0; ++j) sum = cadd(sum, v[j]);
      if constexpr (T < 32) {
        const unsigned mask = gjt::GroupRow<T>::mask();
#pragma unroll
        for (int off = T / 2; off > 0; off >>= 1) {
          sum.x += __shfl_xor_sync(mask, sum.x, off);
          sum.y += __shfl_xor_sync(mask, sum.y, off);
        }
      } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum.x += __shfl_xor_sync(0xffffffffu, sum.x, off);
          sum.y += __shfl_xor_sync(0xffffffffu, sum.y, off);
        }
        if ((t & 31) == 0)
          sums_s[((s & 1) * G + g) * W::kWarps + (t >> 5)] = sum;
      }
    }
#pragma unroll
    for (int u = 0; u < U0; ++u) {
      const int i = t + u * T;
      if (kAll0 || i < B0) {
#pragma unroll
        for (int q = 0; q < R0; ++q) {
          const float w = __ldg(win + i + q * B0);
          v[u * R0 + q] = make_float2(v[u * R0 + q].x * w, v[u * R0 + q].y * w);
        }
      }
    }
    gjt::reg_fft<N, false, Row>(v, buf0, buf1, tab_s, phase);
    if (detrend) {
      // bins 0 and 1 are register 0 of threads 0 and 1, bin N-1 register
      // kJLast of thread kTLast; the FFT's barriers ordered the sums' slots
      if constexpr (T >= 32) {
        if (t <= 1 || t == kTLast) {
          sum = make_float2(0.f, 0.f);
#pragma unroll
          for (int w = 0; w < W::kWarps; ++w)
            sum = cadd(sum, sums_s[((s & 1) * G + g) * W::kWarps + w]);
        }
      }
      if (t == 0) {
        v[0].x -= 0.5f * sum.x;
        v[0].y -= 0.5f * sum.y;
      } else if (t == 1) {
        v[0].x += 0.25f * sum.x;
        v[0].y += 0.25f * sum.y;
      }
      if (t == kTLast) {
        v[kJLast].x += 0.25f * sum.x;
        v[kJLast].y += 0.25f * sum.y;
      }
    }
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const float e = v[j].x * v[j].x + v[j].y * v[j].y;
      if constexpr (W::kAccSmem) {
        if (bins[j] < N) part_s[bins[j]] += e;
      } else {
        acc[j] += e;
      }
    }
  }

  // the block's row: the groups' sums in group order
  __syncthreads();                        // every exchange buffer is free
  if constexpr (G > 1) {
    float* rows = reinterpret_cast<float*>(smem);        // G x N
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (bins[j] < N) rows[g * N + bins[j]] = acc[j];
    __syncthreads();
    for (int k = threadIdx.x; k < N; k += W::kThreads) {
      float sk = 0.f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) sk += rows[gg * N + k];
      part_s[k] = sk;
    }
  } else if constexpr (!W::kAccSmem) {
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (bins[j] < N) part_s[bins[j]] = acc[j];
  }
  __syncthreads();
  welch_finish(part_s, partial, ticket, out, N, scale, flag_s);
}

// Segments per run and blocks (a multiple of the cluster size, at most
// kMaxTiles) for n_segs segments over groups of G runs per block: fixed by
// the shape alone.
void tiles(int n_segs, int G, int* seg_run, int* n_tiles) {
  *seg_run = (n_segs + kMaxTiles * G - 1) / (kMaxTiles * G);
  const int runs = (n_segs + *seg_run - 1) / *seg_run;
  const int blocks = (runs + G - 1) / G;
  *n_tiles = (blocks + kCluster - 1) / kCluster * kCluster;
}

template <int N>
cudaError_t launch(const float2* x, const float* win, const float2* tab,
                   float* partial, unsigned* ticket, float* out, int n_segs,
                   int detrend, float scale, cudaStream_t s) {
  using W = WelchShape<N>;
  int seg_run, n_tiles;
  tiles(n_segs, W::G, &seg_run, &n_tiles);
  const size_t smem = welch_smem_bytes<N>();
  cudaError_t err =
      gjt::allow_smem(reinterpret_cast<const void*>(welch_kernel<N>), smem);
  if (err != cudaSuccess) return err;
  welch_kernel<N><<<n_tiles, W::kThreads, smem, s>>>(
      x, win, tab, partial, ticket, out, n_segs, seg_run, detrend, scale);
  return cudaGetLastError();
}

#define GJT_WELCH_POW2(X) \
  X(64) X(128) X(256) X(512) X(1024) X(2048) X(4096) X(8192) X(16384)

// The 16 mixed-radix nperseg of the TPU kernel (pallas_psd.supported up
// to 16384: 128 * 2^a * {3, 5, 7}), each a size of GJT_REG_SCHEDULES.
#define GJT_WELCH_MIXED(X)                                                \
  X(384) X(640) X(768) X(896) X(1280) X(1536) X(1792) X(2560) X(3072)    \
  X(3584) X(5120) X(6144) X(7168) X(10240) X(12288) X(14336)

}  // namespace

static bool welch_size(int nperseg) {
#define GJT_IS(NN) nperseg == NN ||
  return GJT_WELCH_POW2(GJT_IS) GJT_WELCH_MIXED(GJT_IS) false;
#undef GJT_IS
}

// Bytes of the scratch buffer gjt_welch_psd takes at nperseg: zero-filled
// before the first call (each call leaves the tickets zero); 0 for an
// nperseg it does not take.
extern "C" int gjt_welch_scratch_bytes(int nperseg) {
  if (!welch_size(nperseg)) return 0;
  return kTicketBytes + static_cast<int>(sizeof(float)) *
                            (kMaxTiles / kCluster) * nperseg;
}

// x: (n,) complex64 with n_segs = 1 + (n - nperseg) / (nperseg/2)
// segments; win: (nperseg,) float32; tab: `build.reg_twiddles(nperseg)`
// (the two-level table of fft_reg.cuh); scratch: gjt_welch_scratch_bytes
// (nperseg) bytes; out: (nperseg,) float32. nperseg: a power of two in
// [64, 16384] or a size of GJT_WELCH_MIXED. One launch. Returns a
// cudaError_t (0 on success).
extern "C" int gjt_welch_psd(const void* x, const void* win, const void* tab,
                             void* scratch, void* out, int nperseg,
                             int n_segs, int detrend, float scale,
                             void* stream) {
  if (n_segs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* x2 = static_cast<const float2*>(x);
  const float* w = static_cast<const float*>(win);
  const float2* tb = static_cast<const float2*>(tab);
  unsigned* tk = static_cast<unsigned*>(scratch);
  float* pt = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                       kTicketBytes);
  float* o = static_cast<float*>(out);
#define GJT_WELCH(NN)                                                    \
  if (nperseg == NN)                                                     \
    return static_cast<int>(                                             \
        launch<NN>(x2, w, tb, pt, tk, o, n_segs, detrend, scale, s));
  GJT_WELCH_POW2(GJT_WELCH)
  GJT_WELCH_MIXED(GJT_WELCH)
#undef GJT_WELCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// nperseg above 16384 (every size the TPU kernel takes up to 131072:
// `cuda_psd.supported`): a segment no longer fits one block, so each runs
// the four-step FFT of fft_large.cuh, in chunks of seg_chunk segments:
// 1. welch_half_sums: the complex sum of each half-segment (hop samples),
//    one block each in a fixed order, so segment s's mean is
//    (H[s] + H[s+1]) / nperseg;
// 2. the column pass reads each segment once (SrcSeg: the mean
//    subtracted, the periodic Hann window applied), then the row pass
//    (RowsPsd) writes |X|^2 of every segment, in the permuted order
//    k1*n2 + k2 of bin k1 + n1*k2;
// 3. welch_seg_sum adds the chunk's segments bin by bin, in segment
//    order, onto the running sum, and the last chunk writes the scaled
//    row in natural bin order.
// No float atomics: the chunks depend on the shape alone, so the result is
// the same on every call. What bounds it is device memory: each segment is
// read twice (50 % overlap) and its spectrum goes through device memory
// once as complex64 and once as |X|^2.
// ---------------------------------------------------------------------------

namespace {

__global__ void __launch_bounds__(1024)
welch_half_sums(const float2* __restrict__ x, float2* __restrict__ half,
                int hop) {
  __shared__ float red[32];
  const float2* xs = x + static_cast<long long>(blockIdx.x) * hop;
  float sx = 0.f, sy = 0.f;
  for (int i = threadIdx.x; i < hop; i += blockDim.x) {
    const float2 v = xs[i];
    sx += v.x;
    sy += v.y;
  }
  sx = gjt::block_sum(sx, red);
  sy = gjt::block_sum(sy, red);
  if (threadIdx.x == 0) half[blockIdx.x] = make_float2(sx, sy);
}

// acc[q] (+)= sum over the chunk's sc segments of pw[s, q], q = k1*n2 + k2
// (first: from zero); last: out[k1 + n1*k2] = the sum * scale.
__global__ void __launch_bounds__(256)
welch_seg_sum(const float* __restrict__ pw, float* __restrict__ acc,
              float* __restrict__ out, int n1, int n2, int sc, int first,
              int last, float scale) {
  const int n = n1 * n2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float a = first ? 0.f : acc[q];
  for (int s = 0; s < sc; ++s) a += pw[static_cast<long long>(s) * n + q];
  if (last) {
    const int k1 = q / n2;
    out[k1 + n1 * (q - k1 * n2)] = a * scale;
  } else {
    acc[q] = a;
  }
}

}  // namespace

namespace gjt {

// Segment s0 + row: (x - its mean) * the window.
struct SrcSeg {
  const float2* x;
  const float* win;
  const float2* half;
  int hop, s0, detrend;
  float inv_n;
  __device__ __forceinline__ float2 at(int row, int j) const {
    const int s = s0 + row;
    float2 v = x[static_cast<long long>(s) * hop + j];
    if (detrend) {
      const float2 a = half[s], b = half[s + 1];
      v.x -= (a.x + b.x) * inv_n;
      v.y -= (a.y + b.y) * inv_n;
    }
    const float w = __ldg(win + j);
    return make_float2(v.x * w, v.y * w);
  }
};

// The row pass of a segment's forward FFT, |X|^2 out.
struct RowsPsd {
  static constexpr bool kInverse = false;
  const float2* a;
  float* pw;
  int n2;
  struct Row {
    const float2* src;
    float* dst;
    __device__ __forceinline__ float2 load(int k) const { return src[k]; }
    __device__ __forceinline__ void store(int k, float2 v) const {
      dst[k] = v.x * v.x + v.y * v.y;
    }
  };
  __device__ __forceinline__ Row row(int b) const {
    return Row{a + static_cast<long long>(b) * n2,
               pw + static_cast<long long>(b) * n2};
  }
};

}  // namespace gjt

// nperseg above 16384: x (n,) complex64 with n_segs segments as
// gjt_welch_psd; win: (nperseg,) float32; tw2: the table of the n2-point
// rows (`build.large_row_twiddles`); twn: the nperseg-point two-level table
// (`build.reg_twiddles`); scratch A: (seg_chunk, nperseg) complex64, pw:
// (seg_chunk, nperseg) float32, half: (n_segs + 1,) complex64, acc:
// (nperseg,) float32; out: (nperseg,) float32. Returns a cudaError_t (0 on
// success).
extern "C" int gjt_welch_psd_large(const void* x, const void* win,
                                   const void* tw2, const void* twn, void* A,
                                   void* pw, void* half, void* acc,
                                   void* out, int nperseg, int n_segs,
                                   int seg_chunk, int detrend, float scale,
                                   void* stream) {
  gjt::LargePlan lp;
  if (n_segs < 1 || seg_chunk < 1 || seg_chunk > 65535 ||
      !gjt::large_plan(nperseg, gjt::kLargeMaxN, &lp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hop = nperseg / 2;
  const float2* x2 = static_cast<const float2*>(x);
  float2* hs = static_cast<float2*>(half);
  if (detrend) {
    welch_half_sums<<<n_segs + 1, 1024, 0, s>>>(x2, hs, hop);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float2* A2 = static_cast<float2*>(A);
  float* pw2 = static_cast<float*>(pw);
  for (int s0 = 0; s0 < n_segs; s0 += seg_chunk) {
    const int sc = n_segs - s0 < seg_chunk ? n_segs - s0 : seg_chunk;
    const gjt::SrcSeg src{x2, static_cast<const float*>(win), hs, hop, s0,
                     detrend, 1.f / static_cast<float>(nperseg)};
    cudaError_t err = gjt::launch_large_cols_fwd(
        src, A2, static_cast<const float2*>(twn), sc, lp, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = gjt::launch_large_rows(gjt::RowsPsd{A2, pw2, lp.n2}, sc * lp.n1,
                                 static_cast<const float2*>(tw2), lp, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    welch_seg_sum<<<(nperseg + 255) / 256, 256, 0, s>>>(
        pw2, static_cast<float*>(acc), static_cast<float*>(out), lp.n1,
        lp.n2, sc, s0 == 0, s0 + sc >= n_segs, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
