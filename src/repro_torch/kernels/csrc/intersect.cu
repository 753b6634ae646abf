// Cardinality-class attention intersection (Eq. 8/9) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/intersect.py::intersect_pallas
// (body _intersect_kernel). For each pool row with k inputs x[k, d]:
//   h = relu(x·W1 + b1), logit = h·w2 + b2, att = softmax over k,
//   out = sum_k att_k x_k
// in fp32 for fp32 or bf16 x; the caller clips the result.
//
// Bound: the n·k·d·hd multiply-adds of x·W1 dominate (d = hd = 800 in BetaE);
// the bytes are a few MB. The work runs as two launches on one stream:
//
//  1. intersect_logits_kernel — a tiled fp32 GEMM of the n·k input rows by
//     W1, BM rows x BH hidden units per block, BK-deep slices of both staged
//     in shared memory with coalesced loads. Splitting the hidden units over
//     blocks is what fills the card at serving pool sizes (n·k = 32 rows
//     still gives hd/BH = 25 blocks). Each thread issues all its loads of a
//     slice before storing any, and the next slice's loads are in flight
//     while the current one is computed. The epilogue applies b1, relu and w2
//     and reduces each row over the block's hidden units, writing one
//     partial logit per (hidden tile, row) to scratch — never h itself.
//  2. intersect_combine_kernel — one block per pool row sums the partial
//     logits in tile order, takes the softmax over k and writes
//     sum_k att_k x_k.
//
// Every sum runs in a fixed order that depends only on the row's own inputs,
// so results are deterministic and independent of the pool's size or
// composition (no atomics).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 32;        // input rows (pool row x k) per block
constexpr int BH = 32;        // hidden units per block
constexpr int BK = 64;        // depth slice staged per step
constexpr int THREADS = 256;
constexpr int TX = BH / 4;    // 8 threads share a row, 4 hidden units each
constexpr int PER = BK * BM / THREADS;  // x (and W1) elements each thread stages
constexpr int MAX_K = 8;
static_assert(BM == BH, "x and W1 tiles share one staging loop");

template <typename T>
__global__ void __launch_bounds__(THREADS)
intersect_logits_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        float* __restrict__ partial, int M, int d, int hd) {
  __shared__ float as[BK][BM + 1];   // x slice, transposed: as[depth][row]
  __shared__ float bs[BK][BH];       // W1 slice: bs[depth][hidden]
  const int tid = threadIdx.x;
  const int tx = tid % TX;           // hidden units tx, tx+8, tx+16, tx+24
  const int ty = tid / TX;           // row within the tile
  const int m0 = blockIdx.y * BM;
  const int h0 = blockIdx.x * BH;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float ar[PER], br[PER];  // the next slice, staged in registers

  // x is read along depth (i % BK), W1 along hidden units (i % BH): both
  // coalesced across the warp.
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      const int m = m0 + i / BK, ka = k0 + i % BK;
      ar[j] = (m < M && ka < d) ? repro::to_f32(x[(size_t)m * d + ka]) : 0.f;
      const int kb = k0 + i / BH, h = h0 + i % BH;
      br[j] = (kb < d && h < hd) ? w1[(size_t)kb * hd + h] : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      as[i % BK][i / BK] = ar[j];
      bs[i / BH][i % BH] = br[j];
    }
    __syncthreads();
    if (k0 + BK < d) load(k0 + BK);
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float a = as[c][ty];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, bs[c][tx + TX * j], acc[j]);
    }
    __syncthreads();
  }

  // Epilogue: relu(h + b1) * w2 over this thread's hidden units, then over
  // the 8 threads of the row (lanes differ only in their low 3 bits).
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int h = h0 + tx + TX * j;
    if (h < hd) s = fmaf(fmaxf(acc[j] + b1[h], 0.f), w2[h], s);
  }
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int m = m0 + ty;
  if (tx == 0 && m < M) partial[(size_t)blockIdx.x * M + m] = s;
}

template <int K, typename T>
__global__ void __launch_bounds__(THREADS)
intersect_combine_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                         const float* __restrict__ b2, T* __restrict__ out,
                         int n, int d, int n_tiles) {
  __shared__ float att[K];
  const int row = blockIdx.x;
  const int M = n * K;
  if (threadIdx.x == 0) {
    float logit[K];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      float s = b2[0];
      for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)t * M + row * K + m];
      logit[m] = s;
      mx = fmaxf(mx, s);
    }
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      logit[m] = expf(logit[m] - mx);
      sum += logit[m];
    }
#pragma unroll
    for (int m = 0; m < K; ++m) att[m] = logit[m] / sum;
  }
  __syncthreads();
  const T* xr = x + (size_t)row * K * d;
  T* orow = out + (size_t)row * d;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < K; ++m) s = fmaf(att[m], repro::to_f32(xr[(size_t)m * d + i]), s);
    orow[i] = repro::from_f32<T>(s);
  }
}

template <int K, typename T>
int launch(const void* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* partial, void* out, int n, int d, int hd,
           cudaStream_t stream) {
  const int M = n * K;
  const int n_tiles = (hd + BH - 1) / BH;
  const T* xt = static_cast<const T*>(x);
  intersect_logits_kernel<T><<<dim3(n_tiles, (M + BM - 1) / BM), THREADS, 0, stream>>>(
      xt, w1, b1, w2, partial, M, d, hd);
  intersect_combine_kernel<K, T><<<n, THREADS, 0, stream>>>(
      xt, partial, b2, static_cast<T*>(out), n, d, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(const void* x, const float* w1, const float* b1, const float* w2,
               const float* b2, float* partial, void* out, int n, int k, int d,
               int hd, cudaStream_t s) {
  switch (k) {
    case 1: return launch<1, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    case 2: return launch<2, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    case 3: return launch<3, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    case 4: return launch<4, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    case 5: return launch<5, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    case 6: return launch<6, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    case 7: return launch<7, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    case MAX_K: return launch<MAX_K, T>(x, w1, b1, w2, b2, partial, out, n, d, hd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Hidden-unit tiles of the logits pass: the wrapper allocates `partial` as
// [repro_intersect_tiles(hd), n * k] fp32 scratch.
extern "C" int repro_intersect_tiles(int hd) { return (hd + BH - 1) / BH; }

// x [n, k, d] (dtype: repro::DType), w1 [d, hd], b1 [hd], w2 [hd], b2 [1]
// (fp32), partial: fp32 scratch (see above), out [n, d] in x's dtype. k is
// 1..8. Returns the CUDA error of the launches (0 = success).
extern "C" int repro_intersect(const void* x, const float* w1, const float* b1,
                               const float* w2, const float* b2, float* partial,
                               void* out, int n, int k, int d, int hd, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_k<float>(x, w1, b1, w2, b2, partial, out, n, k, d, hd, s);
  if (dtype == repro::kBF16)
    return dispatch_k<__nv_bfloat16>(x, w1, b1, w2, b2, partial, out, n, k, d, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
