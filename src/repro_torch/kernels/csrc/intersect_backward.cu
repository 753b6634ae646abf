// Backward of the cardinality-class attention intersection (Eq. 8/9) for
// Hopper (sm_90a), fp32.
//
// The forward (csrc/intersect.cu, replacing the TPU kernel
// src/repro/kernels/intersect.py::intersect_pallas) is, per pool row p with
// k input rows x_j [d]:
//   z_j = x_j·W1 + b1, h_j = relu(z_j), logit_j = h_j·w2 + b2,
//   att = softmax_j(logit), out_p = sum_j att_j x_j.
// The JAX package has no backward kernel (its trainer differentiates the jnp
// path), so this one has no TPU counterpart. Given g = dL/dout [n, d]:
//   datt_j = <g_p, x_j>, dlogit_j = att_j (datt_j - sum_i att_i datt_i),
//   dh_j = dlogit_j w2 ⊙ [z_j > 0], dx_j = att_j g_p + dh_j W1ᵀ,
//   dW1 = sum_rows x_jᵀ dh_j, db1 = sum dh_j, dw2 = sum h_j dlogit_j,
//   db2 = sum dlogit_j.
//
// What bounds it. Three products of n·k·d·hd multiply-adds each — the
// recomputed x·W1, dh·W1ᵀ and xᵀ·dh — against x, g, dx, W1 and dW1: at a
// training pool (n·k = 1,536, d = hd = 800) 5.9 GFLOP over 19 MB, bound by
// the fp32 CUDA cores (0.088 ms at 67 TFLOP/s).
//
// Design: the simple kernel that is right. Five launches on the caller's
// stream, each a plain CUDA-core loop, with scratch the wrapper allocates:
//   1. pre = x·W1 + b1 [M, hd] (M = n·k), a register-tiled product;
//   2. one block per pool row: the logits from pre, the softmax, datt by a
//      block reduction over d, and dlogit; att and dlogit [M] to scratch;
//   3. dx = att·g + dh·W1ᵀ, the same tiled product, with dh made from pre,
//      w2 and dlogit as its tiles load;
//   4. dW1 = xᵀ·dh, the same tiled product, its depth the M input rows;
//   5. db1, dw2 (one thread a hidden unit) and db2: chains over the M rows.
// h and the logits are recomputed from x and the weights, so the forward
// keeps nothing for the backward and its arrival counters stay its own.
//
// Fixed-order sums: every output element of the tiled products is one FMA
// chain over its depth in index order from 0 (tiles that run past the edge
// add 0·0); the block reductions of step 2 are per-thread strided chains
// folded by a fixed xor tree and then in warp order, for a block size fixed
// here; step 5's sums are chains in row order. Nothing depends on the launch
// geometry's scheduling, and there are no atomics: two calls on the same
// inputs give the same bits.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;  // output tile and depth step
constexpr int GT = 256;                   // threads of a tiled product (16 × 16)
constexpr int RT = 256;                   // threads of a pool row's block (step 2)
constexpr int CT = 128;                   // threads of a column-sum block (step 5)
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tiled product C[R, C] = sum_t A(r, t)·B(t, c) over t < K, each element one
// FMA chain in t order, handed to ep(r, c, sum). A loader's kContig says
// whether its operand lies contiguous along the depth t (then neighbouring
// threads load neighbouring t) or along the other index.
template <class LA, class LB, class EP>
__global__ void __launch_bounds__(GT) tiled_product(int R, int C, int K, LA la, LB lb, EP ep) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t0 = 0; t0 < K; t0 += BK) {
#pragma unroll
    for (int s = 0; s < BM * BK / GT; ++s) {
      const int e = threadIdx.x + GT * s;
      const int r = LA::kContig ? e / BK : e % BM, t = LA::kContig ? e % BK : e / BM;
      As[t][r] = (r0 + r < R && t0 + t < K) ? la(r0 + r, t0 + t) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < BN * BK / GT; ++s) {
      const int e = threadIdx.x + GT * s;
      const int c = LB::kContig ? e / BK : e % BN, t = LB::kContig ? e % BK : e / BN;
      Bs[t][c] = (c0 + c < C && t0 + t < K) ? lb(t0 + t, c0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < BK; ++t) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[t][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[t][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r < R && c < C) ep(r, c, acc[i][j]);
    }
}

// dh[m, j] = dlogit[m]·w2[j] where pre[m, j] > 0, else 0 (relu's gradient
// is 0 at 0).
__device__ __forceinline__ float dh_at(const float* pre, const float* w2, const float* dlogit,
                                       int hd, int m, int j) {
  const float v = __fmul_rn(dlogit[m], w2[j]);
  return pre[static_cast<size_t>(m) * hd + j] > 0.f ? v : 0.f;
}

// Loaders and epilogues of the three products.
struct RowMajor {  // A[r, t] of a row-major [R, K] matrix
  static constexpr bool kContig = true;
  const float* p;
  int ld;
  __device__ float operator()(int r, int t) const { return p[static_cast<size_t>(r) * ld + t]; }
};
struct DepthMajor {  // B[t, c] of a row-major [K, C] matrix
  static constexpr bool kContig = false;
  const float* p;
  int ld;
  __device__ float operator()(int t, int c) const { return p[static_cast<size_t>(t) * ld + c]; }
};
struct Transposed {  // B[t, c] = W[c, t] of a row-major W [C, K]
  static constexpr bool kContig = true;
  const float* p;
  int ld;
  __device__ float operator()(int t, int c) const { return p[static_cast<size_t>(c) * ld + t]; }
};
struct XT {  // A[r, t] = x[t, r]: xᵀ, x [M, d] row-major
  static constexpr bool kContig = false;
  const float* x;
  int d;
  __device__ float operator()(int r, int t) const { return x[static_cast<size_t>(t) * d + r]; }
};
struct DhRows {  // A[m, j] = dh[m, j] (step 3)
  static constexpr bool kContig = true;
  const float *pre, *w2, *dlogit;
  int hd;
  __device__ float operator()(int m, int j) const { return dh_at(pre, w2, dlogit, hd, m, j); }
};
struct DhDepth {  // B[m, j] = dh[m, j] (step 4, depth m)
  static constexpr bool kContig = false;
  const float *pre, *w2, *dlogit;
  int hd;
  __device__ float operator()(int m, int j) const { return dh_at(pre, w2, dlogit, hd, m, j); }
};
struct StorePre {  // pre[m, j] = sum + b1[j]
  float* pre;
  const float* b1;
  int hd;
  __device__ void operator()(int m, int j, float s) const {
    pre[static_cast<size_t>(m) * hd + j] = __fadd_rn(s, b1[j]);
  }
};
struct StoreDx {  // dx[m, c] = att[m]·g[m / k, c] + sum
  float* dx;
  const float *att, *g;
  int k, d;
  __device__ void operator()(int m, int c, float s) const {
    const float a = __fmul_rn(att[m], g[static_cast<size_t>(m / k) * d + c]);
    dx[static_cast<size_t>(m) * d + c] = __fadd_rn(a, s);
  }
};
struct Store {  // out[r, c] = sum
  float* out;
  int ld;
  __device__ void operator()(int r, int c, float s) const {
    out[static_cast<size_t>(r) * ld + c] = s;
  }
};

// Sum of v over the block's RT threads: a fixed xor tree in each warp, then
// the warp sums in warp order. Every thread gets the total.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < RT / 32; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// Step 2: block p takes pool row p. For each of its k inputs m = p·k + q:
// logit = sum_j relu(pre[m, j])·w2[j] + b2 and datt = <g_p, x_m>, kept in
// att[m] and dlogit[m]; then thread 0 takes the softmax over the k logits
// and dlogit = att (datt - sum_i att_i datt_i), in q order.
__global__ void __launch_bounds__(RT) row_softmax(const float* x, const float* g, const float* pre,
                                                  const float* w2, const float* b2, float* att,
                                                  float* dlogit, int k, int d, int hd) {
  __shared__ float red[RT / 32];
  const int p = blockIdx.x;
  const float* gp = g + static_cast<size_t>(p) * d;
  for (int q = 0; q < k; ++q) {
    const size_t m = static_cast<size_t>(p) * k + q;
    float l = 0.f, a = 0.f;
    for (int j = threadIdx.x; j < hd; j += RT) l = fmaf(fmaxf(pre[m * hd + j], 0.f), w2[j], l);
    for (int c = threadIdx.x; c < d; c += RT) a = fmaf(gp[c], x[m * d + c], a);
    l = block_sum(l, red);
    a = block_sum(a, red);
    if (threadIdx.x == 0) {
      att[m] = __fadd_rn(l, b2[0]);
      dlogit[m] = a;
    }
  }
  if (threadIdx.x != 0) return;
  float* lg = att + static_cast<size_t>(p) * k;
  float* da = dlogit + static_cast<size_t>(p) * k;
  float mx = -INFINITY;
  for (int q = 0; q < k; ++q) mx = fmaxf(mx, lg[q]);
  float sum = 0.f;
  for (int q = 0; q < k; ++q) {
    lg[q] = expf(__fsub_rn(lg[q], mx));
    sum = __fadd_rn(sum, lg[q]);
  }
  float s = 0.f;
  for (int q = 0; q < k; ++q) {
    lg[q] = __fdiv_rn(lg[q], sum);
    s = fmaf(lg[q], da[q], s);
  }
  for (int q = 0; q < k; ++q) da[q] = __fmul_rn(lg[q], __fsub_rn(da[q], s));
}

// Step 5: thread j < hd sums db1[j] = sum_m dh[m, j] and dw2[j] = sum_m
// relu(pre[m, j])·dlogit[m]; thread hd sums db2 = sum_m dlogit[m]; all in
// row order.
__global__ void __launch_bounds__(CT) column_sums(const float* pre, const float* w2,
                                                  const float* dlogit, int M, int hd, float* db1,
                                                  float* dw2, float* db2) {
  const int j = blockIdx.x * CT + threadIdx.x;
  if (j < hd) {
    float s1 = 0.f, s2 = 0.f;
    for (int m = 0; m < M; ++m) {
      s1 = __fadd_rn(s1, dh_at(pre, w2, dlogit, hd, m, j));
      s2 = fmaf(fmaxf(pre[static_cast<size_t>(m) * hd + j], 0.f), dlogit[m], s2);
    }
    db1[j] = s1;
    dw2[j] = s2;
  } else if (j == hd) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s = __fadd_rn(s, dlogit[m]);
    db2[0] = s;
  }
}

template <class LA, class LB, class EP>
int product(int R, int C, int K, LA la, LB lb, EP ep, cudaStream_t s) {
  const dim3 grid(cdiv(R, BM), cdiv(C, BN));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  tiled_product<<<grid, GT, 0, s>>>(R, C, K, la, lb, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, k, d], g [n, d], w1 [d, hd], b1 [hd], w2 [hd], b2 [1], all fp32 and
// contiguous; scratch pre [n·k, hd], att [n·k] and dlogit [n·k] fp32; outputs
// dx [n, k, d], dw1 [d, hd], db1 [hd], dw2 [hd], db2 [1]. n, k, d, hd >= 1
// (n = 0 launches nothing and leaves the weight gradients as they are: the
// wrapper zeroes them). Five launches on `stream`; returns the first CUDA
// error (0 = success).
extern "C" int repro_intersect_backward(const float* x, const float* g, const float* w1,
                                        const float* b1, const float* w2, const float* b2,
                                        float* pre, float* att, float* dlogit, float* dx,
                                        float* dw1, float* db1, float* dw2, float* db2, int n,
                                        int k, int d, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (n < 0 || k < 1 || d < 1 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long M64 = static_cast<long long>(n) * k;
  if (M64 > (1LL << 30) / 2) return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(M64);
  int rc = product(M, hd, d, RowMajor{x, d}, DepthMajor{w1, hd}, StorePre{pre, b1, hd}, s);
  if (rc) return rc;
  row_softmax<<<n, RT, 0, s>>>(x, g, pre, w2, b2, att, dlogit, k, d, hd);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  rc = product(M, d, hd, DhRows{pre, w2, dlogit, hd}, Transposed{w1, hd}, StoreDx{dx, att, g, k, d},
               s);
  if (rc) return rc;
  rc = product(d, hd, M, XT{x, d}, DhDepth{pre, w2, dlogit, hd}, Store{dw1, hd}, s);
  if (rc) return rc;
  column_sums<<<cdiv(hd + 1, CT), CT, 0, s>>>(pre, w2, dlogit, M, hd, db1, dw2, db2);
  return static_cast<int>(cudaGetLastError());
}
