// Cardinality-class attention intersection (Eq. 8/9) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/intersect.py::intersect_pallas
// (body _intersect_kernel). For each pool row with k inputs x[k, d]:
//   h = relu(x·W1 + b1), logit = h·w2 + b2, att = softmax over k,
//   out = sum_k att_k x_k
// in fp32 for fp32 or bf16 x (loaded as bf16, the output rounded once); W1
// [d, hd], b1, w2 and b2 are fp32. The caller clips the result. Any k >= 1.
//
// What bounds it. The n·k·d·hd multiply-adds of x·W1 (d = hd = 800 in BetaE)
// against W1's 2.56 MB: at serving pools (n·k = 16 rows, 20 MFLOP) the call
// is bound by reading W1 once, which only the whole card reads fast; at
// training pools (n·k ~ 1,500, 2 GFLOP) by the fp32 CUDA cores.
//
// Design: one launch. W1 is cut into 64-unit hidden blocks × 8 depth
// chunks (at d = hd = 800: 13 × 8 = 104 pieces of 25.6 KB), and the pool
// into row groups of whole pool rows: group_rows(k) of them (at most RG = 64
// input rows), or as many as the launch asks for (the autotuner's knob,
// kernels/autotune.py; a group of more than RG input rows takes passes of
// RG, as a pool row of k > RG inputs always does). A thread
// block cluster of 8 blocks takes one (hidden block, row group); block c
// loads its chunk of W1 and of the group's x with cp.async at entry (in two
// halves, so that its FMA chain over the first runs while the second
// lands), sums x·W1 over the chunk with register tiles, and leaves the
// partial pre-activations in shared memory. After a cluster barrier the 8
// blocks fold the partials through distributed shared memory (block c the
// rows m = c mod 8), apply b1, relu and w2, and sum each 32-unit hidden tile
// into one partial logit per (tile, row) in global scratch. Each block then
// takes an arrival ticket for its row group and hands it to its cluster;
// the cluster holding the group's last ticket finds every partial logit
// written, and its 8 blocks take the softmax and write the output columns
// of their own chunk from the x they already hold. The ticket counters (one
// per row group) live in a buffer the wrapper keeps per stream; the group's
// last cluster resets its counter, so no launch clears them.
//
// One geometry for every pool: a thread holds a register tile of 4 rows ×
// 8 units on 128 threads (two shared loads for 8 FMAs, four blocks an SM).
// 4 × 4 tiles on 256 threads time within a few percent of it at serving
// pools and slower at large ones.
//
// Fixed-order sums: a row's bits do not depend on n or its place in the
// pool. The depth chunks are fixed by d alone (8 chunks of
// chunk_len(d)); each chunk is one FMA chain in depth order from 0, and the
// chunks are added in order to 0: h = ((0 + c0) + c1) + ... + c7. Then
// v = relu(h + b1)·w2 per hidden unit; a 32-unit tile (fixed by hd alone)
// is summed by a fixed xor tree over the lanes (lane 0's value), the tiles
// by lane-strided chains and the same tree, and b2 is added last. The
// softmax and the weighted sum over k (one FMA chain in k order) are one
// device function. No sum runs in arrival order.
//
// ptxas -v (-O3, sm_90a): 126 (fp32) / 125 (bf16) registers, no spills, 48
// bytes of static shared memory; dynamic shared memory at d = hd = 800:
// 51,776 bytes (fp32 x, n·k <= 16) to 51,968 (a full 64-row group), 38,976
// to 39,168 for bf16 x: four blocks an SM.
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNKS = 8;         // depth chunks, fixed by d alone
constexpr int HT = 32;            // hidden units of a tile: one a lane
constexpr int W = 2 * HT;         // hidden units of a cluster
constexpr int RG = 64;            // input rows of a row group (for k <= RG)
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }
// Depth of a chunk: d / CHUNKS rounded up to 4, so chunks start 16-byte aligned.
__host__ __device__ inline int chunk_len(int d) { return round4(cdiv(d, CHUNKS)); }
// Pool rows of a row group: whole pool rows of at most RG inputs, or one.
__host__ __device__ inline int group_rows(int k) { return k >= RG ? 1 : RG / k; }
__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

struct Args {
  const void* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* partial;        // [T, M] partial logits, one per (hidden tile, input row)
  unsigned* counters;    // [groups], zero between launches
  void* out;
  int n, k, d, hd, G, M, T, SL, vec;  // G: pool rows of a row group
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// Four elements global -> shared without registers: 16 bytes of fp32, 8 of bf16.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// rows × cols elements from global (row stride gs) to shared (row stride ss):
// cp.async of 4 elements where `vec` (cols, strides and bases then hold
// whole 4-element units), else plain element copies.
template <typename T>
__device__ __forceinline__ void copy_block(T* dst, int ss, const T* src, size_t gs, int rows,
                                           int cols, int vec) {
  if (vec) {
    const int units = cols / 4;
    for (int i = threadIdx.x; i < rows * units; i += blockDim.x) {
      const int r = i / units, u = i - r * units;
      cp_async4(dst + r * ss + 4 * u, src + r * gs + 4 * u);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ss + c] = src[r * gs + c];
    }
  }
}

// Fixed xor tree over the 32 lanes; lane 0's value is the one used.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// relu(h + b1)·w2 of one hidden unit.
__device__ __forceinline__ float head(float h, float b1, float w2) {
  return __fmul_rn(fmaxf(__fadd_rn(h, b1), 0.f), w2);
}

// The attention weights of a row group's Mg input rows into lg: each logit is
// b2 + the partial logits of the T tiles (lane-strided chains, then the
// xor tree), then a softmax over each pool row's k logits. A warp loads the
// partials of 8 rows before it sums any, so their latencies overlap; a lane
// past T adds +0, which leaves its chain (never -0) as it is.
__device__ void group_attention(const Args& a, int m0, int gp, float* lg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int Mg = gp * a.k;
  const float b2 = a.b2[0];
  for (int mb = warp; mb < Mg; mb += 8 * nw) {
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int t0 = 0; t0 < a.T; t0 += 32) {
      const int t = t0 + lane;
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = mb + i * nw;
        p[i] = (m < Mg && t < a.T) ? __ldcg(a.partial + static_cast<size_t>(t) * a.M + m0 + m) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = __fadd_rn(s[i], p[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = warp_sum(s[i]);
      if (lane == 0 && mb + i * nw < Mg) lg[mb + i * nw] = __fadd_rn(v, b2);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < gp; r += blockDim.x) {
    float* l = lg + r * a.k;
    float mx = -INFINITY;
    for (int q = 0; q < a.k; ++q) mx = fmaxf(mx, l[q]);
    float sum = 0.f;
    for (int q = 0; q < a.k; ++q) {
      const float e = expf(__fsub_rn(l[q], mx));
      l[q] = e;
      sum = __fadd_rn(sum, e);
    }
    for (int q = 0; q < a.k; ++q) l[q] = __fdiv_rn(l[q], sum);
  }
  __syncthreads();
}

// out[p0 + r, c0 + c] = sum_q att[r, q]·x[r, q, c] (one FMA chain in q order)
// for r < gp, c < cols. x rows come from `xs` (row pitch xp elements, input
// row m at xs + m·xp) and out rows have pitch d. Four columns a thread where
// `vec` (every 4-column unit then lies whole and aligned in both).
template <typename T>
__device__ void weighted_sum(const Args& a, const T* xs, size_t xp, int gp, int cols,
                             const float* lg, T* out) {
  const int k = a.k;
  if (a.vec) {
    const int units = cols / 4;
    for (int i = threadIdx.x; i < gp * units; i += blockDim.x) {
      const int r = i / units, u = i - r * units;
      const T* xr = xs + static_cast<size_t>(r) * k * xp + 4 * u;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < k; ++q) {
        float v[4];
        load4(xr + q * xp, v);
        const float w = lg[r * k + q];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(w, v[e], acc[e]);
      }
      store4(out + static_cast<size_t>(r) * a.d + 4 * u, acc);
    }
  } else {
    for (int i = threadIdx.x; i < gp * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      const T* xr = xs + static_cast<size_t>(r) * k * xp + c;
      float acc = 0.f;
      for (int q = 0; q < k; ++q) acc = fmaf(lg[r * k + q], repro::to_f32(xr[q * xp]), acc);
      out[static_cast<size_t>(r) * a.d + c] = repro::from_f32<T>(acc);
    }
  }
}

// A thread's register tile: TM rows × TN hidden units (rows TM·ty + i;
// units 4·tx + 4·NTX·e + 0..3, so that a quarter-warp reads one x row, a
// broadcast, and 128 contiguous bytes of W1).
constexpr int TM = 4, TN = 8, NTX = W / TN, THREADS = (RG / TM) * NTX;

// Shared memory of a block: ws [SL][W] fp32 (a depth slice of W1) and, in
// the same bytes once the chain has read it, hs [hrows][W] fp32 (the
// chunk's partial pre-activations); bw [2][W] (b1, w2 of its units); lg
// [Mmax] fp32 (logits, then attention weights); xs [RG][SL] T (a depth slice
// of x: with one slice and one row pass the whole chunk, which the final
// combine reads). hrows = min(Mmax, RG).
struct Smem {
  size_t bw, lg, xs, total;
};
template <typename T>
__host__ __device__ inline Smem smem_layout(int SL, int Mmax) {
  const int hrows = Mmax < RG ? Mmax : RG;
  Smem m;
  m.bw = align16(static_cast<size_t>(SL > hrows ? SL : hrows) * W * sizeof(float));
  m.lg = m.bw + 2 * W * sizeof(float);
  m.xs = align16(m.lg + static_cast<size_t>(Mmax) * sizeof(float));
  m.total = m.xs + static_cast<size_t>(RG) * SL * sizeof(T);
  return m;
}

// A depth slice's chains, added to acc[TM·TN]: x rows in xs (pitch SL), W1
// in ws (pitch W), `len` deep. Rows past the group's compute on whatever xs
// holds there and are never stored.
template <typename T>
__device__ __forceinline__ void chain(const T* xs, const float* ws, int SL, int len, float* acc) {
  const int ty = threadIdx.x / NTX, tx = threadIdx.x % NTX;
  const T* A = xs + TM * ty * SL;
  const float* B = ws + 4 * tx;
  int kk = 0;
  for (; kk + 4 <= len; kk += 4) {
    float av[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) load4(A + i * SL + kk, av[i]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float bv[TN];
#pragma unroll
      for (int e = 0; e < TN / 4; ++e) load4(B + (kk + q) * W + 4 * NTX * e, bv + 4 * e);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i * TN + j] = fmaf(av[i][q], bv[j], acc[i * TN + j]);
    }
  }
  for (; kk < len; ++kk) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float av = repro::to_f32(A[i * SL + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i * TN + j] = fmaf(av, B[kk * W + 4 * NTX * (j / 4) + j % 4], acc[i * TN + j]);
    }
  }
}

// Cluster (hidden block hb = blockIdx.x / CHUNKS, row group g = blockIdx.y)
// of CHUNKS blocks, block c = cluster rank taking depth chunk c (the header
// above has the steps).
template <typename T>
__global__ void __cluster_dims__(CHUNKS, 1, 1) __launch_bounds__(THREADS)
intersect_kernel(Args a) {
  constexpr int NW = THREADS / 32, NACC = TM * TN;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned seen[CHUNKS];  // each cluster block's arrival ticket
  __shared__ unsigned ticket;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int hb = blockIdx.x / CHUNKS, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.G, p0 = g * G, gp = min(G, a.n - p0);
  const int Mg = gp * a.k, m0 = p0 * a.k, Mmax = min(G, a.n) * a.k;
  const int CH = chunk_len(a.d), k0 = min(c * CH, a.d), len = min(CH, a.d - k0);
  const int j0 = hb * W, width = min(W, a.hd - j0);
  const Smem sm = smem_layout<T>(a.SL, Mmax);
  float* ws = reinterpret_cast<float*>(smem);
  float* hs = ws;  // the W1 slice's bytes, once the chain has read them
  float* bw = reinterpret_cast<float*>(smem + sm.bw);
  float* lg = reinterpret_cast<float*>(smem + sm.lg);
  T* xs = reinterpret_cast<T*>(smem + sm.xs);
  const T* x = static_cast<const T*>(a.x);
  // One load of the whole chunk, unless the group has more than RG rows or
  // the chunk is deeper than a slice: then passes over rows and slices.
  const bool whole = Mg <= RG && len <= a.SL;

  for (int u = threadIdx.x; u < W; u += THREADS) {
    const int j = j0 + u;
    bw[u] = j < a.hd ? a.b1[j] : 0.f;
    bw[W + u] = j < a.hd ? a.w2[j] : 0.f;
  }
  for (int ms = 0; ms < Mg; ms += RG) {
    const int rows = min(RG, Mg - ms);
    if (ms > 0) cluster.sync();  // the cluster has folded the previous pass
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    // Slices of at most SL, each loaded in two halves.
    for (int s0 = 0; s0 < len; s0 += a.SL) {
      const int sl = min(a.SL, len - s0), half = sl > 8 ? round4(cdiv(sl, 2)) : sl;
      if (s0 > 0) __syncthreads();  // the previous slice is consumed
      for (int h0 = 0; h0 < sl; h0 += half) {
        const int hl = min(half, sl - h0);
        copy_block(ws + h0 * W, W, a.w1 + static_cast<size_t>(k0 + s0 + h0) * a.hd + j0, a.hd, hl,
                   width, a.vec);
        copy_block(xs + h0, a.SL, x + static_cast<size_t>(m0 + ms) * a.d + k0 + s0 + h0, a.d, rows,
                   hl, a.vec);
        cp_commit();
      }
      for (int h0 = 0; h0 < sl; h0 += half) {
        if (h0 == 0 && half < sl) cp_wait<1>(); else cp_wait<0>();
        __syncthreads();
        chain<T>(xs + h0, ws + h0 * W, a.SL, min(half, sl - h0), acc);
      }
    }
    __syncthreads();  // ws is read: its bytes take hs
    {
      const int ty = threadIdx.x / NTX, tx = threadIdx.x % NTX;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int m = TM * ty + i;
          if (m < rows) hs[m * W + 4 * tx + 4 * NTX * (j / 4) + j % 4] = acc[i * TN + j];
        }
    }
    cluster.sync();
    // Block c folds rows m = c (mod CHUNKS), one warp a (row, tile): a warp
    // reads the partials of all its pairs before it sums any.
    constexpr int PAIRS = (RG / CHUNKS) * (W / HT), PER_WARP = (PAIRS + NW - 1) / NW;
    float part[PER_WARP][CHUNKS];
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      const int pr = warp + NW * i, m = c + CHUNKS * (pr / (W / HT)), h = pr % (W / HT);
      if (pr < PAIRS && m < rows)
#pragma unroll
        for (int r = 0; r < CHUNKS; ++r) part[i][r] = cluster.map_shared_rank(hs, r)[m * W + h * HT + lane];
    }
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      const int pr = warp + NW * i, m = c + CHUNKS * (pr / (W / HT)), h = pr % (W / HT);
      const int t = hb * (W / HT) + h;
      if (pr >= PAIRS || m >= rows || t >= a.T) continue;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < CHUNKS; ++r) sum = __fadd_rn(sum, part[i][r]);
      const int u = h * HT + lane;
      const float v = warp_sum(j0 + u < a.hd ? head(sum, bw[u], bw[W + u]) : 0.f);
      if (lane == 0) __stcg(a.partial + static_cast<size_t>(t) * a.M + m0 + ms + m, v);
    }
  }
  __syncthreads();
  if (threadIdx.x < CHUNKS) {
    if (threadIdx.x == 0) {
      __threadfence();  // cumulative: the block's partial logits, ordered by the barrier
      ticket = atomicAdd(a.counters + g, 1u);
    }
    __syncwarp(0xffu);
    *cluster.map_shared_rank(seen + c, threadIdx.x) = ticket;
  }
  cluster.sync();  // also: no block reads another's hs after this
  bool last = false;
#pragma unroll
  for (int r = 0; r < CHUNKS; ++r) last |= seen[r] == gridDim.x - 1;
  if (!last) return;
  if (c == 0 && threadIdx.x == 0) a.counters[g] = 0;  // every block has counted
  __threadfence();
  group_attention(a, m0, gp, lg);
  if (len <= 0) return;
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(p0) * a.d + k0;
  if (whole)
    weighted_sum(a, xs, static_cast<size_t>(a.SL), gp, len, lg, out);
  else
    weighted_sum(a, x + static_cast<size_t>(m0) * a.d + k0, static_cast<size_t>(a.d), gp, len,
                 lg, out);
}

// Once per device and dtype: opt the kernel into all of a block's shared
// memory and read that limit. Returns 0, or the CUDA error.
template <typename T>
int smem_limit(int* limit) {
  static std::atomic<int> room[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  *limit = room[dev].load(std::memory_order_acquire);
  if (*limit > 0) return 0;
  int optin = 0;
  cudaFuncAttributes attr;
  const void* kernel = reinterpret_cast<const void*>(intersect_kernel<T>);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  const int lim = optin - static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  room[dev].store(lim, std::memory_order_release);
  *limit = lim;
  return 0;
}

// A launch's shape: its row groups, the depth of a slice (the whole chunk
// where it fits, else the deepest multiple of 4 that does; 0 where not even
// 4 fit, as for the logits of an enormous k) and its bytes of shared memory.
struct Plan {
  int groups, SL;
  size_t smem;
};

template <typename T>
Plan plan(int n, int k, int d, int G, int limit) {
  const long long Mmax = static_cast<long long>(std::min(G, n)) * k;
  if (Mmax > limit / static_cast<int>(sizeof(float))) return {cdiv(n, G), 0, 0};
  int SL = chunk_len(d);
  while (SL >= 4 && smem_layout<T>(SL, static_cast<int>(Mmax)).total > static_cast<size_t>(limit))
    SL -= 4;
  return {cdiv(n, G), std::max(SL, 0),
          SL >= 4 ? smem_layout<T>(SL, static_cast<int>(Mmax)).total : 0};
}

bool aligned(const void* p, size_t b) { return reinterpret_cast<uintptr_t>(p) % b == 0; }

template <typename T>
int launch(Args a, cudaStream_t stream) {
  int limit = 0;
  if (const int rc = smem_limit<T>(&limit)) return rc;
  const Plan p = plan<T>(a.n, a.k, a.d, a.G, limit);
  // A row group's logits must fit a block's shared memory, and the row
  // groups the grid's y.
  if (p.SL < 4 || p.groups > MAX_GRID_Y) return static_cast<int>(cudaErrorInvalidValue);
  a.M = a.n * a.k;
  a.T = cdiv(a.hd, HT);
  a.SL = p.SL;
  a.vec = a.d % 4 == 0 && a.hd % 4 == 0 && aligned(a.x, 4 * sizeof(T)) &&
          aligned(a.out, 4 * sizeof(T)) && aligned(a.w1, 16);
  const dim3 grid(CHUNKS * cdiv(a.hd, W), p.groups);
  intersect_kernel<T><<<grid, THREADS, p.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Hidden tiles: the wrapper allocates `partial` as [repro_intersect_tiles(hd),
// n * k] fp32 scratch (one partial logit per tile and input row).
extern "C" int repro_intersect_tiles(int hd) { return cdiv(hd, HT); }

// Pool rows of a row group: `rows`, or group_rows(k) for rows = 0 (the
// kernel's own choice). The tuner's knob: a row's bits do not depend on it.
extern "C" int repro_intersect_group_rows(int k, int rows) {
  return rows > 0 ? rows : k < 1 ? 0 : group_rows(k);
}

// Row groups: the wrapper passes `counters` with at least this many uint32,
// all zero; every launch leaves them zero. One buffer per stream.
extern "C" int repro_intersect_groups(int n, int k, int rows) {
  return k < 1 || rows < 0 ? 0 : cdiv(n, repro_intersect_group_rows(k, rows));
}

// x [n, k, d] (dtype: repro::DType), w1 [d, hd], b1 [hd], w2 [hd], b2 [1]
// (fp32), partial and counters as above, out [n, d] in x's dtype; n, k, d,
// hd >= 1 (n = 0 launches nothing); rows: pool rows of a row group, or 0
// for group_rows(k). One launch; returns its CUDA error (0 = success;
// cudaErrorInvalidValue where a row group's logits do not fit a block's
// shared memory or its row groups the grid; no other geometry is tried).
extern "C" int repro_intersect_fused(const void* x, const float* w1, const float* b1,
                                     const float* w2, const float* b2, float* partial,
                                     unsigned* counters, void* out, int n, int k, int d,
                                     int hd, int dtype, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (n < 0 || k < 1 || d < 1 || hd < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,  w1, b1, w2, b2, partial, counters, out, n, k, d, hd,
               repro_intersect_group_rows(k, rows), 0, 0, 0, 0};
  if (dtype == repro::kF32) return launch<float>(a, s);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
