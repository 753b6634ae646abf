// Backward of the semantic entity fusion (Eq. 11 + 12) for Hopper (sm_90a),
// fp32, on the CUDA cores.
//
// The forward (csrc/gather_fuse.cu, replacing the TPU kernel
// src/repro/kernels/gather_fuse.py::gather_fuse_pallas) is, per row i < n:
//   h = h_str[ids[i]] [d], z = h_sem[sem_ids[i]] [dl], zp = z·Wp + bp [dp],
//   y = [h ⊕ zp]·Wf + bf [d], o = sigmoid(y)·2 − 1.
// The JAX package has no backward kernel (its trainer differentiates the jnp
// fuse_semantic), so this one has no TPU counterpart: it is the gradient of
// gather_fuse_pallas (src/repro/kernels/gather_fuse.py:77). Given
// g = dL/do [n, d], with H_sem frozen (it gets no gradient):
//   t  = g ⊙ (1 − o²)/2              the derivative of 2σ − 1, from the saved o
//   dX = t·Wfᵀ = [dh ⊕ dzp]           [n, d + dp]
//   dWf = [h ⊕ zp]ᵀ·t, dbf = Σ_i t, dWp = zᵀ·dzp, dbp = Σ_i dzp,
//   dh_str[e] = Σ_{i: ids[i] = e} dh_i (zero where no id names e).
//
// What bounds it. A row costs 2·dl·dp (zp, recomputed) + 2·d·(d + dp) (dX)
// + 2·(d + dp)·d (dWf) + 2·dl·dp (dWp) flops: 1.0 MFLOP at d = 400,
// dl = 1024, dp = 64, against ~10 KB of its rows (z 4 KB; h, g, o and dh
// 1.6 KB each). At the loss's n = 33,280 rows (512 queries × 65 candidates)
// that is 33 GFLOP: 0.50 ms on the fp32 CUDA cores (67 TFLOP/s), 0.20 ms in
// 3xTF32 on the tensor cores, against ~0.1 ms for the bytes. Bound by
// operations.
//
// Design: a simple kernel that is right; making it fast is later work. One
// C call launches, on the caller's stream, in order:
//   1. the gather: X = [h | zp | 1] and Z = [z | 1] rows into scratch (ids
//      outside their table give zero rows; the ones columns carry the bias
//      gradients through the products below);
//   2. zp = z·Wp + bp, into X;  3. (only when no saved o is given) the
//   pre-activation y = X·Wf + bf;  4. t;  5. dX = t·Wfᵀ;
//   6. [dWf; dbf] = Xᵀ·t;  7. [dWp; dbp] = Zᵀ·dzp, each over chunks of rows
//   then folded;  8. dh_str, a segment sum over the ids sorted once.
// The products are one tiled SGEMM on the CUDA cores: 128 × 128 (or
// 128 × 64) tiles of C, each thread 8 × 8 outputs in registers, depth slices
// of 16 copied into shared memory with cp.async two slices deep (the next
// slice lands while this one is multiplied), each operand kept in shared
// memory in the layout it has in device memory (along k, or along m or n).
// At n = 33,280 the four products run at ~30 TFLOP/s each, ~45% of the
// CUDA-core rate; a cap of 128 registers (two blocks an SM) spilled and ran
// 2–9% slower (PERF.md).
//
// ptxas -v (-O3, sm_90a): gemm_kernel 127–254 registers by instance, no
// spills; 25,600–40,960 bytes of shared memory a block.
//
// Bits that repeat, and no float atomics. Every output of a product is one
// FMA chain in order of depth. The weight and bias gradients sum over the
// call's n rows: the rows are cut into chunks of KC = 1,024 (a constant),
// each chunk's product is one chain an element written to scratch, and a
// fold adds the chunks in order. dh_str: the wrapper sorts the ids once
// (stable); the warp at the start of each run of equal ids adds the run's
// dh rows in that order, which is the order the rows come in the call, and
// writes the row. A row's dh does not depend on n or on the other rows. An
// id outside its table reads as a zero row and writes nothing.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BM = 128;   // rows of C a block
constexpr int BK = 16;    // depth of a slice
constexpr int PAD = 4;    // shared rows stay 16-byte aligned, reads spread over banks
constexpr int KC = 1024;  // rows of a chunk of the weight gradients' depth

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// A row-major operand: A(m, k) is base[m·ld + k] when it runs along k (AK),
// else base[k·ld + m]; B(k, n) is base[n·ld + k] when it runs along k (BKC),
// else base[k·ld + n].
struct Gemm {
  const float* a;
  long long lda;
  const float* b;
  long long ldb;
  int M, N, K;
  int kc;             // depth of a chunk (blockIdx.z); K when one chunk
  float* c;           // one chunk: C = A·B [+ bias], row pitch ldc
  long long ldc;
  const float* bias;  // [N] or null
  float* part;        // chunks: chunk z's A·B at part + z·M·N, row pitch N
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// V floats from src to dst (16 or 4 bytes); of them, `bytes` are read and
// the rest zero-filled (src is not read when bytes is 0).
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of one operand's slice: ROWS rows (m of A, n of B) from
// r0, depth k0..k0 + BK, zeros past r_end and k_end. Along k (KC): shared
// [ROWS][BK + PAD]; else shared [BK][ROWS + PAD].
template <bool KCONTIG, int ROWS, int V, int THREADS>
__device__ __forceinline__ void issue(float* dst, const float* base, long long ld, int r0,
                                      int r_end, int k0, int k_end) {
  if constexpr (KCONTIG) {
    constexpr int PER = BK / V;  // copies a row
    static_assert(ROWS * PER % THREADS == 0, "every thread issues as many copies");
#pragma unroll
    for (int j = 0; j < ROWS * PER / THREADS; ++j) {
      const int f = threadIdx.x + j * THREADS;
      const int r = f / PER, k = (f % PER) * V, gr = r0 + r, gk = k0 + k;
      const int valid = gr < r_end ? max(0, min(V, k_end - gk)) : 0;
      cp_async<V>(dst + r * (BK + PAD) + k, valid ? base + gr * ld + gk : base, 4 * valid);
    }
  } else {
    constexpr int PER = ROWS / V;  // copies a k
    static_assert(BK * PER % THREADS == 0, "every thread issues as many copies");
#pragma unroll
    for (int j = 0; j < BK * PER / THREADS; ++j) {
      const int f = threadIdx.x + j * THREADS;
      const int k = f / PER, r = (f % PER) * V, gk = k0 + k, gr = r0 + r;
      const int valid = gk < k_end ? max(0, min(V, r_end - gr)) : 0;
      cp_async<V>(dst + k * (ROWS + PAD) + r, valid ? base + gk * ld + gr : base, 4 * valid);
    }
  }
}

// Output i (of 8) of thread coordinate t along a tile of ROWS (TT threads):
// strided by TT when the operand runs along k, so that a warp's 8-byte
// reads of consecutive rows fall in distinct banks; else 4 together, twice.
template <bool KCONTIG, int ROWS, int TT>
__device__ __forceinline__ int sub(int t, int i) {
  if constexpr (KCONTIG) return t + TT * i;
  return (i < 4 ? 0 : ROWS / 2 - 4) + 4 * t + i;
}

// Two depth steps of this thread's 8 rows (or columns) from a slice in
// shared memory: v[i][kk] for depth k + kk.
template <bool KCONTIG, int ROWS, int TT>
__device__ __forceinline__ void frag(const float* s, int t, int k, float (&v)[8][2]) {
  if constexpr (KCONTIG) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(s + sub<true, ROWS, TT>(t, i) * (BK + PAD) + k);
      v[i][0] = x.x;
      v[i][1] = x.y;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* row = s + (k + kk) * (ROWS + PAD);
      const float4 x0 = *reinterpret_cast<const float4*>(row + 4 * t);
      const float4 x1 = *reinterpret_cast<const float4*>(row + ROWS / 2 + 4 * t);
      v[0][kk] = x0.x, v[1][kk] = x0.y, v[2][kk] = x0.z, v[3][kk] = x0.w;
      v[4][kk] = x1.x, v[5][kk] = x1.y, v[6][kk] = x1.z, v[7][kk] = x1.w;
    }
  }
}

template <bool AK, bool BKC, int BN>
struct Shape {
  static constexpr int TY = BM / 8, TX = BN / 8, THREADS = TY * TX;
  static constexpr int A_FLOATS = AK ? BM * (BK + PAD) : BK * (BM + PAD);
  static constexpr int B_FLOATS = BKC ? BN * (BK + PAD) : BK * (BN + PAD);
};

template <bool AK, bool BKC, int BN, int V>
__global__ void __launch_bounds__(Shape<AK, BKC, BN>::THREADS) gemm_kernel(const Gemm g) {
  using S = Shape<AK, BKC, BN>;
  __shared__ __align__(16) float As[2][S::A_FLOATS];
  __shared__ __align__(16) float Bs[2][S::B_FLOATS];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * g.kc, k_hi = min(g.K, k_lo + g.kc);
  // A warp covers 4 × 8 threads of the tile grid: its reads of a slice are
  // one contiguous run, or rows in distinct banks.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = (warp % (S::TX / 8)) * 8 + lane % 8, ty = (warp / (S::TX / 8)) * 4 + lane / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto load = [&](int stage, int k0) {
    issue<AK, BM, V, S::THREADS>(As[stage], g.a, g.lda, m0, g.M, k0, k_hi);
    issue<BKC, BN, V, S::THREADS>(Bs[stage], g.b, g.ldb, n0, g.N, k0, k_hi);
    cp_commit();
  };
  if (k_lo < k_hi) load(0, k_lo);
  for (int k0 = k_lo, s = 0; k0 < k_hi; k0 += BK, s ^= 1) {
    if (k0 + BK < k_hi) {  // the next slice, landing under this one's FMAs
      load(s ^ 1, k0 + BK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; k += 2) {
      float a[8][2], b[8][2];
      frag<AK, BM, S::TY>(As[s], ty, k, a);
      frag<BKC, BN, S::TX>(Bs[s], tx, k, b);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
    __syncthreads();  // this stage is read; the next iteration may refill it
  }
  const long long mn = static_cast<long long>(g.M) * g.N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + sub<AK, BM, S::TY>(ty, i);
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + sub<BKC, BN, S::TX>(tx, j);
      if (n >= g.N) continue;
      if (g.part) {
        g.part[blockIdx.z * mn + static_cast<long long>(m) * g.N + n] = acc[i][j];
      } else {
        g.c[m * g.ldc + n] = g.bias ? acc[i][j] + g.bias[n] : acc[i][j];
      }
    }
  }
}

// X rows [h | zp (written by the next launch) | 1 | 0 pad] and Z rows
// [z | 1 | 0 pad], a block a row, 16 bytes a thread where the widths allow
// (VEC); an id outside its table gives zeros.
template <bool VEC>
__device__ __forceinline__ void gather_row(const float* src, bool ok, int width, int one, int pitch,
                                           float* dst) {
  for (int c = 4 * threadIdx.x; c < pitch; c += 4 * blockDim.x) {
    if (VEC && c + 3 < width) {
      *reinterpret_cast<float4*>(dst + c) =
          ok ? *reinterpret_cast<const float4*>(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[c + e] = c + e < width ? (ok ? src[c + e] : 0.f) : (c + e == one ? 1.f : 0.f);
    }
  }
}
template <bool VEC>
__global__ void gather_kernel(const long long* ids, const long long* sem_ids, const float* h_str,
                              const float* h_sem, long long n_str, long long n_sem, int d, int dl,
                              int dp, int lx, int lz, float* X, float* Z) {
  const int i = blockIdx.x;
  const long long e = ids[i], s = sem_ids[i];
  const bool he = e >= 0 && e < n_str, hs = s >= 0 && s < n_sem;
  gather_row<VEC>(h_str + (he ? e : 0) * d, he, d, d + dp, lx, X + static_cast<long long>(i) * lx);
  gather_row<VEC>(h_sem + (hs ? s : 0) * dl, hs, dl, dl, lz, Z + static_cast<long long>(i) * lz);
}

// Σ_z part[z·count + j], the chunks added in order, into dst[j] for
// j < split and dst2[j − split] after.
__global__ void fold_kernel(const float* part, int chunks, long long count, long long split,
                            float* dst, float* dst2) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= count) return;
  float s = part[j];
  for (int z = 1; z < chunks; ++z) s += part[z * count + j];
  if (j < split) dst[j] = s;
  else dst2[j - split] = s;
}

// t = g ⊙ (1 − o²)/2 over count elements; o is the saved output, or (o
// null) made here from the pre-activation y that t holds on entry.
__global__ void dpre_kernel(const float* g, const float* o, float* t, long long count) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= count) return;
  const float v = o ? o[i] : __fdividef(2.f, 1.f + __expf(-t[i])) - 1.f;
  t[i] = g[i] * (0.5f * (1.f - v * v));
}

// dh_str's rows: a warp for each position j of the sorted ids. The warp at
// the start of a run of equal ids adds the run's dh rows (dX rows order[j..],
// row pitch ldx) in order and writes the sum to the id's row; ids outside
// [0, n_str) write nothing.
constexpr int SEG_COLS = 8;  // columns a lane holds in registers
__global__ void segment_kernel(const long long* sorted, const long long* order, const float* dx,
                               long long ldx, int n, long long n_str, int d, float* dh) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w >= n) return;
  const long long e = sorted[w];
  if ((w > 0 && sorted[w - 1] == e) || e < 0 || e >= n_str) return;
  int end = w + 1;
  while (end < n && sorted[end] == e) ++end;
  for (int c0 = 0; c0 < d; c0 += 32 * SEG_COLS) {
    float acc[SEG_COLS];
#pragma unroll
    for (int u = 0; u < SEG_COLS; ++u) acc[u] = 0.f;
    for (int j = w; j < end; ++j) {
      const float* row = dx + order[j] * ldx;
#pragma unroll
      for (int u = 0; u < SEG_COLS; ++u) {
        const int c = c0 + lane + 32 * u;
        if (c < d) acc[u] += row[c];
      }
    }
#pragma unroll
    for (int u = 0; u < SEG_COLS; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < d) dh[e * d + c] = acc[u];
    }
  }
}

template <bool AK, bool BKC, int BN, int V>
void launch_gemm(cudaStream_t s, const Gemm& g, int chunks) {
  const dim3 grid(cdiv(g.M, BM), cdiv(g.N, BN), chunks);
  gemm_kernel<AK, BKC, BN, V><<<grid, Shape<AK, BKC, BN>::THREADS, 0, s>>>(g);
}

// The product on the tile that fits N, in whole chunks of KC rows of depth
// (chunks > 1 writes partials), 16-byte copies when V is 4.
template <bool AK, bool BKC>
int gemm(cudaStream_t s, Gemm g, int chunks, bool vec) {
  g.kc = chunks == 1 ? g.K : KC;
  if (g.N <= 64) {
    if (vec) launch_gemm<AK, BKC, 64, 4>(s, g, chunks);
    else launch_gemm<AK, BKC, 64, 1>(s, g, chunks);
  } else {
    if (vec) launch_gemm<AK, BKC, 128, 4>(s, g, chunks);
    else launch_gemm<AK, BKC, 128, 1>(s, g, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

int fold(cudaStream_t s, const float* part, int chunks, long long count, long long split,
         float* dst, float* dst2) {
  fold_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(part, chunks, count,
                                                                          split, dst, dst2);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Floats of scratch the backward of an n-row call needs: X [n, lx], Z [n, lz],
// t [n, d], dX [n, d + dp] and the weight gradients' chunk partials.
extern "C" long long repro_gather_fuse_backward_scratch(int n, int d, int dl, int dp) {
  const long long rows = n, chunks = std::max(1, cdiv(n, KC));
  const long long lx = round4(d + dp + 1), lz = round4(dl + 1);
  const long long widest = std::max(static_cast<long long>(d + dp + 1) * d,
                                    static_cast<long long>(dl + 1) * dp);
  return rows * (lx + lz + d + round4(d + dp)) + chunks * widest;
}

// ids, sem_ids [n] int64 (rows of h_str [n_str, d] and of h_sem [n_sem, dl]);
// sorted_ids, order [n] int64: ids sorted stably, and each sorted position's
// index in ids; wp [dl, dp], bp [dp], wf [d + dp, d], bf [d]; out [n, d], the
// forward's output, or null to recompute it; g [n, d]; scratch of
// repro_gather_fuse_backward_scratch floats; dh_str [n_str, d], zero on entry;
// dwp, dbp, dwf, dbf written whole. All fp32 but the indices. Returns the
// CUDA error of the first launch that failed (0 = success).
extern "C" int repro_gather_fuse_backward(
    const long long* ids, const long long* sem_ids, const long long* sorted_ids,
    const long long* order, const float* h_str, const float* h_sem, const float* wp,
    const float* bp, const float* wf, const float* bf, const float* out, const float* g,
    float* scratch, float* dh_str, float* dwp, float* dbp, float* dwf, float* dbf, int n,
    long long n_str, long long n_sem, int d, int dl, int dp, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = d + dp, lx = round4(w + 1), lz = round4(dl + 1), chunks = cdiv(n, KC);
  float* X = scratch;
  float* Z = X + static_cast<size_t>(n) * lx;
  float* t = Z + static_cast<size_t>(n) * lz;
  float* dX = t + static_cast<size_t>(n) * d;
  float* part = dX + static_cast<size_t>(n) * round4(w);
  // 16-byte copies need every row pitch and start on a 16-byte boundary.
  const bool vec = d % 4 == 0 && dp % 4 == 0 && aligned16(wp) && aligned16(wf) &&
                   aligned16(scratch);
  int err;
  // 1. X = [h | · | 1], Z = [z | 1]; the table rows in 16-byte pieces where
  // their widths and starts allow.
  if (vec && dl % 4 == 0 && aligned16(h_str) && aligned16(h_sem))
    gather_kernel<true><<<n, 128, 0, s>>>(ids, sem_ids, h_str, h_sem, n_str, n_sem, d, dl, dp, lx,
                                          lz, X, Z);
  else
    gather_kernel<false><<<n, 128, 0, s>>>(ids, sem_ids, h_str, h_sem, n_str, n_sem, d, dl, dp, lx,
                                           lz, X, Z);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  // 2. zp = z·Wp + bp, into X's columns d..
  if ((err = gemm<true, false>(s, Gemm{Z, lz, wp, dp, n, dp, dl, 0, X + d, lx, bp, nullptr}, 1,
                               vec)))
    return err;
  // 3. Without the saved output, the pre-activation y = X·Wf + bf into t.
  if (!out && (err = gemm<true, false>(s, Gemm{X, lx, wf, d, n, d, w, 0, t, d, bf, nullptr}, 1,
                                       vec)))
    return err;
  // 4. t = g ⊙ (1 − o²)/2.
  const long long nd = static_cast<long long>(n) * d;
  dpre_kernel<<<static_cast<unsigned>((nd + 255) / 256), 256, 0, s>>>(g, out, t, nd);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  // 5. dX = t·Wfᵀ: B(k, j) = Wf[j][k], along k.
  if ((err = gemm<true, true>(s, Gemm{t, d, wf, d, n, w, d, 0, dX, w, nullptr, nullptr}, 1, vec)))
    return err;
  // 6. [dWf; dbf] = Xᵀ·t over X's d + dp + 1 columns (the last the ones).
  if ((err = gemm<false, false>(s, Gemm{X, lx, t, d, w + 1, d, n, 0, nullptr, 0, nullptr, part},
                                chunks, vec)) ||
      (err = fold(s, part, chunks, static_cast<long long>(w + 1) * d,
                  static_cast<long long>(w) * d, dwf, dbf)))
    return err;
  // 7. [dWp; dbp] = Zᵀ·dzp, dzp being dX's last dp columns.
  if ((err = gemm<false, false>(s, Gemm{Z, lz, dX + d, w, dl + 1, dp, n, 0, nullptr, 0, nullptr,
                                        part},
                                chunks, vec)) ||
      (err = fold(s, part, chunks, static_cast<long long>(dl + 1) * dp,
                  static_cast<long long>(dl) * dp, dwp, dbp)))
    return err;
  // 8. dh_str: dX's first d columns, summed by id.
  segment_kernel<<<cdiv(n, 8), 256, 0, s>>>(sorted_ids, order, dX, w, n, n_str, d, dh_str);
  return static_cast<int>(cudaGetLastError());
}
