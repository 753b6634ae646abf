// Semantic entity fusion (Eq. 11 + 12) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gather_fuse.py::gather_fuse_pallas
// in both of its launch geometries (rows=1: _gather_fuse_kernel fed by
// scalar-prefetched row DMAs; rows>1: XLA-side takes, then _fuse_only_kernel;
// both run the body _fuse_block). For each output row i < n:
//   h  = h_str[ids[i]]                  [d]
//   z  = h_sem[sem_ids[i]]              [dl]   (full H_sem, or hot-set slots)
//   zp = z·Wp + bp                      [dp]
//   y  = h·Wf[:d] + zp·Wf[d:] + bf      [d]    (the concat h ⊕ zp, split)
//   out[i] = sigmoid(y)·2 − 1, in h_str's dtype
// summed in fp32 for fp32 or bf16 tables (one dtype for both) and fp32
// weights.
//
// Bound: at d = 400, dl = 1024, dp = 64 each row carries
// 2·(dl·dp + (d+dp)·d) = 502k flops against 7.3 KB of fp32 rows (h, z, out),
// 68 flops a byte — above the card's fp32 balance of 20 (67 TFLOP/s over
// 3.35 TB/s), so all-entity fusion at n = E is bound by operations. fp32
// parity with the reference (1e-5) rules out TF32 tensor cores, so the work
// runs on CUDA cores as a tiled GEMM:
//
//  * One block owns BM = 32 rows. It loads its ids and sem_ids itself and
//    gathers its rows of h_str into shared memory (this replaces the scalar
//    prefetch and the XLA-side takes).
//  * It projects its rows, zp = z·Wp + bp, into shared memory, streaming the
//    dl axis in BK-deep slices of z and Wp (a 32-row tile of z alone would be
//    131 KB of shared memory).
//  * It then walks its share of the d output columns in BN = 64 groups:
//    h·Wf_h and zp·Wf_z accumulate into the same registers (no concat), and
//    b_f, the sigmoid and the output cast run in registers.
//  * Each thread computes a 2-row x 4-column register tile; weight slices
//    are staged in shared memory and read as float4, and the next slice's
//    loads are in flight while the current one is computed.
//  * The column groups are split over blocks (grid y) until the grid covers
//    the SMs twice, so 48 anchor rows still fill 14 blocks; at n = E every
//    block keeps all of d. When the groups are split, the blocks of a row
//    tile would each redo the whole projection. Where those blocks share
//    SMs (n = 4,096: 384 blocks), the repeats cost throughput, so a
//    projection-only launch of the same kernel (one block per row tile)
//    writes zp to a scratch [n, dp] first and the fusion blocks read it:
//    each row is projected once. Where every block has an SM to itself
//    (48 rows: 14 blocks), the repeat costs no time and a second launch
//    would, so the blocks project for themselves.
//
// Every output element is one fmaf chain in a fixed order — h·Wf_h over
// k = 0..d-1, then zp·Wf_z over j = 0..dp-1, then + b_f — and zp likewise, so
// a row's result depends only on its own inputs: not on n, on which rows
// share its tile, or on the column split. The same row fused from the
// resident table, the hot-set cache or a streamed chunk is bitwise equal.
// No atomics, no tensor cores. An id outside its table gives a NaN row
// instead of an out-of-bounds read.
#include <math.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace {

constexpr int BM = 32;          // rows per block
constexpr int BN = 64;          // output columns per group
constexpr int BK = 32;          // depth slice
constexpr int THREADS = 256;
constexpr int TXN = 16;         // threads across a group's columns
constexpr int CPT = 4;          // columns per thread (one float4)
constexpr int RPT = 2;          // rows per thread
constexpr int PA = BM * BK / THREADS;  // z elements each thread stages
constexpr int PB = BK * BN / THREADS;  // weight elements each thread stages
constexpr int MAX_DEVICES = 64;

// What a launch does: project and fuse (the column groups are not split),
// project only (zp to global), or fuse the zp a projection launch wrote.
enum Mode { kFull = 0, kProject = 1, kFuse = 2 };
static_assert(TXN * CPT == BN && (THREADS / TXN) * RPT == BM, "thread tile");

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Dynamic shared memory, in floats. The weight slice comes first so its
// float4 reads are 16-byte aligned; the row strides are odd, so the 4 rows a
// warp reads sit in different banks, and zero-padded to whole BK slices.
struct Layout {
  int hst, zst;
  __host__ __device__ Layout(int d, int dp)
      : hst(round_up(d, BK) + 1), zst(round_up(dp, BK) + 1) {}
  __host__ __device__ int bs() const { return 0; }                    // [BK][BN]
  __host__ __device__ int as() const { return BK * BN; }              // [BM][BK+1]
  __host__ __device__ int hs() const { return as() + BM * (BK + 1); } // [BM][hst]
  __host__ __device__ int zs() const { return hs() + BM * hst; }      // [BM][zst]
  __host__ __device__ size_t bytes() const { return (size_t)(zs() + BM * zst) * sizeof(float); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_fuse_kernel(const long long* __restrict__ ids, const long long* __restrict__ sem_ids,
                   const T* __restrict__ h_str, const T* __restrict__ h_sem,
                   const float* __restrict__ wp, const float* __restrict__ bp,
                   const float* __restrict__ wf, const float* __restrict__ bf,
                   float* __restrict__ zp, T* __restrict__ out, int n,
                   long long n_str, long long n_sem, int d, int dl, int dp,
                   int groups_per_block, int mode) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(d, dp);
  float* bs = smem + L.bs();
  float* as = smem + L.as();
  float* hs = smem + L.hs();
  float* zs = smem + L.zs();
  __shared__ long long hrow[BM], zrow[BM];
  __shared__ int bad[BM];

  const int tid = threadIdx.x;
  const int tx = tid % TXN;
  const int ty = tid / TXN;
  const int r0 = blockIdx.x * BM;

  if (tid < BM) {
    const int i = r0 + tid;
    long long h = -1, z = -1;
    int b = 0;
    if (i < n) {
      h = ids[i];
      z = sem_ids[i];
      if (h < 0 || h >= n_str || z < 0 || z >= n_sem) {
        h = z = -1;
        b = 1;
      }
    }
    hrow[tid] = h;
    zrow[tid] = z;
    bad[tid] = b;
  }
  __syncthreads();

  // Gathered structural rows, zero-padded to whole BK slices.
  const int dk = round_up(d, BK);
  if (mode != kProject) {
    for (int i = tid; i < BM * dk; i += THREADS) {
      const int r = i / dk, k = i % dk;
      const long long row = hrow[r];
      hs[r * L.hst + k] = (row >= 0 && k < d) ? repro::to_f32(h_str[row * d + k]) : 0.f;
    }
  }

  float acc[RPT][CPT];
  float ar[PA], br[PB];  // the next slice of z and of the weights, in registers

  auto zero_acc = [&] {
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[rr][j] = 0.f;
  };
  // z is read along dl (i % BK), the weights along columns (i % BN): both
  // coalesced across the warp.
  auto load_z = [&](int k0) {
#pragma unroll
    for (int j = 0; j < PA; ++j) {
      const int i = tid + j * THREADS, r = i / BK, k = k0 + i % BK;
      const long long row = zrow[r];
      ar[j] = (row >= 0 && k < dl) ? repro::to_f32(h_sem[row * dl + k]) : 0.f;
    }
  };
  // Rows k0..k0+BK-1 (of krows) and columns c0..c0+BN-1 (of ncols) of w.
  auto load_w = [&](const float* w, int ldw, int krows, int k0, int c0, int ncols) {
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const int i = tid + j * THREADS, k = k0 + i / BN, c = c0 + i % BN;
      br[j] = (k < krows && c < ncols) ? w[(size_t)k * ldw + c] : 0.f;
    }
  };
  auto store_w = [&] {
#pragma unroll
    for (int j = 0; j < PB; ++j) bs[tid + j * THREADS] = br[j];
  };
  // acc += a[rows][k0 .. k0+BK) · bs, one fmaf chain per output element.
  auto fma_slice = [&](const float* a, int stride, int k0) {
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(bs + c * BN + tx * CPT);
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        const float v = a[(ty * RPT + rr) * stride + k0 + c];
        acc[rr][0] = fmaf(v, b.x, acc[rr][0]);
        acc[rr][1] = fmaf(v, b.y, acc[rr][1]);
        acc[rr][2] = fmaf(v, b.z, acc[rr][2]);
        acc[rr][3] = fmaf(v, b.w, acc[rr][3]);
      }
    }
  };

  // ---- projection: zs = z·Wp + bp, streamed over dl ----------------------
  const int zk = round_up(dp, BK);
  if (mode == kFuse) {  // projected once per row by the kProject launch
    for (int i = tid; i < BM * zk; i += THREADS) {
      const int r = i / zk, c = i % zk;
      zs[r * L.zst + c] = (c < dp && r0 + r < n) ? zp[(size_t)(r0 + r) * dp + c] : 0.f;
    }
  }
  for (int cg = 0; mode != kFuse && cg < zk; cg += BN) {
    zero_acc();
    load_z(0);
    load_w(wp, dp, dl, 0, cg, dp);
    for (int k0 = 0; k0 < dl; k0 += BK) {
#pragma unroll
      for (int j = 0; j < PA; ++j) {
        const int i = tid + j * THREADS;
        as[(i / BK) * (BK + 1) + i % BK] = ar[j];
      }
      store_w();
      __syncthreads();
      if (k0 + BK < dl) {
        load_z(k0 + BK);
        load_w(wp, dp, dl, k0 + BK, cg, dp);
      }
      fma_slice(as, BK + 1, 0);
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = cg + tx * CPT + j;
        if (col < zk) zs[(ty * RPT + rr) * L.zst + col] = col < dp ? acc[rr][j] + bp[col] : 0.f;
      }
  }
  __syncthreads();
  if (mode == kProject) {
    for (int i = tid; i < BM * dp; i += THREADS) {
      const int r = i / dp, c = i % dp;
      if (r0 + r < n) zp[(size_t)(r0 + r) * dp + c] = zs[r * L.zst + c];
    }
    return;
  }

  // ---- fusion: out = sigmoid(h·Wf_h + zp·Wf_z + bf)·2 − 1 ----------------
  const float* wf_z = wf + (size_t)d * d;
  const int n_groups = (d + BN - 1) / BN;
  const int g1 = min(n_groups, (int)(blockIdx.y + 1) * groups_per_block);
  for (int g = blockIdx.y * groups_per_block; g < g1; ++g) {
    const int c0 = g * BN;
    zero_acc();
    load_w(wf, d, d, 0, c0, d);
    for (int k0 = 0; k0 < d; k0 += BK) {
      store_w();
      __syncthreads();
      if (k0 + BK < d) load_w(wf, d, d, k0 + BK, c0, d);
      else load_w(wf_z, d, dp, 0, c0, d);
      fma_slice(hs, L.hst, k0);
      __syncthreads();
    }
    for (int k0 = 0; k0 < dp; k0 += BK) {
      store_w();
      __syncthreads();
      if (k0 + BK < dp) load_w(wf_z, d, dp, k0 + BK, c0, d);
      fma_slice(zs, L.zst, k0);
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int r = ty * RPT + rr, i = r0 + r;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + tx * CPT + j;
        if (col >= d) continue;
        const float y = acc[rr][j] + bf[col];
        const float v = bad[r] ? NAN : (1.f / (1.f + expf(-y))) * 2.f - 1.f;
        out[(size_t)i * d + col] = repro::from_f32<T>(v);
      }
    }
  }
}

// Once per device and table dtype: opt the kernel into all of a block's
// shared memory (above 48 KB only with the opt-in; a layout past the 227 KB
// then fails at launch) and read the SM count. Returns the SM count, or
// minus the CUDA error.
template <typename T>
int device_sms(int dev) {
  static std::atomic<int> sms[MAX_DEVICES];
  int v = sms[dev].load(std::memory_order_acquire);
  if (v > 0) return v;
  auto kernel = gather_fuse_kernel<T>;
  cudaFuncAttributes attr;
  int optin = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  sms[dev].store(v, std::memory_order_release);
  return v;
}

template <typename T>
int launch(const long long* ids, const long long* sem_ids, const void* h_str,
           const void* h_sem, const float* wp, const float* bp, const float* wf,
           const float* bf, float* zp, void* out, int n, long long n_str,
           long long n_sem, int d, int dl, int dp, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const int sms = device_sms<T>(dev);
  if (sms < 0) return -sms;
  const size_t smem = Layout(d, dp).bytes();
  const int row_tiles = (n + BM - 1) / BM;
  const int n_groups = (d + BN - 1) / BN;
  // Split the column groups over blocks until the grid covers the SMs twice.
  int splits = std::min(n_groups, std::max(1, (2 * sms + row_tiles - 1) / row_tiles));
  const int per_block = (n_groups + splits - 1) / splits;
  splits = (n_groups + per_block - 1) / per_block;
  const T* hs = static_cast<const T*>(h_str);
  const T* zs = static_cast<const T*>(h_sem);
  int mode = kFull;
  if (splits > 1 && row_tiles * splits > sms) {  // project each row once
    gather_fuse_kernel<T><<<dim3(row_tiles, 1), THREADS, smem, stream>>>(
        ids, sem_ids, hs, zs, wp, bp, wf, bf, zp, static_cast<T*>(out), n, n_str,
        n_sem, d, dl, dp, 0, kProject);
    mode = kFuse;
  }
  gather_fuse_kernel<T><<<dim3(row_tiles, splits), THREADS, smem, stream>>>(
      ids, sem_ids, hs, zs, wp, bp, wf, bf, zp, static_cast<T*>(out), n, n_str,
      n_sem, d, dl, dp, per_block, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids, sem_ids [n] int64; h_str [n_str, d] and h_sem [n_sem, dl] of one
// dtype (repro::DType); wp [dl, dp], bp [dp], wf [d + dp, d], bf [d] fp32;
// zp [n, dp] fp32 scratch for the projected rows; out [n, d] in the tables'
// dtype. Returns the CUDA error of the launch (0 = success).
extern "C" int repro_gather_fuse(const long long* ids, const long long* sem_ids,
                                 const void* h_str, const void* h_sem,
                                 const float* wp, const float* bp, const float* wf,
                                 const float* bf, float* zp, void* out, int n,
                                 long long n_str, long long n_sem, int d, int dl,
                                 int dp, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(ids, sem_ids, h_str, h_sem, wp, bp, wf, bf, zp, out, n,
                         n_str, n_sem, d, dl, dp, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(ids, sem_ids, h_str, h_sem, wp, bp, wf, bf, zp, out,
                                 n, n_str, n_sem, d, dl, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
