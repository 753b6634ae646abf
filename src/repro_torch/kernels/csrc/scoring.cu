// All-entity scoring logits (Eq. 6) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/scoring.py::scoring_pallas
// (body _scoring_kernel). out[b, n] = gamma + q[b]·e[n] (MODE 0, dot) or
// gamma - sum_d |q[b,d] - e[n,d]| (MODE 1, l1), accumulated in fp32 for
// fp32 or bf16 inputs.
//
// Bound: at the serving shapes (B <= 16 queries against N = 14,951 entities,
// d = 400) the entity table is read once and each element feeds at most 16
// multiply-adds, so the kernel is bound by the bytes of `e`. One block owns a
// BM x BN output tile, one output per thread; the BM query rows cover the
// whole serving batch, so `e` crosses device memory once per launch, and the
// small tiles give ~935 blocks at N = 14,951 — enough resident warps to keep
// many loads of `e` in flight. Each BK-wide slice of q and e is staged in
// shared memory with coalesced loads; every thread issues all its loads of a
// slice before storing any, and the next slice's loads are in flight while
// the current one is computed, so a step costs one memory latency, not one
// per load. The +1 padding keeps the column reads of `es` free of bank
// conflicts. Ragged B, N and d are masked inside
// the kernel (zero fill adds nothing to either the dot or the l1 sum).
#include "common.cuh"

namespace {

constexpr int BM = 16;       // query rows per block
constexpr int BN = 16;       // entities per block
constexpr int BK = 64;       // latent-dim slice staged per step
constexpr int THREADS = BM * BN;
constexpr int PER = BK * BM / THREADS;  // q (and e) elements each thread stages
static_assert(BM == BN, "q and e tiles share one staging loop");

template <int MODE, typename T>
__global__ void __launch_bounds__(THREADS)
scoring_kernel(const T* __restrict__ q, const T* __restrict__ e,
               float* __restrict__ out, int B, int N, int d, float gamma) {
  __shared__ float qs[BM][BK + 1];
  __shared__ float es[BN][BK + 1];
  const int tid = threadIdx.x;
  const int col = tid % BN;        // entity of this thread within the tile
  const int row = tid / BN;        // query row of this thread within the tile
  const int n0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * BM;

  float acc = 0.f;
  float qr[PER], er[PER];  // the next slice, staged in registers

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS, r = i / BK, k = k0 + i % BK;
      qr[j] = (b0 + r < B && k < d) ? repro::to_f32(q[(size_t)(b0 + r) * d + k]) : 0.f;
      er[j] = (n0 + r < N && k < d) ? repro::to_f32(e[(size_t)(n0 + r) * d + k]) : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      qs[i / BK][i % BK] = qr[j];
      es[i / BK][i % BK] = er[j];
    }
    __syncthreads();
    if (k0 + BK < d) load(k0 + BK);
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      if (MODE == 0) {
        acc = fmaf(qs[row][c], es[col][c], acc);
      } else {
        acc += fabsf(qs[row][c] - es[col][c]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + col, b = b0 + row;
  if (n < N && b < B) out[(size_t)b * N + n] = MODE == 0 ? gamma + acc : gamma - acc;
}

template <int MODE, typename T>
void launch(const void* q, const void* e, float* out, int B, int N, int d,
            float gamma, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  scoring_kernel<MODE, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(e), out, B, N, d, gamma);
}

}  // namespace

// mode: 0 = dot, 1 = l1. dtype: repro::DType of q and e. Returns the CUDA
// error of the launch (0 = success).
extern "C" int repro_scoring(const void* q, const void* e, float* out, int B,
                             int N, int d, float gamma, int mode, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0 && dtype == repro::kF32) launch<0, float>(q, e, out, B, N, d, gamma, s);
  else if (mode == 1 && dtype == repro::kF32) launch<1, float>(q, e, out, B, N, d, gamma, s);
  else if (mode == 0 && dtype == repro::kBF16) launch<0, __nv_bfloat16>(q, e, out, B, N, d, gamma, s);
  else if (mode == 1 && dtype == repro::kBF16) launch<1, __nv_bfloat16>(q, e, out, B, N, d, gamma, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
