// A read of a buffer and nothing else: the floor against which the kernels
// that stream a table (scoring's `e`) are timed. It is not a port of a TPU
// kernel and no serving path calls it.
//
// One block per SM sums a contiguous share of the buffer's float4s, each
// thread keeping INFLIGHT 16-byte loads in flight, and writes its partial
// sum. With no elements it is a launch of the same grid that reads nothing.
#include "common.cuh"

namespace {

constexpr int THREADS = 384;
constexpr int INFLIGHT = 8;

__global__ void __launch_bounds__(THREADS, 1)
stream_read_kernel(const float4* __restrict__ x, long long n4, float* __restrict__ part) {
  const long long lo = blockIdx.x * n4 / gridDim.x, hi = (blockIdx.x + 1) * n4 / gridDim.x;
  float acc = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += INFLIGHT * THREADS) {
    float4 v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const long long j = i + u * THREADS;
      v[u] = j < hi ? x[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) acc += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  }
  __shared__ float warps[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += warps[w];
    part[blockIdx.x] = s;
  }
}

}  // namespace

// x: n4 float4s (16-byte aligned); part: `blocks` floats, one partial sum
// per block. Returns the CUDA error of the launch (0 = success).
extern "C" int repro_stream_read(const void* x, long long n4, float* part, int blocks,
                                 void* stream) {
  stream_read_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), n4, part);
  return static_cast<int>(cudaGetLastError());
}
