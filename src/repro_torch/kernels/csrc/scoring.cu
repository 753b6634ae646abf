// All-entity scoring logits (Eq. 6) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/scoring.py::scoring_pallas
// (body _scoring_kernel). out[b, n] = gamma + q[b]·e[n] (MODE 0, dot) or
// gamma - sum_d |q[b,d] - e[n,d]| (MODE 1, l1), accumulated in fp32 for
// fp32 or bf16 inputs, any B, N and d.
//
// Bound: at the serving shapes (B <= 16 queries against N = 14,951 entities,
// d = 400) the entity table (23.9 MB in fp32) is read once and each of its
// elements feeds at most 16 multiply-adds, so the kernel is bound by the
// bytes of `e`: 7.4 us at 3.35 TB/s. The arithmetic is not far behind: the
// 96 M FMAs of dot need ~3 us of the card's CUDA cores and l1's subtract and
// |.|-add twice that, so the loads of `e` have to overlap the arithmetic and
// the arithmetic has to read little shared memory per operation:
//
//  * Persistent grid, one block per SM. Block g owns the contiguous rows
//    [g·N/G, (g+1)·N/G) of `e` (~113 rows at N = 14,951): every SM streams
//    the same number of bytes and there is no tail wave. It walks its rows
//    in tiles of BN and each tile along d in slices of 64 elements.
//  * Warp specialisation. A producer warpgroup streams the slices into a
//    ring of 4 shared-memory stages with 16-byte cp.async and signals each
//    stage's `full` mbarrier with cp.async.mbarrier.arrive; 8 consumer warps
//    compute and release the stage on its `empty` mbarrier. Computing warps
//    never issue copies, so they never stall on the copy queue. setmaxnreg
//    moves the producers' registers to the consumers.
//  * q is staged once per block by the consumers, while the first slices of
//    `e` are already in flight: the block's 16-row query tile over all of d,
//    in fp32, 29 KB at d = 400 (rows past B are zeros). A d too large for
//    shared memory is staged in windows instead, once per window and tile.
//    B > 16 runs another grid row per 16 queries.
//  * Split d, register tiles. Each lane owns 8 queries x RE entities over
//    one of 8 k-groups: 8 interleaved elements of every slice. It loads e
//    and q once per 4 elements as 16-byte vectors. Two tilings, chosen from
//    N: WIDE gives each warp 16 rows (RE = 8, BN = 128, about one byte of
//    shared memory per FMA; with one output per thread it was three), for
//    blocks of more than 64 rows such as the all-entity launch. NARROW gives
//    each warp 4 rows (RE = 2, BN = 32): a 4,096-row store chunk leaves ~31
//    rows a block, which WIDE would hand to 2 of the 8 warps. At the end of
//    a tile the 8 k-groups' partials are added in a fixed shuffle tree, and
//    the tile's scores go through shared memory so that rows of `out` are
//    written with coalesced stores.
//  * Bank-conflict-free reads: the 8 lanes of a quarter-warp cover two
//    k-groups and two rows (or query rows) whose starts the row pitch puts
//    8 or 16 banks apart.
//  * The 16-byte copies need a 16-byte aligned table and rows of a multiple
//    of 16 bytes (d % 4 == 0 in fp32, d % 8 == 0 in bf16). Any other table
//    (odd d, a slice such as e[1:]) takes the element-load variant: the same
//    kernel whose producers load elements into registers and store them to
//    an fp32 ring. Neither is the plain version; repro_scoring_aligned says
//    which one a table takes.
//
// Each output is the fixed tree over 8 k-group partials, each one fp32
// chain (fmaf for dot; a subtract and an add of |.| for l1) over its
// elements in order. Which elements a k-group owns depends only on d and the
// input dtype, so the bits of out[b, n] depend only on q[b], e[n], d and the
// dtype: not on B, N, the row's place in the table, the block, the tiling or
// the variant. A chunk of rows scores bitwise the same as those columns of
// the all-entity launch, and a query alone as its row in a batch. No atomics.
//
// ptxas -v (sm_90a, -O3): every instantiation 168 registers (the cap for 384
// threads), no spills. Shared memory per block at d = 400: WIDE 185,152 bytes
// (fp32 ring), 119,616 (bf16 ring); NARROW 68,416 (fp32 ring). One block per
// SM.
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;                // consumer warps
constexpr int CONSUMERS = WARPS * 32;
constexpr int PRODUCERS = 128;          // one warpgroup issues the copies
constexpr int THREADS = CONSUMERS + PRODUCERS;
// 384 threads launch with 168 registers each; the producer warpgroup hands
// most of its share to the two consumer warpgroups.
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536, "register file");
constexpr int SLICE = 64;              // elements of d per row per slice: 8 k-groups x 8
constexpr int RQ = 8;                  // queries per lane
constexpr int QT = 2 * RQ;             // query rows of a block: two query groups
constexpr int WIDE = 16, NARROW = 4;   // entity rows per warp of the two tilings
constexpr int STAGES = 4;              // slices in the ring
constexpr int QPAD = 8;                // q row padding in floats
constexpr int MAX_DEVICES = 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Row pitch of a ring slice in bytes, for a ring of S holding inputs of T.
// A ring of T is the slice plus 32 bytes, 72 (fp32) or 40 (bf16) words,
// 8 mod 32; an fp32 ring of bf16 inputs is the slice plus 64 bytes, 80 words,
// 16 mod 32. Either way the rows a quarter-warp reads together start in
// banks that its k-groups' 16-byte reads do not share.
template <typename S, typename T>
__host__ __device__ constexpr int pitch() {
  return SLICE * static_cast<int>(sizeof(S)) + (sizeof(S) == 4 && sizeof(T) == 2 ? 64 : 32);
}
template <typename S, typename T, int BN>
__host__ __device__ constexpr int ring_bytes() { return STAGES * BN * pitch<S, T>(); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
// Arrive on `bar` once all of this thread's earlier cp.async have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// The consumer warps' own barrier (the producers never join it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// One level of the k-group reduction: lanes kg and kg ^ M (4·M lanes apart)
// add H of their values each; the lane whose bit M is set keeps the upper half.
template <int H, int M>
__device__ __forceinline__ void fold(float* a, int kg) {
  const bool up = kg & M;
#pragma unroll
  for (int t = 0; t < H; ++t) {
    const float send = up ? a[t] : a[t + H], keep = up ? a[t + H] : a[t];
    a[t] = keep + __shfl_xor_sync(0xffffffffu, send, M * 4);
  }
}

// Where k-group kg's 8 elements of a slice sit, as two halves h = 0, 1 of 4
// elements; returns the half's first element within the slice. The split
// depends on the input dtype T alone, so both variants sum the same elements
// in the same order. fp32: half h is float4 8h + kg, so a quarter-warp's two
// k-groups read adjacent float4. bf16: kg owns the 16-byte chunk kg
// (elements 8kg..8kg+7) and half h is its h-th 4 elements; q rows keep the
// matching float4 pair (2kg, 2kg + 1) with its halves swapped in the upper
// half of each slice, so those reads still hit distinct banks.
template <typename T>
__device__ __forceinline__ int half_elem(int kg, int h) {
  return sizeof(T) == 2 ? 8 * kg + 4 * h : 4 * (8 * h + kg);
}
template <typename T>
__device__ __forceinline__ int q_slot(int c) {  // c: float4 index in a q row
  return sizeof(T) == 2 ? c ^ ((c >> 3) & 1) : c;
}

// MODE: 0 dot, 1 l1. T: input dtype. ALIGNED: 16-byte cp.async of `e` into a
// ring of T, else element loads into a ring of fp32. WN: entity rows per
// consumer warp (WIDE or NARROW). W: elements of d per q window (a multiple
// of SLICE).
template <int MODE, typename T, bool ALIGNED, int WN>
__global__ void __launch_bounds__(THREADS, 1)
scoring_kernel(const T* __restrict__ q, const T* __restrict__ e,
               float* __restrict__ out, int B, int N, int d, int W, float gamma) {
  using S = typename std::conditional<ALIGNED, T, float>::type;  // ring element
  constexpr int RE = WN / 2;             // entities per lane (2 entity groups)
  constexpr int BN = WARPS * WN;         // entity rows per tile
  constexpr int OSP = BN + 4;            // row pitch of the output tile in floats
  constexpr int PITCH = pitch<S, T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int QP = W + QPAD;               // q row pitch in floats
  float* qs = reinterpret_cast<float*>(smem + ring_bytes<S, T, BN>());  // [QT][QP]
  float* os = qs + QT * QP;                                      // [QT][OSP]
  uint64_t* full = reinterpret_cast<uint64_t*>(os + QT * OSP);  // [STAGES]
  uint64_t* empty = full + STAGES;                               // [STAGES]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.y * QT;
  const int r_lo = static_cast<int>(static_cast<long long>(blockIdx.x) * N / gridDim.x);
  const int r_hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * N / gridDim.x);
  const int slices = max(1, cdiv(d, SLICE));
  const int iters = cdiv(r_hi - r_lo, BN) * slices;

  // The query tile's columns [k0, k0 + W) as fp32 rows, zero past B and d,
  // staged by the consumers. Each starts KPER loads in every one of the 16
  // rows before it stores any, so a window of up to KPER·CONSUMERS columns
  // costs one memory latency; neighbouring threads read neighbouring columns.
  auto stage_q = [&](int k0) {
    constexpr int KPER = 2;
    for (int kb = 0; kb < W; kb += KPER * CONSUMERS) {
      float v[KPER][QT];
#pragma unroll
      for (int u = 0; u < KPER; ++u) {
        const int k = kb + u * CONSUMERS + tid;
#pragma unroll
        for (int b = 0; b < QT; ++b)
          v[u][b] = (k < W && k0 + k < d && b0 + b < B)
                        ? repro::to_f32(q[static_cast<size_t>(b0 + b) * d + k0 + k]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < KPER; ++u) {
        const int k = kb + u * CONSUMERS + tid;
        if (k < W) {
          float* col = qs + q_slot<T>(k >> 2) * 4 + (k & 3);
#pragma unroll
          for (int b = 0; b < QT; ++b) col[b * QP] = v[u][b];
        }
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // Producers: slice `it` (tile it / slices, d-slice it % slices) into ring
    // stage it % STAGES once the consumers have released that stage; each
    // producer thread arrives on the stage's `full` barrier when its own
    // copies have landed.
    const int pt = tid - CONSUMERS;
    for (int it = 0; it < iters; ++it) {
      const int stage = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[stage], (it / STAGES - 1) & 1);
      const int t = it / slices, k0 = (it - t * slices) * SLICE;
      const int row0 = r_lo + t * BN, rows = min(BN, r_hi - row0), kw = min(SLICE, d - k0);
      unsigned char* st = smem + stage * BN * PITCH;
      if constexpr (ALIGNED) {
        constexpr int VEC = 16 / sizeof(T), CH = SLICE / VEC;  // 16-byte chunks a row
        for (int c = pt; c < rows * CH; c += PRODUCERS) {
          const int r = c / CH, ch = c % CH;
          if (ch * VEC < kw)
            cp_async16(st + r * PITCH + ch * 16, e + static_cast<size_t>(row0 + r) * d + k0 + ch * VEC);
        }
        cp_async_arrive(&full[stage]);
      } else {
        constexpr int PER = 16;  // loads in flight per thread
        for (int base = 0; base < BN * SLICE; base += PER * PRODUCERS) {
          float v[PER];
#pragma unroll
          for (int u = 0; u < PER; ++u) {
            const int c = base + pt + u * PRODUCERS, r = c / SLICE, k = c % SLICE;
            v[u] = (r < rows && k < kw) ? repro::to_f32(e[static_cast<size_t>(row0 + r) * d + k0 + k]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < PER; ++u) {
            const int c = base + pt + u * PRODUCERS;
            reinterpret_cast<float*>(st + (c / SLICE) * PITCH)[c % SLICE] = v[u];
          }
        }
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // Consumers. Lane (kg, eg, qg) = (lane >> 2, lane & 1, (lane >> 1) & 1):
  // k-group kg of each slice, entities eg + 2j of the warp's WN, queries
  // qg + 2i of the block's 16. The 8 lanes of a quarter-warp cover two
  // k-groups, so their 16-byte reads of e and q share rows and fall in
  // distinct banks.
  const int kg = lane >> 2, eg = lane & 1, qg = (lane >> 1) & 1;
  auto erow = [&](int j) { return warp * WN + eg + 2 * j; };
  auto qrow = [&](int i) { return qg + 2 * i; };
  // q by the consumers alone, while the producers already stream `e`.
  stage_q(0);
  consumers_sync();
  float acc[RQ * RE];  // [query i][entity j]: this lane's k-group's partial sums
#pragma unroll
  for (int u = 0; u < RQ * RE; ++u) acc[u] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int stage = it % STAGES;
    const int t = it / slices, s = it - t * slices, k0 = s * SLICE;
    const int row0 = r_lo + t * BN, rows = min(BN, r_hi - row0), kw = min(SLICE, d - k0);
    if (W < d && it > 0 && k0 % W == 0) {  // next q window
      consumers_sync();
      stage_q(k0);
      consumers_sync();
    }
    mbar_wait(&full[stage], (it / STAGES) & 1);
    if (warp * WN < rows) {  // warp-uniform
      const unsigned char* st = smem + stage * BN * PITCH;
      const float4* qw = reinterpret_cast<const float4*>(qs);
      const int c0 = (k0 % W) / 4;  // the slice's first float4 in a q row
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        // A half lies wholly inside d or wholly past it (aligned fp32 rings
        // have d % 4 == 0, bf16 rings d % 8 == 0, element rings zero-fill).
        // A half past d was not copied and is skipped.
        const int el = half_elem<T>(kg, h);
        if (el >= kw) continue;
        float4 ev[RE];
#pragma unroll
        for (int j = 0; j < RE; ++j) {
          const unsigned char* row = st + erow(j) * PITCH;
          if constexpr (sizeof(S) == 2) {
            const uint2 u = *reinterpret_cast<const uint2*>(row + el * 2);
            ev[j] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                                __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
          } else {
            ev[j] = *reinterpret_cast<const float4*>(row + el * 4);
          }
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float4 qv = qw[qrow(i) * (QP / 4) + q_slot<T>(c0 + el / 4)];
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int j = 0; j < RE; ++j) {
              const float qk = c == 0 ? qv.x : c == 1 ? qv.y : c == 2 ? qv.z : qv.w;
              const float ek = c == 0 ? ev[j].x : c == 1 ? ev[j].y : c == 2 ? ev[j].z : ev[j].w;
              float& a = acc[i * RE + j];
              if constexpr (MODE == 0) a = fmaf(qk, ek, a);
              else a += fabsf(qk - ek);
            }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage

    if (s == slices - 1) {
      // The tile's last slice: add the 8 k-groups' partials in a fixed tree,
      // ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), leaving lane kg
      // with query kr = bitreverse3(kg) for its RE entities; the tile's
      // scores go through shared memory so that rows of `out` are written
      // with coalesced stores.
      if (warp * WN < rows) {
        constexpr int N0 = RQ * RE;
        fold<N0 / 2, 1>(acc, kg);
        fold<N0 / 4, 2>(acc, kg);
        fold<N0 / 8, 4>(acc, kg);
        const int kr = ((kg & 1) << 2) | (kg & 2) | ((kg >> 2) & 1);
#pragma unroll
        for (int j = 0; j < RE; ++j)
          os[qrow(kr) * OSP + erow(j)] = acc[j];
#pragma unroll
        for (int u = 0; u < RQ * RE; ++u) acc[u] = 0.f;
      }
      consumers_sync();
      for (int i = tid; i < QT * BN; i += CONSUMERS) {
        const int b = i / BN, r = i % BN;
        if (b0 + b < B && r < rows) {
          const float v = os[b * OSP + r];
          out[static_cast<size_t>(b0 + b) * N + row0 + r] = MODE == 0 ? gamma + v : gamma - v;
        }
      }
      consumers_sync();
    }
  }
}

struct DeviceInfo {
  int sms, smem;  // SM count, shared memory a block may opt into
};

int device_info(int dev, DeviceInfo* info) {
  static std::atomic<int> sms[MAX_DEVICES], optin[MAX_DEVICES];
  int s = sms[dev].load(std::memory_order_acquire);
  if (s == 0) {
    int o = 0;
    cudaError_t err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    optin[dev].store(o, std::memory_order_relaxed);
    sms[dev].store(s, std::memory_order_release);
  }
  *info = {s, optin[dev].load(std::memory_order_relaxed)};
  return 0;
}

bool aligned(const void* e, int d, int dtype) {
  const int elt = dtype == repro::kBF16 ? 2 : 4;
  return reinterpret_cast<uintptr_t>(e) % 16 == 0 && (static_cast<long long>(d) * elt) % 16 == 0;
}

// The tiling the kernel takes for N rows: WIDE, unless a block's share of the
// rows under it (one block per SM) would keep at most half of its consumer
// warps busy; then NARROW, whose tiles of 32 rows spread a block's rows over
// all 8 warps.
int tile_for(int N, const DeviceInfo& info) {
  return cdiv(N, info.sms) <= WARPS * WIDE / 2 ? NARROW : WIDE;
}

template <int MODE, typename T, bool ALIGNED, int WN>
int launch(const void* q, const void* e, float* out, int B, int N, int d,
           float gamma, int dev, const DeviceInfo& info, cudaStream_t stream) {
  using S = typename std::conditional<ALIGNED, T, float>::type;
  constexpr int BN = WARPS * WN, OSP = BN + 4, RING = ring_bytes<S, T, BN>();
  // The q window: all of d where it fits beside the ring, else the most
  // whole slices that do (rows of W + QPAD floats).
  const int fit = ((info.smem - RING - 2 * STAGES * 8) / (QT * 4) - QPAD - OSP) / SLICE * SLICE;
  if (fit < SLICE) return static_cast<int>(cudaErrorInvalidValue);
  const int W = std::min(fit, std::max(SLICE, cdiv(d, SLICE) * SLICE));
  const size_t smem = RING + static_cast<size_t>(QT) * (W + QPAD + OSP) * 4 + 2 * STAGES * 8;
  auto kernel = scoring_kernel<MODE, T, ALIGNED, WN>;
  static std::atomic<bool> opted[MAX_DEVICES];
  if (!opted[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(std::min(info.sms, cdiv(N, WN)), cdiv(B, QT));
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(e),
                                          out, B, N, d, W, gamma);
  return static_cast<int>(cudaGetLastError());
}

int current_device(int* dev, DeviceInfo* info) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  return device_info(*dev, info);
}

// tile: WIDE or NARROW, or 0 for tile_for's choice.
template <int MODE, typename T>
int dispatch(const void* q, const void* e, float* out, int B, int N, int d,
             float gamma, int dtype, int tile, cudaStream_t stream) {
  int dev = 0;
  DeviceInfo info;
  if (const int rc = current_device(&dev, &info)) return rc;
  if (tile == 0) tile = tile_for(N, info);
  const bool al = aligned(e, d, dtype);
  if (tile == NARROW) {
    return al ? launch<MODE, T, true, NARROW>(q, e, out, B, N, d, gamma, dev, info, stream)
              : launch<MODE, T, false, NARROW>(q, e, out, B, N, d, gamma, dev, info, stream);
  }
  if (tile != WIDE) return static_cast<int>(cudaErrorInvalidValue);
  return al ? launch<MODE, T, true, WIDE>(q, e, out, B, N, d, gamma, dev, info, stream)
            : launch<MODE, T, false, WIDE>(q, e, out, B, N, d, gamma, dev, info, stream);
}

}  // namespace

// mode: 0 = dot, 1 = l1. dtype: repro::DType of q and e. tile: entity rows
// per consumer warp, 16 or 4, or 0 for the kernel's own choice from N (the
// bits of every score are the same under either). Returns the CUDA error of
// the launch (0 = success).
extern "C" int repro_scoring_tiled(const void* q, const void* e, float* out, int B,
                                   int N, int d, float gamma, int mode, int dtype,
                                   int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0 && dtype == repro::kF32) return dispatch<0, float>(q, e, out, B, N, d, gamma, dtype, tile, s);
  if (mode == 1 && dtype == repro::kF32) return dispatch<1, float>(q, e, out, B, N, d, gamma, dtype, tile, s);
  if (mode == 0 && dtype == repro::kBF16)
    return dispatch<0, __nv_bfloat16>(q, e, out, B, N, d, gamma, dtype, tile, s);
  if (mode == 1 && dtype == repro::kBF16)
    return dispatch<1, __nv_bfloat16>(q, e, out, B, N, d, gamma, dtype, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_scoring(const void* q, const void* e, float* out, int B,
                             int N, int d, float gamma, int mode, int dtype,
                             void* stream) {
  return repro_scoring_tiled(q, e, out, B, N, d, gamma, mode, dtype, 0, stream);
}

// The entity rows per consumer warp the kernel takes for N rows on the
// current device (16 or 4), or minus a CUDA error.
extern "C" int repro_scoring_tile(int N) {
  int dev = 0;
  DeviceInfo info;
  if (const int rc = current_device(&dev, &info)) return -rc;
  return tile_for(N, info);
}

// 1 if a table `e` of row length d takes the 16-byte cp.async variant, 0 if
// it takes the element-load one.
extern "C" int repro_scoring_aligned(const void* e, int d, int dtype) {
  return aligned(e, d, dtype) ? 1 : 0;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
