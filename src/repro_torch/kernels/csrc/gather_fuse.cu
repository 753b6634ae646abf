// Semantic entity fusion (Eq. 11 + 12) for Hopper (sm_90a), on the tensor
// cores in 3xTF32.
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
// for fp32 or bf16 tables (one dtype for both) and fp32 weights.
//
// What bounds it. A row carries 2·(dl·dp + (d+dp)·d) flops (502k at d = 400,
// dl = 1024, dp = 64) against 7.3 KB of fp32 rows. In 3xTF32 a multiply-add
// costs three TF32 products, so at n = E the work needs 0.046 ms of the
// card's 495 TFLOP/s dense TF32 against 0.033 ms for its bytes: bound by
// operations.
//
// 3xTF32. Each fp32 operand x splits as hi = tf32(x), lo = tf32(x − hi),
// both rounded to nearest (ties away) in software, so hi's low 13 bits are
// zero and x − hi is exact. a·b is taken as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
// (a_lo·b_lo, ~2^-22 of a·b, is dropped): for every k8 step three wgmma
// into the fp32 accumulator in that fixed order, the small terms first. A
// bf16 table value is exact in TF32, so its lo is 0 and h·Wf_h and z·Wp take
// two products; zp, fp32, takes three. The A operand (rows of z, h or zp)
// is split in registers as it is read; each weight slice once, as it lands
// in shared memory.
//
// Route: wgmma with A from registers and B from shared memory (m64n200k8
// for the fusion, m64n64k8 for the projection). wgmma takes tf32 B only
// K-major: the producer writes each weight slice, which is stored [K, N],
// K-major into the ring as it splits it, so no transposed copy of the
// weights is needed. (An mma.sync m16n8k8 version did not beat the plain
// version at n = E: the legacy instruction falls far short of the TF32
// rate; PERF.md has the numbers.)
//
// Structure, warp-specialised. Weight slices (BK = 16 rows of Wp or of one
// PASS = 200-column pass of Wf) go through a ring of 3-4 stages with full
// and empty mbarriers: a producer warpgroup loads each slice into
// registers a slice ahead, splits it and stores the hi and lo tiles; the
// consumer warpgroups copy their own A rows into the same stage with
// cp.async, S - 1 slices ahead, then read and split A and run the
// stage's wgmmas. zp (BM × dp fp32) stays in shared memory and is the A
// operand of the fusion's last slices: the concat never exists. The
// epilogue (+ bf, the sigmoid, ×2 − 1, the cast) runs on the accumulator.
//  * gather_fuse_kernel, where BM = 64-row tiles alone fill the card (n = E):
//    a block takes two tiles, one per consumer, and both consume one stream
//    of weight slices, so the weights are split once per 128 rows.
//  * gather_fuse_split_kernel otherwise (a 4,096-row chunk, 48 anchors): a
//    block takes one tile and one column pass; its consumers split the
//    projection (consumer c sums half c of dl) and consumer 0 fuses the
//    pass, so that a block's chain of slices is shorter and more SMs take
//    part.
// One launch a call either way; the launch may also name the kernel (the
// autotuner's knob, kernels/autotune.py). Given a zp buffer (training saves it for
// the backward), each block also writes its rows' zp there from shared
// memory (in the split kernel, the blocks of column pass 0); out's bits do
// not change, and with a null zp nothing is written.
//
// Rows stay bitwise. zp = (p0 + p1) + bp, p0 and p1 each one chain over a
// fixed half of dl (the split depends on dl only); an output element is one
// chain over h's k8 steps, then zp's, then + bf. Both kernels run the same
// wgmma shapes on the same operands in the same order; past the data, A and
// B hold zeros, which add nothing. So a row's bits depend only on its
// inputs, d, dl, dp and the dtype: not on n, the kernel, the tile, or the
// layout its semantic row came from. Its place inside the m64 tile changes
// with the ids it comes with; the tensor cores compute each row alike,
// which tests/test_torch_gpu.py checks at every offset. No atomics. An id
// outside its table gives a NaN row instead of an out-of-bounds read.
//
// ptxas -v (-O3, sm_90a): gather_fuse_kernel 166 (fp32) / 162 (bf16)
// registers, gather_fuse_split_kernel 157 / 152, no spills, at the 384-thread
// cap of 168; dynamic shared memory at d = 400, dp = 64: 178,176 and
// 219,136 bytes a block.
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64;           // rows of a consumer: one wgmma m64 tile
constexpr int BROWS = 2 * BM;    // rows of a block: one tile per consumer
constexpr int WG = 128;          // threads of a warpgroup
constexpr int PT = WG;           // producer threads
constexpr int THREADS = 2 * WG + PT;  // two consumer warpgroups, then the producer
constexpr int PASS = 200;        // output columns of a fusion pass (m64n200k8)
constexpr int PN = 64;           // projection columns of one wgmma (m64n64k8)
constexpr int BK = 16;           // depth of a slice: 2 k8 steps
constexpr int S = 4;             // stages of the ring
constexpr int CORE = 128;        // bytes of a core matrix: 8 rows of 16 bytes
constexpr int TILE = PASS * BK * 4;    // bytes of a hi (or lo) weight tile
constexpr int GROUPS = (PASS / 8 + 3) / 4;  // 8-column weight groups a producer warp moves
constexpr int MAX_DEVICES = 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int x, int m) { return cdiv(x, m) * m; }

// Dynamic shared memory, in bytes: a ring of S stages, each the weight
// slice split into a hi and a lo tile (K-major) and each consumer's A tile
// (BM rows of a BK slice of z or h, pitch BK plus 16 bytes so the eight rows
// of an A fragment start in different banks); then zp of the block's rows.
template <typename T>
struct Layout {
  int a_pitch, a_tile, stage, zw, zp_pitch, zp_off, total;
  __host__ __device__ explicit Layout(int dp) {
    a_pitch = BK + 16 / static_cast<int>(sizeof(T));
    a_tile = round_up(BM * a_pitch * static_cast<int>(sizeof(T)), CORE);
    stage = 2 * TILE + 2 * a_tile;
    zw = round_up(dp, PN);
    zp_pitch = zw + 4;
    zp_off = S * stage;
    total = zp_off + BROWS * zp_pitch * 4;
  }
};

struct Args {
  const long long* ids;
  const long long* sem_ids;
  const void* h_str;
  const void* h_sem;
  const float* wp;
  const float* bp;
  const float* wf;
  const float* bf;
  void* out;
  int n;
  long long n_str, n_sem;
  int d, dl, dp;
  int vec;  // table rows take 16-byte copies
  float* zp;  // [n, dp]: where to store zp, or null
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or zeros when !valid (src is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// Ask L2 to fetch `bytes` (a multiple of 16) at a 16-byte aligned `src`.
__device__ __forceinline__ void prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive on `bar` once this thread's earlier cp.async have landed.
__device__ __forceinline__ void mbar_arrive_cp(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Make this thread's shared stores visible to wgmma's operand reads.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across the async
// wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma descriptor of a K-major tile without swizzle: core matrices of 8
// rows (output columns) by 16 bytes (4 k); the next 4 k sit LBO = 128 bytes
// on, the next 8 columns SBO = BK / 4 core matrices on.
__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t lbo = CORE >> 4, sbo = (BK / 4 * CORE) >> 4;
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32);
}

// Round to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero; the low 13 bits of the result are zero. Finite inputs only.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {  // a bf16 value: exact in TF32
    hi = __float_as_uint(x);
    lo = 0;
  } else {
    hi = tf32_bits(x);
    lo = tf32_bits(x - __uint_as_float(hi));
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_tf32<200>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99}, {%100, %101, %102, %103}, %104, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc)
      : "memory");
}


// One k8 step of an A fragment (rows g and g + 8 of the warp's 16, columns
// t and t + 4 of the step), read from shared memory and split.
template <bool EXACT, typename TA>
__device__ __forceinline__ void load_a(const TA* p, int pitch, int g, int t, uint32_t* hi,
                                       uint32_t* lo) {
  p += g * pitch + t;
  split<EXACT>(repro::to_f32(p[0]), hi[0], lo[0]);
  split<EXACT>(repro::to_f32(p[8 * pitch]), hi[1], lo[1]);
  split<EXACT>(repro::to_f32(p[4]), hi[2], lo[2]);
  split<EXACT>(repro::to_f32(p[8 * pitch + 4]), hi[3], lo[3]);
}
// acc += a·b for one k8 step in 3xTF32: a_lo·b_hi, a_hi·b_lo, a_hi·b_hi, in
// that order (the first skipped where a is exact).
template <int N, bool EXACT>
__device__ __forceinline__ void mma3(float* acc, const uint32_t* ah, const uint32_t* al,
                                     uint64_t bh, uint64_t bl) {
  if constexpr (!EXACT) wgmma_tf32<N>(acc, al, bh);
  wgmma_tf32<N>(acc, ah, bl);
  wgmma_tf32<N>(acc, ah, bh);
}

// The epilogue of a fusion pass, from the accumulator fragments of a
// consumer's rows r0.. and columns c0..: + bf, the sigmoid, ×2 − 1, the
// cast; a NaN row for a bad id.
template <typename T>
__device__ __forceinline__ void store_out(const Args& a, const float* acc, const int* bad, int r0,
                                          int c0, int warp, int g, int t) {
  T* out = static_cast<T*>(a.out);
  const int d = a.d;
#pragma unroll
  for (int j = 0; j < PASS / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = 16 * warp + g + 8 * hh, i = r0 + rl, col = c0 + 8 * j + 2 * t;
      if (i >= a.n || col >= d) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = acc[4 * j + 2 * hh + e] + a.bf[min(col + e, d - 1)];
        v[e] = bad[rl] ? NAN : __fdividef(2.f, 1.f + __expf(-y)) - 1.f;
      }
      T* o = out + (size_t)i * d + col;
      if (col + 1 < d && (d & 1) == 0) {
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
        o[0] = repro::from_f32<T>(v[0]);
        if (col + 1 < d) o[1] = repro::from_f32<T>(v[1]);
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) gather_fuse_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long hrow[BROWS], zrow[BROWS];
  __shared__ int bad[BROWS];
  __shared__ uint64_t full[S], empty[S];
  constexpr bool EXACT_T = sizeof(T) == 2;  // bf16 tables: exact in TF32
  constexpr int EPC = 16 / sizeof(T);       // table elements per 16-byte copy
  const Layout<T> L(a.dp);
  const T* h_str = static_cast<const T*>(a.h_str);
  const T* h_sem = static_cast<const T*>(a.h_sem);
  float* zps = reinterpret_cast<float*>(smem + L.zp_off);
  const int tid = threadIdx.x, wg = tid / WG, wt = tid % WG, warp = wt / 32, lane = tid & 31;
  const int d = a.d, dl = a.dl, dp = a.dp;

  // The slices every consumer takes, in order: the projection (PN-column
  // chunks; in each, half 0 of dl, then half 1 — the split depends on dl
  // only), then the fusion passes (PASS columns each: h's k8 steps, then
  // zp's).
  const int dl_half = round_up(cdiv(dl, 2), BK);
  const int np0 = cdiv(min(dl, dl_half), BK), np1 = dl > dl_half ? cdiv(dl - dl_half, BK) : 0;
  const int chunks = L.zw / PN, nproj = chunks * (np0 + np1);
  const int sh = cdiv(d, BK), per_pass = sh + cdiv(dp, BK);
  const int ns = nproj + cdiv(d, PASS) * per_pass;
  struct Slice {
    bool proj, zpart;
    int chunk, half, k0, pass;  // k0: first k of the slice within its source
  };
  auto slice = [&](int s) {
    Slice x{};
    if (s < nproj) {
      const int np = np0 + np1, r = s % np;
      x.proj = true;
      x.chunk = s / np;
      x.half = r < np0 ? 0 : 1;
      x.k0 = x.half * dl_half + (x.half ? r - np0 : r) * BK;
    } else {
      const int f = (s - nproj) % per_pass;
      x.pass = (s - nproj) / per_pass;
      x.zpart = f >= sh;
      x.k0 = (x.zpart ? f - sh : f) * BK;
    }
    return x;
  };
  auto stage_of = [&](int st) { return smem + st * L.stage; };

  if (tid < BROWS) {
    const int i = blockIdx.x * BROWS + tid;
    long long h = -1, z = -1;
    int b = 0;
    if (i < a.n) {
      h = a.ids[i];
      z = a.sem_ids[i];
      if (h < 0 || h >= a.n_str || z < 0 || z >= a.n_sem) {
        h = z = -1;
        b = 1;
      }
    }
    hrow[tid] = h;
    zrow[tid] = z;
    bad[tid] = b;
  }
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], PT + 2 * WG);  // producer stores, both consumers' row copies
      mbar_init(&empty[st], 2 * WG);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: splits each weight slice into the ring --------------------
    // A slice is BK rows of Wp or Wf over PN or PASS columns, moved in
    // groups of 8 columns: lane (nq, q) of a warp takes column nq of a group
    // and k rows 4q..4q+3 (32-byte row segments a load across the warp),
    // splits them and stores 16 bytes each of the hi and the lo tile, where
    // they sit together in wgmma's K-major layout. The next slice is loaded
    // into registers while this one is stored.
    const int nq = lane % 8, q = lane / 8, b_off = q * CORE + nq * 16;
    float pre[GROUPS][4];
    auto load_w = [&](int s) {
      const Slice x = slice(s);
      const float* w = x.proj ? a.wp : x.zpart ? a.wf + (size_t)d * d : a.wf;
      const int ld = x.proj ? dp : d, col0 = x.proj ? x.chunk * PN : x.pass * PASS;
      const int krows = x.proj ? (x.half ? dl : min(dl, dl_half)) : x.zpart ? dp : d;
      const int groups = x.proj ? PN / 8 : PASS / 8;
#pragma unroll
      for (int it = 0; it < GROUPS; ++it) {
        const int grp = warp + 4 * it, col = col0 + 8 * grp + nq;
        const bool ok = grp < groups && col < ld;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = x.k0 + 4 * q + j;
          pre[it][j] = ok && k < krows ? w[(size_t)k * ld + col] : 0.f;
        }
      }
    };
    auto store_w = [&](int s) {
      const int groups = slice(s).proj ? PN / 8 : PASS / 8;
      unsigned char* base = stage_of(s % S);
#pragma unroll
      for (int it = 0; it < GROUPS; ++it) {
        const int grp = warp + 4 * it;
        if (grp >= groups) break;
        uint4 h, l;
        split<false>(pre[it][0], h.x, l.x);
        split<false>(pre[it][1], h.y, l.y);
        split<false>(pre[it][2], h.z, l.z);
        split<false>(pre[it][3], h.w, l.w);
        unsigned char* dst = base + grp * (BK / 4 * CORE) + b_off;
        *reinterpret_cast<uint4*>(dst) = h;
        *reinterpret_cast<uint4*>(dst + TILE) = l;
      }
    };
    // Everything the block reads, in the order it reads it, towards L2:
    // one block alone, or the first wave, would otherwise wait on device
    // memory slice by slice.
    {
      constexpr unsigned PIECE = 16384;
      const unsigned wp_bytes = (unsigned)dl * dp * 4, wf_bytes = (unsigned)(d + dp) * d * 4;
      if (a.vec) {
        prefetch_l2(h_sem + (zrow[wt] < 0 ? 0 : zrow[wt]) * dl, dl * sizeof(T));
        prefetch_l2(h_str + (hrow[wt] < 0 ? 0 : hrow[wt]) * d, d * sizeof(T));
      }
      if ((reinterpret_cast<uintptr_t>(a.wp) & 15) == 0 && wp_bytes % 16 == 0)
        for (unsigned off = wt * PIECE; off < wp_bytes; off += WG * PIECE)
          prefetch_l2(reinterpret_cast<const char*>(a.wp) + off, min(PIECE, wp_bytes - off));
      if ((reinterpret_cast<uintptr_t>(a.wf) & 15) == 0 && wf_bytes % 16 == 0)
        for (unsigned off = wt * PIECE; off < wf_bytes; off += WG * PIECE)
          prefetch_l2(reinterpret_cast<const char*>(a.wf) + off, min(PIECE, wf_bytes - off));
    }
    if (ns > 0) load_w(0);
    for (int s = 0; s < ns; ++s) {
      if (s >= S) mbar_wait(&empty[s % S], ((s / S) - 1) & 1);
      store_w(s);
      fence_async();
      mbar_arrive(&full[s % S]);
      if (s + 1 < ns) load_w(s + 1);
    }
    return;
  }

  // ---- consumers: consumer c owns rows 64c.. of the block's 128 -----------
  const int c = wg;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BROWS + c * BM;
  const long long* my_h = hrow + c * BM;
  const long long* my_z = zrow + c * BM;
  float* my_zp = zps + c * BM * L.zp_pitch;
  auto wait_full = [&](int s) { mbar_wait(&full[s % S], (s / S) & 1); };
  auto a_tile = [&](int s) { return reinterpret_cast<T*>(stage_of(s % S) + 2 * TILE + c * L.a_tile); };
  // This consumer's BM rows (`rows`, of length len) over columns
  // [k0, k0 + BK) ∩ [0, kmax) into its A tile of slice s: 16-byte cp.async,
  // zeros outside the data; each thread arrives on the stage once its copies
  // have landed (at once for zp slices, whose A is zp itself). Started S - 1
  // slices ahead.
  auto copy_a = [&](int s) {
    if (s >= ns) return;
    uint64_t* bar = &full[s % S];
    const Slice x = slice(s);
    if (!x.proj && x.zpart) {
      mbar_arrive(bar);
      return;
    }
    T* dst = a_tile(s);
    const T* table = x.proj ? h_sem : h_str;
    const long long* rows = x.proj ? my_z : my_h;
    const long long len = x.proj ? dl : d;
    const int kmax = x.proj ? (x.half ? dl : min(dl, dl_half)) : d;
    if (a.vec) {
      constexpr int per_row = BK / EPC, per_thread = BM * per_row / WG;
#pragma unroll
      for (int j = 0; j < per_thread; ++j) {
        const int i = wt + j * WG, r = i / per_row, k = x.k0 + (i % per_row) * EPC;
        const long long row = rows[r];
        const bool ok = row >= 0 && k < kmax;
        cp16(dst + r * L.a_pitch + (k - x.k0), ok ? table + row * len + k : table, ok);
      }
      mbar_arrive_cp(bar);
    } else {
      for (int i = wt; i < BM * BK; i += WG) {
        const int r = i / BK, k = x.k0 + i % BK;
        const long long row = rows[r];
        dst[r * L.a_pitch + (k - x.k0)] =
            row >= 0 && k < kmax ? table[row * len + k] : repro::from_f32<T>(0.f);
      }
      mbar_arrive(bar);
    }
  };
  // One slice: A read and split, both k8 steps' wgmmas (past the data A and
  // B hold zeros, which add nothing, so no branch stands between the
  // wgmmas), then the stage released.
  auto step = [&](int s, float* acc, auto n, const auto* at, int pitch, auto exact) {
    constexpr int N = decltype(n)::value;
    constexpr bool EXACT = decltype(exact)::value;
    copy_a(s + S - 1);
    wait_full(s);
    const unsigned char* base = stage_of(s % S);
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) load_a<EXACT>(at + 8 * kk, pitch, g, t, ah[kk], al[kk]);
    fence_regs<N / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      mma3<N, EXACT>(acc, ah[kk], al[kk], desc(base + kk * 2 * CORE), desc(base + TILE + kk * 2 * CORE));
    wgmma_commit();
    wgmma_wait();
    fence_regs<N / 2>(acc);
    mbar_arrive(&empty[s % S]);
  };
  using PN_ = std::integral_constant<int, PN>;
  using PASS_ = std::integral_constant<int, PASS>;
  using EXACT_ = std::integral_constant<bool, EXACT_T>;
  for (int s = 0; s < S - 1; ++s) copy_a(s);

  // Projection: p0 over half 0 of dl, p1 over half 1, each its own chain;
  // zp = (p0 + p1) + bp.
  int s = 0;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    float p[2][PN / 2];
#pragma unroll
    for (int j = 0; j < PN / 2; ++j) p[0][j] = p[1][j] = 0.f;
    for (int i = 0; i < np0; ++i, ++s)
      step(s, p[0], PN_(), a_tile(s) + 16 * warp * L.a_pitch, L.a_pitch, EXACT_());
    for (int i = 0; i < np1; ++i, ++s)
      step(s, p[1], PN_(), a_tile(s) + 16 * warp * L.a_pitch, L.a_pitch, EXACT_());
#pragma unroll
    for (int j = 0; j < PN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e >> 1), col = chunk * PN + 8 * j + 2 * t + (e & 1);
        my_zp[r * L.zp_pitch + col] = col < dp ? (p[0][4 * j + e] + p[1][4 * j + e]) + a.bp[col] : 0.f;
      }
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG) : "memory");  // zp of this tile stored
  if (a.zp)
    for (int idx = wt; idx < BM * dp; idx += WG) {
      const int r = idx / dp, col = idx % dp, i = r0 + r;
      if (i < a.n) a.zp[(size_t)i * dp + col] = my_zp[r * L.zp_pitch + col];
    }

  // Fusion, pass by pass: one m64n200 accumulator chain over the k8 steps
  // of h (A from the ring), then of zp (A from shared memory).
  for (int c0 = 0; c0 < d; c0 += PASS) {
    float acc[PASS / 2];
#pragma unroll
    for (int j = 0; j < PASS / 2; ++j) acc[j] = 0.f;
    for (int i = 0; i < sh; ++i, ++s)
      step(s, acc, PASS_(), a_tile(s) + 16 * warp * L.a_pitch, L.a_pitch, EXACT_());
    for (int i = 0; i < per_pass - sh; ++i, ++s)
      step(s, acc, PASS_(), my_zp + 16 * warp * L.zp_pitch + i * BK, L.zp_pitch, std::false_type());
    store_out<T>(a, acc, bad + c * BM, r0, c0, warp, g, t);
  }
}

// The same arithmetic for few rows: a block for each BM-row tile and
// column pass, whose two consumers split the projection — consumer c sums
// half c of dl — and consumer 0 fuses pass blockIdx.y, so that a small n
// keeps more SMs busy and each block's chain of slices is short. Each
// consumer has its own ring, filled by two producer warps.
constexpr int SPT = 64;                          // producer threads per consumer
constexpr int SS = 3;                            // stages of a consumer's ring
constexpr int SGROUPS = (PASS / 8 + 1) / 2;      // weight groups a producer warp moves

template <typename T>
struct SplitLayout {
  int a_pitch, a_tile, stage, zw, zp_pitch, zp_off, part_off, total;
  __host__ __device__ explicit SplitLayout(int dp) {
    a_pitch = BK + 16 / static_cast<int>(sizeof(T));
    a_tile = round_up(BM * a_pitch * static_cast<int>(sizeof(T)), CORE);
    stage = 2 * TILE + a_tile;
    zw = round_up(dp, PN);
    zp_pitch = zw + 4;
    zp_off = 2 * SS * stage;
    part_off = zp_off + BM * zp_pitch * 4;
    total = part_off + BM * zp_pitch * 4;
  }
};

template <typename T>
__global__ void __launch_bounds__(2 * WG + 2 * SPT, 1) gather_fuse_split_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long hrow[BM], zrow[BM];
  __shared__ int bad[BM];
  __shared__ uint64_t full[2][SS], empty[2][SS];
  constexpr bool EXACT_T = sizeof(T) == 2;
  constexpr int EPC = 16 / sizeof(T);
  const SplitLayout<T> L(a.dp);
  const T* h_str = static_cast<const T*>(a.h_str);
  const T* h_sem = static_cast<const T*>(a.h_sem);
  float* zps = reinterpret_cast<float*>(smem + L.zp_off);
  float* part = reinterpret_cast<float*>(smem + L.part_off);
  const int tid = threadIdx.x, wg = tid / WG, wt = tid % WG, warp = wt / 32, lane = tid & 31;
  const int r0 = blockIdx.x * BM;
  const int d = a.d, dl = a.dl, dp = a.dp;

  // Consumer c's slices: half c of dl (the same split as the other kernel)
  // in PN-column chunks, then (consumer 0) the block's pass.
  const int dl_half = round_up(cdiv(dl, 2), BK);
  const int chunks = L.zw / PN, sh = cdiv(d, BK), per_pass = sh + cdiv(dp, BK);
  auto kb_of = [&](int c) { return c * dl_half; };
  auto ke_of = [&](int c) { return min(dl, c * dl_half + dl_half); };
  auto np_of = [&](int c) { return ke_of(c) > kb_of(c) ? cdiv(ke_of(c) - kb_of(c), BK) : 0; };
  auto c0_of = [&](int c) { return c == 0 ? static_cast<int>(blockIdx.y) * PASS : d; };
  auto ns_of = [&](int c) { return chunks * np_of(c) + (c0_of(c) < d ? per_pass : 0); };
  auto stage_of = [&](int c, int st) { return smem + (c * SS + st) * L.stage; };

  if (tid < BM) {
    const int i = r0 + tid;
    long long h = -1, z = -1;
    int b = 0;
    if (i < a.n) {
      h = a.ids[i];
      z = a.sem_ids[i];
      if (h < 0 || h >= a.n_str || z < 0 || z >= a.n_sem) {
        h = z = -1;
        b = 1;
      }
    }
    hrow[tid] = h;
    zrow[tid] = z;
    bad[tid] = b;
  }
  if (tid == 0) {
    for (int c = 0; c < 2; ++c)
      for (int st = 0; st < SS; ++st) {
        mbar_init(&full[c][st], SPT + WG);  // producer stores, consumer row copies
        mbar_init(&empty[c][st], WG);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producers: warps 0-1 fill consumer 0's ring, warps 2-3 consumer 1's,
    // moving weights as the other kernel's producer does.
    const int pc = warp / 2, pw = warp % 2, pt = wt % SPT;
    const int nq = lane % 8, q = lane / 8, b_off = q * CORE + nq * 16;
    const int npc = np_of(pc), nproj = chunks * npc, ns = ns_of(pc), c0 = c0_of(pc);
    float pre[SGROUPS][4];
    auto load_w = [&](int s) {
      const bool proj = s < nproj, zpart = !proj && s - nproj >= sh;
      const float* w = proj ? a.wp : zpart ? a.wf + (size_t)d * d : a.wf;
      const int ld = proj ? dp : d, col0 = proj ? (s / max(npc, 1)) * PN : c0;
      const int k0 = proj ? kb_of(pc) + (s % max(npc, 1)) * BK : (zpart ? s - nproj - sh : s - nproj) * BK;
      const int krows = proj ? ke_of(pc) : zpart ? dp : d, groups = proj ? PN / 8 : PASS / 8;
#pragma unroll
      for (int it = 0; it < SGROUPS; ++it) {
        const int grp = pw + 2 * it, col = col0 + 8 * grp + nq;
        const bool ok = grp < groups && col < ld;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + 4 * q + j;
          pre[it][j] = ok && k < krows ? w[(size_t)k * ld + col] : 0.f;
        }
      }
    };
    auto store_w = [&](int s) {
      const int groups = s < nproj ? PN / 8 : PASS / 8;
      unsigned char* base = stage_of(pc, s % SS);
#pragma unroll
      for (int it = 0; it < SGROUPS; ++it) {
        const int grp = pw + 2 * it;
        if (grp >= groups) break;
        uint4 h, l;
        split<false>(pre[it][0], h.x, l.x);
        split<false>(pre[it][1], h.y, l.y);
        split<false>(pre[it][2], h.z, l.z);
        split<false>(pre[it][3], h.w, l.w);
        unsigned char* dst = base + grp * (BK / 4 * CORE) + b_off;
        *reinterpret_cast<uint4*>(dst) = h;
        *reinterpret_cast<uint4*>(dst + TILE) = l;
      }
    };
    {
      constexpr unsigned PIECE = 16384;
      const unsigned wp_bytes = (unsigned)dl * dp * 4, wf_bytes = (unsigned)(d + dp) * d * 4;
      if (a.vec && pt < BM) {
        if (pc == 0) prefetch_l2(h_sem + (zrow[pt] < 0 ? 0 : zrow[pt]) * dl, dl * sizeof(T));
        else prefetch_l2(h_str + (hrow[pt] < 0 ? 0 : hrow[pt]) * d, d * sizeof(T));
      }
      if (pc == 0 && (reinterpret_cast<uintptr_t>(a.wp) & 15) == 0 && wp_bytes % 16 == 0)
        for (unsigned off = pt * PIECE; off < wp_bytes; off += SPT * PIECE)
          prefetch_l2(reinterpret_cast<const char*>(a.wp) + off, min(PIECE, wp_bytes - off));
      if (pc == 1 && (reinterpret_cast<uintptr_t>(a.wf) & 15) == 0 && wf_bytes % 16 == 0)
        for (unsigned off = pt * PIECE; off < wf_bytes; off += SPT * PIECE)
          prefetch_l2(reinterpret_cast<const char*>(a.wf) + off, min(PIECE, wf_bytes - off));
    }
    if (ns > 0) load_w(0);
    for (int s = 0; s < ns; ++s) {
      if (s >= SS) mbar_wait(&empty[pc][s % SS], ((s / SS) - 1) & 1);
      store_w(s);
      fence_async();
      mbar_arrive(&full[pc][s % SS]);
      if (s + 1 < ns) load_w(s + 1);
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  const int c = wg;
  const int g = lane >> 2, t = lane & 3;
  const int npc = np_of(c), nproj = chunks * npc, ns = ns_of(c);
  auto wait_full = [&](int s) { mbar_wait(&full[c][s % SS], (s / SS) & 1); };
  auto a_tile = [&](int s) { return reinterpret_cast<T*>(stage_of(c, s % SS) + 2 * TILE); };
  auto copy_a = [&](int s) {
    if (s >= ns) return;
    uint64_t* bar = &full[c][s % SS];
    const bool proj = s < nproj;
    if (!proj && s - nproj >= sh) {
      mbar_arrive(bar);
      return;
    }
    T* dst = a_tile(s);
    const T* table = proj ? h_sem : h_str;
    const long long* rows = proj ? zrow : hrow;
    const long long len = proj ? dl : d;
    const int k0 = proj ? kb_of(c) + (s % npc) * BK : (s - nproj) * BK, kmax = proj ? ke_of(c) : d;
    if (a.vec) {
      constexpr int per_row = BK / EPC, per_thread = BM * per_row / WG;
#pragma unroll
      for (int j = 0; j < per_thread; ++j) {
        const int i = wt + j * WG, r = i / per_row, k = k0 + (i % per_row) * EPC;
        const long long row = rows[r];
        const bool ok = row >= 0 && k < kmax;
        cp16(dst + r * L.a_pitch + (k - k0), ok ? table + row * len + k : table, ok);
      }
      mbar_arrive_cp(bar);
    } else {
      for (int i = wt; i < BM * BK; i += WG) {
        const int r = i / BK, k = k0 + i % BK;
        const long long row = rows[r];
        dst[r * L.a_pitch + (k - k0)] =
            row >= 0 && k < kmax ? table[row * len + k] : repro::from_f32<T>(0.f);
      }
      mbar_arrive(bar);
    }
  };
  auto step = [&](int s, float* acc, auto n, const auto* at, int pitch, auto exact) {
    constexpr int N = decltype(n)::value;
    constexpr bool EXACT = decltype(exact)::value;
    copy_a(s + SS - 1);
    wait_full(s);
    const unsigned char* base = stage_of(c, s % SS);
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) load_a<EXACT>(at + 8 * kk, pitch, g, t, ah[kk], al[kk]);
    fence_regs<N / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      mma3<N, EXACT>(acc, ah[kk], al[kk], desc(base + kk * 2 * CORE), desc(base + TILE + kk * 2 * CORE));
    wgmma_commit();
    wgmma_wait();
    fence_regs<N / 2>(acc);
    mbar_arrive(&empty[c][s % SS]);
  };
  using PN_ = std::integral_constant<int, PN>;
  using PASS_ = std::integral_constant<int, PASS>;
  using EXACT_ = std::integral_constant<bool, EXACT_T>;
  for (int s = 0; s < SS - 1; ++s) copy_a(s);

  // Projection: this consumer's half; p0 lands in zp, p1 in part, then
  // zp = (p0 + p1) + bp.
  int s = 0;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    float p[PN / 2];
#pragma unroll
    for (int j = 0; j < PN / 2; ++j) p[j] = 0.f;
    for (int i = 0; i < npc; ++i, ++s)
      step(s, p, PN_(), a_tile(s) + 16 * warp * L.a_pitch, L.a_pitch, EXACT_());
    float* dst = (c == 0 ? zps : part) + chunk * PN;
#pragma unroll
    for (int j = 0; j < PN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(16 * warp + g + 8 * (e >> 1)) * L.zp_pitch + 8 * j + 2 * t + (e & 1)] = p[4 * j + e];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
  for (int i = c * WG + wt; i < BM * L.zw; i += 2 * WG) {
    const int r = i / L.zw, col = i % L.zw;
    float* z = zps + r * L.zp_pitch + col;
    *z = col < dp ? (*z + part[r * L.zp_pitch + col]) + a.bp[col] : 0.f;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
  if (a.zp && blockIdx.y == 0)
    for (int idx = c * WG + wt; idx < BM * dp; idx += 2 * WG) {
      const int r = idx / dp, col = idx % dp, i = r0 + r;
      if (i < a.n) a.zp[(size_t)i * dp + col] = zps[r * L.zp_pitch + col];
    }
  if (nproj == ns) return;  // no pass for this consumer

  const int c0 = c0_of(c);
  float acc[PASS / 2];
#pragma unroll
  for (int j = 0; j < PASS / 2; ++j) acc[j] = 0.f;
  for (int i = 0; i < sh; ++i, ++s)
    step(s, acc, PASS_(), a_tile(s) + 16 * warp * L.a_pitch, L.a_pitch, EXACT_());
  for (int i = 0; i < per_pass - sh; ++i, ++s)
    step(s, acc, PASS_(), zps + 16 * warp * L.zp_pitch + i * BK, L.zp_pitch, std::false_type());
  // Epilogue through this consumer's ring (idle now) as a [BM][PASS] tile,
  // so that each row is stored 16 bytes a thread.
  constexpr int TP = PASS + 4;
  float* tile = reinterpret_cast<float*>(stage_of(c, 0));
  auto wg_sync = [&] { asm volatile("bar.sync %0, %1;\n" ::"r"(2 + c), "n"(WG) : "memory"); };
  wg_sync();
#pragma unroll
  for (int j = 0; j < PASS / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = 16 * warp + g + 8 * hh, col = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(tile + rl * TP + col) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  wg_sync();
  T* out = static_cast<T*>(a.out);
  const bool vec_out = (d & 3) == 0;
  for (int idx = wt; idx < BM * (PASS / 4); idx += WG) {
    const int rl = idx / (PASS / 4), col = (idx % (PASS / 4)) * 4, i = r0 + rl, oc = c0 + col;
    if (i >= a.n || oc >= d) continue;
    const float4 y = *reinterpret_cast<const float4*>(tile + rl * TP + col);
    float v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = bad[rl] ? NAN : __fdividef(2.f, 1.f + __expf(-(v[e] + a.bf[min(oc + e, d - 1)]))) - 1.f;
    T* o = out + (size_t)i * d + oc;
    if (vec_out && oc + 3 < d) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]), p1 = __floats2bfloat162_rn(v[2], v[3]);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&p0);
        u.y = *reinterpret_cast<uint32_t*>(&p1);
        *reinterpret_cast<uint2*>(o) = u;
      }
    } else {
      for (int e = 0; e < 4 && oc + e < d; ++e) o[e] = repro::from_f32<T>(v[e]);
    }
  }
}

// Once per device and table dtype: opt the kernel into all of a block's
// shared memory and read the SM count and that limit. Returns 0, or the
// CUDA error.
struct DeviceInfo {
  int sms, smem;
};
template <typename T>
int device_info(int dev, DeviceInfo* info) {
  static std::atomic<int> sms[MAX_DEVICES], smem[MAX_DEVICES];
  info->sms = sms[dev].load(std::memory_order_acquire);
  info->smem = smem[dev].load(std::memory_order_acquire);
  if (info->sms > 0) return 0;
  int optin = 0, v = 0, limit = 1 << 30;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const void* kernel : {reinterpret_cast<const void*>(gather_fuse_kernel<T>),
                             reinterpret_cast<const void*>(gather_fuse_split_kernel<T>)}) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    const int room = optin - static_cast<int>(attr.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    limit = std::min(limit, room);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem[dev].store(limit, std::memory_order_release);
  sms[dev].store(v, std::memory_order_release);
  *info = {v, limit};
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int current_info(DeviceInfo* info) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  return device_info<T>(dev, info);
}

// The kernel's own choice for n rows: where BM-row tiles alone would fill
// the card, two tiles a block share one stream of weight slices (BROWS rows
// a block); otherwise a block's two consumers split one tile's work (BM
// rows), so that more SMs take part.
int default_rows(int n, const DeviceInfo& info) { return cdiv(n, BM) > info.sms ? BROWS : BM; }

// rows: BROWS (the pair kernel), BM (the split kernel), or 0 for
// default_rows(n). A geometry that cannot launch returns its error; no
// other is tried.
template <typename T>
int launch(Args a, int rows, cudaStream_t stream) {
  DeviceInfo info;
  if (const int rc = current_info<T>(&info)) return rc;
  constexpr int EPC = 16 / sizeof(T);
  a.vec = a.d % EPC == 0 && a.dl % EPC == 0 && aligned16(a.h_str) && aligned16(a.h_sem);
  if (rows == 0) rows = default_rows(a.n, info);
  if (rows != BROWS && rows != BM) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == BROWS) {
    const int bytes = Layout<T>(a.dp).total;
    if (bytes > info.smem) return static_cast<int>(cudaErrorInvalidConfiguration);
    gather_fuse_kernel<T><<<cdiv(a.n, BROWS), THREADS, bytes, stream>>>(a);
  } else {
    const int bytes = SplitLayout<T>(a.dp).total;
    if (bytes > info.smem) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(cdiv(a.n, BM), cdiv(a.d, PASS));
    gather_fuse_split_kernel<T><<<grid, 2 * WG + 2 * SPT, bytes, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids, sem_ids [n] int64; h_str [n_str, d] and h_sem [n_sem, dl] of one
// dtype (repro::DType); wp [dl, dp], bp [dp], wf [d + dp, d], bf [d] fp32;
// zp: an [n, dp] fp32 buffer that receives z·Wp + bp of each row, or null;
// out [n, d] in the tables' dtype; rows: 128 (two 64-row tiles a block, the
// pair kernel), 64 (one tile and one column pass a block, the split
// kernel), or 0 for the kernel's own choice from n (the autotuner's knob:
// out and zp have the same bits under either). Returns the CUDA error of
// the launch (0 = success; cudaErrorInvalidConfiguration where the chosen
// kernel's shared memory does not fit a block).
extern "C" int repro_gather_fuse(const long long* ids, const long long* sem_ids,
                                 const void* h_str, const void* h_sem,
                                 const float* wp, const float* bp, const float* wf,
                                 const float* bf, float* zp, void* out, int n,
                                 long long n_str, long long n_sem, int d, int dl,
                                 int dp, int dtype, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const Args a{ids, sem_ids, h_str, h_sem, wp, bp, wf, bf, out, n, n_str, n_sem, d, dl, dp, 0, zp};
  if (dtype == repro::kF32) return launch<float>(a, rows, s);
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(a, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The rows a block that the kernel takes for n rows on the current device
// when given rows = 0 (128 or 64), or minus a CUDA error.
extern "C" int repro_gather_fuse_rows(int n) {
  DeviceInfo info;
  if (const int rc = current_info<float>(&info)) return -rc;
  return default_rows(n, info);
}
