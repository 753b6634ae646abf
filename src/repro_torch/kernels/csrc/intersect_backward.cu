// Backward of the cardinality-class attention intersection (Eq. 8/9) for
// Hopper (sm_90a), fp32, on the tensor cores in 3xTF32.
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
// What bounds it. Three products of M·d·hd multiply-adds each (M = n·k) —
// the recomputed x·W1 (depth d), dh·W1ᵀ (depth hd) and xᵀ·dh (depth M) —
// against x, g, dx, W1 and dW1. At fp32 accuracy the card's fastest route
// is 3xTF32 on the tensor cores (three TF32 products a multiply-add): at
// (n, k) = (512, 3), d = hd = 800, 17.7 GFLOP, 0.036 ms at 495 TFLOP/s; at
// (64, 2), the most common training pool, 0.003 ms. There latency bounds it
// instead: two of the products are 800 deep on only 128 rows, so one block
// a 64 × 64 tile would leave most of the card idle behind 800-deep chains,
// and every launch, DRAM trip and barrier counts.
//
// Design: two launches on the caller's stream, both of 8-block thread block
// clusters of one warpgroup (128 threads), with scratch the wrapper
// allocates.
//  1. pre_kernel, the forward's skeleton: a cluster takes one 64-unit hidden
//     block of one row group (whole pool rows, at most 64 input rows; passes
//     of 64 rows for k > 64) and its 8 blocks the 8 depth chunks of x·W1
//     (chunk length fixed by d alone). The blocks fold their partial tiles
//     in rank order through distributed shared memory, add b1, write
//     pre = x·W1 + b1 to scratch and sum relu(pre)·w2 over each 32-unit
//     tile into one partial logit per (tile, row); the group's warps also
//     take <g_p, x_m> over each depth chunk, a (row, chunk) pair each. Each
//     block then takes an arrival ticket for its row group; the cluster
//     holding the group's last ticket adds up the logits and datt, takes
//     the softmax and writes att and dlogit [M] to scratch.
//  2. grad_kernel, roles by cluster index:
//     * dW1 clusters: xᵀ·dh in 64 × 64 tiles over [d + 1, hd], a block a
//       tile over all M rows (at the training pools, M ≤ 1,536, splitting
//       that depth over blocks timed no faster) — row d of the extended xᵀ
//       is ones, so db1 = sum dh rides along as one more output row. The
//       blocks of tile row 0 also chain dw2 = sum_m relu(pre)·dlogit from
//       the slices they hold, under their wgmmas; the first also db2 =
//       sum dlogit.
//     * dx clusters: a 64-row × 64-column tile of dh·W1ᵀ, its 8 blocks the
//       8 depth chunks of hd (fixed by hd alone), folded in rank order, then
//       dx = att·g + the fold.
//     dh = dlogit·w2 ⊙ [pre > 0] is made from pre as its operand is read.
//
// Products: wgmma m64n64k8 TF32 with fp32 accumulation, the block's
// warpgroup on its 64 × 64 tile. Each fp32 operand x splits as hi =
// tf32(x), lo = tf32(x − hi), rounded to nearest (ties away) in software,
// and every k8 step adds a_lo·b_hi, a_hi·b_lo, a_hi·b_hi in that order
// (a_lo·b_lo, ~2^-22 of a·b, is dropped). Slices of 32 deep land raw with
// cp.async in a 2-stage ring (one in flight while one is multiplied), so
// that four blocks fit an SM: at the training pools the grids are a few
// waves of clusters, and a fourth block a SM saves a wave. A's
// fragments are made, split and held in registers as each warp reads its
// 16 rows, and B is made and split once a slice into K-major hi and lo
// tiles — wgmma takes TF32 only K-major, and two of the three products
// read B transposed. Not mma.sync m16n8k8: on this card its TF32 rate left
// the products no faster than the fp32 FMAs they replace (PERF.md). Each
// chunk's first wgmma starts the accumulator from 0 (its scale-d off), so
// no other instruction writes the accumulator and the wgmmas pipeline.
//
// What holds it now (PERF.md has the numbers): at small pools each block's
// chain of latencies (the first slice's load, two barriers a slice, the
// cluster folds, the ticket and the group's tail); at large ones the work
// each slice puts on the SM's issue slots — A and B made (dh) and split in
// software, about five operations a value, and the slice's barriers — not
// its traffic: 128-row tiles on two warpgroups sharing B timed the same.
//
// Fixed-order sums: each wgmma accumulates in the order the hardware fixes,
// the same for every row of a tile; a chunk's chain runs over its k8 steps
// in order from 0 (steps past the data multiply zeros); chunks fold in rank
// order from 0: ((0 + c0) + c1) + ... The logit of a row adds its 32-unit
// tiles' sums (each a fixed xor tree) by lane-strided chains and the same
// tree, then b2; datt adds its 8 chunk partials (each lane-strided chains
// and the tree) in chunk order; the softmax and dlogit are chains in k
// order; dw2 is two chains a column over alternate rows, added in order,
// and db2 chains over rows i (mod 128), xor trees and the warps in order.
// So a row of dx depends only on its own pool row, whatever the pool. The
// only atomic operation is taking a ticket, which decides which cluster
// finishes a row group and orders no sum: two calls on the same inputs give
// the same bits. The tickets (one counter per row group) live in a buffer
// the wrapper keeps per stream, apart from the forward's; the group's last
// cluster resets its counter, so no launch clears them.
//
// ptxas -v (-O3, sm_90a): 128 registers each (the bound of four blocks an
// SM); pre_kernel spills 76 bytes, grad_kernel none; 48 bytes of static
// shared memory (pre_kernel); dynamic shared memory at d = hd = 800: 54,528
// bytes (pre_kernel, a 64-row group) and 54,288 (grad_kernel) a block.
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNKS = 8;       // blocks of a cluster: depth chunks folded in order
constexpr int BM = 64;          // rows of a block tile; input rows of a row group
constexpr int BN = 64;          // columns of a block tile
constexpr int KS = 32;          // depth of a slice
constexpr int THREADS = 128;    // one warpgroup: warp w holds rows 16w.. of a tile
constexpr int PK = KS + 4;      // pitch of an operand slice stored [64][KS] (depth-major)
constexpr int PR = BN + 8;      // pitch of one stored [KS][64], and of a partial tile
constexpr int OPER = BM * PK;   // floats of an operand slice, either layout
static_assert(BM * PK == KS * PR, "both operand layouts take the same bytes");
constexpr int NACC = BM * BN / THREADS;  // accumulator floats a thread
constexpr int CORE = 128;       // bytes of a core matrix: 8 rows of 16 bytes
constexpr int BTILE = BN * KS;  // floats of a K-major B tile (hi or lo) of a slice
constexpr int NST = 2;          // stages of a block's cp.async ring
constexpr int STAGE = 2 * OPER + KS;  // an A and a B slice, and a vector along their depth
constexpr int RING = NST * STAGE;
constexpr int BLOCKS_PER_SM = 4;  // what ~55 KB of shared memory a block allows
constexpr int HT = 32;          // hidden units of a logit tile: one a lane
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return cdiv(a, b) * b; }
// Depth of a chunk when `depth` is cut in `parts`: a whole number of k8 steps.
__host__ __device__ inline int chunk_len(int depth, int parts) {
  return round_up(cdiv(depth, parts), 8);
}
// Pool rows of a row group: whole pool rows of at most BM inputs, or one.
__host__ __device__ inline int group_rows(int k) { return k >= BM ? 1 : BM / k; }

struct Args {
  const float *x, *g, *w1, *b1, *w2, *b2;
  float* pre;            // [M, hd]: x·W1 + b1
  float* partial;        // [T, Mp]: partial logits, one per (32-unit tile, row)
  float* pdatt;          // [CHUNKS, Mp]: <g_p, x_m> over each depth chunk of d
  float* att;            // [M]
  float* dlogit;         // [M]
  unsigned* counters;    // [groups], zero between launches
  float *dx, *dw1, *db1, *dw2, *db2;
  int n, k, d, hd, M, Mp, T, Mmax, vec;
  int n_dw1;             // clusters of the dW1 role
};

// ------------------------------------------------------------ 3xTF32 wgmma

// Round to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero; the low 13 bits of the result are zero. Finite inputs only.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(r[i])::"memory");
}


// wgmma descriptor of a K-major B tile without swizzle: core matrices of 8
// columns by 16 bytes (4 k); the next 4 k sit LBO = 128 bytes on, the next
// 8 columns SBO = KS / 4 core matrices on.
__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t lbo = CORE >> 4, sbo = (KS / 4 * CORE) >> 4;
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32);
}
// acc[64 × 64] = A (registers: the warp's 16 rows × 8 k) · B (desc), plus
// acc where `add`.
__device__ __forceinline__ void wgmma64(float* d, const uint32_t* a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add)
      : "memory");
}
// acc += a·b for one k8 step in 3xTF32: a_lo·b_hi, a_hi·b_lo, a_hi·b_hi, in
// that order (the small terms first); `first` starts acc from 0 instead
// (no other instruction writes the accumulator, so the wgmmas pipeline).
__device__ __forceinline__ void mma3(float* acc, const uint32_t* ah, const uint32_t* al,
                                     uint64_t bh, uint64_t bl, bool first) {
  wgmma64(acc, al, bh, !first);
  wgmma64(acc, ah, bl, 1);
  wgmma64(acc, ah, bh, 1);
}

// Element (i, kk) of a raw operand slice in shared memory: i its index
// across the tile (a row of A, a column of B), kk its depth. DEPTH_MAJOR:
// stored [64][PK] with the depth contiguous; else [KS][PR], the tile index
// contiguous. Both pitches put the 32 reads of a warp in 32 banks.
template <bool DEPTH_MAJOR>
__device__ __forceinline__ float op_at(const float* s, int i, int kk) {
  return DEPTH_MAJOR ? s[i * PK + kk] : s[kk * PR + i];
}

// What an operand takes from a stored element v at (i, kk); sv is the
// slice's vector along its depth (see the loaders).
struct Plain {
  __device__ float operator()(float v, int, int, const float*) const { return v; }
};
// dh = dlogit·w2 where pre > 0, else 0 (relu's gradient is 0 at 0), from
// stored pre, as A of the dx role: i a row of the tile (dlogit in sdl), kk
// the depth (w2 of the slice in sv).
struct DhByRow {
  const float* sdl;
  __device__ float operator()(float v, int i, int kk, const float* sv) const {
    return v > 0.f ? __fmul_rn(sdl[i], sv[kk]) : 0.f;
  }
};
// The same as B of the dW1 role: kk a row (dlogit of the slice in sv), i a
// column of the tile (w2 in sw2).
struct DhByCol {
  const float* sw2;
  __device__ float operator()(float v, int i, int kk, const float* sv) const {
    return v > 0.f ? __fmul_rn(sv[kk], sw2[i]) : 0.f;
  }
};
// xᵀ with a row of ones at index `one` (db1's row), as A of the dW1 role.
struct OnesRow {
  int one;
  __device__ float operator()(float v, int i, int, const float*) const {
    return i == one ? 1.f : v;
  }
};

// B of a slice, stored raw, into its K-major hi and lo tiles (bt, bt +
// BTILE): thread unit (column n, k quad q) — a warp's 32 columns at one q,
// so that both its raw reads and its 16-byte tile stores meet no bank
// conflict.
template <bool DB, class TB>
__device__ __forceinline__ void split_b(const float* Bs, const float* sv, const TB& tb,
                                        float* bt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = threadIdx.x + THREADS * i;
    const int n = u % 32 + 32 * (u / 256), q = (u / 32) % 8;
    float v[4];
    if constexpr (DB) {  // the 4 k of a unit lie together: one 16-byte read
      const float4 w = *reinterpret_cast<const float4*>(Bs + n * PK + 4 * q);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = op_at<false>(Bs, n, 4 * q + j);
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split(tb(v[j], n, 4 * q + j, sv), h[j], l[j]);
    const int off = (n / 8) * (KS / 4 * CORE) + q * CORE + (n % 8) * 16;
    unsigned char* p = reinterpret_cast<unsigned char*>(bt) + off;
    *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(p + BTILE * 4) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The warp's A fragment of k8 step kk: rows 16·warp + g (+ 8), k = kk + t
// (+ 4), made and split.
template <bool DA, class TA>
__device__ __forceinline__ void load_a(const float* As, const float* sv, const TA& ta, int kk,
                                       uint32_t* ah, uint32_t* al) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4, q = kk + lane % 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int rr = r + 8 * (e & 1), qq = q + 4 * (e >> 1);
    split(ta(op_at<DA>(As, rr, qq), rr, qq, sv), ah[e], al[e]);
  }
}

// The thread's accumulator elements: acc[4j + 2hh + e] is row 16·warp + g +
// 8·hh, column 8j + 2t + e of the 64 × 64 tile.
__device__ __forceinline__ void store_tile(float* tile, const float* acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(tile + (16 * warp + g + 8 * hh) * PR + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

// ------------------------------------------------------------- loaders
//
// A slice's operand is 512 units of 4 floats, 4 a thread: depth-major
// [64][KS], rows t / 8 + 16·i at depth 4·(t % 8); else [KS][64], depth
// t / 16 + 8·i at columns 4·(t % 16) (t the thread, i < 4). issue() starts the
// thread's cp.async copies of the slice at depth [k0, k0 + KS), data below
// kend; where `along` is set, the slice's vector along its depth
// (along[k0 + kk]) is copied too. Every element past the data lands as 0.

__device__ __forceinline__ int clamp4(int c) { return c < 0 ? 0 : (c > 4 ? 4 : c); }

// cnt elements from src to dst, zeros after: one 16-byte copy where vec
// (src then 16-byte aligned), else four of 4 bytes. `base` stands in for
// src where nothing is read.
__device__ __forceinline__ void cp_unit(float* dst, const float* src, int cnt, int vec,
                                        const float* base) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(cnt > 0 ? src : base), "r"(4 * cnt)
                 : "memory");
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s + 4 * e),
                   "l"(e < cnt ? src + e : base), "r"(e < cnt ? 4 : 0)
                   : "memory");
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void issue_along(const float* along, float* sv, int k0, int kend,
                                            int vec) {
  if (along != nullptr && threadIdx.x < KS / 4) {
    const int k = k0 + 4 * threadIdx.x;
    cp_unit(sv + 4 * threadIdx.x, along + k, clamp4(kend - k), vec, along);
  }
}

// Rows [r0, r0 + rows) of a row-major matrix p (row stride ld), the depth
// along a row: a depth-major slice (A of pre_kernel: x; A of the dx role:
// pre, with w2 along the depth; B of the dx role: W1 read as W1ᵀ). The
// thread's 4 units share their depth offset kq and lie 16 rows apart.
struct RowsByDepth {
  static constexpr bool kDepthMajor = true;
  const float* p;
  int ld, r0, rows, vec;
  const float* along;
  __device__ void issue(float* s, float* sv, int k0, int kend) const {
    const int r = threadIdx.x / 8, kq = 4 * (threadIdx.x % 8);
    const int cnt = clamp4(kend - k0 - kq);
    const float* src = p + static_cast<size_t>(r0 + r) * ld + k0 + kq;
    float* dst = s + r * PK + kq;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_unit(dst + 16 * i * PK, src + static_cast<size_t>(16 * i) * ld,
              r + 16 * i < rows ? cnt : 0, vec, p);
    issue_along(along, sv, k0, kend, vec);
  }
};

// Rows of a row-major matrix p (row stride ld) as the depth, columns
// [c0, cols) across: a slice with the tile index contiguous (B of
// pre_kernel: W1; A of the dW1 role: x read as xᵀ; B of the dW1 role: pre,
// with dlogit along the depth). The thread's 4 units share their columns
// and lie 8 rows apart.
struct DepthByCols {
  static constexpr bool kDepthMajor = false;
  const float* p;
  int ld, c0, cols, vec;
  const float* along;
  __device__ void issue(float* s, float* sv, int k0, int kend) const {
    const int kd = threadIdx.x / 16, c = c0 + 4 * (threadIdx.x % 16);
    const int cnt = clamp4(cols - c);
    const float* src = p + static_cast<size_t>(k0 + kd) * ld + c;
    float* dst = s + kd * PR + 4 * (threadIdx.x % 16);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_unit(dst + 8 * i * PR, src + static_cast<size_t>(8 * i) * ld,
              k0 + kd + 8 * i < kend ? cnt : 0, vec, p);
    issue_along(along, sv, k0, kend, vec);
  }
};

// A block's share of a product: depth [k0, kend), one chain from 0. Slices
// of KS go through a ring of NST stages, NST - 1 in flight while one is
// multiplied; B of each is split into its tiles once, A as each warp reads
// it. prep() runs once the first slices are on their way (it may fill
// caches the operands read: the first barrier below orders it); each slice
// goes to on_slice(stage, valid depth) as well, while its wgmmas run. `any`:
// the block has a tile. Ends with the ring free (the partial tile may take its bytes).
struct NoSlice {
  __device__ void operator()(const float*, int) const {}
};
template <class LA, class LB, class TA, class TB, class Prep, class OnSlice>
__device__ __forceinline__ void product(const LA& la, const LB& lb, const TA& ta, const TB& tb,
                                        int k0, int kend, bool any, float* smem, float* acc,
                                        Prep prep, OnSlice& on_slice) {
  float* bt = smem + RING;
  const int ns = any ? cdiv(kend - k0, KS) : 0;
  auto issue = [&](int f) {
    float* st = smem + (f % NST) * STAGE;
    la.issue(st, st + 2 * OPER, k0 + f * KS, kend);
    lb.issue(st + OPER, st + 2 * OPER, k0 + f * KS, kend);
  };
#pragma unroll
  for (int f = 0; f < NST - 1; ++f) {
    if (f < ns) issue(f);
    cp_commit();
  }
  prep();
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  // Every k8 step of a slice runs, past the data too (zeros add nothing):
  // no branch stands between the wgmmas.
  for (int f = 0; f < ns; ++f) {
    cp_wait<NST - 2>();
    __syncthreads();  // slice f has landed; every warp is done with slice f - 1
    if (f + NST - 1 < ns) issue(f + NST - 1);
    cp_commit();
    const float* st = smem + (f % NST) * STAGE;
    split_b<LB::kDepthMajor>(st + OPER, st + 2 * OPER, tb, bt);
    fence_async();
    __syncthreads();  // the B tiles are whole
    uint32_t ah[KS / 8][4], al[KS / 8][4];
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk)
      load_a<LA::kDepthMajor>(st, st + 2 * OPER, ta, 8 * kk, ah[kk], al[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk)
      mma3(acc, ah[kk], al[kk], desc(bt + kk * 2 * CORE / 4),
           desc(bt + BTILE + kk * 2 * CORE / 4), f == 0 && kk == 0);
    wgmma_commit();
    on_slice(st, min(KS, kend - k0 - f * KS));  // while the wgmmas run
    wgmma_wait();
    fence_regs(acc);
  }
  cp_wait<0>();
  __syncthreads();
}

// Four sums of the partial tiles of cluster ranks base..base+parts-1 at (row rr,
// columns cc..cc+3), added in rank order from 0.
__device__ __forceinline__ float4 fold4(float* tile, int base, int parts, int rr, int cc) {
  cg::cluster_group cluster = cg::this_cluster();
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < parts; ++r) {
    const float4 p =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, base + r) + rr * PR + cc);
    s.x = __fadd_rn(s.x, p.x);
    s.y = __fadd_rn(s.y, p.y);
    s.z = __fadd_rn(s.z, p.z);
    s.w = __fadd_rn(s.w, p.w);
  }
  return s;
}
__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// Fixed xor tree over the 32 lanes; every lane gets the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Shared memory of a block, in floats: the ring (whose start the block's
// partial tile [64][PR] takes once a product is done); the B tiles, hi
// and lo; then a role's own cache: pre_kernel's b1 and w2 of its units
// and the tail's logits and datt; the dx role's dlogit of its rows; the dW1
// role's w2 of its columns and its dw2 and db2 partials.
constexpr int AUX = RING + 2 * BTILE;
static_assert(BM * PR <= RING, "the partial tile takes the ring's bytes");
inline int pre_smem(int Mmax) { return AUX + 2 * BN + 2 * Mmax; }
inline int grad_smem() { return AUX + 3 * BN + THREADS / 32; }

// ---------------------------------------------------------- pre_kernel

// <g_p, x_m> over each depth chunk c of d for rows m in [m0, m0 + rows),
// into pdatt[c][m]: a warp a (row, chunk) pair, the group's warps taking
// the pairs in turn, BATCH at once (loads first); lane-strided chains, then
// the xor tree.
__device__ void datt_partials(const Args& a, int m0, int rows) {
  constexpr int NW = THREADS / 32, BATCH = 4, PER = 4;  // PER: chunk_len(800, 8) / 32 rounded up
  const int lane = threadIdx.x % 32, nw = gridDim.x * NW;
  const int wi = blockIdx.x * NW + threadIdx.x / 32;
  const int CH = chunk_len(a.d, CHUNKS), pairs = rows * CHUNKS;
  for (int p0 = wi; p0 < pairs; p0 += nw * BATCH) {
    float s[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      s[b] = 0.f;
      const int pr = p0 + b * nw;
      if (pr >= pairs) continue;
      const int m = m0 + pr % rows, c = pr / rows;
      const int k0 = min(c * CH, a.d), ke = min(k0 + CH, a.d);
      const float* xr = a.x + static_cast<size_t>(m) * a.d;
      const float* gr = a.g + static_cast<size_t>(m / a.k) * a.d;
      float xv[PER], gv[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int col = k0 + lane + 32 * i;
        xv[i] = col < ke ? xr[col] : 0.f;
        gv[i] = col < ke ? gr[col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) s[b] = fmaf(gv[i], xv[i], s[b]);
      for (int col = k0 + lane + 32 * PER; col < ke; col += 32) s[b] = fmaf(gr[col], xr[col], s[b]);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const float v = warp_sum(s[b]);
      const int pr = p0 + b * nw;
      if (lane == 0 && pr < pairs)
        __stcg(a.pdatt + static_cast<size_t>(pr / rows) * a.Mp + m0 + pr % rows, v);
    }
  }
}

// The tail of a row group, run by one block of the group's last cluster:
// logit_m = b2 + the partial logits of the T tiles (lane-strided chains,
// then the xor tree; a warp loads 8 rows' partials before it sums any),
// datt_m = the chunk partials in order, then for each pool row the softmax,
// s = sum_q att_q datt_q and dlogit_q = att_q (datt_q - s), in q order.
__device__ void group_tail(const Args& a, int m0, int gp, float* lg, float* da) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int NW = THREADS / 32;
  const int Mg = gp * a.k;
  const float b2 = a.b2[0];
  for (int mb = warp; mb < Mg; mb += 8 * NW) {
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int t0 = 0; t0 < a.T; t0 += 32) {
      const int t = t0 + lane;
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = mb + i * NW;
        p[i] = (m < Mg && t < a.T) ? __ldcg(a.partial + static_cast<size_t>(t) * a.Mp + m0 + m)
                                   : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = __fadd_rn(s[i], p[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = warp_sum(s[i]);
      if (lane == 0 && mb + i * NW < Mg) lg[mb + i * NW] = __fadd_rn(v, b2);
    }
  }
  for (int m = threadIdx.x; m < Mg; m += THREADS) {
    float p[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) p[c] = __ldcg(a.pdatt + static_cast<size_t>(c) * a.Mp + m0 + m);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) s = __fadd_rn(s, p[c]);
    da[m] = s;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < gp; r += THREADS) {
    const float* l = lg + r * a.k;
    const float* dd = da + r * a.k;
    float mx = -INFINITY;
    for (int q = 0; q < a.k; ++q) mx = fmaxf(mx, l[q]);
    float sum = 0.f;
    for (int q = 0; q < a.k; ++q) sum = __fadd_rn(sum, expf(__fsub_rn(l[q], mx)));
    float s = 0.f;
    for (int q = 0; q < a.k; ++q) {
      const float at = __fdiv_rn(expf(__fsub_rn(l[q], mx)), sum);
      s = fmaf(at, dd[q], s);
    }
    for (int q = 0; q < a.k; ++q) {
      const size_t m = static_cast<size_t>(m0) + r * a.k + q;
      const float at = __fdiv_rn(expf(__fsub_rn(l[q], mx)), sum);
      a.att[m] = at;
      a.dlogit[m] = __fmul_rn(at, __fsub_rn(dd[q], s));
    }
  }
}

// Cluster (hidden block hb = blockIdx.x / CHUNKS, row group blockIdx.y) of
// CHUNKS blocks, block c = cluster rank taking depth chunk c of x·W1; then
// pre = the chunks' sum in rank order + b1, the partial logits, datt's
// chunk partials (spread over the group's blocks), a ticket, and the
// group's tail.
__global__ void __cluster_dims__(CHUNKS, 1, 1) __launch_bounds__(THREADS, BLOCKS_PER_SM)
pre_kernel(Args a) {
  constexpr int NW = THREADS / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned seen[CHUNKS];  // each cluster block's arrival ticket
  __shared__ unsigned ticket;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int hb = blockIdx.x / CHUNKS, grp = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = group_rows(a.k), p0 = grp * G, gp = min(G, a.n - p0);
  const int Mg = gp * a.k, m0 = p0 * a.k;
  const int CH = chunk_len(a.d, CHUNKS), k0 = min(c * CH, a.d), kend = min(k0 + CH, a.d);
  const int j0 = hb * BN;
  float* tile = smem;      // the ring's bytes, once a product is done
  float* bw = smem + AUX;  // b1, then w2, of the block's units
  float acc[NACC];
  NoSlice none;
  for (int ms = 0; ms < Mg; ms += BM) {
    const int rows = min(BM, Mg - ms);
    if (ms > 0) cluster.sync();  // the cluster has folded the previous pass
    product(RowsByDepth{a.x, a.d, m0 + ms, rows, a.vec, nullptr},
            DepthByCols{a.w1, a.hd, j0, a.hd, a.vec, nullptr}, Plain{}, Plain{}, k0, kend, true,
            smem, acc,
            [&] {
              if (ms > 0) return;
              for (int u = threadIdx.x; u < BN; u += THREADS) {
                const int j = j0 + u;
                bw[u] = j < a.hd ? a.b1[j] : 0.f;
                bw[BN + u] = j < a.hd ? a.w2[j] : 0.f;
              }
            },
            none);
    store_tile(tile, acc);
    cluster.sync();
    // Block c folds rows m = c (mod CHUNKS), a warp a (row, 32-unit tile), a
    // lane a unit; the warp reads the partials of all its pairs first.
    constexpr int PAIRS = (BM / CHUNKS) * (BN / HT), PER_WARP = PAIRS / NW;
    float part[PER_WARP][CHUNKS];
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      const int pr = warp + NW * i, m = c + CHUNKS * (pr / (BN / HT)), h = pr % (BN / HT);
#pragma unroll
      for (int r = 0; r < CHUNKS; ++r)
        part[i][r] = m < rows ? cluster.map_shared_rank(tile, r)[m * PR + h * HT + lane] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      const int pr = warp + NW * i, m = c + CHUNKS * (pr / (BN / HT)), h = pr % (BN / HT);
      if (m >= rows) continue;
      const int u = h * HT + lane, j = j0 + u, t = hb * (BN / HT) + h;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < CHUNKS; ++r) sum = __fadd_rn(sum, part[i][r]);
      const float z = __fadd_rn(sum, bw[u]);
      const size_t row = static_cast<size_t>(m0 + ms + m);
      if (j < a.hd) a.pre[row * a.hd + j] = z;
      const float v = warp_sum(j < a.hd ? __fmul_rn(fmaxf(z, 0.f), bw[BN + u]) : 0.f);
      if (lane == 0 && t < a.T) __stcg(a.partial + static_cast<size_t>(t) * a.Mp + row, v);
    }
    datt_partials(a, m0 + ms, rows);
  }
  __syncthreads();
  if (threadIdx.x < CHUNKS) {
    if (threadIdx.x == 0) {
      __threadfence();  // cumulative: the block's partials, ordered by the barrier
      ticket = atomicAdd(a.counters + grp, 1u);
    }
    __syncwarp(0xffu);
    *cluster.map_shared_rank(seen + c, threadIdx.x) = ticket;
  }
  cluster.sync();  // also: no block reads another's tile after this
  bool last = false;
#pragma unroll
  for (int r = 0; r < CHUNKS; ++r) last |= seen[r] == gridDim.x - 1;
  if (!last || c != 0) return;
  if (threadIdx.x == 0) a.counters[grp] = 0;  // every block has counted
  __threadfence();
  float* lg = smem + AUX + 2 * BN;
  group_tail(a, m0, gp, lg, lg + a.Mmax);
}

// --------------------------------------------------------- grad_kernel

// dw2 over the slices a dW1 block of tile row 0 sees, from each stored
// slice: thread j chains relu(pre)·dlogit of column j0 + j % 64 over the
// rows j / 64 (mod 2) of the slices, in order (two chains a column, added
// in that order at the end).
struct SumSlices {
  bool on;
  float s;
  __device__ void operator()(const float* st, int len) {
    if (!on) return;
    const float* pre = st + OPER;
    const float* dl = st + 2 * OPER;
    const int j = threadIdx.x % BN, half = threadIdx.x / BN;
    float h[KS / 2];  // the loads first, then the chain
#pragma unroll
    for (int i = 0; i < KS / 2; ++i) h[i] = fmaxf(pre[(2 * i + half) * PR + j], 0.f);
#pragma unroll
    for (int i = 0; i < KS / 2; ++i)
      if (2 * i + half < len) s = fmaf(h[i], dl[2 * i + half], s);
  }
};

// dW1 (and db1 in row d) for tile cl·CHUNKS + rank, over all M rows; the
// blocks of tile row 0 also take dw2, and the first db2.
__device__ void dw1_role(const Args& a, int cl, int rank, float* smem) {
  const int JT = cdiv(a.hd, BN), tile = cl * CHUNKS + rank;
  const bool has = tile < cdiv(a.d + 1, BM) * JT;
  const int c0 = has ? (tile / JT) * BM : 0, j0 = has ? (tile % JT) * BN : 0;
  float* sw2 = smem + AUX;
  float* part = sw2 + BN;  // the two dw2 chains of each column [2][64], then db2
  float acc[NACC];
  SumSlices sums{has && c0 == 0, 0.f};
  product(DepthByCols{a.x, a.d, c0, a.d, a.vec, nullptr},
          DepthByCols{a.pre, a.hd, j0, a.hd, a.vec, a.dlogit}, OnesRow{a.d - c0}, DhByCol{sw2},
          0, a.M, has, smem, acc,
          [&] {
            for (int u = threadIdx.x; u < BN; u += THREADS)
              sw2[u] = j0 + u < a.hd ? a.w2[j0 + u] : 0.f;
          },
          sums);
  if (!has) return;
  store_tile(smem, acc);
  part[threadIdx.x] = sums.s;
  if (c0 == 0 && j0 == 0) {  // db2: chains over rows i (mod 128), then trees
    float t = 0.f;
    for (int m = threadIdx.x; m < a.M; m += THREADS) t = __fadd_rn(t, a.dlogit[m]);
    t = warp_sum(t);
    if (threadIdx.x % 32 == 0) part[2 * BN + threadIdx.x / 32] = t;
  }
  __syncthreads();
  constexpr int UNITS = BN / 4;
  for (int i = threadIdx.x; i < BM * UNITS; i += THREADS) {
    const int rr = i / UNITS, cc = 4 * (i % UNITS), row = c0 + rr;
    if (row > a.d) break;
    const float4 s = *reinterpret_cast<const float4*>(smem + rr * PR + cc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + cc + e;
      if (j >= a.hd) break;
      if (row < a.d)
        a.dw1[static_cast<size_t>(row) * a.hd + j] = at(s, e);
      else
        a.db1[j] = at(s, e);
    }
  }
  if (c0 == 0 && threadIdx.x < BN && j0 + threadIdx.x < a.hd)
    a.dw2[j0 + threadIdx.x] = __fadd_rn(part[threadIdx.x], part[BN + threadIdx.x]);
  if (c0 == 0 && j0 == 0 && threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) t = __fadd_rn(t, part[2 * BN + w]);
    a.db2[0] = t;
  }
}

// dx for the tile of cluster `cl` (64 rows × 64 columns), block rank taking
// depth chunk rank of hd; block rank folds rows rank (mod CHUNKS) in rank
// order, then dx = att·g + the sum.
__device__ void dx_role(const Args& a, int cl, int rank, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CT = cdiv(a.d, BN);
  const int m0 = (cl / CT) * BM, c0 = (cl % CT) * BN;
  const int rows = min(BM, a.M - m0), cols = min(BN, a.d - c0);
  const int CH = chunk_len(a.hd, CHUNKS), k0 = min(rank * CH, a.hd), kend = min(k0 + CH, a.hd);
  float* sdl = smem + AUX;
  float acc[NACC];
  NoSlice none;
  product(RowsByDepth{a.pre, a.hd, m0, rows, a.vec, a.w2},
          RowsByDepth{a.w1, a.hd, c0, cols, a.vec, nullptr}, DhByRow{sdl}, Plain{}, k0, kend,
          true, smem, acc,
          [&] {
            for (int u = threadIdx.x; u < BM; u += THREADS)
              sdl[u] = u < rows ? a.dlogit[m0 + u] : 0.f;
          },
          none);
  store_tile(smem, acc);
  cluster.sync();
  {  // 8 rows × 16 units, one a thread
    const int rr = rank + CHUNKS * (threadIdx.x / (BN / 4)), cc = 4 * (threadIdx.x % (BN / 4));
    const float4 s = fold4(smem, 0, CHUNKS, rr, cc);
    if (rr < rows) {
      const int m = m0 + rr;
      const float att = a.att[m];
      const float* gr = a.g + static_cast<size_t>(m / a.k) * a.d;
      float* out = a.dx + static_cast<size_t>(m) * a.d;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + cc + e;
        if (col < a.d) out[col] = __fadd_rn(__fmul_rn(att, gr[col]), at(s, e));
      }
    }
  }
  cluster.sync();
}

// Clusters [0, n_dw1) take dW1, dw2 and db2, the rest dx: the dW1 blocks,
// whose chains are the longer at large pools, start first.
__global__ void __cluster_dims__(CHUNKS, 1, 1) __launch_bounds__(THREADS, BLOCKS_PER_SM)
grad_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cl = blockIdx.x / CHUNKS;
  if (cl < a.n_dw1)
    dw1_role(a, cl, rank, smem);
  else
    dx_role(a, cl - a.n_dw1, rank, smem);
}

// --------------------------------------------------------------- host

// Once per device and kernel: opt the kernel into all of a block's shared
// memory and read that limit. Returns 0, or the CUDA error.
template <int KERNEL>
int smem_limit(const void* kernel, int* limit) {
  static std::atomic<int> room[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  *limit = room[dev].load(std::memory_order_acquire);
  if (*limit > 0) return 0;
  int optin = 0;
  cudaFuncAttributes attr;
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

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Scratch floats the wrapper passes (16-byte aligned): pre [n·k, hd], then
// the partial logits [cdiv(hd, 32), n·k], the datt partials [8, n·k], att
// and dlogit [n·k], each part from a multiple of 4 floats.
extern "C" long long repro_intersect_backward_scratch(int n, int k, int hd) {
  const long long M4 = (static_cast<long long>(n) * k + 3) / 4 * 4;
  return M4 * (hd + cdiv(hd, HT) + CHUNKS + 2);
}

// Row groups: the wrapper passes `counters` with at least this many uint32,
// all zero; every launch leaves them zero. One buffer per stream, not the
// forward's.
extern "C" int repro_intersect_backward_groups(int n, int k) {
  return k < 1 ? 0 : cdiv(n, group_rows(k));
}

// x [n, k, d], g [n, d], w1 [d, hd], b1 [hd], w2 [hd], b2 [1], all fp32 and
// contiguous; scratch and counters as above; outputs dx [n, k, d], dw1
// [d, hd], db1 [hd], dw2 [hd], db2 [1]. n, k, d, hd >= 1 (n = 0 launches
// nothing and leaves the weight gradients as they are: the wrapper zeroes
// them). Two launches on `stream`; returns the first CUDA error (0 =
// success; cudaErrorInvalidValue where a pool row's k logits do not fit a
// block's shared memory).
extern "C" int repro_intersect_backward(const float* x, const float* g, const float* w1,
                                        const float* b1, const float* w2, const float* b2,
                                        float* scratch, unsigned* counters, float* dx,
                                        float* dw1, float* db1, float* dw2, float* db2, int n,
                                        int k, int d, int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (n < 0 || k < 1 || d < 1 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long M64 = static_cast<long long>(n) * k;
  if (M64 > (1LL << 30) / 2) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x; a.g = g; a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2;
  a.n = n; a.k = k; a.d = d; a.hd = hd;
  a.M = static_cast<int>(M64);
  a.Mp = round_up(a.M, 4);  // every part of the scratch starts 16-byte aligned
  a.T = cdiv(hd, HT);
  a.Mmax = std::min(group_rows(k), n) * k;
  a.pre = scratch;
  a.partial = a.pre + static_cast<size_t>(a.Mp) * hd;
  a.pdatt = a.partial + static_cast<size_t>(a.Mp) * a.T;
  a.att = a.pdatt + static_cast<size_t>(a.Mp) * CHUNKS;
  a.dlogit = a.att + a.Mp;
  a.counters = counters;
  a.dx = dx; a.dw1 = dw1; a.db1 = db1; a.dw2 = dw2; a.db2 = db2;
  a.vec = d % 4 == 0 && hd % 4 == 0 && aligned(x) && aligned(w1) && aligned(w2) &&
          aligned(scratch);
  const int groups = cdiv(n, group_rows(k)), TH = cdiv(hd, BN);
  a.n_dw1 = cdiv(cdiv(d + 1, BM) * TH, CHUNKS);
  const long long clusters = a.n_dw1 + static_cast<long long>(cdiv(a.M, BM)) * cdiv(d, BN);
  if (groups > MAX_GRID_Y || clusters * CHUNKS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  int lim1 = 0, lim2 = 0;
  if (const int rc = smem_limit<1>(reinterpret_cast<const void*>(pre_kernel), &lim1)) return rc;
  if (const int rc = smem_limit<2>(reinterpret_cast<const void*>(grad_kernel), &lim2)) return rc;
  const size_t smem1 = static_cast<size_t>(pre_smem(a.Mmax)) * sizeof(float);
  const size_t smem2 = static_cast<size_t>(grad_smem()) * sizeof(float);
  if (smem1 > static_cast<size_t>(lim1) || smem2 > static_cast<size_t>(lim2))
    return static_cast<int>(cudaErrorInvalidValue);

  pre_kernel<<<dim3(CHUNKS * TH, groups), THREADS, smem1, s>>>(a);
  if (const cudaError_t err = cudaGetLastError(); err != cudaSuccess)
    return static_cast<int>(err);
  grad_kernel<<<dim3(static_cast<unsigned>(clusters * CHUNKS)), THREADS, smem2, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
