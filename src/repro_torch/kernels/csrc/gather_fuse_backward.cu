// Backward of the semantic entity fusion (Eq. 11 + 12) for Hopper (sm_90a),
// fp32 in and out, its products on the tensor cores in 3xTF32.
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
// The forward stores zp as it fuses (training passes it a buffer), so zp is
// an input here; without it one more launch recomputes it.
//
// What bounds it. From the saved zp a row costs 2·d·(d + dp) (dX) +
// 2·(d + dp + 1)·d (dWf, dbf) + 2·(dl + 1)·dp (dWp, dbp) flops: 0.87 MFLOP
// at d = 400, dl = 1024, dp = 64, against ~9 KB of its rows (z 4 KB; h, g,
// o 1.6 KB each; zp). At the loss's n = 33,280 rows that is 29 GFLOP:
// 0.18 ms in 3xTF32 (three TF32 products a multiply-add at 495 TFLOP/s),
// 0.43 ms on the fp32 CUDA cores, against ~0.1 ms for the bytes. Bound by
// operations at large n; at the EMBED pools (32–512 rows) by latency: a
// product 400 or 1,024 deep on a few row tiles.
//
// Design: on the caller's stream, at most five launches (the wrapper adds
// the zeroed dh_str and, above 4,096 rows, the id sort):
//  1. fuse_bwd_split_kernel: Wf split once into hi and lo copies (and, to
//     recompute zp, Wpᵀ). Wf's rows are dX's columns and its columns dX's
//     depth, so its own layout is the K-major one wgmma takes for tf32 B.
//  2. (zp not given) fuse_bwd_zp_kernel: zp = z·Wp + bp, z rows gathered in
//     place by sem_ids.
//  3. fuse_bwd_dx_kernel: dX = t·Wfᵀ, t made from g and o as A is read; dh
//     to scratch for the segment sum, dzp split and transposed (dWp's
//     K-major B), and t split and transposed (dWf's K-major B), the column
//     tiles of a row tile sharing those writes.
//  4. fuse_bwd_weights_kernel, roles by block: [dWf; dbf] = [h | zp | 1]ᵀ·t
//     and [dWp; dbp] = [z | 1]ᵀ·dzp tiles (h and z rows read in place by
//     ids, cached a chunk at a time in shared memory; the ones column gives
//     the bias row), then the segment sum of dh_str (over the ids sorted by
//     the wrapper, or, up to 4,096 rows, found by scanning the ids).
//  5. (n > KC) fuse_bwd_fold_kernel: both weights' chunk partials, in order.
// Every product is wgmma m64n64k8 tf32, A from registers and B from shared
// memory, in 128-row blocks of two warpgroups that share each B tile. Each
// fp32 operand splits as hi = tf32(x), lo = tf32(x − hi), rounded to
// nearest (ties away) in software; every k8 step adds a_lo·b_hi, a_hi·b_lo,
// a_hi·b_hi in that order (a_lo·b_lo, ~2^-22 of a·b, is dropped): the
// forward's order. tf32 wgmma reads B only K-major and A in any layout, so
// A is split in registers as each warp reads its fragment, and every B
// operand (Wf, Wpᵀ, tᵀ, dzpᵀ) is split once, by the launch that makes it,
// and stored in global memory already as wgmma's K-major core-matrix tiles
// (btile): a slice's B tile is one contiguous run, which one thread has the
// copy engine bring (cp.async.bulk on the stage's mbarrier), so no slice is
// split or rearranged in the main loop. A's raw rows land by 16-byte
// cp.async (one bulk copy a row timed slower). Slices 32 deep go through a
// 2-stage ring. dX and the zp product cut their depth in 8 chunks fixed by
// the width (d = 400: six of 64, one of 16, one empty; dl = 1,024: eight of
// 128). Where the row tiles would not fill the card (the EMBED pools, the
// 1,024-row check) a thread block cluster of 8 takes a tile, a block a
// chunk, folded in rank order through distributed shared memory; otherwise
// one block chains the chunks in registers in the same order. Not mma.sync
// m16n8k8: on this card its TF32 rate leaves products no faster than the
// fp32 FMAs they replace (PERF.md).
//
// What holds it (PERF.md has the numbers): at 33,280 rows the two product
// launches run at ~20–25% of the 3xTF32 rate; a slice costs several times
// its wgmmas, in its barrier, the wait for its wgmmas, its A fragments and
// its copies, and one or two blocks an SM hide little of that. B tiles
// brought by bulk copies instead of 16-byte cp.async cut both launches by
// 17–30%. Tried and timed no faster: 3-stage rings, 64-deep slices, one-
// and four-warpgroup blocks, 128-column dX and dWf tiles, A rows by bulk
// copies, and one slice's wgmmas kept in flight while the next A is made
// (ptxas then serialises the wgmmas).
//
// Fixed-order sums, and no float atomics. A wgmma chain runs over its k8
// steps in order from 0 (steps past the data multiply zeros); dX's and zp's
// chunks fold in order from 0, ((0 + c0) + c1) + ..., in a cluster or in a
// block alike, so a row of dX (and so its dh) depends only on its own
// inputs and the widths, not on n. The weight and bias gradients sum over
// chunks of KC = 1,024 rows (a constant): each chunk one chain, written
// whole when the call has one chunk, else folded in chunk order. dh_str:
// the wrapper sorts the ids once (stable); the warp at the start of each
// run of equal ids adds the run's dh rows in that order, the order the rows
// come in the call. An id outside its table reads as a zero row and writes
// nothing. Two calls on the same inputs give the same bits.
//
// ptxas -v (-O3, sm_90a): fuse_bwd_dx_kernel 128 registers (two blocks an
// SM), 4 bytes spilled; fuse_bwd_weights_kernel 93, fuse_bwd_zp_kernel 123,
// split 28, fold 32, none spilled. Shared memory a block: dX 106,496 bytes
// dynamic; the weight gradients 69,632 dynamic and 8,320 static (a chunk's
// ids); zp 69,632 and 1,152.
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WGS = 2;              // warpgroups of a block, 64 tile rows each
constexpr int THREADS = 128 * WGS;
constexpr int BM = 64 * WGS;        // rows of a block tile
constexpr int KS = 32;              // depth of a slice
constexpr int PK = KS + 4;          // pitch of a raw slice stored [BM][KS] (depth-major)
constexpr int PR = BM + 8;          // pitch of a raw slice stored [KS][BM] (tile-major)
constexpr int OPER = BM * PK > KS * PR ? BM * PK : KS * PR;  // floats of a raw operand slice
constexpr int QK = KS / 4;          // 16-byte units along a slice's depth
constexpr int QM = BM / 4;          // 16-byte units across a tile's rows
static_assert(BM * QK % THREADS == 0 && KS * QM % THREADS == 0, "whole units a thread");
constexpr int CORE = 128;           // bytes of a core matrix: 8 rows of 16 bytes
constexpr int NST = 2;              // stages of a block's ring
constexpr int CHUNKS = 8;           // depth chunks of dX and of the zp product
constexpr int KC = 1024;            // rows of a chunk of the weight gradients
constexpr int DX_BN = 64;           // columns of a dX tile
constexpr int ZP_BN = 64;           // columns of a zp tile
constexpr int MINB = 2;             // blocks an SM (128 registers a thread)
constexpr int W_BN = 64;            // columns of a weight-gradient tile
constexpr int SEG_COLS = 8;         // columns a lane of the segment sum holds
constexpr int MAX_DEVICES = 64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return cdiv(a, b) * b; }
// Depth of a chunk when `depth` is cut in `parts`: whole slices, fixed by
// the depth alone (d = 400: six chunks of 64, one of 16 and one empty;
// dl = 1024: eight of 128).
__host__ __device__ inline int chunk_len(int depth, int parts) {
  return round_up(cdiv(depth, parts), KS);
}
template <int NA, int BN>
__host__ __device__ constexpr int stage_floats() { return NA * OPER + 2 * BN * KS; }
// A split B operand (hi or lo) is stored as the K-major tiles wgmma reads:
// for each slice of KS depth, `groups` blocks of 8 columns, each QK core
// matrices of 8 columns by 4 depth. So the B tile of BN columns from c0 (a
// multiple of BN) and one slice is one contiguous run of BN·KS floats, the
// smem tile itself. groups covers the columns in whole BN tiles.
__host__ __device__ inline int groups_of(int columns, int bn) {
  return round_up(cdiv(columns, 8), bn / 8);
}
__host__ __device__ inline long long btile(int c, int k, int groups) {
  return ((static_cast<long long>(k / KS) * groups + c / 8) * QK + (k % KS) / 4) * 32 +
         (c % 8) * 4 + k % 4;
}
// Floats of a split operand of `depth` (whole slices) and `groups`.
__host__ __device__ inline long long btile_floats(int depth, int groups) {
  return static_cast<long long>(cdiv(depth, KS)) * groups * QK * 32;
}

struct Args {
  const long long *ids, *sem_ids, *sorted, *order;
  const float *h_str, *h_sem, *wp, *bp, *wf, *bf, *out, *g;
  const float* zp;          // [n, dp]: the forward's, or zp_out once recomputed
  float* zp_out;            // [n, dp] scratch (the zp product), or null
  // The split B operands, hi and lo, each in wgmma's K-major tiles (btile):
  float *wf_hi, *wf_lo;     // Wf: dX's B, columns d + dp, depth d
  float *wpt_hi, *wpt_lo;   // Wpᵀ: the zp product's B, columns dp, depth dl
  float* dxh;               // [n, d]: dh, the first d columns of dX
  float *tt_hi, *tt_lo;     // tᵀ: dWf's B, columns d, depth n
  float *dzt_hi, *dzt_lo;   // dzpᵀ: dWp's B, columns dp, depth n
  float* part;              // chunk partials of [dWf; dbf], then of [dWp; dbp]
  float *dh, *dwp, *dbp, *dwf, *dbf;
  long long n_str, n_sem;
  int n, d, dl, dp, chunks;
  int g_wf, g_wpt, g_tt, g_dzt;  // 8-column groups of each split operand
  int cl;                   // blocks of a dX / zp cluster: CHUNKS, or 1
  int vec_go, vec_z, vec_x; // 16-byte copies of g and o, of z rows, of X rows
  int n_wf, n_wp;           // blocks of the weights launch's two product roles
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
// Make this thread's shared-memory writes visible to wgmma's operand reads.
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

// wgmma descriptor of a K-major B tile without swizzle: core matrices of 8
// columns by 16 bytes (4 k); the next 4 k sit LBO = 128 bytes on, the next
// 8 columns SBO = KS / 4 core matrices on.
__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t lbo = CORE >> 4, sbo = (KS / 4 * CORE) >> 4;
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32);
}

// acc[64 × N] = A (registers: the warp's 16 rows × 8 k) · B (desc), plus acc
// where `add`.
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a, uint64_t b, int add) {
  static_assert(BN == 64, "every tile is 64 columns wide (m64n64k8)");
  wgmma_n64(d, a, b, add);
}
// acc += a·b for one k8 step in 3xTF32: a_lo·b_hi, a_hi·b_lo, a_hi·b_hi, in
// that order (the small terms first); `first` starts acc from 0 instead.
template <int BN>
__device__ __forceinline__ void mma3(float* acc, const uint32_t* ah, const uint32_t* al,
                                     uint64_t bh, uint64_t bl, bool first) {
  wgmma<BN>(acc, al, bh, !first);
  wgmma<BN>(acc, ah, bl, 1);
  wgmma<BN>(acc, ah, bh, 1);
}

// ------------------------------------------------------------- copies

__device__ __forceinline__ int clamp4(int c) { return c < 0 ? 0 : (c > 4 ? 4 : c); }
// 16 bytes from src (16-byte aligned), of which 4·cnt are read and the rest
// zero-filled; `base` stands in for src where nothing is read.
__device__ __forceinline__ void cp16(float* dst, const float* src, int cnt, const float* base) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(cnt > 0 ? src : base), "r"(4 * cnt)
               : "memory");
}
// 4 bytes from src, or a zero where !ok.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok, const float* base) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(ok ? src : base), "r"(ok ? 4 : 0)
               : "memory");
}
// cnt elements from src to dst, zeros after: one 16-byte copy where vec,
// else four of 4 bytes.
__device__ __forceinline__ void cp_unit(float* dst, const float* src, int cnt, int vec,
                                        const float* base) {
  if (vec) {
    cp16(dst, src, cnt, base);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp4(dst + e, src + e, e < cnt, base);
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// This thread's arrival, announcing `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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
// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the copy engine; their arrival completes on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------------------- loaders
//
// A slice's raw operand lands by cp.async, zeros past the data, in one of
// two layouts: depth-major [BM][PK] (a thread's units: rows t / QK +
// (THREADS / QK)·i at depth 4·(t % QK)) or tile-major [KS][PR] (depth
// t / QM + (THREADS / QM)·i at columns 4·(t % QM)). issue(s, k0, kend) copies depth [k0, k0 + KS), data
// below kend.

// dX's A: rows of g, then of o (the forward's output) — t is made from the
// two as A is read. Rows m0.. of [n, d].
struct GoRows {
  const Args* a;
  int m0;
  __device__ void issue(float* s, int k0, int kend) const {
    const int r0 = threadIdx.x / QK, kq = 4 * (threadIdx.x % QK), k = k0 + kq;
    const int cnt = clamp4(kend - k);
#pragma unroll
    for (int i = 0; i < BM * QK / THREADS; ++i) {
      const int r = r0 + (THREADS / QK) * i, row = m0 + r;
      const int c = row < a->n ? cnt : 0;
      const size_t off = static_cast<size_t>(row) * a->d + k;
      cp_unit(s + r * PK + kq, a->g + off, c, a->vec_go, a->g);
      cp_unit(s + OPER + r * PK + kq, a->out + off, c, a->vec_go, a->g);
    }
  }
};

// The zp product's A: rows of H_sem named by sem_ids (row ids cached in
// shared memory; -1 reads as zeros).
struct ZRows {
  const Args* a;
  const long long* rowid;
  __device__ void issue(float* s, int k0, int kend) const {
    const int r0 = threadIdx.x / QK, kq = 4 * (threadIdx.x % QK), k = k0 + kq;
    const int cnt = clamp4(kend - k);
#pragma unroll
    for (int i = 0; i < BM * QK / THREADS; ++i) {
      const int r = r0 + (THREADS / QK) * i;
      const long long row = rowid[r];
      cp_unit(s + r * PK + kq, a->h_sem + (row < 0 ? 0 : row) * a->dl + k, row < 0 ? 0 : cnt,
              a->vec_z, a->h_sem);
    }
  }
};

// dWf's A, Xᵀ: depth = rows i of X = [h_str[ids[i]] | zp[i] | 1] (the ones
// column comes from OnesAt), tile = columns m0.. of X. rowid holds the
// chunk's ids from row r0 (-1 outside h_str).
struct XCols {
  const Args* a;
  int m0;
  const long long* rowid;
  int r0;
  __device__ void issue(float* s, int k0, int kend) const {
    const int kd0 = threadIdx.x / QM, m = 4 * (threadIdx.x % QM), mm = m0 + m;
    const int d = a->d, w = a->d + a->dp;
#pragma unroll
    for (int i = 0; i < KS * QM / THREADS; ++i) {
      const int kd = kd0 + (THREADS / QM) * i, row = k0 + kd;
      float* dst = s + kd * PR + m;
      const bool in = row < kend;
      const long long e = in ? rowid[row - r0] : -1;
      const bool he = e >= 0;
      const float* hrow = a->h_str + (he ? e : 0) * d;
      const float* zrow = a->zp + static_cast<size_t>(in ? row : 0) * a->dp - d;
      if (a->vec_x) {  // d and dp multiples of 4: a unit lies in h or in zp
        const float* src = mm < d ? hrow + mm : zrow + mm;
        const int cnt = !in ? 0 : mm < d ? (he ? 4 : 0) : clamp4(w - mm);
        cp16(dst, src, cnt, a->g);
      } else {
#pragma unroll
        for (int el = 0; el < 4; ++el) {
          const int c = mm + el;
          const bool ok = in && (c < d ? he : c < w);
          cp4(dst + el, c < d ? hrow + c : zrow + c, ok, a->g);
        }
      }
    }
  }
};

// dWp's A, Zᵀ: depth = rows i of [h_sem[sem_ids[i]] | 1], tile = columns
// m0.. of it. rowid holds the chunk's sem_ids from row r0 (-1 outside
// h_sem).
struct ZCols {
  const Args* a;
  int m0;
  const long long* rowid;
  int r0;
  __device__ void issue(float* s, int k0, int kend) const {
    const int kd0 = threadIdx.x / QM, m = 4 * (threadIdx.x % QM), mm = m0 + m;
#pragma unroll
    for (int i = 0; i < KS * QM / THREADS; ++i) {
      const int kd = kd0 + (THREADS / QM) * i, row = k0 + kd;
      const bool in = row < kend;
      const long long e = in ? rowid[row - r0] : -1;
      const bool ok = e >= 0;
      const float* src = a->h_sem + (ok ? e : 0) * a->dl + mm;
      cp_unit(s + kd * PR + m, src, ok ? clamp4(a->dl - mm) : 0, a->vec_z, a->g);
    }
  }
};

// B of a slice, already split and stored as its tiles (btile): the hi and
// the lo tile of columns c0.. are two contiguous runs of BN·KS floats, which
// one thread has the copy engine bring, their arrival on `bar`.
template <int BN>
struct BTiles {
  const float *hi, *lo;
  int groups, c0;
  __device__ void issue(float* s, int k0, int, uint64_t* bar) const {
    if (threadIdx.x != 0) return;
    constexpr unsigned BYTES = BN * KS * sizeof(float);
    const long long off = btile(c0, k0, groups);
    mbar_expect(bar, 2 * BYTES);
    bulk_copy(s, hi + off, BYTES, bar);
    bulk_copy(s + BN * KS, lo + off, BYTES, bar);
  }
};

// What A takes from its raw slice(s) at (tile index i, depth kk).
struct Plain {
  __device__ float operator()(float v, float, int) const { return v; }
};
// t = g ⊙ (1 − o²)/2, the derivative of 2σ − 1 from the saved o.
__device__ __forceinline__ float dpre(float g, float o) { return g * (0.5f * (1.f - o * o)); }
struct TFromGo {
  __device__ float operator()(float g, float o, int) const { return dpre(g, o); }
};
// A column of ones at tile index `one` (the bias gradients' row).
struct OnesAt {
  int one;
  __device__ float operator()(float v, float, int i) const { return i == one ? 1.f : v; }
};

// The warp's A fragment of k8 step kk: rows 64·wg + 16·warp + g (+ 8),
// depth kk + t (+ 4), made and split.
template <bool DM, int NA, class TA>
__device__ __forceinline__ void load_a(const float* st, const TA& ta, int kk, uint32_t* ah,
                                       uint32_t* al) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = 64 * wg + 16 * warp + lane / 4, q = kk + lane % 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int rr = r + 8 * (e & 1), qq = q + 4 * (e >> 1);
    const int idx = DM ? rr * PK + qq : qq * PR + rr;
    split(ta(st[idx], NA == 2 ? st[OPER + idx] : 0.f, rr), ah[e], al[e]);
  }
}

// A block's product over depth chunks [c_lo, c_hi) of K (chunk c: [c·CH,
// min(K, (c + 1)·CH))), each chunk one chain from 0 into acc, handed to
// chunk_end(acc) once done. Slices of KS go through a ring of NST stages,
// NST - 1 landing while one is multiplied: A by each thread's cp.async, B,
// already split, by one bulk copy a tile on the stage's mbarrier; A is made
// and split as each warp reads it; on_slice(stage, k0, valid) runs while a
// slice's wgmmas do. Ends with the ring free.
template <int BN, int NA, bool DM, class LA, class LB, class TA, class OnSlice, class ChunkEnd>
__device__ __forceinline__ void product(const LA& la, const LB& lb, const TA& ta, int K, int CH,
                                        int c_lo, int c_hi, float* smem, float (&acc)[BN / 2],
                                        OnSlice& on_slice, ChunkEnd chunk_end) {
  constexpr int STAGE = stage_floats<NA, BN>();
  // Only slices that hold data are visited: the whole chunks (CH is whole
  // slices), then the one partial chunk; chunks past K fold as zeros.
  const int spc = CH / KS, nc = c_hi - c_lo;
  const int nfull = max(0, min(K / CH - c_lo, nc));
  const int tail = nfull < nc ? cdiv(max(0, K - (c_lo + nfull) * CH), KS) : 0;
  const int total = nfull * spc + tail;
  // Slice f: its chunk's slice index s, whether it ends the chunk, and its
  // depth [k0, ke).
  auto span = [&](int f, int& s, bool& last, int& k0, int& ke) {
    const int c = c_lo + (f < nfull * spc ? f / spc : nfull);
    s = f < nfull * spc ? f % spc : f - nfull * spc;
    last = s == (f < nfull * spc ? spc : tail) - 1;
    ke = min((c + 1) * CH, K);
    k0 = c * CH + s * KS;
  };
  __shared__ uint64_t full[NST];  // a stage's B tiles have landed
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int f) {
    int s, k0, ke;
    bool last;
    span(f, s, last, k0, ke);
    float* st = smem + (f % NST) * STAGE;
    la.issue(st, k0, ke);
    lb.issue(st + NA * OPER, k0, ke, &full[f % NST]);
  };
#pragma unroll
  for (int f = 0; f < NST - 1; ++f) {
    if (f < total) issue(f);
    cp_commit();
  }
  bool first;
  for (int f = 0; f < total; ++f) {
    cp_wait<NST - 2>();
    fence_async();
    mbar_wait(&full[f % NST], (f / NST) & 1);
    __syncthreads();  // slice f has landed; every warp is done with slice f - 1
    if (f + NST - 1 < total) issue(f + NST - 1);
    cp_commit();
    int s, k0, ke;
    bool last;
    span(f, s, last, k0, ke);
    first = s == 0;
    const int valid = min(KS, ke - k0);
    {
      // Every k8 step of the slice runs, past the data too (A and B hold
      // zeros there, which add nothing): no branch stands between the wgmmas.
      const float* st = smem + (f % NST) * STAGE;
      const float* bt = st + NA * OPER;
      uint32_t ah[KS / 8][4], al[KS / 8][4];
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk) load_a<DM, NA>(st, ta, 8 * kk, ah[kk], al[kk]);
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk)
        mma3<BN>(acc, ah[kk], al[kk], desc(bt + kk * 2 * CORE / 4),
                 desc(bt + BN * KS + kk * 2 * CORE / 4), first && kk == 0);
      wgmma_commit();
      on_slice(st, k0, valid);  // while the wgmmas run
      wgmma_wait();
      fence_regs<BN / 2>(acc);
    }
    if (last) chunk_end(acc);
  }
  for (int c = nfull + (tail > 0); c < nc; ++c) {  // chunks past K
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    chunk_end(acc);
  }
  cp_wait<0>();
  __syncthreads();
}

struct NoSlice {
  __device__ void operator()(const float*, int, int) const {}
};

// The thread's accumulator elements into a [BM][BN + 8] tile: acc[4j + 2hh
// + e] is row 64·wg + 16·warp + g + 8·hh, column 8j + 2t + e.
template <int BN>
__device__ __forceinline__ void store_tile(float* tile, const float* acc) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = 64 * wg + 16 * warp + lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(tile + (r + 8 * hh) * (BN + 8) + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
}

// The depth chunks of a tile, folded in order: ((0 + c0) + c1) + ... The
// blocks of a cluster (cl = CHUNKS) each hold one chunk's chain and fold
// through distributed shared memory, block `rank` the rows rank (mod cl); a
// lone block (cl = 1) has chained its chunks in registers in the same
// order. store(row, column, value) takes each sum of the tile.
template <int BN, class Store>
__device__ __forceinline__ void fold_tile(float* tile, const float* sum, int cl, int rank,
                                          Store store) {
  store_tile<BN>(tile, sum);
  if (cl > 1) cg::this_cluster().sync();
  else __syncthreads();
  constexpr int UNITS = BN / 4;
  for (int u = threadIdx.x; u < (BM / cl) * UNITS; u += THREADS) {
    const int rr = rank + cl * (u / UNITS), cc = 4 * (u % UNITS);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < cl; ++q) {
      const float* src = cl > 1 ? cg::this_cluster().map_shared_rank(tile, q) : tile;
      const float4 p = *reinterpret_cast<const float4*>(src + rr * (BN + 8) + cc);
      s.x = __fadd_rn(s.x, p.x);
      s.y = __fadd_rn(s.y, p.y);
      s.z = __fadd_rn(s.z, p.z);
      s.w = __fadd_rn(s.w, p.w);
    }
    store(rr, cc, s.x);
    store(rr, cc + 1, s.y);
    store(rr, cc + 2, s.z);
    store(rr, cc + 3, s.w);
  }
  if (cl > 1) cg::this_cluster().sync();  // no block leaves while its tile is read
}

// ------------------------------------------------------------- kernels

// Wf split into K-major hi and lo copies for dX (its rows are dX's columns,
// its columns dX's depth, so Wf's own layout is K-major) and, for the zp
// product, Wpᵀ split likewise.
__global__ void fuse_bwd_split_kernel(const Args a, int with_wp) {
  // Every float of the tiles, zeros past the data (slices past the depth
  // must not carry what the scratch held).
  const long long nf = btile_floats(a.d, a.g_wf);
  const long long np = with_wp ? btile_floats(a.dl, a.g_wpt) : 0;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < nf + np;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool f = e < nf;
    const long long t = f ? e : e - nf, groups = f ? a.g_wf : a.g_wpt;
    // t = ((slice·groups + group)·QK + kq)·32 + cr·4 + kr
    const int kr = static_cast<int>(t % 4), cr = static_cast<int>(t / 4 % 8);
    const int kq = static_cast<int>(t / 32 % QK);
    const long long sg = t / (32 * QK);
    const int c = static_cast<int>(sg % groups) * 8 + cr;
    const int k = static_cast<int>(sg / groups) * KS + kq * 4 + kr;
    float v = 0.f;
    if (f && c < a.d + a.dp && k < a.d) v = a.wf[static_cast<long long>(c) * a.d + k];
    if (!f && c < a.dp && k < a.dl) v = a.wp[static_cast<long long>(k) * a.dp + c];
    uint32_t hi, lo;
    split(v, hi, lo);
    (f ? a.wf_hi : a.wpt_hi)[t] = __uint_as_float(hi);
    (f ? a.wf_lo : a.wpt_lo)[t] = __uint_as_float(lo);
  }
}

// zp = z·Wp + bp, recomputed when the forward's is not given: a tile of
// BM rows × 64 columns, its depth dl cut in CHUNKS chunks fixed by dl.
__global__ void __launch_bounds__(THREADS, MINB) fuse_bwd_zp_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ long long rowid[BM];
  const int cl = a.cl, rank = cl > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int NT = cdiv(a.dp, ZP_BN), tile = blockIdx.x / cl;
  const int m0 = (tile / NT) * BM, c0 = (tile % NT) * ZP_BN;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int i = m0 + r;
    const long long e = i < a.n ? a.sem_ids[i] : -1;
    rowid[r] = e >= 0 && e < a.n_sem ? e : -1;
  }
  __syncthreads();
  float acc[ZP_BN / 2], sum[ZP_BN / 2];
#pragma unroll
  for (int i = 0; i < ZP_BN / 2; ++i) sum[i] = 0.f;
  NoSlice none;
  product<ZP_BN, 1, true>(ZRows{&a, rowid}, BTiles<ZP_BN>{a.wpt_hi, a.wpt_lo, a.g_wpt, c0}, Plain{},
                       a.dl, chunk_len(a.dl, CHUNKS), cl > 1 ? rank : 0, cl > 1 ? rank + 1 : CHUNKS,
                       smem, acc, none, [&](const float (&c)[ZP_BN / 2]) {
#pragma unroll
                         for (int i = 0; i < ZP_BN / 2; ++i) sum[i] = __fadd_rn(sum[i], c[i]);
                       });
  fold_tile<ZP_BN>(smem, sum, cl, rank, [&](int rr, int cc, float v) {
    const int i = m0 + rr, c = c0 + cc;
    if (i < a.n && c < a.dp) a.zp_out[static_cast<size_t>(i) * a.dp + c] = __fadd_rn(v, a.bp[c]);
  });
}

// The column tiles of a row tile write t (from the slice's raw g and o) as
// tᵀ split, dWf's B, in its tiles: tile `part` of `parts` takes the blocks
// (8 depth columns of t × KS rows, one core-matrix tile) part, part + parts,
// ..., a thread an element, in the order they lie in memory. Rows from n to
// the end of their slice get zeros (dWf's ones column multiplies them).
struct WriteT {
  const Args* a;
  int m0, part, parts;
  __device__ void operator()(const float* st, int k0, int valid) const {
    constexpr int GROUPS = KS / 8, BLOCKS = (BM / KS) * GROUPS, TILE = 8 * KS;
    const int rows = min(BM, a->n - m0), rpad = min(BM, round_up(a->n, KS) - m0);
    for (int b = part; b < BLOCKS; b += parts)
      for (int e = threadIdx.x; e < TILE; e += THREADS) {
        const int r = (b / GROUPS) * KS + (e / 32) * 4 + e % 4;
        const int kd = (b % GROUPS) * 8 + (e / 4) % 8;
        if (r >= rpad || kd >= valid) continue;
        uint32_t hi, lo;
        split(r < rows ? dpre(st[r * PK + kd], st[OPER + r * PK + kd]) : 0.f, hi, lo);
        const long long off = btile(k0 + kd, m0 + r, a->g_tt);
        a->tt_hi[off] = __uint_as_float(hi);
        a->tt_lo[off] = __uint_as_float(lo);
      }
  }
};

// dX = t·Wfᵀ for a tile of BM rows × DX_BN columns of [dh | dzp], its depth
// d cut in CHUNKS chunks fixed by d; dh to dxh, dzp split and transposed
// (dWp's K-major B); the column tiles share writing tᵀ.
__global__ void __launch_bounds__(THREADS, MINB) fuse_bwd_dx_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) float smem[];
  const int cl = a.cl, rank = cl > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int w = a.d + a.dp, NT = cdiv(w, DX_BN), tile = blockIdx.x / cl;
  const int m0 = (tile / NT) * BM, c0 = (tile % NT) * DX_BN;
  float acc[DX_BN / 2], sum[DX_BN / 2];
#pragma unroll
  for (int i = 0; i < DX_BN / 2; ++i) sum[i] = 0.f;
  WriteT write_t{&a, m0, tile % NT, NT};
  product<DX_BN, 2, true>(GoRows{&a, m0}, BTiles<DX_BN>{a.wf_hi, a.wf_lo, a.g_wf, c0},
                          TFromGo{}, a.d, chunk_len(a.d, CHUNKS), cl > 1 ? rank : 0,
                          cl > 1 ? rank + 1 : CHUNKS, smem, acc, write_t,
                          [&](const float (&c)[DX_BN / 2]) {
#pragma unroll
                            for (int i = 0; i < DX_BN / 2; ++i) sum[i] = __fadd_rn(sum[i], c[i]);
                          });
  fold_tile<DX_BN>(smem, sum, cl, rank, [&](int rr, int cc, float v) {
    const int i = m0 + rr, c = c0 + cc;
    if (c >= w || i >= round_up(a.n, KS)) return;
    if (c < a.d) {
      if (i < a.n) a.dxh[static_cast<size_t>(i) * a.d + c] = v;
    } else {  // rows from n to their slice's end: zeros, as in tᵀ
      uint32_t hi, lo;
      split(i < a.n ? v : 0.f, hi, lo);
      const long long off = btile(c - a.d, i, a.g_dzt);
      a.dzt_hi[off] = __uint_as_float(hi);
      a.dzt_lo[off] = __uint_as_float(lo);
    }
  });
}

// One weight-gradient tile: Aᵀ·B over the rows of chunk kc, A's columns
// m0.. (a ones column at `one` gives the bias row), B's columns c0..; into
// w [M, N] and bias [N] when the call has one chunk, else into its
// partials [M + 1, N] at part.
template <int BN, class LA>
__device__ __forceinline__ void weight_tile(const Args& a, const LA& la, const float* bhi,
                                            const float* blo, int groups, int M, int N, int m0,
                                            int c0,
                                            int kc, float* w, float* bias, float* part,
                                            float* smem) {
  float acc[BN / 2];
  NoSlice none;
  product<BN, 1, false>(la, BTiles<BN>{bhi, blo, groups, c0}, OnesAt{M - m0}, a.n,
                                       KC, kc, kc + 1, smem, acc, none,
                                       [](const float (&)[BN / 2]) {});
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = m0 + 64 * wg + 16 * warp + lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = r + 8 * hh, c = c0 + 8 * j + 2 * t + e;
        if (m > M || c >= N) continue;
        const float v = acc[4 * j + 2 * hh + e];
        if (a.chunks > 1) part[static_cast<size_t>(m) * N + c] = v;
        else if (m < M) w[static_cast<size_t>(m) * N + c] = v;
        else bias[c] = v;
      }
}

// dh_str's rows, a warp for each position w: with the ids sorted (sorted,
// order), the warp at the start of a run of equal ids adds the run's dh
// rows (dxh rows order[w..]) in order; without them (small n), the warp of
// the first row with its id finds the id's rows by scanning the ids and
// adds them in the order they come — the same rows in the same order. Each
// writes the sum to the id's row; ids outside [0, n_str) write nothing.
__device__ __forceinline__ void segment_rows(const Args& a, int b) {
  constexpr unsigned FULL = 0xffffffffu;
  const int w = b * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= a.n) return;
  const long long e = a.sorted ? a.sorted[w] : a.ids[w];
  if (e < 0 || e >= a.n_str) return;
  int end = w + 1;
  if (a.sorted) {
    if (w > 0 && a.sorted[w - 1] == e) return;
    while (end < a.n && a.sorted[end] == e) ++end;
  } else {
    for (int j0 = 0; j0 < w; j0 += 32)
      if (__any_sync(FULL, j0 + lane < w && a.ids[j0 + lane] == e)) return;
  }
  for (int c0 = 0; c0 < a.d; c0 += 32 * SEG_COLS) {
    float acc[SEG_COLS];
#pragma unroll
    for (int u = 0; u < SEG_COLS; ++u) acc[u] = 0.f;
    auto add = [&](long long row_index) {
      const float* row = a.dxh + row_index * a.d;
#pragma unroll
      for (int u = 0; u < SEG_COLS; ++u) {
        const int c = c0 + lane + 32 * u;
        if (c < a.d) acc[u] += row[c];
      }
    };
    if (a.sorted) {
      for (int j = w; j < end; ++j) add(a.order[j]);
    } else {
      for (int j0 = w; j0 < a.n; j0 += 32) {
        unsigned m = __ballot_sync(FULL, j0 + lane < a.n && a.ids[j0 + lane] == e);
        for (; m; m &= m - 1) add(j0 + __ffs(m) - 1);
      }
    }
#pragma unroll
    for (int u = 0; u < SEG_COLS; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < a.d) a.dh[e * a.d + c] = acc[u];
    }
  }
}

// Roles by block: [dWf; dbf] = [X | 1]ᵀ·t tiles (chunk-major), then
// [dWp; dbp] = [Z | 1]ᵀ·dzp tiles, then the segment sum of dh_str.
__global__ void __launch_bounds__(THREADS, MINB) fuse_bwd_weights_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ long long rowid[KC];  // the chunk's ids (dWf) or sem_ids (dWp)
  const int b = blockIdx.x;
  const int wf = a.d + a.dp, cf = (wf + 1) * a.d, cp = (a.dl + 1) * a.dp;
  // The chunk's row ids, once: the copies of a slice then wait on no load.
  auto cache_ids = [&](const long long* src, long long limit, int kc) {
    for (int r = threadIdx.x; r < KC; r += THREADS) {
      const int i = kc * KC + r;
      const long long e = i < a.n ? src[i] : -1;
      rowid[r] = e >= 0 && e < limit ? e : -1;
    }
    __syncthreads();
  };
  if (b < a.n_wf) {
    const int NT = cdiv(a.d, W_BN), MT = cdiv(wf + 1, BM), per = MT * NT;
    const int kc = b / per, r = b % per, m0 = (r / NT) * BM, c0 = (r % NT) * W_BN;
    cache_ids(a.ids, a.n_str, kc);
    weight_tile<W_BN>(a, XCols{&a, m0, rowid, kc * KC}, a.tt_hi, a.tt_lo, a.g_tt, wf, a.d, m0, c0, kc, a.dwf, a.dbf,
                a.part + static_cast<size_t>(kc) * cf, smem);
  } else if (b < a.n_wf + a.n_wp) {
    const int NT = cdiv(a.dp, W_BN), MT = cdiv(a.dl + 1, BM), per = MT * NT;
    const int t = b - a.n_wf, kc = t / per, r = t % per;
    const int m0 = (r / NT) * BM, c0 = (r % NT) * W_BN;
    cache_ids(a.sem_ids, a.n_sem, kc);
    weight_tile<W_BN>(a, ZCols{&a, m0, rowid, kc * KC}, a.dzt_hi, a.dzt_lo, a.g_dzt, a.dl, a.dp, m0, c0, kc, a.dwp, a.dbp,
                a.part + static_cast<size_t>(a.chunks) * cf + static_cast<size_t>(kc) * cp, smem);
  } else {
    segment_rows(a, b - a.n_wf - a.n_wp);
  }
}

// Both weights' chunk partials added in chunk order: element j of
// [dWf; dbf] (j < cf), then of [dWp; dbp].
__global__ void fuse_bwd_fold_kernel(const Args a) {
  const long long cf = static_cast<long long>(a.d + a.dp + 1) * a.d;
  const long long cp = static_cast<long long>(a.dl + 1) * a.dp;
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= cf + cp) return;
  const bool f = j < cf;
  const long long count = f ? cf : cp, jj = f ? j : j - cf;
  const float* p = a.part + (f ? 0 : a.chunks * cf) + jj;
  float s = 0.f;
  for (int z = 0; z < a.chunks; ++z) s = __fadd_rn(s, p[z * count]);
  const long long split_at = f ? static_cast<long long>(a.d + a.dp) * a.d
                               : static_cast<long long>(a.dl) * a.dp;
  if (jj < split_at) (f ? a.dwf : a.dwp)[jj] = s;
  else (f ? a.dbf : a.dbp)[jj - split_at] = s;
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

int sm_count(int* sms) {
  static std::atomic<int> count[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  *sms = count[dev].load(std::memory_order_acquire);
  if (*sms > 0) return 0;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  count[dev].store(*sms, std::memory_order_release);
  return 0;
}

// A launch of `blocks` blocks in clusters of cl along x.
template <class Kernel>
int launch_clusters(Kernel kernel, const Args& a, int blocks, int cl, size_t smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The scratch's parts, in floats from its start, each a multiple of 4.
struct Parts {
  long long wf_hi, wf_lo, wpt_hi, wpt_lo, zp, dxh, tt_hi, tt_lo, dzt_hi, dzt_lo, part, total;
  Parts(int n, int d, int dl, int dp) {
    const long long chunks = std::max(1, cdiv(n, KC));
    long long at = 0;
    auto take = [&](long long floats) {
      const long long here = at;
      at += (floats + 3) / 4 * 4;
      return here;
    };
    const long long wf = btile_floats(d, groups_of(d + dp, DX_BN));
    const long long wpt = btile_floats(dl, groups_of(dp, ZP_BN));
    wf_hi = take(wf);
    wf_lo = take(wf);
    wpt_hi = take(wpt);
    wpt_lo = take(wpt);
    zp = take(static_cast<long long>(n) * dp);
    dxh = take(static_cast<long long>(n) * d);
    const long long tt = btile_floats(n, groups_of(d, W_BN));
    const long long dzt = btile_floats(n, groups_of(dp, W_BN));
    tt_hi = take(tt);
    tt_lo = take(tt);
    dzt_hi = take(dzt);
    dzt_lo = take(dzt);
    part = take(chunks > 1 ? chunks * (static_cast<long long>(d + dp + 1) * d +
                                       static_cast<long long>(dl + 1) * dp)
                           : 0);
    total = at;
  }
};

}  // namespace

// Floats of scratch (16-byte aligned) the backward of an n-row call needs:
// Wf and Wpᵀ split, zp (when recomputed), dh, tᵀ and dzpᵀ split, and the
// weight gradients' chunk partials.
extern "C" long long repro_gather_fuse_backward_scratch(int n, int d, int dl, int dp) {
  return Parts(n, d, dl, dp).total;
}

// ids, sem_ids [n] int64 (rows of h_str [n_str, d] and of h_sem [n_sem, dl]);
// sorted_ids, order [n] int64: ids sorted stably, and each sorted position's
// index in ids, or both null (the segment sum then scans the ids for each
// id's rows: the same sums, quadratic in n; for small n); wp [dl, dp], bp [dp], wf [d + dp, d], bf [d]; zp [n, dp],
// the forward's z·Wp + bp, or null to recompute it; out [n, d], the
// forward's output; g [n, d]; scratch of repro_gather_fuse_backward_scratch
// floats, 16-byte aligned; dh_str [n_str, d], zero on entry; dwp, dbp, dwf,
// dbf written whole. All fp32 but the indices. Launches on `stream`: the
// weights' split, (the zp product,) dX, the weight gradients with the
// segment sum, (the chunk fold). Returns the CUDA error of the first launch
// that failed (0 = success).
extern "C" int repro_gather_fuse_backward(
    const long long* ids, const long long* sem_ids, const long long* sorted_ids,
    const long long* order, const float* h_str, const float* h_sem, const float* wp,
    const float* bp, const float* wf, const float* bf, const float* zp, const float* out,
    const float* g, float* scratch, float* dh_str, float* dwp, float* dbp, float* dwf,
    float* dbf, int n, long long n_str, long long n_sem, int d, int dl, int dp, void* stream) {
  if (n <= 0) return 0;
  if (out == nullptr || d < 1 || dl < 1 || dp < 1 || !aligned(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Parts P(n, d, dl, dp);
  Args a{};
  a.ids = ids; a.sem_ids = sem_ids; a.sorted = sorted_ids; a.order = order;
  a.h_str = h_str; a.h_sem = h_sem; a.wp = wp; a.bp = bp; a.wf = wf; a.bf = bf;
  a.out = out; a.g = g;
  a.zp_out = zp ? nullptr : scratch + P.zp;
  a.zp = zp ? zp : a.zp_out;
  a.wf_hi = scratch + P.wf_hi; a.wf_lo = scratch + P.wf_lo;
  a.wpt_hi = scratch + P.wpt_hi; a.wpt_lo = scratch + P.wpt_lo;
  a.dxh = scratch + P.dxh;
  a.tt_hi = scratch + P.tt_hi; a.tt_lo = scratch + P.tt_lo;
  a.dzt_hi = scratch + P.dzt_hi; a.dzt_lo = scratch + P.dzt_lo;
  a.part = scratch + P.part;
  a.dh = dh_str; a.dwp = dwp; a.dbp = dbp; a.dwf = dwf; a.dbf = dbf;
  a.n_str = n_str; a.n_sem = n_sem;
  a.n = n; a.d = d; a.dl = dl; a.dp = dp;
  a.g_wf = groups_of(d + dp, DX_BN); a.g_wpt = groups_of(dp, ZP_BN);
  a.g_tt = groups_of(d, W_BN); a.g_dzt = groups_of(dp, W_BN);
  a.chunks = cdiv(n, KC);
  a.vec_go = d % 4 == 0 && aligned(g) && aligned(out);
  a.vec_z = dl % 4 == 0 && aligned(h_sem);
  a.vec_x = d % 4 == 0 && dp % 4 == 0 && aligned(h_str) && aligned(a.zp);
  const int wfr = d + dp;
  a.n_wf = a.chunks * cdiv(wfr + 1, BM) * cdiv(d, W_BN);
  a.n_wp = a.chunks * cdiv(dl + 1, BM) * cdiv(dp, W_BN);

  int sms = 0, lim_zp = 0, lim_dx = 0, lim_w = 0;
  if (const int rc = sm_count(&sms)) return rc;
  if (const int rc = smem_limit<0>(reinterpret_cast<const void*>(fuse_bwd_zp_kernel), &lim_zp))
    return rc;
  if (const int rc = smem_limit<1>(reinterpret_cast<const void*>(fuse_bwd_dx_kernel), &lim_dx))
    return rc;
  if (const int rc = smem_limit<2>(reinterpret_cast<const void*>(fuse_bwd_weights_kernel), &lim_w))
    return rc;
  const size_t smem_zp = NST * stage_floats<1, ZP_BN>() * sizeof(float);
  const size_t smem_dx = NST * stage_floats<2, DX_BN>() * sizeof(float);
  const size_t smem_w = NST * stage_floats<1, W_BN>() * sizeof(float);
  if (smem_zp > static_cast<size_t>(lim_zp) || smem_dx > static_cast<size_t>(lim_dx) ||
      smem_w > static_cast<size_t>(lim_w))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_tiles = cdiv(n, BM);
  if (row_tiles * cdiv(wfr, DX_BN) * CHUNKS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  // 1. Wf (and, to recompute zp, Wpᵀ) split once.
  const long long nsplit = btile_floats(d, a.g_wf) + (zp ? 0LL : btile_floats(dl, a.g_wpt));
  const unsigned split_blocks = static_cast<unsigned>(std::min<long long>((nsplit + 255) / 256, 4LL * sms));
  fuse_bwd_split_kernel<<<split_blocks, 256, 0, s>>>(a, zp ? 0 : 1);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  // 2. zp, when not given: clusters of CHUNKS blocks where the tiles alone
  // would not fill the card, else a block chains a tile's chunks.
  if (!zp) {
    const long long tiles = row_tiles * cdiv(dp, ZP_BN);
    a.cl = tiles >= sms ? 1 : CHUNKS;
    if ((err = launch_clusters(fuse_bwd_zp_kernel, a, static_cast<int>(tiles * a.cl), a.cl, smem_zp, s)))
      return err;
  }
  // 3. dX, tᵀ and dzpᵀ, by the same rule.
  {
    const long long tiles = row_tiles * cdiv(wfr, DX_BN);
    a.cl = tiles >= sms ? 1 : CHUNKS;
    if ((err = launch_clusters(fuse_bwd_dx_kernel, a, static_cast<int>(tiles * a.cl), a.cl, smem_dx, s)))
      return err;
  }
  // 4. The weight gradients (chunk partials when n > KC) and dh_str.
  const int seg_blocks = cdiv(n, THREADS / 32);
  fuse_bwd_weights_kernel<<<a.n_wf + a.n_wp + seg_blocks, THREADS, smem_w, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  // 5. The chunk partials folded in order.
  if (a.chunks > 1) {
    const long long count = static_cast<long long>(wfr + 1) * d + static_cast<long long>(dl + 1) * dp;
    fuse_bwd_fold_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(a);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  return 0;
}
