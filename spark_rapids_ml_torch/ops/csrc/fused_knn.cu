// Fused squared-L2 distance + running top-k for exact k nearest neighbours,
// written for Hopper (sm_90a).  It replaces the Pallas kernel of
// spark_rapids_ml_tpu/ops/pallas_knn.py (`fused_topk_sqdist`, kernel body
// `_fused_kernel`): the same function, redesigned for the card.
//
// What it computes.  For every query row, the k valid items of least
// score = ||x||^2 - 2 q.x, ordered by (score, item position), so ties go to
// the lowest position as in the TPU kernel.  Invalid items never appear.
// The epilogue adds ||q||^2 and clamps at 0; slots past the valid count
// hold +inf and position -1.  Positions are int32; the caller maps them
// to user ids.
//
// float32 runs three kernels, launched in this order by the wrapper
// (spark_rapids_ml_torch/ops/fused_knn.py):
//
//   tf32_split_kernel      x -> (hi, lo) with hi = tf32(x), lo = tf32(x - hi),
//                          written as a (2, rows, d_pad) array, d_pad = d
//                          rounded up to BK = 32 floats (128 bytes), zeros in
//                          the pad.  One pass over items and one over queries.
//   fused_knn_tf32_kernel  the distance tile on the tensor cores and the
//                          top-k selection on its accumulators; each block
//                          owns BQ = 128 queries and one of S item splits,
//                          and leaves that split's sorted (score, position)
//                          list of each row in a (q, S, k) scratch.
//   merge_partials_regs_kernel / merge_partials_kernel
//                          merge the S lists of each row by (score,
//                          position) and apply the epilogue, float and
//                          double: one warp per row with the lists in
//                          registers for k <= 32, one thread per entry
//                          above.
//
// float32 with few queries (the wrapper's `route`: q <= _SMALL_Q and
// k <= 32) runs two instead: fused_knn_smallq_kernel, one pass over the
// raw items with the products in IEEE float32 on the CUDA cores, leaving
// the same (q, S, k) lists, and the merge pass.  Its design, and what
// bounds it, are described above the kernel.
//
// float64 runs two: fused_knn_f64_kernel (the distance tile on the FP64
// tensor cores, mma.sync m16n8k4 .f64, with the same grid, selection and
// partial lists as the float32 main kernel) and the merge pass.  Its
// design, and what bounds it, are described above the kernel.  float64
// with few queries (q <= _SMALL_Q_F64, k <= 32) takes
// fused_knn_smallq_f64_kernel instead: the small-q kernel's body on
// doubles (IEEE float64 FMAs on the CUDA cores), then the merge pass.
//
// What bounds the float32 kernel.  2*q*n*d multiply-adds against
// (n + q)*d input bytes: at any realistic q it is bound by operations.
// 3xTF32 spends three TF32 products per multiply-add, hi*hi + hi*lo +
// lo*hi, accumulated in float32: about float32 accuracy (rank-exact at the
// port's tolerances) at 495/3 = 165 TFLOP/s, 2.5x the 67 TFLOP/s of FP32 on
// the CUDA cores.  The bound is 3 * 2qnd / 495 TFLOP/s.
//
// What the design does about the four limits of the first design:
//   1. Too few blocks.  The grid is (ceil(q/BQ), S): the wrapper splits the
//      item sweep into S ranges (`auto_splits`: whole waves of blocks on the
//      132 SMs, each block paying a fixed cost besides its share), and the
//      merge pass joins the partial lists.  blockIdx.x (the query block)
//      runs fastest, so blocks that run together sweep the same item range
//      and L2 serves their item tiles.  The splits of a row share their
//      k-th entries through a 64-bit atomicMin per row (row_kth): any
//      split's k-th entry bounds the row's k-th over all items, so a split
//      that starts after another, or runs beside it, skips most of the
//      first tiles' candidates.  A partial list then holds only entries
//      that beat the others' bound (which ones depends on the order the
//      blocks run); the merged top-k does not.
//   2. No tensor cores.  The score tile is wgmma.mma_async m64n64k8 .tf32:
//      each of two consumer warpgroups owns 64 query rows and issues the
//      three products per k-step with both operands in shared memory,
//      K-major, under the 128-byte swizzle that TMA writes.  The split pass
//      rounds hi to TF32 before it forms lo (wgmma reads only the top 19
//      bits of each value), pads d to whole 128-byte rows (TMA needs 16-byte
//      row strides; d = 6, 17, 33 have none) and zero-fills the ragged
//      depth chunk.
//   3. No asynchronous copies.  One producer thread keeps TMA loads
//      (cp.async.bulk.tensor, completion on mbarriers) in flight into a ring
//      of STAGES item chunks; the consumers release a slot as soon as the
//      wgmma that read it has retired.  Where d_pad <= 128 the block's
//      queries (hi and lo) stay resident in shared memory for the whole
//      sweep; wider rows stream a query chunk beside every item chunk.
//      Item traffic: each block reads its split's hi and lo once, so a call
//      reads ceil(q/BQ) * n * d_pad * 8 bytes from L2 (about 81 GB at
//      1M x 128 items and 10k queries).  BQ = 128, not 256, because the
//      resident queries take 128 KB at d = 128; a 2-CTA cluster that
//      multicasts the item tile would halve those bytes and is later work.
//   4. Serialised selection.  There is no score tile in shared memory and
//      no block-wide barrier per tile.  In the wgmma accumulator layout a
//      thread holds 2 rows x 16 columns of a 64 x 64 tile; it turns them
//      into scores and compares each row's least with the row's current
//      k-th entry, kept in registers by the 4 lanes that share the row;
//      past the first tiles almost no warp finds a candidate and the tile
//      costs 32 fminf.  Survivors go to a per-row candidate buffer of CAP
//      slots in shared memory, their slots a prefix sum over the row's 4
//      lanes (no atomics).  The 16 rows of a warp are filled only by that
//      warp, so when a buffer would overflow the warp alone merges its rows'
//      buffers into their sorted running lists, refreshes the thresholds
//      and files the values that did not fit.  For k <= 32 a row's list
//      lives in the owning warp's registers (one entry per lane) and the
//      merge is a bitonic network; for larger k it lives in the (q, S, k)
//      scratch, merged by rank counting and a shift from the back, so any
//      k works.  The merge code is a rolled loop: it runs rarely, and kept
//      small it stays out of the way of the instruction cache.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared into a
// library with the plain C interface at the end of this file
// (spark_rapids_ml_torch/ops/_build.py does this at first use).  The
// tensor maps are encoded through cudaGetDriverEntryPoint, so the library
// needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) { return fmin(a, b); }

// (score, position) order.  An empty slot holds (+inf, -1); as unsigned
// its position is the largest, so it sorts after every real entry.
template <typename T>
__device__ __forceinline__ bool key_less(T a, int ai, T b, int bi) {
  return a < b || (a == b && (unsigned)ai < (unsigned)bi);
}

// A float32 (score, position) key as 64 bits whose unsigned order is
// key_less's: the score's bits mapped to an unsigned order above the
// position.  NO_KEY, all ones, stands for "none yet".
constexpr unsigned long long NO_KEY = ~0ull;
__device__ __forceinline__ unsigned long long pack_key(float d, int i) {
  uint32_t u = __float_as_uint(d == 0.0f ? 0.0f : d);  // -0 as +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)i;
}
__device__ __forceinline__ void unpack_key(unsigned long long key, float& d, int& i) {
  uint32_t u = (uint32_t)(key >> 32);
  d = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  i = (int)(uint32_t)key;
}

// A float64 score alone as 64 bits whose unsigned order is the score's
// (fused_knn.py `f64_order_key` is its plain version): 64 bits hold no
// position beside it.
__device__ __forceinline__ unsigned long long f64_key(double d) {
  unsigned long long u = (unsigned long long)__double_as_longlong(d == 0.0 ? 0.0 : d);
  return (u >> 63) ? ~u : (u | (1ull << 63));
}
__device__ __forceinline__ double f64_unkey(unsigned long long u) {
  return __longlong_as_double((long long)((u >> 63) ? (u & ~(1ull << 63)) : ~u));
}

// A row's filtering threshold from its own k-th entry (kth, kth_i), (+inf,
// -1) until the list holds k, and the k-th entries other splits of the row
// have published in `slot`; publishes its own.  Any split's k-th entry
// bounds the row's k-th over all items, so a value that does not beat the
// least of them cannot be in the merged top-k.
//
// float32 publishes (score, position) as one key.  float64 publishes the
// score alone, once the list is full: a candidate tied with another split's
// k-th score may still win on position, so the bound (pub, -1) keeps every
// score <= pub (position -1 is the largest as unsigned).
__device__ __forceinline__ void row_bound(unsigned long long* slot, float kth, int kth_i,
                                          float& td, int& ti) {
  const unsigned long long mine = kth_i >= 0 ? pack_key(kth, kth_i) : NO_KEY;
  const unsigned long long old = atomicMin(slot, mine);
  const unsigned long long best = old < mine ? old : mine;
  td = CUDART_INF_F;
  ti = -1;
  if (best != NO_KEY) unpack_key(best, td, ti);
}
__device__ __forceinline__ void row_bound(unsigned long long* slot, double kth, int kth_i,
                                          double& td, int& ti) {
  const unsigned long long mine = kth_i >= 0 ? f64_key(kth) : NO_KEY;
  const unsigned long long old = atomicMin(slot, mine);
  const double pub = old == NO_KEY ? CUDART_INF : f64_unkey(old);
  td = kth;
  ti = kth_i;
  if (key_less(pub, -1, kth, kth_i)) {
    td = pub;
    ti = -1;
  }
}

// ============================================================================
// float32: split pass
// ============================================================================

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 does, leaving the 13 low bits zero.  Written on the
// bits so that the plain version (fused_knn.py `tf32_split_reference`)
// reproduces it exactly.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t b = __float_as_uint(x);
  if ((b & 0x7F800000u) != 0x7F800000u) b = (b + 0x1000u) & 0xFFFFE000u;
  return __uint_as_float(b);
}

// One warp per row (d_pad is a multiple of 32), rows strided over the grid.
__global__ void tf32_split_kernel(const float* __restrict__ x,  // (rows, d)
                                  long long rows, int d, int d_pad,
                                  float* __restrict__ out) {    // (2, rows, d_pad)
  const long long lo_off = rows * d_pad;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long r = blockIdx.x * (long long)(blockDim.x >> 5) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    const float* xr = x + r * d;
    float* hr = out + r * d_pad;
    for (int c = lane; c < d_pad; c += 32) {
      const float v = c < d ? xr[c] : 0.0f;
      const float hi = tf32_rna(v);
      hr[c] = hi;
      hr[lo_off + c] = tf32_rna(v - hi);  // v - hi is exact
    }
  }
}

// ============================================================================
// float32: main kernel (3xTF32 wgmma, TMA ring, fused selection)
// ============================================================================

constexpr int BQ = 128;                    // query rows per block (2 warpgroups x 64)
constexpr int BN = 64;                     // items per tile (the wgmma N)
constexpr int BK = 32;                     // floats per depth chunk: one 128-byte row
constexpr int MAX_STAGES = 8;              // ring slots, as many as shared memory holds
constexpr int CAP = 32;                    // candidate slots per row
static_assert(CAP <= 32, "merge_row holds one candidate per lane");
constexpr int NCONSUMER = 256;             // two consumer warpgroups
constexpr int NTHREADS32 = NCONSUMER + 128;  // + one producer warpgroup
constexpr int RESIDENT_MAX_DPAD = 128;     // queries stay in smem up to this width
constexpr uint32_t SMEM_LIMIT = 232448;    // dynamic shared memory a block may take
constexpr uint32_t XCHUNK = 2u * BN * BK * 4;   // hi + lo item chunk, 16 KB
constexpr uint32_t QCHUNK = 2u * BQ * BK * 4;   // hi + lo query chunk, 32 KB

struct Smem32 {
  uint32_t qres, ring, stage_bytes, stages, cand_d, cand_i, cnt, thr_d, thr_i, bars, total;
};

// Resident queries (or none), a ring of as many slots as the block's
// shared memory holds (up to MAX_STAGES), then the candidate buffers, the
// row state and the barriers.  Offsets are from a base aligned up to 1024
// bytes, which the 128-byte swizzle needs; every tile starts on a multiple
// of 1024.
__host__ __device__ inline Smem32 smem32_layout(int kc_count, bool resident) {
  constexpr uint32_t rest = 2u * BQ * CAP * 4 + 3u * BQ * 4 + (2 * MAX_STAGES + 1) * 8;
  Smem32 s;
  s.qres = 0;
  s.ring = resident ? (uint32_t)kc_count * QCHUNK : 0u;
  s.stage_bytes = XCHUNK + (resident ? 0u : QCHUNK);
  const uint32_t used = 1024u + s.ring + rest;
  const uint32_t room = used < SMEM_LIMIT ? (SMEM_LIMIT - used) / s.stage_bytes : 0u;
  s.stages = room < (uint32_t)MAX_STAGES ? room : MAX_STAGES;
  s.cand_d = s.ring + s.stages * s.stage_bytes;
  s.cand_i = s.cand_d + BQ * CAP * 4;
  s.cnt = s.cand_i + BQ * CAP * 4;
  s.thr_d = s.cnt + BQ * 4;
  s.thr_i = s.thr_d + BQ * 4;
  s.bars = s.thr_i + BQ * 4;  // full[MAX_STAGES], empty[MAX_STAGES], qbar
  s.total = s.bars + (2 * MAX_STAGES + 1) * 8 + 1024u;  // + slack to align the base
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (d_pad, rows, 2) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(0), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); LBO is unused by this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across an asynchronous
// wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 per warpgroup) = A (64 x 8) * B (64 x 8)^T (+ d when scale_d).
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Merge row `lr`'s m (1..CAP) buffered candidates into its sorted running
// list od/oi of length k, in device memory, by one warp.  Each lane holds
// one candidate; a candidate's slot is its rank among the candidates plus
// the number of list entries ahead of it.  List entries from the first
// candidate's slot on move up by the number of candidates ahead of them,
// walking from the back: each group of 32 is read before any of it is
// written, and it only writes at or above its own lowest index.
template <typename T>
__device__ void merge_row(T* __restrict__ od, int* __restrict__ oi, int k, int m, T v, int vi,
                          int lane) {
  int rank = 0;
#pragma unroll 8
  for (int t = 0; t < 32; ++t) {
    const T tv = __shfl_sync(0xffffffffu, v, t);
    const int tvi = __shfl_sync(0xffffffffu, vi, t);
    rank += (t < m && key_less(tv, tvi, v, vi)) ? 1 : 0;
  }
  int tgt = 0x7fffffff;
  if (lane < m) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(od[mid], oi[mid], v, vi)) lo = mid + 1; else hi = mid;
    }
    tgt = rank + lo;
  }
  const int p0 = __reduce_min_sync(0xffffffffu, tgt);
  for (int top = k; top > p0; top -= 32) {
    const int i = top - 32 + lane;
    const bool act = i >= p0;
    T e = pos_inf<T>();
    int ei = -1;
    if (act) {
      e = od[i];
      ei = oi[i];
    }
    int less = 0;
#pragma unroll 8
    for (int t = 0; t < 32; ++t) {
      const T tv = __shfl_sync(0xffffffffu, v, t);
      const int tvi = __shfl_sync(0xffffffffu, vi, t);
      less += (t < m && key_less(tv, tvi, e, ei)) ? 1 : 0;
    }
    const int dst = i + less;
    __syncwarp();
    if (act && dst < k) {
      od[dst] = e;
      oi[dst] = ei;
    }
    __syncwarp();
  }
  if (lane < m && tgt < k) {
    od[tgt] = v;
    oi[tgt] = vi;
  }
  __syncwarp();
}

// One compare-exchange of a bitonic network across lanes `stride` apart:
// in a run sorted ascending the lower lane keeps the lesser key.
template <typename T>
__device__ __forceinline__ void bitonic_step(T& d, int& i, int stride, bool ascending, int lane) {
  const T od = __shfl_xor_sync(0xffffffffu, d, stride);
  const int oi = __shfl_xor_sync(0xffffffffu, i, stride);
  const bool keep_less = ((lane & stride) == 0) == ascending;
  if (keep_less ? key_less(od, oi, d, i) : key_less(d, i, od, oi)) {
    d = od;
    i = oi;
  }
}

// The same merge for k <= 32 with the running list in registers: lane j
// holds entry j (ld, li), +inf / -1 past the list.  A bitonic network sorts
// the candidates (one per lane, +inf / -1 past m); the lesser of list entry
// j and candidate 31 - j are the 32 least keys of both, a bitonic run that
// five more steps sort.  Entries past k are emptied.
template <typename T>
__device__ __forceinline__ void merge_row_regs(T& ld, int& li, int k, T v, int vi, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      bitonic_step(v, vi, stride, (lane & size) == 0, lane);
  const T rv = __shfl_sync(0xffffffffu, v, 31 - lane);
  const int rvi = __shfl_sync(0xffffffffu, vi, 31 - lane);
  if (key_less(rv, rvi, ld, li)) {
    ld = rv;
    li = rvi;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) bitonic_step(ld, li, stride, true, lane);
  if (lane >= k) {
    ld = pos_inf<T>();
    li = -1;
  }
}

// The selection on the accumulators, shared by the float32 and float64
// main kernels.  Both hold the distance tile in the same layout: a warp owns
// 16 query rows of the block (16 * warp ..), and a thread holds rows lr0 =
// 16 * warp + lane / 4 and lr1 = lr0 + 8, columns 8c + 2 * (lane % 4) + j
// of a 64-item tile, in s[4c + 2i + j] (i: row, j: column).  That is the
// wgmma m64nNk8 layout of the float32 kernel and the mma.sync m16n8 layout
// of the float64 one.
//
// Row r's sorted running list: with REG_LIST (k <= 32), entry `lane` of the
// warp's row 16 * warp + rr in (reg_d[rr], reg_i[rr]); else its slot of the
// (q, S, k) scratch, so that any k works.  The candidate buffers, counts and
// thresholds of a row live in shared memory and are touched only by the
// warp that owns the row, so nothing here needs a block barrier.
template <typename T, bool REG_LIST>
struct RowSelect {
  T* cand_d;  // (BQ, CAP)
  int* cand_i;
  int* cnt;   // (BQ,)
  T* thr_d;   // (BQ,)
  int* thr_i;
  unsigned long long* row_kth;  // (q,) k-th entries shared across splits
  T* part_d;                    // (q, splits, k)
  int* part_i;
  int q, k, splits, split, q0, warp, lane, lr0, lr1, col0;
  bool live0, live1;
  T th0, th1;
  int ti0, ti1;
  T reg_d[16];
  int reg_i[16];

  __device__ __forceinline__ T* list_d(int r) {
    return part_d + ((int64_t)(q0 + r) * splits + split) * k;
  }
  __device__ __forceinline__ int* list_i(int r) {
    return part_i + ((int64_t)(q0 + r) * splits + split) * k;
  }

  __device__ __forceinline__ void threshold(int r, T kth, int kth_i) {
    T td = pos_inf<T>();
    int ti = -1;
    if (q0 + r < q) row_bound(&row_kth[q0 + r], kth, kth_i, td, ti);
    thr_d[r] = td;
    thr_i[r] = ti;
    cnt[r] = 0;
  }

  // Empty lists and thresholds of the warp's rows.
  __device__ __forceinline__ void init() {
    const T INF = pos_inf<T>();
    lr0 = 16 * warp + (lane >> 2);
    lr1 = lr0 + 8;
    col0 = 2 * (lane & 3);
    live0 = q0 + lr0 < q;
    live1 = q0 + lr1 < q;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      reg_d[rr] = INF;
      reg_i[rr] = -1;
    }
    if constexpr (!REG_LIST) {
      for (int r = 16 * warp; r < 16 * warp + 16 && q0 + r < q; ++r) {
        T* od = list_d(r);
        int* oi = list_i(r);
        for (int j = lane; j < k; j += 32) {
          od[j] = INF;
          oi[j] = -1;
        }
      }
    }
    if (lane < 16) threshold(16 * warp + lane, INF, -1);
    __syncwarp();
    th0 = thr_d[lr0];
    th1 = thr_d[lr1];
    ti0 = thr_i[lr0];
    ti1 = thr_i[lr1];
  }

  // Merge every buffered row of this warp, then reload the thresholds.  A
  // rolled loop keeps this rarely run code small; with REG_LIST the row
  // being merged is always reg_*[0], and the lists rotate by one row per
  // step, so after 16 steps they are back in place.
  __device__ __forceinline__ void flush() {
    const T INF = pos_inf<T>();
#pragma unroll 1
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * warp + rr;
      const int m = min(cnt[r], CAP);
      if (m > 0) {  // the same for the whole warp
        T* bd = cand_d + r * CAP;
        int* bi = cand_i + r * CAP;
        const T v = lane < m ? bd[lane] : INF;
        const int vi = lane < m ? bi[lane] : -1;
        T kth;
        int kth_i;
        if constexpr (REG_LIST) {
          merge_row_regs(reg_d[0], reg_i[0], k, v, vi, lane);
          kth = __shfl_sync(0xffffffffu, reg_d[0], k - 1);
          kth_i = __shfl_sync(0xffffffffu, reg_i[0], k - 1);
        } else {
          merge_row(list_d(r), list_i(r), k, m, v, vi, lane);
          kth = list_d(r)[k - 1];
          kth_i = list_i(r)[k - 1];
        }
        if (lane == 0) threshold(r, kth, kth_i);
        __syncwarp();
      }
      if constexpr (REG_LIST) {
        const T d0 = reg_d[0];
        const int i0 = reg_i[0];
#pragma unroll
        for (int j = 0; j < 15; ++j) {
          reg_d[j] = reg_d[j + 1];
          reg_i[j] = reg_i[j + 1];
        }
        reg_d[15] = d0;
        reg_i[15] = i0;
      }
    }
    th0 = thr_d[lr0];
    ti0 = thr_i[lr0];
    th1 = thr_d[lr1];
    ti1 = thr_i[lr1];
  }

  // Scores of a finished tile against the thresholds; survivors to the
  // candidate buffers, merging the warp's rows whenever one would overflow.
  // The 4 lanes that share a row take consecutive slots (a prefix sum over
  // the 4), so filing needs no atomics.  A value past the buffer's end is
  // filed after the merge; it may no longer beat the k-th entry then, and
  // the merge drops it.
  __device__ __forceinline__ void select(const T (&score)[32], int n0) {
    const T INF = pos_inf<T>();
    // past the first tiles almost no score beats the k-th entry: look at
    // each row's least score first, and leave at once when no lane has one
    T least0 = INF, least1 = INF;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      if ((v >> 1) & 1) least1 = tmin(least1, score[v]);
      else least0 = tmin(least0, score[v]);
    }
    const bool any0 = live0 && least0 <= th0, any1 = live1 && least1 <= th1;
    if (!__any_sync(0xffffffffu, any0 || any1)) return;
    uint32_t pend = 0;  // bit v: score[v] beats its row's k-th entry
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i ? any1 : any0) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {  // the row's 16 values, s[4c + 2i + j]
            const int v = 4 * c + 2 * i + j;
            const int pos = n0 + 8 * c + col0 + j;
            if (score[v] < INF && key_less(score[v], pos, i ? th1 : th0, i ? ti1 : ti0))
              pend |= 1u << v;
          }
      }
    }
    while (true) {
      const int c0 = __popc(pend & 0x33333333u), c1 = __popc(pend & 0xCCCCCCCCu);
      int p0 = c0, p1 = c1;  // inclusive prefix sums over the row's 4 lanes
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, p0, o, 4);
        const int b = __shfl_up_sync(0xffffffffu, p1, o, 4);
        if ((lane & 3) >= o) {
          p0 += a;
          p1 += b;
        }
      }
      int s0 = cnt[lr0] + p0 - c0, s1 = cnt[lr1] + p1 - c1;
      __syncwarp();
      if ((lane & 3) == 3) {
        cnt[lr0] += p0;
        cnt[lr1] += p1;
      }
      __syncwarp();
      uint32_t keep = 0;
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        if (pend & (1u << v)) {
          const int i = (v >> 1) & 1;
          const int lr = i ? lr1 : lr0;
          const int slot = i ? s1++ : s0++;
          if (slot < CAP) {
            cand_d[lr * CAP + slot] = score[v];
            cand_i[lr * CAP + slot] = n0 + 8 * (v >> 2) + col0 + (v & 1);
          } else {
            keep |= 1u << v;
          }
        }
      }
      pend = keep;
      if (!__any_sync(0xffffffffu, keep != 0)) break;
      __syncwarp();
      flush();
    }
  }

  // After the sweep: merge what is buffered, and write the register lists
  // to the scratch.
  __device__ __forceinline__ void finish() {
    __syncwarp();
    flush();
    if constexpr (REG_LIST) {
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int r = 16 * warp + rr;
        if (q0 + r < q && lane < k) {
          list_d(r)[lane] = reg_d[rr];
          list_i(r)[lane] = reg_i[rr];
        }
      }
    }
  }
};

// REG_LIST: k <= 32, each row's running list in the registers of the warp
// that owns the row; otherwise in the row's slot of the (q, S, k) scratch.
template <bool REG_LIST>
__global__ void __launch_bounds__(NTHREADS32, 1)
fused_knn_tf32_kernel(const __grid_constant__ CUtensorMap xmap,  // items (d_pad, n, 2)
                      const __grid_constant__ CUtensorMap qmap,  // queries (d_pad, q, 2)
                      const float* __restrict__ xs,  // (n_tiles*BN,) ||x||^2, +inf where invalid
                      int q, int k, int kc_count, int tiles_per_split, int n_tiles,
                      int splits, int resident,
                      float* __restrict__ part_d,    // (q, splits, k)
                      int* __restrict__ part_i,
                      unsigned long long* __restrict__ row_kth) {  // (q,) NO_KEY at launch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem32 L = smem32_layout(kc_count, resident != 0);
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128-byte swizzle atoms
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  float* cand_d = reinterpret_cast<float*>(gbase + L.cand_d);
  int* cand_i = reinterpret_cast<int*>(gbase + L.cand_i);
  int* cnt = reinterpret_cast<int*>(gbase + L.cnt);
  float* thr_d = reinterpret_cast<float*>(gbase + L.thr_d);
  int* thr_i = reinterpret_cast<int*>(gbase + L.thr_i);
  const uint32_t full0 = base + L.bars;
  const uint32_t empty0 = full0 + MAX_STAGES * 8;
  const uint32_t qbar = empty0 + MAX_STAGES * 8;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (tid == 0) {
    for (int s = 0; s < (int)L.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONSUMER / 32);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONSUMER) {
    // ---- producer: one thread keeps the ring full --------------------------
    if (tid == NCONSUMER) {
      if (resident) {
        mbar_expect_tx(qbar, (uint32_t)kc_count * QCHUNK);
        for (int kc = 0; kc < kc_count; ++kc)
          tma_load_3d(base + L.qres + kc * QCHUNK, &qmap, kc * BK, q0, qbar);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int kc = 0; kc < kc_count; ++kc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1u);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t slot = base + L.ring + stage * L.stage_bytes;
          mbar_expect_tx(full, L.stage_bytes);
          tma_load_3d(slot, &xmap, kc * BK, t * BN, full);
          if (!resident) tma_load_3d(slot + XCHUNK, &qmap, kc * BK, q0, full);
          if (++stage == (int)L.stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups of 64 query rows each ---------------------
  const int wg = tid >> 7;
  const int lane = tid & 31;
  RowSelect<float, REG_LIST> sel;
  sel.cand_d = cand_d;
  sel.cand_i = cand_i;
  sel.cnt = cnt;
  sel.thr_d = thr_d;
  sel.thr_i = thr_i;
  sel.row_kth = row_kth;
  sel.part_d = part_d;
  sel.part_i = part_i;
  sel.q = q;
  sel.k = k;
  sel.splits = splits;
  sel.split = split;
  sel.q0 = q0;
  sel.warp = tid >> 5;  // 0..7; rows 16*warp .. 16*warp + 15 of the block
  sel.lane = lane;
  sel.init();

  if (resident) mbar_wait(qbar, 0);
  const uint32_t arow = wg * 64 * (BK * 4);  // this warpgroup's 64 rows in a query chunk
  int stage = 0;
  uint32_t phase = 0;
  int pending = -1;  // ring slot of the last chunk issued and not yet released

  // The three products of depth chunk kc into acc (one commit group); then
  // release the slot of the chunk issued before it, whose products have
  // retired once at most this group is in flight.
  auto issue = [&](float (&acc)[32], int kc) {
    mbar_wait(full0 + 8 * stage, phase);
    const uint32_t xa = base + L.ring + stage * L.stage_bytes;
    const uint32_t qa = resident ? base + L.qres + kc * QCHUNK : xa + XCHUNK;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const uint64_t a_hi = smem_desc(qa + arow + 32 * s);
      const uint64_t a_lo = smem_desc(qa + BQ * BK * 4 + arow + 32 * s);
      const uint64_t b_hi = smem_desc(xa + 32 * s);
      const uint64_t b_lo = smem_desc(xa + BN * BK * 4 + 32 * s);
      wgmma_tf32_m64n64k8(acc, a_hi, b_lo, (kc | s) != 0);
      wgmma_tf32_m64n64k8(acc, a_lo, b_hi, 1);
      wgmma_tf32_m64n64k8(acc, a_hi, b_hi, 1);
    }
    wgmma_commit();
    if (pending >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty0 + 8 * pending);
    }
    pending = stage;
    if (++stage == (int)L.stages) {
      stage = 0;
      phase ^= 1u;
    }
  };

  // Each tile: every depth chunk into acc, all retired before the
  // selection, so no wgmma is in flight across its divergent code (ptxas
  // would serialise every wgmma otherwise).  The two warpgroups overlap
  // one's selection with the other's products.
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * BN;
    float2 xv[BN / 8];
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
      xv[c] = *reinterpret_cast<const float2*>(xs + n0 + 8 * c + sel.col0);
    for (int kc = 0; kc < kc_count; ++kc) issue(acc, kc);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * pending);
    pending = -1;
    fence_acc(acc);
#pragma unroll
    for (int v = 0; v < 32; ++v) {  // scores, in place, on every lane
      const float2 x2 = xv[v >> 2];
      acc[v] = (v & 1 ? x2.y : x2.x) - 2.0f * acc[v];
    }
    sel.select(acc, n0);
  }
  sel.finish();
}

// ============================================================================
// merge pass (float and double)
// ============================================================================

// Entries of list t (sorted, empties last) that come before (v, vi), and
// with `or_equal` those equal to it too.
template <typename T>
__device__ __forceinline__ int count_before(const T* __restrict__ ld, const int* __restrict__ li,
                                            int k, T v, int vi, bool or_equal) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (or_equal ? !key_less(v, vi, ld[mid], li[mid]) : key_less(ld[mid], li[mid], v, vi))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// k <= 32: one warp per row, the row's running top-k in registers (lane j
// holds entry j).  List 0 is the first running list; each further list is
// read coalesced (the next one in flight while this one merges) and joined
// as merge_row_regs does, with no sort: the list is sorted already, so the
// lesser of entry j and the list's entry 31 - j are the 32 least keys of
// both, a bitonic run that five steps sort.  Empty slots (+inf, -1) sort
// last.  d^2 = max(score + ||q||^2, 0).
template <typename T>
__global__ void __launch_bounds__(256)
merge_partials_regs_kernel(const T* __restrict__ part_d,  // (q, S, k)
                           const int* __restrict__ part_i,
                           const T* __restrict__ q2,      // (q,)
                           int q, int S, int k,
                           T* __restrict__ out_d,         // (q, k)
                           int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const T INF = pos_inf<T>();
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); row < q;
       row += warps) {
    const T* rd = part_d + row * S * k + lane;
    const int* ri = part_i + row * S * k + lane;
    const bool mine = lane < k;
    T ld = mine ? rd[0] : INF;
    int li = mine ? ri[0] : -1;
    T nd = INF;
    int ni = -1;
    if (S > 1 && mine) {
      nd = rd[k];
      ni = ri[k];
    }
    for (int s = 1; s < S; ++s) {
      const T vd = nd;
      const int vi = ni;
      if (s + 1 < S && mine) {
        nd = rd[(s + 1) * k];
        ni = ri[(s + 1) * k];
      }
      const T rv = __shfl_sync(0xffffffffu, vd, 31 - lane);
      const int rvi = __shfl_sync(0xffffffffu, vi, 31 - lane);
      if (key_less(rv, rvi, ld, li)) {
        ld = rv;
        li = rvi;
      }
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1) bitonic_step(ld, li, stride, true, lane);
    }
    if (mine) {
      const T d2 = ld + q2[row];
      out_d[row * k + lane] = li < 0 ? INF : (d2 > T(0) ? d2 : T(0));
      out_i[row * k + lane] = li;
    }
  }
}

// Larger k: one thread per entry of the (q, S, k) lists, so a row's S * k
// entries spread over S * k / 32 warps and a few rows still fill the card
// (at k = 1000, S = 32 a row is 32,000 entries: one warp per row would
// leave it to 32 lanes).  An entry's slot in the merged row is its index
// in its own list plus the entries of the other lists ahead of it, a
// binary search in each, read where they lie (the lanes of a warp hold
// neighbouring entries of one list and walk nearly the same paths, so most
// reads hit L1); the searches stop once the slot is past k.  Equal keys,
// which only empty slots (+inf, -1) share, go to the lower list: the S * k
// entries take distinct slots, so the first k slots are all written
// without counting the row's real entries.  d^2 = max(score + ||q||^2, 0).
template <typename T>
__global__ void __launch_bounds__(256)
merge_partials_kernel(const T* __restrict__ part_d,  // (q, S, k)
                      const int* __restrict__ part_i,
                      const T* __restrict__ q2,      // (q,)
                      int q, int S, int k,
                      T* __restrict__ out_d,         // (q, k)
                      int* __restrict__ out_i) {
  const long long per_row = (long long)S * k, total = (long long)q * per_row;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < total;
       g += (long long)gridDim.x * blockDim.x) {
    const long long row = g / per_row;
    const long long e = g - row * per_row;
    const int s = (int)(e / k);
    const T* ld = part_d + row * per_row;
    const int* li = part_i + row * per_row;
    const T v = part_d[g];
    const int vi = part_i[g];
    int rank = (int)(e - (long long)s * k);
    for (int t = 0; t < S && rank < k; ++t)
      if (t != s)
        rank += count_before(ld + (long long)t * k, li + (long long)t * k, k, v, vi, t < s);
    if (rank < k) {
      const T d2 = v + q2[row];
      out_d[row * k + rank] = vi < 0 ? pos_inf<T>() : (d2 > T(0) ? d2 : T(0));
      out_i[row * k + rank] = vi;
    }
  }
}

// ============================================================================
// float64: main kernel (mma.sync .f64 on the FP64 tensor cores, cp.async ring)
// ============================================================================
//
// What bounds it.  2*q*n*d multiply-adds in float64 against (n + q)*d*8
// input bytes: bound by operations, on the FP64 tensor cores (DMMA) at
// 67 TFLOP/s, twice the FP64 FMA rate of the CUDA cores.  There is no
// wgmma for float64: the products are mma.sync m16n8k4 .f64 issued by each
// warp from shared memory, and at that size a product reads more shared
// memory per operation than wgmma does, so the tile is blocked for reuse.
//
// The design, against the four limits of the first design (FP64 FMA on the
// CUDA cores, one block per 64 queries sweeping every item):
//   1. Too few blocks.  The grid is (ceil(q/BQD), S), as for float32: the
//      wrapper splits the item sweep (`auto_splits` with this kernel's BQD
//      and its 12-byte scratch entries), the merge pass joins the lists.
//      The splits of a row share their k-th SCORES (row_bound): a double
//      and a position do not fit one 64-bit atomicMin, so the score alone
//      is published, once a split's list holds k entries, and a candidate
//      is dropped only when its score is strictly greater (a tie may still
//      win on position).
//   2. No tensor cores.  Each of 8 warps owns 16 query rows and computes
//      their 16 x 64 tile as 8 m16n8k4 products per k-step: an A fragment
//      (2 doubles a lane) is reused across the 8 item tiles, so a k-step
//      reads 2.5 KB of shared memory per 8 KFLOP (about 86 B/cycle per SM
//      at the DMMA rate, under the SM's 128).  A row belongs to one warp and
//      4 lanes, in the accumulator layout the float32 selection takes, so
//      the selection (RowSelect) is the same code, on doubles.  A wider warp
//      tile (32 x 64, 0.19 B/FLOP) would need 128 accumulator registers
//      beside the register lists; the kernel takes 203 as it is.
//   3. Synchronous loads.  cp.async (16 bytes where d is even and the
//      arrays are 16-byte aligned, else 8) fills a ring of STAGES64 chunks
//      of BKD = 32 doubles (256-byte rows), with zero-fill for rows past n
//      or q and the ragged depth chunk, so any d works and no padded copy is
//      made (TMA would need 16-byte row strides: d = 17, 33 have none).
//      Rows are swizzled (16-byte unit u of row r at u ^ 2 (r % 4)), so
//      the fragment loads of a half-warp hit 16 distinct bank pairs.  Where
//      d <= 128 the block's queries stay resident (128 KB at d = 128); wider
//      rows stream a query chunk beside every item chunk.
//   4. Serialised selection.  As for float32: scores on the accumulators,
//      a per-row least against per-lane thresholds, prefix-sum filing,
//      per-warp merges (register lists and a bitonic network for k <= 32).
// One barrier per depth chunk keeps the ring: a chunk's slot is refilled
// only after every warp has read it.  With one block of 8 warps on an SM
// those barriers and the products' latency are what is left between the
// kernel and the DMMA rate: chunks of 32 doubles in a ring of 2 (one
// barrier per 64 products a warp) took about a sixth less time at the
// main shape than chunks of 16 in a ring of 4 on an H100 (PERF.md).

constexpr int BQD = 128;                  // query rows per block: 8 warps x 16
constexpr int BND = 64;                   // items per tile
constexpr int BKD = 32;                   // doubles per depth chunk: a 256-byte row
constexpr uint32_t ROW64 = BKD * 8;       // bytes of a chunk's row
constexpr int NTHREADS64 = 256;
constexpr int STAGES64 = 2;               // ring slots
constexpr int RESIDENT64_MAX_KC = 4;      // queries stay in smem up to d = 128
constexpr uint32_t XCHUNK64 = BND * BKD * 8;  // item chunk, 16 KB
constexpr uint32_t QCHUNK64 = BQD * BKD * 8;  // query chunk, 32 KB

struct Smem64 {
  uint32_t qres, ring, stage_bytes, cand_d, thr_d, cand_i, cnt, thr_i, total;
};

// Resident queries (or none), the ring, then the candidate buffers and
// the row state.  Every part is a multiple of 16 bytes.
__host__ __device__ inline Smem64 smem64_layout(int kc_count, bool resident) {
  Smem64 s;
  s.qres = 0;
  s.ring = resident ? (uint32_t)kc_count * QCHUNK64 : 0u;
  s.stage_bytes = XCHUNK64 + (resident ? 0u : QCHUNK64);
  s.cand_d = s.ring + STAGES64 * s.stage_bytes;
  s.thr_d = s.cand_d + BQD * CAP * 8;
  s.cand_i = s.thr_d + BQD * 8;
  s.cnt = s.cand_i + BQD * CAP * 4;
  s.thr_i = s.cnt + BQD * 4;
  s.total = s.thr_i + BQD * 4;
  return s;
}
static_assert(RESIDENT64_MAX_KC * QCHUNK64 + STAGES64 * XCHUNK64 + BQD * CAP * 12 + BQD * 16 <=
                  SMEM_LIMIT,
              "resident float64 layout exceeds shared memory");

// Byte offset of element c (0..BKD-1) of row r in a swizzled chunk.
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return (uint32_t)r * ROW64 + ((uint32_t)((c >> 1) ^ ((r & 3) << 1)) << 4) + ((c & 1) << 3);
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1 of a row-major (limit, d) float64 array,
// columns col0 .. col0 + BKD - 1, into the swizzled chunk at dst; rows
// past limit and columns past d read as zeros.  16-byte copies where d is
// even and the arrays 16-byte aligned (vec16), else 8-byte copies, which
// take any d: at 1M x 128 float64 items and 10k queries the function takes
// 8% longer with 8-byte copies alone on an H100 (PERF.md).
template <int ROWS>
__device__ __forceinline__ void load_chunk64(uint32_t dst, const double* __restrict__ src,
                                             long long row0, long long limit, int d, int col0,
                                             bool vec16, int tid) {
  if (vec16) {
#pragma unroll
    for (int it = 0; it < ROWS * (BKD / 2) / NTHREADS64; ++it) {
      const unsigned u = tid + it * NTHREADS64;
      const int r = u / (BKD / 2), cu = u % (BKD / 2), c = col0 + 2 * cu;
      const long long row = row0 + r;
      const bool ok = row < limit && c < d;
      cp_async16(dst + r * ROW64 + ((cu ^ ((r & 3) << 1)) << 4), ok ? src + row * d + c : src,
                 ok ? 16u : 0u);
    }
  } else {
#pragma unroll
    for (int it = 0; it < ROWS * BKD / NTHREADS64; ++it) {
      const unsigned e = tid + it * NTHREADS64;
      const int r = e / BKD, c = col0 + e % BKD;
      const long long row = row0 + r;
      const bool ok = row < limit && c < d;
      cp_async8(dst + sw64(r, e % BKD), ok ? src + row * d + c : src, ok ? 8u : 0u);
    }
  }
}

// d (16 x 8) += a (16 x 4, row) * b (4 x 8, col), float64 on the tensor
// cores.  Lane l holds a[l/4][l%4] and a[l/4 + 8][l%4], b[l%4][l/4], and
// d[l/4][2(l%4) + j] in dj, d[l/4 + 8][2(l%4) + j] in d(2+j).
__device__ __forceinline__ void dmma_16x8x4(double& d0, double& d1, double& d2, double& d3,
                                            double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64"
      " {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

template <bool REG_LIST>
__global__ void __launch_bounds__(NTHREADS64, 1)
fused_knn_f64_kernel(const double* __restrict__ items,    // (n, d)
                     const double* __restrict__ queries,  // (q, d)
                     const double* __restrict__ xs,  // (n_tiles*BND,) ||x||^2, +inf where invalid
                     int n, int q, int d, int k, int kc_count, int tiles_per_split, int n_tiles,
                     int splits, int resident, int vec16,
                     double* __restrict__ part_d,  // (q, splits, k)
                     int* __restrict__ part_i,
                     unsigned long long* __restrict__ row_kth) {  // (q,) NO_KEY at launch
  extern __shared__ __align__(16) unsigned char smem64_raw[];
  const Smem64 L = smem64_layout(kc_count, resident != 0);
  const uint32_t base = smem_u32(smem64_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // 0..7; rows 16*warp .. 16*warp + 15 of the block
  const int q0 = blockIdx.x * BQD;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int steps = (t_end - t_begin) * kc_count;  // (tile, depth chunk) pairs

  RowSelect<double, REG_LIST> sel;
  sel.cand_d = reinterpret_cast<double*>(smem64_raw + L.cand_d);
  sel.cand_i = reinterpret_cast<int*>(smem64_raw + L.cand_i);
  sel.cnt = reinterpret_cast<int*>(smem64_raw + L.cnt);
  sel.thr_d = reinterpret_cast<double*>(smem64_raw + L.thr_d);
  sel.thr_i = reinterpret_cast<int*>(smem64_raw + L.thr_i);
  sel.row_kth = row_kth;
  sel.part_d = part_d;
  sel.part_i = part_i;
  sel.q = q;
  sel.k = k;
  sel.splits = splits;
  sel.split = split;
  sel.q0 = q0;
  sel.warp = warp;
  sel.lane = lane;
  sel.init();

  // The loads of step g into ring slot g % STAGES64, one commit group per
  // step (empty past the last step, so the wait below counts evenly).
  auto load_step = [&](int g) {
    if (g < steps) {
      const int kc = g % kc_count;
      const uint32_t slot = base + L.ring + (g % STAGES64) * L.stage_bytes;
      load_chunk64<BND>(slot, items, (long long)(t_begin + g / kc_count) * BND, n, d, kc * BKD,
                        vec16 != 0, tid);
      if (!resident)
        load_chunk64<BQD>(slot + XCHUNK64, queries, q0, q, d, kc * BKD, vec16 != 0, tid);
    }
    cp_async_commit();
  };
  if (resident)  // part of the first group
    for (int kc = 0; kc < kc_count; ++kc)
      load_chunk64<BQD>(base + L.qres + kc * QCHUNK64, queries, q0, q, d, kc * BKD, vec16 != 0,
                        tid);
  for (int g = 0; g < STAGES64 - 1; ++g) load_step(g);

  // Fragment offsets of this lane: A rows 16*warp + lane/4 (+ 8), B rows
  // (items) 8j + lane/4, column 4kk + lane%4 of the chunk.  All these rows
  // have r % 4 = g3, so the column's offset in the row, sw64(r, 4kk +
  // lane%4) - r * ROW64, is 32 (kk ^ g3) + 8 (lane % 4) for every one.
  const int g8 = lane >> 2, t4 = lane & 3, g3 = g8 & 3;
  const uint32_t arow0 = (16 * warp + g8) * ROW64, arow1 = arow0 + 8 * ROW64;
  const uint32_t brow = g8 * ROW64;

  double acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0;
  for (int g = 0; g < steps; ++g) {
    cp_async_wait<STAGES64 - 2>();
    __syncthreads();  // step g has landed for every thread; slot (g - 1) is free
    load_step(g + STAGES64 - 1);
    const int kc = g % kc_count;
    const unsigned char* xa = smem64_raw + L.ring + (g % STAGES64) * L.stage_bytes;
    const unsigned char* qa = resident ? smem64_raw + L.qres + kc * QCHUNK64 : xa + XCHUNK64;
#pragma unroll
    for (int kk = 0; kk < BKD / 4; ++kk) {
      const uint32_t koff = ((kk ^ g3) << 5) + (t4 << 3);
      const double a0 = *reinterpret_cast<const double*>(qa + arow0 + koff);
      const double a1 = *reinterpret_cast<const double*>(qa + arow1 + koff);
#pragma unroll
      for (int j = 0; j < BND / 8; ++j) {
        const double b = *reinterpret_cast<const double*>(xa + brow + j * 8 * ROW64 + koff);
        dmma_16x8x4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3], a0, a1, b);
      }
    }
    if (kc == kc_count - 1) {  // the tile is done: scores, in place, then selection
      const int n0 = (t_begin + g / kc_count) * BND;
#pragma unroll
      for (int c = 0; c < BND / 8; ++c) {
        const double2 x2 = *reinterpret_cast<const double2*>(xs + n0 + 8 * c + sel.col0);
        acc[4 * c] = x2.x - 2.0 * acc[4 * c];
        acc[4 * c + 1] = x2.y - 2.0 * acc[4 * c + 1];
        acc[4 * c + 2] = x2.x - 2.0 * acc[4 * c + 2];
        acc[4 * c + 3] = x2.y - 2.0 * acc[4 * c + 3];
      }
      sel.select(acc, n0);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0;
    }
  }
  cp_async_wait<0>();
  sel.finish();
}

// ============================================================================
// small q, float32 and float64: one streaming pass over the raw items (CUDA cores)
// ============================================================================
//
// fused_knn_smallq_kernel (float32) and fused_knn_smallq_f64_kernel
// (float64) serve the TPU kernel's function
// (spark_rapids_ml_tpu/ops/pallas_knn.py:113 `fused_topk_sqdist`) where a
// call brings few queries: a served kNN batch, a kneighbors call with a
// handful of rows.  They leave the same (q, S, k) sorted partial lists as
// the main kernels, and the merge pass joins them.  Both are one body,
// smallq_body<T, QT>, on the element type T.
//
// What bounds them.  The items are read once, n * d * sizeof(T) bytes
// (float32 512 MB at 1M x 128: 0.153 ms at 3.35 TB/s; float64 1 GB: 0.306
// ms), against 2 * q * n * d operations in IEEE FMAs on the CUDA cores
// (67 TFLOP/s in float32, 34 in float64): bound by bytes up to q of about
// 40 in float32 and 20 in float64, by operations above.  The main kernels
// cannot come near that at small q: their blocks carry 128 query rows (127
// of them padding at q = 1), their grid is ceil(q / 128) x at most 32
// splits, and every call reads the items once more before the main kernel
// (float32: writes their TF32 halves, 1 GB at 1M x 128, and their norms;
// float64: their norms, 1 GB read).
//
// The design:
//   1. One pass over the raw items.  No split pass and no norms pass: the
//      kernel reads the row-major (n, d) items as they are staged and forms
//      ||x||^2 from the same values it multiplies; items whose item_valid
//      is not > 0, and rows past n, never become candidates.
//   2. Fill the card.  A block takes up to QMAX queries (QT, a power of
//      two >= q, is a template argument, so q = 1 spends no work on padded
//      rows) and one contiguous range of SQ_TILE-item tiles; the wrapper
//      picks the split count S so that the grid is one wave of resident
//      blocks (`smallq_splits`: not bounded by the main kernels' 32).
//      Each block reduces its 256 threads' candidates into one list per
//      query, so the merge pass walks one list per block.
//   3. Asynchronous loads.  Each step brings one depth chunk (a 128-byte
//      row: SqType<T>::DC = 32 floats or 16 doubles) of a 256-item tile and
//      of the block's queries into a ring of as many slots as shared memory
//      holds (`smallq_stages`: 4 at the largest QT of either type, 6 at
//      QT <= 4, so at q = 1 five 36 KB chunks are in flight on each SM, far
//      above what the SM's share of the bandwidth needs to cover the
//      latency), with cp.async (16-byte copies where d is a multiple of the
//      16-byte vector and the arrays are 16-byte aligned, else copies of
//      one element; zero-fill past n, q and d), so any width works and a
//      chunk lands while the one before it is used.  An item row sits at a
//      stride of one vector more than the chunk (SqType<T>::XS): the
//      16-byte reads of 8 neighbouring rows fall in 8 distinct 16-byte
//      bank groups.
//   4. Math.  IEEE fma in depth order, score = ||x||^2 - 2 q.x as the
//      plain version, QT accumulators a thread in registers.  From QT = 8
//      on, a thread holds 4 items (rows g + 64 r of the tile) and a quarter
//      of the queries (the same quarter across a warp, so every query read
//      is a broadcast): each 16-byte vector of a query read from shared
//      memory feeds 4 x VEC FMAs, not VEC.  One item and every query a
//      thread at QT <= 4, where the bytes bound it.  float64 takes at most
//      32 queries a block (QMAX): 4 items x 8 queries = 32 double
//      accumulators, the 64 registers the float32 kernel's 4 x 16 take;
//      q = 64 is two query blocks that sweep the same split side by side,
//      so L2 serves the second its items.
//   5. Selection.  Each score is compared with its query's k-th key in
//      shared memory; survivors of a warp take consecutive slots of the
//      query's SQ_CAP-slot buffer from one atomicAdd.  When a buffer would
//      overflow, the block stops once (a barrier that also asks whether
//      anyone waits), each warp merges the buffers of its queries into
//      their sorted lists (merge_row_regs, k <= 32 in one register a lane),
//      publishes the k-th entry through row_kth as the main kernels do
//      (float32 the (score, position) key; float64 the score alone, and a
//      candidate is dropped only when its score is strictly greater, as in
//      fused_knn_f64_kernel), and the waiting values are filed again.  Past
//      the first tiles almost no score beats the k-th key, and the
//      selection costs a compare per query and item.
// No tensor cores: at a few queries their tiles would be mostly padding.
// What is left between the float32 kernel and its bound at q = 64 (27% of
// the FP32 bound on an H100; PERF.md, PR 18) is, by the instruction mix,
// the shared-memory data path: a warp's 16-byte read of a query writes 512
// bytes into its registers, 4 cycles of the SM's 128 B a cycle, and 20
// such reads come with 256 FMAs a warp (float64 at QT = 32: 12 reads with
// 64 FMAs, each FMA half the float32 rate).  Above QMAX queries the grid
// takes ceil(q / QMAX) query blocks, each sweeping the items again (the
// route sends up to _SMALL_Q / _SMALL_Q_F64 queries here: above that the
// main kernels are faster).  The float64 instance at 1M x 128 reads the
// items at about 80% of the bytes bound at q = 1 (the kernel alone), and
// at q = 32 the call takes about 3.6x its FP64 FMA time at 34 TFLOP/s
// (PERF.md, PR 19): by the same count, the shared-memory data path.

constexpr int SQ_THREADS = 256;
constexpr int SQ_TILE = SQ_THREADS;   // items per tile
constexpr int SQ_WARPS = SQ_THREADS / 32;
constexpr int SQ_MAX_STAGES = 6;      // ring slots, as many as shared memory holds
constexpr int SQ_CAP = 64;            // candidate slots per query

// What the element type fixes: the 16-byte vector V of VEC elements, the
// elements of a 128-byte depth chunk (DC), an item row's stride in a chunk
// (XS, one vector more) and the queries a block takes (QMAX).
template <typename T>
struct SqType;
template <>
struct SqType<float> {
  using V = float4;
  static constexpr int VEC = 4, DC = 32, XS = DC + VEC, QMAX = 64;
};
template <>
struct SqType<double> {
  using V = double2;
  static constexpr int VEC = 2, DC = 16, XS = DC + VEC, QMAX = 32;
};

struct SmemSQ {
  uint32_t qchunk, stage_bytes, list_d, cand_d, thr_d, list_i, cand_i, cnt, thr_i, total;
};

// Ring slots of the small-q kernel of type T with query block qt: as many
// as the block's shared memory holds beside the per-query state (a list
// of 32, SQ_CAP candidates and a threshold, each a T and an int, and a
// count), at most SQ_MAX_STAGES.
template <typename T>
__host__ __device__ constexpr int smallq_stages(int qt) {
  const uint32_t rows = (uint32_t)qt * ((32 + SQ_CAP + 1) * ((uint32_t)sizeof(T) + 4) + 4);
  const uint32_t stage =
      (SQ_TILE * SqType<T>::XS + (uint32_t)qt * SqType<T>::DC) * (uint32_t)sizeof(T);
  const uint32_t fit = (SMEM_LIMIT - rows) / stage;
  return fit < (uint32_t)SQ_MAX_STAGES ? (int)fit : SQ_MAX_STAGES;
}
static_assert(smallq_stages<float>(SqType<float>::QMAX) >= 3, "small-q ring too shallow");
static_assert(smallq_stages<double>(SqType<double>::QMAX) >= 3, "small-q ring too shallow");

// Query groups of the small-q kernel with query block qt: 4 from qt = 8
// on (each thread then holds 4 items and qt / 4 queries), else 1 (one item
// and every query).
__host__ __device__ constexpr int smallq_groups(int qt) { return qt >= 8 ? 4 : 1; }

// The ring (each slot a chunk of 256 item rows, then QT query rows), then
// the T arrays of QT queries (running lists, candidate buffers,
// thresholds; 8-byte aligned for double), then their int arrays.
template <typename T>
__host__ __device__ inline SmemSQ smemsq_layout(int qt) {
  constexpr uint32_t E = sizeof(T);
  SmemSQ s;
  s.qchunk = SQ_TILE * SqType<T>::XS * E;
  s.stage_bytes = s.qchunk + (uint32_t)qt * SqType<T>::DC * E;
  s.list_d = smallq_stages<T>(qt) * s.stage_bytes;
  s.cand_d = s.list_d + qt * 32 * E;
  s.thr_d = s.cand_d + qt * SQ_CAP * E;
  s.list_i = s.thr_d + qt * E;
  s.cand_i = s.list_i + qt * 32 * 4;
  s.cnt = s.cand_i + qt * SQ_CAP * 4;
  s.thr_i = s.cnt + qt * 4;
  s.total = s.thr_i + qt * 4;
  return s;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// One element's copy: 4 bytes of a float, 8 of a double.
__device__ __forceinline__ void cp_async_elem(uint32_t dst, const float* src, uint32_t bytes) {
  cp_async4(dst, src, bytes);
}
__device__ __forceinline__ void cp_async_elem(uint32_t dst, const double* src, uint32_t bytes) {
  cp_async8(dst, src, bytes);
}

// s + a . b over one 16-byte vector, in depth order.
__device__ __forceinline__ float dot_acc(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}
__device__ __forceinline__ double dot_acc(double2 a, double2 b, double s) {
  s = fma(a.x, b.x, s);
  return fma(a.y, b.y, s);
}

// Rows row0 .. row0 + ROWS - 1 of a row-major (limit, d) array of T,
// columns col0 .. col0 + DC - 1, into shared memory at dst, `stride`
// elements a row; rows past limit and columns past d read as zeros.
// ROLLED: the one-element copies in a rolled loop.  ptxas allocates for
// both paths; with the 4-byte loop unrolled the float32 instances of 32
// and 64 queries spill their accumulators, rolled the instances of 4 and
// fewer spill instead (H100, CUDA 12.8, `-Xptxas -v`).
template <typename T, int ROWS, bool ROLLED>
__device__ __forceinline__ void load_chunk_sq(uint32_t dst, int stride, const T* __restrict__ src,
                                              long long row0, long long limit, int d, int col0,
                                              bool vec16, int tid) {
  constexpr int DC = SqType<T>::DC, VEC = SqType<T>::VEC;
  constexpr uint32_t E = sizeof(T);
  if (vec16) {  // d % VEC == 0: a vector inside the row is whole
    constexpr int UNITS = ROWS * (DC / VEC);
#pragma unroll
    for (int it = 0; it < (UNITS + SQ_THREADS - 1) / SQ_THREADS; ++it) {
      const int u = tid + it * SQ_THREADS;
      if (UNITS % SQ_THREADS != 0 && u >= UNITS) break;
      const int r = u / (DC / VEC), cu = u % (DC / VEC), c = col0 + VEC * cu;
      const long long row = row0 + r;
      const bool ok = row < limit && c < d;
      cp_async16(dst + (uint32_t)(r * stride + VEC * cu) * E, ok ? src + row * d + c : src,
                 ok ? 16u : 0u);
    }
  } else {
    constexpr int UNITS = ROWS * DC;
#pragma unroll(ROLLED ? 1 : (UNITS + SQ_THREADS - 1) / SQ_THREADS)
    for (int it = 0; it < (UNITS + SQ_THREADS - 1) / SQ_THREADS; ++it) {
      const int u = tid + it * SQ_THREADS;
      if (UNITS % SQ_THREADS != 0 && u >= UNITS) break;
      const int r = u / DC, cc = u % DC, c = col0 + cc;
      const long long row = row0 + r;
      const bool ok = row < limit && c < d;
      cp_async_elem(dst + (uint32_t)(r * stride + cc) * E, ok ? src + row * d + c : src,
                    ok ? E : 0u);
    }
  }
}

// The state of a block's QT queries in shared memory.
template <typename T>
struct SmallQRows {
  T* list_d;      // (QT, 32) sorted running lists, (+inf, -1) past their entries
  int* list_i;
  T* cand_d;      // (QT, SQ_CAP) candidate buffers
  int* cand_i;
  int* cnt;       // (QT,) values filed (past SQ_CAP: some wait)
  T* thr_d;       // (QT,) the k-th key each score must beat
  int* thr_i;
  unsigned long long* row_kth;  // (q,) k-th keys shared across splits
  int q0, qn, k, warp, lane;

  // File (s, pos) for query j when `want`: the warp's values take
  // consecutive slots from one atomicAdd.  False when the slot is past the
  // buffer: the value waits for the next flush.
  __device__ __forceinline__ bool file(int j, T s, int pos, bool want) {
    const unsigned mask = __ballot_sync(0xffffffffu, want);
    if (mask == 0) return true;
    const int leader = __ffs(mask) - 1;
    int first = 0;
    if (lane == leader) first = atomicAdd(&cnt[j], __popc(mask));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (!want) return true;
    const int slot = first + __popc(mask & ((1u << lane) - 1u));
    if (slot >= SQ_CAP) return false;
    cand_d[j * SQ_CAP + slot] = s;
    cand_i[j * SQ_CAP + slot] = pos;
    return true;
  }

  // Between two block barriers: each warp merges the buffers of its
  // queries into their lists, publishes the k-th entries and reloads the
  // thresholds (row_bound: the float32 key, or the float64 score alone).
  __device__ __forceinline__ void flush() {
    const T INF = pos_inf<T>();
    for (int j = warp; j < qn; j += SQ_WARPS) {
      const int m = min(cnt[j], SQ_CAP);
      if (m == 0) continue;  // the same for the whole warp
      T ld = list_d[j * 32 + lane];
      int li = list_i[j * 32 + lane];
      for (int b = 0; b < m; b += 32) {
        const bool has = b + lane < m;
        const T v = has ? cand_d[j * SQ_CAP + b + lane] : INF;
        const int vi = has ? cand_i[j * SQ_CAP + b + lane] : -1;
        merge_row_regs(ld, li, k, v, vi, lane);
      }
      list_d[j * 32 + lane] = ld;
      list_i[j * 32 + lane] = li;
      const T kth = __shfl_sync(0xffffffffu, ld, k - 1);
      const int kth_i = __shfl_sync(0xffffffffu, li, k - 1);
      if (lane == 0) {
        row_bound(&row_kth[q0 + j], kth, kth_i, thr_d[j], thr_i[j]);
        cnt[j] = 0;
      }
    }
  }
};

// The body of both small-q kernels, on items, validity and queries of type
// T, in the dynamic shared memory sq_raw.
template <typename T, int QT>
__device__ __forceinline__ void smallq_body(unsigned char* sq_raw,
                                            const T* __restrict__ items,       // (n, d)
                                            const T* __restrict__ item_valid,  // (n,) > 0 real
                                            const T* __restrict__ queries,     // (q, d)
                                            int n, int q, int d, int k, int kc_count,
                                            int tiles_per_split, int n_tiles, int splits,
                                            int vec16,
                                            T* __restrict__ part_d,  // (q, splits, k)
                                            int* __restrict__ part_i,
                                            unsigned long long* __restrict__ row_kth) {
  using V = typename SqType<T>::V;
  constexpr int DC = SqType<T>::DC, VEC = SqType<T>::VEC, XS = SqType<T>::XS;
  constexpr int STAGES = smallq_stages<T>(QT);
  constexpr int H = smallq_groups(QT);  // query groups of C queries
  constexpr int C = QT / H, R = H, GT = SQ_THREADS / H;
  static_assert(QT <= SqType<T>::QMAX && R * C <= 64, "small-q instance out of range");
  const SmemSQ L = smemsq_layout<T>(QT);
  const uint32_t base = smem_u32(sq_raw);
  const int tid = threadIdx.x;
  const T INF = pos_inf<T>();
  SmallQRows<T> rows;
  rows.list_d = reinterpret_cast<T*>(sq_raw + L.list_d);
  rows.list_i = reinterpret_cast<int*>(sq_raw + L.list_i);
  rows.cand_d = reinterpret_cast<T*>(sq_raw + L.cand_d);
  rows.cand_i = reinterpret_cast<int*>(sq_raw + L.cand_i);
  rows.cnt = reinterpret_cast<int*>(sq_raw + L.cnt);
  rows.thr_d = reinterpret_cast<T*>(sq_raw + L.thr_d);
  rows.thr_i = reinterpret_cast<int*>(sq_raw + L.thr_i);
  rows.row_kth = row_kth;
  rows.q0 = blockIdx.x * QT;
  rows.qn = min(QT, q - rows.q0);
  rows.k = k;
  rows.warp = tid >> 5;
  rows.lane = tid & 31;
  const int split = blockIdx.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int steps = (t_end - t_begin) * kc_count;  // (tile, depth chunk) pairs

  for (int e = tid; e < QT * 32; e += SQ_THREADS) {
    rows.list_d[e] = INF;
    rows.list_i[e] = -1;
  }
  for (int j = tid; j < QT; j += SQ_THREADS) {
    rows.thr_d[j] = INF;
    rows.thr_i[j] = -1;
    if (j < rows.qn) row_bound(&row_kth[rows.q0 + j], INF, -1, rows.thr_d[j], rows.thr_i[j]);
    rows.cnt[j] = 0;
  }
  __syncthreads();

  // The loads of step st into ring slot st % STAGES, one commit group per
  // step (empty past the last step, so the wait below counts evenly).
  auto load_step = [&](int st) {
    if (st < steps) {
      const int kc = st % kc_count;
      const uint32_t slot = base + (st % STAGES) * L.stage_bytes;
      load_chunk_sq<T, SQ_TILE, (QT >= 8)>(slot, XS, items,
                                           (long long)(t_begin + st / kc_count) * SQ_TILE, n, d,
                                           kc * DC, vec16 != 0, tid);
      load_chunk_sq<T, QT, (QT >= 8)>(slot + L.qchunk, DC, queries, rows.q0, q, d, kc * DC,
                                      vec16 != 0, tid);
    }
    cp_async_commit();
  };
  for (int st = 0; st < STAGES - 1; ++st) load_step(st);

  // Thread tid holds items g + GT * r (r < R) of each tile and queries
  // h * C .. h * C + C - 1 of the block: R * C = QT accumulators.
  const int h = tid / GT, g = tid % GT;  // h is the same across a warp
  T acc[R][C], x2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x2[r] = T(0);
#pragma unroll
    for (int jj = 0; jj < C; ++jj) acc[r][jj] = T(0);
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step st has landed for every thread; slot (st - 1) is free
    load_step(st + STAGES - 1);
    const unsigned char* slot = sq_raw + (st % STAGES) * L.stage_bytes;
    const T* xr = reinterpret_cast<const T*>(slot) + g * XS;
    const T* qc = reinterpret_cast<const T*>(slot + L.qchunk) + h * C * DC;
#pragma unroll 1
    for (int c = 0; c < DC; c += VEC) {
      V xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xv[r] = *reinterpret_cast<const V*>(xr + r * GT * XS + c);
        x2[r] = dot_acc(xv[r], xv[r], x2[r]);
      }
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const V qv = *reinterpret_cast<const V*>(qc + jj * DC + c);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][jj] = dot_acc(xv[r], qv, acc[r][jj]);
      }
    }
    if (st % kc_count == kc_count - 1) {  // the tile is done: scores, then selection
      const int tile0 = (t_begin + st / kc_count) * SQ_TILE;
      uint64_t wait = 0;  // bit r * C + jj: that score beat its threshold, found no slot
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int pos = tile0 + g + GT * r;
        const bool live = pos < n && item_valid[pos] > T(0);
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {
          const int j = h * C + jj;
          acc[r][jj] = x2[r] - T(2) * acc[r][jj];
          const bool want = live && j < rows.qn && acc[r][jj] < INF &&
                            key_less(acc[r][jj], pos, rows.thr_d[j], rows.thr_i[j]);
          if (!rows.file(j, acc[r][jj], pos, want)) wait |= 1ull << (r * C + jj);
        }
      }
      while (__syncthreads_or(wait != 0)) {
        rows.flush();
        __syncthreads();
        uint64_t again = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int pos = tile0 + g + GT * r;
#pragma unroll
          for (int jj = 0; jj < C; ++jj) {
            const int j = h * C + jj;
            const bool want = ((wait >> (r * C + jj)) & 1ull) &&
                              key_less(acc[r][jj], pos, rows.thr_d[j], rows.thr_i[j]);
            if (!rows.file(j, acc[r][jj], pos, want)) again |= 1ull << (r * C + jj);
          }
        }
        wait = again;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x2[r] = T(0);
#pragma unroll
        for (int jj = 0; jj < C; ++jj) acc[r][jj] = T(0);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  rows.flush();
  __syncthreads();
  for (int j = rows.warp; j < rows.qn; j += SQ_WARPS) {
    if (rows.lane < k) {
      const long long at = ((long long)(rows.q0 + j) * splits + split) * k + rows.lane;
      part_d[at] = rows.list_d[j * 32 + rows.lane];
      part_i[at] = rows.list_i[j * 32 + rows.lane];
    }
  }
}

template <int QT>
__global__ void __launch_bounds__(SQ_THREADS)
fused_knn_smallq_kernel(const float* __restrict__ items,       // (n, d)
                        const float* __restrict__ item_valid,  // (n,) > 0 for a real item
                        const float* __restrict__ queries,     // (q, d)
                        int n, int q, int d, int k, int kc_count, int tiles_per_split,
                        int n_tiles, int splits, int vec16,
                        float* __restrict__ part_d,  // (q, splits, k)
                        int* __restrict__ part_i,
                        unsigned long long* __restrict__ row_kth) {  // (q,) NO_KEY at launch
  extern __shared__ __align__(16) unsigned char sq_raw[];
  smallq_body<float, QT>(sq_raw, items, item_valid, queries, n, q, d, k, kc_count,
                         tiles_per_split, n_tiles, splits, vec16, part_d, part_i, row_kth);
}

// The minimum of one block an SM (all that shared memory holds anyway)
// lets ptxas keep the double accumulators in registers: without it ptxas
// held the instances of 1, 2, 4 and 16 queries to 128 registers and
// spilled (H100, CUDA 12.8, `-Xptxas -v`).
template <int QT>
__global__ void __launch_bounds__(SQ_THREADS, 1)
fused_knn_smallq_f64_kernel(const double* __restrict__ items,       // (n, d)
                            const double* __restrict__ item_valid,  // (n,) > 0 for a real item
                            const double* __restrict__ queries,     // (q, d)
                            int n, int q, int d, int k, int kc_count, int tiles_per_split,
                            int n_tiles, int splits, int vec16,
                            double* __restrict__ part_d,  // (q, splits, k)
                            int* __restrict__ part_i,
                            unsigned long long* __restrict__ row_kth) {  // (q,) NO_KEY at launch
  extern __shared__ __align__(16) unsigned char sq_raw[];
  smallq_body<double, QT>(sq_raw, items, item_valid, queries, n, q, d, k, kc_count,
                          tiles_per_split, n_tiles, splits, vec16, part_d, part_i, row_kth);
}

// ============================================================================
// host side
// ============================================================================

// Failures of the tensor-map encoder are returned as this base plus the
// CUresult, apart from cudaError_t codes.
constexpr int ENCODE_ERROR = 100000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (2, rows, d_pad) float32 split array as a 3-D tensor map, boxes of
// (BK, box_rows, 2) under the 128-byte swizzle; rows past the end read 0.
int encode_split_map(CUtensorMap* map, const void* ptr, long long rows, long long d_pad,
                     uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d_pad, (cuuint64_t)rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)d_pad * 4, (cuuint64_t)rows * d_pad * 4};
  const cuuint32_t box[3] = {BK, box_rows, 2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

unsigned grid_for(long long total, int threads) {
  const long long blocks = (total + threads - 1) / threads;
  return (unsigned)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

// The merge pass of one type: k <= 32 merges in registers, one warp per
// row, 8 warps a block; larger k takes one thread per entry.
template <typename T>
int launch_merge(const void* part_d, const void* part_i, const void* q2, long long q,
                 long long splits, long long k, void* out_d, void* out_i, void* stream) {
  const T* pd = static_cast<const T*>(part_d);
  const int* pi = static_cast<const int*>(part_i);
  const T* qq = static_cast<const T*>(q2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32) {
    const long long blocks = (q + 7) / 8;
    merge_partials_regs_kernel<T><<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), 256, 0,
                                    st>>>(pd, pi, qq, (int)q, (int)splits, (int)k,
                                          static_cast<T*>(out_d), static_cast<int*>(out_i));
  } else {
    merge_partials_kernel<T><<<grid_for(q * splits * k, 256), 256, 0, st>>>(
        pd, pi, qq, (int)q, (int)splits, (int)k, static_cast<T*>(out_d),
        static_cast<int*>(out_i));
  }
  return (int)cudaGetLastError();
}

int kc_count64(long long d) { return d > 0 ? (int)((d + BKD - 1) / BKD) : 1; }

// fn(std::integral_constant<int, QT>) for the small-q kernel's query block
// QT at q queries: the least power of two >= q, at most SqType<T>::QMAX.
template <typename T, typename R, typename F>
R by_smallq_width(long long q, R none, F fn) {
  int qt = 1;
  while (qt < q && qt < SqType<T>::QMAX) qt <<= 1;
  switch (qt) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
  }
  if constexpr (SqType<T>::QMAX >= 64) {
    if (qt == 64) return fn(std::integral_constant<int, 64>{});
  }
  return none;
}

// The small-q kernel of type T and query block QT.
template <typename T, int QT>
auto smallq_kernel() {
  if constexpr (std::is_same<T, double>::value)
    return fused_knn_smallq_f64_kernel<QT>;
  else
    return fused_knn_smallq_kernel<QT>;
}

template <typename T, int QT>
int launch_smallq(const void* items, const void* item_valid, const void* queries, long long n,
                  long long q, long long d, long long k, long long tiles_per_split,
                  long long splits, void* part_d, void* part_i, void* row_kth, void* stream) {
  const SmemSQ L = smemsq_layout<T>(QT);
  const auto kernel = smallq_kernel<T, QT>();
  const cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (cerr != cudaSuccess) return (int)cerr;
  constexpr int DC = SqType<T>::DC, VEC = SqType<T>::VEC;
  const int kc_count = d > 0 ? (int)((d + DC - 1) / DC) : 1;
  const int n_tiles = (int)((n + SQ_TILE - 1) / SQ_TILE);
  const bool vec16 = d % VEC == 0 && reinterpret_cast<uintptr_t>(items) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const dim3 grid((unsigned)((q + QT - 1) / QT), (unsigned)splits);
  kernel<<<grid, SQ_THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(items), static_cast<const T*>(item_valid),
      static_cast<const T*>(queries), (int)n, (int)q, (int)d, (int)k, kc_count,
      (int)tiles_per_split, n_tiles, (int)splits, vec16 ? 1 : 0, static_cast<T*>(part_d),
      static_cast<int*>(part_i), static_cast<unsigned long long*>(row_kth));
  return (int)cudaGetLastError();
}

// Blocks of the small-q kernel's instance of type T and query block QT
// that the card holds at once (a wave), or -1 - cudaError_t.
template <typename T, int QT>
long long smallq_wave() {
  const SmemSQ L = smemsq_layout<T>(QT);
  const auto kernel = smallq_kernel<T, QT>();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SQ_THREADS, L.total);
  return err == cudaSuccess ? (long long)sms * per_sm : -1 - (long long)err;
}

template <typename T>
int launch_smallq_any(const void* items, const void* item_valid, const void* queries,
                      long long n, long long q, long long d, long long k,
                      long long tiles_per_split, long long splits, void* part_d, void* part_i,
                      void* row_kth, void* stream) {
  return by_smallq_width<T>(q, (int)cudaErrorInvalidValue, [&](auto qt) {
    return launch_smallq<T, decltype(qt)::value>(items, item_valid, queries, n, q, d, k,
                                                 tiles_per_split, splits, part_d, part_i,
                                                 row_kth, stream);
  });
}

template <typename T>
long long smallq_wave_any(long long q) {
  return by_smallq_width<T>(q, -1 - (long long)cudaErrorInvalidValue,
                            [](auto qt) { return smallq_wave<T, decltype(qt)::value>(); });
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer and the stream are
// passed as void*; sizes as 64-bit integers (the wrapper checks that they
// fit the kernels' int32 indexing).  Each returns the cudaError_t of its
// launch (or ENCODE_ERROR + a CUresult), 0 on success.
extern "C" {

int tf32_split(const void* x, long long rows, long long d, long long d_pad, void* out,
               void* stream) {
  tf32_split_kernel<<<grid_for(rows * 32, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, (int)d, (int)d_pad, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// xsplit (2, n, d_pad) and qsplit (2, q, d_pad) from tf32_split; xs
// (n_tiles * 64,) item norms, +inf where invalid or past n; part_d/part_i
// (q, splits, k) scratch; row_kth (q,) 64-bit keys, all ones at launch;
// splits * tiles_per_split covers the n_tiles tiles of 64 items.
int fused_knn_tf32(const void* xsplit, const void* qsplit, const void* xs, long long n,
                   long long q, long long d_pad, long long k, long long tiles_per_split,
                   long long splits, void* part_d, void* part_i, void* row_kth,
                   void* stream) {
  CUtensorMap xmap, qmap;
  int err = encode_split_map(&xmap, xsplit, n, d_pad, BN);
  if (err == 0) err = encode_split_map(&qmap, qsplit, q, d_pad, BQ);
  if (err != 0) return err;
  const int kc_count = (int)(d_pad / BK);
  const bool resident = d_pad <= RESIDENT_MAX_DPAD;
  const Smem32 L = smem32_layout(kc_count, resident);
  auto kernel = k <= 32 ? fused_knn_tf32_kernel<true> : fused_knn_tf32_kernel<false>;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_tiles = (int)((n + BN - 1) / BN);
  const dim3 grid((unsigned)((q + BQ - 1) / BQ), (unsigned)splits);
  kernel<<<grid, NTHREADS32, L.total, static_cast<cudaStream_t>(stream)>>>(
      xmap, qmap, static_cast<const float*>(xs), (int)q, (int)k, kc_count,
      (int)tiles_per_split, n_tiles, (int)splits, resident ? 1 : 0,
      static_cast<float*>(part_d), static_cast<int*>(part_i),
      static_cast<unsigned long long*>(row_kth));
  return (int)cudaGetLastError();
}

// part_d (q, splits, k) float32 (f64 = 0) or float64 (f64 = 1) sorted
// lists, part_i int32, q2 (q,) of the same type as part_d.
int merge_partials(const void* part_d, const void* part_i, const void* q2, long long q,
                   long long splits, long long k, long long f64, void* out_d, void* out_i,
                   void* stream) {
  return f64 ? launch_merge<double>(part_d, part_i, q2, q, splits, k, out_d, out_i, stream)
             : launch_merge<float>(part_d, part_i, q2, q, splits, k, out_d, out_i, stream);
}

// items (n, d) and queries (q, d) row-major float64; xs (n_tiles * 64,)
// item norms, +inf where invalid or past n; part_d/part_i (q, splits, k)
// scratch; row_kth (q,) 64-bit keys, all ones at launch; splits *
// tiles_per_split covers the n_tiles tiles of 64 items.
int fused_knn_f64(const void* items, const void* queries, const void* xs, long long n,
                  long long q, long long d, long long k, long long tiles_per_split,
                  long long splits, void* part_d, void* part_i, void* row_kth, void* stream) {
  const int kc_count = kc_count64(d);
  const bool resident = kc_count <= RESIDENT64_MAX_KC;
  const Smem64 L = smem64_layout(kc_count, resident);
  const bool vec16 = d % 2 == 0 && reinterpret_cast<uintptr_t>(items) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  auto kernel = k <= 32 ? fused_knn_f64_kernel<true> : fused_knn_f64_kernel<false>;
  const cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_tiles = (int)((n + BND - 1) / BND);
  const dim3 grid((unsigned)((q + BQD - 1) / BQD), (unsigned)splits);
  kernel<<<grid, NTHREADS64, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(items), static_cast<const double*>(queries),
      static_cast<const double*>(xs), (int)n, (int)q, (int)d, (int)k, kc_count,
      (int)tiles_per_split, n_tiles, (int)splits, resident ? 1 : 0, vec16 ? 1 : 0,
      static_cast<double*>(part_d), static_cast<int*>(part_i),
      static_cast<unsigned long long*>(row_kth));
  return (int)cudaGetLastError();
}

// items (n, d), item_valid (n,) and queries (q, d) row-major float32
// (fused_knn_smallq) or float64 (fused_knn_smallq_f64); part_d/part_i
// (q, splits, k) scratch, k <= 32; row_kth (q,) 64-bit keys, all ones at
// launch; splits * tiles_per_split covers the tiles of SQ_TILE items.
int fused_knn_smallq(const void* items, const void* item_valid, const void* queries,
                     long long n, long long q, long long d, long long k,
                     long long tiles_per_split, long long splits, void* part_d, void* part_i,
                     void* row_kth, void* stream) {
  return launch_smallq_any<float>(items, item_valid, queries, n, q, d, k, tiles_per_split,
                                  splits, part_d, part_i, row_kth, stream);
}
int fused_knn_smallq_f64(const void* items, const void* item_valid, const void* queries,
                         long long n, long long q, long long d, long long k,
                         long long tiles_per_split, long long splits, void* part_d,
                         void* part_i, void* row_kth, void* stream) {
  return launch_smallq_any<double>(items, item_valid, queries, n, q, d, k, tiles_per_split,
                                   splits, part_d, part_i, row_kth, stream);
}

// Blocks of the small-q kernel (float32, float64) for q queries that the
// current card holds at once, or -1 - a cudaError_t.
long long fused_knn_smallq_wave(long long q) { return smallq_wave_any<float>(q); }
long long fused_knn_smallq_f64_wave(long long q) { return smallq_wave_any<double>(q); }

// Dynamic shared memory the float32 kernel asks for, and its ring's
// stages, at this width; and the float64 kernel's at width d (for reports).
long long fused_knn_tf32_smem_bytes(long long d_pad) {
  return smem32_layout((int)(d_pad / BK), d_pad <= RESIDENT_MAX_DPAD).total;
}
long long fused_knn_tf32_stages(long long d_pad) {
  return smem32_layout((int)(d_pad / BK), d_pad <= RESIDENT_MAX_DPAD).stages;
}
long long fused_knn_f64_smem_bytes(long long d) {
  const int kc = kc_count64(d);
  return smem64_layout(kc, kc <= RESIDENT64_MAX_KC).total;
}

const char* fused_knn_error_string(int code) {
  if (code >= ENCODE_ERROR) return "cuTensorMapEncodeTiled failed (code - 100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
