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
//   merge_partials_kernel  merges the S lists of each row by (score,
//                          position) and applies the epilogue.
//
// float64 keeps the first, CUDA-core design (fused_knn_kernel<double>):
// FP64 FMA, one block per 64 queries sweeping every item.
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

namespace {

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

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
__device__ void merge_row(float* __restrict__ od, int* __restrict__ oi, int k, int m,
                          float v, int vi, int lane) {
  int rank = 0;
#pragma unroll 8
  for (int t = 0; t < 32; ++t) {
    const float tv = __shfl_sync(0xffffffffu, v, t);
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
    float e = CUDART_INF_F;
    int ei = -1;
    if (act) {
      e = od[i];
      ei = oi[i];
    }
    int less = 0;
#pragma unroll 8
    for (int t = 0; t < 32; ++t) {
      const float tv = __shfl_sync(0xffffffffu, v, t);
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
__device__ __forceinline__ void bitonic_step(float& d, int& i, int stride, bool ascending,
                                             int lane) {
  const float od = __shfl_xor_sync(0xffffffffu, d, stride);
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
__device__ __forceinline__ void merge_row_regs(float& ld, int& li, int k, float v, int vi,
                                               int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      bitonic_step(v, vi, stride, (lane & size) == 0, lane);
  const float rv = __shfl_sync(0xffffffffu, v, 31 - lane);
  const int rvi = __shfl_sync(0xffffffffu, vi, 31 - lane);
  if (key_less(rv, rvi, ld, li)) {
    ld = rv;
    li = rvi;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) bitonic_step(ld, li, stride, true, lane);
  if (lane >= k) {
    ld = CUDART_INF_F;
    li = -1;
  }
}

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
  const int warp = tid >> 5;  // 0..7; rows 16*warp .. 16*warp + 15 of the block
  const int lane = tid & 31;
  const float INF = CUDART_INF_F;
  // accumulator layout of m64nNk8: this thread holds rows lr0 and lr0 + 8,
  // columns 8c + 2*(lane % 4) + j, in d[4c + 2i + j] (i: row, j: column)
  const int lr0 = 16 * warp + (lane >> 2);
  const int lr1 = lr0 + 8;
  const int col0 = 2 * (lane & 3);
  const bool live0 = q0 + lr0 < q, live1 = q0 + lr1 < q;

  // Row r's sorted running list: with REG_LIST, entry `lane` of the
  // warp's row 16 * warp + rr in (reg_d[rr], reg_i[rr]); else its slot of
  // the (q, S, k) scratch, so that any k works.
  auto list_d = [&](int r) { return part_d + ((int64_t)(q0 + r) * splits + split) * k; };
  auto list_i = [&](int r) { return part_i + ((int64_t)(q0 + r) * splits + split) * k; };
  float reg_d[16];
  int reg_i[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    reg_d[rr] = INF;
    reg_i[rr] = -1;
  }
  if constexpr (!REG_LIST) {
    for (int r = 16 * warp; r < 16 * warp + 16 && q0 + r < q; ++r) {
      float* od = list_d(r);
      int* oi = list_i(r);
      for (int j = lane; j < k; j += 32) {
        od[j] = INF;
        oi[j] = -1;
      }
    }
  }
  // A row's threshold: the least of its k-th entry here and the k-th
  // entries other splits of the row have published in row_kth.  Any
  // split's k-th entry bounds the row's k-th over all items, so a value
  // that does not beat it cannot be in the merged top-k.
  auto threshold = [&](int r, unsigned long long mine) {
    float td = INF;
    int ti = -1;
    if (q0 + r < q) {
      const unsigned long long old = atomicMin(&row_kth[q0 + r], mine);
      const unsigned long long best = old < mine ? old : mine;
      if (best != NO_KEY) unpack_key(best, td, ti);
    }
    thr_d[r] = td;
    thr_i[r] = ti;
    cnt[r] = 0;
  };
  if (lane < 16) threshold(16 * warp + lane, NO_KEY);
  __syncwarp();
  float th0 = thr_d[lr0], th1 = thr_d[lr1];
  int ti0 = thr_i[lr0], ti1 = thr_i[lr1];

  // Merge every buffered row of this warp, then reload the thresholds.  A
  // rolled loop keeps this rarely run code small; with REG_LIST the row
  // being merged is always reg_*[0], and the lists rotate by one row per
  // step, so after 16 steps they are back in place.
  auto flush = [&]() {
#pragma unroll 1
    for (int rr = 0; rr < 16; ++rr) {
      const int r = 16 * warp + rr;
      const int m = min(cnt[r], CAP);
      if (m > 0) {  // the same for the whole warp
        float* bd = cand_d + r * CAP;
        int* bi = cand_i + r * CAP;
        const float v = lane < m ? bd[lane] : INF;
        const int vi = lane < m ? bi[lane] : -1;
        float kth;
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
        if (lane == 0) threshold(r, kth_i >= 0 ? pack_key(kth, kth_i) : NO_KEY);
        __syncwarp();
      }
      if constexpr (REG_LIST) {
        const float d0 = reg_d[0];
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
  };

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

  // Scores of a finished tile against the thresholds; survivors to the
  // candidate buffers, merging the warp's rows whenever one would overflow.
  // The 4 lanes that share a row take consecutive slots (a prefix sum over
  // the 4), so filing needs no atomics.  A value past the buffer's end is
  // filed after the merge; it may no longer beat the k-th entry then, and
  // the merge drops it.
  auto select = [&](const float (&score)[32], int n0) {
    // past the first tiles almost no score beats the k-th entry: look at
    // each row's least score first, and leave at once when no lane has one
    float least0 = INF, least1 = INF;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      if ((v >> 1) & 1) least1 = fminf(least1, score[v]);
      else least0 = fminf(least0, score[v]);
    }
    const bool any0 = live0 && least0 <= th0, any1 = live1 && least1 <= th1;
    if (!__any_sync(0xffffffffu, any0 || any1)) return;
    uint32_t pend = 0;  // bit v: score[v] beats its row's k-th entry
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i ? any1 : any0) {
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {  // the row's 16 values, d[4c + 2i + j]
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
      xv[c] = *reinterpret_cast<const float2*>(xs + n0 + 8 * c + col0);
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
    select(acc, n0);
  }
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

// ============================================================================
// float32: merge pass
// ============================================================================

// Entries of list t (sorted, empties last) that come before (v, vi).
__device__ __forceinline__ int count_less(const float* __restrict__ ld, const int* __restrict__ li,
                                          int k, float v, int vi) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(ld[mid], li[mid], v, vi)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One thread per partial entry (row, list s, slot j).  An entry's slot in
// the merged row is j plus the entries of the other lists ahead of it
// (positions are unique, so every real entry has its own slot); the
// threads of list 0 also write the +inf / -1 tail past the row's count of
// real entries.  d^2 = max(score + ||q||^2, 0).
__global__ void merge_partials_kernel(const float* __restrict__ part_d,  // (q, S, k)
                                      const int* __restrict__ part_i,
                                      const float* __restrict__ q2,      // (q,)
                                      int q, int S, int k,
                                      float* __restrict__ out_d,         // (q, k)
                                      int* __restrict__ out_i) {
  const long long per_row = (long long)S * k;
  const long long total = (long long)q * per_row;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / per_row;
    const int rem = (int)(e - row * per_row);
    const int s = rem / k, j = rem - s * k;
    const float* rd = part_d + row * per_row;
    const int* ri = part_i + row * per_row;
    if (s == 0) {
      long long real = 0;
      for (int t = 0; t < S; ++t) {
        int lo = 0, hi = k;  // first empty slot of list t
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ri[t * k + mid] >= 0) lo = mid + 1; else hi = mid;
        }
        real += lo;
      }
      if (j >= real) {
        out_d[row * k + j] = CUDART_INF_F;
        out_i[row * k + j] = -1;
      }
    }
    const float v = rd[rem];
    const int vi = ri[rem];
    if (vi < 0) continue;
    int rank = j;
    for (int t = 0; t < S && rank < k; ++t)
      if (t != s) rank += count_less(rd + t * k, ri + t * k, k, v, vi);
    if (rank < k) {
      const float d2 = v + q2[row];
      out_d[row * k + rank] = d2 > 0.0f ? d2 : 0.0f;
      out_i[row * k + rank] = vi;
    }
  }
}

// ============================================================================
// float64: the first design, FP64 FMA on the CUDA cores
// ============================================================================
//
// One block owns BQ64 query rows and sweeps the whole item set in tiles of
// BN64 items.  Each tile: (1) a BQ64 x BN64 tile of dot products with rows
// staged through shared memory in chunks of DK along d, so any d works;
// (2) one warp per query row keeps only the tile's candidates that beat the
// row's current k-th entry (a ballot + compaction), sorts those few by rank
// counting, and merges them into the row's sorted running list, which
// lives in the output buffers themselves.

constexpr int BQ64 = 64;                          // query rows per block
constexpr int BN64 = 64;                          // items per tile
constexpr int DK = 16;                            // depth of one staged chunk
constexpr int TQ = 4;                             // query rows per thread
constexpr int TN = 4;                             // items per thread
constexpr int GQ = BQ64 / TQ;                     // thread rows (16)
constexpr int GN = BN64 / TN;                     // thread columns (16)
constexpr int NTHREADS = GQ * GN;                 // 256
constexpr int NWARPS = NTHREADS / 32;             // 8
constexpr int QS_LD = BQ64 + 1;                   // padded strides against
constexpr int XS_LD = BN64 + 1;                   // shared-memory bank
constexpr int S_LD = BN64 + 1;                    // conflicts

static_assert(BN64 % 32 == 0, "a warp scans the tile 32 columns at a time");

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(DK * QS_LD + DK * XS_LD + BQ64 * S_LD  // tiles
                              + 2 * BQ64                              // ||q||^2, worst
                              + 2 * NWARPS * BN64)                    // candidates
         + sizeof(int) * (size_t)(BQ64 + 2 * NWARPS * BN64);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fused_knn_kernel(const T* __restrict__ items,    // (n, d)
                 const T* __restrict__ x2,       // (n,) ||x||^2, 0 where invalid
                 const T* __restrict__ valid,    // (n,) > 0 for a real item
                 const T* __restrict__ queries,  // (q, d)
                 int n, int d, int q, int k,
                 T* __restrict__ out_d,          // (q, k)
                 int* __restrict__ out_i) {      // (q, k)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [DK][QS_LD] query chunk, transposed
  T* Xs = Qs + DK * QS_LD;                 // [DK][XS_LD] item chunk, transposed
  T* S = Xs + DK * XS_LD;                  // [BQ64][S_LD] tile scores
  T* q2 = S + BQ64 * S_LD;                 // [BQ64]
  T* worst_d = q2 + BQ64;                  // [BQ64] current k-th score of each row
  T* cand_d = worst_d + BQ64;              // [NWARPS][BN64] survivors, tile order
  T* sort_d = cand_d + NWARPS * BN64;      // [NWARPS][BN64] survivors, sorted
  int* worst_i = reinterpret_cast<int*>(sort_d + NWARPS * BN64);  // [BQ64]
  int* cand_i = worst_i + BQ64;            // [NWARPS][BN64]
  int* sort_i = cand_i + NWARPS * BN64;    // [NWARPS][BN64]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % GN;
  const int ty = tid / GN;
  const int q0 = blockIdx.x * BQ64;
  const T INF = pos_inf<T>();

  // Empty running lists and the query norms of this block's rows.
  for (int r = warp; r < BQ64; r += NWARPS) {
    const int row = q0 + r;
    T acc = T(0);
    if (row < q) {
      const T* qr = queries + (int64_t)row * d;
      for (int c = lane; c < d; c += 32) acc += qr[c] * qr[c];
      T* od = out_d + (int64_t)row * k;
      int* oi = out_i + (int64_t)row * k;
      for (int j = lane; j < k; j += 32) {
        od[j] = INF;
        oi[j] = -1;
      }
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      q2[r] = acc;
      worst_d[r] = INF;
      worst_i[r] = -1;
    }
  }
  __syncthreads();

  T* my_cd = cand_d + warp * BN64;
  int* my_ci = cand_i + warp * BN64;
  T* my_sd = sort_d + warp * BN64;
  int* my_si = sort_i + warp * BN64;

  for (int n0 = 0; n0 < n; n0 += BN64) {
    // ---- 1. scores of the BQ64 x BN64 tile ---------------------------------
    T acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

    for (int d0 = 0; d0 < d; d0 += DK) {
      for (int e = tid; e < BQ64 * DK; e += NTHREADS) {
        const int r = e / DK, c = e % DK;
        const int row = q0 + r, col = d0 + c;
        Qs[c * QS_LD + r] = (row < q && col < d) ? queries[(int64_t)row * d + col] : T(0);
      }
      for (int e = tid; e < BN64 * DK; e += NTHREADS) {
        const int r = e / DK, c = e % DK;
        const int it = n0 + r, col = d0 + c;
        Xs[c * XS_LD + r] = (it < n && col < d) ? items[(int64_t)it * d + col] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < DK; ++c) {
        T a[TQ], b[TN];
#pragma unroll
        for (int i = 0; i < TQ; ++i) a[i] = Qs[c * QS_LD + ty + i * GQ];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Xs[c * XS_LD + tx + j * GN];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + j * GN;
      const int it = n0 + c;
      const bool ok = it < n && valid[it] > T(0);
      const T xx = ok ? x2[it] : T(0);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int r = ty + i * GQ;
        S[r * S_LD + c] = ok ? xx - T(2) * acc[i][j] : INF;
      }
    }
    __syncthreads();

    // ---- 2. merge the tile into each row's running top-k -------------------
    const int nt = min(BN64, n - n0);
    for (int r = warp; r < BQ64; r += NWARPS) {
      const int row = q0 + r;
      if (row >= q) continue;  // the same for the whole warp
      T* od = out_d + (int64_t)row * k;
      int* oi = out_i + (int64_t)row * k;
      const T thr = worst_d[r];
      const int thr_i = worst_i[r];
      __syncwarp();

      // survivors: candidates that beat the current k-th entry
      int m = 0;
#pragma unroll
      for (int c0 = 0; c0 < BN64; c0 += 32) {
        const int c = c0 + lane;
        const T s = S[r * S_LD + c];
        const int pos = n0 + c;
        const bool take = c < nt && s < INF && key_less(s, pos, thr, thr_i);
        const unsigned ball = __ballot_sync(0xffffffffu, take);
        if (take) {
          const int slot = m + __popc(ball & ((1u << lane) - 1u));
          my_cd[slot] = s;
          my_ci[slot] = pos;
        }
        m += __popc(ball);
      }
      if (m == 0) continue;  // the same for the whole warp
      __syncwarp();

      // sort the survivors: (score, position) pairs are distinct, so the
      // ranks are a permutation
      for (int s0 = lane; s0 < m; s0 += 32) {
        const T v = my_cd[s0];
        const int vi = my_ci[s0];
        int rank = 0;
        for (int t = 0; t < m; ++t) rank += key_less(my_cd[t], my_ci[t], v, vi) ? 1 : 0;
        my_sd[rank] = v;
        my_si[rank] = vi;
      }
      __syncwarp();

      // slot of each survivor in the merged list: its rank among the
      // survivors plus the number of running entries ahead of it
      int tgt[BN64 / 32];
#pragma unroll
      for (int u = 0; u < BN64 / 32; ++u) {
        const int j = lane + 32 * u;
        tgt[u] = k;
        if (j < m) {
          const T v = my_sd[j];
          const int vi = my_si[j];
          int lo = 0, hi = k;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (key_less(od[mid], oi[mid], v, vi)) lo = mid + 1; else hi = mid;
          }
          tgt[u] = j + lo;
        }
      }
      // entries before the first survivor's slot stay where they are; the
      // rest move up by the number of survivors ahead of them (from the
      // back, as in merge_row above)
      const int p0 = __shfl_sync(0xffffffffu, tgt[0], 0);
      for (int top = k; top > p0; top -= 32) {
        const int i = top - 32 + lane;
        const bool act = i >= p0;
        T v = INF;
        int vi = -1;
        int dst = k;
        if (act) {
          v = od[i];
          vi = oi[i];
          int lo = 0, hi = m;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (key_less(my_sd[mid], my_si[mid], v, vi)) lo = mid + 1; else hi = mid;
          }
          dst = i + lo;
        }
        __syncwarp();
        if (act && dst < k) {
          od[dst] = v;
          oi[dst] = vi;
        }
        __syncwarp();
      }
#pragma unroll
      for (int u = 0; u < BN64 / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < m && tgt[u] < k) {
          od[tgt[u]] = my_sd[j];
          oi[tgt[u]] = my_si[j];
        }
      }
      __syncwarp();
      if (lane == 0) {
        worst_d[r] = od[k - 1];
        worst_i[r] = oi[k - 1];
      }
    }
    __syncthreads();
  }

  // ---- epilogue: d^2 = max(score + ||q||^2, 0); +inf past the valid count --
  for (int r = warp; r < BQ64; r += NWARPS) {
    const int row = q0 + r;
    if (row >= q) continue;
    T* od = out_d + (int64_t)row * k;
    const int* oi = out_i + (int64_t)row * k;
    const T qq = q2[r];
    for (int j = lane; j < k; j += 32) {
      const T v = od[j] + qq;
      od[j] = oi[j] < 0 ? INF : (v > T(0) ? v : T(0));
    }
  }
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

template <typename T>
int launch(const void* items, const void* x2, const void* valid, const void* queries,
           long long n, long long d, long long q, long long k,
           void* out_d, void* out_i, void* stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_knn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((q + BQ64 - 1) / BQ64));
  fused_knn_kernel<T><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(items), static_cast<const T*>(x2), static_cast<const T*>(valid),
      static_cast<const T*>(queries), (int)n, (int)d, (int)q, (int)k,
      static_cast<T*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
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

int merge_partials(const void* part_d, const void* part_i, const void* q2, long long q,
                   long long splits, long long k, void* out_d, void* out_i, void* stream) {
  merge_partials_kernel<<<grid_for(q * splits * k, 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<const float*>(q2), (int)q, (int)splits, (int)k, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

int fused_knn_f64(const void* items, const void* x2, const void* valid, const void* queries,
                  long long n, long long d, long long q, long long k,
                  void* out_d, void* out_i, void* stream) {
  return launch<double>(items, x2, valid, queries, n, d, q, k, out_d, out_i, stream);
}

// Dynamic shared memory the float32 kernel asks for, and its ring's
// stages, at this width; and the float64 kernel's (for reports).
long long fused_knn_tf32_smem_bytes(long long d_pad) {
  return smem32_layout((int)(d_pad / BK), d_pad <= RESIDENT_MAX_DPAD).total;
}
long long fused_knn_tf32_stages(long long d_pad) {
  return smem32_layout((int)(d_pad / BK), d_pad <= RESIDENT_MAX_DPAD).stages;
}
long long fused_knn_f64_smem_bytes() { return (long long)smem_bytes<double>(); }

const char* fused_knn_error_string(int code) {
  if (code >= ENCODE_ERROR) return "cuTensorMapEncodeTiled failed (code - 100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
