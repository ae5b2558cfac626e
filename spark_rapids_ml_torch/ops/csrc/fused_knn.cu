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
// Design.  One block owns BQ query rows and sweeps the whole item set in
// tiles of BN items (the TPU grid's sequential item axis becomes a loop
// inside the block).  Each tile:
//   1. scores: a BQ x BN tile of dot products on the CUDA cores (FMA in the
//      input type), with query and item rows staged through shared memory
//      in chunks of DK along d, so any d works;
//   2. selection: one warp per query row keeps only the tile's candidates
//      that beat the row's current k-th entry (a ballot + compaction), sorts
//      those few by rank counting, and merges them into the row's sorted
//      running list, which lives in the output buffers themselves.  The
//      merge moves the displaced entries up from the back, so the list
//      needs no scratch and k is bounded only by the item count.
//
// What bounds it.  2*q*n*d operations against (n*d + q*d) input bytes: at
// any realistic q it is bound by operations, at the card's FP32 rate
// outside the tensor cores.  This first version keeps FP32/FP64 FMA on
// the CUDA cores for exact parity with the plain version (no TF32); moving
// the score tile to wgmma and splitting the item sweep across blocks is
// left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared into a
// library with the plain C interface at the end of this file
// (spark_rapids_ml_torch/ops/_build.py does this at first use).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                            // query rows per block
constexpr int BN = 64;                            // items per tile
constexpr int DK = 16;                            // depth of one staged chunk
constexpr int TQ = 4;                             // query rows per thread
constexpr int TN = 4;                             // items per thread
constexpr int GQ = BQ / TQ;                       // thread rows (16)
constexpr int GN = BN / TN;                       // thread columns (16)
constexpr int NTHREADS = GQ * GN;                 // 256
constexpr int NWARPS = NTHREADS / 32;             // 8
constexpr int QS_LD = BQ + 1;                     // padded strides against
constexpr int XS_LD = BN + 1;                     // shared-memory bank
constexpr int S_LD = BN + 1;                      // conflicts

static_assert(BN % 32 == 0, "a warp scans the tile 32 columns at a time");

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

// (score, position) order.  An empty slot holds (+inf, -1); as unsigned
// its position is the largest, so it sorts after every real entry.
template <typename T>
__device__ __forceinline__ bool key_less(T a, int ai, T b, int bi) {
  return a < b || (a == b && (unsigned)ai < (unsigned)bi);
}

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(DK * QS_LD + DK * XS_LD + BQ * S_LD  // tiles
                              + 2 * BQ                              // ||q||^2, worst
                              + 2 * NWARPS * BN)                    // candidates
         + sizeof(int) * (size_t)(BQ + 2 * NWARPS * BN);
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
  T* S = Xs + DK * XS_LD;                  // [BQ][S_LD] tile scores
  T* q2 = S + BQ * S_LD;                   // [BQ]
  T* worst_d = q2 + BQ;                    // [BQ] current k-th score of each row
  T* cand_d = worst_d + BQ;                // [NWARPS][BN] survivors, tile order
  T* sort_d = cand_d + NWARPS * BN;        // [NWARPS][BN] survivors, sorted
  int* worst_i = reinterpret_cast<int*>(sort_d + NWARPS * BN);  // [BQ]
  int* cand_i = worst_i + BQ;              // [NWARPS][BN]
  int* sort_i = cand_i + NWARPS * BN;      // [NWARPS][BN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % GN;
  const int ty = tid / GN;
  const int q0 = blockIdx.x * BQ;
  const T INF = pos_inf<T>();

  // Empty running lists and the query norms of this block's rows.
  for (int r = warp; r < BQ; r += NWARPS) {
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

  T* my_cd = cand_d + warp * BN;
  int* my_ci = cand_i + warp * BN;
  T* my_sd = sort_d + warp * BN;
  int* my_si = sort_i + warp * BN;

  for (int n0 = 0; n0 < n; n0 += BN) {
    // ---- 1. scores of the BQ x BN tile -------------------------------------
    T acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

    for (int d0 = 0; d0 < d; d0 += DK) {
      for (int e = tid; e < BQ * DK; e += NTHREADS) {
        const int r = e / DK, c = e % DK;
        const int row = q0 + r, col = d0 + c;
        Qs[c * QS_LD + r] = (row < q && col < d) ? queries[(int64_t)row * d + col] : T(0);
      }
      for (int e = tid; e < BN * DK; e += NTHREADS) {
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
    const int nt = min(BN, n - n0);
    for (int r = warp; r < BQ; r += NWARPS) {
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
      for (int c0 = 0; c0 < BN; c0 += 32) {
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
      int tgt[BN / 32];
#pragma unroll
      for (int u = 0; u < BN / 32; ++u) {
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
      // rest move up by the number of survivors ahead of them.  Walking
      // from the back, each group of 32 is read before any of it is
      // written, and it only writes at or above its own lowest index.
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
      for (int u = 0; u < BN / 32; ++u) {
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
  for (int r = warp; r < BQ; r += NWARPS) {
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

template <typename T>
int launch(const void* items, const void* x2, const void* valid, const void* queries,
           long long n, long long d, long long q, long long k,
           void* out_d, void* out_i, void* stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_knn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((q + BQ - 1) / BQ));
  fused_knn_kernel<T><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(items), static_cast<const T*>(x2), static_cast<const T*>(valid),
      static_cast<const T*>(queries), (int)n, (int)d, (int)q, (int)k,
      static_cast<T*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every pointer and the stream are
// passed as void*; sizes as 64-bit integers (the wrapper checks that n, d,
// q and k fit in int32).  Returns the cudaError_t of the launch.
extern "C" {

int fused_knn_f32(const void* items, const void* x2, const void* valid, const void* queries,
                  long long n, long long d, long long q, long long k,
                  void* out_d, void* out_i, void* stream) {
  return launch<float>(items, x2, valid, queries, n, d, q, k, out_d, out_i, stream);
}

int fused_knn_f64(const void* items, const void* x2, const void* valid, const void* queries,
                  long long n, long long d, long long q, long long k,
                  void* out_d, void* out_i, void* stream) {
  return launch<double>(items, x2, valid, queries, n, d, q, k, out_d, out_i, stream);
}

const char* fused_knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
