// Exact brute-force 1-NN (+ winner payload row) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gorio_tpu/ops/nn_pallas.py:
//   gorio_nn1        <- _kernel        (:34, nn1_pallas :59, dispatched by nn1_best)
//   gorio_nn1_select <- _select_kernel (:125, nn1_select_pallas :155, dispatched by nn1_select)
//
// What it computes: for every query q of batch b, the index of the ref r
// minimising |q - r|^2 + 1e12 * [r masked], in float32 as on the TPU, that
// minimum clamped at >= 0, and for gorio_nn1_select the winner's payload row
// zero-padded to 16 columns. The lowest index wins ties, as on the TPU.
//
// What bounds it on this card: operations, not bytes. At the GICP shape
// (N = M = 2048, one batch) the search is N*M = 4.19M (query, ref) pairs of
// ~9 FP32 operations (3 subtractions, 3 squares summed, the bias add, the
// compare): 37.7 MFLOP, 0.56 us at 67 TFLOP/s. The bytes are ~0.45 MB at the
// main path's types (f64 query, f32 refs and payload, bool mask; f64 d2 and
// sel out), 0.14 us at 3.35 TB/s. K = 3 is too narrow for the tensor cores, so
// the distance is the direct (q - r)^2 with FMAs on the CUDA cores, which also
// avoids the |q|^2 + |r|^2 - 2 q.r cancellation of the TPU's matmul form.
//
// Two limits of the first port, and what this design does about them:
//  * Too few SMs worked. One thread per query gave ceil(2048 / 128) = 16
//    blocks for 132 SMs. Here a cluster of S <= 8 CTAs (the portable size)
//    shares one block of 128 queries, and CTA rank s scans the contiguous ref
//    range [s*M/S, (s+1)*M/S): at N = 2048, S = 8 that is 128 CTAs. The
//    wrapper picks S from B*N so that the grid covers the card.
//    The partials meet in one launch, with no workspace and no second kernel:
//    every rank stores its (min, argmin) per query into rank 0's shared
//    memory through distributed shared memory (`map_shared_rank`), the
//    cluster synchronises, and rank 0 merges them in rank order with a strict
//    '<'. Rank order is index order, so the lowest index wins every tie, also
//    across the split.
//  * The wrapper cost several times the kernel: casts, a bias tensor, a
//    padded payload and contiguous copies, each a launch of its own. Here the
//    kernel reads the caller's tensors as they are: query, refs and payload
//    in float32 or float64 (template parameters, converted to float32 on
//    load), the bool mask as bytes (the kernel adds the 1e12 itself), the
//    payload with its own width P <= 16 and row stride (the kernel writes the
//    zeros of columns P..15). d2 and sel come out in the query's type, idx as
//    int32. A call is one launch.
//
// Inside a CTA: the refs are staged as float4(x, y, z, bias) tiles in shared
// memory (every lane of a warp reads the same entry: a broadcast, no bank
// conflicts). Measured on the card, one broadcast load per (query, ref) pair
// was the scan's limit, and more warps alone did not help, so each thread
// serves QPT = 2 queries from every load, and PARTS = 4 threads share a query,
// each scanning a quarter of every tile: 256 threads, 8 warps per CTA. Each
// thread keeps CHAINS = 2 running (min, argmin) per query in registers, each
// over increasing indices with a strict '<', so that independent
// compare-select chains overlap. Chains and parts are merged by value and
// then by index, which keeps the first index of the range. The winners'
// payload rows are copied once, at the end, by all of rank 0's threads
// together: loads first, then coalesced stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QUERIES = 128;     // queries per CTA (per cluster)
constexpr int QPT = 2;           // queries per thread: a ref's shared-memory load serves QPT
constexpr int PARTS = 4;         // threads per query, each scanning one part of every tile
constexpr int LANES = QUERIES / QPT;
constexpr int THREADS = LANES * PARTS;
constexpr int TILE = 1024;       // refs staged per shared-memory tile (16 KB)
constexpr int PAYLOAD = 16;      // columns of sel
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int CHAINS = 2;        // running minima per query and thread (see the scan)
constexpr float BIG = 1.0e12f;   // the bias of a masked ref

enum DType { F32 = 0, F64 = 1 };

struct Args {
  const void* query;      // (B, N, 3), q_dtype
  int q_dtype;
  const void* ref;        // (B, M, 3), r_dtype
  int r_dtype;
  const uint8_t* mask;    // (B, M) bool, or nullptr for all live
  const void* payload;    // (B, M, p_stride) rows, P columns used, p_dtype
  int p_dtype, P, p_stride;
  int B, N, M, S;         // S: CTAs per cluster, each scans M / S refs
  int32_t* idx;           // (B, N)
  void* d2;               // (B, N), q_dtype
  void* sel;              // (B, N, 16), q_dtype
  cudaStream_t stream;
};

// Arrive on / wait at the cluster barrier (PTX, sm_90). The first phase
// only says "this CTA has started", which must hold before any CTA writes to
// another's shared memory; splitting it lets the scan hide the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float4 r) {
  const float dx = qx - r.x;
  const float dy = qy - r.y;
  const float dz = qz - r.z;
  return fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, r.w)));  // r.w: the mask's bias
}

// (d, i) beats (best, best_i) among minima kept over runs of increasing
// index: a smaller value, or the same value at a lower index.
__device__ __forceinline__ bool beats(float d, int i, float best, int best_i) {
  return d < best || (d == best && i < best_i);
}

template <typename QT, typename RT, typename PT, bool WITH_PAYLOAD>
__global__ void __launch_bounds__(THREADS) nn1_kernel(
    const QT* __restrict__ query, const RT* __restrict__ ref,
    const uint8_t* __restrict__ mask, const PT* __restrict__ payload, int P, int p_stride,
    int N, int M, int32_t* __restrict__ idx_out, QT* __restrict__ d2_out,
    QT* __restrict__ sel_out) {
  __shared__ float4 tile[TILE];
  // rank 0's copy holds every rank's partial (d2, idx as float bits)
  __shared__ float2 part[MAX_CLUSTER * QUERIES];
  // parts 1..PARTS-1's partials; then rank 0's winners
  __shared__ float2 part_of[(PARTS - 1) * QUERIES];

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;  // queries lane, lane + LANES, ...
  const int sub = threadIdx.x / LANES;   // which part of every tile it scans
  const int q0 = (blockIdx.x / S) * QUERIES;  // the cluster's first query
  const size_t rbase = static_cast<size_t>(b) * M;
  const int lo = static_cast<int>(static_cast<long long>(M) * rank / S);
  const int hi = static_cast<int>(static_cast<long long>(M) * (rank + 1) / S);

  float qx[QPT], qy[QPT], qz[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + lane + j * LANES;
    const size_t qrow = static_cast<size_t>(b) * N + qi;
    qx[j] = qy[j] = qz[j] = 0.f;
    if (qi < N) {
      qx[j] = static_cast<float>(query[qrow * 3 + 0]);
      qy[j] = static_cast<float>(query[qrow * 3 + 1]);
      qz[j] = static_cast<float>(query[qrow * 3 + 2]);
    }
  }
  // CHAINS independent running minima per query, each over an increasing
  // run of indices with a strict '<', so the compare-select chains overlap.
  float bd[QPT][CHAINS];
  int bi[QPT][CHAINS];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      bd[j][c] = CUDART_INF_F;
      bi[j][c] = 0;
    }
  }

  for (int base = lo; base < hi; base += TILE) {
    const int count = min(TILE, hi - base);
    __syncthreads();  // the previous tile is no longer read
#pragma unroll 4
    for (int t = threadIdx.x; t < count; t += THREADS) {
      const size_t r = rbase + base + t;
      const float w = (mask != nullptr && mask[r] == 0) ? BIG : 0.f;
      tile[t] = make_float4(static_cast<float>(ref[r * 3 + 0]), static_cast<float>(ref[r * 3 + 1]),
                            static_cast<float>(ref[r * 3 + 2]), w);
    }
    __syncthreads();
    if (q0 + lane < N) {  // this thread's first query is live
      const int end = (sub + 1) * count / PARTS;
      int t = sub * count / PARTS;
#pragma unroll 2
      for (; t + CHAINS <= end; t += CHAINS) {
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
          const float4 r = tile[t + c];  // one load serves QPT queries
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            const float d = dist2(qx[j], qy[j], qz[j], r);
            if (d < bd[j][c]) {
              bd[j][c] = d;
              bi[j][c] = base + t + c;
            }
          }
        }
      }
      for (; t < end; ++t) {  // the ragged end, still in increasing index on chain 0
        const float4 r = tile[t];
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const float d = dist2(qx[j], qy[j], qz[j], r);
          if (d < bd[j][0]) {
            bd[j][0] = d;
            bi[j][0] = base + t;
          }
        }
      }
    }
  }

  // Each chain, and each part, holds the first index of its own minimum, so
  // among equal minima the lowest index is the first index of the range.
  float best[QPT];
  int best_i[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    best[j] = bd[j][0];
    best_i[j] = bi[j][0];
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) {
      if (beats(bd[j][c], bi[j][c], best[j], best_i[j])) {
        best[j] = bd[j][c];
        best_i[j] = bi[j][c];
      }
    }
    if (sub > 0) {
      part_of[(sub - 1) * QUERIES + lane + j * LANES] =
          make_float2(best[j], __int_as_float(best_i[j]));
    }
  }
  __syncthreads();
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      for (int p = 1; p < PARTS; ++p) {
        const float2 v = part_of[(p - 1) * QUERIES + lane + j * LANES];
        if (beats(v.x, __float_as_int(v.y), best[j], best_i[j])) {
          best[j] = v.x;
          best_i[j] = __float_as_int(v.y);
        }
      }
    }
  }

  // Part 0 stores the CTA's partials into rank 0's shared memory (a remote
  // store through distributed shared memory) once every CTA has started.
  cluster_wait();
  if (sub == 0) {
    float2* slots = cluster.map_shared_rank(part, 0);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      slots[rank * QUERIES + lane + j * LANES] = make_float2(best[j], __int_as_float(best_i[j]));
    }
  }
  cluster.sync();  // the partials have landed in rank 0's shared memory
  if (rank != 0) return;

  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int slot = lane + j * LANES;
      // Merge in rank (= index) order with a strict '<': the lowest index wins.
      for (int s = 1; s < S; ++s) {
        const float2 v = part[s * QUERIES + slot];
        if (v.x < best[j]) {
          best[j] = v.x;
          best_i[j] = __float_as_int(v.y);
        }
      }
      if (q0 + slot < N) {
        const size_t qrow = static_cast<size_t>(b) * N + q0 + slot;
        idx_out[qrow] = best_i[j];
        d2_out[qrow] = static_cast<QT>(fmaxf(best[j], 0.f));
      }
      part_of[slot].y = __int_as_float(best_i[j]);  // read by the copy below
    }
  }
  if constexpr (WITH_PAYLOAD) {
    __syncthreads();
    // the block's winners' rows, copied by all the CTA's threads together:
    // loads first, then coalesced stores (column = thread % 16 throughout)
    constexpr int PER_THREAD = QUERIES * PAYLOAD / THREADS;
    const int rows = min(QUERIES, N - q0);
    QT v[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int row = e / PAYLOAD;
      const int col = e % PAYLOAD;
      v[k] = static_cast<QT>(0);
      if (row < rows && col < P) {
        const size_t win = rbase + __float_as_int(part_of[row].y);
        v[k] = static_cast<QT>(payload[win * p_stride + col]);
      }
    }
    QT* dst = sel_out + (static_cast<size_t>(b) * N + q0) * PAYLOAD;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = threadIdx.x + k * THREADS;
      if (e / PAYLOAD < rows) dst[e] = v[k];
    }
  }
}

template <typename QT, typename RT, typename PT, bool WITH_PAYLOAD>
int launch(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.N + QUERIES - 1) / QUERIES) * a.S, a.B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, nn1_kernel<QT, RT, PT, WITH_PAYLOAD>, static_cast<const QT*>(a.query),
      static_cast<const RT*>(a.ref), a.mask, static_cast<const PT*>(a.payload), a.P,
      a.p_stride, a.N, a.M, a.idx, static_cast<QT*>(a.d2), static_cast<QT*>(a.sel));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <bool WITH_PAYLOAD, typename QT, typename RT>
int by_payload(const Args& a) {
  if constexpr (!WITH_PAYLOAD) {
    return launch<QT, RT, float, false>(a);
  } else {
    return a.p_dtype == F64 ? launch<QT, RT, double, true>(a) : launch<QT, RT, float, true>(a);
  }
}

template <bool WITH_PAYLOAD, typename QT>
int by_ref(const Args& a) {
  return a.r_dtype == F64 ? by_payload<WITH_PAYLOAD, QT, double>(a)
                          : by_payload<WITH_PAYLOAD, QT, float>(a);
}

bool valid_dtype(int code) { return code == F32 || code == F64; }

template <bool WITH_PAYLOAD>
int dispatch(const Args& a) {
  if (!valid_dtype(a.q_dtype) || !valid_dtype(a.r_dtype) || a.B < 1 || a.N < 1 || a.M < 1 ||
      a.S < 1 || a.S > MAX_CLUSTER) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (WITH_PAYLOAD && (!valid_dtype(a.p_dtype) || a.P < 0 || a.P > PAYLOAD || a.p_stride < a.P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return a.q_dtype == F64 ? by_ref<WITH_PAYLOAD, double>(a) : by_ref<WITH_PAYLOAD, float>(a);
}

}  // namespace

// dtype codes: 0 = float32, 1 = float64. mask may be null. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gorio_nn1(const void* query, int q_dtype, const void* ref, int r_dtype,
                         const uint8_t* mask, int B, int N, int M, int S, int32_t* idx,
                         void* d2, void* stream) {
  const Args a{query, q_dtype, ref, r_dtype, mask, nullptr, F32, 0, 0,
               B, N, M, S, idx, d2, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a);
}

extern "C" int gorio_nn1_select(const void* query, int q_dtype, const void* ref, int r_dtype,
                                const uint8_t* mask, const void* payload, int p_dtype, int P,
                                int p_stride, int B, int N, int M, int S, int32_t* idx,
                                void* d2, void* sel, void* stream) {
  const Args a{query, q_dtype, ref, r_dtype, mask, payload, p_dtype, P, p_stride,
               B, N, M, S, idx, d2, sel, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a);
}
