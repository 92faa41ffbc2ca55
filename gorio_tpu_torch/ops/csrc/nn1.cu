// Exact brute-force 1-NN (+ winner payload row) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of gorio_tpu/ops/nn_pallas.py:
//   gorio_nn1        <- _kernel        (nn1_pallas,        dispatched by nn1_best)
//   gorio_nn1_select <- _select_kernel (nn1_select_pallas, dispatched by nn1_select)
//
// What it computes: for every query q of batch b, the index of the ref r
// minimising |q - r|^2 + bias[r] (bias = 0 for live refs, 1e12 for masked
// ones), that minimum (clamped >= 0), and with WITH_PAYLOAD the winner's
// 16-float payload row. The lowest index wins ties, as on the TPU.
//
// What bounds it on this card: arithmetic issue, not bytes. At the GICP
// shape (N = M = 2048, one batch) the inputs are 2048 x 16 B of refs and
// 2048 x 64 B of payload, all L2-resident, while the search is N*M = 4.2M
// distance evaluations of ~8 FP32 instructions each. K = 3 is far too
// narrow for tensor cores, so the distance is the direct (q - r)^2 with
// FMAs on the CUDA cores; this also avoids the |q|^2 + |r|^2 - 2 q.r
// cancellation of the TPU's matmul form at 50 m ranges.
//
// What the design does about it:
//  * One thread owns one query and keeps its running (min, argmin) in
//    registers; the TPU's sequential ref-tile grid axis becomes a loop over
//    tiles of TILE refs staged as float4(x, y, z, bias) in shared memory.
//    Every thread of a warp reads the same tile entry, a broadcast with no
//    bank conflicts.
//  * Refs are visited in increasing index and the running minimum is only
//    replaced on a strict '<', so the first index wins ties (the TPU kernel
//    gets the same rule from its min-column select and strict '<' across
//    tiles).
//  * The payload row is read once, at the end, as 4 x float4: the one-hot
//    matmul the TPU kernel runs per tile buys nothing here.
//  * Ragged N and M are bounds-checked; nothing is padded to tiles.
//  * Known limit: with one query per thread, N = 2048 fills only
//    ceil(2048 / THREADS) blocks of the 132 SMs. Splitting the ref range over
//    blocks with a merge pass is later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // queries per block
constexpr int TILE = 1024;    // refs staged per shared-memory tile (16 KB)
constexpr int PAYLOAD = 16;   // payload floats per ref row

template <bool WITH_PAYLOAD>
__global__ void __launch_bounds__(THREADS) nn1_kernel(
    const float* __restrict__ query,    // (B, N, 3)
    const float* __restrict__ ref,      // (B, M, 3)
    const float* __restrict__ bias,     // (B, M) or nullptr
    const float* __restrict__ payload,  // (B, M, 16) when WITH_PAYLOAD
    int N, int M,
    int32_t* __restrict__ idx_out,      // (B, N)
    float* __restrict__ d2_out,         // (B, N)
    float* __restrict__ sel_out) {      // (B, N, 16) when WITH_PAYLOAD
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * THREADS + threadIdx.x;
  const bool active = qi < N;
  const size_t qrow = static_cast<size_t>(b) * N + qi;
  const size_t rbase = static_cast<size_t>(b) * M;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[qrow * 3 + 0];
    qy = query[qrow * 3 + 1];
    qz = query[qrow * 3 + 2];
  }
  float best = CUDART_INF_F;
  int best_i = 0;

  for (int base = 0; base < M; base += TILE) {
    const int count = min(TILE, M - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < count; t += THREADS) {
      const size_t r = rbase + base + t;
      tile[t] = make_float4(ref[r * 3 + 0], ref[r * 3 + 1], ref[r * 3 + 2],
                            bias != nullptr ? bias[r] : 0.f);
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int t = 0; t < count; ++t) {
        const float4 r = tile[t];
        const float dx = qx - r.x;
        const float dy = qy - r.y;
        const float dz = qz - r.z;
        const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx)) + r.w;
        if (d < best) {
          best = d;
          best_i = base + t;
        }
      }
    }
  }

  if (!active) return;
  idx_out[qrow] = best_i;
  d2_out[qrow] = fmaxf(best, 0.f);
  if constexpr (WITH_PAYLOAD) {
    const float4* src = reinterpret_cast<const float4*>(payload + (rbase + best_i) * PAYLOAD);
    float4* dst = reinterpret_cast<float4*>(sel_out + qrow * PAYLOAD);
#pragma unroll
    for (int k = 0; k < PAYLOAD / 4; ++k) dst[k] = src[k];
  }
}

template <bool WITH_PAYLOAD>
int launch(const float* query, const float* ref, const float* bias, const float* payload,
           int B, int N, int M, int32_t* idx, float* d2, float* sel, void* stream) {
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  nn1_kernel<WITH_PAYLOAD><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      query, ref, bias, payload, N, M, idx, d2, sel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gorio_nn1(const float* query, const float* ref, const float* bias,
                         int B, int N, int M, int32_t* idx, float* d2, void* stream) {
  return launch<false>(query, ref, bias, nullptr, B, N, M, idx, d2, nullptr, stream);
}

extern "C" int gorio_nn1_select(const float* query, const float* ref, const float* bias,
                                const float* payload, int B, int N, int M,
                                int32_t* idx, float* d2, float* sel, void* stream) {
  return launch<true>(query, ref, bias, payload, B, N, M, idx, d2, sel, stream);
}
