// One EGNN-MC layer's edge stage, fused: messages, masked means and coordinate weights.
//
//   m1_ij   = silu(hA_i + hB_j + g_ij . Wg)          g_ij = [d2, 4 edge attrs]
//   m2_ij   = silu(m1_ij . W2 + b2)
//   agg_i   = sum_j mask_ij * m2_ij / max(deg_i, 1)
//   w_ij    = tanh(silu(m2_ij . Wc1 + bc1) . wc2)     (tanh optional)
//   trans_i = sum_j mask_ij * clip(w_ij * cd_ij, +-100) / max(deg_i, 1)
//
// Replaces the Pallas TPU kernel `fused_egnn_messages`
// (extending_..._tpu/ops/pallas/egnn_messages.py:197, bodies `_kernel` :46 and
// `_kernel_v2` :119).  Geometry arrives packed as [B, N, N, 8] =
// [d2, e0..e3, cd_x, cd_y, cd_z], for both of the Pallas versions: version 2's
// [B, 8, N, N] planes were a TPU lane layout made inside the JAX wrapper.
//
// What bounds it on an H100: the two 128x128 products per edge.  At the rollout
// shape (B=64, N=100, He=Hc=128) one call is ~42 GFLOP of f32 against ~25 MB of
// inputs, so it is bound by operations (0.63 ms at 67 TFLOP/s f32 on CUDA cores)
// and never by bytes, as long as no [B, N, N, He] tensor goes to device memory.
// The design keeps every per-edge intermediate on chip:
//   * one block of 512 threads per (sim, tile of <= 16 receivers); it stages W2
//     and Wc1 (64 KB each) in dynamic shared memory once and walks the
//     tile's (receiver, sender) edges in chunks of 128 rows;
//   * per chunk, the geometry and mask rows are loaded into shared memory, and
//     the edge stage shared with K3 (egnn_edge.cuh) builds m1, runs the two
//     register-tiled f32 FMA products and adds the masked sums of agg and trans
//     to shared accumulators; the outputs are written once per receiver.
//   * 209 KB of shared memory leaves one block per SM, so the block is as
//     large as the 128-register budget allows: 16 warps hide shared-memory
//     latency better than 8 (a 256-thread block measured ~1.3x slower).
// f32 FMA throughout: no TF32, no tensor cores yet (a later step for wgmma).
//
// Plain C interface for ctypes (ops/_build.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "egnn_edge.cuh"

namespace {

using namespace egnn_edge;

template <bool kTanh>
__global__ void __launch_bounds__(kThreads, 1)
egnn_edge_kernel(const float* __restrict__ hA, const float* __restrict__ hB,
                 const float* __restrict__ geom, const float* __restrict__ mask,
                 const float* __restrict__ wg, const float* __restrict__ W2,
                 const float* __restrict__ b2, const float* __restrict__ Wc1,
                 const float* __restrict__ bc1, const float* __restrict__ wc2,
                 float* __restrict__ agg, float* __restrict__ trans, int n, int ti) {
  extern __shared__ __align__(16) float smem[];
  const Smem s(smem);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * ti;
  const int nrecv = min(ti, n - i0);
  const int rows = nrecv * n;  // edge row r = il * n + j  <->  (i0 + il, j)

  stage_weights(s, wg, W2, b2, Wc1, bc1, wc2, tid);

  const float* hAb = hA + (static_cast<size_t>(b) * n + i0) * kH;
  const float* hBb = hB + static_cast<size_t>(b) * n * kH;
  const float* geomb = geom + (static_cast<size_t>(b) * n + i0) * n * kGeom;
  const float* maskb = mask + (static_cast<size_t>(b) * n + i0) * n;

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    // geometry and mask of this chunk's edges; rows past the tile are zero
    for (int e = tid; e < kRows * kGeom; e += kThreads) {
      const int r = r0 + e / kGeom;
      s.geom[e] = r < rows ? geomb[static_cast<size_t>(r0) * kGeom + e] : 0.0f;
    }
    if (tid < kRows) {
      const int r = r0 + tid;
      const float m = r < rows ? maskb[r] : 0.0f;
      s.mask[tid] = m;
      if (r < rows) atomicAdd(&s.deg[r / n], m);
    }
    __syncthreads();
    edge_chunk<kTanh>(s, hAb, hBb, r0, rows, n, tid);
  }
  write_means(s, agg, trans, b, n, i0, nrecv, tid);
}

template <bool kTanh>
int launch(const float* hA, const float* hB, const float* geom, const float* mask,
           const float* wg, const float* W2, const float* b2, const float* Wc1,
           const float* bc1, const float* wc2, float* agg, float* trans, int batch, int n,
           int ti, cudaStream_t stream) {
  static bool configured = false;
  if (const int err = allow_smem(egnn_edge_kernel<kTanh>, kSmemBytes, configured)) return err;
  dim3 grid((n + ti - 1) / ti, batch);
  egnn_edge_kernel<kTanh><<<grid, kThreads, kSmemBytes, stream>>>(
      hA, hB, geom, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans, n, ti);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nbody_egnn_messages_f32(const float* hA, const float* hB, const float* geom,
                                       const float* mask, const float* wg, const float* W2,
                                       const float* b2, const float* Wc1, const float* bc1,
                                       const float* wc2, float* agg, float* trans, int batch,
                                       int n, int he, int hc, int ti, int use_tanh,
                                       void* stream) {
  if (he != kH || hc != kH || ti < 1 || ti > kMaxTi || n < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return use_tanh ? launch<true>(hA, hB, geom, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans,
                                 batch, n, ti, s)
                  : launch<false>(hA, hB, geom, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans,
                                  batch, n, ti, s);
}
