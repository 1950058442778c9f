// One EGNN-MC layer's edge stage with the geometry computed from node data: the
// streaming form of K1 (egnn_messages.cu) for large N.
//
//   cd0_ij  = pos0_i - pos0_j                 d0_ij = max(|cd0_ij|, 1e-12)
//   e_ij    = [m_i m_j, v_i . cd0_ij / d0_ij, v_j . cd0_ij / d0_ij, |cd0_ij|^2]
//   cd_ij   = coord_i - coord_j               (divided by max(|cd_ij|, 1) if norm_diff)
//   g_ij    = [|coord_i - coord_j|^2, e_ij]
//
// and then the same messages, masked means and coordinate weights as K1.  pos0,
// vel and mass are the scene's (the same for every layer), coord is the layer's.
//
// Replaces the Pallas TPU kernel `streaming_egnn_messages`
// (extending_..._tpu/ops/pallas/egnn_stream.py:192, body `_kernel` :51).  That
// kernel runs a (B, N/TI, N/TJ) grid in order and carries its sums across sender
// tiles in VMEM scratch; blocks here run in parallel and in no order, so a block
// owns whole receivers and walks all their senders itself, as K1 does.
//
// What bounds it on an H100: the two 128x128 products per edge, as in K1.  At
// (B, N) = (8, 512) one call is ~141 GFLOP of f32 (2.1 ms at 67 TFLOP/s on CUDA
// cores) against ~10 MB of node data and mask, so it is bound by operations.  No
// [B, N, N, *] tensor but the mask goes to or comes from device memory: the
// dense path's [B, N, N, 8] geometry (537 MB at N = 4096) is never made.
//   * one block of 512 threads per (sim, tile of <= 16 receivers); the
//     receivers' node data (10 floats each) sit in shared memory, W2 and Wc1
//     are staged once (egnn_edge.cuh);
//   * per chunk of 128 edge rows, a prologue computes each row's 8 geometry
//     scalars from the receiver's node data in shared memory and the sender's
//     read from device memory (L1/L2 resident: 40 bytes a node), then the edge
//     stage shared with K1 runs on them;
//   * any N: the last chunk of a tile and the last tile of a sim are ragged and
//     masked, with no tile-divisibility assumption.
// f32 FMA throughout: no TF32, no tensor cores yet.
//
// Plain C interface for ctypes (ops/_build.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "egnn_edge.cuh"

namespace {

using namespace egnn_edge;

constexpr int kNode = 10;  // pos0 (3), vel (3), mass (1), coord (3)
constexpr size_t kStreamSmemBytes = kSmemBytes + kMaxTi * kNode * sizeof(float);

template <bool kTanh, bool kNormDiff>
__global__ void __launch_bounds__(kThreads, 1)
egnn_stream_kernel(const float* __restrict__ hA, const float* __restrict__ hB,
                   const float* __restrict__ pos0, const float* __restrict__ vel,
                   const float* __restrict__ mass, const float* __restrict__ coord,
                   const float* __restrict__ mask, const float* __restrict__ wg,
                   const float* __restrict__ W2, const float* __restrict__ b2,
                   const float* __restrict__ Wc1, const float* __restrict__ bc1,
                   const float* __restrict__ wc2, float* __restrict__ agg,
                   float* __restrict__ trans, int n, int ti) {
  extern __shared__ __align__(16) float smem[];
  const Smem s(smem);
  float* sNode = s.end();  // [kMaxTi, kNode]
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * ti;
  const int nrecv = min(ti, n - i0);
  const int rows = nrecv * n;  // edge row r = il * n + j  <->  (i0 + il, j)
  const size_t sim = static_cast<size_t>(b) * n;

  if (tid < nrecv) {
    const size_t i = sim + i0 + tid;
    float* nd = sNode + tid * kNode;
    for (int k = 0; k < 3; ++k) {
      nd[k] = pos0[i * 3 + k];
      nd[3 + k] = vel[i * 3 + k];
      nd[7 + k] = coord[i * 3 + k];
    }
    nd[6] = mass[i];
  }
  stage_weights(s, wg, W2, b2, Wc1, bc1, wc2, tid);  // its barrier covers sNode too

  const float* hAb = hA + (sim + i0) * kH;
  const float* hBb = hB + sim * kH;
  const float* maskb = mask + (sim + i0) * n;

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    // prologue: the geometry of this chunk's edge rows, as the TPU body computes it
    // (egnn_stream.py:95-109); rows past the tile are zero
    if (tid < kRows) {
      const int r = r0 + tid;
      float g[kGeom] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float m = 0.0f;
      if (r < rows) {
        const int il = r / n;
        const size_t j = sim + (r - il * n);
        const float* ni = sNode + il * kNode;
        const float c0x = ni[0] - pos0[j * 3], c0y = ni[1] - pos0[j * 3 + 1],
                    c0z = ni[2] - pos0[j * 3 + 2];
        const float d2_0 = c0x * c0x + c0y * c0y + c0z * c0z;
        const float inv_d0 = 1.0f / fmaxf(sqrtf(fmaxf(d2_0, 0.0f)), 1e-12f);
        const float ux = c0x * inv_d0, uy = c0y * inv_d0, uz = c0z * inv_d0;
        float cx = ni[7] - coord[j * 3], cy = ni[8] - coord[j * 3 + 1],
              cz = ni[9] - coord[j * 3 + 2];
        const float radial = cx * cx + cy * cy + cz * cz;
        if (kNormDiff) {
          const float inv_norm = 1.0f / fmaxf(sqrtf(fmaxf(radial, 0.0f)), 1.0f);
          cx *= inv_norm;
          cy *= inv_norm;
          cz *= inv_norm;
        }
        g[0] = radial;
        g[1] = ni[6] * mass[j];
        g[2] = ni[3] * ux + ni[4] * uy + ni[5] * uz;
        g[3] = vel[j * 3] * ux + vel[j * 3 + 1] * uy + vel[j * 3 + 2] * uz;
        g[4] = d2_0;
        g[5] = cx;
        g[6] = cy;
        g[7] = cz;
        m = maskb[r];
        atomicAdd(&s.deg[il], m);
      }
#pragma unroll
      for (int k = 0; k < kGeom; ++k) s.geom[tid * kGeom + k] = g[k];
      s.mask[tid] = m;
    }
    __syncthreads();
    edge_chunk<kTanh>(s, hAb, hBb, r0, rows, n, tid);
  }
  write_means(s, agg, trans, b, n, i0, nrecv, tid);
}

template <bool kTanh, bool kNormDiff>
int launch(const float* hA, const float* hB, const float* pos0, const float* vel,
           const float* mass, const float* coord, const float* mask, const float* wg,
           const float* W2, const float* b2, const float* Wc1, const float* bc1,
           const float* wc2, float* agg, float* trans, int batch, int n, int ti,
           cudaStream_t stream) {
  static bool configured = false;
  const auto kernel = &egnn_stream_kernel<kTanh, kNormDiff>;
  if (const int err = allow_smem(kernel, kStreamSmemBytes, configured)) return err;
  dim3 grid((n + ti - 1) / ti, batch);
  kernel<<<grid, kThreads, kStreamSmemBytes, stream>>>(
      hA, hB, pos0, vel, mass, coord, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans, n, ti);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nbody_egnn_stream_f32(const float* hA, const float* hB, const float* pos0,
                                     const float* vel, const float* mass, const float* coord,
                                     const float* mask, const float* wg, const float* W2,
                                     const float* b2, const float* Wc1, const float* bc1,
                                     const float* wc2, float* agg, float* trans, int batch,
                                     int n, int he, int hc, int ti, int use_tanh,
                                     int norm_diff, void* stream) {
  if (he != kH || hc != kH || ti < 1 || ti > kMaxTi || n < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = use_tanh ? (norm_diff ? &launch<true, true> : &launch<true, false>)
                           : (norm_diff ? &launch<false, true> : &launch<false, false>);
  return go(hA, hB, pos0, vel, mass, coord, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans,
            batch, n, ti, s);
}
