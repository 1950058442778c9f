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
//   * per chunk, m1 is built in shared memory, each product runs as a register
//     tiled f32 FMA loop (8 rows x 4 columns per thread, float4 shared loads),
//     m2 overwrites m1 in place, and the masked sums of agg and trans go to
//     shared accumulators; the outputs are written once per receiver.
//   * 209 KB of shared memory leaves one block per SM, so the block is as
//     large as the 128-register budget allows: 16 warps hide shared-memory
//     latency better than 8 (a 256-thread block measured ~1.3x slower).
// f32 FMA throughout: no TF32, no tensor cores yet (a later step for wgmma).
//
// Plain C interface for ctypes (ops/_build.py); returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kH = 128;            // He == Hc == 128, the model's widths
constexpr int kThreads = 512;      // 16 warps: warp = 8 rows, lane = 4 columns
constexpr int kRows = kThreads / 4;  // edge rows per chunk
constexpr int kMaxTi = 16;         // receivers per block (MAX_RECEIVERS in ops/egnn_messages.py)
constexpr int kGeom = 8;

constexpr size_t kSmemFloats = 2 * kH * kH        // W2, Wc1
                               + kRows * kH       // m1 / m2 chunk
                               + 5 * kH + 3 * kH  // Wg, b2, bc1, wc2
                               + kRows * kGeom    // geometry chunk
                               + kRows            // mask chunk
                               + kMaxTi * kH      // agg accumulators
                               + kMaxTi * 4       // trans accumulators
                               + kMaxTi;          // degrees
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// NaN passes through, as in torch.clamp / jnp.clip.
__device__ __forceinline__ float clip100(float x) {
  return x < -100.0f ? -100.0f : (x > 100.0f ? 100.0f : x);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// acc[q][p] = sum_k A[ty*8+q][k] * W[k][tx*4+p] over a row-major kRows x 128 chunk A
// and a row-major 128x128 W, both in shared memory.
__device__ __forceinline__ void chunk_product(const float* __restrict__ a,
                                              const float* __restrict__ w, int ty, int tx,
                                              float acc[8][4]) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0.0f;
  const float* arow = a + ty * 8 * kH;
#pragma unroll 2
  for (int k = 0; k < kH; k += 4) {
    float4 av[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) av[q] = *reinterpret_cast<const float4*>(arow + q * kH + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(w + (k + kk) * kH + tx * 4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float x = comp(av[q], kk);
        acc[q][0] += x * wv.x;
        acc[q][1] += x * wv.y;
        acc[q][2] += x * wv.z;
        acc[q][3] += x * wv.w;
      }
    }
  }
}

template <bool kTanh>
__global__ void __launch_bounds__(kThreads, 1)
egnn_edge_kernel(const float* __restrict__ hA, const float* __restrict__ hB,
                 const float* __restrict__ geom, const float* __restrict__ mask,
                 const float* __restrict__ wg, const float* __restrict__ W2,
                 const float* __restrict__ b2, const float* __restrict__ Wc1,
                 const float* __restrict__ bc1, const float* __restrict__ wc2,
                 float* __restrict__ agg, float* __restrict__ trans, int n, int ti) {
  extern __shared__ __align__(16) float smem[];
  float* sW2 = smem;
  float* sWc1 = sW2 + kH * kH;
  float* sA = sWc1 + kH * kH;
  float* sWg = sA + kRows * kH;
  float* sB2 = sWg + 5 * kH;
  float* sBc1 = sB2 + kH;
  float* sWc2 = sBc1 + kH;
  float* sGeom = sWc2 + kH;
  float* sMask = sGeom + kRows * kGeom;
  float* sAgg = sMask + kRows;
  float* sTrans = sAgg + kMaxTi * kH;
  float* sDeg = sTrans + kMaxTi * 4;

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * ti;
  const int nrecv = min(ti, n - i0);
  const int rows = nrecv * n;  // edge row r = il * n + j  <->  (i0 + il, j)

  for (int e = tid; e < kH * kH / 4; e += kThreads) {
    reinterpret_cast<float4*>(sW2)[e] = reinterpret_cast<const float4*>(W2)[e];
    reinterpret_cast<float4*>(sWc1)[e] = reinterpret_cast<const float4*>(Wc1)[e];
  }
  for (int e = tid; e < 5 * kH; e += kThreads) sWg[e] = wg[e];
  for (int e = tid; e < kH; e += kThreads) {
    sB2[e] = b2[e];
    sBc1[e] = bc1[e];
    sWc2[e] = wc2[e];
  }
  for (int e = tid; e < kMaxTi * kH; e += kThreads) sAgg[e] = 0.0f;
  if (tid < kMaxTi * 4) sTrans[tid] = 0.0f;
  if (tid < kMaxTi) sDeg[tid] = 0.0f;
  __syncthreads();

  const float* hAb = hA + (static_cast<size_t>(b) * n + i0) * kH;
  const float* hBb = hB + static_cast<size_t>(b) * n * kH;
  const float* geomb = geom + (static_cast<size_t>(b) * n + i0) * n * kGeom;
  const float* maskb = mask + (static_cast<size_t>(b) * n + i0) * n;

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    // geometry and mask of this chunk's edges; rows past the tile are zero
    for (int e = tid; e < kRows * kGeom; e += kThreads) {
      const int r = r0 + e / kGeom;
      sGeom[e] = r < rows ? geomb[static_cast<size_t>(r0) * kGeom + e] : 0.0f;
    }
    if (tid < kRows) {
      const int r = r0 + tid;
      const float m = r < rows ? maskb[r] : 0.0f;
      sMask[tid] = m;
      if (r < rows) atomicAdd(&sDeg[r / n], m);
    }
    __syncthreads();

    // m1 = silu(hA_i + hB_j + g . Wg), row-major [kRows, kH]
    for (int e = tid; e < kRows * kH; e += kThreads) {
      const int rl = e / kH;
      const int c = e % kH;
      const int r = r0 + rl;
      float v = 0.0f;
      if (r < rows) {
        const int il = r / n;
        const int j = r - il * n;
        const float* g = sGeom + rl * kGeom;
        v = hAb[il * kH + c] + hBb[j * kH + c] + g[0] * sWg[c] + g[1] * sWg[kH + c] +
            g[2] * sWg[2 * kH + c] + g[3] * sWg[3 * kH + c] + g[4] * sWg[4 * kH + c];
        v = silu(v);
      }
      sA[e] = v;
    }
    __syncthreads();

    float acc[8][4];
    chunk_product(sA, sW2, ty, tx, acc);
    __syncthreads();  // every warp has read m1 before m2 overwrites it

    // m2 = silu(m1 W2 + b2) back into sA; masked sums into the receivers' agg
    {
      const float4 bias = *reinterpret_cast<const float4*>(sB2 + tx * 4);
      int cur = -1;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int rl = ty * 8 + q;
        float4 v;
        v.x = silu(acc[q][0] + bias.x);
        v.y = silu(acc[q][1] + bias.y);
        v.z = silu(acc[q][2] + bias.z);
        v.w = silu(acc[q][3] + bias.w);
        *reinterpret_cast<float4*>(sA + rl * kH + tx * 4) = v;
        const int r = r0 + rl;
        if (r < rows) {
          const int il = r / n;
          if (il != cur) {
            if (cur >= 0) {
#pragma unroll
              for (int p = 0; p < 4; ++p) atomicAdd(&sAgg[cur * kH + tx * 4 + p], part[p]);
            }
            cur = il;
            part[0] = part[1] = part[2] = part[3] = 0.0f;
          }
          const float m = sMask[rl];
          part[0] += m * v.x;
          part[1] += m * v.y;
          part[2] += m * v.z;
          part[3] += m * v.w;
        }
      }
      if (cur >= 0) {
#pragma unroll
        for (int p = 0; p < 4; ++p) atomicAdd(&sAgg[cur * kH + tx * 4 + p], part[p]);
      }
    }
    __syncthreads();

    chunk_product(sA, sWc1, ty, tx, acc);

    // w = tanh(silu(m2 Wc1 + bc1) . wc2): a row's dot product spans the warp
    {
      const float4 bias = *reinterpret_cast<const float4*>(sBc1 + tx * 4);
      const float4 wv = *reinterpret_cast<const float4*>(sWc2 + tx * 4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float s = silu(acc[q][0] + bias.x) * wv.x + silu(acc[q][1] + bias.y) * wv.y +
                  silu(acc[q][2] + bias.z) * wv.z + silu(acc[q][3] + bias.w) * wv.w;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        const int rl = ty * 8 + q;
        const int r = r0 + rl;
        if (tx < 3 && r < rows) {
          const float w = kTanh ? tanhf(s) : s;
          const float m = sMask[rl];
          atomicAdd(&sTrans[(r / n) * 4 + tx], m * clip100(w * sGeom[rl * kGeom + 5 + tx]));
        }
      }
    }
    __syncthreads();  // before the next chunk overwrites sGeom, sMask and sA
  }

  for (int e = tid; e < nrecv * kH; e += kThreads) {
    const int il = e / kH;
    agg[(static_cast<size_t>(b) * n + i0 + il) * kH + e % kH] =
        sAgg[e] / fmaxf(sDeg[il], 1.0f);
  }
  if (tid < nrecv * 3) {
    const int il = tid / 3;
    const int d = tid % 3;
    trans[(static_cast<size_t>(b) * n + i0 + il) * 3 + d] =
        sTrans[il * 4 + d] / fmaxf(sDeg[il], 1.0f);
  }
}

template <bool kTanh>
int launch(const float* hA, const float* hB, const float* geom, const float* mask,
           const float* wg, const float* W2, const float* b2, const float* Wc1,
           const float* bc1, const float* wc2, float* agg, float* trans, int batch, int n,
           int ti, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        egnn_edge_kernel<kTanh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
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
