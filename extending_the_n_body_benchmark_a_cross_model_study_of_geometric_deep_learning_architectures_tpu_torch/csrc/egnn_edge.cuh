// The EGNN-MC edge stage shared by kernels K1 (egnn_messages.cu) and K3
// (egnn_stream.cu).  The two differ only in where an edge row's geometry comes
// from: K1 loads it from a [B, N, N, 8] tensor, K3 computes it from node data.
// Everything after that, for a chunk of kRows edge rows whose geometry and mask
// sit in shared memory, is here:
//
//   m1_ij   = silu(hA_i + hB_j + g_ij . Wg)          g_ij = geometry[0:5]
//   m2_ij   = silu(m1_ij . W2 + b2)
//   agg_i  += mask_ij * m2_ij
//   w_ij    = tanh(silu(m2_ij . Wc1 + bc1) . wc2)     (tanh optional)
//   trans_i += mask_ij * clip(w_ij * cd_ij, +-100)    cd_ij = geometry[5:8]
//
// and the final division by max(deg_i, 1).
//
// Layout: one block of kThreads threads per (sim, tile of <= kMaxTi receivers).
// The tile's edge rows are r = il * n + j <-> (receiver i0 + il, sender j) and are
// walked in chunks of kRows.  W2 and Wc1 (64 KB each) are staged in dynamic shared
// memory once per block; each 128x128 product runs as a register-tiled f32 FMA
// loop (8 rows x 4 columns per thread, float4 shared loads); m2 overwrites m1 in
// place; the masked sums go to shared accumulators.  f32 FMA throughout: no TF32,
// no tensor cores.

#pragma once

#include <cuda_runtime.h>

namespace egnn_edge {

constexpr int kH = 128;              // He == Hc == 128, the model's widths
constexpr int kThreads = 512;        // 16 warps: warp = 8 rows, lane = 4 columns
constexpr int kRows = kThreads / 4;  // edge rows per chunk
constexpr int kMaxTi = 16;           // receivers per block (MAX_RECEIVERS in ops/egnn_messages.py)
constexpr int kGeom = 8;             // d2, 4 edge attrs, cd_x, cd_y, cd_z

constexpr size_t kSmemFloats = 2 * kH * kH        // W2, Wc1
                               + kRows * kH       // m1 / m2 chunk
                               + 5 * kH + 3 * kH  // Wg, b2, bc1, wc2
                               + kRows * kGeom    // geometry chunk
                               + kRows            // mask chunk
                               + kMaxTi * kH      // agg accumulators
                               + kMaxTi * 4       // trans accumulators
                               + kMaxTi;          // degrees
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

// The block's dynamic shared memory, carved as kSmemFloats floats from `base`.
struct Smem {
  float *W2, *Wc1, *A, *Wg, *B2, *Bc1, *Wc2, *geom, *mask, *agg, *trans, *deg;
  __device__ explicit Smem(float* base) {
    W2 = base;
    Wc1 = W2 + kH * kH;
    A = Wc1 + kH * kH;
    Wg = A + kRows * kH;
    B2 = Wg + 5 * kH;
    Bc1 = B2 + kH;
    Wc2 = Bc1 + kH;
    geom = Wc2 + kH;
    mask = geom + kRows * kGeom;
    agg = mask + kRows;
    trans = agg + kMaxTi * kH;
    deg = trans + kMaxTi * 4;
  }
  // first float past the shared layout (for a kernel's own extra scratch)
  __device__ float* end() const { return deg + kMaxTi; }
};

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

// Stage the weights in shared memory and zero the accumulators; ends in a barrier.
__device__ __forceinline__ void stage_weights(const Smem& s, const float* __restrict__ wg,
                                              const float* __restrict__ W2,
                                              const float* __restrict__ b2,
                                              const float* __restrict__ Wc1,
                                              const float* __restrict__ bc1,
                                              const float* __restrict__ wc2, int tid) {
  for (int e = tid; e < kH * kH / 4; e += kThreads) {
    reinterpret_cast<float4*>(s.W2)[e] = reinterpret_cast<const float4*>(W2)[e];
    reinterpret_cast<float4*>(s.Wc1)[e] = reinterpret_cast<const float4*>(Wc1)[e];
  }
  for (int e = tid; e < 5 * kH; e += kThreads) s.Wg[e] = wg[e];
  for (int e = tid; e < kH; e += kThreads) {
    s.B2[e] = b2[e];
    s.Bc1[e] = bc1[e];
    s.Wc2[e] = wc2[e];
  }
  for (int e = tid; e < kMaxTi * kH; e += kThreads) s.agg[e] = 0.0f;
  if (tid < kMaxTi * 4) s.trans[tid] = 0.0f;
  if (tid < kMaxTi) s.deg[tid] = 0.0f;
  __syncthreads();
}

// One chunk of edge rows [r0, r0 + kRows) of a tile with `rows` rows and n senders
// per receiver.  s.geom and s.mask hold the chunk (zero past `rows`) and a barrier
// has passed since they were written.  hAb points at the tile's first receiver,
// hBb at the sim's first sender.  Ends in a barrier, so the caller may overwrite
// s.geom and s.mask right after.
template <bool kTanh>
__device__ __forceinline__ void edge_chunk(const Smem& s, const float* __restrict__ hAb,
                                           const float* __restrict__ hBb, int r0, int rows,
                                           int n, int tid) {
  const int tx = tid & 31;
  const int ty = tid >> 5;

  // m1 = silu(hA_i + hB_j + g . Wg), row-major [kRows, kH]
  for (int e = tid; e < kRows * kH; e += kThreads) {
    const int rl = e / kH;
    const int c = e % kH;
    const int r = r0 + rl;
    float v = 0.0f;
    if (r < rows) {
      const int il = r / n;
      const int j = r - il * n;
      const float* g = s.geom + rl * kGeom;
      v = hAb[il * kH + c] + hBb[j * kH + c] + g[0] * s.Wg[c] + g[1] * s.Wg[kH + c] +
          g[2] * s.Wg[2 * kH + c] + g[3] * s.Wg[3 * kH + c] + g[4] * s.Wg[4 * kH + c];
      v = silu(v);
    }
    s.A[e] = v;
  }
  __syncthreads();

  float acc[8][4];
  chunk_product(s.A, s.W2, ty, tx, acc);
  __syncthreads();  // every warp has read m1 before m2 overwrites it

  // m2 = silu(m1 W2 + b2) back into A; masked sums into the receivers' agg
  {
    const float4 bias = *reinterpret_cast<const float4*>(s.B2 + tx * 4);
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
      *reinterpret_cast<float4*>(s.A + rl * kH + tx * 4) = v;
      const int r = r0 + rl;
      if (r < rows) {
        const int il = r / n;
        if (il != cur) {
          if (cur >= 0) {
#pragma unroll
            for (int p = 0; p < 4; ++p) atomicAdd(&s.agg[cur * kH + tx * 4 + p], part[p]);
          }
          cur = il;
          part[0] = part[1] = part[2] = part[3] = 0.0f;
        }
        const float m = s.mask[rl];
        part[0] += m * v.x;
        part[1] += m * v.y;
        part[2] += m * v.z;
        part[3] += m * v.w;
      }
    }
    if (cur >= 0) {
#pragma unroll
      for (int p = 0; p < 4; ++p) atomicAdd(&s.agg[cur * kH + tx * 4 + p], part[p]);
    }
  }
  __syncthreads();

  chunk_product(s.A, s.Wc1, ty, tx, acc);

  // w = tanh(silu(m2 Wc1 + bc1) . wc2): a row's dot product spans the warp
  {
    const float4 bias = *reinterpret_cast<const float4*>(s.Bc1 + tx * 4);
    const float4 wv = *reinterpret_cast<const float4*>(s.Wc2 + tx * 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float sum = silu(acc[q][0] + bias.x) * wv.x + silu(acc[q][1] + bias.y) * wv.y +
                  silu(acc[q][2] + bias.z) * wv.z + silu(acc[q][3] + bias.w) * wv.w;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int rl = ty * 8 + q;
      const int r = r0 + rl;
      if (tx < 3 && r < rows) {
        const float w = kTanh ? tanhf(sum) : sum;
        const float m = s.mask[rl];
        atomicAdd(&s.trans[(r / n) * 4 + tx], m * clip100(w * s.geom[rl * kGeom + 5 + tx]));
      }
    }
  }
  __syncthreads();  // before the next chunk overwrites geom, mask and A
}

// agg [B, N, kH] and trans [B, N, 3] of the tile's nrecv receivers: sums / max(deg, 1).
__device__ __forceinline__ void write_means(const Smem& s, float* __restrict__ agg,
                                            float* __restrict__ trans, int b, int n, int i0,
                                            int nrecv, int tid) {
  for (int e = tid; e < nrecv * kH; e += kThreads) {
    const int il = e / kH;
    agg[(static_cast<size_t>(b) * n + i0 + il) * kH + e % kH] = s.agg[e] / fmaxf(s.deg[il], 1.0f);
  }
  if (tid < nrecv * 3) {
    const int il = tid / 3;
    const int d = tid % 3;
    trans[(static_cast<size_t>(b) * n + i0 + il) * 3 + d] =
        s.trans[il * 4 + d] / fmaxf(s.deg[il], 1.0f);
  }
}

// Raise a kernel's dynamic shared memory limit once per process.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

}  // namespace egnn_edge
