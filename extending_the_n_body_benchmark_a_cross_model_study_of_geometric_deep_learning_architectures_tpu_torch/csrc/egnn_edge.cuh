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
// walked in chunks of kRows.  W2 and Wc1 are staged in dynamic shared memory once
// per block; m2 overwrites m1 in place.
//
// Two operand types, one template (T):
//   * float: each 128x128 product is a register-tiled f32 FMA loop (8 rows x 4
//     columns per thread, float4 shared loads).  No TF32, no tensor cores.
//   * __nv_bfloat16 (the mixed-bf16 model): hA, hB and every weight are bf16;
//     m1, m2 and the silu output before wc2 are rounded to bf16 as matmul
//     operands, and every product accumulates in f32, as the TPU bodies do
//     (ops/pallas/egnn_messages.py:66-115, egnn_stream.py:138-169).  The two
//     128x128 products run on the tensor cores: warp-level
//     mma.sync.m16n8k16 bf16 -> f32 on fragments read with ldmatrix (.trans for
//     the row-major [K, N] weights); 16 warps as 4 x 4 tiles of 32 x 32.  Rows of
//     the bf16 tiles are padded to 136 elements (272 B) so the eight row
//     addresses of an ldmatrix phase fall in distinct banks.  m2 is kept in f32
//     beside its bf16 copy, because agg sums the unrounded m2.
// kElem (K3's elem_bf16): the two silus and the mask multiply run in bf16, one
// rounding per operation (x * 1/(1 + exp(-x)) on __nv_bfloat162 pairs), and m2
// is stored only in bf16; the sums stay f32.
//
// Every sum runs in a fixed order, so a launch is bitwise reproducible: after a
// chunk's m2 is in shared memory, one thread owns each (receiver, column pair)
// and adds mask * m2 over the chunk's rows of that receiver in row order; each
// row writes its three masked, clipped trans terms to shared memory, and one
// thread per (receiver, component) adds them in row order.  Only the degree
// uses a float atomic, and it adds exact 0/1 values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace egnn_edge {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kH = 128;              // He == Hc == 128, the model's widths
constexpr int kThreads = 512;        // 16 warps
constexpr int kRows = kThreads / 4;  // edge rows per chunk
constexpr int kMaxTi = 16;           // receivers per block (MAX_RECEIVERS in ops/egnn_messages.py)
constexpr int kGeom = 8;             // d2, 4 edge attrs, cd_x, cd_y, cd_z
constexpr int kLdB = kH + 8;         // padded row of a bf16 tile (272 B)
constexpr int kLdM = kH + 8;         // padded row of the f32 copy of m2

// The block's dynamic shared memory for operand type T and elementwise mode kElem.
template <typename T, bool kElem>
struct Smem {
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  static constexpr int kLd = kMma ? kLdB : kH;  // row stride of W2, Wc1 and A
  static constexpr size_t kTileBytes = size_t(kH) * kLd * sizeof(T);
  static constexpr size_t kM2Bytes = (kMma && !kElem) ? size_t(kRows) * kLdM * sizeof(float) : 0;
  static constexpr size_t kFloats = 5 * kH + 3 * kH  // Wg, b2, bc1, wc2
                                    + kRows * kGeom   // geometry chunk
                                    + kRows           // mask chunk
                                    + kMaxTi * kH     // agg accumulators
                                    + kMaxTi * 4      // trans accumulators
                                    + kMaxTi          // degrees
                                    + kRows * 4       // a chunk's trans terms
                                    + kRows * 4;      // partial coordinate weights (mma)
  static constexpr size_t kBytes = 3 * kTileBytes + kM2Bytes + kFloats * sizeof(float);

  T *W2, *Wc1, *A;  // A: the chunk's m1, then m2 (the matmul operand)
  float *M2, *Wg, *B2, *Bc1, *Wc2, *geom, *mask, *agg, *trans, *deg, *trow, *wpart;

  __device__ explicit Smem(unsigned char* base) {
    W2 = reinterpret_cast<T*>(base);
    Wc1 = reinterpret_cast<T*>(base + kTileBytes);
    A = reinterpret_cast<T*>(base + 2 * kTileBytes);
    M2 = reinterpret_cast<float*>(base + 3 * kTileBytes);
    Wg = M2 + kM2Bytes / sizeof(float);
    B2 = Wg + 5 * kH;
    Bc1 = B2 + kH;
    Wc2 = Bc1 + kH;
    geom = Wc2 + kH;
    mask = geom + kRows * kGeom;
    agg = mask + kRows;
    trans = agg + kMaxTi * kH;
    deg = trans + kMaxTi * 4;
    trow = deg + kMaxTi;
    wpart = trow + kRows * 4;
  }
  // first float past the shared layout (for a kernel's own extra scratch)
  __device__ float* end() const { return wpart + kRows * 4; }
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// x * (1 / (1 + exp(-x))) in bf16, rounded after each operation (egnn_stream.py:117-122)
__device__ __forceinline__ bf162 silu2(bf162 x) {
  const bf162 one = __float2bfloat162_rn(1.0f);
  return __hmul2(x, h2rcp(__hadd2(one, h2exp(__hneg2(x)))));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// NaN passes through, as in torch.clamp / jnp.clip.
__device__ __forceinline__ float clip100(float x) {
  return x < -100.0f ? -100.0f : (x > 100.0f ? 100.0f : x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(bf16* p, float2 v) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store2(float* p, bf162 v) {
  *reinterpret_cast<float2*>(p) = __bfloat1622float2(v);
}
__device__ __forceinline__ void store2(bf16* p, bf162 v) { *reinterpret_cast<bf162*>(p) = v; }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------- f32 products
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

// ------------------------------------------------------ bf16 tensor-core products
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp (wm, wn) of a 4 x 4 warp grid: acc[mt][nt][.] = the 32 x 32 tile at rows
// wm*32 + mt*16, columns wn*32 + nt*8 of A . W, A [kRows, kLdB] and W [kH, kLdB]
// row-major bf16 in shared memory.  Fragment element e of acc[mt][nt] sits at
// row wm*32 + mt*16 + lane/4 + 8*(e/2), column wn*32 + nt*8 + 2*(lane%4) + e%2.
__device__ __forceinline__ void mma_product(const bf16* __restrict__ a,
                                            const bf16* __restrict__ w, int wm, int wn,
                                            int lane, float acc[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  // ldmatrix: lane l addresses row (l % 8) + 8 * ((l / 8) % 2) and column block l / 16
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lc = (lane >> 4) * 8;
#pragma unroll 2
  for (int k0 = 0; k0 < kH; k0 += 16) {
    uint32_t af[2][4], bfr[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(af[mt], a + (wm * 32 + mt * 16 + lr) * kLdB + k0 + lc);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldmatrix_x4_trans(bfr[np], w + (k0 + lr) * kLdB + wn * 32 + np * 16 + lc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
  }
}

// ------------------------------------------------------------------ staging
// Stage the weights in shared memory and zero the accumulators; ends in a barrier.
template <typename T, bool kElem>
__device__ __forceinline__ void stage_weights(const Smem<T, kElem>& s, const T* __restrict__ wg,
                                              const T* __restrict__ W2, const T* __restrict__ b2,
                                              const T* __restrict__ Wc1,
                                              const T* __restrict__ bc1,
                                              const T* __restrict__ wc2, int tid) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = kH / kVec;
  for (int e = tid; e < kH * kPerRow; e += kThreads) {
    const int row = e / kPerRow;
    const int col = (e % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(s.W2 + row * Smem<T, kElem>::kLd + col) =
        reinterpret_cast<const uint4*>(W2)[e];
    *reinterpret_cast<uint4*>(s.Wc1 + row * Smem<T, kElem>::kLd + col) =
        reinterpret_cast<const uint4*>(Wc1)[e];
  }
  for (int e = tid; e < 5 * kH; e += kThreads) s.Wg[e] = to_f(wg[e]);
  for (int e = tid; e < kH; e += kThreads) {
    s.B2[e] = to_f(b2[e]);
    s.Bc1[e] = to_f(bc1[e]);
    s.Wc2[e] = to_f(wc2[e]);
  }
  for (int e = tid; e < kMaxTi * kH; e += kThreads) s.agg[e] = 0.0f;
  if (tid < kMaxTi * 4) s.trans[tid] = 0.0f;
  if (tid < kMaxTi) s.deg[tid] = 0.0f;
  __syncthreads();
}

// ------------------------------------------------------------------ one chunk
// One chunk of edge rows [r0, r0 + kRows) of a tile with `rows` rows and n senders
// per receiver.  s.geom and s.mask hold the chunk (zero past `rows`) and a barrier
// has passed since they were written.  hAb points at the tile's first receiver,
// hBb at the sim's first sender.  Ends in a barrier, so the caller may overwrite
// s.geom and s.mask right after.
template <typename T, bool kElem, bool kTanh>
__device__ __forceinline__ void edge_chunk(const Smem<T, kElem>& s, const T* __restrict__ hAb,
                                           const T* __restrict__ hBb, int r0, int rows, int n,
                                           int tid) {
  using S = Smem<T, kElem>;
  constexpr int kPairs = kH / 2;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // m1 = silu(hA_i + hB_j + g . Wg), row-major [kRows, kLd], a column pair per step
  for (int e = tid; e < kRows * kPairs; e += kThreads) {
    const int rl = e / kPairs;
    const int c = (e % kPairs) * 2;
    const int r = r0 + rl;
    float2 v = make_float2(0.0f, 0.0f);
    if (r < rows) {
      const int il = r / n;
      const int j = r - il * n;
      const float* g = s.geom + rl * kGeom;
      const float2 a = load2(hAb + il * kH + c);
      const float2 b = load2(hBb + j * kH + c);
      float gx = 0.0f, gy = 0.0f;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        gx += g[k] * s.Wg[k * kH + c];
        gy += g[k] * s.Wg[k * kH + c + 1];
      }
      v = make_float2(a.x + b.x + gx, a.y + b.y + gy);
    }
    T* dst = s.A + rl * S::kLd + c;
    if constexpr (kElem) {
      store2(dst, silu2(__floats2bfloat162_rn(v.x, v.y)));
    } else {
      store2(dst, make_float2(silu(v.x), silu(v.y)));
    }
  }
  __syncthreads();

  if constexpr (S::kMma) {
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[2][4][4];
    mma_product(s.A, s.W2, wm, wn, lane, acc);
    __syncthreads();  // every warp has read m1 before m2 overwrites it

    // m2 = silu(m1 W2 + b2) back into A (bf16) and, unrounded, into M2
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = wm * 32 + mt * 16 + g + half * 8;
          const int c = wn * 32 + nt * 8 + 2 * t4;
          const float vx = acc[mt][nt][2 * half] + s.B2[c];
          const float vy = acc[mt][nt][2 * half + 1] + s.B2[c + 1];
          if constexpr (kElem) {
            store2(s.A + rl * kLdB + c, silu2(__floats2bfloat162_rn(vx, vy)));
          } else {
            const float2 m2 = make_float2(silu(vx), silu(vy));
            store2(s.M2 + rl * kLdM + c, m2);
            store2(s.A + rl * kLdB + c, m2);
          }
        }
  } else {
    const int tx = lane, ty = warp;
    float acc[8][4];
    chunk_product(s.A, s.W2, ty, tx, acc);
    __syncthreads();  // every warp has read m1 before m2 overwrites it

    const float4 bias = *reinterpret_cast<const float4*>(s.B2 + tx * 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float* dst = s.A + (ty * 8 + q) * kH + tx * 4;
      const float4 v = make_float4(acc[q][0] + bias.x, acc[q][1] + bias.y,
                                   acc[q][2] + bias.z, acc[q][3] + bias.w);
      if constexpr (kElem) {
        store2(dst, silu2(__floats2bfloat162_rn(v.x, v.y)));
        store2(dst + 2, silu2(__floats2bfloat162_rn(v.z, v.w)));
      } else {
        *reinterpret_cast<float4*>(dst) =
            make_float4(silu(v.x), silu(v.y), silu(v.z), silu(v.w));
      }
    }
  }
  __syncthreads();

  // the receivers this chunk touches
  const int last = min(r0 + kRows, rows) - 1;
  const int il0 = r0 / n;
  const int nrc = last / n - il0 + 1;

  // agg: one thread per (receiver, column pair) adds mask * m2 over the receiver's
  // rows of this chunk, in row order
  for (int e = tid; e < nrc * kPairs; e += kThreads) {
    const int il = il0 + e / kPairs;
    const int c = (e % kPairs) * 2;
    const int lo = max(il * n, r0) - r0;
    const int hi = min((il + 1) * n - 1, last) - r0;
    float sx = 0.0f, sy = 0.0f;
    for (int rl = lo; rl <= hi; ++rl) {
      const float m = s.mask[rl];
      float2 v;
      if constexpr (S::kMma && kElem) {  // the mask multiply in bf16 too
        v = __bfloat1622float2(__hmul2(*reinterpret_cast<const bf162*>(s.A + rl * kLdB + c),
                                       __float2bfloat162_rn(m)));
      } else if constexpr (S::kMma) {
        v = load2(s.M2 + rl * kLdM + c);
        v.x *= m;
        v.y *= m;
      } else {
        v = load2(s.A + rl * kH + c);
        v.x *= m;
        v.y *= m;
      }
      sx += v.x;
      sy += v.y;
    }
    s.agg[il * kH + c] += sx;
    s.agg[il * kH + c + 1] += sy;
  }

  // w = tanh(silu(m2 Wc1 + bc1) . wc2); each row's three masked, clipped trans terms
  // go to s.trow
  if constexpr (S::kMma) {
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[2][4][4];
    mma_product(s.A, s.Wc1, wm, wn, lane, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int c = wn * 32 + nt * 8 + 2 * t4 + p;
            sum += round_bf16(silu(acc[mt][nt][2 * half + p] + s.Bc1[c])) * s.Wc2[c];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t4 == 0) s.wpart[(wm * 32 + mt * 16 + g + half * 8) * 4 + wn] = sum;
      }
    __syncthreads();
    if (tid < kRows) {
      const float* wp = s.wpart + tid * 4;
      const float sum = ((wp[0] + wp[1]) + wp[2]) + wp[3];
      const float w = kTanh ? tanhf(sum) : sum;
      const bool live = r0 + tid < rows;
      const float m = s.mask[tid];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s.trow[tid * 4 + d] = live ? m * clip100(w * s.geom[tid * kGeom + 5 + d]) : 0.0f;
    }
  } else {
    const int tx = lane, ty = warp;
    float acc[8][4];
    chunk_product(s.A, s.Wc1, ty, tx, acc);
    const float4 bias = *reinterpret_cast<const float4*>(s.Bc1 + tx * 4);
    const float4 wv = *reinterpret_cast<const float4*>(s.Wc2 + tx * 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float sum = silu(acc[q][0] + bias.x) * wv.x + silu(acc[q][1] + bias.y) * wv.y +
                  silu(acc[q][2] + bias.z) * wv.z + silu(acc[q][3] + bias.w) * wv.w;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int rl = ty * 8 + q;
      if (tx < 3) {
        const float w = kTanh ? tanhf(sum) : sum;
        s.trow[rl * 4 + tx] =
            r0 + rl < rows ? s.mask[rl] * clip100(w * s.geom[rl * kGeom + 5 + tx]) : 0.0f;
      }
    }
  }
  __syncthreads();

  // trans: one thread per (receiver, component) adds the chunk's terms in row order
  if (tid < nrc * 3) {
    const int il = il0 + tid / 3;
    const int d = tid % 3;
    const int lo = max(il * n, r0) - r0;
    const int hi = min((il + 1) * n - 1, last) - r0;
    float sum = 0.0f;
    for (int rl = lo; rl <= hi; ++rl) sum += s.trow[rl * 4 + d];
    s.trans[il * 4 + d] += sum;
  }
  __syncthreads();  // before the next chunk overwrites geom, mask, A and trow
}

// agg [B, N, kH] (type TO) and trans [B, N, 3] (f32) of the tile's nrecv receivers:
// sums / max(deg, 1).
template <typename TO, typename S>
__device__ __forceinline__ void write_means(const S& s, TO* __restrict__ agg,
                                            float* __restrict__ trans, int b, int n, int i0,
                                            int nrecv, int tid) {
  for (int e = tid; e < nrecv * kH; e += kThreads) {
    const int il = e / kH;
    store_out(agg + (static_cast<size_t>(b) * n + i0 + il) * kH + e % kH,
              s.agg[e] / fmaxf(s.deg[il], 1.0f));
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
