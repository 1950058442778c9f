// The EGNN-MC edge stage with bf16 operands, the mixed-bf16 model's: K1-bf16
// (egnn_messages.cu, nbody_egnn_messages_bf16), K3-bf16 and K3-elem
// (egnn_stream.cu, nbody_egnn_stream_bf16 without and with elem_bf16).  The same
// function, persistent grid, sub-tiles and fixed-order sums as the f32 chunk of
// egnn_edge.cuh, and the rounding points of the TPU bodies
// (ops/pallas/egnn_messages.py:66-115, egnn_stream.py:111-169): hA, hB and every
// weight are bf16; m1, m2 and the silu output before wc2 are rounded to bf16 as
// matmul operands; every product accumulates in f32; agg sums the unrounded f32
// m2 (with kElem, K3's elem_bf16: the two silus and the mask multiply run in bf16
// on __nv_bfloat162 pairs, one rounding per operation, and agg sums those bf16
// values); agg is written in bf16, trans in f32.
//
// Both 128x128 products run on the tensor cores (mma_product, egnn_edge.cuh) and
// take under a fifth of a chunk; the rest was eight elementwise phases in series
// behind six block-wide barriers.  This chunk is laid out to take them apart:
//   * agg from the W2 product's registers.  Edge row e of a chunk sits at row
//     tile_row(e) of the product tiles, so lane (g, t4) of warp (wm, wn) holds
//     the m2 of the 4 consecutive edge rows wm*32 + 4g .. + 3 at 8 columns.  The
//     m2 epilogue sums mask * m2 per receiver from there (slab_sums): a lane's 4
//     rows in row order, then a segmented sum over the 8 lanes that share t4 with
//     shuffles in a fixed pattern.  A slab of 32 rows is a group of group_sums in
//     egnn_edge.cuh: its first and last receivers go to s.part, the rest to s.agg,
//     and combine_groups adds the heads and tails.  No f32 copy of m2 in shared
//     memory, no agg phase.
//   * m2 goes to a tile of its own (M2), so the m2 epilogue follows the W2 product
//     without a barrier.
//   * the chunk prologue runs one chunk ahead, into the other of two geometry and
//     mask buffers: the next chunk's copies (cp.async) are issued once m1 is built,
//     they land while the products run, and with K3 the threads that the trans
//     phase leaves idle compute the next chunk's geometry from them (the `next`
//     functor).
//   * m1 steps its rows' receivers without a division each and stores a row's 8
//     bf16 values at once; the epilogues hold their biases in registers.
//   * the trans phase's partial sums of w are stored [wn][row], conflict-free.
// So a chunk has four block-wide barriers where the f32 chunk has six.  Copying
// the next chunk's hB rows ahead (cp.async into shared memory, or loads into
// registers) and taking half the f32 silus' exponentials on the FMA pipe measured
// no gain on the H100 (PERF.md).
//
// Shared memory (SmemBf16::kBytes; K3 adds its node data and staged sender rows):
// W2, Wc1, M1 and M2 (4 x 34 KiB, rows padded to 272 B), the sub-tile's hA (4 KiB),
// and 7,008 floats (Wg, biases, two chunks' geometry and mask, the accumulators,
// the per-row partial sums of w, the groups' heads and tails): 171,392 B.

#pragma once

#include "egnn_edge.cuh"

namespace egnn_edge {

struct SmemBf16 {
  static constexpr size_t kTileBytes = size_t(kH) * kLdB * sizeof(bf16);
  static constexpr size_t kHaBytes = size_t(kMaxTi) * kH * sizeof(bf16);
  static constexpr size_t kFloats = 5 * kH + 3 * kH     // Wg, b2, bc1, wc2
                                    + 2 * kRows * kGeom  // geometry, two chunks
                                    + 2 * kRows          // mask, two chunks
                                    + kMaxTi * kH        // agg accumulators
                                    + kMaxTi * 4         // trans accumulators and degrees
                                    + 4 * kRows          // per row: w's four partial sums
                                    + kGroups * 2 * kH   // agg: groups' heads and tails
                                    + kGroups * 2 * 4;   // trans: groups' heads and tails
  static constexpr size_t kBytes = 4 * kTileBytes + kHaBytes + kFloats * sizeof(float);

  // W2 and Wc1 [kH, kLdB] row-major [K, N]; M1 (m1) and M2 (m2) [kRows, kLdB], edge
  // row e at row tile_row(e); geom [2][kRows, kGeom] and mask [2][kRows] by buffer
  bf16 *W2, *Wc1, *M1, *M2;
  bf16* hAs;  // [kMaxTi, kH]: hA of the sub-tile's receivers
  float *Wg, *B2, *Bc1, *Wc2, *geom, *mask, *agg, *trans, *trow, *part, *tpart;

  __device__ explicit SmemBf16(unsigned char* base) {
    W2 = reinterpret_cast<bf16*>(base);
    Wc1 = reinterpret_cast<bf16*>(base + kTileBytes);
    M1 = reinterpret_cast<bf16*>(base + 2 * kTileBytes);
    M2 = reinterpret_cast<bf16*>(base + 3 * kTileBytes);
    hAs = reinterpret_cast<bf16*>(base + 4 * kTileBytes);
    Wg = reinterpret_cast<float*>(base + 4 * kTileBytes + kHaBytes);
    B2 = Wg + 5 * kH;
    Bc1 = B2 + kH;
    Wc2 = Bc1 + kH;
    geom = Wc2 + kH;
    mask = geom + 2 * kRows * kGeom;
    agg = mask + 2 * kRows;
    trans = agg + kMaxTi * kH;
    trow = trans + kMaxTi * 4;
    part = trow + 4 * kRows;
    tpart = part + kGroups * 2 * kH;
  }
  __device__ float* geom_buf(int buf) const { return geom + buf * kRows * kGeom; }
  __device__ float* mask_buf(int buf) const { return mask + buf * kRows; }
  // first float past the shared layout (for a kernel's own extra scratch)
  __device__ float* end() const { return tpart + kGroups * 2 * 4; }
};

// ------------------------------------------------------------------ async copies
// cp.async of 16 or 4 bytes from device to shared memory; with keep false nothing is
// read and the destination is zero-filled.  cp_async_wait_all waits for this thread's
// copies; a barrier after it shows them to the block.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool keep) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(keep ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool keep) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(keep ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------------ row order
// The product tiles' row of a chunk's edge row e: within each slab of kGroupRows
// rows, e = 4 g + k goes to row g + 8 k, so that the mma accumulator rows of lane
// (g, t4), g + 8 (2 mt + half), hold the consecutive edge rows 4 g + 2 mt + half.
__device__ __forceinline__ int tile_row(int e) {
  return (e & ~(kGroupRows - 1)) | ((e & 3) << 3) | ((e >> 2) & 7);
}

// ------------------------------------------------------------------ agg from registers
// Warp (wm, wn)'s part of agg, from sums the m2 epilogue made: lane (g, t4) holds
// the receivers il[0..3] of its 4 consecutive edge rows wm*32 + 4g + k (clamped to
// the chunk's last live receiver; rows past it add 0), the sum of its rows of
// receiver il[0] (head) and of receiver il[3] (tail) at its 8 columns
// c0 + 8 (j / 2) + j % 2, and has put the receivers between them already.  A
// segmented sum over the 8 lanes that share t4 (lane offsets 4, 8, 16), in a fixed
// pattern: z = the heads summed over the run of lanes that start with the same
// receiver; a lane whose first row starts its receiver puts that receiver's z, a lane
// with two or more receivers puts its tail plus the next lane's z when that lane goes
// on with the same receiver.  Puts follow put_group_sum: the slab's first and last
// receivers to s.part, the rest added to s.agg.
__device__ __forceinline__ void slab_sums(const SmemBf16& s, const int il[4], const float head[8],
                                          const float tail[8], int2 ends, int wm, int g,
                                          int c0) {
  constexpr unsigned kAll = 0xffffffffu;
  const int a = il[0], b = il[3];
  float z[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) z[j] = head[j];
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const int other = __shfl_down_sync(kAll, a, 4 * off);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t = __shfl_down_sync(kAll, z[j], 4 * off);
      if (g + off < 8 && other == a) z[j] += t;
    }
  }
  const int a_next = __shfl_down_sync(kAll, a, 4);
  const int b_prev = __shfl_up_sync(kAll, b, 4);
  const bool joins = g < 7 && a_next == b && b != a;  // the next lane goes on with b
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float zn = __shfl_down_sync(kAll, z[j], 4);
    const int c = c0 + 8 * (j >> 1) + (j & 1);
    if (g == 0 || b_prev != a) put_group_sum(a, ends, wm, z[j], s.part, kH, s.agg, kH, c);
    if (b != a) put_group_sum(b, ends, wm, joins ? tail[j] + zn : tail[j], s.part, kH, s.agg, kH, c);
  }
}

// m2 = silu(acc + b2) to M2 in bf16 (with kElem through silu2), and warp (wm, wn)'s
// part of agg from the same values: mask * m2 per receiver over its slab (slab_sums),
// unrounded m2 without kElem, the bf16 m2 with it.  acc is the W2 product's
// accumulator (mma_product's layout).  A slab with no live row puts nothing.
template <bool kElem>
__device__ __forceinline__ void m2_epilogue(const SmemBf16& s, const float* __restrict__ mask,
                                            const float acc[2][4][4], int r0, int valid, int n,
                                            int wm, int wn, int g, int t4) {
  const int e0 = wm * kGroupRows + 4 * g;  // this lane's first edge row
  const int last = (r0 + valid - 1) / n;   // the chunk's last live receiver
  int il[4];
  {
    int i = (r0 + e0) / n, j = r0 + e0 - i * n;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      il[k] = min(i, last);
      if (++j == n) {
        j = 0;
        ++i;
      }
    }
  }
  const float4 mk = *reinterpret_cast<const float4*>(mask + e0);  // 0 past the live rows
  const int c0 = wn * 32 + 2 * t4;
  float2 b2[4];  // b2 at the lane's columns c0 + 8 nt, + 1
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) b2[nt] = *reinterpret_cast<const float2*>(s.B2 + c0 + nt * 8);
  float head[8], run[8];
  int cur = il[0];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // edge row e0 + k, accumulator row g + 8 k
    const int mt = k >> 1, half = k & 1;
    const float m = k == 0 ? mk.x : (k == 1 ? mk.y : (k == 2 ? mk.z : mk.w));
    bf16* dst = s.M2 + (wm * kGroupRows + g + 8 * k) * kLdB;
    float v[8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = c0 + nt * 8;
      const float vx = acc[mt][nt][2 * half] + b2[nt].x;
      const float vy = acc[mt][nt][2 * half + 1] + b2[nt].y;
      float2 m2;
      if constexpr (kElem) {
        const bf162 h = silu2(__floats2bfloat162_rn(vx, vy));
        store2(dst + c, h);
        m2 = __bfloat1622float2(h);
      } else {
        m2 = make_float2(silu(vx), silu(vy));
        store2(dst + c, m2);
      }
      v[2 * nt] = m * m2.x;  // exact: the mask is 0 or 1
      v[2 * nt + 1] = m * m2.y;
    }
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) run[j] = v[j];
    } else if (il[k] == cur) {
#pragma unroll
      for (int j = 0; j < 8; ++j) run[j] += v[j];
    } else {
      if (cur == il[0]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) head[j] = run[j];
      } else {  // a receiver inside the lane's rows: the slab's middle
#pragma unroll
        for (int j = 0; j < 8; ++j) s.agg[cur * kH + c0 + 8 * (j >> 1) + (j & 1)] += run[j];
      }
      cur = il[k];
#pragma unroll
      for (int j = 0; j < 8; ++j) run[j] = v[j];
    }
  }
  if (cur == il[0]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) head[j] = run[j];
  }
  if (wm * kGroupRows < valid)  // the same for the whole warp
    slab_sums(s, il, head, run, group_ends(wm, r0, valid, n), wm, g, c0);
}

// ------------------------------------------------------------------ one chunk
// One chunk of edge rows [r0, r0 + kRows) of a sub-tile with `rows` rows and n
// senders per receiver, its geometry and mask in buffer `buf` (zero past `rows`;
// with kRoundG, g[0:5] is rounded to bf16 here, where m1 reads it).  s.hAs holds
// the sub-tile's hA rows, and a barrier has passed since the buffer and hAs were
// written.  hBb points at the sim's first sender.  After m1's barrier every thread
// calls fetch(tid), which issues the next chunk's copies (into the other buffer;
// they overlap the W2 product and are waited for before the third barrier); in the
// trans phase, threads kRows + kH and up call next(tid) (K3 computes the next
// chunk's geometry there).  The caller syncs before it reads s.agg or s.trans.
template <bool kElem, bool kTanh, bool kRoundG, typename Fetch, typename Next>
__device__ __forceinline__ void edge_chunk_bf16(const SmemBf16& s, int buf,
                                                const bf16* __restrict__ hBb, int r0, int rows,
                                                int n, int tid, PhaseClock& clk, Fetch&& fetch,
                                                Next&& next) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int valid = min(kRows, rows - r0);  // live rows of this chunk
  const float* geom = s.geom_buf(buf);
  const float* mask = s.mask_buf(buf);

  // m1 = silu(hA_i + hB_j + g . Wg) into M1: a thread owns 8 columns (one 16-byte
  // load of a row) of the rows rg, rg + 32, rg + 64, rg + 96; it issues its hB loads
  // before the first use, reads hA and the geometry from shared memory, and stores
  // the 8 bf16 values of a row at once.  Receiver and sender of its rows are stepped
  // from the first's, without a division each.
  {
    constexpr int kVec = 8, kRowThreads = kH / kVec, kRowStep = kThreads / kRowThreads;
    constexpr int kRowsPer = kRows / kRowStep;
    const int c = (tid % kRowThreads) * kVec;
    const int rg = tid / kRowThreads;
    int il[kRowsPer];
    uint4 hb[kRowsPer];
    {
      int i = (r0 + rg) / n, j = r0 + rg - i * n;
#pragma unroll
      for (int q = 0; q < kRowsPer; ++q) {
        if (q > 0) {
          j += kRowStep;
          while (j >= n) {
            j -= n;
            ++i;
          }
        }
        il[q] = i;
        hb[q] = make_uint4(0u, 0u, 0u, 0u);
        if (rg + q * kRowStep < valid)
          hb[q] = __ldg(reinterpret_cast<const uint4*>(hBb + static_cast<size_t>(j) * kH + c));
      }
    }
    // the instrumented build waits here for the hB rows: kM1Load is their wait
    clk.wait_for(hb[0].x ^ hb[kRowsPer - 1].w);
    clk.mark(kM1Load);
    float wg[5][kVec];
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int v = 0; v < kVec; ++v) wg[k][v] = s.Wg[k * kH + c + v];
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q) {
      const int rl = rg + q * kRowStep;
      float x[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) x[v] = 0.0f;  // rows past the tile: m1 = silu(0) = 0
      if (rl < valid) {
        const float4 g4 = *reinterpret_cast<const float4*>(geom + rl * kGeom);
        float gk[5] = {g4.x, g4.y, g4.z, g4.w, geom[rl * kGeom + 4]};
        if constexpr (kRoundG) {
#pragma unroll
          for (int k = 0; k < 5; ++k) gk[k] = round_bf16(gk[k]);
        }
        float a[kVec], b[kVec];
        unpack<bf16>(*reinterpret_cast<const uint4*>(s.hAs + il[q] * kH + c), a);
        unpack<bf16>(hb[q], b);
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          float gx = 0.0f;
#pragma unroll
          for (int k = 0; k < 5; ++k) gx += gk[k] * wg[k][v];
          x[v] = a[v] + b[v] + gx;
        }
      }
      uint4 packed;
      bf162* h = reinterpret_cast<bf162*>(&packed);
#pragma unroll
      for (int v = 0; v < kVec; v += 2) {
        if constexpr (kElem) {
          h[v / 2] = silu2(__floats2bfloat162_rn(x[v], x[v + 1]));
        } else {
          h[v / 2] = __floats2bfloat162_rn(silu(x[v]), silu(x[v + 1]));
        }
      }
      *reinterpret_cast<uint4*>(s.M1 + tile_row(rl) * kLdB + c) = packed;
    }
  }
  clk.mark(kM1);
  barrier(clk);
  fetch(tid);

  // the products' 4 x 4 warp grid (mma_product): warp (wm, wn) holds tile rows
  // wm*32 .. +31 (edge rows of slab wm), columns wn*32 .. +31
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  {
    float acc[2][4][4];
    mma_product(s.M1, s.W2, wm, wn, lane, acc);
    clk.mark(kW2);
    m2_epilogue<kElem>(s, mask, acc, r0, valid, n, wm, wn, g, t4);
  }
  clk.mark(kEpi2);
  barrier(clk);

  // w = tanh(silu(m2 Wc1 + bc1) . wc2): each row's four partial sums of w (one per
  // 32-column tile, wn) go to s.trow [wn][row]; the silu output is rounded to bf16 as
  // the operand of wc2
  {
    float acc[2][4][4];
    mma_product(s.M2, s.Wc1, wm, wn, lane, acc);
    float bc1[8], wc2[8];  // at the lane's columns wn*32 + 8 nt + 2 t4 + p
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = wn * 32 + nt * 8 + 2 * t4 + p;
        bc1[2 * nt + p] = s.Bc1[c];
        wc2[2 * nt + p] = s.Wc2[c];
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float u = round_bf16(silu(acc[mt][nt][2 * half + p] + bc1[2 * nt + p]));
            sum += u * wc2[2 * nt + p];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t4 == 0) s.trow[wn * kRows + wm * kGroupRows + 4 * g + 2 * mt + half] = sum;
      }
  }
  clk.mark(kWc1);
  cp_async_wait_all();  // the caller's copies for the next chunk
  barrier(clk);

  if (tid < kRows) {
    // trans and the degree: thread rl sums row rl's partial sums of w in a fixed order,
    // makes its three terms and holds its mask; each warp (a group of kGroupRows rows)
    // sums them per receiver with shuffles in a fixed pattern
    const int rl = tid;
    float term[4];
    const float m = mask[rl];
    term[3] = rl < valid ? m : 0.0f;
    const float sum = ((s.trow[rl] + s.trow[kRows + rl]) + s.trow[2 * kRows + rl]) +
                      s.trow[3 * kRows + rl];
    const float w = kTanh ? tanhf(sum) : sum;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      term[d] = rl < valid ? m * clip100(w * geom[rl * kGeom + 5 + d]) : 0.0f;
    warp_group_sums(r0, valid, n, term, s.tpart, s.trans);
  } else if (tid < kRows + kH) {
    combine_groups(r0, valid, n, s.part, kH, s.agg, kH, tid - kRows);
  } else {
    next(tid);
  }
  clk.mark(kTrans);
  barrier(clk);
  if (tid < 4) combine_groups(r0, valid, n, s.tpart, 4, s.trans, 4, tid);
  clk.count(kChunks);
  // No barrier here: what follows in this chunk reads only s.tpart and writes
  // s.trans, which the next chunk touches only after its own barriers.
}

}  // namespace egnn_edge
