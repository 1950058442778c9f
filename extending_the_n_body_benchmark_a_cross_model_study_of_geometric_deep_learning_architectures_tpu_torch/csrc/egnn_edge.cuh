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
// The grid is persistent: min(B N, SMs) blocks of kThreads threads, one an SM
// (the shared layout below leaves room for one).  Block k stages W2 and Wc1 once,
// then walks the global receivers b N + i in [k R / G, (k + 1) R / G), R = B N,
// G blocks, in sub-tiles of at most kMaxTi receivers that never cross a sim
// (for_each_subtile; ops/egnn_messages.py:receiver_ranges states the same split).
// A sub-tile's edge rows are r = il * n + j <-> (receiver i0 + il, sender j) and
// are walked in chunks of kRows; m2 overwrites m1 in place.  At (B, N) = (64, 100)
// this turns 448 blocks (3.4 waves, the last 39% full) into 132 blocks of 48-49
// receivers; at (1, 1000) 63 blocks into 132.
//
// silu(x) = x * rcp(1 + exp(-x)) on the special-function unit (ex2.approx and
// rcp.approx), with IEEE's edges: -0 where exp overflows, NaN through, x for large
// x.  Its worst relative error over [-87, 100] is measured by chip_smoke.py
// ([silu]); below -87 the sigmoid flushes to 0 and silu gives -0 where IEEE gives
// a value under 1.1e-36 in magnitude.
//
// This header's chunk (edge_chunk) serves the f32 operands; the bf16 operands (the
// mixed-bf16 model) have a chunk of their own, laid out for the H100, in
// egnn_edge_bf16.cuh, which builds on the pieces here.  The Wc1 product runs on the
// tensor cores for both, 16 warps as 4 x 4 tiles of 32 x 32 (mma_product):
//   * float: the Wc1 product is error-compensated TF32 ("3xTF32").  Each f32 operand
//     is split at fragment load into hi = tf32(x) and lo = tf32(x - hi), rounded to
//     nearest, and each product is taken as lo.hi + hi.lo + hi.hi by
//     mma.sync.m16n8k8 tf32 -> f32, a k-step of 8 at a time, the k-steps' sums added
//     on the CUDA cores: about f32's accuracy, where plain TF32 would keep three
//     decimal digits.  The W2 product stays a register-tiled f32 FMA loop
//     (chunk_product: 8 rows x 4 columns per thread): on the tensor cores its
//     rounding (the tensor core truncates where it adds) put agg and trans over
//     twice the f32 plain version's error against float64 (PERF.md).  Wc1 is staged
//     transposed, and it and m2 are XOR-swizzled (swz below), so fragments load 8
//     bytes at a time without bank conflicts.  m2 goes back into A in f32.
//   * __nv_bfloat16: both products run on the tensor cores, warp-level
//     mma.sync.m16n8k16 bf16 -> f32 on fragments read with ldmatrix (.trans for
//     the row-major [K, N] weights); rows of the bf16 tiles are padded to 136
//     elements (272 B) so the eight row addresses of an ldmatrix phase fall in
//     distinct banks (egnn_edge_bf16.cuh).
// kElem (K3's elem_bf16): the two silus and the mask multiply run in bf16, one
// rounding per operation (x * 1/(1 + exp(-x)) on __nv_bfloat162 pairs), and m2
// is stored only in bf16 values; the sums stay f32.
//
// m1 is built with the sub-tile's hA rows staged in shared memory once per
// sub-tile; a thread owns one 16-byte column slice (4 f32 or 8 bf16) of 8 or 4
// rows, loads those rows' hB slices from device memory first, all 16 bytes wide,
// and keeps its Wg columns in registers.
//
// Every sum runs in a fixed order, so a launch is bitwise reproducible, and no sum
// uses an atomic.  A chunk's rows are cut into kGroups groups of 32: for agg, the
// thread of (column, group) adds mask * m2 over the group's rows in row order, one
// sum per receiver; for trans and the degree (the sum of the 0/1 mask), a warp
// holds one group's rows, a lane each, and sums them per receiver with shuffles in
// a fixed pattern.  A receiver inside one group is added to its accumulator at
// once; the sums of a group's first and last receivers are combined after a
// barrier, group by group in order (combine_groups).
//
// Shared memory of the f32 chunk, in bytes (Smem<float, kElem>::kBytes; K3 adds 640
// of node data): W2, Wc1 and the chunk A (3 x 64 KiB, Wc1 transposed, Wc1 and m2
// swizzled), the sub-tile's hA (8 KiB), and 5,856 floats (Wg, biases, a chunk's
// geometry and mask, the accumulators, a chunk's per-row partial sums of w, the
// groups' heads and tails): 228,224 B (of 232,448).

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
constexpr int kMaxTi = 16;           // receivers of a sub-tile (MAX_RECEIVERS in ops/egnn_messages.py)
constexpr int kGeom = 8;             // d2, 4 edge attrs, cd_x, cd_y, cd_z
constexpr int kLdB = kH + 8;         // padded row of a bf16 tile (272 B)
constexpr int kGroups = 4;           // row groups of a chunk's fixed-order sums
constexpr int kGroupRows = kRows / kGroups;  // 32: a warp's lanes in warp_group_sums

constexpr size_t kSmemMax = 232448;  // shared memory a block can have on the H100

// The f32 chunk's dynamic shared memory (operand type T = float; kElem: K3's elem_bf16).
template <typename T, bool kElem>
struct Smem {
  static_assert(std::is_same<T, float>::value, "the bf16 operands have SmemBf16");
  static constexpr int kLd = kH;  // row stride of W2, Wc1 and A
  static constexpr size_t kTileBytes = size_t(kH) * kLd * sizeof(T);
  static constexpr size_t kFloats = 5 * kH + 3 * kH  // Wg, b2, bc1, wc2
                                    + kRows * kGeom   // geometry chunk
                                    + kRows           // mask chunk
                                    + kMaxTi * kH     // agg accumulators
                                    + kMaxTi * 4      // trans accumulators and degrees
                                    + kRows * 4       // per row: w's four partial sums
                                    + kGroups * 2 * kH  // agg: groups' heads and tails
                                    + kGroups * 2 * 4;  // trans: groups' heads and tails
  static constexpr size_t kHaBytes = size_t(kMaxTi) * kH * sizeof(T);  // the sub-tile's hA
  static constexpr size_t kBytes = 3 * kTileBytes + kHaBytes + kFloats * sizeof(float);

  // A: the chunk's m1, then m2 (the matmul operand), [kRows, kH]; W2 [kH, kH] row-major
  // [K, N], Wc1 transposed ([N, K]); m2 and Wc1 swizzled (tile_at)
  T *W2, *Wc1, *A;
  T* hAs;           // [kMaxTi, kH]: hA of the sub-tile's receivers
  float *Wg, *B2, *Bc1, *Wc2, *geom, *mask, *agg, *trans, *trow, *part, *tpart;

  __device__ explicit Smem(unsigned char* base) {
    W2 = reinterpret_cast<T*>(base);
    Wc1 = reinterpret_cast<T*>(base + kTileBytes);
    A = reinterpret_cast<T*>(base + 2 * kTileBytes);
    hAs = reinterpret_cast<T*>(base + 3 * kTileBytes);
    Wg = reinterpret_cast<float*>(base + 3 * kTileBytes + kHaBytes);
    B2 = Wg + 5 * kH;
    Bc1 = B2 + kH;
    Wc2 = Bc1 + kH;
    geom = Wc2 + kH;
    mask = geom + kRows * kGeom;
    agg = mask + kRows;
    trans = agg + kMaxTi * kH;
    trow = trans + kMaxTi * 4;
    part = trow + kRows * 4;
    tpart = part + kGroups * 2 * kH;
  }
  // first float past the shared layout (for a kernel's own extra scratch)
  __device__ float* end() const { return tpart + kGroups * 2 * 4; }
};

// ------------------------------------------------------------------ phase clock
// Built with -DEGNN_EDGE_PHASES (edge_phases.py), thread 0 of every block adds the
// SM clocks it spends in each phase, from one stamp to the next, to a device array
// of its translation unit that the host reads with read_phases().  kBarrier takes
// thread 0's waits at barriers.  In the normal build every call compiles to nothing.
// kM1Load (the bf16 chunk only) is the part of m1 up to its hB rows' arrival.
enum Phase {
  kStage, kPrologue, kM1, kW2, kEpi2, kAgg, kWc1, kTrans, kBarrier, kMeans, kM1Load,
  kChunks, kBlocks, kPhases  // the last two count chunks and blocks
};

#ifdef EGNN_EDGE_PHASES
// the phases' names, in the enum's order, for edge_phases.py
constexpr char kPhaseNames[] =
    "stage,prologue,m1,w2_product,m2_epilogue,agg,wc1_product_epilogue,trans,barrier,means,"
    "m1_load";

static __device__ unsigned long long g_phase_ticks[kPhases];

__device__ __forceinline__ long long* phase_smem() {
  __shared__ long long ticks[kPhases + 1];  // the last: wait_for's sink
  return ticks;
}

struct PhaseClock {
  long long last;
  long long* t;  // [kPhases] in shared memory, touched by thread 0 only
  __device__ PhaseClock() : last(0), t(phase_smem()) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < kPhases; ++k) t[k] = 0;
      t[kBlocks] = 1;
      last = clock64();
    }
  }
  __device__ void mark(int k) {
    if (threadIdx.x == 0) {
      const long long c = clock64();
      t[k] += c - last;
      last = c;
    }
  }
  __device__ void count(int k) {
    if (threadIdx.x == 0) ++t[k];
  }
  // thread 0 stores v, so its next mark comes after the load that made v arrived
  __device__ void wait_for(unsigned v) {
    if (threadIdx.x == 0) reinterpret_cast<volatile long long*>(t)[kPhases] = v;
  }
  __device__ void flush() {
    if (threadIdx.x == 0)
      for (int k = 0; k < kPhases; ++k)
        atomicAdd(&g_phase_ticks[k], static_cast<unsigned long long>(t[k]));
  }
};

// copy the totals to out[kPhases] and zero them
static inline int read_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ticks, sizeof(g_phase_ticks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_ticks, zero, sizeof(zero)));
}
#else
struct PhaseClock {
  __device__ void mark(int) {}
  __device__ void count(int) {}
  __device__ void wait_for(unsigned) {}
  __device__ void flush() {}
};
#endif

// __syncthreads() with thread 0's wait counted as kBarrier
__device__ __forceinline__ void barrier(PhaseClock& clk) {
  __syncthreads();
  clk.mark(kBarrier);
}

// silu(x) = x / (1 + exp(-x)) on the special-function unit: exp as ex2.approx of
// -x log2(e) (__expf) and the reciprocal as rcp.approx, one instruction each, in
// place of a full-range expf and an IEEE division with its slow path.  The edges
// stay IEEE's: for x below about -88 exp overflows to inf, its reciprocal is 0 and
// silu is -0; NaN passes through; for large x it is x.  Results under 2^-126 in
// magnitude (x below about -87.3) flush to -0.  The worst relative error elsewhere
// is measured by chip_smoke.py ([silu]) against float64.
__device__ __forceinline__ float silu(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + __expf(-x)));
  return x * r;
}

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

// the 4 f32 or 8 bf16 values of a 16-byte load, as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<bf16>(const uint4& u, float* f) {
  const bf162* p = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(p[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ float silu(float x);
__device__ __forceinline__ bf162 silu2(bf162 x);

// dst[0:16 / sizeof(T)] = silu(x), in f32 or, with kElem, in bf16 pairs
template <typename T, bool kElem>
__device__ __forceinline__ void store_silu(T* dst, const float* x) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < kVec; v += 2) {
    if constexpr (kElem) {
      store2(dst + v, silu2(__floats2bfloat162_rn(x[v], x[v + 1])));
    } else {
      store2(dst + v, make_float2(silu(x[v]), silu(x[v + 1])));
    }
  }
}

// ------------------------------------------------------------------ tile layouts
// The f32 tiles that mma_product reads, A holding m2 [kRows, kH] and Wc1 transposed
// [kH (n), kH (k)], are row-major with the 16-byte groups of each row XOR-swizzled:
// column c of row r is stored at column c ^ swz(r), which XORs the group index c / 4
// with 2 (r % 4).  A bank is the column mod 32 (a row is 128 floats), and every access
// of a warp to these tiles is free of bank conflicts:
//   * the fragment loads of mma_product, 8 bytes a lane: a half warp reads rows r0 ..
//     r0 + 3 (r0 a multiple of 4) at one aligned pair of groups, and the XORs 0, 2, 4,
//     6 put the four rows' pairs in four distinct pairs of the eight 16-byte slots of a
//     128-byte window (unswizzled, all four rows hit the same two slots: 4-way
//     conflicts);
//   * row-wise access (the m2 epilogue's float4 rows, agg's columns): a permutation of
//     the groups inside each aligned 32 floats of a row.
// m1, which only chunk_product reads (one row a warp, a broadcast), stays unswizzled.
// The bf16 tiles are padded to kLdB instead (ldmatrix reads eight rows of one column
// block).
__device__ __forceinline__ int swz(int row) { return (row & 3) << 3; }

template <typename T>
__device__ __forceinline__ int tile_at(int row, int col) {
  if constexpr (std::is_same<T, float>::value) {
    return row * kH + (col ^ swz(row));
  } else {
    return row * kLdB + col;
  }
}

// ------------------------------------------------- f32 tensor-core products (3xTF32)
// x -> (hi, lo) as mma operands, x = hi + lo to within 2^-22 |x|: hi is x plus half a
// TF32 ulp, which the tensor core truncates to TF32, so the operand is x rounded to
// nearest, ties away (cvt.rna.tf32.f32, less its inf and NaN test: an infinite x
// gives NaN here as it does through lo there); lo is the same of x - hi, which is exact
// in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// d = a . b + c and d = a . b (c = 0), m16n8k8 tf32 -> f32
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32_from_zero(float d[4], const uint32_t a[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// Warp (wm, wn) of a 4 x 4 warp grid: acc[mt][nt][.] = the 32 x 32 tile at rows
// wm*32 + mt*16, columns wn*32 + nt*8 of A . W, A [kRows, kH] and wt = W transposed
// [kH (n), kH (k)], f32 in shared memory (tile_at).  Fragment element e of acc[mt][nt]
// sits at row wm*32 + mt*16 + lane/4 + 8*(e/2), column wn*32 + nt*8 + 2*(lane%4) + e%2,
// as in the bf16 mma_product.
//
// Each k-step of 8 is lo.hi + hi.lo + hi.hi, the two small terms first, summed by the
// tensor core from zero; lo.lo (2^-22 of a product at most) is dropped.  The k-steps'
// sums are then added to acc in f32 on the CUDA cores, in k order, rounded to
// nearest: the tensor core adds with truncation, and chaining all 48 products of a
// 128-deep sum through its accumulator measured 5.7-9.4x the f32 plain version's
// error against float64 on an H100 (PERF.md).  The truncation inside a k-step stays;
// it is why the W2 product is not taken this way.
//
// Within each k-step the logical k = t4 and t4 + 4 (t4 = lane % 4) are the physical
// columns 2 t4 and 2 t4 + 1, for A and W alike (a permutation of the summands), so a
// lane's A or W fragment of a k-step is one 8-byte load.
__device__ __forceinline__ void mma_product(const float* __restrict__ a,
                                            const float* __restrict__ wt, int wm, int wn,
                                            int lane, float acc[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  const int g = lane >> 2, t4 = lane & 3;
  // every row this lane reads is g mod 8, so one swizzle serves them all
  const int off = (2 * t4) ^ swz(g);
  const float* arow = a + (wm * 32 + g) * kH;   // rows + mt*16 + h*8
  const float* wrow = wt + (wn * 32 + g) * kH;  // rows + nt*8
#pragma unroll 2
  for (int k0 = 0; k0 < kH; k0 += 8) {
    const int col = k0 ^ off;
    float2 av[2][2], wv[4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[mt][h] = *reinterpret_cast<const float2*>(arow + (mt * 16 + h * 8) * kH + col);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      wv[nt] = *reinterpret_cast<const float2*>(wrow + nt * 8 * kH + col);
    // B fragment registers: b0 (k t4, column g), b1 (k t4+4, column g)
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      split_tf32(wv[nt].x, bh[nt][0], bl[nt][0]);
      split_tf32(wv[nt].y, bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // A fragment registers: a0 (row g, k t4), a1 (row g+8, k t4), a2 (row g, k t4+4),
      // a3 (row g+8, k t4+4)
      uint32_t ah[4], al[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        split_tf32(av[mt][h].x, ah[h], al[h]);
        split_tf32(av[mt][h].y, ah[h + 2], al[h + 2]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float d[4];
        mma_tf32_from_zero(d, al, bh[nt][0], bh[nt][1]);
        mma_tf32(d, ah, bl[nt][0], bl[nt][1]);
        mma_tf32(d, ah, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[e];
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

// ------------------------------------------------------------------ f32 FMA product
// acc[q][p] = sum_k A[ty*8+q][k] * W[k][tx*4+p] over a row-major kRows x 128 chunk A (m1,
// not swizzled) and a row-major 128x128 W, both in shared memory: the f32 W2 product.  A
// warp reads one row of A at a time (a broadcast) and one row of W.
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

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

// ------------------------------------------------------------------ staging
// Stage the weights in shared memory; ends in a barrier.
template <typename T, typename S>
__device__ __forceinline__ void stage_weights(const S& s, const T* __restrict__ wg,
                                              const T* __restrict__ W2, const T* __restrict__ b2,
                                              const T* __restrict__ Wc1,
                                              const T* __restrict__ bc1,
                                              const T* __restrict__ wc2, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    // W2 as it is; Wc1 transposed: thread e writes the 16 bytes of row n = e % kH at
    // k = 4 (e / kH) .. + 3, read as four column loads that a warp makes coalesced
    for (int e = tid; e < kH * kH / 4; e += kThreads) {
      reinterpret_cast<float4*>(s.W2)[e] = reinterpret_cast<const float4*>(W2)[e];
      const int n = e % kH, k = 4 * (e / kH);
      const float* wc1 = Wc1 + k * kH + n;
      *reinterpret_cast<float4*>(s.Wc1 + tile_at<float>(n, k)) =
          make_float4(__ldg(wc1), __ldg(wc1 + kH), __ldg(wc1 + 2 * kH), __ldg(wc1 + 3 * kH));
    }
  } else {
    constexpr int kPerRow = kH / 8;  // 16-byte loads a row
    for (int e = tid; e < kH * kPerRow; e += kThreads) {
      const int row = e / kPerRow;
      const int col = (e % kPerRow) * 8;
      *reinterpret_cast<uint4*>(s.W2 + tile_at<T>(row, col)) =
          reinterpret_cast<const uint4*>(W2)[e];
      *reinterpret_cast<uint4*>(s.Wc1 + tile_at<T>(row, col)) =
          reinterpret_cast<const uint4*>(Wc1)[e];
    }
  }
  for (int e = tid; e < 5 * kH; e += kThreads) s.Wg[e] = to_f(wg[e]);
  for (int e = tid; e < kH; e += kThreads) {
    s.B2[e] = to_f(b2[e]);
    s.Bc1[e] = to_f(bc1[e]);
    s.Wc2[e] = to_f(wc2[e]);
  }
  __syncthreads();
}

// ------------------------------------------------------------- the persistent grid
// Block k of `blocks` walks the global receivers b * n + i in [k R / blocks,
// (k + 1) R / blocks), R = batch * n, in sub-tiles of at most kMaxTi receivers that
// never cross a sim: each sim's part of the range is cut into the fewest such
// sub-tiles, evened out.  f(b, i0, nrecv) runs once per sub-tile, in order.
// ops/egnn_messages.py:receiver_ranges states the same split.
template <typename F>
__device__ __forceinline__ void for_each_subtile(int batch, int n, int blocks, F&& f) {
  const long long R = static_cast<long long>(batch) * n;
  long long cur = R * blockIdx.x / blocks;
  const long long end = R * (blockIdx.x + 1) / blocks;
  while (cur < end) {
    const int b = static_cast<int>(cur / n);
    const int i = static_cast<int>(cur - static_cast<long long>(b) * n);
    const int seg = static_cast<int>(min(end, static_cast<long long>(b + 1) * n) - cur);
    const int tiles = (seg + kMaxTi - 1) / kMaxTi;
    for (int q = 0, i0 = i; q < tiles; ++q) {
      const int nrecv = seg / tiles + (q < seg % tiles);
      f(b, i0, nrecv);
      i0 += nrecv;
    }
    cur += seg;
  }
}

// Start a sub-tile: zero its accumulators and copy its receivers' hA rows (hAb, nrecv
// rows) to shared memory.  The caller's next barrier orders it.
template <typename T, typename S>
__device__ __forceinline__ void begin_subtile(const S& s, const T* __restrict__ hAb, int nrecv,
                                              int tid) {
  for (int e = tid; e < kMaxTi * kH; e += kThreads) s.agg[e] = 0.0f;
  if (tid < kMaxTi * 4) s.trans[tid] = 0.0f;
  constexpr int kVec = 16 / sizeof(T);
  for (int e = tid; e < nrecv * kH / kVec; e += kThreads)
    reinterpret_cast<uint4*>(s.hAs)[e] = reinterpret_cast<const uint4*>(hAb)[e];
}

// ------------------------------------------------------------ fixed-order sums
// A chunk's live rows [0, valid) are cut into kGroups groups of kGroupRows rows.
// Within a group, a receiver's rows are summed in row order.  A receiver whose rows
// lie inside one group only (a middle) is added to its accumulator at once; the
// sums of a group's first and last receivers (its head and tail, which may run on
// into the neighbouring groups) go to part [kGroups][2][ld], and combine_groups
// adds them, group by group in order, after a barrier.  So every sum runs in an
// order fixed by the shapes alone, and a launch is bitwise reproducible.
// the receivers (relative to the sub-tile) of group g's first and last live rows
__device__ __forceinline__ int2 group_ends(int g, int r0, int valid, int n) {
  const int lo = g * kGroupRows;
  const int hi = min(lo + kGroupRows, valid) - 1;
  return make_int2((r0 + lo) / n, (r0 + hi) / n);
}

// a group's sum of receiver il, to part (head or tail) or to acc (a middle)
__device__ __forceinline__ void put_group_sum(int il, int2 ends, int g, float v,
                                              float* part, int ld, float* acc, int acc_ld,
                                              int c) {
  if (il == ends.x) {
    part[(g * 2) * ld + c] = v;
  } else if (il == ends.y) {
    part[(g * 2 + 1) * ld + c] = v;
  } else {
    acc[il * acc_ld + c] += v;
  }
}

// Column c of group g: value(rl) summed over the group's rows in row order, per receiver.
template <typename Value>
__device__ __forceinline__ void group_sums(int g, int r0, int valid, int n, float* part, int ld,
                                           float* acc, int acc_ld, int c, Value&& value) {
  const int lo = g * kGroupRows;
  if (lo >= valid) return;
  const int hi = min(lo + kGroupRows, valid);
  const int2 ends = group_ends(g, r0, valid, n);
  int il = ends.x;
  int next = (il + 1) * n - r0;  // first chunk row of receiver il + 1
  float sum = 0.0f;
  for (int rl = lo; rl < hi; ++rl) {
    if (rl == next) {
      put_group_sum(il, ends, g, sum, part, ld, acc, acc_ld, c);
      ++il;
      next += n;
      sum = 0.0f;
    }
    sum += value(rl);
  }
  put_group_sum(il, ends, g, sum, part, ld, acc, acc_ld, c);
}

// The same for the trans terms and the mask, one row per lane of the first kGroups warps
// (row rl = threadIdx.x): a segmented sum over the warp's rows with shuffles in a
// fixed pattern leaves each receiver's sum in the lane of its first row.
__device__ __forceinline__ void warp_group_sums(int r0, int valid, int n, float term[4],
                                                float* part, float* acc) {
  const int rl = threadIdx.x;
  const int lane = rl & 31;
  const int g = rl / kGroupRows;
  const int il = rl < valid ? (r0 + rl) / n : -1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int other = __shfl_down_sync(0xffffffffu, il, off);
    float t[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) t[d] = __shfl_down_sync(0xffffffffu, term[d], off);
    if (lane + off < 32 && other == il) {
#pragma unroll
      for (int d = 0; d < 4; ++d) term[d] += t[d];
    }
  }
  const int before = __shfl_up_sync(0xffffffffu, il, 1);
  if (il >= 0 && (lane == 0 || before != il)) {
    const int2 ends = group_ends(g, r0, valid, n);
#pragma unroll
    for (int d = 0; d < 4; ++d) put_group_sum(il, ends, g, term[d], part, 4, acc, 4, d);
  }
}

// Column c: the groups' heads and tails added to acc, group by group in order.
__device__ __forceinline__ void combine_groups(int r0, int valid, int n, const float* part,
                                               int ld, float* acc, int acc_ld, int c) {
  int cur = -1;
  float sum = 0.0f;
  for (int g = 0; g < kGroups && g * kGroupRows < valid; ++g) {
    const int2 ends = group_ends(g, r0, valid, n);
    const float head = part[(g * 2) * ld + c];
    if (ends.x == cur) {
      sum += head;
    } else {
      if (cur >= 0) acc[cur * acc_ld + c] += sum;
      cur = ends.x;
      sum = head;
    }
    if (ends.y != ends.x) {
      acc[cur * acc_ld + c] += sum;
      cur = ends.y;
      sum = part[(g * 2 + 1) * ld + c];
    }
  }
  if (cur >= 0) acc[cur * acc_ld + c] += sum;
}

// ------------------------------------------------------------------ one chunk
// One chunk of edge rows [r0, r0 + kRows) of a sub-tile with `rows` rows and n
// senders per receiver.  s.hAs holds the sub-tile's hA rows, s.geom and s.mask the
// chunk's geometry and mask (zero past `rows`), and a barrier has passed since they
// were written.  hBb points at the sim's first sender.  The caller may overwrite
// s.geom, s.mask and s.trow right after; it syncs before it reads s.agg or s.trans.
template <typename T, bool kElem, bool kTanh>
__device__ __forceinline__ void edge_chunk(const Smem<T, kElem>& s, const T* __restrict__ hBb,
                                           int r0, int rows, int n, int tid, PhaseClock& clk) {
  using S = Smem<T, kElem>;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int valid = min(kRows, rows - r0);  // live rows of this chunk

  // m1 = silu(hA_i + hB_j + g . Wg), row-major [kRows, kLd] (in f32 not swizzled: only
  // chunk_product reads it).  A thread owns kVec
  // columns (one 16-byte load of a row) of the rows rg, rg + kRowStep, ...; it issues
  // all of its hB loads before the first use, and reads hA from shared memory.
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowThreads = kH / kVec;            // threads on one row: 32 or 16
  constexpr int kRowStep = kThreads / kRowThreads;  // 16 or 32
  constexpr int kRowsPer = kRows / kRowStep;        // 8 or 4
  {
    const int c = (tid % kRowThreads) * kVec;
    const int rg = tid / kRowThreads;
    uint4 hb[kRowsPer];
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q) {
      const int rl = rg + q * kRowStep;
      hb[q] = make_uint4(0u, 0u, 0u, 0u);
      if (rl < valid) {
        const int il = (r0 + rl) / n;
        const int j = r0 + rl - il * n;
        hb[q] = __ldg(reinterpret_cast<const uint4*>(hBb + static_cast<size_t>(j) * kH + c));
      }
    }
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
        const int il = (r0 + rl) / n;
        const float* g = s.geom + rl * kGeom;
        float a[kVec], b[kVec];
        unpack<T>(*reinterpret_cast<const uint4*>(s.hAs + il * kH + c), a);
        unpack<T>(hb[q], b);
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          float gx = 0.0f;
#pragma unroll
          for (int k = 0; k < 5; ++k) gx += g[k] * wg[k][v];
          x[v] = a[v] + b[v] + gx;
        }
      }
      store_silu<T, kElem>(s.A + rl * S::kLd + c, x);
    }
  }
  clk.mark(kM1);
  barrier(clk);

  // the Wc1 product's 4 x 4 warp grid and accumulator layout (mma_product): element
  // e of acc[mt][nt] is row wm*32 + mt*16 + g + 8*(e/2), column wn*32 + nt*8 + 2*t4 + e%2
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  {
    // thread (ty, tx) = (warp, lane) holds rows ty*8 .. +7, columns tx*4 .. +3
    float acc[8][4];
    chunk_product(s.A, s.W2, warp, lane, acc);
    clk.mark(kW2);
    barrier(clk);  // every warp has read m1 before m2 overwrites it

    // m2 = silu(m1 W2 + b2) back into A (f32; with kElem, its bf16 values)
    const float4 bias = *reinterpret_cast<const float4*>(s.B2 + lane * 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float* dst = s.A + tile_at<T>(warp * 8 + q, lane * 4);
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
  clk.mark(kEpi2);
  barrier(clk);

  // agg: a thread owns column c of one group of kGroupRows rows and adds mask * m2
  // over them in row order, one sum per receiver; middles go to s.agg, heads and
  // tails to s.part (group_sums)
  {
    const int c = tid % kH;
    group_sums(tid / kH, r0, valid, n, s.part, kH, s.agg, kH, c, [&](int rl) {
      return s.mask[rl] * s.A[tile_at<T>(rl, c)];  // exact: the mask is 0 or 1
    });
  }
  clk.mark(kAgg);

  // w = tanh(silu(m2 Wc1 + bc1) . wc2): each row's four partial sums of w (one per
  // 32-column tile, wn) go to s.trow
  {
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
            const float u = silu(acc[mt][nt][2 * half + p] + s.Bc1[c]);
            sum += u * s.Wc2[c];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t4 == 0) s.trow[(wm * 32 + mt * 16 + g + half * 8) * 4 + wn] = sum;
      }
  }
  clk.mark(kWc1);
  barrier(clk);

  if (tid < kRows) {
    // trans and the degree: thread rl sums row rl's partial sums of w in a fixed order,
    // makes its three terms and holds its mask; each warp (a group of kGroupRows rows)
    // sums them per receiver with shuffles in a fixed pattern
    const int rl = tid;
    float term[4];
    term[3] = rl < valid ? s.mask[rl] : 0.0f;
    const float* wp = s.trow + rl * 4;
    const float sum = ((wp[0] + wp[1]) + wp[2]) + wp[3];
    const float w = kTanh ? tanhf(sum) : sum;
    const float m = s.mask[rl];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      term[d] = rl < valid ? m * clip100(w * s.geom[rl * kGeom + 5 + d]) : 0.0f;
    warp_group_sums(r0, valid, n, term, s.tpart, s.trans);
  } else if (tid < kRows + kH) {
    combine_groups(r0, valid, n, s.part, kH, s.agg, kH, tid - kRows);
  }
  clk.mark(kTrans);
  barrier(clk);
  if (tid < 4) combine_groups(r0, valid, n, s.tpart, 4, s.trans, 4, tid);
  clk.count(kChunks);
  // No barrier here: what follows in this chunk reads only s.tpart and writes
  // s.trans, which the next chunk touches only after its own barriers.  The
  // caller syncs before it reads the accumulators.
}

// agg [B, N, kH] (type TO) and trans [B, N, 3] (f32) of the sub-tile's nrecv receivers:
// sums / max(deg, 1).
template <typename TO, typename S>
__device__ __forceinline__ void write_means(const S& s, TO* __restrict__ agg,
                                            float* __restrict__ trans, int b, int n, int i0,
                                            int nrecv, int tid) {
  for (int e = tid; e < nrecv * kH; e += kThreads) {
    const int il = e / kH;
    store_out(agg + (static_cast<size_t>(b) * n + i0 + il) * kH + e % kH,
              s.agg[e] / fmaxf(s.trans[il * 4 + 3], 1.0f));
  }
  if (tid < nrecv * 3) {
    const int il = tid / 3;
    const int d = tid % 3;
    trans[(static_cast<size_t>(b) * n + i0 + il) * 3 + d] =
        s.trans[il * 4 + d] / fmaxf(s.trans[il * 4 + 3], 1.0f);
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
