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
// (B, N) = (8, 512) one call is ~141 GFLOP (2.1 ms of f32 at 67 TFLOP/s on CUDA
// cores, ~0.9 ms with both products as 3xTF32 on the tensor cores) against ~10 MB
// of node data and mask, so it is bound by operations.  No
// [B, N, N, *] tensor but the mask goes to or comes from device memory: the
// dense path's [B, N, N, 8] geometry (537 MB at N = 4096) is never made.
//   * a persistent grid of min(B N, SMs) blocks of 512 threads, one an SM, each
//     walking a balanced range of receivers in sub-tiles of <= 16, as K1 does;
//     a sub-tile's receivers' node data (10 floats each) sit in shared memory,
//     W2 and Wc1 are staged once per block (egnn_edge.cuh).  At (1, 1000) that
//     is 132 blocks where one per 16 receivers gave 63;
//   * per chunk of 128 edge rows, a prologue computes each row's 8 geometry
//     scalars from the receiver's node data in shared memory and the sender's
//     read from device memory (L1/L2 resident: 40 bytes a node), then the edge
//     stage shared with K1 runs on them;
//   * any N: the last chunk of a sub-tile is ragged and masked, with no
//     tile-divisibility assumption.
// The f32 form runs its Wc1 product as error-compensated TF32 on the tensor cores
// (3xTF32) and its W2 product as an f32 FMA loop (egnn_edge.cuh), as K1 does; its
// time against its bound is in PERF.md.
//
// The bf16 form (`nbody_egnn_stream_bf16`, the mixed-bf16 model) takes hA, hB
// and the weights in bf16 and writes agg in bf16, trans in f32.  Its operand
// rule is K1's (egnn_messages.cu) but for the geometry term, which the TPU body
// computes as an f32 product with Wg upcast (egnn_stream.py:124-136), so the
// geometry is not rounded.  Its two 128x128 products run on the tensor cores
// (mma.sync m16n8k16, egnn_edge.cuh).  `elem_bf16` (egnn_stream.py:111-158) runs
// the two silus and the mask multiply in bf16 on __nv_bfloat162 pairs, one
// rounding per operation; h2exp and h2rcp are approximate, so a value can land
// one bf16 ulp from the plain version's.  It is legal with f32 operands too (a
// third instantiation of the f32 template).  The running sums of agg, trans and
// the degree stay f32 and run in a fixed order.  The bf16 forms run the chunk of
// egnn_edge_bf16.cuh (agg summed from the W2 product's registers, four barriers a
// chunk): once a chunk's m1 is built every thread issues cp.async copies of the next
// chunk's sender rows (pos0, vel, coord, mass) and mask, and in the trans phase the
// threads it leaves idle compute that chunk's geometry from them, so no chunk but a
// sub-tile's first waits for a prologue.  Their times against their bound and
// their phase split are in PERF.md.
//
// Plain C interface for ctypes (ops/_build.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "egnn_edge.cuh"
#include "egnn_edge_bf16.cuh"

namespace {

using namespace egnn_edge;

constexpr int kNode = 10;    // pos0 (3), vel (3), mass (1), coord (3)
constexpr int kStaged = 12;  // a staged sender row: pos0 (3), vel (3), coord (3), mass, mask, pad

template <typename T, bool kElem>
constexpr size_t stream_smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value) {
    return SmemBf16::kBytes + (kMaxTi * kNode + kRows * kStaged) * sizeof(float);
  } else {
    return Smem<T, kElem>::kBytes + kMaxTi * kNode * sizeof(float);
  }
}
static_assert(stream_smem_bytes<float, false>() <= kSmemMax, "over the H100's shared memory per block");
static_assert(stream_smem_bytes<float, true>() <= kSmemMax, "over the H100's shared memory per block");
static_assert(stream_smem_bytes<bf16, false>() <= kSmemMax, "over the H100's shared memory per block");
static_assert(stream_smem_bytes<bf16, true>() <= kSmemMax, "over the H100's shared memory per block");

// The geometry g[0:8] of edge (i, j), as the TPU body computes it
// (egnn_stream.py:95-109), from receiver i's node data ni [kNode] and sender j's
// pos0 (p), vel (v), coord (c) and mass (m)
template <bool kNormDiff>
__device__ __forceinline__ void edge_geometry(const float* ni, const float* p, const float* v,
                                              const float* c, float m, float g[kGeom]) {
  const float c0x = ni[0] - p[0], c0y = ni[1] - p[1], c0z = ni[2] - p[2];
  const float d2_0 = c0x * c0x + c0y * c0y + c0z * c0z;
  const float inv_d0 = 1.0f / fmaxf(sqrtf(fmaxf(d2_0, 0.0f)), 1e-12f);
  const float ux = c0x * inv_d0, uy = c0y * inv_d0, uz = c0z * inv_d0;
  float cx = ni[7] - c[0], cy = ni[8] - c[1], cz = ni[9] - c[2];
  const float radial = cx * cx + cy * cy + cz * cz;
  if (kNormDiff) {
    const float inv_norm = 1.0f / fmaxf(sqrtf(fmaxf(radial, 0.0f)), 1.0f);
    cx *= inv_norm;
    cy *= inv_norm;
    cz *= inv_norm;
  }
  g[0] = radial;
  g[1] = ni[6] * m;
  g[2] = ni[3] * ux + ni[4] * uy + ni[5] * uz;
  g[3] = v[0] * ux + v[1] * uy + v[2] * uz;
  g[4] = d2_0;
  g[5] = cx;
  g[6] = cy;
  g[7] = cz;
}

// K3 with f32 operands (T = float, with or without elem_bf16): the chunk of egnn_edge.cuh
template <typename T, bool kElem, bool kTanh, bool kNormDiff>
__global__ void __launch_bounds__(kThreads, 1)
egnn_stream_kernel(const T* __restrict__ hA, const T* __restrict__ hB,
                   const float* __restrict__ pos0, const float* __restrict__ vel,
                   const float* __restrict__ mass, const float* __restrict__ coord,
                   const float* __restrict__ mask, const T* __restrict__ wg,
                   const T* __restrict__ W2, const T* __restrict__ b2,
                   const T* __restrict__ Wc1, const T* __restrict__ bc1,
                   const T* __restrict__ wc2, T* __restrict__ agg, float* __restrict__ trans,
                   int batch, int n, int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T, kElem> s(smem);
  float* sNode = s.end();  // [kMaxTi, kNode]
  const int tid = threadIdx.x;
  PhaseClock clk;
  stage_weights(s, wg, W2, b2, Wc1, bc1, wc2, tid);
  clk.mark(kStage);

  for_each_subtile(batch, n, blocks, [&](int b, int i0, int nrecv) {
    const int rows = nrecv * n;  // edge row r = il * n + j  <->  (i0 + il, j)
    const size_t sim = static_cast<size_t>(b) * n;
    const T* hAb = hA + (sim + i0) * kH;
    const T* hBb = hB + sim * kH;
    const float* maskb = mask + (sim + i0) * n;
    begin_subtile(s, hAb, nrecv, tid);
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
    __syncthreads();

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
          edge_geometry<kNormDiff>(sNode + il * kNode, pos0 + j * 3, vel + j * 3,
                                   coord + j * 3, mass[j], g);
          m = maskb[r];
        }
#pragma unroll
        for (int k = 0; k < kGeom; ++k) s.geom[tid * kGeom + k] = g[k];
        s.mask[tid] = m;
      }
      clk.mark(kPrologue);
      barrier(clk);
      edge_chunk<T, kElem, kTanh>(s, hBb, r0, rows, n, tid, clk);
    }
    __syncthreads();  // the last chunk's sums are in
    write_means(s, agg, trans, b, n, i0, nrecv, tid);
    __syncthreads();  // before the next sub-tile zeroes the accumulators and node data
    clk.mark(kMeans);
  });
  clk.flush();
}

// Stage the sender rows and mask of the chunk at r0 of a sub-tile with `rows` rows
// (maskb at its first row, sim the sim's first node) in st [kRows, kStaged], zero
// past `rows`: thread (row t = tid % kRows, part tid / kRows) copies its row's pos0,
// vel, coord, or mass and mask, 4 bytes a cp.async; the caller waits for them.
__device__ __forceinline__ void fetch_senders(float* st, const float* __restrict__ pos0,
                                              const float* __restrict__ vel,
                                              const float* __restrict__ mass,
                                              const float* __restrict__ coord,
                                              const float* __restrict__ maskb, size_t sim,
                                              int r0, int rows, int n, int tid) {
  const int t = tid % kRows, q = tid / kRows;
  const int r = r0 + t;
  const bool live = r < rows;
  const size_t j = live ? sim + r % n : 0;
  float* dst = st + t * kStaged;
  if (q < 3) {
    const float* src = (q == 0 ? pos0 : (q == 1 ? vel : coord)) + j * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) cp_async4(dst + 3 * q + k, src + k, live);
  } else {
    cp_async4(dst + 9, mass + j, live);
    cp_async4(dst + 10, maskb + (live ? r : 0), live);
  }
}

// Row t of the chunk at r0: its geometry and mask from the staged row into buffer buf
// (zero past `rows`)
template <bool kNormDiff>
__device__ __forceinline__ void stream_prologue(const SmemBf16& s, int buf, const float* sNode,
                                                const float* st, int r0, int rows, int n,
                                                int t) {
  float g[kGeom] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float m = 0.0f;
  const int r = r0 + t;
  if (r < rows) {
    const float* sj = st + t * kStaged;
    edge_geometry<kNormDiff>(sNode + (r / n) * kNode, sj, sj + 3, sj + 6, sj[9], g);
    m = sj[10];
  }
  float* dst = s.geom_buf(buf) + t * kGeom;
#pragma unroll
  for (int k = 0; k < kGeom; ++k) dst[k] = g[k];
  s.mask_buf(buf)[t] = m;
}

// K3 with bf16 operands: the chunk of egnn_edge_bf16.cuh, each chunk's geometry made
// during the chunk before it (the sub-tile's first, after its node data)
template <bool kElem, bool kTanh, bool kNormDiff>
__global__ void __launch_bounds__(kThreads, 1)
egnn_stream_kernel_bf16(const bf16* __restrict__ hA, const bf16* __restrict__ hB,
                        const float* __restrict__ pos0, const float* __restrict__ vel,
                        const float* __restrict__ mass, const float* __restrict__ coord,
                        const float* __restrict__ mask, const bf16* __restrict__ wg,
                        const bf16* __restrict__ W2, const bf16* __restrict__ b2,
                        const bf16* __restrict__ Wc1, const bf16* __restrict__ bc1,
                        const bf16* __restrict__ wc2, bf16* __restrict__ agg,
                        float* __restrict__ trans, int batch, int n, int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemBf16 s(smem);
  float* sNode = s.end();                  // [kMaxTi, kNode]
  float* staged = sNode + kMaxTi * kNode;  // [kRows, kStaged]: a chunk's sender rows
  const int tid = threadIdx.x;
  PhaseClock clk;
  stage_weights(s, wg, W2, b2, Wc1, bc1, wc2, tid);
  clk.mark(kStage);

  for_each_subtile(batch, n, blocks, [&](int b, int i0, int nrecv) {
    const int rows = nrecv * n;  // edge row r = il * n + j  <->  (i0 + il, j)
    const size_t sim = static_cast<size_t>(b) * n;
    const bf16* hAb = hA + (sim + i0) * kH;
    const bf16* hBb = hB + sim * kH;
    const float* maskb = mask + (sim + i0) * n;
    begin_subtile(s, hAb, nrecv, tid);
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
    fetch_senders(staged, pos0, vel, mass, coord, maskb, sim, 0, rows, n, tid);
    cp_async_wait_all();
    __syncthreads();
    if (tid < kRows) stream_prologue<kNormDiff>(s, 0, sNode, staged, 0, rows, n, tid);
    __syncthreads();
    clk.mark(kPrologue);

    for (int r0 = 0, buf = 0; r0 < rows; r0 += kRows, buf ^= 1) {
      const int next = r0 + kRows;
      edge_chunk_bf16<kElem, kTanh, false>(
          s, buf, hBb, r0, rows, n, tid, clk,
          [&](int t) {
            if (next < rows) fetch_senders(staged, pos0, vel, mass, coord, maskb, sim, next, rows, n, t);
          },
          [&](int t) {
            t -= kRows + kH;
            if (next < rows && t < kRows)
              stream_prologue<kNormDiff>(s, buf ^ 1, sNode, staged, next, rows, n, t);
          });
    }
    __syncthreads();  // the last chunk's sums are in
    write_means(s, agg, trans, b, n, i0, nrecv, tid);
    __syncthreads();  // before the next sub-tile zeroes the accumulators and node data
    clk.mark(kMeans);
  });
  clk.flush();
}

template <typename T, bool kElem, bool kTanh, bool kNormDiff>
int launch(const T* hA, const T* hB, const float* pos0, const float* vel, const float* mass,
           const float* coord, const float* mask, const T* wg, const T* W2, const T* b2,
           const T* Wc1, const T* bc1, const T* wc2, T* agg, float* trans, int batch, int n,
           int blocks, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t bytes = stream_smem_bytes<T, kElem>();
  const auto kernel = [] {
    if constexpr (std::is_same<T, bf16>::value) {
      return &egnn_stream_kernel_bf16<kElem, kTanh, kNormDiff>;
    } else {
      return &egnn_stream_kernel<T, kElem, kTanh, kNormDiff>;
    }
  }();
  if (const int err = allow_smem(kernel, bytes, configured)) return err;
  kernel<<<blocks, kThreads, bytes, stream>>>(hA, hB, pos0, vel, mass, coord, mask, wg, W2, b2,
                                              Wc1, bc1, wc2, agg, trans, batch, n, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kElem>
auto pick(int use_tanh, int norm_diff) {
  return use_tanh ? (norm_diff ? &launch<T, kElem, true, true> : &launch<T, kElem, true, false>)
                  : (norm_diff ? &launch<T, kElem, false, true> : &launch<T, kElem, false, false>);
}

template <typename T>
int dispatch(const T* hA, const T* hB, const float* pos0, const float* vel, const float* mass,
             const float* coord, const float* mask, const T* wg, const T* W2, const T* b2,
             const T* Wc1, const T* bc1, const T* wc2, T* agg, float* trans, int batch, int n,
             int he, int hc, int blocks, int use_tanh, int norm_diff, int elem_bf16,
             void* stream) {
  if (he != kH || hc != kH || n < 1 || batch < 1 || blocks < 1 ||
      static_cast<long long>(blocks) > static_cast<long long>(batch) * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go =
      elem_bf16 ? pick<T, true>(use_tanh, norm_diff) : pick<T, false>(use_tanh, norm_diff);
  return go(hA, hB, pos0, vel, mass, coord, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans, batch,
            n, blocks, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int nbody_egnn_stream_f32(const float* hA, const float* hB, const float* pos0,
                                     const float* vel, const float* mass, const float* coord,
                                     const float* mask, const float* wg, const float* W2,
                                     const float* b2, const float* Wc1, const float* bc1,
                                     const float* wc2, float* agg, float* trans, int batch,
                                     int n, int he, int hc, int blocks, int use_tanh,
                                     int norm_diff, int elem_bf16, void* stream) {
  return dispatch(hA, hB, pos0, vel, mass, coord, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans,
                  batch, n, he, hc, blocks, use_tanh, norm_diff, elem_bf16, stream);
}

// hA, hB, the weights and agg in bf16; node data, mask and trans in f32.
extern "C" int nbody_egnn_stream_bf16(const bf16* hA, const bf16* hB, const float* pos0,
                                      const float* vel, const float* mass, const float* coord,
                                      const float* mask, const bf16* wg, const bf16* W2,
                                      const bf16* b2, const bf16* Wc1, const bf16* bc1,
                                      const bf16* wc2, bf16* agg, float* trans, int batch,
                                      int n, int he, int hc, int blocks, int use_tanh,
                                      int norm_diff, int elem_bf16, void* stream) {
  return dispatch(hA, hB, pos0, vel, mass, coord, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans,
                  batch, n, he, hc, blocks, use_tanh, norm_diff, elem_bf16, stream);
}

#ifdef EGNN_EDGE_PHASES
extern "C" int nbody_egnn_stream_phases(unsigned long long* out) { return read_phases(out); }
#endif
