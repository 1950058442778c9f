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
// shape (B=64, N=100, He=Hc=128) one call is ~42 GFLOP against ~25 MB of inputs,
// so it is bound by operations and never by bytes, as long as no [B, N, N, He]
// tensor goes to device memory: 0.64 ms at 67 TFLOP/s of f32 on the CUDA cores,
// ~0.27 ms with both products as three TF32 products at 495 TFLOP/s.
// The design keeps every per-edge intermediate on chip:
//   * a persistent grid of min(B N, SMs) blocks of 512 threads, one an SM: each
//     stages W2 and Wc1 (64 KB each) in shared memory once and walks a balanced
//     range of the B N receivers in sub-tiles of <= 16 that never cross a sim
//     (egnn_edge.cuh, for_each_subtile), each sub-tile's edges in chunks of 128
//     rows;
//   * per chunk, the geometry and mask rows are loaded into shared memory, and
//     the edge stage shared with K3 (egnn_edge.cuh) builds m1, runs the two
//     products and adds the masked sums of agg, trans and
//     the degree to shared accumulators in a fixed order, without atomics
//     (bitwise reproducible); the outputs are written once per receiver.
//   * 228 KB of shared memory leaves one block per SM, so the block is as
//     large as the 128-register budget allows: 16 warps hide shared-memory
//     latency better than 8 (a 256-thread block measured ~1.3x slower).
// The f32 form runs its Wc1 product as error-compensated TF32 on the tensor cores
// (3xTF32: each operand split into two TF32 parts, three mma.sync products a k-step
// summed in f32, egnn_edge.cuh), which keeps about f32's accuracy where plain TF32
// would not, and its W2 product as a register-tiled f32 FMA loop: on the tensor
// cores that one's error against float64 went over twice the f32 plain version's.
// Its time against its bound is in PERF.md.
//
// The bf16 form (`nbody_egnn_messages_bf16`, the mixed-bf16 model) follows the
// TPU body's rounding points for bf16 operands (egnn_messages.py:66-115): the
// geometry g[0:5] is rounded to bf16 for its product with the bf16 Wg, m1, m2
// and the silu output before wc2 are rounded to bf16 as matmul operands, every
// product accumulates in f32, the elementwise work and the masked sums are f32,
// agg is written in bf16 and trans in f32.  Its two 128x128 products run on the
// tensor cores (mma.sync m16n8k16): ~0.043 ms of bf16 work at the rollout shape
// against 989 TFLOP/s, under a fifth of a chunk.  Its chunk (egnn_edge_bf16.cuh)
// is laid out against the elementwise phases that held it: agg is summed from the
// W2 product's registers, and the next chunk's geometry and mask rows (contiguous
// in [B, N, N, 8] and [B, N, N]) are copied with cp.async while the current one
// computes, g[0:5] rounded where m1 reads it.  Its time against its bound and its
// phase split are in PERF.md.
//
// Plain C interface for ctypes (ops/_build.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include "egnn_edge.cuh"
#include "egnn_edge_bf16.cuh"

namespace {

using namespace egnn_edge;

// K1 with f32 operands (T = float): the chunk of egnn_edge.cuh
template <typename T, bool kTanh>
__global__ void __launch_bounds__(kThreads, 1)
egnn_edge_kernel(const T* __restrict__ hA, const T* __restrict__ hB,
                 const float* __restrict__ geom, const float* __restrict__ mask,
                 const T* __restrict__ wg, const T* __restrict__ W2, const T* __restrict__ b2,
                 const T* __restrict__ Wc1, const T* __restrict__ bc1,
                 const T* __restrict__ wc2, T* __restrict__ agg, float* __restrict__ trans,
                 int batch, int n, int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T, false> s(smem);
  const int tid = threadIdx.x;
  PhaseClock clk;
  stage_weights(s, wg, W2, b2, Wc1, bc1, wc2, tid);
  clk.mark(kStage);

  for_each_subtile(batch, n, blocks, [&](int b, int i0, int nrecv) {
    const int rows = nrecv * n;  // edge row r = il * n + j  <->  (i0 + il, j)
    const T* hAb = hA + (static_cast<size_t>(b) * n + i0) * kH;
    const T* hBb = hB + static_cast<size_t>(b) * n * kH;
    const float* geomb = geom + (static_cast<size_t>(b) * n + i0) * n * kGeom;
    const float* maskb = mask + (static_cast<size_t>(b) * n + i0) * n;
    begin_subtile(s, hAb, nrecv, tid);
    __syncthreads();

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
      }
      clk.mark(kPrologue);
      barrier(clk);
      edge_chunk<T, false, kTanh>(s, hBb, r0, rows, n, tid, clk);
    }
    __syncthreads();  // the last chunk's sums are in
    write_means(s, agg, trans, b, n, i0, nrecv, tid);
    __syncthreads();  // before the next sub-tile zeroes the accumulators
    clk.mark(kMeans);
  });
  clk.flush();
}

// The geometry and mask of the chunk at r0 of a sub-tile with `rows` rows (geomb,
// maskb at its first row) into buffer `buf`, zero past `rows`: cp.async, 16 bytes of
// geometry (half a row) or 4 of mask a thread; the caller waits for them.
__device__ __forceinline__ void fetch_chunk(const SmemBf16& s, int buf,
                                            const float* __restrict__ geomb,
                                            const float* __restrict__ maskb, int r0, int rows,
                                            int tid) {
  if (tid < 2 * kRows) {
    const bool live = r0 + tid / 2 < rows;
    cp_async16(s.geom_buf(buf) + tid * 4,
               live ? geomb + static_cast<size_t>(r0) * kGeom + tid * 4 : geomb, live);
  } else if (tid < 3 * kRows) {
    const int t = tid - 2 * kRows;
    const bool live = r0 + t < rows;
    cp_async4(s.mask_buf(buf) + t, live ? maskb + r0 + t : maskb, live);
  }
}

// K1 with bf16 operands: the chunk of egnn_edge_bf16.cuh, each chunk's geometry and
// mask copied in during the chunk before it (the sub-tile's first, with its hA rows)
template <bool kTanh>
__global__ void __launch_bounds__(kThreads, 1)
egnn_edge_kernel_bf16(const bf16* __restrict__ hA, const bf16* __restrict__ hB,
                      const float* __restrict__ geom, const float* __restrict__ mask,
                      const bf16* __restrict__ wg, const bf16* __restrict__ W2,
                      const bf16* __restrict__ b2, const bf16* __restrict__ Wc1,
                      const bf16* __restrict__ bc1, const bf16* __restrict__ wc2,
                      bf16* __restrict__ agg, float* __restrict__ trans, int batch, int n,
                      int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemBf16 s(smem);
  const int tid = threadIdx.x;
  PhaseClock clk;
  stage_weights(s, wg, W2, b2, Wc1, bc1, wc2, tid);
  clk.mark(kStage);

  for_each_subtile(batch, n, blocks, [&](int b, int i0, int nrecv) {
    const int rows = nrecv * n;  // edge row r = il * n + j  <->  (i0 + il, j)
    const bf16* hAb = hA + (static_cast<size_t>(b) * n + i0) * kH;
    const bf16* hBb = hB + static_cast<size_t>(b) * n * kH;
    const float* geomb = geom + (static_cast<size_t>(b) * n + i0) * n * kGeom;
    const float* maskb = mask + (static_cast<size_t>(b) * n + i0) * n;
    begin_subtile(s, hAb, nrecv, tid);
    fetch_chunk(s, 0, geomb, maskb, 0, rows, tid);
    cp_async_wait_all();
    __syncthreads();
    clk.mark(kPrologue);

    for (int r0 = 0, buf = 0; r0 < rows; r0 += kRows, buf ^= 1) {
      const int next = r0 + kRows;
      edge_chunk_bf16<false, kTanh, true>(
          s, buf, hBb, r0, rows, n, tid, clk,
          [&](int t) {
            if (next < rows) fetch_chunk(s, buf ^ 1, geomb, maskb, next, rows, t);
          },
          [](int) {});
    }
    __syncthreads();  // the last chunk's sums are in
    write_means(s, agg, trans, b, n, i0, nrecv, tid);
    __syncthreads();  // before the next sub-tile zeroes the accumulators
    clk.mark(kMeans);
  });
  clk.flush();
}

static_assert(Smem<float, false>::kBytes <= kSmemMax, "over the H100's shared memory per block");
static_assert(SmemBf16::kBytes <= kSmemMax, "over the H100's shared memory per block");

template <typename T, bool kTanh>
int launch(const T* hA, const T* hB, const float* geom, const float* mask, const T* wg,
           const T* W2, const T* b2, const T* Wc1, const T* bc1, const T* wc2, T* agg,
           float* trans, int batch, int n, int blocks, cudaStream_t stream) {
  static bool configured = false;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr size_t bytes = kBf16 ? SmemBf16::kBytes : Smem<float, false>::kBytes;
  const auto kernel = [] {
    if constexpr (kBf16) {
      return &egnn_edge_kernel_bf16<kTanh>;
    } else {
      return &egnn_edge_kernel<T, kTanh>;
    }
  }();
  if (const int err = allow_smem(kernel, bytes, configured)) return err;
  kernel<<<blocks, kThreads, bytes, stream>>>(hA, hB, geom, mask, wg, W2, b2, Wc1, bc1, wc2,
                                              agg, trans, batch, n, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* hA, const T* hB, const float* geom, const float* mask, const T* wg,
             const T* W2, const T* b2, const T* Wc1, const T* bc1, const T* wc2, T* agg,
             float* trans, int batch, int n, int he, int hc, int blocks, int use_tanh,
             void* stream) {
  if (he != kH || hc != kH || n < 1 || batch < 1 || blocks < 1 ||
      static_cast<long long>(blocks) > static_cast<long long>(batch) * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = use_tanh ? &launch<T, true> : &launch<T, false>;
  return go(hA, hB, geom, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans, batch, n, blocks,
            static_cast<cudaStream_t>(stream));
}

// The edge stage's silu on its own, element by element (chip_smoke.py measures its error).
__global__ void silu_kernel(const float* __restrict__ x, float* __restrict__ y, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) y[i] = silu(x[i]);
}

}  // namespace

extern "C" int nbody_egnn_messages_f32(const float* hA, const float* hB, const float* geom,
                                       const float* mask, const float* wg, const float* W2,
                                       const float* b2, const float* Wc1, const float* bc1,
                                       const float* wc2, float* agg, float* trans, int batch,
                                       int n, int he, int hc, int blocks, int use_tanh,
                                       void* stream) {
  return dispatch(hA, hB, geom, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans, batch, n, he, hc,
                  blocks, use_tanh, stream);
}

// hA, hB, the weights and agg in bf16; geom, mask and trans in f32.
extern "C" int nbody_egnn_messages_bf16(const bf16* hA, const bf16* hB, const float* geom,
                                        const float* mask, const bf16* wg, const bf16* W2,
                                        const bf16* b2, const bf16* Wc1, const bf16* bc1,
                                        const bf16* wc2, bf16* agg, float* trans, int batch,
                                        int n, int he, int hc, int blocks, int use_tanh,
                                        void* stream) {
  return dispatch(hA, hB, geom, mask, wg, W2, b2, Wc1, bc1, wc2, agg, trans, batch, n, he, hc,
                  blocks, use_tanh, stream);
}

extern "C" int nbody_edge_silu_f32(const float* x, float* y, int count, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  silu_kernel<<<(count + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y, count);
  return static_cast<int>(cudaGetLastError());
}

#ifdef EGNN_EDGE_PHASES
extern "C" int nbody_egnn_messages_phases(unsigned long long* out) { return read_phases(out); }
extern "C" const char* nbody_edge_phase_names() { return kPhaseNames; }
#endif
