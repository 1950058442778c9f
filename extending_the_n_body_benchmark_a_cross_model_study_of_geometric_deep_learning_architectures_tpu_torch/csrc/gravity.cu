// Softened pairwise gravity, a_i = G * sum_j (r_j - r_i) * m_j * (|r_j - r_i|^2 + eps^2)^(-3/2),
// and the leapfrog integrator of the ground-truth datagen built on it.
//
// Both replace the Pallas TPU kernel `pallas_acceleration`
// (extending_..._tpu/ops/pallas/gravity.py:69, body `_gravity_kernel` :37), the
// inner op of every leapfrog substep of the ground-truth datagen:
//
// * K2, `nbody_gravity_f32`: one acceleration per launch.  Each block owns 16
//   receivers of one sim, stages the senders' positions and masses in shared
//   memory tile by tile (any N), and 8 threads share each receiver's sum.
// * K2-leapfrog, `nbody_leapfrog_f32`: a whole GT batch in one launch, as the
//   JAX package's `sample_trajectory` (core/physics.py:93-140) evaluates it: the
//   initial acceleration, then per frame (pos, vel, acc * mass) saved before
//   stepping and `freq` kick-drift-kick substeps.  The substeps after the last
//   frame are not run: nothing of them is saved.  The batch is not cut into
//   chunks of frames: the evaluation's full length (10000 substeps at 64 sims
//   of 100 bodies) is one launch of about 20 ms on an H100.
//
// What bounds them on an H100.  At the datagen shapes (64 sims of 100 bodies,
// 8 of 512) one acceleration is ~13-42 MFLOP (20 flops a pair), a fraction of a
// microsecond at 67 TFLOP/s; a loop of one K2 launch a substep (plus the
// elementwise kicks and drifts around it) is bound by the host's launches.  The
// integrator keeps the whole run on the device: each sim is one thread-block
// cluster (cudaLaunchKernelEx, up to 16 blocks); every block holds all of the
// sim's positions and masses in shared memory, double-buffered, and owns a slice
// of the receivers, whose velocity and acceleration stay in registers.  In each
// substep a block writes its receivers' new positions into every block of the
// cluster through distributed shared memory, and one cluster barrier ends the
// drift: the next write into a buffer comes a substep later, behind the next
// barrier, so one barrier a substep is enough.  Only the saved frames go to
// device memory.  The cluster size comes from ops/gravity.py (`leapfrog_launch`).
//
// One arithmetic.  `gravity_pair` is the only code that computes a pair's
// contribution, and `split_total` the only code that combines a receiver's
// partial sums; K2 and the integrator both call them, in the same order: thread
// s of a receiver's 8 sums j = s, s + 8, ... ascending, and the 8 partial sums
// are combined by a butterfly (float addition commutes, so every lane gets the
// same bits).  Every rounding is written out (__fsub_rn, __fmul_rn, __fmaf_rn,
// __fadd_rn, rsqrt.approx), so no contraction by the compiler can differ between
// the two.  The
// integrator's kicks and drift round as PyTorch's `vel + acc * (dt / 2)` and
// `pos + vel * dt` do (a multiply, then an add, with the scalar cast to float),
// and force is acc * mass: so it gives bitwise the trajectories of the loop of
// K2 launches (ops/gravity.py `leapfrog_loop`).  Both kernels live in this one
// file, so that the shared functions are compiled once, under the same flags.
//
// Same orientation as the TPU kernel (rel = r_j - r_i) and the same guard: a
// pair with r2 == 0 (softening 0 and coincident bodies, or the diagonal)
// contributes nothing instead of 0 * inf.
//
// Plain C interface for ctypes (ops/_build.py); the entry points return
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;                // threads that share one receiver's sum
constexpr int kTile = 128;               // K2: threads a block, senders a staged tile
constexpr int kRecv = kTile / kSplit;    // K2: receivers a block
constexpr int kMaxThreads = 512;         // integrator: threads a block
constexpr int kMaxCluster = 16;          // integrator: blocks a cluster (non-portable above 8)
constexpr int kMaxShared = 232448;       // bytes of shared memory a block may use (227 KB)

static_assert(32 % kSplit == 0, "a receiver's threads lie in one warp");
static_assert(kTile % kSplit == 0, "K2's tiles keep each thread's senders j = s mod kSplit");

// One pair's contribution to receiver i's unscaled sum, from sender p = (x, y, z, m).
__device__ __forceinline__ void gravity_pair(float xi, float yi, float zi, float4 p, float eps2,
                                             float& ax, float& ay, float& az) {
  const float dx = __fsub_rn(p.x, xi);
  const float dy = __fsub_rn(p.y, yi);
  const float dz = __fsub_rn(p.z, zi);
  const float r2 = __fadd_rn(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx))), eps2);
  // rsqrtf without its fix-up for a denormal input: the same bits for every r2
  // that is a normal float; a denormal r2 (softening 0, bodies within ~1e-19)
  // gives an infinite w either way.  Then a select, not a branch, so that the
  // compiler overlaps consecutive pairs.
  float inv;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2));
  const float w = r2 > 0.0f ? __fmul_rn(__fmul_rn(__fmul_rn(inv, inv), inv), p.w) : 0.0f;
  ax = __fmaf_rn(dx, w, ax);
  ay = __fmaf_rn(dy, w, ay);
  az = __fmaf_rn(dz, w, az);
}

// The kSplit partial sums of one receiver (neighbouring lanes), combined in a
// fixed order; every lane of the group returns the same bits.
__device__ __forceinline__ float split_total(float part) {
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  return part;
}

__global__ void __launch_bounds__(kTile)
gravity_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
               float* __restrict__ acc, int n, float g, float eps2) {
  __shared__ float4 sp[kTile];
  const int b = blockIdx.y;
  const int s = threadIdx.x % kSplit;
  const int i = blockIdx.x * kRecv + threadIdx.x / kSplit;
  const float* p = pos + static_cast<size_t>(b) * n * 3;
  const float* m = mass + static_cast<size_t>(b) * n;

  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  if (i < n) {
    xi = p[3 * i];
    yi = p[3 * i + 1];
    zi = p[3 * i + 2];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < n) sp[threadIdx.x] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], m[j]);
    __syncthreads();
    const int cnt = min(kTile, n - j0);
#pragma unroll 4
    for (int jj = s; jj < cnt; jj += kSplit) gravity_pair(xi, yi, zi, sp[jj], eps2, ax, ay, az);
    __syncthreads();
  }
  ax = split_total(ax);
  ay = split_total(ay);
  az = split_total(az);
  if (i < n && s == 0) {
    float* a = acc + (static_cast<size_t>(b) * n + i) * 3;
    a[0] = __fmul_rn(g, ax);
    a[1] = __fmul_rn(g, ay);
    a[2] = __fmul_rn(g, az);
  }
}

// The P receivers' accelerations of one thread, from the positions p[0, n).
template <int P>
__device__ __forceinline__ void accelerations(const float4* p, int n, int s, float g, float eps2,
                                              const float (&x)[P][3], float (&a)[P][3]) {
#pragma unroll
  for (int q = 0; q < P; ++q) a[q][0] = a[q][1] = a[q][2] = 0.0f;
#pragma unroll 4
  for (int j = s; j < n; j += kSplit) {
    const float4 pj = p[j];
#pragma unroll
    for (int q = 0; q < P; ++q) gravity_pair(x[q][0], x[q][1], x[q][2], pj, eps2, a[q][0], a[q][1], a[q][2]);
  }
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c) a[q][c] = __fmul_rn(g, split_total(a[q][c]));
}

// One cluster per sim (blockIdx.x / cluster size).  Block r of the cluster owns
// receivers [r n / C, (r + 1) n / C); its thread group k (kSplit threads) owns
// receivers k, k + groups, ... of that slice, up to P of them.  Shared memory
// holds two buffers of n (x, y, z, m).
template <int P>
__global__ void __launch_bounds__(kMaxThreads)
leapfrog_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
                const float* __restrict__ mass, float* __restrict__ loc_out,
                float* __restrict__ vel_out, float* __restrict__ force_out, int n, int frames,
                int freq, float g, float eps2, float h, float dt) {
  extern __shared__ float4 buf[];  // [2][n]
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / csize;
  const int s = threadIdx.x % kSplit;
  const int group = threadIdx.x / kSplit, groups = blockDim.x / kSplit;
  const int i0 = rank * n / csize, i1 = (rank + 1) * n / csize;
  const float* p0 = pos + static_cast<size_t>(b) * n * 3;
  const float* v0 = vel + static_cast<size_t>(b) * n * 3;
  const float* m0 = mass + static_cast<size_t>(b) * n;

  for (int j = threadIdx.x; j < n; j += blockDim.x)
    buf[j] = make_float4(p0[3 * j], p0[3 * j + 1], p0[3 * j + 2], m0[j]);

  int idx[P];
  bool own[P];
  float x[P][3], v[P][3], a[P][3], m[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = i0 + group + q * groups;
    own[q] = i < i1;
    idx[q] = own[q] ? i : i0;  // a thread past the slice computes on receiver i0 and saves nothing
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[q][c] = p0[3 * idx[q] + c];
      v[q][c] = v0[3 * idx[q] + c];
    }
    m[q] = m0[idx[q]];
  }
  // every block of the cluster has started and loaded its positions before any
  // reads them or a peer writes into its shared memory
  cluster.sync();
  accelerations<P>(buf, n, s, g, eps2, x, a);

  int cur = 0;
  for (int t = 0; t < frames; ++t) {
    if (s < 3) {  // lane c < 3 saves component c of its receivers
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (!own[q]) continue;
        const size_t o = ((static_cast<size_t>(b) * frames + t) * n + idx[q]) * 3 + s;
        const float xs = s == 0 ? x[q][0] : (s == 1 ? x[q][1] : x[q][2]);
        const float vs = s == 0 ? v[q][0] : (s == 1 ? v[q][1] : v[q][2]);
        const float as = s == 0 ? a[q][0] : (s == 1 ? a[q][1] : a[q][2]);
        loc_out[o] = xs;
        vel_out[o] = vs;
        force_out[o] = __fmul_rn(as, m[q]);
      }
    }
    if (t + 1 == frames) break;
    for (int k = 0; k < freq; ++k) {
      cur ^= 1;
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[q][c] = __fadd_rn(v[q][c], __fmul_rn(a[q][c], h));
          x[q][c] = __fadd_rn(x[q][c], __fmul_rn(v[q][c], dt));
        }
        if (own[q]) {
          const float4 p = make_float4(x[q][0], x[q][1], x[q][2], m[q]);
          for (int r = s; r < csize; r += kSplit) cluster.map_shared_rank(buf + cur * n, r)[idx[q]] = p;
        }
      }
      // the new positions are in every block; the last substep's barrier is also
      // the last remote write, so no block exits while a peer writes into it
      cluster.sync();
      accelerations<P>(buf + cur * n, n, s, g, eps2, x, a);
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int c = 0; c < 3; ++c) v[q][c] = __fadd_rn(v[q][c], __fmul_rn(a[q][c], h));
    }
  }
}

template <int P>
cudaError_t configure(int cluster, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(leapfrog_kernel<P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(leapfrog_kernel<P>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Launch(int blocks, int threads, size_t smem, int cluster, cudaStream_t stream) : cfg(), attr() {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <int P>
cudaError_t launch(const float* pos, const float* vel, const float* mass, float* loc, float* vel_out,
                   float* force, int batch, int n, int frames, int freq, float g, float eps2, float h,
                   float dt, int cluster, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t e = configure<P>(cluster, smem);
  if (e != cudaSuccess) return e;
  Launch l(batch * cluster, threads, smem, cluster, stream);
  e = cudaLaunchKernelEx(&l.cfg, leapfrog_kernel<P>, pos, vel, mass, loc, vel_out, force, n, frames,
                         freq, g, eps2, h, dt);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The integrator's launch shape, as ops/gravity.py `leapfrog_launch` gives it.
bool valid_shape(int n, int cluster, int threads, int per) {
  if (n < 1 || cluster < 1 || cluster > kMaxCluster || cluster > n) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return false;
  if (per != 1 && per != 2 && per != 4 && per != 8) return false;
  const int slice = (n + cluster - 1) / cluster;
  return (threads / kSplit) * per >= slice && 2 * sizeof(float4) * static_cast<size_t>(n) <= kMaxShared;
}

}  // namespace

extern "C" int nbody_gravity_f32(const float* pos, const float* mass, float* acc, int batch,
                                 int n, float g, float softening, void* stream) {
  if (batch < 1 || n < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + kRecv - 1) / kRecv, batch);
  gravity_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, mass, acc, n, g, softening * softening);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nbody_leapfrog_f32(const float* pos, const float* vel, const float* mass, float* loc,
                                  float* vel_out, float* force, int batch, int n, int frames,
                                  int freq, float g, float softening, float h, float dt,
                                  int cluster, int threads, int per, void* stream) {
  if (batch < 1 || frames < 1 || freq < 1 || !valid_shape(n, cluster, threads, per) ||
      static_cast<long long>(batch) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(n);
  const float eps2 = softening * softening;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (per) {
    case 1: e = launch<1>(pos, vel, mass, loc, vel_out, force, batch, n, frames, freq, g, eps2, h, dt, cluster, threads, smem, st); break;
    case 2: e = launch<2>(pos, vel, mass, loc, vel_out, force, batch, n, frames, freq, g, eps2, h, dt, cluster, threads, smem, st); break;
    case 4: e = launch<4>(pos, vel, mass, loc, vel_out, force, batch, n, frames, freq, g, eps2, h, dt, cluster, threads, smem, st); break;
    default: e = launch<8>(pos, vel, mass, loc, vel_out, force, batch, n, frames, freq, g, eps2, h, dt, cluster, threads, smem, st); break;
  }
  return static_cast<int>(e);
}
