// Softened pairwise gravity, a_i = G * sum_j (r_j - r_i) * m_j * (|r_j - r_i|^2 + eps^2)^(-3/2).
//
// Replaces the Pallas TPU kernel `pallas_acceleration`
// (extending_..._tpu/ops/pallas/gravity.py:69, body `_gravity_kernel` :37): the
// inner op of every leapfrog substep of the ground-truth datagen.
//
// What bounds it on an H100: at the datagen shape (B=64 sims, N=100 bodies) one
// call reads 64*100*4 values and does ~20 flops per ordered pair, about 13 MFLOP;
// the bound (0.2 us at 67 TFLOP/s f32) is far below the launch cost, so a call
// is launch bound.  The design keeps it to one launch with no scratch in device
// memory: each block owns up to 128 receivers of one sim, stages the senders'
// positions and masses in shared memory tile by tile (any N), and each thread
// accumulates its receiver's acceleration in registers.  The TPU's N <= 512
// limit was a VMEM limit and does not carry over.
//
// Same orientation as the TPU kernel (rel = r_j - r_i) and the same guard: a
// pair with r2 == 0 (softening 0 and coincident bodies, or the diagonal)
// contributes nothing instead of 0 * inf.
//
// Plain C interface for ctypes (ops/_build.py); the entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__global__ void __launch_bounds__(kTile)
gravity_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
               float* __restrict__ acc, int n, float g, float eps2) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], sm[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kTile + threadIdx.x;
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
    if (j < n) {
      sx[threadIdx.x] = p[3 * j];
      sy[threadIdx.x] = p[3 * j + 1];
      sz[threadIdx.x] = p[3 * j + 2];
      sm[threadIdx.x] = m[j];
    }
    __syncthreads();
    const int cnt = min(kTile, n - j0);
    for (int jj = 0; jj < cnt; ++jj) {
      const float dx = sx[jj] - xi;
      const float dy = sy[jj] - yi;
      const float dz = sz[jj] - zi;
      const float r2 = dx * dx + dy * dy + dz * dz + eps2;
      if (r2 > 0.0f) {
        const float inv = rsqrtf(r2);
        const float w = inv * inv * inv * sm[jj];
        ax += dx * w;
        ay += dy * w;
        az += dz * w;
      }
    }
    __syncthreads();
  }
  if (i < n) {
    float* a = acc + (static_cast<size_t>(b) * n + i) * 3;
    a[0] = g * ax;
    a[1] = g * ay;
    a[2] = g * az;
  }
}

}  // namespace

extern "C" int nbody_gravity_f32(const float* pos, const float* mass, float* acc, int batch,
                                 int n, float g, float softening, void* stream) {
  if (batch < 1 || n < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + kTile - 1) / kTile, batch);
  gravity_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, mass, acc, n, g, softening * softening);
  return static_cast<int>(cudaGetLastError());
}
