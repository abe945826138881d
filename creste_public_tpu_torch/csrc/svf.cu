// Expected state-visitation frequency (SVF) over a horizon of T steps, one
// thread block per batch element.
//
// Replaces: creste_public_tpu/ops/svf_pallas.py:52 _svf_kernel (launched by
// expected_svf_pallas), the TPU kernel that keeps the whole horizon of a
// batch chunk in VMEM.
//
// Semantics (the JAX package's, exactly): mu0 = one-hot at s0, total = 0;
// each of the T-1 steps does, in order,
//   if zero_terminal_state: mu[s1] = 0
//   total += mu
//   mu'[y, x] = sum_{a=0..7} pol[a, y - dy_a, x - dx_a] * mu[y - dy_a, x - dx_a]
// over in-bounds sources only (a zero border), with (dy_a, dx_a) the rows
// of DYNAMICS; the result is total + mu. The gather form needs no atomics
// and is deterministic. Products and sums are separate roundings in the
// order of the plain PyTorch version (ops/svf.py), which adds an exact zero
// where this kernel skips an out-of-bounds source, so the two agree to the
// bit.
//
// Layouts: pol [B, 8, H, W] f32 contiguous (the wrapper transposes the
// [B, H, W, 8] policy, as expected_svf_pallas does); s0, s1 [B] int32
// linear indices (row * W + col); out [B, H, W] f32.
//
// Design: mu (double buffered) and total live in dynamic shared memory,
// 3 x 32 KB at 64 x 128, above the 48 KB default, so the launcher sets
// cudaFuncAttributeMaxDynamicSharedMemorySize. One element's policy is
// 8 x 32 KB, more than a block's 227 KB, so it is read from device memory
// (L2-resident: 2.6 MB at B=10) at every step. __syncthreads() separates
// the steps.
//
// What bounds it on an H100: ~18 operations per cell and step over 2.6 MB
// of policy and 0.33 MB of output, both ~1 us at B=10, T=50. The kernel
// runs B blocks on 132 SMs and each block walks its map serially through
// T-1 steps, so it is bound by the latency of one block's L2 reads per
// step, far above that. Splitting each map over a cluster is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
svf_kernel(const float* __restrict__ pol, const int* __restrict__ s0,
           const int* __restrict__ s1, float* __restrict__ out, int H, int W,
           int horizon, int zero_terminal_state) {
  extern __shared__ float smem[];
  const int hw = H * W;
  float* mu = smem;
  float* nxt = smem + hw;
  float* total = smem + 2 * hw;
  const int b = blockIdx.x;
  const float* P = pol + (int64_t)b * 8 * hw;
  // DYNAMICS of ops/value_iteration.py: (dy, dx) per action
  const int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    mu[i] = 0.f;
    total[i] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int s = s0[b];
    if (s >= 0 && s < hw) mu[s] = 1.f;
  }
  __syncthreads();

  for (int step = 0; step + 1 < horizon; ++step) {
    if (zero_terminal_state) {
      if (threadIdx.x == 0) {
        const int s = s1[b];
        if (s >= 0 && s < hw) mu[s] = 0.f;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      total[i] = __fadd_rn(total[i], mu[i]);
      const int y = i / W, x = i - (i / W) * W;
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int sy = y - kDy[a], sx = x - kDx[a];
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) {
          const int j = sy * W + sx;
          acc = __fadd_rn(acc, __fmul_rn(__ldg(P + a * hw + j), mu[j]));
        }
      }
      nxt[i] = acc;
    }
    __syncthreads();
    float* t = mu;
    mu = nxt;
    nxt = t;
  }
  float* o = out + (int64_t)b * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x)
    o[i] = __fadd_rn(total[i], mu[i]);
}

}  // namespace

// Launches B blocks on `stream`; returns a cudaError_t as an int.
extern "C" int svf_propagate(const void* pol, const void* s0, const void* s1,
                             void* out, int B, int H, int W, int horizon,
                             int zero_terminal_state, void* stream) {
  const size_t smem = (size_t)3 * H * W * sizeof(float);
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(svf_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    svf_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)pol, (const int*)s0, (const int*)s1, (float*)out, H, W,
        horizon, zero_terminal_state);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* svf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
