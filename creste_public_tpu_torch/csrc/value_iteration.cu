// Value iteration over the BEV reward grid, solved to convergence in one
// cooperative launch.
//
// Replaces: creste_public_tpu/ops/vi_pallas.py:51 _vi_kernel (launched by
// value_iteration_pallas), the TPU kernel that keeps the whole solve of a
// batch chunk in VMEM.
//
// Semantics (the JAX package's, exactly): V0 = 0; each sweep computes
// p = zero-pad(r + gamma * V) and V' = max over the 8 actions of
// 0.1 * p[L] + 0.8 * p[C] + 0.1 * p[R], the taps of _ACTION_TAPS in that
// order. The solve stops at the first sweep whose sup-norm change over the
// WHOLE batch is <= threshold, or after max_iters sweeps. Multiplies and
// adds are separate roundings (__fmul_rn / __fadd_rn, no FMA contraction),
// in the order of the plain PyTorch version (ops/value_iteration.py), so
// the two agree to the bit and stop at the same sweep.
//
// Layouts: r and v [B, H, W] f32 contiguous; v2 [B, H, W] f32 scratch;
// delta_bits [max_iters] int32, ZEROED by the caller (slot `it` collects
// the sweep's sup-norm change as float bits, so no slot is ever reset);
// sweeps [1] int32 receives the number of sweeps run.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) whose grid
// is sized from the occupancy calculator so that every block is resident.
// Threads walk the B*H*W cells with a grid-stride loop. V is double
// buffered in device memory (2 x 320 KB at B=10: it stays in L2); neighbour
// values are read with ld.global.cg so that no stale L1 line is seen across
// the grid barrier. Each sweep reduces |dV| per block, does one atomicMax
// on the float's bits (non-negative floats order like their bits) into
// slot `it`, and then one grid.sync(); every thread reads the slot and
// decides to stop, so the decision is uniform across the grid.
//
// What bounds it on an H100: per cell and sweep, ~52 operations (24 tap
// products, 16 adds, 7 maxes, r + gamma*V, the change) on 2 x 0.33 MB of
// input and output, so the work bound is operations: ~64 us for 1,000
// sweeps at B=10 at 67 TFLOP/s f32. The kernel is latency-bound instead:
// one grid barrier per sweep, and one sweep is too little work to hide it.
// Keeping each map in shared memory and stopping by a cluster-wide change
// is later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// max that propagates NaN, like jnp.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__global__ void __launch_bounds__(kThreads)
vi_kernel(const float* __restrict__ r, float* v, float* v2, int* delta_bits,
          int* sweeps, int B, int H, int W, float discount, float threshold,
          int max_iters) {
  cg::grid_group grid = cg::this_grid();
  const int64_t n = (int64_t)B * H * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  __shared__ float warp_max[kThreads / 32];

  // the taps' positions in the 3x3 neighbourhood (ky * 3 + kx), per action:
  // _LEFT, _CENTER, _RIGHT of ops/value_iteration.py
  const int kL[8] = {3, 0, 1, 6, 2, 7, 8, 5};
  const int kC[8] = {0, 1, 2, 3, 5, 6, 7, 8};
  const int kR[8] = {1, 2, 5, 0, 8, 3, 6, 7};

  for (int64_t i = first; i < n; i += stride) v[i] = 0.f;
  grid.sync();

  float* cur = v;
  float* nxt = v2;
  int it = 0;
  while (it < max_iters) {
    float local = 0.f;
    for (int64_t i = first; i < n; i += stride) {
      const int x = (int)(i % W);
      const int y = (int)((i / W) % H);
      const int64_t base = i - (int64_t)y * W - x;  // cell (b, 0, 0)
      float p[9];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int yy = y + ky - 1, xx = x + kx - 1;
          float val = 0.f;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const int64_t j = base + (int64_t)yy * W + xx;
            val = __fadd_rn(__ldg(r + j), __fmul_rn(discount, __ldcg(cur + j)));
          }
          p[ky * 3 + kx] = val;
        }
      }
      float best = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float q = __fadd_rn(
            __fadd_rn(__fmul_rn(0.1f, p[kL[a]]), __fmul_rn(0.8f, p[kC[a]])),
            __fmul_rn(0.1f, p[kR[a]]));
        best = a == 0 ? q : nan_max(best, q);
      }
      nxt[i] = best;
      local = nan_max(local, fabsf(__fsub_rn(best, __ldcg(cur + i))));
    }
    // block max of |dV|, then one atomic per block into this sweep's slot
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local = nan_max(local, __shfl_xor_sync(0xffffffffu, local, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = warp_max[0];
      for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
      atomicMax(delta_bits + it, __float_as_int(m));
    }
    grid.sync();
    const float delta =
        __int_as_float(*(volatile const int*)(delta_bits + it));
    float* t = cur;
    cur = nxt;
    nxt = t;
    ++it;
    if (!(delta > threshold)) break;
  }
  // the result ends in v2 after an odd number of sweeps: copy it home
  if (cur != v) {
    for (int64_t i = first; i < n; i += stride) v[i] = __ldcg(cur + i);
  }
  if (first == 0) *sweeps = it;
}

}  // namespace

// Launches the solve on `stream`; returns a cudaError_t as an int.
extern "C" int vi_solve(const void* r, void* v, void* v2, void* delta_bits,
                        void* sweeps, int B, int H, int W, float discount,
                        float threshold, int max_iters, void* stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vi_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t n = (int64_t)B * H * W;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)per_sm * sms;
  const int blocks = (int)(want < most ? (want > 0 ? want : 1) : most);
  const float* rp = (const float*)r;
  float* vp = (float*)v;
  float* v2p = (float*)v2;
  int* dp = (int*)delta_bits;
  int* sp = (int*)sweeps;
  void* args[] = {&rp, &vp, &v2p, &dp, &sp, &B, &H, &W, &discount,
                  &threshold, &max_iters};
  err = cudaLaunchCooperativeKernel((const void*)vi_kernel, dim3(blocks),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* vi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
