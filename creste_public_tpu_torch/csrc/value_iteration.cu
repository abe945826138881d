// Value iteration over the BEV reward grid, solved to convergence in one
// cooperative launch, with k sweeps between grid barriers.
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
// Layouts: r and v [B, H, W] f32 contiguous; ring [2, B, H, W] f32
// scratch; delta_bits [max_iters] int32, ZEROED by the caller (slot n
// collects sweep n's sup-norm change as float bits, so no slot is ever
// reset); info [2] int32 receives the sweeps run and the grid barriers.
//
// Design: temporal blocking. The stop is batch-global, so the blocks must
// meet, and one grid barrier per sweep is what bounded the first version
// (3.64 us per sweep, ~4 M operations each). Here a block owns an interior
// tile of kTileH x kTileW cells. For a phase of k sweeps it loads the tile
// with a halo of k cells, runs the k sweeps locally with one
// __syncthreads() between them, and meets the grid once. After local
// sweep s the cells within k - s - 1 of the interior hold exactly what a
// global sweep gives (halo cells are recomputed with the same operations;
// cells outside the map keep p = 0), so the interior is exact after k.
// Each local sweep reduces |dV| over the interior, with one atomicMax per
// block into that sweep's slot. Phase ph reads V from ring slot ph % 2 and
// writes its interior's V after the phase to the other slot. After the
// barrier every thread scans the phase's slots for the first sweep whose
// change is not above the threshold, so the decision is uniform. A stop at
// the phase's last sweep (or at max_iters) copies that slot to v; a stop
// inside the phase re-runs the phase's first sweeps from its input, which
// no block writes any more, straight into v. Grid barriers per solve:
// ceil(sweeps / k).
//
// Inside a tile, thread t owns a run of rows of column t % LW: r, V and p
// of its cells stay in registers, the products 0.1 * p and 0.8 * p of its
// column and of the two neighbouring columns (read from shared memory,
// double buffered) are computed once and shared by the 8 actions and the
// vertically adjacent cells, and every cell is computed each sweep without
// branches so that the cells' chains overlap.
//
// Schedule (k, tile): k = 8 and 16 x 48 (120 tiles at B=10, 64 x 128, one
// per SM; 48 + 2k = 64 columns, two warps per row), the fastest of eight
// (k, tile) schedules measured at the stage-3 reward on an NVIDIA H100 80GB
// HBM3 (700 W); the table is in PERF.md.
//
// What bounds it on an H100: per cell and sweep ~52 operations (24 tap
// products, 16 adds, 7 maxes, r + gamma*V, the change) on 2 x 0.33 MB of
// input and output: ~44 us for 687 sweeps at B=10 at 67 TFLOP/s f32, by
// operations. The blocked form computes 2.7x the cells (the halo), shares
// the products (7.5 instead of 24 per cell), and pays ceil(sweeps / k)
// grid barriers; each local sweep still costs a block barrier and a pass
// of ~500 instructions per warp, which is what bounds it now.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// sweeps per grid barrier (k) and interior tile (rows x columns)
constexpr int kSweepsPerBarrier = 8;
constexpr int kTileH = 16;
constexpr int kTileW = 48;

// max that propagates NaN, like jnp.max and torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The loaded tile is LH x LW = (TH + 2K) x (TW + 2K) cells. Thread t owns
// a run of RUN consecutive rows of column t % LW: their r, V and p stay in
// registers across the K sweeps, so a cell's vertical neighbours and the
// products 0.1 * p and 0.8 * p of its column come from registers, and only
// the two neighbouring columns' p go through shared memory (double
// buffered, with a one-cell border that is never written). Every sweep
// computes all of a thread's cells without branches, so their chains
// overlap; the cells outside the rings that are exact after the sweep get
// values that only ever reach other such cells.
template <int K, int TH, int TW>
__global__ void __launch_bounds__(kThreads)
vi_kernel(const float* __restrict__ r, float* v, float* ring, int* delta_bits,
          int* info, int B, int H, int W, float discount, float threshold,
          int max_iters) {
  constexpr int LH = TH + 2 * K, LW = TW + 2 * K;
  constexpr int PW = LW + 2, PL = (LH + 2) * PW;  // p with its border
  constexpr int RUN = LH / (kThreads / LW);       // rows per thread
  static_assert(kThreads % LW == 0 && LH % (kThreads / LW) == 0,
                "tile layout");
  cg::grid_group grid = cg::this_grid();
  __shared__ float pbuf[2][PL];
  __shared__ int sdelta[K];

  // the taps' positions in the 3x3 neighbourhood (ky * 3 + kx), per action:
  // _LEFT, _CENTER, _RIGHT of ops/value_iteration.py
  const int kL[8] = {3, 0, 1, 6, 2, 7, 8, 5};
  const int kC[8] = {0, 1, 2, 3, 5, 6, 7, 8};
  const int kR[8] = {1, 2, 5, 0, 8, 3, 6, 7};

  const int lx = threadIdx.x % LW, ly0 = threadIdx.x / LW * RUN;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  const int ntiles = B * tiles_y * tiles_x;
  const int64_t n = (int64_t)B * H * W;

  // Runs `sweeps` sweeps on each of the block's tiles from `vin` (V after
  // `it` sweeps; unread when it == 0), reducing each sweep's change into
  // sdelta when `record`, and writes the interior's V after the last sweep
  // to `vout`.
  auto run = [&](int it, int sweeps, bool record, const float* vin,
                 float* vout) {
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int b = tile / (tiles_y * tiles_x);
      const int rem = tile - b * tiles_y * tiles_x;
      const int Y0 = (rem / tiles_x) * TH - K, X0 = (rem % tiles_x) * TW - K;
      const int64_t base = (int64_t)b * H * W;
      const int x = X0 + lx;
      const bool col_in = x >= 0 && x < W;
      const bool col_interior = lx >= K && lx < K + TW;
      float rv[RUN], vv[RUN], pv[RUN];
      bool in[RUN];
      __syncthreads();  // the previous tile's passes are done
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int y = Y0 + ly0 + j;
        in[j] = col_in && y >= 0 && y < H;
        const int64_t g = base + (int64_t)y * W + x;
        rv[j] = in[j] ? __ldg(r + g) : 0.f;
        vv[j] = in[j] && it > 0 ? __ldcg(vin + g) : 0.f;
        pv[j] = in[j] ? __fadd_rn(rv[j], __fmul_rn(discount, vv[j])) : 0.f;
        pbuf[0][(ly0 + j + 1) * PW + lx + 1] = pv[j];
      }
      for (int s = 0; s < sweeps; ++s) {
        __syncthreads();
        const float* pc = pbuf[s & 1] + ly0 * PW + lx;  // (row -1, col -1)
        float* pn = pbuf[(s + 1) & 1] + (ly0 + 1) * PW + lx + 1;
        // 0.1 * p and 0.8 * p of rows -1..RUN of columns -1, 0, +1; each
        // product is rounded once, as in the plain version
        float c1[3][RUN + 2], c8[3][RUN + 2];
#pragma unroll
        for (int i = 0; i < RUN + 2; ++i) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float p = (dx == 1 && i >= 1 && i <= RUN)
                                ? pv[i - 1]
                                : pc[i * PW + dx];
            c1[dx][i] = __fmul_rn(0.1f, p);
            c8[dx][i] = __fmul_rn(0.8f, p);
          }
        }
        // V' and the next p; exact on the rings >= s + 1. The interior's
        // change.
        float local = 0.f;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          float q[8];
#pragma unroll
          for (int a = 0; a < 8; ++a)
            q[a] = __fadd_rn(
                __fadd_rn(c1[kL[a] % 3][j + kL[a] / 3],
                          c8[kC[a] % 3][j + kC[a] / 3]),
                c1[kR[a] % 3][j + kR[a] / 3]);
          // max is exact, so its order does not change the value
          const float best =
              nan_max(nan_max(nan_max(q[0], q[1]), nan_max(q[2], q[3])),
                      nan_max(nan_max(q[4], q[5]), nan_max(q[6], q[7])));
          const int ly = ly0 + j;
          if (in[j] && col_interior && ly >= K && ly < K + TH)
            local = nan_max(local, fabsf(__fsub_rn(best, vv[j])));
          vv[j] = best;
          pv[j] = in[j] ? __fadd_rn(rv[j], __fmul_rn(discount, best)) : 0.f;
          pn[j * PW] = pv[j];
        }
        if (record) {
          // block max of |dV| for this sweep (non-negative floats order
          // like their bits, and a NaN's bits above them all)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            local = nan_max(local, __shfl_xor_sync(0xffffffffu, local, off));
          if ((threadIdx.x & 31) == 0)
            atomicMax(sdelta + s, __float_as_int(local));
        }
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int ly = ly0 + j;
        if (in[j] && col_interior && ly >= K && ly < K + TH)
          __stcg(vout + base + (int64_t)(Y0 + ly) * W + x, vv[j]);
      }
    }
  };

  // Phases of K sweeps between grid barriers; phase ph reads ring slot
  // ph % 2 and writes the other. A stop inside a phase re-runs that
  // phase's first sweeps from its input (which no block writes any more)
  // straight into v.
  int it = 0, ph = 0, stop = max_iters > 0 ? -1 : 0, barriers = 0;
  const float* res = nullptr;  // the slot holding V at the stop
  while (stop < 0) {
    const int ks = min(K, max_iters - it);
    const float* vin = ring + (int64_t)(ph % 2) * n;
    float* vout = ring + (int64_t)((ph + 1) % 2) * n;
    if (threadIdx.x < ks) sdelta[threadIdx.x] = 0;
    run(it, ks, true, vin, vout);
    __syncthreads();
    if (threadIdx.x < ks)
      atomicMax(delta_bits + it + threadIdx.x, sdelta[threadIdx.x]);
    grid.sync();
    ++barriers;
    int s = 0;
    while (s < ks &&
           __int_as_float(*(volatile const int*)(delta_bits + it + s)) >
               threshold)
      ++s;
    if (s < ks - 1) {  // stopped inside the phase
      run(it, s + 1, false, vin, v);
      stop = it + s + 1;
    } else if (s == ks - 1 || it + ks >= max_iters) {
      res = vout;
      stop = it + ks;
    } else {
      it += ks;
      ++ph;
    }
  }
  if (res != nullptr || stop == 0) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride)
      v[i] = stop > 0 ? __ldcg(res + i) : 0.f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    info[0] = stop;
    info[1] = barriers;
  }
}

template <int K, int TH, int TW>
cudaError_t launch(const float* r, float* v, float* ring, int* delta_bits,
                   int* info, int B, int H, int W, float discount,
                   float threshold, int max_iters, cudaStream_t stream) {
  auto kernel = vi_kernel<K, TH, TW>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t tiles =
      (int64_t)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int64_t most = (int64_t)per_sm * sms;
  const int blocks = (int)(tiles < most ? tiles : most);
  void* args[] = {&r, &v, &ring, &delta_bits, &info, &B, &H, &W, &discount,
                  &threshold, &max_iters};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Launches the solve on `stream`; returns a cudaError_t as an int. `ring`
// holds 2 * B * H * W floats.
extern "C" int vi_solve(const void* r, void* v, void* ring, void* delta_bits,
                        void* info, int B, int H, int W, float discount,
                        float threshold, int max_iters, void* stream) {
  return (int)launch<kSweepsPerBarrier, kTileH, kTileW>(
      (const float*)r, (float*)v, (float*)ring, (int*)delta_bits, (int*)info,
      B, H, W, discount, threshold, max_iters, (cudaStream_t)stream);
}

extern "C" const char* vi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
