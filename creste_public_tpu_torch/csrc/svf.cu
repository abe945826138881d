// Expected state-visitation frequency (SVF) over a horizon of T steps, each
// batch element's map split over a thread-block cluster.
//
// Replaces: creste_public_tpu/ops/svf_pallas.py:52 _svf_kernel (launched by
// expected_svf_pallas), the TPU kernel that keeps the whole horizon of a
// batch chunk in VMEM.
//
// Semantics (the JAX package's, exactly): mu0 = one-hot at s0, total = 0;
// each of the T-1 steps does, in order,
//   if zero_terminal_state: mu[s1] = 0
//   total += mu
//   mu'[y, x] = sum_{a=0..7} pol[y - dy_a, x - dx_a, a] * mu[y - dy_a, x - dx_a]
// over in-bounds sources only (a zero border), with (dy_a, dx_a) the rows
// of DYNAMICS; the result is total + mu. Every product is rounded once and
// the sum runs over a = 0..7 from 0 (__fmul_rn / __fadd_rn), the order of
// the plain PyTorch version (ops/svf.py), so the two agree to the bit. An
// out-of-bounds source adds fmul(0, 0) = +0 here and an exact +0 there; a
// sum that starts at +0 never becomes -0, so adding +0 changes nothing.
//
// Layouts: pol [B, H, W, 8] f32 contiguous, read as it is; s0, s1 [B] int64
// linear indices (row * W + col); out [B, H, W] f32.
//
// Design. The 49 steps of a call are dependent, so a step's latency, not
// its ~1.3 M operations, sets the time. Each element gets a cluster of C
// blocks (C <= 8, the portable cluster size); block r owns the band of R
// rows from r * R, R = ceil(H / 8), C = ceil(H / R), so no band is empty
// and at 64 x 128 each band is 8 x 128 cells, one per thread, on its own SM
// (80 SMs at B = 10). The kernel works in pull form: a thread loads, once,
// the 8 policy values that flow INTO each of its cells (pol[src_a, a], 0
// for a source outside the map) and keeps them, mu and total in registers
// for all steps. Per step a cell's mu is the only value that moves: the
// owner writes it to a shared-memory exchange buffer of R + 2 rows of W + 2
// (a halo row above and below, a zero border column each side), double
// buffered by step parity. The band's first row also goes into the halo
// row below of the band above, its last row into the halo row above of the
// band below, by st.async stores into the neighbour's shared memory that
// count their bytes on the neighbour's mbarrier of that parity. Then a
// __syncthreads(); the cells that read no halo row gather at once, and the
// threads of the two edge rows wait on their block's mbarrier for the
// neighbours' rows first. No cluster-wide barrier sits in the steps: a
// block waits only for the rows it reads (a cluster.sync() per step takes
// twice as long on an H100; PERF.md).
//
// Why parity p's buffers are free when they are written again at step
// t + 2: a neighbour writes step t + 2's row only after it has read this
// block's step t + 1 row, which this block's edge threads write only after
// their step t reads; the block's own threads are one __syncthreads() apart.
// Each mbarrier completes a phase when its one local arrival (with the
// expected byte count) and the neighbours' bytes are in, in either order.
// Every byte stored into a block's memory is waited on by that block
// before it exits, so the kernel needs no barrier at its end.
//
// What bounds it on an H100: ~27 operations per cell and step over 2.6 MB
// of policy and 0.33 MB of output, ~1 us at B=10, T=50. Its floor in time
// is the 49 dependent steps, each a block barrier, the latency of a
// distributed-shared-memory store and an 8-long chain of adds per cell.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// blocks per cluster at most, threads per block, cells per thread at most:
// a band holds at most kThreads * kCellsPerThread cells
constexpr int kClusterBlocks = 8;
constexpr int kThreads = 1024;
constexpr int kCellsPerThread = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of the same shared-memory location in block `rank` of the
// cluster
__device__ __forceinline__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(d)
               : "r"(addr), "r"(rank));
  return d;
}

// stores v at `addr` of block `rank` and counts its 4 bytes on that
// block's mbarrier at `bar`
__device__ __forceinline__ void store_remote(uint32_t addr, float v,
                                             uint32_t bar, int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(remote(addr, rank)),
      "r"(__float_as_uint(v)), "r"(remote(bar, rank))
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
svf_kernel(const float* __restrict__ pol, const int64_t* __restrict__ s0,
           const int64_t* __restrict__ s1, float* __restrict__ out, int H,
           int W, int R, int horizon, int zero_terminal_state) {
  extern __shared__ float smem[];
  __shared__ alignas(8) uint64_t bars[2];  // one per step parity
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int b = blockIdx.x / C;
  const int PW = W + 2;         // a buffer row with its border columns
  const int S = (R + 2) * PW;   // one parity: halo above, R rows, halo below
  const int y0 = rank * R;
  const int rows = min(R, H - y0);  // >= 1: no band is empty
  const int cells = rows * W;
  // bytes of halo rows the neighbours store here per step
  const int halo_bytes = 4 * W * ((rank > 0) + (rank + 1 < C));
  // DYNAMICS of ops/value_iteration.py: (dy, dx) per action
  const int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

  for (int i = threadIdx.x; i < 2 * S; i += kThreads) smem[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(&bars[i])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  const float* P = pol + (int64_t)b * H * W * 8;
  const int64_t start = s0[b], term = s1[b];
  float pin[kCellsPerThread][8], mu[kCellsPerThread], total[kCellsPerThread];
  int off[kCellsPerThread];  // the cell's slot in a parity's buffer
  bool valid[kCellsPerThread], kill[kCellsPerThread];
  bool to_up[kCellsPerThread], to_down[kCellsPerThread];
  bool reads_halo = false;
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    valid[k] = c < cells;
    const int ly = valid[k] ? c / W : 0;
    const int x = c - ly * W, y = y0 + ly;
    const int64_t g = (int64_t)y * W + x;
    off[k] = (ly + 1) * PW + x + 1;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int sy = y - kDy[a], sx = x - kDx[a];
      pin[k][a] = valid[k] && sy >= 0 && sy < H && sx >= 0 && sx < W
                      ? __ldg(P + ((int64_t)sy * W + sx) * 8 + a)
                      : 0.f;
    }
    mu[k] = valid[k] && g == start ? 1.f : 0.f;
    total[k] = 0.f;
    kill[k] = valid[k] && zero_terminal_state && g == term;
    // a band's first row feeds the band above and reads its halo row
    // above; its last row feeds the band below and reads its halo row below
    to_up[k] = valid[k] && ly == 0 && y > 0;
    to_down[k] = valid[k] && ly == rows - 1 && y < H - 1;
    reads_halo |= to_up[k] || to_down[k];
  }
  // every block of the cluster runs, has zeroed its buffers and set up its
  // mbarriers before any block stores into a neighbour's
  cluster.sync();

  for (int step = 0; step + 1 < horizon; ++step) {
    const int p = (step & 1) * S;
    const float* cur = smem + p;
    const uint32_t bar = smem_addr(&bars[step & 1]);
    if (threadIdx.x == 0 && halo_bytes > 0) {
      uint64_t state;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
          : "=l"(state)
          : "r"(bar), "r"(halo_bytes)
          : "memory");
      (void)state;
    }
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k) {
      if (!valid[k]) continue;
      if (kill[k]) mu[k] = 0.f;
      total[k] = __fadd_rn(total[k], mu[k]);
      smem[p + off[k]] = mu[k];
      // into the halo row below of the band above (R rows) and the halo
      // row above of the band below
      if (to_up[k])
        store_remote(smem_addr(smem + p + off[k] + R * PW), mu[k], bar,
                     rank - 1);
      if (to_down[k])
        store_remote(smem_addr(smem + p + off[k] - R * PW), mu[k], bar,
                     rank + 1);
    }
    __syncthreads();
    // the cells that read no halo row, while the neighbours' rows arrive
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k) {
      if (!valid[k] || to_up[k] || to_down[k]) continue;
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a)
        acc = __fadd_rn(
            acc, __fmul_rn(pin[k][a], cur[off[k] - kDy[a] * PW - kDx[a]]));
      mu[k] = acc;
    }
    if (reads_halo) {
      // this parity's (step / 2)-th phase: the neighbours' rows are in
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{ .reg .pred P; mbarrier.try_wait.parity.acquire.cluster."
            "shared::cta.b64 P, [%1], %2; selp.b32 %0, 1, 0, P; }"
            : "=r"(done)
            : "r"(bar), "r"((step >> 1) & 1)
            : "memory");
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k) {
        if (!(to_up[k] || to_down[k])) continue;
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a)
          acc = __fadd_rn(
              acc, __fmul_rn(pin[k][a], cur[off[k] - kDy[a] * PW - kDx[a]]));
        mu[k] = acc;
      }
    }
  }
  float* o = out + (int64_t)b * H * W + (int64_t)y0 * W;
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k)
    if (valid[k]) o[threadIdx.x + k * kThreads] = __fadd_rn(total[k], mu[k]);
}

}  // namespace

// Launches one cluster per batch element on `stream`; returns a cudaError_t
// as an int. `info` (host memory, 3 ints) receives the blocks per cluster,
// the blocks launched and the clusters the card can hold at once.
extern "C" int svf_propagate(const void* pol, const void* s0, const void* s1,
                             void* out, int B, int H, int W, int horizon,
                             int zero_terminal_state, void* stream,
                             int* info) {
  // the fewest rows per band that split H over at most kClusterBlocks
  // blocks, and the fewest blocks for that band
  const int R = (H + kClusterBlocks - 1) / kClusterBlocks;
  const int C = (H + R - 1) / R;
  if (B < 1 || H < 1 || W < 1 ||
      (int64_t)R * W > (int64_t)kThreads * kCellsPerThread)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * (R + 2) * (W + 2) * sizeof(float);
  cudaError_t err;
  // above 48 KB with the two static mbarriers only after an opt-in
  if (smem + 2 * sizeof(uint64_t) > 48 * 1024) {
    err = cudaFuncSetAttribute(
        svf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, svf_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  info[0] = C;
  info[1] = B * C;
  info[2] = clusters;
  err = cudaLaunchKernelEx(&cfg, svf_kernel, (const float*)pol,
                           (const int64_t*)s0, (const int64_t*)s1,
                           (float*)out, H, W, R, horizon,
                           zero_terminal_state);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* svf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
