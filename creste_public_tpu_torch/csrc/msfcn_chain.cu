// One SAME-padded, stride-1 k x k convolution layer of the inference-mode
// MultiScaleFCN reward head, with its BatchNorm folded into a per-channel
// affine: y = post_relu(a[co] * pre_relu(conv(x, w))[co] + b[co]).
//
// Replaces: creste_public_tpu/ops/reward_pallas.py::_chain_kernel (launched
// by _run_chain), the TPU kernel that runs the head as three fused conv
// chains. Here the chain is a sequence of launches of this kernel: four for
// the prepool/skip chain, two for the trunk, one for the postpool.
//
// Layouts: x [B, H, W, Ci] and y [B, H, W, Co] NHWC f32; w [kh, kw, Ci, Co]
// (HWIO, the flax layout); a, b [Co]. All contiguous.
//
// What bounds it on an H100: the production head is about 1.55 GFLOP per
// frame over about 1.3 MB of inputs and weights, so it is bound by
// operations: ~23 us at the 67 TFLOP/s f32 CUDA-core rate. The design is
// the simple direct form: one thread per output element, f32 FMAs in the
// JAX package's tap order (dy, dx, ci). Consecutive threads take
// consecutive output channels of one pixel, so a warp's weight loads are
// coalesced and its input loads are one broadcast address; both stay in
// L1/L2 (the largest layer's weights are 256 KB). Fusing each chain into
// one launch with the tile and halo in shared memory and the taps on
// tensor cores is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void conv_affine_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   float* __restrict__ y,
                                   int B, int H, int W, int Ci, int Co,
                                   int kh, int kw, int pre_relu,
                                   int post_relu) {
  const int64_t total = (int64_t)B * H * W * Co;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = (int)(idx % Co);
  int64_t p = idx / Co;
  const int ox = (int)(p % W);
  p /= W;
  const int oy = (int)(p % H);
  const int bb = (int)(p / H);
  const int ph = kh / 2, pw = kw / 2;

  float acc = 0.f;
  for (int dy = 0; dy < kh; ++dy) {
    const int iy = oy + dy - ph;
    if (iy < 0 || iy >= H) continue;
    for (int dx = 0; dx < kw; ++dx) {
      const int ix = ox + dx - pw;
      if (ix < 0 || ix >= W) continue;
      const float* xp = x + (((int64_t)bb * H + iy) * W + ix) * Ci;
      const float* wp = w + (int64_t)(dy * kw + dx) * Ci * Co + co;
      for (int ci = 0; ci < Ci; ++ci) {
        acc = fmaf(__ldg(xp + ci), __ldg(wp + (int64_t)ci * Co), acc);
      }
    }
  }
  if (pre_relu) acc = fmaxf(acc, 0.f);
  float v = fmaf(acc, __ldg(a + co), __ldg(b + co));
  if (post_relu) v = fmaxf(v, 0.f);
  y[idx] = v;
}

}  // namespace

// Launches one layer on `stream`; returns cudaGetLastError() as an int.
extern "C" int msfcn_conv_affine(const void* x, const void* w, const void* a,
                                 const void* b, void* y, int B, int H, int W,
                                 int Ci, int Co, int kh, int kw, int pre_relu,
                                 int post_relu, void* stream) {
  const int64_t total = (int64_t)B * H * W * Co;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (total > 0) {
    conv_affine_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (const float*)a, (const float*)b,
        (float*)y, B, H, W, Ci, Co, kh, kw, pre_relu, post_relu);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* msfcn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
