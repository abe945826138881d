// The inference-mode MultiScaleFCN reward head, every BatchNorm folded into
// a per-channel affine, as four launches on tensor cores.
//
// Replaces: creste_public_tpu/ops/reward_pallas.py::_chain_kernel (launched
// by _run_chain), the TPU kernel that runs the head as three fused conv
// chains with XLA's maxpool, upsample and concat between them.
//
// The head (the presets' widths; Ci = the input view's channels, k0 odd):
//   prepool: k0 x k0 Ci -> 64, 3x3 64 -> 32           (p_out)
//   skip:    3x3 32 -> 32, 1x1 32 -> 16 on p_out       (s_out)
//   trunk:   2x2 maxpool of p_out, then 3x3 32 -> 32 and 1x1 32 -> 32, each
//            with a relu before its BN                (t, half resolution)
//   post:    bilinear resize of t to (H, W) (half-pixel centres, clamped
//            edges), concat [t, s_out] and 1x1 48 -> 1
// Each layer is a SAME conv (zero padding), then a*y + b, then relu.
//
// Launches (no PyTorch op between them):
//   1. the k0 x k0 layer alone on 8 x 16 output tiles, each block computing
//      half of its 64 channels (128 blocks at 64 x 128; half the weight
//      traffic from L2 of 64-channel blocks), writing them (2 MB at B=1,
//      L2-resident);
//   2. on 8 x 8 output tiles: the 3x3 64 -> 32 layer over the tile and a
//      1-pixel halo, the 2x2 maxpool of its interior (tile origins are
//      even, so no window straddles two blocks), then the skip's 3x3 and
//      1x1; writes the pooled map and s_out;
//   3. the trunk on 4 x 8 half-resolution tiles (64 blocks), writing t;
//   4. upsample + concat + 1x1 48 -> 1 + affine + relu on CUDA cores
//      (N = 1), one thread per pixel.
// Intermediates that feed a later layer of the same launch stay in shared
// memory; pixels outside the map are written as 0 there, which is the next
// layer's zero padding. The maxpool floors and the resize goes back to
// (H, W), so odd sizes work; ragged tiles are masked.
//
// Convolutions: implicit GEMM with M = the tile's pixels, N = Co and
// K = taps x Ci, one tap at a time over the input tile in shared memory,
// on mma.sync.m16n8k8 TF32 with 3xTF32 split precision: each operand is
// split as hi = tf32_rna(x), lo = tf32_rna(x - hi), and the product
// accumulates lo*hi + hi*lo + hi*hi in f32 (about f32 accuracy; a single
// TF32 pass keeps ~3 decimal digits). The weights are split once on the
// host (ops/reward_kernel.py::fold_msfcn_params) and packed per tap,
// k-step and n-tile as the B fragments each lane holds (b0, b1 of hi, then
// of lo: one 16-byte load per lane); activations are split as fragments
// are loaded (two integer operations per part). In the two large layers
// each warp computes one 16-pixel m-tile against all the block's n-tiles,
// so no activation of theirs is split twice in a block. mma.sync and not
// wgmma: the A operand is a shifted
// window of an NHWC tile (176 B pixel stride at Ci = 40), which wgmma's
// shared-memory descriptors do not describe; the pixel stride is padded to
// Ci + 4 floats so the fragment loads hit 32 distinct banks. The input
// tile with its halo and the weights (10 KB per tap of the 5x5 layer's
// slice, hi and lo, kStages taps in flight) arrive with cp.async.
//
// What bounds it on an H100: 1.519 GFLOP per frame at 64 x 128 (the
// in-bounds taps' multiply-adds and the epilogues) over ~1.8 MB of input,
// weights and output. With 3 TF32 products per multiply-add at 495 TFLOP/s
// that is ~9.2 us by operations (22.7 us at the 67 TFLOP/s f32 CUDA-core
// rate); bytes take under 1 us. The design spends the extra work of the
// halos (the 3x3 layer of launch 2 runs on 1.6x its pixels) to get 128
// blocks for the 8,192 pixels of one frame, and keeps every intermediate
// but the first layer's and the pooled map out of device memory. What
// bounds it now is the instruction rate of the tap loop (per k-step and
// warp: 12 mma.sync, 8 shared loads and 20 split operations; 8 warps per
// SM): mma.sync reaches a fraction of the TF32 rate that wgmma would.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// channel widths of the supported head (checked by the wrapper)
constexpr int kC1 = 64, kC2 = 32, kC3 = 32, kC4 = 16, kC5 = 32, kC6 = 32;
constexpr int kMaxCi = 64, kMaxK0 = 5;
// output tiles (rows x columns) of launches 1, 2 and 3; launch 1 also
// splits its kC1 channels over kSplit1 blocks
constexpr int kTile1H = 8, kTile1W = 16, kSplit1 = 2;
constexpr int kTile2H = 8, kTile2W = 8;
constexpr int kTile3H = 4, kTile3W = 8;
constexpr int kPostThreads = 128;
// taps of weights in flight: a ring of kStages tap buffers, refilled
// kStages - 1 taps ahead
constexpr int kStages = 8;

static_assert(kTile2H % 2 == 0 && kTile2W % 2 == 0, "pool windows");

struct HeadArgs {
  const float* x;         // [B, H, W, Ci]
  const float4* w[6];     // packed weights of the six tensor-core layers
  const float* wpost;     // [48] of the final 1x1
  const float* a[7];      // folded BN scale per layer
  const float* b[7];      // folded BN shift per layer
  float* p0;              // [B, H, W, kC1]
  float* s;               // [B, H, W, kC4]
  float* pooled;          // [B, Hp, Wp, kC2]
  float* t;               // [B, Hp, Wp, kC6]
  float* out;             // [B, H, W]
  int B, H, W, K0, Hp, Wp;
};

// cvt.rna.tf32.f32 (round to nearest, ties away, at 10 mantissa bits) in
// two integer operations: exact for finite values, and a NaN stays NaN in
// the product through its lo part.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// the 3xTF32 split of x: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Loads TH x TW pixels of C channels from the NHWC map `src` (one batch
// element, H x W) at origin (y0, x0) into `dst` with a pixel stride of S
// floats; pixels outside the map become 0. Commits nothing.
__device__ void load_tile(float* dst, const float* src, int H, int W, int C,
                          int S, int y0, int x0, int TH, int TW) {
  const int chunks = C / 4;
  const int total = TH * TW * chunks;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int px = i / chunks, c4 = i - px * chunks;
    const int y = y0 + px / TW, x = x0 + px % TW;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const float* g = in ? src + ((int64_t)y * W + x) * C + c4 * 4 : src;
    cp_async16(dst + px * S + c4 * 4, g, in);
  }
}

// One conv layer over an OH x OW output region from a tile in shared memory
// (output (oy, ox) reads in[((oy + dy) * IW + ox + dx) * (CI + 4) + ci]),
// on tensor cores, 3xTF32, for the CO output channels [nt0 * 8,
// nt0 * 8 + CO) of a layer with ntg * 8. Warp w takes the n-tiles
// [nw * NT, nw * NT + NT) (nw = w % NG) and the 16-pixel m-tiles
// mw + j * (kWarps / NG), j < MT (mw = w / NG); rows past the region are
// computed from pixel 0 and never stored. Streams the block's slice of the
// packed weights tap by tap through the ring of kStages tap buffers
// `wbuf`; the caller has started (not committed or waited) the copies of
// `in` when it came from device memory. Calls epi(oy, ox, co, acc) with co
// the layer's channel.
template <int CO, int NT, int MT, int CI, class Epi>
__device__ __forceinline__ void conv_stage(const float* in, int IW, int OH,
                                           int OW, int KH, int KW,
                                           const float4* wg, int ntg,
                                           int nt0, float4* wbuf, Epi epi) {
  constexpr int S = CI + 4;  // pixel stride: fragment loads hit 32 banks
  constexpr int NG = CO / 8 / NT;
  constexpr int MSTEP = kWarps / NG;
  constexpr int KSTEPS = CI / 8;
  constexpr int ROW = CO / 8 * 32;  // float4s of one k-step in the slice
  constexpr int TAP_F4 = KSTEPS * ROW;
  static_assert(CO % (8 * NT) == 0 && kWarps % NG == 0 && CI % 8 == 0,
                "warp layout");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nw = warp % NG, mw = warp / NG;
  const int npx = OH * OW;
  const int taps = KH * KW;
  auto load_tap = [&](float4* dst, int tap) {
    const float4* src = wg + ((int64_t)tap * KSTEPS * ntg + nt0) * 32;
#pragma unroll
    for (int i = threadIdx.x; i < TAP_F4; i += kThreads)
      cp_async16(dst + i, src + (i / ROW) * ntg * 32 + i % ROW, true);
  };

  const float* arow[MT][2];  // the lane's two pixel rows of each m-tile
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int q = (mw + j * MSTEP) * 16 + g + 8 * h;
      if (q >= npx) q = 0;
      arow[j][h] = in + ((q / OW) * IW + q % OW) * S + tq;
    }
  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < taps) load_tap(wbuf + t * TAP_F4, t);
    cp_async_commit();
  }
  for (int tap = 0; tap < taps; ++tap) {
    cp_async_wait<kStages - 2>();  // this tap's copies (and the tile's)
    __syncthreads();               // ... from every thread; the previous
                                   // tap's buffer is free
    const int next = tap + kStages - 1;
    if (next < taps) load_tap(wbuf + (next % kStages) * TAP_F4, next);
    cp_async_commit();
    const float4* wb = wbuf + (tap % kStages) * TAP_F4 + nw * NT * 32 + lane;
    const int off = ((tap / KW) * IW + tap % KW) * S;
    const float* ap[MT][2];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      ap[j][0] = arow[j][0] + off;
      ap[j][1] = arow[j][1] + off;
    }
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t ahi[MT][4], alo[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        split_tf32(ap[j][0][ks * 8], ahi[j][0], alo[j][0]);
        split_tf32(ap[j][1][ks * 8], ahi[j][1], alo[j][1]);
        split_tf32(ap[j][0][ks * 8 + 4], ahi[j][2], alo[j][2]);
        split_tf32(ap[j][1][ks * 8 + 4], ahi[j][3], alo[j][3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 bf = wb[ks * ROW + n * 32];
        bh[n][0] = __float_as_uint(bf.x);
        bh[n][1] = __float_as_uint(bf.y);
        bl[n][0] = __float_as_uint(bf.z);
        bl[n][1] = __float_as_uint(bf.w);
      }
      // the small products first; each pass over independent accumulators
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(acc[j][n], alo[j], bh[n]);
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(acc[j][n], ahi[j], bl[n]);
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(acc[j][n], ahi[j], bh[n]);
    }
  }
  __syncthreads();  // every buffer is free for the next stage
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = (mw + j * MSTEP) * 16 + g + (i >= 2 ? 8 : 0);
        const int co = (nt0 + nw * NT + n) * 8 + 2 * tq + (i & 1);
        if (q < npx) epi(q / OW, q % OW, co, acc[j][n][i]);
      }
}

__device__ __forceinline__ float affine_relu(float v, const float* a,
                                             const float* b, int co) {
  return fmaxf(fmaf(v, __ldg(a + co), __ldg(b + co)), 0.f);
}

// Launch 1: the k0 x k0 Ci -> kC1 layer.
template <int CI>
__global__ void __launch_bounds__(kThreads) head_first(HeadArgs A) {
  extern __shared__ float4 smem4[];
  const int h = A.K0 / 2, IH = kTile1H + 2 * h, IW = kTile1W + 2 * h;
  constexpr int S = CI + 4;
  float* tin = reinterpret_cast<float*>(smem4);
  float4* wbuf = smem4 + IH * IW * S / 4;
  const int bb = blockIdx.z / kSplit1, y0 = blockIdx.y * kTile1H,
            x0 = blockIdx.x * kTile1W;
  constexpr int kCo = kC1 / kSplit1;
  const int H = A.H, W = A.W;
  load_tile(tin, A.x + (int64_t)bb * H * W * CI, H, W, CI, S, y0 - h,
            x0 - h, IH, IW);
  float* p0 = A.p0 + (int64_t)bb * H * W * kC1;
  const float *a = A.a[0], *b = A.b[0];
  static_assert(kTile1H * kTile1W <= 16 * 1 * kWarps, "m-tiles");
  conv_stage<kCo, 4, 1, CI>(tin, IW, kTile1H, kTile1W, A.K0, A.K0,
                        A.w[0], kC1 / 8, blockIdx.z % kSplit1 * kCo / 8,
                        wbuf, [&](int oy, int ox, int co, float v) {
                          const int y = y0 + oy, x = x0 + ox;
                          if (y < H && x < W)
                            p0[((int64_t)y * W + x) * kC1 + co] =
                                affine_relu(v, a, b, co);
                        });
}

// Launch 2: 3x3 kC1 -> kC2 (p_out) on the tile and a 1-pixel halo, the 2x2
// maxpool of the tile, then the skip's 3x3 kC2 -> kC3 and 1x1 kC3 -> kC4.
constexpr int kT2InH = kTile2H + 4, kT2InW = kTile2W + 4, kT2InS = kC1 + 4;
constexpr int kT2PH = kTile2H + 2, kT2PW = kTile2W + 2, kT2PS = kC2 + 4;
constexpr int kT2SS = kC3 + 4;
constexpr int kT2WbufF4 = kStages * kC1 * kC2 * 2 / 4;  // hi and lo
constexpr int kT2Floats = kT2InH * kT2InW * kT2InS + kT2PH * kT2PW * kT2PS +
                          kTile2H * kTile2W * kT2SS;
static_assert(kT2Floats % 4 == 0, "wbuf alignment");

__global__ void __launch_bounds__(kThreads) head_second(HeadArgs A) {
  extern __shared__ float4 smem4[];
  float* tin = reinterpret_cast<float*>(smem4);
  float* tp = tin + kT2InH * kT2InW * kT2InS;
  float* ts = tp + kT2PH * kT2PW * kT2PS;
  float4* wbuf = smem4 + kT2Floats / 4;
  const int bb = blockIdx.z, Y0 = blockIdx.y * kTile2H,
            X0 = blockIdx.x * kTile2W;
  const int H = A.H, W = A.W;
  load_tile(tin, A.p0 + (int64_t)bb * H * W * kC1, H, W, kC1, kT2InS,
            Y0 - 2, X0 - 2, kT2InH, kT2InW);
  static_assert(kT2PH * kT2PW <= 16 * 1 * kWarps, "m-tiles");
  {
    const float *a = A.a[1], *b = A.b[1];
    conv_stage<kC2, 4, 1, kC1>(
        tin, kT2InW, kT2PH, kT2PW, 3, 3, A.w[1], kC2 / 8, 0, wbuf,
        [&](int oy, int ox, int co, float v) {
          const int y = Y0 - 1 + oy, x = X0 - 1 + ox;
          const bool in = y >= 0 && y < H && x >= 0 && x < W;
          tp[(oy * kT2PW + ox) * kT2PS + co] =
              in ? affine_relu(v, a, b, co) : 0.f;
        });
  }
  __syncthreads();
  // 2x2 maxpool of the tile (floor: only windows inside the map)
  for (int i = threadIdx.x; i < kTile2H / 2 * kTile2W / 2 * kC2;
       i += kThreads) {
    const int c = i % kC2, px = i / kC2;
    const int py = px / (kTile2W / 2), pxx = px % (kTile2W / 2);
    const int gy = Y0 / 2 + py, gx = X0 / 2 + pxx;
    if (gy < A.Hp && gx < A.Wp) {
      const float* q = tp + ((1 + 2 * py) * kT2PW + 1 + 2 * pxx) * kT2PS + c;
      const float m = fmaxf(fmaxf(q[0], q[kT2PS]),
                            fmaxf(q[kT2PW * kT2PS], q[(kT2PW + 1) * kT2PS]));
      A.pooled[(((int64_t)bb * A.Hp + gy) * A.Wp + gx) * kC2 + c] = m;
    }
  }
  static_assert(kTile2H * kTile2W <= 16 * 1 * (kWarps / 2), "m-tiles");
  {
    const float *a = A.a[2], *b = A.b[2];
    conv_stage<kC3, 2, 1, kC2>(tp, kT2PW, kTile2H, kTile2W, 3, 3, A.w[2],
                               kC3 / 8, 0, wbuf,
                               [&](int oy, int ox, int co, float v) {
                                 ts[(oy * kTile2W + ox) * kT2SS + co] =
                                     affine_relu(v, a, b, co);
                               });
  }
  {
    const float *a = A.a[3], *b = A.b[3];
    float* s = A.s + (int64_t)bb * H * W * kC4;
    conv_stage<kC4, 1, 1, kC3>(ts, kTile2W, kTile2H, kTile2W, 1, 1, A.w[3],
                               kC4 / 8, 0, wbuf,
                               [&](int oy, int ox, int co, float v) {
                                 const int y = Y0 + oy, x = X0 + ox;
                                 if (y < H && x < W)
                                   s[((int64_t)y * W + x) * kC4 + co] =
                                       affine_relu(v, a, b, co);
                               });
  }
}

// Launch 3: the trunk at half resolution, relu before each BN.
constexpr int kT3InH = kTile3H + 2, kT3InW = kTile3W + 2, kT3InS = kC2 + 4;
constexpr int kT3TS = kC5 + 4;
constexpr int kT3WbufF4 = kStages * kC2 * kC5 * 2 / 4;
constexpr int kT3Floats =
    kT3InH * kT3InW * kT3InS + kTile3H * kTile3W * kT3TS;
static_assert(kT3Floats % 4 == 0, "wbuf alignment");

__global__ void __launch_bounds__(kThreads) head_trunk(HeadArgs A) {
  extern __shared__ float4 smem4[];
  float* tin = reinterpret_cast<float*>(smem4);
  float* tt = tin + kT3InH * kT3InW * kT3InS;
  float4* wbuf = smem4 + kT3Floats / 4;
  const int bb = blockIdx.z, Y0 = blockIdx.y * kTile3H,
            X0 = blockIdx.x * kTile3W;
  const int Hp = A.Hp, Wp = A.Wp;
  load_tile(tin, A.pooled + (int64_t)bb * Hp * Wp * kC2, Hp, Wp, kC2, kT3InS,
            Y0 - 1, X0 - 1, kT3InH, kT3InW);
  static_assert(kTile3H * kTile3W <= 16 * 1 * (kWarps / 4), "m-tiles");
  {
    const float *a = A.a[4], *b = A.b[4];
    conv_stage<kC5, 1, 1, kC2>(
        tin, kT3InW, kTile3H, kTile3W, 3, 3, A.w[4], kC5 / 8, 0, wbuf,
        [&](int oy, int ox, int co, float v) {
          tt[(oy * kTile3W + ox) * kT3TS + co] =
              affine_relu(fmaxf(v, 0.f), a, b, co);
        });
  }
  {
    const float *a = A.a[5], *b = A.b[5];
    float* t = A.t + (int64_t)bb * Hp * Wp * kC6;
    conv_stage<kC6, 1, 1, kC5>(tt, kTile3W, kTile3H, kTile3W, 1, 1, A.w[5],
                               kC6 / 8, 0, wbuf,
                               [&](int oy, int ox, int co, float v) {
                                 const int y = Y0 + oy, x = X0 + ox;
                                 if (y < Hp && x < Wp)
                                   t[((int64_t)y * Wp + x) * kC6 + co] =
                                       affine_relu(fmaxf(v, 0.f), a, b, co);
                               });
  }
}

// Launch 4: bilinear resize of t to (H, W) as F.interpolate(align_corners=
// False) computes it, concat with s_out, 1x1 48 -> 1, affine, relu.
__global__ void __launch_bounds__(kPostThreads) head_post(HeadArgs A) {
  const int64_t i = (int64_t)blockIdx.x * kPostThreads + threadIdx.x;
  const int H = A.H, W = A.W, Hp = A.Hp, Wp = A.Wp;
  if (i >= (int64_t)A.B * H * W) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int bb = (int)(i / ((int64_t)H * W));
  const float sh = (float)Hp / (float)H, sw = (float)Wp / (float)W;
  const float fy = fmaxf(sh * ((float)y + 0.5f) - 0.5f, 0.f);
  const float fx = fmaxf(sw * ((float)x + 0.5f) - 0.5f, 0.f);
  const int y0 = (int)fy, x0 = (int)fx;
  const int y1 = y0 + (y0 < Hp - 1 ? 1 : 0), x1 = x0 + (x0 < Wp - 1 ? 1 : 0);
  const float ly1 = fy - (float)y0, ly0 = 1.f - ly1;
  const float lx1 = fx - (float)x0, lx0 = 1.f - lx1;
  const float* tb = A.t + (int64_t)bb * Hp * Wp * kC6;
  const float4* t00 = reinterpret_cast<const float4*>(
      tb + ((int64_t)y0 * Wp + x0) * kC6);
  const float4* t01 = reinterpret_cast<const float4*>(
      tb + ((int64_t)y0 * Wp + x1) * kC6);
  const float4* t10 = reinterpret_cast<const float4*>(
      tb + ((int64_t)y1 * Wp + x0) * kC6);
  const float4* t11 = reinterpret_cast<const float4*>(
      tb + ((int64_t)y1 * Wp + x1) * kC6);
  const float* w = A.wpost;
  float acc = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < kC6 / 4; ++c4) {
    const float4 q00 = __ldg(t00 + c4), q01 = __ldg(t01 + c4);
    const float4 q10 = __ldg(t10 + c4), q11 = __ldg(t11 + c4);
    const float v00[4] = {q00.x, q00.y, q00.z, q00.w};
    const float v01[4] = {q01.x, q01.y, q01.z, q01.w};
    const float v10[4] = {q10.x, q10.y, q10.z, q10.w};
    const float v11[4] = {q11.x, q11.y, q11.z, q11.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float up = ly0 * (lx0 * v00[e] + lx1 * v01[e]) +
                       ly1 * (lx0 * v10[e] + lx1 * v11[e]);
      acc = fmaf(__ldg(w + c4 * 4 + e), up, acc);
    }
  }
  const float4* s = reinterpret_cast<const float4*>(A.s + i * kC4);
#pragma unroll
  for (int c4 = 0; c4 < kC4 / 4; ++c4) {
    const float4 q = __ldg(s + c4);
    acc = fmaf(__ldg(w + kC6 + c4 * 4 + 0), q.x, acc);
    acc = fmaf(__ldg(w + kC6 + c4 * 4 + 1), q.y, acc);
    acc = fmaf(__ldg(w + kC6 + c4 * 4 + 2), q.z, acc);
    acc = fmaf(__ldg(w + kC6 + c4 * 4 + 3), q.w, acc);
  }
  A.out[i] = affine_relu(acc, A.a[6], A.b[6], 0);
}

size_t first_smem(int Ci, int K0) {
  const int h = K0 / 2;
  return sizeof(float) * ((size_t)(kTile1H + 2 * h) * (kTile1W + 2 * h) *
                              (Ci + 4) +
                          (size_t)kStages * Ci * (kC1 / kSplit1) * 2);
}
constexpr size_t kSecondSmem = sizeof(float) * (kT2Floats + 4 * kT2WbufF4);
constexpr size_t kTrunkSmem = sizeof(float) * (kT3Floats + 4 * kT3WbufF4);

}  // namespace

// Runs the head's four launches on `stream`. ptrs (device pointers, in
// order): x, the six packed weights, the final 1x1's 48 weights, a[7],
// b[7], then the buffers p0, s_out, pooled, t and out. Ci % 8 == 0,
// Ci <= 64, K0 odd <= 5, H, W >= 2 (the wrapper checks). Adds one to
// *launched for each kernel launched. Returns the first launch error (or
// cudaSuccess) as an int.
extern "C" int msfcn_head(const uint64_t* ptrs, int B, int H, int W, int Ci,
                          int K0, int* launched, void* stream) {
  if (Ci % 8 || Ci > kMaxCi || K0 % 2 == 0 || K0 > kMaxK0 || H < 2 ||
      W < 2 || B < 1 || B > 65535 / kSplit1)
    return (int)cudaErrorInvalidValue;
  HeadArgs A;
  int k = 0;
  A.x = (const float*)ptrs[k++];
  for (int i = 0; i < 6; ++i) A.w[i] = (const float4*)ptrs[k++];
  A.wpost = (const float*)ptrs[k++];
  for (int i = 0; i < 7; ++i) A.a[i] = (const float*)ptrs[k++];
  for (int i = 0; i < 7; ++i) A.b[i] = (const float*)ptrs[k++];
  A.p0 = (float*)ptrs[k++];
  A.s = (float*)ptrs[k++];
  A.pooled = (float*)ptrs[k++];
  A.t = (float*)ptrs[k++];
  A.out = (float*)ptrs[k++];
  A.B = B;
  A.H = H;
  A.W = W;
  A.K0 = K0;
  A.Hp = H / 2;
  A.Wp = W / 2;
  cudaStream_t st = (cudaStream_t)stream;
  // raise each kernel's shared-memory cap once (per process, per size)
  static bool set_rest = false;
  static size_t set_first[kMaxCi / 8 + 1] = {};
  const size_t s1 = first_smem(Ci, K0);
  cudaError_t err;
  if (!set_rest) {
    err = cudaFuncSetAttribute(head_second,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSecondSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        head_trunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kTrunkSmem);
    if (err != cudaSuccess) return (int)err;
    set_rest = true;
  }
  const dim3 grid1((W + kTile1W - 1) / kTile1W, (H + kTile1H - 1) / kTile1H,
                   B * kSplit1);
  switch (Ci) {
#define HEAD_FIRST(CI)                                                    \
  case CI:                                                                \
    if (s1 > set_first[CI / 8]) {                                         \
      err = cudaFuncSetAttribute(                                         \
          head_first<CI>, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
          (int)s1);                                                       \
      if (err != cudaSuccess) return (int)err;                            \
      set_first[CI / 8] = s1;                                             \
    }                                                                     \
    head_first<CI><<<grid1, kThreads, s1, st>>>(A);                       \
    break;
    HEAD_FIRST(8)
    HEAD_FIRST(16)
    HEAD_FIRST(24)
    HEAD_FIRST(32)
    HEAD_FIRST(40)
    HEAD_FIRST(48)
    HEAD_FIRST(56)
    HEAD_FIRST(64)
#undef HEAD_FIRST
    default:
      return (int)cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  head_second<<<dim3((W + kTile2W - 1) / kTile2W,
                     (H + kTile2H - 1) / kTile2H, B),
                kThreads, kSecondSmem, st>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  head_trunk<<<dim3((A.Wp + kTile3W - 1) / kTile3W,
                    (A.Hp + kTile3H - 1) / kTile3H, B),
               kThreads, kTrunkSmem, st>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  const int64_t n = (int64_t)B * H * W;
  head_post<<<(unsigned)((n + kPostThreads - 1) / kPostThreads), kPostThreads,
              0, st>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return (int)cudaSuccess;
}

extern "C" const char* msfcn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
