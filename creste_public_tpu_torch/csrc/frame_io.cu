// Camera-frame decode for the CODa reader on the card: nvJPEG decodes the
// JPEG into its Y, Cb, Cr planes on the card, and one hand-written kernel
// assembles the RGBD sample from them: the RGB PIL decodes, resized as
// Pillow resizes it.
//
// Replaces no TPU kernel. It is the card's counterpart of the JAX package's
// native decode core (native/creste_io.cpp:40-189: jpeg_decode and the
// fused assemble_rgbd), fused with the reader's PIL resize
// (creste_public_tpu/data/coda_dataset.py `_resized`): BILINEAR for the
// RGB, NEAREST for the depth.
//
// nvJPEG. One handle per process, made at first use; each decoder runs
// nvJPEG's decoupled API (parse, host phase, transfer, device phase) with
// the backend kBackend, one constant, never switched. GPU_HYBRID decodes
// the Huffman stream on the card, off the host. (The hardware backend,
// the H100's NVJPG engines, is refused on the card's machine with
// NVJPEG_STATUS_ARCH_MISMATCH.) A caller owns a frame_decoder (a decoder,
// its state, a JPEG stream, decode parameters, a pinned and a device
// buffer), one per thread that decodes at a time: ctypes drops the GIL, so
// loader threads call concurrently. nvJPEG writes the planes (YUV output:
// the chroma at the file's subsampling) into the caller's device buffers,
// on the caller's stream. Its own RGB output upsamples the chroma
// otherwise than libjpeg: 6.4 to 7.2 levels from PIL's on average on
// noisy frames (PERF.md), so the kernel converts the planes itself.
//
// assemble_rgbd. The RGB of an input pixel is libjpeg-turbo's, which PIL
// runs: the chroma "fancy" upsampled (jdsample.c h2v2_fancy_upsample and
// h2v1_fancy_upsample: per axis 3/4 of the nearer sample and 1/4 of the
// further, edges repeated, rounding biases 8/7 and 1/2 alternating by
// column), then ycc_rgb_convert's fixed point (jdcolor.c: 16 fractional
// bits, arithmetic right shifts, clamped). The resize is Pillow's
// (Resample.c, 8 bits per channel): a horizontal pass, then a vertical
// pass over its uint8 result, each output
// value the fixed-point sum 2^21 + sum_i in_i * k_i with integer weights k
// of 22 fractional bits, shifted right by 22 and clipped to 0..255. The
// weights and their windows (bounds: first input, count) come from the
// host (ops/frame_kernel.py bilinear_coeffs), computed in doubles as
// Pillow's precompute_coeffs and normalize_coeffs_8bpc compute them. An
// axis that is not resized has the weights [2^22, 0], which give the
// input back, as Pillow's skipped pass does. RGB is written as value /
// 255 in f32, rounded once (numpy's division of the uint8 image). The
// depth channel is the uint16 depth (mm) at the NEAREST row and column
// tables, also from the host, or 0 without a depth map
// (native/creste_io.cpp:158). Out: [h, w, 4] f32.
//
// Design: one block of 512 threads per tile of th x tw outputs (the host's
// plan, ops/frame_kernel.py tile_plan: 20 x 64 at the reader's 1024x1224 ->
// 512x612, 260 blocks, at most 2 on an SM and all resident at once; 16 x 64
// put 3 blocks on some SMs). Pillow's windows are monotone in the output
// index, so a tile's inputs are one rectangle: from its first output's
// window start to its last one's end on each axis, plus the one-sample
// chroma halo that fancy upsampling reads, clamped at the plane's edges. The
// host computes these extents once per resize (int32 per tile row and
// column) and the shared-memory layout. A block (1) stages its luma and
// chroma rectangles in shared memory by 16-byte cp.async chunks (a staged
// row starts at the aligned address at or below its first byte: rows of 1224
// bytes are 8-byte aligned), with the tile's weights and a table of v / 255
// rounded by __fdiv_rn, then loads its outputs' depth values into registers,
// used at the end; (2) converts every luma pixel of its rectangle to RGB
// once, each thread walking a chroma column with the 3 x 3 chroma samples it
// reads kept in registers; (3) runs the horizontal pass once per (input row,
// output column) into uint8, the first kRegTaps weights of its column in
// registers and the RGB rows kept even columns first, so that a warp's loads
// hit distinct banks at 2x; (4) runs the vertical pass per output and writes
// one float4 per pixel with a streaming store. Integer arithmetic
// throughout, so the result equals the plain version (ops/frame_kernel.py)
// to the bit whatever the tiling; an int32 accumulator holds 255 * (2^22 +
// rounding) + 2^21. A strong downscale widens the windows: the host takes a
// smaller tile, down to one output, and refuses before any launch a resize
// whose single window does not fit a block's 227 KB.
//
// What bounds it on an H100: at 1024x1224 (4:2:0) -> 512x612 it reads the
// 1.25 MB luma and 0.63 MB chroma planes and 1.25 MB of depth rows
// (NEAREST reads every second row) and writes 5.01 MB: 8.15 MB, 2.43 us at
// 3.35 TB/s. Its ~83 M integer operations (frame_bound's count) take 1.23
// us at the f32 CUDA-core rate. The earlier kernel, a thread per output,
// converted each input pixel about 4 times and ran each input row's
// horizontal pass twice (~250 M operations): instruction-bound at 22.7 us.
// Here a tile re-reads only its halo (42 input rows and 130 columns for 20
// x 64 outputs), and the time goes to the staging round trips (the
// extents, then the planes) and the conversion's instruction rate (PERF.md).
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <cstring>
#include <mutex>

namespace {

constexpr nvjpegBackend_t kBackend = NVJPEG_BACKEND_GPU_HYBRID;
constexpr const char* kBackendName = "NVJPEG_BACKEND_GPU_HYBRID";
constexpr int kPrecisionBits = 22;  // Pillow's 32 - 8 - 2
// libjpeg's FIX(1.40200), FIX(1.77200), FIX(0.34414), FIX(0.71414)
constexpr int kCrR = 91881, kCbB = 116130, kCbG = 22554, kCrG = 46802;
constexpr int kHalf = 1 << (kPrecisionBits - 1);
constexpr int kThreads = 512;     // TILE_THREADS
constexpr int kOutPerThread = 4;  // OUT_PER_THREAD
constexpr int kMaxSharedBytes = 232448;  // SMEM_BUDGET
// the taps of a window held in registers by the resize's passes (the rest,
// of a strong downscale's wider windows, read from shared memory)
constexpr int kRegTaps = 8;
// error codes beside cudaError_t's: nvJPEG's status + kNvjpegBase, and
// a handle made for another card
constexpr int kNvjpegBase = 1000;
constexpr int kOtherDevice = 2000;

std::once_flag g_once;
nvjpegHandle_t g_handle = nullptr;
int g_device = -1;
int g_create_error = 0;

int nvjpeg_error(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_SUCCESS ? 0 : kNvjpegBase + (int)s;
}

// the process's handle, made on `device` at the first call
int handle_for(int device, nvjpegHandle_t* out) {
  std::call_once(g_once, [device] {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) {
      g_create_error = (int)e;
      return;
    }
    g_create_error = nvjpeg_error(nvjpegCreateEx(
        NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, 0, &g_handle));
    g_device = device;
  });
  if (g_create_error) return g_create_error;
  if (device != g_device) return kOtherDevice;
  *out = g_handle;
  return 0;
}

struct FrameDecoder {
  int device;
  nvjpegJpegDecoder_t decoder;
  nvjpegJpegState_t state;
  nvjpegJpegStream_t stream;
  nvjpegDecodeParams_t params;
  nvjpegBufferPinned_t pinned;
  nvjpegBufferDevice_t buffer;
};

void destroy(FrameDecoder* d) {
  if (d->buffer) nvjpegBufferDeviceDestroy(d->buffer);
  if (d->pinned) nvjpegBufferPinnedDestroy(d->pinned);
  if (d->params) nvjpegDecodeParamsDestroy(d->params);
  if (d->stream) nvjpegJpegStreamDestroy(d->stream);
  if (d->state) nvjpegJpegStateDestroy(d->state);
  if (d->decoder) nvjpegDecoderDestroy(d->decoder);
  delete d;
}

__device__ __forceinline__ int clip8(int v) {
  v >>= kPrecisionBits;
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

struct Planes {
  const uint8_t* y;
  const uint8_t* cb;
  const uint8_t* cr;
  int H, W, ch, cw;  // luma and chroma sizes
};

// Byte offsets in shared memory and the tile, as ops/frame_kernel.py
// tile_plan lays them out (PLAN_FIELDS, in this order; the luma rows at 0)
struct Layout {
  int th, tw, luma_pitch, chroma_pitch, rgb_pitch;
  int cb, cr, rgb, hbuf, hk, hb, vk, vb, nearest, lut, bytes;
};

// The offset within its staged row of a plane's byte (r, col0): a staged
// row holds the 16-byte chunks from the aligned address at or below it
__device__ __forceinline__ int lead(const uint8_t* plane, int pitch, int r,
                                    int col0) {
  return (int)(reinterpret_cast<uintptr_t>(plane + (size_t)r * pitch + col0) &
               15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <int N>  // 4 or 8 bytes
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N));
}

// Rows [row0, row0 + nrows) x columns [col0, col0 + ncols) of a plane
// (`bytes` long, rows `pitch` apart) into shared memory, `spitch` bytes a
// row: 16-byte cp.async chunks, bytes one by one only where a chunk would
// cross the plane's first or last byte
__device__ void stage_plane(uint8_t* dst, int spitch, const uint8_t* plane,
                            int pitch, size_t bytes, int row0, int nrows,
                            int col0, int ncols) {
  const int nq = spitch / 16;
  const uintptr_t first = reinterpret_cast<uintptr_t>(plane);
  const uintptr_t end = first + bytes;
  for (int i = threadIdx.x; i < nrows * nq; i += kThreads) {
    const int rr = i / nq, q = i - rr * nq;
    const uintptr_t g =
        reinterpret_cast<uintptr_t>(plane + (size_t)(row0 + rr) * pitch + col0);
    const uintptr_t a = (g & ~(uintptr_t)15) + 16 * q;
    if (a >= g + ncols) continue;  // past the row's last wanted byte
    uint8_t* s = dst + rr * spitch + 16 * q;
    if (a >= first && a + 16 <= end) {
      cp_async16(s, reinterpret_cast<const void*>(a));
    } else {
      for (int k = 0; k < 16; ++k)
        if (a + k >= first && a + k < end)
          s[k] = *reinterpret_cast<const uint8_t*>(a + k);
    }
  }
}

// The word of a staged RGB row (`pitch` words) that holds column c of the
// extent: the even columns first, then the odd ones, so that the lanes of
// a warp, a column each, read and write consecutive words at 2x
__device__ __forceinline__ int rgb_column(int c, int pitch) {
  return (c & 1) * ((pitch + 1) >> 1) + (c >> 1);
}

// libjpeg's ycc_rgb_convert of one pixel, packed R | G << 8 | B << 16
__device__ __forceinline__ uint32_t ycc_rgb(int y, int cb, int cr) {
  const int b = cb - 128, c = cr - 128;
  const int R = clamp255(y + ((kCrR * c + (1 << 15)) >> 16));
  const int G = clamp255(y + (((1 << 15) - kCbG * b - kCrG * c) >> 16));
  const int B = clamp255(y + ((kCbB * b + (1 << 15)) >> 16));
  return (uint32_t)R | (uint32_t)G << 8 | (uint32_t)B << 16;
}

// Every luma pixel of the tile's extent to RGB, once, from the staged
// planes: libjpeg-turbo's fancy upsampling (h2v2 / h2v1; SH, SV the chroma
// factors) and ycc_rgb_convert. A thread owns a chroma column cx (the SH
// luma columns over it) and walks a run of chroma rows down it, keeping
// the chroma samples it reads in registers: the columns cx - 1, cx, cx + 1
// (clamped at the plane's edges) of the rows cy - 1, cy, cy + 1 (clamped).
template <int SH, int SV>
__device__ void convert_tile(const Planes& p, const Layout& L, uint8_t* smem,
                             int4 re, int4 ce) {
  const uint8_t* sy = smem;
  const uint8_t* sb = smem + L.cb;
  const uint8_t* sr = smem + L.cr;
  uint32_t* rgb = reinterpret_cast<uint32_t*>(smem + L.rgb);
  const int cy0 = re.x / SV, cy1 = (re.y - 1) / SV + 1;
  const int cx0 = ce.x / SH, cx1 = (ce.y - 1) / SH + 1;
  const int ncx = cx1 - cx0, ncy = cy1 - cy0;
  // as many runs per column as the block's threads allow: one round
  const int runs = max(1, min(ncy, kThreads / ncx));
  const int run = (ncy + runs - 1) / runs;
  const int tasks = ncx * ((ncy + run - 1) / run);
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int cx = cx0 + task % ncx;
    const int ya = cy0 + (task / ncx) * run, yb = min(ya + run, cy1);
    const int xl = SH == 2 ? max(cx - 1, 0) : cx;
    const int xr = SH == 2 ? min(cx + 1, p.cw - 1) : cx;
    // [row: cy - 1, cy, cy + 1][column: xl, cx, xr]
    int b[3][3] = {}, c[3][3] = {};
    auto fetch = [&](int cy, int k) {
      const int ob = (cy - re.z) * L.chroma_pitch +
                     lead(p.cb, p.cw, cy, ce.z) - ce.z;
      const int oc = (cy - re.z) * L.chroma_pitch +
                     lead(p.cr, p.cw, cy, ce.z) - ce.z;
      b[k][1] = sb[ob + cx];
      c[k][1] = sr[oc + cx];
      if (SH == 2) {
        b[k][0] = sb[ob + xl];
        b[k][2] = sb[ob + xr];
        c[k][0] = sr[oc + xl];
        c[k][2] = sr[oc + xr];
      }
    };
    if (SV == 2) fetch(max(ya - 1, 0), 0);
    fetch(ya, 1);
    for (int cy = ya; cy < yb; ++cy) {
      if (SV == 2) fetch(min(cy + 1, p.ch - 1), 2);
#pragma unroll
      for (int dy = 0; dy < SV; ++dy) {
        const int r = cy * SV + dy;
        if (r < re.x || r >= re.y) continue;
        // the chroma columns blended down to this luma row
        int sbv[3], scv[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          sbv[j] = SV == 2 ? 3 * b[1][j] + b[dy ? 2 : 0][j] : b[1][j];
          scv[j] = SV == 2 ? 3 * c[1][j] + c[dy ? 2 : 0][j] : c[1][j];
        }
        const int oy = (r - re.x) * L.luma_pitch + lead(p.y, p.W, r, ce.x) -
                       ce.x;
        uint32_t* row = rgb + (r - re.x) * L.rgb_pitch;
#pragma unroll
        for (int dx = 0; dx < SH; ++dx) {
          const int x = cx * SH + dx;
          if (x < ce.x || x >= ce.y) continue;
          int vb, vc;
          if (SH == 1) {
            vb = sbv[1];
            vc = scv[1];
          } else if (SV == 1) {  // h2v1: 3/4 near, 1/4 far, bias 1 or 2
            vb = (3 * sbv[1] + sbv[dx ? 2 : 0] + 1 + dx) >> 2;
            vc = (3 * scv[1] + scv[dx ? 2 : 0] + 1 + dx) >> 2;
          } else {  // h2v2: bias 8 or 7
            vb = (3 * sbv[1] + sbv[dx ? 2 : 0] + 8 - dx) >> 4;
            vc = (3 * scv[1] + scv[dx ? 2 : 0] + 8 - dx) >> 4;
          }
          row[rgb_column(x - ce.x, L.rgb_pitch)] =
              ycc_rgb(sy[oy + x], vb, vc);
        }
      }
      if (SV == 2) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          b[0][j] = b[1][j];
          b[1][j] = b[2][j];
          c[0][j] = c[1][j];
          c[1][j] = c[2][j];
        }
      } else {
        if (cy + 1 < yb) fetch(cy + 1, 1);
      }
    }
  }
}

// One block per tile of L.th x L.tw outputs (blockIdx.y the tile row,
// blockIdx.x the tile column; re and ce their extents from the host:
// luma [x, y), chroma [z, w)). 1. Stage the planes' extents, the tile's
// weights and v / 255 in shared memory; prefetch the tile's depth values
// into registers. 2. Every luma pixel of the extent to RGB, once. 3.
// Pillow's horizontal pass once per (input row of the extent, output
// column) into uint8. 4. The vertical pass per output, / 255 and the depth,
// one float4 per pixel.
template <int SH, int SV>
__global__ void __launch_bounds__(kThreads, 2) assemble_rgbd_kernel(
    const Planes p, const uint16_t* __restrict__ depth,
    const int* __restrict__ hbounds, const int* __restrict__ hweights, int kh,
    const int* __restrict__ vbounds, const int* __restrict__ vweights, int kv,
    const int* __restrict__ rows, const int* __restrict__ cols,
    const int4* __restrict__ tile_rows, const int4* __restrict__ tile_cols,
    const Layout L, float4* __restrict__ out, int h, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int4 re = tile_rows[blockIdx.y], ce = tile_cols[blockIdx.x];
  const int y0 = blockIdx.y * L.th, x0 = blockIdx.x * L.tw;
  const int th = min(L.th, h - y0), tw = min(L.tw, w - x0);
  const int nr = re.y - re.x;  // input rows of the extent
  // 1. stage
  stage_plane(smem, L.luma_pitch, p.y, p.W, (size_t)p.H * p.W, re.x, nr,
              ce.x, ce.y - ce.x);
  stage_plane(smem + L.cb, L.chroma_pitch, p.cb, p.cw, (size_t)p.ch * p.cw,
              re.z, re.w - re.z, ce.z, ce.w - ce.z);
  stage_plane(smem + L.cr, L.chroma_pitch, p.cr, p.cw, (size_t)p.ch * p.cw,
              re.z, re.w - re.z, ce.z, ce.w - ce.z);
  // the tile's weights, windows and NEAREST rows and columns, copied as
  // they are: hk [kh][L.tw], vk [kv][L.th], hb and vb (window start,
  // count) per column and row, nr [th], nc [tw]
  int* hk = reinterpret_cast<int*>(smem + L.hk);
  int2* hb = reinterpret_cast<int2*>(smem + L.hb);
  int* vk = reinterpret_cast<int*>(smem + L.vk);
  int2* vb = reinterpret_cast<int2*>(smem + L.vb);
  int* near_r = reinterpret_cast<int*>(smem + L.nearest);
  int* near_c = near_r + L.th;
  for (int i = threadIdx.x; i < kh * tw; i += kThreads) {
    const int x = i % tw, k = i / tw;
    cp_async<4>(hk + k * L.tw + x, hweights + (size_t)(x0 + x) * kh + k);
  }
  for (int i = threadIdx.x; i < kv * th; i += kThreads) {
    const int y = i % th, k = i / th;
    cp_async<4>(vk + k * L.th + y, vweights + (size_t)(y0 + y) * kv + k);
  }
  for (int x = threadIdx.x; x < tw; x += kThreads) {
    cp_async<8>(hb + x, hbounds + 2 * (x0 + x));
    cp_async<4>(near_c + x, cols + x0 + x);
  }
  for (int y = threadIdx.x; y < th; y += kThreads) {
    cp_async<8>(vb + y, vbounds + 2 * (y0 + y));
    cp_async<4>(near_r + y, rows + y0 + y);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  float* lut = reinterpret_cast<float*>(smem + L.lut);
  for (int i = threadIdx.x; i < 256; i += kThreads)
    lut[i] = __fdiv_rn((float)i, 255.0f);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // a thread's outputs: column xx, rows yy0 + m * lanes; their depth
  // values loaded now, used at the end
  const int lanes = kThreads / L.tw;
  const int xx = threadIdx.x % L.tw, yy0 = threadIdx.x / L.tw;
  uint16_t dep[kOutPerThread];
#pragma unroll
  for (int m = 0; m < kOutPerThread; ++m) {
    const int yy = yy0 + m * lanes;
    dep[m] = depth && xx < tw && yy < th
                 ? depth[(size_t)near_r[yy] * p.W + near_c[xx]]
                 : (uint16_t)0;
  }
  // 2. to RGB
  convert_tile<SH, SV>(p, L, smem, re, ce);
  __syncthreads();
  // 3. the horizontal pass
  const uint32_t* rgb = reinterpret_cast<const uint32_t*>(smem + L.rgb);
  uint32_t* hbuf = reinterpret_cast<uint32_t*>(smem + L.hbuf);  // [nr][L.tw]
  if (xx < tw) {
    const int start = hb[xx].x - ce.x, n = hb[xx].y;
    int k[kRegTaps];
#pragma unroll
    for (int i = 0; i < kRegTaps; ++i) k[i] = i < n ? hk[i * L.tw + xx] : 0;
    for (int rr = yy0; rr < nr; rr += lanes) {
      // tap i at a + i / 2 (i even) or b + i / 2 (i odd)
      const uint32_t* row = rgb + rr * L.rgb_pitch;
      const uint32_t* a = row + rgb_column(start, L.rgb_pitch);
      const uint32_t* b = row + rgb_column(start + 1, L.rgb_pitch);
      int t0 = kHalf, t1 = kHalf, t2 = kHalf;
#pragma unroll
      for (int i = 0; i < kRegTaps; ++i) {
        if (i < n) {
          const uint32_t v = (i & 1 ? b : a)[i / 2];
          t0 += (int)(v & 255) * k[i];
          t1 += (int)((v >> 8) & 255) * k[i];
          t2 += (int)(v >> 16) * k[i];
        }
      }
      for (int i = kRegTaps; i < n; ++i) {
        const uint32_t v = (i & 1 ? b : a)[i / 2];
        const int kk = hk[i * L.tw + xx];
        t0 += (int)(v & 255) * kk;
        t1 += (int)((v >> 8) & 255) * kk;
        t2 += (int)(v >> 16) * kk;
      }
      hbuf[rr * L.tw + xx] = (uint32_t)clip8(t0) |
                             (uint32_t)clip8(t1) << 8 |
                             (uint32_t)clip8(t2) << 16;
    }
  }
  __syncthreads();
  // 4. the vertical pass and the store
#pragma unroll
  for (int m = 0; m < kOutPerThread; ++m) {
    const int yy = yy0 + m * lanes;
    if (xx >= tw || yy >= th) continue;
    const int start = vb[yy].x - re.x, n = vb[yy].y;
    const uint32_t* src = hbuf + start * L.tw + xx;
    int s0 = kHalf, s1 = kHalf, s2 = kHalf;
#pragma unroll
    for (int j = 0; j < kRegTaps; ++j) {
      if (j < n) {
        const uint32_t v = src[j * L.tw];
        const int kk = vk[j * L.th + yy];
        s0 += (int)(v & 255) * kk;
        s1 += (int)((v >> 8) & 255) * kk;
        s2 += (int)(v >> 16) * kk;
      }
    }
    for (int j = kRegTaps; j < n; ++j) {
      const uint32_t v = src[j * L.tw];
      const int kk = vk[j * L.th + yy];
      s0 += (int)(v & 255) * kk;
      s1 += (int)((v >> 8) & 255) * kk;
      s2 += (int)(v >> 16) * kk;
    }
    __stcs(out + (size_t)(y0 + yy) * w + x0 + xx,
           make_float4(lut[clip8(s0)], lut[clip8(s1)], lut[clip8(s2)],
                       (float)dep[m]));
  }
}

}  // namespace

extern "C" const char* frame_backend_name(void) { return kBackendName; }

// A decoder on `device` (kBackend, RGBI output, its buffers attached);
// the handle is made at the first call of the process.
extern "C" int frame_decoder_create(int device, void** out) {
  nvjpegHandle_t h;
  int err = handle_for(device, &h);
  if (err) return err;
  FrameDecoder* d = new FrameDecoder{device};
  err = nvjpeg_error(nvjpegDecoderCreate(h, kBackend, &d->decoder));
  if (!err)
    err = nvjpeg_error(nvjpegDecoderStateCreate(h, d->decoder, &d->state));
  if (!err) err = nvjpeg_error(nvjpegJpegStreamCreate(h, &d->stream));
  if (!err) err = nvjpeg_error(nvjpegDecodeParamsCreate(h, &d->params));
  if (!err)
    err = nvjpeg_error(
        nvjpegDecodeParamsSetOutputFormat(d->params, NVJPEG_OUTPUT_YUV));
  if (!err)
    err = nvjpeg_error(nvjpegBufferPinnedCreate(h, nullptr, &d->pinned));
  if (!err)
    err = nvjpeg_error(nvjpegBufferDeviceCreate(h, nullptr, &d->buffer));
  if (!err)
    err = nvjpeg_error(nvjpegStateAttachPinnedBuffer(d->state, d->pinned));
  if (!err)
    err = nvjpeg_error(nvjpegStateAttachDeviceBuffer(d->state, d->buffer));
  if (err) {
    destroy(d);
    return err;
  }
  *out = d;
  return 0;
}

extern "C" int frame_decoder_destroy(void* decoder) {
  destroy(static_cast<FrameDecoder*>(decoder));
  return 0;
}

// info = (height, width, components, the chroma planes' height and
// width) of a JPEG's bytes
extern "C" int frame_jpeg_info(int device, const void* data, size_t length,
                               int* info) {
  nvjpegHandle_t handle;
  int err = handle_for(device, &handle);
  if (err) return err;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t sub;
  err = nvjpeg_error(nvjpegGetImageInfo(
      handle, static_cast<const unsigned char*>(data), length, &info[2],
      &sub, widths, heights));
  if (err) return err;
  info[0] = heights[0];
  info[1] = widths[0];
  info[3] = heights[1];
  info[4] = widths[1];
  return 0;
}

// Decode a JPEG's bytes (host memory) into its planes on the card: y
// [h, W] at pitch W, cb and cr [ch, cw] at pitch cw, uint8, on `stream`.
extern "C" int frame_jpeg_decode(void* decoder, const void* data,
                                 size_t length, void* y, void* cb, void* cr,
                                 int W, int cw, void* stream) {
  FrameDecoder* d = static_cast<FrameDecoder*>(decoder);
  nvjpegHandle_t handle;
  int err = handle_for(d->device, &handle);
  if (err) return err;
  cudaError_t e = cudaSetDevice(d->device);
  if (e != cudaSuccess) return (int)e;
  nvjpegImage_t image = {};
  image.channel[0] = static_cast<unsigned char*>(y);
  image.channel[1] = static_cast<unsigned char*>(cb);
  image.channel[2] = static_cast<unsigned char*>(cr);
  image.pitch[0] = W;
  image.pitch[1] = image.pitch[2] = cw;
  // the pinned buffer is free: the caller waits for its stream after each
  // frame
  err = nvjpeg_error(nvjpegJpegStreamParse(
      handle, static_cast<const unsigned char*>(data), length, 0, 0,
      d->stream));
  if (!err)
    err = nvjpeg_error(nvjpegDecodeJpegHost(handle, d->decoder, d->state,
                                            d->params, d->stream));
  if (!err)
    err = nvjpeg_error(nvjpegDecodeJpegTransferToDevice(
        handle, d->decoder, d->state, d->stream, (cudaStream_t)stream));
  if (!err)
    err = nvjpeg_error(nvjpegDecodeJpegDevice(handle, d->decoder, d->state,
                                              &image, (cudaStream_t)stream));
  return err;
}

// out [h, w, 4] f32 from the planes y [H, W], cb and cr [ch, cw] (uint8,
// chroma subsampled by sh horizontally and sv vertically: 1 or 2) and
// depth [H, W] uint16 (or null), with the tables of ops/frame_kernel.py:
// hbounds [w, 2], hweights [w, kh], vbounds [h, 2], vweights [h, kv],
// rows [h], cols [w], tile_rows [ceil(h / th), 4], tile_cols [ceil(w /
// tw), 4] (int32, on the card) and the plan's layout (int32 in Layout's
// order, on the host). One launch on `stream`.
extern "C" int frame_assemble_rgbd(const void* y, const void* cb,
                                   const void* cr, int H, int W, int ch,
                                   int cw, int sh, int sv, const void* depth,
                                   const void* hbounds, const void* hweights,
                                   int kh, const void* vbounds,
                                   const void* vweights, int kv,
                                   const void* rows, const void* cols,
                                   const void* tile_rows,
                                   const void* tile_cols, const int* plan,
                                   void* out, int h, int w, void* stream) {
  Layout L;
  memcpy(&L, plan, sizeof(L));
  if (H < 1 || W < 1 || ch < 1 || cw < 1 || h < 1 || w < 1 || kh < 1 ||
      kv < 1 || sh < 1 || sh > 2 || sv < 1 || sv > sh || L.th < 1 ||
      L.tw < 1 || kThreads % L.tw || L.th * L.tw > kThreads * kOutPerThread ||
      L.bytes < 1 || L.bytes > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  const Planes p = {static_cast<const uint8_t*>(y),
                    static_cast<const uint8_t*>(cb),
                    static_cast<const uint8_t*>(cr), H, W, ch, cw};
  auto kernel = sh == 1   ? assemble_rgbd_kernel<1, 1>
                : sv == 1 ? assemble_rgbd_kernel<2, 1>
                          : assemble_rgbd_kernel<2, 2>;
  if (L.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((w + L.tw - 1) / L.tw, (h + L.th - 1) / L.th);
  kernel<<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(
      p, static_cast<const uint16_t*>(depth),
      static_cast<const int*>(hbounds), static_cast<const int*>(hweights), kh,
      static_cast<const int*>(vbounds), static_cast<const int*>(vweights), kv,
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const int4*>(tile_rows), static_cast<const int4*>(tile_cols),
      L, static_cast<float4*>(out), h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* frame_error_string(int err) {
  if (err == kOtherDevice)
    return "the process's nvJPEG handle was made for another card";
  if (err < kNvjpegBase) return cudaGetErrorString((cudaError_t)err);
  switch (err - kNvjpegBase) {
    case NVJPEG_STATUS_NOT_INITIALIZED: return "NVJPEG_STATUS_NOT_INITIALIZED";
    case NVJPEG_STATUS_INVALID_PARAMETER:
      return "NVJPEG_STATUS_INVALID_PARAMETER";
    case NVJPEG_STATUS_BAD_JPEG: return "NVJPEG_STATUS_BAD_JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
      return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE:
      return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
    case NVJPEG_STATUS_EXECUTION_FAILED:
      return "NVJPEG_STATUS_EXECUTION_FAILED";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "NVJPEG_STATUS_ARCH_MISMATCH";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "NVJPEG_STATUS_INTERNAL_ERROR";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
    default: return "an nvJPEG status without a name here";
  }
}
