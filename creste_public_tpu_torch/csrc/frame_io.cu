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
// Design: one thread per output pixel. It converts each input pixel of
// its window to RGB and recomputes the horizontal pass's uint8 value for
// each input row of the window, then sums them vertically: integer
// arithmetic only, so the result equals the plain version
// (ops/frame_kernel.py) to the bit. An int32 accumulator holds 255 * (2^22
// + rounding) + 2^21.
//
// What bounds it on an H100: at 1024x1224 (4:2:0) -> 512x612 it reads the
// 1.25 MB luma and 0.63 MB chroma planes and 1.25 MB of depth rows
// (NEAREST reads every second row) and writes 5.01 MB: 8.15 MB, 2.43 us at
// 3.35 TB/s. Its ~83 M integer operations (the conversion once per input
// pixel, the resize's multiply-adds) take 1.23 us at the f32 CUDA-core
// rate. Each input pixel is converted by the ~4 threads whose windows
// hold it; L1 and L2 serve the repeated reads.
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr nvjpegBackend_t kBackend = NVJPEG_BACKEND_GPU_HYBRID;
constexpr const char* kBackendName = "NVJPEG_BACKEND_GPU_HYBRID";
constexpr int kPrecisionBits = 22;  // Pillow's 32 - 8 - 2
// libjpeg's FIX(1.40200), FIX(1.77200), FIX(0.34414), FIX(0.71414)
constexpr int kCrR = 91881, kCbB = 116130, kCbG = 22554, kCrG = 46802;
constexpr int kHalf = 1 << (kPrecisionBits - 1);
constexpr int kThreads = 128;
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
  int W, cw, ch, sh, sv;  // luma width, chroma size, subsampling factors
};

// libjpeg-turbo's fancy-upsampled chroma at luma pixel (r, x)
__device__ __forceinline__ int chroma(const uint8_t* c, const Planes& p,
                                      int r, int x) {
  const int cy = p.sv == 2 ? r >> 1 : r;
  const int cx = p.sh == 2 ? x >> 1 : x;
  if (p.sh == 1) return c[cy * p.cw + cx];  // 4:4:4
  const int odd = x & 1;
  const int nx = odd ? min(cx + 1, p.cw - 1) : max(cx - 1, 0);
  if (p.sv == 1)  // 4:2:2
    return (3 * c[cy * p.cw + cx] + c[cy * p.cw + nx] + 1 + odd) >> 2;
  const int ny = (r & 1) ? min(cy + 1, p.ch - 1) : max(cy - 1, 0);
  const int s0 = 3 * c[cy * p.cw + cx] + c[ny * p.cw + cx];
  const int s1 = 3 * c[cy * p.cw + nx] + c[ny * p.cw + nx];
  return (3 * s0 + s1 + 8 - odd) >> 4;  // 4:2:0
}

// libjpeg's ycc_rgb_convert at luma pixel (r, x)
__device__ __forceinline__ void rgb_at(const Planes& p, int r, int x,
                                       int& R, int& G, int& B) {
  const int y = p.y[r * p.W + x];
  const int b = chroma(p.cb, p, r, x) - 128;
  const int c = chroma(p.cr, p, r, x) - 128;
  R = clamp255(y + ((kCrR * c + (1 << 15)) >> 16));
  G = clamp255(y + (((1 << 15) - kCbG * b - kCrG * c) >> 16));
  B = clamp255(y + ((kCbB * b + (1 << 15)) >> 16));
}

__global__ void __launch_bounds__(kThreads) assemble_rgbd_kernel(
    const Planes p, const uint16_t* __restrict__ depth,
    const int* __restrict__ hbounds, const int* __restrict__ hweights, int kh,
    const int* __restrict__ vbounds, const int* __restrict__ vweights, int kv,
    const int* __restrict__ rows, const int* __restrict__ cols,
    float4* __restrict__ out, int w) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int x0 = hbounds[2 * x], nx = hbounds[2 * x + 1];
  const int y0 = vbounds[2 * y], ny = vbounds[2 * y + 1];
  const int* kx = hweights + (size_t)x * kh;
  const int* ky = vweights + (size_t)y * kv;
  int s0 = kHalf, s1 = kHalf, s2 = kHalf;
  for (int j = 0; j < ny; ++j) {
    int t0 = kHalf, t1 = kHalf, t2 = kHalf;
    for (int i = 0; i < nx; ++i) {
      int R, G, B;
      rgb_at(p, y0 + j, x0 + i, R, G, B);
      const int k = kx[i];
      t0 += R * k;
      t1 += G * k;
      t2 += B * k;
    }
    const int k = ky[j];
    s0 += clip8(t0) * k;
    s1 += clip8(t1) * k;
    s2 += clip8(t2) * k;
  }
  float4 v;
  v.x = __fdiv_rn((float)clip8(s0), 255.0f);
  v.y = __fdiv_rn((float)clip8(s1), 255.0f);
  v.z = __fdiv_rn((float)clip8(s2), 255.0f);
  v.w = depth ? (float)depth[(size_t)rows[y] * p.W + cols[x]] : 0.0f;
  out[(size_t)y * w + x] = v;
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
// rows [h], cols [w] (int32).
extern "C" int frame_assemble_rgbd(const void* y, const void* cb,
                                   const void* cr, int H, int W, int ch,
                                   int cw, int sh, int sv, const void* depth,
                                   const void* hbounds, const void* hweights,
                                   int kh, const void* vbounds,
                                   const void* vweights, int kv,
                                   const void* rows, const void* cols,
                                   void* out, int h, int w, void* stream) {
  if (H < 1 || W < 1 || ch < 1 || cw < 1 || h < 1 || w < 1 || kh < 1 ||
      kv < 1 || sh < 1 || sh > 2 || sv < 1 || sv > sh)
    return (int)cudaErrorInvalidValue;
  const Planes p = {static_cast<const uint8_t*>(y),
                    static_cast<const uint8_t*>(cb),
                    static_cast<const uint8_t*>(cr), W, cw, ch, sh, sv};
  dim3 grid((w + kThreads - 1) / kThreads, h);
  assemble_rgbd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      p, static_cast<const uint16_t*>(depth),
      static_cast<const int*>(hbounds), static_cast<const int*>(hweights), kh,
      static_cast<const int*>(vbounds), static_cast<const int*>(vweights), kv,
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<float4*>(out), w);
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
