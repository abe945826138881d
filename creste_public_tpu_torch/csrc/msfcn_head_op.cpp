// creste::msfcn_head as a C++ operator: the BN-folded MultiScaleFCN reward
// head for processes without Python.
//
// The same schema as the Python registration in ops/reward_kernel.py,
//   creste::msfcn_head(Tensor x, Tensor[] weights) -> Tensor,
// x [B, H, W, Ci] f32 NHWC and the 27 folded tensors of
// reward_kernel.head_tensors (each layer's HWIO kernel, a and b in HEAD's
// order, then the six packed 3xTF32 weights), returning [B, H, W, 1] f32.
// An AOTInductor package calls the operator by name through the dispatcher,
// so a C++ process that links this library serves a package exported from
// the fused deployment graph.
//
// CUDA: the checks of reward_kernel._head_weights and msfcn_head_cuda, one
// workspace, and the four launches of csrc/msfcn_chain.cu (its C entry
// msfcn_head) on the current stream; a launch error raises, and nothing
// falls back to the plain version. creste_msfcn_head_launches() counts the
// kernels launched. CPU: the plain version in ATen, the twin of
// reward_kernel.msfcn_plain, so that the host also runs on the CPU.
//
// Never load this library into a Python process that imported
// ops/reward_kernel.py: both define creste::msfcn_head.
#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <vector>

#ifdef CRESTE_WITH_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

extern "C" int msfcn_head(const uint64_t* ptrs, int B, int H, int W, int Ci,
                          int K0, int* launched, void* stream);
extern "C" const char* msfcn_error_string(int err);
#endif

namespace {

std::atomic<int64_t> g_launches{0};

// reward_kernel.HEAD in order: prepool 0-1, skip 2-3, trunk 4-5, postpool 6.
// k = 0 and ci = 0 mean any (the first layer: an odd k0 <= 5, Ci the input
// view's).
struct LayerSpec {
  int64_t k, ci, co;
  bool pre_relu;
};
constexpr int kLayers = 7;
constexpr int kPacked = 6;  // the layers on tensor cores
constexpr LayerSpec kHead[kLayers] = {
    {0, 0, 64, false}, {3, 64, 32, false}, {3, 32, 32, false},
    {1, 32, 16, false}, {3, 32, 32, true}, {1, 32, 32, true},
    {1, 48, 1, false}};

// The checks of reward_kernel._head_weights on a flat weight list; returns
// k0.
int64_t check_head(at::TensorList w, const at::Device& device) {
  TORCH_CHECK(w.size() == 3 * kLayers + kPacked, "the operator takes ",
              3 * kLayers + kPacked, " tensors, got ", w.size());
  const int64_t k0 = w[0].dim() == 4 ? w[0].size(0) : -1;
  for (int i = 0; i < kLayers; ++i) {
    const at::Tensor& kernel = w[3 * i];
    TORCH_CHECK(kernel.dim() == 4, "layer ", i, "'s kernel must be HWIO");
    const int64_t k = i == 0 ? k0 : kHead[i].k;
    const int64_t ci = i == 0 ? kernel.size(2) : kHead[i].ci;
    TORCH_CHECK(kernel.size(0) == k && kernel.size(1) == k &&
                    kernel.size(2) == ci && kernel.size(3) == kHead[i].co,
                "layer ", i, " is ", kernel.sizes(), "; the kernel runs ", k,
                "x", k, " ", ci, "->", kHead[i].co);
    for (int j = 1; j < 3; ++j)
      TORCH_CHECK(w[3 * i + j].numel() == kHead[i].co, "layer ", i,
                  "'s affine has ", w[3 * i + j].numel(), " entries, not ",
                  kHead[i].co);
    if (i < kPacked)
      TORCH_CHECK(w[3 * kLayers + i].numel() == 2 * kernel.numel(), "layer ",
                  i, " has no packed weights of its size: fold it with "
                  "fold_msfcn_params");
  }
  TORCH_CHECK(k0 % 2 == 1 && k0 <= 5,
              "the first layer must be odd and <= 5, got ", k0);
  for (const at::Tensor& t : w)
    TORCH_CHECK(t.device() == device && t.scalar_type() == at::kFloat &&
                    t.is_contiguous(),
                "the folded head's tensors must be contiguous float32 on ",
                device, ", got ", t.scalar_type(), " on ", t.device());
  return k0;
}

// reward_kernel.conv_affine_plain: one folded layer, NHWC in and out.
at::Tensor conv_affine_plain(const at::Tensor& x, const at::Tensor& kernel,
                             const at::Tensor& a, const at::Tensor& b,
                             bool pre_relu) {
  const int64_t kh = kernel.size(0), kw = kernel.size(1);
  at::Tensor y = at::conv2d(x.permute({0, 3, 1, 2}),
                            kernel.permute({3, 2, 0, 1}), {}, {1, 1},
                            {kh / 2, kw / 2});
  if (pre_relu) y = at::relu(y);
  y = y * a.unsqueeze(1).unsqueeze(2) + b.unsqueeze(1).unsqueeze(2);
  return at::relu(y).permute({0, 2, 3, 1});
}

// reward_kernel.msfcn_plain (msfcn_chain with conv_affine_plain).
at::Tensor msfcn_head_cpu(const at::Tensor& x_in, at::TensorList w) {
  check_head(w, x_in.device());
  const at::Tensor x = x_in.to(at::kFloat).contiguous();
  TORCH_CHECK(x.dim() == 4, "x must be [B,H,W,C], got ", x.sizes());
  TORCH_CHECK(x.size(3) == w[0].size(2), "x has ", x.size(3),
              " channels, the head takes ", w[0].size(2));
  const int64_t H = x.size(1), W = x.size(2);
  auto layer = [&](const at::Tensor& t, int i) {
    return conv_affine_plain(t.contiguous(), w[3 * i], w[3 * i + 1],
                             w[3 * i + 2], kHead[i].pre_relu);
  };
  // prepool, forking the skip branch off its output
  const at::Tensor p_out = layer(layer(x, 0), 1);
  const at::Tensor s_out = layer(layer(p_out, 2), 3);
  // 2x2 maxpool, the trunk at half resolution
  at::Tensor t = at::max_pool2d(p_out.permute({0, 3, 1, 2}), {2, 2}, {2, 2})
                     .permute({0, 2, 3, 1});
  t = layer(layer(t, 4), 5);
  // bilinear x2 upsample (half-pixel centres, convnets.resize_bilinear) and
  // concat, then the postpool
  t = at::upsample_bilinear2d(t.permute({0, 3, 1, 2}), {H, W}, false,
                              std::nullopt, std::nullopt)
          .permute({0, 2, 3, 1});
  return layer(at::cat({t, s_out}, -1), 6).contiguous();
}

#ifdef CRESTE_WITH_CUDA
// reward_kernel.msfcn_head_cuda: the four launches of csrc/msfcn_chain.cu.
at::Tensor msfcn_head_cuda(const at::Tensor& x, at::TensorList w) {
  TORCH_CHECK(x.is_cuda(), "x must be a CUDA tensor, got ", x.device());
  TORCH_CHECK(x.scalar_type() == at::kFloat, "x must be float32, got ",
              x.scalar_type());
  TORCH_CHECK(x.is_contiguous() &&
                  reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0,
              "x must be contiguous and 16-byte aligned");
  TORCH_CHECK(x.dim() == 4, "x must be [B,H,W,C], got ", x.sizes());
  const int64_t B = x.size(0), H = x.size(1), W = x.size(2), Ci = x.size(3);
  TORCH_CHECK(Ci % 8 == 0 && Ci >= 8 && Ci <= 64 && H >= 2 && W >= 2 &&
                  B >= 1 && B <= 32767,
              "unsupported input ", x.sizes(), ": Ci a multiple of 8 up to "
              "64, H and W >= 2, 1 <= B <= 32767");
  TORCH_CHECK(B * H * W * 64 < (int64_t{1} << 31),
              "tensor too large for the kernel: ", x.sizes());
  const int64_t k0 = check_head(w, x.device());
  TORCH_CHECK(w[0].size(2) == Ci, "x has ", Ci, " channels, the head takes ",
              w[0].size(2));
  for (const at::Tensor& t : w)
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0,
                "the folded head's tensors must be 16-byte aligned");
  const c10::cuda::CUDAGuard guard(x.device());
  // one workspace: p0 [B,H,W,64], s_out [B,H,W,16], pooled and t
  // [B,H/2,W/2,32]; every size a multiple of 4 floats (16 bytes)
  const int64_t n = B * H * W, m = B * (H / 2) * (W / 2);
  at::Tensor work = at::empty({80 * n + 64 * m}, x.options());
  at::Tensor out = at::empty({B, H, W, 1}, x.options());
  const uint64_t base = reinterpret_cast<uint64_t>(work.data_ptr());
  // the kernel's order: x, the six packed weights, the last 1x1's kernel,
  // a[7], b[7], the four workspace slices, out
  std::vector<uint64_t> ptrs;
  ptrs.push_back(reinterpret_cast<uint64_t>(x.data_ptr()));
  for (int i = 0; i < kPacked; ++i)
    ptrs.push_back(reinterpret_cast<uint64_t>(w[3 * kLayers + i].data_ptr()));
  ptrs.push_back(reinterpret_cast<uint64_t>(w[3 * (kLayers - 1)].data_ptr()));
  for (int j = 1; j < 3; ++j)
    for (int i = 0; i < kLayers; ++i)
      ptrs.push_back(reinterpret_cast<uint64_t>(w[3 * i + j].data_ptr()));
  for (int64_t off : {int64_t{0}, 64 * n, 80 * n, 80 * n + 32 * m})
    ptrs.push_back(base + 4 * off);
  ptrs.push_back(reinterpret_cast<uint64_t>(out.data_ptr()));
  TORCH_INTERNAL_ASSERT(ptrs.size() == 27);
  int launched = 0;
  const int err = msfcn_head(
      ptrs.data(), (int)B, (int)H, (int)W, (int)Ci, (int)k0, &launched,
      at::cuda::getCurrentCUDAStream(x.device().index()).stream());
  g_launches += launched;
  TORCH_CHECK(err == 0, "msfcn_head launch failed: ", msfcn_error_string(err));
  return out;
}
#endif

}  // namespace

// The kernels this library launched so far in this process (four per head).
extern "C" int64_t creste_msfcn_head_launches() { return g_launches.load(); }

TORCH_LIBRARY(creste, m) {
  m.def("msfcn_head(Tensor x, Tensor[] weights) -> Tensor");
}

TORCH_LIBRARY_IMPL(creste, CPU, m) { m.impl("msfcn_head", &msfcn_head_cpu); }

#ifdef CRESTE_WITH_CUDA
TORCH_LIBRARY_IMPL(creste, CUDA, m) {
  m.impl("msfcn_head", &msfcn_head_cuda);
}
#endif
