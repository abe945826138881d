// creste::splat_sums as a C++ operator: the splat's scatter for processes
// without Python.
//
// The same schema as the Python registration in ops/splat_kernel.py,
//   creste::splat_sums(Tensor xy, Tensor feats, int H, int W) -> Tensor,
// xy [B, P, 2] f32 and feats [B, P, F] f32, returning [B, H*W, F+1] f32:
// each voxel's bilinearly weighted feature sums, then its density. An
// AOTInductor package of the deployment graph calls it by name through the
// dispatcher, beside creste::msfcn_head (csrc/msfcn_head_op.cpp, which
// defines the library; this file adds a fragment to it).
//
// CUDA: the checks of splat_kernel.splat_sums_cuda, one workspace, and the
// launches of csrc/splat.cu (its C entry splat_sums) on the current stream;
// a launch error raises, and nothing falls back to the plain version.
// creste_splat_sums_launches() counts the calls that launched the kernel,
// creste_splat_sums_calls() the operator's calls on either device. CPU: the
// plain version in ATen, op for op as ops/splat.py::splat_sums_plain, so
// that the host also runs on the CPU.
//
// Never load this library into a Python process that imported
// ops/splat_kernel.py: both define creste::splat_sums.
#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <vector>

#ifdef CRESTE_WITH_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

extern "C" long long splat_sums_workspace(int B, int P, int H, int W, int F);
extern "C" int splat_sums(const void* xy, const void* feats, void* out,
                          void* work, int B, int P, int F, int H, int W,
                          void* stream);
extern "C" const char* splat_error_string(int err);
#endif

namespace {

std::atomic<int64_t> g_launches{0};
std::atomic<int64_t> g_calls{0};

// ops/splat.py::_corners: the flat voxel index [B * 4P] and the weight
// [B, 4P] of each point's four corners, corner by corner.
std::pair<at::Tensor, at::Tensor> corners(const at::Tensor& xy_in, int64_t H,
                                          int64_t W) {
  const int64_t B = xy_in.size(0);
  const at::Tensor xy = xy_in.to(at::kFloat);
  const at::Tensor xy0 = at::floor(xy);
  const at::Tensor r = xy - xy0;
  const at::Tensor x0 = xy0.select(-1, 0).to(at::kLong);
  const at::Tensor y0 = xy0.select(-1, 1).to(at::kLong);
  const at::Tensor rx = r.select(-1, 0), ry = r.select(-1, 1);
  std::vector<at::Tensor> idxs, ws;
  for (int64_t xdiff : {0, 1}) {
    const at::Tensor x = x0 + xdiff;
    const at::Tensor wx = rx * (2 * xdiff - 1) + (1 - xdiff);
    for (int64_t ydiff : {0, 1}) {
      const at::Tensor y = y0 + ydiff;
      const at::Tensor wy = ry * (2 * ydiff - 1) + (1 - ydiff);
      const at::Tensor valid = (x >= 0) & (x < W) & (y >= 0) & (y < H);
      idxs.push_back(at::where(valid, y * W + x, 0));
      ws.push_back(at::where(valid, wx * wy, 0.0));
    }
  }
  const at::Tensor idx4 = at::cat(idxs, 1);
  const at::Tensor w4 = at::cat(ws, 1);
  const at::Tensor flat =
      (at::arange(B, idx4.options()).unsqueeze(1) * (H * W) + idx4)
          .reshape({-1});
  return {flat, w4};
}

// ops/splat.py::splat_sums_plain (votes, then index_add_).
at::Tensor splat_sums_cpu(const at::Tensor& xy, const at::Tensor& feats,
                          int64_t H, int64_t W) {
  ++g_calls;
  TORCH_CHECK(xy.dim() == 3 && xy.size(2) == 2 && feats.dim() == 3 &&
                  feats.size(0) == xy.size(0) && feats.size(1) == xy.size(1),
              "xy must be [B,P,2] and feats [B,P,F], got ", xy.sizes(),
              " and ", feats.sizes());
  const int64_t B = feats.size(0), F = feats.size(2);
  auto [flat, w4] = corners(xy, H, W);
  at::Tensor upd = w4.unsqueeze(-1) * feats.to(at::kFloat).repeat({1, 4, 1});
  upd = at::cat({upd, w4.unsqueeze(-1)}, -1);
  return at::zeros({B * H * W, F + 1}, w4.options())
      .index_add_(0, flat, upd.reshape({-1, F + 1}))
      .reshape({B, H * W, F + 1});
}

#ifdef CRESTE_WITH_CUDA
// splat_kernel.splat_sums_cuda: the launches of csrc/splat.cu.
at::Tensor splat_sums_cuda(const at::Tensor& xy, const at::Tensor& feats,
                           int64_t H, int64_t W) {
  ++g_calls;
  for (const at::Tensor* t : {&xy, &feats}) {
    TORCH_CHECK(t->is_cuda(), "xy and feats must be CUDA tensors, got ",
                t->device());
    TORCH_CHECK(t->scalar_type() == at::kFloat,
                "xy and feats must be float32, got ", t->scalar_type());
    TORCH_CHECK(t->is_contiguous(), "xy and feats must be contiguous");
  }
  TORCH_CHECK(xy.dim() == 3 && xy.size(2) == 2 && feats.dim() == 3 &&
                  feats.size(0) == xy.size(0) && feats.size(1) == xy.size(1),
              "xy must be [B,P,2] and feats [B,P,F], got ", xy.sizes(),
              " and ", feats.sizes());
  TORCH_CHECK(xy.device() == feats.device(),
              "xy and feats must lie on one device");
  const int64_t B = feats.size(0), P = feats.size(1), F = feats.size(2);
  constexpr int64_t kMax = (int64_t{1} << 31) - 1;
  TORCH_CHECK(B >= 1 && H >= 1 && W >= 1, "B, H and W must be >= 1, got B=",
              B, ", H=", H, ", W=", W);
  TORCH_CHECK(4 * B * P <= kMax && B * H * W + 1 <= kMax && B * F <= kMax,
              "too large for the kernel: B=", B, ", P=", P, ", F=", F,
              ", grid ", H, "x", W);
  const c10::cuda::CUDAGuard guard(xy.device());
  at::Tensor work = at::empty(
      {splat_sums_workspace((int)B, (int)P, (int)H, (int)W, (int)F)},
      xy.options().dtype(at::kInt));
  at::Tensor out = at::empty({B, H * W, F + 1}, xy.options());
  const int err = splat_sums(
      xy.data_ptr(), feats.data_ptr(), out.data_ptr(), work.data_ptr(),
      (int)B, (int)P, (int)F, (int)H, (int)W,
      at::cuda::getCurrentCUDAStream(xy.device().index()).stream());
  TORCH_CHECK(err == 0, "splat_sums launch failed: ", splat_error_string(err));
  ++g_launches;
  return out;
}
#endif

}  // namespace

// The operator's calls that launched csrc/splat.cu so far in this process
// (one per splat).
extern "C" int64_t creste_splat_sums_launches() { return g_launches.load(); }

// The operator's calls so far in this process, on either device.
extern "C" int64_t creste_splat_sums_calls() { return g_calls.load(); }

TORCH_LIBRARY_FRAGMENT(creste, m) {
  m.def("splat_sums(Tensor xy, Tensor feats, int H, int W) -> Tensor");
}

TORCH_LIBRARY_IMPL(creste, CPU, m) { m.impl("splat_sums", &splat_sums_cpu); }

#ifdef CRESTE_WITH_CUDA
TORCH_LIBRARY_IMPL(creste, CUDA, m) { m.impl("splat_sums", &splat_sums_cuda); }
#endif
