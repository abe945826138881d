// The splat's scatter: each voxel's bilinearly weighted feature sums and
// density, every voxel summed in one fixed order.
//
// Replaces: creste_public_tpu/ops/splat.py:107 (splat_bilinear's XLA
// scatter-adds, :107, :112, :117), which the JAX package leaves to XLA: on
// the TPU they add in a fixed order, so one frame always gives one map. The
// port's plain version (ops/splat.py::splat_sums_plain) adds with
// index_add_, whose CUDA form uses float atomics: the last bits of a
// voxel's sum change from run to run. This kernel sums each voxel in the
// order the CPU's index_add_ does, so it equals the plain version run on
// the CPU from the same inputs to the bit, on every run.
//
// Semantics (ops/splat.py::_corners and splat_sums_plain, exactly): point p
// of batch element b at (x, y) = xy[b, p] votes into its four corners k =
// 2 * xdiff + ydiff (xdiff outer, ydiff inner) with
//   rx = x - floor(x), wx = (1 - xdiff) + (2 * xdiff - 1) * rx (ry, wy alike)
//   w  = wx * wy if the corner (floor(x) + xdiff, floor(y) + ydiff) lies on
//        the H x W grid, else exactly +0 and voxel 0,
// each product and sum rounded once (__fmul_rn / __fadd_rn: never an FMA).
// Vote (k, p) of element b has the ordinal b * 4P + k * P + p; each voxel's
// channels c < F sum w * feats[b, p, c] and channel F sums w, from +0 in
// ordinal order, as the CPU's index_add_ adds a voxel's rows in index
// order. An off-grid vote adds w * f = +-0 to voxel 0, which changes no
// sum (a sum from +0 is never -0), unless f is not finite: then the plain
// version's voxel 0 holds NaN in that channel (0 * inf, NaN), and so does
// this kernel's. So off-grid votes are kept out of the ordering, and a flag
// per element and channel records a non-finite feature among them.
//
// Layouts: xy [B, P, 2] f32, feats [B, P, F] f32, out [B, H * W, F + 1] f32,
// all contiguous; work holds splat_sums_workspace(B, P, H, W, F) ints.
//
// Design (simple first). Seven kernels on the caller's stream, sized from
// shapes alone (no host sync, capture-safe):
//   1. vote_keys, a warp per point: each corner's voxel (the sentinel V =
//      B * H * W off the grid), the per-voxel vote counts (integer atomics:
//      the counts are exact whatever their order) and the non-finite flags.
//   2. span_sums, span_scan: the exclusive scan of the counts, each
//      voxel's first slot, a block per 4096 voxels (the sums of the spans
//      before it read by each block); it lists the voxels of more than 32
//      votes.
//   3. A stable LSD radix sort of the votes by voxel, 9 bits a pass (two
//      passes at B * H * W <= 2^18 - 1): per tile of 1024 votes its digit
//      counts, then a stable scatter whose blocks each read every tile's
//      counts for their offsets (a warp's peers by __match_any_sync, warps
//      of a tile ranked by their digit counts in shared memory). Votes of
//      one voxel keep their ordinal order.
//      The last pass writes each vote's point and its weight, recomputed
//      from xy, in place of its ordinal.
//   4. voxel_sums, a warp per voxel of at most 32 votes: its lanes load
//      the votes; the warp walks them in order, each lane adding its
//      channels (4 per lane per pass of 128 channels; the features of 8
//      votes loaded together), and writes the voxel once, zeros for an
//      empty voxel.
//   5. heavy_voxel_sums, a block per voxel of more votes (the scan's
//      list): a channel a thread, each thread loading its channel of 32
//      votes together before it adds them in order, the next 32 votes'
//      points and weights in flight. A crowded voxel near the robot holds
//      hundreds of votes; one warp walking them waits on a load every few
//      votes.
// The [4P, F + 1] update tensor the plain version builds is never built;
// no float atomics, no zeroing pass over the output. That is a memset and
// 5 + 2 * passes launches per call.
//
// What bounds it on an H100: bytes. xy and feats read once and the sums
// written once: at the production shape (B = 1, P = 19,584, F = 96, a
// 256 x 256 grid) 0.157 + 7.52 + 25.43 MB = 33.1 MB, ~9.9 us at 3.35 TB/s;
// ~15 MFLOP is ~0.2 us. A voxel's sum is a chain of dependent adds, so a
// crowded voxel (hundreds to thousands of votes near the robot) takes the
// time of its chain: its block overlaps the loads, not the adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadixBits = 9;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortThreads = 256;  // 8 warps
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kTile = 1024;  // votes per sort tile: 4 rounds of 32 a warp
constexpr int kRounds = kTile / kSortThreads;
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 4;  // counts a thread
constexpr int kScanSpan = kScanThreads * kScanPer;  // counts a block
constexpr int kWalkThreads = 256;  // 8 voxels a block
constexpr int kChan = 4;  // channels per lane per pass: 128 a pass
constexpr int kAhead = 8;  // votes whose features are loaded together
// a voxel of more votes is walked by a block, a channel a thread
constexpr int kHeavy = 32;
constexpr int kHeavyThreads = 128;  // channels a pass
constexpr int kHeavyBlocks = 264;

struct Corner {
  bool valid;
  int index;  // y * W + x on the grid
  float w;
};

// _corners for corner k = 2 * xdiff + ydiff of the point at (x, y).
__device__ __forceinline__ Corner corner(float x, float y, int k, int H,
                                         int W) {
  const int xdiff = k >> 1, ydiff = k & 1;
  const float x0 = floorf(x), y0 = floorf(y);
  const float rx = __fsub_rn(x, x0), ry = __fsub_rn(y, y0);
  const float wx = __fadd_rn((float)(1 - xdiff),
                             __fmul_rn((float)(2 * xdiff - 1), rx));
  const float wy = __fadd_rn((float)(1 - ydiff),
                             __fmul_rn((float)(2 * ydiff - 1), ry));
  // the grid test on floats: exact for |x0| < 2^24, and any larger or
  // non-finite value is off the grid both ways (NaN compares false)
  const float xc = __fadd_rn(x0, (float)xdiff);
  const float yc = __fadd_rn(y0, (float)ydiff);
  Corner c;
  c.valid = xc >= 0.0f && xc < (float)W && yc >= 0.0f && yc < (float)H;
  c.index = c.valid ? (int)yc * W + (int)xc : 0;
  c.w = c.valid ? __fmul_rn(wx, wy) : 0.0f;
  return c;
}

// 1. A warp per point: its four votes' keys, the voxels' vote counts and
// the non-finite flags of its off-grid votes.
__global__ void __launch_bounds__(256)
vote_keys(const float* __restrict__ xy, const float* __restrict__ feats,
          int B, int P, int F, int H, int W, int* __restrict__ keys,
          int* __restrict__ counts, int* __restrict__ nonfinite) {
  const long long pt =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pt >= (long long)B * P) return;  // uniform over the warp
  const int b = (int)(pt / P), p = (int)(pt - (long long)b * P);
  const int V = B * H * W;
  bool off = false;
  if (lane < 4) {
    const Corner c = corner(xy[2 * pt], xy[2 * pt + 1], lane, H, W);
    const int key = c.valid ? b * H * W + c.index : V;
    keys[(long long)b * 4 * P + (long long)lane * P + p] = key;
    if (c.valid) atomicAdd(&counts[key], 1);
    off = !c.valid;
  }
  if (__ballot_sync(kFull, off) && F > 0) {
    const float* row = feats + pt * F;
    for (int c = lane; c < F; c += 32)
      if ((__float_as_uint(__ldg(row + c)) & 0x7f800000u) == 0x7f800000u)
        atomicOr(&nonfinite[b * F + c], 1);  // inf or NaN
  }
}

// The sum over the block of each thread's x (every thread gets it).
__device__ __forceinline__ int block_sum(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  if (lane == 0) warp_sums[wid] = x;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
  __syncthreads();  // warp_sums is written again
  return total;
}

// 2a. The sum of each span of kScanSpan counts: bsum[blockIdx.x].
__global__ void __launch_bounds__(kScanThreads)
span_sums(const int* __restrict__ in, int n, int* __restrict__ bsum) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int base = blockIdx.x * kScanSpan + kScanPer * threadIdx.x;
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) s += base + k < n ? in[base + k] : 0;
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) bsum[blockIdx.x] = s;
}

// 2b. out[0..n] = the exclusive prefix sums of in[0..n), out[n] the total:
// a block per span, its offset the sum of the spans before it. Each i with
// in[i] > kHeavy is appended to heavy (in any order), counted in
// *n_heavy.
__global__ void __launch_bounds__(kScanThreads)
span_scan(const int* __restrict__ in, int n, const int* __restrict__ bsum,
          int* __restrict__ out, int* __restrict__ heavy,
          int* __restrict__ n_heavy) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  int before = 0;
  for (int b = t; b < (int)blockIdx.x; b += kScanThreads) before += bsum[b];
  const int offset = block_sum(before, warp_sums);
  const int base = blockIdx.x * kScanSpan + kScanPer * t;
  int v[kScanPer];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    v[k] = base + k < n ? in[base + k] : 0;
    s += v[k];
  }
  int x = s;  // inclusive over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  int run = offset + x - s;
  for (int w = 0; w < wid; ++w) run += warp_sums[w];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    if (base + k < n) out[base + k] = run;
    if (v[k] > kHeavy) heavy[atomicAdd(n_heavy, 1)] = base + k;
    run += v[k];
  }
  if (blockIdx.x == gridDim.x - 1 && t == kScanThreads - 1) out[n] = run;
}

// 3a. Each tile's count of each digit, tile-major: tcount[t * kRadix + d].
__global__ void __launch_bounds__(kSortThreads)
digit_counts(const int* __restrict__ keys, int n, int shift,
             int* __restrict__ tcount) {
  __shared__ int hist[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int i = base + r * kSortThreads + threadIdx.x;
    if (i < n) atomicAdd(&hist[(keys[i] >> shift) & (kRadix - 1)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += kSortThreads)
    tcount[blockIdx.x * kRadix + d] = hist[d];
}

// 3b. The stable scatter of one tile by its digit. The tile's offset for
// digit d is the count of all votes of lower digits plus the votes of
// digit d in earlier tiles (read from tcount by each block: no scan
// launch). Warp w holds the tile's votes w * 128 .. w * 128 + 127, 32 a
// round; a vote's place is its digit's offset, plus the votes of that
// digit in the earlier warps, the earlier rounds and the lower lanes.
// vals_in null: the votes' ordinals are their indices. The last pass
// (w_out given) writes in place of each vote's ordinal its point (b * P +
// p) and its weight, recomputed from xy, which is what voxel_sums reads.
__global__ void __launch_bounds__(kSortThreads)
digit_scatter(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
              int n, int shift, int tiles, const int* __restrict__ tcount,
              int* __restrict__ keys_out, int* __restrict__ vals_out,
              const float* __restrict__ xy, int P, int H, int W,
              float* __restrict__ w_out) {
  static_assert(kRadix == 2 * kSortThreads, "two digits a thread");
  __shared__ int whist[kSortWarps][kRadix];
  __shared__ int off[kRadix];
  __shared__ int warp_sums[kSortWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  {  // off[d]: this tile's first place for digit d
    const int d0 = 2 * threadIdx.x;
    int tot0 = 0, tot1 = 0, pre0 = 0, pre1 = 0;
#pragma unroll 8
    for (int tt = 0; tt < tiles; ++tt) {
      if (tt == (int)blockIdx.x) {
        pre0 = tot0;
        pre1 = tot1;
      }
      tot0 += tcount[tt * kRadix + d0];
      tot1 += tcount[tt * kRadix + d0 + 1];
    }
    const int s = tot0 + tot1;
    int x = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[w] = x;
    __syncthreads();
    int below = x - s;
    for (int v = 0; v < w; ++v) below += warp_sums[v];
    off[d0] = below + pre0;
    off[d0 + 1] = below + tot0 + pre1;
  }
  for (int i = threadIdx.x; i < kSortWarps * kRadix; i += kSortThreads)
    (&whist[0][0])[i] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile + w * (kTile / kSortWarps);
  int key[kRounds], val[kRounds], dig[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = base + r * 32 + lane;
    const bool ok = i < n;
    key[r] = ok ? keys_in[i] : 0;
    val[r] = ok ? (vals_in ? vals_in[i] : i) : 0;
    dig[r] = ok ? (key[r] >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(kFull, dig[r]);
    const int before = __popc(peers & ((1u << lane) - 1u));
    const int seen = ok ? whist[w][dig[r]] : 0;
    __syncwarp();
    if (ok && before == 0) whist[w][dig[r]] = seen + __popc(peers);
    __syncwarp();
    rank[r] = seen + before;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += kSortThreads) {
    int run = off[d];
    for (int v = 0; v < kSortWarps; ++v) {
      const int c = whist[v][d];
      whist[v][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (base + r * 32 + lane >= n) continue;
    const int pos = whist[w][dig[r]] + rank[r];
    keys_out[pos] = key[r];
    if (w_out == nullptr) {
      vals_out[pos] = val[r];
      continue;
    }
    const int b = val[r] / (4 * P), q = val[r] - b * 4 * P;
    const int k = q / P, pt = b * P + q - k * P;
    vals_out[pos] = pt;
    w_out[pos] = corner(__ldg(xy + 2 * (long long)pt),
                        __ldg(xy + 2 * (long long)pt + 1), k, H, W).w;
  }
}

// A voxel's channel c as written: voxel 0 of an element holds NaN where an
// off-grid vote of the element carried a non-finite feature.
__device__ __forceinline__ float finish(float acc, long long v, int c, int F,
                                        int HW, const int* nonfinite) {
  if (v % HW == 0 && c < F && nonfinite[(v / HW) * F + c])
    return __int_as_float(0x7fffffff);
  return acc;
}

// 4. A warp per voxel: its votes (points pts and weights wts [starts[v]
// .. starts[v + 1]), in ordinal order) summed channel by channel, written
// once. The lanes read 32 votes at a time, the next 32 in flight; the
// features of kAhead votes are loaded together before they are added in
// order.
__global__ void __launch_bounds__(kWalkThreads)
voxel_sums(const float* __restrict__ feats, const int* __restrict__ starts,
           const int* __restrict__ pts, const float* __restrict__ wts,
           const int* __restrict__ nonfinite, int B, int F, int HW,
           float* __restrict__ out) {
  const long long v =
      ((long long)blockIdx.x * kWalkThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= (long long)B * HW) return;  // uniform over the warp
  const int lo = starts[v], hi = starts[v + 1];
  if (hi - lo > kHeavy) return;  // heavy_voxel_sums writes it
  const int C = F + 1;
  float* o = out + v * C;
  for (int c0 = 0; c0 < C; c0 += 32 * kChan) {
    float acc[kChan];
#pragma unroll
    for (int u = 0; u < kChan; ++u) acc[u] = 0.0f;
    float wn = 0.0f;
    int pn = 0;
    if (lo + lane < hi) {
      wn = wts[lo + lane];
      pn = pts[lo + lane];
    }
    for (int s = lo; s < hi; s += 32) {
      const int m = min(32, hi - s);
      const float wl = wn;
      const long long rowl = (long long)pn * F;
      if (s + 32 + lane < hi) {  // the next 32 votes
        wn = wts[s + 32 + lane];
        pn = pts[s + 32 + lane];
      }
      for (int j0 = 0; j0 < m; j0 += kAhead) {
        float wj[kAhead], val[kAhead][kChan];
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          wj[j] = __shfl_sync(kFull, wl, j0 + j);
          const long long row = __shfl_sync(kFull, rowl, j0 + j);
#pragma unroll
          for (int u = 0; u < kChan; ++u) {
            const int c = c0 + u * 32 + lane;
            val[j][u] = j0 + j < m && c < F ? __ldg(feats + row + c) : 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          if (j0 + j < m) {  // uniform over the warp
#pragma unroll
            for (int u = 0; u < kChan; ++u) {
              // channel F adds the weight; lanes past it add what they like
              const int c = c0 + u * 32 + lane;
              acc[u] = __fadd_rn(
                  acc[u], c < F ? __fmul_rn(wj[j], val[j][u]) : wj[j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChan; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c < C) o[c] = finish(acc[u], v, c, F, HW, nonfinite);
    }
  }
}

// 5. A block per voxel of more than kHeavy votes (heavy[0 .. *n_heavy),
// the blocks striding over them), a channel a thread: the block's first
// warp reads 32 votes into shared memory, the next 32 in flight; each
// thread loads its channel of all 32 rows together, then adds them in
// order.
__global__ void __launch_bounds__(kHeavyThreads)
heavy_voxel_sums(const float* __restrict__ feats,
                 const int* __restrict__ starts, const int* __restrict__ pts,
                 const float* __restrict__ wts,
                 const int* __restrict__ nonfinite,
                 const int* __restrict__ heavy,
                 const int* __restrict__ n_heavy, int F, int HW,
                 float* __restrict__ out) {
  __shared__ float s_w[32];
  __shared__ long long s_row[32];
  const int t = threadIdx.x;
  const int C = F + 1;
  const int count = *n_heavy;
  for (int h = blockIdx.x; h < count; h += gridDim.x) {
    const int v = heavy[h];
    const int lo = starts[v], hi = starts[v + 1];
    float* o = out + (long long)v * C;
    const int span = (C + kHeavyThreads - 1) / kHeavyThreads * kHeavyThreads;
    for (int c = t; c < span; c += kHeavyThreads) {  // all take every pass
      float acc = 0.0f;
      float wn = 0.0f;
      int pn = 0;
      if (t < 32 && lo + t < hi) {
        wn = wts[lo + t];
        pn = pts[lo + t];
      }
      for (int s = lo; s < hi; s += 32) {
        const int m = min(32, hi - s);
        __syncthreads();  // the last chunk's reads are done
        if (t < 32) {
          s_w[t] = wn;
          s_row[t] = (long long)pn * F;
          if (s + 32 + t < hi) {  // the next 32 votes
            wn = wts[s + 32 + t];
            pn = pts[s + 32 + t];
          }
        }
        __syncthreads();
        float val[32];
#pragma unroll
        for (int j = 0; j < 32; ++j)
          val[j] = j < m && c < F ? __ldg(feats + s_row[j] + c) : 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (j < m)
            acc = __fadd_rn(acc, c < F ? __fmul_rn(s_w[j], val[j]) : s_w[j]);
      }
      if (c < C) o[c] = finish(acc, v, c, F, HW, nonfinite);
    }
    __syncthreads();  // s_w, s_row are written again for the next voxel
  }
}

int bit_length(long long x) {
  int n = 0;
  while (x > 0) {
    ++n;
    x >>= 1;
  }
  return n;
}

struct Layout {
  long long n, v, tiles, total;
  long long keys0, keys_a, vals_a, keys_b, vals_b, wts, counts, nonfinite,
      n_heavy, heavy, starts, bsum, tcount;
};

Layout layout(int B, int P, int H, int W, int F) {
  Layout l;
  l.n = 4LL * B * P;
  l.v = (long long)B * H * W;
  l.tiles = (l.n + kTile - 1) / kTile;
  long long at = 0;
  auto take = [&at](long long count) {
    const long long here = at;
    at += count;
    return here;
  };
  l.keys0 = take(l.n);
  l.keys_a = take(l.n);
  l.vals_a = take(l.n);
  l.keys_b = take(l.n);
  l.vals_b = take(l.n);
  l.wts = take(l.n);  // floats
  // counts, nonfinite and n_heavy adjacent: one memset
  l.counts = take(l.v);
  l.nonfinite = take((long long)B * F);
  l.n_heavy = take(1);
  l.heavy = take(l.n / (kHeavy + 1) + 1);
  l.starts = take(l.v + 1);
  l.bsum = take((l.v + kScanSpan - 1) / kScanSpan);
  l.tcount = take(kRadix * l.tiles);
  l.total = at;
  return l;
}

}  // namespace

// The ints of workspace splat_sums needs for these sizes.
extern "C" long long splat_sums_workspace(int B, int P, int H, int W, int F) {
  return layout(B, P, H, W, F).total;
}

// out [B, H*W, F+1] from xy [B, P, 2] and feats [B, P, F] (f32, contiguous,
// on the card) on `stream`, with `work` of splat_sums_workspace ints. The
// caller checks the sizes: 4 * B * P and B * H * W + 1 below 2^31, B, H, W
// >= 1, P, F >= 0. Returns a cudaError_t (0: launched).
extern "C" int splat_sums(const void* xy, const void* feats, void* out,
                          void* work, int B, int P, int F, int H, int W,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(B, P, H, W, F);
  int* ws = (int*)work;
  const float* xyf = (const float*)xy;
  const float* ff = (const float*)feats;
  cudaError_t err = cudaMemsetAsync(
      ws + l.counts, 0, (l.v + (long long)B * F + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (l.n > 0) {
    const long long threads = (long long)B * P * 32;
    vote_keys<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        xyf, ff, B, P, F, H, W, ws + l.keys0, ws + l.counts,
        ws + l.nonfinite);
  }
  const unsigned spans = (unsigned)((l.v + kScanSpan - 1) / kScanSpan);
  span_sums<<<spans, kScanThreads, 0, s>>>(ws + l.counts, (int)l.v,
                                           ws + l.bsum);
  span_scan<<<spans, kScanThreads, 0, s>>>(ws + l.counts, (int)l.v,
                                           ws + l.bsum, ws + l.starts,
                                           ws + l.heavy, ws + l.n_heavy);
  const int* pts = ws + l.keys0;  // unread when there is no vote
  float* wts = (float*)(ws + l.wts);
  if (l.n > 0) {
    // keys run to the sentinel v
    const int passes = (bit_length(l.v) + kRadixBits - 1) / kRadixBits;
    const int* kin = ws + l.keys0;
    const int* vin = nullptr;
    for (int pass = 0; pass < passes; ++pass) {
      int* kout = ws + (pass % 2 ? l.keys_b : l.keys_a);
      int* vout = ws + (pass % 2 ? l.vals_b : l.vals_a);
      const int shift = pass * kRadixBits;
      digit_counts<<<(unsigned)l.tiles, kSortThreads, 0, s>>>(
          kin, (int)l.n, shift, ws + l.tcount);
      digit_scatter<<<(unsigned)l.tiles, kSortThreads, 0, s>>>(
          kin, vin, (int)l.n, shift, (int)l.tiles, ws + l.tcount, kout,
          vout, xyf, P, H, W, pass == passes - 1 ? wts : nullptr);
      kin = kout;
      vin = vout;
    }
    pts = vin;
  }
  voxel_sums<<<(unsigned)((l.v * 32 + kWalkThreads - 1) / kWalkThreads),
               kWalkThreads, 0, s>>>(ff, ws + l.starts, pts, wts,
                                     ws + l.nonfinite, B, F, H * W,
                                     (float*)out);
  heavy_voxel_sums<<<kHeavyBlocks, kHeavyThreads, 0, s>>>(
      ff, ws + l.starts, pts, wts, ws + l.nonfinite, ws + l.heavy,
      ws + l.n_heavy, F, H * W, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* splat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
