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
// What bounds it on an H100: bytes. xy and feats read once and the sums
// written once: at the production shape (B = 1, P = 19,584, F = 96, a
// 256 x 256 grid) 0.157 + 7.52 + 25.43 MB = 33.1 MB, ~9.9 us at 3.35 TB/s;
// ~15 MFLOP is ~0.2 us. A voxel's sum is a chain of dependent adds, so a
// crowded voxel (hundreds to thousands of votes near the robot) takes at
// least the time of its chain, ~4 cycles a vote.
//
// Design. A memset and 2 + passes launches on the caller's stream (4 at
// the production grid, for any B up to 15 at 256 x 256), all sized from
// shapes alone: no host sync, no allocation, no device attribute set, so
// a call can be captured in a CUDA graph.
//   1. vote_keys, a thread per vote (a warp is 8 points x 4 corners): each
//      vote's cell y * W + x (-1 off the grid) and weight in ordinal order;
//      the voxels' vote counts and every pass's digit counts per element,
//      a warp's equal keys merged by __match_any_sync into one atomic (a
//      crowded voxel's votes do not serialise on one address). It also
//      zeroes the sort's look-back words.
//   2. sort_pass, a stable LSD radix sort of each element's votes by cell,
//      8 bits a pass: two passes for a grid of up to 2^16 cells whatever
//      B (the element is not part of the key: each element is sorted in
//      its own segment, placed after the elements before it by their digit
//      counts), so B = 8 and B = 10 need two passes, as B = 1 does. The
//      first pass drops the off-grid votes. Each pass is one launch
//      (Onesweep): every tile of 512 votes (153 tiles a production
//      element, more than the card's 132 SMs) ranks its votes with
//      __match_any_sync, publishes its digit counts and takes its offset
//      by decoupled look-back over the tiles before it (8 words read
//      together); the element's digit offsets come from vote_keys' counts,
//      so there is no count kernel and no scan launch. Tiles take their
//      place in the order of an atomic counter, so a tile only waits on
//      tiles that run. The weights travel with the votes; the last pass
//      writes each vote's point in place of its ordinal.
//      The first pass's launch holds three more kinds of blocks, which
//      need only vote_keys' results and run beside its tiles: the scan of
//      the voxel counts (decoupled look-back over spans of 4096 voxels)
//      into lists of the voxels to write, {voxel, first slot, end,
//      voxel-0 flag}, one list per size class (> 2048, > 256, > 32 votes,
//      the rest), every element's voxel 0 among them (its NaN flags), a
//      block taking its places with one atomic a class; the non-finite
//      flags, 8 points a warp, the off-grid points' rows read together (16
//      bytes a load where rows allow); and zeros over the voxels that no
//      list holds, runs of 16-byte stores.
//   3. voxel_sums, one wave of blocks of one crowded warp and three light
//      warps. The crowded warp owns a slice of 32 channels (channel F, the
//      density, in the last slice) and walks the voxels of more than 32
//      votes, fullest class first, round robin with the crowded warps of
//      its slice, so the longest chains start first and a voxel's slices
//      run on different SMs. It keeps a ring of kStages chunks of 32 vote
//      rows in shared memory, filled by asynchronous copies kStages chunks
//      ahead of its adds and across voxels: 16-byte cp.async of the rows'
//      slices where F % 4 == 0 and feats is 16-byte aligned (the
//      production F = 96), else 4-byte cp.async a channel (the same ring,
//      the same adds; splat_row_path says which). The votes' points and
//      weights go by 4-byte cp.async into a ring of notes kStages chunks
//      before their rows. Each lane adds its channel of a chunk's rows
//      from shared memory in order, all 32 loaded before the chain; a
//      ring column past the slice's features holds 1.0f, so the
//      density lane adds w * 1 = w with the same instructions. A light
//      warp sums whole voxels of at most 32 votes, all channels, 4 a lane,
//      the rows loaded 8 at a time.
// The [4P, F + 1] update tensor the plain version builds is never built;
// no float atomics; each output float is written once.
// Choices, with what was measured on the H100 while choosing them:
// - The ring is filled by the warp that adds, with cp.async waited by
//   cp.async.wait_group (6 cycles a chunk once the ring runs), not with
//   cp.async.bulk on an mbarrier: an mbarrier arrive releases, so it
//   waits for every load and copy the arriving thread still has in
//   flight (0.5 to 1.4 us a chunk, the ring serialised); bulk copies of
//   128-byte rows were slower than 16-byte cp.async (three cells 503-516
//   against 320-348 us); a producer warp beside a consumer warp (rows on
//   cp.async.mbarrier.arrive.noinc) measured the same as one warp (main
//   path 49.7-53.4 against 49.7 us) and is not kept.
// - Static shared memory under 48 KB (37 KB a block: no
//   cudaFuncSetAttribute) and at most 128 registers a thread: four blocks
//   an SM, one wave (three waves at 124 registers with 6 warps a block
//   started the last blocks 18.8 us late).
// - Crowded voxels by the ring, light ones by plain loads on more warps:
//   one ring chunk costs about 1,000 cycles of the warp's own
//   instructions, which a voxel of one or two votes (most voxels when
//   points spread over the grid) cannot repay.
// - Zeros and flags beside the first pass, not in voxel_sums: 3 to 6 us
//   less on the main path; under their stores the sort's round trips
//   stretch, so the overlap is partial.
// - Items in round robin, not from an atomic queue (one atomic per voxel
//   per warp serialises on a single address).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kMaxPasses = 4;  // cells below 2^31
constexpr int kKeyThreads = 256;  // 64 points x 4 corners
constexpr int kKeyPoints = kKeyThreads / 4;
constexpr int kSortThreads = 256;  // one digit a thread
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kPer = 2;  // votes a thread in a sort tile
constexpr int kTile = kSortThreads * kPer;
constexpr int kScanPer = 16;  // counts a thread in a scan span
// of the first pass's launch: the flagging and the zeroing blocks
constexpr int kFlagBlocks = 132;
constexpr int kZeroBlocks = 264;
constexpr int kSpan = kSortThreads * kScanPer;
constexpr int kClasses = 4;  // > 2048, > 256, > 32 votes, the rest
constexpr int kStages = 8;  // chunks in a warp's ring
constexpr int kRows = 32;  // votes a chunk
constexpr int kSumPerSM = 4;  // blocks an SM (registers and shared memory)
constexpr int kSumBlocks = 132 * kSumPerSM;  // one wave on an H100
constexpr int kSumWarps = 4;  // a block's crowded warp and 3 light warps
// look-back words: flag in the high half, a count in the low half
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
// chunk flags: a chunk, the voxel's first, its last, its element's voxel 0
constexpr int kChunk = 1, kFirst = 2, kLast = 4, kZero = 8;
constexpr int kWindow = 8;  // look-back words read together

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

// Device pointers into the workspace (see layout()), and the sizes.
struct Args {
  const float* xy;
  const float* feats;
  float* out;
  int B, P, F, H, W, passes;
  int vec;  // feats rows 16-byte aligned (F % 4 == 0)
  long long V;  // B * H * W voxels
  int* keys0;  // [B * 4P] cell or -1, in ordinal order
  int* keys[2];  // ping-pong of the sort's keys
  int* vals[2];  // ... and its ordinals, or at the end its points
  float* w0;  // [B * 4P] each vote's weight, in ordinal order
  float* wb[2];  // ping-pong of the weights through the sort
  float* wts;  // the sorted votes' weights (beside the last vals)
  int* counts;  // [V] votes per voxel
  int* hist;  // [passes][B][kRadix] digit counts per element
  int* nonfinite;  // [B * F] a non-finite feature off the grid
  int* list_n;  // [kClasses] entries per list
  int* tile_next;  // [kMaxPasses] the sort's tile counters
  int* span_next;  // the scan's span counter
  unsigned long long* span_state;  // [spans] look-back words
  unsigned long long* tile_state;  // [passes][B * tiles][kRadix]
  long long tile_state_words;
  int4* lists[kClasses];  // {voxel, first slot, end, kZero or 0}
  int tiles;  // sort tiles per element
};

__device__ __forceinline__ unsigned long long load_state(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_state(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Decoupled look-back: publish `count` at state[0] and return the sum of
// the counts of the `depth` words before it, state[-step], ...,
// state[-depth * step], the first of which publishes a prefix at once.
// kWindow words are read together; a word not yet published is read again.
__device__ __forceinline__ unsigned look_back(unsigned long long* state,
                                              long long step, long long depth,
                                              unsigned count) {
  if (depth == 0) {
    store_state(state, kPrefix | count);
    return 0;
  }
  store_state(state, kAggregate | count);
  unsigned before = 0;
  for (long long j = 1;;) {  // the distance of the window's first word
    unsigned long long x[kWindow];
#pragma unroll
    for (int u = 0; u < kWindow; ++u)
      x[u] = j + u <= depth ? load_state(state - (j + u) * step) : kPrefix;
    int stop = kWindow;  // the first word not yet published
    bool found = false;
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {
      if (found || stop < kWindow) continue;
      const unsigned long long flag = x[u] & ~0xffffffffull;
      if (flag == 0) {
        stop = u;
      } else {
        before += (unsigned)x[u];
        found = flag == kPrefix;
      }
    }
    if (found) break;
    j += stop;
  }
  store_state(state, kPrefix | (before + count));
  return before;
}

// The non-finite flags: the warp's 8 points from p0 (flat over the batch,
// all of element b, k the lane's corner; valid: its corner lies on the
// grid), their rows read together where a corner is off the grid.
__device__ __forceinline__ void flag_nonfinite(const Args& a, int b,
                                               long long p0, int p,
                                               bool valid) {
  const int lane = threadIdx.x & 31;
  const unsigned off = __ballot_sync(kFull, p < a.P && !valid);
  const unsigned off_pts = (off | off >> 8 | off >> 16 | off >> 24) & 0xffu;
  if (off_pts && a.F > 0) {
    // their rows in units of 4 floats where rows are 16-byte aligned
    const int U = a.vec ? a.F / 4 : a.F;  // units a row
    const int n_off = __popc(off_pts);
    const int total = n_off * U;
    for (int e0 = 0; e0 < total; e0 += 32 * 8) {
      float4 v[8];
      int ch[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // 8 loads in flight a lane
        const int e = e0 + u * 32 + lane;
        const int i = e / U;
        ch[u] = e - i * U;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e < total) {
          unsigned m = off_pts;  // its i-th point
          for (int t = 0; t < i; ++t) m &= m - 1u;
          const long long row = (p0 + __ffs(m) - 1) * a.F;
          if (a.vec)
            v[u] = __ldg((const float4*)(a.feats + row) + ch[u]);
          else
            v[u].x = __ldg(a.feats + row + ch[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        for (int h = 0; h < 4; ++h)
          if ((__float_as_uint(f[h]) & 0x7f800000u) == 0x7f800000u)
            atomicOr(&a.nonfinite[b * a.F + (a.vec ? 4 * ch[u] + h : ch[u])],
                     1);  // inf or NaN
      }
    }
  }
}

// 1. A thread per vote: lane = 8 * k + i holds corner k of point 8w + i of
// the block's 64 (the keys of a corner are stored 8 together).
// Block x covers points 64 (x % blocks) .. of element x / blocks.
__global__ void __launch_bounds__(kKeyThreads)
vote_keys(Args a, int blocks) {
  __shared__ int hist[kMaxPasses][kRadix];
  const int b = blockIdx.x / blocks, bx = blockIdx.x - b * blocks;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int k = lane >> 3;
  const int p = bx * kKeyPoints + w * 8 + (lane & 7);
  for (int i = threadIdx.x; i < a.passes * kRadix; i += kKeyThreads)
    (&hist[0][0])[i] = 0;
  {  // zero the sort's look-back words for this call
    const long long grid_threads = (long long)gridDim.x * kKeyThreads;
    const long long me = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
    int4* z = (int4*)a.tile_state;
    for (long long i = me; i < a.tile_state_words / 2; i += grid_threads)
      z[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  bool valid = false;
  int cell = -1;
  if (p < a.P) {
    const float* q = a.xy + 2 * ((long long)b * a.P + p);
    const Corner c = corner(q[0], q[1], k, a.H, a.W);
    valid = c.valid;
    cell = valid ? c.index : -1;
    const long long ord = (long long)b * 4 * a.P + (long long)k * a.P + p;
    a.keys0[ord] = cell;
    a.w0[ord] = c.w;
  }
  // equal keys of the warp: one atomic each
  const unsigned peers = __match_any_sync(kFull, cell);
  if (valid && (peers & ((1u << lane) - 1u)) == 0) {
    const int n = __popc(peers);
    atomicAdd(&a.counts[(long long)b * a.H * a.W + cell], n);
    for (int pass = 0; pass < a.passes; ++pass)
      atomicAdd(&hist[pass][(cell >> (kRadixBits * pass)) & (kRadix - 1)],
                n);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.passes * kRadix; i += kKeyThreads) {
    const int n = (&hist[0][0])[i];
    if (n) atomicAdd(&a.hist[((i / kRadix) * a.B + b) * kRadix + i % kRadix],
                     n);
  }
}

// The exclusive prefix over the block of each thread's x; *total gets the
// block's sum. Uses warp_sums[kSortWarps].
__device__ __forceinline__ int block_exclusive(int x, int* warp_sums,
                                               int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[wid] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int v = 0; v < kSortWarps; ++v) {
    before += v < wid ? warp_sums[v] : 0;
    all += warp_sums[v];
  }
  __syncthreads();  // warp_sums is written again
  *total = all;
  return before + inc - x;
}

struct SortShared {
  int whist[kSortWarps][kRadix];
  int off[kRadix];
  int warp_sums[kSortWarps];
};

// 2a. One tile of one element's votes, scattered stably by the pass's
// digit. Warp w holds the tile's votes w * 64 .. w * 64 + 63, 32 a round;
// a vote's place is its digit's offset in the element, plus that digit's
// votes in the element's earlier tiles (look-back), in the earlier warps,
// rounds and lanes.
__device__ void sort_tile(const Args& a, int t, int pass, SortShared& s) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = t / a.tiles, lt = t - b * a.tiles;
  const long long four_p = 4LL * a.P;
  for (int i = threadIdx.x; i < kSortWarps * kRadix; i += kSortThreads)
    (&s.whist[0][0])[i] = 0;
  // thread d: digit d's votes in this element and in the elements before
  const int* h = a.hist + (long long)pass * a.B * kRadix + threadIdx.x;
  int earlier = 0;
  for (int e = 0; e < b; ++e) earlier += h[e * kRadix];
  int on_grid, seg;  // the element's votes on the grid, its first slot
  const int below = block_exclusive(h[b * kRadix], s.warp_sums, &on_grid);
  block_exclusive(earlier, s.warp_sums, &seg);
  const int len = pass == 0 ? (int)four_p : on_grid;
  const long long in0 = pass == 0 ? b * four_p : seg;
  if (lt * kTile >= len) return;  // uniform: no later tile has votes
  const int shift = kRadixBits * pass;
  const bool last = pass == a.passes - 1;
  const int* kin = pass == 0 ? a.keys0 : a.keys[(pass - 1) & 1];
  const int* vin = pass == 0 ? nullptr : a.vals[(pass - 1) & 1];
  const float* win = pass == 0 ? a.w0 : a.wb[(pass - 1) & 1];
  int key[kPer], val[kPer], dig[kPer], rank[kPer];
  float wt[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = lt * kTile + w * (kTile / kSortWarps) + r * 32 + lane;
    bool ok = i < len;
    key[r] = ok ? kin[in0 + i] : -1;
    val[r] = ok ? (vin ? vin[in0 + i] : (int)(in0 + i)) : 0;
    wt[r] = ok ? win[in0 + i] : 0.0f;
    ok = ok && key[r] >= 0;  // the first pass drops off-grid votes
    dig[r] = ok ? (key[r] >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(kFull, dig[r]);
    const int before = __popc(peers & ((1u << lane) - 1u));
    const int seen = ok ? s.whist[w][dig[r]] : 0;
    __syncwarp();
    if (ok && before == 0) s.whist[w][dig[r]] = seen + __popc(peers);
    __syncwarp();
    rank[r] = seen + before;
  }
  __syncthreads();
  {  // thread d: digit d's offsets
    const int d = threadIdx.x;
    int count = 0;
    for (int v = 0; v < kSortWarps; ++v) {
      const int c = s.whist[v][d];
      s.whist[v][d] = count;
      count += c;
    }
    const unsigned before = look_back(
        a.tile_state + ((long long)pass * a.B * a.tiles + t) * kRadix + d,
        kRadix, lt, (unsigned)count);
    s.off[d] = seg + below + (int)before;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (dig[r] == kRadix) continue;
    const int pos = s.off[dig[r]] + s.whist[w][dig[r]] + rank[r];
    if (!last) {
      a.keys[pass & 1][pos] = key[r];
      a.vals[pass & 1][pos] = val[r];
      a.wb[pass & 1][pos] = wt[r];
      continue;
    }
    const int e = (int)(val[r] / four_p);
    const int q = val[r] - (int)(e * four_p);
    const int k = q / a.P;
    a.vals[pass & 1][pos] = (int)((long long)e * a.P + q - k * a.P);
    a.wts[pos] = wt[r];
  }
}

struct ScanShared {
  int warp_sums[kSortWarps];
  int prefix;
  int at[kClasses];  // the block's first entry in each list
};

__device__ __forceinline__ int size_class(int n) {
  return n > 2048 ? 0 : n > 256 ? 1 : n > 32 ? 2 : 3;
}

// 2b. One span of kSpan voxel counts: each voxel's first slot in the
// sorted votes (the counts before it: look-back over the spans), and an
// entry in its size class's list for each voxel with a vote, and for
// each element's voxel 0. A block takes its places in the lists with one
// atomic a class.
__device__ void scan_span(const Args& a, int span, ScanShared& s) {
  const long long base = (long long)span * kSpan + kScanPer * threadIdx.x;
  const long long HW = (long long)a.H * a.W;
  int c[kScanPer];
  int sum = 0, mine[kClasses] = {0, 0, 0, 0};
  unsigned listed = 0;  // bit k: voxel base + k gets an entry
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    c[k] = base + k < a.V ? a.counts[base + k] : 0;
    sum += c[k];
    if (base + k < a.V && (c[k] > 0 || (base + k) % HW == 0)) {
      listed |= 1u << k;
      ++mine[size_class(c[k])];
    }
  }
  int total;
  int run = block_exclusive(sum, s.warp_sums, &total);
  // each thread's first place in each class's list: two scans of two
  // 16-bit counts (a block lists at most kSpan voxels a class)
  int t01, t23;
  const int x01 = block_exclusive(mine[0] | mine[1] << 16, s.warp_sums, &t01);
  const int x23 = block_exclusive(mine[2] | mine[3] << 16, s.warp_sums, &t23);
  if (threadIdx.x == 0)
    s.prefix = (int)look_back(a.span_state + span, 1, span, (unsigned)total);
  if (threadIdx.x >= 32 && threadIdx.x < 32 + kClasses) {  // in parallel
    const int q = threadIdx.x - 32;
    const int tot = (q < 2 ? t01 : t23) >> (16 * (q & 1)) & 0xffff;
    s.at[q] = tot ? atomicAdd(&a.list_n[q], tot) : 0;
  }
  __syncthreads();
  int at[kClasses] = {s.at[0] + (x01 & 0xffff), s.at[1] + (x01 >> 16),
                      s.at[2] + (x23 & 0xffff), s.at[3] + (x23 >> 16)};
  run += s.prefix;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    if (listed >> k & 1u) {
      const int q = size_class(c[k]);
      a.lists[q][at[q]++] = make_int4((int)(base + k), run, run + c[k],
                                      (base + k) % HW == 0 ? kZero : 0);
    }
    run += c[k];
  }
}

// Zeros over out[fa, fb) by the warp: 16-byte stores between the
// 16-byte boundaries, single floats at the ends.
template <typename T>
__device__ __forceinline__ void zero_range(float* out, T fa, T fb) {
  const int lane = threadIdx.x & 31;
  const T a4 = (fa + 3) / 4 * 4, b4 = fb / 4 * 4;
  if (a4 >= b4) {
    for (T f = fa + lane; f < fb; f += 32) out[f] = 0.0f;
    return;
  }
  if (fa + lane < a4) out[fa + lane] = 0.0f;
  if (b4 + lane < fb) out[b4 + lane] = 0.0f;
  float4* out4 = (float4*)out;
  for (T i = a4 / 4 + lane; i < b4 / 4; i += 32)
    out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Zeros over the rows of this warp's share (share of shares) of the
// voxels, but for those that a list entry writes: each element's
// voxel 0 and the voxels with a vote. 32 voxels at a time, the next 32's
// counts in flight; each run of unlisted voxels among them is one
// contiguous range of the output. T, the index type, 32 bits where the
// output allows.
template <typename T>
__device__ void zero_unlisted(const Args& a, unsigned share,
                              unsigned shares) {
  const T C = (T)a.F + 1, HW = (T)a.H * (T)a.W;
  const int lane = threadIdx.x & 31;
  const T vlo = (T)((unsigned long long)a.V * share / shares);
  const T vhi = (T)((unsigned long long)a.V * (share + 1) / shares);
  auto unlisted = [&](T v0) {  // lane's voxel of the 32 from v0
    const T v = v0 + lane;
    return v < vhi && v % HW != 0 && a.counts[v] == 0;
  };
  bool mine = unlisted(vlo);
  for (T v0 = vlo; v0 < vhi; v0 += 32) {
    unsigned rest = __ballot_sync(kFull, mine);
    mine = unlisted(v0 + 32);
    while (rest) {  // runs of set bits
      const int r0 = __ffs(rest) - 1;
      const unsigned gap = ~(rest >> r0);
      const int len = gap ? __ffs(gap) - 1 : 32 - r0;
      zero_range<T>(a.out, (v0 + r0) * C, (v0 + r0 + len) * C);
      rest &= len == 32 ? 0u : ~(((1u << len) - 1u) << r0);
    }
  }
}

// Zeros over share `share` of `shares` of the unlisted voxels.
__device__ __forceinline__ void zero_all(const Args& a, unsigned share,
                                         unsigned shares) {
  if (a.V * (a.F + 1) + 32LL * (a.F + 1) < (1LL << 32))
    zero_unlisted<unsigned>(a, share, shares);
  else
    zero_unlisted<unsigned long long>(a, share, shares);
}

// 2. One pass of the sort. The first pass's launch holds more blocks
// after the sort's: `spans` that scan the counts, `flagging` that set the
// non-finite flags from the off-grid votes' rows, and the rest, which write
// zeros over the voxels that no list holds. These need only vote_keys'
// results, and their loads and streaming stores run beside the sort's
// latency-bound tiles. The sort's and the scan's blocks take their tiles
// in the order of their own counters.
__global__ void __launch_bounds__(kSortThreads)
sort_pass(Args a, int pass, int sort_blocks, int spans, int flagging) {
  __shared__ union {
    SortShared sort;
    ScanShared scan;
  } s;
  __shared__ int id;
  const int extra = (int)blockIdx.x - sort_blocks - spans;
  if (extra >= 0) {
    const int per = kSortThreads / 32, warp = threadIdx.x >> 5;
    if (extra < flagging) {  // 8 points a warp, as vote_keys holds them
      const int lane = threadIdx.x & 31, k = lane >> 3;
      const long long groups_b = (a.P + 7) / 8, groups = groups_b * a.B;
      for (long long g = (long long)extra * per + warp; g < groups;
           g += (long long)flagging * per) {
        const int b = (int)(g / groups_b);
        const int p0 = (int)(g - b * groups_b) * 8, p = p0 + (lane & 7);
        const bool valid =
            p < a.P &&
            a.keys0[(long long)b * 4 * a.P + (long long)k * a.P + p] >= 0;
        flag_nonfinite(a, b, (long long)b * a.P + p0, p, valid);
      }
      return;
    }
    const unsigned zeroing = (unsigned)(gridDim.x - sort_blocks - spans -
                                        flagging);
    zero_all(a, (extra - flagging) * per + warp, zeroing * per);
    return;
  }
  const bool scan = (int)blockIdx.x >= sort_blocks;
  if (threadIdx.x == 0)
    id = atomicAdd(scan ? a.span_next : &a.tile_next[pass], 1);
  __syncthreads();
  if (scan)
    scan_span(a, id, s.scan);
  else
    sort_tile(a, id, pass, s.sort);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A chunk of at most kRows votes of one voxel: sorted slots [row, row + m).
struct Chunk {
  int voxel, row, m, flags;  // flags 0: no chunk
};

// A warp's voxels, in list order from its first, every `stride`-th; the
// entries read 32 at a time, one a lane.
struct Walk {
  int next, stride, n;  // list index of batch lane 0, the step, the total
  int n0, n1, n2;  // class boundaries in the concatenated lists
  int4 e;  // this lane's entry of the batch
  int at;  // batch lane of the current voxel
  int voxel, lo, hi, row, zero;  // the current voxel, the next chunk's slot

  __device__ int4 entry(const Args& a, int L) const {
    if (L < n0) return a.lists[0][L];
    if (L < n1) return a.lists[1][L - n0];
    if (L < n2) return a.lists[2][L - n1];
    return a.lists[3][L - n2];
  }
  __device__ void batch(const Args& a) {
    const int L = next + (threadIdx.x & 31) * stride;
    e = L < n ? entry(a, L) : make_int4(-1, 0, 0, 0);
    at = 0;
  }
  __device__ void voxel_from_batch() {
    voxel = __shfl_sync(kFull, e.x, at);
    lo = row = __shfl_sync(kFull, e.y, at);
    hi = __shfl_sync(kFull, e.z, at);
    zero = __shfl_sync(kFull, e.w, at);
  }
  // the next chunk (flags 0 when the warp's voxels are done)
  __device__ Chunk take(const Args& a) {
    Chunk c{voxel, row, min(kRows, hi - row), 0};
    if (voxel < 0) return c;
    c.flags = kChunk | zero | (row == lo ? kFirst : 0) |
              (row + kRows >= hi ? kLast : 0);
    row += kRows;
    if (c.flags & kLast) {
      if (++at == 32) {
        next += 32 * stride;
        batch(a);
      }
      voxel_from_batch();
    }
    return c;
  }
};

// A voxel's channel c as written: voxel 0 of an element (flags kZero)
// holds NaN where an off-grid vote of the element carried a non-finite
// feature.
__device__ __forceinline__ float finish(float acc, int v, int flags, int c,
                                       const Args& a) {
  if ((flags & kZero) && c < a.F &&
      a.nonfinite[(long long)(v / (a.H * a.W)) * a.F + c])
    return __int_as_float(0x7fffffff);
  return acc;
}

// Zeros over the rows of this warp's share (share of shares) of the
// voxels, but for those that a list entry writes: each element's
// voxel 0 and the voxels with a vote. 32 voxels at a time, the next 32's
// counts in flight: where none of the 32 is listed, one flat run of
// 16-byte stores. T, the index type, 32 bits where the output allows.
// 3b. A light warp: every listed voxel of at most kRows votes (list 3)
// whose index is lw modulo nlw, all channels, 4 a lane a pass of 128:
// the votes' points and weights one a lane, then the feature rows 8 at a
// time (loads in flight together), added in order.
__device__ void light_sums(const Args& a, int lw, int nlw) {
  const int lane = threadIdx.x & 31;
  const int C = a.F + 1;
  const int* pts = a.vals[(a.passes - 1) & 1];
  const int n3 = a.list_n[3];
  for (int L = lw; L < n3; L += nlw) {
    const int4 e = a.lists[3][L];
    const int m = e.z - e.y;
    const int pt = lane < m ? pts[e.y + lane] : 0;
    const float w = lane < m ? a.wts[e.y + lane] : 0.0f;
    for (int c0 = 0; c0 < C; c0 += 128) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j0 = 0; j0 < m; j0 += 8) {
        float v[8][4], wj[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pj = __shfl_sync(kFull, pt, (j0 + j) & 31);
          wj[j] = __shfl_sync(kFull, w, (j0 + j) & 31);
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // channel F adds w * 1
            const int c = c0 + 32 * u + lane;
            v[j][u] = j0 + j < m && c < a.F
                          ? __ldg(a.feats + (long long)pj * a.F + c)
                          : 1.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j0 + j < m) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[u] = __fadd_rn(acc[u], __fmul_rn(wj[j], v[j][u]));
          }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u + lane;
        if (c < C) a.out[(long long)e.x * C + c] = finish(acc[u], e.x, e.w, c, a);
      }
    }
  }
}

// 3. A block of kSumWarps warps. Warp 0, the crowded warp: the slice s =
// blockIdx.x % slices of every (gridDim.x / slices)-th voxel of more than
// kRows votes (lists 0-2, fullest class first). Warps 1 .. kSumWarps - 1:
// light_sums. vec: feats rows by 16-byte cp.async (F % 4 == 0, 16-byte
// aligned), else by 4-byte cp.async.
//
// Chunk i of the crowded warp's walk is taken (its points and weights
// copied by 4-byte cp.async into note slot i % kNotes) kStages chunks
// before its rows are issued into stage i % kStages, and added kStages
// chunks after that. Each step commits one cp.async group (the taken
// chunk's notes and the issued chunk's rows), so waiting until at most
// kStages - 1 groups are pending completes both the rows of the chunk to
// add and the notes of the chunk to issue.
__global__ void __launch_bounds__(32 * kSumWarps, kSumPerSM)
voxel_sums(Args a, int slices) {
  constexpr int kNotes = 2 * kStages;
  __shared__ __align__(128) float ring[kStages][kRows * 32];
  __shared__ __align__(16) int note_pt[kNotes][kRows];
  __shared__ __align__(16) float note_w[kNotes][kRows];
  __shared__ int4 note[kNotes];  // {voxel, first slot, votes, flags}
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp > 0) {
    light_sums(a, blockIdx.x * (kSumWarps - 1) + warp - 1,
               gridDim.x * (kSumWarps - 1));
    return;
  }
  const int s = blockIdx.x % slices;
  const int C = a.F + 1;
  const int c = 32 * s + lane;  // this lane's channel
  const int width = max(0, min(32, a.F - 32 * s));  // feature columns
  if (lane >= width)
    for (int j = 0; j < kStages * kRows; ++j) (&ring[0][0])[j * 32 + lane] =
        1.0f;
  __syncwarp();
  // vec path: the lane copies units lane + 32 r (r < 8) of the chunk's
  // rows of `units` 16-byte units, row ur[r], unit uq[r]
  const int units = max(1, width / 4);
  int ur[8], uq[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    ur[r] = (lane + 32 * r) / units;
    uq[r] = (lane + 32 * r) % units;
  }
  const float* fcol = a.feats + 32 * s;
  const int* pts = a.vals[(a.passes - 1) & 1];

  Walk walk;
  walk.n0 = a.list_n[0];
  walk.n1 = walk.n0 + a.list_n[1];
  walk.n2 = walk.n1 + a.list_n[2];
  walk.n = walk.n2;  // the crowded voxels
  walk.stride = gridDim.x / slices;
  walk.next = blockIdx.x / slices;
  walk.batch(a);
  walk.voxel_from_batch();

  int taken = 0, issued = 0;
  auto take = [&]() {  // the walk's next chunk into the next note slot
    const Chunk ch = walk.take(a);
    if (!ch.flags) return;
    const int n = taken % kNotes;
    if (lane == 0) note[n] = make_int4(ch.voxel, ch.row, ch.m, ch.flags);
    if (lane < ch.m) {
      copy4(&note_pt[n][lane], pts + ch.row + lane);
      copy4(&note_w[n][lane], a.wts + ch.row + lane);
    }
    ++taken;
  };
  auto issue = [&]() {  // the next taken chunk's rows into its stage
    if (issued == taken) return;
    const int n = issued % kNotes, st = issued % kStages;
    const int m = note[n].z;
    float* dst = &ring[st][0];
    if (a.vec && width) {
      int pt[8];  // the rows' points first: the copies order no loads
#pragma unroll
      for (int r = 0; r < 8; ++r) pt[r] = note_pt[n][min(ur[r], kRows - 1)];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (ur[r] < m)
          copy16(dst + ur[r] * 32 + 4 * uq[r],
                 fcol + (long long)pt[r] * a.F + 4 * uq[r]);
    } else if (width) {  // uniform: every lane takes part in the shuffles
      const int mine = note_pt[n][lane];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int pt = __shfl_sync(kFull, mine, j);
        if (j < m && lane < width)
          copy4(dst + j * 32 + lane, fcol + (long long)pt * a.F + lane);
      }
    }
    ++issued;
  };
  auto step_wait = [&]() {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncwarp();
  };
  for (int k = 0; k < kStages; ++k) take();
  copy_commit();
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  for (int k = 0; k < kStages; ++k) {
    issue();
    take();
    copy_commit();
  }

  float acc = 0.0f;
  for (int done = 0; done < issued; ++done) {
    step_wait();
    const int st = done % kStages, n = done % kNotes;
    const int4 md = note[n];
    if (md.w & kFirst) acc = 0.0f;
    const float* col = &ring[st][lane];
    const float* wv = note_w[n];
    float f[kRows], wj[kRows];  // all loads first, then the chain of adds
#pragma unroll
    for (int j = 0; j < kRows; j += 4) {
      const float4 w4 = *(const float4*)(wv + j);
      wj[j] = w4.x;
      wj[j + 1] = w4.y;
      wj[j + 2] = w4.z;
      wj[j + 3] = w4.w;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) f[j] = col[j * 32];
    if (md.z == kRows) {  // a full chunk: no test in the chain
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc = __fadd_rn(acc, __fmul_rn(wj[j], f[j]));
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j < md.z) acc = __fadd_rn(acc, __fmul_rn(wj[j], f[j]));
    }
    if ((md.w & kLast) && c < C)
      a.out[(long long)md.x * C + c] = finish(acc, md.x, md.w, c, a);
    __syncwarp();  // the stage and the note are read: both may be refilled
    issue();
    take();
    copy_commit();
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
  long long n, v, spans, tiles, passes, total;
  long long keys0, keys[2], vals[2], w0, wb[2], wts, counts, hist,
      nonfinite,
      list_n, tile_next, span_next, span_state, zero_end, tile_state,
      tile_state_words, lists[kClasses], caps[kClasses];
};

Layout layout(int B, int P, int H, int W, int F) {
  Layout l;
  l.n = 4LL * B * P;
  l.v = (long long)B * H * W;
  l.spans = (l.v + kSpan - 1) / kSpan;
  l.tiles = (4LL * P + kTile - 1) / kTile;
  l.passes = (bit_length((long long)H * W - 1) + kRadixBits - 1) / kRadixBits;
  if (l.passes < 1) l.passes = 1;
  long long at = 0;
  auto take = [&at](long long count) {  // 16-byte aligned
    const long long here = at;
    at += (count + 3) / 4 * 4;
    return here;
  };
  l.keys0 = take(l.n);
  for (int i = 0; i < 2; ++i) {
    l.keys[i] = take(l.n);
    l.vals[i] = take(l.n);
  }
  l.w0 = take(l.n);  // floats
  for (int i = 0; i < 2; ++i) l.wb[i] = take(l.n);
  l.wts = take(l.n);
  // zeroed by one memset: counts .. span_state
  l.counts = take(l.v);
  l.hist = take(l.passes * B * kRadix);
  l.nonfinite = take((long long)B * F);
  l.list_n = take(kClasses);
  l.tile_next = take(kMaxPasses);
  l.span_next = take(1);
  l.span_state = take(2 * l.spans);  // u64
  l.zero_end = at;
  // zeroed by vote_keys
  l.tile_state_words = l.passes * B * l.tiles * kRadix;
  l.tile_state = take(2 * l.tile_state_words);  // u64
  const long long most = l.v < l.n ? l.v : l.n;
  const long long lower[kClasses] = {2048, 256, 32, 0};
  for (int q = 0; q < kClasses; ++q) {
    long long cap = l.n / (lower[q] + 1);
    if (cap > most) cap = most;
    l.caps[q] = cap + (q == kClasses - 1 ? B : 0);
    l.lists[q] = take(4 * l.caps[q]);  // int4
  }
  l.total = at;
  return l;
}

}  // namespace

// The ints of workspace splat_sums needs for these sizes.
extern "C" long long splat_sums_workspace(int B, int P, int H, int W, int F) {
  return layout(B, P, H, W, F).total;
}

// How splat_sums feeds the feature rows of feats [B, P, F] to the crowded
// voxels' adds: 2, 16-byte cp.async of each row's slice (F % 4 == 0, feats
// 16-byte aligned); 1, 4-byte cp.async a channel; 0, no rows (F == 0).
extern "C" int splat_row_path(const void* feats, int F) {
  if (F == 0) return 0;
  return F % 4 == 0 && (uintptr_t)feats % 16 == 0 ? 2 : 1;
}

// out [B, H*W, F+1] from xy [B, P, 2] and feats [B, P, F] (f32, contiguous,
// on the card) on `stream`, with `work` of splat_sums_workspace ints. The
// caller checks the sizes: 4 * B * P and B * H * W + 1 below 2^31, B, H, W
// >= 1, P, F >= 0. Returns a cudaError_t (0: launched).
extern "C" int splat_sums(const void* xy, const void* feats, void* out,
                          void* work, int B, int P, int F, int H, int W,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Layout l = layout(B, P, H, W, F);
  int* ws = (int*)work;
  Args a;
  a.xy = (const float*)xy;
  a.feats = (const float*)feats;
  a.out = (float*)out;
  a.B = B;
  a.P = P;
  a.F = F;
  a.H = H;
  a.W = W;
  a.passes = (int)l.passes;
  a.vec = splat_row_path(feats, F) == 2;
  a.V = l.v;
  a.keys0 = ws + l.keys0;
  for (int i = 0; i < 2; ++i) {
    a.keys[i] = ws + l.keys[i];
    a.vals[i] = ws + l.vals[i];
  }
  a.w0 = (float*)(ws + l.w0);
  for (int i = 0; i < 2; ++i) a.wb[i] = (float*)(ws + l.wb[i]);
  a.wts = (float*)(ws + l.wts);
  a.counts = ws + l.counts;
  a.hist = ws + l.hist;
  a.nonfinite = ws + l.nonfinite;
  a.list_n = ws + l.list_n;
  a.tile_next = ws + l.tile_next;
  a.span_next = ws + l.span_next;
  a.span_state = (unsigned long long*)(ws + l.span_state);
  a.tile_state = (unsigned long long*)(ws + l.tile_state);
  a.tile_state_words = l.tile_state_words;
  for (int q = 0; q < kClasses; ++q) a.lists[q] = (int4*)(ws + l.lists[q]);
  a.tiles = (int)l.tiles;
  cudaError_t err = cudaMemsetAsync(
      ws + l.counts, 0, (l.zero_end - l.counts) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const unsigned key_blocks =
      (unsigned)(P > 0 ? (P + kKeyPoints - 1) / kKeyPoints : 1);
  vote_keys<<<key_blocks * (unsigned)B, kKeyThreads, 0, st>>>(
      a, (int)key_blocks);
  const int sort_blocks = l.n > 0 ? (int)(B * l.tiles) : 0;
  const int last = l.n > 0 ? a.passes - 1 : 0;
  for (int pass = 0; pass <= last; ++pass) {
    const int spans = pass == 0 ? (int)l.spans : 0;
    const int flagging = pass == 0 && F > 0 && P > 0 ? kFlagBlocks : 0;
    sort_pass<<<(unsigned)(sort_blocks + spans + flagging +
                           (pass == 0 ? kZeroBlocks : 0)),
                kSortThreads, 0, st>>>(a, pass, sort_blocks, spans, flagging);
  }
  const int slices = (F + 1 + 31) / 32;
  const int blocks =
      kSumBlocks >= slices ? kSumBlocks / slices * slices : slices;
  voxel_sums<<<(unsigned)blocks, 32 * kSumWarps, 0, st>>>(a, slices);
  return (int)cudaGetLastError();
}

extern "C" const char* splat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
