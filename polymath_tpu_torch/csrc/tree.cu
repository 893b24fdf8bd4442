// The MSM's group-law tree after the bucket scan: the row offsets and the
// window fold of ops/msm.py (steps 4 and 5).  Replaces, for that tree, the
// launch-by-launch composition over
//   polymath_tpu/ops/pallas_curve.py:_add_kernel (B5), as
//   curve_jax.prefix_scan_jac_tree and curve_jax.tree_sum_jac use it:
// 11 Hillis-Steele launches of g1_add_kernel over the row totals, each
// behind a torch.cat, one launch to add the offsets, and 13 halving
// launches for the fold, 25 a chunk.  Here it is at most 3:
//
//   g1_row_scan_kernel   row totals -> each segment's exclusive prefix and
//                        total; block (segment, window);
//   g1_row_carry_kernel  adds the earlier segments' totals to the prefix of
//                        each segment but the first: the exclusive row
//                        offsets (not launched for a single segment);
//   g1_fold_kernel       each threshold prefix + its row's offset,
//                        thresholds with no digit dropped, summed per
//                        (window, slice) in shared memory; the last block
//                        of a window to finish sums the slices' partials.
//
// and one more kernel after the chunks, for the adds across them:
//
//   g1_sum_sets_kernel   k sets of window sums (k, 36, W) -> their sum
//                        (36, W), one launch: the chunks' sums of one MSM
//                        (ops/msm.py), or the ranks' (parallel/
//                        msm_sharded.py).  It replaces the reference's
//                        fori_loop of jac_add over the chunks
//                        (polymath_tpu/ops/msm.py:325-336) and its scan
//                        over the ranks (parallel/msm_sharded.py:25-34),
//                        k - 1 launches of g1_add_kernel in a chain.
//
// g1_add_kernel stays for its other callers.  All four kernels call
// jac_add of g1.cuh unchanged.  jac_add is complete (an identity operand
// returns the other, P + P doubles, P + (-P) gives the identity), so the
// sums are the same group elements as the composition's, but added in
// another order: the Jacobian words may differ from it, their affine
// points do not, and neither do the proofs.  No fast-mode flag is needed.
//
// Bound on the H100: integer multiplies, 8,748 32-bit multiply-adds a
// jac_add.  At the bench chunk (W = 20, rows = 2048, 2^13 thresholds) the
// work is about 2 x 20 x 2048 adds for the offsets (a work-efficient scan),
// where Hillis-Steele took 11 x 40,960, and at most 2 x 163,840 adds to
// offset and sum the thresholds (a sum of ps + offset is summed as ps, then
// offset), where the old fold halved 2^13 x 20 lanes over 13 launches.
// Bytes are small (each point 144 B, read once or twice).
//
// What bounds them in practice is latency: a jac_add is a chain of 16
// dependent Montgomery products, tens of microseconds for one warp, and a
// thread's adds depend on each other.  So the work is cut into as many
// blocks as the card holds at once (one wave; the wrapper reads the
// occupancy), each thread's chain is short (2 rows or about 5 thresholds,
// then 7 levels in shared memory), and one block a window, which left 20
// SMs working through 39 dependent adds a thread, is split into segments
// joined by the carry pass.
//
// The sum of sets is tiny (at most 40 x 20 adds at the bench workload,
// 8,748 multiply-adds each: a bound under a microsecond), so only its
// critical path counts: one block a window, the window's k <= 128 sets
// staged in shared memory, then ceil(log2 k) levels of pairwise adds: 6
// dependent adds for the 40 chunks of the d MSM, 2 for 4 chunks, where the
// chain took 39 and 3 launches of one add each.  More sets than a block
// holds take more launches of the same kernel (ops/cuda_tree.py).
//
// Built with a host compiler, the kernels are the bodies alone (no launch
// code): tests/test_torch_tree.py runs them under a host emulation of a
// block.
#include "g1.cuh"
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kTreeThreads = 128;
constexpr int kLevels = 7;  // log2(kTreeThreads)

// Points in shared memory as [36][kTreeThreads] words: thread t's point at
// column t, so a warp's accesses hit 32 different banks.
__device__ __forceinline__ Jac sm_load(const uint32_t* sm, int t) {
  return load_jac(sm, kTreeThreads, t);
}

__device__ __forceinline__ void sm_store(uint32_t* sm, int t, const Jac& a) {
  store_jac(sm, kTreeThreads, t, a);
}

// A point another block wrote in this launch: loaded past L1.
__device__ __forceinline__ Jac load_jac_cg(const uint32_t* p, long stride,
                                           long i) {
  Jac r;
#pragma unroll
  for (int k = 0; k < FqP::N; ++k) {
    r.x.w[k] = __ldcg(p + k * stride + i);
    r.y.w[k] = __ldcg(p + (12 + k) * stride + i);
    r.z.w[k] = __ldcg(p + (24 + k) * stride + i);
  }
  return r;
}

// Each kernel is a loop of steps acc = jac_add(acc, b) with ONE call site
// of jac_add: ptxas inlines a single call, as in g1_add_kernel, where
// several call sites compile to calls whose saved state spills.  A step
// with live == false adds nothing.  Shared-memory steps are pairwise
// halving or Hillis-Steele levels over the kTreeThreads values of acc.

// totals: word k of (window w, row r) at totals[k * t_stride + w * rows + r].
// Block (j, w) owns the rows [j * seg, (j + 1) * seg) of window w and writes
// rel (36, windows, rows): rel[., w, r] = the sum of the segment's totals at
// rows < r (the identity at the segment's first row), and
// seg_tot[., w, j] of (36, windows, gridDim.x), the segment's total.
// Thread t owns the rows [lo, hi) = [j * seg + t * per, ... + per); steps
//   [0, per)                  acc += its rows (its run's total);
//   [per, per + kLevels)      an inclusive scan of the run totals;
//   [per + kLevels, end)      acc = the earlier runs' total, then each row
//                             stores acc and adds its total.
__global__ void __launch_bounds__(kTreeThreads)
g1_row_scan_kernel(const uint32_t* totals, long t_stride, uint32_t* rel,
                   uint32_t* seg_tot, long windows, long rows, long seg) {
  __shared__ uint32_t sm[36 * kTreeThreads];
  const int t = threadIdx.x;
  const long w = blockIdx.y, j = blockIdx.x, segs = gridDim.x;
  const long s1 = (j + 1) * seg < rows ? (j + 1) * seg : rows;
  const long per = (seg + kTreeThreads - 1) / kTreeThreads;
  const long lo = j * seg + t * per < s1 ? j * seg + t * per : s1;
  const long hi = lo + per < s1 ? lo + per : s1;
  const uint32_t* src = totals + w * rows;
  uint32_t* dst = rel + w * rows;
  Jac acc = jac_identity();
  for (long k = 0; k < 2 * per + kLevels; ++k) {
    Jac b;
    bool live = false;
    if (k < per) {
      live = lo + k < hi;
      if (live) b = load_jac(src, t_stride, lo + k);
    } else if (k < per + kLevels) {
      sm_store(sm, t, acc);
      __syncthreads();
      const int d = 1 << (k - per);
      live = t >= d;
      if (live) b = sm_load(sm, t - d);
      __syncthreads();
    } else {
      if (k == per + kLevels) {  // inclusive -> exclusive
        sm_store(sm, t, acc);
        if (t == kTreeThreads - 1)
          store_jac(seg_tot, windows * segs, w * segs + j, acc);
        __syncthreads();
        acc = t == 0 ? jac_identity() : sm_load(sm, t - 1);
      }
      const long r = lo + (k - per - kLevels);
      if (r < hi) {
        store_jac(dst, windows * rows, r, acc);
        live = r + 1 < hi;
        if (live) b = load_jac(src, t_stride, r);
      }
    }
    if (live) acc = jac_add(acc, b);
  }
}

// Block (j - 1, w), j >= 1: carry = seg_tot[., w, 0] + ... + seg_tot[., w,
// j - 1] (pairwise halving; segs <= kTreeThreads), then each thread adds it
// to the rel rows it owns in segment j, in place: offs = rel + carry.
__global__ void __launch_bounds__(kTreeThreads)
g1_row_carry_kernel(uint32_t* offs, const uint32_t* seg_tot, long windows,
                    long rows, long seg, long segs) {
  __shared__ uint32_t sm[36 * kTreeThreads];
  const int t = threadIdx.x;
  const long w = blockIdx.y, j = blockIdx.x + 1;
  const long s1 = (j + 1) * seg < rows ? (j + 1) * seg : rows;
  const long per = (seg + kTreeThreads - 1) / kTreeThreads;
  const long lo = j * seg + t * per < s1 ? j * seg + t * per : s1;
  const long hi = lo + per < s1 ? lo + per : s1;
  const long o_stride = windows * rows;
  uint32_t* dst = offs + w * rows;
  Jac acc = t < j ? load_jac(seg_tot, windows * segs, w * segs + t)
                  : jac_identity();
  // steps [0, kLevels): the carry, by pairwise halving, into thread 0;
  // then a step per row: acc = carry + rel[r], stored at the next step, so
  // that only acc and b are live across jac_add, as in g1_row_scan_kernel
  for (long k = 0; k <= kLevels + per; ++k) {
    Jac b;
    bool live = false;
    if (k < kLevels) {
      sm_store(sm, t, acc);
      __syncthreads();
      const int h = kTreeThreads >> (k + 1);
      live = t < h;
      if (live) b = sm_load(sm, t + h);
      __syncthreads();
    } else {
      if (k == kLevels) {  // thread 0 holds the carry: hand it to all
        if (t == 0) sm_store(sm, 0, acc);
        __syncthreads();
      } else if (lo + (k - 1 - kLevels) < hi) {
        store_jac(dst, o_stride, lo + (k - 1 - kLevels), acc);
      }
      const long r = lo + (k - kLevels);
      live = k < kLevels + per && r < hi;
      if (live) {
        acc = sm_load(sm, 0);
        b = load_jac(dst, o_stride, r);
      }
    }
    if (live) acc = jac_add(acc, b);
  }
}

// ps (36, windows, n) contiguous.  Block (slice, w) sums the thresholds
// j = (slice * per + i) * kTreeThreads + t, i < per, j < n.  cnt (windows,
// n) int64: a threshold whose count is 0 is the identity (skipped); with
// offs (36, windows, rows) and r_of (windows, n) int64, each threshold also
// adds its row's offset offs[., w, r_of].  Steps: per
// threshold acc += ps (and acc += its offset), then kLevels of pairwise
// halving.  With one slice the block writes out[., w] of (36, windows).
// With several, each block writes its sum to part (36, windows, slices),
// counts itself in count[w] (zeroed by the caller), and the last block of
// the window to do so sums the partials (slices <= kTreeThreads) into out.
__global__ void __launch_bounds__(kTreeThreads)
g1_fold_kernel(const uint32_t* ps, long n, const int64_t* cnt,
               const int64_t* r_of, const uint32_t* offs, long rows,
               uint32_t* part, int* count, uint32_t* out, long windows,
               long per) {
  __shared__ uint32_t sm[36 * kTreeThreads];
  __shared__ int last;
  const int t = threadIdx.x;
  const long w = blockIdx.y, slice = blockIdx.x, slices = gridDim.x;
  const int parts = offs != nullptr ? 2 : 1;
  const long steps = parts * per;
  const long end = steps + kLevels + (slices > 1 ? kLevels : 0);
  Jac acc = jac_identity();
  for (long k = 0; k < end; ++k) {
    Jac b;
    bool live = false;
    if (k < steps) {
      const long j = (slice * per + k / parts) * kTreeThreads + t;
      const long at = w * n + j;
      live = j < n && cnt[at] > 0;
      if (live && k % parts == 0)
        b = load_jac(ps, windows * n, at);
      else if (live)
        b = load_jac(offs, windows * rows, w * rows + r_of[at]);
    } else {
      if (k == steps + kLevels) {  // the block's sum is in thread 0
        if (t == 0) {
          store_jac(part, windows * slices, w * slices + slice, acc);
          __threadfence();
          last = atomicAdd(count + w, 1) == slices - 1;
        }
        __syncthreads();
        if (!last) return;
        __threadfence();
        acc = t < slices ? load_jac_cg(part, windows * slices,
                                       w * slices + t)
                         : jac_identity();
      }
      sm_store(sm, t, acc);
      __syncthreads();
      const int h = kTreeThreads >> ((k - steps) % kLevels + 1);
      live = t < h;
      if (live) b = sm_load(sm, t + h);
      __syncthreads();
    }
    if (live) acc = jac_add(acc, b);
  }
  if (t == 0) store_jac(out, windows, w, acc);
}

// parts (k, 36, windows): word i of window w of set s at
// parts[s * set_stride + i * windows + w].  Block (j, w) sums the sets
// [j * per, min(k, (j + 1) * per)) of window w (per <= kTreeThreads) into
// out[j, ., w] of (gridDim.x, 36, windows): thread t loads set j * per + t,
// then levels of pairwise halving over the n sets of the block, strides
// h = 2^(ceil(log2 n) - 1) down to 1, a step adding only where both sums
// hold a set; the block's sum ends in thread 0.
__global__ void __launch_bounds__(kTreeThreads)
g1_sum_sets_kernel(const uint32_t* parts, long set_stride, long k, long per,
                   uint32_t* out, long windows) {
  __shared__ uint32_t sm[36 * kTreeThreads];
  const int t = threadIdx.x;
  const long w = blockIdx.y, j = blockIdx.x;
  const long n = k - j * per < per ? k - j * per : per;
  Jac acc = t < n ? load_jac(parts + (j * per + t) * set_stride, windows, w)
                  : jac_identity();
  int h = 1;
  while (h < n) h <<= 1;
  for (h >>= 1; h > 0; h >>= 1) {
    sm_store(sm, t, acc);
    __syncthreads();
    Jac b;
    const bool live = t < h && t + h < n;
    if (live) b = sm_load(sm, t + h);
    __syncthreads();
    if (live) acc = jac_add(acc, b);
  }
  if (t == 0) store_jac(out + j * 36 * windows, windows, w, acc);
}

}  // namespace

#ifdef __CUDACC__
template <class K>
static int blocks_per_sm(K kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTreeThreads, 0);
  return n;
}

// Blocks of the tree kernels one SM holds at once (registers and shared
// memory), the least over the three.
extern "C" int pm_tree_blocks_per_sm() {
  int a = blocks_per_sm(g1_row_scan_kernel);
  int b = blocks_per_sm(g1_row_carry_kernel);
  int c = blocks_per_sm(g1_fold_kernel);
  return a < b ? (a < c ? a : c) : (b < c ? b : c);
}

extern "C" int pm_g1_row_scan(const void* totals, long t_stride, void* rel,
                              void* seg_tot, long windows, long rows,
                              long seg, long segs, void* stream) {
  if (windows > 0 && rows > 0)
    g1_row_scan_kernel<<<dim3((unsigned)segs, (unsigned)windows),
                         kTreeThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)totals, t_stride, (uint32_t*)rel,
        (uint32_t*)seg_tot, windows, rows, seg);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_row_carry(void* offs, const void* seg_tot, long windows,
                               long rows, long seg, long segs,
                               void* stream) {
  if (windows > 0 && segs > 1)
    g1_row_carry_kernel<<<dim3((unsigned)(segs - 1), (unsigned)windows),
                          kTreeThreads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)offs, (const uint32_t*)seg_tot, windows, rows, seg, segs);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_fold(const void* ps, long n, const void* cnt,
                          const void* r_of, const void* offs, long rows,
                          void* part, void* count, void* out, long windows,
                          long slices, long per, void* stream) {
  if (windows > 0 && n > 0 && slices > 0)
    g1_fold_kernel<<<dim3((unsigned)slices, (unsigned)windows), kTreeThreads,
                     0, (cudaStream_t)stream>>>(
        (const uint32_t*)ps, n, (const int64_t*)cnt, (const int64_t*)r_of,
        (const uint32_t*)offs, rows, (uint32_t*)part, (int*)count,
        (uint32_t*)out, windows, per);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_sum_sets(const void* parts, long set_stride, long k,
                              long per, void* out, long windows,
                              void* stream) {
  if (per < 1 || per > kTreeThreads) return (int)cudaErrorInvalidValue;
  if (windows > 0 && k > 0)
    g1_sum_sets_kernel<<<dim3((unsigned)((k + per - 1) / per),
                              (unsigned)windows),
                         kTreeThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)parts, set_stride, k, per, (uint32_t*)out, windows);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
