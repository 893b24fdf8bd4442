// The MSM bucket scans, both configurations:
//   polymath_tpu/ops/pallas_scan.py:_fused_kernel          -> g1_scan_msm_kernel
//     (B7, the fused configuration: leaves read from the point table)
//   polymath_tpu/ops/pallas_curve.py:_madd_kernel as scanned by
//     polymath_tpu/ops/msm.py:_scan_local_madd             -> g1_madd_scan_kernel
//     (B3, the split configuration: leaves read from the gathered buffer)
// Kept apart from g1.cu so that the two sources, each inlining the madd of
// g1.cuh, compile in parallel.
//
// Both kernels run, for every lane i of a chunk (lanes = W * rows), the
// inclusive mixed-add scan of its seq sorted leaves, and differ only in
// where a leaf comes from: the step loop (scan_lane) is written once, as a
// template over the leaf source.
//
//   local (36, seq, lanes): step s holds each lane's prefix after s + 1
//   leaves, so local[:, seq - 1] are the lane totals.  err (lanes,) gets 1
//   where the fast form skipped a doubling (never cleared: OR-ed).
//
// The reference's sequential grid axis (t, or lax.scan's steps) becomes the
// loop inside the thread: the Jacobian accumulator stays in registers for
// all seq steps, and the next step's leaf (or its index) is in flight while
// this step's madd runs.  Stores of one step are coalesced (neighbouring
// lanes, neighbouring words).  The madds run in the order of the per-step
// loop they replace, so the outputs are that loop's, word for word.
//
// Bound on the H100: integer multiplies.  One 2^19-point chunk at c = 13
// is 20 x 2^19 = 10.5M madds x 6,072 32-bit multiply-adds at 16.7e12/s,
// about 3.8 ms.  Bytes: the fused kernel reads the 50 MB table (about fits
// the 50 MB L2) and 8 B of index a madd; the split one reads 96 B of leaf a
// madd (about 1 GB a chunk, step-major and limb-major, so coalesced); both
// write 144 B of prefix a madd.  What they issue is the madd's Fq
// products, each a carry chain of one instruction a product word
// (fields.cuh); the leaves of both kernels arrive a step ahead through
// cp.async rings, so no load waits in the step; and a chunk's 640 blocks
// of 64 threads run in one wave (kScanBlocksPerSm, the grid sized from the
// occupancy API).
//
// What the split kernel replaces: seq = 256 launches of g1_madd_kernel a
// chunk, each paying the host's launch (15-35 us, PERF.md) and reloading
// and restoring every lane's 144-byte accumulator (about 1.5 GB a chunk each
// way), both gone here.
#include <cuda_runtime.h>
#include "g1.cuh"

namespace {

constexpr int kScanThreads = 64;
// An SM's registers are four partitions of 16,384, one a warp scheduler,
// and a warp's registers come from one of them.  At more than 168
// registers a thread (176 x 32 = 5,632 a warp) two warps fit a
// partition, 4 blocks an SM, 528 on the card: a chunk's 640 blocks would
// take a second wave.  At 168, three fit: 6 blocks an SM, 792 on the card.
constexpr int kScanBlocksPerSm = 6;

// The step loop of one lane: acc_s = acc_(s-1) + leaf_s, every prefix
// stored.  Leaves::step(s, x2, y2) yields leaf s (and may start fetching
// leaf s + 1).
template <class Leaves>
__device__ __forceinline__ void scan_lane(Leaves& leaves, long i, long seq,
                                          long lanes, bool fast,
                                          uint32_t* local, int32_t* err) {
  const long stride = seq * lanes;
  Jac acc = jac_identity();
  bool coll = false;
  for (long s = 0; s < seq; ++s) {
    Fq x2, y2;
    leaves.step(s, x2, y2);
    acc = jac_madd(acc, x2, y2, fast, &coll);
    store_jac(local + s * lanes, stride, i, acc);
  }
  if (coll) err[i] = 1;
}

// B7's leaf source: table (T, 24) words as six 16-byte vectors a row;
// idx (seq, lanes) int64, step major; an index outside [0, T) is the
// affine identity (a dead leaf).  Two loads stand between a step and its
// leaf, the index and then the row, so both are started early: the index
// of leaf s + 2 is loaded during step s, and at step s the row of leaf
// s + 1 is copied with six 16-byte cp.async into a two-stage ring in
// shared memory (a dead leaf copies no byte and zero-fills its stage).  So
// each load has a whole madd to arrive, and the leaf costs no registers
// across the madd.  The ring is [2][6][kScanThreads] vectors: a warp's
// copies and reads of one vector are 512 contiguous bytes, with no bank
// conflict, and each thread reads back only what it copied, so no barrier
// is needed, only cp.async.wait_group.
struct TableLeaves {
  const uint4* table;
  long T;
  const int64_t* idx;
  long seq, lanes, i;
  uint4* ring;  // this thread's column
  long r_next;  // the row of the next leaf to copy

  __device__ __forceinline__ long index(long s) const {
    return s < seq ? idx[s * lanes + i] : T;
  }

  __device__ __forceinline__ void fetch(long s, long r) {
    const bool live = r >= 0 && r < T;
    const uint4* src = table + (live ? r * 6 : 0);
    uint4* dst = ring + (s & 1) * 6 * kScanThreads;
    const unsigned size = live ? 16 : 0;
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(
          dst + v * kScanThreads);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src + v), "r"(size)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ void start() {
    fetch(0, index(0));
    r_next = index(1);
  }

  __device__ __forceinline__ void step(long s, Fq& x2, Fq& y2) {
    if (s + 1 < seq) {
      const long r2 = index(s + 2);
      fetch(s + 1, r_next);
      r_next = r2;
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    const uint4* src = ring + (s & 1) * 6 * kScanThreads;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const uint4 qx = src[v * kScanThreads];
      const uint4 qy = src[(3 + v) * kScanThreads];
      x2.w[4 * v] = qx.x;
      x2.w[4 * v + 1] = qx.y;
      x2.w[4 * v + 2] = qx.z;
      x2.w[4 * v + 3] = qx.w;
      y2.w[4 * v] = qy.x;
      y2.w[4 * v + 1] = qy.y;
      y2.w[4 * v + 2] = qy.z;
      y2.w[4 * v + 3] = qy.w;
    }
  }
};

// The split scan's leaf source: the gathered leaves (24, seq, lanes), limb
// major and step major ((0, 0) is the identity).  Each thread copies its
// next leaf with cp.async into a two-stage ring in shared memory (2 x 96 B
// a thread, 12 KB a block), which costs no registers across the madd; a
// thread reads back only what it copied itself, so the ring needs no
// barrier, only cp.async.wait_group.
struct BufferLeaves {
  const uint32_t* leaves;
  long seq, lanes, i;
  uint32_t* ring;  // [2][24][kScanThreads]; this thread's column

  __device__ __forceinline__ void fetch(long s) {
    uint32_t* dst = ring + (s & 1) * 24 * kScanThreads;
    const uint32_t* src = leaves + s * lanes + i;
    const long word = seq * lanes;
#pragma unroll
    for (int k = 0; k < 24; ++k) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(
          dst + k * kScanThreads);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src + k * word)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ void step(long s, Fq& x2, Fq& y2) {
    if (s + 1 < seq) {
      fetch(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    const uint32_t* src = ring + (s & 1) * 24 * kScanThreads;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      x2.w[k] = src[k * kScanThreads];
      y2.w[k] = src[(12 + k) * kScanThreads];
    }
  }
};

// Both kernels walk the lanes with a grid stride: the wrapper sizes the
// grid to what the card holds at once (pm_scan_blocks_per_sm), so every
// lane is in the first wave whenever the registers allow it.
__global__ void __launch_bounds__(kScanThreads, kScanBlocksPerSm)
g1_scan_msm_kernel(const uint4* table, long T, const int64_t* idx,
                   uint32_t* local, int32_t* err, long fast, long seq,
                   long lanes) {
  __shared__ uint4 ring[2 * 6 * kScanThreads];
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += (long)gridDim.x * blockDim.x) {
    TableLeaves src{table, T, idx, seq, lanes, i, ring + threadIdx.x, 0};
    src.start();
    scan_lane(src, i, seq, lanes, fast != 0, local, err);
  }
}

__global__ void __launch_bounds__(kScanThreads, kScanBlocksPerSm)
g1_madd_scan_kernel(const uint32_t* leaves, uint32_t* local, int32_t* err,
                    long fast, long seq, long lanes) {
  __shared__ uint32_t ring[2 * 24 * kScanThreads];
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += (long)gridDim.x * blockDim.x) {
    BufferLeaves src{leaves, seq, lanes, i, ring + threadIdx.x};
    src.fetch(0);
    scan_lane(src, i, seq, lanes, fast != 0, local, err);
  }
}

inline unsigned grid_for(long lanes, long blocks) {
  const long need = (lanes + kScanThreads - 1) / kScanThreads;
  return (unsigned)(need < blocks ? need : blocks);
}

// The most shared memory an SM can give: six 12 KB rings and the 1 KB a
// block the system keeps do not fit a 64 KB carveout.  Set on the current
// card before each occupancy query and each launch, so that neither
// depends on the other having run.
template <class K>
int carve(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

template <class K>
int blocks_per_sm(K kernel) {
  int n = 0;
  if (carve(kernel) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kScanThreads,
                                                    0) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// Blocks of kScanThreads threads that one SM holds at once (registers and
// shared memory, at the carveout the launches set), the least over the two
// scan kernels; 0 if the query failed.
extern "C" int pm_scan_blocks_per_sm() {
  const int a = blocks_per_sm(g1_scan_msm_kernel);
  const int b = blocks_per_sm(g1_madd_scan_kernel);
  return a < b ? a : b;
}

// ``blocks``: the most blocks to launch (pm_scan_blocks_per_sm x SMs).
extern "C" int pm_g1_scan_msm(const void* table, long T, const void* idx,
                              void* local, void* err, long fast, long seq,
                              long lanes, long blocks, void* stream) {
  if (const int e = carve(g1_scan_msm_kernel)) return e;
  if (seq > 0 && lanes > 0)
    g1_scan_msm_kernel<<<grid_for(lanes, blocks), kScanThreads, 0,
                         (cudaStream_t)stream>>>(
        (const uint4*)table, T, (const int64_t*)idx, (uint32_t*)local,
        (int32_t*)err, fast, seq, lanes);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_madd_scan(const void* leaves, void* local, void* err,
                               long fast, long seq, long lanes, long blocks,
                               void* stream) {
  if (const int e = carve(g1_madd_scan_kernel)) return e;
  if (seq > 0 && lanes > 0)
    g1_madd_scan_kernel<<<grid_for(lanes, blocks), kScanThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)leaves, (uint32_t*)local, (int32_t*)err, fast, seq,
        lanes);
  return (int)cudaGetLastError();
}
