// Row-gather layout experiments: six ways to gather m rows of 24 words from
// a table of quads and write them limb-major, out (24, m).
//
// Replaces tools/pgather_variants.py:make_call (:19-35) with its bodies
// v_rowload, v_tileload, v_noop and v_noextract (:48-111), the variants of
// B4 (pallas_gather.py:_gather_kernel).  The table is the tool's quads:
// (t4, 128) 32-bit words, row i = words 24*(i%4) .. 24*(i%4)+23 of quad row
// i/4, lanes 96-127 padding.  idx int32 (m,), m a multiple of 1024.
//
//   variant 0, 1  rowload u8, u16   out[:, j] = row idx[j]
//   variant 2, 3  tileload u8, u16  out[:, j] = row idx[j]
//   variant 4     probe noidx u8    out[:, j] = quad[(k + t*64) % 4096,
//                                   24*(idx[j]%4) : +24], p = j % 1024,
//                                   k = p / 8, t = p % 8 (t4 >= 4096)
//   variant 5     probe noextract   out[:, j] = quad[idx[j]/4, 0:24]
//
// An index outside [0, 4*t4) reads a zero row (the TPU kernels read past
// the table with bounds checks off); the probe noidx reads only idx & 3.
//
// What the variants differ in is how they read the table:
//   rowload   one warp per 16-byte vector of the row (block 32 rows x 6
//             vectors): each thread issues u loads of 16 bytes (rows j, j +
//             32, ...) before its first store, then stores 4 words of each
//             row, coalesced across the warp.  Only the row's 96 bytes are
//             read (offset 96*(i%4) is 16-byte aligned).
//   tileload  one warp per 32 consecutive rows: for each row the warp reads
//             the aligned 512-byte quad row cooperatively (16 bytes a lane),
//             u rows in flight before the first store; the six lanes that
//             hold the row's 96 bytes put them in shared memory, and the
//             warp writes the (24, 32) tile out coalesced.
// u16 rows of 24 words in one thread's registers would be 384 registers;
// here a thread holds 4 words of each of its u rows (64 at u16), and ptxas
// reports no spill (tests/test_torch_cuda.py reads the report).
//
// Bound on the H100: bytes.  The table, idx and the output each moved once
// (at the tool's n = 2^18, m = 22 * 2^18: 33.6 + 23.1 + 553.6 MB = 610 MB,
// 0.182 ms at 3.35 TB/s); the output dominates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 24;
constexpr int kVecs = 6;        // 16-byte vectors in a row
constexpr int kQuadVecs = 32;   // 16-byte vectors in a quad row
constexpr int kTileWarps = 4;

enum Mode { kIdx = 0, kNoIdx = 1, kNoExtract = 2 };

template <int U, int M>
__global__ void __launch_bounds__(32 * kVecs)
rowload_kernel(const uint4* __restrict__ quad, long t4,
               const int32_t* __restrict__ idx, uint32_t* __restrict__ out,
               long m) {
  const int r = threadIdx.x, v = threadIdx.y;
  const long base = (long)blockIdx.x * (32 * U);
  uint4 w[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long j = base + u * 32 + r;
    const int i = idx[j];
    long q;
    int sec;
    bool ok = true;
    if (M == kNoIdx) {
      const int p = (int)(j % 1024);
      q = (p / U + (p % U) * 64) % 4096;
      sec = i & 3;
    } else {
      ok = i >= 0 && (long)i < 4 * t4;
      q = i >> 2;
      sec = M == kNoExtract ? 0 : (i & 3);
    }
    w[u] = ok ? quad[q * kQuadVecs + sec * kVecs + v] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long j = base + u * 32 + r;
    out[(4 * v + 0) * m + j] = w[u].x;
    out[(4 * v + 1) * m + j] = w[u].y;
    out[(4 * v + 2) * m + j] = w[u].z;
    out[(4 * v + 3) * m + j] = w[u].w;
  }
}

template <int U>
__global__ void __launch_bounds__(32 * kTileWarps)
tileload_kernel(const uint4* __restrict__ quad, long t4,
                const int32_t* __restrict__ idx, uint32_t* __restrict__ out,
                long m) {
  __shared__ uint32_t stage[kTileWarps][kRow][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long j0 = ((long)blockIdx.x * kTileWarps + warp) * 32;
  uint32_t (*st)[33] = stage[warp];
  const int mine = idx[j0 + lane];
#pragma unroll 1
  for (int g = 0; g < 32; g += U) {
    uint4 w[U];
    int sec[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = __shfl_sync(0xffffffffu, mine, g + u);
      const bool ok = i >= 0 && (long)i < 4 * t4;
      sec[u] = ok ? (i & 3) : 0;
      w[u] = ok ? quad[(long)(i >> 2) * kQuadVecs + lane]
                : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = lane - kVecs * sec[u];
      if (c >= 0 && c < kVecs) {
        st[4 * c + 0][g + u] = w[u].x;
        st[4 * c + 1][g + u] = w[u].y;
        st[4 * c + 2][g + u] = w[u].z;
        st[4 * c + 3][g + u] = w[u].w;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kRow; ++k) out[k * m + j0 + lane] = st[k][lane];
}

template <int U, int M>
cudaError_t rowload(const void* quad, long t4, const void* idx, void* out,
                    long m, cudaStream_t s) {
  rowload_kernel<U, M><<<(unsigned)(m / (32 * U)), dim3(32, kVecs), 0, s>>>(
      (const uint4*)quad, t4, (const int32_t*)idx, (uint32_t*)out, m);
  return cudaGetLastError();
}

template <int U>
cudaError_t tileload(const void* quad, long t4, const void* idx, void* out,
                     long m, cudaStream_t s) {
  tileload_kernel<U><<<(unsigned)(m / (32 * kTileWarps)), 32 * kTileWarps, 0,
                       s>>>((const uint4*)quad, t4, (const int32_t*)idx,
                            (uint32_t*)out, m);
  return cudaGetLastError();
}

}  // namespace

// Variant 0-5 (the order above) over m rows (m a multiple of 1024; the
// probe noidx needs t4 >= 4096).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown variant or a bad size.
extern "C" int pm_gather_variant(long variant, const void* quad, long t4,
                                 const void* idx, void* out, long m,
                                 void* stream) {
  if (m <= 0) return 0;
  if (m % 1024 || (variant == 4 && t4 < 4096))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return (int)rowload<8, kIdx>(quad, t4, idx, out, m, s);
    case 1: return (int)rowload<16, kIdx>(quad, t4, idx, out, m, s);
    case 2: return (int)tileload<8>(quad, t4, idx, out, m, s);
    case 3: return (int)tileload<16>(quad, t4, idx, out, m, s);
    case 4: return (int)rowload<8, kNoIdx>(quad, t4, idx, out, m, s);
    case 5: return (int)rowload<8, kNoExtract>(quad, t4, idx, out, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
