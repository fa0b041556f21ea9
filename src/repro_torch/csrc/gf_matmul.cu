// (a @ b) mod 65537 on CUDA cores: the field matmul behind the dense encode,
// every decode, every rebuild and every degraded read.
//
// Replaces the TPU kernel `_gf_matmul_kernel` of src/repro/kernels/gf_matmul.py
// (launched by `gf_matmul`).  That kernel works in uint32 only: it
// Fermat-reduces every product before accumulating, special-cases a == 65536,
// and bounds each partial sum by slicing the reduction.  Here every product
// goes into a 64-bit accumulator instead:
//
//   inputs lie in [0, q) with q = 2^16 + 1, so each product is at most
//   65536^2 = 2^32, and a sum of K of them is at most K * 2^32 < 2^64 for any
//   K < 2^32 (K is an int here).  So the sum is exact in unsigned 64 bits and
//   is reduced `% 65537` once per output, at the end.  The a == 65536 corner
//   needs no case of its own: 65536^2 = 2^32 fits.
//
// Bound on this card: at the main path's shapes (M = 64 or 256 rows, K = 256,
// N = 2^18 columns) each column of b (K values in) and of c (M values out)
// carries M * K multiply-adds, 16 to 64 per byte moved, so the kernel is bound
// by integer multiply-add throughput on the CUDA cores, not by memory.  This first
// version keeps a (BM x BK) tile of a and a (BK x BN) tile of b in shared
// memory and gives each thread a TM x TN block of 64-bit accumulators, so
// every value loaded from shared memory feeds several multiply-adds.  Tensor
// cores (splitting each operand into 8-bit limbs) are later work.
//
// Layouts: a (M, K), b (K, N), c (M, N), all row-major int32 holding values in
// [0, q), read as uint32.  Ragged edges of M, N and K are masked here; the
// host pads nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kQ = 65537u;
constexpr int BM = 32;   // rows of c per block
constexpr int BN = 128;  // columns of c per block (the long, coalesced axis)
constexpr int BK = 32;   // reduction slice staged in shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 8 x 32 = 256

__global__ void __launch_bounds__(THREADS)
gf_matmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ c, int M, int N, int K) {
  __shared__ uint32_t As[BM][BK + 1];  // +1: rows of As read down a column
  __shared__ __align__(16) uint32_t Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..31: column group, one warp spans a row
  const int ty = tid / (BN / TN);  // 0..7:  row group
  const int row0 = blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BN;

  unsigned long long acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0ull;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage a[row0 : row0+BM, k0 : k0+BK]; masked entries are 0
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const int gr = row0 + r, gk = k0 + k;
      As[r][k] = (gr < M && gk < K) ? a[(long long)gr * K + gk] : 0u;
    }
    // stage b[k0 : k0+BK, col0 : col0+BN]; consecutive threads read
    // consecutive columns, so every warp's load is one coalesced row segment
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k;
      const long long gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? b[(long long)gk * N + gn] : 0u;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      uint32_t av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[ty * TM + i][k];
      const uint4 bv = *reinterpret_cast<const uint4*>(&Bs[k][tx * TN]);
      const uint32_t bj[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += (unsigned long long)av[i] * bj[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gn = col0 + tx * TN + j;
      if (gn < N) c[(long long)gr * N + gn] = (uint32_t)(acc[i][j] % kQ);
    }
  }
}

}  // namespace

// c = (a @ b) mod 65537 on `stream`; returns cudaGetLastError() of the launch.
extern "C" int gf_matmul_launch(const void* a, const void* b, void* c, int M,
                                int N, int K, void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
    gf_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)c, M, N, K);
  }
  return (int)cudaGetLastError();
}
