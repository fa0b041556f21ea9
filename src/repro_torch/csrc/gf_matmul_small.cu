// c[z] = (a[z] @ b[z]) mod 65537 for small M and K on the CUDA cores: the
// mesh backend's per-processor combine, `gf_matmul_batched`'s design for
// the shapes the mesh gives it.
//
// Stands for the TPU kernel `_gf_matmul_kernel` of
// src/repro/kernels/gf_matmul.py, whose batched use in the reference is
// `gf_matmul_ref` at src/repro/core/shardmap_exec.py:214 (the universal
// combine, outside any Pallas kernel there).  The combine is always
// (B; (m+1) x m) . (m x W) with m = (p+1)^T_p small: (16; 3x2) at rs 16/4,
// (64; 5x4) at rs 64/16, (256; 9x8) at rs 256/64.
//
// Bound on this card.  At the combine of rs K=256 R=64, W = 2^18, the kernel
// must read b and write c: 4 (B M K + B K N + B M N) = 4.56 GB, 1.362 ms at
// 3.35 TB/s (NVIDIA H100 80GB HBM3).  Its 256 * 9 * 8 * 2^18 = 4.83 G
// field multiply-adds take 0.29 ms at the INT32 lanes' 16.75 T/s, so bytes
// bound it; the wrapper sends a shape here only while M K stays small
// against M + K (kernels/gf_matmul.py::_batched_design).
//
// What the tensor-core kernel (csrc/gf_matmul.cu, batched entry) does at
// this shape, and what this design does instead:
// - It launches one block per (batch, 128-column slab): 524,288 blocks,
//   each paying its set-up (a's limb planes, 16 KB of mostly zero-filled
//   cp.async) for 4 KB of b.  Here about SMs x 2 persistent blocks each walk
//   a contiguous run of work items (batch z, BN-column tile), and stage
//   a[z] (at most 64 x 32 values, no limb planes) only when z changes.
// - It stages b in one k-step whose prefetch never fires, so load, MMA and
//   store run in series, and its 112,640 bytes of shared memory admit two
//   blocks an SM with about 8 KB of b in flight.  Here b comes by 16-byte
//   `cp.async.cg` into a ring of STAGES = 3 stages of 32 KiB, sized to K
//   (BN = 8192 / K columns, a power of two in [256, 4096]): the next two
//   tiles load while this one is multiplied and stored, two blocks fit on an
//   SM (98,688 bytes each at K = 8), and 128 KiB an SM are in flight.
//   cp.async rather than TMA: its src-size operand zero-fills the ragged
//   last tile, and its 4-byte form serves rows that are not 16-byte
//   aligned (N % 4 != 0, or an unaligned base) with the same ring.
// - It runs a 32-row MMA tile with 9 live rows and a 32-deep step with 8
//   live, on limb products.  Here each thread owns 4 consecutive columns
//   and a chunk of RC <= 9 rows (the rows split into ceil(M / 9) equal
//   chunks: 9 at M = 9, 4 x 9 at M = 33), and accumulates
//   c[i, n] = sum_k a[i, k] b[k, n] with `mad.wide.u32` into u64 registers:
//   every product is at most 2^32 and K <= 32 terms stay below 2^37, so
//   there is no limb split and no special case for 65536.
// - Each u64 sum is reduced mod q once: x = lo16 + 2^16 mid16 + 2^32 hi
//   == lo16 - mid16 + hi (2^16 == -1, 2^32 == 1), then one correction each
//   way.  The 4 columns go out as one coalesced 16-byte store per row, or
//   as 4 scalar stores where rows are not 16-byte aligned; columns past N
//   are not written.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 1.65-1.66 ms at
// the combine, 82% of its bytes bound, against 7.4-7.5 ms for the
// tensor-core kernel's batched entry.  Where the multiply-adds dominate,
// at (4096; 33 x 32) . (32 x 4096), the 17.7 G `mad.wide.u32` (IMAD.WIDE.U32
// in SASS) with their shared-memory reads and folds ran at 5.0-5.3 T/s,
// a third of the 16.75 T/s INT32 peak; there the tensor cores tie (3.4 ms),
// which sets the wrapper's crossover.
//
// Layouts: a (B, M, K), b (B, K, N), c (B, M, N) row-major int32 holding
// values in [0, q), read as uint32; 1 <= M <= 64, K <= 32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kQ = 65537u;
constexpr int THREADS = 256;       // 8 warps
constexpr int STAGES = 3;          // ring of b tiles in shared memory
constexpr int STAGE_WORDS = 8192;  // 32 KiB of b a stage: K rows x BN
constexpr int MAX_BN = 4096;       // columns of a tile (a power of two)
constexpr int MAX_RC = 9;          // rows of a thread's chunk
constexpr int MAX_M = 64;
constexpr int MAX_K = 32;          // K * 2^32 < 2^64 by far; the stage holds
                                   // at least 256 columns
constexpr int MAX_A_WORDS = 8 * 12 * MAX_K;  // chunks x padded rows x K

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// acc += a * b, 32 x 32 -> 64 bits.
__device__ __forceinline__ void mad_wide(uint64_t& acc, uint32_t a,
                                         uint32_t b) {
  asm("mad.wide.u32 %0, %1, %2, %0;\n" : "+l"(acc) : "r"(a), "r"(b));
}

// x mod q for x < 2^37: lo - mid + hi lies in [-65535, 65567].
__device__ __forceinline__ uint32_t fold(uint64_t x) {
  int r = (int)(x & 0xFFFFu) - (int)((x >> 16) & 0xFFFFu) + (int)(x >> 32);
  r += r < 0 ? (int)kQ : 0;
  r -= r >= (int)kQ ? (int)kQ : 0;
  return (uint32_t)r;
}

// Block-uniform geometry of one launch.
struct Geometry {
  int M, N, K;
  int bn;             // columns of a tile (power of two)
  int groups;         // bn / 4: 4-column groups of a tile
  int gshift;         // log2(groups)
  int chunks;         // row chunks of a (each RC rows, zero-padded)
  long long tiles_z;  // tiles of one batch: ceil(N / bn)
  long long tiles;    // B * tiles_z
  bool vec;           // every row of b and c 16-byte aligned (N % 4 == 0
                      // and aligned bases): 16-byte copies and stores
};

// Block b takes the work items [tiles b / grid, tiles (b + 1) / grid), item
// = z * tiles_z + tile, in order: a block meets few batches.
template <int RC>
__global__ void __launch_bounds__(THREADS, 2)
gf_matmul_small(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ c,
                Geometry g) {
  constexpr int RCP = (RC + 3) / 4 * 4;  // a chunk's rows padded for v4 reads
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* As = smem + STAGES * STAGE_WORDS;  // [chunk][k][RCP]
  const int tid = threadIdx.x;
  const int M = g.M, N = g.N, K = g.K, bn = g.bn, G = g.groups;
  const long long first = g.tiles * blockIdx.x / gridDim.x;
  const int items = (int)(g.tiles * (blockIdx.x + 1) / gridDim.x - first);

  // Tile `j` of this block's run into stage j % STAGES, one commit group
  // per call (empty past the run, so every thread counts groups alike).
  auto issue = [&](int j) {
    if (j < items) {
      const long long item = first + j;
      const long long z = item / g.tiles_z;
      const long long n0 = item % g.tiles_z * bn;
      const uint32_t* src = b + z * K * N + n0;
      uint32_t* dst = smem + (j % STAGES) * STAGE_WORDS;
      if (g.vec) {
        for (int i = tid; i < K * G; i += THREADS) {
          const int k = i >> g.gshift, col = 4 * (i & (G - 1));
          const bool valid = n0 + col < N;  // N % 4 == 0: all 4 or none
          cp_async16(dst + k * bn + col,
                     valid ? src + (long long)k * N + col : b, valid);
        }
      } else {
        for (int i = tid; i < K * bn; i += THREADS) {
          const int k = i >> (g.gshift + 2), col = i & (bn - 1);
          const bool valid = n0 + col < N;
          cp_async4(dst + k * bn + col,
                    valid ? src + (long long)k * N + col : b, valid);
        }
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  long long z_staged = -1;
  for (int j = 0; j < items; ++j) {
    cp_async_wait<STAGES - 2>();  // this thread's share of tile j is in
    __syncthreads();  // all of tile j is in; tile j - 1 is done with
    issue(j + STAGES - 1);        // into tile j - 1's stage
    const long long item = first + j;
    const long long z = item / g.tiles_z;
    const long long n0 = item % g.tiles_z * bn;
    if (z != z_staged) {  // a[z] into As, rows past M as 0
      const int words = g.chunks * K * RCP;
      for (int e = tid; e < words; e += THREADS) {
        const int i = e % RCP, k = e / RCP % K, row = e / (RCP * K) * RC + i;
        As[e] = i < RC && row < M ? __ldg(a + (z * M + row) * K + k) : 0u;
      }
      z_staged = z;
      __syncthreads();
    }
    const uint32_t* Bs = smem + (j % STAGES) * STAGE_WORDS;
    for (int u = tid; u < G * g.chunks; u += THREADS) {
      const int grp = u & (G - 1), chunk = u >> g.gshift;
      const uint32_t* Ac = As + chunk * K * RCP;
      uint64_t acc[RC][4];
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0;
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const uint4 bv = *reinterpret_cast<const uint4*>(Bs + k * bn + 4 * grp);
        uint32_t av[RCP];
#pragma unroll
        for (int r = 0; r < RCP; r += 4) {
          const uint4 t = *reinterpret_cast<const uint4*>(Ac + k * RCP + r);
          av[r] = t.x;
          av[r + 1] = t.y;
          av[r + 2] = t.z;
          av[r + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          mad_wide(acc[i][0], av[i], bv.x);
          mad_wide(acc[i][1], av[i], bv.y);
          mad_wide(acc[i][2], av[i], bv.z);
          mad_wide(acc[i][3], av[i], bv.w);
        }
      }
      const long long col = n0 + 4 * grp;
      if (col >= N) continue;
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const int row = chunk * RC + i;
        if (row >= M) break;
        uint32_t* dst = c + (z * M + row) * N + col;
        const uint32_t v0 = fold(acc[i][0]), v1 = fold(acc[i][1]),
                       v2 = fold(acc[i][2]), v3 = fold(acc[i][3]);
        if (g.vec) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(v0, v1, v2, v3);
        } else {
          dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
          if (col + 2 < N) dst[2] = v2;
          if (col + 3 < N) dst[3] = v3;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The launch's geometry and the rows of a thread's chunk.
Geometry geometry(const void* b, const void* c, int B, int M, int N, int K,
                  int* rc) {
  Geometry g;
  g.M = M;
  g.N = N;
  g.K = K;
  g.bn = MAX_BN;
  while (g.bn > 256 && g.bn * (K > 0 ? K : 1) > STAGE_WORDS) g.bn /= 2;
  g.groups = g.bn / 4;
  g.gshift = 0;
  while ((1 << g.gshift) < g.groups) ++g.gshift;
  g.chunks = (M + MAX_RC - 1) / MAX_RC;
  *rc = (M + g.chunks - 1) / g.chunks;
  g.tiles_z = ((long long)N + g.bn - 1) / g.bn;
  g.tiles = B * g.tiles_z;
  g.vec = N % 4 == 0 && (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0;
  return g;
}

int smem_bytes(const Geometry& g, int rc) {
  return (STAGES * STAGE_WORDS + g.chunks * g.K * ((rc + 3) / 4 * 4)) * 4;
}

template <int RC>
int launch_rc(const uint32_t* a, const uint32_t* b, uint32_t* c,
              const Geometry& g, cudaStream_t stream, int* info) {
  const int smem = smem_bytes(g, RC);
  cudaError_t err = cudaFuncSetAttribute(  // per device: set each call
      gf_matmul_small<RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (STAGES * STAGE_WORDS + MAX_A_WORDS) * 4);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gf_matmul_small<RC>, THREADS, smem)) != cudaSuccess)
    return (int)err;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > g.tiles) grid = g.tiles;
  if (info) {  // for the record: what this launch would be
    const int v[8] = {g.bn, g.chunks, RC, smem, per_sm, (int)grid, g.vec,
                      sms};
    for (int i = 0; i < 8; ++i) info[i] = v[i];
    return 0;
  }
  if (grid > 0)
    gf_matmul_small<RC><<<(unsigned)grid, THREADS, smem, stream>>>(a, b, c, g);
  return (int)cudaGetLastError();
}

int run(const void* a, const void* b, void* c, int B, int M, int N, int K,
        void* stream, int* info) {
  if (M < 1 || M > MAX_M || K < 0 || K > MAX_K || N < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  int rc = 0;
  const Geometry g = geometry(b, c, B, M, N, K, &rc);
  const auto* pa = (const uint32_t*)a;
  const auto* pb = (const uint32_t*)b;
  auto* pc = (uint32_t*)c;
  auto* st = (cudaStream_t)stream;
  switch (rc) {
    case 1: return launch_rc<1>(pa, pb, pc, g, st, info);
    case 2: return launch_rc<2>(pa, pb, pc, g, st, info);
    case 3: return launch_rc<3>(pa, pb, pc, g, st, info);
    case 4: return launch_rc<4>(pa, pb, pc, g, st, info);
    case 5: return launch_rc<5>(pa, pb, pc, g, st, info);
    case 6: return launch_rc<6>(pa, pb, pc, g, st, info);
    case 7: return launch_rc<7>(pa, pb, pc, g, st, info);
    case 8: return launch_rc<8>(pa, pb, pc, g, st, info);
    default: return launch_rc<9>(pa, pb, pc, g, st, info);
  }
}

}  // namespace

// c[z] = (a[z] @ b[z]) mod 65537 for z < B on `stream`: a (B, M, K), b (B,
// K, N), c (B, M, N), each batch contiguous after the one before;
// 1 <= M <= 64, 0 <= K <= 32.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape outside those limits).
extern "C" int gf_matmul_small_launch(const void* a, const void* b, void* c,
                                      int B, int M, int N, int K,
                                      void* stream) {
  return run(a, b, c, B, M, N, K, stream, nullptr);
}

// What a launch of this shape would be, without launching: info[0..7] =
// tile columns, row chunks, rows a chunk, dynamic shared bytes, resident
// blocks an SM, grid, 16-byte path, SMs.
extern "C" int gf_matmul_small_config(const void* b, const void* c, int B,
                                      int M, int N, int K, int* info) {
  return run(nullptr, b, const_cast<void*>(c), B, M, N, K, nullptr, info);
}
