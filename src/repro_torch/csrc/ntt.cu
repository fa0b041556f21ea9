// Batched radix-2 NTT over F_65537 along axis 0 of a (Z, C) array: the O(K log K)
// local encode (the paper's permuted DFT D_Z Pi, Sec. V-A).
//
// Replaces the TPU kernel `_ntt_kernel` of src/repro/kernels/ntt.py (body
// `_ntt_stages`, launched by `ntt`).  It computes the same function: the
// forward transform runs decimation-in-frequency (DIF) stages h = 0 .. H-1
// (u' = u + v, v' = (u - v) w), leaving the output in bit-reversed order; the
// inverse runs h = H-1 .. 0 with the inverse twiddles (u' = u + v w,
// v' = u - v w) and then scales by Z^-1.  The twiddle of the b-th butterfly
// of stage h is root^((b mod half) 2^h), half = Z / 2^(h+1), as in
// `ntt_twiddles`.  All arithmetic is exact mod q (products of two residues,
// <= 2^32, are folded with 2^16 == -1), so any exact factorisation of the
// transform gives the same output bit for bit; the kernels below regroup the
// stages, and only the bit-reversed output order and the inverse's Z^-1 scale
// are fixed.  Z is any power of two dividing q - 1 (Z <= 2^16), the domain of
// `ntt_twiddles`.
//
// Bound on this card: each element is read once and written once and takes
// log2 Z butterflies of a few integer operations, so one pass is bound by
// memory bytes, 8 Z C over 3.35 TB/s: at the rs codeword's (64, 2^20),
// 536.9 MB = 0.160 ms; at the dft encode's (4096, 2^12), 134.2 MB = 0.040
// ms; at (8192, 2^12) 0.080 ms and at (65536, 2^10) 0.160 ms.
//
// Three kernels; the wrapper picks by Z.
//
// ntt_regs (Z <= 64, the rs codeword's Z = 64): each thread owns one column
// and holds all Z values in registers.  Row r of column c is x[r C + c], so
// the warp's loads and stores are coalesced and each thread has Z
// independent loads in flight.  The kernel is templated on H = log2 Z and
// fully unrolled (`dif` below), so every register index and every twiddle
// index is a compile-time constant: no local memory, no shared memory, no
// barrier.  The Z/2 powers of the root are a kernel parameter (constant
// memory, the same word for every thread: a broadcast operand); butterflies
// whose twiddle is root^0 = 1 skip the multiply.
//
// ntt_slab (64 < Z <= 4096): two register passes joined by one exchange
// through shared memory.  Write Z = Z1 Z2 (Z1 = 2^floor(H/2), Z2 = Z / Z1,
// both <= 64) and row r = a Z2 + j (a < Z1, j < Z2).  The first log2 Z1 DIF
// stages pair only rows with the same j, and their twiddle
// root^((a' Z2 + j) 2^h) splits into root_Z1^(a' 2^h) times root^(j 2^h); so
// they are a pure Z1-point DIF of the strided sequence x[j + a Z2] (twiddles
// root_Z1 = root^Z2) followed by one "twist" multiply of position a by
// root^(j rev(a)), rev over log2 Z1 bits.  The remaining stages are a pure
// Z2-point DIF (root_Z2 = root^Z1) of each contiguous block of Z2 rows.  A
// block of 512 threads owns BW = 512 / Z1 columns.  Pass A: thread (p, c)
// loads the values of sequences j = p (and j = p + Z1 when H is odd) of
// column c straight from device memory (consecutive threads on consecutive
// columns: a warp covers whole 32-byte sectors), runs the Z1-point DIF in
// registers and writes them to shared memory once; one barrier; pass B: the
// thread reads back block a = p (Z2 contiguous rows), multiplies it by row p
// of the (Z1, Z2) twist table (16-byte loads through L1), runs the Z2-point
// DIF in registers and stores.  The inverse runs the same steps backwards
// (pass B's inverse stages, the inverse twist with Z^-1 folded into its
// table, exchange, pass A's inverse stages), so the scale costs no extra
// multiply.  That is one trip through shared memory and one barrier in
// place of H of each.  The kernel is templated on (log2 Z1, log2 Z2): every
// register and twiddle index is a compile-time constant, and the pass
// twiddles are a kernel parameter (64 words, the constant bank).  The shared
// slab is padded by BW words after every block of Z2 rows, so both the
// strided accesses of pass A and the blocked ones of pass B fall on 32
// distinct banks.  At Z = 4096 a block holds 64 values a thread in 128
// registers and a 133 KB slab, so one block runs on an SM at a time and its
// loads, arithmetic and stores do not overlap; blocks of 256 threads and 4
// columns would let two share an SM but leave each warp half of every
// 32-byte sector, and ran slower.  Every product with a stage twiddle or a
// forward twist factor takes the 32-bit `mulmod_tw`.
//
// ntt_cluster (4096 < Z <= 2^16): the slab's split with Z1 = Z0 = Z / R and
// Z2 = R, in one pass, on a thread-block cluster (Hopper) of Z0 blocks that
// each hold R rows.  A column at Z = 2^16 is 256 KB, more than one block's 227 KB of
// shared memory; the cluster's distributed shared memory holds it.  The
// block layout (`with_layout`): R = 2048 rows of 8 columns up to Z = 2^15
// (256 threads, 66,560 bytes: two blocks an SM, so one block's loads and
// stores overlap the other's arithmetic; it ran faster there than 4096
// rows) and R = 4096 rows of 8 columns at Z = 2^16 (512 threads, 133,120
// bytes, one block an SM), where 2048 rows would need 32 blocks and a
// cluster holds at most 16.  Four columns a block would let two 4096-row
// blocks share an SM but leave each warp half of every 32-byte sector.
// Block rank a owns rows [a R, (a + 1) R) of its cluster's columns in
// shared memory, in the slab's padded layout with Z1 = R / 64, Z2 = 64; the
// clusters tile the columns.  Forward: each block takes R / Z0 of the
// sequences j; thread (p, c) loads the Z0 values x[j + a R] of each of its
// 64 / Z0 sequences (64 loads in flight, consecutive threads on consecutive
// columns), runs the Z0-point DIF and the twist root^(j rev(a)) in
// registers and stores value a into rank a's shared memory
// (`map_shared_rank`; one warp writes 32 consecutive words of one peer).
// The blocks take the ranks in turns starting from their own (a local
// store), so at any time each peer receives from one block.  After one
// cluster barrier each block runs the slab's pass A in place on its own
// rows (thread p owns sequences p + i Z1), a block barrier, pass B, and
// stores.  The inverse runs the steps backwards: pass B's inverse stages
// and twist from device memory, pass A's inverse stages in shared memory,
// a cluster barrier, then each block reads its sequences' Z0 values from
// the ranks (in the same turns), applies the inverse twist with Z^-1 folded
// in and the Z0-point inverse stages, and stores.  So each element moves
// once from and once to device memory, and (Z0 - 1) / Z0 of them cross SMs
// once.  The cluster barrier is split (`barrier.cluster` arrive, then wait)
// where that hides it: the forward arrives at entry and waits only before
// its first store into a peer (a peer's shared memory may not be written
// before the peer runs); the inverse arrives after its last read from a
// peer and waits before it exits (no block's shared memory may go away
// while a peer reads it).  Clusters above 8 blocks are non-portable and
// need their attribute; `ntt_cluster_config` reports how many clusters can
// be resident at once.  The kernel may also run in place: every global
// read of a cluster comes before its barrier and every global write after
// it, and clusters own disjoint columns.  Registers: the exchange's 64
// values and the slab passes' 64 are live at different times (at most 128
// a thread).  At these sizes the integer arithmetic (a butterfly's add and
// subtract with their folds and, in most butterflies, a product and its
// fold: about 8 instructions, on the SM's 64 INT32 lanes) and the memory
// traffic each take longer alone than the bytes bound, so the kernel ends
// near half of it.
//
// Layouts: x and out (Z, C) row-major int32 holding values in [0, q), read as
// uint32.  Ragged C is masked here.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kQ = 65537u;

// Reductions mod q written as an unsigned min, which Hopper executes as one
// fused add-and-min (VIADDMNMX): for s in [0, 2q), min(s, s - q) is s mod q,
// since s - q wraps to a large value when s < q.

// a * b mod q for a, b in [0, q): the product p <= 2^32 needs 64 bits.  With
// p = hi * 2^16 + lo and 2^16 == -1 (mod q), p == lo - hi, and
// lo + q - hi lies in (0, 2q).
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  const unsigned long long p = (unsigned long long)a * b;
  const uint32_t lo = (uint32_t)(p & 0xFFFFull);
  const uint32_t hi = (uint32_t)(p >> 16);  // <= 2^16
  const uint32_t r = lo + kQ - hi;
  return min(r, r - kQ);
}

// a * w mod q for a in [0, q) and w in [0, q - 1) (never 65536 == -1): the
// product is below 2^32, so 32 bits hold it.  Every stage twiddle qualifies
// (root_N^e with e < N / 2 is never -1), and so does every forward twist
// factor root^(j rev(a)) (j rev(a) < Z can never be Z / 2: both factors
// would be powers of two whose exponents sum to H - 1, but they sum to at
// most H - 2).  With p = hi 2^16 + lo (hi < 2^16), p - hi q = lo - hi lies in
// (-2^16, 2^16): one multiply-add, then an add-min that wraps a negative
// value into [1, q).
__device__ __forceinline__ uint32_t mulmod_tw(uint32_t a, uint32_t w) {
  const uint32_t p = a * w;
  const uint32_t r = p - (p >> 16) * kQ;
  return min(r, r + kQ);
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - kQ);
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return min(d, d + kQ);
}

// In-place pure N-point DIF (N = 2^L) on v[0 .. N) in registers, or its
// stagewise inverse: stage h pairs v[u], v[u + half] with twiddle
// tw[(u mod half) << h], tw[e] = root_N^e (e < N / 2; the inverse root's
// powers for the inverse).  Fully unrolled: every index is a constant.
template <int L, bool INV>
__device__ __forceinline__ void dif(uint32_t* v, const uint32_t* tw) {
  constexpr int N = 1 << L;
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const int h = INV ? L - 1 - t : t;
    const int half = N >> (h + 1);
#pragma unroll
    for (int b = 0; b < N / 2; ++b) {
      const int j = b % half;
      const int u = (b / half) * 2 * half + j;
      if (INV) {
        const uint32_t m = j == 0 ? v[u + half] : mulmod_tw(v[u + half], tw[j << h]);
        v[u + half] = submod(v[u], m);
        v[u] = addmod(v[u], m);
      } else {
        const uint32_t d = submod(v[u], v[u + half]);
        v[u] = addmod(v[u], v[u + half]);
        v[u + half] = j == 0 ? d : mulmod_tw(d, tw[j << h]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ntt_slab: 64 < Z <= 4096 (see above)
// ---------------------------------------------------------------------------

constexpr int SLAB_THREADS = 512;  // Z1 threads a column x BW = 512 / Z1 columns

struct PassTwiddles {  // kernel parameter (constant bank)
  uint32_t w1[32];     // pass A: root_Z1^e = root^(Z2 e), e < Z1 / 2
  uint32_t w2[32];     // pass B: root_Z2^e = root^(Z1 e), e < Z2 / 2
};

// v[i] *= t[i] for i < N: one row of the twist table, 16 bytes a load.  The
// forward's factors are never 65536 and t[0] = 1; the inverse's hold Z^-1.
template <int N, bool INV>
__device__ __forceinline__ void twist_row(uint32_t* v, const uint32_t* t) {
  const uint4* t4 = reinterpret_cast<const uint4*>(t);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint4 f = __ldg(t4 + i);
    if (INV) {
      v[4 * i] = mulmod(v[4 * i], f.x);
      v[4 * i + 1] = mulmod(v[4 * i + 1], f.y);
      v[4 * i + 2] = mulmod(v[4 * i + 2], f.z);
      v[4 * i + 3] = mulmod(v[4 * i + 3], f.w);
    } else {
      if (i > 0) v[4 * i] = mulmod_tw(v[4 * i], f.x);
      v[4 * i + 1] = mulmod_tw(v[4 * i + 1], f.y);
      v[4 * i + 2] = mulmod_tw(v[4 * i + 2], f.z);
      v[4 * i + 3] = mulmod_tw(v[4 * i + 3], f.w);
    }
  }
}

template <int L1, int L2, bool INV>
__global__ void __launch_bounds__(SLAB_THREADS, 1)
ntt_slab(const uint32_t* x, uint32_t* out, const uint32_t* __restrict__ twist,
         long long C, const __grid_constant__ PassTwiddles tw) {
  constexpr int Z1 = 1 << L1, Z2 = 1 << L2;
  constexpr int BW = SLAB_THREADS >> L1;  // columns per block
  constexpr int S = Z2 / Z1;              // pass-A sequences per thread: 1 or 2
  constexpr int BLK = (Z2 + 1) * BW;      // shared words per padded block of Z2 rows
  extern __shared__ uint32_t s[];         // (Z1, Z2 + 1, BW): rows a Z2 + j, padded
  const int c = threadIdx.x % BW, p = threadIdx.x / BW;
  const long long col = (long long)blockIdx.x * BW + c;
  const bool live = col < C;
  // batch blockIdx.y: rows [y Z, (y + 1) Z) of a (batches * Z, C) array
  const long long base = (long long)blockIdx.y * (Z1 * Z2) * C + col;
  const uint32_t* xb = x + base;
  uint32_t* ob = out + base;
  const uint32_t* trow = twist + p * Z2;  // block a = p's twist factors
  uint32_t v[Z2];

  if (!INV) {
    // pass A: sequences j = p + i Z1, rows j + a Z2, straight from memory
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int a = 0; a < Z1; ++a)
        v[i * Z1 + a] = live ? __ldcs(xb + (long long)(p + i * Z1 + a * Z2) * C) : 0u;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      dif<L1, false>(v + i * Z1, tw.w1);
#pragma unroll
      for (int a = 0; a < Z1; ++a) s[a * BLK + (p + i * Z1) * BW + c] = v[i * Z1 + a];
    }
    __syncthreads();
    // pass B: block a = p (rows p Z2 + i), the twist, then its DIF
#pragma unroll
    for (int i = 0; i < Z2; ++i) v[i] = s[p * BLK + i * BW + c];
    twist_row<Z2, false>(v, trow);
    dif<L2, false>(v, tw.w2);
    if (live) {
#pragma unroll
      for (int i = 0; i < Z2; ++i) __stcs(ob + (long long)(p * Z2 + i) * C, v[i]);
    }
  } else {
    // pass B's inverse stages and the inverse twist on block p, from memory
#pragma unroll
    for (int i = 0; i < Z2; ++i)
      v[i] = live ? __ldcs(xb + (long long)(p * Z2 + i) * C) : 0u;
    dif<L2, true>(v, tw.w2);
    twist_row<Z2, true>(v, trow);
#pragma unroll
    for (int i = 0; i < Z2; ++i) s[p * BLK + i * BW + c] = v[i];
    __syncthreads();
    // pass A's inverse stages on sequences j = p + i Z1
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int a = 0; a < Z1; ++a) v[i * Z1 + a] = s[a * BLK + (p + i * Z1) * BW + c];
      dif<L1, true>(v + i * Z1, tw.w1);
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int a = 0; a < Z1; ++a)
          __stcs(ob + (long long)(p + i * Z1 + a * Z2) * C, v[i * Z1 + a]);
    }
  }
}

template <int L1, int L2>
cudaError_t launch_slab(const uint32_t* x, uint32_t* out, const uint32_t* twist,
                        const PassTwiddles& tw, long long C, int batches,
                        bool inverse, cudaStream_t stream) {
  constexpr int BW = SLAB_THREADS >> L1;
  constexpr size_t smem = (size_t)(1 << L1) * ((1 << L2) + 1) * BW * sizeof(uint32_t);
  void (*kernel)(const uint32_t*, uint32_t*, const uint32_t*, long long,
                 const PassTwiddles) =
      inverse ? ntt_slab<L1, L2, true> : ntt_slab<L1, L2, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((C + BW - 1) / BW), (unsigned)batches);
  kernel<<<grid, SLAB_THREADS, smem, stream>>>(x, out, twist, C, tw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ntt_cluster: 4096 < Z <= 2^16 in one pass (see above)
// ---------------------------------------------------------------------------

constexpr int CLUSTER_BW = 8;  // columns a cluster: one 32-byte sector a row
constexpr int CLUSTER_MAX_L0 = 4;  // Z0 = Z / R <= 16 blocks a cluster

// One block's share: R = Z1 * 64 rows of CLUSTER_BW columns, Z1 * CLUSTER_BW
// threads (64 values each in at most 128 registers), the slab's padded layout.
template <int L1>
struct ClusterShape {
  static constexpr int Z1 = 1 << L1, R = Z1 * 64, THREADS = Z1 * CLUSTER_BW;
  static constexpr int BLK = 65 * CLUSTER_BW;  // shared words a padded block of 64 rows
  static constexpr size_t SMEM = (size_t)Z1 * BLK * sizeof(uint32_t);
  static constexpr int MIN_BLOCKS = 65536 / (128 * THREADS);  // an SM's registers
};

struct ClusterTwiddles {  // kernel parameter (constant bank)
  uint32_t w0[1 << (CLUSTER_MAX_L0 - 1)];  // leading stages: root^(R e), e < Z0 / 2
  PassTwiddles pass;                       // the R-point slab's, root^Z0
};

// The two halves of a cluster barrier (PTX barrier.cluster).  The relaxed
// arrive orders nothing; the plain arrive releases this thread's earlier
// memory operations and the wait acquires the peers'.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Rotate each of the NI groups of Z0 = 2^L0 registers left by r: afterwards
// v[k Z0 + d] holds the old v[k Z0 + (d + r) mod Z0].  One select a value for
// each bit of r, every index a compile-time constant.
template <int L0, int NI>
__device__ __forceinline__ void rotate_groups(uint32_t* v, int r) {
  constexpr int Z0 = 1 << L0;
#pragma unroll
  for (int b = 0; b < L0; ++b) {
    const bool on = (r >> b) & 1;
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      uint32_t t[Z0];
#pragma unroll
      for (int d = 0; d < Z0; ++d) t[d] = v[k * Z0 + ((d + (1 << b)) & (Z0 - 1))];
#pragma unroll
      for (int d = 0; d < Z0; ++d) v[k * Z0 + d] = on ? t[d] : v[k * Z0 + d];
    }
  }
}

// Z = Z0 R with Z0 = 2^L0 blocks a cluster, each R = 2^L1 * 64 rows of
// CLUSTER_BW columns (the shapes of the header above: Z1 = 2^L1, Z2 = 64).
template <int L0, int L1, bool INV>
__global__ void __launch_bounds__(ClusterShape<L1>::THREADS,
                                  ClusterShape<L1>::MIN_BLOCKS)
ntt_cluster(const uint32_t* x, uint32_t* out, const uint32_t* __restrict__ otwist,
            const uint32_t* __restrict__ stwist, long long C,
            const __grid_constant__ ClusterTwiddles tw) {
  using Shape = ClusterShape<L1>;
  constexpr int Z0 = 1 << L0, Z1 = Shape::Z1, R = Shape::R, BLK = Shape::BLK;
  constexpr int BW = CLUSTER_BW;
  constexpr int NI = 64 >> L0;  // exchange sequences a thread: 64 / Z0
  constexpr int S = 64 / Z1;    // pass-A sequences a thread: 1 or 2
  static_assert(Z0 <= Z1, "a block's share of the sequences spans whole 64-row blocks");
  extern __shared__ uint32_t s[];  // rows [rank R, (rank + 1) R): row a 64 + j at a BLK + j BW + c
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, c = t % BW, p = t / BW;
  const long long col = (long long)(blockIdx.x >> L0) * BW + c;
  const bool live = col < C;
  // The exchange: thread (p, c) takes sequences j_k = rank R / Z0 + k Z1 + p
  // (k < NI) of column c.  Local row j_k of every rank lies at word
  // (j_k / 64) BLK + (j_k % 64) BW + c = slot + (k Z1 / 64) BLK + (k Z1 % 64) BW.
  const int j0 = rank * (R / Z0) + p;
  const int slot = rank * (Z1 / Z0) * BLK + t;
  uint32_t v[64];

  if (!INV) {
    cluster_arrive_relaxed();
    const uint32_t* xj = x + (long long)j0 * C + col;
#pragma unroll
    for (int k = 0; k < NI; ++k)
#pragma unroll
      for (int a = 0; a < Z0; ++a)
        v[k * Z0 + a] = live ? __ldcs(xj + (long long)(k * Z1 + a * R) * C) : 0u;
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      dif<L0, false>(v + k * Z0, tw.w0);
#pragma unroll
      for (int a = 1; a < Z0; ++a)  // twist root^(j rev(a)); 1 at a = 0
        v[k * Z0 + a] = mulmod_tw(v[k * Z0 + a], __ldg(otwist + a * R + j0 + k * Z1));
    }
    // value a goes to rank a, in turns d = 0 .. Z0 - 1 to rank + d: its own
    // rows first (local stores), then each block to a different peer at a time
    rotate_groups<L0, NI>(v, rank);  // v[k Z0 + d]: value rank + d
    cluster_wait();                  // every peer has started
#pragma unroll
    for (int d = 0; d < Z0; ++d) {
      uint32_t* dst = d == 0 ? s : cluster.map_shared_rank(s, (rank + d) & (Z0 - 1));
#pragma unroll
      for (int k = 0; k < NI; ++k)
        dst[slot + (k * Z1 / 64) * BLK + (k * Z1 % 64) * BW] = v[k * Z0 + d];
    }
    cluster.sync();
    // pass A in place: sequences p + i Z1 of this block's rows
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int a = 0; a < Z1; ++a) v[a] = s[a * BLK + i * Z1 * BW + t];
      dif<L1, false>(v, tw.pass.w1);
#pragma unroll
      for (int a = 0; a < Z1; ++a) s[a * BLK + i * Z1 * BW + t] = v[a];
    }
    __syncthreads();
    // pass B: block p (local rows p 64 + i), the twist, then its DIF
#pragma unroll
    for (int i = 0; i < 64; ++i) v[i] = s[p * BLK + i * BW + c];
    twist_row<64, false>(v, stwist + p * 64);
    dif<6, false>(v, tw.pass.w2);
    if (live) {
      uint32_t* ob = out + (long long)(rank * R + p * 64) * C + col;
#pragma unroll
      for (int i = 0; i < 64; ++i) __stcs(ob + (long long)i * C, v[i]);
    }
  } else {
    // pass B's inverse stages and the inverse twist on local rows p 64 + i
    const uint32_t* xb = x + (long long)(rank * R + p * 64) * C + col;
#pragma unroll
    for (int i = 0; i < 64; ++i) v[i] = live ? __ldcs(xb + (long long)i * C) : 0u;
    dif<6, true>(v, tw.pass.w2);
    twist_row<64, true>(v, stwist + p * 64);
#pragma unroll
    for (int i = 0; i < 64; ++i) s[p * BLK + i * BW + c] = v[i];
    __syncthreads();
    // pass A's inverse stages in place on sequences p + i Z1
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int a = 0; a < Z1; ++a) v[a] = s[a * BLK + i * Z1 * BW + t];
      dif<L1, true>(v, tw.pass.w1);
#pragma unroll
      for (int a = 0; a < Z1; ++a) s[a * BLK + i * Z1 * BW + t] = v[a];
    }
    cluster.sync();
    // value a comes from rank a, in turns as the forward's stores
#pragma unroll
    for (int d = 0; d < Z0; ++d) {
      const uint32_t* src =
          d == 0 ? s : cluster.map_shared_rank(s, (rank + d) & (Z0 - 1));
#pragma unroll
      for (int k = 0; k < NI; ++k)
        v[k * Z0 + d] = src[slot + (k * Z1 / 64) * BLK + (k * Z1 % 64) * BW];
    }
    cluster_arrive();                             // the reads from the peers are done
    rotate_groups<L0, NI>(v, (Z0 - rank) & (Z0 - 1));  // v[k Z0 + a]: value a
#pragma unroll
    for (int k = 0; k < NI; ++k) {
#pragma unroll
      for (int a = 0; a < Z0; ++a)  // inverse twist, Z^-1 folded in
        v[k * Z0 + a] = mulmod(v[k * Z0 + a], __ldg(otwist + a * R + j0 + k * Z1));
      dif<L0, true>(v + k * Z0, tw.w0);
    }
    if (live) {
      uint32_t* oj = out + (long long)j0 * C + col;
#pragma unroll
      for (int k = 0; k < NI; ++k)
#pragma unroll
        for (int a = 0; a < Z0; ++a)
          __stcs(oj + (long long)(k * Z1 + a * R) * C, v[k * Z0 + a]);
    }
    cluster_wait();  // no peer reads this block's rows any more
  }
}

typedef void (*ClusterKernel)(const uint32_t*, uint32_t*, const uint32_t*,
                              const uint32_t*, long long, const ClusterTwiddles);

// Sets the function attributes of ntt_cluster<L0, L1, INV> on the current
// device, once a device (they hold for every later launch there).
template <int L0, int L1, bool INV>
cudaError_t cluster_attributes() {
  static std::atomic<unsigned long long> done{0};  // a bit per device < 64
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const ClusterKernel kernel = ntt_cluster<L0, L1, INV>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ClusterShape<L1>::SMEM);
  if (err == cudaSuccess && (1 << L0) > 8)  // above the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The launch of ntt_cluster<L0, L1, INV> over C columns: its attributes set
// and `cfg` filled (the cluster dimension in attr[0]).
template <int L0, int L1, bool INV>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           long long C, cudaStream_t stream) {
  using Shape = ClusterShape<L1>;
  const cudaError_t err = cluster_attributes<L0, L1, INV>();
  if (err != cudaSuccess) return err;
  const long long groups = (C + CLUSTER_BW - 1) / CLUSTER_BW;
  if (groups > (0x7FFFFFFFLL >> L0)) return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(groups << L0));
  cfg->blockDim = dim3(Shape::THREADS);
  cfg->dynamicSmemBytes = Shape::SMEM;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << L0;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int L0, int L1, bool INV>
cudaError_t launch_cluster(const uint32_t* x, uint32_t* out, const uint32_t* otwist,
                           const uint32_t* stwist, const ClusterTwiddles& tw,
                           long long C, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<L0, L1, INV>(&cfg, attr, C, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, ntt_cluster<L0, L1, INV>, x, out, otwist,
                           stwist, C, tw);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// info[0..6] of ntt_cluster<L0, L1, INV>: blocks a cluster, shared bytes a
// block, columns a cluster, threads a block, the clusters that can be
// resident at once (cudaOccupancyMaxActiveClusters), registers a thread
// and local (spill) bytes a thread.
template <int L0, int L1, bool INV>
cudaError_t cluster_facts(int* info) {
  using Shape = ClusterShape<L1>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<L0, L1, INV>(&cfg, attr, 1LL << 20, nullptr);
  if (err != cudaSuccess) return err;
  info[0] = 1 << L0;
  info[1] = (int)Shape::SMEM;
  info[2] = CLUSTER_BW;
  info[3] = Shape::THREADS;
  const ClusterKernel kernel = ntt_cluster<L0, L1, INV>;
  err = cudaOccupancyMaxActiveClusters(&info[4], kernel, &cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  info[5] = fa.numRegs;
  info[6] = (int)fa.localSizeBytes;
  return cudaSuccess;
}

// The block layout of a Z-point transform, Z = 2^H: rows = 2048 for
// 13 <= H <= 15 (256 threads, two blocks an SM, so one block's loads and
// stores overlap the other's arithmetic) and rows = 4096 for H = 16 (512
// threads, one block an SM: 2048 rows would need 32 blocks a cluster).
// Calls fn.template run<L0, L1>() with rows = 2^(L1 + 6) and Z0 = 2^L0, or
// returns cudaErrorInvalidValue for any other H.
template <class Fn>
cudaError_t with_layout(int H, Fn& fn) {
  switch (H) {
    case 13: return fn.template run<2, 5>();
    case 14: return fn.template run<3, 5>();
    case 15: return fn.template run<4, 5>();
    case 16: return fn.template run<4, 6>();
    default: return cudaErrorInvalidValue;
  }
}

struct ClusterLaunch {  // with_layout's launch
  const uint32_t *x, *otwist, *stwist;
  uint32_t* out;
  const ClusterTwiddles& tw;
  long long C;
  bool inverse;
  cudaStream_t stream;
  template <int L0, int L1>
  cudaError_t run() {
    if (C <= 0) return cudaGetLastError();
    return inverse
        ? launch_cluster<L0, L1, true>(x, out, otwist, stwist, tw, C, stream)
        : launch_cluster<L0, L1, false>(x, out, otwist, stwist, tw, C, stream);
  }
};

struct ClusterFacts {  // with_layout's facts of both directions
  int* info;
  template <int L0, int L1>
  cudaError_t run() {
    int inv[7];
    cudaError_t err = cluster_facts<L0, L1, false>(info);
    if (err != cudaSuccess) return err;
    err = cluster_facts<L0, L1, true>(inv);
    for (int i = 0; i < 3; ++i) info[7 + i] = inv[4 + i];
    return err;
  }
};

// ---------------------------------------------------------------------------
// ntt_regs: Z <= 64 (see above)
// ---------------------------------------------------------------------------

constexpr int REG_THREADS = 128;
constexpr int REG_MAX_H = 6;  // Z <= 64

struct Twiddles {  // kernel parameter: root^e, e < Z / 2 (the constant bank)
  uint32_t w[1 << (REG_MAX_H - 1)];
};

template <int H, bool INV>
__global__ void __launch_bounds__(REG_THREADS)
ntt_regs(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
         long long C, uint32_t scale, const __grid_constant__ Twiddles tw) {
  constexpr int Z = 1 << H;
  const long long c = (long long)blockIdx.x * REG_THREADS + threadIdx.x;
  if (c >= C) return;
  uint32_t v[Z];
#pragma unroll
  for (int r = 0; r < Z; ++r) v[r] = __ldcs(x + r * C + c);  // read once
  dif<H, INV>(v, tw.w);
#pragma unroll
  for (int r = 0; r < Z; ++r)
    __stcs(out + r * C + c, INV ? mulmod(v[r], scale) : v[r]);  // written once
}

template <int H>
cudaError_t launch_regs(const uint32_t* x, uint32_t* out, const Twiddles& tw,
                        long long C, uint32_t scale, bool inverse,
                        cudaStream_t stream) {
  const unsigned blocks = (unsigned)((C + REG_THREADS - 1) / REG_THREADS);
  if (inverse)
    ntt_regs<H, true><<<blocks, REG_THREADS, 0, stream>>>(x, out, C, scale, tw);
  else
    ntt_regs<H, false><<<blocks, REG_THREADS, 0, stream>>>(x, out, C, scale, tw);
  return cudaGetLastError();
}

}  // namespace

// out = the Z-point NTT (see ntt_slab above), Z = 2^H, 7 <= H <= 12, along
// axis 0 of each of `batches` stacked (Z, C) arrays, on `stream`, in blocks
// of 512 threads and 512 / Z1 columns.  twist: the (Z1, Z2) twist table in
// device memory (16-byte aligned); tw_host: the pass twiddles (w1[32],
// w2[32]) in host memory, copied into the launch's parameters.  x may equal
// out.  Returns cudaGetLastError() of the launch.
extern "C" int ntt_slab_launch(const void* x, void* out, const void* twist,
                               const void* tw_host, int H, long long C,
                               int batches, int inverse, void* stream) {
  PassTwiddles tw;
  const uint32_t* src = (const uint32_t*)tw_host;
  for (int i = 0; i < 32; ++i) {
    tw.w1[i] = src[i];
    tw.w2[i] = src[32 + i];
  }
  if (C <= 0 || batches <= 0) return (int)cudaGetLastError();
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* tt = (const uint32_t*)twist;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool inv = inverse != 0;
  switch (H) {
    case 7: return (int)launch_slab<3, 4>(xi, o, tt, tw, C, batches, inv, st);
    case 8: return (int)launch_slab<4, 4>(xi, o, tt, tw, C, batches, inv, st);
    case 9: return (int)launch_slab<4, 5>(xi, o, tt, tw, C, batches, inv, st);
    case 10: return (int)launch_slab<5, 5>(xi, o, tt, tw, C, batches, inv, st);
    case 11: return (int)launch_slab<5, 6>(xi, o, tt, tw, C, batches, inv, st);
    case 12: return (int)launch_slab<6, 6>(xi, o, tt, tw, C, batches, inv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out = NTT(x) along axis 0 on `stream` for Z = 2^H <= 64 rows, one column a
// thread in registers; tw_host holds the Z/2 powers root^e in host memory
// (copied into the launch's parameters).  Returns cudaGetLastError().
extern "C" int ntt_regs_launch(const void* x, void* out, const void* tw_host,
                               int H, long long C, unsigned int scale,
                               int inverse, void* stream) {
  if (H < 0 || H > REG_MAX_H) return (int)cudaErrorInvalidValue;
  Twiddles tw = {};
  const uint32_t* src = (const uint32_t*)tw_host;
  for (int i = 0; i < (1 << H) / 2; ++i) tw.w[i] = src[i];
  if (C <= 0) return (int)cudaGetLastError();
  const uint32_t* xi = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool inv = inverse != 0;
  switch (H) {
    case 0: return (int)launch_regs<0>(xi, o, tw, C, scale, inv, st);
    case 1: return (int)launch_regs<1>(xi, o, tw, C, scale, inv, st);
    case 2: return (int)launch_regs<2>(xi, o, tw, C, scale, inv, st);
    case 3: return (int)launch_regs<3>(xi, o, tw, C, scale, inv, st);
    case 4: return (int)launch_regs<4>(xi, o, tw, C, scale, inv, st);
    case 5: return (int)launch_regs<5>(xi, o, tw, C, scale, inv, st);
    default: return (int)launch_regs<6>(xi, o, tw, C, scale, inv, st);
  }
}

// out = the Z-point NTT, Z = 2^H with 13 <= H <= 16, along axis 0 of a
// (Z, C) array on `stream` in one pass: clusters of Z / rows blocks, each
// holding `rows` rows (2048 below H = 16, 4096 at it; see with_layout) of 8
// columns in shared memory (see ntt_cluster above).  otwist: the
// (Z / rows, rows) leading-stages twist table (Z^-1 folded into the
// inverse's); stwist: the (rows / 64, 64) twist table of the rows-point
// slab with root^(Z / rows); both in device memory, 16-byte aligned.
// tw_host: 72 words in host memory, copied into the launch's parameters:
// w0[8] = root^(rows e), e < Z / rows / 2, then the slab's w1[32] and
// w2[32].  x may equal out.  Returns the error of the attributes, of
// cudaLaunchKernelEx (a refused cluster launch) or cudaGetLastError().
extern "C" int ntt_cluster_launch(const void* x, void* out, const void* otwist,
                                  const void* stwist, const void* tw_host, int H,
                                  long long C, int inverse, void* stream) {
  ClusterTwiddles tw;
  const uint32_t* src = (const uint32_t*)tw_host;
  for (int i = 0; i < 8; ++i) tw.w0[i] = src[i];
  for (int i = 0; i < 32; ++i) {
    tw.pass.w1[i] = src[8 + i];
    tw.pass.w2[i] = src[40 + i];
  }
  ClusterLaunch fn{(const uint32_t*)x, (const uint32_t*)otwist,
                   (const uint32_t*)stwist, (uint32_t*)out, tw, C, inverse != 0,
                   (cudaStream_t)stream};
  return (int)with_layout(H, fn);
}

// Launch facts of ntt_cluster at Z = 2^H (rows a block: see with_layout),
// for reports: info[0] blocks a cluster, [1] dynamic shared bytes a block, [2]
// columns a cluster, [3] threads a block, then (forward, inverse) each:
// [4, 7] the clusters that can be resident at once, [5, 8] registers a
// thread, [6, 9] local (spill) bytes a thread.  Returns the first CUDA error.
extern "C" int ntt_cluster_config(int H, int* info) {
  ClusterFacts fn{info};
  return (int)with_layout(H, fn);
}
