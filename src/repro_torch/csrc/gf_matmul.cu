// (a @ b) mod 65537 on the int8 tensor cores: the field matmul behind the
// dense encode, every decode, every rebuild and every degraded read.
//
// Replaces the TPU kernel `_gf_matmul_kernel` of src/repro/kernels/gf_matmul.py
// (launched by `gf_matmul`).  That kernel works in uint32 only: it
// Fermat-reduces every product before accumulating, special-cases a == 65536
// and slices the reduction to bound partial sums.  Here the field
// multiply-adds run as exact integer products of 8-bit limbs on the tensor
// cores (`mma.sync.aligned.m16n8k32` with u8/s8 operands, s32 accumulators).
//
// Exactness.  q = 2^16 + 1, so 2^16 == -1 and 2^32 == 1 (mod q).  Values lie
// in [0, q), and 65536 == -1 is the one value that needs a 17th bit.
//   a = a0 + 2^8 a1 + 2^16 a2    a0, a1 in [0, 255], a2 in {0, 1}
//   b = b0 + 2^8 b1 + 2^16 b2    b0, b1 in [0, 255], b2 in {0, 1}
// (a2 = 1 only for a = 65536, and then a0 = a1 = 0; the same for b).  The
// nine limb products fall into three s32 accumulators by weight mod q:
//   S0  (weight  1):   a0 b0                  + a2 b2       (2^32 ==  1)
//   S8  (weight 2^8):  a0 b1 + a1 b0 - a2 b1 - a1 b2        (2^24 == -2^8)
//   S16 (weight -1):   a1 b1 + a2 b0 + a0 b2                (2^16 == -1)
// and c == S0 + 2^8 S8 - S16 (mod q).  The two negative terms run as s8
// operands holding -a2 and -b2 (bytes 0xFF), so -1 needs no fourth
// accumulator.  a2 and b2 are rare: a2's products run only for 16-row tiles
// of a whose rows hold a 65536 (row flags from the wrapper; a2 is then read
// from L2), b2's only in a K-step of the slab where some b is 65536 (a
// block-wide vote while b is staged).  Typical inputs thus take four u8
// products per field multiply-add; all-65536 inputs take nine and stay
// bitwise.
//
// Overflow.  Per k, S8 grows by at most 2 * 255^2 = 130,050 and falls by at
// most 255; S0 and S16 grow by at most 255^2 + 2 * 255.  So s32 is exact for
// up to 16,512 terms (16,512 * 130,050 < 2^31).  Every 16,384 of K (64
// staged chunks) the sums are reduced mod q into c and restarted; c is read
// back at the next flush and at the end.  The final reduction adds 2^16 q to make
// S0 + 2^8 S8 - S16 nonnegative (it is above -2^32) and folds the 64-bit
// value with 2^16 == -1, 2^32 == 1.
//
// Bound on this card.  With tensor cores the least time is the bytes bound:
// at the degraded read's (256 x 256) . (256 x 2^18), 537.1 MB at 3.35 TB/s =
// 0.160 ms, against 0.104 ms for even six u8 products per multiply-add at
// 989.5 T MAC/s; the repair shape (64 rows) moves 335.6 MB, 0.100 ms.  On the
// CUDA cores' INT32 lanes (16.75 T multiply-adds/s) the same work needs
// 1.026 ms and 0.256 ms.
//
// Design.  Each block owns a slab of BN = 128 columns of b.  It reads b once
// from device memory, splits each value into its limbs while staging, and
// keeps the slab in shared memory as packed u8 planes, K-major per column as
// the MMA's B operand wants (KC = 256 rows: 2 x 32 KiB plus the b2 nibbles;
// words swizzled so staging stores and fragment reads are free of bank
// conflicts).  It then loops over all M-tiles of a (BM = 32 rows) against the
// slab, so the payload is read once however many rows a has.  Staging
// overlaps the MMAs: under the first M-tile the block loads the next 32-row
// step of b into registers (each warp load one 128-byte line of a row) while
// the tensor cores work on the step just stored, and two blocks share an SM,
// so one stages while the other computes.  Two blocks of 256 threads leave
// 128 registers a thread; loading four steps of b at once instead of one
// needs more, spills, and ran slower.  a's limb planes a0, a1 come by
// cp.async into two buffers, the next M-tile's while this one computes.
// Deeper K (K > 256) is cut into chunks that are staged again for every
// M-tile; that re-read occurs only on shapes off the main path.  The wrapper
// builds a's limb planes (a is at most a few hundred x K values), padded
// with zeros to a multiple of 16 in K.  Ragged M, N and K of the payload
// are masked here; the host pads nothing.
//
// Batched entry.  `gf_matmul_batched_launch` runs B independent products in
// one launch, batch index on blockIdx.y (B <= 65535) with 64-bit batch
// strides; the 2-D entry is the same kernel body without the batch offsets
// (a template flag), so its code and its times are those it had before.  It
// is the mesh combine's design for large M K only: the combine's small
// shapes, (9 x 8) . (8 x 2^18) at rs K=256 R=64 among them, run on the CUDA
// cores in csrc/gf_matmul_small.cu, since this slab design pays a block's
// set-up (one M-tile, one k-step, rows past M zero) for every 128 columns.
//
// Layouts: al (3, M, Kp) uint8 limb planes of a; ahi (M,) uint8 row flags;
// b (K, N) and c (M, N) row-major int32 holding values in [0, q), read as
// uint32 (batched: each with a leading B axis).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kQ = 65537u;
constexpr int THREADS = 256;          // 8 warps
constexpr int BN = 128;               // slab width: columns of b per block
constexpr int BM = 32;                // rows of a per M-tile
constexpr int KC = 256;               // k values per staged chunk
constexpr int KW = KC / 4;            // words of 4 packed limbs per slab row
constexpr int ST = KW + 4;            // row stride in words, == 4 (mod 32):
                                      // lanes (g, t) reading (row g, word t)
                                      // hit 32 distinct banks
constexpr int STEPS = KC / 32;        // MMA k-steps per chunk
constexpr int FLUSH_CHUNKS = 16384 / KC;
constexpr int B_PLANE = BN * ST;      // words of one slab limb plane
constexpr int A_PLANE = BM * ST;      // words of one M-tile's a0 or a1
constexpr int A_BUF = 2 * A_PLANE;    // one M-tile of a0 and a1
constexpr int SMEM_BYTES = (2 * B_PLANE + 2 * A_BUF) * 4 + KW * BN;
constexpr unsigned FULL = 0xFFFFFFFFu;

// c[4] += a (16 x 32, row) * b (32 x 8, col), s32 accumulate.  Fragments per
// lane (g = lane / 4, t = lane % 4): a = {row g, row g+8} x {k 4t.., k 16+4t..},
// b = column g x {k 4t.., k 16+4t..}, c = {row g, g+8} x {column 2t, 2t+1};
// each 32-bit register packs 4 consecutive k, lowest k in the low byte.
#define GF_MMA(NAME, TYPES)                                                   \
  __device__ __forceinline__ void NAME(int (&c)[4], const uint32_t (&a)[4],   \
                                       const uint32_t (&b)[2]) {              \
    asm("mma.sync.aligned.m16n8k32.row.col.s32." TYPES ".s32 "                \
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"             \
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                      \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1])); \
  }
GF_MMA(mma_uu, "u8.u8")
GF_MMA(mma_su, "s8.u8")
GF_MMA(mma_us, "u8.s8")
#undef GF_MMA

// Word w of slab column col sits at w ^ ((col / 8) % 4): the staging
// stores (32 consecutive columns, one word) and the fragment reads (8
// columns x 4 words) both hit 32 distinct banks.
__device__ __forceinline__ int swz(int w, int col) {
  return w ^ ((col >> 3) & 3);
}

// 16 bytes global -> shared without registers; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// A nibble of b2 bits (4 consecutive k) as 4 bytes of 0 or 1.
__device__ __forceinline__ uint32_t expand_nibble(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// (S0 + 2^8 S8 - S16) mod q.  The sum lies in (-2^32, 2^41); adding
// 2^16 q > 2^32 makes it nonnegative, and x = lo + 2^16 mid + 2^32 hi
// == lo - mid + hi with hi < 2^10.
__device__ __forceinline__ uint32_t combine(int s0, int s8, int s16) {
  const unsigned long long x = (unsigned long long)(
      (long long)s0 + 256LL * s8 - s16 + (long long)kQ * 65536);
  int r = (int)(x & 0xFFFFu) - (int)((x >> 16) & 0xFFFFu) + (int)(x >> 32) +
          (int)kQ;  // in (0, 3q)
  r = r >= (int)kQ ? r - (int)kQ : r;
  r = r >= (int)kQ ? r - (int)kQ : r;
  return (uint32_t)r;
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= kQ ? s - kQ : s;
}

typedef int Acc[3][2][2][4];  // [S0, S8, S16][m16 tile][n8 tile][fragment]

// One 32-deep k-step s of the warp's 32 x 16 output tile.  a2[mi] says
// whether a's top limb takes part in m16 tile mi (its rows hold a 65536:
// read from al2, a's third plane in device memory), b2 whether b's does.
__device__ __forceinline__ void mma_step(Acc& acc, const uint32_t* Bs,
                                         const uint32_t* A, const uint8_t* B2,
                                         const uint8_t* __restrict__ al2,
                                         int M, int Kp, int m0, int k0, int s,
                                         int wn, int g, int t,
                                         const bool (&a2)[2], bool b2) {
  const int w = s * 8 + t;  // slab word of k = 32 s + 4 t
  uint32_t b0[2][2], b1[2][2], bb[2][2], bn[2][2];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int col = wn + nj * 8 + g;
    const int o = col * ST + swz(w, col);  // swz(w + 4) = swz(w) + 4
    b0[nj][0] = Bs[o];
    b0[nj][1] = Bs[o + 4];
    b1[nj][0] = Bs[B_PLANE + o];
    b1[nj][1] = Bs[B_PLANE + o + 4];
    if (b2) {
      bb[nj][0] = expand_nibble(B2[w * BN + col]);
      bb[nj][1] = expand_nibble(B2[(w + 4) * BN + col]);
      bn[nj][0] = bb[nj][0] * 0xFFu;  // -b2 as s8
      bn[nj][1] = bb[nj][1] * 0xFFu;
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int o = (mi * 16 + g) * ST + w;
    const uint32_t a0[4] = {A[o], A[o + 8 * ST], A[o + 4], A[o + 8 * ST + 4]};
    const uint32_t* A1 = A + A_PLANE;
    const uint32_t a1[4] = {A1[o], A1[o + 8 * ST], A1[o + 4], A1[o + 8 * ST + 4]};
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      mma_uu(acc[0][mi][nj], a0, b0[nj]);
      mma_uu(acc[1][mi][nj], a0, b1[nj]);
      mma_uu(acc[2][mi][nj], a1, b1[nj]);
      mma_uu(acc[1][mi][nj], a1, b0[nj]);
    }
    if (a2[mi]) {  // warp-uniform, rare: the fragment of a2 from L2
      const int r = m0 + mi * 16 + g, kb = k0 + s * 32 + 4 * t;
      uint32_t p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e & 1) * 8, kk = kb + (e >> 1) * 16;
        p[e] = (rr < M && kk < Kp)
                   ? __ldg(reinterpret_cast<const uint32_t*>(
                         al2 + (long long)rr * Kp + kk))
                   : 0u;
      }
      const uint32_t pn[4] = {p[0] * 0xFFu, p[1] * 0xFFu, p[2] * 0xFFu,
                              p[3] * 0xFFu};  // -a2 as s8
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        mma_uu(acc[2][mi][nj], p, b0[nj]);
        mma_su(acc[1][mi][nj], pn, b1[nj]);
        if (b2) mma_uu(acc[0][mi][nj], p, bb[nj]);
      }
    }
    if (b2) {
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        mma_uu(acc[2][mi][nj], a0, bb[nj]);
        mma_us(acc[1][mi][nj], a1, bn[nj]);
      }
    }
  }
}

// Reduce the warp's accumulators mod q into c (adding c's earlier partial
// sum when `add_old`), and restart them.
__device__ __forceinline__ void write_tile(Acc& acc, uint32_t* __restrict__ c,
                                           int M, int N, int m0, long long col0,
                                           int g, int t, bool add_old) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mi * 16 + h * 8 + g;
        const long long col = col0 + nj * 8 + 2 * t;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          v[e] = combine(acc[0][mi][nj][i], acc[1][mi][nj][i], acc[2][mi][nj][i]);
          acc[0][mi][nj][i] = acc[1][mi][nj][i] = acc[2][mi][nj][i] = 0;
        }
        if (row >= M) continue;
        uint32_t* dst = c + (long long)row * N + col;
        if (add_old) {
          if (col < N) v[0] = addmod(v[0], dst[0]);
          if (col + 1 < N) v[1] = addmod(v[1], dst[1]);
        }
        if (col + 1 < N && (N & 1) == 0) {  // col is even: 8-byte aligned
          *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
        } else {
          if (col < N) dst[0] = v[0];
          if (col + 1 < N) dst[1] = v[1];
        }
      }
}

// kBatched: batch z = blockIdx.y multiplies its own operands (al, ahi, b
// and c advance by z times their batch strides).  The one-product entry is
// the kBatched = false instance, which compiles to the kernel as it was
// before the batched entry existed (the strides are unused there).
template <bool kBatched>
__global__ void __launch_bounds__(THREADS, 2)
gf_matmul_imma(const uint8_t* __restrict__ al, const uint8_t* __restrict__ ahi,
               const uint32_t* __restrict__ b, uint32_t* __restrict__ c,
               int M, int N, int K, int Kp, long long s_al, long long s_ahi,
               long long s_b, long long s_c) {
  extern __shared__ __align__(16) uint32_t smem[];
  if constexpr (kBatched) {
    const long long z = blockIdx.y;
    al += z * s_al;
    ahi += z * s_ahi;
    b += z * s_b;
    c += z * s_c;
  }
  uint32_t* Bs = smem;                      // [2][BN][ST] b0, b1 (swizzled)
  uint32_t* Ab = smem + 2 * B_PLANE;        // [2 buffers][2][BM][ST] a0, a1
  uint8_t* B2 = reinterpret_cast<uint8_t*>(Ab + 2 * A_BUF);  // [KW][BN]
  const uint8_t* al2 = al + 2LL * M * Kp;   // a's third limb plane

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long n0 = (long long)blockIdx.x * BN;
  const int wn = warp * 16;  // the warp's 16 columns of the slab
  const int nchunks = max(1, (K + KC - 1) / KC);  // K = 0: one empty chunk
  const bool restage = nchunks > 1;  // else staged once, under M-tile 0
  const int tiles = (M + BM - 1) / BM * nchunks;  // (M-tile, chunk) in order

  // Staging map: unit u = warp + 8 i packs word u / 4 (4 consecutive k) of
  // columns 32 (u % 4) + lane, so each load instruction reads one 128-byte
  // line of a row of b.
  int scol[4], sword[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = warp + 8 * i;
    scol[i] = (u & 3) * 32 + lane;
    sword[i] = u >> 2;
  }

  // a0, a1 of tile tt into A buffer `buf` by cp.async (zero outside
  // (M, Kp)), and the flags of its rows (a 65536 somewhere) into `flag`.
  auto fetch_a = [&](int tt, int buf, uint32_t& flag) {
    if (tt < tiles) {
      const int m0 = tt / nchunks * BM, k0 = tt % nchunks * KC;
#pragma unroll
      for (int it = 0; it < 2 * BM * (KC / 16) / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int p = i / (BM * (KC / 16)), r = i / (KC / 16) % BM,
                  j = i % (KC / 16);
        const int gr = m0 + r, gk = k0 + j * 16;
        const bool valid = gr < M && gk < Kp;
        cp_async16(Ab + buf * A_BUF + (p * BM + r) * ST + j * 4,
                   valid ? al + ((long long)p * M + gr) * Kp + gk : al, valid);
      }
      flag = m0 + lane < M ? ahi[m0 + lane] : 0u;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  uint32_t bmask = 0;  // bit s: k-step s of the slab holds a b == 65536
  uint32_t fl_next = 0;
  Acc acc;
#pragma unroll
  for (int i = 0; i < 3 * 2 * 2 * 4; ++i) (&acc[0][0][0][0])[i] = 0;

  fetch_a(0, 0, fl_next);
  for (int tt = 0; tt < tiles; ++tt) {
    const int m0 = tt / nchunks * BM, kc = tt % nchunks, k0 = kc * KC;
    const int steps = min(STEPS, (K - k0 + 31) / 32);
    const uint32_t* A = Ab + (tt & 1) * A_BUF;
    const uint32_t fl = fl_next;
    __syncthreads();  // tile tt-1's reads of the other A buffer are done
    fetch_a(tt + 1, (tt & 1) ^ 1, fl_next);  // lands during this tile
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile's a is in
    __syncthreads();
    const bool a2[2] = {__any_sync(FULL, lane < 16 && fl != 0u),
                        __any_sync(FULL, lane >= 16 && fl != 0u)};

    if (restage || m0 == 0) {
      bmask = 0;
      uint32_t pre[4][4];
      auto load = [&](int s) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + s * 32 + sword[i] * 4 + j;
            const long long n = n0 + scol[i];
            pre[i][j] = (k < K && n < N) ? __ldg(b + (long long)k * N + n) : 0u;
          }
      };
      load(0);
      for (int s = 0; s < steps; ++s) {
        bool hit = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t lo = 0, hi = 0, top = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lo |= (pre[i][j] & 0xFFu) << (8 * j);
            hi |= ((pre[i][j] >> 8) & 0xFFu) << (8 * j);
            top |= (pre[i][j] >> 16) << j;
          }
          const int w = s * 8 + sword[i];
          const int o = scol[i] * ST + swz(w, scol[i]);
          Bs[o] = lo;
          Bs[B_PLANE + o] = hi;
          B2[w * BN + scol[i]] = (uint8_t)top;
          hit |= top != 0u;
        }
        bmask |= (uint32_t)(__syncthreads_or(hit) != 0) << s;
        if (s + 1 < steps) load(s + 1);  // in flight during the MMAs
        mma_step(acc, Bs, A, B2, al2, M, Kp, m0, k0, s, wn, g, t, a2,
                 (bmask >> s) & 1u);
      }
    } else {
      for (int s = 0; s < steps; ++s)
        mma_step(acc, Bs, A, B2, al2, M, Kp, m0, k0, s, wn, g, t, a2,
                 (bmask >> s) & 1u);
    }
    if (kc + 1 == nchunks)
      write_tile(acc, c, M, N, m0, n0 + wn, g, t, nchunks > FLUSH_CHUNKS);
    else if ((kc + 1) % FLUSH_CHUNKS == 0)  // s32 headroom
      write_tile(acc, c, M, N, m0, n0 + wn, g, t, kc + 1 > FLUSH_CHUNKS);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One launch of B products on `stream` (grid.y = B <= 65535).
template <bool kBatched>
int launch(const void* al, const void* ahi, const void* b, void* c, int B,
           int M, int N, int K, int Kp, long long s_al, long long s_ahi,
           long long s_b, long long s_c, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(  // per device: set each call
      gf_matmul_imma<kBatched>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && M > 0 && N > 0) {
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)B);
    gf_matmul_imma<kBatched><<<grid, THREADS, SMEM_BYTES,
                               (cudaStream_t)stream>>>(
        (const uint8_t*)al, (const uint8_t*)ahi, (const uint32_t*)b,
        (uint32_t*)c, M, N, K, Kp, s_al, s_ahi, s_b, s_c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// c = (a @ b) mod 65537 on `stream`, with al the (3, M, Kp) u8 limb planes of
// a (Kp a multiple of 16, zero beyond K) and ahi (M,) u8, nonzero for the
// rows of a that hold a 65536.  Returns cudaGetLastError().
extern "C" int gf_matmul_launch(const void* al, const void* ahi, const void* b,
                                void* c, int M, int N, int K, int Kp,
                                void* stream) {
  return launch<false>(al, ahi, b, c, 1, M, N, K, Kp, 0, 0, 0, 0, stream);
}

// c[z] = (a[z] @ b[z]) mod 65537 for z < B, in one launch: al (B, 3, M, Kp)
// limb planes, ahi (B, M) row flags, b (B, K, N) and c (B, M, N), each batch
// contiguous after the one before.  Returns cudaGetLastError().
extern "C" int gf_matmul_batched_launch(const void* al, const void* ahi,
                                        const void* b, void* c, int B, int M,
                                        int N, int K, int Kp, void* stream) {
  return launch<true>(al, ahi, b, c, B, M, N, K, Kp, 3LL * M * Kp, M,
                (long long)K * N, (long long)M * N, stream);
}
