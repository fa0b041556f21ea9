// Batched radix-2 NTT over F_65537 along axis 0 of a (Z, C) array: the O(K log K)
// local encode (the paper's permuted DFT D_Z Pi, Sec. V-A).
//
// Replaces the TPU kernel `_ntt_kernel` of src/repro/kernels/ntt.py (body
// `_ntt_stages`, launched by `ntt`).  It computes the same thing in the same
// order: the forward transform runs decimation-in-frequency stages
// h = 0 .. H-1 (u' = u + v, v' = (u - v) w), leaving the output in
// bit-reversed order; the inverse runs h = H-1 .. 0 with the inverse twiddles
// (u' = u + v w, v' = u - v w) and then scales by Z^-1.  The twiddle of the
// b-th butterfly of stage h is tw[h, b], as in `ntt_twiddles`.  Here the
// Z^-1 scale is folded into the write-back (`scale`; 1 for the forward
// transform), which gives the same values as the separate multiply.  All
// arithmetic is exact mod q: products of two residues (<= 2^32) are folded
// with 2^16 == -1 (mod q).
//
// Bound on this card: each element is read once and written once and takes
// log2 Z butterflies of a few integer operations, so the transform is bound
// by memory bytes: at the main path's (64, 2^20), 536.9 MB at 3.35 TB/s =
// 0.160 ms; at the dft encode's (4096, 2^12), 134.2 MB = 0.040 ms.
//
// Two kernels; the wrapper picks by Z.
//
// ntt_regs (Z <= 64, the rs codeword's Z = 64): each thread owns one column
// and holds all Z values in registers.  Row r of column c is x[r C + c], so
// the warp's loads and stores are coalesced and each thread has Z
// independent loads in flight.  The kernel is templated on H = log2 Z and
// fully unrolled, so every register index and every twiddle index is a
// compile-time constant: no local memory, no shared memory, no barrier.  The
// twiddles are a kernel parameter (constant memory, the same word for every
// thread: a broadcast operand); butterflies whose twiddle is root^0 = 1 skip
// the multiply.
//
// ntt_slab (64 < Z <= 4096): one block holds a (Z, bw) column slab in shared
// memory for all log2 Z stages, so device memory is touched only by the one
// coalesced load and the one store; bw shrinks as Z grows so that
// Z * bw * 4 bytes fits in a block's shared memory (Z = 128: bw = 128,
// 64 KiB; Z = 4096: bw = 8, 128 KiB).  Z above 4096 needs a four-step split
// (later work); the wrapper refuses it.
//
// Layouts: x and out (Z, C) row-major int32 holding values in [0, q), read as
// uint32; tw (H, Z/2) uint32.  Ragged C is masked here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kQ = 65537u;
constexpr int THREADS = 256;

// a * b mod q for a, b in [0, q): the product p <= 2^32 needs 64 bits.  With
// p = hi * 2^16 + lo and 2^16 == -1 (mod q), p == lo - hi, and
// lo + q - hi lies in (0, 2q), so one conditional subtract finishes it.
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  const unsigned long long p = (unsigned long long)a * b;
  const uint32_t lo = (uint32_t)(p & 0xFFFFull);
  const uint32_t hi = (uint32_t)(p >> 16);  // <= 2^16
  const uint32_t r = lo + kQ - hi;
  return r >= kQ ? r - kQ : r;
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= kQ ? s - kQ : s;
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + kQ - b;
}

__global__ void __launch_bounds__(THREADS)
ntt_slab(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ tw, int H, long long C, int lbw,
           uint32_t scale, int inverse) {
  extern __shared__ uint32_t s[];  // (Z, bw) slab; Z = 2^H and bw = 2^lbw
  const int bw = 1 << lbw;
  const long long c0 = (long long)blockIdx.x * bw;
  const int n = bw << H;

  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i >> lbw, c = i & (bw - 1);
    s[i] = (c0 + c < C) ? x[(long long)r * C + c0 + c] : 0u;
  }
  __syncthreads();

  const int nb = n >> 1;  // butterflies per stage: (Z / 2) * bw
  for (int t = 0; t < H; ++t) {
    const int h = inverse ? H - 1 - t : t;
    const int lhalf = H - 1 - h;  // half = Z >> (h + 1) = 2^lhalf
    const uint32_t* twh = tw + ((long long)h << (H - 1));
    for (int i = threadIdx.x; i < nb; i += THREADS) {
      // butterfly b in group g = b / half, offset j = b % half: rows
      // u = g * 2 * half + j and u + half; consecutive threads take
      // consecutive columns, so shared-memory accesses do not conflict
      const int b = i >> lbw, c = i & (bw - 1);
      const int g = b >> lhalf, j = b & ((1 << lhalf) - 1);
      const int u = (((g << (lhalf + 1)) + j) << lbw) + c;
      const int v = u + (1 << (lhalf + lbw));
      const uint32_t w = __ldg(twh + b);
      const uint32_t xu = s[u], xv = s[v];
      if (inverse) {
        const uint32_t m = mulmod(xv, w);
        s[u] = addmod(xu, m);
        s[v] = submod(xu, m);
      } else {
        s[u] = addmod(xu, xv);
        s[v] = mulmod(submod(xu, xv), w);
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i >> lbw, c = i & (bw - 1);
    if (c0 + c < C) {
      const uint32_t y = scale == 1u ? s[i] : mulmod(s[i], scale);
      out[(long long)r * C + c0 + c] = y;
    }
  }
}

constexpr int REG_THREADS = 128;
constexpr int REG_MAX_H = 6;  // Z <= 64

struct Twiddles {  // (H, Z/2) row-major, passed by value: constant memory
  uint32_t w[REG_MAX_H << (REG_MAX_H - 1)];
};

template <int H, bool INV>
__global__ void __launch_bounds__(REG_THREADS)
ntt_regs(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
         long long C, uint32_t scale, const Twiddles tw) {
  constexpr int Z = 1 << H;
  const long long c = (long long)blockIdx.x * REG_THREADS + threadIdx.x;
  if (c >= C) return;
  uint32_t v[Z];
#pragma unroll
  for (int r = 0; r < Z; ++r) v[r] = __ldcs(x + r * C + c);  // read once
#pragma unroll
  for (int t = 0; t < H; ++t) {
    const int h = INV ? H - 1 - t : t;
    const int half = Z >> (h + 1);
#pragma unroll
    for (int b = 0; b < Z / 2; ++b) {
      // butterfly b in group b / half, offset j = b % half: rows u, u + half;
      // its twiddle root^(j 2^h) is 1 at j = 0
      const int j = b % half;
      const int u = (b / half) * 2 * half + j;
      const uint32_t w = tw.w[h * (Z / 2) + b];
      if (INV) {
        const uint32_t m = j == 0 ? v[u + half] : mulmod(v[u + half], w);
        v[u + half] = submod(v[u], m);
        v[u] = addmod(v[u], m);
      } else {
        const uint32_t d = submod(v[u], v[u + half]);
        v[u] = addmod(v[u], v[u + half]);
        v[u + half] = j == 0 ? d : mulmod(d, w);
      }
    }
  }
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

// out = NTT(x) along axis 0 on `stream` (see above) for Z = 2^H rows, in
// slabs of bw = 2^lbw columns; shared memory is Z * bw * 4 bytes.  Returns
// cudaGetLastError() of the launch.
extern "C" int ntt_launch(const void* x, void* out, const void* tw, int H,
                          long long C, int lbw, unsigned int scale, int inverse,
                          void* stream) {
  const int bw = 1 << lbw;
  const size_t smem = ((size_t)bw << H) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_slab, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (C > 0) {
    const unsigned blocks = (unsigned)((C + bw - 1) / bw);
    ntt_slab<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, H, C, lbw,
        scale, inverse);
  }
  return (int)cudaGetLastError();
}

// out = NTT(x) along axis 0 on `stream` for Z = 2^H <= 64 rows, one column a
// thread in registers; tw_host is the (H, Z/2) twiddle table in host memory
// (copied into the launch's parameters).  Returns cudaGetLastError().
extern "C" int ntt_regs_launch(const void* x, void* out, const void* tw_host,
                               int H, long long C, unsigned int scale,
                               int inverse, void* stream) {
  if (H < 0 || H > REG_MAX_H) return (int)cudaErrorInvalidValue;
  Twiddles tw = {};
  const uint32_t* src = (const uint32_t*)tw_host;
  for (int i = 0; i < (H << H) / 2; ++i) tw.w[i] = src[i];
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
