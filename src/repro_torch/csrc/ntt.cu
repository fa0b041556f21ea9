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
// transform), which gives the same values as the separate multiply.
//
// Bound on this card: each element is read once and written once and takes
// log2 Z butterflies of a few integer operations, so at the main path's
// Z = 64 the transform is bound by memory bytes.  One block holds a (Z, bw)
// column slab in shared memory for all log2 Z stages, so device memory is
// touched only by the one coalesced load and the one store; bw shrinks as Z
// grows so that Z * bw * 4 bytes fits in a block's shared memory
// (Z = 64: bw = 128, 32 KiB; Z = 4096: bw = 8, 128 KiB).  Z above 4096 needs
// a four-step split (later work); the wrapper refuses it.
//
// Layouts: x and out (Z, C) row-major int32 holding values in [0, q), read as
// uint32; tw (H, Z/2) uint32.  The ragged last slab is masked here.

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
ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
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
        ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (C > 0) {
    const unsigned blocks = (unsigned)((C + bw - 1) / bw);
    ntt_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, H, C, lbw,
        scale, inverse);
  }
  return (int)cudaGetLastError();
}
