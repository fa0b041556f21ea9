"""Finite-field arithmetic for decentralized encoding.

Two execution paths share one `Field` definition:

* a **numpy int64** path used by the planners and all correctness oracles
  (exact, host-side), and
* a **torch int64** path (`fermat_*`) for the Fermat prime
  q = 2^16 + 1 = 65537 on any device: every product of two field elements
  is at most 2^32, so one int64 multiply and one `%` are exact.  Device
  payloads are stored as int32 (every value < q < 2^31); these functions
  widen to int64 before any arithmetic.

Why 65537 is the default field:
  * q - 1 = 2^16, so radix-2^k DFTs exist for every K = 2^h <= 65536 — exactly
    what the paper's specific (DFT / draw-and-loose) algorithms need.
  * data symbols are 16-bit chunks (any uint16 value < q), so real state bytes
    (checkpoints, gradients) embed losslessly with zero inflation.
  * modular reduction is two shifts and a subtract: 2^16 == -1 (mod q), so for
    x < 2^32:  x mod q == (x & 0xffff) - (x >> 16)  (+q if negative).
  * the only uint32-overflow corner in a*b is a == b == 65536 (== -1), i.e.
    (-1)*(-1) == 1 = 2^32 mod q; the CUDA kernels form the 64-bit product,
    so no special case is needed.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

FERMAT_Q = 65537  # 2^16 + 1, Fermat prime F4


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    # deterministic Miller-Rabin for n < 3.3e24
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if a % n == 0:
            continue
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def factorize(n: int) -> dict[int, int]:
    out: dict[int, int] = {}
    d = 2
    while d * d <= n:
        while n % d == 0:
            out[d] = out.get(d, 0) + 1
            n //= d
        d += 1
    if n > 1:
        out[n] = out.get(n, 0) + 1
    return out


@functools.lru_cache(maxsize=None)
def find_generator(q: int) -> int:
    """Smallest generator of the multiplicative group of F_q."""
    phi = q - 1
    primes = list(factorize(phi))
    for g in range(2, q):
        if all(pow(g, phi // p, q) != 1 for p in primes):
            return g
    raise ValueError(f"no generator found for q={q}")


@dataclass(frozen=True)
class Field:
    """Prime field F_q with vectorized numpy int64 arithmetic.

    Requires q < 2^31 so that single products fit int64 with headroom for
    K-term accumulations in `matmul` (K * q^2 < 2^63  =>  K < 2^63 / q^2).
    """

    q: int

    def __post_init__(self):
        if not is_prime(self.q):
            raise ValueError(f"q={self.q} is not prime")
        if self.q >= 1 << 31:
            raise ValueError("q must be < 2^31")

    # -- scalars / numpy arrays (exact oracle path) -------------------------
    @property
    def generator(self) -> int:
        return find_generator(self.q)

    def arr(self, x) -> np.ndarray:
        return np.asarray(x, dtype=np.int64) % self.q

    def add(self, a, b):
        return (np.asarray(a, np.int64) + np.asarray(b, np.int64)) % self.q

    def sub(self, a, b):
        return (np.asarray(a, np.int64) - np.asarray(b, np.int64)) % self.q

    def neg(self, a):
        return (-np.asarray(a, np.int64)) % self.q

    def mul(self, a, b):
        return (np.asarray(a, np.int64) * np.asarray(b, np.int64)) % self.q

    def pow(self, a, e: int):
        """Element-wise a**e mod q (e may be negative)."""
        e = int(e) % (self.q - 1) if e != 0 else 0
        a = np.asarray(a, np.int64) % self.q
        result = np.ones_like(a)
        base = a
        while e:
            if e & 1:
                result = (result * base) % self.q
            base = (base * base) % self.q
            e >>= 1
        return result

    def inv(self, a):
        a = np.asarray(a, np.int64) % self.q
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0")
        return self.pow(a, self.q - 2)

    def matmul(self, a, b):
        """(a @ b) mod q, exact. Accumulation bound: K*q^2 < 2^63."""
        a = np.asarray(a, np.int64) % self.q
        b = np.asarray(b, np.int64) % self.q
        k = a.shape[-1]
        if k * (self.q - 1) ** 2 >= 1 << 63:
            # chunked accumulation to stay exact
            step = max(1, ((1 << 62) // (self.q - 1) ** 2))
            acc = np.zeros(np.broadcast_shapes(a.shape[:-1] + (b.shape[-1],)), np.int64)
            for i in range(0, k, step):
                acc = (acc + a[..., i : i + step] @ b[i : i + step]) % self.q
            return acc
        return (a @ b) % self.q

    def dot(self, a, b):
        return self.matmul(np.atleast_2d(a), b)

    def rand(self, shape, rng: np.random.Generator):
        return rng.integers(0, self.q, size=shape, dtype=np.int64)

    # -- polynomial helpers --------------------------------------------------
    def poly_eval(self, coeffs, x):
        """Horner evaluation of sum_i coeffs[i] * x^i (coeffs along axis 0)."""
        coeffs = self.arr(coeffs)
        x = self.arr(x)
        out = np.zeros(np.broadcast_shapes(coeffs.shape[1:] if coeffs.ndim > 1 else (), x.shape), np.int64)
        for c in coeffs[::-1]:
            out = (out * x + c) % self.q
        return out

    def root_of_unity(self, order: int) -> int:
        """A primitive `order`-th root of unity; requires order | q-1."""
        if (self.q - 1) % order != 0:
            raise ValueError(f"order {order} does not divide q-1={self.q - 1}")
        return int(pow(self.generator, (self.q - 1) // order, self.q))


FERMAT = Field(FERMAT_Q)


# ---------------------------------------------------------------------------
# torch int64 path for q = 65537 (any device).  Inputs are integer tensors
# with values in [0, q) (any int64 for `fermat_reduce`); outputs are int64.
# ---------------------------------------------------------------------------

def fermat_reduce(x):
    """x mod 65537 for an integer tensor x (int64 result)."""
    return x.long() % FERMAT_Q


def fermat_mul(a, b):
    """a*b mod 65537 for a, b in [0, q): the product is <= 2^32, exact in int64."""
    return (a.long() * b.long()) % FERMAT_Q


def fermat_add(a, b):
    return (a.long() + b.long()) % FERMAT_Q


def fermat_sub(a, b):
    return (a.long() - b.long()) % FERMAT_Q


def fermat_matvec_cols(x, cmat):
    """y[..., j] = sum_k x[..., k] * cmat[k, j] mod q.

    x: (..., K); cmat: (K, J).  Products are <= 2^32, so an int64 sum is
    exact for K < 2^31.
    """
    assert cmat.shape[0] < 1 << 31, "accumulation overflow guard"
    prods = x.long()[..., :, None] * cmat.long()
    return prods.sum(dim=-2) % FERMAT_Q


# ---------------------------------------------------------------------------
# byte <-> symbol packing (for coded checkpoints / gradient coding)
# ---------------------------------------------------------------------------

def bytes_to_symbols(raw: np.ndarray) -> np.ndarray:
    """uint8[n] -> int64 symbols in [0, 65536): 16-bit little-endian chunks.

    Pads with zero byte if n is odd. Every symbol < 2^16 < q: lossless.
    """
    raw = np.asarray(raw, np.uint8).ravel()
    if raw.size % 2:
        raw = np.concatenate([raw, np.zeros(1, np.uint8)])
    return raw.view("<u2").astype(np.int64)


def symbols_to_bytes(sym: np.ndarray, nbytes: int) -> np.ndarray:
    sym = np.asarray(sym)
    if np.any((sym < 0) | (sym >= 1 << 16)):
        raise ValueError("symbol out of uint16 range — not a data payload")
    return sym.astype("<u2").view(np.uint8)[:nbytes]
