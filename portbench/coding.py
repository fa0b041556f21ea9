"""What the coding cells share: the code of a configuration, the program's
kernels, seeded data, and the sample of answers kept for the check.

The data are user bytes packed as 16-bit symbols, made on the device from
the seed in one call per stripe and handed to the program as the NumPy
int64 arrays its API takes.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import dataclass

import numpy as np
import torch

SYMBOL_VALUES = 1 << 16  # a data symbol is 16 bits of user data


def seed64(seed: int) -> int:
    return int(seed) % (1 << 63)


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent host stream of the run's seed."""
    return np.random.default_rng([seed64(seed), stream])


@dataclass(frozen=True)
class Code:
    """The code of a configuration file."""

    kind: str
    K: int
    R: int
    p: int
    W: int
    backend: str

    @classmethod
    def of(cls, config: dict) -> "Code":
        return cls(config["kind"], int(config["K"]), int(config["R"]),
                   int(config.get("p", 1)), int(config["shard_symbols"]),
                   config.get("backend", "local"))

    @property
    def N(self) -> int:
        return self.K + self.R

    def spec(self):
        """The program's `CodeSpec`."""
        from repro_torch.api import CodeSpec

        return CodeSpec(kind=self.kind, K=self.K, R=self.R, p=self.p)


def build_kernels(device: str) -> list[str]:
    """Build (first run in a checkout) or load the program's CUDA kernels;
    returns the sources compiled now."""
    if device != "cuda":
        return []
    from repro_torch.kernels import build

    compiled = list(build.build())
    for name in build.SOURCES:
        build.load(name)
    return compiled


# glibc's mallopt(3) parameters
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4


def host_heap(traffic: dict, device: str) -> None:
    """Set the process's host heap as the traffic file's `host_heap` says.

    "default" (or no key): glibc as it comes, which maps every block above
    32 MiB afresh and unmaps it when freed, so each op's GiB-sized host
    temporaries fault their pages in again.  "kept": a long-lived coding
    process's warm heap: no block is mapped apart and the heap is never
    trimmed, so after the warm-up the window's temporaries reuse pages
    already faulted in, and the kernel's page allocator, whose speed
    follows the host's state, leaves the window.  Only on the card: a CPU
    test run keeps its process as it is."""
    mode = traffic.get("host_heap", "default")
    if mode not in ("default", "kept"):
        raise ValueError(f"host_heap {mode!r}: 'default' or 'kept'")
    if mode == "default" or device != "cuda":
        return
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    if not (libc.mallopt(M_MMAP_MAX, 0) and libc.mallopt(M_TRIM_THRESHOLD, -1)):
        raise RuntimeError("mallopt refused the kept heap")


def warm_heap(traffic: dict, device: str, nbytes: int) -> None:
    """Under the kept heap, fault `nbytes` more of it in and free them, in
    set-up: room for the answers the window keeps for the check, so that
    keeping one faults nothing in the window."""
    if traffic.get("host_heap", "default") == "kept" and device == "cuda":
        block = np.empty(nbytes, np.uint8)
        block[::4096] = 0
        del block


class Data:
    """Seeded stripes: every call draws the next one from the card's
    generator."""

    def __init__(self, seed: int, device: str):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed64(seed))

    def stripe(self, rows: int, W: int) -> np.ndarray:
        x = torch.randint(0, SYMBOL_VALUES, (rows, W), generator=self.gen,
                          device=self.device, dtype=torch.int32)
        return x.cpu().numpy().astype(np.int64)


class Sampler:
    """Which answers are kept for the check: the first, then each with
    probability `share` drawn from the seed op by op, at most `cap`."""

    def __init__(self, seed: int, share: float, cap: int):
        self.rng = rng(seed, 7)
        self.share, self.cap, self.kept = float(share), int(cap), 0

    def take(self) -> bool:
        hit = self.rng.random() < self.share or self.kept == 0
        hit = hit and self.kept < self.cap
        self.kept += hit
        return bool(hit)
