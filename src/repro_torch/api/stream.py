"""Streaming execution under `EncodePlan.run` / `DecodePlan.run`.

The cost model charges every all-to-all encode per symbol of payload width
W, so the throughput regime is *streaming*: large payloads arrive (or are
produced) in pieces, and the executor should amortize planning, kernel
set-up and host<->device transfers across them instead of re-paying them
per whole-W call.  This module is the engine behind
`plan.run_stream(chunks)` and `plan.run_batched(xs)` on both planners:

* the W (payload) axis is split into chunks of `plan_chunk_w(plan)`
  columns: the JAX package's rule (`default_chunk_w`, a 4 MiB (K, w)
  int32 tile in 128-column groups) on a network-measuring backend, so the
  simulator's per-chunk C1/C2 equal the JAX package's; a byte budget
  measured on the card (`DEVICE_BUDGET_BYTES`) for device-pipelined plans;
* on a CUDA plan the pipeline overlaps transfers with kernels: chunk k+1
  is reduced mod q into a pinned int32 host buffer and copied to the card
  (`non_blocking`) on a dedicated copy stream; the compute stream (the
  caller's current stream) waits on that copy's event, launches chunk k's
  kernels while chunk k+1's copy is in flight, and enqueues chunk k's
  device->host copy into a pinned output buffer; only then does the host
  wait, on chunk k's event alone, and widen the result to a fresh int64
  array (the pinned buffers are a ring of two, reused);
* on `device="cpu"` the same loop runs without pinned memory or streams
  (CPU-only torch refuses `pin_memory=True`); a CUDA plan never takes it;
* the simulator backend keeps lockstep semantics per chunk and records
  EXACT per-chunk C1/C2 on `plan.stream_stats` (a fresh `RoundNetwork`
  per chunk — C1 is per-chunk rounds, C2 scales with the chunk width).

The JAX package donates the chunk buffer to its jitted callable
(`maybe_donate_jit`); the port has no counterpart: the pipeline owns its
device buffers and the caching allocator recycles them (a buffer made on
the copy stream is `record_stream`-ed onto the compute stream that reads
it).

Bitwise contract (tested across all backends and both planners):

    np.concatenate(list(plan.run_stream(chunks)), axis=1)
        == plan.run(np.concatenate(chunks, axis=1))
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field as dc_field
from typing import Callable, Iterable, Iterator

import numpy as np

from ..obs.metrics import REGISTRY as _METRICS
from ..obs.trace import host_span

DEFAULT_VMEM_BUDGET_BYTES = 4 << 20  # the JAX package's (K, w) tile budget
_LANES = 128                         # columns per group (JAX: TPU lanes)
# (K, w) int32 chunk budget of the device pipeline, from the chunk-width
# sweep of `chip_smoke.py` on an NVIDIA H100 80GB HBM3 (700 W): rs
# K=256 R=64 encode_stream/decode_stream at W=2^18, w from 2^12 to 2^18
DEVICE_BUDGET_BYTES = 64 << 20

_CHUNKS = _METRICS.counter("stream_chunks_total",
                           "chunks executed through run_stream")
_CHUNK_ELEMS = _METRICS.counter(
    "stream_elems_total", "payload field elements streamed (K * w summed)")


def default_chunk_w(K: int, *, itemsize: int = 4,
                    budget_bytes: int = DEFAULT_VMEM_BUDGET_BYTES) -> int:
    """Largest multiple of 128 columns such that a (K, w) tile fits the
    budget (at least one full 128-column group)."""
    return max(_LANES, budget_bytes // (K * itemsize) // _LANES * _LANES)


def plan_chunk_w(plan) -> int:
    """The chunk width `plan`'s streams use when the caller gives none:
    the device budget for a device-pipelined backend, the JAX package's
    rule (and value) otherwise."""
    from .registry import get_backend

    if get_backend(plan.backend).supports_stream:
        return default_chunk_w(plan.spec.K, budget_bytes=DEVICE_BUDGET_BYTES)
    return default_chunk_w(plan.spec.K)


@dataclass
class StreamStats:
    """Per-chunk accounting of one `run_stream` pass (simulator backend
    additionally fills the exact C1/C2 of each chunk's lockstep run)."""

    widths: list[int] = dc_field(default_factory=list)
    C1: list[int] = dc_field(default_factory=list)
    C2: list[int] = dc_field(default_factory=list)

    @property
    def chunks(self) -> int:
        return len(self.widths)

    @property
    def W(self) -> int:
        return sum(self.widths)

    def totals(self) -> tuple[int, int]:
        """(sum C1, sum C2) across chunks — the cost of the streamed run
        as the round network actually measured it."""
        return sum(self.C1), sum(self.C2)


def iter_chunks(payload, K: int, chunk_w: int | None) -> Iterator[np.ndarray]:
    """Normalize a payload into (K, w) chunks.

    A single (K, W) array is split into `chunk_w`-wide pieces; an iterable
    of arrays is streamed as given, each piece re-split only if it exceeds
    `chunk_w`.  Chunks must all carry the plan's K rows.  Zero-width
    pieces yield nothing (a stream of no data has no chunks).
    """
    if isinstance(payload, np.ndarray) or hasattr(payload, "shape"):
        pieces: Iterable = (payload,)
    else:
        pieces = payload
    cw = chunk_w or default_chunk_w(K)
    for piece in pieces:
        piece = np.asarray(piece)
        if piece.ndim != 2 or piece.shape[0] != K:
            raise ValueError(
                f"stream chunks must be (K={K}, w) arrays, got {piece.shape}")
        for c0 in range(0, piece.shape[1], cw):
            yield piece[:, c0 : c0 + cw]


def split_chunks(payload, chunk_w: int) -> Iterator[np.ndarray]:
    """Split a (rows, W) array or an iterable of (rows, w_i) pieces into
    chunks of width <= `chunk_w`, preserving whatever leading dim the
    pieces carry (the caller validates it — unlike `iter_chunks` this is
    row-count-agnostic, for streams that carry full codeword rows).
    Zero-width pieces yield nothing."""
    pieces: Iterable = ((payload,) if hasattr(payload, "shape") else payload)
    for piece in pieces:
        piece = np.asarray(piece)
        if piece.ndim != 2:
            raise ValueError(
                f"stream chunks must be 2-D (rows, w) arrays, got "
                f"{piece.shape}")
        for c0 in range(0, piece.shape[1], chunk_w):
            yield piece[:, c0 : c0 + chunk_w]


def run_paired_stream(plan, chunks: Iterator[np.ndarray], slice_fn: Callable,
                      *, chunk_w: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Drive `plan.run_stream` over `slice_fn(chunk)` while pairing every
    output block 1:1 with the chunk it came from — the passthrough side of
    a rebuild rides along with the repaired rows, still through the
    device pipeline.

    `chunks` must already be split to width <= `chunk_w` (use
    `split_chunks` with the same value) so `run_stream` never re-splits a
    piece and the pairing stays aligned; the pipeline's one-chunk
    read-ahead means at most two chunks are held at once.
    """
    from collections import deque

    pending: deque = deque()

    def _feed():
        for c in chunks:
            pending.append(c)
            yield slice_fn(c)

    for y in plan.run_stream(_feed(), chunk_w=chunk_w):
        yield pending.popleft(), y


# ---------------------------------------------------------------------------
# the device pipeline
# ---------------------------------------------------------------------------

class PipelineTimeline:
    """CUDA-event timeline of the device pipelines run on this thread inside
    `record_timeline()`: per chunk, when its host->device copy, its kernels
    and its device->host copy ran on the card."""

    STAGES = ("h2d", "kernels", "d2h")

    def __init__(self) -> None:
        self.runs: list[list[dict]] = []   # per pipeline, per chunk

    def chunk_spans_ms(self) -> list[list[dict]]:
        """Per pipeline and chunk: {stage: (start, end)} for each stage in
        `STAGES`, in ms from the pipeline's first event (synchronises).
        A stage's span runs from the event before its first operation to
        the one after its last, on the stream that ran it."""
        import torch

        torch.cuda.synchronize()
        out = []
        for run in self.runs:
            ref = run[0]["ref"]
            out.append([{key: (ref.elapsed_time(ev[key][0]),
                               ref.elapsed_time(ev[key][1]))
                         for key in self.STAGES if key in ev}
                        for ev in run])
        return out

    def busy_ms(self) -> float:
        """Time in which the card ran some stage of a recorded pipeline:
        the union of all the stages' spans."""
        total = 0.0
        for run in self.chunk_spans_ms():
            end = float("-inf")
            for s, e in sorted(span for ch in run for span in ch.values()):
                total += max(0.0, e - max(s, end))
                end = max(end, e)
        return total

    def overlap_ms(self) -> float:
        """Total time for which chunk k+1's host->device copy ran while
        chunk k's kernels ran, over every recorded pipeline."""
        total = 0.0
        for run in self.chunk_spans_ms():
            for cur, nxt in zip(run, run[1:]):
                ks, ke = cur["kernels"]
                hs, he = nxt["h2d"]
                total += max(0.0, min(ke, he) - max(ks, hs))
        return total


_TLS = threading.local()


@contextlib.contextmanager
def record_timeline():
    """Record CUDA timing events in every device pipeline this thread runs
    inside the block; yields the `PipelineTimeline`.  Off (no timing
    events) outside it."""
    tl = PipelineTimeline()
    prev = getattr(_TLS, "timeline", None)
    _TLS.timeline = tl
    try:
        yield tl
    finally:
        _TLS.timeline = prev


class _HostStage:
    """The pipeline's stages on `device="cpu"`: the plain loop."""

    def __init__(self, fn: Callable, q: int):
        self.fn, self.q = fn, q

    def to_device(self, c: np.ndarray):
        import torch

        return torch.from_numpy(np.ascontiguousarray(c % self.q,
                                                     dtype=np.int32))

    def dispatch(self, x):
        return self.fn(x)

    def finalize(self, y) -> np.ndarray:
        return y.numpy().astype(np.int64)


class _CudaStage:
    """The pipeline's stages on a CUDA device: pinned rings of two, a copy
    stream, and events (see the module docstring)."""

    def __init__(self, fn: Callable, device, q: int):
        import torch

        self.fn, self.device, self.q = fn, device, q
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        self.pin_in: list = [None, None]
        self.pin_out: list = [None, None]
        self.copied: list = [None, None]   # event: pin_in[slot] was read
        self.n_in = self.n_out = 0
        tl = getattr(_TLS, "timeline", None)
        self.chunks: list[dict] | None = None
        if tl is not None:
            self.chunks = []
            tl.runs.append(self.chunks)

    def _event(self, stream):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    @staticmethod
    def _pinned(ring: list, slot: int, shape):
        import torch

        n = int(np.prod(shape))
        if ring[slot] is None or ring[slot].numel() < n:
            ring[slot] = torch.empty(max(n, 1), dtype=torch.int32,
                                     pin_memory=True)
        return ring[slot][:n].view(shape)

    def to_device(self, c: np.ndarray):
        import torch

        slot = self.n_in % 2
        self.n_in += 1
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()  # its last copy has read it
        host = self._pinned(self.pin_in, slot, c.shape)
        np.remainder(c, self.q, out=host.numpy(), casting="unsafe")
        rec = None
        if self.chunks is not None:   # recording: the first chunk holds
            rec = {} if self.chunks else {"ref": self._event(self.compute)}
            self.chunks.append(rec)   # the run's reference event
        with torch.cuda.stream(self.copy):
            # allocated on the copy stream: no pending compute work can
            # still be reading this memory when the copy writes it
            dev = torch.empty(c.shape, dtype=torch.int32, device=self.device)
            t0 = self._event(self.copy) if rec is not None else None
            dev.copy_(host, non_blocking=True)
            if rec is not None:
                rec["h2d"] = (t0, self._event(self.copy))
            ready = torch.cuda.Event()
            ready.record(self.copy)
        self.copied[slot] = ready
        return dev, ready, rec

    def dispatch(self, cur):
        import torch

        dev, ready, rec = cur
        with torch.cuda.device(self.device), torch.cuda.stream(self.compute):
            self.compute.wait_event(ready)
            dev.record_stream(self.compute)
            t0 = self._event(self.compute) if rec is not None else None
            y = self.fn(dev)
            if rec is not None:
                rec["kernels"] = (t0, self._event(self.compute))
            slot = self.n_out % 2
            self.n_out += 1
            out = self._pinned(self.pin_out, slot, tuple(y.shape))
            t1 = self._event(self.compute) if rec is not None else None
            out.copy_(y, non_blocking=True)
            if rec is not None:
                rec["d2h"] = (t1, self._event(self.compute))
            done = torch.cuda.Event()
            done.record(self.compute)
        return out, done

    def finalize(self, pending) -> np.ndarray:
        out, done = pending
        done.synchronize()          # chunk k's copy only, not the device
        return out.numpy().astype(np.int64)


def device_stage(fn: Callable, device, q: int):
    """The pipeline stages of a plan on `device` running `fn` ((K, w) int32
    device tensor -> (rows, w) int32 device tensor)."""
    if device.type == "cuda":
        return _CudaStage(fn, device, q)
    if device.type == "cpu":
        return _HostStage(fn, q)
    raise ValueError(f"the stream pipeline runs on cuda or cpu, not {device}")


def _block_rows(chunks: Iterator[np.ndarray], rows: slice | None):
    """Each chunk's rows this rank copies to its device (a mesh plan on G
    ranks takes its block of processors); all rows for `rows=None`."""
    for c in chunks:
        yield c if rows is None else c[rows]


def _pipelined(chunks: Iterator[np.ndarray], stage) -> Iterator[np.ndarray]:
    """Double-buffered device pipeline.

    For each chunk k+1: enqueue its host->device transfer, then dispatch
    chunk k (already resident) so its kernels run beside that transfer,
    then materialize chunk k.  One chunk of read-ahead: when chunk k's
    output is yielded, chunks k and k+1 have been drawn from `chunks`.

    With a tracer installed, the three pipeline stages of every chunk
    become spans on a "stream"/"pipeline" track (h2d / dispatch /
    materialize; profiler ranges `stream.<stage>`); they time the host side
    of each stage and never synchronise the device.
    """
    def _span(name, k):
        return host_span(name, "stream", tid="pipeline", cat="stream",
                         chunk=k)

    cur = None
    k = 0          # index of the chunk resident on device
    for c in chunks:
        with _span("h2d", k + (cur is not None)):
            nxt = stage.to_device(c)
        if cur is not None:
            with _span("dispatch", k):
                y = stage.dispatch(cur)
            with _span("materialize", k):
                out = stage.finalize(y)
            yield out
            k += 1
        cur = nxt
    if cur is not None:
        with _span("dispatch", k):
            y = stage.dispatch(cur)
        with _span("materialize", k):
            out = stage.finalize(y)
        yield out


def run_stream(plan, payload, *, chunk_w: int | None = None
               ) -> Iterator[np.ndarray]:
    """Generator of per-chunk outputs for `plan` (encode or decode).

    Dispatch follows the plan's registered backend capabilities: a
    network-measuring backend (simulator) runs lockstep per chunk and
    records exact per-chunk C1/C2 on `plan.stream_stats`; a
    `supports_stream` backend (local, mesh) runs the device pipeline over
    the plan's `_stream_device_fn()` on `plan.device` (a mesh rank copies
    only its block of each chunk, `plan._stream_rows()`); any other registered
    backend streams by plain per-chunk `encode`/`decode` calls — no
    pipelining, but the bitwise contract still holds.
    """
    from .registry import get_backend

    K = plan.spec.K

    def _counted(cs):
        for c in cs:
            _CHUNKS.inc(1, op=plan.op, backend=plan.backend)
            _CHUNK_ELEMS.inc(K * c.shape[1], op=plan.op,
                             backend=plan.backend)
            yield c

    chunks = _counted(iter_chunks(payload, K, chunk_w or plan_chunk_w(plan)))
    backend = get_backend(plan.backend)
    if backend.measures_network:
        stats = StreamStats()
        plan.stream_stats = stats
        for c in chunks:
            y, net = plan._stream_sim_chunk(c)
            stats.widths.append(c.shape[1])
            stats.C1.append(net.C1)
            stats.C2.append(net.C2)
            plan._record_net(net, op=plan.op, width=c.shape[1])
            yield y
        return
    if backend.supports_stream:
        stage = device_stage(plan._stream_device_fn(), plan.device,
                             plan.field.q)
        yield from _pipelined(_block_rows(chunks, plan._stream_rows()),
                              stage)
        return
    run_chunk = backend.encode if plan.op == "encode" else backend.decode
    for c in chunks:
        yield run_chunk(plan, c)


def run_batched(plan, xs, *, chunk_w: int | None = None) -> list[np.ndarray]:
    """Coalesce a batch of payloads into one streamed execution.

    xs: list of (K,) or (K, W_i) arrays (W_i may differ per request).
    The payloads are concatenated on the W axis, run through `run_stream`
    (so concurrent requests share the transfer/compute pipeline), and the
    outputs are split back per request.
    """
    K = plan.spec.K
    norm: list[np.ndarray] = []
    squeeze: list[bool] = []
    for x in xs:
        x = np.asarray(x)
        if x.shape[0] != K:
            raise ValueError(f"payload leading dim must be K={K}, got {x.shape}")
        squeeze.append(x.ndim == 1)
        norm.append(x[:, None] if x.ndim == 1 else x)
    if not norm:
        return []
    widths = [x.shape[1] for x in norm]
    big = np.concatenate(norm, axis=1)
    if big.shape[1] == 0:
        y = plan.run(big)  # zero-width batch: keep run()'s (rows, 0) shape
    else:
        y = np.concatenate(list(run_stream(plan, big, chunk_w=chunk_w)),
                           axis=1)
    out: list[np.ndarray] = []
    col = 0
    for w, sq in zip(widths, squeeze):
        piece = y[:, col : col + w]
        out.append(piece[:, 0] if sq else piece)
        col += w
    return out
