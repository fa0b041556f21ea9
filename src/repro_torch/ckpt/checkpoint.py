"""Fault-tolerant checkpointing with Reed-Solomon coded parity.

Layout (one directory per step, atomic rename on completion):

    ckpt_dir/step_000123/
        meta.json            — tree structure, shapes, dtypes, N, R, q
        shard_000.npy ...    — N data shards (equal-size 16-bit symbol chunks
                               of the concatenated flat state)
        parity_000.npy ...   — R parity shards (systematic GRS over F_65537)

The files are the JAX package's (`repro/ckpt/checkpoint.py`), byte for
byte: the same leaves give the same shard and parity files and the same
`meta.json` (bar its free-form "treedef" string), so either package
restores the other's checkpoints.  A tree is a nest of dicts (sorted
keys), `OrderedDict`s such as `nn.Module.state_dict()` (insertion order),
lists and tuples, flattened in JAX's leaf order (`core.pytree`); its
leaves are torch tensors on any device (moved to the CPU) or numpy
arrays.  Dtypes are written under numpy's names; bf16 goes through
`view(torch.int16)` to the little-endian bytes JAX writes.

Parity comes from a `repro_torch.api.CodedSystem` session on the
checkpointer's `device` (None means "cuda"): `encode_stream` runs the NTT
kernels through the device pipeline (pinned buffers, a copy stream and
events), and the survivors of a degraded restore or a scrub are sliced off
the memmapped files chunk by chunk into the same pipeline, repaired by the
`gf_matmul` kernel.  Streams use the session's chunk width
(`api.stream.plan_chunk_w`: 2^20 columns at N = 16 on the card, where the
JAX package's 4 MiB rule gives 65,536); the bytes do not depend on it.
Non-Fermat fields run on the host-only simulator, as in JAX.

Restore tolerates up to R missing shards (any-N-of-(N+R) MDS property):
shard/parity files missing from disk are detected, `fail()`-ed on a
restore-scoped session, and decoded around automatically (degraded read).
Elastic resharding is supported: a checkpoint written with N shards
restores onto any N' (the flat symbol stream is re-split).

Integrity: `save` records a sha256 of every shard/parity payload in
meta.json, and `scrub()` verifies every file on disk against its checksum
and rebuilds missing/corrupt ones *in place* via the streamed rebuild
(`CodedSystem.rebuild_stream` off the survivor memmaps).

Tracing: with an `obs.trace` tracer installed, each stage is a span on
its "ckpt" track, one row per thread — save: tree_to_bytes,
shard_symbols, shard_files, parity (with a parity_write per chunk, beside
the stream's own h2d/dispatch/materialize spans); restore: degraded_read,
assemble, bytes_to_tree; scrub: verify, rebuild.

Async: `save(..., background=True)` hands the write (parity encode
included) to a daemon thread; `wait()` joins it — and raises what it
raised — and every later save, restore, scrub or reshard waits first.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..api import CodedSystem, CodeSpec
from ..api.stream import iter_chunks, plan_chunk_w
from ..core.field import FERMAT, bytes_to_symbols, symbols_to_bytes
from ..core.pytree import tree_flatten, tree_unflatten
from ..obs.trace import host_span

# ---------------------------------------------------------------------------
# tree <-> flat byte stream
# ---------------------------------------------------------------------------


def _leaf_array(leaf) -> tuple[dict, np.ndarray]:
    """(meta, host array of the leaf's bytes): bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ({"shape": list(t.shape), "dtype": "bfloat16"},
                    t.view(torch.int16).numpy().view(np.uint16))
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return ({"shape": list(arr.shape), "dtype": "bfloat16"},
                    arr.view(np.uint16))
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}, arr


def tree_to_bytes(tree: Any) -> tuple[np.ndarray, dict]:
    """The tree's leaves as one uint8 stream (each leaf's C-order native
    bytes, in leaf order) and its meta: leaf shapes/dtypes, the treedef
    string and the byte count."""
    leaves, treedef = tree_flatten(tree)
    metas, arrs = [], []
    for leaf in leaves:
        m, arr = _leaf_array(leaf)
        metas.append(m)
        arrs.append(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    raw = np.empty(sum(a.size for a in arrs), np.uint8)
    off = 0
    for a in arrs:
        raw[off:off + a.size] = a
        off += a.size
    meta = {"leaves": metas, "treedef": str(treedef), "nbytes": int(raw.size)}
    return raw, meta


def bytes_to_tree(raw: np.ndarray, meta: dict, treedef_example: Any) -> Any:
    """Rebuild the tree of `treedef_example`'s structure from `raw`.  Each
    leaf takes the type of the example's leaf: a CPU tensor for a tensor, a
    numpy array otherwise (bf16 stays a tensor unless the example holds a
    numpy bf16 array)."""
    leaves_ex, treedef = tree_flatten(treedef_example)
    if len(leaves_ex) != len(meta["leaves"]):
        raise ValueError(f"example has {len(leaves_ex)} leaves, the "
                         f"checkpoint {len(meta['leaves'])}")
    out = []
    off = 0
    for m, ex in zip(meta["leaves"], leaves_ex):
        bf16 = m["dtype"] == "bfloat16"
        dt = np.dtype(np.uint16 if bf16 else m["dtype"])
        nb = int(np.prod(m["shape"])) * dt.itemsize
        arr = raw[off:off + nb].view(dt).reshape(m["shape"]).copy()
        off += nb
        if bf16 and isinstance(ex, np.ndarray) and ex.dtype.name == "bfloat16":
            out.append(arr.view(ex.dtype))
        elif bf16:
            out.append(torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16))
        elif isinstance(ex, torch.Tensor):
            out.append(torch.from_numpy(arr))
        else:
            out.append(arr)
    if off != meta["nbytes"]:
        raise ValueError(f"leaves hold {off} bytes, meta says {meta['nbytes']}")
    return tree_unflatten(treedef, out)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


def _span(name: str):
    """A span on the installed tracer's "ckpt" track, one row per thread
    (a background save's worker has its own); free without a tracer."""
    return host_span(name, "ckpt", tid=threading.current_thread().name,
                     cat="ckpt")


# ---------------------------------------------------------------------------
# coded checkpoint manager
# ---------------------------------------------------------------------------

@dataclass
class CodedCheckpointer:
    """N data shards + R parity shards per step under `directory`.

    chunk_w : streaming chunk width (payload columns) of the coded save,
              restore and scrub paths; None = `api.stream.plan_chunk_w`
    device  : torch device of every coding session (None means "cuda",
              and a missing card raises RuntimeError; "cpu" runs the
              kernels' plain versions); moot for non-Fermat fields
    """

    directory: str
    n_shards: int = 16
    n_parity: int = 4
    field: Any = None
    chunk_w: int | None = None
    device: Any = None
    _thread: threading.Thread | None = dc_field(default=None, init=False,
                                                repr=False)
    _error: BaseException | None = dc_field(default=None, init=False,
                                            repr=False)

    def __post_init__(self):
        self.field = self.field or FERMAT
        assert self.n_shards % self.n_parity == 0, "R | N (Remark 4)"
        # one CodedSystem session owns both coding directions; the shared
        # plan caches mean repeated checkpointer instances (reshard,
        # restarts) never rebuild the code tables.  The kernels are
        # Fermat-only; other fields encode parity by the exact host
        # matmul (same generator block either way).
        spec = CodeSpec(kind="rs", K=self.n_shards, R=self.n_parity,
                        q=self.field.q)
        self._fermat = self.field.q == FERMAT.q
        self._system = self._session(spec)
        self.sgrs = self._system.encode_plan.sgrs
        self._A = self._system.encode_plan.A
        Path(self.directory).mkdir(parents=True, exist_ok=True)

    def _session(self, spec: CodeSpec) -> CodedSystem:
        return CodedSystem(
            spec, backend="local" if spec.q == FERMAT.q else "simulator",
            chunk_w=self.chunk_w, device=self.device)

    # -- encode -------------------------------------------------------------
    def shard_symbols(self, raw: np.ndarray) -> np.ndarray:
        """(N, L) int64 symbols: 16-bit chunks, zero-padded to N*L."""
        sym = bytes_to_symbols(raw)
        L = -(-sym.size // self.n_shards)
        pad = np.zeros(self.n_shards * L - sym.size, np.int64)
        return np.concatenate([sym, pad]).reshape(self.n_shards, L)

    def encode_parity(self, shards: np.ndarray) -> np.ndarray:
        """(R, L) parity — `CodedSystem.encode` on the kernel path;
        non-Fermat fields keep the exact host matmul."""
        if not self._fermat:
            return self.field.matmul(self._A.T, shards)
        return self._system.encode(shards)

    def _parity_stream(self, shards: np.ndarray):
        """Generator of (R, w) parity blocks — `CodedSystem.encode_stream`
        on the kernel path (the device pipeline), exact chunked host matmul
        otherwise."""
        if self._fermat:
            yield from self._system.encode_stream(shards)
            return
        cw = self.chunk_w or plan_chunk_w(self._system.encode_plan)
        for c in iter_chunks(shards, self.n_shards, cw):
            yield self.field.matmul(self._A.T, c)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, background: bool = False) -> str:
        with _span("tree_to_bytes"):
            raw, meta = tree_to_bytes(state)  # the state is read here, now
        with _span("shard_symbols"):
            shards = self.shard_symbols(raw)

        def _write():
            final = Path(self.directory) / f"step_{step:06d}"
            tmp = Path(self.directory) / f".tmp_step_{step:06d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            # per-file sha256 of the symbol payload (the uint32 array
            # bytes, not the .npy container) — scrub() verifies against
            # these to localize silent corruption to a file
            sums: dict[str, str] = {}
            with _span("shard_files"):
                for k in range(self.n_shards):
                    arr = shards[k].astype(np.uint32)
                    np.save(tmp / f"shard_{k:03d}.npy", arr)
                    sums[f"shard_{k:03d}"] = _sha256(arr)
            # parity is STREAMED into preallocated .npy memmaps: the full
            # (R, L) parity matrix is never materialized; the checksums
            # accumulate over exactly the bytes written
            L = shards.shape[1]
            if L == 0:  # empty state: mmap cannot map zero bytes
                for r in range(self.n_parity):
                    np.save(tmp / f"parity_{r:03d}.npy",
                            np.zeros(0, np.uint32))
                    sums[f"parity_{r:03d}"] = hashlib.sha256(b"").hexdigest()
            else:
                mms = [np.lib.format.open_memmap(
                           tmp / f"parity_{r:03d}.npy", mode="w+",
                           dtype=np.uint32, shape=(L,))
                       for r in range(self.n_parity)]
                hs = [hashlib.sha256() for _ in range(self.n_parity)]
                col = 0
                with _span("parity"):
                    for blk in self._parity_stream(shards):
                        w = blk.shape[1]
                        with _span("parity_write"):
                            for r in range(self.n_parity):
                                row = blk[r].astype(np.uint32)
                                mms[r][col : col + w] = row
                                hs[r].update(row.tobytes())
                        col += w
                    assert col == L
                    for mm in mms:
                        mm.flush()
                    del mms
                for r in range(self.n_parity):
                    sums[f"parity_{r:03d}"] = hs[r].hexdigest()
            meta2 = dict(meta, N=self.n_shards, R=self.n_parity,
                         q=self.field.q, step=step, sha256=sums)
            (tmp / "meta.json").write_text(json.dumps(meta2))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)

        def _background():
            try:
                _write()
            except BaseException as exc:  # noqa: BLE001 — re-raised by wait()
                self._error = exc

        self.wait()  # single-writer: join any in-flight background save
        if background:
            self._thread = threading.Thread(target=_background, daemon=True)
            self._thread.start()
        else:
            _write()
        return str(Path(self.directory) / f"step_{step:06d}")

    def wait(self):
        """Join the in-flight background save, if any; raise what it
        raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in Path(self.directory).glob("step_*"))
        return steps[-1] if steps else None

    def restore(self, step: int, example_state: Any,
                failed_shards: set[int] = frozenset()) -> Any:
        """Restore, reconstructing up to R erased shards via the decode
        subsystem.

        Degraded reads are automatic: shard/parity files missing from disk
        count as erasures, in addition to the explicitly `failed_shards`
        (simulated node failures, indices into [0, N)).  The restore
        succeeds as long as data + parity erasures total at most R."""
        self.wait()
        d = Path(self.directory) / f"step_{step:06d}"
        meta = json.loads((d / "meta.json").read_text())
        N, R = meta["N"], meta["R"]
        erased = {int(k) for k in failed_shards}
        for k in range(N):
            if k not in erased and not (d / f"shard_{k:03d}.npy").exists():
                erased.add(k)
        for r in range(R):
            if not (d / f"parity_{r:03d}.npy").exists():
                erased.add(N + r)

        loaded: dict[int, np.ndarray] = {}

        def _load(idx: int) -> np.ndarray:
            # memory-mapped: survivor files are read chunk-by-chunk by the
            # streamed repair and row-by-row by the final assembly, never
            # duplicated wholesale on the heap
            if idx not in loaded:
                name = (f"shard_{idx:03d}.npy" if idx < N
                        else f"parity_{idx - N:03d}.npy")
                loaded[idx] = np.load(d / name, mmap_mode="r")
            return loaded[idx]

        if any(e < N for e in erased):
            assert len(erased) <= R, "more failures than parity can cover"
            spec = CodeSpec(kind="rs", K=N, R=R,
                            q=int(meta.get("q", self.field.q)))
            # a restore-scoped session for the file's (N, R) layout (may
            # differ from self under elastic reshard): fail the missing
            # positions, then stream the degraded read.  Only the |E| lost
            # columns are repaired (K x |E| work); repaired rows of
            # missing *parity* files ride along unused.
            rsys = self._session(spec)
            try:
                rsys.fail(sorted(erased))
                plan = rsys.decode_plan
                L = int(_load(plan.kept[0]).shape[0])
                rep = {e: np.empty(L, np.int64) for e in plan.erased}
                cw = self.chunk_w or plan_chunk_w(plan)

                def survivor_chunks():
                    for c0 in range(0, L, cw):
                        yield np.stack([np.asarray(_load(i)[c0 : c0 + cw],
                                                   np.int64)
                                        for i in plan.kept])

                col = 0
                with _span("degraded_read"):
                    for blk in rsys.decode_stream(survivor_chunks(),
                                                  chunk_w=cw):
                        for j, e in enumerate(plan.erased):
                            rep[e][col : col + blk.shape[1]] = blk[j]
                        col += blk.shape[1]
                assert col == L
            finally:
                rsys.close()
        else:
            rep = {}
        with _span("assemble"):
            shards = np.stack([rep[k] if k in rep
                               else np.asarray(_load(k), np.int64)
                               for k in range(N)])
        with _span("bytes_to_tree"):
            sym = shards.reshape(-1)[: -(-meta["nbytes"] // 2)]
            raw = symbols_to_bytes(sym, meta["nbytes"])
            return bytes_to_tree(raw, meta, example_state)

    # -- scrub: verify on-disk shards, rebuild the bad ones in place --------
    def scrub(self, step: int | None = None) -> dict:
        """Verify a checkpoint's shard/parity files and rebuild the
        missing/corrupt ones in place (fail -> rebuild -> healed, on disk).

        Every file must exist, parse as the expected (L,) uint32 array and
        match the sha256 recorded at save time (checkpoints written without
        checksums fall back to a shape + symbol-range check).  Files
        failing any check count as erasures; as long as they total at most
        R, the survivors rebuild them bitwise via the streamed rebuild
        (`CodedSystem.rebuild_stream` driven off the survivor memmaps),
        each rebuilt file is re-verified against its recorded checksum, and
        the replacement is atomic per file.  Returns a report dict:

            {"step", "checked", "missing", "corrupt", "rebuilt",
             "verified"}
        """
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        d = Path(self.directory) / f"step_{step:06d}"
        meta = json.loads((d / "meta.json").read_text())
        N, R, q = meta["N"], meta["R"], int(meta.get("q", self.field.q))
        sums: dict = meta.get("sha256", {})
        sym = -(-meta["nbytes"] // 2)
        L = -(-sym // N) if sym else 0

        def _name(i: int) -> str:
            return (f"shard_{i:03d}" if i < N else f"parity_{i - N:03d}")

        missing: list[int] = []
        corrupt: list[int] = []
        with _span("verify"):
            for i in range(N + R):
                path = d / (_name(i) + ".npy")
                if not path.exists():
                    missing.append(i)
                    continue
                try:
                    mm = np.load(path, mmap_mode="r")
                except (ValueError, OSError, EOFError):
                    corrupt.append(i)  # unparseable container
                    continue
                if mm.shape != (L,) or mm.dtype != np.uint32:
                    corrupt.append(i)
                    continue
                expected = sums.get(_name(i))
                if expected is not None:
                    h = hashlib.sha256()
                    for c0 in range(0, L, 1 << 20):
                        h.update(np.ascontiguousarray(
                            mm[c0 : c0 + (1 << 20)]).tobytes())
                    if h.hexdigest() != expected:
                        corrupt.append(i)
                elif L and int(np.max(mm)) >= q:
                    # a checkpoint without checksums: range check
                    corrupt.append(i)
        erased = sorted(missing + corrupt)
        report = {"step": step, "checked": N + R, "missing": missing,
                  "corrupt": corrupt, "rebuilt": erased, "verified": True}
        if not erased:
            return report
        if len(erased) > R:
            raise RuntimeError(
                f"scrub: {len(erased)} missing/corrupt files exceed the "
                f"code's R={R} — the checkpoint is unrecoverable "
                f"(missing={missing}, corrupt={corrupt})")

        if L == 0:
            for e in erased:
                np.save(d / (_name(e) + ".npy"), np.zeros(0, np.uint32))
            return report

        rsys = self._session(CodeSpec(kind="rs", K=N, R=R, q=q))
        try:
            rsys.fail(erased)
            kept = rsys.decode_plan.kept
            cw = self.chunk_w or plan_chunk_w(rsys.decode_plan)
            srcs = {i: np.load(d / (_name(i) + ".npy"), mmap_mode="r")
                    for i in kept}
            hs = {e: hashlib.sha256() for e in erased}
            tmps = {e: np.lib.format.open_memmap(
                        d / f".scrub_{_name(e)}.npy", mode="w+",
                        dtype=np.uint32, shape=(L,))
                    for e in erased}

            def survivor_chunks():
                for c0 in range(0, L, cw):
                    yield np.stack([np.asarray(srcs[i][c0 : c0 + cw],
                                               np.int64)
                                    for i in kept])

            col = 0
            with _span("rebuild"):
                for healed in rsys.rebuild_stream(survivor_chunks(),
                                                  chunk_w=cw):
                    w = healed.shape[1]
                    for e in erased:
                        row = healed[e].astype(np.uint32)
                        tmps[e][col : col + w] = row
                        hs[e].update(row.tobytes())
                    col += w
            assert col == L
            for e in erased:
                tmps[e].flush()
            del tmps
            # verify EVERY rebuilt payload before replacing ANY file: a
            # checksum mismatch must leave the checkpoint untouched
            for e in erased:
                expected = sums.get(_name(e))
                if expected is not None and hs[e].hexdigest() != expected:
                    report["verified"] = False
                    raise RuntimeError(
                        f"scrub: rebuilt {_name(e)} does not match its "
                        "recorded checksum — survivors are inconsistent "
                        "(more corruption than the parity can localize?)")
            for e in erased:
                os.replace(d / f".scrub_{_name(e)}.npy",
                           d / (_name(e) + ".npy"))
        finally:
            # never strand .scrub_* temps on a failed rebuild/verify
            for e in erased:
                (d / f".scrub_{_name(e)}.npy").unlink(missing_ok=True)
            rsys.close()
        return report

    def reshard(self, step: int, new_n: int, new_r: int) -> "CodedCheckpointer":
        """Elastic rescale: rewrite step with a different (N, R) layout, in
        a sibling directory `<directory>_n<new_n>`.  Its meta.json records
        the sha256 of the rewritten files (the JAX package's `reshard`
        keeps the old layout's checksums there, which its `scrub` then
        finds wrong)."""
        self.wait()
        d = Path(self.directory) / f"step_{step:06d}"
        meta = json.loads((d / "meta.json").read_text())
        shards = np.stack([np.load(d / f"shard_{k:03d}.npy").astype(np.int64)
                           for k in range(meta["N"])])
        sym = shards.reshape(-1)[: -(-meta["nbytes"] // 2)]
        raw = symbols_to_bytes(sym, meta["nbytes"])
        new = CodedCheckpointer(self.directory + f"_n{new_n}", new_n, new_r,
                                self.field, device=self.device)
        nshards = new.shard_symbols(raw)
        parity = new.encode_parity(nshards)
        final = Path(new.directory) / f"step_{meta['step']:06d}"
        final.mkdir(parents=True, exist_ok=True)
        sums: dict[str, str] = {}
        for k in range(new_n):
            arr = nshards[k].astype(np.uint32)
            np.save(final / f"shard_{k:03d}.npy", arr)
            sums[f"shard_{k:03d}"] = _sha256(arr)
        for r in range(new_r):
            arr = parity[r].astype(np.uint32)
            np.save(final / f"parity_{r:03d}.npy", arr)
            sums[f"parity_{r:03d}"] = _sha256(arr)
        meta2 = dict(meta, N=new_n, R=new_r, sha256=sums)
        (final / "meta.json").write_text(json.dumps(meta2))
        return new
