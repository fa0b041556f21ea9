"""Round-schedule IR: one backend-neutral program per (spec, method).

The paper's all-to-all encode/decode is ONE algorithm, but the repo used to
carry three implementations per code kind (simulator generators, mesh
ppermute tables, local kernels) with bitwise identity enforced only by
tests.  This module reifies the round schedule as a first-class IR so the
4-kinds x 3-backends matrix collapses into 4 *builders* + 3 *lowerings*:

    builders   build_encode_ir / build_decode_ir transcribe the per-kind
               generator schedules (universal prepare-and-shoot, rs/lagrange
               draw-and-loose, dft butterfly stages, the Sec.-III framework
               glue, and the decode-as-encode batches of recover/engine)
               into an explicit `RoundIR`: a sequence of `Round`s, each a
               tuple of `Send`s (packet movements) plus per-processor
               linear `Combine` ops over a shared coefficient pool.
    passes     `validate()` — static port/erasure-constraint check at plan
               time; `attribute(placement)` — per-tier round counts the
               drift ledger cross-checks; `tier_commute(placement)` —
               rewrites the commuting reduce phase under a placement so
               inter-host rounds strictly shrink; `digest()` — stable
               content hash for golden-schedule tests.
    lowerings  `execute(ir, ...)` runs the IR generically on the
               `RoundNetwork` simulator (round-for-round identical to the
               legacy generators: same strides, same payload snapshots, so
               measured C1/C2 still equal the closed forms bit for bit);
               `core.shardmap_exec.build_ir_mesh_program` compiles IR
               rounds into permutation legs; `coeff_matrix()` recovers
               the generator block the local/host tables consume.

This module is a copy of the JAX package's `core/schedule.py` (pure numpy),
kept so that the port imports nothing of it.

Packets are value-carrying ids: a `Send` moves ids between processors (the
value is unchanged — a broadcast shares one id), a `Combine` creates a new
id as a linear combination of ids available at its processor.  Rounds with
no sends are free, matching the simulator's local-compute contract.

The legacy generator entry points (`prepare_shoot`, `dft_a2a`,
`cauchy_a2a`, `decentralized_encode`, ...) remain importable and correct —
they are the transcription sources and the parity oracles — but the
planner backends now execute the IR.
"""
from __future__ import annotations

import hashlib
import itertools
import math
from collections import Counter, defaultdict
from dataclasses import dataclass, replace

import numpy as np

from .collectives import _n_rounds
from .dft_a2a import _stage_groups, _stage_matrix
from .field import Field
from .matrices import StructuredPoints, gauss_inverse
from .prepare_shoot import phase_split
from .simulator import Msg


class ScheduleValidationError(ValueError):
    """The IR breaks a static invariant: port overflow, a packet used
    before it exists (or away from where it lives), double creation, or
    traffic through a processor declared failed."""


# ---------------------------------------------------------------------------
# IR data model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Send:
    """Move packets `packets` (ids, values unchanged) src -> dst; costs one
    port each way and len(packets) * W field elements."""

    src: int
    dst: int
    packets: tuple[int, ...]


@dataclass(frozen=True)
class Combine:
    """Create packet `out` at `proc` as sum(coeffs[cref] * packet) over
    `terms`; empty terms make a zero packet (borrowed processors)."""

    proc: int
    out: int
    terms: tuple[tuple[int, int], ...]  # (coeff_ref, packet)


@dataclass(frozen=True)
class Round:
    """One network round: sends deliver first, then combines run in order
    (a combine may consume packets delivered this round or created by an
    earlier combine of the same round).  No sends -> free round."""

    sends: tuple[Send, ...]
    combines: tuple[Combine, ...]
    tag: str = ""


@dataclass(frozen=True)
class ReduceJob:
    """Commute metadata for one all-to-one sum-reduce: `out` (the packet
    the rest of the IR consumes) equals the sum of the `members` packets.
    `tier_commute` may drop the job's rounds (tag `reduce:{seg}`) and
    re-synthesize them placement-aware, as mod-q addition commutes."""

    seg: int
    root: int
    members: tuple[tuple[int, int], ...]  # (proc, packet)
    out: int


@dataclass(frozen=True)
class RoundIR:
    """A complete backend-neutral round program (see module docstring)."""

    kind: str                               # "encode/<method>" | "decode"
    n_procs: int
    p: int
    q: int
    n_packets: int
    coeffs: tuple[int, ...]                 # shared coefficient pool
    inputs: tuple[tuple[int, int], ...]     # (proc, packet) in payload order
    outputs: tuple[tuple[int, int], ...]    # (proc, packet) in result order
    rounds: tuple[Round, ...]
    jobs: tuple[ReduceJob, ...] = ()

    # -- analysis ----------------------------------------------------------

    def cost(self) -> tuple[int, int]:
        """Measured-equivalent flat (C1, C2) at W=1 (free rounds excluded)."""
        c1 = c2 = 0
        for r in self.rounds:
            if r.sends:
                c1 += 1
                c2 += max(len(s.packets) for s in r.sends)
        return c1, c2

    def attribute(self, placement) -> dict[str, tuple[int, int]]:
        """Per-tier (C1, C2) at W=1 under `placement` — a round is "inter"
        if ANY of its sends crosses hosts (the RoundNetwork rule)."""
        host_of = placement.host_of
        c1 = {"intra": 0, "inter": 0}
        c2 = {"intra": 0, "inter": 0}
        for r in self.rounds:
            if not r.sends:
                continue
            tier = ("inter" if any(host_of(s.src) != host_of(s.dst)
                                   for s in r.sends) else "intra")
            c1[tier] += 1
            c2[tier] += max(len(s.packets) for s in r.sends)
        return {t: (c1[t], c2[t]) for t in ("intra", "inter")}

    def digest(self) -> str:
        """Stable 16-hex content hash of the full program (golden tests)."""
        h = hashlib.sha256()
        h.update(repr((self.kind, self.n_procs, self.p, self.q,
                       self.n_packets, self.coeffs, self.inputs,
                       self.outputs)).encode())
        for r in self.rounds:
            h.update(repr((r.tag,
                           tuple((s.src, s.dst, s.packets) for s in r.sends),
                           tuple((c.proc, c.out, c.terms)
                                 for c in r.combines))).encode())
        return h.hexdigest()[:16]

    def summary(self, placement=None) -> str:
        """One describe() line: round/message totals (+ per-tier split)."""
        active = sum(1 for r in self.rounds if r.sends)
        n_msgs = sum(len(r.sends) for r in self.rounds)
        peak = max((len(r.sends) for r in self.rounds if r.sends), default=0)
        commuted = any(r.tag.startswith("commute") for r in self.rounds)
        s = (f"{active} rounds, {n_msgs} msgs (max {peak}/round), "
             f"digest={self.digest()}")
        if placement is not None:
            a = self.attribute(placement)
            s += (f"; tiers intra {a['intra'][0]} | "
                  f"inter {a['inter'][0]} rounds")
        if commuted:
            s += " [commuted]"
        return s

    def coeff_matrix(self, field: Field | None = None) -> np.ndarray:
        """(n_outputs, n_inputs) linear map the program computes: row i of
        the result is output_i = sum_j mat[i, j] * input_j.  For an encode
        IR this equals A.T; for a decode IR, D.T — the local/host table
        lowering is derived (and tested) against exactly this."""
        field = field or Field(self.q)
        n_in = len(self.inputs)
        vec: dict[int, np.ndarray] = {}
        for i, (_, pid) in enumerate(self.inputs):
            e = np.zeros(n_in, np.int64)
            e[i] = 1
            vec[pid] = e
        for r in self.rounds:
            for c in r.combines:
                acc = np.zeros(n_in, np.int64)
                for cref, pid in c.terms:
                    acc = field.add(acc, field.mul(self.coeffs[cref],
                                                   vec[pid]))
                vec[c.out] = acc
        if not self.outputs:
            return np.zeros((0, n_in), np.int64)
        return np.stack([vec[pid] for _, pid in self.outputs])

    # -- validation --------------------------------------------------------

    def validate(self, failed=None) -> "RoundIR":
        """Static plan-time check; raises `ScheduleValidationError`.

        Verifies processor ranges, the p-port constraint per round, packet
        provenance (sent packets exist at their source from a PRIOR round;
        combine terms are available at the combining processor, same-round
        deliveries included), single assignment of packet ids, coefficient
        refs in range, output availability — and, with `failed`, that no
        send or combine touches an erased processor."""
        failed = frozenset(failed or ())
        n, p = self.n_procs, self.p

        def _chk_proc(g, what):
            if not 0 <= g < n:
                raise ScheduleValidationError(
                    f"{what}: processor {g} outside [0, {n})")
            if g in failed:
                raise ScheduleValidationError(
                    f"{what}: touches failed processor {g}")

        avail: dict[int, set[int]] = {}
        created: set[int] = set()
        for proc, pid in self.inputs:
            _chk_proc(proc, "input")
            if pid in created:
                raise ScheduleValidationError(
                    f"packet {pid} created twice (input)")
            created.add(pid)
            avail[pid] = {proc}
        for t, r in enumerate(self.rounds):
            where = f"round {t} [{r.tag}]"
            sends_per: Counter = Counter()
            recvs_per: Counter = Counter()
            delivered: list[tuple[int, int]] = []
            for s in r.sends:
                _chk_proc(s.src, where)
                _chk_proc(s.dst, where)
                if s.src == s.dst:
                    raise ScheduleValidationError(
                        f"{where}: self-send at {s.src}")
                if not s.packets:
                    raise ScheduleValidationError(
                        f"{where}: empty send {s.src}->{s.dst}")
                sends_per[s.src] += 1
                recvs_per[s.dst] += 1
                for pid in s.packets:
                    if pid not in created:
                        raise ScheduleValidationError(
                            f"{where}: packet {pid} sent before creation")
                    if s.src not in avail[pid]:
                        raise ScheduleValidationError(
                            f"{where}: packet {pid} not at sender {s.src}")
                    delivered.append((s.dst, pid))
            over = {g: c for g, c in sends_per.items() if c > p}
            if over:
                raise ScheduleValidationError(
                    f"{where}: send-port violation {over} with p={p}")
            over = {g: c for g, c in recvs_per.items() if c > p}
            if over:
                raise ScheduleValidationError(
                    f"{where}: recv-port violation {over} with p={p}")
            for dst, pid in delivered:
                avail[pid].add(dst)
            for c in r.combines:
                _chk_proc(c.proc, where)
                if c.out in created:
                    raise ScheduleValidationError(
                        f"{where}: packet {c.out} created twice")
                for cref, pid in c.terms:
                    if not 0 <= cref < len(self.coeffs):
                        raise ScheduleValidationError(
                            f"{where}: coefficient ref {cref} out of range")
                    if pid not in created or c.proc not in avail[pid]:
                        raise ScheduleValidationError(
                            f"{where}: combine at {c.proc} uses packet "
                            f"{pid} it does not hold")
                created.add(c.out)
                avail[c.out] = {c.proc}
        for proc, pid in self.outputs:
            _chk_proc(proc, "output")
            if pid not in created or proc not in avail[pid]:
                raise ScheduleValidationError(
                    f"output packet {pid} not available at {proc}")
        return self

    # -- rewrite pass ------------------------------------------------------

    def tier_commute(self, placement) -> "RoundIR":
        """Placement-aware rewrite of the commuting reduce segments.

        Mod-q all-to-one sums commute, so each `ReduceJob` segment may be
        re-synthesized against the placement: per-host partial sums pack
        into intra-host rounds, outgoing partials coalesce onto one
        forwarder per source host, and ALL cross-host traffic collapses
        into bundled forwarder->sink-host rounds — the inter-host round
        count strictly shrinks or the segment is left untouched (so
        canonical plans keep their closed-form tier splits).  Outputs are
        value-identical: the final combine recreates each job's original
        `out` packet id from the re-routed partials."""
        if not self.jobs:
            return self
        host_of = placement.host_of
        by_seg: dict[int, list[ReduceJob]] = defaultdict(list)
        for j in self.jobs:
            by_seg[j.seg].append(j)

        coeffs = list(self.coeffs)
        cmap = {c: i for i, c in enumerate(coeffs)}

        def cref(c):
            c = int(c) % self.q
            if c not in cmap:
                cmap[c] = len(coeffs)
                coeffs.append(c)
            return cmap[c]

        state = {"next": self.n_packets}

        def new_pid():
            i = state["next"]
            state["next"] += 1
            return i

        def seg_tiers(rounds):
            return sum(1 for r in rounds if r.sends
                       and any(host_of(s.src) != host_of(s.dst)
                               for s in r.sends))

        rounds = list(self.rounds)
        changed = False
        for seg in sorted(by_seg):
            tag = f"reduce:{seg}"
            idxs = [i for i, r in enumerate(rounds) if r.tag == tag]
            if not idxs or idxs != list(range(idxs[0], idxs[-1] + 1)):
                continue  # nothing to rewrite / non-contiguous segment
            old = rounds[idxs[0]: idxs[-1] + 1]
            synth = _resynth_reduce(by_seg[seg], placement, self.p,
                                    new_pid, cref, seg)
            if seg_tiers(synth) >= seg_tiers(old):
                continue  # rewrite must strictly shrink inter rounds
            rounds[idxs[0]: idxs[-1] + 1] = synth
            changed = True
        if not changed:
            return self
        return replace(self, rounds=tuple(rounds), coeffs=tuple(coeffs),
                       n_packets=state["next"], jobs=()).validate()


# ---------------------------------------------------------------------------
# generic simulator lowering
# ---------------------------------------------------------------------------

def execute(ir: RoundIR, field: Field, x: np.ndarray, net) -> np.ndarray:
    """Run the IR on a `RoundNetwork`: x rows are the input payloads in
    `ir.inputs` order; returns the output payloads stacked in `ir.outputs`
    order.  The generator yields exactly the legacy schedules' rounds
    (combines run lazily after each round's delivery, like the generator
    state updates they transcribe), so port checks, tier attribution,
    RoundEvents and PartialRunError semantics all come from the untouched
    simulator."""
    x = field.arr(x)
    if x.shape[0] != len(ir.inputs):
        raise ValueError(f"x must carry {len(ir.inputs)} input rows, "
                         f"got {x.shape}")
    row_shape = x.shape[1:]
    W = int(np.prod(row_shape, dtype=np.int64)) if row_shape else 1
    coeffs = ir.coeffs
    vals: dict[int, np.ndarray] = {}
    for (_, pid), row in zip(ir.inputs, x):
        vals[pid] = row

    def gen():
        for r in ir.rounds:
            yield [Msg(s.src, s.dst, len(s.packets) * W) for s in r.sends]
            for c in r.combines:
                acc = np.zeros(row_shape, np.int64)
                for cr, pid in c.terms:
                    acc = field.add(acc, field.mul(coeffs[cr], vals[pid]))
                vals[c.out] = acc

    net.run(gen())
    if not ir.outputs:
        return np.zeros((0,) + row_shape, np.int64)
    return np.stack([vals[pid] for _, pid in ir.outputs])


# ---------------------------------------------------------------------------
# builder plumbing: packet/coefficient allocation + fragment lockstep
# ---------------------------------------------------------------------------

class _Builder:
    """Allocates packet ids and deduplicated coefficient refs."""

    def __init__(self, field: Field, p: int):
        self.field = field
        self.p = p
        self.n_packets = 0
        self.inputs: list[tuple[int, int]] = []
        self.coeffs: list[int] = []
        self._cmap: dict[int, int] = {}

    def pid(self) -> int:
        i = self.n_packets
        self.n_packets += 1
        return i

    def input(self, proc: int) -> int:
        i = self.pid()
        self.inputs.append((proc, i))
        return i

    def cref(self, c) -> int:
        c = int(c) % self.field.q
        i = self._cmap.get(c)
        if i is None:
            i = self._cmap[c] = len(self.coeffs)
            self.coeffs.append(c)
        return i

    def comb(self, proc: int, terms) -> Combine:
        return Combine(proc, self.pid(),
                       tuple((self.cref(c), pid) for c, pid in terms))

    def finish(self, kind: str, n_procs: int, rounds, outputs,
               jobs=()) -> RoundIR:
        return RoundIR(kind=kind, n_procs=n_procs, p=self.p,
                       q=self.field.q, n_packets=self.n_packets,
                       coeffs=tuple(self.coeffs),
                       inputs=tuple(self.inputs), outputs=tuple(outputs),
                       rounds=tuple(rounds), jobs=tuple(jobs))


def _lockstep(*frags):
    """Merge fragment streams positionally — the IR-level `run_lockstep`:
    parallel instances on disjoint groups share rounds 1:1."""
    for parts in itertools.zip_longest(*frags, fillvalue=None):
        sends: list[Send] = []
        combines: list[Combine] = []
        for part in parts:
            if part is not None:
                s, c = part
                sends.extend(s)
                combines.extend(c)
        yield (sends, combines)


def _rounds_from(frags, tag: str) -> list[Round]:
    return [Round(tuple(s), tuple(c), tag) for s, c in frags]


# ---------------------------------------------------------------------------
# fragment builders — line-for-line transcriptions of the legacy generators
# (same strides, same payload snapshots, same grouped pops), yielding
# (sends, combines) per round so the IR matches them round-for-round
# ---------------------------------------------------------------------------

def _ps_frag(b: _Builder, C, x: dict[int, int], procs: list[int],
             out: dict[int, int]):
    """Universal prepare-and-shoot (`core.prepare_shoot.prepare_shoot`)."""
    field, p = b.field, b.p
    K = len(procs)
    C = field.arr(C)
    if K == 1:
        c = b.comb(procs[0], [(int(C[0, 0]), x[procs[0]])])
        out[procs[0]] = c.out
        yield ([], [c])
        return

    L, T_p, T_s, m = phase_split(K, p)
    n = math.ceil(K / m)

    # ---- prepare phase (Alg. 1): payload snapshots move input ids --------
    memory: list[dict[int, int]] = [{k: x[procs[k]]} for k in range(K)]
    w: list[dict[int, int]] = []
    for t in range(1, T_p + 1):
        stride = (p + 1) ** (T_p - t)
        sends: list[Send] = []
        incoming: list[list[dict[int, int]]] = [[] for _ in range(K)]
        for k in range(K):
            payload = dict(memory[k])
            for rho in range(1, p + 1):
                dst = (k + rho * stride) % K
                if dst == k:
                    continue
                sends.append(Send(procs[k], procs[dst],
                                  tuple(payload[r] for r in sorted(payload))))
                incoming[dst].append(payload)
        for k in range(K):
            for payload in incoming[k]:
                memory[k].update(payload)
        combines: list[Combine] = []
        if t == T_p:
            # shoot-packet init runs after the last prepare delivery
            for k in range(K):
                wk: dict[int, int] = {}
                for l in range(n):
                    s = (k + l * m) % K
                    c = b.comb(procs[k], [(int(C[r, s]), memory[k][r])
                                          for r in sorted(memory[k])])
                    wk[s] = c.out
                    combines.append(c)
                w.append(wk)
            if T_s == 0:
                combines.extend(_ps_correction(b, C, memory, w, procs,
                                               n, m, K, out))
        yield (sends, combines)

    # ---- shoot phase (Alg. 2, corrected stride) --------------------------
    for t in range(1, T_s + 1):
        blk = (p + 1) ** t
        sub = (p + 1) ** (t - 1)
        grouped: dict[tuple[int, int], dict[int, int]] = defaultdict(dict)
        for s in range(K):
            for j in range(n):
                rem = j % blk
                if rem == 0 or rem % sub != 0:
                    continue
                src = (s - j * m) % K
                dst = (s - (j - rem) * m) % K
                if s in w[src]:
                    grouped[(src, dst)][s] = w[src].pop(s)
        sends = [Send(procs[src], procs[dst],
                      tuple(pl[s] for s in sorted(pl)))
                 for (src, dst), pl in grouped.items()]
        combines = []
        for (src, dst), pl in grouped.items():
            for s in sorted(pl):
                c = b.comb(procs[dst], [(1, w[dst][s]), (1, pl[s])])
                w[dst][s] = c.out
                combines.append(c)
        if t == T_s:
            combines.extend(_ps_correction(b, C, memory, w, procs,
                                           n, m, K, out))
        yield (sends, combines)


def _ps_correction(b, C, memory, w, procs, n, m, K, out):
    """Overlap correction (eq. 4): out_k = w[k][k] - sum over duplicated
    source indices — emitted as one combine with negated coefficients."""
    q = b.field.q
    combines = []
    for k in range(K):
        mult: Counter = Counter()
        for j in range(n):
            for r in memory[(k - j * m) % K]:
                mult[r] += 1
        extra = [((-(c - 1) * int(C[r, k])) % q, memory[k][r])
                 for r, c in sorted(mult.items()) if c > 1]
        if extra:
            c2 = b.comb(procs[k], [(1, w[k][k])] + extra)
            out[procs[k]] = c2.out
            combines.append(c2)
        else:
            out[procs[k]] = w[k][k]
    return combines


def _bcast_plan(N: int, p: int) -> list[list[tuple[int, int]]]:
    """(p+1)-nomial broadcast edge plan of `collectives.broadcast` — the
    reduce schedules replay it reversed."""
    T = _n_rounds(N, p)
    plan: list[list[tuple[int, int]]] = []
    have = {0}
    for t in range(1, T + 1):
        stride = (p + 1) ** (T - t)
        edges, new = [], set()
        for i in sorted(have):
            for rho in range(1, p + 1):
                j = i + rho * stride
                if j < N and j not in have and j not in new:
                    edges.append((i, j))
                    new.add(j)
        plan.append(edges)
        have |= new
    return plan


def _bcast_frag(b: _Builder, pid: int, procs: list[int],
                out: dict[int, int]):
    """One-to-all broadcast: every member ends holding the SAME packet."""
    for edges in _bcast_plan(len(procs), b.p):
        yield ([Send(procs[i], procs[j], (pid,)) for i, j in edges], [])
    for g in procs:
        out[g] = pid


def _reduce_frag(b: _Builder, vals: dict[int, int], procs: list[int],
                 out: dict[int, int], jobs: list[ReduceJob] | None,
                 seg: int):
    """All-to-one sum-reduce onto procs[0] (dual of broadcast); records a
    `ReduceJob` so `tier_commute` may re-synthesize it."""
    N = len(procs)
    acc = {i: vals[procs[i]] for i in range(N)}
    members = tuple((procs[i], acc[i]) for i in range(N))
    plan = _bcast_plan(N, b.p)
    for edges in reversed(plan):
        sends = [Send(procs[j], procs[i], (acc[j],)) for i, j in edges]
        combines = []
        for i, j in edges:
            c = b.comb(procs[i], [(1, acc[i]), (1, acc[j])])
            acc[i] = c.out
            combines.append(c)
        yield (sends, combines)
    out[procs[0]] = acc[0]
    if jobs is not None and plan:
        jobs.append(ReduceJob(seg, procs[0], members, acc[0]))


def _dft_frag(b: _Builder, x: dict[int, int], procs: list[int], P: int,
              out: dict[int, int], inverse: bool = False):
    """Permuted-DFT butterfly stages (`core.dft_a2a.dft_a2a`)."""
    field = b.field
    K = len(procs)
    H = 0
    while P ** H < K:
        H += 1
    vals = {k: x[procs[k]] for k in range(K)}
    stages = range(H - 1, -1, -1) if inverse else range(H)
    for h in stages:
        frags = []
        stage_out: dict[int, int] = {}
        for members in _stage_groups(K, P, H, h):
            mat = _stage_matrix(field, K, P, H, h, members[0])
            if inverse:
                mat = gauss_inverse(field, mat)
            gx = {procs[mm]: vals[mm] for mm in members}
            frags.append(_ps_frag(b, mat, gx,
                                  [procs[mm] for mm in members], stage_out))
        yield from _lockstep(*frags)
        for k in range(K):
            vals[k] = stage_out[procs[k]]
    for k in range(K):
        out[procs[k]] = vals[k]


def _dl_frag(b: _Builder, sp: StructuredPoints, x: dict[int, int],
             procs: list[int], out: dict[int, int],
             inverse: bool = False):
    """Draw-and-loose (`core.draw_loose.draw_loose`): column A2As on V_M,
    the free local scaling (a sendless combine round), row DFTs."""
    from .draw_loose import _v_m

    field = b.field
    M, Z, P = sp.M, sp.Z, sp.P
    K = M * Z
    vals = {k: x[procs[k]] for k in range(K)}

    def draw(mat):
        frags, so = [], {}
        for j in range(Z):
            gx = {procs[i * Z + j]: vals[i * Z + j] for i in range(M)}
            frags.append(_ps_frag(b, mat, gx,
                                  [procs[i * Z + j] for i in range(M)], so))
        return frags, so

    def loose(inv):
        frags, so = [], {}
        for i in range(M):
            gx = {procs[i * Z + j]: vals[i * Z + j] for j in range(Z)}
            frags.append(_dft_frag(b, gx,
                                   [procs[i * Z + j] for j in range(Z)],
                                   P, so, inverse=inv))
        return frags, so

    def scale(invert):
        combines = []
        for i in range(M):
            for j in range(Z):
                s = pow(sp.alpha(i), j, field.q)
                if invert:
                    s = int(field.inv(s))
                if s != 1:
                    c = b.comb(procs[i * Z + j], [(s, vals[i * Z + j])])
                    vals[i * Z + j] = c.out
                    combines.append(c)
        return combines

    def sync(so):
        for k in range(K):
            vals[k] = so[procs[k]]

    if not inverse:
        if M > 1:
            frags, so = draw(_v_m(field, sp))
            yield from _lockstep(*frags)
            sync(so)
        yield ([], scale(invert=False))
        if Z > 1:
            frags, so = loose(False)
            yield from _lockstep(*frags)
            sync(so)
    else:
        if Z > 1:
            frags, so = loose(True)
            yield from _lockstep(*frags)
            sync(so)
        yield ([], scale(invert=True))
        if M > 1:
            frags, so = draw(gauss_inverse(field, _v_m(field, sp)))
            yield from _lockstep(*frags)
            sync(so)
    for k in range(K):
        out[procs[k]] = vals[k]


def _cauchy_frag(b: _Builder, sgrs, m: int, x: dict[int, int],
                 procs: list[int], out: dict[int, int]):
    """Cauchy-like block A2A (`core.cauchy.cauchy_a2a`): phi^-1 scale,
    inverse draw-loose, forward draw-loose, psi scale."""
    f = b.field
    phi, psi = sgrs.scaling_factors(m)
    if sgrs.K >= sgrs.R:
        sp_in, sp_out = sgrs.alpha_blocks[m], sgrs.beta_blocks[0]
    else:
        sp_in, sp_out = sgrs.alpha_blocks[0], sgrs.beta_blocks[m]
    n = len(procs)
    vals: dict[int, int] = {}
    head = []
    for k in range(n):
        s = int(f.inv(phi[k]))
        if s != 1:
            c = b.comb(procs[k], [(s, x[procs[k]])])
            vals[procs[k]] = c.out
            head.append(c)
        else:
            vals[procs[k]] = x[procs[k]]
    yield ([], head)
    mid: dict[int, int] = {}
    yield from _dl_frag(b, sp_in, vals, procs, mid, inverse=True)
    fin: dict[int, int] = {}
    yield from _dl_frag(b, sp_out, mid, procs, fin)
    tail = []
    for k in range(n):
        s = int(psi[k]) % f.q
        if s != 1:
            c = b.comb(procs[k], [(s, fin[procs[k]])])
            out[procs[k]] = c.out
            tail.append(c)
        else:
            out[procs[k]] = fin[procs[k]]
    yield ([], tail)


# ---------------------------------------------------------------------------
# top-level builders
# ---------------------------------------------------------------------------

def build_universal_a2a_ir(field: Field, C: np.ndarray,
                           p: int = 1) -> RoundIR:
    """IR of one square universal A2A on K standalone processors (the
    paper's worked examples; `prepare_shoot`'s convenience wrapper)."""
    K = int(C.shape[0])
    b = _Builder(field, p)
    x = {k: b.input(k) for k in range(K)}
    out: dict[int, int] = {}
    rounds = _rounds_from(_ps_frag(b, C, x, list(range(K)), out), "a2a")
    return b.finish("a2a/universal", K, rounds,
                    [(k, out[k]) for k in range(K)])


def build_encode_ir(spec, method: str | None = None, A=None,
                    sgrs=None) -> RoundIR:
    """IR of the full Sec.-III framework encode (or the dft transform) for
    `spec`, transcribing `framework.decentralized_encode` / `dft_a2a`."""
    field = spec.field
    if method is None:
        method = "dft" if spec.kind == "dft" else (
            "rs" if spec.structured() else "universal")
    K, R, p = spec.K, spec.R, spec.p
    b = _Builder(field, p)

    if spec.kind == "dft" or method == "dft":
        procs = list(range(K))
        x = {k: b.input(k) for k in procs}
        out: dict[int, int] = {}
        rounds = _rounds_from(_dft_frag(b, x, procs, spec.P, out), "dft")
        return b.finish("encode/dft", K, rounds,
                        [(k, out[k]) for k in procs])

    if method == "rs" and sgrs is None:
        from .cauchy import StructuredGRS

        sgrs = StructuredGRS.build(field, K, R, P=spec.P,
                                   lagrange=spec.kind == "lagrange")
    if A is None:
        A = (sgrs.grs.A_direct() if method == "rs"
             else spec.default_matrix(field))
    A = field.arr(A)

    from .framework import _pad_rows

    xpid = {k: b.input(k) for k in range(K)}
    jobs: list[ReduceJob] = []

    if K >= R:
        M = math.ceil(K / R)
        Ap = _pad_rows(field, A, M * R)

        def pos_proc(r, m):
            k = r + m * R
            return k if k < K else K + r  # borrowed sink T_r holds 0

        zero_combines: list[Combine] = []
        zero_pid: dict[int, int] = {}

        def zpid(proc):
            if proc not in zero_pid:
                c = b.comb(proc, [])
                zero_pid[proc] = c.out
                zero_combines.append(c)
            return zero_pid[proc]

        # ---- phase 1: column-wise A2A --------------------------------
        partial: dict[int, int] = {}
        frags = []
        for m in range(M):
            procs = [pos_proc(r, m) for r in range(R)]
            vals = {pos_proc(r, m): (xpid[r + m * R] if r + m * R < K
                                     else zpid(pos_proc(r, m)))
                    for r in range(R)}
            if method == "rs":
                frags.append(_cauchy_frag(b, sgrs, m, vals, procs, partial))
            else:
                Am = Ap[m * R: (m + 1) * R, :]
                frags.append(_ps_frag(b, Am, vals, procs, partial))
        phase1 = _rounds_from(_lockstep(*frags), "a2a:0")

        # ---- phase 2: row-wise reduce into sink T_r -------------------
        out = {}
        frags = []
        for r in range(R):
            row = [pos_proc(r, m) for m in range(M)]
            sink = K + r
            procs = [sink] + [g for g in row if g != sink]
            vals = {g: partial[g] for g in row}
            if sink not in vals:
                vals[sink] = zpid(sink)
            frags.append(_reduce_frag(b, vals, procs, out, jobs, seg=0))
        phase2 = _rounds_from(_lockstep(*frags), "reduce:0")
        init = ([Round((), tuple(zero_combines), "init")]
                if zero_combines else [])
        rounds = init + phase1 + phase2
        outputs = [(K + r, out[K + r]) for r in range(R)]
    else:
        M = math.ceil(R / K)

        def pos_proc(k, m):
            r = k + m * K
            return K + r if r < R else k  # borrowed source holds its x_k

        Ap = np.concatenate(
            [field.arr(A), np.zeros((K, M * K - R), np.int64)], axis=1)

        # ---- phase 1: row-wise broadcast of x_k -----------------------
        xk: dict[int, int] = {}
        frags = []
        for k in range(K):
            row = [k] + [pos_proc(k, m) for m in range(M)
                         if pos_proc(k, m) != k]
            frags.append(_bcast_frag(b, xpid[k], row, xk))
        phase1 = _rounds_from(_lockstep(*frags), "bcast:0")

        # ---- phase 2: column-wise A2A on A'_m -------------------------
        out = {}
        frags = []
        for m in range(M):
            procs = [pos_proc(k, m) for k in range(K)]
            vals = {pos_proc(k, m): xk[pos_proc(k, m)] for k in range(K)}
            if method == "rs":
                frags.append(_cauchy_frag(b, sgrs, m, vals, procs, out))
            else:
                Am = Ap[:, m * K: (m + 1) * K]
                frags.append(_ps_frag(b, Am, vals, procs, out))
        phase2 = _rounds_from(_lockstep(*frags), "a2a:0")
        rounds = phase1 + phase2
        outputs = [(pos_proc(r % K, r // K), out[pos_proc(r % K, r // K)])
                   for r in range(R)]

    return b.finish(f"encode/{method}", K + R, rounds, outputs, jobs)


def build_decode_ir(spec, D: np.ndarray, kept) -> RoundIR:
    """IR of the decode-as-encode repair among the K kept survivors,
    transcribing `recover.engine.decentralized_decode` batch by batch."""
    from ..recover.engine import batch_block, decode_batches

    field = spec.field
    D = field.arr(D)
    K, E = D.shape
    kept = [int(g) for g in kept]
    b = _Builder(field, spec.p)
    vpid = {i: b.input(kept[i]) for i in range(K)}
    jobs: list[ReduceJob] = []
    rounds: list[Round] = []
    out_rows: list[tuple[int, int]] = []
    for bi, (eb, ep) in enumerate(decode_batches(K, E)):
        Db = batch_block(D, bi)
        M = K // ep
        partial: dict[int, int] = {}
        frags = []
        for m in range(M):
            procs = [kept[m * ep + j] for j in range(ep)]
            vals = {procs[j]: vpid[m * ep + j] for j in range(ep)}
            frags.append(_ps_frag(b, Db[m * ep: (m + 1) * ep, :], vals,
                                  procs, partial))
        rounds += _rounds_from(_lockstep(*frags), f"a2a:{bi}")
        if M > 1:
            out: dict[int, int] = {}
            frags = []
            for j in range(ep):
                procs = [kept[m * ep + j] for m in range(M)]
                vals = {g: partial[g] for g in procs}
                frags.append(_reduce_frag(b, vals, procs, out, jobs,
                                          seg=bi))
            rounds += _rounds_from(_lockstep(*frags), f"reduce:{bi}")
        else:
            out = partial
        out_rows.extend((kept[j], out[kept[j]]) for j in range(eb))
    return b.finish("decode", spec.N, rounds, out_rows, jobs)


# ---------------------------------------------------------------------------
# tier_commute re-synthesis
# ---------------------------------------------------------------------------

def _greedy_rounds(pending, p, tag):
    """Schedule bundled sends into p-port-legal rounds, greedily and
    deterministically; each round admits at most p sends and p receives
    per processor."""
    rounds: list[Round] = []
    while pending:
        used_s: Counter = Counter()
        used_r: Counter = Counter()
        this, rest = [], []
        for src, dst, pids in pending:
            if used_s[src] < p and used_r[dst] < p:
                this.append(Send(src, dst, tuple(pids)))
                used_s[src] += 1
                used_r[dst] += 1
            else:
                rest.append((src, dst, pids))
        rounds.append(Round(tuple(this), (), tag))
        pending = rest
    return rounds


def _merge_frag_lists(lists, tag):
    """Positionally merge per-instance round lists of (sends, combines)."""
    out: list[Round] = []
    for parts in itertools.zip_longest(*lists, fillvalue=None):
        sends: list[Send] = []
        combines: list[Combine] = []
        for part in parts:
            if part is not None:
                s, c = part
                sends.extend(s)
                combines.extend(c)
        out.append(Round(tuple(sends), tuple(combines), tag))
    return out


def _resynth_reduce(jobs, placement, p, new_pid, cref, seg):
    """Placement-aware replacement rounds for one reduce segment.

    1. per-(job, host) intra reduce trees onto a leader (the root on its
       own host), run in lockstep;
    2. per source host, gather every outgoing partial onto ONE forwarder
       (bundled intra tree — messages carry multiple packets);
    3. bundled forwarder -> sink-host rounds (the only inter traffic);
    4. intra redistribution from the receiving processor to each root;
    5. final combines recreate each job's original `out` packet."""
    host_of = placement.host_of
    one = cref(1)

    # ---- stage 1: per-host partial sums ---------------------------------
    trees = []   # (ji, host, members sorted leader-first)
    for ji, job in enumerate(jobs):
        by_host: dict[int, list] = defaultdict(list)
        for proc, pid in job.members:
            by_host[host_of(proc)].append((proc, pid))
        rh = host_of(job.root)
        for h in sorted(by_host):
            mem = by_host[h]
            if h == rh:
                mem.sort(key=lambda t: (t[0] != job.root, t[0]))
            else:
                mem.sort()
            trees.append((ji, h, mem))

    partials: dict[tuple[int, int], tuple[int, int]] = {}
    tree_frags = []
    for ji, h, mem in trees:
        acc = {i: mem[i][1] for i in range(len(mem))}
        frag = []
        for edges in reversed(_bcast_plan(len(mem), p)):
            sends, combines = [], []
            for i, j in edges:
                sends.append(Send(mem[j][0], mem[i][0], (acc[j],)))
                out = new_pid()
                combines.append(Combine(mem[i][0], out,
                                        ((one, acc[i]), (one, acc[j]))))
                acc[i] = out
            frag.append((sends, combines))
        tree_frags.append(frag)
        partials[(ji, h)] = (mem[0][0], acc[0])
    rounds = _merge_frag_lists(tree_frags, f"commute:tree:{seg}")

    # ---- stage 2: gather outgoing partials onto one forwarder per host --
    outbound: dict[int, list] = defaultdict(list)
    for (ji, h), (leader, pid) in sorted(partials.items()):
        if h != host_of(jobs[ji].root):
            outbound[h].append((ji, leader, pid))
    forwarder: dict[int, int] = {}
    fwd_bundle: dict[int, list] = {}
    gather_frags = []
    for h in sorted(outbound):
        holders: dict[int, list] = defaultdict(list)
        for ji, leader, pid in outbound[h]:
            holders[leader].append((ji, pid))
        hl = sorted(holders, key=lambda g: (-len(holders[g]), g))
        bundles = {i: list(holders[hl[i]]) for i in range(len(hl))}
        frag = []
        for edges in reversed(_bcast_plan(len(hl), p)):
            sends = []
            for i, j in edges:
                sends.append(Send(hl[j], hl[i],
                                  tuple(pid for _, pid in bundles[j])))
                bundles[i].extend(bundles[j])
                bundles[j] = []
            frag.append((sends, []))
        gather_frags.append(frag)
        forwarder[h] = hl[0]
        fwd_bundle[h] = bundles[0]
    rounds += _merge_frag_lists(gather_frags, f"commute:gather:{seg}")

    # ---- stage 3: bundled inter-host rounds -----------------------------
    roots_on: dict[int, list] = defaultdict(list)
    for job in jobs:
        H = host_of(job.root)
        if job.root not in roots_on[H]:
            roots_on[H].append(job.root)
    rr: Counter = Counter()
    inter_pending = []
    for h in sorted(fwd_bundle):
        by_dst: dict[int, list] = defaultdict(list)
        for ji, pid in fwd_bundle[h]:
            by_dst[host_of(jobs[ji].root)].append((ji, pid))
        for H in sorted(by_dst):
            dst = roots_on[H][rr[H] % len(roots_on[H])]
            rr[H] += 1
            inter_pending.append(
                (forwarder[h], dst, tuple(p_ for _, p_ in by_dst[H]),
                 by_dst[H]))
    rounds += _greedy_rounds([(s, d, pids) for s, d, pids, _ in
                              inter_pending], p, f"commute:inter:{seg}")

    # ---- stage 4: intra redistribution to the roots ---------------------
    arrived: dict[int, list] = defaultdict(list)
    redis: dict[tuple[int, int], list] = defaultdict(list)
    for _, dst, _, items in inter_pending:
        for ji, pid in items:
            root = jobs[ji].root
            if dst == root:
                arrived[ji].append(pid)
            else:
                redis[(dst, root)].append((ji, pid))
    for (dst, root), items in sorted(redis.items()):
        for ji, pid in items:
            arrived[ji].append(pid)
    redis_rounds = _greedy_rounds(
        [(d, r, tuple(p_ for _, p_ in items))
         for (d, r), items in sorted(redis.items())],
        p, f"commute:redistribute:{seg}")

    # ---- stage 5: final combines recreate the original out packets ------
    final = []
    for ji, job in enumerate(jobs):
        rh = host_of(job.root)
        terms = []
        if (ji, rh) in partials:
            terms.append((one, partials[(ji, rh)][1]))
        terms.extend((one, pid) for pid in arrived[ji])
        final.append(Combine(job.root, job.out, tuple(terms)))
    if redis_rounds:
        last = redis_rounds[-1]
        redis_rounds[-1] = Round(last.sends,
                                 last.combines + tuple(final), last.tag)
    else:
        redis_rounds.append(Round((), tuple(final),
                                  f"commute:final:{seg}"))
    rounds += redis_rounds
    return rounds
