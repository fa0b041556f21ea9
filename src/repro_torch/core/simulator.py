"""Round-based p-port network simulator (the paper's communication model).

The network is fully connected; time advances in rounds; in one round every
processor may send one message and receive one message per port (p ports).
Round t costs  alpha + beta * m_t  where m_t is the largest message (in field
elements) exchanged in that round.  Metrics (Sec. I):

    C1 = number of rounds
    C2 = sum_t m_t

Algorithms are written as *schedules*: python generators that yield, once per
round, a list of `Msg(src, dst, n_elems)` records (state changes are applied
by the generator itself — it simulates all processors of its group with
global knowledge, which is legitimate because scheduling and coding schemes
are data-independent, Remark 1).  The network runner:

  * advances any number of schedules in lockstep (parallel instances on
    disjoint processor groups, e.g. the M column-wise A2As of Sec. III),
  * validates the p-port constraint globally per round,
  * accounts C1 / C2 / total element traffic.

Failure model (Sec. I): `fail(procs)` erases processors statically —
schedules planned around the erasure set never touch them, and a schedule
that does raises `FailedProcessorError`.  `fail_at(round, procs)` (or the
`FaultInjector` harness) additionally injects *live* failures between rounds
of a running schedule: once `C1` reaches the registered round, the
processors die, and the first message touching one aborts `run` with a
structured `PartialRunError` carrying the exact C1/C2 of the completed
prefix plus each processor's received-so-far element counts — everything a
repair planner needs to replan against the enlarged erasure set and
account the aborted prefix plus the retry exactly.

All validation raises real exceptions (`ValueError` for malformed
messages/positions, `PortViolationError` for port-constraint breaches) —
never bare `assert`, which `python -O` strips.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field as dc_field

from ..obs.trace import get_tracer


@dataclass(frozen=True)
class RoundEvent:
    """Structured record of one accounted round (the `round_log` entry).

    round — 1-based round index on this network (== C1 after the round)
    n_msgs, m_t — message count and max message size of the round
    sent, recv — per-processor field elements moved this round, as sorted
                 ((proc, elems), ...) tuples

    Unpacks as the legacy `(n_msgs, m_t)` pair, so existing consumers of
    `round_log` (`sum(m for _, m in net.round_log)`) keep working.
    """

    round: int
    n_msgs: int
    m_t: int
    sent: tuple = ()
    recv: tuple = ()

    def __iter__(self):
        return iter((self.n_msgs, self.m_t))

    def __getitem__(self, i):
        return (self.n_msgs, self.m_t)[i]

    def __len__(self):
        return 2


@dataclass(frozen=True)
class Msg:
    src: int
    dst: int
    n_elems: int  # field elements in this message

    def __post_init__(self):
        if self.src == self.dst:
            raise ValueError(
                f"self-message {self.src}->{self.dst}: local ops are not "
                "traffic")
        if self.n_elems < 1:
            raise ValueError(f"messages carry >= 1 field elements, got "
                             f"{self.n_elems}")


class FailedProcessorError(RuntimeError):
    """A schedule tried to route traffic through an erased processor.

    `proc` is the erased processor the message touched (None when raised
    without that context)."""

    def __init__(self, message: str, proc: int | None = None):
        super().__init__(message)
        self.proc = proc


class PortViolationError(RuntimeError):
    """A round exceeded the p-port constraint on some processor (more than
    p sends or p receives)."""


class PartialRunError(FailedProcessorError):
    """`run` aborted because a live-injected kill (`fail_at` /
    `FaultInjector`) landed mid-schedule.

    The aborted round is NOT accounted (its messages were never
    delivered); the attributes snapshot everything the recover planner
    needs to restart the repair against the enlarged erasure set:

        round    — completed rounds when the abort hit (== C1)
        C1, C2   — the network's exact accounting of the completed prefix
                   (cumulative over the network's lifetime)
        proc     — the dead processor whose message aborted the round
        killed   — all processors killed by live injection so far
        failed   — the full failure set (static + injected)
        received — per-processor field elements received so far (only
                   fully-accounted rounds count; cumulative per network)
    """

    def __init__(self, net: "RoundNetwork", proc: int):
        self.round = net.C1
        self.C1 = net.C1
        self.C2 = net.C2
        self.proc = proc
        self.killed = frozenset(net.injected)
        self.failed = frozenset(net.failed)
        self.received = dict(net.received)
        RuntimeError.__init__(
            self,
            f"schedule aborted in round {net.C1 + 1}: processor {proc} was "
            f"killed mid-run (completed prefix C1={net.C1}, C2={net.C2}; "
            f"failed={sorted(net.failed)})")


@dataclass
class RoundNetwork:
    """Validates port constraints and accumulates C1/C2 across schedules.

    `keep_log` enables the per-round `RoundEvent` trace on `round_log`
    (each entry still unpacks as the legacy (n_msgs, m_t) pair); it is off
    by default so long simulations don't grow memory per round.
    `tracer` emits per-round events on per-processor tracks plus
    kill/abort instants to an `obs.trace.Tracer`; it defaults to the
    process-installed tracer (`obs.trace.get_tracer()`, None when tracing
    is off — pass `tracer=False` to silence a network while one is
    installed).
    `fail(procs)` erases processors: they may neither send nor receive, and
    any schedule touching them raises `FailedProcessorError` — repair
    schedules must route around the erasure set (Sec. I fault model).
    `fail_at(round, procs)` registers a *live* kill that fires between
    rounds once C1 reaches `round`; a running schedule that then touches a
    killed processor aborts with `PartialRunError` (see class docstring).
    `received` tracks the field elements delivered to each processor in
    fully-accounted rounds (the received-so-far state a restarted repair
    can inspect).
    `placement` (a `repro_torch.topo.Placement`, duck-typed to avoid the import
    cycle core -> topo -> core) additionally attributes every accounted
    round to a link tier: a round is "inter" if ANY of its messages
    crosses hosts, else "intra" — so the per-tier counters sum exactly to
    C1/C2 by construction.  `by_tier()` reads them back.
    """

    n_procs: int
    p: int = 1
    keep_log: bool = False
    C1: int = 0
    C2: int = 0
    total_elems: int = 0
    placement: object = None
    c1_by_tier: dict = dc_field(default_factory=lambda: {"intra": 0,
                                                         "inter": 0})
    c2_by_tier: dict = dc_field(default_factory=lambda: {"intra": 0,
                                                         "inter": 0})
    round_log: list = dc_field(default_factory=list)
    failed: set = dc_field(default_factory=set)
    received: dict = dc_field(default_factory=dict)
    # live-injection state: pending round -> procs, and everything already
    # killed by injection (distinguishes PartialRunError from the static
    # FailedProcessorError contract)
    pending_kills: dict = dc_field(default_factory=dict, repr=False)
    injected: set = dc_field(default_factory=set, repr=False)
    # obs.trace.Tracer | None | False — resolved once at construction so
    # the per-round hot path is a single attribute check when tracing is
    # off (the zero-overhead-by-default contract)
    tracer: object = dc_field(default=None, repr=False)

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = get_tracer()
        elif self.tracer is False:
            self.tracer = None
        if (self.placement is not None
                and self.placement.n_procs < self.n_procs):
            raise ValueError(
                f"placement covers {self.placement.n_procs} processors, "
                f"network has {self.n_procs}")

    def _check_procs(self, procs) -> set[int]:
        procs = {int(q) for q in procs}
        bad = [q for q in procs if not 0 <= q < self.n_procs]
        if bad:
            raise ValueError(
                f"processors {sorted(bad)} outside [0, {self.n_procs})")
        return procs

    def fail(self, procs) -> None:
        """Mark processors as erased (no sends, no receives, ever after)."""
        procs = self._check_procs(procs)
        if self.tracer is not None:
            for q in sorted(procs - self.failed):
                self.tracer.instant(
                    "fail", pid="simulator", tid=f"proc {q}", cat="sim.fail",
                    args={"round": self.C1, "proc": q})
        self.failed |= procs

    def fail_at(self, round: int, procs) -> None:
        """Register a live kill: `procs` die between rounds, as soon as C1
        reaches `round` (i.e. after `round` rounds have completed).  A
        running schedule that then touches one aborts with
        `PartialRunError`; `round` at or beyond a schedule's length simply
        never fires."""
        procs = self._check_procs(procs)
        if round < 0:
            raise ValueError(f"kill round must be >= 0, got {round}")
        self.pending_kills.setdefault(int(round), set()).update(procs)

    def apply_pending_kills(self) -> set[int]:
        """Fire every registered kill whose round has been reached; returns
        the processors newly killed.  `run` calls this between rounds; a
        repair loop calls it before (re)planning so a kill due exactly at
        the restart boundary enlarges the pattern up front."""
        due = [r for r in self.pending_kills if r <= self.C1]
        fired: set[int] = set()
        for r in due:
            fired |= self.pending_kills.pop(r)
        self.injected |= fired
        self.failed |= fired
        if fired and self.tracer is not None:
            for q in sorted(fired):
                self.tracer.instant(
                    "kill", pid="simulator", tid=f"proc {q}", cat="sim.fail",
                    args={"round": self.C1, "proc": q})
        return fired

    def _account(self, msgs: list[Msg]) -> None:
        tracer = self.tracer
        t0 = tracer.now_us() if tracer is not None else 0.0
        sends: dict[int, int] = {}
        recvs: dict[int, int] = {}
        for m in msgs:
            if not (0 <= m.src < self.n_procs and 0 <= m.dst < self.n_procs):
                raise ValueError(
                    f"message {m.src}->{m.dst} outside the "
                    f"{self.n_procs}-processor network")
            if m.src in self.failed or m.dst in self.failed:
                dead = m.src if m.src in self.failed else m.dst
                # C1 counts *completed* rounds, so the round being executed
                # is round C1 + 1 (1-based)
                raise FailedProcessorError(
                    f"round {self.C1 + 1}: message {m.src}->{m.dst} touches "
                    f"failed processor {dead}", proc=dead)
            sends[m.src] = sends.get(m.src, 0) + 1
            recvs[m.dst] = recvs.get(m.dst, 0) + 1
        over_s = {k: v for k, v in sends.items() if v > self.p}
        over_r = {k: v for k, v in recvs.items() if v > self.p}
        if over_s:
            raise PortViolationError(
                f"port violation (send): {over_s} with p={self.p}")
        if over_r:
            raise PortViolationError(
                f"port violation (recv): {over_r} with p={self.p}")
        m_t = max((m.n_elems for m in msgs), default=0)
        self.C1 += 1
        self.C2 += m_t
        if self.placement is not None:
            host_of = self.placement.host_of
            tier = ("inter" if any(host_of(m.src) != host_of(m.dst)
                                   for m in msgs) else "intra")
            self.c1_by_tier[tier] += 1
            self.c2_by_tier[tier] += m_t
        self.total_elems += sum(m.n_elems for m in msgs)
        for m in msgs:
            self.received[m.dst] = self.received.get(m.dst, 0) + m.n_elems
        if self.keep_log or tracer is not None:
            sent_e: dict[int, int] = {}
            recv_e: dict[int, int] = {}
            for m in msgs:
                sent_e[m.src] = sent_e.get(m.src, 0) + m.n_elems
                recv_e[m.dst] = recv_e.get(m.dst, 0) + m.n_elems
            ev = RoundEvent(self.C1, len(msgs), m_t,
                            tuple(sorted(sent_e.items())),
                            tuple(sorted(recv_e.items())))
            if self.keep_log:
                self.round_log.append(ev)
            if tracer is not None:
                dur = max(tracer.now_us() - t0, 0.001)
                tracer.complete(
                    "round", t0, dur, pid="simulator", tid="rounds",
                    cat="sim.round",
                    args={"round": ev.round, "n_msgs": ev.n_msgs,
                          "m_t": ev.m_t})
                for proc in sorted(set(sent_e) | set(recv_e)):
                    tracer.complete(
                        "round", t0, dur, pid="simulator",
                        tid=f"proc {proc}", cat="sim.proc",
                        args={"round": ev.round, "m_t": ev.m_t,
                              "sent": sent_e.get(proc, 0),
                              "recv": recv_e.get(proc, 0)})

    def run(self, *schedules) -> None:
        """Advance all schedules in lockstep until all are exhausted.

        A schedule that finishes early simply idles (its processors wait,
        Sec. III-B). Rounds where *no* schedule sends anything are free.
        Registered `fail_at` kills fire between rounds; if the next round
        then touches a killed processor, the run aborts with a
        `PartialRunError` snapshot (the aborted round is not accounted).
        """
        gens = [iter(s) for s in schedules]
        while gens:
            self.apply_pending_kills()
            round_msgs: list[Msg] = []
            alive = []
            for g in gens:
                try:
                    round_msgs.extend(next(g))
                    alive.append(g)
                except StopIteration:
                    pass
            gens = alive
            if round_msgs:
                try:
                    self._account(round_msgs)
                except FailedProcessorError as exc:
                    if (not isinstance(exc, PartialRunError)
                            and exc.proc in self.injected):
                        if self.tracer is not None:
                            self.tracer.instant(
                                "abort", pid="simulator",
                                tid=f"proc {exc.proc}", cat="sim.fail",
                                args={"round": self.C1, "proc": exc.proc})
                        raise PartialRunError(self, exc.proc) from exc
                    raise
            elif gens:
                # a schedule yielded an empty round (local-compute round):
                # does not consume network time in the linear cost model
                continue

    def by_tier(self) -> dict:
        """Measured per-tier accounting: {"intra": (C1, C2), "inter":
        (C1, C2)} under the network's placement (empty without one).  The
        tier entries sum exactly to the flat C1/C2."""
        if self.placement is None:
            return {}
        return {t: (self.c1_by_tier[t], self.c2_by_tier[t])
                for t in ("intra", "inter")}

    def cost(self, alpha: float, beta_bits: float) -> float:
        """C = alpha*C1 + (beta*ceil(log2 q))*C2 with beta_bits = beta*log2q."""
        return alpha * self.C1 + beta_bits * self.C2


@dataclass
class FaultInjector:
    """Driver for round-granular failure injection on a `RoundNetwork`.

    Wraps `net.fail_at` with a plan the caller can inspect: `kill_at`
    registers one kill, `random_kills` draws up to `n_kills` distinct
    victims at random round boundaries (the chaos-testing entry point —
    `launch/serve.py --chaos` builds its schedule here).  `plan` lists the
    registered (round, proc) pairs in registration order.
    """

    net: RoundNetwork
    plan: list = dc_field(default_factory=list)

    def kill_at(self, round: int, procs) -> "FaultInjector":
        self.net.fail_at(round, procs)
        procs = procs if hasattr(procs, "__iter__") else (procs,)
        self.plan.extend((int(round), int(q)) for q in procs)
        return self

    def random_kills(self, rng, candidates, n_kills: int,
                     max_round: int) -> list[tuple[int, int]]:
        """Register up to `n_kills` kills of distinct processors drawn from
        `candidates`, each at a uniform round in [0, max_round]; returns
        the registered (round, proc) pairs."""
        candidates = [int(q) for q in candidates]
        n = min(int(n_kills), len(candidates))
        victims = rng.choice(candidates, size=n, replace=False) if n else []
        out = []
        for v in victims:
            r = int(rng.integers(0, max_round + 1))
            self.kill_at(r, (int(v),))
            out.append((r, int(v)))
        return out


def run_lockstep(*gens):
    """Merge several round-schedules into one (their rounds align 1:1).

    Used for nested parallelism: e.g. each DFT stage runs K/P parallel P-sized
    prepare-and-shoot instances; the stage is itself one schedule.
    """
    iters = [iter(g) for g in gens]
    for rounds in itertools.zip_longest(*iters, fillvalue=None):
        merged: list[Msg] = []
        for r in rounds:
            if r:
                merged.extend(r)
        yield merged
