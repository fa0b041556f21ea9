"""Serving launcher: batched greedy decode behind a coded self-check of the
parameters; the port of `repro/launch/serve.py`.

    python -m repro_torch.launch.serve --arch qwen3_1_7b --coded-selfcheck
    python -m repro_torch.launch.serve --device cpu --queue-demo 2

The request path (prompt -> teacher-forced prompt consumption -> KV-cached
greedy decode) runs on `--device` (default "cuda", which raises without a
card; "cpu" runs everything there, the kernels as their plain versions).
The CLI serves the arch's reduced `.smoke()` config, as the JAX CLI does;
`serve(cfg, model, prompt, gen_len)` is the same decode loop for any
config (`chip_smoke.py` serves Qwen3-1.7B at full width through it).

`--coded-selfcheck` first runs the parameters through a
`repro_torch.api.CodedSystem` session: `to_reference` gives the JAX
package's tree, `tree_to_bytes` its bytes (the JAX package's, byte for
byte, for the same weights), whose 16-bit symbols are cut into shards,
RS-parity-encoded (`system.codeword`: the NTT kernel at rs 8/2), R shards
dropped and recovered, and checked bitwise.  Recovery is the host solve
(`core.parity.reconstruct` -> `kernels.gf_solve`, whose apply step is the
`gf_matmul` kernel), or with `--degraded` the session's cached
`DecodePlan` (the `gf_matmul` kernel).

`--queue-demo N`, `--service N` and `--chaos R,SEED` are the JAX
launcher's coding-queue, multi-tenant and failure-injection scenarios on
`--device`, each result self-checked bitwise; `--trace OUT.json` saves a
Chrome trace-event timeline of the run, `--metrics` prints the metrics
registry at exit."""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch


def _chaos_demo(max_kills: int, seed: int, n_shards: int,
                n_parity: int, device=None) -> None:
    import numpy as np

    from ..api import CodedSystem, CodeSpec
    from ..core.field import FERMAT
    from ..core.simulator import FaultInjector, RoundNetwork
    from ..recover import repair_with_faults

    max_kills = max(1, min(int(max_kills), n_parity))
    rng = np.random.default_rng(seed)
    spec = CodeSpec(kind="rs", K=n_shards, R=n_parity)
    x = FERMAT.rand((n_shards, 128), rng)
    system = CodedSystem(spec, backend="local", device=device)
    cw = system.codeword(x)

    # -- leg 1: mid-schedule kills on the round network -------------------
    first = int(rng.integers(0, spec.N))
    net = RoundNetwork(spec.N, spec.p)
    inj = FaultInjector(net)
    # small-K repair schedules run only a handful of rounds — keep the
    # injection window inside them so kills actually land mid-schedule
    kills = inj.random_kills(rng, [i for i in range(spec.N) if i != first],
                             max_kills - 1, max_round=2)
    report = repair_with_faults(spec, cw, erased=(first,), net=net)
    assert np.array_equal(report.codeword, cw), "chaos repair mismatch"
    assert net.C1 == sum(a.C1 for a in report.attempts), "C1 accounting"
    assert net.C2 == sum(a.C2 for a in report.attempts), "C2 accounting"
    print(f"chaos mid-schedule OK: kill {{{first}}} at start + injected "
          f"{kills or 'none'}; {report.restarts} restart(s) across "
          f"{len(report.attempts)} attempt(s), final |E|="
          f"{len(report.erased)}, exact C1={net.C1} C2={net.C2} (bitwise)")

    # -- leg 2: random fail()s racing queued submissions ------------------
    futs = []
    for _ in range(6 * max_kills):
        roll = rng.random()
        if roll < 0.35 and len(system.failed) < n_parity:
            alive = [i for i in range(spec.N) if i not in system.failed]
            system.fail(int(rng.choice(alive)))
        elif roll < 0.55:
            futs.append(("encode", None, system.submit("encode", x)))
        elif roll < 0.80:
            futs.append(("decode", system.failed,
                         system.submit("decode", cw)))
        else:
            futs.append(("rebuild", None, system.submit("rebuild", cw)))
    for op, pinned, fut in futs:
        got = fut.result(timeout=120)
        ref = (cw[n_shards:] if op == "encode"
               else cw[list(pinned)] if op == "decode" else cw)
        assert np.array_equal(got, ref), f"queued {op} self-check failed"
    stats = system.stats()
    healed = system.rebuild(cw)
    assert np.array_equal(healed, cw) and system.failed == (), "rebuild"
    qs = stats.get("queue")
    system.close()
    print(f"chaos serving OK: {len(futs)} queued ops under "
          f"{len(stats['failed'])} live failures "
          f"({qs.failovers if qs else 0} superset failover(s)); "
          "rebuild -> healed, all bitwise")

    # -- leg 3: chaos UNDER multi-tenant service load ---------------------
    from .service import CodedService

    with CodedService(backend="local", device=device) as svc:
        tens = []
        for t in range(2):
            name = f"tenant{t}"
            xt = FERMAT.rand((n_shards, 64), rng)
            sess = svc.session(name, spec)
            tens.append((name, sess, xt, sess.codeword(xt)))
        sfuts = []
        for _ in range(12 * max_kills):
            name, sess, xt, cwt = tens[int(rng.integers(2))]
            roll = rng.random()
            if roll < 0.3 and len(sess.failed) < n_parity:
                alive = [i for i in range(spec.N) if i not in sess.failed]
                sess.fail(int(rng.choice(alive)))
            elif roll < 0.6:
                sfuts.append(("encode", None, cwt,
                              svc.submit(name, spec, "encode", xt)))
            elif roll < 0.85:
                sfuts.append(("decode", sess.failed, cwt,
                              svc.submit(name, spec, "decode", cwt)))
            else:
                sfuts.append(("rebuild", None, cwt,
                              svc.submit(name, spec, "rebuild", cwt)))
        for op, pinned, cwt, fut in sfuts:
            got = fut.result(timeout=120)
            ref = (cwt[n_shards:] if op == "encode"
                   else cwt[list(pinned)] if op == "decode" else cwt)
            assert np.array_equal(got, ref), f"service {op} self-check"
        sstats = svc.stats()["service"]
        print(f"chaos service OK: {len(sfuts)} ops across 2 tenants' "
              f"sessions under live kills (coalescing "
              f"{sstats['coalescing_ratio']:.2f}x, "
              f"{sstats['failovers']} failover(s)), all bitwise")


def _service_demo(n_requests: int, n_shards: int, n_parity: int,
                  device=None) -> None:
    """Multi-tenant serving demo: two tenants drive one `CodedService`
    from concurrent clients — same spec, so their encodes coalesce across
    sessions — one tenant degraded mid-run; everything verified bitwise
    and the per-tenant serving stats printed (`service.describe()`)."""
    import threading

    import numpy as np

    from ..api import CodedSystem, CodeSpec
    from ..core.field import FERMAT
    from .service import CodedService, TenantQuota

    spec = CodeSpec(kind="rs", K=n_shards, R=n_parity)
    ref = CodedSystem(spec, backend="local", device=device)
    with CodedService(backend="local", device=device) as svc:
        svc.set_quota("acme", TenantQuota(max_inflight_ops=32, weight=2.0))
        futs: list[tuple[np.ndarray, object]] = []
        lock = threading.Lock()

        def client(tenant: str, seed: int) -> None:
            r = np.random.default_rng(seed)
            for _ in range(n_requests):
                x = FERMAT.rand((n_shards, 64), r)
                f = svc.submit(tenant, spec, "encode", x, tag=f"{tenant}/v0")
                with lock:
                    futs.append((ref.codeword(x)[n_shards:], f))

        threads = [threading.Thread(target=client, args=(t, 50 + i))
                   for i, t in enumerate(["acme", "zeta"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for want, fut in futs:
            assert np.array_equal(fut.result(timeout=120), want), \
                "service encode self-check failed"
        # one tenant degrades; its decode rides the same shared queue
        x = FERMAT.rand((n_shards, 64), np.random.default_rng(99))
        cw = ref.codeword(x)
        svc.session("zeta", spec).fail(range(n_parity))
        got = svc.submit("zeta", spec, "decode", cw).result(timeout=120)
        assert np.array_equal(got, cw[: n_parity]), "degraded read failed"
        print(svc.describe())
        print(f"service demo OK: {len(futs)} encodes from 2 tenants + 1 "
              "degraded read, all bitwise")


def _queue_demo(n_requests: int, n_shards: int, n_parity: int,
                device=None) -> None:
    import threading

    import numpy as np

    from ..api import CodedSystem, CodeSpec
    from ..core.field import FERMAT

    # one session handle: erasure state + both planners + the coalescing
    # queue behind system.submit (previously hand-wired plans + CodingQueue)
    system = CodedSystem(CodeSpec(kind="rs", K=n_shards, R=n_parity),
                         backend="local", device=device)
    system.fail(range(n_parity))  # worst case: first R data shards lost
    enc_plan, dec_plan = system.encode_plan, system.decode_plan

    futs: list[tuple[str, np.ndarray, object]] = []
    lock = threading.Lock()

    def client(seed: int) -> None:
        r = np.random.default_rng(seed)
        x = FERMAT.rand((n_shards, int(r.integers(64, 512))), r)
        fe = system.submit("encode", x)
        full = system.codeword(x)
        v = full[list(system.kept)]
        fd = system.submit("decode", v)
        with lock:
            futs.append(("encode", x, fe))
            futs.append(("decode", v, fd))

    threads = [threading.Thread(target=client, args=(1000 + i,))
               for i in range(n_requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for op, payload, fut in futs:
        got = fut.result(timeout=120)
        ref = (enc_plan if op == "encode" else dec_plan).run(payload)
        assert np.array_equal(got, ref), f"queued {op} != direct run"
    stats = system.stats()
    system.close()
    s = stats["queue"]
    print(f"coding queue OK: {s.requests} requests in {s.batches} batched "
          f"plan executions (max coalesced {s.max_coalesced}); "
          f"encode path: {enc_plan.local_impl}")


def _span(name: str):
    """A span on the installed tracer's "selfcheck" track (free without a
    tracer)."""
    from ..obs.trace import host_span

    return host_span(name, "selfcheck", cat="selfcheck")


def _param_shards(raw: np.ndarray, n_shards: int) -> np.ndarray:
    """The (n_shards, L) int64 symbol shards of a byte stream: its 16-bit
    little-endian symbols (a last odd byte as its own symbol), zero-padded
    to a multiple of n_shards: what the JAX launcher builds with
    `bytes_to_symbols` and a concatenation, without the int64 copy of
    every symbol between the two (13.8 GB for Qwen3-1.7B)."""
    n_sym = -(-raw.size // 2)
    L = -(-n_sym // n_shards)
    flat = np.zeros(n_shards * L, np.int64)
    even = raw.size // 2
    flat[:even] = raw[:2 * even].view("<u2")
    if raw.size % 2:
        flat[even] = raw[-1]
    return flat.reshape(n_shards, L)


def _coded_selfcheck(params, n_shards: int, n_parity: int,
                     degraded: bool = False, device=None) -> np.ndarray:
    """Shard the parameter tree's bytes, encode, lose the first R shards,
    recover them, check bitwise; returns the (N, L) codeword."""
    from ..api import CodedSystem, CodeSpec
    from ..ckpt.checkpoint import tree_to_bytes
    from ..core.field import FERMAT

    if n_shards % n_parity:
        raise SystemExit(
            f"--coded-parity must divide --coded-shards (Remark 4): "
            f"got {n_shards} shards, {n_parity} parity")
    with _span("tree_to_bytes"):
        raw, _ = tree_to_bytes(params)
    with _span("shard_symbols"):
        shards = _param_shards(raw, n_shards)
    del raw

    system = CodedSystem(CodeSpec(kind="rs", K=n_shards, R=n_parity),
                         backend="local", device=device)
    with _span("codeword"):
        full = system.codeword(shards)  # [shards | parity]

    # worst case: the first R data shards are lost; recover from parity
    erased = tuple(range(n_parity))
    if degraded:
        system.fail(erased)
        print(system.describe())
        with _span("decode"):
            repaired = system.decode(full)
        if not np.array_equal(repaired, shards[:n_parity]):
            raise AssertionError("degraded self-check failed (repair)")
        del repaired
        with _span("read"):
            rec = system.read(full)
        system.heal()
    else:
        from ..core.parity import reconstruct

        print(system.describe())
        kept = np.arange(n_parity, n_shards + n_parity)
        with _span("reconstruct"):
            rec = reconstruct(FERMAT, system.encode_plan.sgrs, kept,
                              full[kept], device=device)
    if not np.array_equal(rec, shards):
        raise AssertionError("coded self-check failed")
    mode = "degraded DecodePlan" if degraded else "host solve"
    print(f"coded self-check OK ({mode}): {n_shards} param shards + "
          f"{n_parity} parity, recovered {n_parity} lost shards bitwise")
    return full


@dataclass
class ServeResult:
    """What `serve` returns: the (B, S + gen) tokens, the (B, S + gen - 1,
    V) logits of every decode step, and the loop's wall time (ending in a
    device synchronise on a card)."""

    tokens: torch.Tensor
    logits: torch.Tensor
    steps: int
    wall_s: float

    @property
    def ms_per_token(self) -> float:
        """Wall time of one decode step (one token of every sequence)."""
        return self.wall_s / self.steps * 1e3

    @property
    def tokens_per_s(self) -> float:
        """Tokens through the model per second, prompt tokens included
        (each takes one decode step)."""
        return self.tokens.shape[0] * self.steps / self.wall_s


def serve(cfg, model, prompt: torch.Tensor, gen_len: int) -> ServeResult:
    """Greedy decode of `gen_len` tokens after `prompt` (B, S) on the
    prompt's device: the JAX launcher's serving loop, cache length
    S + gen_len + 1."""
    from ..train.serve import greedy_generate

    S = prompt.shape[1]
    cuda = prompt.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(prompt.device)
    t0 = time.perf_counter()
    tokens, logits = greedy_generate(cfg, model, prompt, gen_len,
                                     max_len=S + gen_len + 1,
                                     return_logits=True)
    if cuda:
        torch.cuda.synchronize(prompt.device)
    return ServeResult(tokens, logits, S + gen_len - 1,
                       time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_780m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the coding "
                         "sessions; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--coded-selfcheck", action="store_true",
                    help="verify params survive R lost shards via RS parity")
    ap.add_argument("--degraded", action="store_true",
                    help="recover the self-check erasures via the decode "
                         "subsystem (DecodePlan) instead of the host solve")
    ap.add_argument("--coded-shards", type=int, default=8)
    ap.add_argument("--coded-parity", type=int, default=2)
    ap.add_argument("--queue-demo", type=int, default=0, metavar="N",
                    help="drive the batched coding queue with N concurrent "
                         "encode+decode clients and verify bitwise")
    ap.add_argument("--service", type=int, default=0, metavar="N",
                    help="multi-tenant CodedService demo: two tenants x N "
                         "coalescing encodes + a degraded read, verified "
                         "bitwise, per-tenant stats printed")
    ap.add_argument("--chaos", default=None, metavar="R,SEED",
                    help="failure-injection scenario: kill up to R "
                         "processors at random rounds while serving queued "
                         "encodes/decodes/rebuilds, self-check bitwise")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="capture a Chrome trace-event timeline of the whole "
                         "run (stream pipeline, queue/service ops, kernels, "
                         "the self-check's stages)")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the unified metrics registry (text "
                         "exposition format) at exit")
    args = ap.parse_args(argv)
    if args.degraded and not args.coded_selfcheck:
        ap.error("--degraded modifies the self-check; pass --coded-selfcheck")
    from ..api.registry import resolve_device

    device = resolve_device(args.device)  # raises without a card
    tracer = None
    if args.trace:
        from ..obs import trace as _trace

        tracer = _trace.install(_trace.Tracer())
    try:
        _run(args, ap, device)
    finally:
        if tracer is not None:
            from ..obs import trace as _trace

            _trace.uninstall(tracer)
            print(f"trace   : {len(tracer)} events -> "
                  f"{tracer.save(args.trace)}")
        if args.metrics:
            from ..obs.metrics import REGISTRY

            print(REGISTRY.render_text(), end="")


def _run(args, ap, device):
    if args.chaos:
        try:
            kills, seed = (int(t) for t in args.chaos.split(","))
        except ValueError:
            ap.error("--chaos expects R,SEED (e.g. --chaos 3,7)")
        _chaos_demo(kills, seed, args.coded_shards, args.coded_parity, device)
    if args.queue_demo:
        _queue_demo(args.queue_demo, args.coded_shards, args.coded_parity,
                    device)
    if args.service:
        _service_demo(args.service, args.coded_shards, args.coded_parity,
                      device)

    from ..configs import get_config
    from ..models import model as M
    from ..models.convert import to_reference

    cfg = get_config(args.arch).smoke()
    model = M.init_params(cfg, torch.Generator(device).manual_seed(0), device)
    if args.coded_selfcheck:
        _coded_selfcheck(to_reference(model), args.coded_shards,
                         args.coded_parity, degraded=args.degraded,
                         device=device)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    res = serve(cfg, model, prompt, args.gen_len)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} batch={args.batch} generated {args.gen_len} "
          f"tokens/seq @ {res.ms_per_token:.1f} ms/token ({where}, reduced "
          "config)")
    print("sample token ids:",
          res.tokens[0, args.prompt_len:args.prompt_len + 12].tolist())


if __name__ == "__main__":
    main()
