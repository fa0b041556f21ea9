"""The session API in three lines: open a coded system, survive failures,
serve traffic.

    system = CodedSystem(CodeSpec(kind="rs", K=16, R=4), backend="local")
    system.fail([2, 17])
    x2 = system.read(cw)          # degraded read, auto-replanned

Walks one `CodedSystem` through its lifecycle — healthy encode, failures,
degraded reads (bitwise-exact), repair of exactly the lost symbols, full
`rebuild` back to health, and batched future-based submission — and
cross-checks the simulator oracle against the local kernel backend at
every step.  Then the multi-tenant layer: a `CodedService` pooling two
tenants' sessions behind one shared coding queue — cross-session
coalescing, per-tenant admission quotas, a degraded tenant, and the
per-tenant serving stats.

The port of `examples/coded_system_demo.py` on `repro_torch`: the local
backend's kernels run on `--device` (default the card; `--device cpu`
runs their plain versions).
"""
import argparse
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.api import CodedSystem, CodeSpec
from repro_torch.api.registry import resolve_device
from repro_torch.core.field import FERMAT
from repro_torch.launch.service import CodedService, TenantQuota

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args().device)

    K, R, W = 16, 4, 256
    x = FERMAT.rand((K, W), np.random.default_rng(0))

    system = CodedSystem(CodeSpec(kind="rs", K=K, R=R, W=W), backend="local",
                         device=device)
    oracle = CodedSystem(CodeSpec(kind="rs", K=K, R=R, W=W),
                         backend="simulator")

    cw = system.codeword(x)                      # [x | parity], (K+R, W)
    assert np.array_equal(cw, oracle.codeword(x)), "backends disagree"
    print(f"healthy: encoded {K} shards + {R} parity "
          f"(local kernel == simulator bitwise)")

    lost = [2, 7, K + 1]                         # two data shards + a parity
    system.fail(lost)
    oracle.fail(lost)
    print(f"failed  : {list(system.failed)} "
          f"(kept survivors: {list(system.kept)})")

    x2 = system.read(cw)                         # degraded read
    assert np.array_equal(x2, x % FERMAT.q)
    assert np.array_equal(x2, oracle.read(cw))
    repaired = system.decode(cw)                 # just the lost symbols
    assert np.array_equal(repaired, cw[sorted(lost)])
    print(f"degraded: full read + {len(lost)}-symbol repair bitwise-exact; "
          f"decode model cost {oracle.stats()['decode']['model_us']:.1f} us")

    healed = system.rebuild(cw)                  # re-materialize + heal()
    assert np.array_equal(healed, cw)
    assert np.array_equal(healed, oracle.rebuild(cw))
    assert system.failed == () == oracle.failed
    print("rebuilt : all lost symbols recomputed, codeword fully healed "
          "(local == simulator bitwise)")

    fut = system.submit("encode", x)             # batched queue path
    assert np.array_equal(fut.result(timeout=60), cw[K:])
    system.close()
    print("healed  : encode again via system.submit — parity unchanged")
    print()
    print(system.describe())

    # -- traced pass: the observability layer -----------------------------
    #
    # trace= captures every layer onto ONE Chrome trace-event timeline —
    # per-processor simulator round tracks, fail/kill instants, kernel
    # spans — loadable in ui.perfetto.dev.  Alongside it, the drift
    # ledger cross-checks every simulator-backed run against the
    # closed-form cost model, bit for bit.
    import tempfile

    trace_path = str(Path(tempfile.gettempdir()) / "coded_system_trace.json")
    traced = CodedSystem(CodeSpec(kind="rs", K=K, R=R, W=W),
                         backend="simulator", trace=trace_path)
    cw3 = traced.codeword(x)                     # rounds land on the tracer
    traced.fail([3, K + 2])                      # fail instants, per proc
    assert np.array_equal(traced.read(cw3), x % FERMAT.q)
    healed3 = traced.rebuild(cw3)                # repair rounds + heal
    assert np.array_equal(healed3, cw3)
    rounds = traced.tracer.events(cat="sim.round")
    st = traced.stats()
    traced.close()                               # writes the trace JSON
    print()
    print(f"traced  : fail -> read -> heal captured as {len(rounds)} round "
          f"events on per-processor tracks -> {trace_path}")
    print(f"          drift ledger: {st['drift']['exact']}/"
          f"{st['drift']['runs']} simulator runs exact vs the closed-form "
          "cost model")

    # -- hierarchical topology: place the code on a 5x4 fleet -------------
    #
    # A Topology tells the simulator which processors share a host; the
    # affinity policy packs each prepare-and-shoot group onto one host so
    # the heavy phase-one traffic stays intra-host, while the flat
    # round-robin strawman pushes every round onto the network.  Outputs
    # are bitwise-identical either way (Remark 1) — only the per-tier
    # split of the SAME (C1, C2) moves, and the measured split matches
    # the closed form exactly.
    from repro_torch.api import TieredLinkModel, Topology

    print()
    link = TieredLinkModel.from_ratio(4.0)       # inter links 4x pricier
    tiered = {}
    for policy in ("affinity", "flat"):
        sys_t = CodedSystem(CodeSpec(kind="rs", K=K, R=R, W=W),
                            backend="simulator",
                            topology=Topology(hosts=5, devices_per_host=4),
                            placement=policy, link=link)
        assert np.array_equal(sys_t.codeword(x), cw)   # placement-invariant
        tiers = sys_t.stats()["encode"]["tiers"]
        model = {t: (c.C1, c.C2) for t, c in tiers["model"].items()}
        assert tiers["measured"] == model, "per-tier model must be exact"
        tiered[policy] = tiers
        print(f"topo    : {policy:8s} intra C2={model['intra'][1]:6d} "
              f"inter C2={model['inter'][1]:6d} "
              f"-> {tiers['model_us']:.1f} us at 4x inter cost")
    assert (tiered["affinity"]["model"]["inter"].C2
            < tiered["flat"]["model"]["inter"].C2)
    print("topo    : affinity keeps phase-1 traffic on-host — "
          "same codeword, cheaper network")

    # -- the multi-tenant layer: two tenants, one service -----------------
    #
    # A CodedService pools CodedSystem sessions behind ONE shared coding
    # queue: requests that share a plan — same (spec, backend, A-digest) —
    # coalesce into a single batched execution even when they come from
    # DIFFERENT tenants' sessions, while each future resolves to its own
    # rows.  Admission is quota-bounded per tenant; nothing is silently
    # dropped.
    print()
    spec = CodeSpec(kind="rs", K=K, R=R, W=W)
    with CodedService(backend="local", device=device) as svc:
        # acme pays for more capacity: deeper in-flight quota, 2x fair
        # share under contention
        svc.set_quota("acme", TenantQuota(max_inflight_ops=128, weight=2.0))

        futs = []
        lock = threading.Lock()

        def tenant_client(tenant: str, seed: int) -> None:
            r = np.random.default_rng(seed)
            for _ in range(8):
                xt = FERMAT.rand((K, W), r)
                f = svc.submit(tenant, spec, "encode", xt, tag="hot-volume")
                with lock:
                    futs.append((xt, f))

        clients = [threading.Thread(target=tenant_client, args=(t, i))
                   for i, t in enumerate(["acme", "zeta"])]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        check = CodedSystem(spec, backend="local", device=device)
        for xt, f in futs:
            assert np.array_equal(f.result(timeout=60),
                                  check.codeword(xt)[K:])
        ratio = svc.stats()["service"]["coalescing_ratio"]
        print(f"service : {len(futs)} encodes from 2 tenants coalesced "
              f"{ratio:.2f}x across sessions, every future bitwise-exact")

        # zeta's volume degrades; its session's erasure state steers every
        # decode the service routes there — acme is unaffected
        zeta = svc.session("zeta", spec)
        zeta.fail([1, K + 2])
        cw2 = check.codeword(x)
        got = svc.submit("zeta", spec, "decode", cw2).result(timeout=60)
        assert np.array_equal(got, cw2[[1, K + 2]])
        print(f"service : zeta degraded {list(zeta.failed)} — repair "
              "through the shared queue, bitwise-exact")
        print()
        print(svc.describe())
