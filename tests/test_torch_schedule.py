"""The port's schedule IR, simulator backend, `describe`/`stats` and
`repair_with_faults` against the JAX package's, on the CPU.

Same seeded numpy inputs through `repro` and `repro_torch`: golden
digests, IR passes, simulator values and measured C1/C2 must be equal,
with no tolerance."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.api import CodedSystem as JSystem
from repro.api import CodeSpec as JSpec
from repro.api import Encoder as JEncoder
from repro.api.planner import _ir_tiered_cost as j_ir_tiered_cost
from repro.core.schedule import build_encode_ir as j_build_encode_ir
from repro.core.simulator import FaultInjector as JFaultInjector
from repro.core.simulator import RoundNetwork as JNet
from repro.obs import drift as jdrift
from repro.recover import Decoder as JDecoder
from repro.recover import repair_with_faults as j_repair
from repro.topo import Placement as JPlacement
from repro.topo import TieredLinkModel as JLink
from repro.topo import Topology as JTopology
from repro.topo import place as jplace
from repro_torch.api import CodedSystem as TSystem
from repro_torch.api import CodeSpec as TSpec
from repro_torch.api import Encoder as TEncoder
from repro_torch.api.planner import _ir_tiered_cost as t_ir_tiered_cost
from repro_torch.core.schedule import (Round, ScheduleValidationError, Send,
                                       build_encode_ir, execute)
from repro_torch.core.simulator import FaultInjector, RoundNetwork
from repro_torch.obs import drift as tdrift
from repro_torch.recover import Decoder as TDecoder
from repro_torch.recover import repair_with_faults
from repro_torch.topo import Placement, TieredLinkModel, Topology, place

torch.set_num_threads(1)

Q = 65537

# the golden digests of the JAX package's tests/test_schedule.py
GOLDEN = [
    (("universal", 9, 3), {"p": 2, "seed": 9}, "a645678176d4450d"),
    (("rs", 16, 4), {}, "e723afc227cffff8"),
    (("dft", 8, 8), {}, "8aa9988febd2caf0"),
    (("universal", 4, 2), {"seed": 5}, "46a783700fbdcd0c"),
    (("dft", 4, 4), {}, "8d4e2a7f2debde99"),
]
ALL_KINDS = [(("universal", 6, 3), {"seed": 1}), (("rs", 8, 4), {}),
             (("lagrange", 9, 3), {}), (("dft", 8, 8), {})]


def _pair(args, kw=None):
    kw = kw or {}
    return JSpec(*args, **kw), TSpec(*args, **kw)


def _counts(cost):
    return cost.C1, cost.C2


# ---------------------------------------------------------------------------
# golden digests, coefficient matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw,want", GOLDEN,
                         ids=[f"{a[0]}-{a[1]}-{a[2]}" for a, _, _ in GOLDEN])
def test_golden_digest_matches_reference(args, kw, want):
    js, ts = _pair(args, kw)
    ir = build_encode_ir(ts).validate()
    assert ir.digest() == want == j_build_encode_ir(js).digest()
    assert TEncoder.plan(ts, backend="simulator").schedule_ir().digest() == \
        JEncoder.plan(js, backend="simulator").schedule_ir().digest()
    assert ir.summary() == j_build_encode_ir(js).summary()


@pytest.mark.parametrize("args,kw", [(("rs", 6, 3), {}), (("lagrange", 8, 4), {}),
                                     (("universal", 5, 7), {"seed": 2}),
                                     (("dft", 8, 8), {})],
                         ids=lambda a: str(a))
def test_encode_coeff_matrix_is_A_T(args, kw):
    js, ts = _pair(args, kw)
    plan = TEncoder.plan(ts, backend="simulator")
    cm = plan.schedule_ir().coeff_matrix(plan.field)
    assert np.array_equal(cm, plan.A.T % ts.q)
    jplan = JEncoder.plan(js, backend="simulator")
    assert np.array_equal(cm, jplan.schedule_ir().coeff_matrix(jplan.field))


def test_decode_coeff_matrix_is_D_T_and_matches_reference():
    js, ts = _pair(("rs", 8, 4))
    plan = TDecoder.plan(ts, erased=[1, 5, 9], backend="simulator")
    ir = plan.schedule_ir()
    assert np.array_equal(ir.coeff_matrix(plan.field), plan.D.T % ts.q)
    jplan = JDecoder.plan(js, erased=[1, 5, 9])
    assert ir.digest() == jplan.schedule_ir().digest()
    empty = TDecoder.plan(ts, erased=[], backend="simulator").schedule_ir()
    assert empty.rounds == () and empty.cost() == (0, 0)


# ---------------------------------------------------------------------------
# validate(): positive sweep + mutation rejection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", ALL_KINDS, ids=lambda a: str(a))
def test_validate_passes_both_planners(args, kw):
    _, ts = _pair(args, kw)
    TEncoder.plan(ts, backend="simulator").schedule_ir().validate()
    erased = [ts.K + 1] if ts.kind != "dft" else [2]
    TDecoder.plan(ts, erased=erased, backend="simulator").schedule_ir().validate()


def _first_send_round(ir):
    return next(i for i, r in enumerate(ir.rounds) if r.sends)


def _mutate_round(ir, i, rnd):
    rounds = list(ir.rounds)
    rounds[i] = rnd
    return replace(ir, rounds=tuple(rounds))


def test_validate_rejects_port_violation():
    ir = build_encode_ir(TSpec("rs", 8, 4)).validate()
    i = _first_send_round(ir)
    r = ir.rounds[i]
    bad = _mutate_round(ir, i, replace(r, sends=r.sends + (r.sends[0],)))
    with pytest.raises(ScheduleValidationError, match="port violation"):
        bad.validate()


def test_validate_rejects_phantom_packet():
    ir = build_encode_ir(TSpec("rs", 8, 4)).validate()
    i = _first_send_round(ir)
    r = ir.rounds[i]
    s = r.sends[0]
    ghost = Send(s.src, s.dst, (ir.n_packets + 7,))
    bad = _mutate_round(ir, i, Round((ghost,) + r.sends[1:], r.combines,
                                     r.tag))
    with pytest.raises(ScheduleValidationError, match="before creation"):
        bad.validate()


def test_validate_rejects_misplaced_sender():
    ir = build_encode_ir(TSpec("rs", 8, 4)).validate()
    i = _first_send_round(ir)
    r = ir.rounds[i]
    s = r.sends[0]
    thief = next(g for g in range(ir.n_procs)
                 if g not in (s.src, s.dst)
                 and all(g not in (o.src, o.dst) for o in r.sends))
    bad = _mutate_round(ir, i, replace(
        r, sends=(Send(thief, s.dst, s.packets),) + r.sends[1:]))
    with pytest.raises(ScheduleValidationError,
                       match="not at sender|port violation"):
        bad.validate()


def test_validate_rejects_failed_processor_touch():
    plan = TDecoder.plan(TSpec("rs", 8, 4), erased=[3], backend="simulator")
    ir = plan.schedule_ir()
    ir.validate(failed={3})
    with pytest.raises(ScheduleValidationError, match="failed processor"):
        ir.validate(failed={3, plan.kept[0]})


# ---------------------------------------------------------------------------
# the simulator backend: values and measured C1/C2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", ALL_KINDS + [(("rs", 16, 4), {})],
                         ids=lambda a: str(a))
def test_simulator_values_and_costs_match_reference(args, kw):
    js, ts = _pair(args, kw)
    tp = TEncoder.plan(ts, backend="simulator")
    jp = JEncoder.plan(js, backend="simulator")
    assert tp.device is None                 # host-only: no device
    x = np.random.default_rng(ts.K).integers(0, Q, (ts.K, 5))
    y = tp.run(x)
    assert np.array_equal(y, jp.run(x))
    assert np.array_equal(y, TEncoder.plan(ts, backend="local",
                                           device="cpu").run(x))
    assert _counts(tp.last_stats) == _counts(jp.last_stats)
    c = tp.cost()
    assert _counts(tp.last_stats) == (c.C1, c.C2 * 5)
    assert tp.sim_net.C1 == jp.sim_net.C1
    # decode among the survivors, erased processors failed
    erased = (1, ts.K) if ts.kind != "dft" else (2, 9)
    td = TDecoder.plan(ts, erased=erased, backend="simulator")
    jd = JDecoder.plan(js, erased=erased, backend="simulator")
    v = np.concatenate([x % Q, y])[list(td.kept)]
    got = td.run(v)
    assert np.array_equal(got, jd.run(v))
    assert _counts(td.last_stats) == _counts(jd.last_stats)
    assert _counts(td.last_stats) == (td.cost().C1, td.cost().C2 * 5)
    assert np.array_equal(td.data(v), x % Q)     # host matmul: no device


def test_simulator_session_has_zero_drift_and_matches_reference():
    tdrift.LEDGER.reset()
    jdrift.LEDGER.reset()
    out = []
    for Sys, Spec, kw in ((JSystem, JSpec, {}), (TSystem, TSpec, {})):
        s = Sys(Spec("rs", 16, 4), backend="simulator", **kw)
        x = np.random.default_rng(1).integers(0, Q, (16, 6))
        cw = s.codeword(x)
        s.fail([2, 17])
        lost = cw.copy()
        lost[[2, 17]] = 0
        out.append((cw, s.read(lost), s.rebuild(lost), s.describe()))
    (jcw, jx, jh, jd), (tcw, tx, th, td) = out
    assert np.array_equal(tcw, jcw) and np.array_equal(tx, jx)
    assert np.array_equal(th, jh) and np.array_equal(th, tcw)
    assert td == jd
    assert tdrift.LEDGER.drifted() == []
    assert tdrift.LEDGER.describe() == jdrift.LEDGER.describe()
    tdrift.LEDGER.reset()
    jdrift.LEDGER.reset()


# ---------------------------------------------------------------------------
# tier_commute, attribute, the IR-priced fallback
# ---------------------------------------------------------------------------

def _rs164(pkg):
    if pkg == "j":
        return jplace(JSpec("rs", 16, 4), JTopology(5, 4), "affinity")
    return place(TSpec("rs", 16, 4), Topology(5, 4), "affinity")


def test_tier_commute_matches_reference():
    ir = build_encode_ir(TSpec("rs", 16, 4)).validate()
    jir = j_build_encode_ir(JSpec("rs", 16, 4))
    pl, jpl = _rs164("t"), _rs164("j")
    cm, jcm = ir.tier_commute(pl), jir.tier_commute(jpl)
    assert ir.attribute(pl) == jir.attribute(jpl)
    assert cm.attribute(pl) == jcm.attribute(jpl)
    assert ir.attribute(pl)["inter"][0] == 3
    assert cm.attribute(pl)["inter"][0] == 1
    assert cm.digest() == jcm.digest() != ir.digest()
    assert "[commuted]" in cm.summary()
    f = TSpec("rs", 16, 4).field
    x = f.rand((16, 2), np.random.default_rng(2))
    assert np.array_equal(execute(ir, f, x, RoundNetwork(ir.n_procs, 1)),
                          execute(cm, f, x, RoundNetwork(cm.n_procs, 1)))
    dft = TSpec("dft", 8, 8)
    dir_ = build_encode_ir(dft).validate()
    assert dir_.tier_commute(place(dft, Topology(2, 4), "affinity")) is dir_


def test_commuted_plan_measured_cost_equals_attribute():
    tdrift.LEDGER.reset()
    spec = TSpec("rs", 16, 4)
    pl = _rs164("t")
    base = TEncoder.plan(spec, backend="simulator", topology=pl)
    plan = TEncoder.plan(spec, backend="simulator", topology=pl, commute=True)
    assert plan is not base
    x = spec.field.rand((16, 3), np.random.default_rng(3))
    y = plan.run(x)
    assert np.array_equal(y, base.run(x))
    a = plan.schedule_ir().attribute(pl)
    tiers = plan.sim_net.by_tier()
    for t in ("intra", "inter"):
        assert tiers[t] == (a[t][0], a[t][1] * 3)
    tc = plan.tiered_cost()
    assert (tc.inter.C1, tc.intra.C1) == (a["inter"][0], a["intra"][0])
    assert tdrift.LEDGER.drifted() == []
    jplan = JEncoder.plan(JSpec("rs", 16, 4), topology=_rs164("j"),
                          commute=True)
    assert plan.describe() == jplan.describe()
    assert "[commuted]" in plan.describe()
    with pytest.raises(ValueError, match="placement"):
        TEncoder.plan(spec, backend="simulator", commute=True)
    with pytest.raises(ValueError, match="placed topology"):
        TSystem(spec, backend="simulator", commute=True)
    tdrift.LEDGER.reset()


def test_ir_priced_fallback_matches_reference():
    """A placement with no closed-form per-tier split is priced from the
    schedule IR, and auto selection then agrees with the JAX package."""
    slots = list(range(20))
    slots[3], slots[16] = slots[16], slots[3]
    ts, js = TSpec("rs", 16, 4, W=8), JSpec("rs", 16, 4, W=8)
    pl = Placement(Topology(5, 4), tuple(slots))
    jpl = JPlacement(JTopology(5, 4), tuple(slots))
    tp = TEncoder.plan(ts, backend="simulator", topology=pl)
    jp = JEncoder.plan(js, topology=jpl)
    for m in ("rs", "universal"):
        tc = t_ir_tiered_cost(tp.tables, m, pl)
        jc = j_ir_tiered_cost(jp.tables, m, jpl)
        assert (_counts(tc.intra), _counts(tc.inter)) == \
            (_counts(jc.intra), _counts(jc.inter))
    kw = dict(alpha_intra=1e-6, beta_bits_intra=1e-9, alpha_inter=1e-4,
              beta_bits_inter=1e-7)
    for backend in ("simulator", "local"):
        auto = TEncoder.plan(ts, backend=backend, topology=pl,
                             link=TieredLinkModel(**kw), device="cpu")
        jauto = JEncoder.plan(js, backend=backend, topology=jpl,
                              link=JLink(**kw))
        assert auto.method == jauto.method
    assert TEncoder.auto_method(ts) == JEncoder.auto_method(js)


# ---------------------------------------------------------------------------
# describe / stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["simulator", "local"])
@pytest.mark.parametrize("args,kw", ALL_KINDS, ids=lambda a: str(a))
def test_describe_lines_match_reference_but_the_local_note(args, kw, backend):
    js, ts = _pair(args, kw)
    tp = TEncoder.plan(ts, backend=backend, device="cpu")
    jp = JEncoder.plan(js, backend=backend)
    tl, jl = tp.describe().splitlines(), jp.describe().splitlines()
    assert len(tl) == len(jl)
    diff = [(t, j) for t, j in zip(tl, jl) if t != j]
    if backend == "simulator":
        assert diff == []
    else:
        assert [t.split(":")[0] for t, _ in diff] == ["  note    "]
        assert "CUDA" in diff[0][0] and "Pallas" not in diff[0][0]
    erased = [1, ts.N - 1] if ts.kind != "dft" else [2, 9]
    assert TDecoder.plan(ts, erased=erased, backend=backend,
                         device="cpu").describe() == \
        JDecoder.plan(js, erased=erased, backend=backend).describe()


def _key_tree(d):
    return {k: (_key_tree(v) if isinstance(v, dict) and k != "metrics"
                else None) for k, v in d.items() if k not in ("cache",)}


@pytest.mark.parametrize("backend", ["simulator", "local"])
def test_stats_and_describe_with_an_undecodable_dft_pattern(backend):
    pattern = (0, 2, 4, 6, 8, 9)     # |E| <= R but information-losing
    js, ts = _pair(("dft", 8, 8))
    j = JSystem(js, backend=backend)
    t = TSystem(ts, backend=backend, device="cpu")
    for s in (j, t):
        s.fail(pattern)
        s.submit("encode", np.ones((8, 2), np.int64)).result(timeout=60)
    tst, jst = t.stats(), j.stats()
    assert _key_tree(tst) == _key_tree(jst)
    assert tst["decode"]["decodable"] is False
    assert tst["decode"]["error"] == jst["decode"]["error"]
    assert tst["queue"].requests == 1
    assert sorted(tst["cache"]) == sorted(jst["cache"]) == ["decode", "encode"]
    td, jd = t.describe().splitlines(), j.describe().splitlines()
    assert any("UNDECODABLE" in ln for ln in td)
    if backend == "local":
        assert [a for a, b in zip(td, jd) if a != b] == \
            [ln for ln in td if ln.startswith("    note")]
    t.close()
    j.close()


# ---------------------------------------------------------------------------
# repair_with_faults: the kill scenarios of the JAX package's test_rebuild
# ---------------------------------------------------------------------------

CASES = [(("universal", 8, 4), {"seed": 5}, (0, 9)), (("rs", 8, 4), {}, (2, 4, 11)),
         (("lagrange", 8, 4), {}, (1, 10)), (("dft", 8, 8), {}, (5, 9, 13))]


def _attempts(rep):
    return [(a.erased, a.C1, a.C2, a.completed, a.killed) for a in rep.attempts]


@pytest.mark.parametrize("args,kw,erased", CASES, ids=lambda a: str(a))
def test_repair_with_mid_schedule_kill_matches_reference(args, kw, erased):
    js, ts = _pair(args, kw)
    x = np.random.default_rng(41).integers(0, Q, (ts.K, 4))
    cw = TSystem(ts, backend="simulator").codeword(x)
    victim = TDecoder.plan(ts, erased=erased, backend="simulator").kept[1]
    net, jnet = RoundNetwork(ts.N, ts.p), JNet(js.N, js.p)
    FaultInjector(net).kill_at(1, (victim,))
    JFaultInjector(jnet).kill_at(1, (victim,))
    rep = repair_with_faults(ts, cw, erased=erased, net=net)
    jrep = j_repair(js, cw, erased=erased, net=jnet)
    assert np.array_equal(rep.codeword, cw)
    assert np.array_equal(rep.codeword, jrep.codeword)
    assert _attempts(rep) == _attempts(jrep)
    assert rep.erased == jrep.erased and victim in rep.erased
    assert rep.restarts == jrep.restarts >= 1
    assert (net.C1, net.C2) == (jnet.C1, jnet.C2)
    assert net.C1 == sum(a.C1 for a in rep.attempts)


def test_repair_edge_scenarios_match_reference():
    js, ts = _pair(("rs", 8, 4))
    x = np.random.default_rng(42).integers(0, Q, (8, 3))
    cw = TSystem(ts, backend="simulator").codeword(x)
    # no faults; a kill due before round 0; an idle survivor's kill
    for kills, erased in [((), (0, 9)), (((0, (4,)),), (0,)),
                          (((2, (3,)),), (0, 9))]:
        net, jnet = RoundNetwork(12, 1), JNet(12, 1)
        for r, procs in kills:
            net.fail_at(r, procs)
            jnet.fail_at(r, procs)
        rep = repair_with_faults(ts, cw, erased=erased, net=net)
        jrep = j_repair(js, cw, erased=erased, net=jnet)
        assert np.array_equal(rep.codeword, cw)
        assert _attempts(rep) == _attempts(jrep)
    net = RoundNetwork(12, 1)
    FaultInjector(net).kill_at(1, (4, 5))
    with pytest.raises(ValueError, match="exceed"):
        repair_with_faults(ts, cw, erased=(0, 1, 2), net=net)
    with pytest.raises(ValueError, match="N=12"):
        repair_with_faults(ts, cw[:8], erased=(0,))
