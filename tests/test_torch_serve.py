"""The port's model server (`repro_torch.train.serve`,
`repro_torch.launch.serve`) against the JAX package's on the CPU.

On weights carried from JAX: teacher-forced on JAX's tokens,
`greedy_generate`'s per-step logits are JAX's `decode_step`'s within the
float32 tolerance (atol 2e-4, rtol 1e-4; the frameworks round differently),
and untethered it picks JAX's tokens wherever JAX's top-2 margin exceeds
1e-3.  The coded self-check is exact: the same parameter bytes, shards and
codeword as the JAX launcher's, bit for bit.  The CLI runs in-process with
`--device cpu` and raises without it on a machine with no card.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CodedSystem as JSystem
from repro.api import CodeSpec as JSpec
from repro.ckpt.checkpoint import tree_to_bytes as j_tree_to_bytes
from repro.configs import get_config as jget
from repro.core.field import bytes_to_symbols
from repro.models import model as JM
from repro.train import serve as JS
from repro_torch.ckpt.checkpoint import tree_to_bytes
from repro_torch.configs import get_config
from repro_torch.launch import serve as LS
from repro_torch.models import model as M
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.train import serve as TS

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 2e-4, 1e-4
MARGIN = 1e-3


def _carried(arch, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    jcfg = dataclasses.replace(jget(arch).smoke(), dtype=dtype)
    jp = jax.device_get(JM.init_params(jcfg, KEY))
    return cfg, jcfg, jp, from_reference(cfg, jp, "cpu")


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mamba2_780m", "hymba_1_5b",
                                  "phi3_5_moe_42b_a6_6b", "minicpm_2b"])
def test_greedy_generate_matches_reference(arch):
    cfg, jcfg, jp, model = _carried(arch)
    B, S, steps = 2, 6, 10
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jtoks = np.asarray(JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), steps,
                                          max_len=32))
    T = S + steps - 1
    decode = jax.jit(lambda p, t, pos, c: JM.decode_step(jcfg, p, t, pos, c))
    cache = JM.init_cache(jcfg, B, 32)
    jlogits = []
    for t in range(T):
        lg, cache = decode(jp, jnp.asarray(jtoks[:, t]), jnp.int32(t), cache)
        jlogits.append(np.asarray(lg))
    jlogits = np.stack(jlogits, 1)

    # teacher-forced on JAX's tokens: the same logits at every step
    forced, logits = TS.greedy_generate(
        cfg, model, torch.from_numpy(jtoks[:, :T].astype(np.int64)), 1,
        max_len=32, return_logits=True)
    assert logits.shape == (B, T, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=ATOL, rtol=RTOL)
    assert torch.equal(forced[:, :T], torch.from_numpy(jtoks[:, :T].astype(np.int64)))

    # untethered: JAX's tokens up to the first step whose margin is thin
    top2 = -np.sort(-jlogits, axis=-1)[..., :2]
    thin = np.nonzero((top2[..., 0] - top2[..., 1])[:, S - 1:].min(0) <= MARGIN)[0]
    upto = S + (thin[0] if thin.size else steps)
    toks = TS.greedy_generate(cfg, model, torch.from_numpy(prompt).long(), steps,
                              max_len=32)
    assert toks.shape == (B, S + steps)
    assert np.array_equal(toks.numpy()[:, :upto], jtoks[:, :upto])
    assert upto > S  # at least one generated token compared


def test_prefill_and_decode_steps_match_model_functions():
    cfg, _, _, model = _carried("qwen3_1_7b")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 5)))
    assert torch.equal(TS.make_prefill_step(cfg)(model, {"tokens": toks}),
                       M.forward(cfg, model, {"tokens": toks}))
    step = TS.make_decode_step(cfg)
    c1 = M.init_cache(cfg, 2, 8, device="cpu")
    c2 = M.init_cache(cfg, 2, 8, device="cpu")
    a, _ = step(model, toks[:, 0], 0, c1)
    b, _ = M.decode_step(cfg, model, toks[:, 0], 0, c2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("nbytes", [0, 1, 2, 15, 16, 17, 4097])
def test_param_shards_match_reference(nbytes):
    """The launcher's shards: JAX's bytes_to_symbols + zero padding."""
    raw = np.random.default_rng(nbytes).integers(0, 256, nbytes).astype(np.uint8)
    sym = bytes_to_symbols(raw)
    L = -(-sym.size // 8)
    want = np.concatenate([sym, np.zeros(8 * L - sym.size, np.int64)]).reshape(8, L)
    got = LS._param_shards(raw, 8)
    assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mamba2_780m",
                                  "whisper_large_v3", "kimi_k2_1t_a32b"])
def test_coded_selfcheck_is_bitwise_the_reference(arch, capsys):
    """On a carried bf16 smoke tree: the same tree_to_bytes stream as JAX's
    and a codeword bitwise equal to JAX's CodedSystem(rs, 8, 2).codeword
    on the same shards, in both recovery modes."""
    _, _, jp, model = _carried(arch, dtype="bfloat16")
    tree = to_reference(model)
    raw, meta = tree_to_bytes(tree)
    jraw, jmeta = j_tree_to_bytes(jp)
    assert np.array_equal(raw, jraw)
    assert meta["leaves"] == jmeta["leaves"]
    shards = LS._param_shards(raw, 8)
    want = JSystem(JSpec(kind="rs", K=8, R=2), backend="local").codeword(shards)
    for degraded in (False, True):
        full = LS._coded_selfcheck(tree, 8, 2, degraded=degraded, device="cpu")
        assert full.dtype == np.int64 and np.array_equal(full, want)
    out = capsys.readouterr().out
    assert "coded self-check OK (host solve)" in out
    assert "coded self-check OK (degraded DecodePlan)" in out


def test_coded_selfcheck_refuses_parity_not_dividing_shards():
    _, _, _, model = _carried("qwen3_1_7b")
    with pytest.raises(SystemExit, match="must divide"):
        LS._coded_selfcheck(to_reference(model), 8, 3, device="cpu")


@pytest.mark.parametrize("flags,expect", [
    ([], []),
    (["--coded-selfcheck"], ["coded self-check OK (host solve)"]),
    (["--coded-selfcheck", "--degraded"],
     ["coded self-check OK (degraded DecodePlan)", "failed  : [0, 1]"]),
    (["--queue-demo", "2"], ["coding queue OK: 4 requests"]),
])
def test_main_runs_in_process(flags, expect, capsys):
    LS.main(["--arch", "qwen3_1_7b", "--batch", "2", "--prompt-len", "4",
             "--gen-len", "4", "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b batch=2 generated 4 tokens/seq" in out
    assert "(cpu, reduced config)" in out
    for line in expect:
        assert line in out


def test_main_trace_holds_the_selfcheck_stages(tmp_path, capsys):
    path = tmp_path / "trace.json"
    LS.main(["--arch", "mamba2_780m", "--batch", "1", "--prompt-len", "2",
             "--gen-len", "2", "--device", "cpu", "--coded-selfcheck",
             "--trace", str(path)])
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "selfcheck"}
    assert names == {"tree_to_bytes", "shard_symbols", "codeword",
                     "reconstruct"}
    assert "events ->" in capsys.readouterr().out


def test_main_refuses_degraded_without_selfcheck(capsys):
    with pytest.raises(SystemExit):
        LS.main(["--device", "cpu", "--degraded"])
    assert "--degraded modifies the self-check" in capsys.readouterr().err


def test_main_without_device_needs_a_card():
    """The server runs on the card unless asked otherwise: without one,
    the default device raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LS.main(["--arch", "qwen3_1_7b", "--batch", "1", "--prompt-len", "2",
                 "--gen-len", "2"])


def test_serve_result():
    cfg, _, _, model = _carried("qwen3_1_7b")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (3, 4)))
    res = LS.serve(cfg, model, prompt, 5)
    assert res.tokens.shape == (3, 9) and res.logits.shape == (3, 8, cfg.vocab)
    assert res.steps == 8 and res.wall_s > 0
    assert res.ms_per_token == pytest.approx(res.wall_s / 8 * 1e3)
    assert res.tokens_per_s == pytest.approx(3 * 8 / res.wall_s)
    # the step logits are the forward's over the same tokens
    full = M.forward(cfg, model, {"tokens": res.tokens[:, :8]})
    np.testing.assert_allclose(res.logits.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)
