"""The port's model substrate (`repro_torch.configs`, `repro_torch.models`)
against the JAX package's on the CPU.

Shapes, dtypes, leaf paths and parameter counts of every full config are
equal (the port builds on the meta device, JAX under `jax.eval_shape`).
On the same weights, carried from JAX by `models.convert.from_reference`,
the float32 forward agrees within atol 2e-4, rtol 1e-4: the two frameworks
sum in other orders, so the logits differ by float32 rounding only.
Within the port, JAX's own serving scenarios (`tests/test_archs.py`) hold
at JAX's tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget
from repro.models import model as JM
from repro_torch.configs import (
    ARCH_IDS,
    all_configs,
    cell_applicable,
    get_config,
    get_shape,
)
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models.convert import from_reference, to_reference

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ARCHS = [a for a in ARCH_IDS if a != "paper_rs"]
ATOL, RTOL = 2e-4, 1e-4            # float32, the same weights, two frameworks
DEC_ATOL, DEC_RTOL = 0.15, 0.05    # bf16 decode vs forward (test_archs.py)


def _f32(arch, **kw):
    """The arch's smoke config in float32, in both packages."""
    return (dataclasses.replace(get_config(arch).smoke(), dtype="float32", **kw),
            dataclasses.replace(jget(arch).smoke(), dtype="float32", **kw))


def _carried(cfg, jcfg):
    """JAX's seeded smoke weights and the port's model holding them."""
    jp = jax.device_get(JM.init_params(jcfg, KEY))
    return jp, from_reference(cfg, jp, "cpu")


def _batch(cfg, B=2, S=16, seed=0):
    """The same inputs for both packages, made with numpy."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        arrays["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in arrays.items()}
    return jb, tb


def _leaf_table(tree, prefix=()):
    """{path: (shape, dtype name)} of a nested dict of arrays/tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_table(v, prefix + (k,)))
        else:
            dt = str(v.dtype).replace("torch.", "")
            out[prefix + (k,)] = (tuple(v.shape), dt)
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_ids_match_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert get_config("paper_rs") == type(get_config("paper_rs"))(
        **dataclasses.asdict(jget("paper_rs")))
    assert get_config("qwen3-1.7b") is get_config("qwen3_1_7b")
    with pytest.raises(KeyError):
        get_config("no_such_arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_by_field(arch):
    for port, ref in ((get_config(arch), jget(arch)),
                      (get_config(arch).smoke(), jget(arch).smoke())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.hd, port.subquadratic, port.d_inner, port.ssm_heads) == \
            (ref.hd, ref.subquadratic, ref.d_inner, ref.ssm_heads)


def test_exact_assigned_configs():
    """The numbers of `tests/test_archs.py::test_exact_assigned_configs`."""
    c = get_config("qwen3_14b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == \
        (40, 5120, 40, 8, 17408, 151936) and c.qk_norm
    c = get_config("kimi_k2_1t_a32b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab,
            c.n_experts, c.top_k) == (61, 7168, 64, 8, 2048, 163840, 384, 8)
    c = get_config("mamba2_780m")
    assert (c.n_layers, c.d_model, c.vocab, c.ssm_state) == (48, 1536, 50280, 128)
    c = get_config("qwen1_5_32b")
    assert c.qkv_bias and c.n_layers == 64 and c.d_ff == 27392
    c = get_config("hymba_1_5b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab,
            c.ssm_state) == (32, 1600, 25, 5, 5504, 32001, 16)
    c = get_config("minicpm_2b")
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.vocab) == \
        (40, 2304, 36, 5760, 122753)
    c = get_config("whisper_large_v3")
    assert c.family == "encdec" and c.d_model == 1280 and c.vocab == 51866
    c = get_config("llava_next_mistral_7b")
    assert c.family == "vlm" and c.d_model == 4096 and c.d_ff == 14336
    c = get_config("phi3_5_moe_42b_a6_6b")
    assert (c.n_experts, c.top_k, c.d_ff) == (16, 2, 6400)
    c = get_config("qwen3_1_7b")
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff) == (28, 2048, 16, 6144)


def test_cell_applicability_matrix():
    runnable = 0
    for arch, cfg in all_configs().items():
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            ok, why = cell_applicable(cfg, get_shape(shape))
            if shape == "long_500k":
                assert ok == (arch in ("mamba2_780m", "hymba_1_5b")), (arch, why)
            else:
                assert ok
            runnable += ok
    assert runnable == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_match_reference(arch):
    """Meta-device build vs `jax.eval_shape`: the same leaf paths, shapes,
    dtypes and total count (kimi-k2's 1T parameters included)."""
    cfg, jcfg = get_config(arch), jget(arch)
    model = M.init_params(cfg, device="meta")
    ref = jax.eval_shape(lambda: JM.init_params(jcfg, KEY))
    assert _leaf_table(to_reference(model)) == _leaf_table(ref)
    count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    assert M.param_count(model) == count
    if arch == "qwen3_1_7b":
        assert count == 1_720_574_976


# ---------------------------------------------------------------------------
# the same weights through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg = _f32(arch)
    jp, model = _carried(cfg, jcfg)
    jb, tb = _batch(cfg)
    want = np.asarray(JM.forward(jcfg, jp, jb))
    got = M.forward(cfg, model, tb).numpy()
    assert got.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    loss = M.loss_fn(cfg, model, tb).item()
    np.testing.assert_allclose(loss, float(JM.loss_fn(jcfg, jp, jb)),
                               rtol=RTOL)


def test_encode_frames_matches_reference():
    cfg, jcfg = _f32("whisper_large_v3")
    jp, model = _carried(cfg, jcfg)
    jb, tb = _batch(cfg)
    want = np.asarray(JM.encode_frames(jcfg, jp, jb["frames"]))
    got = M.encode_frames(cfg, model, tb["frames"]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = TL.act_fn("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4  # the default would not do


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_is_bitwise(arch):
    """to_reference(from_reference(tree)) is the tree, bit for bit, in the
    arch's own dtypes (bf16 leaves included)."""
    jcfg = jget(arch).smoke()
    jp = jax.device_get(JM.init_params(jcfg, KEY))
    back = to_reference(from_reference(get_config(arch).smoke(), jp, "cpu"))
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(back)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        if b.dtype == torch.bfloat16:
            b = b.view(torch.int16).numpy()
            a = np.asarray(a).view(np.int16)
        else:
            b = b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_from_reference_refuses_a_wrong_tree():
    cfg = get_config("qwen3_1_7b").smoke()
    jp = jax.device_get(JM.init_params(jget("qwen3_1_7b").smoke(), KEY))
    bad = dict(jp, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        from_reference(cfg, bad, "cpu")
    bad = dict(jp, ln_f=np.ones(7, np.float32))
    with pytest.raises(ValueError, match="ln_f"):
        from_reference(cfg, bad, "cpu")
    bad = dict(jp, ln_f=np.ones(cfg.d_model, np.float64))
    with pytest.raises(ValueError, match="ln_f"):
        from_reference(cfg, bad, "cpu")


@pytest.mark.parametrize("arch,cf", [("phi3_5_moe_42b_a6_6b", 0.5),
                                     ("kimi_k2_1t_a32b", 0.25)])
def test_moe_dropping_matches_reference(arch, cf):
    """A capacity factor low enough to drop choices: the same slots, the
    same drops, the same top-k order as JAX."""
    cfg, jcfg = _f32(arch, capacity_factor=cf)
    jp, model = _carried(cfg, jcfg)
    jb, tb = _batch(cfg, S=32)
    want = np.asarray(JM.forward(jcfg, jp, jb))
    got = M.forward(cfg, model, tb).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    roomy = dataclasses.replace(cfg, capacity_factor=8.0)
    assert not np.allclose(M.forward(roomy, model, tb).numpy(), got,
                           atol=1e-3), "no choice was dropped"


@pytest.mark.parametrize("arch,window", [("qwen3_1_7b", 0), ("hymba_1_5b", 8)])
def test_chunked_attention_matches_reference(monkeypatch, arch, window):
    """The chunked path above a lowered threshold, in both packages (their
    constants are read at call time): full causal and sliding window."""
    cfg, jcfg = _f32(arch, sliding_window=window)
    jp, model = _carried(cfg, jcfg)
    jb, tb = _batch(cfg, S=64)
    unchunked = M.forward(cfg, model, tb).numpy()
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 16)
        monkeypatch.setattr(mod, "_Q_CHUNK", 16)
        monkeypatch.setattr(mod, "_KV_CHUNK", 32)
    calls = []
    real = TL._chunked_attention
    monkeypatch.setattr(TL, "_chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = np.asarray(JM.forward(jcfg, jp, jb))
    got = M.forward(cfg, model, tb).numpy()
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, unchunked, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# within the port: JAX's serving scenarios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_decode_step(arch):
    cfg = get_config(arch).smoke()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(cfg, S=32)
    logits = M.forward(cfg, model, tb)
    assert logits.shape == (2, 32, cfg.vocab) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    assert np.isfinite(M.loss_fn(cfg, model, tb).item())
    enc = None
    if cfg.family == "encdec":
        enc = M.encode_frames(cfg, model, tb["frames"].to(torch.bfloat16))
    cache = M.init_cache(cfg, 2, 64, enc, device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    lg, cache = M.decode_step(cfg, model, tb["tokens"][:, 0], 0, cache, enc)
    assert lg.shape == (2, cfg.vocab) and torch.isfinite(lg.float()).all()
    assert any(not torch.equal(before[k], cache[k]) for k in cache)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mamba2_780m", "hymba_1_5b",
                                  "phi3_5_moe_42b_a6_6b", "whisper_large_v3"])
def test_decode_matches_forward(arch):
    """`tests/test_archs.py::test_decode_matches_forward` on the port."""
    cfg = get_config(arch).smoke()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 8
    _, tb = _batch(cfg, B=B, S=S)
    enc = None
    fwd = {"tokens": tb["tokens"]}
    if cfg.family == "encdec":
        enc = M.encode_frames(cfg, model, tb["frames"].to(torch.bfloat16))
        fwd["frames"] = tb["frames"]
    cache = M.init_cache(cfg, B, 64, enc, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = M.decode_step(cfg, model, tb["tokens"][:, t], t, cache, enc)
        outs.append(lg)
    stepwise = torch.stack(outs, 1).float().numpy()
    full = M.forward(cfg, model, fwd).float().numpy()
    np.testing.assert_allclose(stepwise, full, atol=DEC_ATOL, rtol=DEC_RTOL)


def test_decode_position_as_tensor_equals_int():
    cfg = get_config("hymba_1_5b").smoke()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)))
    c_int = M.init_cache(cfg, 2, 48, device="cpu")
    c_ten = M.init_cache(cfg, 2, 48, device="cpu")
    for t in range(40):  # past the 32-slot ring: wraps
        a, c_int = M.decode_step(cfg, model, toks[:, t], t, c_int)
        b, c_ten = M.decode_step(cfg, model, toks[:, t], torch.tensor(t), c_ten)
        assert torch.equal(a, b)


def test_int8_kv_cache_decode_matches_fp():
    """`quantize_kv`: greedy decode agrees with the full-precision cache
    (JAX's scenario: its weights and tokens, carried across), and the int8
    path's logits are JAX's int8 path's."""
    scfg, jcfg = _f32("qwen3_1_7b")
    scfgq = dataclasses.replace(scfg, quantize_kv=True)
    jcfgq = dataclasses.replace(jcfg, quantize_kv=True)
    jp, model = _carried(scfg, jcfg)
    B, S = 2, 10
    jtoks = jax.random.randint(KEY, (B, S), 0, scfg.vocab)
    toks = torch.from_numpy(np.array(jtoks)).long()
    cf = M.init_cache(scfg, B, 32, device="cpu")
    cq = M.init_cache(scfgq, B, 32, device="cpu")
    jq = JM.init_cache(jcfgq, B, 32)
    assert cq["k"].dtype == torch.int8 and "k_scale" in cq
    for t in range(S):
        lf, cf = M.decode_step(scfg, model, toks[:, t], t, cf)
        lq, cq = M.decode_step(scfgq, model, toks[:, t], t, cq)
        ljq, jq = JM.decode_step(jcfgq, jp, jtoks[:, t], jnp.int32(t), jq)
        assert (lf - lq).abs().max().item() < 0.05
        assert torch.equal(lf.argmax(-1), lq.argmax(-1))
        np.testing.assert_allclose(lq.numpy(), np.asarray(ljq), atol=ATOL,
                                   rtol=RTOL)


def test_int8_quantizer_matches_reference():
    """absmax/127 floored at 1e-8, round half to even, clip, bf16 scales:
    the same int8 values and scales as the JAX decode path."""
    x = np.random.default_rng(4).standard_normal((3, 5, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                  # the floor
    x[1, 1, 1, :2] = [2.5, -127.0]    # a half and the clip edge
    t8, ts = TL._q8(torch.from_numpy(x))
    s = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8)
    want = np.clip(np.asarray(jnp.round(jnp.asarray(x) / s)), -127, 127)
    assert np.array_equal(t8.numpy(), want.astype(np.int8))
    assert np.array_equal(ts.float().numpy(),
                          np.asarray(jnp.asarray(s).astype(jnp.bfloat16),
                                     np.float32))


def test_ring_buffer_swa_cache_matches_forward():
    """Sliding-window ring cache (L == window) decode == full forward, on
    JAX's scenario (its weights and tokens, carried across)."""
    scfg, jcfg = _f32("hymba_1_5b", sliding_window=8)
    _, model = _carried(scfg, jcfg)
    B, S = 2, 24
    toks = torch.from_numpy(np.array(
        jax.random.randint(KEY, (B, S), 0, scfg.vocab))).long()
    cache = M.init_cache(scfg, B, 64, device="cpu")
    assert cache["k"].shape[2] == 8  # ring length == window
    outs = []
    for t in range(S):
        lg, cache = M.decode_step(scfg, model, toks[:, t], t, cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               M.forward(scfg, model, {"tokens": toks}).numpy(),
                               atol=2e-4)


def test_default_device_is_cuda():
    """`device=None` means CUDA: there it lands on the card; without one it
    raises rather than fall back to the CPU."""
    cfg = get_config("qwen3_1_7b").smoke()
    if torch.cuda.is_available():
        assert M.init_params(cfg).embed.device.type == "cuda"
        assert M.init_cache(cfg, 1, 4)["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_reference(cfg, {}, None)
