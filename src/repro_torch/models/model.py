"""Model assembly for all 10 assigned architectures; the port of
`repro/models/model.py`.

`Model` is an `nn.Module` over an `nn.ModuleList` of decoder layers (and,
for whisper, of encoder layers), with the JAX package's parameter names:
`models.convert.to_reference` gives its tree in JAX's layout, stacked
layers and all.  The functions below keep the JAX names and signatures
and run eagerly, a Python loop over layers where JAX scans a stacked
tree.  `params` is a `Model`, or for `forward`, `loss_fn` and
`value_and_grad` also JAX's tree of tensors (the training state's
layout): the model then runs on per-layer views of the stacked leaves
(`convert.bind`), so the gradients come back as JAX's tree.

Families:
  dense  — llama-style decoder (qwen3*, minicpm, qwen1.5)
  moe    — dense skeleton with MoE FFN (kimi-k2, phi3.5-moe)
  ssm    — mamba2 SSD stack (attention-free)
  hybrid — hymba: parallel attention + SSM heads per layer, sliding window
  encdec — whisper: bidirectional encoder (stub frontend) + causal decoder
           with cross-attention
  vlm    — llava: mistral decoder over [vision-stub | text] sequence

Built on `device="meta"`, a `Model` has every shape and dtype and holds no
memory: the counterpart of `jax.eval_shape(init_params)` (kimi-k2 has 1T
parameters).  A `Model`'s own parameters take no gradient (they are
serving's weights); training differentiates the tree's leaves.  With
`cfg.remat` and gradients on, each decoder layer runs under
`torch.utils.checkpoint` (JAX: `jax.checkpoint` around the scanned layer
body): its activations are recomputed in the backward, exactly, since the
model has no dropout and no RNG.
"""
from __future__ import annotations

import math
import threading

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.ctx import constrain, lookup, matmul
from .config import ArchConfig
from .layers import MLP, Attention, MoE, RMSNorm, _dtype, dense_init
from .ssm import Mamba2


def _res_scale(cfg: ArchConfig) -> float:
    if cfg.scale_depth:
        return cfg.scale_depth / math.sqrt(cfg.n_layers)
    return 1.0


class Layer(nn.Module):
    """One decoder (or, with `cross=False` in an encdec model, encoder)
    layer."""

    def __init__(self, cfg: ArchConfig, gen, device, cross: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        if cfg.family == "ssm":
            self.ssm = Mamba2(cfg, gen, device)
            return
        self.attn = Attention(cfg, gen, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        if cfg.family == "hybrid":
            self.ssm = Mamba2(cfg, gen, device)
            self.attn_norm = RMSNorm(cfg.d_model, device)
            self.ssm_norm = RMSNorm(cfg.d_model, device)
        if cross:
            self.xattn = Attention(cfg, gen, device)
            self.ln_x = RMSNorm(cfg.d_model, device)
        self.ffn = (MoE(cfg, gen, device) if cfg.family == "moe"
                    else MLP(cfg, gen, device))

    def _ffn(self, cfg: ArchConfig, x, s: float):
        return x + s * self.ffn(cfg, self.ln2(x, cfg.norm_eps))

    def forward(self, cfg: ArchConfig, x, positions, enc_out=None):
        """Full-sequence forward (train / prefill)."""
        s = _res_scale(cfg)
        xin = self.ln1(x, cfg.norm_eps)
        if cfg.family == "ssm":
            h, _ = self.ssm(cfg, xin)
            return x + s * h
        # hymba's global layers are approximated by one uniform sliding
        # window across the stack, as in the JAX package
        a, _ = self.attn(cfg, xin, positions, window=cfg.sliding_window)
        if cfg.family == "hybrid":
            m, _ = self.ssm(cfg, xin)
            a = 0.5 * (self.attn_norm(a, cfg.norm_eps)
                       + self.ssm_norm(m, cfg.norm_eps))
        x = x + s * a
        if enc_out is not None:
            xx = self.ln_x(x, cfg.norm_eps)
            c, _ = self.xattn(cfg, xx, positions, mode="cross", kv_src=enc_out)
            x = x + s * c
        return self._ffn(cfg, x, s)

    def encode(self, cfg: ArchConfig, x):
        """An encoder layer: bidirectional attention, no residual scale."""
        pos = torch.arange(x.shape[1], device=x.device)[None]
        a, _ = self.attn(cfg, self.ln1(x, cfg.norm_eps), pos, mode="bidir")
        x = x + a
        return x + self.ffn(cfg, self.ln2(x, cfg.norm_eps))

    def decode(self, cfg: ArchConfig, x, pos, cache: dict, enc_out=None):
        """x: (B, 1, D); `cache` this layer's entries.  K/V are written
        into `cache` in place; returns (x, the SSM state's new tensors)."""
        s = _res_scale(cfg)
        B = x.shape[0]
        if isinstance(pos, torch.Tensor):
            positions = pos.reshape(1, 1).expand(B, 1)
        else:
            positions = torch.full((B, 1), pos, device=x.device)
        xin = self.ln1(x, cfg.norm_eps)
        if cfg.family == "ssm":
            h, st = self.ssm.decode_step(cfg, xin, cache)
            return x + s * h, st
        kv = {k: cache[k] for k in ("k", "v", "k_scale", "v_scale")
              if k in cache}
        a, _ = self.attn(cfg, xin, positions, window=cfg.sliding_window,
                         cache=kv, cache_pos=pos)
        st = {}
        if cfg.family == "hybrid":
            m, st = self.ssm.decode_step(cfg, xin, cache)
            a = 0.5 * (self.attn_norm(a, cfg.norm_eps)
                       + self.ssm_norm(m, cfg.norm_eps))
        x = x + s * a
        if cfg.family == "encdec" and enc_out is not None:
            xx = self.ln_x(x, cfg.norm_eps)
            c, _ = self.xattn(cfg, xx, positions, mode="cross",
                              kv_src=enc_out)
            x = x + s * c
        return self._ffn(cfg, x, s), st


class Model(nn.Module):
    """Every architecture's parameters, under the JAX tree's names."""

    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        D = cfg.d_model
        self.embed = dense_init((cfg.vocab, D), gen, device, dt, scale=0.02)
        self.ln_f = RMSNorm(D, device)
        self.layers = nn.ModuleList(
            Layer(cfg, gen, device, cross=cfg.family == "encdec")
            for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.unembed = dense_init((D, cfg.vocab), gen, device, dt)
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                Layer(cfg, gen, device) for _ in range(cfg.n_enc_layers))
            self.enc_ln_f = RMSNorm(D, device)
            self.dec_pos = dense_init((32768 + 16, D), gen, device, dt,
                                      scale=0.02)
        if cfg.family == "vlm":
            self.vis_proj = dense_init((D, D), gen, device, dt)

    def w_out(self, cfg: ArchConfig) -> torch.Tensor:
        return self.embed.T if cfg.tie_embeddings else self.unembed

    def forward(self, cfg: ArchConfig, batch: dict) -> torch.Tensor:
        """The logits: `forward(cfg, self, batch)`, for
        `torch.func.functional_call`."""
        return forward(cfg, self, batch)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device=None) -> Model:
    """A `Model` with seeded random weights drawn from `generator` (None: a
    generator on the device seeded with 0).  `device` None means CUDA, and
    raises without a card; "meta" builds shapes and dtypes only."""
    if device is not None and torch.device(device).type == "meta":
        dev = torch.device("meta")
    else:
        from ..api.registry import resolve_device

        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        return Model(cfg, generator, dev)


def param_count(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------

def encode_frames(cfg: ArchConfig, params: Model, frames):
    """Whisper encoder over stub frame embeddings (B, n_frames, D)."""
    x = frames
    for layer in params.enc_layers:
        x = layer.encode(cfg, x)
    return params.enc_ln_f(x, cfg.norm_eps)


_SKELETONS = threading.local()


def _skeleton(cfg: ArchConfig) -> Model:
    """A `Model` of `cfg` on the meta device, one per thread and config:
    `functional_call` swaps tensors into the module it is given."""
    cache = _SKELETONS.__dict__.setdefault("models", {})
    if cfg not in cache:
        cache[cfg] = init_params(cfg, device="meta")
    return cache[cfg]


def _layer_call(layer: "Layer", names: tuple, cfg: ArchConfig, x, positions,
                enc_out, *tensors):
    """`layer` on the given parameter tensors: what remat recomputes in the
    backward, when an enclosing `functional_call` has ended."""
    return torch.func.functional_call(layer, dict(zip(names, tensors)),
                                      (cfg, x, positions, enc_out))


def _run_stack(cfg: ArchConfig, layers, x, positions, enc_out=None):
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            names, tensors = zip(*layer.named_parameters())
            x = checkpoint(_layer_call, layer, names, cfg, x, positions,
                           enc_out, *tensors, use_reentrant=False)
        else:
            x = layer(cfg, x, positions, enc_out)
    return x


def forward(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """Returns logits (B, S_text, vocab).

    params: a `Model`, or JAX's parameter tree of tensors.
    batch: tokens (B, S_text) integer; optional vision_embeds (B, P, D)
    [vlm], frames (B, F, D) [encdec]."""
    if isinstance(params, dict):
        from .convert import bind

        model = _skeleton(cfg)
        return torch.func.functional_call(model, bind(model, params),
                                          (cfg, batch), strict=True)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = lookup(params.embed, tokens) * cfg.scale_emb
    positions = torch.arange(S, device=x.device)[None]
    enc_out = None
    vision = cfg.family == "vlm" and "vision_embeds" in batch
    if vision:
        v = matmul(batch["vision_embeds"].to(x.dtype), params.vis_proj)
        x = torch.cat([v, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None]
    if cfg.family == "encdec":
        enc_out = encode_frames(cfg, params, batch["frames"].to(x.dtype))
        x = x + params.dec_pos[:S][None]
    x = constrain(x, "batch", None, None)
    x = _run_stack(cfg, params.layers, x, positions, enc_out)
    x = params.ln_f(x, cfg.norm_eps)
    if vision:
        x = x[:, -S:]  # logits over text positions only
    logits = matmul(x, params.w_out(cfg)) / cfg.logit_scale
    # vocab-sharded logits: keeps the (B, S, V) tensor (the largest activation
    # by far) distributed over the model axis through the loss
    return constrain(logits, "batch", None, "model")


def loss_fn(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """Mean token cross-entropy (float32), masked by an optional
    `loss_mask`."""
    logits = forward(cfg, params, batch).float()
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)
    # a 2-D gather: DTensor's rule for a gather along a sharded vocab
    # dimension takes a 2-D input only (the picked values are the same)
    picked = torch.gather(logits.reshape(-1, logits.shape[-1]), 1,
                          labels.reshape(-1, 1))
    # reduced over the vocab shards here, before it meets lse (DTensor would
    # otherwise mask lse as if it were indices)
    picked = constrain(picked, "batch", None).reshape(labels.shape)
    ll = picked - lse
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def value_and_grad(cfg: ArchConfig, params: dict, batch: dict):
    """(loss, grads): `jax.value_and_grad(loss_fn)` on JAX's parameter
    tree.  The grads are a tree of the same structure, each leaf in its
    parameter's dtype; a leaf the loss does not reach gets zeros, as in
    JAX.  `params` is read, never changed."""
    from ..core.pytree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(params)
    xs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(treedef, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


# ---------------------------------------------------------------------------
# decode (serve_step): one new token against a KV/SSM cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_out=None,
               device=None) -> dict:
    """Stacked per-layer cache (leading axis = layer), as in JAX.  On
    `device` (None: enc_out's device, else CUDA, raising without a card)."""
    from ..api.registry import resolve_device

    if device is None and enc_out is not None:
        device = enc_out.device
    device = resolve_device(device)
    dt = _dtype(cfg)
    KV, hd, n = cfg.n_kv_heads, cfg.hd, cfg.n_layers

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    cache: dict = {}
    if cfg.family != "ssm":
        # sliding-window archs only attend to the last `window` tokens: a
        # ring buffer of exactly that length
        L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        kv_dt = torch.int8 if cfg.quantize_kv else dt
        cache["k"] = zeros((n, batch, L, KV, hd), kv_dt)
        cache["v"] = zeros((n, batch, L, KV, hd), kv_dt)
        if cfg.quantize_kv:
            cache["k_scale"] = zeros((n, batch, L, KV, 1), torch.bfloat16)
            cache["v_scale"] = zeros((n, batch, L, KV, 1), torch.bfloat16)
    if cfg.family in ("ssm", "hybrid"):
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
        C = cfg.d_inner + 2 * N
        cache["ssm"] = zeros((n, batch, H, N, P), torch.float32)
        cache["conv"] = zeros((n, batch, cfg.ssm_conv - 1, C), dt)
    # encdec: cross-attention K/V is recomputed from enc_out each step
    return cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Model, token, pos, cache: dict,
                enc_out=None):
    """token: (B,) integer; pos: a Python int or a 0-d integer tensor.
    Returns (logits (B, V), cache): the cache is updated in place (JAX
    returns a new one)."""
    x = lookup(params.embed, token)[:, None, :] * cfg.scale_emb
    if cfg.family == "encdec":
        x = x + params.dec_pos[pos][None, None]
    for i, layer in enumerate(params.layers):
        x, state = layer.decode(cfg, x, pos, {k: v[i] for k, v in cache.items()},
                                enc_out)
        for k, v in state.items():  # the SSM's new state and conv tail
            cache[k][i].copy_(v)
    x = params.ln_f(x, cfg.norm_eps)
    return matmul(x[:, 0], params.w_out(cfg)) / cfg.logit_scale, cache
