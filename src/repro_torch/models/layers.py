"""Transformer building blocks: RMSNorm, RoPE, GQA attention (qk-norm /
bias / sliding-window / cross / bidirectional variants, the chunked path
for long prefills, the decode cache with its int8 and ring-buffer forms),
gated MLP, and MoE with sort-free bucket dispatch.

The port of `repro/models/layers.py`.  Parameters live in `nn.Module`s
under the JAX package's names and in its layouts (`wq` is (d_model, H*hd)
and is applied as `x @ wq`), so `models.convert` carries a tree across
leaf for leaf.  Every forward takes the `ArchConfig` as an argument, as
the JAX functions do, so one set of weights serves configs that differ
only in serving options (`quantize_kv`).

What differs from JAX, and why:
- `torch.einsum` refuses mixed dtypes where `jnp.einsum` promotes; `_einsum`
  casts every operand to the promoted dtype first (`jnp.result_type`).
  Under a mesh it runs on each rank's shards (`dist.ctx.einsum`), and so
  does attention (`_per_shard`): DTensor's einsum cannot always fold a
  sharded batch of indices (XLA partitions einsums itself).
- `jax.nn.gelu` is the tanh approximation; so is `act_fn("gelu")` here.
- `jnp.repeat(k, rep, axis=2)` is `repeat_interleave`.
- The decode cache is updated in place: `attention` writes the new token's
  K/V into the cache tensors it is given and returns them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dist.ctx import (constrain, current_mesh, einsum, local_shard,
                        split_heads)
from .config import ArchConfig


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` with JAX's promotion: operands cast to their common
    dtype (bf16 x f32 -> f32), where torch would raise."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return einsum(eq, *(t.to(dt) for t in ops))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(shape, gen: torch.Generator | None, device, dtype,
               scale: float | None = None) -> nn.Parameter:
    """N(0, 1) * scale (default 1/sqrt(fan_in)) drawn in float32 from `gen`,
    cast to `dtype`; on the meta device an uninitialised parameter."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return nn.Parameter((w * scale).to(dtype), requires_grad=False)


def const_param(value: torch.Tensor, device) -> nn.Parameter:
    """A parameter holding `value` (ones, zeros, a range) on `device`."""
    if torch.device(device).type == "meta":
        value = torch.empty_like(value, device="meta")
    return nn.Parameter(value.to(device), requires_grad=False)


# ---------------------------------------------------------------------------
# norms / rope / activation
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


class RMSNorm(nn.Module):
    """A float32 scale vector; a leaf of its parent in the JAX tree."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.weight = const_param(torch.ones(dim, dtype=torch.float32), device)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(x, self.weight, eps)


def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """`rope_freqs` on `device`, copied there once (a copy from pageable
    host memory at every call would make the host wait for the card)."""
    return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer.  Split-half form."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# attention (GQA; causal / sliding-window / cross / bidirectional)
# ---------------------------------------------------------------------------

def _per_shard(fn, q, k, v, *rest):
    """`fn(q, k, v, *rest)`: attention, independent across batch rows and
    heads.  Under a mesh, on DTensors, q, k and v are laid out with the
    batch over the data axes and the heads over "model" (where they
    divide), and `fn` runs on each rank's shards: the einsums inside fold
    (batch, heads) into one dimension, which DTensor can shard by its
    leading part only.  k and v hold as many heads as q."""
    from torch.distributed.tensor import DTensor

    if current_mesh() is None or not all(isinstance(t, DTensor)
                                         for t in (q, k, v)):
        return fn(q, k, v, *rest)
    q, k, v = (constrain(t, "batch", None, "model", None) for t in (q, k, v))
    assert q.placements == k.placements == v.placements
    out = fn(local_shard(q), local_shard(k), local_shard(v), *rest)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def _sdpa(q, k, v, mask, cfg: ArchConfig):
    """q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd), mask broadcastable (1,1,Sq,Skv)."""
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return _per_shard(_attend, q, k, v, mask, 1.0 / math.sqrt(cfg.hd))


def _attend(q, k, v, mask, scale: float):
    logits = _einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _einsum("bhqk,bkhd->bqhd", w, v)


# chunked attention kicks in above this sequence length (S^2 score tensors
# dominate device memory at 4k+).  Read at call time, so a test may lower
# them.
CHUNKED_ATTN_THRESHOLD = 4096
_Q_CHUNK = 512
_KV_CHUNK = 1024


def _chunked_attention(q, k, v, cfg: ArchConfig, causal: bool, window: int):
    """Blockwise attention with an online softmax over kv chunks: never
    materialises (Sq, Skv) scores; the live block is (B, H, cq, ck).

    window > 0: each q chunk attends to one slice of width window + cq.
    Causal full attention visits and masks every kv chunk, as in JAX."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return _per_shard(_chunked, q, k, v, 1.0 / math.sqrt(cfg.hd), causal,
                      window)


def _chunked(q, k, v, scale: float, causal: bool, window: int):
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    cq = min(_Q_CHUNK, Sq)
    nq = Sq // cq
    assert Sq % cq == 0
    dev = q.device
    qs = q.reshape(B, nq, cq, H, hd)
    blocks = []
    for qi in range(nq):
        qb = qs[:, qi] * scale  # (B, cq, H, hd)
        q_start = qi * cq
        qpos = q_start + torch.arange(cq, device=dev)[:, None]
        if window > 0:
            kw = window + cq
            start = min(max(q_start + cq - kw, 0), max(Skv - kw, 0))
            width = min(kw, Skv)
            kb, vb = k[:, start:start + width], v[:, start:start + width]
            s = _einsum("bqhd,bkhd->bhqk", qb, kb).float()
            kpos = start + torch.arange(width, device=dev)[None, :]
            msk = (kpos <= qpos) & (kpos > qpos - window)
            s = torch.where(msk[None, None], s, -1e30)
            w = torch.softmax(s, dim=-1).to(qb.dtype)
            blocks.append(_einsum("bhqk,bkhd->bqhd", w, vb))
            continue
        ck = min(_KV_CHUNK, Skv)
        m = torch.full((B, H, cq), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32, device=dev)
        for ki in range(Skv // ck):
            kb = k[:, ki * ck:(ki + 1) * ck]
            vb = v[:, ki * ck:(ki + 1) * ck]
            s = _einsum("bqhd,bkhd->bhqk", qb, kb).float()
            if causal:
                kpos = ki * ck + torch.arange(ck, device=dev)[None, :]
                s = torch.where((kpos <= qpos)[None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _einsum(
                "bhqk,bkhd->bhqd", p.to(qb.dtype), vb).float()
            m = m_new
        ob = (acc / l[..., None]).to(qb.dtype)  # (B, H, cq, hd)
        blocks.append(ob.transpose(1, 2))
    return torch.stack(blocks, dim=1).reshape(B, Sq, H, hd)


def causal_mask(Sq: int, Skv: int, q_offset, window: int = 0, device=None):
    """(1, 1, Sq, Skv) bool; window > 0 = sliding window attention."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None, None]


def _q8(t: torch.Tensor):
    """int8 values and bf16 per-row scales: absmax / 127, floored at 1e-8,
    round half to even, clipped to +-127."""
    tf = t.float()
    s = torch.clamp(tf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return (torch.clamp(torch.round(tf / s), -127, 127).to(torch.int8),
            s.to(torch.bfloat16))


def _write_slot(buf: torch.Tensor, slot, val: torch.Tensor) -> None:
    """buf[:, slot] = val[:, 0] in place; `slot` a Python int or a 0-d
    tensor (then by `index_copy_`, so the host never waits on it)."""
    val = val.to(buf.dtype)
    if isinstance(slot, torch.Tensor):
        buf.index_copy_(1, slot.reshape(1).to(buf.device), val)
    else:
        buf[:, slot:slot + 1] = val


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        hd, H, KV, D = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
        dt = _dtype(cfg)
        self.wq = dense_init((D, H * hd), gen, device, dt)
        self.wk = dense_init((D, KV * hd), gen, device, dt)
        self.wv = dense_init((D, KV * hd), gen, device, dt)
        self.wo = dense_init((H * hd, D), gen, device, dt)
        if cfg.qkv_bias:
            self.bq = const_param(torch.zeros(H * hd, dtype=dt), device)
            self.bk = const_param(torch.zeros(KV * hd, dtype=dt), device)
            self.bv = const_param(torch.zeros(KV * hd, dtype=dt), device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)

    def _project_qkv(self, cfg, xq, xkv, q_positions, kv_positions, use_rope):
        B, Sq, _ = xq.shape
        Skv = xkv.shape[1]
        hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        q, k, v = xq @ self.wq, xkv @ self.wk, xkv @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = split_heads(q, (B, Sq, H, hd))
        k = split_heads(k, (B, Skv, KV, hd))
        v = split_heads(v, (B, Skv, KV, hd))
        if cfg.qk_norm:
            q = self.q_norm(q, cfg.norm_eps)
            k = self.k_norm(k, cfg.norm_eps)
        if use_rope:
            q = apply_rope(q, q_positions, cfg.rope_theta)
            k = apply_rope(k, kv_positions, cfg.rope_theta)
        return q, k, v

    def forward(self, cfg: ArchConfig, x, positions, *, mode: str = "causal",
                window: int = 0, kv_src=None, cache: dict | None = None,
                cache_pos=None):
        """Returns (out, cache).  Full-sequence when `cache` is None (the
        returned cache holds this call's K/V); otherwise one-token decode
        at `cache_pos` that writes into the (B, L, KV, hd) cache in place."""
        B, Sq, _ = x.shape
        if mode == "cross":
            if cache is not None:
                k, v = cache["k"], cache["v"]  # precomputed encoder KV
                q = split_heads(x @ self.wq, (B, Sq, cfg.n_heads, cfg.hd))
                if cfg.qk_norm:
                    q = self.q_norm(q, cfg.norm_eps)
                out = _sdpa(q, k, v, None, cfg)
                return out.reshape(B, Sq, -1) @ self.wo, cache
            kv_pos = torch.arange(kv_src.shape[1], device=x.device)[None]
            q, k, v = self._project_qkv(cfg, x, kv_src, positions, kv_pos,
                                        use_rope=False)
            out = _sdpa(q, k, v, None, cfg)
            return out.reshape(B, Sq, -1) @ self.wo, {"k": k, "v": v}

        if cache is None:
            q, k, v = self._project_qkv(cfg, x, x, positions, positions, True)
            if (Sq > CHUNKED_ATTN_THRESHOLD and Sq % _Q_CHUNK == 0
                    and mode != "bidir"):
                out = _chunked_attention(q, k, v, cfg, causal=True,
                                         window=window)
            else:
                mask = (None if mode == "bidir"
                        else causal_mask(Sq, Sq, 0, window, x.device))
                out = _sdpa(q, k, v, mask, cfg)
            return out.reshape(B, Sq, -1) @ self.wo, {"k": k, "v": v}

        # ---- decode: Sq == 1, write into the cache ----------------------
        # Ring buffer: when the cache is no longer than the window (sliding
        # window archs allocate L == window), slot = pos mod L and every
        # filled slot lies inside the window.
        q, k, v = self._project_qkv(cfg, x, x, positions, positions, True)
        L = cache["k"].shape[1]
        ring = window > 0 and L <= window
        slot = cache_pos % L if ring else cache_pos
        if cfg.quantize_kv and "k_scale" in cache:
            k8, ks = _q8(k)
            v8, vs = _q8(v)
            for name, val in (("k", k8), ("v", v8), ("k_scale", ks),
                              ("v_scale", vs)):
                _write_slot(cache[name], slot, val)
            k_cache = cache["k"].to(torch.bfloat16) * cache["k_scale"]
            v_cache = cache["v"].to(torch.bfloat16) * cache["v_scale"]
        else:
            _write_slot(cache["k"], slot, k)
            _write_slot(cache["v"], slot, v)
            k_cache, v_cache = cache["k"], cache["v"]
        kpos = torch.arange(L, device=x.device)[None, :]
        # a ring's filled slots are those up to pos, all L once it wraps
        # (JAX: kpos < min(pos + 1, L), the same set for kpos < L)
        valid = kpos <= cache_pos
        if window > 0 and not ring:
            valid = valid & (kpos > cache_pos - window)
        out = _sdpa(q, k_cache, v_cache, valid[None, None], cfg)
        return out.reshape(B, Sq, -1) @ self.wo, cache


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, gen, device, d_ff: int | None = None):
        super().__init__()
        dff = d_ff or cfg.d_ff
        dt = _dtype(cfg)
        self.wg = dense_init((cfg.d_model, dff), gen, device, dt)
        self.wu = dense_init((cfg.d_model, dff), gen, device, dt)
        self.wd = dense_init((dff, cfg.d_model), gen, device, dt)

    def forward(self, cfg: ArchConfig, x):
        return (act_fn(cfg.act)(x @ self.wg) * (x @ self.wu)) @ self.wd


# ---------------------------------------------------------------------------
# MoE: sort-free bucket dispatch with static capacity (dropping)
# ---------------------------------------------------------------------------
# top-k routing -> position-in-expert by one one-hot cumsum over the
# flattened (S*k) order -> scatter into (E, cap, d) buckets per batch row ->
# three batched expert matmuls -> gather + weighted combine.  A choice whose
# position reaches the capacity is dropped.

class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        dt = _dtype(cfg)
        self.router = dense_init((D, E), gen, device, torch.float32,
                                 scale=0.02)
        self.wg = dense_init((E, D, Fd), gen, device, dt)
        self.wu = dense_init((E, D, Fd), gen, device, dt)
        self.wd = dense_init((E, Fd, D), gen, device, dt)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, gen, device,
                              d_ff=cfg.d_ff * cfg.n_shared_experts)

    def forward(self, cfg: ArchConfig, x):
        """x: (B, S, D) -> (B, S, D).  Routing, positions and buckets are
        per batch row (the JAX package's grouped dispatch); the capacity
        per row is max(1, int(cf * S * k / E))."""
        B, S, D = x.shape
        E, k = cfg.n_experts, cfg.top_k
        cap = max(1, int(cfg.capacity_factor * S * k / E))
        logits = x.float() @ self.router                       # (B, S, E)
        topv, topi = torch.topk(logits, k, dim=-1)
        weights = torch.softmax(topv, dim=-1)                  # (B, S, k)
        flat_e = topi.reshape(B, S * k)
        onehot = F.one_hot(flat_e, E)
        pos = torch.cumsum(onehot, dim=1) - onehot
        pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
        keep = pos < cap
        tok_idx = torch.arange(S * k, device=x.device) // k
        e_idx = torch.where(keep, flat_e, 0)
        p_idx = torch.where(keep, pos, cap - 1)
        src = torch.where(keep[..., None], x[:, tok_idx], 0)
        b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
        # out of place: under DTensor `src` is one, the fresh zeros are not
        buckets = torch.zeros((B, E, cap, D), dtype=x.dtype,
                              device=x.device).index_put(
            (b_idx, e_idx, p_idx), src, accumulate=True)
        # group axis on data, expert axis on model: expert compute is fully
        # partitioned over the whole mesh
        buckets = constrain(buckets, "batch", "model", None, None)

        h = _einsum("gecd,edf->gecf", buckets, self.wg)
        h = act_fn(cfg.act)(h) * _einsum("gecd,edf->gecf", buckets, self.wu)
        out_buckets = _einsum("gecf,efd->gecd", h, self.wd)    # (B, E, cap, D)
        out_buckets = constrain(out_buckets, "batch", "model", None, None)

        gathered = out_buckets[b_idx, e_idx, p_idx]            # (B, S*k, D)
        gathered = torch.where(keep[..., None], gathered, 0)
        w = weights.reshape(B, S * k, 1).to(x.dtype)
        y = (gathered * w).reshape(B, S, k, D).sum(dim=2)
        if cfg.n_shared_experts:
            y = y + self.shared(cfg, x)
        return y
