"""Mamba2 — SSD (state-space duality) blocks with a chunked scan
(arXiv:2405.21060); the port of `repro/models/ssm.py`.

The algorithm is the JAX package's: a quadratic intra-chunk term plus an
O(S) inter-chunk state recurrence, as batched einsums and one loop over
chunks.  Decode keeps O(1) state: the (B, H, N, P) SSM state and the
(B, conv-1, C) conv tail.

`jnp.einsum` promotes bf16 x f32 operands to f32 inside one call; here
`layers._einsum` casts them first, giving the same dtypes.  `jnp.split`'s
indices are `torch.tensor_split`'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.ctx import along, constrain, matmul, split_heads
from .config import ArchConfig
from .layers import RMSNorm, _dtype, _einsum, const_param, dense_init


def _causal_conv(conv_w, conv_b, cfg: ArchConfig, xbc, conv_state=None):
    """Depthwise causal conv over the sequence axis.

    xbc: (B, S, C). conv_state: (B, conv-1, C) tail of previous tokens.
    Returns (out, new_conv_state)."""
    K = cfg.ssm_conv
    B, S, C = xbc.shape
    if conv_state is None:
        pad = torch.zeros((B, K - 1, C), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    out = torch.zeros_like(xbc)
    for i in range(K):
        out = out + full[:, i:i + S, :] * conv_w[i]
    out = F.silu(out + conv_b)
    return out, full[:, -(K - 1):, :]


def _cumsum(x, dim: int):
    """`torch.cumsum`, but on a CUDA tensor under
    `torch.use_deterministic_algorithms` (CUDA's floating cumsum has no
    deterministic kernel and raises there; the straggler-coded train step
    turns the mode on) a product with a triangular matrix of ones.  Under
    a mesh, on a DTensor, on each rank's shard (`dist.ctx.along`)."""
    def local(t):
        if t.is_cuda and torch.are_deterministic_algorithms_enabled():
            n = t.shape[dim]
            tri = torch.ones((n, n), dtype=t.dtype, device=t.device).triu()
            return (t.movedim(dim, -1) @ tri).movedim(-1, dim)
        return torch.cumsum(t, dim=dim)
    return along(local, x, (dim,))


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) lower-tri cumulative sums:
    L[i,j] = sum_{j<t<=i} x_t, -inf above the diagonal."""
    Q = x.shape[-1]
    c = _cumsum(x, -1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(cfg: ArchConfig, xh, Bm, Cm, dt, A, initial_state=None):
    """Chunked SSD scan.

    xh: (B, S, H, P); Bm, Cm: (B, S, N); dt: (B, S, H) (post-softplus);
    A: (H,) negative decay rates. Returns (y (B,S,H,P), final_state (B,H,N,P)).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:  # pad the tail (causal: outputs before the pad are unaffected;
        # the returned final state assumes chunk-aligned prefill lengths)
        pad = Q - S % Q

        def zf(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        y, st = ssd_chunked(cfg, zf(xh), zf(Bm), zf(Cm), zf(dt), A,
                            initial_state)
        return y[:, :S], st
    nc = S // Q

    xc = xh.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    dtc = dt.reshape(Bsz, nc, Q, H)
    dA = dtc * A  # (B, nc, Q, H) negative

    # ---- intra-chunk (quadratic within Q) --------------------------------
    L = torch.exp(_segsum(dA.movedim(-1, -2)))  # (B, nc, H, Q, Q)
    scores = _einsum("bcqn,bckn->bcqk", Cc, Bc)[:, :, None] * L
    y_intra = _einsum("bchqk,bckh,bckhp->bcqhp", scores, dtc, xc)

    # ---- chunk states + inter-chunk recurrence ---------------------------
    dA_cum = _cumsum(dA, 2)                                # (B, nc, Q, H)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = _einsum("bcqn,bcqh,bcqhp->bchnp",
                     Bc, dtc * decay_to_end, xc)            # (B, nc, H, N, P)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])            # (B, nc, H)

    if initial_state is None:
        initial_state = torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                                    device=xh.device)
    carry = initial_state.float()
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(carry)
        carry = (carry * chunk_decay[:, c].float()[..., None, None]
                 + states[:, c].float())
    entering = torch.stack(entering, dim=1)                 # (B, nc, H, N, P)

    decay_from_start = torch.exp(dA_cum)                    # (B, nc, Q, H)
    y_inter = _einsum("bcqn,bcqh,bchnp->bcqhp",
                      Cc, decay_from_start, entering.to(Cc.dtype))
    y = (y_intra + y_inter.to(y_intra.dtype)).reshape(Bsz, S, H, P)
    return y, carry


class Mamba2(nn.Module):
    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        C = DI + 2 * N  # conv acts on the x, B, C streams
        dt = _dtype(cfg)
        f32 = torch.float32
        # projections: [z | x | B | C | dt]
        self.in_proj = dense_init((D, 2 * DI + 2 * N + H), gen, device, dt)
        self.conv_w = dense_init((cfg.ssm_conv, C), gen, device, dt, scale=0.5)
        self.conv_b = const_param(torch.zeros(C, dtype=dt), device)
        self.A_log = const_param(torch.log(torch.arange(1, H + 1, dtype=f32)),
                                 device)
        self.D = const_param(torch.ones(H, dtype=f32), device)
        self.dt_bias = const_param(torch.zeros(H, dtype=f32), device)
        self.norm = RMSNorm(DI, device)
        self.out_proj = dense_init((DI, D), gen, device, dt)

    def _split_proj(self, cfg: ArchConfig, u):
        DI, N = cfg.d_inner, cfg.ssm_state
        z, xbc, dt = torch.tensor_split(matmul(u, self.in_proj),
                                        [DI, 2 * DI + 2 * N], dim=-1)
        return z, xbc, dt

    def forward(self, cfg: ArchConfig, u, state=None):
        """u: (B, S, D). state: None (train/prefill) or
        {'conv': (B, K-1, C), 'ssm': (B, H, N, P)} for chunk-continuation.
        Returns (out, new_state)."""
        B, S, D = u.shape
        DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
        z, xbc, dtr = self._split_proj(cfg, u)
        conv_in = state["conv"] if state else None
        xbc, conv_tail = _causal_conv(self.conv_w, self.conv_b, cfg, xbc,
                                      conv_in)
        xh, Bm, Cm = torch.tensor_split(xbc, [DI, DI + N], dim=-1)
        xh = split_heads(xh, (B, S, H, P))
        dt = F.softplus(dtr.float() + self.dt_bias)
        A = -torch.exp(self.A_log)
        ssm_in = state["ssm"] if state else None
        y, final = ssd_chunked(cfg, xh, Bm, Cm, dt, A, ssm_in)
        y = y + xh * self.D[None, None, :, None].to(xh.dtype)
        y = y.reshape(B, S, DI)
        y = self.norm(y * F.silu(z.to(y.dtype)), cfg.norm_eps)
        out = matmul(y.to(u.dtype), self.out_proj).to(u.dtype)
        return out, {"conv": conv_tail, "ssm": final}

    def decode_step(self, cfg: ArchConfig, u, state):
        """Single-token decode: u (B, 1, D), O(1) state update.  Returns
        (out, new_state) with new tensors (the caller stores them)."""
        B, _, D = u.shape
        DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
        z, xbc, dtr = self._split_proj(cfg, u)
        # conv: the state holds the last K-1 inputs
        full = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)  # (B, K, C)
        conv_out = _einsum("bkc,kc->bc", full, self.conv_w) + self.conv_b
        conv_out = F.silu(conv_out)[:, None, :]
        new_conv = full[:, 1:, :]
        xh, Bm, Cm = torch.tensor_split(conv_out, [DI, DI + N], dim=-1)
        xh = split_heads(xh, (B, H, P))
        dt = F.softplus(dtr[:, 0].float() + self.dt_bias)  # (B, H)
        A = -torch.exp(self.A_log)
        decay = torch.exp(dt * A)  # (B, H)
        st = state["ssm"] * decay[..., None, None] + _einsum(
            "bn,bh,bhp->bhnp", Bm[:, 0].float(), dt, xh.float())
        y = _einsum("bn,bhnp->bhp", Cm[:, 0].float(), st)
        y = y.to(u.dtype) + xh * self.D[None, :, None].to(xh.dtype)
        # under a mesh, the heads over "model" (not head_dim, as the state
        # has it): DTensor folds (heads, head_dim) by its leading part only
        y = constrain(y, "batch", "model", None).reshape(B, 1, DI)
        y = self.norm(y * F.silu(z.to(y.dtype)), cfg.norm_eps)
        return matmul(y.to(u.dtype), self.out_proj).to(u.dtype), {
            "conv": new_conv, "ssm": st}
