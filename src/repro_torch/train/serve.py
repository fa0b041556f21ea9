"""Serving steps: prefill (full-sequence logits) and decode (one token per
request against the cache); the port of `repro/train/serve.py`."""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill(params, batch):
        return M.forward(cfg, params, batch)

    return prefill


def make_decode_step(cfg: ArchConfig):
    def decode(params, token, pos, cache, enc_out=None):
        return M.decode_step(cfg, params, token, pos, cache, enc_out)

    return decode


@torch.no_grad()
def greedy_generate(cfg: ArchConfig, params, prompt: torch.Tensor, steps: int,
                    max_len: int = 256, return_logits: bool = False):
    """Batched greedy generation: the prompt (B, S) is consumed token by
    token (teacher-forced), then `steps` tokens are taken by argmax (the
    first maximum).  Returns the (B, S + steps) tokens and, with
    `return_logits`, the (B, S + steps - 1, V) logits of every step.

    Runs on the prompt's device with `pos` a Python int: the host never
    waits for the device inside the loop."""
    B, S = prompt.shape
    cache = M.init_cache(cfg, B, max_len, device=prompt.device)
    tok = prompt[:, 0]
    out, logits_all = [tok], []
    for t in range(S + steps - 1):
        logits, cache = M.decode_step(cfg, params, tok, t, cache)
        if return_logits:
            logits_all.append(logits)
        if t + 1 < S:
            tok = prompt[:, t + 1]  # teacher-forced prompt consumption
        else:
            tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        out.append(tok)
    tokens = torch.stack(out, dim=1)
    if return_logits:
        return tokens, torch.stack(logits_all, dim=1)
    return tokens
