"""Speculative decoding (Leviathan et al.) in PyTorch - the compute core of
the paper's Disg-Spec-Decode optimizer (§2.2, §4.1); a port of
src/repro/core/spec_decode.py.

One *round*:
  1. the draft model autoregressively proposes K tokens (K serve_steps,
     plus one bookkeeping step so its cache stays consistent when all K
     are accepted),
  2. the target model scores [last, d_1..d_K] in ONE extend_step pass,
  3. the verifier accepts d_i with probability min(1, q_i/p_i) (exact
     rejection sampling), resamples the first rejected position from the
     residual max(q - p, 0), or samples a bonus token when all K are
     accepted.

Everything is batched; acceptance lengths vary per sequence and cache
rollback is per-sequence via the (B,) `pos` vector (stale KV above `pos`
is masked and later overwritten). Random draws come from one
`torch.Generator`, in a fixed order, where the reference splits jax.random
keys; the two give different numbers from the same seed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DEFAULT_EXEC, ExecConfig


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    num_draft_tokens: int = 4     # K
    temperature: float = 1.0


def _sample(gen: torch.Generator, probs):
    """Categorical sample from a (B, V) probability matrix."""
    return torch.multinomial(probs.clamp_min(1e-30), 1, generator=gen)[:, 0]


def _probs(logits, temperature: float):
    return torch.softmax(logits.float() / max(temperature, 1e-4), dim=-1)


def draft_propose(params, cache, last_tokens, cfg: ModelConfig, spec: SpecConfig,
                  gen: torch.Generator, exec_cfg: ExecConfig = DEFAULT_EXEC):
    """Propose K draft tokens. Returns (tokens (B,K), probs (B,K,V), cache).

    Runs K+1 serve_steps: [last, d_1..d_K]. The final step only advances the
    draft cache so that the all-accepted case leaves it consistent."""
    tokens, probs = [], []
    cur = last_tokens
    for _ in range(spec.num_draft_tokens):
        logits, cache = backbone.serve_step(params, cache, cur, cfg, exec_cfg)
        p = _probs(logits, spec.temperature)
        cur = _sample(gen, p).to(torch.int32)
        tokens.append(cur)
        probs.append(p)
    _, cache = backbone.serve_step(params, cache, cur, cfg, exec_cfg)  # bookkeeping
    return torch.stack(tokens, dim=1), torch.stack(probs, dim=1), cache


def verify(gen: torch.Generator, target_logits, draft_probs, draft_tokens,
           temperature: float = 1.0):
    """Exact rejection-sampling verification.

    target_logits (B, K+1, V): dists after [last, d_1..d_K]; draft_probs
    (B, K, V); draft_tokens (B, K). Returns (out_tokens (B, K+1),
    n_emitted (B,), n_accepted (B,)); out_tokens[:, :n_emitted] are
    committed, entries beyond are zeros."""
    b, k = draft_tokens.shape
    v = draft_probs.shape[-1]
    q = _probs(target_logits, temperature)                        # (B, K+1, V)
    dt = draft_tokens.long()[..., None]
    q_at = q[:, :k].gather(-1, dt)[..., 0]
    p_at = draft_probs.gather(-1, dt)[..., 0]
    u = torch.rand((b, k), generator=gen, device=q.device)
    accept = u < torch.clamp(q_at / p_at.clamp_min(1e-30), max=1.0)
    n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)        # (B,)

    # distribution for the extra token: residual at the rejection position,
    # or the target's bonus distribution when everything was accepted
    q_n = q.gather(1, n_acc[:, None, None].expand(b, 1, v))[:, 0]  # (B, V)
    p_n = draft_probs.gather(
        1, n_acc.clamp(max=k - 1)[:, None, None].expand(b, 1, v))[:, 0]
    residual = (q_n - p_n).clamp_min(0.0)
    res_sum = residual.sum(-1, keepdim=True)
    residual = torch.where(res_sum > 1e-30, residual / res_sum.clamp_min(1e-30), q_n)
    extra_dist = torch.where((n_acc == k)[:, None], q_n, residual)
    extra = _sample(gen, extra_dist).to(draft_tokens.dtype)        # (B,)

    idx = torch.arange(k + 1, device=q.device)[None, :]
    padded = torch.cat([draft_tokens, draft_tokens.new_zeros(b, 1)], dim=1)
    out = torch.where(idx < n_acc[:, None], padded, 0)
    out = torch.where(idx == n_acc[:, None], extra[:, None], out)
    return out, n_acc + 1, n_acc


def spec_decode_round(target_params, target_cfg: ModelConfig, target_cache,
                      draft_params, draft_cfg: ModelConfig, draft_cache,
                      last_tokens, spec: SpecConfig, gen: torch.Generator,
                      exec_cfg: ExecConfig = DEFAULT_EXEC):
    """One full draft -> transfer -> verify cycle.

    Returns dict with committed tokens, per-sequence counts, updated caches
    and the inter-pool payload sizes (token ids vs draft probs) that the
    disaggregation layer prices against the interconnect (paper Fig. 7).
    """
    for c, which in ((target_cfg, "target"), (draft_cfg, "draft")):
        if c.family in ("ssm", "hybrid"):
            # extend_step verification works for recurrent families, but
            # per-sequence rollback would need per-step state checkpoints;
            # the serving layer routes these archs to standard decode
            # (DESIGN.md §4 Arch-applicability).
            raise NotImplementedError(
                f"spec-decode {which} model {c.name} is recurrent ({c.family}); "
                "per-sequence state rollback is not supported"
            )
    k = spec.num_draft_tokens
    t_pos0 = target_cache["pos"]
    d_pos0 = draft_cache["pos"]

    d_tokens, d_probs, draft_cache = draft_propose(
        draft_params, draft_cache, last_tokens, draft_cfg, spec, gen, exec_cfg)

    target_in = torch.cat([last_tokens[:, None], d_tokens], dim=1)  # (B, K+1)
    t_logits, target_cache = backbone.extend_step(
        target_params, target_cache, target_in, target_cfg, exec_cfg)

    out, n_emitted, n_acc = verify(gen, t_logits, d_probs, d_tokens, spec.temperature)

    # per-sequence rollback: keep prefix + last + accepted drafts processed
    target_cache = dict(target_cache, pos=(t_pos0 + 1 + n_acc).to(torch.int32))
    draft_cache = dict(draft_cache, pos=(d_pos0 + 1 + n_acc).to(torch.int32))

    new_last = out.gather(1, n_acc[:, None])[:, 0]
    b = last_tokens.shape[0]
    return {
        "tokens": out,
        "n_emitted": n_emitted,
        "n_accepted": n_acc,
        "new_last": new_last,
        "target_cache": target_cache,
        "draft_cache": draft_cache,
        # bytes crossing the pool boundary per round (Fig. 4 / Fig. 7);
        # draft probs ship fp16 (the verifier's acceptance test tolerates it)
        "bytes_token_ids": b * k * 4,
        "bytes_draft_probs": b * k * draft_cfg.vocab_size * 2,
    }


def expected_tokens_per_round(alpha: float, k: int) -> float:
    """E[#emitted tokens] for per-token acceptance rate alpha (analytic)."""
    if abs(1.0 - alpha) < 1e-9:
        return float(k + 1)
    return float((1.0 - alpha ** (k + 1)) / (1.0 - alpha))
