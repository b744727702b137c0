"""Device-side token sampling (port of ``fastllama_tpu/ops/sampling.py``).

Greedy argmax at temperature <= 0, otherwise temperature softmax with a
top-p nucleus filter, drawn by the Gumbel-max rule as
``jax.random.categorical`` draws.  Noise comes from ``torch.Generator``s
in place of JAX keys, so draws differ from JAX's PRNG; the distributions
they sample (``nucleus_dist``, ``nucleus_dist_dynamic``) are the same.
"""
from __future__ import annotations

from typing import Sequence

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis (first index on ties)."""
    return torch.argmax(logits, dim=-1)


def _gumbel_argmax(logits: torch.Tensor, uniform: torch.Tensor
                   ) -> torch.Tensor:
    """argmax(logits + Gumbel noise), the noise made from U(0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(uniform.to(torch.float32), tiny, 1.0 - 2 ** -24)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _categorical(logits: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return _gumbel_argmax(logits, u)


def _nucleus_cutoff(probs: torch.Tensor, top_p) -> torch.Tensor:
    """The smallest kept probability: tokens are kept while the mass
    strictly before them is < top_p (sampling.py:30-36)."""
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_mass = cum - sorted_probs < top_p
    return torch.where(keep_mass, sorted_probs,
                       torch.ones_like(sorted_probs)).amin(dim=-1,
                                                           keepdim=True)


def sample_top_p(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float, top_p: float) -> torch.Tensor:
    """Temperature + nucleus sampling with static parameters: the smallest
    prefix of descending probabilities whose mass reaches ``top_p``
    (inclusive of the crossing token); top_p outside (0, 1) samples the
    whole softmax."""
    lf = logits.to(torch.float32) / max(temperature, 1e-6)
    if top_p <= 0.0 or top_p >= 1.0:
        return _categorical(lf, generator)
    probs = torch.softmax(lf, dim=-1)
    masked = torch.where(probs >= _nucleus_cutoff(probs, top_p), lf,
                         torch.full_like(lf, float("-inf")))
    return _categorical(masked, generator)


def nucleus_dist(logits: torch.Tensor, temperature: float,
                 top_p: float) -> torch.Tensor:
    """The normalized distribution :func:`sample_top_p` samples from."""
    lf = logits.to(torch.float32) / max(temperature, 1e-6)
    probs = torch.softmax(lf, dim=-1)
    if top_p <= 0.0 or top_p >= 1.0:
        return probs
    kept = torch.where(probs >= _nucleus_cutoff(probs, top_p), probs,
                       torch.zeros_like(probs))
    return kept / kept.sum(dim=-1, keepdim=True)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float, top_p: float) -> torch.Tensor:
    """Greedy at temperature 0, else :func:`sample_top_p` (the static
    branch of sampling.py:59-65)."""
    if temperature == 0.0:
        return greedy(logits)
    return sample_top_p(logits, generator, temperature, top_p)


def _nucleus_keep(probs: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Tokens inside the nucleus: the smallest prefix of descending
    probabilities whose mass before each kept token is < top_p; top_p >= 1
    keeps every token."""
    cutoff = _nucleus_cutoff(probs, torch.clamp(top_p, 1e-9, 1.0)[..., None])
    return torch.logical_or(top_p[..., None] >= 1.0, probs >= cutoff)


def _as_rows(v, logits: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32,
                           device=logits.device).expand(logits.shape[:-1])


def sample_dynamic(logits: torch.Tensor, uniform: torch.Tensor,
                   temperature, top_p) -> torch.Tensor:
    """Per-row sampling with per-row temperature/top_p.  ``uniform`` holds
    U(0, 1) noise of logits' shape, turned into Gumbel noise for the draw.
    temperature <= 0 is greedy."""
    lf = logits.to(torch.float32)
    temperature = _as_rows(temperature, lf)
    top_p = _as_rows(top_p, lf)
    g = greedy(lf)
    scaled = lf / torch.clamp(temperature, min=1e-6)[..., None]
    probs = torch.softmax(scaled, dim=-1)
    masked = torch.where(_nucleus_keep(probs, top_p), scaled,
                         torch.full_like(scaled, float("-inf")))
    return torch.where(temperature <= 0.0, g, _gumbel_argmax(masked, uniform))


def nucleus_dist_dynamic(logits: torch.Tensor, temperature,
                         top_p) -> torch.Tensor:
    """The normalized distribution :func:`sample_dynamic` samples from
    (temperature <= 0: a delta at the argmax)."""
    lf = logits.to(torch.float32)
    temperature = _as_rows(temperature, lf)
    top_p = _as_rows(top_p, lf)
    gdelta = torch.nn.functional.one_hot(greedy(lf), lf.shape[-1]).to(
        torch.float32)
    scaled = lf / torch.clamp(temperature, min=1e-6)[..., None]
    probs = torch.softmax(scaled, dim=-1)
    p = torch.where(_nucleus_keep(probs, top_p), probs,
                    torch.zeros_like(probs))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.where((temperature <= 0.0)[..., None], gdelta, p)


def sample_batched(logits: torch.Tensor,
                   generators: Sequence[torch.Generator],
                   temperatures: torch.Tensor,
                   top_ps: torch.Tensor) -> torch.Tensor:
    """Per-slot sampling over (B, V) logits: row b draws its noise from
    ``generators[b]`` (each on logits' device), so a request's draws do not
    depend on its neighbours.  Returns (B,) token ids."""
    B, V = logits.shape
    u = torch.stack([torch.rand(V, generator=gen, device=logits.device)
                     for gen in generators[:B]])
    return sample_dynamic(logits, u, temperatures, top_ps)
