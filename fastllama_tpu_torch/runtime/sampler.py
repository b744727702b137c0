"""Host-side sampler reproducing the reference's exact RNG and algorithms
(port of ``fastllama_tpu/runtime/sampler.py``): numpy only, so its draws
are bit-equal to the JAX package's.  ``Engine.generate(host_sampling=True)``
samples through it; the default path samples on the device
(``ops/sampling.py``).
"""
from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


class XorshiftRng:
    """xorshift64*."""

    def __init__(self, seed: int):
        self.state = seed & MASK64

    def random_u32(self) -> int:
        s = self.state
        s ^= (s >> 12)
        s ^= (s << 25) & MASK64
        s ^= (s >> 27)
        self.state = s
        return ((s * 0x2545F4914F6CDD1D) & MASK64) >> 32

    def random_f32(self) -> float:
        return (self.random_u32() >> 8) / 16777216.0


class HostSampler:
    """Greedy / temperature / top-p over host logits."""

    def __init__(self, vocab_size: int, seed: int = 128391297):
        self.vocab_size = vocab_size
        self.rng = XorshiftRng(seed)

    def sample(self, logits: np.ndarray, temperature: float,
               topp: float) -> int:
        logits = np.asarray(logits, np.float32).copy()
        if temperature == 0.0:
            return int(np.argmax(logits))
        logits /= temperature
        e = np.exp(logits - logits.max())
        probs = e / e.sum()
        coin = self.rng.random_f32()
        if topp <= 0 or topp >= 1:
            cdf = np.cumsum(probs)
            return int(np.searchsorted(cdf, coin, side="right"))
        return self._sample_topp(probs, topp, coin)

    def _sample_topp(self, probs: np.ndarray, topp: float,
                     coin: float) -> int:
        """Cutoff pre-filter, descending sort, truncate at cumulative >
        topp, renormalized CDF sample."""
        n = self.vocab_size
        cutoff = (1.0 - topp) / (n - 1)
        idx = np.nonzero(probs >= cutoff)[0]
        order = idx[np.argsort(-probs[idx], kind="stable")]
        p = probs[order]
        cum = np.cumsum(p)
        last = int(np.argmax(cum > topp)) if (cum > topp).any() \
            else len(p) - 1
        r = coin * cum[last]
        sub = np.searchsorted(np.cumsum(p[:last + 1]), r, side="right")
        sub = min(sub, last)
        return int(order[sub])
