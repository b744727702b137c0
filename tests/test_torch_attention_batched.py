"""``ops/attention.gqa_attention_batched`` (the per-slot masked GQA
attention) and ``update_kv_cache_at`` against the JAX package on the same
numpy inputs.  Mixed per-slot positions, T = 1 and 5, GQA hgs 1, 2 and 4;
f32 q within 2e-5 (another summation order), bf16 q within 1e-2 of
max|ref| (the output rounds to bf16 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu.ops import attention as jatt
from fastllama_tpu_torch.ops import attention as tatt


def _inputs(seed, B, n_heads, n_kv, T, S, hs):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, n_heads, T, hs)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hs)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hs)).astype(np.float32)
    # slot 0 at the start, the last at the end of the cache, the rest mixed
    pos = rng.integers(0, S - T + 1, size=B).astype(np.int32)
    pos[0], pos[-1] = 0, S - T
    return q, k, v, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("n_heads,n_kv", [(4, 4), (8, 4), (8, 2)])
def test_gqa_attention_batched_matches_jax(dtype, T, n_heads, n_kv):
    q, k, v, pos = _inputs(T + n_kv, 4, n_heads, n_kv, T, 40, 16)
    jq = jnp.asarray(q, jnp.dtype(dtype))
    want = np.asarray(jatt.gqa_attention_batched(
        jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)
    ).astype(jnp.float32))
    tq = torch.tensor(q).to(getattr(torch, dtype))
    got = tatt.gqa_attention_batched(tq, torch.tensor(k), torch.tensor(v),
                                     torch.tensor(pos))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


def test_gqa_attention_batched_is_per_slot_gqa_attention():
    """Each slot equals the single-stream ``gqa_attention`` at its own
    position: the per-slot mask is the only difference."""
    q, k, v, pos = _inputs(0, 3, 8, 4, 3, 32, 16)
    got = tatt.gqa_attention_batched(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), torch.tensor(pos))
    for b in range(3):
        one = tatt.gqa_attention(torch.tensor(q[b]), torch.tensor(k[b]),
                                 torch.tensor(v[b]), int(pos[b]))
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_kv_cache_at_equals_host_write(dtype):
    """Rows written at device positions equal the host-int write, bit for
    bit, in both cache dtypes."""
    rng = np.random.default_rng(1)
    kc = torch.tensor(rng.standard_normal((2, 16, 8)).astype(np.float32)
                      ).to(dtype)
    vc = kc.clone() * 2
    kn = torch.tensor(rng.standard_normal((2, 3, 8)).astype(np.float32))
    vn = kn * 3
    want = tatt.update_kv_cache(kc.clone(), vc.clone(), kn, vn, 11)
    got = tatt.update_kv_cache_at(kc.clone(), vc.clone(), kn, vn,
                                  torch.arange(11, 14, dtype=torch.int32))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
