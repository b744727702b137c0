"""LLaMA forward pass and parameters for the port (part of
``fastllama_tpu/models/llama.py``: ``LlamaParams``, ``KVCache``,
``embed_tokens``, ``fuse_params``, ``forward``, ``logits_at``,
``truncate_params``, ``requantize_params``, ``random_params``,
``random_params_int``, ``build_params``) plus ``params_from_numpy``, the
bridge that builds the port's parameters from the JAX package's arrays
handed over as numpy.

Projection matrices live in the transposed ``(in, out)`` layout with quant
groups along ``in`` (QArray.group_axis = -2), stacked over layers:
``(L, in, out)``.  ``w[l]`` of a contiguous stack is a view, which is how
the layer-indexed matmul reads a layer in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from fastllama_tpu_torch.config import ModelConfig, QuantType
from fastllama_tpu_torch.device import resolve_device, torch_dtype
from fastllama_tpu_torch.ops.attention import (gqa_attention,
                                               update_kv_cache,
                                               update_kv_cache_at)
from fastllama_tpu_torch.ops.norms import rmsnorm, swiglu
from fastllama_tpu_torch.ops.qmatmul import qmatmul
from fastllama_tpu_torch.ops.rope import apply_rope_half, rope_tables
from fastllama_tpu_torch.quant.groupquant import (QDTYPE, QArray, dequantize,
                                                  host_tensor, pack_int4_rows,
                                                  pack_supported, quantize)


@dataclasses.dataclass
class LlamaParams:
    """Layer-stacked weights: quantized leaves are :class:`QArray`, norms
    f32.  After :func:`fuse_params`, ``wq`` holds Q|K|V and ``w1`` gate|up
    (``wk``/``wv``/``w3`` are None)."""

    embedding: Any        # (vocab, dim)            QArray(ga=-1) | f32
    attn_norm: torch.Tensor  # (L, dim)             f32
    wq: Any               # (L, dim, n_heads*hs)
    wk: Any               # (L, dim, kv_dim)
    wv: Any               # (L, dim, kv_dim)
    wo: Any               # (L, n_heads*hs, dim)
    ffn_norm: torch.Tensor  # (L, dim)
    w1: Any               # (L, dim, hidden)        gate
    w2: Any               # (L, hidden, dim)        down
    w3: Any               # (L, dim, hidden)        up
    out_norm: torch.Tensor  # (dim,)
    classifier: Any       # (dim, vocab)

    def to(self, device) -> "LlamaParams":
        return LlamaParams(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})

    def quantized(self):
        """The QArray leaves, by field name."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), QArray)}


@dataclasses.dataclass
class KVCache:
    """The single-stream cache, ``(L, n_kv_heads, max_seq, head_size)`` per
    tensor, f32 or bf16.  An int8 cache (per-row scales) is a
    ``BatchedKVCache`` feature: ``create`` refuses it, as the JAX package
    does.  ``forward`` writes rows in place."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, max_seq_len: Optional[int] = None,
               dtype=torch.float32, device=None) -> "KVCache":
        dev = resolve_device(device)
        dtype = torch_dtype(dtype)
        if dtype == torch.int8:
            raise ValueError("int8 KV is a BatchedKVCache feature "
                             "(models/batched.py)")
        S = max_seq_len or cfg.max_seq_len
        shape = (cfg.n_layers, cfg.n_kv_heads, S, cfg.head_size)
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev))


def embed_tokens(emb, tokens: torch.Tensor, dtype=torch.float32
                 ) -> torch.Tensor:
    """Gather + dequantize embedding rows."""
    tokens = tokens.to(torch.long)
    if isinstance(emb, QArray):
        rows = QArray(emb.data[tokens], emb.scales[tokens], emb.qtype,
                      emb.group_size)
        return dequantize(rows, dtype)
    return emb[tokens].to(dtype)


def fuse_params(cfg: ModelConfig, params: LlamaParams) -> LlamaParams:
    """Concatenate Q|K|V and gate|up along the out-features axis (data and
    scales alike: groups run along the shared contraction axis).  Refuses
    projections with mixed quant layouts."""
    def cat(ws):
        if isinstance(ws[0], QArray):
            statics = {(w.qtype, w.group_size, w.group_axis, w.packed)
                       for w in ws}
            if len(statics) != 1:
                raise ValueError(
                    f"fuse_weights: projections have mixed quant layouts "
                    f"{statics}; load without fuse_weights")
            return QArray(torch.cat([w.data for w in ws], dim=-1),
                          torch.cat([w.scales for w in ws], dim=-1),
                          ws[0].qtype, ws[0].group_size, ws[0].group_axis,
                          ws[0].packed)
        return torch.cat(ws, dim=-1)

    return dataclasses.replace(
        params,
        wq=cat([params.wq, params.wk, params.wv]), wk=None, wv=None,
        w1=cat([params.w1, params.w3]), w3=None)


def forward(cfg: ModelConfig, params: LlamaParams, tokens: torch.Tensor,
            pos: Optional[int], cache: KVCache, *, mm: Callable = qmatmul,
            attn: Callable = gqa_attention, unroll: bool = False,
            mm_idx: Optional[Callable] = None,
            attn_idx: Optional[Callable] = None,
            last_index: Optional[int] = None,
            compute_dtype=torch.float32,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """One transformer step over T tokens at absolute positions
    [pos, pos+T): prefill (T = a prompt block) or decode (T = 1).  Returns
    per-token logits (T, vocab) f32 and the cache, whose rows
    [pos, pos+T) of every layer are written in place before attention
    reads them.

    One Python loop over layers (JAX's four scan/unroll modes collapse into
    it; ``unroll`` is accepted and has no meaning here).  The hooks:
    ``mm_idx(h, w_stacked, layer, ...)`` reads a layer of the stacked
    weights in place, else ``mm(h, w[layer])``; ``attn_idx(q, ck, cv,
    pos, layer)`` reads the stacked cache in place, else ``attn(q, ck[l],
    cv[l], pos)``.  When ``mm_idx.supports_fusion`` is set, the two
    residual adds of each layer run inside the matmul (K1f), and so do the
    two rmsnorms when QKV and gate|up are fused, as ``layer_fn`` does
    (llama.py:175-233).

    ``pos`` is a host int (it places the cache rows).  ``positions`` is the
    (T,) int32 device tensor ``pos + arange(T)``, made here when None; the
    decode chunk passes a slice of one it made per chunk, so a step copies
    nothing from the host.  The attention hooks get ``positions[:1]``.
    ``last_index`` keeps one row for the classifier (a padded prefill).

    ``pos=None`` places the rows at the device ``positions`` instead (a
    copy along the cache's row axis at those indices), so that a caller
    whose position lives on the device (the speculative engine's rounds)
    never reads it back.  That path does not check that the rows fit the
    cache: its caller guarantees it (``SpeculativeEngine``'s room rule
    leaves every block it queues inside ``max_seq_len``)."""
    T = tokens.shape[0]
    hs, n_heads, n_kv = cfg.head_size, cfg.n_heads, cfg.n_kv_heads
    S = cache.k.shape[2]
    if pos is None:
        if positions is None:
            raise ValueError("forward at pos=None needs device positions")
    elif not 0 <= pos <= S - T:
        raise ValueError(f"positions [{pos}, {pos + T}) do not fit a cache "
                         f"of {S} rows")
    elif positions is None:
        positions = torch.arange(pos, pos + T, dtype=torch.int32,
                                 device=tokens.device)
    pos_t = positions[:1]

    x = embed_tokens(params.embedding, tokens, compute_dtype)       # (T, dim)
    cos, sin = rope_tables(cfg, positions, compute_dtype)

    fused = params.wk is None
    # the residual adds fold into the matmul whenever the hook can; the
    # norms only when QKV and gate|up are fused (llama.py:186-232)
    fuse_res = getattr(mm_idx, "supports_fusion", False)
    fuse_norm = fused and fuse_res
    qdim, kvdim, hdim = n_heads * hs, cfg.kv_dim, cfg.hidden_dim

    for l in range(cfg.n_layers):
        if mm_idx is not None:
            def proj(h, w, l=l, **kw):
                return mm_idx(h, w, l, **kw)
        else:
            def proj(h, w, l=l):
                return mm(h, w[l])

        if fuse_norm:
            qkv = proj(x, params.wq, norm_gain=params.attn_norm[l],
                       eps=cfg.norm_eps)
        else:
            h = rmsnorm(x, params.attn_norm[l], cfg.norm_eps)
            qkv = (proj(h, params.wq) if fused else
                   torch.cat([proj(h, params.wq), proj(h, params.wk),
                              proj(h, params.wv)], dim=-1))
        q = qkv[:, :qdim].reshape(T, n_heads, hs).transpose(0, 1)
        k = qkv[:, qdim:qdim + kvdim].reshape(T, n_kv, hs).transpose(0, 1)
        v = qkv[:, qdim + kvdim:].reshape(T, n_kv, hs).transpose(0, 1)
        q = apply_rope_half(q, cos[None], sin[None])
        k = apply_rope_half(k, cos[None], sin[None])

        if pos is None:
            update_kv_cache_at(cache.k[l], cache.v[l], k, v, positions)
        else:
            update_kv_cache(cache.k[l], cache.v[l], k, v, pos)
        if attn_idx is not None:
            o = attn_idx(q, cache.k, cache.v, pos_t, l)           # (H, T, hs)
        else:
            o = attn(q, cache.k[l], cache.v[l], pos_t)
        o = o.transpose(0, 1).reshape(T, n_heads * hs).contiguous()
        x = proj(o, params.wo, residual=x) if fuse_res \
            else x + proj(o, params.wo)
        if fuse_norm:
            g13 = proj(x, params.w1, norm_gain=params.ffn_norm[l],
                       eps=cfg.norm_eps)
        else:
            h = rmsnorm(x, params.ffn_norm[l], cfg.norm_eps)
            g13 = (proj(h, params.w1) if fused else
                   torch.cat([proj(h, params.w1), proj(h, params.w3)],
                             dim=-1))
        hd = swiglu(g13[:, :hdim], g13[:, hdim:])
        x = proj(hd, params.w2, residual=x) if fuse_res \
            else x + proj(hd, params.w2)

    if last_index is not None:
        x = x[last_index:last_index + 1]
    x = rmsnorm(x, params.out_norm, cfg.norm_eps)
    logits = mm(x, params.classifier)                            # (T, vocab)
    return logits.to(torch.float32), cache


def logits_at(logits: torch.Tensor, length: int) -> torch.Tensor:
    """Logits of the last valid token of a padded prefill."""
    return logits[length - 1]


def truncate_params(cfg: ModelConfig, params: LlamaParams, n_layers: int
                    ) -> Tuple[ModelConfig, LlamaParams]:
    """(cfg', params') keeping only the first ``n_layers`` layers: a draft
    model for speculative decoding made from the target's own weights
    (``fastllama_tpu/models/llama.py:480``).  Every stacked leaf (QArray
    data and scales, the norms) keeps its first ``n_layers`` layers; the
    embedding, classifier and ``out_norm`` are shared.  The slices are
    copies, so the draft holds ``n_layers / L`` of the layer bytes again.
    Takes parameters before :func:`fuse_params`, as an ``Engine`` does."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"n_layers {n_layers} out of range")

    def take(w):
        if isinstance(w, QArray):
            return QArray(w.data[:n_layers].clone(),
                          w.scales[:n_layers].clone(), w.qtype,
                          w.group_size, w.group_axis, w.packed)
        return w[:n_layers].clone()

    p = dataclasses.replace(params, **{
        name: take(getattr(params, name))
        for name in ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w1",
                     "w2", "w3")})
    return cfg.replace(n_layers=n_layers), p


def requantize_params(cfg: ModelConfig, params: LlamaParams,
                      qtype: QuantType) -> LlamaParams:
    """Every QArray quantized again to ``qtype`` through its current
    quantization (dequantize to f32, then :func:`quantize` along the same
    group axis, truncating toward zero): the same weights at a lower
    precision, a draft for speculative decoding
    (``fastllama_tpu/models/llama.py:506``).  Norms and unquantized leaves
    pass through; a packed leaf raises, as in the JAX package.

    The JAX function runs under ``jit``, where XLA turns the scale's
    division by QF into a product with QF's f32 reciprocal; the port
    computes the scale the same way, so the two agree bit for bit."""
    recip = torch.tensor(1.0, dtype=torch.float32) / float(qtype.factor)

    def requant(fp, gs):
        """(data, scales) of ``fp`` quantized along its last axis."""
        g = fp.reshape(*fp.shape[:-1], fp.shape[-1] // gs, gs)
        scale = g.abs().amax(dim=-1) * recip.to(fp.device)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.trunc(g / safe[..., None]).to(QDTYPE[qtype])
        return q.reshape(fp.shape), scale

    def conv(w):
        if not isinstance(w, QArray):
            return w
        if w.packed:
            raise ValueError("requantize of packed INT4 not supported")
        fp = dequantize(w, torch.float32)
        if w.group_axis == -2:       # groups along the contraction axis
            data, scales = requant(fp.transpose(-1, -2), w.group_size)
            return QArray(data.transpose(-1, -2).contiguous(),
                          scales.transpose(-1, -2).contiguous(), qtype,
                          w.group_size, -2)
        data, scales = requant(fp, w.group_size)
        return QArray(data, scales, qtype, w.group_size, w.group_axis)

    return LlamaParams(**{f.name: conv(getattr(params, f.name))
                          for f in dataclasses.fields(LlamaParams)})


def _shapes(cfg: ModelConfig):
    L, D, H, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    kd, nh, hs = cfg.kv_dim, cfg.n_heads, cfg.head_size
    return dict(
        embedding=(V, D), wq=(L, D, nh * hs), wk=(L, D, kd), wv=(L, D, kd),
        wo=(L, nh * hs, D), w1=(L, D, H), w2=(L, H, D), w3=(L, D, H),
        classifier=(D, V))


def _norms(cfg: ModelConfig, dev: torch.device):
    L, D = cfg.n_layers, cfg.dim
    return dict(
        attn_norm=torch.ones((L, D), dtype=torch.float32, device=dev),
        ffn_norm=torch.ones((L, D), dtype=torch.float32, device=dev),
        out_norm=torch.ones((D,), dtype=torch.float32, device=dev))


def random_params(cfg: ModelConfig, seed: int = 0,
                  qtype: Optional[QuantType] = None,
                  scale: float = 0.02, device=None) -> LlamaParams:
    """Random parameters, made on the device from a ``torch.Generator``:
    every weight normal x ``scale`` in f32, norms one.  At
    ``QuantType.NONE`` the weights stay plain f32 tensors; otherwise each
    is quantized with :func:`quantize`, the embedding along its last axis
    and the projections along their contraction axis (group_axis -2,
    unpacked, as the JAX package's ``random_params`` leaves INT4).  Same
    recipe as the JAX package's; the values differ (another generator)."""
    qtype = qtype if qtype is not None else cfg.quant_type
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gs = cfg.group_size
    out = _norms(cfg, dev)
    for name, shape in _shapes(cfg).items():
        w = torch.randn(shape, generator=gen, device=dev) * scale
        if qtype == QuantType.NONE:
            out[name] = w
        elif name == "embedding":
            out[name] = quantize(w, qtype, gs)
        else:
            q = quantize(w.transpose(-1, -2), qtype, gs)
            out[name] = QArray(q.data.transpose(-1, -2).contiguous(),
                               q.scales.transpose(-1, -2).contiguous(),
                               qtype, gs, group_axis=-2)
    return LlamaParams(**out)


def random_params_int(cfg: ModelConfig, seed: int = 0,
                      qtype: Optional[QuantType] = None,
                      scale: float = 0.02, device=None) -> LlamaParams:
    """Random quantized parameters made directly as integers on the device
    from a ``torch.Generator`` (no f32 intermediate, so 7B-size weights
    are made in place): values uniform in [-QF, QF], every group scale
    ``scale / QF``, norms one.  INT4 projections are split-half packed on
    the device where :func:`pack_supported` says, the rest stay int8-held.
    ``QuantType.NONE`` is handed to :func:`random_params`.  Same recipe as
    the JAX package's ``random_params_int``; the values differ (another
    generator)."""
    qtype = qtype if qtype is not None else cfg.quant_type
    if qtype == QuantType.NONE:
        return random_params(cfg, seed, qtype, scale, device)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qmax, gs = qtype.factor, cfg.group_size
    out = _norms(cfg, dev)
    sval = scale / qmax
    for name, shape in _shapes(cfg).items():
        data = torch.empty(shape, dtype=QDTYPE[qtype], device=dev)
        data.random_(-qmax, qmax + 1, generator=gen)
        packed = False
        if name == "embedding":
            sshape, ga = (*shape[:-1], shape[-1] // gs), -1
        else:
            sshape, ga = (*shape[:-2], shape[-2] // gs, shape[-1]), -2
            packed = (qtype == QuantType.INT4
                      and pack_supported(shape[-2], shape[-1], gs))
            if packed:
                data = pack_int4_rows(data)
        out[name] = QArray(data, torch.full(sshape, sval, dtype=torch.float32,
                                            device=dev), qtype, gs, ga,
                           packed)
    return LlamaParams(**out)


_NORM_FIELDS = ("attn_norm", "ffn_norm", "out_norm")


def build_params(cfg: ModelConfig, raw: Mapping[str, Any],
                 qtype: Optional[QuantType] = None,
                 device=None) -> LlamaParams:
    """Assemble parameters from a loader's numpy dict (checkpoint layout:
    projections ``(…, out, in)``, groups along ``in``).

    ``raw`` values are fp32 arrays (or tensors on any device), or ``(data,
    scales)`` pairs for pre-quantized tensors (FLM and GGUF files store
    integers).  fp32
    weights are quantized here to ``qtype`` (quantize on load); every
    projection is transposed to the ``(in, out)`` layout with its groups
    on axis -2, INT4 ones nibble-packed where :func:`pack_supported` says;
    scales stay f32.  The arrays go to ``device`` first and are quantized,
    transposed and packed there, with the same bits as the JAX package's
    host-side ``build_params``."""
    qtype = qtype if qtype is not None else cfg.quant_type
    dev = resolve_device(device)
    gs = cfg.group_size
    out = {}
    for f in dataclasses.fields(LlamaParams):
        v = raw[f.name]
        if f.name in _NORM_FIELDS:
            out[f.name] = (v.to(dev, torch.float32, copy=True)
                           if isinstance(v, torch.Tensor) else
                           host_tensor(np.asarray(v, dtype=np.float32), dev))
            continue
        transpose = f.name != "embedding"
        if isinstance(v, tuple):
            data = host_tensor(v[0], dev)
            scales = host_tensor(np.asarray(v[1], dtype=np.float32), dev)
        else:
            w = (v.to(dev, torch.float32) if isinstance(v, torch.Tensor)
                 else host_tensor(np.asarray(v, dtype=np.float32), dev))
            if qtype == QuantType.NONE:
                out[f.name] = (w.transpose(-1, -2).contiguous() if transpose
                               else w)
                continue
            q = quantize(w, qtype, gs)
            del w
            data, scales = q.data, q.scales
        if not transpose:
            out[f.name] = QArray(data, scales, qtype, gs)
            continue
        data = data.transpose(-1, -2).contiguous()
        scales = scales.transpose(-1, -2).contiguous()
        # INT4 ships nibble-packed where the JAX package packs it; odd
        # contraction extents (an unpadded hidden size) stay int8-held
        packed = (qtype == QuantType.INT4
                  and pack_supported(data.shape[-2], data.shape[-1], gs))
        if packed:
            data = pack_int4_rows(data)
        out[f.name] = QArray(data, scales, qtype, gs, group_axis=-2,
                             packed=packed)
    return LlamaParams(**out)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``dev`` (the caller's array may be read-only)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(
            dev).to(torch.bfloat16)
    return host_tensor(a, dev)


def _qtype(q) -> QuantType:
    if isinstance(q, QuantType):
        return q
    if isinstance(q, str):
        return QuantType[q]
    return QuantType(int(q))


def params_from_numpy(cfg: ModelConfig, arrays: Mapping[str, Any],
                      flags: Mapping[str, Mapping[str, Any]],
                      device=None) -> LlamaParams:
    """Build the port's parameters from another framework's leaves given
    as numpy arrays.

    ``arrays[field]`` is an ndarray (norms, unquantized weights), a
    ``(data, scales)`` pair (a QArray) or None (a fused-away field).
    ``flags[field]`` gives each QArray's ``qtype`` (QuantType, its name or
    its value), ``group_size``, ``group_axis`` and ``packed``."""
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(LlamaParams):
        v = arrays.get(f.name)
        if v is None:
            out[f.name] = None
        elif isinstance(v, (tuple, list)):
            fl = flags[f.name]
            out[f.name] = QArray(_tensor(v[0], dev), _tensor(v[1], dev),
                                 _qtype(fl["qtype"]), int(fl["group_size"]),
                                 int(fl.get("group_axis", -1)),
                                 bool(fl.get("packed", False)))
        else:
            out[f.name] = _tensor(v, dev)
    return LlamaParams(**out)
