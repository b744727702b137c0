"""Checkpoint files for the port's loader tests, written by the tests'
own byte writers from ``fastllama_tpu.tools.synthetic``'s seeded weights:
a GGUF file (F32, F16 and ``Q8_0`` tensors) and HuggingFace directories
(``config.json``, ``tokenizer.json`` and one ``.bin`` or ``.safetensors``
shard).  Nothing comes from outside the repo."""
import json
import os
import struct

import numpy as np
import torch

# llama field -> HF name of a layer's tensor
HF_LAYER = {"attn_norm": "input_layernorm.weight",
            "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
            "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
            "ffn_norm": "post_attention_layernorm.weight",
            "w1": "mlp.gate_proj.weight", "w2": "mlp.down_proj.weight",
            "w3": "mlp.up_proj.weight"}
# llama field -> GGUF name of a layer's tensor
GGUF_LAYER = {"attn_norm": "attn_norm", "wq": "attn_q", "wk": "attn_k",
              "wv": "attn_v", "wo": "attn_output", "ffn_norm": "ffn_norm",
              "w1": "ffn_gate", "w2": "ffn_down", "w3": "ffn_up"}


def _s(txt):
    b = txt.encode()
    return struct.pack("<Q", len(b)) + b


def q8_0_encode(arr):
    """Q8_0 blocks of 32 along the last axis: an fp16 scale max|x|/127
    and 32 rounded int8 values.  Returns (bytes, int8 data, f32 scales as
    the file holds them)."""
    a = np.asarray(arr, np.float32).reshape(-1, 32)
    scale = (np.abs(a).max(axis=1) / 127.0).astype(np.float16)
    safe = np.where(scale > 0, scale.astype(np.float32), 1.0)
    q = np.clip(np.round(a / safe[:, None]), -127, 127).astype(np.int8)
    blk = np.empty(a.shape[0], np.dtype([("d", "<f2"), ("q", "i1", (32,))]))
    blk["d"], blk["q"] = scale, q
    return (blk.tobytes(), q.reshape(arr.shape),
            scale.astype(np.float32).reshape(*arr.shape[:-1], -1))


def write_gguf(path, cfg, weights, tok, q8=("wq", "wk", "wv", "wo", "w1",
                                            "w2", "w3", "embedding",
                                            "classifier"), f16=()):
    """A GGUF v3 file of ``weights`` (interleaved convention, fp32): fields
    in ``f16`` as F16, the others in ``q8`` as ``Q8_0``, the rest F32.
    Returns {field: [(data, scales), one pair a tensor]} of the Q8_0
    tensors."""
    def kv_u32(k, v):
        return _s(k) + struct.pack("<II", 4, v)

    def kv_f32(k, v):
        return _s(k) + struct.pack("<I", 6) + struct.pack("<f", v)

    def kv_str(k, v):
        return _s(k) + struct.pack("<I", 8) + _s(v)

    def kv_arr(k, etype, items):
        out = _s(k) + struct.pack("<IIQ", 9, etype, len(items))
        if etype == 8:
            return out + b"".join(_s(t) for t in items)
        fmt = {6: "f", 5: "i"}[etype]
        return out + struct.pack(f"<{len(items)}{fmt}", *items)

    kvs = [kv_str("general.architecture", "llama"),
           kv_str("general.name", "tiny"),
           kv_u32("llama.embedding_length", cfg.dim),
           kv_u32("llama.feed_forward_length", cfg.hidden_dim),
           kv_u32("llama.block_count", cfg.n_layers),
           kv_u32("llama.attention.head_count", cfg.n_heads),
           kv_u32("llama.attention.head_count_kv", cfg.n_kv_heads),
           kv_u32("llama.context_length", cfg.max_seq_len),
           kv_f32("llama.rope.freq_base", cfg.rope_theta),
           kv_f32("llama.attention.layer_norm_rms_epsilon", cfg.norm_eps),
           kv_str("tokenizer.ggml.model", "llama"),
           kv_arr("tokenizer.ggml.tokens", 8, tok.index_texts),
           kv_arr("tokenizer.ggml.scores", 6, tok.scores),
           kv_arr("tokenizer.ggml.token_type", 5, tok.types),
           kv_u32("tokenizer.ggml.bos_token_id", tok.bos_token_id),
           kv_u32("tokenizer.ggml.eos_token_id", tok.eos_token_id)]
    tensors = [("token_embd.weight", "embedding", weights["embedding"]),
               ("output_norm.weight", "out_norm", weights["out_norm"]),
               ("output.weight", "classifier", weights["classifier"])]
    for l in range(cfg.n_layers):
        tensors += [(f"blk.{l}.{g}.weight", f, weights[f][l])
                    for f, g in GGUF_LAYER.items()]
    infos, blobs, expect, offset = [], [], {}, 0
    for name, field, arr in tensors:
        arr = np.asarray(arr, np.float32)
        if field in f16:
            blob, gtype = arr.astype("<f2").tobytes(), 1
        elif field in q8:
            blob, q, sc = q8_0_encode(arr)
            expect.setdefault(field, []).append((q, sc))
            gtype = 8
        else:
            blob, gtype = arr.astype("<f4").tobytes(), 0
        offset += (-offset) % 32
        dims = tuple(reversed(arr.shape))     # ggml: innermost first
        infos.append(_s(name) + struct.pack("<I", len(dims))
                     + struct.pack(f"<{len(dims)}Q", *dims)
                     + struct.pack("<IQ", gtype, offset))
        blobs.append((offset, blob))
        offset += len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(kvs)))
        f.write(b"".join(kvs) + b"".join(infos))
        start = f.tell() + (-f.tell()) % 32
        for off, blob in blobs:
            f.seek(start + off)
            f.write(blob)
    return expect


def hf_state_dict(cfg, weights):
    """HF names of ``weights`` (taken as the half convention, fp32)."""
    sd = {"model.embed_tokens.weight": weights["embedding"],
          "model.norm.weight": weights["out_norm"],
          "lm_head.weight": weights["classifier"]}
    for l in range(cfg.n_layers):
        for f, n in HF_LAYER.items():
            sd[f"model.layers.{l}.{n}"] = weights[f][l]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def write_safetensors(path, arrays):
    """A ``.safetensors`` file written byte by byte: an 8-byte header
    size, the JSON header, the raw little-endian data."""
    names = {np.dtype("<f4"): "F32", np.dtype("<f2"): "F16",
             np.dtype("int8"): "I8", np.dtype("<i4"): "I32",
             np.dtype("uint8"): "U8", np.dtype("<i8"): "I64"}
    header, data = {}, b""
    for k, a in arrays.items():
        raw = np.ascontiguousarray(a).tobytes()
        header[k] = {"dtype": names[np.dtype(a.dtype)],
                     "shape": list(a.shape),
                     "data_offsets": [len(data), len(data) + len(raw)]}
        data += raw
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + data)


def write_hf(dirpath, cfg, weights, tok, shard="bin", rope_scaling=None):
    """An HF checkpoint directory: config.json, tokenizer.json and one
    shard (``"bin"``: ``torch.save`` of the state dict; ``"safetensors"``:
    :func:`write_safetensors`)."""
    os.makedirs(dirpath, exist_ok=True)
    conf = dict(hidden_size=cfg.dim, intermediate_size=cfg.hidden_dim,
                num_hidden_layers=cfg.n_layers,
                num_attention_heads=cfg.n_heads,
                num_key_value_heads=cfg.n_kv_heads,
                vocab_size=cfg.vocab_size,
                max_position_embeddings=cfg.max_seq_len,
                rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
                model_type="llama")
    if rope_scaling:
        conf["rope_scaling"] = rope_scaling
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(dirpath, "tokenizer.json"), "w") as f:
        json.dump({"model": {"vocab": {t: i for i, t in
                                       enumerate(tok.index_texts)}}}, f)
    sd = hf_state_dict(cfg, weights)
    if shard == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(dirpath, "pytorch_model.bin"))
    else:
        write_safetensors(os.path.join(dirpath, "model.safetensors"), sd)
    return dirpath
