"""Checkpoint format detection + unified load path (port of
``fastllama_tpu/loaders/registry.py``).

Sniff the magic, dispatch to a format loader, then normalize everything
into device parameters:

1. deinterleave Wq/Wk rows for formats in the Meta/interleaved RoPE
   convention (llama2c/FLM/GGUF) — see ops/rope.py,
2. quantize fp32 projections on load to the engine's quant type, or keep
   pre-quantized data,
3. stack per-layer tensors and build a ``LlamaParams`` on the device
   (``models.llama.build_params``).

With ``EngineConfig.mesh`` the FFN hidden size is padded for the 'model'
axis and each rank builds its own shard of the parameters alone, on its
device.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from fastllama_tpu_torch.config import ModelConfig, QuantType
from fastllama_tpu_torch.device import resolve_device
from fastllama_tpu_torch.loaders import flm, gguf, hf, llama2c
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from fastllama_tpu_torch.models.llama import LlamaParams, build_params
from fastllama_tpu_torch.ops.rope import deinterleave_heads
from fastllama_tpu_torch.parallel.sharding import pad_hidden_for_sharding


class FileType(enum.Enum):
    UNKNOWN = 0
    FLM = 1
    GGUF = 2
    LLAMA2C = 3
    HF = 4

    @staticmethod
    def parse(name: str) -> "FileType":
        return {"flm": FileType.FLM, "gguf": FileType.GGUF,
                "llama2c": FileType.LLAMA2C, "hf": FileType.HF,
                "": FileType.UNKNOWN, "unknown": FileType.UNKNOWN}[name.lower()]


# formats whose Wq/Wk rows follow the Meta interleaved-pair RoPE convention
_INTERLEAVED = {FileType.FLM, FileType.GGUF, FileType.LLAMA2C}


def detect_file_type(path: str) -> FileType:
    """Magic-number sniffing (the C++ engine's ``model_loader.cpp``)."""
    if hf.is_hf_dir(path):
        return FileType.HF
    if flm.is_flm(path):
        return FileType.FLM
    if gguf.is_gguf(path):
        return FileType.GGUF
    if llama2c.is_llama2c(path):
        return FileType.LLAMA2C
    return FileType.UNKNOWN


@dataclasses.dataclass
class LoadedModel:
    config: ModelConfig
    weights: dict            # numpy: fp32 arrays or (data, scales) tuples
    tokenizer: Tokenizer
    file_type: FileType

    def build(self, qtype: Optional[QuantType] = None,
              device=None, mesh=None) -> LlamaParams:
        """The parameters on ``device``; on a ``mesh``, this rank's shard
        of them alone (``parallel.sharding.shard_raw``: each leaf sliced
        before it goes to the device and is quantized there)."""
        qt = qtype if qtype is not None else self.config.quant_type
        if qt == QuantType.INT4 and self.config.hidden_dim % 512:
            # zero-pad hidden_dim to a 512 multiple so the FFN down
            # projection's contraction axis tiles for nibble packing
            # (exact: silu(0)*0 rows feed zero columns); updates self.config
            self.config = pad_hidden_for_sharding(
                self.config, self.weights,
                512 // self.config.group_size)
        raw = self.weights
        if mesh is not None:
            from fastllama_tpu_torch.parallel.sharding import shard_raw
            raw = shard_raw(self.config, mesh, raw)
        return build_params(self.config, raw, qtype, device)


def _deinterleave(weights: dict, head_size: int) -> None:
    """Convert Wq/Wk rows to the half layout.  Quant groups ride along the
    input axis, so the same row (axis -2) permutation applies to per-row
    scale arrays unchanged."""
    for key in ("wq", "wk"):
        v = weights.get(key)
        if v is None:
            continue
        if isinstance(v, tuple):
            data, scales = v
            weights[key] = (deinterleave_heads(data, head_size),
                            deinterleave_heads(scales, head_size))
        else:
            weights[key] = deinterleave_heads(v, head_size)


def resolve_and_build(ckpt_path: str, tokenizer_path: str,
                      file_type: "FileType", qtype, engine_config,
                      device=None):
    """The engines' shared load path: load the checkpoint, resolve the
    effective quant type (the user's request for an fp32 file; a
    pre-quantized FLM or GGUF file keeps its own) and build the parameters
    on ``device`` (``None``: the card).  Returns (config, params,
    tokenizer).

    With ``engine_config.mesh`` the mesh is checked first (one larger than
    the world raises ValueError before the file is read), the FFN hidden
    size is padded for the 'model' axis (``registry.py:114-123``), and the
    parameters are this rank's shard, built on the rank's device: each
    leaf is sliced on the host and only the slice goes to the device and
    is quantized there.  The engines take them with ``sharded=True``."""
    mesh = None
    if engine_config is not None and engine_config.mesh:
        from fastllama_tpu_torch.runtime.batching import open_mesh
        mesh, device = open_mesh(engine_config, device)
    device = resolve_device(device)     # no card: raise before reading
    m = load_model(ckpt_path, tokenizer_path, file_type)
    cfg = m.config
    if qtype is not None and cfg.quant_type == QuantType.NONE:
        cfg = cfg.replace(quant_type=qtype)
    elif m.file_type in (FileType.FLM, FileType.GGUF) \
            and cfg.quant_type != QuantType.NONE:
        qtype = cfg.quant_type          # pre-quantized file wins
    if mesh is not None:
        from fastllama_tpu_torch.parallel.sharding import MODEL_AXIS
        cfg = pad_hidden_for_sharding(cfg, m.weights,
                                      mesh.shape[MODEL_AXIS])
        m.config = cfg
    params = m.build(qtype, device, mesh)
    # build() may pad hidden_dim (INT4 packing alignment)
    cfg = cfg.replace(hidden_dim=m.config.hidden_dim)
    return cfg, params, m.tokenizer


def stack_layers(per_layer: dict, n_layers: int):
    """Stack a {field: {layer_id: array-or-(data,scales)}} map into (L, ...)
    arrays (shared by the FLM and GGUF loaders)."""
    out = {}
    for field, layers in per_layer.items():
        first = layers[0]
        if isinstance(first, tuple):
            out[field] = (np.stack([layers[i][0] for i in range(n_layers)]),
                          np.stack([layers[i][1] for i in range(n_layers)]))
        else:
            out[field] = np.stack([layers[i] for i in range(n_layers)])
    return out


def load_model(path: str, tokenizer_path: str = "",
               file_type: FileType = FileType.UNKNOWN,
               tokenizer_only: bool = False) -> LoadedModel:
    ft = file_type if file_type != FileType.UNKNOWN else detect_file_type(path)
    if ft == FileType.UNKNOWN:
        raise ValueError(f"cannot detect checkpoint format of {path}")
    if ft == FileType.FLM:
        cfg, weights, tok = flm.load_flm(path, tokenizer_only)
    elif ft == FileType.GGUF:
        cfg, weights, tok = gguf.load_gguf(path, tokenizer_only)
    elif ft == FileType.LLAMA2C:
        cfg, weights, tok = llama2c.load_llama2c(path, tokenizer_path,
                                                 tokenizer_only)
    else:
        cfg, weights, tok = hf.load_hf(path, tokenizer_only)

    if weights and ft in _INTERLEAVED:
        _deinterleave(weights, cfg.head_size)
    return LoadedModel(cfg, weights, tok, ft)
