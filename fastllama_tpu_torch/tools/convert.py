"""Any checkpoint -> FLM offline converter CLI (port of
``fastllama_tpu/tools/convert.py``; host only, no card).

Reads any format the registry can read (a HuggingFace LLaMA directory:
config.json + safetensors/pytorch .bin + tokenizer.model/tokenizer.json;
llama2c; GGUF; FLM), group-quantizes to INT8/INT16 (scale = max|group|/QF,
truncation), permutes Q/K to the interleaved RoPE convention (the C++
engine's on-disk convention, with per-tensor head counts) and writes an
FLM file the C++ engine can load: the same bytes as the JAX package's
converter.

Usage: python -m fastllama_tpu_torch.tools.convert -m <hf_dir> -o out.flm -t int8
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fastllama-convert", description=__doc__)
    p.add_argument("-m", "--model", required=True, help="HF checkpoint dir "
                   "(or any format the registry can read)")
    p.add_argument("-o", "--output", required=True, help="output .flm path")
    p.add_argument("-t", "--type", default="int8", choices=["int8", "int16",
                                                            "none"])
    args = p.parse_args(argv)

    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.loaders import flm
    from fastllama_tpu_torch.loaders.registry import load_model
    from fastllama_tpu_torch.quant.groupquant import dequantize_np

    m = load_model(args.model)
    qtype = QuantType.parse(args.type)
    weights = {}
    for name, v in m.weights.items():
        if isinstance(v, tuple):  # pre-quantized input: dequantize to fp32
            weights[name] = dequantize_np(v[0], v[1], m.config.group_size)
        else:
            weights[name] = v
    print(f"loaded {m.file_type.name} checkpoint: dim={m.config.dim} "
          f"layers={m.config.n_layers} vocab={m.config.vocab_size}",
          file=sys.stderr)
    # registry normalized to the half convention; write_flm re-permutes
    flm.write_flm(args.output, m.config, m.tokenizer, weights, qtype,
                  rope_convention="half")
    print(f"wrote {args.output} ({qtype.name})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
