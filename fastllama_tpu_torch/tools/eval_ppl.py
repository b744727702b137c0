"""Perplexity evaluation — the accuracy gate for quantization parity (port
of ``fastllama_tpu/tools/eval_ppl.py``).

Usage:
  python -m fastllama_tpu_torch.tools.eval_ppl -c model.flm -f text.txt
  python -m fastllama_tpu_torch.tools.eval_ppl -c hfdir -q int8,int16,none \\
      -f text.txt --engine batched --kv int8
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import List

import numpy as np
import torch


def _nll_sum(lg: np.ndarray, tgt: np.ndarray) -> float:
    lg = np.asarray(lg, np.float64)
    lg = lg - lg.max(axis=-1, keepdims=True)
    logp = lg - np.log(np.exp(lg).sum(axis=-1, keepdims=True))
    return float(-logp[np.arange(len(tgt)), tgt].sum())


def perplexity_from_logits(logits: np.ndarray, targets: np.ndarray) -> float:
    return float(np.exp(_nll_sum(logits, targets) / len(targets)))


def evaluate(engine, token_ids: List[int], window: int = 512) -> float:
    """Sliding-window perplexity: each window is prefilled fresh and scores
    the next-token predictions of its tokens, through the engine's own
    kernel bundle (``kb.mm``, ``kb.attn``, ``kb.mm_idx``, ``kb.attn_idx``:
    the path ``Engine.generate`` runs, as the JAX tool threads its
    engine's kernels into ``forward``)."""
    from fastllama_tpu_torch.models.llama import forward

    if engine._spmd:
        raise NotImplementedError("evaluate scores one card's forward; on "
                                  "a mesh use evaluate_decode")
    cfg = engine.config
    kb = engine.kernels
    window = min(window, cfg.max_seq_len)
    total_nll, total_n = 0.0, 0
    for start in range(0, max(len(token_ids) - 1, 1), window - 1):
        chunk = token_ids[start:start + window]
        if len(chunk) < 2:
            break
        pad = np.zeros(window, np.int64)
        pad[:len(chunk)] = chunk
        logits, _ = forward(
            cfg, engine.params, torch.as_tensor(pad, device=engine.device),
            0, engine.new_cache(), mm=kb.mm, attn=kb.attn, mm_idx=kb.mm_idx,
            attn_idx=kb.attn_idx, compute_dtype=engine._cdt)
        lg = logits[:len(chunk) - 1].double().cpu().numpy()
        total_nll += _nll_sum(lg, np.asarray(chunk[1:], np.int64))
        total_n += len(chunk) - 1
    return math.exp(total_nll / max(total_n, 1))


def evaluate_decode(bengine, token_ids: List[int], window: int = 0,
                    step_chunk: int = 64) -> float:
    """Teacher-forced perplexity through the BatchedEngine's own decode
    step (``BatchedEngine.decode``: its kernels, its KV dtype, its slots,
    its mesh) — the serving configuration, where :func:`evaluate` scores
    the prefill math.

    Windows of ``window`` tokens are packed B at a time into the slots;
    every position t feeds token[t] through the decode step at pos=t
    (writing its K/V row) and scores token[t+1].  The NLL is computed on
    the device and only (K, B) values come to the host a chunk of K =
    ``step_chunk`` steps.  As in the JAX tool: positions are clamped at
    max_seq_len - 1, a short final chunk still runs its zero-padded steps,
    and the positions advance by ``step_chunk`` after every chunk."""
    cfg = bengine.config
    window = min(window or cfg.max_seq_len, cfg.max_seq_len)
    B = bengine.B
    dev = bengine.device
    S = cfg.max_seq_len

    wins = [token_ids[s:s + window]
            for s in range(0, max(len(token_ids) - 1, 1), window - 1)]
    wins = [w for w in wins if len(w) >= 2]
    if not wins:
        return float("nan")

    def chunk_fn(cache, toks, tgts, pos):
        """toks/tgts (K, B) on the device, pos (B,): per-step NLL (K, B)."""
        nlls = torch.empty(toks.shape, dtype=torch.float32, device=dev)
        for j in range(toks.shape[0]):
            lg, cache = bengine.decode(toks[j], pos, cache)
            lp = torch.log_softmax(lg.to(torch.float32), dim=-1)
            nlls[j] = -lp.gather(1, tgts[j][:, None])[:, 0]
            pos = torch.clamp(pos + 1, max=S - 1)
        return nlls

    total_nll, total_n = 0.0, 0
    for g in range(0, len(wins), B):
        grp = wins[g:g + B]
        T = max(len(w) for w in grp)
        toks = np.zeros((B, T), np.int64)
        valid = np.zeros((B, T - 1), bool)
        for i, w in enumerate(grp):
            toks[i, :len(w)] = w
            valid[i, :len(w) - 1] = True
        cache = bengine.new_cache()
        inp, tgt = toks[:, :-1].T, toks[:, 1:].T          # (T-1, B)
        pos = np.zeros(B, np.int32)
        for s in range(0, T - 1, step_chunk):
            k = min(step_chunk, T - 1 - s)
            ip = np.zeros((step_chunk, B), np.int64)
            tp = np.zeros((step_chunk, B), np.int64)
            ip[:k], tp[:k] = inp[s:s + k], tgt[s:s + k]
            nlls = chunk_fn(cache, torch.as_tensor(ip, device=dev),
                            torch.as_tensor(tp, device=dev),
                            torch.as_tensor(pos, device=dev))
            nlls = nlls.cpu().numpy()[:k]                 # (k, B)
            m = valid[:, s:s + k].T
            total_nll += float(nlls[m].sum())
            total_n += int(m.sum())
            pos = np.minimum(pos + step_chunk, S - 1).astype(np.int32)
    return math.exp(total_nll / max(total_n, 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fastllama-torch-eval-ppl",
                                description=__doc__)
    p.add_argument("-c", "--checkpoint", required=True)
    p.add_argument("-z", "--tokenizer", default="")
    p.add_argument("-f", "--file", required=True, help="UTF-8 text file")
    p.add_argument("-q", "--quant", default="int8",
                   help="comma-separated list: int8,int16,int4,none")
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--max-chars", type=int, default=20000)
    p.add_argument("--engine", choices=("single", "batched"),
                   default="single",
                   help="'batched' scores the SERVING path (BatchedEngine "
                        "decode step, per-slot cache, its kernels)")
    p.add_argument("--kv", default="float32",
                   help="KV-cache dtype for --engine batched "
                        "(float32/bfloat16/int8)")
    p.add_argument("--batch", type=int, default=8,
                   help="window slots per step (--engine batched)")
    p.add_argument("--device", default="cuda",
                   help="where the engines run: cuda (default) or cpu "
                        "(the plain PyTorch versions)")
    args = p.parse_args(argv)

    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine

    with open(args.file, encoding="utf-8") as f:
        text = f.read()[:args.max_chars]

    results = {}
    for qname in args.quant.split(","):
        qt = QuantType.parse(qname)
        if args.engine == "batched":
            eng = BatchedEngine.load(
                args.checkpoint, args.tokenizer, qtype=qt,
                engine_config=EngineConfig(kv_dtype=args.kv,
                                           max_batch_size=args.batch),
                device=args.device)
            toks = eng.tokenizer.encode(text, add_bos=True)
            ppl = evaluate_decode(eng, toks, args.window)
        else:
            eng = Engine.load(args.checkpoint, args.tokenizer, qtype=qt,
                              engine_config=EngineConfig(),
                              device=args.device)
            toks = eng.tokenizer.encode(text, add_bos=True)
            ppl = evaluate(eng, toks, args.window)
        results[qname] = ppl
        print(f"{qname:>6}: ppl = {ppl:.4f}  ({len(toks)} tokens)")
    if "none" in results:
        base = results["none"]
        for qname, ppl in results.items():
            if qname != "none":
                print(f"{qname:>6}: delta vs fp32 = {ppl - base:+.4f} "
                      f"({(ppl/base - 1)*100:+.2f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
