"""The port's command line (port of ``fastllama_tpu/cli.py``),
flag-compatible with the C++ engine's CLI: -c/-z/-f/-i/-n/-t/-p/-q/-e/-d/
--mode/--rounds/--seed/--detail/--debug.  The thread knobs (-j, --numa,
--uma) are accepted and ignored.

Modes: ``gen`` (with ``--spec`` or ``--draft``: single-stream
speculative decoding), ``benchmark``/``bm`` (N rounds, then a
tab-separated line of prompt/output token latency and tok/s), ``chat``
(a resident KV cache across turns, lines on stdin) and ``serve``
(continuous batching over prompts from a file or stdin; ``--spec``
batched speculation, ``--prefix-cache``, ``--qos-chunk``,
``--priority``/``--deadline``/``--prompts-tsv``, ``--prefill-chunk``).
``-e``/``-d`` use the tokenizer only.

``--device`` (default ``cuda``) names where the engines run; ``--device
cpu`` runs the plain PyTorch versions on the host.  Nothing falls back to
the CPU on its own.  ``--mesh model=N`` (``--spmd-kernels`` takes the same
per-rank path) serves on a mesh of ranks, one process a rank under
torchrun: each rank joins the process group from torchrun's variables,
runs on ``cuda:{LOCAL_RANK}`` (or ``--device cpu``), and only rank 0
writes the output.  A mesh larger than the world exits with status 2 and
the error's text.  ``-m serve --multihost`` (with or without ``--spec``)
serves per-host admission across the hosts of the mesh
(``runtime/multihost.py``): a host is a data coordinate, by default the
ranks of one machine (``data = WORLD_SIZE / LOCAL_WORLD_SIZE``); host d
serves the prompts ``d::hosts`` of the list, its model-0 rank writes that
host's completions, and every host prints the fleet's ``fleet:`` line.

Usage: python -m fastllama_tpu_torch.cli -c model.flm -m benchmark
       torchrun --nproc-per-node 2 -m fastllama_tpu_torch.cli -c model.flm \
           -m serve --mesh model=2 --prompts-file prompts.txt
       torchrun --nnodes 2 --nproc-per-node 4 ... -m fastllama_tpu_torch.cli \
           -c model.flm -m serve --multihost --prompts-file prompts.txt
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from fastllama_tpu_torch.config import EngineConfig, QuantType
from fastllama_tpu_torch.loaders.registry import FileType, load_model

DEFAULT_PROMPT = (
    "Long ago, in a quiet village between two great mountains, there lived a "
    "curious young girl named Mira. Every morning she walked to the river to "
    "watch the boats come in, wondering what lay beyond the water.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fastllama-torch", description=__doc__)
    p.add_argument("-c", "--checkpoint", default="", help="model checkpoint path")
    p.add_argument("-z", "--tokenizer", default="", help="tokenizer path (llama2c)")
    p.add_argument("-f", "--file-type", default="",
                   choices=["", "flm", "gguf", "llama2c", "hf"])
    p.add_argument("-i", "--prompt", default="")
    p.add_argument("-n", "--max-new-tokens", type=int, default=512)
    p.add_argument("-t", "--temperature", type=float, default=1.0)
    p.add_argument("-p", "--topp", type=float, default=0.9)
    p.add_argument("-q", "--quant", default="int8",
                   choices=["none", "int16", "int8", "int4"])
    p.add_argument("-j", "--threads", type=int, default=-1,
                   help="ignored (the card replaces the thread pool)")
    p.add_argument("--numa", action="store_true", help="ignored")
    p.add_argument("--uma", action="store_true", help="ignored")
    p.add_argument("--device", default="cuda",
                   help="where the engines run: cuda (default) or cpu "
                        "(the plain PyTorch versions, for tests)")
    p.add_argument("-m", "--mode", default="gen",
                   choices=["gen", "generate", "chat", "benchmark", "bm",
                            "serve"])
    p.add_argument("--rounds", type=int, default=0)
    p.add_argument("--seed", type=int, default=128391297)
    p.add_argument("--max-seq-len", type=int, default=1024,
                   help="context clamp (the C++ engine clamps to 1024)")
    p.add_argument("--mesh", default="", help="mesh spec, e.g. 'model=8' or "
                   "'data=2,model=4': serve on that many ranks (one "
                   "process a rank, under torchrun)")
    p.add_argument("--decode-chunk", type=int, default=32,
                   help="tokens generated per device dispatch")
    p.add_argument("--kv-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="int8 = per-row-quantized cache (serve mode only)")
    p.add_argument("--scale-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="group-scale storage for int8/int4 weights: "
                        "bfloat16 halves the scale stream; float32 keeps "
                        "the loader/parity contract")
    p.add_argument("--parity", action="store_true",
                   help="bit-faithful reference math (slow)")
    p.add_argument("--no-pallas", action="store_true",
                   help="disable the hand-written kernels (the plain "
                        "PyTorch versions on the card)")
    p.add_argument("--spmd-kernels", action="store_true",
                   help="with --mesh: the kernels per shard (the port's one "
                        "mesh path either way)")
    p.add_argument("--multihost", action="store_true",
                   help="--mode serve with per-host admission across the "
                        "hosts of the mesh (a host: a data coordinate; "
                        "default mesh: one host a machine under torchrun)")
    p.add_argument("-e", "--encode", default="", help="encode text to tokens")
    p.add_argument("-d", "--decode", default="", help="decode ids (comma-sep)")
    p.add_argument("--detail", action="store_true")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the run to this "
                        "dir (trace.json for Perfetto / chrome://tracing, "
                        "kernels.txt by device time)")
    p.add_argument("--batch", type=int, default=8,
                   help="serving slots for --mode serve (continuous batching)")
    p.add_argument("--prompts-file", default="",
                   help="--mode serve: file with one prompt per line "
                        "(default: stdin)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="--mode serve: reuse K/V of shared prompt prefixes "
                        "across slots (device-side row copy + tail prefill)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="prefill long prompts in fixed blocks of this size "
                        "(bounds memory on long contexts)")
    p.add_argument("--draft", default="",
                   help="draft checkpoint for speculative decoding "
                        "(--spec-width tokens per verify; temperature 0 "
                        "verifies greedily, temperature > 0 uses "
                        "distribution-preserving speculative sampling)")
    p.add_argument("--spec", action="store_true",
                   help="draft-free speculative decoding (n-gram "
                        "prompt-lookup); with --mode serve, runs batched "
                        "speculation inside the decode chunks")
    p.add_argument("--qos-chunk", type=int, default=0,
                   help="serve mode: cap decode chunks at this many steps "
                        "while requests queue behind a full batch (bounds "
                        "queued TTFT; 0 = off)")
    p.add_argument("--priority", type=int, default=0,
                   help="serve mode: admission priority class for the "
                        "submitted prompts (higher admits first; per-line "
                        "values via --prompts-tsv override this)")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="serve mode: queued-TTFT deadline in seconds — "
                        "requests still queued past it are rejected "
                        "(0 = none; per-line values via --prompts-tsv)")
    p.add_argument("--prompts-tsv", action="store_true",
                   help="--prompts-file lines are 'priority<TAB>deadline_s"
                        "<TAB>prompt' (mixed QoS loads from one file)")
    p.add_argument("--spec-width", type=int, default=0,
                   help="speculation MAX verify width D (0 = auto: 8 for "
                        "single-stream --draft/--spec, 4 for --mode serve, "
                        "whose SpecAutoTuner arbitrates plain vs the "
                        "widths up to D by measured emitted tok/s)")
    p.add_argument("--spec-rounds", type=int, default=32,
                   help="--mode serve --spec: speculative rounds per "
                        "device chunk (longer chunks amortize the "
                        "per-chunk host round trip; the engine falls back "
                        "to plain chunks when they measure faster)")
    p.add_argument("--debug", action="store_true")
    return p


def serve_mode(args) -> int:
    """Continuous-batching batch job: read prompts (file or stdin), serve
    them through BatchedEngine slots (SpecBatchedEngine with --spec, the
    multi-host engines with --multihost), print completions + aggregate
    stats."""
    ec = EngineConfig(max_seq_len=args.max_seq_len, kv_dtype=args.kv_dtype,
                      use_pallas=not args.no_pallas, mesh=args.mesh,
                      max_batch_size=args.batch,
                      prefix_cache=args.prefix_cache,
                      spmd_kernels=args.spmd_kernels,
                      qos_chunk=args.qos_chunk,
                      scale_dtype=args.scale_dtype)
    # serve-mode auto default: 4 = the tuner's width-arm headroom
    # ({2, 4} + plain; spec_batching.SpecAutoTuner); the lockstep fleet
    # keeps a static width (its vote is spec or plain), 2
    spec_width = args.spec_width or (2 if args.multihost else 4)
    if args.multihost and args.spec:
        from fastllama_tpu_torch.runtime.spec_multihost import \
            MultiHostSpecEngine
        eng = MultiHostSpecEngine.load_spec(
            args.checkpoint, args.tokenizer, FileType.parse(args.file_type),
            QuantType.parse(args.quant), ec, decode_chunk=args.decode_chunk,
            width=spec_width, rounds_per_chunk=args.spec_rounds,
            device=args.device)
    elif args.multihost:
        from fastllama_tpu_torch.runtime.multihost import MultiHostEngine
        eng = MultiHostEngine.load(args.checkpoint, args.tokenizer,
                                   FileType.parse(args.file_type),
                                   QuantType.parse(args.quant), ec,
                                   decode_chunk=args.decode_chunk,
                                   device=args.device)
    elif args.spec:
        # batched speculation: per-slot n-gram drafts verified D rows at a
        # time inside the decode chunks (runtime/spec_batching.py)
        from fastllama_tpu_torch.runtime.spec_batching import \
            SpecBatchedEngine
        eng = SpecBatchedEngine.load_spec(
            args.checkpoint, args.tokenizer, FileType.parse(args.file_type),
            QuantType.parse(args.quant), ec, decode_chunk=args.decode_chunk,
            width=spec_width, rounds_per_chunk=args.spec_rounds,
            device=args.device)
    else:
        from fastllama_tpu_torch.runtime.batching import BatchedEngine
        eng = BatchedEngine.load(args.checkpoint, args.tokenizer,
                                 FileType.parse(args.file_type),
                                 QuantType.parse(args.quant), ec,
                                 decode_chunk=args.decode_chunk,
                                 device=args.device)
    if args.prompts_file:
        with open(args.prompts_file, encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    else:
        lines = [ln.rstrip("\n") for ln in sys.stdin if ln.strip()]
    if args.prompts_tsv:
        # per-line QoS: 'priority<TAB>deadline_s<TAB>prompt'
        prompts = []
        for ln in lines:
            pr, dl, text = ln.split("\t", 2)
            prompts.append((text, int(pr), float(dl)))
    else:
        prompts = [(ln, args.priority, args.deadline) for ln in lines]
    if args.multihost:
        # each host serves its share of the list, round-robin by host (a
        # shared file on every host serves distinct rows)
        prompts = prompts[eng.host::eng.n_hosts]
    elif not prompts:
        print("no prompts", file=sys.stderr)
        return 2
    reqs = [eng.submit(pr, max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature, topp=args.topp,
                       seed=args.seed + i, priority=prio, deadline_s=dl)
            for i, (pr, prio, dl) in enumerate(prompts)]
    stats = eng.run()
    for r in reqs:
        if r.rejected:
            print(f"[{r.id}] REJECTED (deadline {r.deadline_s:.2f}s "
                  f"lapsed while queued)\n")
            continue
        print(f"[{r.id}] ttft={r.ttft*1000:.0f}ms "
              f"tokens={len(r.output_tokens)}\n{r.text(eng.tokenizer)}\n")
    print(f"served {stats.completed} requests | aggregate decode "
          f"{stats.aggregate_tps:.1f} tok/s | {stats.total_output_tokens} "
          f"tokens in {stats.decode_s:.2f}s (+{stats.prefill_s:.2f}s prefill)",
          file=sys.stderr)
    if args.multihost:
        g = eng.global_stats()
        if eng.lead:
            print(f"fleet: {g.completed} requests | aggregate decode "
                  f"{g.aggregate_tps:.1f} tok/s across hosts",
                  file=sys.stderr)
    return 0


def encode_decode(args) -> int:
    """Tokenizer-only path (no weights, no card)."""
    m = load_model(args.checkpoint, args.tokenizer,
                   FileType.parse(args.file_type), tokenizer_only=True)
    if args.encode:
        toks = m.tokenizer.encode(args.encode, add_bos=True)
        print(f"tokens({len(toks)}): {toks}")
    if args.decode:
        ids = [int(x) for x in args.decode.replace(",", " ").split()]
        print(f"text: {m.tokenizer.decode(ids)}")
    return 0


def chat_loop(eng, args) -> int:
    """Interactive multi-turn REPL (the C++ engine's chat mode) with the KV
    cache held resident between turns."""
    from fastllama_tpu_torch.runtime.engine import ChatSession
    sess = ChatSession(eng, system_prompt=args.prompt or "")
    print("chat mode — empty line or /exit to quit, /reset for a new session")
    while True:
        try:
            line = input("you> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line or line == "/exit":
            return 0
        if line == "/reset":
            sess = ChatSession(eng, system_prompt=args.prompt or "")
            continue
        print("bot> ", end="", flush=True)
        try:
            sess.generate(line, max_new_tokens=args.max_new_tokens,
                          temperature=args.temperature, topp=args.topp,
                          seed=args.seed,
                          callback=lambda t: print(t, end="", flush=True))
        except ValueError as e:
            print(f"[{e} — /reset to clear]", end="")
        print()


def join_mesh(args):
    """With ``--mesh`` or ``-m serve --multihost``: join the process group
    (torchrun's variables; a no-op without them), check the mesh against
    the world (``--multihost`` without ``--mesh``: one host a machine,
    set in ``args.mesh``) and set ``args.device`` to the rank's.  Returns
    (whether this rank writes the output: rank 0, or with ``--multihost``
    each host's model-0 rank; whether this call joined the group); (True,
    False) off a mesh.  Raises ValueError for a mesh the world cannot
    hold."""
    multihost = args.multihost and args.mode == "serve"
    if not (args.mesh or multihost):
        return True, False
    from fastllama_tpu_torch.parallel import distributed
    from fastllama_tpu_torch.parallel.sharding import MODEL_AXIS, make_mesh
    joined = not distributed.is_initialized()
    dev = distributed.initialize(
        device=None if args.device == "cuda" else args.device)
    joined = joined and distributed.is_initialized()
    try:
        if not args.mesh:
            args.mesh = distributed.default_mesh_spec()
        mesh = make_mesh(args.mesh)
    except ValueError:
        if joined:
            distributed.shutdown()
        raise
    if dev is not None:
        args.device = str(dev)
    writer = mesh.index(MODEL_AXIS) == 0 if multihost else mesh.rank == 0
    return writer, joined


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        writer, joined = join_mesh(args)
    except ValueError as e:
        print(f"error: --mesh {args.mesh}: {e}", file=sys.stderr)
        return 2
    try:
        if writer:
            return run(args)
        # every rank serves in lockstep; the writers alone write the output
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            return run(args)
    finally:
        if joined:
            from fastllama_tpu_torch.parallel import distributed
            distributed.shutdown()


def run(args) -> int:
    if args.encode or args.decode:
        if not args.checkpoint:
            print("error: -e/-d need -c/--checkpoint (the tokenizer lives "
                  "in the model file)", file=sys.stderr)
            return 2
        return encode_decode(args)
    if not args.checkpoint:
        print("error: -c/--checkpoint is required", file=sys.stderr)
        return 2
    if args.mode == "serve":
        return serve_mode(args)

    from fastllama_tpu_torch.runtime.engine import Engine

    bench = args.mode in ("benchmark", "bm")
    rounds = args.rounds if args.rounds > 0 else (16 if bench else 1)
    prompt = args.prompt or DEFAULT_PROMPT
    qtype = QuantType.parse(args.quant)

    ec = EngineConfig(max_seq_len=args.max_seq_len, kv_dtype=args.kv_dtype,
                      use_pallas=not args.no_pallas, parity_mode=args.parity,
                      mesh=args.mesh, prefill_chunk=args.prefill_chunk,
                      spmd_kernels=args.spmd_kernels,
                      scale_dtype=args.scale_dtype)
    if args.detail or args.debug:
        print(f"checkpoint: {args.checkpoint}\nquant: {qtype.name}\n"
              f"temperature: {args.temperature}  top_p: {args.topp}",
              file=sys.stderr)

    t0 = time.perf_counter()
    eng = Engine.load(args.checkpoint, args.tokenizer,
                      FileType.parse(args.file_type), qtype, ec,
                      device=args.device)
    if args.detail or args.debug:
        print(f"model loaded in {time.perf_counter()-t0:.1f}s "
              f"({eng.config.name or 'unnamed'}: dim={eng.config.dim} "
              f"layers={eng.config.n_layers} vocab={eng.config.vocab_size})",
              file=sys.stderr)
    if args.debug:
        # weight-statistics sweep (the C++ engine's analyze_weights
        # numerics probe, run over every tensor)
        from fastllama_tpu_torch.utils.debug import params_stats
        params_stats(eng.params,
                     print_fn=lambda s: print(f"# {s}", file=sys.stderr))

    if args.mode == "chat":
        return chat_loop(eng, args)

    spec = None
    if args.draft or args.spec:
        from fastllama_tpu_torch.runtime.speculative import \
            SpeculativeEngine
        draft_eng = None
        if args.draft:
            draft_eng = Engine.load(args.draft, args.tokenizer,
                                    FileType.parse(args.file_type), qtype, ec,
                                    device=args.device)
        spec = SpeculativeEngine(eng, draft=draft_eng,
                                 width=args.spec_width or 8)

    profiler = None
    if args.profile_dir:
        from fastllama_tpu_torch.utils.profiling import trace
        profiler = trace(args.profile_dir)
        profiler.__enter__()

    agg = dict(ptok=0.0, otok=0.0, ps=0.0, ds=0.0)
    try:
        for r in range(rounds):
            if not bench:
                print(f"prompt: {prompt}\noutput: ", end="", flush=True)

            def cb(text, tok):
                if not bench:
                    print(text, end="", flush=True)
                return True

            if spec is not None:
                toks, st = spec.generate(prompt, args.max_new_tokens,
                                         callback=cb,
                                         temperature=args.temperature,
                                         topp=args.topp,
                                         seed=args.seed + r)
            else:
                toks, st = eng.generate(prompt, args.max_new_tokens,
                                        args.temperature, args.topp,
                                        seed=args.seed + r, callback=cb,
                                        decode_chunk=args.decode_chunk)
            if not bench:
                print()
            if spec is not None and (args.detail or args.debug):
                print(f"# spec acceptance {st.acceptance:.2f} over "
                      f"{st.rounds} rounds", file=sys.stderr)
            agg["ptok"] += st.prompt_tokens
            agg["otok"] += st.output_tokens
            agg["ps"] += st.prefill_s
            agg["ds"] += st.decode_s
    finally:
        # stop the trace even when a round raises — otherwise the profiler
        # keeps running and the trace is never written
        if profiler is not None:
            profiler.__exit__(None, None, None)
            print(f"# trace written to {args.profile_dir}", file=sys.stderr)

    n = rounds
    ptok, otok = agg["ptok"] / n, agg["otok"] / n
    ps, ds = agg["ps"] / n, agg["ds"] / n
    first_lat = ps / max(ptok, 1) * 1000
    out_lat = ds / max(otok - 1, 1) * 1000
    print(f"quant:{qtype.name}\tprompt_size:{ptok:.0f}\toutput_size:{otok:.0f}\t"
          f"total_latency:{(ps+ds)*1000:.0f}ms\t"
          f"prompt_token_latency:{first_lat:.2f}ms\t"
          f"output_token_latency:{out_lat:.2f}ms\t"
          f"prompt_speed:{1000/max(first_lat,1e-9):.1f}tps\t"
          f"output_speed:{1000/max(out_lat,1e-9):.1f}tps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
