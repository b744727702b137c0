#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fastllama_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --phases 1,2   # a subset while iterating
    python3 chip_smoke.py --phases 1 --regs-against OTHER/flash_decode.cu \
        --regs-against OTHER/qmm.cu --regs-against OTHER/qmm_prefill.cu

Phases (any failure exits non-zero; no phase catches an error and goes on):

1. the card and toolchain; build every CUDA kernel from ``csrc/`` (nvcc
   version and ``-Xptxas -v`` printed; the instantiations of the groupdot
   ring and the wide ring of K1 and of their G32 instantiations (group
   sizes off 64: ``qmm_pipe_g32_kernel``, ``qmm_pipe_wide_g32_kernel``),
   of the split-row modes of K2 (non-fresh; fresh and stats) and K2s and
   of K2b's split-TF32 mode must not spill, and their registers are
   recorded; with ``--regs-against`` another tree's flash_decode.cu is
   built beside them and its kernels, the split kernels of K2 and K2s
   among them, must keep its registers (in this tree the kernels of that
   one source are in three: flash_decode.cu, flash_decode_split.cu and
   flash_block_tc.cu, each its own nvcc; a tree of either layout may be
   the other), the nvcc seconds of each source are recorded, and another tree's qmm.cu, whose
   ``qmm_pipe_kernel``, ``qmm_pipe_gd_kernel``, ``qmm_pipe_wide_kernel``,
   ``qmm_bf16_kernel`` and ``qmm_f32_kernel`` instantiations must keep
   its registers, and another tree's qmm_prefill.cu, whose
   ``qmm_wgmma_kernel`` and ``qmm_wgmma_wide_kernel`` instantiations must
   keep its registers; ``qmm_prefill.cu``'s ``qmm_wgmma_kernel`` and
   ``qmm_wgmma_wide_kernel`` and their G32 kernels must not spill, ptxas
   must not have serialized their wgmma, and its library's SASS must hold
   ``HGMMA`` where the toolkit has ``cuobjdump``);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the LLaMA2-7B serving paths: the batched path's kernels (K2
   with fresh rows over int8, bf16 and f32 caches, also at a ``model=2``
   rank's one slot of 16 heads, every call in its split-row mode, then
   that mode with and without stats at B=48 and pos 0, 107, 511 and
   mixed, at B=12 and 1 over S=2048, also at 2-16 forced splits: 2b; K3's
   writers, bit-equal, f32 at a rank's heads too: 2c), then
   K1f (the matmul with the rmsnorm prologue / residual epilogue) at the
   single-stream decode shapes, K2's non-fresh mode at B=1 through its
   three wrappers and per slot through ``flash_decode_batched`` and
   ``decode_attention_pallas_batched``, then its split-row mode across
   cache dtypes, hgs 1/2/4/8, hs 64/128, B 1/4/32 and pos 0, 1, 107,
   S-1 and 2047 at S=2048, each call advancing ``launches_split`` (2e),
   K2s, the speculative-verify
   attention, at B=32 and T in {2, 4, 8} through its wrapper (the
   split-row mode, one ``launches_split`` a call), the tiled kernel and
   the split mode at 2, 3, 8 and 16 splits on the same inputs, and at B=1
   and 4 over S=2048, over int8, bf16 and f32 caches, and the
   single-stream verify on a ``model=2`` rank (B=1, 16 heads) (2f),
   ``spec_write`` (2g, f32 at a rank's heads too),
   K1p, the packed INT4 matmul, at the 7B INT4 shapes (2h), K2b, the
   prefix cache's block-attend, at T up to 496 over a B=48 cache, at
   GQA hgs = 8 and at ragged T and start, in its tensor-core mode (bf16 q
   over an int8 or bf16 cache) and its split-TF32 mode (f32 q over every
   cache, bf16 q over an f32 cache; also at hs 64, 80, 96 and 256, where
   bf16 q off hs % 16 takes it too), each call one ``launches_tc`` or
   ``launches_tf32``, and a misaligned view in the CUDA-core f32 mode
   (2i), K2 with its softmax
   stats (o, m, l) at B=48, every call in the split-row mode (2j),
   and the groupdot (scale-after-dot) mode of K1 and K1p at the 7B
   shapes, T in {1, 48, 128}, auto and one split, on the pipelined ring
   (one ``launches_groupdot_pipe`` a call) and on the forced loop, gs =
   128 on the ring, O = 1000 and gs = 16 and 32 on the loop, the wide
   cases equal to K1 bit for bit, gs = 8 refused (2k), and the
   pipelined mode of K1 and K1p (``qmm_pipe_kernel``) at the 7B shapes,
   INT8 with f32 and bf16 scales and packed INT4, T in {1, 48, 128},
   bare and with the norm gain and residual, each call one launch on its
   wrapper's ``launches_pipe`` (2l), and K1's wide mode on the ring
   (``qmm_pipe_wide_kernel``, f32 compute) at the 7B shapes, T in {1, 5,
   48, 128}, f32 and bf16 scales and x, bare and with the norm gain and
   residual, the auto split and one split, each wrapper call one launch on
   its ``launches_wide_pipe``, then above 128 rows on its prefill kernel
   (``qmm_wgmma_wide_kernel``) at the four projections of a layer, T in
   {129, 200, 256, 1024, 2048}, f32 and bf16 scales and x, bare and with
   the glue, each wrapper call one launch on its ``launches_wide_prefill``,
   and both on the plane probe (an identity INT8 weight with power-of-two
   scales on f32 x, within 2^-21 of the exact product, where leaving out
   x's lo plane is four times that off) (2m), and the prefill mode of K1 and K1p
   (``qmm_wgmma_kernel``, T > 128) at the four 7B projections, T in {129,
   200, 256, 1024, 2048}, INT8 with f32 and bf16 scales and packed INT4
   (hidden 11264) with f32 scales on bf16 and f32 x, bare and with the
   norm gain, the residual and both, each wrapper call one launch on its
   ``launches_prefill`` and none on ``launches_pipe`` (2n), K1 at group
   sizes 32 (a GGUF ``Q8_0`` file's) and 96 on the G32 instantiations
   (2o): the ring and the prefill kernel at bf16 compute, T in {1, 48,
   128, 129, 2048}, and the wide ring and the wide prefill kernel
   (int8-held at f32 compute, INT16), at the 7B projections (I cut to a
   multiple of 192 at gs 96), bare and with the glue, each call one
   launch on its mode's count, and
   K1 on INT16 weights (2p): the wide ring's INT16 instantiation (T in
   {1, 16, 48, 64, 128}) and the wide prefill kernel's (T in {129, 512,
   2048}) at wqkv's and w2's shapes with the planes' edge values, bf16
   and f32 x and scales, K1, K1 indexed and K1f with the norm and with
   the residual (each call one launch on its ``launches_wide_pipe`` or
   ``launches_wide_prefill``), at one and three forced splits;
3. the engines' kernel paths against their plain paths at 7B width, 2
   layers, f32 compute: the ``BatchedEngine`` (int8 KV, B=4), the
   single-stream ``Engine`` (f32 scales and KV: logits, 40 greedy tokens
   with a tail chunk, a two-turn ``ChatSession``) and (3c) the batched
   speculative verify and ``SpecBatchedEngine`` (int8 KV, B=4: logits,
   caches, greedy tokens equal to plain serving with the tuner off and
   on; every verify launch of K2s in its split-row mode);
3d. the same three comparisons at packed INT4 (bench.py's INT4 shape:
   hidden_dim 11264, every projection packed, through K1p);
3e. the prefix cache and deferred KV, kernel path against plain path (7B
   width, 2 layers, f32, int8 KV, B=4): a tail prefill and deferred steps
   in lockstep, then the BatchedEngine and SpecBatchedEngine on
   donor-then-hits traffic and the deferred BatchedEngine; every K2b
   launch (f32 q over the int8 cache, and over an f32 cache where the
   hits' tokens must equal the engine's without the prefix cache) in the
   split-TF32 mode, and K1's launches of a deferred step counted, all in
   its wide mode's ring;
3f. unquantized f32 weights (``random_params``) at phase 3's
   configuration: the BatchedEngine with plain and deferred chunks and
   the single-stream Engine, kernel path against plain path (equal greedy
   tokens; K1 must not launch, K2 and K3 must);
3g. the single-stream ``SpeculativeEngine`` at phase 3's configuration
   (INT8, f32 compute, f32 scales and KV, S=128), kernel path and plain
   path: speculative greedy tokens equal to ``Engine.generate``'s for the
   n-gram drafter at widths 4 and 8, a ``truncate_params(..., 1)`` and a
   ``requantize_params(..., INT4)`` draft and a 90-token prompt (38 new
   tokens, the shrunken last chunk and the plain tail); ``forward`` at
   device positions bit-equal to a host pos (T = 1 and 8); on the kernel
   path no synchronizing call inside a chunk (greedy and sampled, both
   drafters; the debug mode "error") and sampled runs (0.8, 0.9) of 40
   tokens inside the vocab;
3h. the checkpoint loaders on the card (7B width, 2 layers, f32
   compute): one seeded set of fp32 weights written as an llama2c file,
   an FLM INT8 file (the port's ``write_flm``, quantizing on the card), a
   GGUF ``Q8_0`` file and two HF directories (a ``.bin`` shard by
   ``torch.save``, a ``.safetensors`` shard written byte by byte), one at
   a time under ``tempfile.gettempdir()``, each loaded by ``Engine.load``:
   every leaf bit-equal to ``build_params`` on the in-memory arrays (the
   GGUF leaves to what its ``Q8_0`` bytes encode, group size 32), the
   card's ``build_params`` bit-equal to the CPU's, the prefill logits
   within ``TOL_F32`` and 24 greedy tokens equal to an engine on the
   in-memory parameters; the GGUF engine's K1 launches, and a 200-token
   prefill on its parameters, all on the wide mode's G32 kernels (the
   wide ring and the wide prefill kernel), none on ``qmm_f32_kernel``;
4. the batched serving path at full width: ``BatchedEngine`` over 7B /
   INT8 / fused QKV and gate|up / int8 KV / B=48 / S=512, 32 layers,
   synthetic weights made on the card; 48 requests of a 43-token prompt
   and 128 new tokens, greedy, decode chunk 64.  Launch counters are
   zeroed just before and read just after; every kernel of the path must
   have run, every K1/K1p launch with T <= 128 must have taken the
   pipelined mode and every one above 128 rows (the prefill waves: 256)
   the prefill mode (a tally of ``qmm.qmm_mode`` by mode and T, held to
   the wrappers' ``launches_pipe`` and ``launches_prefill``; so in 4b-4g
   and 4i too), and every K2 launch its split-row mode (so in 4d and
   4f).  Then one 16-step decode chunk is
   traced with ``torch.profiler`` (device time by kernel, the K1 family's
   and K2's a step, the device's idle share);
4p. dispatch-ahead decode (``FASTLLAMA_PIPELINE=1``) on phase 4's engine
   at decode chunk 16, 48 requests of its prompt and 64 new tokens: the
   sequential and the pipelined run in eight balanced turns, tokens equal
   in every run, three chunks dispatched ahead a pipelined run; each
   run's tok/s and its wall a step split into launching, emitting and
   the rest; the first pipelined run's launches by mode; no host sync
   inside a chunk queued ahead; device ms a step traced in each mode on
   its own traffic (two 8-step chunks);
4b. the single-stream serving path at full width (bench.py's
   ``bench_single`` shape): ``Engine`` over 7B / INT8 / QKV and gate|up
   fused once / bf16 scales ("auto") / bf16 KV / S=512, the 43-token
   prompt, 128 new tokens, greedy, decode chunk 64, one warm-up and one
   measured run with the counters zeroed just before; one decode chunk
   traced (K2 non-fresh's device ms a step by mode).  Then the
   ``flash_attention=False`` engine and a ``forward`` with the one-layer
   attention hook, each with the counters zeroed, so that every wrapper
   of K2's non-fresh mode runs on a path; every non-fresh launch of the
   three must be in the split-row mode; then a ``ChatSession`` fed a
   200-token block (a 256-row prefill at pos 1, K1f's glue above 128
   rows), every K1f launch of the block in the prefill mode
   (``feed_block``);
4c. speculative serving at full width (bench.py's ``bench_spec_serving``
   shape): ``SpecBatchedEngine`` over 7B / INT8 unfused / scale_dtype
   "auto" (f32) / int8 KV / B=32 / S=512, width 4, 32 rounds a chunk, decode
   chunk 64, the tuner on; 32 requests of the repetitive 43-token prompt,
   129 new tokens, greedy; a warm-up and a measured pass with the counters
   zeroed just before it (every K2s launch must be in its split-row mode);
   the plain ``BatchedEngine`` on the same traffic for scale; one spec
   chunk of 8 rounds traced;
4d. INT4 serving at full width (bench.py's ``BENCH_QUANT=int4``): phase
   4's measurement over 7B / INT4 packed, hidden_dim 11264, fused once /
   f32 scales / int8 KV / B=48 / S=512, 32 layers; K1p's indexed and plain
   forms must have run;
4e. INT4 single stream on the same parameter set (the batched engine
   freed first): phase 4b's measurement with f32 scales ("auto" at INT4),
   K1p's fused form carrying the layer glue;
4f. prefix-cache serving on phase 4's engine: a donor with a 256-token
   system prompt, then 47 hits with distinct 8-40-token tails, 128 new
   tokens each; 47 hits reusing 256 rows each and K2b launched 32 times a
   hit, every launch in its tensor-core mode, and every K2 launch split,
   are required; TTFT, prefill seconds, tok/s and memory beside the same
   traffic without the prefix cache;
4i. phase 4f at the default f32 KV cache of both packages (``kv_dtype
   "float32"``; 25.8 GB of cache): every K2b launch in its split-TF32
   mode (``launches_tf32``), every K2 launch split, every kernel of
   ``PREFIX_F32_PATH`` launched; the same records;
4j. phase 4b's single stream at f32 compute (7B INT8 fused once, bf16
   scales "auto", the default f32 KV cache, the 43-token prompt, 128 new
   tokens, decode chunk 64): every K1 launch with T <= 128 (the prefill,
   the K1f glue, the classifier) in the wide mode's ring, by a tally of
   ``qmm.wide_kernel`` held to the wrappers' ``launches_wide_pipe``; tok/s,
   memory and a traced chunk as 4b; then 4b's 200-token ``ChatSession``
   block, its 128 K1f launches above 128 rows on the wide mode's prefill
   kernel (held to ``launches_wide_prefill``);
4k. phase 4's batched serving at f32 compute (int8 KV, B=48, S=512, 48
   requests of the 43-token prompt, 128 new tokens): every K1 launch with
   T <= 128 in the wide mode's ring, every one of the prefill waves above
   128 rows (256) on its prefill kernel and none on ``qmm_f32_kernel``,
   tallied and held to ``launches_wide_pipe`` and
   ``launches_wide_prefill``; the records of phase 4;
4l. single-stream speculative serving on phase 4b's engine
   (``SpeculativeEngine``, width 8, 8 rounds a call, 128 new greedy
   tokens): the n-gram drafter on ``tools/spec_bench.py``'s loop prompt
   and on 4b's prompt, and a ``truncate_params(cfg, params, 4)`` draft on
   4b's prompt, each beside ``Engine.generate`` on its prompt; every
   K1/K1f launch with T <= 128 (the verify's 8 rows, the draft's steps)
   on the pipelined ring and every K2 non-fresh launch split; the tokens
   held to plain greedy by ``same_greedy``'s tie rule (bf16 compute);
   tok/s, acceptance, rounds, memory and launches a round; then one chunk
   of 8 rounds of each traced (device ms and ops a round, idle share);
4m. serving from files at 7B width: a 16-layer FLM INT8 file written by
   the port's ``write_flm`` from fp32 layers drawn on the card one at a
   time (while the kernels build), served through ``Engine.load`` on
   4b's measurement and ``BatchedEngine.load`` on 4's (every K1/K1f
   launch on the ring or the prefill mode, the launch counts equal to
   4/4b's with the per-layer ones halved, which must run with it); a
   4-layer GGUF ``Q8_0`` file (group
   size 32: every K1 launch on the ring's or the prefill mode's G32
   instantiation, none on the loop) and a 4-layer fp32 llama2c file
   loaded with qtype INT16 (every K1 launch on the wide ring or the wide
   prefill kernel, none on ``qmm_f32_kernel``) through both entry points
   on the same traffic; the seconds to write and to load, tok/s, ms a
   step,
   memory and profiles; then the CLI as subprocesses (``-m benchmark`` on
   the 32-layer file alone; ``serve``, ``serve --spec``, ``serve
   --prefix-cache``, ``gen --spec``, ``chat`` on stdin, ``-e``/``-d`` and
   ``--profile-dir`` at once, on a 4-layer FLM file), each exiting 0 with
   its output checked, ``--mesh model=2`` and ``serve --multihost
   --mesh data=2`` in one process exiting 2 (a mesh larger than the
   world);
4n. INT16 at full depth: 7B / INT16 / 32 layers from
   ``random_params_int`` (13.5 GB of weights, f32 scales), fused once,
   at bf16 compute through phase 4's ``BatchedEngine`` (int8 KV, B=48,
   4's traffic) and phase 4b's ``Engine`` (bf16 KV, 4b's traffic and its
   200-token ``ChatSession`` block): every K1 launch with T <= 128 on
   the wide ring and every one above (the 256 prefill-wave launches, the
   block's 128 K1f launches) on the wide prefill kernel, none on
   ``qmm_f32_kernel``; tok/s, ms a step, the traced device ms a step and
   idle share, memory;
4o. INT8 at group size 32 (a GGUF ``Q8_0`` model's) at full depth: 7B /
   32 layers from ``random_params_int`` at gs 32, fused once, at bf16
   compute through phase 4's ``BatchedEngine`` (f32 scales) and phase
   4b's ``Engine`` (bf16 scales, its 200-token block): every K1 launch
   with T <= 128 on the ring's G32 instantiation and every one above on
   the prefill mode's, none on the loop; tok/s, ms a step, the traced
   device ms a step and idle share, memory;
4g. deferred KV on phase 4's engine and traffic, 16 layers deep, at
   decode chunk 16 (every chunk deferred, every K2 launch with stats in
   the split-row mode) against plain chunks, in turns;
4h. the measurement path through the port's tools: the bandwidth probe
   (``tools/hbm_peak.py``, 128/512/1024 MB), then ``tools/qmm_sweep.py``
   at the 7B decode shapes, T=1 and 48, INT8 and INT4, auto split,
   standard and groupdot (the groupdot mode's launches come from here,
   every one on the pipelined ring);
5. each kernel timed with CUDA events at the path's shapes, beside its
   bound (bytes over the card's 3.35 TB/s, or operations over peak), its
   plain version and a library call (K1 and K1p: the pipelined mode, the
   loop on the same calls, ``torch.matmul`` and the plain version timed
   in turns, and a verify round's unfused INT8 layer at T = 128; their
   prefill mode: a 7B INT8 layer at T in {256, 512, 1024, 2048}, the INT4
   layer at T in {512, 2048}, each projection at T = 2048, K1f's glue
   layer at T = 256 and the unindexed wrapper on wqkv at T = 2048, the
   kernel, the loop and ``torch.matmul`` in turns, the plain version at
   T = 512 in turns and alone at 2048 and 256; the
   groupdot mode: the ring, the loop, the standard mode, ``torch.matmul``
   and the plain version in turns; K1's wide mode (f32 compute): the
   ring, ``qmm_f32_kernel`` on the same calls, ``torch.matmul`` on f32
   weights and the plain version in turns at a 7B layer, T=48 (f32
   scales), T=1 (f32 and bf16 scales; a glue layer at bf16 scales) and
   the classifier at T=48; its prefill kernel above 128 rows: a 7B layer
   at T in {256, 512, 1024, 2048}, each projection at T = 2048, K1f's glue
   layer at T = 256 and the unindexed wrapper on wqkv at T = 2048, in
   turns with ``qmm_f32_kernel`` on the same calls, ``torch.matmul`` on
   f32 weights and (T = 512) the plain version, and the pre-pass's share
   of a layer at T = 2048 (the pre-pass alone in turns with the calls);
   K2b: the tensor-core mode at T in
   {32, 64, 128, 256} and against start, the CUDA-core f32 mode on its
   inputs at T=32 and 256, and on its own f32 inputs (bf16 q over an f32
   cache, f32 q over an int8 and over an f32 cache) at T=32 and 256 the
   split-TF32 mode, the CUDA-core f32 mode, SDPA in f32 and the plain
   version in turns (the TF32 mode must beat the CUDA-core mode at
   each; the SDPA backend's kernels are recorded);
   K2 non-fresh: the split-row mode and the tiled kernel at B=1 against
   pos, 0 to 511 at S=512 and 2047 at S=2048, and at B=32, the split
   mode at other split counts, least chunks and warps a block at pos 107,
   255, 511 and 2047, and other warps a block at pos 0 and 107; K2 with
   fresh rows and with stats: the split-row mode, the tiled kernel, SDPA
   and the plain version in turns at B=48, S=512, pos 107 (phase 4's
   reading, with and without stats) and mixed positions, and at B=12,
   S=2048, pos 2040, also at 1, 2, 4 and 8 splits; K2s: the
   split-row mode, the tiled kernel, the plain version and SDPA in turns
   at phase 4c's reading, B=32, pos 107, T in {2, 4, 8}, and at B=4,
   S=2048, pos 2040, the split mode also at 1, 2 and 4 splits; the modes a
   loaded model reaches (3h, 4m, 4n, 4o): K1 and K1f at group size 32 on
   the G32 instantiations at bf16 compute (in turns with the loop they
   replace) and at f32 compute (the wide ones, in turns with
   ``qmm_f32_kernel``), and at INT16 (gs 64, and gs 32 for K1) on the
   wide kernels (in turns with ``qmm_f32_kernel``), the ring at T in {1,
   48} and the prefill kernels at T = 2048, a 7B layer, also in turns
   with ``torch.matmul`` on pre-dequantized weights and the plain
   version; every new kernel must beat the kernel it replaces);
6. the perplexity tool (``tools/eval_ppl.py``) at 7B, 32 layers: fp32
   weights made on the card from one seed, built at INT8, INT16 and fp32,
   f32 compute: ``evaluate`` (window 512) over 2048 seeded token ids at
   INT8 and the first 512 at INT16 and fp32; at INT8 ``evaluate_decode``
   (B = 4, chunk 64) with an f32 KV cache within 1e-3 of it in log
   perplexity, and with an int8 KV cache; every K1 launch on the wide
   ring or its prefill kernel;
6b. the mesh path in this process (``mesh="model=1"``, ``spmd_kernels``,
   an NCCL group of one rank) on one set of 32-layer weights: phase 4's
   ``BatchedEngine`` (the batched steps given the mesh) and 4b's
   ``Engine`` (a one-rank mesh keeps the one-card path), and 4c's
   ``SpecBatchedEngine`` at 4 layers, each held to the same engine
   without a mesh (logits within 1e-2 of max|ref| at bf16), then a short
   counted run of each (16 new tokens; 33 speculative), every K1 launch
   on the ring or the prefill kernel; device ms a step beside 4's and
   4b's;
6c. two spawned ranks on the one card (each given ``cuda:0`` and gloo:
   NCCL refuses two ranks on one GPU): a probe of gloo's collectives on
   CUDA tensors, then ``model=2`` and ``data=2`` on the 4-layer 7B FLM
   INT8 file loaded by each rank on the mesh (``BatchedEngine.load``:
   its shard alone; host and card memory of the load), int8 KV, B=8:
   greedy tokens at f32 equal to one rank's engine, the bf16 prefill's
   int8 cache of the first layer within one quantum beyond the bf16 bar
   of one rank's (every layer recorded, beside one card's fused engine
   against its unfused one), one decode step's logits within 1e-2 at
   bf16, per rank the launches by
   mode, device ms a step and peak memory (no scaling: one card).  A
   rank that fails fails the run;
6d. multi-host serving, in 6c's two rank processes after its ``data=2``
   run, on the weights its f32 engine loaded (``data=2``: a host a rank,
   4 slots a host, int8 KV, host d given 6c's prompts 4d..4d+3):
   ``MultiHostEngine`` at f32, its tokens by host equal to 6c's one-rank
   engine's, then a prefix hit on each host's own donor; ``global_stats``
   equal on both ranks, each request counted once;
   ``MultiHostSpecEngine`` (width 2) at f32, its tokens equal to one
   rank's, drafting on both hosts; one 16-token counted run at bf16 (ms
   a step, the traced device ms a step, launches by mode, peak memory a
   rank); then the CLI's ``serve --multihost --mesh data=2`` on the same
   file as two spawned ranks joining from torchrun's variables (gloo on
   the one card): exit 0, each host's completions and the ``fleet:``
   line;
6e. the single-stream ``SpeculativeEngine`` (width 4) on ``model=2``, in
   6c's two rank processes on the 4-layer FLM file: the n-gram drafter
   and a 2-layer draft (``truncate_params``) at f32, their tokens equal
   to one rank's engine's on both ranks; then at bf16 compute over the
   engine's default f32 cache and over a bf16 cache, each: one verify's
   logits as close to the f32 verify's as one rank's engine's (plus
   1e-2·max|ref|; the f32 verify's within 1e-4 of one rank's), a 32-token
   counted run (ms a round, launches a round by kernel, K2s's split mode
   and ``spec_write`` required, peak memory a rank, tokens equal on both
   ranks) and a traced chunk (device ms a round, idle share).  The launches of 6, 6b, 6c, 6d and
   6e are added to each kernel's count in the kernels line.

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json`` (``build/`` is git-ignored).  Exits non-zero
without printing a result when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12          # H100 SXM HBM3
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor cores
F32_FLOP_S = 67e12             # H100 SXM f32 outside the tensor cores
TF32_FLOP_S = 495e12           # H100 SXM dense TF32 tensor cores

# Tolerances, kernel against plain version on the same inputs: the two sum
# in a different order and both round the output.
TOL_F32 = 1e-4                 # x max|plain|, f32 outputs
TOL_BF16 = 1e-2                # x max|plain|, bf16 outputs
TOL_P4_NORM = 1e-3             # K1p, f32 x through the norm prologue (2h)
TOL_PLANES = 2.0 ** -21        # x max|exact|: the wide mode's plane probe
INT4_FLIP_CAP = 2e-2           # share of int8 cache elements one quantum off

SEED = 1234


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Failed(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise Failed(msg)


def compare(name, got, want, tol, quiet=False):
    """max|got - want| <= tol * max|want|; returns the error.  ``quiet``
    logs nothing when the check passes (a sweep logs its own summary)."""
    import torch
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = float((g - w).abs().max())
    ref = float(w.abs().max())
    check(err <= tol * max(ref, 1e-30),
          f"{name}: max abs err {err:.3e} > {tol} x max|ref| {ref:.3e}")
    if not quiet:
        log(f"  ok {name}: max_abs_err {err:.3e} (max|ref| {ref:.3e})")
    return err


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# -- shapes of the main path (bench.py's LLaMA2-7B serving shape) ----------

def cfg_7b(n_layers=32):
    from fastllama_tpu_torch.config import ModelConfig, QuantType
    return ModelConfig(dim=4096, hidden_dim=11008, n_layers=n_layers,
                       n_heads=32, n_kv_heads=32, vocab_size=32000,
                       max_seq_len=512, quant_type=QuantType.INT8,
                       name="llama2-7b-synthetic")


PROJ_7B = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
           "w2": (11008, 4096), "classifier": (4096, 32000)}


def cfg_7b_int4(n_layers=32):
    """bench.py's INT4 configuration (bench.py:246-255): hidden_dim padded
    from 11008 to 11264, so that every projection packs; group size 64,
    f32 scales ("auto" resolves to f32 at INT4)."""
    from fastllama_tpu_torch.config import QuantType
    return cfg_7b(n_layers).replace(hidden_dim=11264,
                                    quant_type=QuantType.INT4)


PROJ_7B_INT4 = dict(PROJ_7B, w13=(4096, 22528), w2=(11264, 4096))


def rand_packed(gen, shape, dev, scale_dtype=None, gs=64):
    """A split-half packed INT4 (…, I/2, O) weight of random nibbles over
    the whole range [-8, 7] (the sign extension's edge) and random
    positive group scales, ``gs`` rows a group."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.quant.groupquant import QArray, pack_int4_rows
    data = torch.empty(shape, dtype=torch.int8, device=dev).random_(
        -8, 8, generator=gen)
    sshape = (*shape[:-2], shape[-2] // gs, shape[-1])
    s = (torch.rand(sshape, generator=gen, device=dev) + 0.5) * (0.02 / 7)
    if scale_dtype is not None:
        s = s.to(scale_dtype)
    return QArray(pack_int4_rows(data), s, QuantType.INT4, gs, group_axis=-2,
                  packed=True)


def rand_qarray(gen, shape, qtype, dev, scale_dtype=None, gs=64):
    """(…, I, O) weight with random values AND random positive group
    scales (constant scales would hide a scale-indexing fault), ``gs``
    rows a group."""
    import torch
    from fastllama_tpu_torch.quant.groupquant import QDTYPE, QArray
    qmax = qtype.factor
    data = torch.empty(shape, dtype=QDTYPE[qtype], device=dev)
    data.random_(-qmax, qmax + 1, generator=gen)
    sshape = (*shape[:-2], shape[-2] // gs, shape[-1])
    s = (torch.rand(sshape, generator=gen, device=dev) + 0.5) * (0.02 / qmax)
    if scale_dtype is not None:
        s = s.to(scale_dtype)
    return QArray(data, s, qtype, gs, group_axis=-2)


def check_no_spill(build_log: str, kernel: str):
    """Each instantiation of ``kernel`` in the ``-Xptxas -v`` log: its
    registers, and no spill (fails otherwise).  Returns {name and
    template arguments, mangled: registers}."""
    import re
    lines = build_log.splitlines()
    regs = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*" + kernel + r"\S*)'",
                      line)
        if not m:
            continue
        near = lines[i + 1:i + 6]
        spill = next((t for t in near if "spill stores" in t), "")
        used = next((t for t in near if "registers" in t), "")
        check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
              f"{m.group(1)} spills: {spill.strip()}")
        name = m.group(1)[m.group(1).index(kernel):].split("EEv")[0]
        regs[name] = int(re.search(r"Used (\d+) registers", used).group(1))
    check(len(regs) > 0, f"no {kernel} instantiation in the build log")
    log(f"  ok {len(regs)} {kernel} instantiations, no spill; registers "
        f"{sorted(regs.values())}")
    return regs


def check_prefill_build(build_log: str):
    """Phase 1 for ``qmm_prefill.cu``: no ``qmm_wgmma_kernel`` or
    ``qmm_wgmma_wide_kernel`` instantiation, nor one of their G32 kernels
    (``qmm_wgmma_g32_kernel``, ``qmm_wgmma_wide_g32_kernel``), spills,
    ptxas left their wgmma
    asynchronous (no C75xx performance note in the source's log), and the
    library's SASS holds ``HGMMA`` (where the toolkit has ``cuobjdump``).
    Returns the registers and the HGMMA count."""
    import shutil
    from fastllama_tpu_torch.ops.kernels import _build
    regs = check_no_spill(build_log, "qmm_wgmma_kernel")
    for kernel in ("qmm_wgmma_wide_kernel", "qmm_wgmma_g32_kernel",
                   "qmm_wgmma_wide_g32_kernel"):
        regs.update(check_no_spill(build_log, kernel))
    ours = build_log.split("== qmm_prefill.cu (rc")[1].split("\n== ")[0]
    notes = [t.strip() for t in ours.splitlines() if "(C75" in t]
    check(not notes, f"qmm_prefill.cu: ptxas performance notes {notes}")
    cuobjdump = (shutil.which("cuobjdump", path=os.path.dirname(
        _build.nvcc())) or shutil.which("cuobjdump"))
    hgmma = None
    if cuobjdump is not None:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.build() / "libqmm_prefill.so")],
            capture_output=True, text=True, check=True).stdout
        hgmma = sum("HGMMA" in t for t in sass.splitlines())
        check(hgmma > 0, "qmm_prefill.cu: no HGMMA in the library's SASS")
        log(f"  ok qmm_prefill.cu: {hgmma} HGMMA instructions in its SASS, "
            f"no ptxas performance note")
    else:
        log("  qmm_prefill.cu: no cuobjdump in the toolkit, SASS not read")
    return {"registers": regs, "hgmma": hgmma}


def entry_regs(text: str):
    """{entry function: registers} of an ``-Xptxas -v`` log, each mangled
    name without its anonymous namespace (which hashes the file's
    path)."""
    import re
    lines = text.splitlines()
    regs = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            used = next(t for t in lines[i + 1:i + 6] if "registers" in t)
            name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_"
                          r"[0-9a-f]{8}", "", m.group(1))
            regs[name] = int(
                re.search(r"Used (\d+) registers", used).group(1))
    return regs


# the sources that hold, by kernel family, what was one flash_decode.cu
FLASH_DECODE_FAMILY = ("flash_decode.cu", "flash_decode_split.cu",
                       "flash_block_tc.cu")


class RefBuild:
    """An ``--regs-against`` nvcc process, read to its end by a thread so
    that its seconds (from the build's start, beside it) are its own."""

    def __init__(self, cmd, t0):
        import threading
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.thread = threading.Thread(target=self._wait, args=(t0,))
        self.thread.start()

    def _wait(self, t0):
        self.text = self.proc.communicate()[0]
        self.returncode = self.proc.returncode
        self.seconds = time.perf_counter() - t0

    def join(self):
        self.thread.join()


def check_regs_against(ref, src, rec, build_log):
    """Phase 1 with ``--regs-against``: the reference build ``ref`` (an
    nvcc process on another tree's flash_decode.cu, qmm.cu or
    qmm_prefill.cu).  Of flash_decode.cu it must hold the same
    instantiations of ``flash_decode_split_kernel`` and
    ``flash_spec_split_kernel`` with the same registers as this build, and
    so every kernel of this build's FLASH_DECODE_FAMILY (the kernels of
    one flash_decode.cu before it was split by family; a reference that
    is one source of a split tree holds its own kernels only, and is
    held to those); of qmm.cu the same
    instantiations of ``qmm_pipe_kernel``, ``qmm_pipe_gd_kernel``,
    ``qmm_pipe_wide_kernel``, ``qmm_bf16_kernel`` and ``qmm_f32_kernel``
    with the same registers; of qmm_prefill.cu those of
    ``qmm_wgmma_kernel`` and ``qmm_wgmma_wide_kernel`` (the G32 kernels
    are this build's own)."""
    ref.join()
    text = ref.text
    check(ref.returncode == 0, f"nvcc failed for {src}:\n{text}")
    rec.setdefault("regs_against", []).append(src)
    rec.setdefault("regs_against_nvcc_s", {})[src] = ref.seconds
    log(f"  {src}: {ref.seconds:.1f} s of nvcc, beside this build's")
    base = os.path.basename(src)
    if base in ("qmm.cu", "qmm_prefill.cu"):
        ours = build_log.split(f"== {base} (rc")[1].split("\n== ")[0]
        mine, theirs = entry_regs(ours), entry_regs(text)
        for kernel in (("qmm_pipe_kernel", "qmm_pipe_gd_kernel",
                        "qmm_pipe_wide_kernel", "qmm_bf16_kernel",
                        "qmm_f32_kernel")
                       if base == "qmm.cu" else
                       ("qmm_wgmma_kernel", "qmm_wgmma_wide_kernel")):
            a, b = ({k: v for k, v in regs.items() if kernel + "I" in k}
                    for regs in (mine, theirs))
            check(a == b and len(a) > 0,
                  f"{kernel}: instantiations or registers differ from "
                  f"{src}: {set(a.items()) ^ set(b.items())}")
            log(f"  ok {kernel}: the {len(a)} instantiations keep the "
                f"registers of {src} ({sorted(set(a.values()))})")
        return
    for key, kernel in (("decode_split_ptxas", "flash_decode_split_kernel"),
                        ("spec_split_ptxas", "flash_spec_split_kernel")):
        if kernel not in text:          # a split tree's tiled source
            continue
        theirs = check_no_spill(text, kernel)
        diff = {k: (rec[key].get(k), v) for k, v in theirs.items()
                if rec[key].get(k) != v}
        check(not diff and len(theirs) == len(rec[key]),
              f"{kernel}: registers (this build, {src}) differ: {diff}")
        log(f"  ok {kernel}: the {len(theirs)} instantiations keep the "
            f"registers of {src}")
    mine = {}
    for base in FLASH_DECODE_FAMILY:
        if f"== {base} (rc" in build_log:
            mine.update(entry_regs(
                build_log.split(f"== {base} (rc")[1].split("\n== ")[0]))
    theirs = entry_regs(text)
    if not ("split_kernel" in text and "flash_block_tc_kernel" in text):
        # one source of a split tree: its kernels only
        mine = {k: v for k, v in mine.items() if k in theirs}
    check(mine == theirs and len(theirs) > 0,
          f"{'+'.join(FLASH_DECODE_FAMILY)}: kernels or registers differ "
          f"from {src}: {set(mine.items()) ^ set(theirs.items())}")
    log(f"  ok {'+'.join(FLASH_DECODE_FAMILY)}: all {len(mine)} kernels "
        f"keep the registers of {src}")


# -- phase 2: kernels against plain versions --------------------------------

def phase_kernels(dev, rec):
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.ops.kernels import kv_write as kw
    from fastllama_tpu_torch.ops.kernels import qmm
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {name: 0.0 for name in KERNELS}

    log("phase 2a: K1 group-dequant matmul vs plain")
    for name, (I, O) in PROJ_7B.items():
        w = rand_qarray(gen, (I, O), QuantType.INT8, dev)
        for T in (1, 48, 2048):
            for cdt, xdt, tol in ((torch.bfloat16, torch.bfloat16, TOL_BF16),
                                  (torch.float32, torch.float32, TOL_F32)):
                x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                got = qmm.qmatmul_pallas(x, w, cdt)
                want = qmm.qmm_plain(x, w, cdt)
                e = compare(f"qmm {name} T={T} {str(cdt)[6:]}", got, want,
                            tol)
                errs["qmatmul_pallas"] = max(errs["qmatmul_pallas"], e)
        del w
    # bf16-stored scales (compress_scales); INT16: check_int16 (2p)
    w = rand_qarray(gen, (4096, 4096), QuantType.INT8, dev, torch.bfloat16)
    x = torch.randn((48, 4096), generator=gen, device=dev).to(torch.bfloat16)
    compare("qmm wo bf16-scales T=48", qmm.qmatmul_pallas(x, w),
            qmm.qmm_plain(x, w), TOL_BF16)
    # layer-indexed: layer 1 of a stacked (2, I, O) weight
    for name in ("wqkv", "w2"):
        I, O = PROJ_7B[name]
        ws = rand_qarray(gen, (2, I, O), QuantType.INT8, dev)
        for T in (1, 48, 2048):
            x = torch.randn((T, I), generator=gen, device=dev).to(
                torch.bfloat16)
            e = compare(f"qmm_indexed {name}[1] T={T}",
                        qmm.qmatmul_pallas_indexed(x, ws, 1),
                        qmm.qmm_plain(x, ws[1]), TOL_BF16)
            errs["qmatmul_pallas_indexed"] = max(
                errs["qmatmul_pallas_indexed"], e)
        del ws

    log("phase 2b: K2 flash decode vs plain")
    S = 512
    # the last: a draft step of the single-stream engine on model=2 (one
    # slot, 16 heads a rank, its f32 or bf16 cache)
    for label, B, H, n_kv, hs in (("7b", 48, 32, 32, 128),
                                  ("tinyllama", 48, 32, 4, 64),
                                  ("7b model=2 rank B=1", 1, 16, 16, 128)):
        L = 2
        pos = torch.randint(0, S, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        if B > 1:
            pos[:8] = torch.tensor([0, 1, 255, 256, 511, 63, 64, 0],
                                   dtype=torch.int32, device=dev)
        else:
            pos[0] = 300
        for cache_dt in (torch.int8, torch.bfloat16, torch.float32):
            shape = (L, B, n_kv, S, hs)
            if cache_dt == torch.int8:
                ck = torch.empty(shape, dtype=torch.int8, device=dev)
                cv = torch.empty(shape, dtype=torch.int8, device=dev)
                ck.random_(-127, 128, generator=gen)
                cv.random_(-127, 128, generator=gen)
                ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
                vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
            else:
                ck = torch.randn(shape, generator=gen, device=dev).to(cache_dt)
                cv = torch.randn(shape, generator=gen, device=dev).to(cache_dt)
                ks = vs = None
            for qdt, tol in ((torch.bfloat16, TOL_BF16),
                             (torch.float32, TOL_F32)):
                q = torch.randn((B, H, 1, hs), generator=gen,
                                device=dev).to(qdt)
                kn = torch.randn((B, n_kv, hs), generator=gen,
                                 device=dev).to(qdt)
                vn = torch.randn((B, n_kv, hs), generator=gen,
                                 device=dev).to(qdt)
                s0 = fd.flash_decode_batched.launches_split
                got = fd.flash_decode_batched(q, ck, cv, pos, 1, ks, vs,
                                              kn, vn)
                check(fd.flash_decode_batched.launches_split == s0 + 1,
                      f"flash {label}: a fresh call outside the split mode")
                want = fd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs,
                                             kn, vn)
                e = compare(f"flash {label} cache={str(cache_dt)[6:]} "
                            f"q={str(qdt)[6:]}", got, want, tol)
                errs["flash_decode_batched"] = max(
                    errs["flash_decode_batched"], e)
                # idle slots (pos 0) return exactly v_new
                idle = (pos == 0).nonzero().flatten()
                hgs = H // n_kv
                check(torch.equal(
                    got[idle, :, 0].float(),
                    vn[idle].float().repeat_interleave(hgs, dim=1)),
                    f"flash {label}: pos=0 slot is not exactly v_new")
        del ck, cv
    check_fresh_split(dev, gen, errs)

    log("phase 2c: K3 KV row scatter vs plain (bit-equal)")
    from fastllama_tpu_torch.models.batched import BatchedKVCache
    # the f32 cache at a model=2 rank's 16 heads, 4 layers deep (the
    # single-stream engine's default kv_dtype on a mesh), at B=32 and at
    # its one slot
    rank = cfg_7b(4).replace(dim=2048, n_heads=16, n_kv_heads=16)
    for kv_dt, cfg, B in ((torch.int8, cfg_7b(), 48),
                          (torch.bfloat16, cfg_7b(), 48),
                          (torch.float32, rank, 32),
                          (torch.float32, rank, 1)):
        L, n_kv, hs = cfg.n_layers, cfg.n_kv_heads, cfg.head_size
        tag = f"{str(kv_dt)[6:]} B={B} kv={n_kv}"
        base = BatchedKVCache.create(cfg, B, dtype=kv_dt, device=dev)

        def fresh(*shape):
            if kv_dt == torch.int8:
                t = torch.empty(shape, dtype=torch.int8, device=dev)
                return t.random_(-127, 128, generator=gen)
            return torch.randn(shape, generator=gen, device=dev).to(kv_dt)

        def scales(*shape):
            if kv_dt != torch.int8:
                return None
            return torch.rand(shape, generator=gen, device=dev)

        def clone(c):
            return BatchedKVCache(*(None if t is None else t.clone()
                                    for t in (c.k, c.v, c.k_scale,
                                              c.v_scale)))
        kq, vq = fresh(L, B, n_kv, hs), fresh(L, B, n_kv, hs)
        ks, vs = scales(L, B, n_kv), scales(L, B, n_kv)
        pos = torch.randint(0, cfg.max_seq_len, (B,), generator=gen,
                            device=dev, dtype=torch.int32)
        if B > 1:
            pos[:3] = torch.tensor([0, cfg.max_seq_len - 1, 31],
                                   device=dev, dtype=torch.int32)
        a, b = clone(base), clone(base)
        kw.decode_write(a, kq, vq, ks, vs, pos)
        kw.decode_write_plain(b, kq, vq, ks, vs, pos)
        torch.cuda.synchronize()
        for x, y in zip((a.k, a.v, a.k_scale, a.v_scale),
                        (b.k, b.v, b.k_scale, b.v_scale)):
            check(x is None or torch.equal(x, y),
                  f"decode_write {tag}: caches differ")
        log(f"  ok decode_write cache={tag} bit-equal")
        for N, T in ((32, 64), (4, 43)) if B > 1 else ((1, 43),):
            slots = torch.randperm(B, generator=gen, device=dev)[:N].to(
                torch.int32)
            kq, vq = fresh(L, N, n_kv, T, hs), fresh(L, N, n_kv, T, hs)
            ks, vs = scales(L, N, n_kv, T), scales(L, N, n_kv, T)
            if N > 1:
                # duplicate slots carry identical rows (admission padding)
                slots[-1] = slots[-2]
                for t in (kq, vq, ks, vs):
                    if t is not None:
                        t[:, -1] = t[:, -2]
            a, b = clone(base), clone(base)
            kw.prefill_write(a, kq, vq, ks, vs, slots)
            kw.prefill_write_plain(b, kq, vq, ks, vs, slots)
            torch.cuda.synchronize()
            for x, y in zip((a.k, a.v, a.k_scale, a.v_scale),
                            (b.k, b.v, b.k_scale, b.v_scale)):
                check(x is None or torch.equal(x, y),
                      f"prefill_write {tag} N={N} T={T}: caches differ")
            log(f"  ok prefill_write cache={tag} N={N} T={T}"
                + (" (duplicate slots)" if N > 1 else "") + " bit-equal")
        del a, b, base
    torch.cuda.empty_cache()
    check_fused(dev, gen, errs)
    check_non_fresh(dev, gen, errs)
    check_split(dev, gen, errs)
    check_spec(dev, gen, errs)
    check_spec_write(dev, gen, errs)
    check_p4(dev, gen, errs)
    check_block(dev, gen, errs)
    check_stats(dev, gen, errs)
    check_groupdot(dev, gen, errs)
    check_pipe(dev, gen, errs)
    check_wide(dev, gen, errs)
    check_wide_prefill(dev, gen, errs)
    check_wide_planes(dev, gen)
    check_prefill(dev, gen, errs)
    check_loaded_modes(dev, gen, errs)
    check_int16(dev, gen, errs)
    rec["max_abs_err"] = errs


def g32_proj(name: str, gs: int):
    """A 7B projection's (I, O) at group size ``gs``: at 96, which divides
    neither 4096 nor 11008, I cut to a multiple of 192 (4032, 10944: whole
    groups and whole 64-row stages)."""
    I, O = PROJ_7B[name]
    return (I - I % 192 if gs == 96 else I), O


def check_loaded_modes(dev, gen, errs):
    """Phase 2o: K1 at a group size off a multiple of 64 (GGUF ``Q8_0``'s
    32; 96, where a group ends halfway through a 64-row stage) on the G32
    instantiations, against ``qmm_fused_plain`` at the four 7B
    projections (:func:`g32_proj`): INT8 at bf16 compute on bf16 x, K1
    (f32 scales) and K1f with the glue (bf16 scales: the norm on wqkv and
    w13, the residual on wo and w2), T in {1, 48, 128, 129, 2048}, on the
    ring (``qmm_pipe_g32_kernel``, ``launches_pipe``) and the prefill
    kernel (``qmm_wgmma_g32_kernel``, ``launches_prefill``); the wide mode
    (f32 scales) on an int8-held weight at f32 compute on f32 x and on
    INT16 (bf16 x at bf16 compute, f32 x at f32), K1 at T in {1, 48, 129,
    2048} and K1f with the glue at 48 and 2048, on the wide ring
    (``launches_wide_pipe``) and the wide prefill kernel
    (``launches_wide_prefill``).  Every call must take that kernel
    (``qmm._kernel``) and move its count by one; bf16 outputs within
    ``TOL_BF16``, f32 within ``TOL_F32``.  (INT16 at gs 64:
    :func:`check_int16`.)"""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2o: K1 at group sizes 32 and 96 on the G32 instantiations "
        "(ring, prefill, wide ring, wide prefill), 7B projections, against "
        "the plain version")
    bf16, f32 = torch.bfloat16, torch.float32
    norm = {"wqkv": True, "wo": False, "w13": True, "w2": False}
    n_calls = 0
    for gs in (32, 96):
        for n in ("wqkv", "wo", "w13", "w2"):
            I, O = g32_proj(n, gs)
            for qt, sdt, xdt, cdt, glue, Ts in (
                    (QuantType.INT8, f32, bf16, bf16, False,
                     (1, 48, 128, 129, 2048)),
                    (QuantType.INT8, bf16, bf16, bf16, True,
                     (1, 48, 128, 129, 2048)),
                    (QuantType.INT8, f32, f32, f32, False, (1, 48, 129, 2048)),
                    (QuantType.INT8, f32, f32, f32, True, (48, 2048)),
                    (QuantType.INT16, f32, bf16, bf16, False,
                     (1, 48, 129, 2048)),
                    (QuantType.INT16, f32, f32, f32, True, (48, 2048))):
                w = rand_qarray(gen, (2, I, O), qt, dev, sdt, gs=gs)
                wide = qmm.is_wide(w, cdt)
                for T in Ts:
                    x = torch.randn((T, I), generator=gen,
                                    device=dev).to(xdt)
                    kw = {}
                    if glue and norm[n]:
                        kw["norm_gain"] = torch.rand((I,), generator=gen,
                                                     device=dev) + 0.5
                    elif glue:
                        kw["residual"] = torch.randn(
                            (T, O), generator=gen, device=dev).to(xdt)
                    kernel = (("wide_" if wide else "")
                              + ("pipe" if T <= 128 else "prefill"))
                    check(qmm._kernel(x, w[1], cdt, False,
                                      kw.get("residual")) == kernel
                          and qmm.g32(w), f"2o {n} T={T} gs {gs}: not on "
                                          f"the G32 {kernel} kernel")
                    fn = (qmm.qmatmul_pallas_indexed_fused if kw
                          else qmm.qmatmul_pallas_indexed)
                    n0 = getattr(fn, "launches_" + kernel)
                    got = fn(x, w, 1, cdt, **kw)
                    check(getattr(fn, "launches_" + kernel) == n0 + 1,
                          f"2o {n} T={T} gs {gs}: not one launch on "
                          f"{fn.__name__}.launches_{kernel}")
                    want = qmm.qmm_fused_plain(x, w[1], cdt, **kw)
                    name = (fn.__name__ + ("_wide" if wide else "")
                            + "_gs32" + ("_prefill" if T > 128 else ""))
                    e = compare(
                        f"{name} {n} ({I}x{O}) T={T} {qt.name} gs {gs} "
                        f"{str(sdt)[6:]} scales {str(xdt)[6:]} x "
                        f"{str(cdt)[6:]} compute", got, want,
                        TOL_F32 if xdt == f32 else TOL_BF16, quiet=True)
                    errs[name] = max(errs.get(name, 0.0), e)
                    n_calls += 1
                del w
            torch.cuda.empty_cache()
    log(f"  ok 2o: {n_calls} calls within tolerance, each one launch on "
        f"its G32 kernel; largest abs error "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(errs.items())
                    if "gs32" in k))


def rand_int16_edges(gen, shape, dev, scale_dtype):
    """An INT16 weight of :func:`rand_qarray` with the planes' edge values
    in every layer: rows 0-6 all 5792, -5792, -1 (hi -1, lo 255), 255,
    -256, 256 and 0, and the group of rows 64-127 all at 5792 (QF)."""
    from fastllama_tpu_torch.config import QuantType
    w = rand_qarray(gen, shape, QuantType.INT16, dev, scale_dtype)
    for r, v in enumerate((5792, -5792, -1, 255, -256, 256, 0)):
        w.data[..., r, :] = v
    w.data[..., 64:128, :] = 5792
    return w


def check_int16(dev, gen, errs):
    """Phase 2p: K1 on INT16 weights, the wide ring's INT16 instantiation
    (T <= 128) and the wide prefill kernel's (above), against
    ``qmm_fused_plain`` at wqkv's and w2's 7B shapes (group size 64, the
    edge values of :func:`rand_int16_edges`), T in {1, 16, 48, 64, 128,
    129, 512, 2048}, bf16 x at bf16 compute (the engines') and f32 x at f32
    compute, f32 and bf16 scales: K1 (``qmatmul_pallas``), K1 indexed
    (layer 1 of a stacked weight) and K1f with the norm gain and with the
    residual, each wrapper call one launch on its ``launches_wide_pipe``
    or ``launches_wide_prefill`` and its ``launches`` (so none on
    ``qmm_f32_kernel``); at the auto split (split-K at decode) and forced
    (``_launch``, uncounted) to one split and to three.  Limits: f32
    output ``TOL_F32``, bf16 ``TOL_BF16`` (x max|plain|)."""
    import torch
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2p: K1 at INT16 on the wide ring and the wide prefill kernel "
        "vs plain (wqkv, w2; T in {1, 16, 48, 64, 128, 129, 512, 2048}; "
        "bf16 and f32 x and scales; the glue; split-K; edge values)")
    bf16, f32 = torch.bfloat16, torch.float32
    forms = (("K1", qmm.qmatmul_pallas, {}),
             ("K1 indexed", qmm.qmatmul_pallas_indexed, {}),
             ("K1f norm", qmm.qmatmul_pallas_indexed_fused, {"norm": True}),
             ("K1f residual", qmm.qmatmul_pallas_indexed_fused,
              {"res": True}))
    worst, n = {}, 0
    for name in ("wqkv", "w2"):
        I, O = PROJ_7B[name]
        g = torch.rand((I,), generator=gen, device=dev) + 0.5
        for sdt in (f32, bf16):
            w = rand_int16_edges(gen, (2, I, O), dev, sdt)
            for T in (1, 16, 48, 64, 128, 129, 512, 2048):
                mode = "wide_pipe" if T <= 128 else "wide_prefill"
                for xdt, tol in ((bf16, TOL_BF16), (f32, TOL_F32)):
                    x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                    r = torch.randn((T, O), generator=gen, device=dev).to(xdt)
                    check(qmm._kernel(x, w[1], xdt, False, r) == mode,
                          f"2p {name} T={T}: not a {mode} call")
                    for label, fn, how in forms:
                        kw = dict(norm_gain=g if how.get("norm") else None,
                                  residual=r if how.get("res") else None)
                        attr = "launches_" + mode
                        n0, a0 = getattr(fn, attr), fn.launches
                        got = (fn(x, w[1], xdt) if label == "K1" else
                               fn(x, w, 1, xdt, **{k: v for k, v in
                                                   kw.items() if v is not
                                                   None}))
                        check(getattr(fn, attr) == n0 + 1
                              and fn.launches == a0 + 1,
                              f"2p {name} T={T} {label}: not one launch on "
                              f"{attr}")
                        want = qmm.qmm_fused_plain(x, w[1], xdt, **kw)
                        tag = (f"int16 {name} s={str(sdt)[6:]} T={T} "
                               f"x={str(xdt)[6:]} {label}")
                        e = compare(tag, got, want, tol, quiet=True)
                        if label in ("K1", "K1f residual"):
                            for splits in (1, 3):
                                compare(f"{tag} splits={splits}",
                                        qmm._launch(x, w[1], xdt,
                                                    kw["norm_gain"],
                                                    kw["residual"],
                                                    splits=splits),
                                        want, tol, quiet=True)
                                n += 1
                        key = ("qmatmul_pallas_indexed_"
                               + ("fused_" if label.startswith("K1f")
                                  else "") + "int16"
                               + ("_prefill" if T > 128 else ""))
                        errs[key] = max(errs.get(key, 0.0), e)
                        worst[xdt] = max(worst.get(xdt, 0.0), e / max(
                            float(want.float().abs().max()), 1e-30))
                        n += 1
            del w
            torch.cuda.empty_cache()
    log(f"  ok int16: {n} comparisons, largest error {worst[f32]:.3e} of "
        f"max|plain| at f32 x, {worst[bf16]:.3e} at bf16 x")


def check_fused(dev, gen, errs):
    """K1f at the single-stream 7B decode shapes (T=1), layer 1 of a
    stacked (2, I, O) weight: bf16 compute with bf16 scales (the measured
    path) and f32 compute with f32 scales (phase 3's path); then a
    mid-sequence block (T=64) with both the norm and the residual."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2d: K1f fused-glue matmul vs plain (7B decode shapes)")
    cases = [("wqkv", 1, True, False), ("wo", 1, False, True),
             ("w13", 1, True, False), ("w2", 1, False, True),
             ("wqkv", 64, True, True)]
    for name, T, norm, res in cases:
        I, O = PROJ_7B[name]
        for cdt, tol in ((torch.bfloat16, TOL_BF16),
                         (torch.float32, TOL_F32)):
            w = rand_qarray(gen, (2, I, O), QuantType.INT8, dev,
                            torch.bfloat16 if cdt == torch.bfloat16
                            else None)
            x = torch.randn((T, I), generator=gen, device=dev).to(cdt)
            g = torch.rand((I,), generator=gen, device=dev) + 0.5
            r = torch.randn((T, O), generator=gen, device=dev).to(cdt)
            kw = dict(norm_gain=g if norm else None, eps=1e-5,
                      residual=r if res else None)
            got = qmm.qmatmul_pallas_indexed(x, w, 1, cdt, **kw)
            want = qmm.qmm_fused_plain(x, w[1], cdt, **kw)
            glue = "+".join(k for k, on in (("norm", norm), ("residual", res))
                            if on)
            e = compare(f"qmm_fused {name}[1] {glue} T={T} "
                        f"{str(cdt)[6:]}", got, want, tol)
            errs["qmatmul_pallas_indexed_fused"] = max(
                errs["qmatmul_pallas_indexed_fused"], e)
            del w
    torch.cuda.empty_cache()


def check_non_fresh(dev, gen, errs):
    """K2 without fresh rows (rows [0, pos] of a cache that already holds
    the current row) through each of its wrappers, 7B heads, B=1, S=512,
    f32 and bf16 caches, at pos 0, 1, 107 and S-1; and the batched form
    over per-slot positions, through ``flash_decode_batched`` and
    ``decode_attention_pallas_batched``."""
    import torch
    from fastllama_tpu_torch.ops.kernels import attention as at
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    log("phase 2e: K2 non-fresh flash decode vs plain (B=1)")
    S, L, H, n_kv, hs = 512, 2, 32, 32, 128
    for cdt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        ck = torch.randn((L, n_kv, S, hs), generator=gen, device=dev).to(cdt)
        cv = torch.randn((L, n_kv, S, hs), generator=gen, device=dev).to(cdt)
        q = torch.randn((H, 1, hs), generator=gen, device=dev).to(cdt)
        for p in (0, 1, 107, S - 1):
            pos = torch.full((1,), p, dtype=torch.int32, device=dev)
            for name, fn, args, plain, pargs in (
                    ("flash_decode_single", fd.flash_decode_single,
                     (q, ck, cv, pos, 1), fd.flash_decode_single_plain,
                     (q, ck, cv, pos, 1)),
                    ("decode_attention_pallas_indexed",
                     at.decode_attention_pallas_indexed, (q, ck, cv, pos, 1),
                     fd.flash_decode_single_plain, (q, ck, cv, pos, 1)),
                    ("decode_attention_pallas", at.decode_attention_pallas,
                     (q, ck[1], cv[1], p), at.decode_attention_plain,
                     (q, ck[1], cv[1], p))):
                e = compare(f"{name} cache={str(cdt)[6:]} pos={p}",
                            fn(*args), plain(*pargs), tol)
                for k in (name, name + "_split"):
                    errs[k] = max(errs[k], e)
        B = 4
        ckb = ck[:, None].expand(L, B, n_kv, S, hs).contiguous()
        cvb = cv[:, None].expand(L, B, n_kv, S, hs).contiguous()
        qb = torch.randn((B, H, 1, hs), generator=gen, device=dev).to(cdt)
        pos = torch.tensor([0, 1, 107, S - 1], dtype=torch.int32, device=dev)
        e = compare(f"flash_decode_batched non-fresh B={B} "
                    f"cache={str(cdt)[6:]}",
                    fd.flash_decode_batched(qb, ckb, cvb, pos, 1),
                    fd.flash_decode_plain(qb, ckb, cvb, pos, 1), tol)
        for k in ("flash_decode_single", "flash_decode_batched_split"):
            errs[k] = max(errs[k], e)
        e = compare(f"decode_attention_pallas_batched B={B} "
                    f"cache={str(cdt)[6:]}",
                    at.decode_attention_pallas_batched(qb, ckb, cvb, pos, 1),
                    at.decode_attention_batched_plain(qb, ckb, cvb, pos, 1),
                    tol)
        for k in ("decode_attention_pallas_batched",
                  "decode_attention_pallas_batched_split"):
            errs[k] = max(errs[k], e)
        del ck, cv, ckb, cvb
    torch.cuda.empty_cache()


def check_split(dev, gen, errs):
    """K2's split-row mode (non-fresh, no stats, hs a multiple of 16) at
    7B heads (H=32, n_kv = 32 / hgs): bf16 q over a bf16 or int8 cache,
    f32 q over an f32 or int8 cache (int8 with ``quantize_rows`` scales),
    hgs 1, 2, 4 and 8, hs 64 and 128; B=1 at pos 0, 1, 107 and S-1 over
    slot 0 of a 32-slot cache (S=512) and at 0 and 2047 over a one-slot
    cache (S=2048); B=4 and B=32 at per-slot positions.  Every call must
    advance the wrapper's ``launches_split``."""
    import torch
    from fastllama_tpu_torch.ops.kernels import attention as at
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.quant.groupquant import quantize_rows
    log("phase 2e: K2 split-row mode vs plain (7B heads, hgs 1-8, hs 64 "
        "and 128, B 1/4/32, S 512 and 2048)")
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    H, L = 32, 2
    n = 0

    def cache(shape, cdt):
        ck, cv = (torch.randn(shape, generator=gen, device=dev)
                  for _ in range(2))
        if cdt != i8:
            return ck.to(cdt), cv.to(cdt), None, None
        (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
        return ck, cv, ks[..., 0].contiguous(), vs[..., 0].contiguous()

    def run(label, key, fn, args, plain, tol):
        nonlocal n
        s0 = fn.launches_split
        e = compare(label, fn(*args), plain(*args), tol, quiet=True)
        check(fn.launches_split == s0 + 1,
              f"{label}: launches_split did not advance")
        errs[key] = max(errs[key], e)
        n += 1
    for qdt, cdt in ((bf16, bf16), (f32, f32), (bf16, i8), (f32, i8)):
        tol = TOL_F32 if qdt == f32 else TOL_BF16
        for hs in (64, 128):
            for hgs in (1, 2, 4, 8):
                n_kv = H // hgs
                tag = (f"q={str(qdt)[6:]} cache={str(cdt)[6:]} hs={hs} "
                       f"hgs={hgs}")
                S = 512
                ck, cv, ks, vs = cache((L, 32, n_kv, S, hs), cdt)
                q = torch.randn((32, H, 1, hs), generator=gen,
                                device=dev).to(qdt)
                for B, pos in ((1, [0]), (1, [1]), (1, [107]), (1, [S - 1]),
                               (4, [S - 1, 0, 107, 1]),
                               (32, torch.randint(0, S, (32,), generator=gen,
                                                  device=dev).tolist())):
                    p = torch.tensor(pos, dtype=torch.int32, device=dev)
                    args = (q[:B].contiguous(), ck, cv, p, 1, ks, vs)
                    run(f"flash_decode_batched split {tag} B={B} "
                        f"pos={pos[:4]}", "flash_decode_batched_split",
                        fd.flash_decode_batched, args, fd.flash_decode_plain,
                        tol)
                    if B == 4:
                        # 8 splits of at least 16 rows: several merge
                        e = compare(f"split mode 8 splits {tag} B={B}",
                                    fd._split_launch(*args, 8, 16),
                                    fd.flash_decode_plain(*args), tol,
                                    quiet=True)
                        errs["flash_decode_batched_split"] = max(
                            errs["flash_decode_batched_split"], e)
                        n += 1
                    if B == 32 and ks is None:
                        run(f"decode_attention_pallas_batched split {tag}",
                            "decode_attention_pallas_batched_split",
                            at.decode_attention_pallas_batched, args[:5],
                            at.decode_attention_batched_plain, tol)
                del ck, cv, ks, vs
                S = 2048
                ck, cv, ks, vs = cache((L, 1, n_kv, S, hs), cdt)
                for p in (0, S - 1):
                    pos = torch.full((1,), p, dtype=torch.int32, device=dev)
                    if ks is None:
                        run(f"flash_decode_single split {tag} S={S} pos={p}",
                            "flash_decode_single_split",
                            fd.flash_decode_single,
                            (q[0], ck[:, 0], cv[:, 0], pos, 1),
                            fd.flash_decode_single_plain, tol)
                    else:
                        run(f"flash_decode_batched split {tag} S={S} "
                            f"pos={p}", "flash_decode_batched_split",
                            fd.flash_decode_batched,
                            (q[:1].contiguous(), ck, cv, pos, 1, ks, vs),
                            fd.flash_decode_plain, tol)
                del ck, cv, ks, vs
    torch.cuda.empty_cache()
    log(f"  ok {n} split-mode comparisons; largest errors "
        + ", ".join(f"{k} {errs[k]:.3e}" for k in
                    ("flash_decode_batched_split",
                     "decode_attention_pallas_batched_split",
                     "flash_decode_single_split")))


def check_spec(dev, gen, errs):
    """K2s at the 7B verify shapes: B=32, 32 heads of 128, S=512, T in
    {2, 4, 8}; an int8 cache with the exact diagonal (k_self/v_self), and
    bf16 and f32 caches without; positions 0, across a 64-row tile and
    S - T; f32 and bf16 q.  Each call through the wrapper (the split-row
    mode, one ``launches_split``), then the tiled kernel and the split
    mode at 2, 3, 8 and 16 splits of at least 16 rows on the same inputs;
    then B=1 and B=4 at S=2048, pos up to S - T, at the default split
    count; then the single-stream verify on a ``model=2`` rank: B=1, 16
    heads, S=512."""
    import torch
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.quant.groupquant import (dequantize_rows,
                                                      quantize_rows)
    log("phase 2f: K2s speculative-verify attention vs plain (7B, B=32 at "
        "S=512, B=1 and 4 at S=2048, B=1 at a model=2 rank's 16 heads), "
        "split-row mode and tiled kernel")
    hs, L = 128, 2
    n = 0

    def note(e, split=True):
        # the wrapper's entry holds every mode, its _split entry that mode
        for key in ("flash_spec_batched",) + (
                ("flash_spec_batched_split",) if split else ()):
            errs[key] = max(errs[key], e)

    def run(label, args, tol):
        nonlocal n
        want = fd.flash_spec_plain(*args)
        s0 = fd.flash_spec_batched.launches_split
        check(fd.spec_mode(args[0], args[1]) == "split",
              f"{label}: not the split-row mode")
        note(compare(f"flash_spec {label}", fd.flash_spec_batched(*args),
                     want, tol))
        check(fd.flash_spec_batched.launches_split == s0 + 1,
              f"{label}: launches_split did not advance")
        note(compare(f"flash_spec {label} tiled", fd._spec_launch(*args),
                     want, tol, quiet=True), split=False)
        n += 2
        if args[0].shape[0] == 32:
            for ns in (2, 3, 8, 16):
                note(compare(f"flash_spec {label} {ns} splits",
                             fd._spec_split_launch(*args, ns, 16), want, tol,
                             quiet=True))
                n += 1

    for B, S, H in ((32, 512, 32), (1, 2048, 32), (4, 2048, 32),
                    (1, 512, 16)):
        n_kv = H
        shape = (L, B, n_kv, S, hs)
        for cache_dt in (torch.int8, torch.bfloat16, torch.float32):
            if cache_dt == torch.int8:
                ck = torch.empty(shape, dtype=torch.int8, device=dev)
                cv = torch.empty(shape, dtype=torch.int8, device=dev)
                ck.random_(-127, 128, generator=gen)
                cv.random_(-127, 128, generator=gen)
                ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
                vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
            else:
                ck = torch.randn(shape, generator=gen, device=dev).to(cache_dt)
                cv = torch.randn(shape, generator=gen, device=dev).to(cache_dt)
                ks = vs = None
            for T in (2, 4, 8):
                pos = torch.randint(0, S - T + 1, (B,), generator=gen,
                                    device=dev, dtype=torch.int32)
                edge = [0, 1, 63, 64, 130, S - T] if B == 32 else \
                    [S - T, 0, 1107, 2040 - T]
                pos[:len(edge)] = torch.tensor(edge[:B], dtype=torch.int32,
                                               device=dev)
                for qdt, tol in ((torch.bfloat16, TOL_BF16),
                                 (torch.float32, TOL_F32)):
                    q = torch.randn((B, H, T, hs), generator=gen,
                                    device=dev).to(qdt)
                    ke = torch.randn((B, n_kv, T, hs), generator=gen,
                                     device=dev).to(qdt)
                    ve = torch.randn((B, n_kv, T, hs), generator=gen,
                                     device=dev).to(qdt)
                    if cache_dt == torch.int8:
                        # the verify's fresh rows: the exact rows
                        # round-tripped through the cache quantizer
                        kn = dequantize_rows(*quantize_rows(ke), qdt)
                        vn = dequantize_rows(*quantize_rows(ve), qdt)
                        kw = (ke, ve)
                    else:
                        kn, vn, kw = ke, ve, (None, None)
                    run(f"B={B} S={S} H={H} cache={str(cache_dt)[6:]} "
                        f"T={T} q={str(qdt)[6:]}"
                        + (" exact_diag" if kw[0] is not None else ""),
                        (q, ck, cv, pos, 1, ks, vs, kn, vn) + kw, tol)
            del ck, cv
    torch.cuda.empty_cache()
    log(f"  ok {n} K2s comparisons; largest errors split "
        f"{errs['flash_spec_batched_split']:.3e}, tiled "
        f"{errs['flash_spec_batched']:.3e}")


def check_spec_write(dev, gen, errs):
    """spec_write (K3 with slots = arange(B), starts = pos, T = D) against
    its plain version, bit-equal: on the 7B cache of 32 layers at B=32,
    int8 with scales and bf16; on an f32 cache at a ``model=2`` rank's 16
    heads, 4 layers deep (the single-stream engine's default on a mesh),
    at B=32 and at its one slot; D in {2, 4, 8}; positions across a
    32-row boundary and at S - D."""
    import torch
    from fastllama_tpu_torch.models.batched import BatchedKVCache
    from fastllama_tpu_torch.ops.kernels import kv_write as kw
    log("phase 2g: spec_write vs plain (bit-equal, 7B cache, B=32; f32 "
        "at a model=2 rank's heads, B=32 and 1)")
    rank = cfg_7b(4).replace(dim=2048, n_heads=16, n_kv_heads=16)
    for kv_dt, cfg, B in ((torch.int8, cfg_7b(), 32),
                          (torch.bfloat16, cfg_7b(), 32),
                          (torch.float32, rank, 32),
                          (torch.float32, rank, 1)):
        L, n_kv, hs, S = (cfg.n_layers, cfg.n_kv_heads, cfg.head_size,
                          cfg.max_seq_len)
        tag = f"{str(kv_dt)[6:]} B={B} kv={n_kv}"
        a = BatchedKVCache.create(cfg, B, dtype=kv_dt, device=dev)
        b = BatchedKVCache.create(cfg, B, dtype=kv_dt, device=dev)
        for D in (2, 4, 8):
            if kv_dt == torch.int8:
                kq = torch.empty((L, B, n_kv, D, hs), dtype=torch.int8,
                                 device=dev).random_(-127, 128, generator=gen)
                vq = torch.empty_like(kq).random_(-127, 128, generator=gen)
                ks = torch.rand((L, B, n_kv, D), generator=gen, device=dev)
                vs = torch.rand((L, B, n_kv, D), generator=gen, device=dev)
            else:
                kq = torch.randn((L, B, n_kv, D, hs), generator=gen,
                                 device=dev).to(kv_dt)
                vq = torch.randn((L, B, n_kv, D, hs), generator=gen,
                                 device=dev).to(kv_dt)
                ks = vs = None
            pos = torch.randint(0, S - D + 1, (B,), generator=gen,
                                device=dev, dtype=torch.int32)
            if B > 1:
                pos[:4] = torch.tensor([0, 31, 32 - D // 2, S - D],
                                       dtype=torch.int32, device=dev)
            kw.spec_write(a, kq, vq, ks, vs, pos)
            kw.spec_write_plain(b, kq, vq, ks, vs, pos)
            torch.cuda.synchronize()
            for x, y in zip((a.k, a.v, a.k_scale, a.v_scale),
                            (b.k, b.v, b.k_scale, b.v_scale)):
                check(x is None or torch.equal(x, y),
                      f"spec_write {tag} D={D}: caches differ")
            log(f"  ok spec_write cache={tag} D={D} bit-equal")
        del a, b
    torch.cuda.empty_cache()


def check_p4(dev, gen, errs):
    """K1p against ``qmm_p4_plain`` at the 7B INT4 shapes (hidden 11264):
    every projection and the classifier at T in {1, 48, 128, 2048}, bf16
    and f32 x, f32 and bf16 scales; the indexed form at layers 0 and 31 of
    a stacked (32, I/2, O) weight with and without the norm and residual
    operands; then an int8-held INT4 weight (w2 at 11008, which does not
    pack) through K1.  Tolerances as phase 2, except TOL_P4_NORM where an
    f32 x is normalized in the prologue: the normalized row is rounded to
    bf16 for the tensor cores (no wide path), so a one-ulp difference in
    its f32 inverse RMS flips some of those roundings (at most 1.3e-4 of
    max|plain| seen on an H100)."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2h: K1p packed INT4 matmul vs plain (7B INT4 shapes)")
    combos = ((torch.bfloat16, None), (torch.float32, None),
              (torch.bfloat16, torch.bfloat16), (torch.float32,
                                                 torch.bfloat16))
    for name, (I, O) in PROJ_7B_INT4.items():
        ws = {sdt: rand_packed(gen, (I, O), dev, sdt) for sdt in
              (None, torch.bfloat16)}
        for T in (1, 48, 128, 2048):
            for xdt, sdt in combos:
                x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                tol = TOL_F32 if xdt == torch.float32 else TOL_BF16
                e = compare(f"qmm_p4 {name} T={T} x={str(xdt)[6:]} "
                            f"s={str(sdt or torch.float32)[6:]}",
                            qmm.qmatmul_pallas(x, ws[sdt]),
                            qmm.qmm_p4_plain(x, ws[sdt]), tol)
                errs["qmatmul_pallas_p4"] = max(errs["qmatmul_pallas_p4"], e)
        del ws
    for name in ("wqkv", "w2"):
        I, O = PROJ_7B_INT4[name]
        w = rand_packed(gen, (32, I, O), dev)
        g = torch.rand((I,), generator=gen, device=dev) + 0.5
        for layer in (0, 31):
            for T in (1, 48):
                for xdt in (torch.bfloat16, torch.float32):
                    x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                    r = torch.randn((T, O), generator=gen, device=dev).to(xdt)
                    for norm, res in ((False, False), (True, False),
                                      (False, True), (True, True)):
                        kw = dict(norm_gain=g if norm else None,
                                  residual=r if res else None)
                        tol = (TOL_BF16 if xdt == torch.bfloat16 else
                               TOL_P4_NORM if norm else TOL_F32)
                        glue = "+".join(k for k, on in (("norm", norm),
                                                        ("residual", res))
                                        if on) or "bare"
                        e = compare(f"qmm_p4_indexed {name}[{layer}] {glue} "
                                    f"T={T} x={str(xdt)[6:]}",
                                    qmm.qmatmul_pallas_indexed(x, w, layer,
                                                               **kw),
                                    qmm.qmm_p4_plain(x, w[layer], **kw), tol)
                        k = ("qmatmul_pallas_indexed_fused_p4" if norm or res
                             else "qmatmul_pallas_indexed_p4")
                        errs[k] = max(errs[k], e)
        del w
    # an INT4 weight that does not pack stays int8-held and takes K1
    w = rand_qarray(gen, (11008, 4096), QuantType.INT4, dev)
    check(not w.packed, "w2 at 11008 packed")
    for T in (1, 48):
        for cdt, tol in ((torch.bfloat16, TOL_BF16), (torch.float32,
                                                      TOL_F32)):
            x = torch.randn((T, 11008), generator=gen, device=dev).to(cdt)
            n0 = qmm.qmatmul_pallas.launches
            e = compare(f"qmm int8-held INT4 w2 11008x4096 T={T} "
                        f"{str(cdt)[6:]}", qmm.qmatmul_pallas(x, w, cdt),
                        qmm.qmm_plain(x, w, cdt), tol)
            check(qmm.qmatmul_pallas.launches == n0 + 1,
                  "the int8-held INT4 weight did not go through K1")
            errs["qmatmul_pallas"] = max(errs["qmatmul_pallas"], e)
    del w
    torch.cuda.empty_cache()


def rand_cache(gen, shape, cache_dt, dev):
    """K and V caches of ``shape`` (L, B, n_kv, S, hs) in ``cache_dt`` with
    random rows, and random f32 row scales for an int8 cache."""
    import torch
    if cache_dt == torch.int8:
        ck = torch.empty(shape, dtype=torch.int8, device=dev).random_(
            -127, 128, generator=gen)
        cv = torch.empty(shape, dtype=torch.int8, device=dev).random_(
            -127, 128, generator=gen)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
        return ck, cv, ks, vs
    return (torch.randn(shape, generator=gen, device=dev).to(cache_dt),
            torch.randn(shape, generator=gen, device=dev).to(cache_dt),
            None, None)


def block_expect(qdt, cache_dt, hs, hgs):
    """The mode of an aligned K2b call (``block_mode``'s rule restated):
    TC for bf16 q over an int8 or bf16 cache at hs % 16 == 0 (past hs
    128 for hgs <= 32), TF32 for the other calls at hs % 8 == 0 (past hs
    128 for hgs <= 16), f32 otherwise."""
    import torch
    if hs > 256:
        return "f32"
    if (qdt == torch.bfloat16 and cache_dt != torch.float32
            and hs % 16 == 0 and (hs <= 128 or hgs <= 32)):
        return "tc"
    return "tf32" if hs % 8 == 0 and (hs <= 128 or hgs <= 16) else "f32"


def check_block(dev, gen, errs):
    """K2b against ``flash_block_plain`` at the 7B prefix-cache shapes:
    32 heads of 128 over a B=48, S=512 cache (int8, bf16, f32), layer 1;
    T in {1, 16, 32, 64, 100, 256, 496} and start in {0, 16, 256} wherever
    start + T <= S, slots 0 and 47, f32 and bf16 q.  Then GQA at hgs = 8
    (LLaMA-2-70B's 64 heads over 8 kv heads, one layer), since 7B has
    hgs = 1.  Then ragged T in {1, 15, 17, 63, 65, 150} at start in
    {0, 1, 100, S - T}, hgs 1 and 8, int8 and bf16 caches.  bf16 q over an
    int8 or bf16 cache runs the TC mode (``launches_tc`` must advance),
    every other case the split-TF32 mode (``launches_tf32`` must
    advance).  Then the TF32 mode across head sizes (:func:`block_cases`)
    and a misaligned view in the CUDA-core f32 mode.  Errors are logged
    by mode; f32 q is held to TOL_F32, bf16 q to TOL_BF16."""
    import torch
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    log("phase 2i: K2b block-attend vs plain (7B heads, B=48, S=512)")
    B, S = 48, 512
    i8, b16, f32 = torch.int8, torch.bfloat16, torch.float32
    ragged = (1, 15, 17, 63, 65, 150)
    cases = [(32, 32, 2, 128, (1, 16, 32, 64, 100, 256, 496), (0, 16, 256),
              (0, 47), (i8, b16, f32)),
             (64, 8, 1, 128, (1, 32, 100, 256), (0, 256), (47,), (i8, b16)),
             (32, 32, 2, 128, ragged, (0, 1, 100, None), (47,), (i8, b16)),
             (64, 8, 1, 128, ragged, (0, 1, 100, None), (0,), (i8, b16))]
    n, by_mode = block_cases(dev, gen, errs, cases, B, S)
    # the TF32 mode across head sizes: 8 kv heads at hgs 1 and 8, every
    # cache dtype, f32 q and (over an f32 cache, or off hs % 16) bf16 q
    cases = [(8 * hgs, 8, 1, hs, ragged[::2] + (150,), (0, 1, 100, None),
              (3,), (i8, b16, f32))
             for hs in (64, 80, 96, 128, 256) for hgs in (1, 8)]
    m, more = block_cases(dev, gen, errs, cases, 4, S, quiet=True)
    n += m
    for k, v in more.items():
        by_mode[k] = max(by_mode.get(k, 0.0), v)
    # a cache view off a 16-byte boundary: the CUDA-core f32 mode
    for qdt, tol in ((f32, TOL_F32), (b16, TOL_BF16)):
        ck, cv, ks, vs = rand_cache(gen, (1, 4, 8, S, 128), f32, dev)
        flat = torch.empty(ck.numel() + 4, dtype=f32, device=dev)
        ck = flat[1:1 + ck.numel()].view(ck.shape).copy_(ck)
        q = torch.randn((8, 65, 128), generator=gen, device=dev).to(qdt)
        kn, vn = (torch.randn((8, 65, 128), generator=gen, device=dev).to(qdt)
                  for _ in range(2))
        check(fd.block_mode(q, ck, cv, kn, vn) == "f32",
              "K2b: a misaligned view outside the f32 mode")
        n_tf = fd.flash_block_attend.launches_tf32
        got = fd.flash_block_attend(q, ck, cv, 2, 0, 100, ks, vs, kn, vn)
        check(fd.flash_block_attend.launches_tf32 == n_tf,
              "K2b: a misaligned view launched the TF32 mode")
        compare(f"flash_block misaligned f32 cache q={str(qdt)[6:]} "
                f"mode=f32", got, fd.flash_block_plain(
                    q, ck, cv, 2, 0, 100, ks, vs, kn, vn), tol)
        n += 1
        del ck, cv, flat
    log(f"  {n} K2b comparisons passed; largest error / max|ref| by mode "
        f"{by_mode}")
    torch.cuda.empty_cache()


def block_cases(dev, gen, errs, cases, B, S, quiet=False):
    """K2b calls of ``cases`` (H, n_kv, L, hs, Ts, starts, slots, cache
    dtypes; a start of None is S - T) at f32 and bf16 q against
    ``flash_block_plain``, each in the mode :func:`block_expect` names,
    advancing ``launches_tc`` or ``launches_tf32`` exactly then.  Returns
    the count and the largest error / max|ref| by mode and q dtype."""
    import torch
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    b16, f32 = torch.bfloat16, torch.float32
    fn = fd.flash_block_attend
    n, by_mode = 0, {}
    for H, n_kv, L, hs, Ts, starts, slots, cache_dts in cases:
        for cache_dt in cache_dts:
            ck, cv, ks, vs = rand_cache(gen, (L, B, n_kv, S, hs), cache_dt,
                                        dev)
            worst = {}
            for T in Ts:
                for start in starts:
                    start = S - T if start is None else start
                    if start + T > S:
                        continue
                    for slot in slots:
                        for qdt, tol in ((b16, TOL_BF16), (f32, TOL_F32)):
                            q = torch.randn((H, T, hs), generator=gen,
                                            device=dev).to(qdt)
                            kn = torch.randn((n_kv, T, hs), generator=gen,
                                             device=dev).to(qdt)
                            vn = torch.randn((n_kv, T, hs), generator=gen,
                                             device=dev).to(qdt)
                            mode = fd.block_mode(q, ck, cv, kn, vn)
                            want_mode = block_expect(qdt, cache_dt, hs,
                                                     H // n_kv)
                            check(mode == want_mode,
                                  f"K2b mode {mode} for q {qdt} cache "
                                  f"{cache_dt} hs {hs}, not {want_mode}")
                            n_tc, n_tf = fn.launches_tc, fn.launches_tf32
                            got = fn(q, ck, cv, slot, L - 1, start, ks, vs,
                                     kn, vn)
                            check(fn.launches_tc - n_tc == (mode == "tc")
                                  and fn.launches_tf32 - n_tf
                                  == (mode == "tf32"),
                                  f"K2b launches_tc / launches_tf32 wrong "
                                  f"in the {mode} mode")
                            want = fd.flash_block_plain(q, ck, cv, slot,
                                                        L - 1, start, ks, vs,
                                                        kn, vn)
                            e = compare(f"flash_block H={H} n_kv={n_kv} "
                                        f"hs={hs} cache={str(cache_dt)[6:]} "
                                        f"T={T} start={start} slot={slot} "
                                        f"q={str(qdt)[6:]} mode={mode}",
                                        got, want, tol, quiet=True)
                            rel = e / max(float(want.float().abs().max()),
                                          1e-30)
                            k = f"{mode} q={str(qdt)[6:]}"
                            worst[k] = max(worst.get(k, 0.0), e)
                            by_mode[k] = max(by_mode.get(k, 0.0), rel)
                            errs["flash_block_attend"] = max(
                                errs["flash_block_attend"], e)
                            if mode == "tf32":
                                errs["flash_block_attend_tf32"] = max(
                                    errs["flash_block_attend_tf32"], e)
                            n += 1
            if not quiet:
                log(f"  ok flash_block H={H} n_kv={n_kv} hs={hs} "
                    f"cache={str(cache_dt)[6:]}: T {Ts} x start {starts} x "
                    f"slots {slots}; max_abs_err by mode {worst}")
            del ck, cv, ks, vs
    if quiet:
        log(f"  ok {n} K2b calls across head sizes; largest error / "
            f"max|ref| by mode {by_mode}")
    return n, by_mode


def fresh_split_cases(dev, gen, B, S, pos_list, nsplits, errs, label,
                      stats_too=True):
    """K2's fresh and stats split mode at 7B heads against the plain
    version: int8 and bf16 caches, bf16 and f32 q, fresh rows with and
    without stats, at each of ``pos_list`` (label, (B,) positions),
    through the wrapper (one ``launches_split`` or
    ``launches_stats_split`` a call) and at each forced split count of
    ``nsplits`` with a 16-row least chunk (several splits merge); o within
    TOL_F32 / TOL_BF16, m and l within TOL_F32.  Returns the comparisons
    made."""
    import torch
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    L, H, n_kv, hs = 2, 32, 32, 128
    n = 0
    for cache_dt in (torch.int8, torch.bfloat16):
        ck, cv, ks, vs = rand_cache(gen, (L, B, n_kv, S, hs), cache_dt, dev)
        for qdt, tol in ((torch.bfloat16, TOL_BF16),
                         (torch.float32, TOL_F32)):
            q = torch.randn((B, H, 1, hs), generator=gen,
                            device=dev).to(qdt)
            kn = torch.randn((B, n_kv, hs), generator=gen,
                             device=dev).to(qdt)
            vn = torch.randn((B, n_kv, hs), generator=gen,
                             device=dev).to(qdt)
            for plabel, pos in pos_list:
                for stats in ((False, True) if stats_too else (False,)):
                    args = (q, ck, cv, pos, 1, ks, vs, kn, vn)
                    want = fd.flash_decode_plain(*args, stats=stats)
                    want = want if stats else (want,)
                    attr = "launches_stats_split" if stats \
                        else "launches_split"
                    c0 = getattr(fd.flash_decode_batched, attr)
                    runs = [(None, fd.flash_decode_batched(*args,
                                                           stats=stats))]
                    check(getattr(fd.flash_decode_batched, attr) == c0 + 1,
                          f"{label}: a call outside the split mode")
                    runs += [(ns, fd._split_launch(*args[:7], ns, 16,
                                                   k_new=kn, v_new=vn,
                                                   stats=stats))
                             for ns in nsplits]
                    for ns, got in runs:
                        got = got if stats else (got,)
                        for name, g, w, t in zip("oml", got, want,
                                                 (tol, TOL_F32, TOL_F32)):
                            e = compare(
                                f"{label} {name} cache={str(cache_dt)[6:]} "
                                f"q={str(qdt)[6:]} {plabel} stats={stats} "
                                f"nsplit={ns or 'auto'}", g, w, t,
                                quiet=True)
                            key = ("flash_decode_batched_stats_split"
                                   if stats else "flash_decode_batched_split")
                            errs[key] = max(errs[key], e)
                            n += 1
        del ck, cv, ks, vs
    torch.cuda.empty_cache()
    return n


def check_fresh_split(dev, gen, errs):
    """Phase 2b, K2's fresh and stats split mode (7B heads): at B=48, S=512
    (phase 4's shape) every slot at pos 0, 107 and 511 and mixed
    positions, also at 2 and 4 forced splits; at B=12, S=2048 (the long
    context reading) pos 2047 and mixed positions at 2, 4, 8 and 16
    forced splits; at B=1, S=2048 pos 2040."""
    import torch
    log("phase 2b: K2's fresh and stats split mode vs plain")

    def full(B, p):
        return torch.full((B,), p, dtype=torch.int32, device=dev)

    def mixed(B, S):
        pos = torch.randint(0, S, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[:4] = torch.tensor([0, 1, 107, S - 1], dtype=torch.int32,
                               device=dev)
        return pos
    n = fresh_split_cases(
        dev, gen, 48, 512, [(f"pos {p}", full(48, p)) for p in (0, 107, 511)]
        + [("mixed pos", mixed(48, 512))], (2, 4), errs, "fresh split B=48")
    n += fresh_split_cases(
        dev, gen, 12, 2048, [("pos 2047", full(12, 2047)),
                             ("mixed pos", mixed(12, 2048))],
        (2, 4, 8, 16), errs, "fresh split B=12 S=2048")
    n += fresh_split_cases(
        dev, gen, 1, 2048, [("pos 2040", full(1, 2040))], (2, 4, 8, 16),
        errs, "fresh split B=1 S=2048")
    log(f"  ok {n} comparisons of the fresh and stats split mode; largest "
        f"max_abs_err fresh "
        f"{errs['flash_decode_batched_split']:.3e}, stats "
        f"{errs['flash_decode_batched_stats_split']:.3e}")


def check_stats(dev, gen, errs):
    """K2 with its softmax stats (the deferred-KV path) against the plain
    version at the 7B decode shape, B=48, S=512, int8 and bf16 caches, f32
    and bf16 q: o, m and l with every slot at pos 0, 107 and 511, and with
    mixed positions, every call in the split mode (one
    ``launches_stats_split``).  m and l are f32 in both dtypes, so TOL_F32
    holds them."""
    import torch
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    log("phase 2j: K2 with softmax stats vs plain (7B, B=48, S=512)")
    B, L, H, n_kv, hs, S = 48, 2, 32, 32, 128, 512
    mixed = torch.randint(0, S, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    mixed[:4] = torch.tensor([0, 1, 64, S - 1], dtype=torch.int32,
                             device=dev)
    for cache_dt in (torch.int8, torch.bfloat16):
        ck, cv, ks, vs = rand_cache(gen, (L, B, n_kv, S, hs), cache_dt, dev)
        for label, pos in (
                ("pos 0", torch.zeros(B, dtype=torch.int32, device=dev)),
                ("pos 107", torch.full((B,), 107, dtype=torch.int32,
                                       device=dev)),
                ("pos 511", torch.full((B,), S - 1, dtype=torch.int32,
                                       device=dev)),
                ("mixed pos", mixed)):
            for qdt, tol in ((torch.bfloat16, TOL_BF16),
                             (torch.float32, TOL_F32)):
                q = torch.randn((B, H, 1, hs), generator=gen,
                                device=dev).to(qdt)
                kn = torch.randn((B, n_kv, hs), generator=gen,
                                 device=dev).to(qdt)
                vn = torch.randn((B, n_kv, hs), generator=gen,
                                 device=dev).to(qdt)
                s0 = fd.flash_decode_batched.launches_stats_split
                got = fd.flash_decode_batched(q, ck, cv, pos, 1, ks, vs, kn,
                                              vn, stats=True)
                check(fd.flash_decode_batched.launches_stats_split == s0 + 1,
                      "flash stats: a stats call outside the split mode")
                want = fd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs, kn,
                                             vn, stats=True)
                for name, g, w, t in zip("oml", got, want,
                                         (tol, TOL_F32, TOL_F32)):
                    e = compare(f"flash stats {name} cache="
                                f"{str(cache_dt)[6:]} {label} "
                                f"q={str(qdt)[6:]}", g, w, t)
                    errs["flash_decode_batched_stats"] = max(
                        errs["flash_decode_batched_stats"], e)
        del ck, cv, ks, vs
    torch.cuda.empty_cache()


def gd_counts():
    from fastllama_tpu_torch.ops.kernels import qmm
    f = qmm.qmatmul_pallas
    return (f.launches, f.launches_p4, f.launches_groupdot,
            f.launches_groupdot_p4, f.launches_groupdot_pipe)


def check_groupdot(dev, gen, errs):
    """Phase 2k: the groupdot mode of K1 and K1p against
    ``qmm_groupdot_plain`` at the four fused-layer shapes and the
    classifier (INT8 with f32 and with bf16 scales; packed INT4, hidden
    11264, f32 scales), T in {1, 48, 128}, bf16 and f32 x, the auto split
    and one split: each call on the pipelined ring (``groupdot_kernel``),
    one ``launches_groupdot_pipe``, and the forced loop on the same inputs
    held to the plain version too; gs = 128 on the ring; then O = 1000
    (rows off 16 bytes) and gs = 16 and 32 on the loop, the ring's count
    unmoved; the wide cases (INT16, INT8 at f32 compute) equal to the
    standard K1 path bit for bit and counted as K1; gs = 8 raises."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2k: groupdot mode of K1 and K1p vs plain (7B shapes), on "
        "the ring and on the loop")
    bf16, f32 = torch.bfloat16, torch.float32
    f = qmm.qmatmul_pallas

    def run(label, w, Ts, splits_list=(None, 1)):
        key = "qmatmul_pallas_groupdot" + ("_p4" if w.packed else "")
        slot = 3 if w.packed else 2
        I = w.scales.shape[0] * w.group_size
        worst, n, rings = 0.0, 0, 0
        for T in Ts:
            for xdt, tol in ((bf16, TOL_BF16), (f32, TOL_F32)):
                x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                want = qmm.qmm_groupdot_plain(x, w)
                ring = qmm.groupdot_kernel(x, w) == "pipe"
                for splits in splits_list:
                    before = list(gd_counts())
                    got = f(x, w, groupdot=True, splits=splits)
                    before[slot] += 1
                    before[4] += ring
                    check(list(gd_counts()) == before,
                          f"groupdot {label}: not one groupdot launch"
                          f"{' on the ring' if ring else ' on the loop'}")
                    e = compare(f"groupdot {label} T={T} x={str(xdt)[6:]} "
                                f"splits={splits}", got, want, tol,
                                quiet=True)
                    worst, n = max(worst, e / max(
                        float(want.float().abs().max()), 1e-30)), n + 1
                    errs[key] = max(errs[key], e)
                    if ring:
                        rings += 1
                        errs["qmatmul_pallas_groupdot_pipe"] = max(
                            errs["qmatmul_pallas_groupdot_pipe"], e)
                        loop = qmm._launch(x, w, bf16, gd=True,
                                           splits=splits, mode="loop")
                        compare(f"groupdot loop {label} T={T} "
                                f"x={str(xdt)[6:]} splits={splits}", loop,
                                want, tol, quiet=True)
        log(f"  ok groupdot {label}: {n} comparisons ({rings} on the ring, "
            f"each against the forced loop too), largest error "
            f"{worst:.3e} of max|plain|")

    for name, (I, O) in PROJ_7B.items():
        for sdt in (None, bf16):
            w = rand_qarray(gen, (I, O), QuantType.INT8, dev, sdt)
            run(f"int8 {name} s={str(sdt or f32)[6:]}", w, (1, 48, 128))
            del w
    for name, (I, O) in PROJ_7B_INT4.items():
        w = rand_packed(gen, (I, O), dev)
        run(f"int4 {name}", w, (1, 48, 128))
        del w
    for gs, O in ((64, 1000), (128, 4096), (32, 4096), (16, 4096)):
        run(f"int8 4096x{O} gs={gs}",
            rand_qarray(gen, (4096, O), QuantType.INT8, dev, gs=gs), (1, 48))
        run(f"int4 4096x{O} gs={gs}",
            rand_packed(gen, (4096, O), dev, gs=gs), (1, 48))
    # the wide cases take the standard path: equal bit for bit, K1 counts
    x = torch.randn((48, 4096), generator=gen, device=dev)
    for label, w, cdt in (
            ("int16", rand_qarray(gen, (4096, 4096), QuantType.INT16, dev),
             bf16),
            ("int8 f32 compute",
             rand_qarray(gen, (4096, 4096), QuantType.INT8, dev), f32)):
        for xdt in (bf16, f32):
            before = list(gd_counts())
            got = f(x.to(xdt), w, cdt, groupdot=True)
            before[0] += 1
            check(list(gd_counts()) == before,
                  f"groupdot {label}: not counted as one K1 launch")
            check(torch.equal(got, f(x.to(xdt), w, cdt)),
                  f"groupdot {label} x={str(xdt)[6:]}: differs from the "
                  f"standard path")
        log(f"  ok groupdot {label}: the standard path bit for bit")
    w8 = rand_qarray(gen, (256, 256), QuantType.INT8, dev, gs=8)
    try:
        f(x[:, :256].to(bf16), w8, groupdot=True)
    except ValueError as e:
        log(f"  ok groupdot gs=8 raises: {e}")
    else:
        raise Failed("groupdot at gs=8 did not raise")
    torch.cuda.empty_cache()


def check_pipe(dev, gen, errs):
    """Phase 2l: the pipelined mode of K1 and K1p against the plain
    versions at the 7B shapes (the four fused-layer projections and the
    classifier): INT8 with f32 and with bf16 scales, packed INT4 (hidden
    11264) with f32 scales and bf16 or f32 x, T in {1, 48, 128}; the plain
    wrapper, then layer 1 of a stacked weight with the norm gain, the
    residual and both.  Every call must be one launch on its wrapper's
    ``launches_pipe``.  Limits as phase 2: bf16 x 1e-2, f32 x 1e-4 of
    max|plain|, 1e-3 (TOL_P4_NORM) for f32 x through the norm prologue."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2l: the pipelined mode of K1 and K1p vs plain (7B shapes, "
        "T in {1, 48, 128}, with and without the glue)")
    bf16, f32 = torch.bfloat16, torch.float32
    glue = (("bare", False, False), ("norm", True, False),
            ("residual", False, True), ("norm+residual", True, True))
    kinds = (("int8 s=f32", PROJ_7B, None, (bf16,)),
             ("int8 s=bf16", PROJ_7B, bf16, (bf16,)),
             ("int4 s=f32", PROJ_7B_INT4, None, (bf16, f32)))
    for label, proj, sdt, xdts in kinds:
        worst, n = 0.0, 0
        for name, (I, O) in proj.items():
            shape = (2, I, O)
            w = (rand_packed(gen, shape, dev, sdt) if label.startswith("int4")
                 else rand_qarray(gen, shape, QuantType.INT8, dev, sdt))
            g = torch.rand((I,), generator=gen, device=dev) + 0.5
            for T in (1, 48, 128):
                for xdt in xdts:
                    x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                    r = torch.randn((T, O), generator=gen, device=dev).to(xdt)
                    for gl, norm, res in glue:
                        kw = dict(norm_gain=g if norm else None,
                                  residual=r if res else None)
                        fn = (qmm.qmatmul_pallas if gl == "bare"
                              else qmm.qmatmul_pallas_indexed_fused)
                        n0 = fn.launches_pipe
                        got = (qmm.qmatmul_pallas(x, w[1]) if gl == "bare"
                               else qmm.qmatmul_pallas_indexed(x, w, 1, bf16,
                                                               **kw))
                        check(fn.launches_pipe == n0 + 1,
                              f"pipe {label} {name} T={T} {gl}: not one "
                              f"pipelined launch")
                        want = qmm.qmm_fused_plain(x, w[1], bf16, **kw)
                        tol = (TOL_BF16 if xdt == bf16 else
                               TOL_P4_NORM if norm else TOL_F32)
                        e = compare(f"pipe {label} {name} T={T} "
                                    f"x={str(xdt)[6:]} {gl}", got, want, tol,
                                    quiet=True)
                        key = ("qmatmul_pallas_pipe" if gl == "bare" else
                               "qmatmul_pallas_indexed_fused_pipe")
                        errs[key] = max(errs[key], e)
                        worst = max(worst, e / max(float(
                            want.float().abs().max()), 1e-30))
                        n += 1
            del w
        log(f"  ok pipe {label}: {n} comparisons, largest error "
            f"{worst:.3e} of max|plain|")
    # the indexed wrapper without glue takes the mode too
    w = rand_qarray(gen, (2, *PROJ_7B["wo"]), QuantType.INT8, dev)
    f = qmm.qmatmul_pallas_indexed
    for T in (1, 48, 128):
        x = torch.randn((T, 4096), generator=gen, device=dev).to(bf16)
        n0 = f.launches_pipe
        e = compare(f"pipe qmatmul_pallas_indexed wo[1] T={T}",
                    f(x, w, 1), qmm.qmm_plain(x, w[1]), TOL_BF16, quiet=True)
        check(f.launches_pipe == n0 + 1, "indexed: not a pipelined launch")
        errs["qmatmul_pallas_indexed_pipe"] = max(
            errs["qmatmul_pallas_indexed_pipe"], e)
    log("  ok pipe qmatmul_pallas_indexed wo[1] T in {1, 48, 128}")
    del w
    torch.cuda.empty_cache()


def check_wide(dev, gen, errs):
    """Phase 2m: K1's wide mode on the ring (``qmm_pipe_wide_kernel``, f32
    compute) against ``qmm_fused_plain`` at the 7B projections (the four
    fused-layer ones and the classifier), INT8 with f32 and with bf16
    scales, T in {1, 5, 48, 128}, f32 and bf16 x: bare through
    ``qmatmul_pallas`` and with the norm gain, the residual and both
    through the fused wrapper on layer 1 of a stacked weight, each at the
    auto split (one ``launches_wide_pipe`` on the calling wrapper, none on
    ``launches_pipe``) and at one split (``_launch``, uncounted).  Limits:
    f32 x 1e-4 (``TOL_F32``), bf16 x 1e-2 of max|plain| (the output's
    rounding)."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2m: K1's wide mode on the ring vs plain (7B shapes, f32 "
        "compute, T in {1, 5, 48, 128}, with and without the glue)")
    bf16, f32 = torch.bfloat16, torch.float32
    glue = (("bare", False, False), ("norm", True, False),
            ("residual", False, True), ("norm+residual", True, True))
    for sdt in (f32, bf16):
        worst, n = {f32: 0.0, bf16: 0.0}, 0
        for name, (I, O) in PROJ_7B.items():
            w = rand_qarray(gen, (2, I, O), QuantType.INT8, dev, sdt)
            g = torch.rand((I,), generator=gen, device=dev) + 0.5
            for T in (1, 5, 48, 128):
                for xdt, tol in ((f32, TOL_F32), (bf16, TOL_BF16)):
                    x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                    r = torch.randn((T, O), generator=gen, device=dev).to(xdt)
                    check(qmm.wide_kernel(x, w[1], f32, r) == "pipe",
                          f"wide {name} T={T}: not a ring call")
                    for gl, norm, res in glue:
                        kw = dict(norm_gain=g if norm else None,
                                  residual=r if res else None)
                        fn = (qmm.qmatmul_pallas if gl == "bare"
                              else qmm.qmatmul_pallas_indexed_fused)
                        n0, p0 = fn.launches_wide_pipe, fn.launches_pipe
                        got = (qmm.qmatmul_pallas(x, w[1], f32)
                               if gl == "bare" else
                               qmm.qmatmul_pallas_indexed(x, w, 1, f32, **kw))
                        check(fn.launches_wide_pipe == n0 + 1
                              and fn.launches_pipe == p0,
                              f"wide {name} T={T} {gl}: not one launch on "
                              f"the wide ring")
                        one = qmm._launch(x, w[1], f32, kw["norm_gain"],
                                          kw["residual"], splits=1)
                        want = qmm.qmm_fused_plain(x, w[1], f32, **kw)
                        label = (f"wide {name} s={str(sdt)[6:]} T={T} "
                                 f"x={str(xdt)[6:]} {gl}")
                        e = compare(label, got, want, tol, quiet=True)
                        compare(label + " splits=1", one, want, tol,
                                quiet=True)
                        key = ("qmatmul_pallas_wide_pipe" if gl == "bare"
                               else "qmatmul_pallas_indexed_fused_wide_pipe")
                        errs[key] = max(errs[key], e)
                        worst[xdt] = max(worst[xdt], e / max(float(
                            want.float().abs().max()), 1e-30))
                        n += 2
            del w
        log(f"  ok wide s={str(sdt)[6:]}: {n} comparisons, largest error "
            f"{worst[f32]:.3e} of max|plain| at f32 x, {worst[bf16]:.3e} "
            f"at bf16 x")
    # the indexed wrapper without glue takes the ring too
    w = rand_qarray(gen, (2, *PROJ_7B["w2"]), QuantType.INT8, dev)
    f = qmm.qmatmul_pallas_indexed
    for T in (1, 48, 128):
        x = torch.randn((T, PROJ_7B["w2"][0]), generator=gen, device=dev)
        n0 = f.launches_wide_pipe
        e = compare(f"wide qmatmul_pallas_indexed w2[1] T={T}",
                    f(x, w, 1, f32), qmm.qmm_plain(x, w[1], f32), TOL_F32,
                    quiet=True)
        check(f.launches_wide_pipe == n0 + 1,
              "indexed: not a launch on the wide ring")
        errs["qmatmul_pallas_indexed_wide_pipe"] = max(
            errs["qmatmul_pallas_indexed_wide_pipe"], e)
    log("  ok wide qmatmul_pallas_indexed w2[1] T in {1, 48, 128}")
    del w
    torch.cuda.empty_cache()


def check_wide_prefill(dev, gen, errs):
    """Phase 2m above 128 rows: K1's wide mode on its prefill kernel
    (``qmm_wgmma_wide_kernel``, f32 compute) against ``qmm_fused_plain`` at
    the four 7B projections of a fused layer, INT8 with f32 and with bf16
    scales, T in {129, 200, 256, 1024, 2048}, f32 and bf16 x: bare through
    ``qmatmul_pallas`` and with the norm gain, the residual and both
    through the fused wrapper on layer 1 of a stacked weight (one
    ``launches_wide_prefill`` on the calling wrapper, none on
    ``launches_wide_pipe``), at T <= 256 also at one split (``_launch``,
    uncounted); the indexed wrapper without glue at T = 2048; gs 128 (a
    group over two stages) on wo with the glue, at the auto split and at
    three (which cut groups), T in {256, 2048}.  Limits as
    the ring's: f32 x 1e-4 (``TOL_F32``), bf16 x 1e-2 of max|plain|."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2m: K1's wide mode above 128 rows vs plain (7B projections, "
        "f32 compute, T in {129, 200, 256, 1024, 2048}, with and without "
        "the glue)")
    bf16, f32 = torch.bfloat16, torch.float32
    glue = (("bare", False, False), ("norm", True, False),
            ("residual", False, True), ("norm+residual", True, True))
    for sdt in (f32, bf16):
        worst, n = {f32: 0.0, bf16: 0.0}, 0
        for name in ("wqkv", "wo", "w13", "w2"):
            I, O = PROJ_7B[name]
            w = rand_qarray(gen, (2, I, O), QuantType.INT8, dev, sdt)
            g = torch.rand((I,), generator=gen, device=dev) + 0.5
            for T in (129, 200, 256, 1024, 2048):
                for xdt, tol in ((f32, TOL_F32), (bf16, TOL_BF16)):
                    x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                    r = torch.randn((T, O), generator=gen, device=dev).to(xdt)
                    check(qmm._kernel(x, w[1], f32, False, r)
                          == "wide_prefill",
                          f"wide {name} T={T}: not a wide prefill call")
                    for gl, norm, res in glue:
                        kw = dict(norm_gain=g if norm else None,
                                  residual=r if res else None)
                        fn = (qmm.qmatmul_pallas if gl == "bare"
                              else qmm.qmatmul_pallas_indexed_fused)
                        n0 = fn.launches_wide_prefill
                        p0 = fn.launches_wide_pipe
                        got = (qmm.qmatmul_pallas(x, w[1], f32)
                               if gl == "bare" else
                               qmm.qmatmul_pallas_indexed(x, w, 1, f32, **kw))
                        check(fn.launches_wide_prefill == n0 + 1
                              and fn.launches_wide_pipe == p0,
                              f"wide {name} T={T} {gl}: not one launch of "
                              f"the wide prefill kernel")
                        want = qmm.qmm_fused_plain(x, w[1], f32, **kw)
                        label = (f"wide prefill {name} s={str(sdt)[6:]} "
                                 f"T={T} x={str(xdt)[6:]} {gl}")
                        e = compare(label, got, want, tol, quiet=True)
                        if T <= 256:
                            one = qmm._launch(x, w[1], f32, kw["norm_gain"],
                                              kw["residual"], splits=1)
                            compare(label + " splits=1", one, want, tol,
                                    quiet=True)
                        key = ("qmatmul_pallas_wide_prefill" if gl == "bare"
                               else "qmatmul_pallas_indexed_fused_"
                                    "wide_prefill")
                        errs[key] = max(errs[key], e)
                        worst[xdt] = max(worst[xdt], e / max(float(
                            want.float().abs().max()), 1e-30))
                        n += 1
            del w
            torch.cuda.empty_cache()
        log(f"  ok wide prefill s={str(sdt)[6:]}: {n} comparisons, largest "
            f"error {worst[f32]:.3e} of max|plain| at f32 x, "
            f"{worst[bf16]:.3e} at bf16 x")
    f = qmm.qmatmul_pallas_indexed
    for name in ("wo", "w2"):
        w = rand_qarray(gen, (2, *PROJ_7B[name]), QuantType.INT8, dev)
        x = torch.randn((2048, PROJ_7B[name][0]), generator=gen, device=dev)
        n0 = f.launches_wide_prefill
        e = compare(f"wide prefill qmatmul_pallas_indexed {name}[1] T=2048",
                    f(x, w, 1, f32), qmm.qmm_plain(x, w[1], f32), TOL_F32,
                    quiet=True)
        check(f.launches_wide_prefill == n0 + 1,
              "indexed: not a launch of the wide prefill kernel")
        errs["qmatmul_pallas_indexed_wide_prefill"] = max(
            errs["qmatmul_pallas_indexed_wide_prefill"], e)
        del w
    log("  ok wide prefill qmatmul_pallas_indexed wo[1], w2[1] T=2048")
    # gs 128: a group over two stages, cut by three splits
    w = rand_qarray(gen, (2, *PROJ_7B["wo"]), QuantType.INT8, dev, gs=128)
    g = torch.rand((PROJ_7B["wo"][0],), generator=gen, device=dev) + 0.5
    fi = qmm.qmatmul_pallas_indexed_fused
    for T in (256, 2048):
        x = torch.randn((T, PROJ_7B["wo"][0]), generator=gen, device=dev)
        r = torch.randn((T, PROJ_7B["wo"][1]), generator=gen, device=dev)
        want = qmm.qmm_fused_plain(x, w[1], f32, g, 1e-5, r)
        n0 = fi.launches_wide_prefill
        e = compare(f"wide prefill gs=128 wo[1] T={T} norm+residual",
                    qmm.qmatmul_pallas_indexed(x, w, 1, f32, norm_gain=g,
                                               residual=r), want, TOL_F32,
                    quiet=True)
        check(fi.launches_wide_prefill == n0 + 1,
              "gs=128: not a launch of the wide prefill kernel")
        compare(f"wide prefill gs=128 wo[1] T={T} splits=3",
                qmm._launch(x, w[1], f32, g, r, splits=3), want, TOL_F32,
                quiet=True)
        errs["qmatmul_pallas_indexed_fused_wide_prefill"] = max(
            errs["qmatmul_pallas_indexed_fused_wide_prefill"], e)
    log("  ok wide prefill gs=128 wo[1] T in {256, 2048}, auto and 3 "
        "splits")
    del w
    torch.cuda.empty_cache()


def plane_probe(dev, gen, T, I, scale_dtype, gs=64):
    """Inputs on which the wide mode's product shows whether each of x's
    three bf16 planes was multiplied: an f32 x of full 24-bit significands
    (its lo plane about 2^-17 of |x|) and an INT8 identity weight (I, I)
    whose group scales are powers of two (1/2, 1 and 2 by group), so that
    the product is x times its column's scale exactly, which the three
    planes reach up to the f32 accumulation's last bit.  Returns (x, the
    weight, the exact product, max|error| of the same product without the
    lo plane)."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.quant.groupquant import QArray
    x = torch.randn((T, I), generator=gen, device=dev)
    e = torch.arange(I // gs, device=dev) % 3 - 1
    s = torch.exp2(e.float())[:, None].expand(I // gs, I).contiguous()
    w = QArray(torch.eye(I, dtype=torch.int8, device=dev),
               s.to(scale_dtype), QuantType.INT8, gs, group_axis=-2)
    col = torch.exp2((torch.arange(I, device=dev) // gs % 3 - 1).float())
    exact = x * col
    hi = x.to(torch.bfloat16).float()
    two = (hi + (x - hi).to(torch.bfloat16).float()) * col
    return x, w, exact, float((two - exact).abs().max())


def check_wide_planes(dev, gen):
    """Phase 2m's plane probe (:func:`plane_probe`, at wo's width 4096):
    the wide ring (T = 48) and the wide prefill kernel (T in {129, 256,
    2048}, the auto split and, above 128 rows, one and three splits), f32
    and bf16 scales, each within ``TOL_PLANES`` (2^-21) of max|exact| of
    the exact product, where the product without the lo plane is more than
    four times that limit off: a kernel that drops or misplaces a plane
    fails here though it passes ``TOL_F32``."""
    import torch
    from fastllama_tpu_torch.ops.kernels import qmm
    f32, I = torch.float32, PROJ_7B["wo"][0]
    log("phase 2m: the wide mode's plane probe (identity INT8 weight, "
        "power-of-two scales, f32 x at 4096 columns) against the exact "
        "product")
    worst, n = 0.0, 0
    for sdt in (f32, torch.bfloat16):
        for T in (48, 129, 256, 2048):
            x, w, exact, two = plane_probe(dev, gen, T, I, sdt)
            ref = float(exact.abs().max())
            label = f"plane probe T={T} s={str(sdt)[6:]}"
            check(two > 4 * TOL_PLANES * ref,
                  f"{label}: the product without the lo plane is only "
                  f"{two / ref:.3e} of max|exact| off")
            mode = "wide_pipe" if T <= 128 else "wide_prefill"
            check(qmm._kernel(x, w, f32, False, None) == mode,
                  f"{label}: not a {mode} call")
            got = {"auto": qmm.qmatmul_pallas(x, w, f32)}
            if T > 128:
                for splits in (1, 3):
                    got[f"splits={splits}"] = qmm._launch(x, w, f32,
                                                          splits=splits)
            for k, v in got.items():
                e = compare(f"{label} {k}", v, exact, TOL_PLANES, quiet=True)
                worst = max(worst, e / ref)
                n += 1
            del x, w, exact
    torch.cuda.empty_cache()
    log(f"  ok plane probe: {n} products, largest error {worst:.3e} of "
        f"max|exact| (limit {TOL_PLANES:.3e}; without the lo plane "
        f"> {4 * TOL_PLANES:.3e})")


def check_prefill(dev, gen, errs):
    """Phase 2n: the prefill mode of K1 and K1p (``qmm_wgmma_kernel``)
    against the plain versions at the four 7B projections of a fused layer,
    INT8 with f32 and with bf16 scales, packed INT4 (hidden 11264) with f32
    scales and bf16 or f32 x, T in {129, 200, 256, 1024, 2048}: the plain
    wrapper, then layer 1 of a stacked weight with the norm gain, the
    residual and both; the indexed wrapper without glue at T = 2048.  Every
    call must be one launch on its wrapper's ``launches_prefill`` and none
    on ``launches_pipe``.  Limits as phase 2l: bf16 x 1e-2, f32 x 1e-4 of
    max|plain|, 1e-3 (TOL_P4_NORM) for f32 x through the norm prologue."""
    import torch
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    log("phase 2n: the prefill mode of K1 and K1p vs plain (7B projections, "
        "T in {129, 200, 256, 1024, 2048}, with and without the glue)")
    bf16, f32 = torch.bfloat16, torch.float32
    glue = (("bare", False, False), ("norm", True, False),
            ("residual", False, True), ("norm+residual", True, True))
    kinds = (("int8 s=f32", PROJ_7B, None, (bf16,)),
             ("int8 s=bf16", PROJ_7B, bf16, (bf16,)),
             ("int4 s=f32", PROJ_7B_INT4, None, (bf16, f32)))
    layer = ("wqkv", "wo", "w13", "w2")
    for label, proj, sdt, xdts in kinds:
        worst, n = 0.0, 0
        for name in layer:
            I, O = proj[name]
            shape = (2, I, O)
            w = (rand_packed(gen, shape, dev, sdt) if label.startswith("int4")
                 else rand_qarray(gen, shape, QuantType.INT8, dev, sdt))
            g = torch.rand((I,), generator=gen, device=dev) + 0.5
            for T in (129, 200, 256, 1024, 2048):
                for xdt in xdts:
                    x = torch.randn((T, I), generator=gen, device=dev).to(xdt)
                    r = torch.randn((T, O), generator=gen, device=dev).to(xdt)
                    check(qmm._kernel(x, w[1], bf16, False, r) == "prefill",
                          f"prefill {label} {name} T={T}: not a prefill "
                          f"call")
                    for gl, norm, res in glue:
                        kw = dict(norm_gain=g if norm else None,
                                  residual=r if res else None)
                        fn = (qmm.qmatmul_pallas if gl == "bare"
                              else qmm.qmatmul_pallas_indexed_fused)
                        n0, p0 = fn.launches_prefill, fn.launches_pipe
                        got = (qmm.qmatmul_pallas(x, w[1]) if gl == "bare"
                               else qmm.qmatmul_pallas_indexed(x, w, 1, bf16,
                                                               **kw))
                        check(fn.launches_prefill == n0 + 1
                              and fn.launches_pipe == p0,
                              f"prefill {label} {name} T={T} {gl}: not one "
                              f"prefill launch")
                        want = qmm.qmm_fused_plain(x, w[1], bf16, **kw)
                        tol = (TOL_BF16 if xdt == bf16 else
                               TOL_P4_NORM if norm else TOL_F32)
                        e = compare(f"prefill {label} {name} T={T} "
                                    f"x={str(xdt)[6:]} {gl}", got, want, tol,
                                    quiet=True)
                        key = ("qmatmul_pallas_prefill" if gl == "bare" else
                               "qmatmul_pallas_indexed_fused_prefill")
                        errs[key] = max(errs[key], e)
                        worst = max(worst, e / max(float(
                            want.float().abs().max()), 1e-30))
                        n += 1
            del w
            torch.cuda.empty_cache()
        log(f"  ok prefill {label}: {n} comparisons, largest error "
            f"{worst:.3e} of max|plain|")
    # the indexed wrapper without glue takes the mode too
    f = qmm.qmatmul_pallas_indexed
    for name in ("wo", "w2"):
        w = rand_qarray(gen, (2, *PROJ_7B[name]), QuantType.INT8, dev)
        x = torch.randn((2048, PROJ_7B[name][0]), generator=gen,
                        device=dev).to(bf16)
        n0 = f.launches_prefill
        e = compare(f"prefill qmatmul_pallas_indexed {name}[1] T=2048",
                    f(x, w, 1), qmm.qmm_plain(x, w[1]), TOL_BF16, quiet=True)
        check(f.launches_prefill == n0 + 1, "indexed: not a prefill launch")
        errs["qmatmul_pallas_indexed_prefill"] = max(
            errs["qmatmul_pallas_indexed_prefill"], e)
        del w
    log("  ok prefill qmatmul_pallas_indexed wo[1], w2[1] T=2048")
    torch.cuda.empty_cache()


# -- phase 3: engine, kernel path against plain path ------------------------

def plain_logits(dev, cfg, params, use_pallas=False):
    """logits_of(seq): the plain path's next-token logits after ``seq``
    (``forward`` over the whole sequence at pos 0, f32, plain matmuls and
    attention): the referee of ``same_greedy``.  ``use_pallas`` takes the
    kernel path at f32 compute instead (held to the plain path within
    ``TOL_F32`` by phases 2 and 3), a faster referee at 32 layers."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.models.llama import KVCache, forward
    from fastllama_tpu_torch.runtime.kernels import select_kernels
    kb = select_kernels(dev, EngineConfig(use_pallas=use_pallas,
                                          compute_dtype="float32"),
                        torch.float32)

    def logits_of(seq):
        cache = KVCache.create(cfg, dtype=torch.float32, device=dev)
        lg, _ = forward(cfg, params, torch.tensor(seq, device=dev), 0, cache,
                        mm=kb.mm, mm_idx=kb.mm_idx,
                        compute_dtype=torch.float32,
                        last_index=len(seq) - 1)
        return lg[0].float()

    def rows_of(seq):
        """Every row's next-token logits of one forward over ``seq``: row
        i is ``logits_of(seq[:i + 1])`` computed causally in one block."""
        cache = KVCache.create(cfg, dtype=torch.float32, device=dev)
        lg, _ = forward(cfg, params, torch.tensor(seq, device=dev), 0, cache,
                        mm=kb.mm, mm_idx=kb.mm_idx,
                        compute_dtype=torch.float32)
        return lg.float()
    logits_of.rows = rows_of
    return logits_of


def same_greedy(label, got, want, prompts, logits_of, tie_tol=None):
    """Greedy tokens of two paths, request by request.  Without
    ``tie_tol`` they must be equal.  With it (INT4, where K1p rounds its
    activations to bf16, so the paths' logits differ by up to about 4e-3
    of their maximum) a request may part from the other path only at an
    argmax tie: at its first differing step both tokens lie within
    2 x tie_tol x max|logits| of the top logit of ``logits_of`` over the
    prompt and the common prefix (two logits each within the logit
    tolerance).  After the parting the two requests condition on
    different prefixes, so each later token of ``got`` is held to the
    same bound against ``logits_of`` over its own prefix (the rows of one
    forward over it, ``logits_of.rows``: a :func:`plain_logits` referee).
    Returns the number of partings."""
    ties = 0
    for i, (g, w, p) in enumerate(zip(got, want, prompts)):
        if g == w:
            continue
        check(tie_tol is not None and len(g) == len(w),
              f"{label}: request {i} tokens differ: {g} vs {w}")
        k = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        lg = logits_of(list(p) + list(w[:k]))
        top, m = float(lg.max()), float(lg.abs().max())
        gaps = (top - float(lg[g[k]]), top - float(lg[w[k]]))
        check(max(gaps) <= 2 * tie_tol * m,
              f"{label}: request {i} parts at step {k} ({g[k]} vs {w[k]}), "
              f"not at a tie: gaps to the top logit {gaps}, max|logit| "
              f"{m:.4e}")
        worst = 0.0
        # one forward over the request's own tokens gives every later
        # step's logits
        rows = logits_of.rows(list(p) + list(g[:-1]))
        for j in range(k + 1, len(g)):
            lg = rows[len(p) + j - 1]
            gap = float(lg.max() - lg[g[j]]) / float(lg.abs().max())
            check(gap <= 2 * tie_tol,
                  f"{label}: request {i} after its parting at step {k}: "
                  f"token {g[j]} at step {j} is {gap:.3e} of max|logit| "
                  f"below the plain forward's top")
            worst = max(worst, gap)
        log(f"  tie {label}: request {i} parts at step {k} ({g[k]} vs "
            f"{w[k]}); gaps to the top logit {gaps[0]:.3e} and "
            f"{gaps[1]:.3e}, max|logit| {m:.3e}; its {len(g) - k - 1} later "
            f"tokens at most {worst:.3e} of max|logit| below the plain "
            f"forward's top over their own prefix")
        ties += 1
    return ties


def phase_engine_parity(dev, rec, cfg=None, tol=TOL_F32, flip_cap=1e-3,
                        key="engine_parity", tie_tol=None):
    """The BatchedEngine's kernel path against its plain path: model-level
    logits in lockstep, then greedy tokens.  ``cfg`` defaults to the INT8
    7B width at 2 layers; phase 3d passes the INT4 one with its own
    tolerances (see ``phase_int4_parity``)."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.batched import (BatchedKVCache,
                                                    decode_step, prefill_many)
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int)
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.kernels import select_kernels
    cfg = cfg or cfg_7b(n_layers=2)
    log(f"phase 3 ({cfg.quant_type.name}): engine kernel path vs plain path "
        f"(7B width, 2 layers, f32 compute, int8 KV, B=4)")
    params = random_params_int(cfg, seed=SEED, device=dev)
    fused = fuse_params(cfg, params)
    rng = torch.Generator(device="cpu")
    rng.manual_seed(SEED)
    B, T = 4, 64
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (43, 17, 60, 5)]

    # model level: prefill + teacher-forced decode steps in lockstep,
    # logits compared after every step.  Each step starts from the same
    # cache: an int8 row may round one element the other way (its f32
    # input differs in the last bits), and one quantum moves the logits by
    # more than the f32 tolerance; the caches are checked to agree within
    # that quantum and the plain path's bytes are then copied over.
    kbs = {use: select_kernels(dev, EngineConfig(
        use_pallas=use, compute_dtype="float32", kv_dtype="int8"),
        torch.float32) for use in (True, False)}
    caches = {use: BatchedKVCache.create(cfg, B, dtype=torch.int8,
                                         device=dev) for use in kbs}

    def sync(label):
        ck, cp = caches[True], caches[False]
        for name in ("k", "v"):
            d = (getattr(ck, name).int() - getattr(cp, name).int()).abs()
            flips = float((d > 0).float().mean())
            check(int(d.max()) <= 1 and flips < flip_cap,
                  f"{label}: cache {name} differs by more than one quantum "
                  f"(max {int(d.max())}, share {flips:.2e})")
            log(f"  ok {label} cache {name}: within one int8 quantum, "
                f"share {flips:.2e}")
            compare(f"{label} cache {name}_scale",
                    getattr(ck, name + "_scale"),
                    getattr(cp, name + "_scale"), tol)
            getattr(ck, name).copy_(getattr(cp, name))
            getattr(ck, name + "_scale").copy_(getattr(cp, name + "_scale"))

    toks = torch.zeros((B, T), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts])
    out = {}
    for use, kb in kbs.items():
        out[use], _ = prefill_many(
            cfg, fused, toks.to(dev), lens.to(dev),
            torch.arange(B, dtype=torch.int32, device=dev), caches[use],
            mm=kb.mm, mm_idx=kb.mm_idx, slot_writer=kb.slot_writer,
            compute_dtype=torch.float32)
    errs = [compare("engine logits prefill", out[True], out[False], tol)]
    sync("prefill")
    pos = lens.to(dev, torch.int32)
    tok = torch.tensor([7, 11, 13, 17], device=dev)
    for step in range(3):
        for use, kb in kbs.items():
            out[use], _ = decode_step(
                cfg, fused, tok, pos, caches[use], mm=kb.mm,
                mm_idx=kb.mm_idx, attn_bidx=kb.attn_bidx,
                kv_writer=kb.kv_writer, compute_dtype=torch.float32)
        errs.append(compare(f"engine logits decode step {step}", out[True],
                            out[False], tol))
        sync(f"decode step {step}")
        pos = pos + 1
        tok = (tok * 31 + 5) % cfg.vocab_size
    del caches

    # engine level: greedy tokens equal
    toks_by = {}
    for use in (True, False):
        eng = BatchedEngine(cfg, params, Tokenizer().finalize(),
                            EngineConfig(max_batch_size=B, kv_dtype="int8",
                                         compute_dtype="float32",
                                         use_pallas=use),
                            decode_chunk=8, device=dev)
        reqs = eng.generate_all(prompts + prompts[:2], max_new_tokens=20,
                                temperature=0.0, stop_tokens=())
        toks_by[use] = [r.output_tokens for r in reqs]
        check(all(len(t) == 20 for t in toks_by[use]), "short output")
        del eng
    ties = same_greedy("BatchedEngine", toks_by[True], toks_by[False],
                       prompts + prompts[:2], plain_logits(dev, cfg, params),
                       tie_tol)
    log(f"  ok greedy tokens equal over {len(toks_by[True])} requests "
        f"(6 requests through 4 slots; {ties} parted at a tie)")
    rec[key] = {"max_logit_err": max(errs), "tokens_equal": True,
                "ties": ties}
    del params, fused
    torch.cuda.empty_cache()


def phase_spec_parity(dev, rec, cfg=None, tol=TOL_F32, flip_cap=1e-3,
                      key="spec_parity", tie_tol=None):
    """The batched speculative path's kernels against its plain path: 7B
    width (INT8 unless ``cfg`` says), 2 layers, f32 compute, int8 KV, B=4.  ``spec_decode_step`` with
    K2s and spec_write against the plain verify (logits, caches within one
    int8 quantum); then ``SpecBatchedEngine`` greedy tokens (width 4, the
    tuner off and on) against the plain ``BatchedEngine``'s, with drafts
    accepted on a repetitive prompt."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.batched import (BatchedKVCache,
                                                    prefill_many,
                                                    spec_decode_step)
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int)
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.kernels import select_kernels
    from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
    cfg = cfg or cfg_7b(n_layers=2)
    log(f"phase 3c ({cfg.quant_type.name}): speculative verify and "
        f"SpecBatchedEngine, kernel path vs plain path (7B width, 2 layers, "
        f"f32 compute, int8 KV, B=4)")
    params = random_params_int(cfg, seed=SEED + 7, device=dev)
    fused = fuse_params(cfg, params)
    B, D, T = 4, 4, 64
    rng = torch.Generator(device="cpu")
    rng.manual_seed(SEED + 7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (43, 17, 60, 5)]
    kbs = {use: select_kernels(dev, EngineConfig(
        use_pallas=use, compute_dtype="float32", kv_dtype="int8"),
        torch.float32) for use in (True, False)}
    check(kbs[False].attn_sbidx is None, "the plain path took a kernel")
    caches = {use: BatchedKVCache.create(cfg, B, dtype=torch.int8,
                                         device=dev) for use in kbs}
    toks = torch.zeros((B, T), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts])
    for cache in caches.values():              # one plain prefill each
        prefill_many(cfg, fused, toks.to(dev), lens.to(dev),
                     torch.arange(B, dtype=torch.int32, device=dev), cache,
                     mm=kbs[False].mm, slot_writer=kbs[False].slot_writer,
                     compute_dtype=torch.float32)
    pos = lens.to(dev, torch.int32)
    pos[3] = 0                                    # a parked slot
    batch = torch.randint(1, cfg.vocab_size, (B, D), generator=rng,
                          dtype=torch.int32).to(dev)
    errs = []
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    split0 = fd.flash_spec_batched.launches_split
    for rnd in range(2):
        out = {}
        for use, kb in kbs.items():
            out[use], _ = spec_decode_step(
                cfg, fused, batch, pos, caches[use], mm=kb.mm,
                mm_idx=kb.mm_idx, attn_sbidx=kb.attn_sbidx,
                spec_writer=kb.spec_writer, compute_dtype=torch.float32)
        errs.append(compare(f"spec_decode_step logits round {rnd}",
                            out[True], out[False], tol))
        ck, cp = caches[True], caches[False]
        for name in ("k", "v"):
            d = (getattr(ck, name).int() - getattr(cp, name).int()).abs()
            flips = float((d > 0).float().mean())
            check(int(d.max()) <= 1 and flips < flip_cap,
                  f"spec round {rnd}: cache {name} differs by more than one "
                  f"quantum (max {int(d.max())}, share {flips:.2e})")
            compare(f"spec round {rnd} cache {name}_scale",
                    getattr(ck, name + "_scale"),
                    getattr(cp, name + "_scale"), tol)
            getattr(ck, name).copy_(getattr(cp, name))
            getattr(ck, name + "_scale").copy_(getattr(cp, name + "_scale"))
        pos = pos + torch.tensor([1, 4, 2, 1], dtype=torch.int32, device=dev)
        batch = (batch * 31 + 5) % cfg.vocab_size
    check(fd.flash_spec_batched.launches_split - split0 == 2 * cfg.n_layers,
          "the verify's K2s launches were not all in the split-row mode")
    del caches, fused

    # engine level: greedy tokens of the spec engine equal plain serving
    ec = EngineConfig(max_batch_size=B, kv_dtype="int8",
                      compute_dtype="float32")
    rep = ([7, 121, 3088, 59] * 11)[:43]
    traffic = prompts + prompts[:2] + [rep]
    base = BatchedEngine(cfg, params, Tokenizer().finalize(), ec,
                         decode_chunk=8, device=dev)
    want = [r.output_tokens for r in base.generate_all(
        traffic, max_new_tokens=24, temperature=0.0, stop_tokens=())]
    del base
    accepted, ties = {}, 0
    logits_of = plain_logits(dev, cfg, params)
    for auto in (False, True):
        spec = SpecBatchedEngine(cfg, params, Tokenizer().finalize(), ec,
                                 decode_chunk=8, width=4, rounds_per_chunk=8,
                                 spec_auto=auto, device=dev)
        got = [r.output_tokens for r in spec.generate_all(
            traffic, max_new_tokens=24, temperature=0.0, stop_tokens=())]
        ties += same_greedy(f"SpecBatchedEngine tuner={auto}", got, want,
                            traffic, logits_of, tie_tol)
        accepted[auto] = (spec.spec_accepted, spec.spec_drafted,
                          dict(spec.arm_chunks))
        log(f"  ok SpecBatchedEngine tuner={auto}: greedy tokens equal "
            f"plain serving over {len(traffic)} requests; accepted "
            f"{spec.spec_accepted} of {spec.spec_drafted} drafts; chunks by "
            f"arm {dict(spec.arm_chunks)}")
        del spec
    check(accepted[False][0] > 0, "no draft accepted on a repetitive prompt")
    rec[key] = {"max_logit_err": max(errs), "tokens_equal": True,
                "ties": ties, "accepted_drafted_arms": {
                    str(k): v for k, v in accepted.items()}}
    del params
    torch.cuda.empty_cache()


def phase_single_parity(dev, rec, cfg=None, tol=TOL_F32,
                        key="single_parity", tie_tol=None):
    """The single-stream engine's kernel path (K1f, K2 non-fresh, K1; K1p
    at INT4) against its plain path: 7B width, 2 layers, f32 compute, f32
    scales, f32 KV.  Logits of a prefill, a mid-sequence block and a decode step
    within the f32 tolerance; equal greedy tokens over 40 new tokens in
    chunks of 16 (a tail chunk of 7 runs); one two-turn ChatSession."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import \
        build_byte_fallback_vocab
    from fastllama_tpu_torch.models.llama import (KVCache, forward,
                                                  random_params_int)
    from fastllama_tpu_torch.runtime.engine import ChatSession, Engine
    cfg = cfg or cfg_7b(n_layers=2)
    log(f"phase 3b ({cfg.quant_type.name}): single-stream Engine kernel path "
        f"vs plain path (7B width, 2 layers, f32 compute, f32 scales, f32 "
        f"KV)")
    params = random_params_int(cfg, seed=SEED + 3, device=dev)
    vocab = build_byte_fallback_vocab(
        [f"w{i}" for i in range(cfg.vocab_size - 259)])
    engs = {use: Engine(cfg, params, vocab, EngineConfig(
        compute_dtype="float32", scale_dtype="float32", kv_dtype="float32",
        use_pallas=use), device=dev) for use in (True, False)}
    del params
    rng = torch.Generator(device="cpu")
    rng.manual_seed(SEED + 3)
    prompt = torch.randint(3, cfg.vocab_size, (59,), generator=rng).tolist()

    # model level: a 43-token prefill, a 16-token block at pos 43 (K1f at
    # T=16, masked attention over the cache) and one decode step at 59
    out, caches = {}, {}
    for use, eng in engs.items():
        kb = eng.kernels
        hooks = dict(mm=kb.mm, attn=kb.attn, mm_idx=kb.mm_idx,
                     attn_idx=kb.attn_idx, compute_dtype=torch.float32)
        c = KVCache.create(cfg, dtype=torch.float32, device=dev)
        toks = torch.tensor(prompt, device=dev)
        a, _ = forward(cfg, eng.params, toks[:43], 0, c, **hooks)
        b, _ = forward(cfg, eng.params, toks[43:], 43, c, **hooks)
        d, _ = forward(cfg, eng.params, torch.tensor([7], device=dev), 59, c,
                       **hooks)
        out[use], caches[use] = (a, b, d), c
    errs = [compare(f"single-stream logits {label}", got, want, tol)
            for label, got, want in zip(("prefill T=43", "block T=16 at 43",
                                         "decode at 59"), out[True],
                                        out[False])]
    for name in ("k", "v"):
        compare(f"single-stream cache {name}", getattr(caches[True], name),
                getattr(caches[False], name), tol)
    del caches

    # engine level: greedy tokens over 40 new tokens, chunks of 16
    toks = {}
    for use, eng in engs.items():
        toks[use], st = eng.generate(prompt[:43], max_new_tokens=40,
                                     temperature=0.0, stop_tokens=(),
                                     decode_chunk=16)
        check(len(toks[use]) == 40, "short single-stream output")
    ties = same_greedy("Engine", [toks[True]], [toks[False]], [prompt[:43]],
                       plain_logits(dev, cfg, engs[False].params), tie_tol)
    log(f"  ok single-stream greedy tokens equal over 40 new tokens "
        f"(chunks 16, 16 and a tail of 7; {ties} parted at a tie)")

    # a two-turn chat session: the history stays in the cache
    replies = {}
    for use, eng in engs.items():
        sess = ChatSession(eng, "w5 w9 w17")
        replies[use] = [(sess.generate(turn, max_new_tokens=12,
                                       temperature=0.0), sess.pos)
                        for turn in ("w3w17 w40 w1", "w100w2w77")]
    check(replies[True] == replies[False],
          f"chat replies differ: {replies[True]} vs {replies[False]}")
    log(f"  ok two-turn ChatSession equal (positions "
        f"{[p for _, p in replies[True]]})")
    rec[key] = {"max_logit_err": max(errs), "tokens_equal": True,
                "ties": ties, "chat_equal": True}
    del engs
    torch.cuda.empty_cache()


def phase_single_spec_parity(dev, rec, cfg=None):
    """Phase 3g: the single-stream ``SpeculativeEngine``, kernel path
    against plain path (7B width, 2 layers, INT8, f32 compute, f32 scales,
    f32 KV, S = 128).  On each path the speculative greedy tokens equal
    ``Engine.generate``'s for the n-gram drafter at widths 4 and 8 on a
    repetitive prompt, a ``truncate_params(..., 1)`` draft, a
    ``requantize_params(..., INT4)`` draft, and near the context limit (a
    90-token prompt, 38 new tokens, width 8, 8 rounds a call).  On the
    kernel path a chunk queues no host sync (greedy and sampled, both
    drafters; ``torch.cuda.set_sync_debug_mode``), sampled runs
    (temperature 0.8, top-p 0.9) complete at full length inside the vocab,
    and ``forward`` at device positions equals ``forward`` at a host pos
    bit for bit (logits and cache, T = 1 and 8, both paths)."""
    import traceback
    import warnings

    import torch
    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.loaders.tokenizer import \
        build_byte_fallback_vocab
    from fastllama_tpu_torch.models.llama import (KVCache, forward,
                                                  random_params_int,
                                                  requantize_params,
                                                  truncate_params)
    from fastllama_tpu_torch.runtime.engine import Engine
    from fastllama_tpu_torch.runtime.speculative import SpeculativeEngine
    cfg = cfg or cfg_7b(n_layers=2)
    log("phase 3g: single-stream SpeculativeEngine kernel path vs plain "
        "path (7B width, 2 layers, INT8, f32 compute, f32 scales, f32 KV, "
        "S=128)")
    V = cfg.vocab_size
    params = random_params_int(cfg, seed=SEED + 7, device=dev)
    cfg1, p1 = truncate_params(cfg, params, 1)
    cfg4 = cfg.replace(quant_type=QuantType.INT4)
    p4 = requantize_params(cfg, params, QuantType.INT4)
    vocab = build_byte_fallback_vocab([f"w{i}" for i in range(V - 259)])
    loop = [t % V for t in ([7, 121, 3088, 59] * 11)[:43]]
    near = (loop * 3)[:90]
    # (label, draft, width, prompt, new tokens)
    cases = [("n-gram width 4", None, 4, loop, 40),
             ("n-gram width 8", None, 8, loop, 40),
             ("truncate_params 1 layer", "trunc", 4, loop, 40),
             ("requantize_params INT4", "int4", 4, loop, 40),
             ("near the context limit", None, 8, near, 38)]
    out = {}
    for use in (True, False):
        ec = EngineConfig(max_seq_len=128, compute_dtype="float32",
                          scale_dtype="float32", kv_dtype="float32",
                          use_pallas=use)
        target = Engine(cfg, params, vocab, ec, device=dev)
        drafts = {"trunc": Engine(cfg1, p1, vocab, ec, device=dev),
                  "int4": Engine(cfg4, p4, vocab, ec, device=dev)}
        path = "kernel" if use else "plain"
        plain = {}
        for label, d, width, prompt, n in cases:
            key = (tuple(prompt), n)
            if key not in plain:
                plain[key], _ = target.generate(
                    prompt, max_new_tokens=n, temperature=0.0,
                    stop_tokens=(), decode_chunk=16)
            spec = SpeculativeEngine(target, drafts.get(d), width=width,
                                     rounds_per_call=8)
            toks, st = spec.generate(prompt, max_new_tokens=n,
                                     stop_tokens=())
            check(toks == plain[key],
                  f"3g {path} path, {label}: speculative tokens {toks} "
                  f"differ from plain greedy {plain[key]}")
            out[f"{path}: {label}"] = {
                "tokens": len(toks), "rounds": st.rounds,
                "drafted": st.drafted, "accepted": st.accepted,
                "acceptance": st.acceptance}
            log(f"  ok {path} path, {label}: {len(toks)} tokens equal to "
                f"plain greedy; {st.rounds} rounds, acceptance "
                f"{st.acceptance:.3f}")

        # forward at device positions against a host pos, bit for bit
        kb = target.kernels
        hooks = dict(mm=kb.mm, attn=kb.attn, mm_idx=kb.mm_idx,
                     attn_idx=kb.attn_idx, compute_dtype=torch.float32)
        toks = torch.tensor(loop + [5, 9, 300, 17, 2, 88, 41, 3][:8],
                            device=dev)
        for T in (1, 8):
            res = []
            for device_pos in (False, True):
                c = KVCache.create(target.config, dtype=torch.float32,
                                   device=dev)
                forward(target.config, target.params, toks[:43], 0, c,
                        **hooks)
                if device_pos:
                    lg, _ = forward(
                        target.config, target.params, toks[43:43 + T], None,
                        c, positions=torch.arange(43, 43 + T,
                                                  dtype=torch.int32,
                                                  device=dev), **hooks)
                else:
                    lg, _ = forward(target.config, target.params,
                                    toks[43:43 + T], 43, c, **hooks)
                res.append((lg, c))
            (la, ca), (lb, cb) = res
            check(torch.equal(la, lb) and torch.equal(ca.k, cb.k)
                  and torch.equal(ca.v, cb.v),
                  f"3g {path} path: forward at device positions differs "
                  f"from a host pos at T={T}")
            log(f"  ok {path} path: forward at device positions equals a "
                f"host pos bit for bit at T={T} (logits and cache)")
            del res, ca, cb
        if not use:
            continue

        # no host sync inside a chunk (a synchronizing call raises in the
        # debug mode "error"; where, is reported); sampled runs at full
        # length
        syncs = []
        for d in (None, drafts["trunc"]):
            spec = SpeculativeEngine(target, d, width=8)
            for temp in (0.0, 0.8):
                st, _, gen = spec._start(loop, temp, 0.9, SEED)
                torch.cuda.synchronize()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # "a prototype"
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    spec._chunk(st, 2, temp > 0, temp, 0.9, gen)
                except RuntimeError as e:
                    where = [f"{f.filename.split('/')[-1]}:{f.lineno} "
                             f"{f.line}" for f in
                             traceback.extract_tb(e.__traceback__)
                             if "fastllama_tpu_torch" in f.filename]
                    syncs.append((f"{'draft' if d else 'n-gram'} "
                                  f"temperature {temp}", str(e)[:120],
                                  where[-3:]))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            toks, st = spec.generate(loop, max_new_tokens=40,
                                     stop_tokens=(), temperature=0.8,
                                     topp=0.9, seed=SEED + 1)
            check(len(toks) == 40 and all(0 <= t < V for t in toks),
                  f"3g sampled run ({'draft' if d else 'n-gram'}): "
                  f"{len(toks)} tokens, vocab {V}: {toks}")
            out[f"sampled {'draft' if d else 'n-gram'} acceptance"] = \
                st.acceptance
        check(not syncs, f"3g: a speculative chunk synchronized with the "
                         f"host: {syncs[:3]}")
        log(f"  ok no host sync in a chunk of 2 rounds (greedy and sampled, "
            f"both drafters); sampled runs 40 tokens in the vocab, "
            f"acceptance n-gram {out['sampled n-gram acceptance']:.3f}, "
            f"draft {out['sampled draft acceptance']:.3f}")
        del target, drafts, spec, st
    rec["single_spec_parity"] = out
    del params, p1, p4
    torch.cuda.empty_cache()


def phase_int4_parity(dev, rec):
    """Phase 3d: the three engines at packed INT4 (bench.py's INT4 shape,
    hidden_dim 11264, every projection packed; 7B width, 2 layers, f32
    compute), kernel path (K1p) against plain path, as phases 3, 3b and 3c.
    Logits are held to TOL_BF16, not TOL_F32: K1p rounds its activations to
    bf16 at any compute dtype, so the two paths' f32 summation orders flip
    some of those roundings downstream (at most 4.1e-3 of max|plain| seen
    on an H100).  For the same reason an int8 cache element may differ by
    one quantum in up to INT4_FLIP_CAP of a cache (5.9e-3 seen), and greedy
    tokens are equal up to argmax ties (``same_greedy``)."""
    cfg = cfg_7b_int4(n_layers=2)
    phase_engine_parity(dev, rec, cfg, TOL_BF16, INT4_FLIP_CAP,
                        "int4_engine_parity", tie_tol=TOL_BF16)
    phase_single_parity(dev, rec, cfg, TOL_BF16, "int4_single_parity",
                        tie_tol=TOL_BF16)
    phase_spec_parity(dev, rec, cfg, TOL_BF16, INT4_FLIP_CAP,
                      "int4_spec_parity", tie_tol=TOL_BF16)


def within_quantum(label, a, b, flip_cap=1e-3):
    """Two int8 tensors within one quantum, in fewer than ``flip_cap`` of
    their elements (an f32 row whose last bits differ between the paths
    may round one element the other way)."""
    d = (a.int() - b.int()).abs()
    flips = float((d > 0).float().mean())
    check(int(d.max()) <= 1 and flips < flip_cap,
          f"{label}: differ by more than one quantum (max {int(d.max())}, "
          f"share {flips:.2e})")
    return flips


def phase_prefix_deferred_parity(dev, rec):
    """Phase 3e: the prefix cache and deferred KV, kernel path (K2b, K2
    with stats, K3) against the plain path (``use_pallas=False``: the
    copy-and-mask tail, plain chunks) at 7B width, 2 layers, f32 compute,
    int8 KV, B=4.  Model level in lockstep: a tail prefill at start 48
    over a copied donor prefix, then 4 teacher-forced deferred steps and
    their landing against 4 plain decode steps, the caches held within one
    quantum and the plain path's bytes copied over after each check, as
    phase 3 does.  Engine level: greedy tokens and prefix stats of the
    BatchedEngine and the SpecBatchedEngine on donor-then-hits traffic
    (and, at an f32 cache, equal to the engine without the prefix cache),
    and of the deferred BatchedEngine (decode chunk 16) against plain
    chunks."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.batched import (
        BatchedKVCache, copy_slot_prefix, decode_step, decode_step_deferred,
        land_staged, make_staged, prefill_into_slot_at, prefill_many)
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int)
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.kernels import select_kernels
    from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
    cfg = cfg_7b(n_layers=2)
    log("phase 3e: prefix cache and deferred KV, kernel path vs plain path "
        "(7B width, 2 layers, f32 compute, int8 KV, B=4)")
    params = random_params_int(cfg, seed=SEED + 11, device=dev)
    fused = fuse_params(cfg, params)
    f32 = torch.float32
    kbs = {use: select_kernels(dev, EngineConfig(
        use_pallas=use, compute_dtype="float32", kv_dtype="int8"), f32)
        for use in (True, False)}
    check(kbs[True].attn_tail is not None and kbs[True].attn_stats
          is not None, "the kernel path lacks K2b or K2 with stats")
    check(kbs[False].attn_tail is None and kbs[False].attn_stats is None,
          "the plain path took a kernel")
    rng = torch.Generator(device="cpu")
    rng.manual_seed(SEED + 11)
    B = 4
    caches = {use: BatchedKVCache.create(cfg, B, dtype=torch.int8,
                                         device=dev) for use in kbs}

    def sync(label, flip_cap=1e-3):
        ck, cp = caches[True], caches[False]
        for name in ("k", "v"):
            within_quantum(f"{label} cache {name}", getattr(ck, name),
                           getattr(cp, name), flip_cap)
            compare(f"{label} cache {name}_scale",
                    getattr(ck, name + "_scale"),
                    getattr(cp, name + "_scale"), TOL_F32, quiet=True)
            for t in (name, name + "_scale"):
                getattr(ck, t).copy_(getattr(cp, t))
        log(f"  ok {label}: caches within one int8 quantum")

    # a donor prompt of 60 tokens in slot 1 (the plain prefill on both)
    donor = torch.randint(1, cfg.vocab_size, (1, 64), generator=rng)
    for c in caches.values():
        prefill_many(cfg, fused, donor.to(dev), torch.tensor([60], device=dev),
                     torch.tensor([1], dtype=torch.int32, device=dev), c,
                     mm=kbs[False].mm, slot_writer=kbs[False].slot_writer,
                     compute_dtype=f32)
    # slot 2: the donor's first 48 rows, then a 32-row tail (27 valid)
    tail = torch.randint(1, cfg.vocab_size, (32,), generator=rng).to(dev)
    lg = {}
    for use, kb in kbs.items():
        copy_slot_prefix(caches[use], 1, 2, 48)
        lg[use], _ = prefill_into_slot_at(
            cfg, fused, tail, 27, 2, 48, caches[use], mm=kb.mm,
            mm_idx=kb.mm_idx, attn_tail=kb.attn_tail,
            slot_writer=kb.slot_writer, compute_dtype=f32)
    errs = [compare("tail prefill logits (K2b vs copy-and-mask)", lg[True],
                    lg[False], TOL_F32)]
    sync("tail prefill")

    # 4 deferred steps (kernel path) against 4 plain decode steps
    K = 4
    pos0 = torch.tensor([0, 60, 75, 0], dtype=torch.int32, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (K, B), generator=rng).to(dev)
    kb = kbs[True]
    staged = make_staged(cfg, caches[True], B, K)
    n0 = fd.flash_decode_batched.launches_stats
    pos = pos0.clone()
    tally = ModeTally()          # K1's modes on the first deferred step
    for s in range(K):
        with tally if s == 0 else contextlib.nullcontext():
            got, staged = decode_step_deferred(
                cfg, fused, toks[s], pos0, s, staged, caches[True],
                mm=kb.mm, mm_idx=kb.mm_idx, attn_stats=kb.attn_stats,
                compute_dtype=f32)
        kp = kbs[False]
        want, _ = decode_step(cfg, fused, toks[s], pos, caches[False],
                              mm=kp.mm, mm_idx=kp.mm_idx,
                              attn_bidx=kp.attn_bidx, kv_writer=kp.kv_writer,
                              compute_dtype=f32)
        errs.append(compare(f"deferred step {s} logits", got, want,
                            TOL_F32))
        # the staged row against the row the plain step wrote, then the
        # plain bytes into the staging buffers
        b_i = torch.arange(B, device=dev)
        p_i = (pos0 + s).long()
        for i, name in enumerate(("k", "v")):
            plain_rows = getattr(caches[False], name)[:, b_i, :, p_i]
            within_quantum(f"deferred step {s} staged {name}",
                           staged[i][:, :, s], plain_rows.transpose(0, 1))
            staged[i][:, :, s] = plain_rows.transpose(0, 1)
            staged[2 + i][:, :, s] = getattr(
                caches[False], name + "_scale")[:, b_i, :, p_i].transpose(
                    0, 1)
        pos = pos + 1
    check(fd.flash_decode_batched.launches_stats - n0 == K * cfg.n_layers,
          "the deferred steps did not launch K2 with stats once a layer")
    # K1 at f32 compute: its wide mode's ring, every launch of a step (the
    # first step's, tallied alone)
    wide = tally.counts[("wide_pipe", True)]
    check(sum(tally.counts.values()) == wide > 0,
          f"a deferred step's K1 launches by mode {tally.record()}: not "
          f"all on the wide ring")
    land_staged(caches[True], staged, pos0, kb.spec_writer)
    sync("deferred landing")
    del caches, fused

    # engine level
    tok = Tokenizer().finalize()
    system = torch.randint(1, cfg.vocab_size, (48,), generator=rng).tolist()
    tails = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
             for n in (5, 3, 11, 20)]
    out = {}

    def hits_run(eng):
        first = eng.submit(system + tails[0], max_new_tokens=30,
                           temperature=0.0, stop_tokens=())
        eng.step()
        rest = [eng.submit(system + t, max_new_tokens=16, temperature=0.0,
                           stop_tokens=()) for t in tails[1:]]
        eng.run()
        return ([r.output_tokens for r in [first] + rest],
                (eng.stats.prefix_hits, eng.stats.prefix_rows_reused))

    def ec(use, kv="int8", **kw):
        return EngineConfig(max_batch_size=B, kv_dtype=kv,
                            compute_dtype="float32", use_pallas=use, **kw)
    fn = fd.flash_block_attend
    n0, n0_tf = fn.launches, fn.launches_tf32
    for use in (True, False):
        out["batched", use] = hits_run(BatchedEngine(
            cfg, params, tok, ec(use, prefix_cache=True), decode_chunk=8,
            device=dev))
        out["spec", use] = hits_run(SpecBatchedEngine(
            cfg, params, tok, ec(use, prefix_cache=True), decode_chunk=8,
            width=4, rounds_per_chunk=4, spec_auto=False, device=dev))
    launched = fn.launches - n0
    launched_tf = fn.launches_tf32 - n0_tf
    # against whole prefills only at an f32 cache: at int8 a hit's tail
    # attends the prefix rows as quantized in the cache, where a whole
    # prefill attends its own exact rows
    n0, n0_tf = fn.launches, fn.launches_tf32
    by_pc = {pc: hits_run(BatchedEngine(
        cfg, params, tok, ec(True, "float32", prefix_cache=pc),
        decode_chunk=8, device=dev)) for pc in (True, False)}
    f32_launched = fn.launches - n0
    check(f32_launched == fn.launches_tf32 - n0_tf == 3 * cfg.n_layers,
          f"f32 KV: K2b launched {f32_launched} times, "
          f"{fn.launches_tf32 - n0_tf} in the TF32 mode; want "
          f"{3 * cfg.n_layers}, all TF32")
    want_stats = (3, 3 * 48)
    for kind in ("batched", "spec"):
        check(out[kind, True] == out[kind, False],
              f"{kind} prefix cache: kernel and plain paths differ: "
              f"{out[kind, True]} vs {out[kind, False]}")
        check(out[kind, True][1] == want_stats,
              f"{kind} prefix stats {out[kind, True][1]}, not {want_stats}")
    check(by_pc[True][0] == by_pc[False][0],
          "f32 KV: prefix-cache tokens differ from the engine without it")
    check(by_pc[True][1] == want_stats, "f32 KV: prefix stats differ")
    check(launched == 2 * 3 * cfg.n_layers,
          f"K2b launched {launched} times, not once a layer a hit")
    check(launched_tf == launched,
          f"K2b launched {launched_tf} of {launched} times in the TF32 mode")
    log(f"  ok prefix cache: BatchedEngine and SpecBatchedEngine tokens "
        f"equal on both paths (int8 KV), and to the engine without the "
        f"cache at f32 KV; {want_stats[0]} hits, {want_stats[1]} rows "
        f"reused each; K2b {launched} launches on the int8 kernel paths "
        f"and {f32_launched} at f32 KV, all in the TF32 mode; K1 {wide} "
        f"launches a deferred step, all on the wide ring")

    deferred = {}
    prompts = [system + t for t in tails] + [tails[2]]
    n0 = fd.flash_decode_batched.launches_stats
    for d in (True, False):
        eng = BatchedEngine(cfg, params, tok, ec(True, deferred_kv=d),
                            decode_chunk=16, device=dev)
        deferred[d] = [r.output_tokens for r in eng.generate_all(
            prompts, max_new_tokens=40, temperature=0.0, stop_tokens=())]
        check((eng.deferred_chunks > 0) == d, "deferred chunks: wrong gate")
    n_stats = fd.flash_decode_batched.launches_stats - n0
    check(deferred[True] == deferred[False],
          "deferred tokens differ from plain chunks")
    check(n_stats > 0, "K2 with stats was not launched")
    log(f"  ok deferred KV (decode chunk 16): greedy tokens equal plain "
        f"chunks over {len(prompts)} requests; K2 with stats launched "
        f"{n_stats} times")
    rec["prefix_deferred_parity"] = {
        "max_logit_err": max(errs), "prefix_stats": want_stats,
        "k2b_launches": launched, "k2b_tf32_launches": launched_tf,
        "k2b_f32_kv_tf32_launches": f32_launched,
        "k1_wide_launches_per_step": wide,
        "stats_launches": n_stats, "tokens_equal": True}
    del params
    torch.cuda.empty_cache()


def phase_f32_parity(dev, rec):
    """Phase 3f: unquantized f32 weights (``QuantType.NONE``, from
    ``random_params``) at phase 3's configuration (7B width, 2 layers, f32
    compute): the ``BatchedEngine`` (int8 KV, B=4) with plain chunks and
    with deferred chunks, and the single-stream ``Engine`` (f32 KV), each
    kernel path against the plain path, equal greedy tokens.  Both
    packages route an unquantized matmul to the plain product, so K1 must
    not launch; K2 and K3 must."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.loaders.tokenizer import (
        Tokenizer, build_byte_fallback_vocab)
    from fastllama_tpu_torch.models.llama import random_params_int
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine
    log("phase 3f: f32 weights (QuantType.NONE), kernel path vs plain path "
        "(7B width, 2 layers, f32 compute): BatchedEngine plain and "
        "deferred chunks, Engine")
    cfg = cfg_7b(n_layers=2).replace(quant_type=QuantType.NONE)
    params = random_params_int(cfg, seed=SEED + 6, device=dev)
    check(all(isinstance(getattr(params, n), torch.Tensor)
              and getattr(params, n).dtype == torch.float32
              for n in ("embedding", "wq", "w1", "w2", "classifier")),
          "random_params_int(NONE) did not give f32 tensors")
    rng = torch.Generator(device="cpu")
    rng.manual_seed(SEED + 6)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (43, 17, 60, 5)]
    k1 = ("qmatmul_pallas", "qmatmul_pallas_indexed",
          "qmatmul_pallas_indexed_fused")
    toks, out = {}, {}
    for label, use, deferred in (("plain", False, False),
                                 ("kernel", True, False),
                                 ("deferred", True, True)):
        eng = BatchedEngine(cfg, params, Tokenizer().finalize(),
                            EngineConfig(max_batch_size=4, kv_dtype="int8",
                                         compute_dtype="float32",
                                         use_pallas=use,
                                         deferred_kv=deferred),
                            decode_chunk=8, device=dev)
        zero_launches()
        reqs = eng.generate_all(prompts + prompts[:2], max_new_tokens=20,
                                temperature=0.0, stop_tokens=())
        got = read_launches()
        toks[label] = [r.output_tokens for r in reqs]
        check(all(len(t) == 20 for t in toks[label]), "short output")
        check(all(got[k] == 0 and got[k + "_p4"] == 0 for k in k1),
              f"3f {label}: K1 launched on f32 weights: {got}")
        if use:
            stats = got["flash_decode_batched_stats"]
            check(got["prefill_write"] > 0
                  and (stats > 0 and got["spec_write"] > 0 if deferred
                       else got["flash_decode_batched"] > 0
                       and got["decode_write"] > 0),
                  f"3f {label}: a kernel of the path did not run: {got}")
            check((eng.deferred_chunks > 0) == deferred,
                  f"3f {label}: deferred chunks {eng.deferred_chunks}")
        out[label] = {k: v for k, v in got.items() if v}
        del eng
    for label in ("kernel", "deferred"):
        check(toks[label] == toks["plain"],
              f"3f BatchedEngine {label}: tokens differ from the plain path")
    log(f"  ok BatchedEngine greedy tokens equal, plain / kernel / deferred "
        f"chunks over 6 requests through 4 slots; launches {out}")

    vocab = build_byte_fallback_vocab(
        [f"w{i}" for i in range(cfg.vocab_size - 259)])
    single = {}
    for use in (False, True):
        eng = Engine(cfg, params, vocab, EngineConfig(
            compute_dtype="float32", kv_dtype="float32", use_pallas=use),
            device=dev)
        zero_launches()
        single[use], _ = eng.generate(prompts[0], max_new_tokens=40,
                                      temperature=0.0, stop_tokens=(),
                                      decode_chunk=16)
        got = read_launches()
        check(len(single[use]) == 40, "short single-stream output")
        check(all(got[k] == 0 for k in k1), f"3f Engine: K1 launched {got}")
        if use:
            check(got["flash_decode_single"] > 0,
                  f"3f Engine: K2 non-fresh did not run: {got}")
            out["engine"] = {k: v for k, v in got.items() if v}
        del eng
    check(single[True] == single[False],
          "3f Engine: tokens differ from the plain path")
    log(f"  ok Engine greedy tokens equal over 40 new tokens (chunks of "
        f"16); launches {out['engine']}")
    rec["f32_parity"] = {"tokens_equal": True, "launches": out}
    del params
    torch.cuda.empty_cache()


# -- phase 4: the serving path at full width ---------------------------------

# one entry per Pallas function the port replaces; the kernels of each path
BATCHED_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
                "flash_decode_batched", "flash_decode_batched_split",
                "decode_write", "prefill_write",
                "qmatmul_pallas_pipe", "qmatmul_pallas_indexed_pipe",
                "qmatmul_pallas_indexed_prefill")
SPEC_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
             "flash_spec_batched", "flash_spec_batched_split", "spec_write",
             "prefill_write",
             "qmatmul_pallas_pipe", "qmatmul_pallas_indexed_pipe",
             "qmatmul_pallas_indexed_prefill")
SINGLE_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
               "qmatmul_pallas_indexed_fused", "flash_decode_single",
               "qmatmul_pallas_pipe", "qmatmul_pallas_indexed_fused_pipe")
WIDE_BATCHED_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
                     "flash_decode_batched", "flash_decode_batched_split",
                     "decode_write", "prefill_write",
                     "qmatmul_pallas_wide_pipe",
                     "qmatmul_pallas_indexed_wide_pipe",
                     "qmatmul_pallas_indexed_wide_prefill")
WIDE_SINGLE_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
                    "qmatmul_pallas_indexed_fused", "flash_decode_single",
                    "qmatmul_pallas_wide_pipe",
                    "qmatmul_pallas_indexed_fused_wide_pipe")
INT4_BATCHED_PATH = ("qmatmul_pallas_p4", "qmatmul_pallas_indexed_p4",
                     "flash_decode_batched", "flash_decode_batched_split",
                     "decode_write", "prefill_write",
                     "qmatmul_pallas_pipe", "qmatmul_pallas_indexed_pipe",
                     "qmatmul_pallas_indexed_prefill")
INT4_SINGLE_PATH = ("qmatmul_pallas_p4", "qmatmul_pallas_indexed_p4",
                    "qmatmul_pallas_indexed_fused_p4", "flash_decode_single",
                    "qmatmul_pallas_pipe", "qmatmul_pallas_indexed_fused_pipe")
KERNELS = ("qmatmul_pallas", "qmatmul_pallas_indexed",
           "qmatmul_pallas_indexed_fused", "flash_decode_batched",
           "flash_decode_single", "decode_attention_pallas_indexed",
           "decode_attention_pallas", "decode_write", "prefill_write",
           "flash_spec_batched", "spec_write",
           "decode_attention_pallas_batched", "qmatmul_pallas_p4",
           "qmatmul_pallas_indexed_p4", "qmatmul_pallas_indexed_fused_p4",
           "flash_block_attend", "flash_decode_batched_stats",
           "qmatmul_pallas_groupdot", "qmatmul_pallas_groupdot_p4",
           "flash_decode_single_split", "decode_attention_pallas_indexed_split",
           "decode_attention_pallas_split", "flash_decode_batched_split",
           "decode_attention_pallas_batched_split", "qmatmul_pallas_pipe",
           "qmatmul_pallas_indexed_pipe",
           "qmatmul_pallas_indexed_fused_pipe",
           "qmatmul_pallas_groupdot_pipe", "flash_spec_batched_split",
           "flash_decode_batched_stats_split", "flash_block_attend_tf32",
           "qmatmul_pallas_wide_pipe", "qmatmul_pallas_indexed_wide_pipe",
           "qmatmul_pallas_indexed_fused_wide_pipe", "qmatmul_pallas_prefill",
           "qmatmul_pallas_indexed_prefill",
           "qmatmul_pallas_indexed_fused_prefill",
           "qmatmul_pallas_wide_prefill",
           "qmatmul_pallas_indexed_wide_prefill",
           "qmatmul_pallas_indexed_fused_wide_prefill",
           "qmatmul_pallas_indexed_gs32", "qmatmul_pallas_indexed_fused_gs32",
           "qmatmul_pallas_indexed_gs32_prefill",
           "qmatmul_pallas_indexed_fused_gs32_prefill",
           "qmatmul_pallas_indexed_wide_gs32",
           "qmatmul_pallas_indexed_fused_wide_gs32",
           "qmatmul_pallas_indexed_wide_gs32_prefill",
           "qmatmul_pallas_indexed_fused_wide_gs32_prefill",
           "qmatmul_pallas_indexed_int16",
           "qmatmul_pallas_indexed_fused_int16",
           "qmatmul_pallas_indexed_int16_prefill",
           "qmatmul_pallas_indexed_fused_int16_prefill")
# the wrappers of K2's non-fresh mode: each counts its split-row launches
SPLIT_WRAPPERS = ("flash_decode_single", "decode_attention_pallas_indexed",
                  "decode_attention_pallas", "flash_decode_batched",
                  "decode_attention_pallas_batched")


def counters():
    """(wrapper, count attribute) of each entry of KERNELS: K1p's launches
    are counted on the K1/K1f wrappers' ``launches_p4``, K2's with stats on
    ``flash_decode_batched.launches_stats`` (those in the split mode also
    on ``launches_stats_split``), the groupdot mode's on
    ``qmatmul_pallas.launches_groupdot`` (K1) and ``_groupdot_p4`` (K1p),
    those of them on the pipelined ring also on ``_groupdot_pipe``,
    K2's split-row modes on each K2 wrapper's ``launches_split``
    (``<wrapper>_split``; fresh calls too), K2s's on
    ``flash_spec_batched.launches_split``, the pipelined mode of K1 and
    K1p on each K1 wrapper's ``launches_pipe`` (``<wrapper>_pipe``), their
    prefill mode on its ``launches_prefill`` (``<wrapper>_prefill``), K1's
    wide mode's ring on its ``launches_wide_pipe`` (``_wide_pipe``) and its
    wide prefill kernel on ``launches_wide_prefill`` (``_wide_prefill``),
    K2b's
    TC and split-TF32 modes on ``flash_block_attend.launches_tc`` and
    ``.launches_tf32``."""
    from fastllama_tpu_torch.ops.kernels import attention as at
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.ops.kernels import kv_write as kw
    from fastllama_tpu_torch.ops.kernels import qmm
    k1 = {"qmatmul_pallas": qmm.qmatmul_pallas,
          "qmatmul_pallas_indexed": qmm.qmatmul_pallas_indexed,
          "qmatmul_pallas_indexed_fused": qmm.qmatmul_pallas_indexed_fused}
    rest = {"flash_decode_batched": fd.flash_decode_batched,
            "flash_decode_single": fd.flash_decode_single,
            "decode_attention_pallas_indexed":
                at.decode_attention_pallas_indexed,
            "decode_attention_pallas": at.decode_attention_pallas,
            "decode_write": kw.decode_write,
            "prefill_write": kw.prefill_write,
            "flash_spec_batched": fd.flash_spec_batched,
            "spec_write": kw.spec_write,
            "decode_attention_pallas_batched":
                at.decode_attention_pallas_batched,
            "flash_block_attend": fd.flash_block_attend}
    out = {k: (fn, "launches") for k, fn in {**k1, **rest}.items()}
    out.update({k + "_p4": (fn, "launches_p4") for k, fn in k1.items()})
    out.update({k + "_pipe": (fn, "launches_pipe") for k, fn in k1.items()})
    out.update({k + "_prefill": (fn, "launches_prefill")
                for k, fn in k1.items()})
    out.update({k + "_wide_pipe": (fn, "launches_wide_pipe")
                for k, fn in k1.items()})
    out.update({k + "_wide_prefill": (fn, "launches_wide_prefill")
                for k, fn in k1.items()})
    out["flash_decode_batched_stats"] = (fd.flash_decode_batched,
                                         "launches_stats")
    out["flash_decode_batched_stats_split"] = (fd.flash_decode_batched,
                                               "launches_stats_split")
    out["flash_block_attend_tc"] = (fd.flash_block_attend, "launches_tc")
    out["flash_block_attend_tf32"] = (fd.flash_block_attend,
                                      "launches_tf32")
    out["flash_spec_batched_split"] = (fd.flash_spec_batched,
                                       "launches_split")
    out.update({k + "_split": (rest[k], "launches_split")
                for k in SPLIT_WRAPPERS})
    out["qmatmul_pallas_groupdot"] = (qmm.qmatmul_pallas,
                                      "launches_groupdot")
    out["qmatmul_pallas_groupdot_p4"] = (qmm.qmatmul_pallas,
                                         "launches_groupdot_p4")
    out["qmatmul_pallas_groupdot_pipe"] = (qmm.qmatmul_pallas,
                                           "launches_groupdot_pipe")
    return out


def zero_launches():
    """Every wrapper's counts to 0, just before a path is driven."""
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    torch_sync()


def read_launches():
    torch_sync()
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def torch_sync():
    import torch
    torch.cuda.synchronize()


def profile_decode(eng, prompt, step_ms, n_steps=16):
    """One decode chunk of ``n_steps`` steps for every slot under
    ``torch.profiler``: device time by kernel, and the device's idle share
    of the traced chunk's wall time and of ``step_ms``, the untraced wall
    time of one decode step (tracing slows the host, not the device).
    Admission (prefill) runs before the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    B = eng.B
    for _ in range(B):
        eng.submit(prompt, max_new_tokens=n_steps + 1, temperature=0.0,
                   stop_tokens=())
    eng._admit_pending()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    rows = device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    busy_step_ms = busy_s * 1e3 / n_steps
    out = {"steps": n_steps, "wall_ms": wall * 1e3,
           "device_busy_ms": busy_s * 1e3,
           "device_idle_share_traced": 1.0 - busy_s / wall,
           "device_busy_ms_per_step": busy_step_ms,
           "device_ops_per_step": sum(r[1] for r in rows) / n_steps,
           "device_idle_share": 1.0 - busy_step_ms / step_ms,
           "k1_ms_per_step": k1_rows(rows, n_steps),
           "k2_ms_per_step": k2_rows(rows, n_steps),
           "top_kernels": [{"name": k[:120], "count": c, "device_ms":
                            us / 1e3} for us, c, k in rows[:15]]}
    log(f"  K1 family device ms per step {out['k1_ms_per_step']} of "
        f"{busy_step_ms:.3f}")
    log(f"  K2 device ms per step by kernel (ms, launches) "
        f"{out['k2_ms_per_step']}")
    log(f"  profile: {n_steps} decode steps in {wall * 1e3:.3f} ms wall, "
        f"device busy {busy_s * 1e3:.3f} ms (idle share traced "
        f"{out['device_idle_share_traced']:.3f}); {busy_step_ms:.3f} ms "
        f"device per step against {step_ms:.3f} ms untraced (idle share "
        f"{out['device_idle_share']:.3f}); "
        f"{out['device_ops_per_step']:.1f} device ops per step")
    for r in out["top_kernels"][:8]:
        log(f"    {r['device_ms']:10.3f} ms  x{r['count']:<6} {r['name']}")
    return out


def phase_serving(dev, rec, with_4p=False):
    """Phase 4 (and, ``with_4p``, phase 4p after it on its engine)."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import random_params_int
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    log("phase 4: serving 7B INT8 fused, int8 KV, B=48, S=512, 32 layers")
    cfg = cfg_7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_params_int(cfg, seed=SEED, device=dev)
    eng = BatchedEngine(cfg, params, Tokenizer().finalize(),
                        EngineConfig(max_seq_len=512, max_batch_size=48,
                                     kv_dtype="int8"),
                        decode_chunk=64, device=dev)
    del params
    rec["serving"], launches = serve_batched(eng, BATCHED_PATH, t0)
    # 48 prompts padded to 64 rows: waves of 2048 and 1024 rows, 4
    # projections a layer
    check(launches["qmatmul_pallas_indexed_prefill"] == 256,
          f"batched serving: {launches['qmatmul_pallas_indexed_prefill']} "
          f"prefill launches, not 256")
    if with_4p:
        # 4's seconds hold 4p's
        t1 = time.perf_counter()
        got = phase_pipelined(eng, rec)
        rec["phase_s"]["4p"] = time.perf_counter() - t1
        log(f"  phase 4p took {rec['phase_s']['4p']:.1f} s (on phase 4's "
            f"engine; counted in 4's seconds too)")
        launches = {k: launches[k] + got.get(k, 0) for k in launches}
    del eng
    torch.cuda.empty_cache()
    return launches


# phase 4m's FLM INT8 file: its depth (cut from 32 to keep the whole run
# inside its time limit)
FLM_DEPTH = 16

# phase 4p: a shortened copy of phase 4's traffic at decode chunk 16: 64
# new tokens, one dispatch-ahead stretch of three chunks, then a 15-step
# chunk
PIPE_NEW, PIPE_CHUNK = 64, 16


def phase_pipelined(eng, rec):
    """Phase 4p: phase 4's engine (7B INT8 fused, int8 KV, B=48, S=512,
    32 layers) at decode chunk 16 on a shortened copy of 4's traffic (48
    requests of its 43-token prompt, 64 new tokens, greedy): the
    sequential run and the run under ``FASTLLAMA_PIPELINE=1`` in eight
    balanced turns (s p p s p s s p), tokens equal in every run; each
    run's tok/s and ms a step, split into the host's seconds inside
    ``_dispatch_chunk`` (launching), inside ``_apply_chunk`` (emitting)
    and the rest (waiting on the card, uploads), and each mode's median
    and quartiles; ``pipelined_chunks`` (3 a pipelined run, 0 a
    sequential one), the launches of the first
    pipelined run with the counters zeroed just before (K1 by mode, K2 in
    its split mode).  Then no host sync inside a chunk queued ahead
    (``torch.cuda.set_sync_debug_mode``), and device ms a step traced in
    each mode on this traffic (two 8-step chunks: two steps, and a
    stretch) with the idle share against each mode's untraced ms a
    step."""
    import traceback
    import warnings

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    log(f"phase 4p: phase 4's engine under FASTLLAMA_PIPELINE=1 against its "
        f"sequential run, B=48, {PIPE_NEW} new tokens, decode chunk "
        f"{PIPE_CHUNK}, in turns")
    chunk0 = eng.decode_chunk
    eng.decode_chunk = PIPE_CHUNK
    prompt = list(range(1, 44))
    B = eng.B
    prior = os.environ.get("FASTLLAMA_PIPELINE")
    out = {"card": smi_line(), "runs": []}
    tokens = None
    # host seconds inside the engine's launch and emit methods, by run
    host_s = {}

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host_s[name] += time.perf_counter() - t
        return call

    eng._dispatch_chunk = timed("launch", eng._dispatch_chunk)
    eng._apply_chunk = timed("emit", eng._apply_chunk)
    try:
        for i, pipe in enumerate(("0", "1", "1", "0", "1", "0", "0", "1")):
            os.environ["FASTLLAMA_PIPELINE"] = pipe
            eng.stats = type(eng.stats)()
            eng.pipelined_chunks = 0
            zero_launches()
            host_s.update(launch=0.0, emit=0.0)
            t0 = time.perf_counter()
            with ModeTally() as tally:
                reqs = eng.generate_all([prompt] * B,
                                        max_new_tokens=PIPE_NEW,
                                        temperature=0.0, stop_tokens=())
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if i == 1:                  # the first pipelined run's counts
                launches, counted = read_launches(), tally
            got = [r.output_tokens for r in reqs]
            check(all(len(t) == PIPE_NEW for t in got),
                  f"4p: a request did not get its {PIPE_NEW} tokens")
            if tokens is None:
                tokens = got
            check(got == tokens, f"4p run {len(out['runs'])} "
                                 f"(FASTLLAMA_PIPELINE={pipe}): tokens "
                                 f"differ from the first sequential run's")
            check(eng.pipelined_chunks == (3 if pipe == "1" else 0),
                  f"4p: {eng.pipelined_chunks} chunks dispatched ahead "
                  f"with FASTLLAMA_PIPELINE={pipe}")
            st = eng.stats
            steps = PIPE_NEW - 1
            run = {"pipeline": pipe == "1",
                   "pipelined_chunks": eng.pipelined_chunks,
                   "aggregate_decode_tok_s": st.aggregate_tps,
                   "decode_s": st.decode_s, "wall_s": wall,
                   "ms_per_decode_step": st.decode_s / steps * 1e3,
                   "wall_ms_per_step": wall / steps * 1e3,
                   "launch_ms_per_step": host_s["launch"] / steps * 1e3,
                   "emit_ms_per_step": host_s["emit"] / steps * 1e3}
            run["rest_ms_per_step"] = (run["wall_ms_per_step"]
                                       - run["launch_ms_per_step"]
                                       - run["emit_ms_per_step"])
            out["runs"].append(run)
            log(f"  run {len(out['runs'])} FASTLLAMA_PIPELINE={pipe}: "
                f"{st.aggregate_tps:.2f} tok/s, "
                f"{run['ms_per_decode_step']:.3f} ms a step (wall "
                f"{run['wall_ms_per_step']:.3f}: launching "
                f"{run['launch_ms_per_step']:.3f}, emitting "
                f"{run['emit_ms_per_step']:.3f}, the rest "
                f"{run['rest_ms_per_step']:.3f}), "
                f"{eng.pipelined_chunks} chunks dispatched ahead")
        for mode in (False, True):
            tps = [r["aggregate_decode_tok_s"] for r in out["runs"]
                   if r["pipeline"] == mode]
            q1, med, q3 = np.percentile(tps, [25, 50, 75])
            out["pipelined_tok_s" if mode else "sequential_tok_s"] = {
                "median": med, "q1": q1, "q3": q3}
            log(f"  {'pipelined' if mode else 'sequential'}: median "
                f"{med:.2f} tok/s (quartiles {q1:.2f}, {q3:.2f})")
        check_all_pipe(launches, counted, "4p pipelined")
        check(launches["flash_decode_batched_split"]
              == launches["flash_decode_batched"] > 0,
              f"4p: {launches['flash_decode_batched_split']} of "
              f"{launches['flash_decode_batched']} K2 launches split")
        for k in BATCHED_PATH:
            check(launches[k] > 0, f"4p: kernel {k} was not launched")
        out["launches"] = {k: v for k, v in launches.items() if v}
        out["k1_modes"] = counted.record()

        # no host sync inside a chunk queued ahead: its inputs are device
        # tensors (a synchronizing call raises in the debug mode "error")
        os.environ["FASTLLAMA_PIPELINE"] = "0"
        for _ in range(B):
            eng.submit(prompt, max_new_tokens=PIPE_CHUNK + 1,
                       temperature=0.0, stop_tokens=())
        eng._admit_pending()
        io = eng._device_io()
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # "a prototype"
            torch.cuda.set_sync_debug_mode("error")
        sync = None
        try:
            eng._dispatch_chunk(PIPE_CHUNK, True, io)
        except RuntimeError as e:
            sync = (str(e)[:120], [
                f"{f.filename.split('/')[-1]}:{f.lineno} {f.line}"
                for f in traceback.extract_tb(e.__traceback__)
                if "fastllama_tpu_torch" in f.filename][-3:])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        eng.run()       # the same steps again, from the host's positions
        check(sync is None, f"4p: a chunk queued ahead synchronized with "
                            f"the host: {sync}")
        log("  ok no host sync inside a chunk queued ahead")

        # device ms a step in each mode on this traffic: two 8-step
        # chunks, as two steps and as one stretch
        eng.decode_chunk = 8
        traced = {}
        for mode in ("sequential", "pipelined"):
            for _ in range(B):
                eng.submit(prompt, max_new_tokens=17, temperature=0.0,
                           stop_tokens=())
            eng._admit_pending()
            n0 = eng.pipelined_chunks
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if mode == "pipelined":
                    eng._pipelined_stretch()
                else:
                    eng.step()
                    eng.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = device_rows(prof)
            busy = sum(r[0] for r in rows) / 1e3 / 16
            ran = eng.pipelined_chunks - n0
            check(ran == (2 if mode == "pipelined" else 0)
                  and all(r is None for r in eng.slot_req),
                  f"4p: the traced {mode} chunks did not finish the "
                  f"requests ({ran} dispatched ahead)")
            traced[mode] = {"steps": 16, "device_busy_ms_per_step": busy,
                            "device_ops_per_step":
                                sum(r[1] for r in rows) / 16,
                            "traced_wall_ms": wall_ms,
                            "device_idle_share_traced":
                                1.0 - busy * 16 / wall_ms,
                            "k1_ms_per_step": k1_rows(rows, 16)}
        for mode, t in traced.items():
            ms = [r["ms_per_decode_step"] for r in out["runs"]
                  if r["pipeline"] == (mode == "pipelined")]
            t["device_idle_share"] = (1.0 - t["device_busy_ms_per_step"]
                                      * len(ms) / sum(ms))
            log(f"  {mode}: device {t['device_busy_ms_per_step']:.3f} ms a "
                f"step ({t['device_ops_per_step']:.1f} ops), idle share "
                f"{t['device_idle_share']:.3f} against "
                f"{sum(ms) / len(ms):.3f} ms a step untraced (traced "
                f"{t['device_idle_share_traced']:.3f})")
        out["profile"] = traced
    finally:
        del eng._dispatch_chunk, eng._apply_chunk
        eng.decode_chunk = chunk0
        if prior is None:
            os.environ.pop("FASTLLAMA_PIPELINE", None)
        else:
            os.environ["FASTLLAMA_PIPELINE"] = prior
    rec["pipelined"] = out
    return launches


def serve_batched(eng, path, t0, n_new=128, k1_check=None):
    """bench.py's batched measurement on a ready engine of 48 slots: a
    warm-up wave, then 48 requests of a 43-token prompt and ``n_new``
    tokens with every launch counter zeroed just before; every kernel of
    ``path`` must have run, and K1's modes pass ``k1_check`` (default
    :func:`check_all_pipe`).  Then one 16-step decode chunk traced."""
    import torch
    B = eng.B
    torch.cuda.synchronize()
    log(f"  weights + engine ready in {time.perf_counter() - t0:.2f} s")
    prompt = list(range(1, 44))
    # warm-up: one prefill wave and a short decode chunk
    eng.generate_all([prompt] * B, max_new_tokens=3, temperature=0.0,
                     stop_tokens=())
    eng.stats = type(eng.stats)()

    zero_launches()
    t0 = time.perf_counter()
    with ModeTally() as tally:
        reqs = eng.generate_all([prompt] * B, max_new_tokens=n_new,
                                temperature=0.0, stop_tokens=())
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    (k1_check or check_all_pipe)(launches, tally, "batched serving")
    check(launches["flash_decode_batched_split"]
          == launches["flash_decode_batched"] > 0,
          f"batched serving: {launches['flash_decode_batched_split']} of "
          f"{launches['flash_decode_batched']} K2 launches in the split "
          f"mode")
    check(all(len(r.output_tokens) == n_new and r.done for r in reqs),
          "a request did not get all its tokens")
    for k in path:
        check(launches[k] > 0, f"kernel {k} was not launched on the main "
                               f"path")
    steps = launches["decode_write"]
    st = eng.stats
    out = {
        "requests": len(reqs), "new_tokens_each": n_new,
        "aggregate_decode_tok_s": st.aggregate_tps,
        "decode_s": st.decode_s, "prefill_s": st.prefill_s,
        "decode_steps": steps, "wall_s": wall,
        "ms_per_decode_step": st.decode_s / steps * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "k1_modes": tally.record(),
        "launches_per_decode_step": {
            k: launches[k] / steps for k in path if k != "prefill_write"},
        "card": smi_line(),
    }
    first = reqs[0].output_tokens
    check(all(r.output_tokens == first for r in reqs),
          "identical greedy requests produced different tokens")
    log(f"  aggregate decode {st.aggregate_tps:.2f} tok/s over {B} streams, "
        f"prefill {st.prefill_s:.3f} s, {steps} decode steps "
        f"({out['ms_per_decode_step']:.3f} ms/step), max memory "
        f"{out['max_memory_allocated_gb']:.2f} GB on {out['card']}")
    log(f"  launches {launches}")
    out["profile"] = profile_decode(eng, prompt, out["ms_per_decode_step"])
    return out, launches


def device_rows(prof):
    """(self device us, count, name) of the device-side rows (kernels,
    copies), largest first: an operator's row repeats the time of the
    kernels it launched."""
    from torch.autograd import DeviceType
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def profile_single(eng, prompt, step_ms, n_steps=16):
    """One single-stream decode chunk of ``n_steps`` steps under
    ``torch.profiler``, after an untraced prefill: device time by kernel
    and the device's idle share against ``step_ms``, the untraced wall
    time of one decode step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cache = eng.new_cache()
    logits = eng._prefill(prompt, eng._bucket(len(prompt)), cache, 0)
    tok = torch.argmax(logits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._decode_chunk(cache, tok, len(prompt), n_steps, 0.0, 0.9, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    busy_step_ms = busy_s * 1e3 / n_steps
    # K2 non-fresh by mode: the split-row kernel and the tiled one
    k2 = {mode: [sum(us for us, _, k in rows if name in k) / 1e3 / n_steps,
                 sum(c for _, c, k in rows if name in k) / n_steps]
          for mode, name in (("split", "flash_decode_split_kernel"),
                             ("tiled", "flash_decode_kernel"))}
    out = {"steps": n_steps, "wall_ms": wall * 1e3,
           "device_busy_ms": busy_s * 1e3,
           "device_idle_share_traced": 1.0 - busy_s / wall,
           "device_busy_ms_per_step": busy_step_ms,
           "device_ops_per_step": sum(r[1] for r in rows) / n_steps,
           "device_idle_share": 1.0 - busy_step_ms / step_ms,
           "k2_non_fresh_ms_per_step": k2,
           "k1_ms_per_step": k1_rows(rows, n_steps),
           "top_kernels": [{"name": k[:120], "count": c, "device_ms":
                            us / 1e3} for us, c, k in rows[:15]]}
    log(f"  profile: {n_steps} decode steps in {wall * 1e3:.3f} ms wall, "
        f"device busy {busy_s * 1e3:.3f} ms (idle share traced "
        f"{out['device_idle_share_traced']:.3f}); {busy_step_ms:.3f} ms "
        f"device per step against {step_ms:.3f} ms untraced (idle share "
        f"{out['device_idle_share']:.3f}); "
        f"{out['device_ops_per_step']:.1f} device ops per step")
    log(f"  K1 family device ms per step {out['k1_ms_per_step']} of "
        f"{busy_step_ms:.3f}")
    log(f"  K2 non-fresh device ms per step: split mode "
        f"{k2['split'][0]:.4f} ({k2['split'][1]:.1f} launches), tiled "
        f"{k2['tiled'][0]:.4f} ({k2['tiled'][1]:.1f})")
    for r in out["top_kernels"][:8]:
        log(f"    {r['device_ms']:10.3f} ms  x{r['count']:<6} {r['name']}")
    return out


def check_all_split(launches, names):
    """Every non-fresh K2 launch of a single-stream run in the split-row
    mode: ``<name>_split`` equal to ``<name>`` for each wrapper."""
    for k in names:
        check(launches[k + "_split"] == launches[k],
              f"{k}: {launches[k + '_split']} of {launches[k]} launches in "
              f"the split-row mode")


class ModeTally:
    """Counts each K1/K1p launch of a run by (mode, T <= 128) while it is
    entered, by wrapping ``qmm.qmm_mode`` (which the wrappers consult once
    a launch, on a CUDA tensor only); the wrapped function returns what
    the original returns, so the path is unchanged.  A wide call is
    tallied by its kernel (``qmm.wide_kernel``): ``"wide_pipe"`` the ring,
    ``"wide_prefill"`` its prefill kernel, ``"wide_f32"``
    ``qmm_f32_kernel``; a loop call by its kernel
    (``qmm.prefill_kernel``'s choice): ``"prefill"`` or ``"loop"``."""

    def __enter__(self):
        import collections
        from fastllama_tpu_torch.ops.kernels import qmm
        self.qmm, self.orig = qmm, qmm.qmm_mode
        self.counts = collections.Counter()

        def tally(x, w, compute_dtype=None, groupdot=False, residual=None):
            mode = self.orig(x, w, compute_dtype, groupdot, residual)
            key = ("wide_" + qmm.wide_kernel(x, w, compute_dtype, residual)
                   if mode == "wide" else
                   qmm._loop_kernel(x, w, residual) if mode == "loop"
                   else mode)
            self.counts[(key, x.shape[0] <= qmm.PIPE_MAX_T)] += 1
            return mode
        qmm.qmm_mode = tally
        return self

    def __exit__(self, *exc):
        self.qmm.qmm_mode = self.orig

    def record(self):
        return {f"{m} {'T<=128' if small else 'T>128'}": n
                for (m, small), n in sorted(self.counts.items())}


def check_all_pipe(launches, tally, label):
    """Every K1/K1p launch with T <= 128 of a run in the pipelined mode
    and every one above 128 rows in the prefill mode: no other mode in
    the tally, and the tally's pipelined and prefill launches equal to the
    three wrappers' ``launches_pipe`` and ``launches_prefill``.  Returns
    the prefill launches."""
    small = {m: n for (m, s), n in tally.counts.items() if s}
    large = {m: n for (m, s), n in tally.counts.items() if not s}
    k1 = ("qmatmul_pallas", "qmatmul_pallas_indexed",
          "qmatmul_pallas_indexed_fused")
    pipe = sum(launches[k + "_pipe"] for k in k1)
    prefill = sum(launches[k + "_prefill"] for k in k1)
    check(set(small) <= {"pipe"}, f"{label}: K1/K1p launches with T <= 128 "
                                  f"outside the pipelined mode: {small}")
    check(small.get("pipe", 0) == pipe > 0,
          f"{label}: {small.get('pipe', 0)} pipelined launches in the tally, "
          f"{pipe} on the wrappers' launches_pipe")
    check(set(large) <= {"prefill"}, f"{label}: K1/K1p launches with T > "
                                     f"128 outside the prefill mode: {large}")
    check(large.get("prefill", 0) == prefill,
          f"{label}: {large.get('prefill', 0)} prefill launches in the "
          f"tally, {prefill} on the wrappers' launches_prefill")
    log(f"  ok {label}: all {pipe} K1/K1p launches with T <= 128 in the "
        f"pipelined mode, all {prefill} above in the prefill mode; by mode "
        f"{tally.record()}")
    return prefill


def check_all_wide(launches, tally, label):
    """Every K1 launch of a run at f32 compute in the wide mode's tensor
    core kernels: those with T <= 128 on the ring, those above (prefill
    waves, a long K1f block) on its prefill kernel; no other kernel (none
    on ``qmm_f32_kernel``) in the tally, and the tally's ring and prefill
    launches equal to the three wrappers' ``launches_wide_pipe`` (at least
    one) and ``launches_wide_prefill``.
    Returns the wide prefill launches."""
    small = {m: n for (m, s), n in tally.counts.items() if s}
    large = {m: n for (m, s), n in tally.counts.items() if not s}
    k1 = ("qmatmul_pallas", "qmatmul_pallas_indexed",
          "qmatmul_pallas_indexed_fused")
    ring = sum(launches[k + "_wide_pipe"] for k in k1)
    prefill = sum(launches[k + "_wide_prefill"] for k in k1)
    check(set(small) <= {"wide_pipe"},
          f"{label}: K1 launches with T <= 128 off the wide ring: {small}")
    check(small.get("wide_pipe", 0) == ring and ring > 0,
          f"{label}: {small.get('wide_pipe', 0)} wide ring launches in the "
          f"tally, {ring} on the wrappers' launches_wide_pipe")
    check(set(large) <= {"wide_prefill"},
          f"{label}: K1 launches with T > 128 off the wide prefill kernel: "
          f"{large}")
    check(large.get("wide_prefill", 0) == prefill,
          f"{label}: {large.get('wide_prefill', 0)} wide prefill launches in "
          f"the tally, {prefill} on the wrappers' launches_wide_prefill")
    log(f"  ok {label}: all {ring} K1 launches with T <= 128 on the wide "
        f"ring, all {prefill} above on its prefill kernel; by mode "
        f"{tally.record()}")
    return prefill


def k2_rows(rows, per):
    """Device ms and launches of K2's batched kernels in a profile's rows,
    divided by ``per`` (steps): the fresh and stats split mode and the
    tiled kernel."""
    return {mode: [sum(us for us, _, k in rows if name in k) / 1e3 / per,
                   sum(c for _, c, k in rows if name in k) / per]
            for mode, name in (("split", "flash_decode_fresh_split_kernel"),
                               ("tiled", "flash_decode_kernel"))}


def k1_rows(rows, per):
    """Device ms of the K1 family in a profile's rows, divided by ``per``
    (steps or rounds): the pipelined kernel and its G32 instantiation, the
    loop, the wide mode's ring (and its G32 instantiation), its prefill
    kernel and ``qmm_f32_kernel``, and the split-K reduce pass."""
    return {mode: sum(us for us, _, k in rows if name in k) / 1e3 / per
            for mode, name in (("pipe", "qmm_pipe_kernel"),
                               ("pipe_g32", "qmm_pipe_g32_kernel"),
                               ("loop", "qmm_bf16_kernel"),
                               ("wide_pipe", "qmm_pipe_wide_kernel"),
                               ("wide_pipe_g32", "qmm_pipe_wide_g32_kernel"),
                               ("wide_prefill", "qmm_wgmma_wide_kernel"),
                               ("wide_f32", "qmm_f32_kernel"),
                               ("reduce", "splitk_reduce_kernel"))}


def phase_single_serving(dev, rec):
    """bench.py's single-stream shape on the port: the measured run with
    every launch counter zeroed just before it; then the two other
    wrappers of K2's non-fresh mode, each on a path of its own."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import (KVCache, forward,
                                                  fuse_params,
                                                  random_params_int)
    from fastllama_tpu_torch.ops.kernels import attention as at
    from fastllama_tpu_torch.runtime.engine import Engine
    log("phase 4b: single-stream 7B INT8 fused once, bf16 scales (auto), "
        "bf16 KV, S=512, 32 layers")
    cfg = cfg_7b()
    t0 = time.perf_counter()
    params = fuse_params(cfg, random_params_int(cfg, seed=SEED, device=dev))
    ec = EngineConfig(max_seq_len=512, kv_dtype="bfloat16",
                      fuse_weights=False, scale_dtype="auto")
    eng = Engine(cfg, params, Tokenizer().finalize(), ec, device=dev)
    check(eng.params.wq.scales.dtype == torch.bfloat16,
          "scale_dtype='auto' did not narrow the scales on the kernel path")
    out, launches, toks = serve_single(eng, SINGLE_PATH, t0)
    del eng
    torch.cuda.empty_cache()

    # flash_attention=False: decode_attention_pallas_indexed on the same
    # CUDA kernel, so the tokens are the flash run's, bit for bit
    prompt = list(range(1, 44))
    eng = Engine(cfg, params, Tokenizer().finalize(),
                 dataclasses.replace(ec, flash_attention=False), device=dev)
    zero_launches()
    got, _ = eng.generate(prompt, max_new_tokens=16, temperature=0.0,
                          stop_tokens=(), decode_chunk=64)
    more = read_launches()
    check(more["decode_attention_pallas_indexed"] > 0,
          "decode_attention_pallas_indexed was not launched")
    check(got == toks[:16], f"flash_attention=False tokens {got} differ "
                            f"from {toks[:16]}")
    check_all_split(more, ("decode_attention_pallas_indexed",))
    log(f"  ok flash_attention=False: 16 tokens equal, launches "
        f"{more['decode_attention_pallas_indexed']}, all in the split mode")
    for k in ("decode_attention_pallas_indexed",
              "decode_attention_pallas_indexed_split"):
        launches[k] = more[k]

    # models.llama.forward with the one-layer attention hook (per-layer
    # weight views through K1, decode_attention_pallas on cache[l])
    kb = eng.kernels
    cache = KVCache.create(cfg, dtype=torch.bfloat16, device=dev)
    zero_launches()
    lg, _ = forward(cfg, eng.params, torch.tensor(prompt, device=dev), 0,
                    cache, mm=kb.mm, attn=at.make_attn(),
                    compute_dtype=torch.bfloat16)
    tok = torch.argmax(lg[-1]).reshape(1)
    for p in range(len(prompt), len(prompt) + 8):
        lg, _ = forward(cfg, eng.params, tok, p, cache, mm=kb.mm,
                        attn=at.make_attn(), compute_dtype=torch.bfloat16)
        check(bool(torch.isfinite(lg).all()), "non-finite logits")
        tok = torch.argmax(lg[0]).reshape(1)
    more = read_launches()
    check(more["decode_attention_pallas"] > 0,
          "decode_attention_pallas was not launched")
    check_all_split(more, ("decode_attention_pallas",))
    log(f"  ok forward with the one-layer attention hook: 8 decode steps, "
        f"launches {more['decode_attention_pallas']}, all in the split "
        f"mode")
    for k in ("decode_attention_pallas", "decode_attention_pallas_split"):
        launches[k] = more[k]

    del cache
    key = "qmatmul_pallas_indexed_fused_prefill"
    out["long_block"], launches[key] = feed_block(eng, cfg, check_all_pipe,
                                                  key)
    rec["single_serving"] = out
    del eng, params
    torch.cuda.empty_cache()
    return launches


def feed_block(eng, cfg, k1_check, key):
    """A 200-token block fed to a ``ChatSession`` of ``eng`` after its first
    token, with the counters zeroed just before: a 256-row prefill at pos
    1, whose layer glue runs K1f above 128 rows.  K1's modes must pass
    ``k1_check`` (which returns the launches above 128 rows) and every K1f
    launch of the block (four a layer: QKV and gate|up fused, all four
    glued) be counted on ``key``; the logits finite.  Returns (record, K1f
    launches)."""
    import torch
    from fastllama_tpu_torch.runtime.engine import ChatSession
    sess = ChatSession(eng)
    block = torch.randint(1, cfg.vocab_size, (200,),
                          generator=torch.Generator().manual_seed(SEED + 4),
                          ).tolist()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    with ModeTally() as tally:
        sess.feed(block)
        torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    more = read_launches()
    n = k1_check(more, tally, "a 200-token ChatSession block")
    want = 4 * cfg.n_layers
    check(more[key] == n == want,
          f"the block's K1f launches: {more[key]} on {key} of {n} above 128 "
          f"rows, want {want}")
    check(bool(torch.isfinite(sess._last_logits).all())
          and sess._last_logits.shape == (cfg.vocab_size,),
          "the block's logits are not finite or not (vocab,)")
    log(f"  ok ChatSession block of {len(block)} tokens in {feed_s:.3f} s: "
        f"{n} K1f launches on {key}")
    return {"tokens": len(block), "feed_s": feed_s,
            "k1_modes": tally.record(), "card": smi_line()}, n


def serve_single(eng, path, t0, n_new=128, chunk=64, k1_check=None):
    """bench.py's single-stream measurement (``bench_single``) on a ready
    engine: the 43-token prompt, ``n_new`` greedy tokens in chunks of
    ``chunk``, one warm-up run and one measured run with every launch
    counter zeroed just before; every kernel of ``path`` must have run,
    and K1's modes pass ``k1_check`` (default :func:`check_all_pipe`).
    Then one decode chunk traced.  Returns (record, launches, tokens)."""
    import torch
    torch.cuda.synchronize()
    log(f"  weights + engine ready in {time.perf_counter() - t0:.2f} s")
    prompt = list(range(1, 44))
    kw = dict(max_new_tokens=n_new, temperature=0.0, stop_tokens=(),
              decode_chunk=chunk)
    t0 = time.perf_counter()
    warm, _ = eng.generate(prompt, **kw)
    log(f"  warm-up run {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with ModeTally() as tally:
        toks, st = eng.generate(prompt, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    (k1_check or check_all_pipe)(launches, tally, "single-stream serving")
    check(len(toks) == n_new, f"{len(toks)} tokens, not {n_new}")
    check(toks == warm, "two greedy runs gave different tokens")
    for k in path:
        check(launches[k] > 0, f"kernel {k} was not launched on the "
                               f"single-stream path")
    check_all_split(launches, ("flash_decode_single",))
    steps = launches["flash_decode_single"] // eng.config.n_layers
    out = {
        "prompt_tokens": st.prompt_tokens, "new_tokens": st.output_tokens,
        "decode_tok_s": st.decode_tps, "decode_s": st.decode_s,
        "prefill_s": st.prefill_s, "prefill_tok_s": st.prefill_tps,
        "decode_steps": steps, "wall_s": wall,
        "ms_per_decode_step": st.decode_s / steps * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "k1_modes": tally.record(),
        "launches_per_decode_step": {k: launches[k] / steps for k in path},
        "card": smi_line(),
    }
    log(f"  decode {st.decode_tps:.2f} tok/s ({out['ms_per_decode_step']:.3f}"
        f" ms/step over {steps} steps), prefill {st.prefill_s:.4f} s for "
        f"{st.prompt_tokens} tokens, max memory "
        f"{out['max_memory_allocated_gb']:.2f} GB on {out['card']}")
    log(f"  launches {launches}; all {launches['flash_decode_single']} "
        f"flash_decode_single launches in the split-row mode")
    out["profile"] = profile_single(eng, prompt, out["ms_per_decode_step"])
    return out, launches, toks


def phase_wide_single_serving(dev, rec):
    """Phase 4j: phase 4b's single stream at f32 compute, the configuration
    that gives the reference's full-precision arithmetic: 7B INT8 fused
    once, scale_dtype "auto" (bf16 at INT8 on the single-stream kernel
    path, ``resolve_scale_dtype``), the default f32 KV cache; every K1
    launch with T <= 128 (the 43-row prefill, the K1f glue, the
    classifier) on the wide mode's ring; then 4b's 200-token
    ``ChatSession`` block, every K1f launch of its 256-row prefill on the
    wide mode's prefill kernel."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int)
    from fastllama_tpu_torch.runtime.engine import Engine
    log("phase 4j: single-stream 7B INT8 fused once at f32 compute, bf16 "
        "scales (auto), f32 KV, S=512, 32 layers")
    cfg = cfg_7b()
    t0 = time.perf_counter()
    params = fuse_params(cfg, random_params_int(cfg, seed=SEED, device=dev))
    ec = EngineConfig(max_seq_len=512, fuse_weights=False,
                      compute_dtype="float32")
    eng = Engine(cfg, params, Tokenizer().finalize(), ec, device=dev)
    del params
    check(eng.params.wq.scales.dtype == torch.bfloat16,
          "scale_dtype='auto' did not narrow the scales on the kernel path")
    out, launches, _ = serve_single(eng, WIDE_SINGLE_PATH, t0,
                                    k1_check=check_all_wide)
    key = "qmatmul_pallas_indexed_fused_wide_prefill"
    out["long_block"], launches[key] = feed_block(eng, cfg, check_all_wide,
                                                  key)
    rec["wide_single_serving"] = out
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_wide_serving(dev, rec):
    """Phase 4k: phase 4's batched serving at f32 compute (7B INT8 fused,
    f32 scales, int8 KV, B=48, S=512): every K1 launch with T <= 128 (the
    decode steps at T=48) on the wide mode's ring; every one of the
    prefill waves above 128 rows (256: two waves, 2048 and 1024 rows, 4
    projections a layer) on its prefill kernel, none on
    ``qmm_f32_kernel``, tallied."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import random_params_int
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    log("phase 4k: serving 7B INT8 fused at f32 compute, int8 KV, B=48, "
        "S=512, 32 layers")
    cfg = cfg_7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_params_int(cfg, seed=SEED, device=dev)
    eng = BatchedEngine(cfg, params, Tokenizer().finalize(),
                        EngineConfig(max_seq_len=512, max_batch_size=48,
                                     kv_dtype="int8",
                                     compute_dtype="float32"),
                        decode_chunk=64, device=dev)
    del params
    rec["wide_serving"], launches = serve_batched(
        eng, WIDE_BATCHED_PATH, t0, k1_check=check_all_wide)
    n = launches["qmatmul_pallas_indexed_wide_prefill"]
    check(n == 256, f"batched serving at f32 compute: {n} wide prefill "
                    f"launches, not 256")
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_int16_serving(dev, rec):
    """Phase 4n: INT16 at full depth, 7B / INT16 / 32 layers from
    ``random_params_int`` (13.5 GB of int16 weights, f32 scales: "auto"
    at INT16), QKV and gate|up fused once and shared by two engines at bf16
    compute: phase 4's ``BatchedEngine`` (int8 KV, B=48, S=512, 48
    requests of the 43-token prompt, 128 new tokens, decode chunk 64) and
    phase 4b's ``Engine`` (bf16 KV, S=512, the same prompt, 128 new tokens
    in chunks of 64, then its 200-token ``ChatSession`` block).  Every K1
    launch with T <= 128 on the wide ring's INT16 instantiation and every
    one above on the wide prefill kernel's, none on ``qmm_f32_kernel``
    (:func:`check_all_wide`; the prefill waves' 256 and the block's 128
    K1f launches); tok/s, ms a step, the traced device ms a step and idle
    share, max memory.  Returns the INT16 launches of the kernels line."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int)
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine
    log("phase 4n: serving 7B INT16 fused at 32 layers (bf16 compute, f32 "
        "scales): B=48 int8 KV, then one stream bf16 KV")
    cfg = cfg_7b().replace(quant_type=QuantType.INT16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = fuse_params(cfg, random_params_int(cfg, seed=SEED, device=dev))
    check(params.wq.data.dtype == torch.int16
          and params.wq.scales.dtype == torch.float32,
          "4n: the parameters are not INT16 with f32 scales")
    weights_gb = sum(q.data.numel() * q.data.element_size()
                     for q in params.quantized().values()) / 1e9
    out = rec["int16_serving"] = {"weights_gb": weights_gb}
    log(f"  INT16 weights: {weights_gb:.2f} GB")
    beng = BatchedEngine(cfg, params, Tokenizer().finalize(),
                         EngineConfig(max_seq_len=512, max_batch_size=48,
                                      kv_dtype="int8", fuse_weights=False),
                         decode_chunk=64, device=dev)
    out["batched"], lb = serve_batched(beng, WIDE_BATCHED_PATH, t0,
                                       k1_check=check_all_wide)
    n = lb["qmatmul_pallas_indexed_wide_prefill"]
    check(n == 256, f"4n batched: {n} wide prefill launches, not 256")
    del beng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, Tokenizer().finalize(),
                 EngineConfig(max_seq_len=512, kv_dtype="bfloat16",
                              fuse_weights=False, scale_dtype="auto"),
                 device=dev)
    check(eng.params.wq.scales.dtype == torch.float32,
          "4n: scale_dtype 'auto' at INT16 is not f32")
    out["single"], ls, _ = serve_single(eng, WIDE_SINGLE_PATH, t0,
                                        k1_check=check_all_wide)
    key = "qmatmul_pallas_indexed_fused_wide_prefill"
    out["single"]["long_block"], nb = feed_block(eng, cfg, check_all_wide,
                                                 key)
    out["card"] = smi_line()
    del eng, params
    torch.cuda.empty_cache()
    return {"qmatmul_pallas_indexed_int16":
            lb["qmatmul_pallas_indexed_wide_pipe"],
            "qmatmul_pallas_indexed_int16_prefill": n,
            "qmatmul_pallas_indexed_fused_int16":
            ls["qmatmul_pallas_indexed_fused_wide_pipe"],
            "qmatmul_pallas_indexed_fused_int16_prefill": nb}


def phase_gs32_serving(dev, rec):
    """Phase 4o: INT8 at group size 32 (a GGUF ``Q8_0`` model's) at full
    depth, 7B / 32 layers from ``random_params_int`` at group size 32
    (6.8 GB of int8, 0.8 GB of f32 scales), QKV and gate|up fused once and
    shared by two engines at bf16 compute, with 4m's GGUF engines' scale
    dtypes: phase 4's ``BatchedEngine`` (f32 scales, int8 KV, B=48, S=512,
    48 requests of the 43-token prompt, 128 new tokens, decode chunk 64)
    and phase 4b's ``Engine`` (bf16 scales, "auto"; bf16 KV, S=512, the
    same prompt, 128 new tokens in chunks of 64, then its 200-token
    ``ChatSession`` block).  Every K1 launch with T <= 128 on the ring's
    G32 instantiation and every one above on the prefill mode's, none on
    the loop (:func:`check_all_pipe`; the prefill waves' 256 and the
    block's 128 K1f launches); tok/s, ms a step, the traced device ms a
    step and idle share, max memory.  Returns the gs-32 launches of the
    kernels line."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int)
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine
    log("phase 4o: serving 7B INT8 at group size 32 fused at 32 layers "
        "(bf16 compute): B=48 int8 KV f32 scales, then one stream bf16 KV "
        "bf16 scales")
    cfg = cfg_7b().replace(quant_type=QuantType.INT8, group_size=32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = fuse_params(cfg, random_params_int(cfg, seed=SEED, device=dev))
    check(params.wq.group_size == 32 and qmm.g32(params.wq)
          and params.wq.scales.dtype == torch.float32,
          "4o: the parameters are not INT8 at group size 32, f32 scales")
    weights_gb = sum(q.data.numel() * q.data.element_size()
                     + q.scales.numel() * q.scales.element_size()
                     for q in params.quantized().values()) / 1e9
    out = rec["gs32_serving"] = {"weights_gb": weights_gb}
    log(f"  INT8 gs 32 weights and scales: {weights_gb:.2f} GB")
    beng = BatchedEngine(cfg, params, Tokenizer().finalize(),
                         EngineConfig(max_seq_len=512, max_batch_size=48,
                                      kv_dtype="int8", fuse_weights=False),
                         decode_chunk=64, device=dev)
    out["batched"], lb = serve_batched(beng, BATCHED_PATH, t0)
    n = lb["qmatmul_pallas_indexed_prefill"]
    check(n == 256, f"4o batched: {n} prefill launches, not 256")
    del beng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = Engine(cfg, params, Tokenizer().finalize(),
                 EngineConfig(max_seq_len=512, kv_dtype="bfloat16",
                              fuse_weights=False, scale_dtype="auto"),
                 device=dev)
    check(eng.params.wq.scales.dtype == torch.bfloat16,
          "4o: scale_dtype 'auto' at INT8 is not bf16")
    out["single"], ls, _ = serve_single(eng, SINGLE_PATH, t0)
    key = "qmatmul_pallas_indexed_fused_prefill"
    out["single"]["long_block"], nb = feed_block(eng, cfg, check_all_pipe,
                                                 key)
    out["card"] = smi_line()
    del eng, params
    torch.cuda.empty_cache()
    return {"qmatmul_pallas_indexed_gs32": lb["qmatmul_pallas_indexed_pipe"],
            "qmatmul_pallas_indexed_gs32_prefill": n,
            "qmatmul_pallas_indexed_fused_gs32":
            ls["qmatmul_pallas_indexed_fused_pipe"],
            "qmatmul_pallas_indexed_fused_gs32_prefill": nb}


# the INT4 parameter set of phases 4d and 4e: made once and shared, as
# bench.py shares one fused set between its engines (bench.py:257-268)
_INT4 = {}


def int4_params(dev):
    import torch
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int)
    if "params" not in _INT4:
        cfg = cfg_7b_int4()
        params = fuse_params(cfg, random_params_int(cfg, seed=SEED,
                                                    device=dev))
        check(all(w.packed for n, w in params.quantized().items()
                  if n != "embedding"), "an INT4 projection did not pack")
        check(params.wq.scales.dtype == torch.float32, "INT4 scales not f32")
        _INT4["params"] = params
    return _INT4["params"]


def phase_int4_serving(dev, rec):
    """Phase 4d: bench.py's INT4 batched measurement (BENCH_QUANT=int4):
    7B with hidden_dim 11264, every projection packed, QKV and gate|up
    fused once, f32 scales, int8 KV, B=48, S=512, 32 layers, served as
    phase 4.  K1p's indexed and plain forms must both have run."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    log("phase 4d: serving 7B INT4 packed (hidden 11264), fused once, f32 "
        "scales, int8 KV, B=48, S=512, 32 layers")
    cfg = cfg_7b_int4()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = BatchedEngine(cfg, int4_params(dev), Tokenizer().finalize(),
                        EngineConfig(max_seq_len=512, max_batch_size=48,
                                     kv_dtype="int8", fuse_weights=False),
                        decode_chunk=64, device=dev)
    rec["int4_serving"], launches = serve_batched(eng, INT4_BATCHED_PATH, t0)
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_int4_single_serving(dev, rec):
    """Phase 4e: bench.py's INT4 single-stream measurement on the same
    parameter set as 4d (the batched engine is freed first): bf16 KV,
    scale_dtype "auto" (f32 at INT4), S=512, as phase 4b.  K1p's fused
    form carries the layer glue; its plain form serves the classifier."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.runtime.engine import Engine
    log("phase 4e: single-stream 7B INT4 packed (hidden 11264), fused once, "
        "f32 scales (auto), bf16 KV, S=512, 32 layers")
    cfg = cfg_7b_int4()
    t0 = time.perf_counter()
    eng = Engine(cfg, int4_params(dev), Tokenizer().finalize(),
                 EngineConfig(max_seq_len=512, kv_dtype="bfloat16",
                              fuse_weights=False, scale_dtype="auto"),
                 device=dev)
    _INT4.clear()
    check(eng.params.wq.scales.dtype == torch.float32,
          "scale_dtype='auto' did not keep f32 scales at INT4")
    rec["int4_single_serving"], launches, _ = serve_single(
        eng, INT4_SINGLE_PATH, t0)
    del eng
    torch.cuda.empty_cache()
    return launches


def profile_spec(eng, prompt, rounds=8):
    """Speculative chunks of ``rounds`` rounds for every slot, the tuner set
    aside so that each is a spec chunk at the engine's width: one admits
    the requests, the next is timed untraced, the third is traced with
    ``torch.profiler`` (fewer rounds than a serving chunk keep the trace
    short; a round's work does not depend on the chunk's length).  Device
    time by kernel per round, and the device's idle share of the traced
    chunk and against the untraced one.  The requests ask for more tokens
    than three chunks can give, so every slot stays live throughout; the
    engine is discarded afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng._tuner, eng.R = None, rounds
    for _ in range(eng.B):
        eng.submit(prompt, max_new_tokens=eng.S - len(prompt) - 8,
                   temperature=0.0, stop_tokens=())
    eng.step()
    torch.cuda.synchronize()
    n0 = eng.arm_chunks[eng.width]
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(eng.arm_chunks[eng.width] == n0 + 2
          and len(eng._live_slots()) == eng.B,
          "the profiled chunks were not full speculative chunks")
    rows = device_rows(prof)
    R = rounds
    busy_s = sum(r[0] for r in rows) / 1e6
    out = {"rounds": R, "width": eng.width, "wall_ms": wall * 1e3,
           "untraced_wall_ms": untraced * 1e3,
           "device_busy_ms": busy_s * 1e3,
           "device_busy_ms_per_round": busy_s * 1e3 / R,
           "device_idle_share_traced": 1.0 - busy_s / wall,
           "device_idle_share": 1.0 - busy_s / untraced,
           "k1_ms_per_round": k1_rows(rows, R),
           "top_kernels_per_round": [
               {"name": k[:120], "count_per_round": c / R,
                "device_ms_per_round": us / 1e3 / R}
               for us, c, k in rows[:15]]}
    log(f"  profile: a spec chunk of {R} rounds at width {eng.width}: "
        f"{wall * 1e3:.3f} ms wall traced, {untraced * 1e3:.3f} ms untraced;"
        f" device busy {busy_s * 1e3:.3f} ms "
        f"({out['device_busy_ms_per_round']:.4f} ms a round), idle share "
        f"{out['device_idle_share']:.3f} untraced, "
        f"{out['device_idle_share_traced']:.3f} traced")
    log(f"  K1 family device ms a round {out['k1_ms_per_round']} of "
        f"{out['device_busy_ms_per_round']:.4f}")
    for r in out["top_kernels_per_round"][:10]:
        log(f"    {r['device_ms_per_round']:9.4f} ms/round  "
            f"x{r['count_per_round']:<7.1f} {r['name']}")
    return out


def phase_spec_serving(dev, rec):
    """bench.py's ``bench_spec_serving`` shape (bench.py:139-182, :309-312),
    nothing cut: SpecBatchedEngine over 7B INT8 unfused weights,
    scale_dtype "auto" (f32 scales: the batched rule), int8 KV, B=32,
    S=512, width 4, 32 rounds a chunk,
    decode chunk 64, the tuner on; 32 requests of the repetitive 43-token
    prompt, 129 new tokens each, greedy.  One warm-up pass, then the
    measured pass with every launch counter zeroed just before; then the
    same traffic through the plain BatchedEngine (unfused, B=32) for
    scale; then one spec chunk traced."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import random_params_int
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
    log("phase 4c: speculative serving 7B INT8 unfused, scale_dtype auto "
        "(f32 for a batched engine), int8 KV, B=32, S=512, width 4, 32 "
        "rounds a chunk, tuner on")
    cfg = cfg_7b()
    B, n_new = 32, 129
    prompt = ([7, 121, 3088, 59] * 11)[:43]
    ec = EngineConfig(max_seq_len=512, kv_dtype="int8", max_batch_size=B,
                      fuse_weights=False, scale_dtype="auto")
    t0 = time.perf_counter()
    params = random_params_int(cfg, seed=SEED, device=dev)
    eng = SpecBatchedEngine(cfg, params, Tokenizer().finalize(), ec,
                            decode_chunk=64, width=4, rounds_per_chunk=32,
                            device=dev)
    check(eng.params.wk is not None, "the weights were fused")
    torch.cuda.synchronize()
    # the peak of serving, not of making the weights
    torch.cuda.reset_peak_memory_stats()
    log(f"  weights + engine ready in {time.perf_counter() - t0:.2f} s")

    def serve(e):
        reqs = e.generate_all([prompt] * B, max_new_tokens=n_new,
                              temperature=0.0, stop_tokens=())
        torch.cuda.synchronize()
        check(all(len(r.output_tokens) == n_new and r.done for r in reqs),
              "a request did not get all its tokens")
        return reqs

    t0 = time.perf_counter()
    serve(eng)
    log(f"  warm-up pass {time.perf_counter() - t0:.2f} s, chunks by arm "
        f"{dict(eng.arm_chunks)}")
    eng.stats = type(eng.stats)()
    eng.spec_drafted = eng.spec_accepted = 0
    eng.arm_chunks.clear()

    zero_launches()
    t0 = time.perf_counter()
    with ModeTally() as tally:
        reqs = serve(eng)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_all_pipe(launches, tally, "speculative serving")
    check(launches["flash_spec_batched_split"]
          == launches["flash_spec_batched"],
          f"K2s: {launches['flash_spec_batched_split']} of "
          f"{launches['flash_spec_batched']} launches in the split-row mode")
    for k in SPEC_PATH:
        check(launches[k] > 0, f"kernel {k} was not launched on the "
                               f"speculative path")
    # bf16 compute: tokens are compared within one pass only (the passes
    # mix chunk kinds as the tuner measures, and bf16 argmax ties flip
    # between the verify and the decode step; phase 3c compares at f32)
    check(all(r.output_tokens == reqs[0].output_tokens for r in reqs),
          "identical greedy requests produced different tokens")
    st = eng.stats
    rounds = launches["spec_write"]
    out = {
        "requests": B, "new_tokens_each": n_new,
        "aggregate_decode_tok_s": st.aggregate_tps,
        "acceptance": eng.acceptance, "spec_drafted": eng.spec_drafted,
        "spec_accepted": eng.spec_accepted,
        "chunks_by_arm": {str(k): v for k, v in eng.arm_chunks.items()},
        "tuner_ema_tok_s": {str(k): v for k, v in eng._tuner.ema.items()},
        "spec_rounds": rounds, "decode_s": st.decode_s,
        "prefill_s": st.prefill_s, "wall_s": wall,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "k1_modes": tally.record(),
        "launches_per_spec_round": {
            k: launches[k] / rounds for k in ("flash_spec_batched",
                                              "flash_spec_batched_split",
                                              "spec_write")},
        "card": smi_line(),
    }
    log(f"  aggregate decode {st.aggregate_tps:.2f} tok/s over {B} streams, "
        f"acceptance {eng.acceptance:.4f} ({eng.spec_accepted} of "
        f"{eng.spec_drafted}), chunks by arm {dict(eng.arm_chunks)}, "
        f"{rounds} spec rounds, prefill {st.prefill_s:.3f} s, max memory "
        f"{out['max_memory_allocated_gb']:.2f} GB on {out['card']}")
    log(f"  tuner EMA tok/s by arm {out['tuner_ema_tok_s']}")
    log(f"  launches {launches}")
    log(f"  measured pass {wall:.2f} s")

    # the same traffic through the plain engine, for scale, before any
    # trace
    t0 = time.perf_counter()
    plain = BatchedEngine(cfg, params, Tokenizer().finalize(), ec,
                          decode_chunk=64, device=dev)
    plain.generate_all([prompt] * B, max_new_tokens=3, temperature=0.0,
                       stop_tokens=())
    plain.stats = type(plain.stats)()
    serve(plain)
    steps = n_new - 1
    out["plain_engine"] = {"aggregate_decode_tok_s":
                           plain.stats.aggregate_tps,
                           "decode_s": plain.stats.decode_s,
                           "ms_per_decode_step":
                               plain.stats.decode_s / steps * 1e3}
    log(f"  plain BatchedEngine on the same traffic: "
        f"{plain.stats.aggregate_tps:.2f} tok/s "
        f"({out['plain_engine']['ms_per_decode_step']:.3f} ms a step), "
        f"{time.perf_counter() - t0:.2f} s")
    del plain
    t0 = time.perf_counter()
    out["profile"] = profile_spec(eng, prompt)
    log(f"  profile {time.perf_counter() - t0:.2f} s")
    rec["spec_serving"] = out
    del eng, params
    torch.cuda.empty_cache()
    return launches


SINGLE_SPEC_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed_fused",
                    "qmatmul_pallas_pipe",
                    "qmatmul_pallas_indexed_fused_pipe")


def profile_spec_single(spec, prompt, rounds=8):
    """Two chunks of ``rounds`` greedy rounds of a ``SpeculativeEngine``
    after its prefill: the first timed untraced, the second traced with
    ``torch.profiler``.  Device time by kernel per round, and the device's
    idle share of the traced chunk and against the untraced one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    st, _, gen = spec._start(prompt, 0.0, 0.9, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec._chunk(st, rounds, False, 0.0, 0.9, gen)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        spec._chunk(st, rounds, False, 0.0, 0.9, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    R = rounds
    out = {"rounds": R, "width": spec.width, "wall_ms": wall * 1e3,
           "untraced_wall_ms": untraced * 1e3,
           "device_busy_ms": busy_s * 1e3,
           "device_busy_ms_per_round": busy_s * 1e3 / R,
           "device_ops_per_round": sum(r[1] for r in rows) / R,
           "device_idle_share_traced": 1.0 - busy_s / wall,
           "device_idle_share": 1.0 - busy_s / untraced,
           "k1_ms_per_round": k1_rows(rows, R),
           "top_kernels_per_round": [
               {"name": k[:120], "count_per_round": c / R,
                "device_ms_per_round": us / 1e3 / R}
               for us, c, k in rows[:15]]}
    log(f"  profile: {R} rounds at width {spec.width}: {wall * 1e3:.3f} ms "
        f"wall traced, {untraced * 1e3:.3f} ms untraced; device busy "
        f"{busy_s * 1e3:.3f} ms ({out['device_busy_ms_per_round']:.4f} ms "
        f"a round, {out['device_ops_per_round']:.1f} device ops a round), "
        f"idle share {out['device_idle_share']:.3f} untraced, "
        f"{out['device_idle_share_traced']:.3f} traced")
    log(f"  K1 family device ms a round {out['k1_ms_per_round']}")
    for r in out["top_kernels_per_round"][:8]:
        log(f"    {r['device_ms_per_round']:9.4f} ms/round  "
            f"x{r['count_per_round']:<7.1f} {r['name']}")
    return out


def phase_single_spec_serving(dev, rec):
    """Phase 4l: single-stream speculative serving on phase 4b's engine
    (7B INT8, QKV and gate|up fused once, bf16 scales "auto", bf16 KV,
    S=512, 32 layers), 128 new greedy tokens, width 8, 8 rounds a call:
    the n-gram drafter on ``tools/spec_bench.py``'s loop prompt and on
    4b's ``list(range(1, 44))``, then a ``truncate_params(cfg, params,
    4)`` draft (fused, the same engine config) on 4b's prompt.  Each
    beside ``Engine.generate`` on its prompt in this call; a short warm-up
    of each, then the measured run with the counters zeroed just before:
    every K1/K1p launch with T <= 128 (the verify's T = 8, the draft's
    T = 1) on the pipelined ring, every K2 non-fresh launch split; the
    tokens held to plain greedy by ``same_greedy``'s tie rule (bf16
    compute: the verify's 8 rows and a decode step round differently),
    the referee the kernel path at f32 compute.  Then one chunk of each
    traced (after every timing)."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import (fuse_params,
                                                  random_params_int,
                                                  truncate_params)
    from fastllama_tpu_torch.runtime.engine import Engine
    from fastllama_tpu_torch.runtime.speculative import SpeculativeEngine
    log("phase 4l: single-stream speculative serving, 7B INT8 fused once, "
        "bf16 scales (auto), bf16 KV, S=512, 32 layers, width 8")
    cfg = cfg_7b()
    n_new, width = 128, 8
    t0 = time.perf_counter()
    unfused = random_params_int(cfg, seed=SEED, device=dev)
    cfg_d, draft_p = truncate_params(cfg, unfused, 4)
    params = fuse_params(cfg, unfused)
    del unfused
    ec = EngineConfig(max_seq_len=512, kv_dtype="bfloat16",
                      fuse_weights=False, scale_dtype="auto")
    eng = Engine(cfg, params, Tokenizer().finalize(), ec, device=dev)
    draft = Engine(cfg_d, fuse_params(cfg_d, draft_p),
                   Tokenizer().finalize(), ec, device=dev)
    del params, draft_p
    torch.cuda.synchronize()
    log(f"  weights + engines ready in {time.perf_counter() - t0:.2f} s")
    referee = plain_logits(dev, cfg, eng.params, use_pallas=True)
    loop = ([7, 121, 3088, 59] * 11)[:43]
    rng_prompt = list(range(1, 44))
    kw = dict(max_new_tokens=n_new, temperature=0.0, stop_tokens=())

    plain = {}
    for name, prompt in (("loop", loop), ("range", rng_prompt)):
        eng.generate(prompt, max_new_tokens=16, temperature=0.0,
                     stop_tokens=(), decode_chunk=64)
        toks, st = eng.generate(prompt, decode_chunk=64, **kw)
        torch.cuda.synchronize()
        check(len(toks) == n_new, f"4l plain {name}: {len(toks)} tokens")
        plain[name] = (toks, {"decode_tok_s": st.decode_tps,
                              "decode_s": st.decode_s})
        log(f"  plain Engine.generate, {name} prompt: {st.decode_tps:.2f} "
            f"tok/s")

    runs = (("n-gram, loop prompt", None, "loop", loop),
            ("n-gram, range prompt", None, "range", rng_prompt),
            ("truncate_params 4 layers, range prompt", draft, "range",
             rng_prompt))
    out, all_launches, specs = {}, {}, []
    for label, d, pname, prompt in runs:
        spec = SpeculativeEngine(eng, d, width=width, rounds_per_call=8)
        spec.generate(prompt, max_new_tokens=16, stop_tokens=())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        with ModeTally() as tally:
            toks, st = spec.generate(prompt, **kw)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(len(toks) == n_new, f"4l {label}: {len(toks)} tokens")
        check_all_pipe(launches, tally, f"4l {label}")
        check_all_split(launches, ("flash_decode_single",))
        path = SINGLE_SPEC_PATH + (("flash_decode_single",
                                    "flash_decode_single_split")
                                   if d is not None else ())
        for k in path:
            check(launches[k] > 0, f"4l {label}: kernel {k} was not "
                                   f"launched")
        ties = same_greedy(f"4l {label}", [toks], [plain[pname][0]],
                           [prompt], referee, tie_tol=TOL_BF16)
        r = {"decode_tok_s": st.decode_tps, "decode_s": st.decode_s,
             "prefill_s": st.prefill_s, "wall_s": wall,
             "plain_decode_tok_s": plain[pname][1]["decode_tok_s"],
             "speedup": st.decode_tps / plain[pname][1]["decode_tok_s"],
             "rounds": st.rounds, "drafted": st.drafted,
             "accepted": st.accepted, "acceptance": st.acceptance,
             "tokens_a_round": n_new / st.rounds, "ties": ties,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9,
             "launches": {k: v for k, v in launches.items() if v},
             "launches_per_round": {k: launches[k] / st.rounds
                                    for k in path},
             "k1_modes": tally.record(), "card": smi_line()}
        out[label] = r
        for k, v in launches.items():
            all_launches[k] = all_launches.get(k, 0) + v
        specs.append((label, spec, prompt))
        log(f"  {label}: {st.decode_tps:.2f} tok/s against plain "
            f"{r['plain_decode_tok_s']:.2f} ({r['speedup']:.3f}x); "
            f"acceptance {st.acceptance:.4f}, {st.rounds} rounds "
            f"({r['tokens_a_round']:.2f} tokens a round), {ties} parted at "
            f"a tie; max memory {r['max_memory_allocated_gb']:.2f} GB on "
            f"{r['card']}")
        log(f"  launches a round {r['launches_per_round']}; K1 by mode "
            f"{r['k1_modes']}")
    for label, spec, prompt in specs:
        log(f"  trace: {label}")
        out[label]["profile"] = profile_spec_single(spec, prompt, rounds=4)
    out["plain"] = {k: v[1] for k, v in plain.items()}
    rec["single_spec_serving"] = out
    del eng, draft, specs, spec
    torch.cuda.empty_cache()
    return all_launches


PREFIX_PATH = BATCHED_PATH + ("flash_block_attend",)
PREFIX_F32_PATH = PREFIX_PATH + ("flash_block_attend_tf32",)
DEFERRED_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
                 "flash_decode_batched_stats",
                 "flash_decode_batched_stats_split", "spec_write",
                 "prefill_write", "qmatmul_pallas_indexed_prefill")


def phase_prefix_serving(dev, rec):
    """Phase 4f: prefix-cache serving at full width — phase 4's engine
    (7B INT8, QKV and gate|up fused, int8 KV, B=48, S=512, 32 layers) with
    ``prefix_cache``.  Traffic: a donor request of a 256-token system
    prompt and a 24-token tail, one ``step()``; then 47 requests of the
    same system prompt and distinct 8-40-token tails (buckets 32 and 64)
    drawn from SEED; 128 new tokens each, greedy, decode chunk 64.  The
    counters are zeroed just before the donor is submitted; every request
    after the donor must be a hit reusing 256 rows, with K2b launched once
    a layer a hit, every launch in its TC mode.  Then the same traffic
    without the prefix cache, for scale.  TTFT is each hit's (submit to
    first token; the 47 are submitted together and admitted one tail call
    after another)."""
    return serve_prefix(dev, rec, "int8")


def phase_prefix_f32_serving(dev, rec):
    """Phase 4i: phase 4f at the default f32 KV cache of both packages
    (``EngineConfig.kv_dtype = "float32"``): the same engine, traffic and
    checks, but every K2b launch (bf16 q over the f32 cache) in its
    split-TF32 mode, and every kernel of ``PREFIX_F32_PATH`` launched."""
    return serve_prefix(dev, rec, "float32")


def serve_prefix(dev, rec, kv):
    """Phases 4f and 4i on a ``kv`` ("int8" or "float32") KV cache; every
    K2 launch must be in its split-row mode."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import random_params_int
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    label, mode, path = {"int8": ("4f", "tc", PREFIX_PATH),
                         "float32": ("4i", "tf32", PREFIX_F32_PATH)}[kv]
    log(f"phase {label}: prefix-cache serving 7B INT8 fused, {kv} KV, B=48, "
        f"S=512, 32 layers: a 256-token system prompt shared by 48 "
        f"requests")
    cfg = cfg_7b()
    B, n_new, plen = 48, 128, 256
    rng = torch.Generator(device="cpu")
    rng.manual_seed(SEED + 13)
    system = torch.randint(1, cfg.vocab_size, (plen,), generator=rng).tolist()
    donor = system + torch.randint(1, cfg.vocab_size, (24,),
                                   generator=rng).tolist()
    lens = torch.randint(8, 41, (B - 1,), generator=rng).tolist()
    tails = [torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
             for n in lens]
    check(len({tuple(t[:8]) for t in tails}) == B - 1, "tails not distinct")
    t0 = time.perf_counter()
    params = random_params_int(cfg, seed=SEED, device=dev)
    log(f"  weights ready in {time.perf_counter() - t0:.2f} s")
    out, launches = {}, None
    for pc in (True, False):
        eng = BatchedEngine(cfg, params, Tokenizer().finalize(),
                            EngineConfig(max_seq_len=512, max_batch_size=B,
                                         kv_dtype=kv, prefix_cache=pc),
                            decode_chunk=64, device=dev)
        # warm-up: a donor and two hits, a few tokens each
        eng.submit(donor, max_new_tokens=70, temperature=0.0, stop_tokens=())
        eng.step()
        eng.generate_all([system + t for t in tails[:2]], max_new_tokens=3,
                         temperature=0.0, stop_tokens=())
        eng.stats = type(eng.stats)()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        zero_launches()
        t0 = time.perf_counter()
        with ModeTally() as tally:
            first = eng.submit(donor, max_new_tokens=n_new,
                               temperature=0.0, stop_tokens=())
            eng.step()
            hits = [eng.submit(system + t, max_new_tokens=n_new,
                               temperature=0.0, stop_tokens=())
                    for t in tails]
            eng.run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        n_prefill = check_all_pipe(got, tally, f"prefix_cache={pc}")
        check(all(len(r.output_tokens) == n_new and r.done
                  for r in [first] + hits),
              "a request did not get all its tokens")
        st = eng.stats
        ttft = [r.ttft for r in hits]
        res = {
            "aggregate_decode_tok_s": st.aggregate_tps,
            "ttft_mean_s": sum(ttft) / len(ttft), "ttft_max_s": max(ttft),
            "prefill_s": st.prefill_s, "decode_s": st.decode_s,
            "wall_s": wall, "prefix_hits": st.prefix_hits,
            "prefix_rows_reused": st.prefix_rows_reused,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": got, "k1_modes": tally.record(),
            "prefill_launches": n_prefill, "card": smi_line()}
        if pc:
            check(st.prefix_hits == B - 1
                  and st.prefix_rows_reused == (B - 1) * plen,
                  f"prefix stats {st.prefix_hits} hits, "
                  f"{st.prefix_rows_reused} rows; want {B - 1} and "
                  f"{(B - 1) * plen}")
            check(got["flash_block_attend"] == (B - 1) * cfg.n_layers,
                  f"K2b launched {got['flash_block_attend']} times, not "
                  f"{cfg.n_layers} a hit")
            check(got[f"flash_block_attend_{mode}"]
                  == got["flash_block_attend"],
                  f"K2b launched {got[f'flash_block_attend_{mode}']} times "
                  f"in the {mode} mode, not all {got['flash_block_attend']}")
            check(got["flash_decode_batched_split"]
                  == got["flash_decode_batched"],
                  f"{got['flash_decode_batched_split']} of "
                  f"{got['flash_decode_batched']} K2 launches in the split "
                  f"mode")
            for k in path:
                check(got[k] > 0, f"kernel {k} was not launched on the "
                                  f"prefix-cache path")
            launches = got
            tokens_pc = [r.output_tokens for r in hits]
        else:
            check(st.prefix_hits == 0, "hits without the prefix cache")
            # at bf16 a hit's tail and a whole prefill round differently
            # (and at int8 KV the tail attends the prefix rows as quantized
            # in the cache, a whole prefill its own rows), so the tokens
            # part; how soon is recorded (phase 3e compares at f32)
            common = [next((i for i, (x, y) in enumerate(
                zip(a, r.output_tokens)) if x != y), n_new)
                for a, r in zip(tokens_pc, hits)]
            res["hit_first_token_equal_share"] = sum(
                c > 0 for c in common) / (B - 1)
            res["hit_common_prefix_mean"] = sum(common) / (B - 1)
        out["prefix_cache" if pc else "no_prefix_cache"] = res
        log(f"  prefix_cache={pc}: {st.prefix_hits} hits "
            f"({st.prefix_rows_reused} rows reused), TTFT of the 47 mean "
            f"{res['ttft_mean_s'] * 1e3:.3f} ms max "
            f"{res['ttft_max_s'] * 1e3:.3f} ms, prefill {st.prefill_s:.3f} "
            f"s, aggregate decode {st.aggregate_tps:.2f} tok/s, max memory "
            f"{res['max_memory_allocated_gb']:.2f} GB, wall {wall:.2f} s on "
            f"{res['card']}")
        del eng
        torch.cuda.empty_cache()
    log(f"  launches with the prefix cache {launches}")
    nc = out["no_prefix_cache"]
    log(f"  hits against whole prefills: first token equal in "
        f"{nc['hit_first_token_equal_share']:.3f} of 47, tokens equal for "
        f"{nc['hit_common_prefix_mean']:.2f} steps on average")
    rec["prefix_serving" if kv == "int8" else "prefix_serving_f32"] = out
    del params
    torch.cuda.empty_cache()
    return launches


# 4g's depth: cut from 32 to keep the whole run inside its time limit
# (the deferred and plain passes compare within the phase)
DEFERRED_LAYERS = 16


def phase_deferred_serving(dev, rec):
    """Phase 4g: deferred KV at full width, ``DEFERRED_LAYERS`` deep —
    phase 4's engine and traffic (48 requests of ``list(range(1, 44))``,
    128 new tokens, greedy) at decode chunk 16, where every chunk runs
    deferred (2 <= K <= 32), and the same engine with plain chunks, in
    turns plain, deferred, deferred, plain.  The counters are zeroed just
    before each measured pass."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import random_params_int
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    log("phase 4g: deferred KV serving 7B INT8 fused, int8 KV, B=48, S=512, "
        f"{DEFERRED_LAYERS} layers, decode chunk 16, against plain chunks")
    cfg = cfg_7b(DEFERRED_LAYERS)
    B, n_new = 48, 128
    prompt = list(range(1, 44))
    params = random_params_int(cfg, seed=SEED, device=dev)
    engs = {d: BatchedEngine(cfg, params, Tokenizer().finalize(),
                             EngineConfig(max_seq_len=512, max_batch_size=B,
                                          kv_dtype="int8", deferred_kv=d),
                             decode_chunk=16, device=dev)
            for d in (False, True)}
    del params
    for eng in engs.values():           # warm-up
        eng.generate_all([prompt] * B, max_new_tokens=20, temperature=0.0,
                         stop_tokens=())
    runs, launches, tokens = [], None, {}
    for d in (False, True, True, False):
        eng = engs[d]
        eng.stats = type(eng.stats)()
        eng.deferred_chunks = 0
        zero_launches()
        with ModeTally() as tally:
            reqs = eng.generate_all([prompt] * B, max_new_tokens=n_new,
                                    temperature=0.0, stop_tokens=())
        got = read_launches()
        check_all_pipe(got, tally, f"deferred={d} serving")
        check(all(len(r.output_tokens) == n_new for r in reqs),
              "a request did not get all its tokens")
        check(all(r.output_tokens == reqs[0].output_tokens for r in reqs),
              "identical greedy requests produced different tokens")
        st = eng.stats
        steps = (got["flash_decode_batched_stats"] if d
                 else got["flash_decode_batched"]) // cfg.n_layers
        if d:
            check(eng.deferred_chunks > 0 and got["decode_write"] == 0,
                  "a chunk of the deferred pass ran plain")
            for k in DEFERRED_PATH:
                check(got[k] > 0, f"kernel {k} was not launched on the "
                                  f"deferred path")
            n_split = got["flash_decode_batched_stats_split"]
            check(n_split == got["flash_decode_batched_stats"],
                  f"deferred serving: {n_split} of "
                  f"{got['flash_decode_batched_stats']} stats launches in "
                  f"the split mode")
            launches = got
        tokens[d] = reqs[0].output_tokens
        runs.append({"deferred": d, "aggregate_decode_tok_s":
                     st.aggregate_tps, "decode_s": st.decode_s,
                     "decode_steps": steps,
                     "ms_per_decode_step": st.decode_s / steps * 1e3,
                     "deferred_chunks": eng.deferred_chunks})
        log(f"  deferred={d}: {st.aggregate_tps:.2f} tok/s, "
            f"{runs[-1]['ms_per_decode_step']:.3f} ms a step over {steps} "
            f"steps ({eng.deferred_chunks} deferred chunks)")
    same = sum(a == b for a, b in zip(tokens[True], tokens[False]))
    log(f"  launches of a deferred pass {launches}")
    log(f"  tokens of deferred and plain chunks agree at {same} of {n_new} "
        f"positions (bf16 compute; phase 3e compares at f32)")
    # then one 16-step chunk of each traced: device time and device ops a
    # step (after the timed passes: a trace slows the host after it)
    profiles = {}
    for d in (False, True):
        step_ms = [r["ms_per_decode_step"] for r in runs if r["deferred"] == d]
        log(f"  deferred={d}:")
        profiles[str(d)] = profile_decode(engs[d], prompt,
                                          sum(step_ms) / len(step_ms))
    rec["deferred_serving"] = {"runs": runs, "launches": launches,
                               "token_agreement": same / n_new,
                               "profiles": profiles, "card": smi_line()}
    del engs
    torch.cuda.empty_cache()
    return launches


SWEEP_ITERS = 50


def phase_sweep(dev, rec):
    """Phase 4h: the measurement path at full width, through the port's
    two tools.  The bandwidth probe (128, 512 and 1024 MB buffers), then
    ``qmm_sweep`` at the 7B decode shapes (4096x4096, 4096x12288,
    4096x22016, and 11008x4096 at INT8 / 11264x4096 at INT4), T=1 and
    T=48, INT8 and packed INT4 with f32 scales, the auto split, standard
    and groupdot; weights rotating so every launch finds its weight cold
    in L2.  Counters zeroed just before the sweep, read just after; every
    variant must run and none may read above the measured peak."""
    from fastllama_tpu_torch.tools import hbm_peak, qmm_sweep
    log("phase 4h: bandwidth probe and qmm sweep (7B decode shapes, T=1 "
        "and 48, INT8 and INT4, auto split, standard and groupdot)")
    bufs = hbm_peak.measure((128, 512, 1024), iters=16, device=dev,
                            log=lambda line: log("  " + line))
    peak = max(g for _, g in bufs)
    rec["hbm_peak"] = {"buffers_gbs": {str(mb): g for mb, g in bufs},
                       "best_gbs": peak,
                       "share_of_card": peak * 1e9 / HBM_BYTES_S}
    log(f"  probe read rate {peak:.1f} GB/s, "
        f"{100 * peak * 1e9 / HBM_BYTES_S:.1f} % of the card's 3350")
    zero_launches()
    rows = {}
    for quant in ("int8", "int4"):
        shapes = qmm_sweep.default_shapes(quant)
        for T in (1, 48):
            lines = []
            got = qmm_sweep.sweep(
                shapes, T, quant, "float32", SWEEP_ITERS, peak, dev,
                explicit=False, log=lambda line: (
                    print(line, file=sys.stderr, flush=True),
                    lines.append(line)))
            check(len(got) == 2 * len(shapes),
                  f"sweep {quant} T={T}: {len(got)} of {2 * len(shapes)} "
                  f"variants ran: {lines}")
            over = [r for r in got if r["eff"] > 1.0]
            check(not over, f"sweep {quant} T={T} above the measured peak "
                            f"(L2 not cold?): {over}")
            rows[f"{quant}_T{T}"] = got
    launches = read_launches()
    # each variant: 3 warm-up calls, a dry pass and the timed pass
    per = 2 * 4 * (3 + 2 * SWEEP_ITERS)
    for k in ("qmatmul_pallas", "qmatmul_pallas_p4",
              "qmatmul_pallas_groupdot", "qmatmul_pallas_groupdot_p4"):
        check(launches[k] == per,
              f"sweep: {k} launched {launches[k]} times, not {per}")
    # every sweep launch has T <= 48, gs 64 and aligned rows: the ring
    check(launches["qmatmul_pallas_groupdot_pipe"] == 2 * per,
          f"sweep: {launches['qmatmul_pallas_groupdot_pipe']} of "
          f"{2 * per} groupdot launches on the pipelined ring")
    log(f"  ok sweep: {sum(len(v) for v in rows.values())} variants, each "
        f"mode {per} launches a quant type, every groupdot launch on the "
        f"ring")
    rec["sweep"] = rows
    return launches


# -- phase 5: timing ---------------------------------------------------------

def phase_timing(dev, rec):
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    import torch.nn.functional as F
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.models.batched import BatchedKVCache
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.ops.kernels import kv_write as kw
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    log("phase 5: kernel timing at the path's shapes (CUDA events)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    B, nl = 48, 4          # 4 layers of weights rotate so L2 stays cold
    res = {}

    # qmatmul_pallas: the classifier, T = B
    I, O = PROJ_7B["classifier"]
    w = rand_qarray(gen, (I, O), QuantType.INT8, dev)
    w.scales = torch.full_like(w.scales, 0.02 / 127)
    x = torch.randn((B, I), generator=gen, device=dev).to(torch.bfloat16)
    wd = dequantize(w, torch.bfloat16)
    nbytes = x.numel() * 2 + I * O + w.scales.numel() * 4 + B * O * 2
    bm, by = bound_ms(nbytes, 2 * B * I * O, BF16_FLOP_S)
    res["qmatmul_pallas"] = dict(
        **in_turns({"ms": lambda: qmm.qmatmul_pallas(x, w),
                    "loop_ms": lambda: qmm._launch(x, w, torch.bfloat16,
                                                   mode="loop"),
                    "library_ms": lambda: torch.matmul(x, wd),
                    "plain_ms": lambda: qmm.qmm_plain(x, w)}),
        library_call="torch.matmul(x, w) on a pre-dequantized bf16 weight",
        bound_ms=bm, bound_by=by,
        shape=f"T={B} I={I} O={O} (ms: the pipelined mode; loop_ms: "
              f"qmm_bf16_kernel's loop on the same inputs)")
    del w, wd

    # qmatmul_pallas_indexed: one layer's four projections, T = B
    names = ("wqkv", "wo", "w13", "w2")
    ws = {n: rand_qarray(gen, (nl, *PROJ_7B[n]), QuantType.INT8, dev)
          for n in names}
    xs = {n: torch.randn((B, PROJ_7B[n][0]), generator=gen,
                         device=dev).to(torch.bfloat16) for n in names}
    wds = {n: dequantize(ws[n], torch.bfloat16) for n in names}
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    def k_layer():
        lyr = rot()
        for n in names:
            qmm.qmatmul_pallas_indexed(xs[n], ws[n], lyr)

    def p_layer():
        lyr = rot()
        for n in names:
            qmm.qmm_plain(xs[n], ws[n][lyr])

    def l_layer():
        lyr = rot()
        for n in names:
            torch.matmul(xs[n], wds[n][lyr])

    def loop_layer():
        lyr = rot()
        for n in names:
            qmm._launch(xs[n], ws[n][lyr], torch.bfloat16, mode="loop")
    nbytes = sum(B * PROJ_7B[n][0] * 2 + PROJ_7B[n][0] * PROJ_7B[n][1]
                 * (1 + 4 / 64) + B * PROJ_7B[n][1] * 2 for n in names)
    flops = sum(2 * B * PROJ_7B[n][0] * PROJ_7B[n][1] for n in names)
    bm, by = bound_ms(nbytes, flops, BF16_FLOP_S)
    per = {}
    for n in names:
        per[n] = in_turns({
            "ms": lambda n=n: qmm.qmatmul_pallas_indexed(xs[n], ws[n],
                                                         rot()),
            "loop_ms": lambda n=n: qmm._launch(xs[n], ws[n][rot()],
                                               torch.bfloat16,
                                               mode="loop")})
    res["qmatmul_pallas_indexed"] = dict(
        **in_turns({"ms": k_layer, "loop_ms": loop_layer,
                    "library_ms": l_layer, "plain_ms": p_layer}),
        library_call="torch.matmul per projection on pre-dequantized bf16 "
                     "weights",
        bound_ms=bm, bound_by=by,
        per_projection_ms=per,
        shape=f"T={B}, one layer: wqkv 4096x12288, wo 4096x4096, "
              f"w13 4096x22016, w2 11008x4096")
    # prefill-wave shape, T = 2048
    x2 = {n: torch.randn((2048, PROJ_7B[n][0]), generator=gen,
                         device=dev).to(torch.bfloat16) for n in names}

    def k_wave():
        lyr = rot()
        for n in names:
            qmm.qmatmul_pallas_indexed(x2[n], ws[n], lyr)
    wave_flops = sum(2 * 2048 * PROJ_7B[n][0] * PROJ_7B[n][1] for n in names)
    wave_ms = time_ms(k_wave, iters=5, warmup=1)
    res["qmatmul_pallas_indexed"]["prefill_T2048_layer_ms"] = wave_ms
    res["qmatmul_pallas_indexed"]["prefill_T2048_tflop_s"] = (
        wave_flops / wave_ms / 1e9)
    del ws, wds, xs, x2
    res["qmatmul_pallas_indexed"]["verify_T128"] = time_verify_layer(
        dev, gen)
    res["qmatmul_pallas_pipe"] = dict(res["qmatmul_pallas"])
    res["qmatmul_pallas_indexed_pipe"] = dict(res["qmatmul_pallas_indexed"])

    time_fresh(dev, gen, res)

    # decode_write / prefill_write: int8 7B cache, all 32 layers
    cfg = cfg_7b()
    cache = BatchedKVCache.create(cfg, B, dtype=torch.int8, device=dev)
    Lc, n_kv, hs, S = (cfg.n_layers, cfg.n_kv_heads, cfg.head_size,
                       cfg.max_seq_len)

    def fresh(*s):
        return torch.empty(s, dtype=torch.int8, device=dev).random_(
            -127, 128, generator=gen)
    kq, vq = fresh(Lc, B, n_kv, hs), fresh(Lc, B, n_kv, hs)
    ks, vs = (torch.rand((Lc, B, n_kv), generator=gen, device=dev),
              torch.rand((Lc, B, n_kv), generator=gen, device=dev))
    pos = torch.full((B,), 107, dtype=torch.int32, device=dev)
    b_idx = torch.arange(B, device=dev)
    p_idx = pos.long()

    def lib_decode():
        cache.k[:, b_idx, :, p_idx] = kq.transpose(0, 1)
        cache.v[:, b_idx, :, p_idx] = vq.transpose(0, 1)
        cache.k_scale[:, b_idx, :, p_idx] = ks.transpose(0, 1)
        cache.v_scale[:, b_idx, :, p_idx] = vs.transpose(0, 1)
    nbytes = 2 * (2 * kq.numel() + 2 * ks.numel() * 4)
    bm, by = bound_ms(nbytes, 0, BF16_FLOP_S)
    res["decode_write"] = dict(
        ms=time_ms(lambda: kw.decode_write(cache, kq, vq, ks, vs, pos)),
        plain_ms=time_ms(lambda: kw.decode_write_plain(cache, kq, vq, ks,
                                                       vs, pos)),
        library_ms=time_ms(lib_decode),
        library_call="indexed assignment (index_put_) on the cache "
                     "tensors (K, V, 2 scales)",
        bound_ms=bm, bound_by=by,
        shape=f"L={Lc} B={B} n_kv={n_kv} hs={hs}")
    N, T = 32, 64
    slots = torch.arange(N, dtype=torch.int32, device=dev)
    kq, vq = fresh(Lc, N, n_kv, T, hs), fresh(Lc, N, n_kv, T, hs)
    ks, vs = (torch.rand((Lc, N, n_kv, T), generator=gen, device=dev),
              torch.rand((Lc, N, n_kv, T), generator=gen, device=dev))
    s_idx = slots.long()

    def lib_prefill():
        cache.k[:, s_idx, :, :T] = kq
        cache.v[:, s_idx, :, :T] = vq
        cache.k_scale[:, s_idx, :, :T] = ks
        cache.v_scale[:, s_idx, :, :T] = vs
    nbytes = 2 * (2 * kq.numel() + 2 * ks.numel() * 4)
    bm, by = bound_ms(nbytes, 0, BF16_FLOP_S)
    res["prefill_write"] = dict(
        ms=time_ms(lambda: kw.prefill_write(cache, kq, vq, ks, vs, slots)),
        plain_ms=time_ms(lambda: kw.prefill_write_plain(cache, kq, vq, ks,
                                                        vs, slots)),
        library_ms=time_ms(lib_prefill),
        library_call="indexed assignment (index_put_) on the cache "
                     "tensors (K, V, 2 scales)",
        bound_ms=bm, bound_by=by,
        shape=f"L={Lc} N={N} T={T} n_kv={n_kv} hs={hs}")
    del cache
    torch.cuda.empty_cache()
    time_single(dev, gen, res)
    time_decode_by_pos(dev, gen, res)
    time_spec(dev, gen, res)
    time_p4(dev, gen, res)
    sdpa = time_block(dev, gen, res)
    time_groupdot(dev, gen, res)
    time_wide(dev, gen, res)
    time_wide_prefill(dev, gen, res)
    time_prefill(dev, gen, res)
    rec["loaded_modes"] = time_loaded_modes(dev, gen, res)
    for k, v in res.items():
        loop = f"loop {v['loop_ms']:.4f}, " if "loop_ms" in v else ""
        log(f"  {k}: {v['ms']:.4f} ms ({loop}plain {v['plain_ms']:.4f}, "
            f"library {v['library_ms']:.4f}, bound {v['bound_ms']:.4f} by "
            f"{v['bound_by']}) {v['shape']}")
    # which SDPA backend ran K2b's f32 library readings: its device
    # kernels under the profiler, after the last timing of the phase
    backends = {k: sdpa_kernels(fn) for k, fn in sdpa.items()}
    for k, names in backends.items():
        res["flash_block_attend_tf32"]["by_reading"][k]["sdpa_kernels"] = \
            names
    log(f"  K2b f32 readings' SDPA device kernels: {backends}")
    rec["timing"] = res


def sdpa_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs (which SDPA
    backend serves it), from ``torch.profiler``: the second of two traces
    (the first trace of a process can come back empty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return sorted({r[2][:100] for r in device_rows(prof)})


def time_verify_layer(dev, gen):
    """K1 at a verify round's rows as phase 4c runs it: one layer of the
    7B INT8 UNFUSED weights (wq, wk, wv, wo 4096x4096, w1, w3 4096x11008,
    w2 11008x4096), f32 scales, T = B x D = 128 bf16 rows, layers rotating
    so every launch finds its weight cold in L2; the pipelined mode, the
    loop, torch.matmul on pre-dequantized bf16 weights and the plain
    version, in turns."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    bf16, nl, T = torch.bfloat16, 4, 128
    shapes = {"wq": (4096, 4096), "wk": (4096, 4096), "wv": (4096, 4096),
              "wo": (4096, 4096), "w1": (4096, 11008), "w3": (4096, 11008),
              "w2": (11008, 4096)}
    ws = {n: rand_qarray(gen, (nl, *sh), QuantType.INT8, dev)
          for n, sh in shapes.items()}
    wds = {n: dequantize(ws[n], bf16) for n in shapes}
    xs = {n: torch.randn((T, sh[0]), generator=gen, device=dev).to(bf16)
          for n, sh in shapes.items()}
    layer = [0]

    def per_layer(one):
        def run():
            layer[0] = (layer[0] + 1) % nl
            for n in shapes:
                one(n, layer[0])
        return run
    nbytes = sum(T * I * 2 + I * O + I // 64 * O * 4 + T * O * 2
                 for I, O in shapes.values())
    flops = sum(2 * T * I * O for I, O in shapes.values())
    bm, by = bound_ms(nbytes, flops, BF16_FLOP_S)
    out = dict(
        **in_turns({
            "ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas_indexed(
                xs[n], ws[n], lyr)),
            "loop_ms": per_layer(lambda n, lyr: qmm._launch(
                xs[n], ws[n][lyr], bf16, mode="loop")),
            "library_ms": per_layer(lambda n, lyr: torch.matmul(
                xs[n], wds[n][lyr])),
            "plain_ms": per_layer(lambda n, lyr: qmm.qmm_plain(
                xs[n], ws[n][lyr]))}),
        bound_ms=bm, bound_by=by, bytes=nbytes,
        library_call="torch.matmul per projection on pre-dequantized bf16 "
                     "weights",
        shape="T=128 (B=32 x D=4), one unfused INT8 layer, f32 scales: wq, "
              "wk, wv, wo 4096x4096, w1, w3 4096x11008, w2 11008x4096")
    log(f"  qmatmul_pallas_indexed verify T=128: {out['ms']:.4f} ms (loop "
        f"{out['loop_ms']:.4f}, plain {out['plain_ms']:.4f}, library "
        f"{out['library_ms']:.4f}, bound {bm:.4f} by {by})")
    del ws, wds
    torch.cuda.empty_cache()
    return out


def time_single(dev, gen, res):
    """The single-stream path's kernels at its 7B decode shapes (T=1, B=1,
    bf16 scales, bf16 KV at pos 107): K1f over one layer's four
    projections, K1 on the classifier, K2 non-fresh through each of its
    three wrappers.  Layers rotate so that every launch finds its weights
    and cache rows cold in L2, as it does between two layers."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    import torch.nn.functional as F
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import attention as at
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    bf16, nl = torch.bfloat16, 4
    names = ("wqkv", "wo", "w13", "w2")
    norm = {"wqkv": True, "wo": False, "w13": True, "w2": False}
    ws = {n: rand_qarray(gen, (nl, *PROJ_7B[n]), QuantType.INT8, dev, bf16)
          for n in names}
    wds = {n: dequantize(ws[n], bf16) for n in names}
    xs = {n: torch.randn((1, PROJ_7B[n][0]), generator=gen,
                         device=dev).to(bf16) for n in names}
    kws = {n: (dict(norm_gain=torch.rand((PROJ_7B[n][0],), generator=gen,
                                         device=dev) + 0.5) if norm[n] else
               dict(residual=torch.randn((1, PROJ_7B[n][1]), generator=gen,
                                         device=dev).to(bf16)))
           for n in names}
    layer = [0]

    def rot(n=nl):
        layer[0] = (layer[0] + 1) % n
        return layer[0]

    def k_one(n, lyr):
        return qmm.qmatmul_pallas_indexed(xs[n], ws[n], lyr, bf16, **kws[n])

    def p_one(n, lyr):
        return qmm.qmm_fused_plain(xs[n], ws[n][lyr], bf16, **kws[n])

    def l_one(n, lyr):
        if norm[n]:
            g = kws[n]["norm_gain"].to(bf16)
            return torch.matmul(F.rms_norm(xs[n], g.shape, g, 1e-5),
                                wds[n][lyr])
        return torch.addmm(kws[n]["residual"], xs[n], wds[n][lyr])

    def loop_one(n, lyr):
        return qmm._launch(xs[n], ws[n][lyr], bf16,
                           kws[n].get("norm_gain"), kws[n].get("residual"),
                           mode="loop")

    def per_layer(one):
        def run():
            lyr = rot()
            for n in names:
                one(n, lyr)
        return run
    nbytes, flops = 0, 0
    for n in names:
        I, O = PROJ_7B[n]
        nbytes += (I * 2 + I * O + I // 64 * O * 2 + O * 2
                   + (I * 4 if norm[n] else O * 2))
        flops += 2 * I * O
    bm, by = bound_ms(nbytes, flops, BF16_FLOP_S)
    res["qmatmul_pallas_indexed_fused"] = dict(
        **in_turns({"ms": per_layer(k_one), "loop_ms": per_layer(loop_one),
                    "library_ms": per_layer(l_one),
                    "plain_ms": per_layer(p_one)}),
        library_call="torch rms_norm then torch.matmul (norm projections) "
                     "or torch.addmm (residual projections) on "
                     "pre-dequantized bf16 weights",
        bound_ms=bm, bound_by=by, bytes=nbytes,
        per_projection_ms={n: in_turns({
            "ms": lambda n=n: k_one(n, rot()),
            "loop_ms": lambda n=n: loop_one(n, rot())}) for n in names},
        shape="T=1 bf16 scales, one layer: wqkv 4096x12288 +norm, wo "
              "4096x4096 +residual, w13 4096x22016 +norm, w2 11008x4096 "
              "+residual")
    res["qmatmul_pallas_indexed_fused_pipe"] = dict(
        res["qmatmul_pallas_indexed_fused"])
    del ws, wds

    # K1 on the classifier at T=1 with bf16 scales
    I, O = PROJ_7B["classifier"]
    w = rand_qarray(gen, (I, O), QuantType.INT8, dev, bf16)
    wd = dequantize(w, bf16)
    x = torch.randn((1, I), generator=gen, device=dev).to(bf16)
    nbytes = I * 2 + I * O + I // 64 * O * 2 + O * 2
    bm, by = bound_ms(nbytes, 2 * I * O, BF16_FLOP_S)
    res["qmatmul_pallas"]["single_stream"] = dict(
        **in_turns({"ms": lambda: qmm.qmatmul_pallas(x, w),
                    "loop_ms": lambda: qmm._launch(x, w, bf16, mode="loop"),
                    "library_ms": lambda: torch.matmul(x, wd),
                    "plain_ms": lambda: qmm.qmm_plain(x, w)}),
        bound_ms=bm, bound_by=by,
        shape=f"T=1 I={I} O={O} bf16 scales")
    v = res["qmatmul_pallas"]["single_stream"]
    log(f"  qmatmul_pallas single-stream: {v['ms']:.4f} ms (loop "
        f"{v['loop_ms']:.4f}, plain "
        f"{v['plain_ms']:.4f}, library {v['library_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f} by {v['bound_by']}) {v['shape']}")
    del w, wd

    # K2 non-fresh: 7B heads, B=1, bf16 cache of 32 layers, pos 107
    L, H, n_kv, hs, S, p = 32, 32, 32, 128, 512, 107
    ck = torch.randn((L, n_kv, S, hs), generator=gen, device=dev).to(bf16)
    cv = torch.randn((L, n_kv, S, hs), generator=gen, device=dev).to(bf16)
    q = torch.randn((H, 1, hs), generator=gen, device=dev).to(bf16)
    pos = torch.full((1,), p, dtype=torch.int32, device=dev)
    nbytes = 2 * H * hs * 2 + 2 * (p + 1) * n_kv * hs * 2
    bm, by = bound_ms(nbytes, 4 * (p + 1) * H * hs, F32_FLOP_S)

    def sdpa():
        lyr = rot(L)
        return F.scaled_dot_product_attention(
            q[None], ck[lyr][None, :, :p + 1], cv[lyr][None, :, :p + 1])
    lib = time_ms(sdpa)
    ckb = ck.view(L, 1, n_kv, S, hs)
    cvb = cv.view(L, 1, n_kv, S, hs)
    tile = time_ms(lambda: fd._launch(q[None], ckb, cvb, pos, rot(L), None,
                                      None, None, None, False))
    for name, run, plain in (
            ("flash_decode_single",
             lambda: fd.flash_decode_single(q, ck, cv, pos, rot(L)),
             lambda: fd.flash_decode_single_plain(q, ck, cv, pos, rot(L))),
            ("decode_attention_pallas_indexed",
             lambda: at.decode_attention_pallas_indexed(q, ck, cv, pos,
                                                        rot(L)),
             lambda: fd.flash_decode_single_plain(q, ck, cv, pos, rot(L))),
            ("decode_attention_pallas",
             lambda: at.decode_attention_pallas(q, ck[rot(L)], cv[layer[0]],
                                                pos),
             lambda: at.decode_attention_plain(q, ck[rot(L)], cv[layer[0]],
                                               pos))):
        res[name] = dict(
            ms=time_ms(run), plain_ms=time_ms(plain), library_ms=lib,
            library_call="SDPA over the bf16 rows [0, pos] of one layer",
            bound_ms=bm, bound_by=by, bytes=nbytes, tile_ms=tile,
            shape=f"B=1 H={H} n_kv={n_kv} hs={hs} S={S} bf16 cache, "
                  f"pos={p}, split-row mode (tile_ms: the tiled kernel)")
        res[name + "_split"] = dict(res[name])
    del ck, cv, ckb, cvb
    torch.cuda.empty_cache()


FRESH_READINGS = (
    # (key, B, S, pos: an int for every slot or None for mixed, stats)
    ("B48_S512_pos107", 48, 512, 107, False),        # phase 4's
    ("B48_S512_pos107_stats", 48, 512, 107, True),   # phase 4g's
    ("B48_S512_mixed", 48, 512, None, False),
    ("B12_S2048_pos2040", 12, 2048, 2040, False))    # bench.py's long context


def time_fresh(dev, gen, res):
    """K2's fresh and stats split mode at ``FRESH_READINGS`` (7B heads,
    int8 cache, bf16 q, layers rotating over 4 so that L2 stays cold):
    the split mode (the wrapper's choice), the tiled kernel
    (``fd._launch``), SDPA over pre-dequantized bf16 rows masked to the
    cache rows the kernel reads (no fresh row, no stats) and the plain
    version, in turns; the bound from the rows this run reads.  At the
    long context also the split mode at 1, 2, 4 and 8 splits (warps a
    block by the rule)."""
    import torch
    import torch.nn.functional as F
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.tools.timing import in_turns
    bf16 = torch.bfloat16
    H, n_kv, hs, L = 32, 32, 128, 4
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % L
        return layer[0]
    rows = {}
    for B, S in ((48, 512), (12, 2048)):
        ck, cv, ksc, vsc = rand_cache(gen, (L, B, n_kv, S, hs), torch.int8,
                                      dev)
        kd = [(ck[i].float() * ksc[i][..., None]).to(bf16) for i in range(L)]
        vd = [(cv[i].float() * vsc[i][..., None]).to(bf16) for i in range(L)]
        q = torch.randn((B, H, 1, hs), generator=gen, device=dev).to(bf16)
        kn = torch.randn((B, n_kv, hs), generator=gen, device=dev).to(bf16)
        vn = torch.randn((B, n_kv, hs), generator=gen, device=dev).to(bf16)
        for key, b, s, p, stats in FRESH_READINGS:
            if (b, s) != (B, S):
                continue
            pos = (torch.randint(0, S, (B,), generator=gen, device=dev,
                                 dtype=torch.int32) if p is None
                   else torch.full((B,), p, dtype=torch.int32, device=dev))
            mask = (torch.arange(S, device=dev)[None, :]
                    < pos[:, None])[:, None, None, :]
            nrows = int(pos.sum())
            nbytes = (2 * q.numel() * 2 + nrows * n_kv * (2 * hs + 8)
                      + 2 * kn.numel() * 2 + (2 * B * H * 4 if stats else 0))
            bm, by = bound_ms(nbytes, 4 * (nrows + B) * H * hs, F32_FLOP_S)

            def args(pos=pos):
                return (q, ck, cv, pos, rot(), ksc, vsc, kn, vn)
            r = dict(
                **in_turns({
                    "ms": lambda: fd.flash_decode_batched(*args(),
                                                          stats=stats),
                    "tile_ms": lambda: fd._launch(*args(), stats),
                    "library_ms": lambda: F.scaled_dot_product_attention(
                        q, kd[rot()], vd[layer[0]], attn_mask=mask),
                    "plain_ms": lambda: fd.flash_decode_plain(
                        *args(), stats=stats)}),
                library_call="SDPA over pre-dequantized bf16 K/V of the "
                             "layer, masked to rows [0, pos) (no fresh row, "
                             "no stats)",
                bound_ms=bm, bound_by=by, bytes=nbytes,
                plan=dict(zip(("nsplit", "nw"), fd.fresh_split_plan(q, ck))),
                shape=f"B={B} H={H} n_kv={n_kv} hs={hs} S={S} int8 cache, "
                      f"bf16 q, {'mixed pos' if p is None else f'pos={p}'}"
                      f"{', stats' if stats else ''} (ms: the split mode; "
                      f"tile_ms: the tiled kernel)")
            if S == 2048:
                r["ms_by_nsplit"] = in_turns({n: lambda n=n: fd._split_launch(
                    *args()[:7], n, k_new=kn, v_new=vn) for n in (1, 2, 4, 8)})
            rows[key] = r
            log(f"  K2 {key}: split {r['ms']:.4f} ms (plan {r['plan']}), "
                f"tiled {r['tile_ms']:.4f}, SDPA {r['library_ms']:.4f}, plain "
                f"{r['plain_ms']:.4f}, bound {bm:.5f} by {by} ({nbytes} "
                f"bytes)" + (f"; by nsplit {r['ms_by_nsplit']}"
                             if "ms_by_nsplit" in r else ""))
        del ck, cv, kd, vd
        torch.cuda.empty_cache()
    res["flash_decode_batched"] = dict(rows["B48_S512_pos107"],
                                       by_reading=rows)
    res["flash_decode_batched_split"] = dict(rows["B48_S512_pos107"])
    res["flash_decode_batched_stats"] = dict(rows["B48_S512_pos107_stats"])
    res["flash_decode_batched_stats_split"] = dict(
        rows["B48_S512_pos107_stats"])


def time_decode_by_pos(dev, gen, res):
    """K2 non-fresh against the rows it reads: 7B heads, bf16 cache of 32
    layers (layers rotating), B=1 at pos 0, 63, 64, 107, 255, 511 (S=512)
    and 2047 (S=2048), and B=32 at pos 107 (S=512, 2 layers): the split-row
    mode (what the wrappers run) and the tiled kernel
    (``flash_decode_kernel``) on each, SDPA over the same rows and the
    bytes bound beside them; at B=1 pos 107, 255, 511 and 2047 also the
    split mode at other split counts than ``split_count``'s, other least
    chunks than ``SPLIT_MIN_CHUNK`` and other warps a block (also at pos
    0)."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    import torch.nn.functional as F
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    bf16 = torch.bfloat16
    H, n_kv, hs = 32, 32, 128
    rows = {}
    for B, L, S, positions in ((1, 32, 512, (0, 63, 64, 107, 255, 511)),
                               (1, 32, 2048, (2047,)), (32, 2, 512, (107,))):
        ck = torch.randn((L, B, n_kv, S, hs), generator=gen,
                         device=dev).to(bf16)
        cv = torch.randn((L, B, n_kv, S, hs), generator=gen,
                         device=dev).to(bf16)
        q = torch.randn((B, H, 1, hs), generator=gen, device=dev).to(bf16)
        layer = [0]

        def rot():
            layer[0] = (layer[0] + 1) % L
            return layer[0]
        for p in positions:
            pos = torch.full((B,), p, dtype=torch.int32, device=dev)
            nbytes = 2 * q.numel() * 2 + 2 * B * (p + 1) * n_kv * hs * 2
            bm, by = bound_ms(nbytes, 4 * B * (p + 1) * H * hs, F32_FLOP_S)

            def sdpa():
                lyr = rot()
                return F.scaled_dot_product_attention(
                    q, ck[lyr][:, :, :p + 1], cv[lyr][:, :, :p + 1])
            r = dict(
                ms=time_ms(lambda: fd._split_launch(q, ck, cv, pos, rot(),
                                                    None, None)),
                tile_ms=time_ms(lambda: fd._launch(
                    q, ck, cv, pos, rot(), None, None, None, None, False)),
                library_ms=time_ms(sdpa),
                library_call="SDPA over the bf16 rows [0, pos] of one layer",
                bound_ms=bm, bound_by=by, bytes=nbytes,
                nsplit=fd.split_count(B, n_kv, S, H // n_kv),
                shape=f"B={B} H={H} n_kv={n_kv} hs={hs} S={S} bf16 cache, "
                      f"pos={p}")
            if B == 1 and p in (107, 255, 511, 2047):
                r["ms_by_nsplit"] = {n: time_ms(lambda: fd._split_launch(
                    q, ck, cv, pos, rot(), None, None, n))
                    for n in (1, 2, 4, 8, 16)}
                r["ms_by_min_chunk"] = {c: time_ms(lambda: fd._split_launch(
                    q, ck, cv, pos, rot(), None, None, None, c))
                    for c in (64, 128, 256, 512)}
                r["ms_by_nsplit_warps"] = {
                    f"{n}x{w}": time_ms(lambda: fd._split_launch(
                        q, ck, cv, pos, rot(), None, None, n,
                        fd.SPLIT_MIN_CHUNK, w))
                    for n, w in ((4, 8), (8, 8), (16, 4), (8, 16))}
            if B == 1 and p in (0, 107):
                r["ms_by_warps"] = {w: time_ms(lambda: fd._split_launch(
                    q, ck, cv, pos, rot(), None, None, None,
                    fd.SPLIT_MIN_CHUNK, w)) for w in (4, 8, 16)}
            if B > 1:
                r["plain_ms"] = time_ms(lambda: fd.flash_decode_plain(
                    q, ck, cv, pos, rot()))
            key = f"B{B}_S{S}_pos{p}"
            rows[key] = r
            log(f"  K2 non-fresh {key}: split {r['ms']:.4f} ms (nsplit "
                f"{r['nsplit']}), tiled {r['tile_ms']:.4f}, SDPA "
                f"{r['library_ms']:.4f}, bound {bm:.5f} by {by}"
                + (f"; by nsplit {r['ms_by_nsplit']}; by least chunk "
                   f"{r['ms_by_min_chunk']}; by nsplit x warps "
                   f"{r['ms_by_nsplit_warps']}" if "ms_by_nsplit" in r
                   else "")
                + (f"; by warps a block {r['ms_by_warps']}"
                   if "ms_by_warps" in r else ""))
        del ck, cv
        torch.cuda.empty_cache()
    res["flash_decode_single"]["by_pos"] = rows


def time_spec(dev, gen, res):
    """The speculative path's kernels at phase 4c's shapes: K2s at B=32,
    7B heads, pos 107 in every slot, int8 cache with the exact diagonal,
    one layer of two (layers rotate), at T = 4 (4c's width) and at T = 2
    and 8 (the tuner's other arms), and at B=4, S=2048, pos 2040, T=4 (the
    split count at its default, 4): the split-row mode (what the wrapper
    runs), the tiled kernel, the plain version and SDPA in turns, the
    bytes bound beside them; spec_write of D=4 rows for 32 slots into the
    7B int8 cache, all 32 layers.  Also ``decode_attention_pallas_batched``
    (on K2 non-fresh; no engine path reaches it) at B=32, bf16 cache, pos
    107."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    import torch.nn.functional as F
    from fastllama_tpu_torch.models.batched import BatchedKVCache
    from fastllama_tpu_torch.ops.kernels import attention as at
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.ops.kernels import kv_write as kw
    from fastllama_tpu_torch.quant.groupquant import (dequantize_rows,
                                                      quantize_rows)
    bf16 = torch.bfloat16
    H, n_kv, hs, L = 32, 32, 128, 2
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % L
        return layer[0]
    rows = {}
    for B, S, p, Ts in ((32, 512, 107, (4, 2, 8)), (4, 2048, 2040, (4,))):
        shape = (L, B, n_kv, S, hs)
        ck = torch.empty(shape, dtype=torch.int8, device=dev).random_(
            -127, 128, generator=gen)
        cv = torch.empty(shape, dtype=torch.int8, device=dev).random_(
            -127, 128, generator=gen)
        ksc = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
        vsc = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
        pos = torch.full((B,), p, dtype=torch.int32, device=dev)
        for T in Ts:
            q = torch.randn((B, H, T, hs), generator=gen, device=dev).to(bf16)
            ke = torch.randn((B, n_kv, T, hs), generator=gen,
                             device=dev).to(bf16)
            ve = torch.randn((B, n_kv, T, hs), generator=gen,
                             device=dev).to(bf16)
            kn = dequantize_rows(*quantize_rows(ke), bf16)
            vn = dequantize_rows(*quantize_rows(ve), bf16)
            args = (q, ck, cv, pos)
            rest = (ksc, vsc, kn, vn, ke, ve)
            # library: SDPA over pre-dequantized bf16 rows [0, S) of the
            # layer and the fresh block, masked to rows [0, pos) and the
            # causal block (the exact diagonal has no counterpart there)
            kd = [torch.cat([(ck[i].float() * ksc[i][..., None]).to(bf16),
                             kn], 2) for i in range(L)]
            vd = [torch.cat([(cv[i].float() * vsc[i][..., None]).to(bf16),
                             vn], 2) for i in range(L)]
            col = torch.arange(S + T, device=dev)
            t_i = torch.arange(T, device=dev)[:, None]
            mask = ((col[None, :] < p) | ((col[None, :] >= S)
                                          & (col[None, :] - S <= t_i))
                    )[None, None]
            nrows = B * p
            nbytes = (q.numel() * 2 * 2 + nrows * n_kv * (2 * hs + 8)
                      + 4 * kn.numel() * 2)
            flops = 4 * nrows * H * T * hs + 4 * B * H * T * T * hs
            bm, by = bound_ms(nbytes, flops, F32_FLOP_S)
            r = dict(
                **in_turns({
                    "ms": lambda: fd.flash_spec_batched(*args, rot(), *rest),
                    "tile_ms": lambda: fd._spec_launch(*args, rot(), *rest),
                    "plain_ms": lambda: fd.flash_spec_plain(*args, rot(),
                                                            *rest),
                    "library_ms": lambda: F.scaled_dot_product_attention(
                        q, kd[rot()], vd[layer[0]], attn_mask=mask)}),
                library_call="SDPA with an explicit mask over "
                             "pre-dequantized bf16 K/V rows and the fresh "
                             "block (no exact diagonal)",
                bound_ms=bm, bound_by=by, bytes=nbytes,
                nsplit=fd.split_count(B, n_kv, S, fd.spec_rows(T), True),
                shape=f"B={B} T={T} H={H} n_kv={n_kv} hs={hs} S={S} int8 "
                      f"cache, exact diagonal, pos={p} every slot (ms: the "
                      f"split-row mode; tile_ms: the tiled kernel)")
            if B == 32 and T == 4:
                # more blocks a (slot, kv head), each fewer rows
                r["ms_by_nsplit"] = {n: time_ms(
                    lambda: fd._spec_split_launch(*args, rot(), *rest, n, 16))
                    for n in (1, 2, 4)}
            key = f"B{B}_S{S}_T{T}_pos{p}"
            rows[key] = r
            log(f"  K2s {key}: split {r['ms']:.4f} ms (nsplit "
                f"{r['nsplit']}), tiled {r['tile_ms']:.4f}, plain "
                f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound "
                f"{bm:.5f} by {by} ({nbytes} bytes)"
                + (f"; by nsplit (least chunk 16) {r['ms_by_nsplit']}"
                   if "ms_by_nsplit" in r else ""))
            del kd, vd
        del ck, cv
        torch.cuda.empty_cache()
    res["flash_spec_batched"] = dict(rows["B32_S512_T4_pos107"], by_shape=rows)
    res["flash_spec_batched_split"] = dict(rows["B32_S512_T4_pos107"])
    B, S, p = 32, 512, 107
    shape = (L, B, n_kv, S, hs)
    pos = torch.full((B,), p, dtype=torch.int32, device=dev)

    # decode_attention_pallas_batched: B=32, bf16 cache, rows [0, pos]
    ckb = torch.randn(shape, generator=gen, device=dev).to(bf16)
    cvb = torch.randn(shape, generator=gen, device=dev).to(bf16)
    q1 = torch.randn((B, H, 1, hs), generator=gen, device=dev).to(bf16)
    mask1 = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None,
                                                                   None, :]
    nbytes = 2 * q1.numel() * 2 + 2 * B * (p + 1) * n_kv * hs * 2
    bm, by = bound_ms(nbytes, 4 * B * (p + 1) * H * hs, F32_FLOP_S)
    res["decode_attention_pallas_batched"] = dict(
        ms=time_ms(lambda: at.decode_attention_pallas_batched(
            q1, ckb, cvb, pos, rot())),
        tile_ms=time_ms(lambda: fd._launch(q1, ckb, cvb, pos, rot(), None,
                                           None, None, None, False)),
        plain_ms=time_ms(lambda: at.decode_attention_batched_plain(
            q1, ckb, cvb, pos, rot())),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q1, ckb[rot()], cvb[layer[0]], attn_mask=mask1)),
        library_call="SDPA over the bf16 layer, masked to rows [0, pos]",
        bound_ms=bm, bound_by=by, bytes=nbytes,
        shape=f"B={B} H={H} n_kv={n_kv} hs={hs} S={S} bf16 cache, pos={p}, "
              f"split-row mode (tile_ms: the tiled kernel)")
    res["decode_attention_pallas_batched_split"] = dict(
        res["decode_attention_pallas_batched"])
    del ckb, cvb

    # spec_write: D=4 rows for 32 slots, the 7B int8 cache of 32 layers
    cfg = cfg_7b()
    Lc, D, n_kv, hs = cfg.n_layers, 4, cfg.n_kv_heads, cfg.head_size
    cache = BatchedKVCache.create(cfg, B, dtype=torch.int8, device=dev)
    kq = torch.empty((Lc, B, n_kv, D, hs), dtype=torch.int8,
                     device=dev).random_(-127, 128, generator=gen)
    vq = torch.empty_like(kq).random_(-127, 128, generator=gen)
    ks = torch.rand((Lc, B, n_kv, D), generator=gen, device=dev)
    vs = torch.rand((Lc, B, n_kv, D), generator=gen, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None]
    r_idx = pos.long()[:, None] + torch.arange(D, device=dev)[None, :]
    # (B, D, L, n_kv[, hs]): the layout indexed assignment takes
    kq_t, vq_t = kq.permute(1, 3, 0, 2, 4), vq.permute(1, 3, 0, 2, 4)
    ks_t, vs_t = ks.permute(1, 3, 0, 2), vs.permute(1, 3, 0, 2)

    def lib_spec():
        cache.k[:, b_idx, :, r_idx] = kq_t
        cache.v[:, b_idx, :, r_idx] = vq_t
        cache.k_scale[:, b_idx, :, r_idx] = ks_t
        cache.v_scale[:, b_idx, :, r_idx] = vs_t
    nbytes = 2 * (2 * kq.numel() + 2 * ks.numel() * 4)
    bm, by = bound_ms(nbytes, 0, BF16_FLOP_S)
    res["spec_write"] = dict(
        ms=time_ms(lambda: kw.spec_write(cache, kq, vq, ks, vs, pos)),
        plain_ms=time_ms(lambda: kw.spec_write_plain(cache, kq, vq, ks, vs,
                                                     pos)),
        library_ms=time_ms(lib_spec),
        library_call="indexed assignment (index_put_) on the cache tensors "
                     "(K, V, 2 scales)",
        bound_ms=bm, bound_by=by, bytes=nbytes,
        shape=f"L={Lc} B={B} D={D} n_kv={n_kv} hs={hs} int8, pos={p}")
    del cache
    torch.cuda.empty_cache()


def time_p4(dev, gen, res):
    """K1p at the INT4 paths' shapes (hidden 11264, f32 scales): the
    classifier at T=48 (phase 4d) and T=1 (4e); one layer's four
    projections at T=48 (a decode step of 4d), T=128 (a verify round's
    rows) and T=2048 (a prefill wave); one single-stream layer at T=1
    with the norm and residual operands (4e).  Beside each: its bound, its
    plain version, ``torch.matmul`` on a pre-dequantized bf16 weight (for
    scale only) and K1 on the same shapes at INT8.  Layers rotate so that
    every launch finds its weights cold in L2."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    import torch.nn.functional as F
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    bf16, nl = torch.bfloat16, 4
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    def nbytes_of(T, I, O, glue=0):
        # x and out in bf16, the nibbles, f32 scales, glue operand bytes
        return T * I * 2 + I * O // 2 + I // 64 * O * 4 + T * O * 2 + glue

    # the classifier, T = 48 and T = 1
    I, O = PROJ_7B_INT4["classifier"]
    w = rand_packed(gen, (I, O), dev)
    w8 = rand_qarray(gen, (I, O), QuantType.INT8, dev)
    wd = dequantize(w, bf16)
    for label, T in (("batched", 48), ("single_stream", 1)):
        x = torch.randn((T, I), generator=gen, device=dev).to(bf16)
        bm, by = bound_ms(nbytes_of(T, I, O), 2 * T * I * O, BF16_FLOP_S)
        d = dict(**in_turns({
                     "ms": lambda: qmm.qmatmul_pallas(x, w),
                     "loop_ms": lambda: qmm._launch(x, w, bf16, mode="loop"),
                     "library_ms": lambda: torch.matmul(x, wd),
                     "plain_ms": lambda: qmm.qmm_p4_plain(x, w)}),
                 k1_int8_ms=time_ms(lambda: qmm.qmatmul_pallas(x, w8)),
                 bound_ms=bm, bound_by=by,
                 bytes=nbytes_of(T, I, O),
                 shape=f"T={T} I={I} O={O} packed, f32 scales")
        if T == 48:
            d["library_call"] = ("torch.matmul(x, w) on a pre-dequantized "
                                 "bf16 weight")
            res["qmatmul_pallas_p4"] = d
        else:
            res["qmatmul_pallas_p4"][label] = d
    del w, w8, wd

    # one layer's four projections, T = 48, 128, 2048
    names = ("wqkv", "wo", "w13", "w2")
    ws = {n: rand_packed(gen, (nl, *PROJ_7B_INT4[n]), dev) for n in names}
    w8s = {n: rand_qarray(gen, (nl, *PROJ_7B_INT4[n]), QuantType.INT8, dev)
           for n in names}
    wds = {n: dequantize(ws[n], bf16) for n in names}
    out = {}
    for T in (48, 128, 2048):
        xs = {n: torch.randn((T, PROJ_7B_INT4[n][0]), generator=gen,
                             device=dev).to(bf16) for n in names}

        def run(one):
            def layer_fn():
                lyr = rot()
                for n in names:
                    one(n, lyr)
            return layer_fn
        kern = run(lambda n, lyr: qmm.qmatmul_pallas_indexed(xs[n], ws[n],
                                                              lyr))
        nb = sum(nbytes_of(T, *PROJ_7B_INT4[n]) for n in names)
        fl = sum(2 * T * PROJ_7B_INT4[n][0] * PROJ_7B_INT4[n][1]
                 for n in names)
        bm, by = bound_ms(nb, fl, BF16_FLOP_S)
        iters = 5 if T == 2048 else 20
        d = dict(bound_ms=bm, bound_by=by, bytes=nb,
                 k1_int8_ms=time_ms(run(lambda n, lyr:
                                        qmm.qmatmul_pallas_indexed(
                                            xs[n], w8s[n], lyr)),
                                    iters=iters, warmup=1))
        if T != 2048:
            d.update(in_turns({
                "ms": kern,
                "loop_ms": run(lambda n, lyr: qmm._launch(
                    xs[n], ws[n][lyr], bf16, mode="loop")),
                "library_ms": run(lambda n, lyr: torch.matmul(
                    xs[n], wds[n][lyr])),
                "plain_ms": run(lambda n, lyr: qmm.qmm_p4_plain(
                    xs[n], ws[n][lyr]))}))
        else:
            d["ms"] = time_ms(kern, iters=iters, warmup=1)
            d["tflop_s"] = fl / d["ms"] / 1e9
        if T != 2048:
            log(f"  qmatmul_pallas_indexed_p4 T={T}: {d['ms']:.4f} ms (loop "
                f"{d['loop_ms']:.4f}, plain {d['plain_ms']:.4f}, library "
                f"{d['library_ms']:.4f}, bound {bm:.4f} by {by})")
        if T == 48:
            d["per_projection_ms"] = {n: in_turns({
                "ms": lambda n=n: qmm.qmatmul_pallas_indexed(xs[n], ws[n],
                                                             rot()),
                "loop_ms": lambda n=n: qmm._launch(
                    xs[n], ws[n][rot()], bf16, mode="loop")})
                for n in names}
        out[T] = d
    res["qmatmul_pallas_indexed_p4"] = dict(
        out[48], verify_T128=out[128], prefill_T2048=out[2048],
        library_call="torch.matmul per projection on pre-dequantized bf16 "
                     "weights",
        shape="T=48, one layer: wqkv 4096x12288, wo 4096x4096, w13 "
              "4096x22528, w2 11264x4096, packed, f32 scales")
    del w8s

    # the single-stream layer with its glue, T = 1
    norm = {"wqkv": True, "wo": False, "w13": True, "w2": False}
    xs = {n: torch.randn((1, PROJ_7B_INT4[n][0]), generator=gen,
                         device=dev).to(bf16) for n in names}
    kws = {n: (dict(norm_gain=torch.rand((PROJ_7B_INT4[n][0],),
                                         generator=gen, device=dev) + 0.5)
               if norm[n] else
               dict(residual=torch.randn((1, PROJ_7B_INT4[n][1]),
                                         generator=gen, device=dev).to(bf16)))
           for n in names}

    def per_layer(one):
        def layer_fn():
            lyr = rot()
            for n in names:
                one(n, lyr)
        return layer_fn

    def lib(n, lyr):
        if norm[n]:
            g = kws[n]["norm_gain"].to(bf16)
            return torch.matmul(F.rms_norm(xs[n], g.shape, g, 1e-5),
                                wds[n][lyr])
        return torch.addmm(kws[n]["residual"], xs[n], wds[n][lyr])
    nb = sum(nbytes_of(1, I, O, I * 4 if norm[n] else O * 2)
             for n, (I, O) in ((n, PROJ_7B_INT4[n]) for n in names))
    fl = sum(2 * PROJ_7B_INT4[n][0] * PROJ_7B_INT4[n][1] for n in names)
    bm, by = bound_ms(nb, fl, BF16_FLOP_S)
    res["qmatmul_pallas_indexed_fused_p4"] = dict(
        **in_turns({
            "ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas_indexed(
                xs[n], ws[n], lyr, **kws[n])),
            "loop_ms": per_layer(lambda n, lyr: qmm._launch(
                xs[n], ws[n][lyr], bf16, kws[n].get("norm_gain"),
                kws[n].get("residual"), mode="loop")),
            "library_ms": per_layer(lib),
            "plain_ms": per_layer(lambda n, lyr: qmm.qmm_p4_plain(
                xs[n], ws[n][lyr], **kws[n]))}),
        library_call="torch rms_norm then torch.matmul (norm projections) "
                     "or torch.addmm (residual projections) on "
                     "pre-dequantized bf16 weights",
        bound_ms=bm, bound_by=by, bytes=nb,
        per_projection_ms={n: time_ms(lambda n=n: qmm.qmatmul_pallas_indexed(
            xs[n], ws[n], rot(), **kws[n])) for n in names},
        shape="T=1 f32 scales, one layer: wqkv 4096x12288 +norm, wo "
              "4096x4096 +residual, w13 4096x22528 +norm, w2 11264x4096 "
              "+residual")
    del ws, wds
    torch.cuda.empty_cache()


def time_block(dev, gen, res):
    """K2b at the prefix-cache tail shapes (7B heads, int8 cache of B=48,
    S=512, start 256, bf16 q and fresh block), layers rotating: the TC
    mode at T in {32, 64, 128, 256}, bounded at the bf16 tensor-core peak;
    the f32 mode (``flash_block_kernel``) on the same inputs at T=32 and
    T=256, bounded at the f32 peak, as its own record (K2 with its
    softmax stats is timed by :func:`time_fresh`)."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    import torch.nn.functional as F
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    bf16 = torch.bfloat16
    B, L, H, n_kv, hs, S, start, slot = 48, 4, 32, 32, 128, 512, 256, 5
    ck, cv, ksc, vsc = rand_cache(gen, (L, B, n_kv, S, hs), torch.int8, dev)
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % L
        return layer[0]
    rows, f32_rows = {}, {}
    for T in (32, 64, 128, 256):
        q = torch.randn((H, T, hs), generator=gen, device=dev).to(bf16)
        kn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(bf16)
        vn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(bf16)
        # library: SDPA with an explicit mask over the pre-dequantized bf16
        # cache rows [0, start) of the slot and the fresh block
        kd = [torch.cat([(ck[i, slot, :, :start].float()
                          * ksc[i, slot, :, :start, None]).to(bf16), kn], 1)
              for i in range(L)]
        vd = [torch.cat([(cv[i, slot, :, :start].float()
                          * vsc[i, slot, :, :start, None]).to(bf16), vn], 1)
              for i in range(L)]
        col = torch.arange(start + T, device=dev)[None, :]
        t_i = torch.arange(T, device=dev)[:, None]
        mask = (col < start) | (col - start <= t_i)
        nbytes = (2 * q.numel() * 2 + start * n_kv * (2 * hs + 8)
                  + 2 * kn.numel() * 2)
        flops = 4 * H * T * start * hs + 4 * H * hs * T * (T + 1) // 2
        check(fd.block_mode(q, ck) == "tc", "K2b phase 5: not the TC mode")
        bm, by = bound_ms(nbytes, flops, BF16_FLOP_S)
        rows[T] = dict(
            ms=time_ms(lambda: fd.flash_block_attend(
                q, ck, cv, slot, rot(), start, ksc, vsc, kn, vn)),
            plain_ms=time_ms(lambda: fd.flash_block_plain(
                q, ck, cv, slot, rot(), start, ksc, vsc, kn, vn)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, kd[rot()], vd[layer[0]], attn_mask=mask)),
            library_call="SDPA with an explicit mask over pre-dequantized "
                         "bf16 cache rows [0, start) and the fresh block",
            bound_ms=bm, bound_by=by, bytes=nbytes, flops=flops,
            block_rows=fd.block_rows(T, H // n_kv, n_kv, "tc"),
            shape=f"T={T} start={start} H={H} n_kv={n_kv} hs={hs} int8 "
                  f"cache B={B} S={S}, bf16 q, TC mode")
        if T in (32, 256):
            bm, by = bound_ms(nbytes, flops, F32_FLOP_S)
            f32_rows[f"T{T}"] = dict(
                ms=time_ms(lambda: fd._block_launch(
                    "f32", q, ck, cv, slot, rot(), start, ksc, vsc, kn,
                    vn)),
                bound_ms=bm, bound_by=by,
                block_rows=fd.block_rows(T, H // n_kv, n_kv, "f32"),
                shape=f"T={T}, the same inputs, f32 mode")
        r = rows[T]
        log(f"  flash_block_attend T={T}: TC {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.5f} by {r['bound_by']}, plain "
            f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, TQ "
            f"{r['block_rows']})"
            + (f"; f32 mode {f32_rows[f'T{T}']['ms']:.4f} ms (bound "
               f"{f32_rows[f'T{T}']['bound_ms']:.5f})"
               if f"T{T}" in f32_rows else ""))
        del kd, vd
    # the TC mode's time against the cache rows it reads: T=32, start
    # 0 .. 448 (0 .. 7 cache tiles of 64 rows)
    T = 32
    q = torch.randn((H, T, hs), generator=gen, device=dev).to(bf16)
    kn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(bf16)
    vn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(bf16)
    by_start = {st: time_ms(lambda: fd.flash_block_attend(
        q, ck, cv, slot, rot(), st, ksc, vsc, kn, vn))
        for st in (0, 128, 256, 448)}
    log(f"  flash_block_attend TC T=32 by start (ms): {by_start}")
    res["flash_block_attend"] = dict(
        rows[32], T64=rows[64], T128=rows[128], T256=rows[256],
        f32_mode=f32_rows, tc_T32_ms_by_start=by_start)
    del ck, cv
    torch.cuda.empty_cache()
    return time_block_f32(dev, gen, res)


# K2b's f32 inputs: (reading, q dtype, cache dtype); passes of the split
# TF32 mode for the cache part and for the fresh block (in q's dtype)
F32_BLOCK_READINGS = (("bf16q_f32cache", "bfloat16", "float32", 2, 1),
                      ("f32q_int8cache", "float32", "int8", 2, 3),
                      ("f32q_f32cache", "float32", "float32", 3, 3))


def time_block_f32(dev, gen, res):
    """K2b's f32 inputs at the prefix-cache tail shapes (7B heads, B=48,
    S=512, start 256, layers rotating over 4), at T=32 and 256:
    ``F32_BLOCK_READINGS`` -- bf16 q over an f32 cache (phase 4i's), f32 q
    over an int8 cache (phase 3e's) and f32 q over an f32 cache.  In
    turns: the split-TF32 mode (the wrapper's choice), the CUDA-core f32
    mode (``flash_block_kernel``), SDPA at the matching dtype (q cast to
    f32 over f32 K/V: the cache rows [0, start), int8 rows dequantized,
    and the fresh block; an explicit mask; ``allow_tf32`` off) and the
    plain version.  The bound is max(bytes / 3.35 TB/s, operations / 67
    TFLOP/s), the TF32 bound (the mode's passes at 495 TFLOP/s) beside
    it.  Returns the SDPA calls, whose backend :func:`phase_timing` reads
    after the last timing."""
    import torch
    import torch.nn.functional as F
    from fastllama_tpu_torch.ops.kernels import flash_decode as fd
    from fastllama_tpu_torch.tools.timing import in_turns
    B, L, H, n_kv, hs, S, start, slot = 48, 4, 32, 32, 128, 512, 256, 5
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % L
        return layer[0]
    rows, sdpa, caches = {}, {}, {}
    for key, qname, cname, p_cache, p_fresh in F32_BLOCK_READINGS:
        qdt, cdt = getattr(torch, qname), getattr(torch, cname)
        if cname not in caches:
            caches.clear()
            torch.cuda.empty_cache()
            caches[cname] = rand_cache(gen, (L, B, n_kv, S, hs), cdt, dev)
        ck, cv, ksc, vsc = caches[cname]
        csize = ck.element_size()
        for T in (32, 256):
            q = torch.randn((H, T, hs), generator=gen, device=dev).to(qdt)
            kn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(qdt)
            vn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(qdt)
            check(fd.block_mode(q, ck, cv, kn, vn) == "tf32",
                  f"K2b phase 5 {key}: not the TF32 mode")

            def deq(c, sc, i):
                rows_ = c[i, slot, :, :start].float()
                return rows_ if sc is None else rows_ * sc[i, slot, :, :start,
                                                           None]
            kd = [torch.cat([deq(ck, ksc, i), kn.float()], 1)
                  for i in range(L)]
            vd = [torch.cat([deq(cv, vsc, i), vn.float()], 1)
                  for i in range(L)]
            qf = q.float()
            col = torch.arange(start + T, device=dev)[None, :]
            t_i = torch.arange(T, device=dev)[:, None]
            mask = (col < start) | (col - start <= t_i)
            qb = q.element_size()
            nbytes = (2 * q.numel() * qb
                      + start * n_kv * (2 * hs * csize
                                        + (8 if ksc is not None else 0))
                      + 2 * kn.numel() * qb)
            f_cache = 4 * H * T * start * hs
            f_fresh = 4 * H * hs * T * (T + 1) // 2
            bm, by = bound_ms(nbytes, f_cache + f_fresh, F32_FLOP_S)
            tf_ms = (f_cache * p_cache + f_fresh * p_fresh) / TF32_FLOP_S * 1e3

            def args():
                return (q, ck, cv, slot, rot(), start, ksc, vsc, kn, vn)
            sdpa[f"{key}_T{T}"] = (
                lambda q=qf, kd=kd, vd=vd, mask=mask:
                F.scaled_dot_product_attention(q, kd[0], vd[0],
                                               attn_mask=mask))
            r = dict(
                **in_turns({
                    "ms": lambda: fd.flash_block_attend(*args()),
                    "cuda_core_ms": lambda: fd._block_launch("f32", *args()),
                    "library_ms": lambda kd=kd, vd=vd, qf=qf, mask=mask:
                        F.scaled_dot_product_attention(
                            qf, kd[rot()], vd[layer[0]], attn_mask=mask),
                    "plain_ms": lambda: fd.flash_block_plain(*args())}),
                library_call="SDPA in f32 (allow_tf32 off) with an explicit "
                             "mask over q cast to f32, the slot's cache rows "
                             "[0, start) (int8 rows dequantized) and the "
                             "fresh block",
                bound_ms=bm, bound_by=by, bytes=nbytes,
                flops=f_cache + f_fresh, bound_tf32_ms=tf_ms,
                tf32_passes={"cache": p_cache, "fresh": p_fresh},
                block_rows=fd.block_rows(T, H // n_kv, n_kv, "tf32", hs),
                shape=f"T={T} start={start} H={H} n_kv={n_kv} hs={hs} "
                      f"{cname} cache B={B} S={S}, {qname} q (ms: the TF32 "
                      f"mode; cuda_core_ms: flash_block_kernel)")
            check(r["ms"] < r["cuda_core_ms"],
                  f"K2b {key} T={T}: the TF32 mode ({r['ms']:.4f} ms) is not "
                  f"faster than the CUDA-core mode ({r['cuda_core_ms']:.4f})")
            rows[f"{key}_T{T}"] = r
            log(f"  flash_block_attend {key} T={T}: TF32 {r['ms']:.4f} ms, "
                f"CUDA-core {r['cuda_core_ms']:.4f}, SDPA "
                f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
                f"{bm:.5f} by {by} (TF32 {tf_ms:.5f} at passes {p_cache}/"
                f"{p_fresh}), TQ {r['block_rows']}")
            del kd, vd
    del caches
    torch.cuda.empty_cache()
    res["flash_block_attend_tf32"] = dict(rows["bf16q_f32cache_T32"],
                                          by_reading=rows)
    return sdpa


def time_wide(dev, gen, res):
    """K1's wide mode (f32 compute) at the 7B decode shapes, f32 x: one
    layer's four INT8 projections (wqkv, wo, w13, w2; layers rotating over
    4 so every launch finds its weight cold in L2) at T=48 with f32 scales
    (phase 4k's step), at T=1 with f32 scales and at T=1 with bf16 scales
    through the K1f glue (phase 4j's step: the norm on wqkv and w13, the
    residual on wo and w2), and the classifier at T=48.  Timed in turns:
    the wide ring (``ms``, the wrapper's choice), ``qmm_f32_kernel`` on
    the same calls (``_launch(..., mode="wide")``), ``torch.matmul`` on
    pre-dequantized f32 weights (``allow_tf32`` off; the glue by
    ``rms_norm`` and ``addmm``) and the plain version.  Bound: max(bytes /
    3.35 TB/s, operations x 3
    / 989 TFLOP/s): the f32 product on the tensor cores takes three bf16
    passes (the ring beats the f32 cores' figure, operations / 67 TFLOP/s,
    which stands beside it as ``f32_core_bound_ms``)."""
    import torch
    import torch.nn.functional as F
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    from fastllama_tpu_torch.tools.timing import in_turns
    f32, bf16, nl = torch.float32, torch.bfloat16, 4
    names = ("wqkv", "wo", "w13", "w2")
    norm = {"wqkv": True, "wo": False, "w13": True, "w2": False}
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    def bounds(T, shapes, ssz, glue=False):
        nbytes = sum(T * I * 4 + I * O + I // 64 * O * ssz + T * O * 4
                     for I, O in shapes)
        if glue:
            nbytes += sum((I * 4 if norm[n] else T * O * 4)
                          for n, (I, O) in zip(names, shapes))
        flops = sum(2 * T * I * O for I, O in shapes)
        bm, by = bound_ms(nbytes, 3 * flops, BF16_FLOP_S)
        return dict(bound_ms=bm, bound_by=by, bytes=nbytes, flops=flops,
                    f32_core_bound_ms=bound_ms(nbytes, flops,
                                               F32_FLOP_S)[0])

    def log_row(label, v):
        log(f"  wide {label}: {v['ms']:.4f} ms (qmm_f32_kernel "
            f"{v['f32_kernel_ms']:.4f}, plain {v['plain_ms']:.4f}, library "
            f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f} by "
            f"{v['bound_by']}; f32 cores {v['f32_core_bound_ms']:.4f})")
    rows = {}
    for sdt in (f32, bf16):
        ws = {n: rand_qarray(gen, (nl, *PROJ_7B[n]), QuantType.INT8, dev,
                             sdt) for n in names}
        wds = {n: dequantize(ws[n], f32) for n in names}
        for T in ((48, 1) if sdt == f32 else (1,)):
            glue = sdt == bf16
            xs = {n: torch.randn((T, PROJ_7B[n][0]), generator=gen,
                                 device=dev) for n in names}
            kws = {n: (dict(norm_gain=torch.rand(
                (PROJ_7B[n][0],), generator=gen, device=dev) + 0.5)
                if norm[n] else dict(residual=torch.randn(
                    (T, PROJ_7B[n][1]), generator=gen, device=dev)))
                if glue else {} for n in names}
            check(all(qmm.wide_kernel(xs[n], ws[n][0], f32,
                                      kws[n].get("residual")) == "pipe"
                      for n in names), "K1 at f32 compute: not the wide ring")

            def per_layer(one):
                def run():
                    lyr = rot()
                    for n in names:
                        one(n, lyr)
                return run

            def l_one(n, lyr):
                if kws[n].get("norm_gain") is not None:
                    g = kws[n]["norm_gain"]
                    return torch.matmul(F.rms_norm(xs[n], g.shape, g, 1e-5),
                                        wds[n][lyr])
                if kws[n].get("residual") is not None:
                    return torch.addmm(kws[n]["residual"], xs[n],
                                       wds[n][lyr])
                return torch.matmul(xs[n], wds[n][lyr])
            label = f"T{T}" + ("_glue_bf16_scales" if glue else "")
            rows[label] = dict(
                **in_turns({
                    "ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas_indexed(
                        xs[n], ws[n], lyr, f32, **kws[n])),
                    "f32_kernel_ms": per_layer(lambda n, lyr: qmm._launch(
                        xs[n], ws[n][lyr], f32, kws[n].get("norm_gain"),
                        kws[n].get("residual"), mode="wide")),
                    "library_ms": per_layer(l_one),
                    "plain_ms": per_layer(lambda n, lyr: qmm.qmm_fused_plain(
                        xs[n], ws[n][lyr], f32, **kws[n]))}),
                **bounds(T, [PROJ_7B[n] for n in names], 2 if glue else 4,
                         glue),
                library_call=("torch rms_norm then torch.matmul (norm "
                              "projections) or torch.addmm (residual "
                              "projections)" if glue else
                              "torch.matmul per projection") +
                " on pre-dequantized f32 weights (allow_tf32 off)",
                shape=f"T={T}, one layer (wqkv 4096x12288, wo 4096x4096, "
                      f"w13 4096x22016, w2 11008x4096), INT8, "
                      f"{str(sdt)[6:]} scales, f32 x and compute"
                      + (", K1f glue" if glue else ""))
            log_row(label, rows[label])
        del ws, wds
    # the classifier at T=48, f32 scales (phase 4k's)
    I, O = PROJ_7B["classifier"]
    w = rand_qarray(gen, (I, O), QuantType.INT8, dev)
    wd = dequantize(w, f32)
    x = torch.randn((48, I), generator=gen, device=dev)
    check(qmm.wide_kernel(x, w) == "pipe", "classifier: not the wide ring")
    cls = dict(
        **in_turns({"ms": lambda: qmm.qmatmul_pallas(x, w, f32),
                    "f32_kernel_ms": lambda: qmm._launch(x, w, f32,
                                                         mode="wide"),
                    "library_ms": lambda: torch.matmul(x, wd),
                    "plain_ms": lambda: qmm.qmm_plain(x, w, f32)}),
        **bounds(48, [(I, O)], 4),
        library_call="torch.matmul on a pre-dequantized f32 weight "
                     "(allow_tf32 off)",
        shape=f"T=48 I={I} O={O} INT8, f32 scales, x and compute")
    log_row("classifier T48", cls)
    del w, wd
    torch.cuda.empty_cache()
    res["qmatmul_pallas_indexed_wide_pipe"] = dict(rows["T48"], T1=rows["T1"])
    res["qmatmul_pallas_indexed_fused_wide_pipe"] = dict(
        rows["T1_glue_bf16_scales"])
    res["qmatmul_pallas_wide_pipe"] = cls


def time_wide_prefill(dev, gen, res):
    """K1's wide mode above 128 rows (f32 compute): its prefill kernel
    (``qmm_wgmma_wide_kernel``, the wrappers' choice), ``qmm_f32_kernel``
    on the same calls (``_launch(..., mode="wide")``) and ``torch.matmul``
    on pre-dequantized f32 weights (``allow_tf32`` off), in turns: one 7B
    layer's four INT8 projections (f32 scales and x) at T in {256, 512,
    1024, 2048}, the plain version in turns at T = 512 and alone (three
    calls) at T = 2048, and each projection alone at T = 2048 (the kernel
    and the library); K1f's glue layer at T = 256 with bf16 scales (4j's
    200-token block: the norm on wqkv and w13, the residual on wo and
    w2); the unindexed wrapper on wqkv at T = 2048.  Layers rotate over 2,
    so that every launch finds its weights cold in L2.  Bound: bytes (f32
    x, the weight and its scales, f32 out, the glue operands) over 3.35
    TB/s against operations x 3 (the bf16 passes) over 989 TFLOP/s; the
    f32 cores' figure (operations / 67 TFLOP/s) beside it.  Ends with
    :func:`time_wide_prepass` on the layer's inputs at T = 2048."""
    import torch
    import torch.nn.functional as F
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    f32, nl = torch.float32, 2
    names = ("wqkv", "wo", "w13", "w2")
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    def bounds(T, shapes, ssz=4, glue=0):
        nbytes = sum(T * I * 4 + I * O + I // 64 * O * ssz + T * O * 4
                     for I, O in shapes) + glue
        flops = sum(2 * T * I * O for I, O in shapes)
        bm, by = bound_ms(nbytes, 3 * flops, BF16_FLOP_S)
        return dict(bound_ms=bm, bound_by=by, bytes=nbytes,
                    gflop=flops / 1e9,
                    f32_core_bound_ms=bound_ms(nbytes, flops, F32_FLOP_S)[0])

    def per_layer(one):
        def f():
            lyr = rot()
            for n in names:
                one(n, lyr)
        return f

    def log_row(label, d):
        extra = (f", plain {d['plain_ms']:.4f}" if "plain_ms" in d else "")
        log(f"  {label}: {d['ms']:.4f} ms ({d['tflop_s_3_passes']:.1f} "
            f"TFLOP/s of bf16 passes; qmm_f32_kernel "
            f"{d['f32_kernel_ms']:.4f}, library {d['library_ms']:.4f}"
            f"{extra}, bound {d['bound_ms']:.4f} by {d['bound_by']})")

    ws = {n: rand_qarray(gen, (nl, *PROJ_7B[n]), QuantType.INT8, dev)
          for n in names}
    wds = {n: dequantize(ws[n], f32) for n in names}
    by_t = {}
    for T in (256, 512, 1024, 2048):
        xs = {n: torch.randn((T, PROJ_7B[n][0]), generator=gen, device=dev)
              for n in names}
        check(all(qmm._kernel(xs[n], ws[n][0], f32, False, None)
                  == "wide_prefill" for n in names),
              f"T={T}: not the wide prefill kernel")
        fns = {"ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas_indexed(
                   xs[n], ws[n], lyr, f32)),
               "f32_kernel_ms": per_layer(lambda n, lyr: qmm._launch(
                   xs[n], ws[n][lyr], f32, mode="wide")),
               "library_ms": per_layer(lambda n, lyr: torch.matmul(
                   xs[n], wds[n][lyr]))}
        if T == 512:
            fns["plain_ms"] = per_layer(lambda n, lyr: qmm.qmm_fused_plain(
                xs[n], ws[n][lyr], f32))
        d = dict(**in_turns(fns, iters=5 if T >= 1024 else 10),
                 **bounds(T, [PROJ_7B[n] for n in names]))
        d["tflop_s_3_passes"] = 3 * d["gflop"] / d["ms"]
        if T == 2048:
            d["plain_ms"] = time_ms(per_layer(
                lambda n, lyr: qmm.qmm_fused_plain(xs[n], ws[n][lyr], f32)),
                iters=3, warmup=1)
            d["per_projection_ms"] = {}
            for n in names:
                I, O = PROJ_7B[n]
                d["per_projection_ms"][n] = dict(
                    **in_turns({
                        "ms": lambda n=n: qmm.qmatmul_pallas_indexed(
                            xs[n], ws[n], rot(), f32),
                        "library_ms": lambda n=n: torch.matmul(
                            xs[n], wds[n][rot()])}, iters=10),
                    **bounds(T, [(I, O)]))
            x2048 = xs
        by_t[T] = d
        log_row(f"wide prefill layer T={T}", d)
    res["qmatmul_pallas_indexed_wide_prefill"] = dict(
        by_t[2048], by_T=by_t,
        library_call="torch.matmul per projection on pre-dequantized f32 "
                     "weights (allow_tf32 off)",
        shape="T=2048, one layer: wqkv 4096x12288, wo 4096x4096, w13 "
              "4096x22016, w2 11008x4096, INT8 f32 scales, f32 x and "
              "compute (by_T: T 256-2048)")
    del wds

    # K1f's glue layer at T = 256 (4j's block), bf16 scales
    T = 256
    norm = {"wqkv": True, "wo": False, "w13": True, "w2": False}
    wb = {n: rand_qarray(gen, (nl, *PROJ_7B[n]), QuantType.INT8, dev,
                         torch.bfloat16) for n in names}
    wbd = {n: dequantize(wb[n], f32) for n in names}
    xs = {n: torch.randn((T, PROJ_7B[n][0]), generator=gen, device=dev)
          for n in names}
    kws = {n: (dict(norm_gain=torch.rand((PROJ_7B[n][0],), generator=gen,
                                         device=dev) + 0.5) if norm[n] else
               dict(residual=torch.randn((T, PROJ_7B[n][1]), generator=gen,
                                         device=dev)))
           for n in names}

    def lib(n, lyr):
        if norm[n]:
            g = kws[n]["norm_gain"]
            return torch.matmul(F.rms_norm(xs[n], g.shape, g, 1e-5),
                                wbd[n][lyr])
        return torch.addmm(kws[n]["residual"], xs[n], wbd[n][lyr])
    d = dict(**in_turns({
        "ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas_indexed(
            xs[n], wb[n], lyr, f32, **kws[n])),
        "f32_kernel_ms": per_layer(lambda n, lyr: qmm._launch(
            xs[n], wb[n][lyr], f32, kws[n].get("norm_gain"),
            kws[n].get("residual"), mode="wide")),
        "library_ms": per_layer(lib),
        "plain_ms": per_layer(lambda n, lyr: qmm.qmm_fused_plain(
            xs[n], wb[n][lyr], f32, **kws[n]))}),
        **bounds(T, [PROJ_7B[n] for n in names], 2,
                 sum(PROJ_7B[n][0] * 4 if norm[n] else T * PROJ_7B[n][1] * 4
                     for n in names)),
        library_call="torch rms_norm then torch.matmul (norm projections) "
                     "or torch.addmm (residual projections) on "
                     "pre-dequantized f32 weights",
        shape="T=256 bf16 scales, f32 x and compute, one layer: wqkv "
              "+norm, wo +residual, w13 +norm, w2 +residual")
    d["tflop_s_3_passes"] = 3 * d["gflop"] / d["ms"]
    log_row("wide prefill K1f glue layer T=256", d)
    res["qmatmul_pallas_indexed_fused_wide_prefill"] = d
    del wb, wbd

    # the unindexed wrapper on wqkv at T = 2048
    T, (I, O) = 2048, PROJ_7B["wqkv"]
    w = ws["wqkv"][0]
    wd = dequantize(w, f32)
    x = x2048["wqkv"]
    d = dict(**in_turns({"ms": lambda: qmm.qmatmul_pallas(x, w, f32),
                         "f32_kernel_ms": lambda: qmm._launch(
                             x, w, f32, mode="wide"),
                         "library_ms": lambda: torch.matmul(x, wd)},
                        iters=5),
             plain_ms=time_ms(lambda: qmm.qmm_plain(x, w, f32), iters=3,
                              warmup=1),
             **bounds(T, [(I, O)]),
             library_call="torch.matmul(x, w) on a pre-dequantized f32 "
                          "weight (allow_tf32 off)",
             shape=f"T={T} I={I} O={O} INT8 f32 scales, f32 x and compute")
    d["tflop_s_3_passes"] = 3 * d["gflop"] / d["ms"]
    log_row("wide prefill qmatmul_pallas wqkv T=2048", d)
    res["qmatmul_pallas_wide_prefill"] = d
    del wd
    time_wide_prepass(ws, x2048, res)


def time_wide_prepass(ws, xs, res):
    """The pre-pass's share of the wide prefill calls of a 7B layer at
    T = 2048 (f32 x), by CUDA events, in turns: for each projection the
    wrapper's call (the pre-pass ``prefill_x_kernel`` writing x's three
    bf16 planes, then ``qmm_wgmma_wide_kernel``) and the pre-pass alone
    (``qmm._launch_prepass``) on the same x; the kernel is the call less
    the pre-pass.  Layers rotate over 2 as in :func:`time_wide_prefill`.
    Fails unless the pre-pass's hi plane is bf16(x), the three planes sum
    to x within ``TOL_PLANES`` and each pre-pass is shorter than its
    call."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns
    from fastllama_tpu_torch.ops.kernels import qmm
    f32, layer = torch.float32, [0]

    def rot():
        layer[0] = (layer[0] + 1) % 2
        return layer[0]
    by = {}
    for n, x in xs.items():
        I = x.shape[1]
        xb = qmm._launch_prepass(x)
        check(torch.equal(xb[:, :I], x.to(torch.bfloat16)),
              f"wide pre-pass {n}: the hi plane is not bf16(x)")
        compare(f"wide pre-pass {n}: the planes' sum against x",
                sum(xb[:, q * I:(q + 1) * I].double() for q in range(3)),
                x.double(), TOL_PLANES)
        del xb
        d = in_turns({
            "call_ms": lambda x=x, n=n: qmm.qmatmul_pallas_indexed(
                x, ws[n], rot(), f32),
            "prepass_ms": lambda x=x: qmm._launch_prepass(x)}, iters=10)
        check(0.0 < d["prepass_ms"] < d["call_ms"],
              f"wide pre-pass {n}: {d['prepass_ms']:.4f} ms against the "
              f"call's {d['call_ms']:.4f}")
        d["kernel_ms"] = d["call_ms"] - d["prepass_ms"]
        by[n] = d
    call = sum(v["call_ms"] for v in by.values())
    pre = sum(v["prepass_ms"] for v in by.values())
    out = {"by_projection": by, "layer_call_ms": call,
           "layer_prepass_ms": pre, "prepass_share": pre / call}
    res["qmatmul_pallas_indexed_wide_prefill"]["prepass_T2048"] = out
    log(f"  wide prefill layer T=2048, pre-pass by CUDA events: "
        f"{pre:.4f} ms of the calls' {call:.4f} ms a layer (share "
        f"{out['prepass_share']:.3f}); by projection {by}")


def time_prefill(dev, gen, res):
    """K1 and K1p above 128 rows: the prefill mode (``qmm_wgmma_kernel``,
    the wrappers' choice), ``qmm_bf16_kernel``'s loop on the same calls
    (``mode="loop"``) and ``torch.matmul`` on pre-dequantized bf16 weights
    (the library), in turns: one 7B layer's four projections (INT8, f32
    scales, bf16 x) at T in {256, 512, 1024, 2048}, the INT4 layer (hidden
    11264, packed, f32 scales) at T in {512, 2048}, each projection alone
    at T = 2048; the plain version in turns at T = 512 and alone (three
    calls) at T = 2048.  K1f's glue layer (the norm on wqkv and w13, the
    residual on wo and w2, bf16 scales) at T = 256, a single-stream block;
    the unindexed wrapper on wqkv at T = 2048.  Layers rotate over 2, so
    that every launch finds its weights cold in L2.  Bound: bytes (x, the
    weight and its scales, out, the glue operands) over 3.35 TB/s against
    operations over 989 TFLOP/s."""
    import torch
    import torch.nn.functional as F
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    bf16, nl = torch.bfloat16, 2
    names = ("wqkv", "wo", "w13", "w2")
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    def nbytes_of(T, I, O, packed=False, ssz=4, glue=0):
        return (T * I * 2 + (I * O // 2 if packed else I * O)
                + I // 64 * O * ssz + T * O * 2 + glue)

    def per_layer(one):
        def f():
            lyr = rot()
            for n in names:
                one(n, lyr)
        return f

    def log_row(label, d):
        extra = (f", plain {d['plain_ms']:.4f}" if "plain_ms" in d else "")
        log(f"  {label}: {d['ms']:.4f} ms ({d['tflop_s']:.1f} TFLOP/s; loop "
            f"{d['loop_ms']:.4f}, library {d['library_ms']:.4f}{extra}, "
            f"bound {d['bound_ms']:.4f} by {d['bound_by']})")

    out = {}
    for packed, proj, Ts in ((False, PROJ_7B, (256, 512, 1024, 2048)),
                             (True, PROJ_7B_INT4, (512, 2048))):
        ws = {n: (rand_packed(gen, (nl, *proj[n]), dev) if packed else
                  rand_qarray(gen, (nl, *proj[n]), QuantType.INT8, dev))
              for n in names}
        wds = {n: dequantize(ws[n], bf16) for n in names}
        by_t = {}
        for T in Ts:
            xs = {n: torch.randn((T, proj[n][0]), generator=gen,
                                 device=dev).to(bf16) for n in names}
            fns = {"ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas_indexed(
                       xs[n], ws[n], lyr)),
                   "loop_ms": per_layer(lambda n, lyr: qmm._launch(
                       xs[n], ws[n][lyr], bf16, mode="loop")),
                   "library_ms": per_layer(lambda n, lyr: torch.matmul(
                       xs[n], wds[n][lyr]))}
            if T == 512:
                fns["plain_ms"] = per_layer(lambda n, lyr: qmm.qmm_fused_plain(
                    xs[n], ws[n][lyr]))
            fl = sum(2 * T * proj[n][0] * proj[n][1] for n in names)
            nb = sum(nbytes_of(T, *proj[n], packed) for n in names)
            bm, bb = bound_ms(nb, fl, BF16_FLOP_S)
            d = dict(**in_turns(fns, iters=10 if T >= 1024 else 20),
                     bound_ms=bm, bound_by=bb, bytes=nb, gflop=fl / 1e9)
            d["tflop_s"] = fl / d["ms"] / 1e9
            if T == 2048:
                d["plain_ms"] = time_ms(per_layer(
                    lambda n, lyr: qmm.qmm_fused_plain(xs[n], ws[n][lyr])),
                    iters=3, warmup=1)
                d["per_projection_ms"] = {}
                for n in names:
                    I, O = proj[n]
                    bmp, bbp = bound_ms(nbytes_of(T, I, O, packed),
                                        2 * T * I * O, BF16_FLOP_S)
                    d["per_projection_ms"][n] = dict(
                        **in_turns({
                            "ms": lambda n=n: qmm.qmatmul_pallas_indexed(
                                xs[n], ws[n], rot()),
                            "loop_ms": lambda n=n: qmm._launch(
                                xs[n], ws[n][rot()], bf16, mode="loop"),
                            "library_ms": lambda n=n: torch.matmul(
                                xs[n], wds[n][rot()])}, iters=10),
                        bound_ms=bmp, bound_by=bbp)
            by_t[T] = d
            log_row(f"prefill {'int4' if packed else 'int8'} layer T={T}", d)
        out["int4" if packed else "int8"] = by_t
        del ws, wds, xs
        torch.cuda.empty_cache()
    res["qmatmul_pallas_indexed_prefill"] = dict(
        out["int8"][2048], by_T=out["int8"], int4_by_T=out["int4"],
        library_call="torch.matmul per projection on pre-dequantized bf16 "
                     "weights",
        shape="T=2048, one layer: wqkv 4096x12288, wo 4096x4096, w13 "
              "4096x22016, w2 11008x4096, INT8 f32 scales (int4_by_T: "
              "packed, hidden 11264)")

    # K1f's glue layer at T = 256 (a single-stream block), bf16 scales
    T = 256
    norm = {"wqkv": True, "wo": False, "w13": True, "w2": False}
    ws = {n: rand_qarray(gen, (nl, *PROJ_7B[n]), QuantType.INT8, dev, bf16)
          for n in names}
    wds = {n: dequantize(ws[n], bf16) for n in names}
    xs = {n: torch.randn((T, PROJ_7B[n][0]), generator=gen,
                         device=dev).to(bf16) for n in names}
    kws = {n: (dict(norm_gain=torch.rand((PROJ_7B[n][0],), generator=gen,
                                         device=dev) + 0.5) if norm[n] else
               dict(residual=torch.randn((T, PROJ_7B[n][1]), generator=gen,
                                         device=dev).to(bf16)))
           for n in names}

    def lib(n, lyr):
        if norm[n]:
            g = kws[n]["norm_gain"].to(bf16)
            return torch.matmul(F.rms_norm(xs[n], g.shape, g, 1e-5),
                                wds[n][lyr])
        return torch.addmm(kws[n]["residual"], xs[n], wds[n][lyr])
    fl = sum(2 * T * PROJ_7B[n][0] * PROJ_7B[n][1] for n in names)
    nb = sum(nbytes_of(T, *PROJ_7B[n], ssz=2,
                       glue=PROJ_7B[n][0] * 4 if norm[n] else T *
                       PROJ_7B[n][1] * 2) for n in names)
    bm, bb = bound_ms(nb, fl, BF16_FLOP_S)
    d = dict(**in_turns({
        "ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas_indexed(
            xs[n], ws[n], lyr, **kws[n])),
        "loop_ms": per_layer(lambda n, lyr: qmm._launch(
            xs[n], ws[n][lyr], bf16, kws[n].get("norm_gain"),
            kws[n].get("residual"), mode="loop")),
        "library_ms": per_layer(lib),
        "plain_ms": per_layer(lambda n, lyr: qmm.qmm_fused_plain(
            xs[n], ws[n][lyr], **kws[n]))}),
        bound_ms=bm, bound_by=bb, bytes=nb, gflop=fl / 1e9,
        library_call="torch rms_norm then torch.matmul (norm projections) "
                     "or torch.addmm (residual projections) on "
                     "pre-dequantized bf16 weights",
        shape="T=256 bf16 scales, one layer: wqkv 4096x12288 +norm, wo "
              "4096x4096 +residual, w13 4096x22016 +norm, w2 11008x4096 "
              "+residual")
    d["tflop_s"] = fl / d["ms"] / 1e9
    log_row("prefill K1f glue layer T=256", d)
    res["qmatmul_pallas_indexed_fused_prefill"] = d
    del ws, wds

    # the unindexed wrapper on wqkv at T = 2048
    T, (I, O) = 2048, PROJ_7B["wqkv"]
    w = rand_qarray(gen, (I, O), QuantType.INT8, dev)
    wd = dequantize(w, bf16)
    x = torch.randn((T, I), generator=gen, device=dev).to(bf16)
    bm, bb = bound_ms(nbytes_of(T, I, O), 2 * T * I * O, BF16_FLOP_S)
    d = dict(**in_turns({"ms": lambda: qmm.qmatmul_pallas(x, w),
                         "loop_ms": lambda: qmm._launch(x, w, bf16,
                                                        mode="loop"),
                         "library_ms": lambda: torch.matmul(x, wd)},
                        iters=10),
             plain_ms=time_ms(lambda: qmm.qmm_plain(x, w), iters=3,
                              warmup=1),
             bound_ms=bm, bound_by=bb,
             library_call="torch.matmul(x, w) on a pre-dequantized bf16 "
                          "weight",
             shape=f"T={T} I={I} O={O} INT8 f32 scales")
    d["tflop_s"] = 2 * T * I * O / d["ms"] / 1e9
    log_row("prefill qmatmul_pallas wqkv T=2048", d)
    res["qmatmul_pallas_prefill"] = d
    del w, wd
    torch.cuda.empty_cache()


def time_groupdot(dev, gen, res):
    """The groupdot mode of K1 (INT8, f32 scales) and K1p (packed INT4,
    hidden 11264, f32 scales), the plain form: the classifier at T=48 and
    T=1, and one fused layer's four projections at T=48 and T=1 with the
    layers rotating over 4 copies so every launch finds its weight cold in
    L2.  Timed in turns: the pipelined ring (``ms``, the wrapper's choice
    at these shapes), the loop on the same inputs (``_launch(...,
    mode="loop")``), the standard mode, ``torch.matmul`` on a
    pre-dequantized bf16 weight and the plain version; beside them the
    bound."""
    import torch
    from fastllama_tpu_torch.tools.timing import in_turns
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    bf16, nl = torch.bfloat16, 4
    names = ("wqkv", "wo", "w13", "w2")
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    def loop(x, w):
        return qmm._launch(x, w, bf16, gd=True, mode="loop")

    for kind, proj in (("int8", PROJ_7B), ("int4", PROJ_7B_INT4)):
        def make(shape):
            if kind == "int4":
                return rand_packed(gen, shape, dev)
            return rand_qarray(gen, shape, QuantType.INT8, dev)

        def nbytes_of(T, I, O):
            wb = I * O // 2 if kind == "int4" else I * O
            return T * I * 2 + wb + I // 64 * O * 4 + T * O * 2
        key = "qmatmul_pallas_groupdot" + ("_p4" if kind == "int4" else "")
        I, O = proj["classifier"]
        w = make((I, O))
        wd = dequantize(w, bf16)
        rows = {}
        for T in (48, 1):
            x = torch.randn((T, I), generator=gen, device=dev).to(bf16)
            check(qmm.groupdot_kernel(x, w) == "pipe",
                  f"{key} T={T}: not a ring call")
            nb = nbytes_of(T, I, O)
            bm, by = bound_ms(nb, 2 * T * I * O, BF16_FLOP_S)
            rows[T] = dict(
                **in_turns({
                    "ms": lambda: qmm.qmatmul_pallas(x, w, groupdot=True),
                    "loop_ms": lambda: loop(x, w),
                    "standard_ms": lambda: qmm.qmatmul_pallas(x, w),
                    "library_ms": lambda: torch.matmul(x, wd),
                    "plain_ms": lambda: qmm.qmm_groupdot_plain(x, w)}),
                bound_ms=bm, bound_by=by, bytes=nb,
                shape=f"T={T} I={I} O={O} {kind}"
                      f"{' packed' if kind == 'int4' else ''}, f32 scales")
        del w, wd
        ws = {n: make((nl, *proj[n])) for n in names}
        wds = {n: dequantize(ws[n], bf16) for n in names}
        for T in (48, 1):
            xs = {n: torch.randn((T, proj[n][0]), generator=gen,
                                 device=dev).to(bf16) for n in names}

            def per_layer(one):
                def run():
                    lyr = rot()
                    for n in names:
                        one(n, lyr)
                return run
            nb = sum(nbytes_of(T, *proj[n]) for n in names)
            fl = sum(2 * T * proj[n][0] * proj[n][1] for n in names)
            bm, by = bound_ms(nb, fl, BF16_FLOP_S)
            rows[f"layer_T{T}"] = dict(
                **in_turns({
                    "ms": per_layer(lambda n, lyr: qmm.qmatmul_pallas(
                        xs[n], ws[n][lyr], groupdot=True)),
                    "loop_ms": per_layer(lambda n, lyr: loop(xs[n],
                                                             ws[n][lyr])),
                    "standard_ms": per_layer(lambda n, lyr:
                                             qmm.qmatmul_pallas(
                                                 xs[n], ws[n][lyr])),
                    "library_ms": per_layer(lambda n, lyr: torch.matmul(
                        xs[n], wds[n][lyr])),
                    "plain_ms": per_layer(lambda n, lyr:
                                          qmm.qmm_groupdot_plain(
                                              xs[n], ws[n][lyr]))}),
                bound_ms=bm, bound_by=by, bytes=nb,
                shape=f"T={T}, one layer: " + ", ".join(
                    f"{n} {proj[n][0]}x{proj[n][1]}" for n in names))
        del ws, wds
        res[key] = dict(rows[48], single_stream=rows[1],
                        layer_T48=rows["layer_T48"],
                        layer_T1=rows["layer_T1"],
                        library_call="torch.matmul(x, w) on a "
                                     "pre-dequantized bf16 weight")
        for label, v in (("T=1", rows[1]), ("layer T=48", rows["layer_T48"]),
                         ("layer T=1", rows["layer_T1"])):
            log(f"  {key} {label}: {v['ms']:.4f} ms (loop "
                f"{v['loop_ms']:.4f}, standard {v['standard_ms']:.4f}, "
                f"plain {v['plain_ms']:.4f}, library "
                f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f} by "
                f"{v['bound_by']}) {v['shape']}")
    # the ring's own entry: K1's readings (K1p's stand in its _p4 entry)
    res["qmatmul_pallas_groupdot_pipe"] = dict(res["qmatmul_pallas_groupdot"])
    torch.cuda.empty_cache()


# -- phases 3h and 4m: checkpoint files through the loaders and the CLI ------

class SeededLayers:
    """One per-layer fp32 field in checkpoint layout, made on the card from
    a seed when indexed: ``[l]`` is layer ``l`` (normal x ``scale``, or a
    norm gain ``1 + 0.1 x normal``), so a 32-layer 7B set never sits whole
    in any memory.  ``stack(L)`` gives the first ``L`` layers stacked."""

    def __init__(self, shape, seed, dev, scale=0.02, norm=False):
        self.shape, self.seed, self.dev = shape, seed, dev
        self.scale, self.norm = scale, norm

    def __getitem__(self, layer):
        import torch
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed * 1009 + layer)
        x = torch.randn(self.shape, generator=gen, device=self.dev)
        return 1 + 0.1 * x if self.norm else x * self.scale

    def stack(self, n_layers):
        import torch
        return torch.stack([self[l] for l in range(n_layers)])


def seeded_weights(cfg, seed, dev, scale=0.02):
    """fp32 weights of ``cfg`` in checkpoint layout (projections (out, in),
    the convention a file stores), made on the card from ``seed``: the
    embedding, classifier and final norm as tensors, every per-layer field
    a :class:`SeededLayers`."""
    import torch
    D, H, V = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    qd, kd = cfg.n_heads * cfg.head_size, cfg.kv_dim
    shapes = dict(wq=(qd, D), wk=(kd, D), wv=(kd, D), wo=(D, qd),
                  w1=(H, D), w2=(D, H), w3=(H, D))
    w = {k: SeededLayers(s, seed * 16 + i, dev, scale)
         for i, (k, s) in enumerate(shapes.items())}
    w["attn_norm"] = SeededLayers((D,), seed * 16 + 8, dev, norm=True)
    w["ffn_norm"] = SeededLayers((D,), seed * 16 + 9, dev, norm=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w["embedding"] = torch.randn((V, D), generator=gen, device=dev) * scale
    w["classifier"] = torch.randn((V, D), generator=gen, device=dev) * scale
    w["out_norm"] = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    return w


def host_weights(cfg, w):
    """The stacked host (numpy f32) arrays of :func:`seeded_weights`."""
    return {k: (v.stack(cfg.n_layers) if isinstance(v, SeededLayers)
                else v).cpu().numpy() for k, v in w.items()}


def q8_0_blocks(t):
    """``Q8_0`` of an f32 tensor on the card, blocks of 32 along its last
    axis: an fp16 scale max|x| / 127 and 32 int8 values rounded against
    it.  Returns (the file's bytes, int8 data, f32 scales as stored)."""
    import torch
    a = t.reshape(-1, 32)
    d = (a.abs().amax(dim=1) / 127.0).to(torch.float16)
    safe = torch.where(d > 0, d.float(), torch.ones_like(d.float()))
    q = torch.round(a / safe[:, None]).clamp(-127, 127).to(torch.int8)
    blob = torch.cat([d.view(torch.uint8).reshape(-1, 2),
                      q.view(torch.uint8)], dim=1)
    return (blob.cpu().numpy().tobytes(), q.reshape(t.shape),
            d.float().reshape(*t.shape[:-1], t.shape[-1] // 32))


GGUF_LAYER = {"attn_norm": "attn_norm", "wq": "attn_q", "wk": "attn_k",
              "wv": "attn_v", "wo": "attn_output", "ffn_norm": "ffn_norm",
              "w1": "ffn_gate", "w2": "ffn_down", "w3": "ffn_up"}


def write_gguf_q8(path, cfg, w, tok, keep=False):
    """A GGUF v3 file by hand (the format's byte layout): the metadata,
    the tokenizer, every projection, the embedding and the classifier as
    ``Q8_0`` (encoded on the card), the norms F32.  ``keep``: return
    {field: (data, scales)} of the ``Q8_0`` tensors as host arrays,
    stacked over layers, else None."""
    import struct

    import numpy as np

    def s(txt):
        b = txt.encode()
        return struct.pack("<Q", len(b)) + b

    def kv(key, vtype, payload):
        return s(key) + struct.pack("<I", vtype) + payload

    def arr(key, etype, items):
        head = struct.pack("<IQ", etype, len(items))
        if etype == 8:
            return kv(key, 9, head + b"".join(s(t) for t in items))
        fmt = {6: "f", 5: "i"}[etype]
        return kv(key, 9, head + struct.pack(f"<{len(items)}{fmt}", *items))
    u32 = {"llama.embedding_length": cfg.dim,
           "llama.feed_forward_length": cfg.hidden_dim,
           "llama.block_count": cfg.n_layers,
           "llama.attention.head_count": cfg.n_heads,
           "llama.attention.head_count_kv": cfg.n_kv_heads,
           "llama.context_length": cfg.max_seq_len,
           "tokenizer.ggml.bos_token_id": tok.bos_token_id,
           "tokenizer.ggml.eos_token_id": tok.eos_token_id}
    kvs = [kv("general.architecture", 8, s("llama")),
           kv("general.name", 8, s("llama2-7b-synthetic-q8_0")),
           kv("llama.rope.freq_base", 6, struct.pack("<f", cfg.rope_theta)),
           kv("llama.attention.layer_norm_rms_epsilon", 6,
              struct.pack("<f", cfg.norm_eps)),
           kv("tokenizer.ggml.model", 8, s("llama")),
           arr("tokenizer.ggml.tokens", 8, tok.index_texts),
           arr("tokenizer.ggml.scores", 6, tok.scores),
           arr("tokenizer.ggml.token_type", 5, [int(t) for t in tok.types])]
    kvs += [kv(k, 4, struct.pack("<I", v)) for k, v in u32.items()]
    D, V = cfg.dim, cfg.vocab_size
    tensors = [("token_embd.weight", "embedding", None, (V, D)),
               ("output_norm.weight", "out_norm", None, (D,)),
               ("output.weight", "classifier", None, (V, D))]
    for l in range(cfg.n_layers):
        for f, g in GGUF_LAYER.items():
            tensors.append((f"blk.{l}.{g}.weight", f, l,
                            tuple(w[f].shape)))
    infos, offsets, offset = [], [], 0
    for name, field, _, shape in tensors:
        n = int(np.prod(shape))
        size = 4 * n if len(shape) == 1 else n // 32 * 34
        offset += (-offset) % 32
        dims = tuple(reversed(shape))          # ggml: innermost first
        infos.append(s(name) + struct.pack("<I", len(dims))
                     + struct.pack(f"<{len(dims)}Q", *dims)
                     + struct.pack("<IQ", 0 if len(shape) == 1 else 8,
                                   offset))
        offsets.append(offset)
        offset += size
    kept = {}
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(kvs)))
        f.write(b"".join(kvs) + b"".join(infos))
        start = f.tell() + (-f.tell()) % 32
        for (name, field, l, shape), off in zip(tensors, offsets):
            t = w[field] if l is None else w[field][l]
            f.seek(start + off)
            if len(shape) == 1:
                f.write(t.float().cpu().numpy().astype("<f4").tobytes())
                continue
            blob, q, sc = q8_0_blocks(t.float())
            f.write(blob)
            if keep:
                kept.setdefault(field, []).append((q.cpu().numpy(),
                                                   sc.cpu().numpy()))
    if not keep:
        return None
    return {k: (v[0] if k in ("embedding", "classifier") else
                (np.stack([q for q, _ in v]), np.stack([s for _, s in v])))
            for k, v in kept.items()}


HF_LAYER = {"attn_norm": "input_layernorm.weight",
            "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
            "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
            "ffn_norm": "post_attention_layernorm.weight",
            "w1": "mlp.gate_proj.weight", "w2": "mlp.down_proj.weight",
            "w3": "mlp.up_proj.weight"}


def write_hf_dir(dirpath, cfg, host, shard):
    """An HF checkpoint directory from the host arrays ``host``:
    ``config.json``, and one shard: ``"bin"`` by ``torch.save`` of the
    state dict, ``"safetensors"`` written here byte by byte (an 8-byte
    header size, the JSON header, the raw little-endian data)."""
    import struct

    import torch
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(dict(hidden_size=cfg.dim, intermediate_size=cfg.hidden_dim,
                       num_hidden_layers=cfg.n_layers,
                       num_attention_heads=cfg.n_heads,
                       num_key_value_heads=cfg.n_kv_heads,
                       vocab_size=cfg.vocab_size,
                       max_position_embeddings=cfg.max_seq_len,
                       rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
                       model_type="llama"), f)
    sd = {"model.embed_tokens.weight": host["embedding"],
          "model.norm.weight": host["out_norm"],
          "lm_head.weight": host["classifier"]}
    for l in range(cfg.n_layers):
        for k, n in HF_LAYER.items():
            sd[f"model.layers.{l}.{n}"] = host[k][l]
    if shard == "bin":
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
                   os.path.join(dirpath, "pytorch_model.bin"))
        return dirpath
    header, off = {}, 0
    for k, v in sd.items():
        header[k] = {"dtype": "F32", "shape": list(v.shape),
                     "data_offsets": [off, off + v.nbytes]}
        off += v.nbytes
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(os.path.join(dirpath, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for v in sd.values():
            f.write(v.astype("<f4").tobytes())
    return dirpath


def same_params(label, got, want):
    """Every leaf of two ``LlamaParams`` bit-equal (data, scales, dtypes,
    shapes and the QArray flags)."""
    import torch
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if hasattr(b, "scales"):
            check(hasattr(a, "scales")
                  and (a.qtype, a.group_size, a.group_axis, a.packed)
                  == (b.qtype, b.group_size, b.group_axis, b.packed),
                  f"{label}: {f.name}'s layout differs")
            pairs = ((a.data, b.data), (a.scales, b.scales))
        else:
            pairs = ((a, b),)
        for x, y in pairs:
            check(x.dtype == y.dtype and x.shape == y.shape
                  and bool(torch.equal(x.to(y.device), y)),
                  f"{label}: {f.name} is not bit-equal ({x.dtype} "
                  f"{tuple(x.shape)} against {y.dtype} {tuple(y.shape)})")


def phase_loader_parity(dev, rec):
    """Phase 3h: the loaders on the card, 7B width, 2 layers, f32 compute.
    One seeded set of fp32 weights is written as an llama2c file, an FLM
    INT8 file (``write_flm`` on the card's tensors), a GGUF ``Q8_0`` file
    and two HF directories (a ``torch.save`` ``.bin`` shard and a
    ``.safetensors`` shard written here), one at a time under
    ``tempfile.gettempdir()``.  Each is loaded on the card
    (``Engine.load``, unfused, f32 scales): every leaf bit-equal to
    ``build_params`` on the same in-memory arrays (the GGUF leaves to what
    its ``Q8_0`` bytes encode), the card's build bit-equal to the CPU's
    (the JAX package's quantization, held on the CPU by the tests); the
    prefill logits within ``TOL_F32`` and 24 greedy tokens equal to an
    engine on the in-memory parameters.  The GGUF engine (group size 32)
    runs on the wide mode's G32 kernels (:func:`gguf_wide_run`).  Returns
    the launches of the kernels line."""
    import shutil
    import tempfile

    import torch
    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.loaders import flm, llama2c
    from fastllama_tpu_torch.loaders.registry import FileType
    from fastllama_tpu_torch.models.llama import build_params
    from fastllama_tpu_torch.ops.rope import deinterleave_heads
    from fastllama_tpu_torch.runtime.engine import Engine
    from fastllama_tpu_torch.tools.synthetic import tiny_tokenizer
    log("phase 3h: the loaders on the card (7B width, 2 layers, f32 "
        "compute): llama2c, FLM INT8, GGUF Q8_0, HF .bin and .safetensors")
    cfg = cfg_7b(n_layers=2).replace(quant_type=QuantType.NONE, name="")
    cfg8 = cfg.replace(quant_type=QuantType.INT8)
    hs = cfg.head_size
    w = seeded_weights(cfg, SEED + 30, dev)
    host = host_weights(cfg, w)
    deint = dict(host, wq=deinterleave_heads(host["wq"], hs),
                 wk=deinterleave_heads(host["wk"], hs))
    tok = tiny_tokenizer(cfg.vocab_size)
    ec = EngineConfig(max_seq_len=128, compute_dtype="float32",
                      scale_dtype="float32", kv_dtype="float32",
                      fuse_weights=False)
    prompt = list(range(3, 46))
    t0 = time.perf_counter()
    ref = build_params(cfg8, deint, QuantType.INT8, device=dev)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    same_params("the card's build against the CPU's", ref,
                build_params(cfg8, deint, QuantType.INT8, device="cpu"))
    log(f"  ok build_params on the card ({ref_s:.2f} s) bit-equal to the "
        f"CPU's ({time.perf_counter() - t0:.2f} s)")

    def run(eng):
        cache = eng.new_cache()
        lg = eng._prefill(prompt, eng._bucket(len(prompt)), cache, 0)
        toks, _ = eng.generate(prompt, max_new_tokens=24, temperature=0.0,
                               stop_tokens=(), decode_chunk=8)
        return lg.float(), toks
    d = tempfile.mkdtemp(prefix="chip_smoke_3h_")
    out = {"free_gb": shutil.disk_usage(d).free / 1e9}
    launches = {}
    log(f"  files under {d}: {out['free_gb']:.1f} GB free")
    refs, runs = {"deint": ref}, {}
    try:
        tokp = os.path.join(d, "tokenizer.bin")
        llama2c.write_llama2c_tokenizer(tokp, tok)
        cases = [
            ("llama2c", lambda p: llama2c.write_llama2c(
                p, cfg, host, shared_classifier=False), tokp,
             FileType.LLAMA2C, QuantType.INT8, "deint"),
            ("flm_int8", lambda p: flm.write_flm(
                p, cfg8, tok, w, QuantType.INT8,
                rope_convention="interleaved"), "", FileType.UNKNOWN, None,
             "deint"),
            ("gguf_q8_0", None, "", FileType.UNKNOWN, None, "gguf"),
            ("hf_bin", lambda p: write_hf_dir(p, cfg, host, "bin"), "",
             FileType.UNKNOWN, QuantType.INT8, "hf"),
            ("hf_safetensors", lambda p: write_hf_dir(p, cfg, host,
                                                      "safetensors"), "",
             FileType.UNKNOWN, QuantType.INT8, "hf")]
        for label, write, tkp, ft, qt, kind in cases:
            p = os.path.join(d, label)
            t0 = time.perf_counter()
            if kind == "gguf":
                # the leaves are what the Q8_0 bytes encode
                pairs = write_gguf_q8(p, cfg, w, tok, keep=True)
                for k in ("wq", "wk"):
                    pairs[k] = tuple(deinterleave_heads(a, hs)
                                     for a in pairs[k])
                write_s = time.perf_counter() - t0
                refs["gguf"] = build_params(cfg8.replace(group_size=32),
                                            dict(deint, **pairs),
                                            QuantType.INT8, device=dev)
            else:
                write(p)
                write_s = time.perf_counter() - t0
                if kind == "hf" and "hf" not in refs:
                    # HF files hold the rotate-half layout: no deinterleave
                    refs["hf"] = build_params(cfg8, host, QuantType.INT8,
                                              device=dev)
            size = (sum(os.path.getsize(os.path.join(r, f))
                        for r, _, fs in os.walk(p) for f in fs)
                    if os.path.isdir(p) else os.path.getsize(p))
            t0 = time.perf_counter()
            eng = Engine.load(p, tkp, ft, qt, ec, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            check(eng.config.group_size == (32 if kind == "gguf" else 64)
                  and eng.config.quant_type == QuantType.INT8,
                  f"{label}: loaded as {eng.config.quant_type} at group "
                  f"size {eng.config.group_size}")
            same_params(label, eng.params, refs[kind])
            if kind not in runs:
                mem = Engine(eng.config, refs[kind], tok, ec, device=dev)
                runs[kind] = run(mem)
                del mem
            if kind == "gguf":
                lg, toks = gguf_wide_run(eng, run, tok, ec, dev, launches)
            else:
                lg, toks = run(eng)
            err = compare(f"{label}: Engine.load's prefill logits against "
                          f"the in-memory engine's", lg, runs[kind][0],
                          TOL_F32)
            check(toks == runs[kind][1] and len(toks) == 24,
                  f"{label}: Engine.load's greedy tokens {toks} differ from "
                  f"the in-memory engine's {runs[kind][1]}")
            out[label] = {"bytes": size, "write_s": write_s, "load_s": load_s,
                          "max_logit_err": err}
            log(f"  ok {label}: {size / 1e9:.3f} GB written in "
                f"{write_s:.2f} s, Engine.load {load_s:.2f} s, every leaf "
                f"bit-equal to build_params, 24 greedy tokens equal")
            del eng
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.unlink(p)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec["loader_parity"] = out
    del ref, refs
    torch.cuda.empty_cache()
    return launches


def gguf_wide_run(eng, run, tok, ec, dev, launches):
    """3h's GGUF ``Q8_0`` engine (group size 32, f32 compute) on the wide
    mode's G32 kernels: its ``run`` (the 43-token prefill and 24 greedy
    tokens) and, on an engine of the same loaded parameters at 512 cache
    rows, a 200-token prefill (256 rows), with the counts zeroed before and
    read after (at pos 0 and at pos 1, where the layer glue runs K1f);
    every K1 launch on the wide ring (T <= 128) or the wide prefill
    kernel, none on ``qmm_f32_kernel`` (:func:`check_all_wide`), K1 and
    K1f on the prefill kernel both.
    Puts the launches of the kernels line into ``launches``; returns
    ``run``'s result."""
    import dataclasses

    from fastllama_tpu_torch.runtime.engine import Engine
    zero_launches()
    with ModeTally() as tally:
        got = run(eng)
        long = Engine(eng.config.replace(max_seq_len=512), eng.params, tok,
                      dataclasses.replace(ec, max_seq_len=512), device=dev)
        for pos in (0, 1):         # at pos 1 the layer glue runs K1f
            long._prefill(list(range(3, 203)), long._bucket(200),
                          long.new_cache(), pos)
        del long
    got_l = read_launches()
    check_all_wide(got_l, tally, "3h gguf_q8_0 at f32 compute (gs 32)")
    check(all(got_l[k + "_wide_prefill"] > 0 for k in (
        "qmatmul_pallas_indexed", "qmatmul_pallas_indexed_fused")),
          "3h gguf_q8_0: K1 or K1f never on the wide prefill kernel")
    for k in ("qmatmul_pallas_indexed", "qmatmul_pallas_indexed_fused"):
        launches[k + "_wide_gs32"] = got_l[k + "_wide_pipe"]
        launches[k + "_wide_gs32_prefill"] = got_l[k + "_wide_prefill"]
    return got


# the kernels of a loaded model that no random-weight phase before 4m
# reaches: K1 and K1f on the G32 instantiations of the ring and the prefill
# mode at group size 32 (a GGUF Q8_0 file); at INT16 (an fp32 file loaded
# with qtype INT16) the wide kernels
LOADED_SINGLE_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed_fused",
                      "flash_decode_single")
LOADED_BATCHED_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
                       "flash_decode_batched", "flash_decode_batched_split",
                       "decode_write", "prefill_write")
K1_WRAPPERS = ("qmatmul_pallas", "qmatmul_pallas_indexed",
               "qmatmul_pallas_indexed_fused")


class FileSet:
    """Phase 4m's and 6c's checkpoint files, written by the port's writers
    under ``tempfile.gettempdir()`` on a thread started before the kernels
    build (the card is idle then): a 32-layer and a 4-layer FLM INT8 file
    (``write_flm`` on fp32 layers drawn on the card from a seed, one layer
    at a time), a 4-layer GGUF ``Q8_0`` file and a 4-layer fp32 llama2c
    file with its tokenizer, all at 7B width; ``names`` picks some of
    them.  ``join`` waits and re-raises a writer's error; ``remove``
    deletes the files."""

    JOBS = [("flm16", FLM_DEPTH, "flm"), ("flm4", 4, "flm"),
            ("gguf4", 4, "gguf"),
            ("llama2c4", 4, "llama2c")]

    def __init__(self, dev, names=None):
        import tempfile
        import threading
        self.dev = dev
        self.jobs = [j for j in self.JOBS if names is None or j[0] in names]
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_4m_")
        self.paths, self.rec, self.err = {}, {}, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            self._write()
        except BaseException as e:           # re-raised by join()
            self.err = e

    def _write(self):
        import shutil

        from fastllama_tpu_torch.config import QuantType
        from fastllama_tpu_torch.loaders import flm, llama2c
        from fastllama_tpu_torch.tools.synthetic import tiny_tokenizer
        free = shutil.disk_usage(self.dir).free
        self.rec["dir"], self.rec["free_gb"] = self.dir, free / 1e9
        need = 15e9 if len(self.jobs) > 1 else 2e9
        log(f"  checkpoint files under {self.dir}: {free / 1e9:.1f} GB free")
        check(free > need + 1e9, f"{self.dir}: {free / 1e9:.1f} GB free, "
                                 f"the files take about {need / 1e9:.0f} GB")
        tok = tiny_tokenizer(32000)
        for name, n_layers, kind in self.jobs:
            cfg = cfg_7b(n_layers)
            w = seeded_weights(cfg, SEED + 40, self.dev)
            p = os.path.join(self.dir, name)
            t0 = time.perf_counter()
            if kind == "flm":
                flm.write_flm(p, cfg, tok, w, QuantType.INT8,
                              rope_convention="interleaved")
            elif kind == "gguf":
                write_gguf_q8(p, cfg, w, tok)
            else:
                llama2c.write_llama2c(p, cfg, host_weights(cfg, w),
                                      shared_classifier=False)
                llama2c.write_llama2c_tokenizer(p + ".tok", tok)
                self.paths[name + ".tok"] = p + ".tok"
            self.paths[name] = p
            self.rec[name] = {"layers": n_layers, "write_s":
                              time.perf_counter() - t0,
                              "bytes": os.path.getsize(p)}
            log(f"  phase 4m file {name}: {n_layers} layers, "
                f"{self.rec[name]['bytes'] / 1e9:.3f} GB written in "
                f"{self.rec[name]['write_s']:.2f} s")
            del w

    def join(self):
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self

    def remove(self):
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


CLI = [sys.executable, "-m", "fastllama_tpu_torch.cli"]


def _cli_result(r, label, sec, rc):
    ok = r.returncode == rc if rc is not None else r.returncode != 0
    check(ok, f"CLI {label}: exit code {r.returncode}; stderr "
              f"{r.stderr[-2000:]!r}")
    log(f"  ok CLI {label}: rc {r.returncode} in {sec:.1f} s")
    return r.stdout, r.stderr, sec


def run_cli(args, label, stdin=None, timeout=600, rc=0):
    """``python3 -m fastllama_tpu_torch.cli`` as a subprocess from the
    checkout's root; its exit code must be ``rc`` (0: success; None: any
    non-zero).  Returns (stdout, stderr, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run(CLI + list(args), input=stdin, capture_output=True,
                       text=True, timeout=timeout,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    return _cli_result(r, label, time.perf_counter() - t0, rc)


def run_clis(jobs, timeout=600):
    """Several CLI runs at once, each a subprocess as :func:`run_cli`
    starts it: ``jobs`` of (args, label, stdin, rc), the runs whose output
    is checked and whose speed is not read.  Returns their (stdout,
    stderr, seconds) in order; stops every one it started."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for args, label, stdin, rc in jobs:
            procs.append(subprocess.Popen(
                CLI + list(args), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=root))
        out = []
        for p, (args, label, stdin, rc) in zip(procs, jobs):
            left = max(1.0, timeout - (time.perf_counter() - t0))
            so, se = p.communicate(stdin or "", timeout=left)
            out.append(_cli_result(
                subprocess.CompletedProcess(args, p.returncode, so, se),
                label, time.perf_counter() - t0, rc))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_cli(files, rec):
    """Phase 4m's CLI runs, each a subprocess that loads its file again:
    ``-m benchmark`` on the 16-layer FLM file alone (its speed is
    recorded), then at once, on the 4-layer one, ``chat`` on stdin,
    ``gen --spec``, ``-e``/``-d``, ``--profile-dir``, ``--mesh model=2``,
    ``--multihost``, ``serve``, ``serve --spec`` and ``serve
    --prefix-cache``, whose outputs are checked (nine processes share the
    card: their speeds are not readings).  Every run must exit 0 with its
    output checked, ``--mesh model=2`` in one process 2 naming the two
    counts and ``--multihost`` 2 with the not-ported message."""
    import re
    f16, f4 = files.paths["flm16"], files.paths["flm4"]
    out = {}
    so, _, sec = run_cli(["-c", f16, "-m", "benchmark", "-t", "0", "-n",
                          "64", "--rounds", "2"], "benchmark (16 layers)")
    stats = dict(kv.split(":", 1) for kv in so.strip().splitlines()[-1]
                 .split("\t"))
    check(0 < float(stats.get("output_size", 0)) <= 64
          and "output_speed" in stats, f"CLI benchmark: stats line {stats}")
    out["benchmark"] = dict(stats, seconds=sec,
                            output_speed_tps=float(
                                stats["output_speed"].rstrip("tps")))
    log(f"  CLI benchmark: {stats}")
    prompts = os.path.join(files.dir, "prompts.txt")
    with open(prompts, "w") as f:
        f.write("\n".join(f"the story of the {w} and the dog"
                          for w in ("cat", "boy", "she", "it", "sto", "c",
                                    "b", "w")) + "\n")
    shared = os.path.join(files.dir, "shared.txt")
    with open(shared, "w") as f:
        f.write("\n".join("the story of the cat and the dog and the boy " * 3
                          + w for w in ("a", "the", "on", "in", "to", "of",
                                        "he", "it")) + "\n")
    # -e and -d in one run: the file's tokenizer read here gives the ids
    from fastllama_tpu_torch.loaders.registry import load_model
    text = "the story of the cat and the dog"
    ids = load_model(f4, tokenizer_only=True).tokenizer.encode(text)
    prof = os.path.join(files.dir, "prof")
    serve = ["-c", f4, "-m", "serve", "--batch", "8", "-n", "32", "-t", "0",
             "--prompts-file"]
    # one process: a world of one rank, which a two-rank mesh outgrows
    t0 = time.perf_counter()
    (chat, _, _), (spec_o, spec_e, _), (ed, _, _), _, (_, mesh_e, _), \
        (_, mh_e, _), *served = run_clis([
            (["-c", f4, "-m", "chat", "-n", "16", "-t", "0"], "chat",
             "the cat\nand the dog\n", 0),
            (["-c", f4, "-m", "gen", "--spec", "-t", "0", "-n", "32", "-i",
              "the cat and the cat and the cat", "--detail"], "gen --spec",
             None, 0),
            (["-c", f4, "-e", text, "-d", ",".join(map(str, ids[1:]))],
             "-e/-d", None, 0),
            (["-c", f4, "-n", "16", "-t", "0", "-i", text, "--profile-dir",
              prof], "--profile-dir", None, 0),
            (["-c", f4, "--mesh", "model=2"], "--mesh", None, 2),
            (["-c", f4, "-m", "serve", "--multihost", "--mesh", "data=2"],
             "--multihost", None, 2),
            (serve + [prompts], "serve", None, 0),
            (serve + [prompts, "--spec"], "serve --spec", None, 0),
            (serve + [shared, "--prefix-cache"], "serve --prefix-cache",
             None, 0)])
    out["concurrent_runs_s"] = time.perf_counter() - t0
    for label, (so, se, _) in zip(("serve", "serve --spec",
                                   "serve --prefix-cache"), served):
        m = re.search(r"served (\d+) requests \| aggregate decode "
                      r"([0-9.]+) tok/s", se)
        check(m is not None and m.group(1) == "8"
              and so.count(" tokens=") == 8, f"CLI {label}: {se[-500:]!r}")
    check(chat.count("bot> ") == 2, f"CLI chat: {chat[-500:]!r}")
    check("output:" in spec_o and "spec acceptance" in spec_e,
          f"CLI gen --spec: no output or acceptance line: {spec_o[-500:]!r}")
    got = re.search(r"tokens\((\d+)\): \[(.*)\]", ed)
    check(got is not None and [int(i) for i in got.group(2).split(", ")]
          == ids and ed.split("text:", 1)[-1].strip() == text,
          f"CLI -e/-d: {ed!r}, want the ids {ids} and the text back")
    with open(os.path.join(prof, "trace.json")) as f:
        trace = f.read()
    check("qmm_pipe_kernel" in trace,
          "CLI --profile-dir: the trace names no qmm_pipe_kernel")
    out["profile_trace_bytes"] = len(trace)
    check("needs 2 devices, have 1" in mesh_e,
          f"CLI --mesh: {mesh_e[-300:]!r}")
    check("needs 2 devices, have 1" in mh_e,
          f"CLI --multihost: {mh_e[-300:]!r}")
    rec["file_serving"]["cli"] = out


def phase_file_serving(dev, rec, files):
    """Phase 4m: serving from files at 7B width.  The 16-layer FLM INT8
    file (``FLM_DEPTH``; cut from 32 to keep the whole run in its time)
    through ``Engine.load`` on phase 4b's traffic (its measured
    run and its 200-token ``ChatSession`` block) and through
    ``BatchedEngine.load`` on phase 4's (B=48): every K1/K1f launch on the
    ring or the prefill mode, the launch counts equal to 4/4b's at 32
    layers with each per-layer count scaled to the file's depth (which
    must run before it); then the 4-layer GGUF ``Q8_0`` file (group size
    32: every K1 launch on the ring's or the prefill mode's G32
    instantiation, none on the loop: :func:`check_all_pipe`) and the
    4-layer fp32 llama2c file loaded with
    qtype INT16 (every K1 launch on the wide ring or the wide prefill
    kernel, none on ``qmm_f32_kernel``: :func:`check_all_wide`) through
    both load entry points on the same traffic; then the CLI
    (:func:`phase_cli`).
    Records tok/s, ms a step, the profiles, peak memory and the seconds to
    write and to load."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.loaders.registry import FileType
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine
    log(f"phase 4m: serving from files at 7B width (FLM INT8 {FLM_DEPTH} "
        "layers; "
        "GGUF Q8_0 and llama2c fp32 at INT16 on the wide kernels, 4 "
        "layers; the CLI)")
    out = rec["file_serving"] = {"files": files.rec}
    ec1 = EngineConfig(max_seq_len=512, kv_dtype="bfloat16",
                       scale_dtype="auto")
    ecb = EngineConfig(max_seq_len=512, max_batch_size=48, kv_dtype="int8")
    launches = {}

    def same_counts(label, got, key):
        want = rec.get(key, {}).get("launches")
        check(want is not None, f"{label}: phase {key}'s launch counts are "
                                f"missing, so 4m cannot hold its own to them")
        keys = [k for k in want if k.startswith(("qmatmul", "flash_decode",
                                                 "decode_write",
                                                 "prefill_write"))]
        # a launch a layer (the layer-indexed K1 forms, K2) scales with
        # the depth; the classifier's and the writers' (all layers in one
        # launch) do not
        want = {k: (want[k] * FLM_DEPTH // 32
                    if k.startswith(("qmatmul_pallas_indexed",
                                     "flash_decode")) else want[k])
                for k in keys}
        diff = {k: (got[k], want[k]) for k in keys if got[k] != want[k]}
        check(not diff, f"{label}: launch counts differ from the random-"
                        f"weight phase's: {diff}")
        log(f"  ok {label}: launch counts equal to phase {key}'s")

    path = files.paths["flm16"]
    t0 = time.perf_counter()
    eng = Engine.load(path, engine_config=ec1, device=dev)
    torch.cuda.synchronize()
    load1 = time.perf_counter() - t0
    check(eng.config.n_layers == FLM_DEPTH and eng.params.wq.scales.dtype
          == torch.bfloat16, "the FLM engine: wrong depth or scales")
    log(f"  Engine.load of the {FLM_DEPTH}-layer FLM INT8 file: "
        f"{load1:.2f} s")
    single, ls, _ = serve_single(eng, SINGLE_PATH, t0)
    # 4b's counts take its 200-token ChatSession block in too
    key = "qmatmul_pallas_indexed_fused_prefill"
    single["long_block"], ls[key] = feed_block(eng, eng.config,
                                               check_all_pipe, key)
    same_counts("FLM single stream", ls, "single_serving")
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    beng = BatchedEngine.load(path, engine_config=ecb, decode_chunk=64,
                              device=dev)
    torch.cuda.synchronize()
    loadb = time.perf_counter() - t0
    log(f"  BatchedEngine.load of the {FLM_DEPTH}-layer FLM INT8 file: "
        f"{loadb:.2f} s")
    batched, lb = serve_batched(beng, BATCHED_PATH, t0)
    check(lb["qmatmul_pallas_indexed_prefill"] == 8 * FLM_DEPTH,
          f"FLM batched serving: {lb['qmatmul_pallas_indexed_prefill']} "
          f"prefill launches, not {8 * FLM_DEPTH}")
    same_counts("FLM batched", lb, "serving")
    del beng
    torch.cuda.empty_cache()
    write_load = files.rec["flm16"]["write_s"] + load1 + loadb
    out["flm_int8"] = {"layers": FLM_DEPTH, "single": single,
                       "batched": batched, "engine_load_s": load1,
                       "batched_load_s": loadb,
                       "write_s": files.rec["flm16"]["write_s"],
                       "write_and_load_s": write_load}
    log(f"  the {FLM_DEPTH}-layer FLM file: written in "
        f"{files.rec['flm16']['write_s']:.2f} s, loaded in {load1:.2f} + "
        f"{loadb:.2f} s ({write_load:.1f} s in all)")

    for label, name, tokp, ft, qt, k1, suffix in (
            ("GGUF Q8_0", "gguf4", "", FileType.UNKNOWN, None,
             check_all_pipe, "gs32"),
            ("llama2c fp32 at INT16", "llama2c4",
             files.paths["llama2c4.tok"], FileType.LLAMA2C, QuantType.INT16,
             check_all_wide, "int16")):
        path = files.paths[name]
        t0 = time.perf_counter()
        eng = Engine.load(path, tokp, ft, qt, ec1, device=dev)
        torch.cuda.synchronize()
        l1 = time.perf_counter() - t0
        check(eng.config.group_size == (32 if suffix == "gs32" else 64)
              and eng.config.quant_type == (QuantType.INT8 if suffix
                                            == "gs32" else QuantType.INT16),
              f"{label}: loaded as {eng.config.quant_type} at group size "
              f"{eng.config.group_size}")
        log(f"  {label}: Engine.load {l1:.2f} s")
        single, ls, _ = serve_single(eng, LOADED_SINGLE_PATH, t0,
                                     k1_check=k1)
        del eng
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        beng = BatchedEngine.load(path, tokp, ft, qt, ecb, decode_chunk=64,
                                  device=dev)
        torch.cuda.synchronize()
        lb_s = time.perf_counter() - t0
        batched, lb = serve_batched(beng, LOADED_BATCHED_PATH, t0,
                                    k1_check=k1)
        del beng
        torch.cuda.empty_cache()
        # the launches for the kernels line: at gs 32 these, unless 4o
        # gives them at full depth; INT16's are 4n's
        if suffix == "gs32":
            for k, got in (("qmatmul_pallas_indexed", lb),
                           ("qmatmul_pallas_indexed_fused", ls)):
                launches[k + "_gs32"] = got[k + "_pipe"]
                launches[k + "_gs32_prefill"] = got[k + "_prefill"]
        out[name] = {"single": single, "batched": batched,
                     "engine_load_s": l1, "batched_load_s": lb_s,
                     "write_s": files.rec[name]["write_s"]}
    phase_cli(files, rec)
    return launches


def time_loaded_modes(dev, gen, res):
    """The K1 modes a loaded model puts on a path, at a 7B layer (the four
    projections, layers rotating over 4 so L2 stays cold), T in {1, 48,
    2048}, bf16 x unless said: at group size 32 (GGUF ``Q8_0``) the G32
    instantiations of the ring (T <= 48) and the prefill mode (T = 2048),
    K1 (f32 scales, the batched path's) and K1f with its glue (bf16
    scales, the single stream's: the norm on wqkv and w13, the residual on
    wo and w2), in turns with the loop they replace (``_launch(...,
    mode="loop")``, ``qmm_bf16_kernel``: ``loop_ms``), ``torch.matmul`` on
    pre-dequantized bf16 weights and the plain version (T <= 48; at T =
    2048 the plain version is timed alone, twice); the same calls at f32
    compute on f32 x (the wide mode's G32 instantiations: int8-held
    weights, the wide ring and the wide prefill kernel) and INT16 weights
    at group sizes 64 and 32 (bf16 compute, the engines'), each in turns
    with ``qmm_f32_kernel`` on the same calls (``_launch(...,
    mode="wide")``: ``f32_kernel_ms``), ``torch.matmul`` on f32 weights and
    f32 x (``allow_tf32`` off) and the plain version.  Every new kernel must
    beat the kernel it replaces.  Bound: bytes over 3.35 TB/s against
    operations over 989 TFLOP/s, the bf16 tensor cores: one pass at bf16
    compute, three on f32 x (its three bf16 planes), two at INT16 (hi *
    256 + lo, both exact in bf16); the f32 cores' figure (operations over
    67 TFLOP/s) stands beside the wide ones as ``f32_core_bound_ms``.
    Returns every row, by label."""
    import torch
    import torch.nn.functional as F
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.ops.kernels import qmm
    from fastllama_tpu_torch.quant.groupquant import dequantize
    from fastllama_tpu_torch.tools.timing import in_turns, time_ms
    bf16, f32, nl = torch.bfloat16, torch.float32, 4
    names = ("wqkv", "wo", "w13", "w2")
    norm = {"wqkv": True, "wo": False, "w13": True, "w2": False}
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    def per_layer(one):
        def run():
            lyr = rot()
            for n in names:
                one(n, lyr)
        return run
    rows = {}
    # (row label, qtype, gs, scales, glue, compute and x dtype, bf16
    # passes, the kernel it replaces: _launch's mode)
    for mode, qt, gs, sdt, glue, cdt, passes, old in (
            ("gs32", QuantType.INT8, 32, f32, False, bf16, 1, "loop"),
            ("gs32", QuantType.INT8, 32, bf16, True, bf16, 1, "loop"),
            ("wide gs32", QuantType.INT8, 32, f32, False, f32, 3, "wide"),
            ("wide gs32", QuantType.INT8, 32, bf16, True, f32, 3, "wide"),
            ("INT16", QuantType.INT16, 64, f32, False, bf16, 2, "wide"),
            ("INT16", QuantType.INT16, 64, f32, True, bf16, 2, "wide"),
            ("INT16 gs32", QuantType.INT16, 32, f32, False, bf16, 2,
             "wide")):
        ws = {n: rand_qarray(gen, (nl, *PROJ_7B[n]), qt, dev, sdt, gs=gs)
              for n in names}
        wide = qmm.is_wide(ws["wo"], cdt)
        ldt = f32 if wide else bf16
        wds = {n: dequantize(ws[n], ldt) for n in names}
        ssz = 4 if sdt == f32 else 2
        wb = 1 if qt == QuantType.INT8 else 2
        xs_b = 4 if cdt == f32 else 2
        old_key = "loop_ms" if old == "loop" else "f32_kernel_ms"
        for T in (1, 48, 2048):
            xs = {n: torch.randn((T, PROJ_7B[n][0]), generator=gen,
                                 device=dev).to(cdt) for n in names}
            kws = {n: (dict(norm_gain=torch.rand(
                (PROJ_7B[n][0],), generator=gen, device=dev) + 0.5)
                if norm[n] else dict(residual=torch.randn(
                    (T, PROJ_7B[n][1]), generator=gen, device=dev).to(cdt)))
                if glue else {} for n in names}
            want = (("wide_" if wide else "")
                    + ("pipe" if T <= 128 else "prefill"))
            check(all(qmm._kernel(xs[n], ws[n][0], cdt, False,
                                  kws[n].get("residual")) == want
                      and qmm.g32(ws[n]) == (gs == 32) for n in names),
                  f"{mode} rows at T={T}: another K1 kernel")

            def l_one(n, lyr):
                x = xs[n].to(ldt)
                if kws[n].get("norm_gain") is not None:
                    g = kws[n]["norm_gain"].to(ldt)
                    return torch.matmul(F.rms_norm(x, g.shape, g, 1e-5),
                                        wds[n][lyr])
                if kws[n].get("residual") is not None:
                    return torch.addmm(kws[n]["residual"].to(ldt), x,
                                       wds[n][lyr])
                return torch.matmul(x, wds[n][lyr])
            fns = {"ms": per_layer(lambda n, lyr: (
                       qmm.qmatmul_pallas_indexed_fused if glue
                       else qmm.qmatmul_pallas_indexed)(
                           xs[n], ws[n], lyr, cdt, **kws[n])),
                   old_key: per_layer(lambda n, lyr: qmm._launch(
                       xs[n], ws[n][lyr], cdt, kws[n].get("norm_gain"),
                       kws[n].get("residual"), mode=old)),
                   "library_ms": per_layer(l_one)}
            if T <= 48:
                fns["plain_ms"] = per_layer(
                    lambda n, lyr: qmm.qmm_fused_plain(
                        xs[n], ws[n][lyr], cdt, **kws[n]))
            got = in_turns(fns, iters=20 if T <= 48 else 5)
            if "plain_ms" not in got:
                got["plain_ms"] = time_ms(per_layer(
                    lambda n, lyr: qmm.qmm_fused_plain(
                        xs[n], ws[n][lyr], cdt, **kws[n])), iters=2,
                    warmup=1)
            shapes = [PROJ_7B[n] for n in names]
            nbytes = sum(T * I * xs_b + I * O * wb + I // gs * O * ssz
                         + T * O * xs_b for I, O in shapes)
            if glue:
                nbytes += sum((I * 4 if norm[n] else T * O * xs_b)
                              for n, (I, O) in zip(names, shapes))
            flops = sum(2 * T * I * O for I, O in shapes)
            bm, by = bound_ms(nbytes, flops * passes, BF16_FLOP_S)
            label = f"{'K1f glue' if glue else 'K1'} {mode} T={T}"
            core = (dict(f32_core_bound_ms=bound_ms(nbytes, flops,
                                                    F32_FLOP_S)[0])
                    if wide else {})
            rows[label] = dict(
                **got, bound_ms=bm, bound_by=by, bytes=nbytes, flops=flops,
                bf16_passes=passes, **core,
                library_call=(
                    ("torch rms_norm then torch.matmul or torch.addmm"
                     if glue else "torch.matmul per projection")
                    + (" on pre-dequantized f32 weights, f32 x "
                       "(allow_tf32 off)" if wide else
                       " on pre-dequantized bf16 weights")),
                replaces=("qmm_bf16_kernel (the loop)" if old == "loop"
                          else "qmm_f32_kernel"),
                shape=f"T={T}, one layer (wqkv 4096x12288, wo 4096x4096, "
                      f"w13 4096x22016, w2 11008x4096), {qt.name} gs {gs}, "
                      f"{str(sdt)[6:]} scales, {str(cdt)[6:]} x and "
                      f"compute" + (", K1f glue" if glue else ""))
            log(f"  {label}: {got['ms']:.4f} ms ({rows[label]['replaces']} "
                f"{got[old_key]:.4f}, library {got['library_ms']:.4f}, "
                f"plain {got['plain_ms']:.4f}, bound {bm:.4f} by {by}"
                + (f", f32 cores {core['f32_core_bound_ms']:.4f})" if core
                   else ")"))
            check(got["ms"] < got[old_key],
                  f"{label}: {got['ms']:.4f} ms, not faster than "
                  f"{rows[label]['replaces']}'s {got[old_key]:.4f}")
        del ws, wds
        torch.cuda.empty_cache()
    for kind in ("gs32", "wide gs32", "INT16"):
        suffix = {"gs32": "_gs32", "wide gs32": "_wide_gs32",
                  "INT16": "_int16"}[kind]
        res["qmatmul_pallas_indexed" + suffix] = dict(
            rows[f"K1 {kind} T=48"], T1=rows[f"K1 {kind} T=1"])
        res["qmatmul_pallas_indexed_fused" + suffix] = dict(
            rows[f"K1f glue {kind} T=1"], T48=rows[f"K1f glue {kind} T=48"])
        res["qmatmul_pallas_indexed" + suffix + "_prefill"] = \
            rows[f"K1 {kind} T=2048"]
        res["qmatmul_pallas_indexed_fused" + suffix + "_prefill"] = \
            rows[f"K1f glue {kind} T=2048"]
    return rows


# -- phases 6, 6b and 6c: perplexity, and serving on a mesh of ranks -------

PPL_TOKENS = 2048
PPL_TOKENS_SHORT = 512        # INT16 and fp32: one window
EVAL_PATH = ("qmatmul_pallas", "qmatmul_pallas_indexed",
             "qmatmul_pallas_indexed_fused", "flash_decode_batched",
             "decode_write", "qmatmul_pallas_wide_pipe",
             "qmatmul_pallas_indexed_wide_pipe",
             "qmatmul_pallas_wide_prefill",
             "qmatmul_pallas_indexed_fused_wide_prefill")


def phase_eval(dev, rec):
    """Phase 6: ``tools/eval_ppl`` on 7B, 32 layers, fp32 weights made on
    the card from one seed and built (``build_params``) at INT8, INT16 and
    fp32, f32 compute and scales: ``evaluate`` (window 512) over 2048
    seeded token ids at INT8 and the first 512 at INT16 and fp32; at INT8
    also ``evaluate_decode`` (B = 4, chunk 64) with an f32 KV cache,
    within 1e-3 of ``evaluate`` in log perplexity (the JAX tool's bar),
    and with an int8 KV cache (recorded).
    Every K1 launch on the wide ring or its prefill kernel.  Returns the
    launches."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig, QuantType
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import build_params
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine
    from fastllama_tpu_torch.tools.eval_ppl import evaluate, evaluate_decode
    log("phase 6: perplexity, 7B, 32 layers, one seed at INT8 (2048 token "
        "ids), INT16 and fp32 (512), f32 compute")
    cfg = cfg_7b().replace(quant_type=QuantType.NONE, name="")
    w = seeded_weights(cfg, SEED + 60, dev)
    raw = {k: (v.stack(cfg.n_layers) if isinstance(v, SeededLayers) else v)
           for k, v in w.items()}
    del w
    ids = torch.randint(1, cfg.vocab_size, (PPL_TOKENS,),
                        generator=torch.Generator().manual_seed(SEED + 61)
                        ).tolist()
    tok = Tokenizer().finalize()
    ec = EngineConfig(max_seq_len=512, compute_dtype="float32",
                      kv_dtype="float32", scale_dtype="float32")
    out = {"tokens": PPL_TOKENS, "window": 512, "card": smi_line()}
    zero_launches()
    with ModeTally() as tally:
        for name, qt in (("int8", QuantType.INT8), ("int16", QuantType.INT16),
                         ("f32", QuantType.NONE)):
            t0 = time.perf_counter()
            cq = cfg.replace(quant_type=qt)
            params = build_params(cq, raw, qt, device=dev)
            if qt == QuantType.NONE:
                del raw
            torch.cuda.synchronize()
            row = {"build_s": time.perf_counter() - t0}
            eng = Engine(cq, params, tok, ec, device=dev)
            t0 = time.perf_counter()
            n = PPL_TOKENS if qt == QuantType.INT8 else PPL_TOKENS_SHORT
            ppl = evaluate(eng, ids[:n], 512)
            row.update(ppl=ppl, tokens=n,
                       evaluate_s=time.perf_counter() - t0)
            check(math.isfinite(ppl) and ppl > 1, f"{name}: ppl {ppl}")
            del eng
            if qt == QuantType.INT8:
                for kv in ("float32", "int8"):
                    be = BatchedEngine(cq, params, tok, dataclasses.replace(
                        ec, kv_dtype=kv, max_batch_size=4), device=dev)
                    t0 = time.perf_counter()
                    row[f"decode_ppl_{kv}_kv"] = evaluate_decode(be, ids, 0,
                                                                 64)
                    row[f"decode_{kv}_kv_s"] = time.perf_counter() - t0
                    del be
                d = abs(math.log(row["decode_ppl_float32_kv"])
                        - math.log(ppl))
                row["delta_log_ppl_decode_f32_kv"] = d
                check(d <= 1e-3, f"INT8: evaluate_decode (f32 KV) "
                                 f"{row['decode_ppl_float32_kv']} against "
                                 f"evaluate {ppl}: |d log ppl| {d:.3e}")
            out[name] = row
            log(f"  {name}: {row}")
            del params
            torch.cuda.empty_cache()
    launches = read_launches()
    check_all_wide(launches, tally, "perplexity")
    for k in EVAL_PATH:
        check(launches[k] > 0, f"kernel {k} was not launched by the "
                               f"perplexity tool")
    out["launches"] = launches
    out["k1_modes"] = tally.record()
    rec["eval"] = out
    return launches


def _spec_logits(eng, prompts):
    """One admission of ``prompts`` and one verify of each prompt's first
    four tokens on a SpecBatchedEngine's own verify step: its logits (B,
    4, V).  The rows are fixed tokens, not the sampled first ones: at
    bf16 a greedy argmax may part between two engines within tolerance."""
    import torch
    from fastllama_tpu_torch.models.batched import spec_decode_step
    for p in prompts:
        eng.submit(p, max_new_tokens=8, temperature=0.0, stop_tokens=())
    eng._admit_pending()
    dev = eng.device
    batch = torch.tensor([prompts[b][:4] for b in range(eng.B)],
                         device=dev)
    pos = torch.as_tensor(eng.pos, device=dev)
    kb = eng.kernels
    return spec_decode_step(eng.config, eng.params, batch, pos, eng.cache,
                            mm=kb.mm, mm_idx=kb.mm_idx,
                            attn_sbidx=kb.attn_sbidx,
                            spec_writer=kb.spec_writer,
                            compute_dtype=eng._cdt, mesh=eng.mesh,
                            data_sharded=True)[0]


def _admit(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=8, temperature=0.0, stop_tokens=())
    eng._admit_pending()


def _cache_block(eng, cache):
    """This rank's block of a one-rank engine's whole slot cache: (k, v,
    k scales, v scales) views (the whole cache for an engine without a
    mesh)."""
    from fastllama_tpu_torch.parallel.sharding import (local_slices,
                                                       slot_cache_sharding)
    if eng.mesh is None:
        return cache.k, cache.v, cache.k_scale, cache.v_scale
    p5, p4 = slot_cache_sharding(eng.config, eng.mesh, eng.B)
    return tuple(None if t is None else
                 t[local_slices((p5 if t.ndim == 5 else p4).mesh, t.shape,
                                (p5 if t.ndim == 5 else p4).spec)]
                 for t in (cache.k, cache.v, cache.k_scale, cache.v_scale))


def _decode_logits(eng, prompts, cache_from=None, admit=True):
    """One admission of ``prompts`` (unless ``admit`` is False: done
    already) and one decode step of every slot on the engine's own step,
    fed each prompt's first token (not the sampled one: at bf16 a greedy
    argmax may part between two engines within tolerance): its logits (B,
    V).  ``cache_from`` (a one-rank engine's whole slot cache after the
    same admission) replaces the engine's block of the cache first, so
    that two engines' steps compare on the same cache contents (at an
    int8 cache a prefill row one rounding apart may quantize one step
    apart)."""
    import torch
    if admit:
        _admit(eng, prompts)
    if cache_from is not None:
        c = eng.cache
        for mine, theirs in zip((c.k, c.v, c.k_scale, c.v_scale),
                                _cache_block(eng, cache_from)):
            if mine is not None:
                mine.copy_(theirs)
    dev = eng.device
    tok = torch.tensor([p[0] for p in prompts], device=dev)
    return eng.decode(tok, torch.as_tensor(eng.pos, device=dev),
                      eng.cache)[0]


def _cache_quanta(eng, cache_from, n_rows):
    """The largest difference, layer by layer, between the engine's int8
    cache and its block of ``cache_from`` over rows [0, n_rows) of every
    slot and head, K and V, dequantized, in quanta: |q·s - q'·s'| /
    max(s, s'), the step between two int8 values at the row's larger
    scale."""
    c = eng.cache
    k, v, ks, vs = _cache_block(eng, cache_from)
    worst = None
    for q, s, q1, s1 in ((c.k, c.k_scale, k, ks), (c.v, c.v_scale, v, vs)):
        s, s1 = s[..., :n_rows, None], s1[..., :n_rows, None]
        d = (q[..., :n_rows, :].float() * s
             - q1[..., :n_rows, :].float() * s1).abs() / s.maximum(s1)
        by_layer = d.reshape(d.shape[0], -1).amax(dim=1)
        worst = by_layer if worst is None else worst.maximum(by_layer)
    return worst.tolist()


def phase_mesh_one(dev, rec):
    """Phase 6b: the mesh path in this process, ``mesh="model=1"`` with
    ``spmd_kernels`` on an NCCL group of one rank, at 7B, 32 layers, on
    one set of weights: phase 4's ``BatchedEngine`` (the batched steps
    given the mesh) and 4b's ``Engine`` (a one-rank mesh keeps the
    one-card path, as JAX's does), and 4c's ``SpecBatchedEngine`` at 4
    layers (its arm pinned to speculation), each held to the same engine
    without a mesh (logits within 1e-2·max|ref| at bf16); then a short
    counted run of each (16 new
    tokens; 33 for the speculative one) with its launches, every K1
    launch on the ring or the prefill kernel, and a traced decode chunk
    for device ms a step beside 4's and 4b's."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import random_params_int
    from fastllama_tpu_torch.parallel import distributed
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine
    from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
    log("phase 6b: mesh model=1 on an NCCL group of one rank: 4's "
        "BatchedEngine, 4b's Engine (32 layers), 4c's SpecBatchedEngine "
        "(4 layers)")
    distributed.initialize(f"tcp://localhost:{distributed.free_port()}", 1,
                           0, backend=ONE_RANK_BACKEND, device=RANK_DEVICE)
    out = {"card": smi_line()}
    launches = {}

    def add(got, keys):
        for k in keys:
            launches[k] = launches.get(k, 0) + got[k]
    try:
        tok = Tokenizer().finalize()
        cfg = cfg_7b()
        prompt = list(range(1, 44))
        t0 = time.perf_counter()
        params = random_params_int(cfg, seed=SEED, device=dev)
        ec = EngineConfig(max_seq_len=512, max_batch_size=48,
                          kv_dtype="int8")
        mesh = dict(mesh="model=1", spmd_kernels=True)
        want = _decode_logits(BatchedEngine(cfg, params, tok, ec,
                                            decode_chunk=64, device=dev),
                              [prompt] * 48)
        eng = BatchedEngine(cfg, params, tok, dataclasses.replace(ec, **mesh),
                            decode_chunk=64, device=dev)
        check(eng.mesh is not None and eng.mesh.device_mesh is not None,
              "the engine has no mesh")
        out["batched_logits_err"] = compare(
            "6b BatchedEngine on model=1, one decode step",
            _decode_logits(eng, [prompt] * 48), want, TOL_BF16)
        eng.run()
        del want
        torch.cuda.empty_cache()
        out["batched"], got = serve_batched(eng, BATCHED_PATH, t0, n_new=16)
        add(got, BATCHED_PATH)
        del eng
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ec = EngineConfig(max_seq_len=512, kv_dtype="bfloat16")
        ref = Engine(cfg, params, tok, ec, device=dev)
        eng = Engine(cfg, params, tok, dataclasses.replace(ec, **mesh),
                     device=dev)
        check(eng.mesh is not None and not eng._spmd,
              "a one-rank mesh left the one-card path")
        del params
        out["single_logits_err"] = compare(
            "6b Engine on model=1, the prompt's logits",
            eng._prefill(prompt, 64, eng.new_cache(), 0),
            ref._prefill(prompt, 64, ref.new_cache(), 0), TOL_BF16)
        del ref
        torch.cuda.empty_cache()
        out["single"], got, _ = serve_single(eng, SINGLE_PATH, t0, n_new=16,
                                             chunk=16)
        add(got, SINGLE_PATH)
        del eng
        torch.cuda.empty_cache()

        cfg4 = cfg_7b(4)
        params = random_params_int(cfg4, seed=SEED, device=dev)
        ec = EngineConfig(max_seq_len=512, kv_dtype="int8",
                          max_batch_size=32, fuse_weights=False)
        sprompt = ([7, 121, 3088, 59] * 11)[:43]
        # the arm pinned to speculation: the counted run takes the
        # speculative path whatever the warm-up measured
        kw = dict(decode_chunk=64, width=4, rounds_per_chunk=32,
                  spec_auto=False, device=dev)
        want = _spec_logits(SpecBatchedEngine(cfg4, params, tok, ec, **kw),
                            [sprompt] * 32)
        eng = SpecBatchedEngine(cfg4, params, tok,
                                dataclasses.replace(ec, **mesh), **kw)
        del params
        out["spec_logits_err"] = compare(
            "6b SpecBatchedEngine on model=1, one verify",
            _spec_logits(eng, [sprompt] * 32), want, TOL_BF16)
        del want
        eng.run()
        eng.stats = type(eng.stats)()
        eng.spec_drafted = eng.spec_accepted = 0
        eng.arm_chunks.clear()
        zero_launches()
        with ModeTally() as tally:
            reqs = eng.generate_all([sprompt] * 32, max_new_tokens=33,
                                    temperature=0.0, stop_tokens=())
            torch.cuda.synchronize()
        got = read_launches()
        check_all_pipe(got, tally, "6b speculative serving")
        check(all(len(r.output_tokens) == 33 for r in reqs),
              "6b: a speculative request did not get its tokens")
        for k in SPEC_PATH:
            check(got[k] > 0, f"6b: kernel {k} was not launched on the "
                              f"speculative path")
        out["spec"] = {"aggregate_decode_tok_s": eng.stats.aggregate_tps,
                       "acceptance": eng.acceptance,
                       "chunks_by_arm": dict(eng.arm_chunks),
                       "launches": got, "k1_modes": tally.record()}
        log(f"  6b spec (4 layers): {eng.stats.aggregate_tps:.2f} tok/s, "
            f"acceptance {eng.acceptance:.3f}, arms {dict(eng.arm_chunks)}")
        add(got, SPEC_PATH)
        del eng
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    for label, key in (("batched", "serving"), ("single", "single_serving")):
        ours = out[label]["profile"]["device_busy_ms_per_step"]
        theirs = rec.get(key, {}).get("profile", {}).get(
            "device_busy_ms_per_step")
        out[label]["device_ms_per_step_without_mesh"] = theirs
        log(f"  6b {label}: device {ours:.3f} ms a step on model=1, "
            f"{theirs} without a mesh (phase "
            f"{'4' if label == 'batched' else '4b'})")
    rec["mesh_one"] = out
    return launches


MESH_PROMPTS = [list(range(1 + i, 44 + i)) for i in range(8)]
# 6c: both ranks on the one card, over gloo (NCCL refuses two ranks on one
# GPU); 6b: one rank over NCCL
RANK_DEVICE = "cuda:0"
RANKS_BACKEND = "gloo"
ONE_RANK_BACKEND = "nccl"
# 6c's int8 cache after the bf16 prefill against one rank's, in its first
# layer (the same inputs on both: the embedding, the column-parallel K/V
# projections, rope, the cache writes): the bf16 bar on the rows
# (TOL_BF16 of a row's largest value, 127 quanta) and one quantum for
# the int8 rounding.  Deeper layers' inputs part at bf16 as two one-card
# engines' do (fused against unfused weights: recorded beside them)
CACHE_QUANTA = 1 + 127 * TOL_BF16


def _gloo_probe():
    """gloo's collectives on CUDA tensors on this rank: (all-reduce,
    all-gather and broadcast results by dtype, the wall ms of one
    all-reduce of a 48-row activation by dtype; both ranks on the one
    card, gloo moves CUDA tensors through the host)."""
    import torch
    import torch.distributed as dist
    from fastllama_tpu_torch.parallel.sharding import make_mesh
    rank = dist.get_rank()
    g = make_mesh("model=2").group("model")
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        t = torch.full((4,), rank + 1.0, dtype=dt, device=RANK_DEVICE)
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t, group=g)
        dist.all_reduce(t, group=g)
        b = torch.full((4,), rank + 7.0, dtype=dt, device=RANK_DEVICE)
        dist.broadcast(b, src=0, group=g)
        res[str(dt)] = (t.tolist(), [p.tolist() for p in parts], b.tolist())
    ms = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.ones((48, 4096), dtype=dt, device=RANK_DEVICE)
        for it in range(25):
            if it == 5:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            dist.all_reduce(x, group=g)
        torch.cuda.synchronize()
        ms[str(dt)] = (time.perf_counter() - t0) / 20 * 1e3
    return res, ms


def _host_gb():
    """(this process's resident set now, its peak so far or None where
    ``/proc/self/status`` has no VmHWM), GB (``getrusage``'s peak would
    carry the parent's through the spawn's fork and exec)."""
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                peak = int(line.split()[1]) * 1024 / 1e9
    return rss / 1e9, peak


def _mesh_rank(rank, path, with_6d=False, with_6e=False):
    """Phase 6c on one rank (and, ``with_6d``, phase 6d after it on the
    weights of 6c's ``data=2`` f32 engine): the gloo probe, then on
    ``model=2`` and on
    ``data=2`` the 4-layer 7B FLM INT8 file at ``path`` through
    ``BatchedEngine.load(..., mesh=...)`` (int8 KV, B=8, 8 prompts of 43
    tokens), the rank's host and card memory around the load; greedy
    tokens at f32 compute (rank 0 also those of one rank's engine,
    loaded without a mesh); at bf16 the int8 cache after the prefill (and
    one card's fused engine's against its unfused one) and one decode
    step's logits against one rank's engine, the decode on that engine's
    cache; then the serving run at bf16 with the launch
    counters zeroed just before (K1's modes tallied), its tok/s, peak
    memory and a traced chunk."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    dev = torch.device(RANK_DEVICE)
    out = {"probe": _gloo_probe()}
    for mesh in ("model=2", "data=2"):
        row = {}
        ec = EngineConfig(max_seq_len=512, max_batch_size=8,
                          kv_dtype="int8", compute_dtype="float32",
                          mesh=mesh)
        bf = dataclasses.replace(ec, compute_dtype="bfloat16")
        # one rank's engine, unfused as the mesh engine is: the
        # comparisons isolate the mesh
        one = dict(mesh="", fuse_weights=False)

        def load(e):
            return BatchedEngine.load(path, engine_config=e,
                                      decode_chunk=16, device=dev)

        def gen(e):
            return [r.output_tokens for r in e.generate_all(
                MESH_PROMPTS, max_new_tokens=16, temperature=0.0,
                stop_tokens=())]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rss0, _ = _host_gb()
        t0 = time.perf_counter()
        eng = load(bf)
        torch.cuda.synchronize()
        rss1, peak = _host_gb()
        row.update(
            load_s=time.perf_counter() - t0,
            load_card_peak_gb=(torch.cuda.max_memory_allocated() - base)
            / 1e9,
            host_rss_before_load_gb=rss0, host_rss_after_load_gb=rss1,
            host_peak_rss_gb=peak,
            weight_shard_gb=sum(
                t.numel() * t.element_size() for f in dataclasses.fields(
                    eng.params) for t in _leaf_tensors(
                        getattr(eng.params, f.name))) / 1e9,
            wq_shape=tuple(eng.params.wq.data.shape))
        with ModeTally() as tally:
            zero_launches()
            f32_eng = load(ec)
            row["tokens_f32"] = gen(f32_eng)
            f32_launches = read_launches()
        check_all_wide(f32_launches, tally, f"6c {mesh} rank {rank} f32")
        if mesh == "data=2" and with_6d:
            weights = (f32_eng.config, f32_eng.params, f32_eng.tokenizer)
        del f32_eng
        if rank == 0:
            row["tokens_f32_one_rank"] = gen(load(
                dataclasses.replace(ec, **one)))
        one_eng = load(dataclasses.replace(bf, **one))
        _admit(one_eng, MESH_PROMPTS)
        _admit(eng, MESH_PROMPTS)
        row["cache_quanta"] = _cache_quanta(eng, one_eng.cache, 43)
        # one card against itself: fused weights, the same prompts
        fused = load(dataclasses.replace(bf, mesh=""))
        _admit(fused, MESH_PROMPTS)
        row["cache_quanta_one_card_fused"] = _cache_quanta(
            fused, one_eng.cache, 43)
        del fused
        ref = _decode_logits(one_eng, MESH_PROMPTS, admit=False)
        lg = _decode_logits(eng, MESH_PROMPTS, cache_from=one_eng.cache,
                            admit=False)
        if rank == 0:
            row["logits_bf16_err"] = float((lg - ref).abs().max()
                                           / ref.abs().max())
        del one_eng, ref, lg
        eng.run()
        eng.generate_all(MESH_PROMPTS, max_new_tokens=3, temperature=0.0,
                         stop_tokens=())
        eng.stats = type(eng.stats)()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        with ModeTally() as tally:
            reqs = eng.generate_all(MESH_PROMPTS, max_new_tokens=32,
                                    temperature=0.0, stop_tokens=())
            torch.cuda.synchronize()
        launches = read_launches()
        check_all_pipe(launches, tally, f"6c {mesh} rank {rank} bf16")
        check(all(len(r.output_tokens) == 32 for r in reqs),
              f"6c {mesh}: a request did not get its tokens")
        steps = launches["decode_write"]
        st = eng.stats
        row.update(
            tokens_bf16=[r.output_tokens for r in reqs],
            aggregate_decode_tok_s=st.aggregate_tps,
            ms_per_decode_step=st.decode_s / max(steps, 1) * 1e3,
            decode_steps=steps,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            cache_shape=tuple(eng.cache.k.shape), launches=launches,
            k1_modes=tally.record(),
            profile=profile_decode(eng, MESH_PROMPTS[0],
                                   st.decode_s / max(steps, 1) * 1e3,
                                   n_steps=8))
        out[mesh] = row
        del eng
        torch.cuda.empty_cache()
    if with_6d:
        out["6d"] = _multihost_rank(rank, *weights)
    if with_6e:
        out["6e"] = _spec_mesh_rank(rank, path)
    return out


# phase 6e: tools/spec_bench.py's loop prompt, the tokens a run, and one
# verify block after the prompt (the loop's next four)
SPEC_MESH_PROMPT = ([7, 121, 3088, 59] * 11)[:43]
SPEC_MESH_NEW = 32
SPEC_MESH_VERIFY = [59, 7, 121, 3088]


def _verify_logits(eng):
    """An engine's logits (4, V) of one verify of ``SPEC_MESH_VERIFY``
    after ``SPEC_MESH_PROMPT`` on a fresh cache, as a numpy array (a rank
    returns it to the parent)."""
    import torch
    prompt, dev = SPEC_MESH_PROMPT, eng.device
    cache = eng.new_cache()
    eng._prefill(prompt, eng._bucket(len(prompt)), cache, 0)
    positions = torch.arange(len(prompt), len(prompt) + 4,
                             dtype=torch.int32, device=dev)
    lg = eng._verify(torch.tensor(SPEC_MESH_VERIFY, dtype=torch.int32,
                                  device=dev), positions, cache)
    return lg.float().cpu().numpy()


def _spec_mesh_rank(rank, path):
    """Phase 6e on one rank of ``model=2``: the single-stream
    ``SpeculativeEngine`` (width 4) over ``Engine.load(path, mesh=...)``
    (the 4-layer 7B FLM INT8 file, f32 scales): greedy
    tokens at f32 compute and an f32 cache with the n-gram drafter and
    with a ``truncate_params(..., 2)`` draft on the same mesh (rank 0
    also one rank's engine without a mesh: its speculative and plain
    greedy tokens), and one verify's logits at f32 (rank 0 also one
    rank's engine's, unfused as the mesh engine is); then at bf16 compute
    over the engine's default f32 cache and over a bf16 cache, each: one
    verify's logits (rank 0 also one rank's engine's), a 32-token
    counted run, the counters zeroed just before (ms a round, its
    launches by mode, peak memory), and two chunks of 4 rounds for
    device ms a round and the idle share.  Returns the readings and the
    launches of the counted runs."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.models.llama import truncate_params
    from fastllama_tpu_torch.runtime.engine import Engine
    from fastllama_tpu_torch.runtime.speculative import SpeculativeEngine
    t_start = time.perf_counter()
    dev = torch.device(RANK_DEVICE)
    # f32 scales on both sides (one card's "auto" would narrow them)
    ec = EngineConfig(max_seq_len=512, compute_dtype="float32",
                      kv_dtype="float32", scale_dtype="float32",
                      mesh="model=2")
    kw = dict(max_new_tokens=SPEC_MESH_NEW, temperature=0.0,
              stop_tokens=())
    prompt = SPEC_MESH_PROMPT
    row, launches = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    eng = Engine.load(path, engine_config=ec, device=dev)
    cfg_d, params_d = truncate_params(eng.config, eng.params, 2)
    draft = Engine(cfg_d, params_d, eng.tokenizer, ec, dev, sharded=True)
    with ModeTally() as tally:
        zero_launches()
        for name, d in (("ngram", None), ("draft", draft)):
            toks, st = SpeculativeEngine(eng, d, width=4).generate(prompt,
                                                                   **kw)
            row[f"tokens_f32_{name}"] = toks
            row[f"acceptance_f32_{name}"] = st.acceptance
        got = read_launches()
    check_all_wide(got, tally, f"6e rank {rank} f32")
    add(got)
    row["verify_f32"] = _verify_logits(eng)
    del eng, draft, params_d
    if rank == 0:
        one = Engine.load(path, engine_config=dataclasses.replace(
            ec, mesh="", fuse_weights=False), device=dev)
        row["verify_one_rank_f32"] = _verify_logits(one)
        row["tokens_f32_one_rank"] = SpeculativeEngine(
            one, None, width=4).generate(prompt, **kw)[0]
        row["plain_f32_one_rank"] = one.generate(prompt, decode_chunk=32,
                                                 **kw)[0]
        del one
    torch.cuda.empty_cache()

    # bf16 compute over the default f32 cache, then over a bf16 one
    for kv in ("float32", "bfloat16"):
        ec_b = dataclasses.replace(ec, compute_dtype="bfloat16",
                                   kv_dtype=kv)
        if rank == 0:
            one = Engine.load(path, engine_config=dataclasses.replace(
                ec_b, mesh="", fuse_weights=False), device=dev)
            row[f"verify_one_rank_{kv}"] = _verify_logits(one)
            del one
            torch.cuda.empty_cache()
        eng = Engine.load(path, engine_config=ec_b, device=dev)
        row[f"verify_{kv}"] = _verify_logits(eng)
        spec = SpeculativeEngine(eng, None, width=4)
        spec.generate(prompt, max_new_tokens=8, temperature=0.0,
                      stop_tokens=())                        # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with ModeTally() as tally:
            zero_launches()
            toks, st = spec.generate(prompt, **kw)
            torch.cuda.synchronize()
            got = read_launches()
        label = f"6e rank {rank} bf16 over {kv} cache"
        check_all_pipe(got, tally, label)
        check(got["flash_spec_batched_split"] == got["flash_spec_batched"]
              > 0 and got["spec_write"] > 0,
              f"{label}: K2s {got['flash_spec_batched_split']} of "
              f"{got['flash_spec_batched']} launches split, spec_write "
              f"{got['spec_write']}")
        add(got)
        row[f"bf16_{kv}_cache"] = dict(
            tokens=toks, rounds=st.rounds, acceptance=st.acceptance,
            decode_tok_s=st.decode_tps,
            ms_per_round=st.decode_s / max(st.rounds, 1) * 1e3,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=got, k1_modes=tally.record(),
            launches_per_round={k: got[k] / max(st.rounds, 1) for k in (
                "qmatmul_pallas", "qmatmul_pallas_indexed",
                "flash_spec_batched", "spec_write") if got.get(k)},
            profile=profile_spec_single(spec, prompt, rounds=4))
        del spec, eng
        torch.cuda.empty_cache()
    row["launches"] = launches
    row["seconds"] = time.perf_counter() - t_start
    return row


def phase_spec_mesh(ranks, rec):
    """Phase 6e's checks on what 6c's ranks returned: f32 greedy tokens
    of both drafters on both ranks equal to one rank's engine's, and the
    f32 verify's logits within TOL_F32·max|ref| of one rank's; at bf16
    compute over the f32 and the bf16 cache, the tokens equal on both
    ranks, and each rank's verify logits no further from the f32
    verify's than one rank's engine's bf16 logits are, plus
    TOL_BF16·max|ref|.  The f32 verify is the reference: at 7B width
    each bf16 path lies ≈ 1.8e-2·max|ref| from it, so two bf16 paths
    that round at different places (K1f's prologue, the all-reduce, the
    vocabulary-sharded classifier) part by more than TOL_BF16 from each
    other; that parting is logged.  Returns both ranks' launches
    summed."""
    import torch
    r0, r1 = (r["6e"] for r in ranks)
    one = r0["tokens_f32_one_rank"]
    launches = {}
    for r, row in enumerate((r0, r1)):
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for name in ("ngram", "draft"):
            check(row[f"tokens_f32_{name}"] == one,
                  f"6e rank {r}: f32 tokens with the {name} drafter differ "
                  f"from one rank's engine's")
        log(f"  6e rank {r}: f32 acceptance n-gram "
            f"{row['acceptance_f32_ngram']:.3f}, draft "
            f"{row['acceptance_f32_draft']:.3f}; "
            f"{row['seconds']:.1f} s in the rank")
    check(one == r0["plain_f32_one_rank"],
          "6e: one rank's speculative tokens differ from its plain greedy")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    # the f32 verify's logits: the reference of the bf16 ones
    ref = torch.from_numpy(r0.pop("verify_one_rank_f32"))
    f32 = {r: torch.from_numpy(row.pop("verify_f32"))
           for r, row in enumerate((r0, r1))}
    for r in (0, 1):
        rec_f32 = rel(f32[r], ref)
        log(f"  6e rank {r} verify logits at f32 against one rank's: "
            f"{rec_f32:.3e} of max|ref|")
        check(rec_f32 <= TOL_F32, f"6e rank {r}: f32 verify logits "
                                  f"{rec_f32:.3e} of max|ref| from one "
                                  f"rank's")
        (r0, r1)[r]["verify_f32_rel_err"] = rec_f32
    for kv in ("float32", "bfloat16"):
        want = torch.from_numpy(r0.pop(f"verify_one_rank_{kv}"))
        one_vs_f32 = rel(want, ref)
        for r, row in enumerate((r0, r1)):
            got = torch.from_numpy(row.pop(f"verify_{kv}"))
            b = row[f"bf16_{kv}_cache"]
            b["verify_logits_rel_err"] = rel(got, want)
            b["verify_logits_f32_rel_err"] = rel(got, ref)
            b["one_rank_f32_rel_err"] = one_vs_f32
            log(f"  6e rank {r} bf16 over {kv} cache: verify logits "
                f"{b['verify_logits_rel_err']:.3e} of max|ref| from one "
                f"rank's; from the f32 verify's: this rank "
                f"{b['verify_logits_f32_rel_err']:.3e}, one rank's "
                f"{one_vs_f32:.3e}")
            check(b["verify_logits_f32_rel_err"] <= one_vs_f32 + TOL_BF16,
                  f"6e rank {r} bf16 over {kv} cache: verify logits "
                  f"{b['verify_logits_f32_rel_err']:.3e} of max|ref| from "
                  f"the f32 verify's, one rank's {one_vs_f32:.3e} + "
                  f"{TOL_BF16}")
            log(f"  6e rank {r} bf16 over {kv} cache: "
                f"{b['ms_per_round']:.3f} ms a round over {b['rounds']} "
                f"rounds ({b['decode_tok_s']:.2f} tok/s, acceptance "
                f"{b['acceptance']:.3f}), device "
                f"{b['profile']['device_busy_ms_per_round']:.3f} ms a round "
                f"(idle {b['profile']['device_idle_share']:.3f}), peak "
                f"{b['max_memory_allocated_gb']:.3f} GB; launches a round "
                f"{b['launches_per_round']}; K1 {b['k1_modes']}")
        check(r0[f"bf16_{kv}_cache"]["tokens"]
              == r1[f"bf16_{kv}_cache"]["tokens"],
              f"6e: the ranks emitted different tokens at bf16 over the "
              f"{kv} cache")
    log(f"  ok 6e: f32 tokens of both drafters on both ranks equal one "
        f"rank's engine's ({len(one)} tokens), f32 verify logits within "
        f"{TOL_F32} of one rank's; at bf16 over the f32 and the bf16 "
        f"cache the verify logits as close to the f32 verify's as one "
        f"rank's (+ {TOL_BF16}) and the tokens equal on both ranks; K2s "
        f"split and spec_write launched on each")
    rec["spec_mesh"] = {"card": smi_line(), "ranks": [r0, r1]}
    return launches


def _multihost_rank(rank, cfg, params, tok):
    """Phase 6d on one rank of ``data=2`` (a host a rank), on 6c's f32
    weights: ``MultiHostEngine`` at f32 on the host's prompts
    (``MESH_PROMPTS[4d:4d+4]``, 4 slots, int8 KV, the prefix cache on),
    then a donor and a prefix hit on it; the fleet's stats;
    ``MultiHostSpecEngine`` (width 2) at f32 on the same prompts; one
    16-token counted run at bf16 (ms a step, launches by mode, peak
    memory, a traced chunk).  Each run's launches with the counters
    zeroed just before it; returns them summed beside the readings."""
    import torch
    from fastllama_tpu_torch.config import EngineConfig
    from fastllama_tpu_torch.parallel.sharding import make_mesh
    from fastllama_tpu_torch.runtime.multihost import MultiHostEngine
    from fastllama_tpu_torch.runtime.spec_multihost import \
        MultiHostSpecEngine
    t_start = time.perf_counter()
    dev = torch.device(RANK_DEVICE)
    mesh = make_mesh("data=2")
    ec = EngineConfig(max_seq_len=512, max_batch_size=4, kv_dtype="int8",
                      compute_dtype="float32", mesh="data=2",
                      prefix_cache=True)
    row, launches = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    def serve(e, prompts, n):
        return [r.output_tokens for r in e.generate_all(
            prompts, max_new_tokens=n, temperature=0.0, stop_tokens=())]
    eng = MultiHostEngine(cfg, params, tok, ec, 16, mesh, dev, sharded=True)
    d = eng.host
    prompts = MESH_PROMPTS[4 * d:4 * d + 4]
    with ModeTally() as tally:
        zero_launches()
        row["tokens_f32"] = serve(eng, prompts, 16)
        # a donor live past its first chunk, then a prompt sharing its
        # first 32 tokens: a hit on this host's own donor
        donor = eng.submit(prompts[0], max_new_tokens=24, temperature=0.0,
                           stop_tokens=())
        eng.step()
        hit = eng.submit(prompts[0][:32] + [7, 8, 9], max_new_tokens=8,
                         temperature=0.0, stop_tokens=())
        eng.run()
        got = read_launches()
    check(donor.done and hit.done and len(hit.output_tokens) == 8,
          f"6d rank {rank}: the donor or the hit did not complete")
    check_all_wide(got, tally, f"6d rank {rank} f32")
    add(got)
    row.update(hits=eng.stats.prefix_hits,
               hit_rows=eng.stats.prefix_rows_reused,
               completed=eng.stats.completed,
               global_stats=dataclasses.asdict(eng.global_stats()),
               host=d)
    del eng
    spec = MultiHostSpecEngine(cfg, params, tok,
                               dataclasses.replace(ec, prefix_cache=False),
                               16, mesh, width=2, rounds_per_chunk=8,
                               spec_auto=False, device=dev, sharded=True)
    with ModeTally() as tally:
        zero_launches()
        row["spec_tokens_f32"] = serve(spec, prompts, 16)
        got = read_launches()
    check_all_wide(got, tally, f"6d rank {rank} spec f32")
    add(got)
    row.update(spec_drafted=spec.spec_drafted,
               spec_acceptance=spec.acceptance,
               spec_arms=dict(spec.arm_chunks))
    del spec
    eng = MultiHostEngine(cfg, params, tok,
                          dataclasses.replace(ec, compute_dtype="bfloat16",
                                              prefix_cache=False),
                          16, mesh, dev, sharded=True)
    serve(eng, prompts, 3)                  # warm
    eng.stats = type(eng.stats)()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with ModeTally() as tally:
        zero_launches()
        row["tokens_bf16"] = serve(eng, prompts, 16)
        torch.cuda.synchronize()
        got = read_launches()
    check_all_pipe(got, tally, f"6d rank {rank} bf16")
    check(all(len(t) == 16 for t in row["tokens_bf16"]),
          f"6d rank {rank}: a bf16 request did not get its tokens")
    add(got)
    steps = got["decode_write"]
    st = eng.stats
    row.update(
        aggregate_decode_tok_s=st.aggregate_tps,
        ms_per_decode_step=st.decode_s / max(steps, 1) * 1e3,
        decode_steps=steps,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        cache_shape=tuple(eng.cache.k.shape), launches_bf16=got,
        k1_modes=tally.record(),
        profile=profile_decode(eng, prompts[0],
                               st.decode_s / max(steps, 1) * 1e3,
                               n_steps=8))
    del eng
    torch.cuda.empty_cache()
    row["launches"] = launches
    row["seconds"] = time.perf_counter() - t_start
    return row


def _multihost_cli_rank(rank, path, pf):
    """Phase 6d's CLI on one rank, as torchrun starts it: the rank joins
    from torchrun's variables (gloo on the one card, as 6c's ranks), then
    ``serve --multihost --mesh data=2`` in this process; (rc, stdout,
    stderr)."""
    import io
    from fastllama_tpu_torch import cli
    from fastllama_tpu_torch.parallel import distributed
    distributed.initialize(backend=RANKS_BACKEND, device=RANK_DEVICE)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["-c", path, "-m", "serve", "--multihost", "--mesh",
                       "data=2", "--batch", "4", "--prompts-file", pf, "-n",
                       "8", "-t", "0", "--max-seq-len", "512", "--kv-dtype",
                       "int8", "--device", RANK_DEVICE])
    return rc, out.getvalue(), err.getvalue()


def _leaf_tensors(v):
    if v is None:
        return []
    return [v.data, v.scales] if hasattr(v, "scales") else [v]


def phase_mesh_two(dev, rec, files, with_6d=False, with_6e=False):
    """Phase 6c: two ranks on the one card (NCCL refuses two ranks on one
    GPU; each rank is given ``cuda:0`` and the gloo backend), spawned by
    ``parallel.distributed.run_ranks``: a probe of gloo's collectives on
    CUDA tensors, then ``model=2`` and ``data=2`` on the 4-layer 7B FLM
    INT8 file (phase 4m's), loaded by each rank with the mesh (its shard
    alone), int8 KV: greedy tokens at f32 compute equal to one rank's
    engine on the same file; at bf16 the first layer's int8 cache after
    the prefill within ``CACHE_QUANTA`` of one rank's (every layer's
    recorded beside one card's fused engine against its unfused one) and
    one decode step's logits within 1e-2·max|ref|; per rank the host and card memory of the load,
    the launches by mode (every K1 launch on the ring or the prefill
    kernel at bf16, the wide kernels at f32), device ms a step and peak
    memory.  A rank that fails fails the phase.  Both ranks share one
    card: no scaling is measured here."""
    from fastllama_tpu_torch.parallel import distributed
    log("phase 6c: two gloo ranks on the one card, model=2 and data=2, "
        "the 4-layer 7B FLM INT8 file loaded on a mesh, int8 KV")
    try:
        ranks = distributed.run_ranks(
            _mesh_rank, 2, files.paths["flm4"], with_6d, with_6e,
            device=RANK_DEVICE, backend=RANKS_BACKEND, timeout=600)
    except Exception as e:              # a rank raised, died or hung
        raise Failed(f"6c: a rank failed: {e}") from e
    for r, row in enumerate(ranks):
        for dt, (red, gat, bc) in row["probe"][0].items():
            check(red == [3.0] * 4 and gat == [[1.0] * 4, [2.0] * 4]
                  and bc == [7.0] * 4,
                  f"gloo on CUDA tensors, rank {r} {dt}: {row['probe'][0]}")
    ms = [row["probe"][1] for row in ranks]
    log(f"  ok gloo all_reduce, all_gather, broadcast on CUDA tensors "
        f"(f32, bf16) on both ranks; one all-reduce of 48x4096, ms by "
        f"rank: {ms}")
    out = {"card": smi_line(), "all_reduce_48x4096_ms": ms}
    launches = {}
    for mesh in ("model=2", "data=2"):
        r0, r1 = ranks[0][mesh], ranks[1][mesh]
        for r, row in enumerate((r0, r1)):
            for k, v in row["launches"].items():
                launches[k] = launches.get(k, 0) + v
            fused_q = row["cache_quanta_one_card_fused"]
            log(f"  6c {mesh} rank {r}: load {row['load_s']:.2f} s, card "
                f"+{row['load_card_peak_gb']:.3f} GB at peak, host RSS "
                f"{row['host_rss_before_load_gb']:.3f} -> "
                f"{row['host_rss_after_load_gb']:.3f} GB (peak "
                f"{row['host_peak_rss_gb']}), weight shard "
                f"{row['weight_shard_gb']:.3f} GB, wq {row['wq_shape']}; "
                f"cache quanta from one rank's by layer "
                f"{[round(q, 3) for q in row['cache_quanta']]} (one card "
                f"fused against unfused "
                f"{[round(q, 3) for q in fused_q]}); "
                f"{row['aggregate_decode_tok_s']:.2f} tok/s, "
                f"{row['ms_per_decode_step']:.3f} ms a step, device "
                f"{row['profile']['device_busy_ms_per_step']:.3f} ms a step "
                f"(idle {row['profile']['device_idle_share']:.3f}), peak "
                f"{row['max_memory_allocated_gb']:.3f} GB, cache "
                f"{row['cache_shape']}, K1 {row['k1_modes']}")
        log(f"  6c {mesh}: bf16 logits {r0['logits_bf16_err']:.3e} of "
            f"max|ref| from one rank's")
        check(r0["tokens_f32"] == r1["tokens_f32"]
              == r0["tokens_f32_one_rank"],
              f"6c {mesh}: greedy tokens at f32 differ from one rank's")
        check(r0["tokens_bf16"] == r1["tokens_bf16"],
              f"6c {mesh}: the ranks emitted different tokens")
        check(r0["logits_bf16_err"] <= TOL_BF16,
              f"6c {mesh}: bf16 logits {r0['logits_bf16_err']:.3e} of "
              f"max|ref| from one rank's")
        for r, row in enumerate((r0, r1)):
            check(row["cache_quanta"][0] <= CACHE_QUANTA,
                  f"6c {mesh} rank {r}: the bf16 prefill's int8 cache of "
                  f"layer 0 is {row['cache_quanta'][0]:.3f} quanta from one "
                  f"rank's (bar {CACHE_QUANTA})")
        out[mesh] = {"ranks": [r0, r1], "logits_bf16_err":
                     r0["logits_bf16_err"]}
        log(f"  ok 6c {mesh}: f32 tokens equal one rank's, bf16 logits "
            f"{r0['logits_bf16_err']:.3e} of max|ref|, layer 0's cache "
            f"within {max(r0['cache_quanta'][0], r1['cache_quanta'][0]):.3f}"
            f" quanta")
    for k in BATCHED_PATH:
        check(launches[k] > 0, f"6c: kernel {k} was not launched")
    rec["mesh_two"] = out
    if with_6d:
        # 6d runs in 6c's ranks: 6c's seconds hold 6d's
        t1 = time.perf_counter()
        got = phase_multihost(ranks, files, rec)
        rec["phase_s"]["6d"] = (time.perf_counter() - t1 + max(
            row["6d"]["seconds"] for row in ranks))
        log(f"  phase 6d took {rec['phase_s']['6d']:.1f} s (in 6c's ranks "
            f"and its CLI; counted in 6c's seconds too)")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    if with_6e:
        # 6e runs in 6c's ranks: 6c's seconds hold 6e's
        rec["phase_s"]["6e"] = max(row["6e"]["seconds"] for row in ranks)
        for k, v in phase_spec_mesh(ranks, rec).items():
            launches[k] = launches.get(k, 0) + v
        log(f"  phase 6e took {rec['phase_s']['6e']:.1f} s in the ranks "
            f"(counted in 6c's seconds too)")
    return launches


def phase_multihost(ranks, files, rec):
    """Phase 6d's checks on what 6c's ranks returned, then its CLI run.
    Returns both ranks' launches summed."""
    from fastllama_tpu_torch.parallel import distributed
    r0, r1 = (r["6d"] for r in ranks)
    one = ranks[0]["data=2"]["tokens_f32_one_rank"]
    launches = {}
    for r, row in enumerate((r0, r1)):
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
        check(row["host"] == r, f"6d: rank {r} is host {row['host']}")
        check(row["hits"] >= 1, f"6d host {r}: no prefix hit on its donor")
        check(row["spec_drafted"] > 0, f"6d host {r}: the spec engine "
                                       f"drafted nothing")
        log(f"  6d host {r}: {row['hits']} prefix hit(s), "
            f"{row['hit_rows']} rows reused; spec acceptance "
            f"{row['spec_acceptance']:.3f}, arms {row['spec_arms']}; bf16 "
            f"{row['aggregate_decode_tok_s']:.2f} tok/s, "
            f"{row['ms_per_decode_step']:.3f} ms a step, device "
            f"{row['profile']['device_busy_ms_per_step']:.3f} ms a step "
            f"(idle {row['profile']['device_idle_share']:.3f}), peak "
            f"{row['max_memory_allocated_gb']:.3f} GB, cache "
            f"{row['cache_shape']}, K1 {row['k1_modes']}; "
            f"{row['seconds']:.1f} s in the rank")
    check(r0["tokens_f32"] + r1["tokens_f32"] == one,
          "6d: MultiHostEngine's f32 tokens by host differ from one rank's")
    check(r0["spec_tokens_f32"] + r1["spec_tokens_f32"] == one,
          "6d: MultiHostSpecEngine's f32 tokens differ from one rank's")
    g = r0["global_stats"]
    check(g == r1["global_stats"], f"6d: global_stats differ between the "
                                   f"ranks: {g} / {r1['global_stats']}")
    check(g["completed"] == r0["completed"] + r1["completed"] == 12
          and g["prefix_hits"] == r0["hits"] + r1["hits"],
          f"6d: global_stats {g} against the hosts' own "
          f"{r0['completed']} + {r1['completed']} requests")
    log(f"  ok 6d: f32 tokens of both engines by host equal one rank's; "
        f"global_stats equal on both ranks, {g['completed']} requests, "
        f"{g['prefix_hits']} hits")
    # the CLI: every line a host's share (d::2), completions by host
    pf = os.path.join(os.path.dirname(files.paths["flm4"]),
                      "multihost_prompts.txt")
    with open(pf, "w") as f:
        f.write("the cat sat on the mat\nonce upon a time\n"
                "a big dog ran home\nhello there world\n")
    t0 = time.perf_counter()
    try:
        clis = distributed.run_ranks(_multihost_cli_rank, 2,
                                     files.paths["flm4"], pf, join=False,
                                     timeout=300)
    except Exception as e:              # a rank raised, died or hung
        raise Failed(f"6d: a CLI rank failed: {e}") from e
    for r, (rc, so, se) in enumerate(clis):
        check(rc == 0 and so.count(" tokens=") == 2
              and "fleet: 4 requests" in se,
              f"6d CLI host {r}: rc {rc}, stdout {so[-400:]!r}, stderr "
              f"{se[-400:]!r}")
    log(f"  ok 6d CLI: serve --multihost --mesh data=2 on two ranks, rc 0, "
        f"2 completions a host, the fleet line on each "
        f"({time.perf_counter() - t0:.1f} s)")
    rec["multihost"] = {"card": smi_line(), "ranks": [r0, r1],
                        "cli_s": time.perf_counter() - t0,
                        "cli_fleet": [se.strip().splitlines()[-1]
                                      for _, _, se in clis]}
    for k in BATCHED_PATH + ("flash_block_attend_tf32",
                             "flash_spec_batched_split", "spec_write"):
        check(launches.get(k, 0) > 0, f"6d: kernel {k} was not launched")
    return launches


SOURCES = {
    "qmatmul_pallas": ("fastllama_tpu_torch/csrc/qmm.cu",
                       "fastllama_tpu/ops/pallas/qmm.py:251"),
    "qmatmul_pallas_indexed": ("fastllama_tpu_torch/csrc/qmm.cu",
                               "fastllama_tpu/ops/pallas/qmm.py:551"),
    "qmatmul_pallas_indexed_fused": ("fastllama_tpu_torch/csrc/qmm.cu",
                                     "fastllama_tpu/ops/pallas/qmm.py:470"),
    "flash_decode_batched": ("fastllama_tpu_torch/csrc/flash_decode_fresh.cu",
                             "fastllama_tpu/ops/pallas/flash_decode.py:203"),
    "flash_decode_single": ("fastllama_tpu_torch/csrc/flash_decode.cu",
                            "fastllama_tpu/ops/pallas/flash_decode.py:299"),
    "decode_attention_pallas_indexed": (
        "fastllama_tpu_torch/csrc/flash_decode.cu",
        "fastllama_tpu/ops/pallas/attention.py:110"),
    "decode_attention_pallas": ("fastllama_tpu_torch/csrc/flash_decode.cu",
                                "fastllama_tpu/ops/pallas/attention.py:48"),
    "decode_write": ("fastllama_tpu_torch/csrc/kv_write.cu",
                     "fastllama_tpu/ops/pallas/kv_write.py:119"),
    "prefill_write": ("fastllama_tpu_torch/csrc/kv_write.cu",
                      "fastllama_tpu/ops/pallas/kv_write.py:244"),
    "flash_spec_batched": ("fastllama_tpu_torch/csrc/flash_decode.cu",
                           "fastllama_tpu/ops/pallas/flash_decode.py:700"),
    "spec_write": ("fastllama_tpu_torch/csrc/kv_write.cu",
                   "fastllama_tpu/ops/pallas/kv_write.py:392"),
    "decode_attention_pallas_batched": (
        "fastllama_tpu_torch/csrc/flash_decode.cu",
        "fastllama_tpu/ops/pallas/attention.py:178"),
    "qmatmul_pallas_p4": ("fastllama_tpu_torch/csrc/qmm.cu",
                          "fastllama_tpu/ops/pallas/qmm.py:271"),
    "qmatmul_pallas_indexed_p4": ("fastllama_tpu_torch/csrc/qmm.cu",
                                  "fastllama_tpu/ops/pallas/qmm.py:601"),
    "qmatmul_pallas_indexed_fused_p4": ("fastllama_tpu_torch/csrc/qmm.cu",
                                        "fastllama_tpu/ops/pallas/qmm.py:601"),
    "flash_block_attend": ("fastllama_tpu_torch/csrc/flash_block_tc.cu",
                           "fastllama_tpu/ops/pallas/flash_decode.py:426"),
    "flash_decode_batched_stats": (
        "fastllama_tpu_torch/csrc/flash_decode_fresh.cu",
        "fastllama_tpu/ops/pallas/flash_decode.py:203"),
    "qmatmul_pallas_groupdot": ("fastllama_tpu_torch/csrc/qmm.cu",
                                "fastllama_tpu/ops/pallas/qmm.py:89"),
    "qmatmul_pallas_groupdot_p4": ("fastllama_tpu_torch/csrc/qmm.cu",
                                   "fastllama_tpu/ops/pallas/qmm.py:405"),
    "flash_block_attend_tf32": (
        "fastllama_tpu_torch/csrc/flash_block_tf32.cu",
        "fastllama_tpu/ops/pallas/flash_decode.py:426"),
}
# the split-row modes of K2 and K2s: their source, the TPU function of
# their wrapper (flash_decode_batched's: the fresh and stats split mode,
# which its main paths run, in its wrapper's source)
SOURCES.update({k + "_split": ("fastllama_tpu_torch/csrc/flash_decode_split.cu",
                               SOURCES[k][1])
                for k in SPLIT_WRAPPERS + ("flash_spec_batched",)})
SOURCES.update({k + "_split": SOURCES[k] for k in (
    "flash_decode_batched", "flash_decode_batched_stats")})
# the pipelined mode of K1 and K1p (INT8 and packed alike): K1's wrappers;
# the groupdot mode's ring, K1's groupdot function; the wide mode's ring,
# K1's wrappers (the JAX wide branch, _qmm_chunk's, runs in each)
SOURCES.update({k + "_pipe": SOURCES[k] for k in (
    "qmatmul_pallas", "qmatmul_pallas_indexed",
    "qmatmul_pallas_indexed_fused", "qmatmul_pallas_groupdot")})
SOURCES.update({k + "_wide_pipe": SOURCES[k] for k in (
    "qmatmul_pallas", "qmatmul_pallas_indexed",
    "qmatmul_pallas_indexed_fused")})
# the prefill mode of K1 and K1p (T > 128): its own source, the TPU
# functions of K1's wrappers
SOURCES.update({k + "_prefill": ("fastllama_tpu_torch/csrc/qmm_prefill.cu",
                                 SOURCES[k][1]) for k in (
    "qmatmul_pallas", "qmatmul_pallas_indexed",
    "qmatmul_pallas_indexed_fused")})
# the wide mode's prefill kernel (f32 compute, T > 128): the same source,
# the TPU functions of K1's wrappers (the JAX wide branch runs in each)
SOURCES.update({k + "_wide_prefill": (
    "fastllama_tpu_torch/csrc/qmm_prefill.cu", SOURCES[k][1]) for k in (
    "qmatmul_pallas", "qmatmul_pallas_indexed",
    "qmatmul_pallas_indexed_fused")})


# the modes a loaded model puts on a path (phases 3h, 4m, 4n, 4o): K1 and
# K1f at group size 32 (GGUF Q8_0) on the G32 instantiations of the ring
# (qmm.cu) and, above 128 rows, of the prefill mode (qmm_prefill.cu), at
# bf16 compute and in the wide mode (f32 compute); at INT16 the wide ring's
# INT16 instantiation and the wide prefill kernel's; the TPU functions of
# their wrappers
SOURCES.update({k + s: SOURCES[k] for k in (
    "qmatmul_pallas_indexed", "qmatmul_pallas_indexed_fused")
    for s in ("_gs32", "_wide_gs32", "_int16")})
SOURCES.update({k + s + "_prefill": (
    "fastllama_tpu_torch/csrc/qmm_prefill.cu", SOURCES[k][1]) for k in (
    "qmatmul_pallas_indexed", "qmatmul_pallas_indexed_fused")
    for s in ("_gs32", "_wide_gs32", "_int16")})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,3d,3e,3f,3g,3h,4,4p,4b,4c,4d,4e,4f,"
                            "4i,4j,4k,4l,4m,4n,4o,4g,4h,6,6b,6c,6d,6e,5",
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--regs-against", metavar="CU", action="append",
                    default=[],
                    help="another tree's csrc/flash_decode.cu, csrc/qmm.cu "
                         "or csrc/qmm_prefill.cu (such as the parent "
                         "commit's; may repeat), built beside the kernels "
                         "with the same flags: phase 1 then requires the "
                         "registers of every instantiation of the split "
                         "kernels of K2 and K2s, of qmm_pipe_kernel, "
                         "qmm_pipe_gd_kernel, qmm_pipe_wide_kernel, "
                         "qmm_bf16_kernel and qmm_f32_kernel, or of "
                         "qmm_wgmma_kernel and qmm_wgmma_wide_kernel, to "
                         "be equal in both")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if "4m" in phases and not {"4", "4b"} <= phases:
        ap.error("phase 4m holds its launch counts to phases 4 and 4b's: "
                 "run those with it (--phases ...,4,4b,4m)")
    if "4p" in phases and "4" not in phases:
        ap.error("phase 4p runs on phase 4's engine: run 4 with it "
                 "(--phases ...,4,4p)")
    if "6e" in phases and "6c" not in phases:
        ap.error("phase 6e runs in phase 6c's rank processes: run 6c with "
                 "it (--phases ...,6c,6e)")
    if "6d" in phases and "6c" not in phases:
        ap.error("phase 6d runs in phase 6c's rank processes: run 6c with "
                 "it (--phases ...,6c,6d)")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from fastllama_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"card": smi_line(), "torch": torch.__version__,
           "torch_cuda": torch.version.cuda,
           "device_name": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count()}
    try:
        import triton
        rec["triton"] = triton.__version__
    except ImportError:
        rec["triton"] = None
    log(f"card: {rec['card']}")
    log(f"torch {rec['torch']} cuda {rec['torch_cuda']} triton "
        f"{rec['triton']}")
    nv = _build.nvcc_version()
    rec["nvcc"] = nv.splitlines()[-1]
    log(nv)
    # phase 4m's and 6c's files are written while nvcc builds (the card
    # is idle)
    files = (FileSet(dev) if "4m" in phases
             else FileSet(dev, ("flm4",)) if "6c" in phases else None)
    try:
        return run_phases(args, phases, dev, rec, files)
    finally:
        if files is not None:
            files.remove()


def run_phases(args, phases, dev, rec, files) -> int:
    import torch
    from fastllama_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    refs = []
    for src in args.regs_against:
        os.makedirs(os.path.join("build", "regs_against"), exist_ok=True)
        stem = os.path.splitext(os.path.basename(src))[0]
        refs.append((src, RefBuild(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join("build", "regs_against", f"lib{stem}.so"), src],
            t0)))
    _build.build()
    rec["build_s"] = time.perf_counter() - t0
    log(f"phase 1: kernels built in {rec['build_s']:.1f} s")
    log(_build.build_log())
    import re
    rec["build_sources_s"] = {k: float(v) for k, v in re.findall(
        r"== (\S+) \(rc \d+, ([0-9.]+) s\)", _build.build_log())}
    log(f"  nvcc seconds by source: {rec['build_sources_s']}")
    rec["groupdot_ring_ptxas"] = check_no_spill(_build.build_log(),
                                                "qmm_pipe_gd_kernel")
    rec["wide_ring_ptxas"] = check_no_spill(_build.build_log(),
                                            "qmm_pipe_wide_kernel")
    # the G32 instantiations (gs a multiple of 32, not of 64)
    rec["g32_ring_ptxas"] = check_no_spill(_build.build_log(),
                                           "qmm_pipe_g32_kernel")
    rec["g32_wide_ring_ptxas"] = check_no_spill(_build.build_log(),
                                                "qmm_pipe_wide_g32_kernel")
    rec["spec_split_ptxas"] = check_no_spill(_build.build_log(),
                                             "flash_spec_split_kernel")
    rec["decode_split_ptxas"] = check_no_spill(_build.build_log(),
                                               "flash_decode_split_kernel")
    rec["fresh_split_ptxas"] = check_no_spill(
        _build.build_log(), "flash_decode_fresh_split_kernel")
    rec["block_tf32_ptxas"] = check_no_spill(_build.build_log(),
                                             "flash_block_tf32_kernel")
    rec["prefill_ptxas"] = check_prefill_build(_build.build_log())
    for src, ref in refs:
        check_regs_against(ref, src, rec, _build.build_log())
    if files is not None:
        t0 = time.perf_counter()
        files.join()
        log(f"checkpoint files written ({time.perf_counter() - t0:.1f} s "
            f"waited after the build)")

    t_start = time.perf_counter()
    # each kernel's launches on the path it serves: the batched path's from
    # phase 4, the single-stream path's from phase 4b, the speculative
    # path's own kernels from phase 4c, K1p's plain and indexed forms from
    # phase 4d and its fused form from 4e, the groupdot mode's from the
    # sweep (4h)
    launches = {}
    rec["phase_s"] = {}

    def run(label, fn):
        t0 = time.perf_counter()
        out = fn(dev, rec)
        rec["phase_s"][label] = time.perf_counter() - t0
        log(f"  phase {label} took {rec['phase_s'][label]:.1f} s")
        return out
    if "2" in phases:
        run("2", phase_kernels)
    if "3" in phases:
        run("3", phase_engine_parity)
        run("3b", phase_single_parity)
        run("3c", phase_spec_parity)
    if "3d" in phases:
        run("3d", phase_int4_parity)
    if "3e" in phases:
        run("3e", phase_prefix_deferred_parity)
    if "3f" in phases:
        run("3f", phase_f32_parity)
    if "3g" in phases:
        run("3g", phase_single_spec_parity)
    if "3h" in phases:
        launches.update(run("3h", phase_loader_parity))
    if "4" in phases:
        got = run("4", lambda d, r: phase_serving(d, r, "4p" in phases))
        launches.update({k: got[k] for k in BATCHED_PATH})
        # no engine path calls the unindexed wrapper above 128 rows (as in
        # JAX): its prefill count is this run's, 0
        launches["qmatmul_pallas_prefill"] = got["qmatmul_pallas_prefill"]
    if "4b" in phases:
        got = run("4b", phase_single_serving)
        # every count of the single-stream run but K1p's (4d and 4e's)
        launches.update({k: v for k, v in got.items()
                         if not k.endswith("_p4")
                         and (k not in BATCHED_PATH or k not in launches)})
    if "4c" in phases:
        got = run("4c", phase_spec_serving)
        launches.update({k: got[k] for k in ("flash_spec_batched",
                                             "flash_spec_batched_split",
                                             "spec_write")})
    if "4d" in phases:
        got = run("4d", phase_int4_serving)
        launches.update({k: got[k] for k in ("qmatmul_pallas_p4",
                                             "qmatmul_pallas_indexed_p4")})
    if "4e" in phases:
        got = run("4e", phase_int4_single_serving)
        launches["qmatmul_pallas_indexed_fused_p4"] = \
            got["qmatmul_pallas_indexed_fused_p4"]
        for k in ("qmatmul_pallas_p4", "qmatmul_pallas_indexed_p4"):
            launches.setdefault(k, got[k])
    if "4f" in phases:
        got = run("4f", phase_prefix_serving)
        launches["flash_block_attend"] = got["flash_block_attend"]
    if "4i" in phases:
        got = run("4i", phase_prefix_f32_serving)
        launches["flash_block_attend_tf32"] = got["flash_block_attend_tf32"]
        launches.setdefault("flash_block_attend", got["flash_block_attend"])
    if "4j" in phases:
        got = run("4j", phase_wide_single_serving)
        for k in ("qmatmul_pallas_indexed_fused_wide_pipe",
                  "qmatmul_pallas_indexed_fused_wide_prefill"):
            launches[k] = got[k]
        # the classifier's ring launches: 4k's batched path when it runs
        if not launches.get("qmatmul_pallas_wide_pipe"):
            launches["qmatmul_pallas_wide_pipe"] = \
                got["qmatmul_pallas_wide_pipe"]
    if "4k" in phases:
        got = run("4k", phase_wide_serving)
        # the unindexed wrapper's wide prefill count is this run's, 0: no
        # engine path calls it above 128 rows (as in JAX)
        for k in ("qmatmul_pallas_wide_pipe",
                  "qmatmul_pallas_indexed_wide_pipe",
                  "qmatmul_pallas_indexed_wide_prefill",
                  "qmatmul_pallas_wide_prefill"):
            launches[k] = got[k]
    if "4l" in phases:
        # the single-stream speculative path's counts, where 4b did not
        # run: K1 at T = 8 and 1, K1f, K2 non-fresh (the draft's steps)
        got = run("4l", phase_single_spec_serving)
        for k in SINGLE_SPEC_PATH + ("flash_decode_single",
                                     "flash_decode_single_split"):
            launches.setdefault(k, got[k])
    if "4m" in phases:
        got = run("4m", lambda d, r: phase_file_serving(d, r, files))
        launches.update(got)
    if "4n" in phases:
        got = run("4n", phase_int16_serving)
        launches.update(got)
    if "4o" in phases:
        got = run("4o", phase_gs32_serving)
        launches.update(got)
    if "4g" in phases:
        got = run("4g", phase_deferred_serving)
        for k in ("flash_decode_batched_stats",
                  "flash_decode_batched_stats_split"):
            launches[k] = got[k]
    if "4h" in phases:
        got = run("4h", phase_sweep)
        for k in ("qmatmul_pallas_groupdot", "qmatmul_pallas_groupdot_p4",
                  "qmatmul_pallas_groupdot_pipe"):
            launches[k] = got[k]
    # the perplexity tool's and the mesh paths' launches are added to
    # each kernel's count (6c: both ranks')
    for label, fn in (("6", phase_eval), ("6b", phase_mesh_one),
                      ("6c", lambda d, r: phase_mesh_two(
                          d, r, files, "6d" in phases, "6e" in phases))):
        if label in phases:
            for k, v in run(label, fn).items():
                launches[k] = launches.get(k, 0) + v
    if "5" in phases:
        run("5", phase_timing)
    rec["phases_s"] = time.perf_counter() - t_start

    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    kernels = []
    for name in KERNELS:
        t = rec.get("timing", {}).get(name, {})
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": rec.get("max_abs_err", {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    log(rec["card"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        # on both streams: a caller that keeps only one still reads why
        print(f"chip_smoke FAILED: {e}", flush=True)
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
