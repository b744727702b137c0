"""The port's measurement tools, each run as
``python3 -m fastllama_tpu_torch.tools.<name>``: ``hbm_peak`` (sustained
device-memory read bandwidth, the sweep's denominator) and
``qmm_sweep`` (the dequant-matmul's steady-state bandwidth at the 7B
decode shapes), with ``timing``, the port's one device timer, and
``fresh_split_design`` (K2's fresh and stats split mode built with other
tuning constants and timed in turns: the design calls behind its
defaults), and ``block_tf32_design`` (the same for K2b's split-TF32
mode); ``eval_ppl`` measures perplexity through the engines' own paths
(the accuracy gate across bit widths)."""
