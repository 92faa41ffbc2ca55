"""The port's evaluation harnesses: counterparts of the repo's `scripts/`.

  recall          <- scripts/recall_benchmark.py   (loop recall / precision)
  accuracy        <- scripts/accuracy_benchmark.py (ATE / RTE of the stored sequences)
  loop_replay     <- scripts/loop_replay.py        (record / replay the loop detector)
  loop_sweep      <- scripts/loop_sweep.py         (LoopConfig combos over recordings)
  stream          <- scripts/stream_benchmark.py   (wall-clock replay, both modes)
  graph_baseline  <- scripts/graph_baseline.py     (host scipy LM against the port's solver)
  scaling         <- scripts/bench_scaling.py      (weak scaling over ranks sharing the card)
  multihost       <- scripts/demo_multihost.py     (two processes, one SMC population, TCP)
  ugpm_golden     <- scripts/make_ugpm_golden.py   (the UGPM golden record, and its check)
  profile_linearize <- scripts/profile_linearize.py (APDGICP linearize by component)
  profile_ndt     <- scripts/profile_ndt.py        (NDT align by component)
  profile_graph_solve <- scripts/profile_graph_solve.py (block assembly against PCG)
  profile_ugpm    <- scripts/profile_ugpm.py, profile_ugpm2.py (UGPM fit by variant, by batch)
  dispatch        <- scripts/diagnose_dispatch_poison.py (the probe before and after stages)

`sequence` is the shared `simulate` + `slam` run, `timing` the profilers'
host and device time per call. `cublas_workspace` has no script: it runs
the profilers' readings in processes with and without the cuBLAS setting
that every spawned rank exports, in alternating pairs.

Each runs as `python -m gorio_tpu_torch.evaluation.<module>` with its
script's arguments plus `--device` (default cuda; without a card it raises,
there is no fallback to the CPU). They drive the port's own CLI and modules,
and import nothing of JAX. The JAX package's records (`ACCURACY.json`,
`RECALL.json`, `STREAM.json`, `GRAPH_BASELINE.json`, `SCALING.json`,
`tests/golden/ugpm_golden.npz`) are only read: an `--update` (or the
golden record) writes to the path given by `--out`.
"""
