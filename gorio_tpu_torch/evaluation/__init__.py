"""The port's evaluation harnesses: counterparts of the repo's `scripts/`.

  recall          <- scripts/recall_benchmark.py   (loop recall / precision)
  accuracy        <- scripts/accuracy_benchmark.py (ATE / RTE of the stored sequences)
  loop_replay     <- scripts/loop_replay.py        (record / replay the loop detector)
  loop_sweep      <- scripts/loop_sweep.py         (LoopConfig combos over recordings)
  stream          <- scripts/stream_benchmark.py   (wall-clock replay, both modes)
  graph_baseline  <- scripts/graph_baseline.py     (host scipy LM against the port's solver)

Each runs as `python -m gorio_tpu_torch.evaluation.<module>` with its
script's arguments plus `--device` (default cuda; without a card it raises,
there is no fallback to the CPU). They drive the port's own CLI and modules,
and import nothing of JAX. The JAX package's records (`ACCURACY.json`,
`RECALL.json`, `STREAM.json`, `GRAPH_BASELINE.json`) are only read: an
`--update` writes to the path given by `--out`.
"""
