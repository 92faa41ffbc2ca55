"""The benchmark of `gorio_tpu_torch` on one NVIDIA H100.

`BENCHMARK.json` at the root names the cells; everything else is found by
name here:

    run.py                one run of one cell (`--workload --seed --seconds --trace`)
    control.py            a cell's control: its reference one precision down
    configs/<config>.json a deployment: its source, sizes, driver and limits
    traffic/<mix>.json    a traffic mix: the parameters its driver reads
    drivers/<driver>.py   set-up, window and check of one kind of cell
    metrics/<metric>.py   one reader per metric, `read(observations)`
    reference/            the plain reference and the frozen graph (no program code)
    lib/                  the manifest's loaders and the trace reduction
    tests/                CPU tests: `python -m pytest --noconftest benchmark/tests -q`

Nothing here imports `jax`, `gorio_tpu`, `tests/` or the root `bench.py`.
"""
