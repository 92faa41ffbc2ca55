"""leapfrog_overhead_ms: milliseconds of the card per leapfrog step of all
chains outside the density's replays: for each draw's trajectory of the
traced `run_hmc` calls (the program's `hmc.trajectory` spans), the
CUDA-event time of the trajectory less that of the `hmc.replay` spans
inside it, over the `leapfrog_steps` it counted; the median over the
trajectories (64 a call), so that one host stall does not move it: the
eager position, momentum and Metropolis kernels between replays and the
wait the host leaves the card in a typical trajectory. From the program's
records of the last profiler session, the traced window's; None where the
program keeps no such records."""

import statistics

from benchmark.lib.spans import hmc_calls, overheads_ms


def read(obs):
    ms = overheads_ms([t for c in hmc_calls() for t in c["trajectories"]])
    return statistics.median(ms) if ms else None
