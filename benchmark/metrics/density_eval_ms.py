"""density_eval_ms: milliseconds of the card between the CUDA events around
each replay of the density's captured graph (the program's `hmc.replay`
span: one value and gradient for all chains), averaged over every replay of
the traced `run_hmc` calls (`hmc.run` spans), from the program's records of
the last profiler session, the traced window's. None where the program
keeps no such records."""

from benchmark.lib.spans import hmc_calls


def read(obs):
    ms = [x for c in hmc_calls() for x in c["replays_ms"]]
    return sum(ms) / len(ms) if ms else None
