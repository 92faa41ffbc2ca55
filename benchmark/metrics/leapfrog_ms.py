"""leapfrog_ms: milliseconds of the card's stream per leapfrog step of all
chains, from CUDA events around each `run_hmc` call of the window that the
profiler did not cover (its CUDA-graph capture and initial density
evaluation included), over the leapfrog steps those calls made."""


def read(obs):
    ms = obs["spans"].get("run_hmc_ms")
    steps = obs["counters"].get("leapfrog_steps_timed", 0)
    return sum(ms) / steps if ms and steps else None
