"""hmc_capture_ms: host milliseconds of the density's CUDA-graph capture
(the program's `hmc.capture` span: `CudaGraphed`'s two eager evaluations
and the capture) per traced `run_hmc` call (`hmc.run` span), from the
program's records of the last profiler session, the traced window's. None
where the program keeps no such records."""

from benchmark.lib.spans import hmc_calls


def read(obs):
    calls = hmc_calls()
    if not any(c["captures"] for c in calls):
        return None
    return sum(c["capture_ms"] for c in calls) / len(calls)
