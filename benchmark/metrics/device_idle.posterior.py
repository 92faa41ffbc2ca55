"""Share of the traced window in which no operation ran on the card, in %:
100 * (1 - busy / window), busy being the union of all device activity
intervals of the profiler's trace (every stream of the process), window
the traced seconds."""


def read(obs):
    tr = obs.get("trace")
    if not tr:
        return None
    busy_s, window_s = tr[0], tr[1]
    return 100.0 * (1.0 - busy_s / window_s)
