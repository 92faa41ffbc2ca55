"""traj_samples_per_s: chains x draws of every `run_hmc` call of the window,
over the window's seconds (host clock, from its start to the end of the
call that crossed `--seconds`)."""


def read(obs):
    samples = obs["work"].get("samples")
    return None if samples is None else samples / obs["window_s"]
