"""Wall-clock streaming replay with backpressure and deadline accounting.

Port of `gorio_tpu/pipeline/streaming.py`, the counterpart of the
reference's `bag_player.py` with its `/read_until` flow control
(`scan_matching_odometry_nodelet.cpp:383-389`): a producer thread releases
frames on the recording's own clock into a bounded queue that feeds the
fused frontend and the back end, in one of two modes:

  block — the producer stalls while the queue is full (nothing is lost, the
          clock slips: how far from real time the pipeline runs)
  drop  — the producer evicts the oldest queued frame (a live sensor: the
          clock holds, frames are lost and counted)

A frame's latency runs from its scheduled release to the end of its work
on the card (the pose pulled to the host and the device synchronised), so
it counts the time a frame waits in a full queue. The report holds frames
on time, latency p50 / p95 / max, dropped frames, and the wall clock
against the recording's span, with the JAX package's JSON keys.

The producer only reads `.grf` frames and copies the packed numpy buffer;
all device work stays on the consumer thread: each frame is uploaded as a
contiguous float64 tensor (as the `slam` CLI uploads its fused frames) and
stepped there. With `optimize_async`, `slam.optimize` runs on one worker
thread, the reference's optimization timer (`radar_graph_slam_nodelet.cpp:
750-834`); a tick that comes while the previous cycle still runs is skipped
and counted. Both threads queue their kernels on the device's current
stream, so the card runs them one after the other.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..io.native import NativePipelineDataset


@dataclass
class StreamReport:
    n_frames: int = 0
    n_processed: int = 0
    n_dropped: int = 0
    n_keyframes: int = 0
    n_loops: int = 0
    n_opt_cycles: int = 0
    n_opt_skipped: int = 0  # optimize ticks skipped: the previous cycle still ran
    opt_p50_ms: float = 0.0
    opt_max_ms: float = 0.0
    on_time_frac: float = 0.0
    latency_p50_ms: float = 0.0
    latency_p95_ms: float = 0.0
    latency_max_ms: float = 0.0
    period_ms: float = 0.0
    wall_s: float = 0.0
    recording_s: float = 0.0
    realtime_factor: float = 0.0  # recording span / wall clock (>= 1 is real time)
    mode: str = "block"

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


def stream_sequence(
    frames,
    slam,
    odo,
    imu: Optional[dict] = None,
    rate_multiplier: float = 1.0,
    mode: str = "block",
    queue_depth: int = 4,
    capacity: int = 2048,
    optimize_every: int = 0,
    optimize_window: int = 0,
    optimize_async: bool = False,
    ground: bool = False,
    generator: Optional[torch.Generator] = None,
) -> StreamReport:
    """Replay `frames` (.grf paths) against the wall clock; returns the
    report.

    `slam` / `odo` are a `RadarGraphSLAM` and a `ScanMatchingOdometry`
    already loaded with their measurement streams; the frames run on
    `slam.device`. `imu` may map 'gyr_t' / 'gyr' arrays for the fused
    deskew; `generator` draws the ego-velocity RANSAC hypotheses. Each
    frame's ego velocity joins the back end's twist stream only where no
    twist stream was pushed before the replay, as in the `slam` CLI (the
    JAX package pushes both, and its unsorted twist stream then breaks the
    preintegration windows)."""
    device = torch.device(slam.device)
    online_twists = len(slam.vel_t) == 0
    ds = NativePipelineDataset(frames, capacity=capacity, queue_depth=queue_depth)
    q: queue.Queue = queue.Queue(maxsize=max(queue_depth, 1))
    stop = threading.Event()
    n_dropped = 0
    n_frames = 0
    first_stamp = None
    last_stamp = None

    gyr_t = np.asarray(imu["gyr_t"]) if imu is not None else None
    gyr = np.asarray(imu["gyr"]) if imu is not None else None

    def omega_at(t):
        if gyr_t is None or gyr_t.size == 0:
            return None
        return gyr[np.clip(np.searchsorted(gyr_t, t) - 1, 0, gyr_t.size - 1)]

    def producer():
        nonlocal n_dropped, n_frames, first_stamp, last_stamp
        t_wall0 = time.monotonic()
        t_rec0 = None
        # the sentinel, or the exception, always reaches the consumer, even
        # when reading dies mid-stream (a corrupt .grf): else it would block
        # on q.get() for ever
        final: object = None
        try:
            for stamp, n_pts, packed in ds:
                if stop.is_set():
                    break
                n_frames += 1
                if t_rec0 is None:
                    t_rec0 = first_stamp = stamp
                last_stamp = stamp
                release = t_wall0 + (stamp - t_rec0) / rate_multiplier
                delay = release - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                # latency counts from the scheduled arrival (`release`), not
                # from the put: a block-mode producer stalled past its
                # schedule is latency a robot would see
                item = (stamp, n_pts, packed.copy(), release)
                if mode == "drop":
                    while True:
                        try:
                            q.put_nowait(item)
                            break
                        except queue.Full:
                            try:
                                q.get_nowait()
                                n_dropped += 1
                            except queue.Empty:
                                pass
                else:  # block: the /read_until contract
                    q.put(item)
        except BaseException as exc:  # handed to the consumer
            final = exc
        finally:
            q.put(final)

    th = threading.Thread(target=producer, daemon=True)
    t_start = time.monotonic()
    th.start()

    latencies = []
    n_processed = 0
    prev_stamp = None
    period_est = []
    opt_executor = ThreadPoolExecutor(max_workers=1) if optimize_every and optimize_async else None
    opt_future = None
    opt_times: list = []
    n_opt = 0
    n_opt_skipped = 0

    def run_optimize():
        t0 = time.monotonic()
        slam.optimize(window=optimize_window or None)
        opt_times.append(time.monotonic() - t0)

    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            stamp, n_pts, packed, t_release = item
            frame = torch.tensor(packed, dtype=torch.float64, device=device)
            pose, v = odo.step_fused(float(stamp), frame, n_pts, ground=ground,
                                     omega=omega_at(float(stamp)), generator=generator)
            if online_twists:
                slam.push_twist(float(stamp), v)
            floor = None
            if ground and odo.last_ground_count >= slam.cfg.floor_min_ground_points \
                    and abs(odo.last_plane[2]) > slam.cfg.floor_max_tilt_nz:
                floor = odo.last_plane
            slam.add_frame(float(stamp), odo.last_cloud, pose, floor_coeffs=floor)
            if optimize_every and len(slam.keyframes) % optimize_every == 0:
                if opt_executor is None:
                    run_optimize()
                    n_opt += 1
                elif opt_future is None or opt_future.done():
                    if opt_future is not None:
                        opt_future.result()  # raise the last cycle's exception
                    opt_future = opt_executor.submit(run_optimize)
                    n_opt += 1
                else:
                    n_opt_skipped += 1
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()  # the frame's work is done
            latencies.append(time.monotonic() - t_release)
            if prev_stamp is not None:
                period_est.append(stamp - prev_stamp)
            prev_stamp = stamp
            n_processed += 1
    finally:
        stop.set()
        deadline = time.monotonic() + 5.0
        while th.is_alive() and time.monotonic() < deadline:
            try:  # unblock a producer stuck on a full queue
                q.get_nowait()
            except queue.Empty:
                th.join(timeout=0.05)
        if not th.is_alive():
            ds.close()
        if opt_executor is not None:
            if opt_future is not None:
                opt_future.result()
            opt_executor.shutdown(wait=True)

    wall = time.monotonic() - t_start
    period = float(np.median(period_est)) / rate_multiplier if period_est else 0.1
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    on_time = float(np.mean(lat <= period)) if latencies else 0.0
    rec_span = (last_stamp - first_stamp) if (first_stamp is not None and last_stamp) else 0.0
    opt_arr = np.asarray(opt_times) if opt_times else np.zeros(1)
    return StreamReport(
        n_frames=n_frames,
        n_processed=n_processed,
        n_dropped=n_dropped,
        n_keyframes=len(slam.keyframes),
        n_loops=len(slam.loops),
        n_opt_cycles=n_opt,
        n_opt_skipped=n_opt_skipped,
        opt_p50_ms=round(float(np.percentile(opt_arr, 50)) * 1e3, 2) if opt_times else 0.0,
        opt_max_ms=round(float(opt_arr.max()) * 1e3, 2) if opt_times else 0.0,
        on_time_frac=round(on_time, 4),
        latency_p50_ms=round(float(np.percentile(lat, 50)) * 1e3, 2),
        latency_p95_ms=round(float(np.percentile(lat, 95)) * 1e3, 2),
        latency_max_ms=round(float(lat.max()) * 1e3, 2),
        period_ms=round(period * 1e3, 2),
        wall_s=round(wall, 3),
        recording_s=round(rec_span, 3),
        realtime_factor=round(rec_span / rate_multiplier / max(wall, 1e-9), 3),
        mode=mode,
    )
