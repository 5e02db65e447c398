"""Metric logging: a CSV always, wandb where it is installed, Python logging
to a file and the stream, a torch.profiler trace of a range of steps, and a
step timer.

Counterpart of `clip_dplm_tpu/utils/logging.py`: `setup_logging` writes
`train.log` in the log dir; `MetricLogger` appends rows of `step`, `time`
and the metrics to `metrics.csv` (the JAX package's columns) and mirrors them
to wandb when asked and importable (warning and keeping the CSV alone
otherwise); `ProfilerHook` traces steps 11-15 with `torch.profiler` (CPU and,
on a card, CUDA activity) into a Chrome trace in `profile_dir`; `StepTimer`
times steps after a warmup. `setup_logging` moves its file handler to a new
log dir when called with one, so every run of a process logs into its own.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, Optional


def setup_logging(log_dir: str, name: str = "clip_dplm_tpu_torch") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    path = os.path.abspath(os.path.join(log_dir, "train.log"))
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            if h.baseFilename == path:
                return logger
            logger.removeHandler(h)
            h.close()
    fh = logging.FileHandler(path)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


class MetricLogger:
    """CSV metric sink with an optional wandb mirror."""

    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_project: str = "clip-dplm-tpu", config: Optional[dict] = None,
                 csv_name: str = "metrics.csv"):
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, csv_name)
        self._csv_file = open(self.csv_path, "a", newline="")
        self._writer: Optional[csv.DictWriter] = None
        self.logger = setup_logging(log_dir)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                self.logger.warning("wandb requested but not installed; CSV only")
            else:
                self._wandb = wandb
                wandb.init(project=wandb_project, config=config or {})

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        if self._writer is None:
            self._writer = csv.DictWriter(self._csv_file, fieldnames=list(row))
            if self._csv_file.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._csv_file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._csv_file.close()
        if self._wandb is not None:
            self._wandb.finish()


class ProfilerHook:
    """torch.profiler over a range of steps: `step(n)` after the n-th step
    starts the trace at n == start_step and, from start_step + num_steps
    on, stops it and writes `trace_steps_<a>_<b>.json` (Chrome trace format)
    into `profile_dir`. On the card the profiler returns kernels only in the
    first session of a process."""

    def __init__(self, profile_dir: str, start_step: int = 10, num_steps: int = 5):
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.end_step = start_step + num_steps
        self._prof = None

    def step(self, step: int) -> None:
        import torch

        if step == self.start_step and self._prof is None:
            os.makedirs(self.profile_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step >= self.end_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        """Stop a trace in progress and write it."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(os.path.join(
            self.profile_dir, f"trace_steps_{self.start_step}_{self.end_step}.json"))
        self._prof = None


class StepTimer:
    """Wall-clock time of each step after `warmup` steps (throughput)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._last = None
        self._count = 0

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                dt = now - self._last
                self.times.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return float(sum(self.times) / len(self.times)) if self.times else 0.0
