"""Logging glue (counterpart of nsynth_wavenet_tpu/utils/logging_utils.py):
console and per-run train.log, config dumps, and the training metrics, one
JSON line of scalars per logged step in ``metrics.jsonl`` and TensorBoard
scalars where tensorboardX imports, and the DETAIL_LOG histograms
(``device_histogram``: a fixed-size summary reduced on the device, over a
mesh that of the global tensor) as TensorBoard histograms."""

import dataclasses
import json
import logging
import os
import sys

import numpy as np
import torch

from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib

LOGGER_NAME = "nsynth_wavenet_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)s %(message)s"


def get_logger(name: str = LOGGER_NAME) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def add_log_file(logdir: str, name: str = LOGGER_NAME) -> logging.Logger:
    """Attach a <logdir>/train.log file handler (once per path)."""
    logger = get_logger(name)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.abspath(os.path.join(logdir, "train.log"))
    for h in logger.handlers:
        if isinstance(h, logging.FileHandler) and h.baseFilename == path:
            return logger
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(fh)
    return logger


def remove_log_file(logdir: str, name: str = LOGGER_NAME):
    """Detach and close the train.log handler of ``logdir``."""
    logger = logging.getLogger(name)
    path = os.path.abspath(os.path.join(logdir, "train.log"))
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename == path:
            logger.removeHandler(h)
            h.close()


def config_summary(cfg) -> str:
    lines = [type(cfg).__name__ + ":"]
    for f in dataclasses.fields(cfg):
        lines.append(f"  {f.name} = {getattr(cfg, f.name)}")
    return "\n".join(lines)


def device_histogram(x: torch.Tensor, bins: int = 64, groups=None) -> dict:
    """{'counts' [bins] int32, 'min', 'max', 'sum', 'sum_sq'} of x (as f32)
    with ``bins`` equal buckets between its min and max: value v lands in
    bucket clip(int((v - min) / span * bins), 0, bins - 1), span = max - min
    (1 when the two are equal), as the JAX package's device_histogram.
    groups: a process group (mesh.Mesh.replica_group: the data x seq
    ranks) over which min and max are all-reduced before the buckets, and
    the counts and sums summed, so that every rank holds the histogram of
    the global tensor whose parts the ranks hold; None: x alone.  (all_reduce
    is the identity for None.)"""
    x = x.detach().float().reshape(-1)
    lo = mesh_lib.all_reduce(x.min(), groups, op=mesh_lib.dist.ReduceOp.MIN)
    hi = mesh_lib.all_reduce(x.max(), groups, op=mesh_lib.dist.ReduceOp.MAX)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    idx = torch.clamp(((x - lo) / span * bins).to(torch.int32), 0, bins - 1)
    counts = mesh_lib.all_reduce(torch.bincount(idx, minlength=bins).to(torch.int32), groups)
    sums = mesh_lib.all_reduce(torch.stack([x.sum(), (x * x).sum()]), groups)
    return {"counts": counts, "min": lo, "max": hi, "sum": sums[0], "sum_sq": sums[1]}


def is_histogram(v) -> bool:
    return isinstance(v, dict) and "counts" in v


class MetricsWriter:
    """metrics.jsonl (one {"step", ...scalars} line a write) plus
    TensorBoard scalars when tensorboardX is installed; histogram metrics
    (``device_histogram``'s dicts) go to TensorBoard alone, through
    add_histogram_raw."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "at")
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception:  # tensorboardX is optional
            self._w = None

    def write(self, step: int, metrics: dict):
        scalars = {k: float(v) for k, v in metrics.items() if not is_histogram(v)}
        self._f.write(json.dumps({"step": int(step), **scalars}) + "\n")
        self._f.flush()
        if self._w is not None:
            for k, v in scalars.items():
                self._w.add_scalar(k, v, step)
            for k, v in metrics.items():
                if is_histogram(v):
                    self._write_histogram(k, v, step)

    def _write_histogram(self, tag: str, h: dict, step: int):
        counts = np.asarray(torch.as_tensor(h["counts"]).cpu(), np.float64)
        lo, hi = float(h["min"]), float(h["max"])
        if hi <= lo:
            hi = lo + 1.0
        edges = np.linspace(lo, hi, counts.size + 1)
        self._w.add_histogram_raw(tag, min=lo, max=hi, num=float(counts.sum()),
                                  sum=float(h["sum"]), sum_squares=float(h["sum_sq"]),
                                  bucket_limits=edges[1:].tolist(),
                                  bucket_counts=counts.tolist(), global_step=step)

    def close(self):
        self._f.close()
        if self._w is not None:
            self._w.close()
