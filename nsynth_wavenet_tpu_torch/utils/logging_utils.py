"""Logging glue (counterpart of nsynth_wavenet_tpu/utils/logging_utils.py):
console and per-run train.log, config dumps, and the training metrics, one
JSON line per logged step in ``metrics.jsonl`` and TensorBoard scalars where
tensorboardX imports.  The DETAIL_LOG histograms (device_histogram) are not
ported yet."""

import dataclasses
import json
import logging
import os
import sys

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


class MetricsWriter:
    """metrics.jsonl (one {"step", ...scalars} line a write) plus
    TensorBoard scalars when tensorboardX is installed."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "at")
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception:  # tensorboardX is optional
            self._w = None

    def write(self, step: int, metrics: dict):
        scalars = {k: float(v) for k, v in metrics.items()}
        self._f.write(json.dumps({"step": int(step), **scalars}) + "\n")
        self._f.flush()
        if self._w is not None:
            for k, v in scalars.items():
                self._w.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._w is not None:
            self._w.close()
