"""Export an EMA-weights-only eval model from a training run of the port
(counterpart of the JAX package's tools/make_eval_model.py; the reference's
tools/make_eval_model.py rewrote a TF checkpoint keeping only the EMA shadow
variables).

The EMA comes from evaluation.load_eval_model (the run's export under ema/,
else its latest checkpoint's EMA) and is written by
training/checkpoint.py::export_ema as params.npz + meta.json, what the eval
CLIs' --ckpt_dir and --params / --config read.

Usage:
    python -m nsynth_wavenet_tpu_torch.tools.make_eval_model --run_dir <run>
        [--out_dir DIR] [--device cpu]
"""

import json
import os
import sys
from argparse import ArgumentParser


def _step(run_dir):
    """The step of the weights load_eval_model reads: its export's, else the
    latest checkpoint's."""
    meta = os.path.join(run_dir, "ema", "meta.json")
    if os.path.isfile(os.path.join(run_dir, "ema", "params.npz")):
        with open(meta) as f:
            return json.load(f).get("step")
    from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib

    return ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt")).latest_step()


def save_eval_model(run_dir: str, out_dir: str = None, device="cuda"):
    from nsynth_wavenet_tpu_torch.evaluation import load_eval_model
    from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib

    cfg, ema_params = load_eval_model(run_dir, device=device)
    out_dir = out_dir or os.path.join(run_dir, "ema")
    ckpt_lib.export_ema({"ema": ema_params, "step": _step(run_dir)}, out_dir, cfg)
    print(f"EMA eval model written to {out_dir}")
    return out_dir


def cli(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run_dir", required=True, help="training run directory (json + ckpt)")
    parser.add_argument("--out_dir", default=None, help="output dir (default <run_dir>/ema)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    save_eval_model(args.run_dir, args.out_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
