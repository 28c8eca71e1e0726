"""Convert a JAX training run directory into the PyTorch port's EMA-export
layout, so that the port's eval CLIs serve the weights trained with the JAX
package.

    python -m tools.jax_run_to_torch --run_dir runs/<jax-run> --out_dir runs/<jax-run>-torch
    python eval_wavenet_torch.py --ckpt_dir runs/<jax-run>-torch --source_path wavs/ \
        --save_path gen/        # a teacher run
    python eval_parallel_wavenet_torch.py --ckpt_dir runs/<jax-run>-torch \
        --source_path wavs/ --save_path gen/        # a student run

It runs where JAX and Orbax are (run it from the repository root).  The run
is read through nsynth_wavenet_tpu.evaluation.load_eval_model, which restores
the Orbax trees against the model's own template: the EMA export under
<run_dir>/ema when there is one, else the EMA of the latest checkpoint.  The
output holds
  <out_dir>/ema/params.npz  every leaf as plain float32 under its key path
                            (['layers'][0]['dilated']['w'], ['flows'][1]...),
                            as the port's weights.save_npz writes them;
  <out_dir>/ema/meta.json   {"config": the run's config json, "step": the
                            latest checkpoint's step, or null};
  <out_dir>/norm_stats.npz  a student run's power-loss statistics, copied
                            when the run has them.
"""

import argparse
import glob
import json
import os
import shutil

from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.training.checkpoint import write_export_meta


def _config_json(run_dir: str) -> str:
    jsons = [j for j in glob.glob(os.path.join(run_dir, "*.json"))
             if not os.path.basename(j).startswith("norm_stats")]
    if len(jsons) != 1:
        raise FileNotFoundError(f"expected exactly one config json in {run_dir}: {jsons}")
    return jsons[0]


def _latest_step(run_dir: str):
    ckpt = os.path.join(run_dir, "ckpt")
    if not os.path.isdir(ckpt):
        return None
    from nsynth_wavenet_tpu.training import checkpoint as ckpt_lib

    mgr = ckpt_lib.CheckpointManager(ckpt)
    try:
        return mgr.latest_step()
    finally:
        mgr.close()


def convert(run_dir: str, out_dir: str) -> str:
    """Write run_dir's EMA weights and config in the port's layout under
    out_dir; returns out_dir."""
    from nsynth_wavenet_tpu.evaluation import load_eval_model

    _, params = load_eval_model(run_dir)
    with open(_config_json(run_dir)) as f:
        config = json.load(f)
    ema = os.path.join(out_dir, "ema")
    os.makedirs(ema, exist_ok=True)
    weights.save_npz(os.path.join(ema, "params.npz"), weights.from_jax_params(params, "cpu"))
    write_export_meta(ema, config, _latest_step(run_dir))
    stats = os.path.join(run_dir, "norm_stats.npz")
    if os.path.exists(stats):
        shutil.copyfile(stats, os.path.join(out_dir, "norm_stats.npz"))
    return out_dir


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run_dir", required=True, help="a JAX teacher or student run directory")
    ap.add_argument("--out_dir", required=True, help="where to write the port's layout")
    args = ap.parse_args()
    print(convert(args.run_dir, args.out_dir))


if __name__ == "__main__":
    main()
