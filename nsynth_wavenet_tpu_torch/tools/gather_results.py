"""Gather experiment artifacts and re-synthesize eval audio for every run of
the port under a root directory (counterpart of the JAX package's
tools/gather_results.py; the reference's run_all_eval.py SSH/SCPs the latest
checkpoint, event files and config json from N hosts and re-synthesizes
locally, run_all_eval.py:52-140).

A run directory of the port's trainers holds one config json and ckpt/
(a student's norm_stats.npz is not a json).  Each run's config json,
train.log, metrics.jsonl and TensorBoard event files are copied into
<results_dir>/<run>/, and the test wavs are synthesized with the run's EMA
into <results_dir>/<run>/generated/ through evaluation.generate_wavenet /
generate_parallel_wavenet(ckpt_dir=run): on a CUDA device the hand-written
AR and flow kernels.

Usage:
    python -m nsynth_wavenet_tpu_torch.tools.gather_results --root <dir>
        --test_wavs <wav or dir> --results_dir <dir> [--batch_size 4] [--device cpu]
"""

import glob
import os
import shutil
import sys
from argparse import ArgumentParser

from nsynth_wavenet_tpu_torch import config as config_lib

ARTIFACTS = ("*.json", "train.log", "metrics.jsonl", "events.out.tfevents.*")


def _config_jsons(run_dir):
    return glob.glob(os.path.join(run_dir, "*.json"))


def find_runs(root: str):
    """A run dir is any directory under root holding exactly one config json
    and ckpt/."""
    return [d for d in sorted(glob.glob(os.path.join(root, "*")))
            if os.path.isdir(d) and len(_config_jsons(d)) == 1
            and os.path.isdir(os.path.join(d, "ckpt"))]


def copy_artifacts(run_dir: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    for pat in ARTIFACTS:
        for f in glob.glob(os.path.join(run_dir, pat)):
            shutil.copy(f, out_dir)


def gather(root: str, test_wavs: str, results_dir: str, batch_size: int = 4, device="cuda"):
    """Returns {run name: the generated wav paths}."""
    from nsynth_wavenet_tpu_torch import evaluation

    runs = find_runs(root)
    print(f"found {len(runs)} runs under {root}")
    out = {}
    for run_dir in runs:
        name = os.path.basename(run_dir.rstrip("/"))
        out_dir = os.path.join(results_dir, name)
        copy_artifacts(run_dir, out_dir)
        cfg = config_lib.load_config(_config_jsons(run_dir)[0])
        gen_dir = os.path.join(out_dir, "generated")
        print(f"[{name}] synthesizing into {gen_dir}")
        synth = (evaluation.generate_parallel_wavenet
                 if isinstance(cfg, config_lib.ParallelWavenetConfig)
                 else evaluation.generate_wavenet)
        out[name] = synth(test_wavs, None, None, gen_dir, batch_size, device=device,
                          ckpt_dir=run_dir)
    return out


def cli(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True, help="directory containing run dirs")
    parser.add_argument("--test_wavs", required=True, help="wav file or directory")
    parser.add_argument("--results_dir", required=True)
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    gather(args.root, args.test_wavs, args.results_dir, args.batch_size, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
