"""Parallel WaveNet student distillation with the PyTorch / CUDA port.

New run:    python train_parallel_wavenet_torch.py --config configs/parallel_wavenet.json \
                --train_path ds/ --teacher_dir runs/<teacher-run> --log_root runs/
Resume:     python train_parallel_wavenet_torch.py --train_path ds/ \
                --teacher_dir runs/<teacher-run> --logdir runs/<student-run>

--teacher_dir is a run directory of train_wavenet_torch.py: its config json
and the EMA of its latest checkpoint make the frozen teacher.  Trains on the
first CUDA device unless --device cpu.  The run directory holds a copy of the
config json, train.log, metrics.jsonl, ckpt/<step>/ and, with norm_feat,
norm_stats.npz; --export_ema writes the EMA weights to <run>/ema at the end,
which eval_parallel_wavenet_torch.py --ckpt_dir <run> serves.

Several processes, one a device: torchrun --nproc_per_node N ... --multihost
[--n_model M] [--n_seq S], as train_wavenet_torch.py; the frozen teacher is
sharded as the student is.  --n_seq splits the sample length (7680 for a
7680-sample crop) over S ranks: every flow and the teacher's scoring pass
run on a rank's chunk with halo exchanges, and the power loss on the
student's sample gathered over them.
"""

import os
from argparse import ArgumentParser

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
from nsynth_wavenet_tpu_torch.training import runner


def main():
    parser = ArgumentParser()
    parser.add_argument("--config", default="", help="Student config json")
    parser.add_argument("--train_path", required=True, help="Dataset directory")
    parser.add_argument("--teacher_dir", required=True,
                        help="Run directory of the trained teacher (config json + ckpt)")
    parser.add_argument("--logdir", default="/tmp/nsynth_pwn_torch",
                        help="Existing run directory to resume")
    parser.add_argument("--log_root", default="", help="Root for a new run directory")
    parser.add_argument("--total_batch_size", default=4, type=int)
    parser.add_argument("--num_steps", default=None, type=int, help="Override cfg.num_iters")
    parser.add_argument("--ckpt_every_steps", default=2000, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--multihost", action="store_true",
                        help="one process of several: join the process group of torchrun's "
                             "env:// variables")
    parser.add_argument("--profile_steps", default=0, type=int,
                        help="torch.profiler trace over N steps from the 10th")
    parser.add_argument("--n_model", default=1, type=int,
                        help="ranks that shard the model's channels (tensor parallelism)")
    parser.add_argument("--n_seq", default=1, type=int,
                        help="ranks that shard the time axis (sequence parallelism); must "
                             "divide the sample length")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--export_ema", action="store_true",
                        help="write the EMA weights to <run>/ema when the run ends")
    args = parser.parse_args()
    run_dir, state = runner.train_parallel_wavenet(
        train_path=args.train_path, teacher_dir=args.teacher_dir, config_path=args.config,
        log_root=args.log_root, logdir=args.logdir, total_batch_size=args.total_batch_size,
        num_steps=args.num_steps, ckpt_every_steps=args.ckpt_every_steps, seed=args.seed,
        multihost=args.multihost, profile_steps=args.profile_steps, n_model=args.n_model,
        n_seq=args.n_seq, device=args.device)
    if args.export_ema:
        cfg = config_lib.load_config(runner.find_config_json(run_dir))
        ckpt_lib.export_ema(state, os.path.join(run_dir, "ema"), cfg)
    mesh_lib.shutdown()
    print(run_dir)


if __name__ == "__main__":
    main()
