"""One-shot student (IAF) synthesis with the PyTorch / CUDA port.

    python eval_parallel_wavenet_torch.py --source_path wavs/ \
        --params tests/golden/tiny_student/params.npz \
        --config tests/golden/tiny_student/meta.json --save_path gen/
    python eval_parallel_wavenet_torch.py --source_path wavs/ \
        --ckpt_dir runs/<student-run> --save_path gen/

--params is a golden-format params.npz (int8 '#q'/'#s' pairs allowed);
--config a student config JSON or a golden meta.json.  Instead of both,
--ckpt_dir <run> reads a run directory of train_parallel_wavenet_torch.py:
its EMA export (<run>/ema) when there is one, else the EMA of its latest
checkpoint.  Runs on the first CUDA device unless --device cpu.  --npy_only
serves the .npy mels of a source directory that holds .wav files as well.
A JAX run directory serves through --ckpt_dir once
tools/jax_run_to_torch.py has written its EMA in the port's layout.
Under torchrun (--nproc_per_node N ... --multihost) each batch is split over
the ranks (gloo on the CPU, nccl on cards) and rank 0 writes the wavs.
"""

import argparse
import logging

from nsynth_wavenet_tpu_torch.evaluation import generate_parallel_wavenet
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source_path", required=True, help="a .wav/.npy file or a directory")
    ap.add_argument("--params", help="golden-format params.npz")
    ap.add_argument("--config", help="student config json or golden meta.json")
    ap.add_argument("--ckpt_dir", help="a train_parallel_wavenet_torch.py run directory "
                                       "(instead of --params and --config)")
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample_length", type=int, default=-1, help="truncate input wavs")
    ap.add_argument("--streaming_chunk", type=int, default=None,
                    help="stream the flows in chunks of this many samples")
    ap.add_argument("--npy_only", action="store_true",
                    help="use only the .npy (precomputed mel) inputs of the source directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multihost", action="store_true",
                    help="one process of several: join the process group of torchrun's env:// "
                         "variables and split each batch over the ranks")
    args = ap.parse_args()
    if (args.ckpt_dir is None) == (args.params is None or args.config is None):
        ap.error("pass --ckpt_dir, or --params and --config")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = mesh_lib.init_distributed(args.device) if args.multihost else args.device
    for path in generate_parallel_wavenet(
            args.source_path, args.params, args.config, args.save_path,
            batch_size=args.batch_size, seed=args.seed, device=device,
            sample_length=args.sample_length, streaming_chunk=args.streaming_chunk,
            ckpt_dir=args.ckpt_dir, npy_only=args.npy_only):
        if mesh_lib.process_index() == 0:
            print(path)
    mesh_lib.shutdown()


if __name__ == "__main__":
    main()
