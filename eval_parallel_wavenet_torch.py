"""One-shot student (IAF) synthesis with the PyTorch / CUDA port.

    python eval_parallel_wavenet_torch.py --source_path wavs/ \
        --params tests/golden/tiny_student/params.npz \
        --config tests/golden/tiny_student/meta.json --save_path gen/

--params is a golden-format params.npz (int8 '#q'/'#s' pairs allowed);
--config a student config JSON or a golden meta.json.  Runs on the first
CUDA device unless --device cpu.
"""

import argparse
import logging

from nsynth_wavenet_tpu_torch.evaluation import generate_parallel_wavenet


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source_path", required=True, help="a .wav/.npy file or a directory")
    ap.add_argument("--params", required=True, help="golden-format params.npz")
    ap.add_argument("--config", required=True, help="student config json or golden meta.json")
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample_length", type=int, default=-1, help="truncate input wavs")
    ap.add_argument("--streaming_chunk", type=int, default=None,
                    help="stream the flows in chunks of this many samples")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    for path in generate_parallel_wavenet(
            args.source_path, args.params, args.config, args.save_path,
            batch_size=args.batch_size, seed=args.seed, device=args.device,
            sample_length=args.sample_length, streaming_chunk=args.streaming_chunk):
        print(path)


if __name__ == "__main__":
    main()
