"""Dataset builder of the PyTorch / CUDA port: a directory of 16 kHz wavs ->
{data.bin, index.json}, the format build_dataset.py writes.

    python build_dataset_torch.py --wave_dir wavs/ --save_path ds/
"""

from argparse import ArgumentParser

from nsynth_wavenet_tpu_torch.data import dataset


def main():
    parser = ArgumentParser()
    parser.add_argument("--wave_dir", required=True, help="input wave directory")
    parser.add_argument("--save_path", required=True, help="output dataset directory")
    parser.add_argument("--sample_rate", default=16000, type=int)
    parser.add_argument("--min_len", default=16000, type=int, help="minimum length for padding")
    parser.add_argument("--num_workers", default=10, type=int)
    args = parser.parse_args()
    dataset.build_dataset(args.wave_dir, args.save_path, args.sample_rate, args.min_len,
                          args.num_workers)


if __name__ == "__main__":
    main()
