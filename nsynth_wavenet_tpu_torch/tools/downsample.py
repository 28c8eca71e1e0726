"""Resample a directory of wavs to a target rate (counterpart of the JAX
package's tools/downsample.py; the reference's tools/sox_downsample.py
shelled out to the sox binary): a polyphase resampler in-process, the
rational factor target / source in lowest terms, the result clipped to
[-1, 1] and written as 16-bit PCM.  Runs on the host (numpy and scipy).

Usage:
    python -m nsynth_wavenet_tpu_torch.tools.downsample --wave_dir <dir>
        --out_dir <dir> [--sample_rate 16000] [--num_workers 8]
"""

import glob
import os
import sys
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction

import numpy as np
from scipy.signal import resample_poly

from nsynth_wavenet_tpu_torch.data.wav_io import read_wav, write_wav


def resample(wav, sr: int, target_sr: int):
    """wav at sr -> float32 at target_sr (unchanged when the rates agree)."""
    if sr == target_sr:
        return wav
    frac = Fraction(target_sr, sr)
    return resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)


def downsample_file(src: str, dst: str, target_sr: int):
    wav, sr = read_wav(src)
    write_wav(dst, np.clip(resample(wav, sr, target_sr), -1.0, 1.0), target_sr)


def downsample_dir(wave_dir: str, out_dir: str, target_sr: int = 16000, workers: int = 8):
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(glob.glob(os.path.join(wave_dir, "*.wav")))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(lambda f: downsample_file(f, os.path.join(out_dir, os.path.basename(f)),
                                              target_sr), files))
    print(f"resampled {len(files)} files to {target_sr} Hz in {out_dir}")
    return files


def cli(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--wave_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--sample_rate", default=16000, type=int)
    parser.add_argument("--num_workers", default=8, type=int)
    args = parser.parse_args(argv)
    downsample_dir(args.wave_dir, args.out_dir, args.sample_rate, args.num_workers)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
