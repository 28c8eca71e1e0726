"""Write audible free-run generations of every committed golden teacher
(tests/golden/tiny_{ce,mol,gauss}) with the port (counterpart of the JAX
package's tools/make_golden_wavs.py, which writes them into tests/golden/;
this tool writes under --out_dir and never into tests/golden/).

Each golden free-runs from the held-out mels of its own eval seeds (its
meta.json) with seed 7, through the plain ``Fastgen.generate`` as the JAX
tool's XLA ``generate``, or with --cuda through ``Fastgen.generate_cuda`` in
bf16 (on a CUDA device one launch of the hand-written AR kernel).  The wavs
exist so a human can LISTEN to what each head's sampler produces from its
trained weights; the quantitative gates live in utils/quality.py.

Usage:
    python -m nsynth_wavenet_tpu_torch.tools.make_golden_wavs [--out_dir DIR]
        [--cuda] [--device cpu]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.utils import quality

GOLDEN_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")
HEADS = ("ce", "mol", "gauss")
N_MELS = 4
GEN_SEED = 7
LENGTH = None  # samples a free run; None: the whole mel


def available_heads():
    return [h for h in HEADS
            if os.path.exists(os.path.join(GOLDEN_ROOT, f"tiny_{h}", "meta.json"))]


def load_golden(head, device="cuda"):
    """(Wavenet, params, meta) of a committed golden teacher."""
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet

    d = os.path.join(GOLDEN_ROOT, f"tiny_{head}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    model = Wavenet(config_lib.load_config(os.path.join(d, "meta.json")))
    return model, weights.load_npz(os.path.join(d, "params.npz"), device=device), meta


def golden_audio(head, cuda=False, device="cuda"):
    """The free run [N_MELS, L] of a golden from its eval seeds' mels."""
    from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen

    model, params, meta = load_golden(head, device)
    mels, _ = quality.eval_mels(meta["eval_seeds"][:N_MELS])
    mels = torch.from_numpy(mels).to(device)
    fg = Fastgen(model)
    if cuda:
        audio = fg.generate_cuda(params, mels, seed=GEN_SEED, length=LENGTH)
    else:
        audio = fg.generate(params, mels, torch.Generator().manual_seed(GEN_SEED), length=LENGTH)
    return audio.cpu().numpy()


def main(out_dir, cuda=False, device="cuda"):
    """Writes <out_dir>/gen_golden_{head}_{i}.wav for every golden; returns
    the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for head in available_heads():
        audio = golden_audio(head, cuda, device)
        if not np.isfinite(audio).all():
            raise RuntimeError(f"the free run of tiny_{head} is not finite")
        for i in range(len(audio)):
            path = os.path.join(out_dir, f"gen_golden_{head}_{i}.wav")
            wav_io.write_wav(path, audio[i])
            print("wrote", path)
            paths.append(path)
    return paths


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "golden_wavs_torch"))
    ap.add_argument("--cuda", action="store_true",
                    help="serve through Fastgen.generate_cuda (bf16) instead of the plain "
                         "Fastgen.generate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(args.out_dir, args.cuda, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
