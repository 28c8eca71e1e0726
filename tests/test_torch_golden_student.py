"""The JAX package's golden-student gate, run on the port.

tests/test_golden_regression.py::test_golden_student_oneshot_tracks_conditioning
holds the JAX one-shot synthesis from the committed trained student to its
recorded mel tracking.  Here the same gate (the same held-out mels, the same
metrics and limits) holds the port's plain ``parallelgen.synthesize`` on the
CPU.  The noise is the port's own (a torch generator), so the audio differs
from JAX's sample by sample; the gate is about tracking, not samples.
"""

import json
import os

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from tools.make_golden_ckpt import eval_mels, student_dir
from tools.quality_smoke import mel_track_metrics


def test_golden_student_oneshot_tracks_conditioning_on_the_port():
    d = student_dir()
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    pwn = ParallelWavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    mels, _ = eval_mels(n=4)
    audio = parallelgen.synthesize(pwn, params, torch.from_numpy(mels),
                                   torch.Generator().manual_seed(7)).numpy()
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    mt = mel_track_metrics(audio, mels, meta["gen_samples"])
    m_corr, mm_corr = mt["corr"]
    print(f"port student mel tracking: matched corr {m_corr:.4f}, mismatched {mm_corr:.4f}, "
          f"recorded {meta['matched_corr']}; mcd {mt['mcd']}")
    assert m_corr > mm_corr + 0.05
    assert m_corr > meta["matched_corr"] - 0.15, (m_corr, meta["matched_corr"])
    assert mt["mcd"][0] < mt["mcd"][1], mt["mcd"]
