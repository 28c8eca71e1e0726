"""The JAX package's golden quality gate on the port's serving path, on the
CPU.

tests/test_golden_regression.py::test_golden_freerun_tracks_conditioning
holds a free run of each committed trained teacher (tests/golden/tiny_*) to
the mel tracking recorded when it was trained: 8 000 samples generated from
the first 41 frames of the two held-out mels, matched corr > mismatched
corr + 0.05, matched corr > meta.matched_corr - 0.2 and matched MCD <
mismatched MCD.  Here the same
gate, the same mels and limits, holds the port's Fastgen.generate_cuda (its
plain version on CPU tensors, the arithmetic of the CUDA kernel) in every
serving mode on tiny_mol and in bf16 on tiny_ce and tiny_gauss.  The noise is
the port's own Philox stream, so the audio differs from JAX's sample by
sample; the gate is about tracking.  Nothing is tightened beyond JAX's gate.

The metrics are utils/quality.py's, the port's copy of
tools/quality_smoke.py's; they are held equal to the tools' on the same
audio (within 1e-6 of each reading: the two mels part by up to 1e-5 of a
normalised dB, tests/test_torch_ops.py)."""

import json
import os

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import stft as tstft
from nsynth_wavenet_tpu_torch.utils import quality
from tools.make_golden_ckpt import eval_mels, golden_dir
from tools.quality_smoke import mel_track_metrics

N_GEN = 8000  # as tests/test_golden_regression.py
# (head, generate_cuda options beyond the packed weights' mode): the six
# serving modes of the AR kernel that a user picks
MODES = [
    ("mol", "bf16", {}),
    ("mol", "w8a8_static", dict(weight_dtype="int8", gate_static=True)),
    ("mol", "w8a8_row", dict(weight_dtype="int8")),
    ("mol", "w8a8_row_rs_bf16", dict(weight_dtype="int8", rs_dtype="bf16")),
    ("ce", "bf16", {}),
    ("gauss", "bf16", {}),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _golden(head):
    d = golden_dir(head)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    model = Wavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    return model, weights.load_npz(os.path.join(d, "params.npz"), device="cpu"), meta


@pytest.mark.parametrize("head,mode,kw", MODES, ids=[f"{h}-{m}" for h, m, _ in MODES])
def test_golden_gate_holds_the_serving_path(head, mode, kw):
    model, params, meta = _golden(head)
    mels, wavs = eval_mels(n=2)
    mels = mels[:, : 1 + N_GEN // 200]
    fg = Fastgen(model)
    if mode == "w8a8_static":
        # calibrated on the two held-out utterances' audio
        kw = dict(kw, act_amax=fg.calibrate_act_amax(
            params, torch.from_numpy(wavs), torch.from_numpy(tstft.melspectrogram_np(wavs))))
    audio = fg.generate_cuda(params, torch.from_numpy(mels), seed=7, **kw).numpy()
    assert audio.shape == (2, mels.shape[1] * 200)
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    mt = quality.mel_track_metrics(audio, mels, N_GEN)
    ok, reading = quality.golden_gate(mt, meta["matched_corr"], quality.TEACHER_MARGIN)
    print(f"{head} {mode}: {reading}")
    assert ok, reading


def test_metrics_equal_the_tools_copy():
    mels, wavs = eval_mels(n=2)
    audio = np.stack([wavs[0], 0.5 * wavs[1]])
    got, want = quality.mel_track_metrics(audio, mels, 12000), mel_track_metrics(audio, mels, 12000)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6 * max(1.0, abs(want[k][1])), rtol=0)
    # the port's copy of the held-out mels
    pmels, pwavs = quality.eval_mels((101, 202))
    np.testing.assert_array_equal(pwavs, wavs)
    np.testing.assert_allclose(pmels, mels, atol=1e-5, rtol=0)


def test_gate_refuses_untracked_audio():
    model, params, meta = _golden("mol")
    mels, _ = eval_mels(n=2)
    audio = np.stack([np.zeros(N_GEN, np.float32), np.zeros(N_GEN, np.float32)])
    audio += 0.1 * np.random.default_rng(0).standard_normal(audio.shape).astype(np.float32)
    ok, reading = quality.golden_gate(quality.mel_track_metrics(audio, mels, N_GEN),
                                      meta["matched_corr"], quality.TEACHER_MARGIN)
    assert not ok, reading


@pytest.mark.parametrize("corr,mcd,ok", [
    ((0.60, 0.10), (200.0, 500.0), True),
    ((0.60, 0.56), (200.0, 500.0), False),  # matched within 0.05 of mismatched
    ((0.40, 0.10), (200.0, 500.0), False),  # under the recorded 0.6206 - 0.2
    ((0.60, 0.10), (500.0, 200.0), False),  # spectrally further than mismatched
], ids=["pass", "mismatch_gap", "recorded", "mcd"])
def test_gate_conditions(corr, mcd, ok):
    """Each of the JAX gate's three conditions fails the gate alone."""
    got, reading = quality.golden_gate({"corr": corr, "mcd": mcd, "msd": (0.0, 0.0)}, 0.6206,
                                       quality.TEACHER_MARGIN)
    assert got == ok, reading
