"""The port's copy of the speech-like corpus of the JAX package's passing
Gauss student smoke (nsynth_wavenet_tpu_torch/tools/speech_corpus_84d3f9e.py),
on the CPU:

* the copy bit for bit against fingerprints of git 84d3f9e's
  nsynth_wavenet_tpu/data/synthetic.py (made from that commit's source and
  committed here, so the test needs no git): the float64 sum (math.fsum),
  the first and last 8 samples and the sha256 of utterances 0, 1 and 23 of
  make_speechlike_corpus(seed=0), and of the 4 held-out clips 84d3f9e's
  tools/quality_smoke.py made (default_rng(1234), 1 s each);
* quality_smoke's corpus choice: under ``speech`` the dataset and held-out
  clips still equal the JAX package's data/synthetic.py; under
  ``speech_84d3f9e`` they are the copy's, and differ;
* ``gauss_pairing distill --corpus speech_84d3f9e --device cpu`` end to end
  at 2 steps from the tiny golden Gauss teacher, the corpus's dataset and
  clips in use, and the flow kernel's reading absent off the card.

Torch is pinned to one thread (step loops)."""

import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.data import synthetic as jax_synthetic
from nsynth_wavenet_tpu_torch.data import dataset as data_lib
from nsynth_wavenet_tpu_torch.tools import gauss_pairing as gp
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs
from nsynth_wavenet_tpu_torch.tools import speech_corpus_84d3f9e as corpus84
from nsynth_wavenet_tpu_torch.training import runner

# {index: (fsum, first 8 samples, last 8 samples, sha256 of the float32 bytes)}
CORPUS_FINGERPRINTS = {
    0: (233.62267261453823,
        (3.1766374e-04, 1.3784837e-03, -2.5886443e-04, 1.5503379e-03,
         -8.8774477e-04, 4.1416092e-04, -1.5449884e-03, 2.5128003e-03),
        (-2.8922388e-03, -9.3520887e-04, 1.1039176e-03, -2.7202885e-03,
         -2.0960195e-03, -8.788043e-04, -2.5178585e-03, -4.0410843e-04),
        'b7e544b694d44bdd9723c99e071b05bdfd3728e52da133bfa59ca1dea7939b14'),
    1: (423.2105630929083,
        (-2.2106785e-03, -1.7348643e-03, -8.537927e-04, 2.3114975e-03,
         1.4722723e-03, -1.6263686e-03, 6.230276e-04, 3.8215166e-04),
        (-3.4626606e-03, -2.4806656e-04, 4.8385636e-04, 1.63738e-03,
         5.072014e-04, -3.5954753e-04, 9.904476e-04, 2.8266895e-03),
        '893a11c70e350ad4dc6608daac285ed16177d286f84709370ad80bfac9cfa7d5'),
    23: (177.0253812351261,
        (-5.526512e-04, -6.886346e-05, -1.2622834e-03, -1.0337348e-03,
         1.3466199e-03, -1.1140661e-04, 9.5373904e-04, 1.3964932e-03),
        (-1.9928694e-03, 3.3168418e-03, -6.14114e-05, 1.9208763e-03,
         -1.4711731e-03, 3.5414146e-03, -2.2723802e-04, 1.0280667e-03),
        '26f164bccf4915b024e3472f1d7239573ca12e07de7c83b4a15a9f8994c531c3'),
}
HELD_OUT_FINGERPRINTS = {
    0: (105.47566719282241,
        (7.395862e-04, 3.3228933e-03, -1.0373911e-03, 1.2742368e-03,
         -1.9609968e-03, -4.2511276e-03, -1.5258327e-03, -1.9970697e-03),
        (-1.4324759e-03, -9.377372e-05, -1.3022093e-03, -5.220099e-04,
         5.667318e-04, 8.736896e-05, -1.2658584e-03, 2.970541e-03),
        'f08f2a2953996c141d83200ff7d3d51454c9419b505ad7b8aff1cc7dfbb1dbf6'),
    1: (257.8485758468205,
        (-2.4574096e-03, 1.3013989e-03, -3.8254465e-04, 1.5523917e-03,
         -1.6565551e-04, 2.8973976e-03, 9.35626e-04, -2.2673814e-03),
        (2.8723073e-03, -2.129045e-03, -2.4725704e-03, -2.01342e-03,
         1.9722185e-03, 1.1915647e-03, 5.4928563e-03, -3.2382912e-03),
        'c0cc50df72c4d92b340189cc7f4a18d580e21e5115206efa2f0ddc03ef19755c'),
    2: (232.87298916438158,
        (3.8947046e-03, 3.3240977e-03, 9.830996e-04, -6.828282e-04,
         -2.2510256e-04, 1.1591001e-03, -9.228201e-04, -8.576471e-04),
        (-1.7571786e-03, -1.9195111e-05, 3.2234318e-03, 7.370203e-04,
         6.7379134e-04, 5.4240995e-04, -2.2794711e-03, 1.08078195e-04),
        'bc2d00ac0cc57a765774b02bd37270935d85533dc1f602b99198e6489b4dcd0c'),
    3: (294.8194298723223,
        (1.9336643e-04, 2.8299917e-03, 8.976396e-04, 1.0204492e-03,
         2.1412347e-04, -5.0505216e-04, 8.082279e-05, 1.9308036e-04),
        (4.916853e-04, 5.6184377e-03, 7.0474045e-05, -2.955068e-03,
         3.2987108e-03, -2.5905631e-03, -2.3496656e-03, 1.9576654e-03),
        '0a2179da74750bf641c02a015d9788babbcaaf29188ad774a628d3d4f1d929ba'),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus():
    return corpus84.make_speechlike_corpus(seed=0)


def _assert_fingerprint(wav, want):
    total, head, tail, sha = want
    assert wav.dtype == np.float32
    assert math.fsum(wav.astype(np.float64)) == total
    np.testing.assert_array_equal(wav[:8], np.asarray(head, np.float32))
    np.testing.assert_array_equal(wav[-8:], np.asarray(tail, np.float32))
    assert hashlib.sha256(wav.tobytes()).hexdigest() == sha


@pytest.mark.parametrize("i", sorted(CORPUS_FINGERPRINTS))
def test_corpus_equals_84d3f9e(corpus, i):
    waves, ids = corpus
    assert len(waves) == 24 and ids[i] == f"pseudo_{i:03d}" and waves[i].shape == (32000,)
    _assert_fingerprint(waves[i], CORPUS_FINGERPRINTS[i])


@pytest.mark.parametrize("i", sorted(HELD_OUT_FINGERPRINTS))
def test_held_out_equals_84d3f9e(i):
    wavs = corpus84.held_out_wavs()
    assert wavs.shape == (4, 16000)
    _assert_fingerprint(wavs[i], HELD_OUT_FINGERPRINTS[i])


def _records(ds_dir):
    ds = data_lib.Dataset(ds_dir, use_native=False)
    return [ds.get_record(i) for i in range(len(ds))]


def test_quality_smoke_corpus_choice(tmp_path):
    n = 3
    # ``speech`` unchanged: the JAX package's corpus and held-out clips
    qs.make_speech_corpus(str(tmp_path / "speech"), n_utts=n)
    want, _ = jax_synthetic.make_speechlike_corpus(n_utts=n, duration=2.0, seed=0)
    for got, w in zip(_records(str(tmp_path / "speech")), want, strict=True):
        np.testing.assert_array_equal(got, w)
    rng = np.random.default_rng(qs.HELD_OUT_SEED)
    np.testing.assert_array_equal(qs.held_out_wavs("speech"), np.stack(
        [jax_synthetic.make_speechlike_utterance(rng, qs.SR, 1.0) for _ in range(4)]))
    # ``speech_84d3f9e``: the copy's, not the JAX package's current ones
    qs.make_speech_corpus(str(tmp_path / "old"), n_utts=n, corpus="speech_84d3f9e")
    old, _ = corpus84.make_speechlike_corpus(n_utts=n, seed=0)
    for got, w, new in zip(_records(str(tmp_path / "old")), old, want, strict=True):
        np.testing.assert_array_equal(got, w)
        assert not np.array_equal(got, new)
    held = qs.held_out_wavs("speech_84d3f9e")
    np.testing.assert_array_equal(held, corpus84.held_out_wavs())
    assert not np.array_equal(held, qs.held_out_wavs("speech"))
    # the Gauss pairing's sigma batch reads the chosen clips
    wav, _ = gp.held_out_batch(1280, "speech_84d3f9e")
    np.testing.assert_array_equal(wav, held[:, :1280])


def test_distill_on_84d3f9e_corpus_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(runner, "LOG_EVERY", 1)
    monkeypatch.setattr(qs, "STUDENT_CFG", dict(qs.STUDENT_CFG, num_iaf_layers=[2, 2],
                                                num_stages=2, width=16, wave_length=1280))
    monkeypatch.setattr(qs, "HELD_OUT_SAMPLES", 1200)
    monkeypatch.setattr(qs, "N_HELD_OUT", 2)
    monkeypatch.setattr(qs, "STUDENT_BATCH", 2)
    out, work = tmp_path / "out", tmp_path / "work"
    rc = gp.cli(["distill", "--corpus", "speech_84d3f9e", "--teacher", "golden", "--steps", "2",
                 "--device", "cpu", "--work_dir", str(work), "--out_dir", str(out)])
    text = capsys.readouterr().out
    for line in ("teacher sigma", "student kl", "student free-run std",
                 "student mel corr matched", "QUALITY SMOKE (student):",
                 "flow kernel reading: absent", "distill seed0_floor0_speech_84d3f9e"):
        assert line in text, line
    with open(out / "distill_seed0_floor0_speech_84d3f9e.json") as f:
        rep = json.load(f)
    assert rc == (0 if rep["passed"] else 1)
    assert rep["corpus"] == "speech_84d3f9e" and rep["steps"] == 2
    assert set(rep["gates"]) == {"kl", "power", "amp", "track"}
    assert rep["flow_kernel"].startswith("absent")
    assert rep["teacher_sigma"] == gp.read_sigma("golden", "cpu", "speech_84d3f9e")
    assert rep["teacher_sigma"] != gp.read_sigma("golden", "cpu")
    # the student trained on the copy's corpus
    ds_dir = os.path.join(str(work), "ds_speech_84d3f9e")
    want, _ = corpus84.make_speechlike_corpus(seed=0)
    for got, w in zip(_records(ds_dir), want, strict=True):
        np.testing.assert_array_equal(got, w)
