"""The port's quality smoke (nsynth_wavenet_tpu_torch/tools/quality_smoke.py)
against the JAX package's tools/quality_smoke.py on the CPU: the four config
dicts and their typed configs, the tones and speech corpora and the held-out
clips bit for bit, the metrics and log parsers within 1e-6, the
teacher-forced gates on the golden tiny_ce within the f32 step limit, the
tracking gate on consistent, noisy and rolled batches, and both entries end
to end at a tiny size (the tool's module constants shrunk here)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.data import dataset as jdata
from nsynth_wavenet_tpu.data.synthetic import make_speechlike_utterance as j_utterance
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import dataset as tdata
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs
from nsynth_wavenet_tpu_torch.training import runner
from nsynth_wavenet_tpu_torch.utils import quality
from tools import quality_smoke as jqs
from tools.make_golden_ckpt import load_golden

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SR = 16000
METRIC_RTOL = 1e-6
# tests/test_torch_train_step.py TOL["f32"][0]: the f32 limit of a step
# against JAX's
TF_RTOL = 1e-4
TINY_TEACHER = dict(num_layers=2, num_stages=2, width=16, skip_width=16, deconv_width=16,
                    wave_length=1280)
TINY_STUDENT = dict(num_iaf_layers=[2, 2], num_stages=2, width=16, deconv_width=16,
                    wave_length=1280)
CONFIGS = {
    "teacher": lambda m: m.TEACHER_CFG,
    "gauss_teacher": lambda m: m.GAUSS_TEACHER_CFG,
    "mol_teacher": lambda m: m.MOL_TEACHER_CFG,
    "student": lambda m: m.STUDENT_CFG,
    "student_mol_pairing": lambda m: dict(m.STUDENT_CFG, loss_type="logistic", num_samples=100),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_dicts_equal_jax_and_load_alike(tmp_path, name):
    d = CONFIGS[name](qs)
    assert d == CONFIGS[name](jqs)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(d))
    got, want = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _records(path, lib):
    ds = lib.Dataset(path)
    return [np.asarray(ds.get_record(i)) for i in range(len(ds))], ds


@pytest.mark.parametrize("corpus", ("tones", "speech"))
def test_corpus_equals_jax_record_by_record(tmp_path, corpus):
    t_dir, j_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    if corpus == "tones":
        (t_index, t_pitches), (j_index, j_pitches) = qs.make_corpus(t_dir), jqs.make_corpus(j_dir)
        assert t_pitches == j_pitches
    else:
        t_index, j_index = qs.make_speech_corpus(t_dir), jqs.make_speech_corpus(j_dir)
    assert t_index == j_index
    (got, _), (want, _) = _records(t_dir, tdata), _records(j_dir, jdata)
    assert len(got) == len(want) == (16 if corpus == "tones" else 24)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _jax_held_out(corpus):
    """The held-out clips as the JAX tool's main and main_student make them."""
    if corpus == "speech":
        rng = np.random.default_rng(1234)
        return np.stack([j_utterance(rng, SR, 1.0) for _ in range(4)])
    t = np.arange(SR) / SR
    return np.stack([0.4 * (np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(2 * np.pi * 2 * f0 * t)
                            + 0.2 * np.sin(2 * np.pi * 3 * f0 * t))
                     for f0 in (110, 150, 200, 270)]).astype(np.float32)


@pytest.mark.parametrize("corpus", ("tones", "speech"))
def test_held_out_clips_equal_jax(corpus):
    got, want = qs.held_out_wavs(corpus), _jax_held_out(corpus)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _audio(kind):
    if kind == "tones":
        return _jax_held_out("tones")
    if kind == "noise":
        return (0.3 * np.random.default_rng(5).standard_normal((4, SR))).astype(np.float32)
    from nsynth_wavenet_tpu_torch.data import wav_io

    return np.stack([wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))[0][:SR]
                     for i in range(4)])


def _jax_flatness(gen):
    spec = np.abs(np.fft.rfft(gen[2000:] * np.hanning(len(gen) - 2000))) + 1e-9
    return float(np.exp(np.mean(np.log(spec))) / np.mean(spec))


@pytest.mark.parametrize("kind", ("tones", "noise", "generated"))
def test_metrics_equal_jax(kind):
    audio = _audio(kind)
    mels = jstft.melspectrogram_np(_jax_held_out("speech"))
    got, want = qs.mel_track_metrics(audio, mels, SR), jqs.mel_track_metrics(audio, mels, SR)
    for m in ("corr", "msd", "mcd"):
        for g, w in zip(got[m], want[m]):
            assert _rel(g, w) <= METRIC_RTOL, (m, g, w)
    assert qs.mel_track_corr(audio, mels, SR) == got["corr"]
    gen_mel = jstft.melspectrogram_np(audio[0])
    assert _rel(quality.mcd(gen_mel, mels[1, : len(gen_mel)]),
                jqs._mcd(gen_mel, mels[1, : len(gen_mel)])) <= METRIC_RTOL
    for row in audio:
        assert qs.dominant_freq(row) == jqs.dominant_freq(row)
        assert _rel(qs.spectral_flatness(row), _jax_flatness(row)) <= METRIC_RTOL


def _jax_teacher_losses(run_dir):
    """The JAX tool's inline train.log loss parser (main)."""
    losses = []
    with open(os.path.join(run_dir, "train.log")) as f:
        for line in f:
            if " loss " in line:
                losses.append(float(line.split(" loss ")[1].split()[0]))
    return losses


def _synthetic_student_log(run, hpt):
    rng = np.random.default_rng(0)
    lines = []
    for i in range(40):
        base = 10.0 if i < 20 else 1.0
        extra = f" hpt {base - 1 + rng.uniform(-.1, .1):.4f}" if hpt else ""
        lines.append(f"step {100 * (i + 1)} loss {base + rng.uniform(-.2, .2):.4f} "
                     f"kl {base / 10 + rng.uniform(-.02, .02):.4f} "
                     f"power {base / 2 + rng.uniform(-.1, .1):.4f}{extra} (50.0 steps/s)")
    (run / "train.log").write_text("\n".join(lines))
    return str(run)


def _tiny_runs(tmp_path, monkeypatch):
    """A teacher and a student run directory of the port's runners, 2 steps
    each, a log line a step."""
    monkeypatch.setattr(runner, "LOG_EVERY", 1)
    ds = str(tmp_path / "ds")
    qs.make_speech_corpus(ds, n_utts=4)
    te_cfg = qs._write_config(str(tmp_path / "te.json"),
                              dict(qs.GAUSS_TEACHER_CFG, **TINY_TEACHER))
    te_dir, _ = runner.train_wavenet(ds, config_path=te_cfg, log_root=str(tmp_path / "runs"),
                                     total_batch_size=2, num_steps=2, device="cpu")
    st_cfg = qs._write_config(str(tmp_path / "st.json"), dict(qs.STUDENT_CFG, **TINY_STUDENT))
    st_dir, _ = runner.train_parallel_wavenet(ds, te_dir, config_path=st_cfg,
                                              log_root=str(tmp_path / "runs"),
                                              total_batch_size=2, num_steps=2, device="cpu")
    return te_dir, st_dir


@pytest.mark.parametrize("log", ("synthetic", "synthetic_hpt", "runner"))
def test_log_parsers_equal_jax(tmp_path, monkeypatch, log):
    if log == "runner":
        te_dir, st_dir = _tiny_runs(tmp_path, monkeypatch)
        losses = qs.parse_teacher_log(te_dir)
        assert len(losses) == 2 and losses == _jax_teacher_losses(te_dir)
        runs = [st_dir]
    else:
        runs = [_synthetic_student_log(tmp_path, log == "synthetic_hpt")]
    for run in runs:
        assert qs.parse_teacher_log(run) == _jax_teacher_losses(run)
        for window in (1, 10):
            got, want = qs.parse_student_log(run, window), jqs.parse_student_log(run, window)
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                assert (np.isnan(g) and np.isnan(w)) or _rel(g, w) <= METRIC_RTOL, (g, w)


def test_teacher_forced_gates_equal_jax_on_tiny_ce():
    jmodel, jparams, meta = load_golden("ce")
    d = os.path.join(GOLDEN, "tiny_ce")
    model = Wavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    assert model.cfg.compute_dtype == "float32"
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    wavs = qs.held_out_wavs("speech")
    mel = jstft.melspectrogram_np(wavs)
    tf_loss, tf_mis = qs.teacher_forced_losses(model, params, wavs, mel)

    # the JAX tool's recipe (main, speech corpus)
    tf_fn = jax.jit(lambda p, w, m: jmodel.forward_loss(p, w, m)["loss"])
    wav_crop = wavs[:, : jmodel.cfg.wave_length]
    mel_crop = mel[:, : jmodel.cfg.wave_length // 200 + 1]
    j_loss = float(tf_fn(jparams, wav_crop, mel_crop))
    j_mis = float(tf_fn(jparams, wav_crop, np.roll(mel_crop, 1, axis=0)))
    print(f"tiny_ce held-out TF loss port {tf_loss:.6f} jax {j_loss:.6f}; shuffled "
          f"{tf_mis:.6f} / {j_mis:.6f}")
    assert _rel(tf_loss, j_loss) <= TF_RTOL and _rel(tf_mis, j_mis) <= TF_RTOL
    cg = qs.cond_gate(tf_loss, tf_mis, "ce")
    assert abs(cg["cond_gap"] - (j_mis - j_loss)) <= TF_RTOL * max(abs(j_mis), 1.0)
    assert cg["ok"] == (j_mis - j_loss > 0.15)
    assert qs.tf_gate(tf_loss, None, "ce", "speech")["ok"] == (j_loss < 4.5)


def _tracking_batch(kind):
    wavs = qs.held_out_wavs("speech")
    mels = jstft.melspectrogram_np(wavs)
    if kind == "noise":
        wavs = (0.3 * np.random.default_rng(3).standard_normal(wavs.shape)).astype(np.float32)
    elif kind == "rolled":
        wavs = np.roll(wavs, 1, axis=0)
    return wavs, mels


@pytest.mark.parametrize("kind,passes", (("consistent", True), ("noise", False),
                                         ("rolled", False)))
def test_tracking_gate(kind, passes):
    wavs, mels = _tracking_batch(kind)
    mt = qs.mel_track_metrics(wavs, mels, SR)
    assert qs.tracking_gate(mt) is passes, mt
    assert qs.student_tracking_gate(mt, "speech") is passes
    m_corr, mm_corr = mt["corr"]
    assert qs.kernel_tracking_gate(m_corr, mm_corr, m_corr) is passes


# Each gate against the JAX tool's inline comparison, at readings on both
# sides of every threshold.
GATE_CASES = [
    ("loss", dict(losses=[5.0, 3.99], head="ce", corpus="speech"), True),
    ("loss", dict(losses=[5.0, 4.01], head="ce", corpus="speech"), False),
    ("loss", dict(losses=[5.0, 2.49], head="ce", corpus="tones"), True),
    ("loss", dict(losses=[5.0, 2.51], head="ce", corpus="tones"), False),
    ("loss", dict(losses=[3.0, 1.99], head="gauss", corpus="speech"), True),
    ("loss", dict(losses=[3.0, 2.01], head="mol", corpus="speech"), False),
    ("tf", dict(tf_loss=4.49, final_loss=None, head="ce", corpus="speech"), True),
    ("tf", dict(tf_loss=3.01, final_loss=None, head="ce", corpus="tones"), False),
    ("tf", dict(tf_loss=1.49, final_loss=1.0, head="gauss", corpus="speech"), True),
    ("tf", dict(tf_loss=1.51, final_loss=1.0, head="mol", corpus="speech"), False),
    ("cond", dict(tf_loss=3.0, tf_mis=3.16, head="ce"), True),
    ("cond", dict(tf_loss=3.0, tf_mis=3.14, head="ce"), False),
    ("cond", dict(tf_loss=3.0, tf_mis=3.06, head="gauss"), True),
    ("cond", dict(tf_loss=3.0, tf_mis=3.04, head="mol"), False),
    ("tonal", dict(flatnesses=[0.44, 0.1, 0.9], corrs=[0.41, 0.41]), True),
    ("tonal", dict(flatnesses=[0.46, 0.5, 0.1], corrs=[0.9, 0.9]), False),
    ("tonal", dict(flatnesses=[0.1, 0.1, 0.1], corrs=[0.39, 0.4]), False),
    ("kernel_tonal", dict(flatnesses=[0.39, 0.2], corrs=[0.5], base_median=0.2), True),
    ("kernel_tonal", dict(flatnesses=[0.5, 0.3], corrs=[0.5], base_median=0.2), False),
    ("student_loss", dict(head=(0, 1.0, 1.0, np.nan), tail=(0, 0.49, 0.49, np.nan),
                          pairing="gauss", steps=100), (True, True)),
    ("student_loss", dict(head=(0, 1.0, 1.0, np.nan), tail=(0, 0.51, 0.49, np.nan),
                          pairing="gauss", steps=100), (False, True)),
    ("student_loss", dict(head=(0, 10.0, 1.0, 8.0), tail=(0, 11.9, 0.54, 8.5),
                          pairing="mol", steps=30000), (True, True)),
    ("student_loss", dict(head=(0, 10.0, 1.0, 8.0), tail=(0, 12.1, 0.56, 7.0),
                          pairing="mol", steps=30000), (False, False)),
    ("student_loss", dict(head=(0, 10.0, 1.0, 8.0), tail=(0, 11.0, 0.5, 7.95),
                          pairing="mol", steps=60000), (False, True)),
    ("student_loss", dict(head=(0, 10.0, 1.0, 8.0), tail=(0, 11.0, 0.5, 7.85),
                          pairing="mol", steps=60000), (True, True)),
    ("student_amp", dict(audio=np.full((2, 8), 0.02) * np.array([1, -1] * 4)), True),
    ("student_amp", dict(audio=np.full((2, 8), 0.005) * np.array([1, -1] * 4)), False),
    ("student_amp", dict(audio=np.array([[0.5, np.nan]])), False),
]


@pytest.mark.parametrize("gate,kw,want", GATE_CASES)
def test_gate_thresholds_are_jax(gate, kw, want):
    fn = getattr(qs, f"{gate}_gate")
    out = fn(**kw)
    if gate == "student_loss":
        assert (out["kl_ok"], out["pw_ok"]) == want
    else:
        assert bool(out["ok"]) is want


def _tiny_tool(monkeypatch):
    monkeypatch.setattr(runner, "LOG_EVERY", 1)
    for name in ("TEACHER_CFG", "GAUSS_TEACHER_CFG", "MOL_TEACHER_CFG"):
        monkeypatch.setattr(qs, name, dict(getattr(qs, name), **TINY_TEACHER))
    monkeypatch.setattr(qs, "STUDENT_CFG", dict(qs.STUDENT_CFG, **TINY_STUDENT))
    monkeypatch.setattr(qs, "HELD_OUT_SAMPLES", 1200)
    monkeypatch.setattr(qs, "N_HELD_OUT", 2)
    monkeypatch.setattr(qs, "TEACHER_BATCH", 2)
    monkeypatch.setattr(qs, "STUDENT_BATCH", 2)


def test_main_speech_ce_compare_cuda_end_to_end(tmp_path, monkeypatch, capsys):
    _tiny_tool(monkeypatch)
    res = qs.teacher_smoke(3, str(tmp_path), corpus="speech", head="ce", n_utts=4,
                           compare_cuda=True, device="cpu")
    out = capsys.readouterr().out
    for line in ("final training loss", "held-out teacher-forced loss", "cond gap (shuffled-mel",
                 "free-run mel corr matched", "cuda-bf16: free-run mel corr", "cuda-int8:",
                 "cuda-int8s:", "QUALITY SMOKE (speech):"):
        assert line in out, line
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["audio"].shape == (2, 1400) and np.isfinite(res["audio"]).all()
    assert set(res["cuda"]) == {"cuda-bf16", "cuda-int8", "cuda-int8s"}
    for r in res["cuda"].values():
        assert r["audio"].shape == (2, 1400) and r["launches"] == {}  # the plain version
    assert set(res["gates"]) == {"loss", "tf", "cond", "track", "cuda-bf16", "cuda-int8",
                                 "cuda-int8s"}
    assert res["passed"] == all(res["gates"].values())
    assert os.path.exists(tmp_path / "gen_speech_0.wav")
    assert qs.main(2, str(tmp_path / "again"), corpus="speech", n_utts=4, device="cpu") in (0, 1)


def test_main_student_gauss_end_to_end(tmp_path, monkeypatch, capsys):
    _tiny_tool(monkeypatch)
    assert qs.main_student(3, str(tmp_path), "speech", "gauss", n_utts=4, device="cpu") in (0, 1)
    out = capsys.readouterr().out
    for line in ("student kl", "student free-run std", "student mel corr matched",
                 "QUALITY SMOKE (student):"):
        assert line in out, line
