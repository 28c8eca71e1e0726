"""The port's ops tools (nsynth_wavenet_tpu_torch/tools/) against the JAX
package's tools/ on the CPU: make_golden_ckpt's int8 storage bit for bit on
every golden and its layout loaded by both sides, downsample bit for bit,
find_runs / make_eval_model / gather_results on a port run directory, the
long-form check, make_golden_ckpt and make_golden_wavs end to end at a tiny
size (module constants shrunk here), and every tool's ``python -m`` entry."""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.tools import downsample as tds
from nsynth_wavenet_tpu_torch.tools import gather_results as tgr
from nsynth_wavenet_tpu_torch.tools import longform_check as tlf
from nsynth_wavenet_tpu_torch.tools import make_eval_model as tme
from nsynth_wavenet_tpu_torch.tools import make_golden_ckpt as tmg
from nsynth_wavenet_tpu_torch.tools import make_golden_wavs as tmw
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs
from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
from nsynth_wavenet_tpu_torch.training import runner
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib
from tools import downsample as jds
from tools import gather_results as jgr
from tools import make_golden_ckpt as jmg

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOOLS = ("quality_smoke", "longform_check", "make_golden_ckpt", "make_golden_wavs",
         "make_eval_model", "downsample", "gather_results")
TINY = dict(num_layers=2, num_stages=2, width=16, skip_width=16, deconv_width=16,
            wave_length=1280)
META_KEYS = {"config", "train_steps", "corpus", "eval_seeds", "batch_pad_seeds", "gen_samples",
             "matched_corr", "mismatched_corr"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stored(head):
    with np.load(os.path.join(GOLDEN, f"tiny_{head}", "params.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("head", ("ce", "mol", "gauss", "student"))
def test_quantize_flat_equals_jax(head):
    flat = jmg.dequantize_flat(_stored(head))
    got, want = tmg.quantize_flat(flat), jmg.quantize_flat(flat)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape and np.array_equal(got[k], w), k
    assert any(k.endswith("#q") for k in got)
    dq = weights.dequantize_npz(got)
    assert sorted(dq) == sorted(jmg.dequantize_flat(want))
    for k, v in jmg.dequantize_flat(want).items():
        assert np.array_equal(dq[k], v), k


@pytest.mark.parametrize("head", ("ce", "student"))
def test_golden_layout_loads_on_both_sides(tmp_path, head):
    """The port's round trip and writer on a golden's params: JAX's
    load_golden reads the directory to the params weights.load_npz reads,
    and meta.json has the JAX tool's keys."""
    d = os.path.join(GOLDEN, f"tiny_{head}")
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    with open(os.path.join(d, "meta.json")) as f:
        config = json.load(f)["config"]
    stored, back = tmg.round_trip(params)
    extra = (dict(student=True, pairing="gauss", teacher=qs.GAUSS_TEACHER_CFG)
             if head == "student" else dict(head=head))
    out = str(tmp_path / f"tiny_{head}")
    tmg.write_golden(out, stored, tmg._meta(config, 7, 0.5, 0.25, **extra))
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == META_KEYS | set(extra)
    assert meta["eval_seeds"] == list(jmg.METRIC_SEEDS) and meta["gen_samples"] == jmg.GEN_SAMPLES
    _, jparams, jmeta = jmg.load_golden(out)
    assert jmeta == meta
    ported = weights.load_npz(os.path.join(out, "params.npz"), device="cpu")
    jflat = jmg.flatten_params(jparams)
    tflat = weights.flatten(weights.to_jax_params(ported))
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert np.array_equal(tflat[k], v), k
    for a, b in zip(tree_lib.leaves(back), tree_lib.leaves(ported)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sr", (44100, 22050))
def test_downsample_equals_jax(tmp_path, sr):
    t = np.arange(int(0.5 * sr)) / sr
    wav = (0.6 * np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 3000 * t)).astype(np.float32)
    src = str(tmp_path / "src.wav")
    wav_io.write_wav(src, wav, sr)
    tds.downsample_file(src, str(tmp_path / "port.wav"), 16000)
    jds.downsample_file(src, str(tmp_path / "jax.wav"), 16000)
    got = (tmp_path / "port.wav").read_bytes()
    assert got == (tmp_path / "jax.wav").read_bytes()
    out, got_sr = wav_io.read_wav(str(tmp_path / "port.wav"))
    assert got_sr == 16000 and abs(len(out) - 8000) <= 1
    (tmp_path / "dir").mkdir()
    wav_io.write_wav(str(tmp_path / "dir" / "a.wav"), wav, sr)
    tds.downsample_dir(str(tmp_path / "dir"), str(tmp_path / "dir16"), 16000, workers=2)
    assert (tmp_path / "dir16" / "a.wav").read_bytes() == got


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """A teacher run directory of the port's runner, 2 tiny steps, under
    <tmp>/runs."""
    monkeypatch.setattr(runner, "LOG_EVERY", 1)
    ds = str(tmp_path / "ds")
    qs.make_speech_corpus(ds, n_utts=2)
    cfg = qs._write_config(str(tmp_path / "te.json"), dict(qs.TEACHER_CFG, **TINY))
    run_dir, state = runner.train_wavenet(ds, config_path=cfg, log_root=str(tmp_path / "runs"),
                                          total_batch_size=2, num_steps=2, device="cpu")
    return run_dir, state


def test_find_runs_and_make_eval_model(tmp_path, tiny_run):
    run_dir, state = tiny_run
    root = str(tmp_path / "runs")
    (tmp_path / "runs" / "not_a_run").mkdir()
    assert tgr.find_runs(root) == jgr.find_runs(root) == [run_dir]
    out = tme.save_eval_model(run_dir, str(tmp_path / "export"), device="cpu")
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f)["step"] == 2
    exported = ckpt_lib.load_params(out, device="cpu")
    for a, b in zip(tree_lib.leaves(exported), tree_lib.leaves(state["ema"])):
        assert torch.equal(a, b)
    assert tme.save_eval_model(run_dir, device="cpu") == os.path.join(run_dir, "ema")
    assert tgr.find_runs(root) == [run_dir]  # ema/ adds no top-level json


def test_gather_results_synthesizes_every_run(tmp_path, tiny_run):
    run_dir, _ = tiny_run
    src = tmp_path / "src"
    src.mkdir()
    wav_io.write_wav(str(src / "utt.wav"), qs.held_out_wavs("speech")[0][:2000])
    out = tgr.gather(str(tmp_path / "runs"), str(src), str(tmp_path / "results"), device="cpu")
    name = os.path.basename(run_dir)
    assert list(out) == [name]
    res = tmp_path / "results" / name
    for f in ("te.json", "train.log", "metrics.jsonl"):
        assert (res / f).exists(), f
    wav, sr = wav_io.read_wav(str(res / "generated" / "gen_utt.wav"))
    assert sr == 16000 and len(wav) >= 2000 and np.isfinite(wav).all()


@pytest.mark.parametrize("mode", ("bf16", "int8_static"))
def test_longform_check_end_to_end(tmp_path, monkeypatch, capsys, mode):
    """tiny_mol under <run>/ema, 1 s: 2 utterances, a 4 000-sample second."""
    ema = tmp_path / "run" / "ema"
    ema.mkdir(parents=True)
    for f in ("params.npz", "meta.json"):
        (ema / f).write_bytes(open(os.path.join(GOLDEN, "tiny_mol", f), "rb").read())
    monkeypatch.setattr(tlf, "N_UTTS", 2)
    monkeypatch.setattr(tlf, "SR", 4000)
    rc = tlf.main(str(tmp_path / "run"), 1, 1000, mode, str(tmp_path / "out"), device="cpu")
    assert rc in (0, 1)
    out = capsys.readouterr().out
    for line in ("per-window matched mel corr:", "per-window MCD (dB):", f"({mode}, 1s, chunk 1000)"):
        assert line in out, line
    assert (tmp_path / "out" / f"longform_{mode}_1.wav").exists()


def test_make_golden_ckpt_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(runner, "LOG_EVERY", 1)
    monkeypatch.setattr(qs, "TEACHER_CFG", dict(qs.TEACHER_CFG, **TINY))
    monkeypatch.setattr(tmg, "GEN_SAMPLES", 1000)
    rc = tmg.main("ce", steps=2, batch=2, workdir=str(tmp_path / "work"),
                  out_dir=str(tmp_path / "golden"), device="cpu")
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "golden ce free-run tracking: matched" in out and "wrote " in out
    d = str(tmp_path / "golden" / "tiny_ce")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == META_KEYS | {"head"} and meta["train_steps"] == 2
    assert meta["config"]["compute_dtype"] == "float32"
    _, jparams, _ = jmg.load_golden(d)
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    jflat = jmg.flatten_params(jparams)
    for k, v in weights.flatten(weights.to_jax_params(params)).items():
        assert np.array_equal(v, jflat[k]), k


@pytest.mark.parametrize("cuda", (False, True))
def test_make_golden_wavs_end_to_end(tmp_path, monkeypatch, cuda):
    monkeypatch.setattr(tmw, "LENGTH", 300)
    paths = tmw.main(str(tmp_path), cuda=cuda, device="cpu")
    assert len(paths) == 12
    for head in ("ce", "mol", "gauss"):
        for i in range(4):
            wav, sr = wav_io.read_wav(str(tmp_path / f"gen_golden_{head}_{i}.wav"))
            assert sr == 16000 and len(wav) == 300 and np.isfinite(wav).all()
            assert np.abs(wav).max() > 0


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
@pytest.mark.parametrize("name", TOOLS)
def test_python_m_entry(monkeypatch, capsys, name):
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"nsynth_wavenet_tpu_torch.tools.{name}", run_name="__main__")
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "usage:" in out
    assert name == "downsample" or "--device" in out  # downsample runs on the host
