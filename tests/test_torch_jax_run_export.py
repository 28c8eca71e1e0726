"""tools/jax_run_to_torch.py on JAX run directories written inside the test,
on the CPU.

The JAX trainer writes a tiny teacher run (3 steps, no EMA export: the
converter takes the latest checkpoint's EMA) and a tiny student run
distilled from it (2 steps, then tools/make_eval_model.py's EMA export: the
converter takes the export).  The converter writes each in the port's
EMA-export layout, and then:
  * the port's load_eval_model reads params equal bit for bit to the EMA
    that JAX's load_eval_model restores, and the run's config;
  * the port's teacher-forced forward (teacher) and its feed_forward on the
    same base noise (student) agree with JAX's within 1e-4 x max(|JAX|, 1)
    (f32, summation order, as tests/test_torch_wavenet.py);
  * eval_wavenet_torch.py and eval_parallel_wavenet_torch.py --ckpt_dir
    serve the converted directories on the CPU and write finite wavs."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import evaluation as jeval
from nsynth_wavenet_tpu.data import dataset as jdata
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu.training import runner as jrunner
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.evaluation import load_eval_model
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from test_e2e import ST_CFG, TE_CFG
from tools import jax_run_to_torch
from tools.make_eval_model import save_eval_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_runs")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(6000) / 16000.0
    for i in range(4):
        w = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.01 * rng.standard_normal(6000)
        jdata.write_wav(str(wav_dir / f"utt_{i}.wav"), np.clip(w, -0.99, 0.99))
    ds = str(root / "ds")
    jdata.build_dataset(str(wav_dir), ds, min_len=2000)
    (root / "te.json").write_text(json.dumps(TE_CFG))
    (root / "st.json").write_text(json.dumps(ST_CFG))
    te_run, _ = jrunner.train_wavenet(ds, config_path=str(root / "te.json"),
                                      log_root=str(root / "runs"), total_batch_size=2, num_steps=3,
                                      ckpt_every_steps=3)
    st_run, _ = jrunner.train_parallel_wavenet(ds, te_run, config_path=str(root / "st.json"),
                                               log_root=str(root / "runs"), total_batch_size=2,
                                               num_steps=2, ckpt_every_steps=2)
    save_eval_model(st_run)
    # a student trained with norm_feat keeps its power-loss statistics here
    np.savez(os.path.join(st_run, "norm_stats.npz"), mean=np.arange(3, dtype=np.float32),
             std=np.ones(3, np.float32))
    return {"root": root, "wavs": str(wav_dir), "teacher": te_run, "student": st_run}


def _flat_jax(params):
    return weights.flatten(jax.tree_util.tree_map(np.asarray, params))


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _check_converted(run, out, want_cfg):
    jmodel, jparams = jeval.load_eval_model(run)
    cfg, params = load_eval_model(out, device="cpu")
    assert cfg == want_cfg
    want, got = _flat_jax(jparams), weights.flatten(weights.to_jax_params(params))
    assert want.keys() == got.keys() and len(want) > 0
    for k in want:
        assert want[k].dtype == got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return jmodel, jparams, cfg, params


def _served(out_dir, n=4):
    names = sorted(os.listdir(out_dir))
    assert names == [f"gen_utt_{i}.wav" for i in range(n)]
    for name in names:
        wav, sr = jdata.read_wav(os.path.join(out_dir, name))
        assert sr == 16000 and len(wav) > 0 and np.isfinite(wav).all()


def test_teacher_run_converts_and_serves(runs):
    out = str(runs["root"] / "teacher_torch")
    assert jax_run_to_torch.convert(runs["teacher"], out) == out
    with open(os.path.join(out, "ema", "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"config": TE_CFG, "step": 3}
    jmodel, jparams, cfg, params = _check_converted(
        runs["teacher"], out, tconfig.wavenet_config_from_dict(TE_CFG))
    assert not os.path.exists(os.path.join(out, "norm_stats.npz"))

    wav = jdata.Dataset(os.path.join(runs["root"], "ds")).get_init_batch(2, 1280, seed=1)
    mel = jstft.melspectrogram_np(wav)
    enc = jmodel.encode_signal({"wav": wav})
    jff, _ = jmodel.feed_forward(jparams, {"wav_scaled": enc["wav_scaled"], "mel": mel})
    want = np.asarray(jff["out_params"])
    model = Wavenet(tconfig.wavenet_config_from_dict(TE_CFG, use_as_teacher=True))
    tenc = model.encode_signal(torch.from_numpy(wav))
    got = model.feed_forward(params, {"wav_scaled": tenc["wav_scaled"],
                                      "mel": torch.from_numpy(mel)})["out_params"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1.0), rtol=0)

    gen = str(runs["root"] / "gen_teacher")
    _cli("eval_wavenet_torch.py", "--ckpt_dir", out, "--source_path", runs["wavs"],
         "--save_path", gen, "--sample_length", "400", "--device", "cpu")
    _served(gen)


def test_student_run_converts_and_serves(runs):
    out = str(runs["root"] / "student_torch")
    printed = _cli("-m", "tools.jax_run_to_torch", "--run_dir", runs["student"], "--out_dir", out)
    assert printed.strip() == out
    with open(os.path.join(out, "ema", "meta.json")) as f:
        assert json.load(f) == {"config": ST_CFG, "step": 2}
    with np.load(os.path.join(out, "norm_stats.npz")) as z:
        np.testing.assert_array_equal(z["mean"], np.arange(3, dtype=np.float32))
    jpwn, jparams, cfg, params = _check_converted(
        runs["student"], out, tconfig.pwn_config_from_dict(ST_CFG))

    wav = jdata.Dataset(os.path.join(runs["root"], "ds")).get_init_batch(2, 1280, seed=2)
    mel = jstft.melspectrogram_np(wav)
    base = np.random.default_rng(3).logistic(size=(2, jpwn.sample_length(mel.shape[1])))
    base = base.astype(np.float32)
    jff, _ = jpwn.feed_forward(jparams, {"mel": mel, "base_x": base})
    tff = ParallelWavenet(cfg).feed_forward(params, {"mel": torch.from_numpy(mel),
                                                     "base_x": torch.from_numpy(base)})
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        want = np.asarray(jff[k])
        np.testing.assert_allclose(tff[k].numpy(), want, atol=1e-4 * max(np.abs(want).max(), 1.0),
                                   rtol=0, err_msg=k)

    gen = str(runs["root"] / "gen_student")
    _cli("eval_parallel_wavenet_torch.py", "--ckpt_dir", out, "--source_path", runs["wavs"],
         "--save_path", gen, "--sample_length", "2560", "--device", "cpu")
    _served(gen)
