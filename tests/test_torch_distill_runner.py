"""The port's distillation run on the CPU (training/runner.py
load_teacher / train_parallel_wavenet, data/dataset.py spec_feat_mean_std,
train_parallel_wavenet_torch.py, eval_parallel_wavenet_torch.py --ckpt_dir):
a teacher run directory written by the port's own train_wavenet, the
student's run directory and checkpoints, resume by logdir equal bit for bit
to an uninterrupted run on a one-record dataset whose record is exactly
wave_length (every crop the same), norm_stats.npz computed once and reused,
the power-loss statistics against JAX's, and the CLI chain end to end."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.data import dataset as jdata
from nsynth_wavenet_tpu.models.parallel_wavenet import ParallelWavenet as JParallelWavenet
from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import dataset as tdata
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import generate_parallel_wavenet, load_eval_model
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
from nsynth_wavenet_tpu_torch.training import runner
from test_parallel_wavenet import ST_SMALL, TE_SMALL
from test_torch_train_runner import _equal_states, _equal_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 1280
TEACHER = dict(TE_SMALL, loss_type="mol", mol_mix=4, lr_schedule=[[0, 1e-3]],
               deconv_config=[[40, 10], [80, 20]])
STUDENT = dict(ST_SMALL, loss_type="logistic", num_iaf_layers=[2, 2], power_loss_factor=1.0,
               contrastive_loss_factor=0.3, use_share_deconv=True, norm_feat=True,
               lr_schedule=[[0, 1e-3], [3, 5e-4]], deconv_config=[[40, 10], [80, 20]])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _json(path, d):
    path.write_text(json.dumps(d))
    return str(path)


def _one_record(path):
    rng = np.random.default_rng(0)
    t = np.arange(L) / 16000.0
    w = (0.5 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(L)).astype(np.float32)
    tdata.build_dataset_from_arrays([w], ["only"], str(path))
    return str(path)


@pytest.fixture(scope="module")
def teacher_run(tmp_path_factory):
    """A 2-step port teacher run on a one-record dataset: (dataset, run_dir, state)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("teacher")
    ds = _one_record(tmp / "ds1")
    run_dir, state = runner.train_wavenet(
        ds, config_path=_json(tmp / "tiny_teacher.json", TEACHER), log_root=str(tmp / "runs"),
        total_batch_size=2, num_steps=2, ckpt_every_steps=1, seed=0, device="cpu")
    torch.set_num_threads(threads)
    return ds, run_dir, state


def _small_stats(monkeypatch, calls):
    """spec_feat_mean_std at a test's size, counting its calls."""
    orig = tdata.spec_feat_mean_std

    def small(train_path, feat_fn, **kw):
        calls.append(train_path)
        return orig(train_path, feat_fn, batch_size=16, seq_len=L, chunk=8, **kw)

    monkeypatch.setattr(tdata, "spec_feat_mean_std", small)


def _distill(ds, teacher_dir, **kw):
    args = dict(train_path=ds, teacher_dir=teacher_dir, total_batch_size=2, ckpt_every_steps=2,
                seed=0, device="cpu")
    args.update(kw)
    return runner.train_parallel_wavenet(**args)


def test_load_teacher_reads_the_port_teacher_run(teacher_run, tmp_path):
    _, run_dir, state = teacher_run
    model, params = runner.load_teacher(run_dir, device="cpu")
    assert model.cfg.use_as_teacher and model.cfg.loss_type == "mol"
    # the latest checkpoint's EMA, not its params
    assert _equal_trees(params, state["ema"]) and not _equal_trees(params, state["params"])
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "t.json").write_text(json.dumps(TEACHER))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        runner.load_teacher(str(tmp_path / "empty"), device="cpu")
    (tmp_path / "student").mkdir()
    (tmp_path / "student" / "s.json").write_text(json.dumps(STUDENT))
    with pytest.raises(ValueError, match="student"):
        runner.load_teacher(str(tmp_path / "student"), device="cpu")


def test_run_dir_norm_stats_and_resume_bit_for_bit(teacher_run, tmp_path, monkeypatch):
    ds, teacher_dir, _ = teacher_run
    calls = []
    _small_stats(monkeypatch, calls)
    cfg = _json(tmp_path / "tiny_student.json", STUDENT)
    full_dir, full = _distill(ds, teacher_dir, config_path=cfg, log_root=str(tmp_path / "a"),
                              num_steps=5)
    assert os.path.basename(full_dir).startswith(
        "ns_pwn-n_MU-n_WN-TS-leaky_relu-n_LOGS-n_CLIP-NABS-n_MEL-L2-PFS-SHA_DC-LOGISTIC-pl1-cl0.3")
    assert {"ckpt", "metrics.jsonl", "train.log", "tiny_student.json", "norm_stats.npz"} <= \
        set(os.listdir(full_dir))
    assert ckpt_lib.CheckpointManager(os.path.join(full_dir, "ckpt")).all_steps() == [2, 4, 5]
    (line,) = [json.loads(x) for x in open(os.path.join(full_dir, "metrics.jsonl"))]
    assert line["step"] == 5 and line["learning_rate"] == pytest.approx(5e-4)
    for k in ("loss", "kl_loss", "power_loss", "contrastive_loss", "H_Ps", "H_Ps_Pt", "new_x",
              "new_x_std", "new_x_abs", "new_x_abs_std", "mean_tot", "scale_tot",
              "log_scale_tot", "steps_per_sec", "utterances_per_sec"):
        assert np.isfinite(line[k]), k
    log = open(os.path.join(full_dir, "train.log")).read()
    assert "ParallelWavenetConfig:" in log and "teacher from" in log
    assert "step 5 loss" in log and " hpt " in log
    # the transplanted teacher deconv started the shared stack: after 5 steps
    # it has moved (use_share_deconv trains it)
    _, te_params = runner.load_teacher(teacher_dir, device="cpu")
    assert not _equal_trees(full["params"]["deconv_share"], te_params["deconv"])

    part_dir, part = _distill(ds, teacher_dir, config_path=cfg, log_root=str(tmp_path / "b"),
                              num_steps=3)
    assert part["step"] == 3 and len(calls) == 2  # one estimate a new run
    stats = dict(np.load(os.path.join(part_dir, "norm_stats.npz")))
    _, resumed = _distill(ds, teacher_dir, logdir=part_dir, num_steps=5)
    assert len(calls) == 2  # the resumed run read norm_stats.npz
    assert "Restored checkpoint at step 3" in open(os.path.join(part_dir, "train.log")).read()
    assert _equal_states(resumed, full)
    for k, v in np.load(os.path.join(part_dir, "norm_stats.npz")).items():
        np.testing.assert_array_equal(v, stats[k])
    np.testing.assert_array_equal(stats["mean"], np.load(os.path.join(full_dir,
                                                                      "norm_stats.npz"))["mean"])


def test_teacher_deconv_stays_frozen_and_exports_serve(teacher_run, tmp_path):
    """use_teacher_deconv: the shared stack equals the teacher's deconv bit
    for bit after training and holds no Adam moments; the EMA export and,
    without it, the latest checkpoint's EMA serve through the eval path."""
    ds, teacher_dir, _ = teacher_run
    kw = dict(STUDENT, use_share_deconv=False, use_teacher_deconv=True, norm_feat=False)
    run_dir, state = _distill(ds, teacher_dir, config_path=_json(tmp_path / "tea.json", kw),
                              log_root=str(tmp_path / "r"), num_steps=3)
    _, te_params = runner.load_teacher(teacher_dir, device="cpu")
    assert _equal_trees(state["params"]["deconv_share"], te_params["deconv"])
    assert _equal_trees(state["ema"]["deconv_share"], te_params["deconv"])
    n_leaves = len(weights.flatten(state["params"]))
    assert len(state["opt_state"]["mu"]) == n_leaves - len(weights.flatten(te_params["deconv"]))

    src = tmp_path / "src"
    src.mkdir()
    wav = tdata.Dataset(ds).get_record(0)
    wav_io.write_wav(str(src / "a.wav"), wav)
    wav_io.write_wav(str(src / "b.wav"), wav[::-1].copy())
    cfg, params = load_eval_model(run_dir, device="cpu")  # no export yet: the checkpoint's EMA
    assert isinstance(cfg, tconfig.ParallelWavenetConfig) and _equal_trees(params, state["ema"])
    ckpt_lib.export_ema(state, os.path.join(run_dir, "ema"), tconfig.load_config(
        runner.find_config_json(run_dir)))
    paths = generate_parallel_wavenet(str(src), None, None, str(tmp_path / "gen"), device="cpu",
                                      ckpt_dir=run_dir)
    assert [os.path.basename(p) for p in paths] == ["gen_a.wav", "gen_b.wav"]
    pwn = ParallelWavenet(cfg)
    for p in paths:
        audio, sr = wav_io.read_wav(p)
        assert sr == 16000 and len(audio) == pwn.sample_length(1 + L // 200)
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    with pytest.raises(ValueError, match="teacher config"):
        generate_parallel_wavenet(str(src), None, None, str(tmp_path / "g2"), device="cpu",
                                  ckpt_dir=teacher_dir)


def test_spec_feat_mean_std_equals_jax(tmp_path):
    jdata.make_synthetic_dataset(str(tmp_path / "ds"), n_records=6, length=4000)
    kw = dict(STUDENT, spec_enhance_factor=0)
    jfeat = JParallelWavenet(jconfig.ParallelWavenetConfig(**kw)).stft_feat
    tfeat = ParallelWavenet(tconfig.ParallelWavenetConfig(**kw)).stft_feat
    args = dict(batch_size=24, seq_len=L, first_n=6, chunk=10, seed=3)
    jm, js = jdata.spec_feat_mean_std(str(tmp_path / "ds"), jfeat, **args)
    tm, ts = tdata.spec_feat_mean_std(str(tmp_path / "ds"), tfeat, device="cpu", **args)
    assert tm.shape == ts.shape == (1025,) and tm.dtype == ts.dtype == np.float32
    # f32 features through a DFT matmul (JAX) and an FFT (the port); the log
    # feature of a bin near zero magnifies their difference: 1e-4 of the scale
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-4 * np.abs(jm).max())
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4 * np.abs(js).max())


def test_refusals(teacher_run, tmp_path):
    ds, teacher_dir, _ = teacher_run
    cfg = _json(tmp_path / "s.json", STUDENT)
    with pytest.raises(ValueError, match=r"n_model\*n_seq=2 ranks, have 1"):
        _distill(ds, teacher_dir, config_path=cfg, log_root=str(tmp_path / "x"), n_seq=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _distill(ds, teacher_dir, config_path=cfg, log_root=str(tmp_path / "x"),
                     device="cuda")
    # detail_log: each flow's scalars and the upsamplers' histograms ride the ff dict
    pwn = ParallelWavenet(tconfig.ParallelWavenetConfig(**dict(STUDENT, detail_log=True)))
    ff, _ = pwn.feed_forward_train(pwn.init_params(0, device="cpu"),
                                   {"mel": torch.zeros(1, 7, 80), "base_x": torch.zeros(1, 1400)})
    assert any(k.startswith("hist/") for k in ff["detail"])
    assert {f"scale_{i}" for i in range(pwn.num_flows)} <= set(ff["detail"])


def test_clis_teacher_distill_export_and_serve(tmp_path):
    """train_wavenet_torch.py -> train_parallel_wavenet_torch.py --export_ema
    -> eval_parallel_wavenet_torch.py --ckpt_dir, each in its own
    interpreter on the CPU."""
    ds = _one_record(tmp_path / "ds")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # the interpreters' work is tiny; spare the other workers

    def run(*args):
        proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    common = ["--train_path", ds, "--device", "cpu", "--total_batch_size", "2",
              "--num_steps", "2", "--ckpt_every_steps", "2"]
    teacher_dir = run("train_wavenet_torch.py", *common, "--config",
                      _json(tmp_path / "t.json", TEACHER), "--log_root",
                      str(tmp_path / "runs")).strip().splitlines()[-1]
    student_dir = run("train_parallel_wavenet_torch.py", *common, "--config",
                      _json(tmp_path / "s.json", dict(STUDENT, norm_feat=False)),
                      "--teacher_dir", teacher_dir, "--log_root", str(tmp_path / "runs"),
                      "--export_ema").strip().splitlines()[-1]
    assert json.loads(open(os.path.join(student_dir, "ema", "meta.json")).read())["step"] == 2
    src = tmp_path / "src"
    src.mkdir()
    wav_io.write_wav(str(src / "u.wav"), tdata.Dataset(ds).get_record(0))
    out = run("eval_parallel_wavenet_torch.py", "--ckpt_dir", student_dir, "--source_path",
              str(src), "--save_path", str(tmp_path / "gen"), "--device", "cpu")
    assert len(out.split()) == 1 and os.path.isfile(out.split()[0])
    proc = subprocess.run([sys.executable, "eval_parallel_wavenet_torch.py", "--source_path",
                           str(src), "--save_path", str(tmp_path / "g2")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "--ckpt_dir" in proc.stderr
