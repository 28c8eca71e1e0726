"""The port's training runner on the CPU (training/runner.py,
training/checkpoint.py, train_wavenet_torch.py, build_dataset_torch.py):
the run directory, train.log, metrics.jsonl and checkpoints; resume by
logdir equal bit for bit to an uninterrupted run on a one-record dataset
whose record is exactly wave_length (every crop the same); a save on
SIGTERM; the EMA export read back by the eval path and by the JAX model
through weights.to_jax_params; the CLIs end to end."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.models.wavenet import Wavenet as JWavenet
from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import dataset as tdata
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import generate_wavenet, load_eval_model
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
from nsynth_wavenet_tpu_torch.training import runner
from nsynth_wavenet_tpu_torch.training import train_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 1280
CFG = dict(num_layers=4, num_stages=2, width=16, skip_width=8, deconv_width=16, wave_length=L,
           loss_type="mol", use_mu_law=False, dropout_inputs=True, compute_dtype="float32",
           mol_mix=4, lr_schedule=[[0, 1e-3], [3, 5e-4]], deconv_config=[[40, 10], [80, 20]])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(tmp_path, **kw):
    path = tmp_path / "tiny_mol.json"
    path.write_text(json.dumps({**CFG, **kw}))
    return str(path)


def _one_record(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(L) / 16000.0
    w = (0.5 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(L)).astype(np.float32)
    tdata.build_dataset_from_arrays([w], ["only"], str(tmp_path / "ds1"))
    return str(tmp_path / "ds1")


def _train(tmp_path, ds, **kw):
    args = dict(train_path=ds, total_batch_size=2, ckpt_every_steps=2, seed=0, device="cpu")
    args.update(kw)
    return runner.train_wavenet(**args)


def _equal_trees(a, b):
    fa, fb = weights.flatten(a), weights.flatten(b)
    assert fa.keys() == fb.keys()
    return all(torch.equal(fa[k], fb[k]) for k in fa)


def _equal_states(a, b):
    return (a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
            and _equal_trees(a["params"], b["params"]) and _equal_trees(a["ema"], b["ema"])
            and _equal_trees(a["opt_state"]["mu"], b["opt_state"]["mu"])
            and _equal_trees(a["opt_state"]["nu"], b["opt_state"]["nu"]))


def test_run_dir_logs_checkpoints_and_resume_bit_for_bit(tmp_path):
    ds, cfg = _one_record(tmp_path), _config(tmp_path)
    full_dir, full = _train(tmp_path, ds, config_path=cfg, log_root=str(tmp_path / "a"),
                            num_steps=5)
    assert os.path.basename(full_dir).startswith("ns_wn-n_MU-n_WN-TS-tanh-DIN-MOL-")
    assert sorted(os.listdir(full_dir)) == sorted(
        ["ckpt", "metrics.jsonl", "train.log", "tiny_mol.json"] +
        [f for f in os.listdir(full_dir) if f.startswith("events.out.tfevents")])
    mgr = ckpt_lib.CheckpointManager(os.path.join(full_dir, "ckpt"))
    assert mgr.all_steps() == [2, 4, 5]
    lines = [json.loads(x) for x in open(os.path.join(full_dir, "metrics.jsonl"))]
    assert [m["step"] for m in lines] == [5]
    assert {"loss", "learning_rate", "steps_per_sec", "utterances_per_sec",
            "cond_gap"} <= lines[0].keys()
    assert lines[0]["learning_rate"] == pytest.approx(5e-4) and np.isfinite(lines[0]["loss"])
    log = open(os.path.join(full_dir, "train.log")).read()
    assert "WavenetConfig:" in log and "step 5 loss" in log

    # stop at 3, then resume by logdir to 5: the state equals the uninterrupted one
    part_dir, part = _train(tmp_path, ds, config_path=cfg, log_root=str(tmp_path / "b"),
                            num_steps=3)
    assert part["step"] == 3
    _, resumed = _train(tmp_path, ds, logdir=part_dir, num_steps=5)
    assert "Restored checkpoint at step 3" in open(os.path.join(part_dir, "train.log")).read()
    assert _equal_states(resumed, full)
    # and the checkpoint on disk is the state
    assert _equal_states(mgr.restore(device="cpu"), full)


def test_checkpoint_keeps_three_and_round_trips(tmp_path):
    cfg = tconfig.load_config(_config(tmp_path))
    model = Wavenet(cfg)
    opt = train_lib.opt_lib.make_optimizer(cfg.lr_schedule)
    state = train_lib.make_train_state(model.init_params(0, device="cpu"), opt)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ckpt"))
    for step in (1, 2, 3, 4, 5):
        state["step"] = step
        mgr.save(step, state)
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".tmp")]
    back = mgr.restore(device="cpu")
    assert _equal_states(back, state)
    assert mgr.restore(step=3, device="cpu")["step"] == 3
    assert ckpt_lib.CheckpointManager(str(tmp_path / "none")).restore(device="cpu") is None
    # the export is the EMA leaf for leaf, through the JAX layout
    ckpt_lib.export_ema(state, str(tmp_path / "ema"), cfg)
    want = weights.flatten(weights.to_jax_params(state["ema"]))
    with np.load(tmp_path / "ema" / "params.npz") as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert z[k].dtype == np.float32 and "#" not in k
            np.testing.assert_array_equal(z[k], want[k])
    assert _equal_trees(ckpt_lib.load_params(str(tmp_path / "ema"), device="cpu"), state["ema"])
    meta = json.loads((tmp_path / "ema" / "meta.json").read_text())
    assert tconfig.load_config(str(tmp_path / "ema" / "meta.json")) == cfg and meta["step"] == 5


def test_shutdown_signal_saves(tmp_path, monkeypatch):
    ds, cfg = _one_record(tmp_path), _config(tmp_path)
    make = train_lib.make_wavenet_train_step

    def signalling(model, optimizer, mesh=None):
        step_fn = make(model, optimizer, mesh=mesh)

        def fn(state, wav, seed=None):
            out = step_fn(state, wav, seed)
            if state["step"] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return fn

    monkeypatch.setattr(train_lib, "make_wavenet_train_step", signalling)
    run_dir, state = _train(tmp_path, ds, config_path=cfg, log_root=str(tmp_path / "r"),
                            num_steps=50, ckpt_every_steps=10)
    assert state["step"] == 3
    assert ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps() == [3]
    assert "shutdown signal: saving checkpoint at step 3" in \
        open(os.path.join(run_dir, "train.log")).read()
    assert signal.getsignal(signal.SIGTERM) is not None


def test_refusals(tmp_path):
    ds, cfg = _one_record(tmp_path), _config(tmp_path)
    # sequence and channel tensor parallelism need a process group of two ranks
    with pytest.raises(ValueError, match=r"n_model\*n_seq=2 ranks, have 1"):
        _train(tmp_path, ds, config_path=cfg, log_root=str(tmp_path / "x"), n_seq=2)
    with pytest.raises(ValueError, match=r"n_model\*n_seq=2 ranks, have 1"):
        _train(tmp_path, ds, config_path=cfg, log_root=str(tmp_path / "x"), n_model=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _train(tmp_path, ds, config_path=cfg, log_root=str(tmp_path / "x"), device="cuda")
    # detail_log: the upsampler's histograms ride the loss dict
    model = Wavenet(tconfig.load_config(cfg, detail_log=True))
    ld = model.forward_loss(model.init_params(0, device="cpu"), torch.zeros(1, L),
                            torch.zeros(1, 7, 80))
    hists = sorted(k for k in ld if k.startswith("hist/"))
    assert hists == [f"hist/mel_en_{i}" for i in range(len(model.cfg.deconv_config))], hists


def test_weight_norm_run_and_export_serve_on_jax_and_port(tmp_path):
    """A weight-normed run (data-dependent init) exports EMA weights that the
    JAX model and the port's forward read alike, and that the eval path
    serves from the run directory."""
    ds, cfg = _one_record(tmp_path), _config(tmp_path, use_weight_norm=True)
    run_dir, state = _train(tmp_path, ds, config_path=cfg, log_root=str(tmp_path / "w"),
                            num_steps=2)
    assert "initial mean.m" in open(os.path.join(run_dir, "train.log")).read()
    ckpt_lib.export_ema(state, os.path.join(run_dir, "ema"), tconfig.load_config(cfg))
    got_cfg, params = load_eval_model(run_dir, device="cpu")
    assert _equal_trees(params, state["ema"]) and got_cfg.use_weight_norm

    wav = np.array(tdata.Dataset(ds).get_record(0)[None])
    mel = jstft.melspectrogram_np(wav)
    jmodel = JWavenet(jconfig.load_config(cfg))
    enc = jmodel.encode_signal({"wav": wav})
    jff, _ = jmodel.feed_forward(weights.to_jax_params(params),
                                 {"wav_scaled": enc["wav_scaled"], "mel": mel})
    tmodel = Wavenet(got_cfg)
    tff = tmodel.feed_forward(params, {"wav_scaled": tmodel.encode_signal(
        torch.from_numpy(wav))["wav_scaled"], "mel": torch.from_numpy(mel)})
    want = np.asarray(jff["out_params"])
    np.testing.assert_allclose(tff["out_params"].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())

    src = tmp_path / "src"
    src.mkdir()
    wav_io.write_wav(str(src / "a.wav"), wav[0])
    paths = generate_wavenet(str(src), None, None, str(tmp_path / "gen"), device="cpu",
                             sample_length=400, ckpt_dir=run_dir)
    audio, sr = wav_io.read_wav(paths[0])
    assert sr == 16000 and len(audio) >= 400 and np.isfinite(audio).all()


def test_clis_build_train_resume_export_and_serve(tmp_path):
    """build_dataset_torch.py -> train_wavenet_torch.py --device cpu (new run,
    then resume by --logdir with --export_ema) -> eval_wavenet_torch.py
    --ckpt_dir, each in its own interpreter."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        wav_io.write_wav(str(wavs / f"u{i}.wav"), 0.3 * rng.standard_normal(3000))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # the interpreters' work is tiny; spare the other workers

    def run(*args):
        proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    run("build_dataset_torch.py", "--wave_dir", str(wavs), "--save_path", str(tmp_path / "ds"),
        "--min_len", "2000")
    common = ["train_wavenet_torch.py", "--train_path", str(tmp_path / "ds"), "--device", "cpu",
              "--total_batch_size", "2", "--ckpt_every_steps", "2"]
    run_dir = run(*common, "--config", _config(tmp_path), "--log_root", str(tmp_path / "runs"),
                  "--num_steps", "2").strip().splitlines()[-1]
    run(*common, "--logdir", run_dir, "--num_steps", "3", "--export_ema")
    assert ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps() == [2, 3]
    assert json.loads(open(os.path.join(run_dir, "ema", "meta.json")).read())["step"] == 3
    out = run("eval_wavenet_torch.py", "--ckpt_dir", run_dir, "--source_path", str(wavs),
              "--save_path", str(tmp_path / "gen"), "--device", "cpu", "--sample_length", "300")
    assert len(out.split()) == 2 and all(os.path.isfile(p) for p in out.split())


def test_profiler_writes_a_trace(tmp_path):
    prof = runner.Profiler(str(tmp_path), start_step=3, num_steps=2)
    for step in range(7):
        prof.maybe_update(step)
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.close()
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    runner.Profiler(str(tmp_path / "off"), start_step=0, num_steps=0).maybe_update(0)
    assert not (tmp_path / "off").exists()
