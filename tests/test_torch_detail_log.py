"""DETAIL_LOG on the port (utils/logging_utils.py device_histogram and
MetricsWriter; the histograms and per-flow scalars of models/wavenet.py and
models/parallel_wavenet.py) against the JAX package's, the counterparts of
tests/test_detail_log.py, and the histograms of the global tensor over a
seq mesh (2 gloo processes, tests/torch_rank_worker.py) against one
process's.

Limits.  device_histogram on the same tensor: counts and min / max equal,
sum and sum of squares within 1e-6 relative.  Through a training step the
two sides' tensors part by summation order (f32 roundoff, 1e-6 of a value
at most in these tiny models), and a value within that of a bucket edge may
land in the next bucket: min / max / sum / sum_sq within HIST_TOL of the
tensor's scale, and at most MAX_MOVED values in another bucket.  The
per-flow scalars at tests/test_torch_distill_step.py's METRIC_TOL."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models.wavenet import Wavenet as JWavenet
from nsynth_wavenet_tpu.training import optimizer as jopt
from nsynth_wavenet_tpu.training import train_lib as jtl
from nsynth_wavenet_tpu.utils import logging_utils as jlog
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet as TWavenet
from nsynth_wavenet_tpu_torch.training import optimizer as topt
from nsynth_wavenet_tpu_torch.training import train_lib as ttl
from nsynth_wavenet_tpu_torch.utils import logging_utils as tlog
from test_torch_distill_losses import Pair
from test_torch_distill_step import METRIC_TOL, _jax_step
from test_torch_multiprocess import run_job
from test_torch_train_step import _compile

TINY = dict(num_layers=4, num_stages=2, width=16, skip_width=8, deconv_width=16,
            wave_length=1280, compute_dtype="float32", use_mu_law=False, loss_type="gauss",
            lr_schedule=((0, 1e-3),))
HIST_TOL = 1e-5
MAX_MOVED = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wav(batch=2, length=1280, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 16000.0
    return np.clip(0.3 * np.sin(2 * np.pi * 200 * t)[None] + 0.02 * rng.randn(batch, length),
                   -0.99, 0.99).astype(np.float32)


def _np(h):
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in h.items()}


def _assert_hist_close(want, got, tag):
    want, got = _np(want), _np(got)
    assert got["counts"].dtype == np.int32 and got["counts"].shape == want["counts"].shape, tag
    assert got["counts"].sum() == want["counts"].sum(), tag
    moved = int(np.abs(got["counts"].astype(np.int64) - want["counts"]).sum()) // 2
    assert moved <= MAX_MOVED, (tag, want["counts"], got["counts"])
    scale = max(abs(float(want["min"])), abs(float(want["max"])), 1e-30)
    for k in ("min", "max"):
        assert abs(float(got[k]) - float(want[k])) <= HIST_TOL * scale, (tag, k)
    n = float(want["counts"].sum())
    assert abs(float(got["sum"]) - float(want["sum"])) <= HIST_TOL * scale * n, (tag, "sum")
    assert abs(float(got["sum_sq"]) - float(want["sum_sq"])) <= HIST_TOL * scale**2 * n, tag


@pytest.mark.parametrize("case", ["linspace", "normal", "constant", "bf16"])
def test_device_histogram_equals_jax(case):
    rng = np.random.default_rng(0)
    x = {"linspace": np.linspace(-2.0, 2.0, 257, dtype=np.float32),
         "normal": rng.standard_normal((4, 100, 8)).astype(np.float32),
         "constant": np.full((64,), 3.0, np.float32),
         "bf16": rng.standard_normal((3, 50, 4)).astype(np.float32)}[case]
    jx = jnp.asarray(x, jnp.bfloat16) if case == "bf16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if case == "bf16" else torch.from_numpy(x)
    want = _np(jax.device_get(jax.jit(jlog.device_histogram)(jx)))
    got = _np(tlog.device_histogram(tx))
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["counts"].sum() == x.size
    assert float(got["min"]) == float(want["min"]) and float(got["max"]) == float(want["max"])
    for k in ("sum", "sum_sq"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-30)


def _teacher_step_metrics(detail_log):
    jcfg = jconfig.WavenetConfig(detail_log=detail_log, **TINY)
    tcfg = tconfig.WavenetConfig(detail_log=detail_log, **TINY)
    jm, tm = JWavenet(jcfg), TWavenet(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    wav = _wav()
    jo = jopt.make_optimizer(jcfg.lr_schedule)
    state = jtl.make_train_state(jp, jo)
    step = _compile(jtl.make_wavenet_train_step(jm, jo), state, wav, jax.random.PRNGKey(1))
    _, jmetrics = step(state, wav, jax.random.PRNGKey(1))
    to = topt.make_optimizer(tcfg.lr_schedule)
    _, tmetrics = ttl.make_wavenet_train_step(tm, to)(ttl.make_train_state(tp, to),
                                                      torch.from_numpy(wav))
    return jax.device_get(jmetrics), tmetrics, tcfg


def test_teacher_gauss_detail_metrics_equal_jax():
    """detail_log: the upsampler's layers and the Gauss head's mean, std and
    log std as histograms in the step's metrics, JAX's within the limits;
    without it, scalars only on both sides."""
    jmetrics, tmetrics, tcfg = _teacher_step_metrics(True)
    tags = sorted(k for k in jmetrics if k.startswith("hist/"))
    assert tags == sorted(k for k in tmetrics if k.startswith("hist/"))
    assert tags == sorted([f"hist/mel_en_{i}" for i in range(len(tcfg.deconv_config))]
                          + ["hist/mean", "hist/std", "hist/log_std"])
    for tag in tags:
        _assert_hist_close(jmetrics[tag], tmetrics[tag], tag)
    assert abs(float(tmetrics["loss"]) - float(jmetrics["loss"])) <= 1e-5
    hls = _np(tmetrics["hist/log_std"])
    assert np.isfinite(float(hls["min"])) and np.isfinite(float(hls["max"]))
    jm_off, tm_off, _ = _teacher_step_metrics(False)
    assert not any(k.startswith("hist/") for k in jm_off)
    assert set(tm_off) == {"loss", "learning_rate"}


@pytest.mark.parametrize("share", [True, False], ids=["shared-deconv", "own-deconv"])
def test_student_per_flow_detail_scalars_equal_jax(monkeypatch, share):
    """The per-flow mean scale, log scale and mean, and the upsamplers'
    histograms (the shared stack's unprefixed, each flow's own under
    iaf_{i}/), on the same weights, batch and noise as JAX's step."""
    pair = Pair("gauss", dtype=np.float32, power_loss_factor=1.0, detail_log=True,
                use_share_deconv=share, lr_schedule=((0, 1e-3),))
    jo = jtl.make_student_optimizer(pair.jcfg, pair.np_params)
    js = jtl.make_train_state(pair.np_params, jo)
    teacher = jax.tree_util.tree_map(jnp.asarray, pair.np_teacher)
    step = _jax_step(monkeypatch, pair.jpwn, teacher, jo, js, (pair.wav, pair.wav_rand),
                     pair.draws)
    _, jm = step(js, pair.wav, pair.wav_rand, pair.draws)
    jm = jax.device_get(jm)
    to = ttl.make_student_optimizer(pair.tcfg, pair.tparams)
    _, tm = ttl.make_pwn_train_step(pair.tpwn, pair.tte, to)(
        ttl.make_train_state(pair.tparams, to), torch.from_numpy(pair.wav),
        torch.from_numpy(pair.wav_rand), None, draws=pair.tdraws())
    assert set(jm) == set(tm), (sorted(jm), sorted(tm))
    for fi in range(pair.tpwn.num_flows):
        for tag in (f"scale_{fi}", f"log_scale_{fi}", f"mean_{fi}"):
            assert abs(float(tm[tag]) - float(jm[tag])) <= METRIC_TOL * max(abs(float(jm[tag])),
                                                                             1.0), tag
    prefixes = [""] if share else [f"iaf_{fi}/" for fi in range(pair.tpwn.num_flows)]
    want = sorted(f"hist/{p}mel_en_{i}" for p in prefixes
                  for i in range(len(pair.tcfg.deconv_config)))
    assert sorted(k for k in tm if k.startswith("hist/")) == want
    for tag in want:
        _assert_hist_close(jm[tag], tm[tag], tag)
    assert 0.0 < float(tm["scale_0"]) <= np.exp(7.0)


def test_metrics_writer_histogram_tags_in_events(tmp_path):
    """The runner's path: step metrics -> _host_metrics -> MetricsWriter ->
    the tags in the TensorBoard events file; metrics.jsonl keeps the
    scalars."""
    from nsynth_wavenet_tpu_torch.training.runner import _host_metrics

    logdir = str(tmp_path / "tb")
    w = tlog.MetricsWriter(logdir)
    h = tlog.device_histogram(torch.from_numpy(np.random.RandomState(0).randn(512)))
    m = _host_metrics({"loss": torch.tensor(1.5), "hist/mel_en_0": h})
    assert isinstance(m["loss"], float) and isinstance(m["hist/mel_en_0"], dict)
    w.write(3, m)
    w.close()
    events = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert events, os.listdir(logdir)
    blob = b"".join(open(e, "rb").read() for e in events)
    assert b"hist/mel_en_0" in blob and b"loss" in blob
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        assert [json.loads(line) for line in f] == [{"step": 3, "loss": 1.5}]


def test_detail_histograms_over_seq_mesh_equal_one_process(tmp_path):
    """n_seq 2: each rank counts the encoding samples it owns (the first
    rank also those before the wav, the last those after it) and the head's
    outputs of its chunk, and the reduction over the data x seq group gives
    every rank the histogram of the global tensors: one process's."""
    tcfg = tconfig.WavenetConfig(detail_log=True, **TINY)
    model = TWavenet(tcfg)
    params = model.init_params(0, device="cpu")
    wavs = [torch.from_numpy(_wav(batch=2, seed=s)) for s in (0, 1)]
    to = topt.make_optimizer(tcfg.lr_schedule)
    one, step_fn = ttl.make_train_state(params, to), ttl.make_wavenet_train_step(model, to)
    for w in wavs:
        one, want = step_fn(one, w)
    ranks = run_job("teacher", {"cfg": tcfg, "params": params, "n_data": 1, "n_model": 1,
                                "n_seq": 2, "wavs": wavs}, 2, tmp_path)
    tags = sorted(k for k in want if k.startswith("hist/"))
    assert len(tags) == len(tcfg.deconv_config) + 3
    for r in ranks:
        assert sorted(k for k in r["metrics"] if k.startswith("hist/")) == tags
        for tag in tags:
            _assert_hist_close(want[tag], r["metrics"][tag], tag)
        assert abs(r["losses"][-1] - float(want["loss"])) <= 1e-5 * max(abs(float(want["loss"])),
                                                                        1.0)
    for tag in tags:
        for k, v in _np(ranks[0]["metrics"][tag]).items():
            np.testing.assert_array_equal(_np(ranks[1]["metrics"][tag])[k], v)
