"""The port's student model (config, parameters, plain feed_forward and its
pieces) against the JAX package on the CPU, same inputs from numpy."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models.parallel_wavenet import ParallelWavenet as JParallelWavenet
from nsynth_wavenet_tpu.ops import distributions as jdist
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.ops import distributions as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FF_KEYS = ("x", "mean_tot", "scale_tot", "log_scale_tot", "rand_input")


def tiny_cfg(**kw):
    base = dict(loss_type="logistic", num_iaf_layers=(2, 4), num_stages=2, width=8,
                deconv_width=16, wave_length=1280, use_mu_law=False, upsample_act="leaky_relu",
                use_share_deconv=True, compute_dtype="float32")
    base.update(kw)
    return base


def student_pair(**kw):
    """(JAX model, its params, port model, the same params as tensors)."""
    cfg = tiny_cfg(**kw)
    jpwn = JParallelWavenet(jconfig.ParallelWavenetConfig(**cfg))
    jparams = jpwn.init_params(jax.random.PRNGKey(0))
    tparams = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jpwn, jparams, ParallelWavenet(tconfig.ParallelWavenetConfig(**cfg)), tparams


def mel_batch(batch=3, length=1280, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * 180 * t)[None, :] + 0.02 * rng.randn(batch, length)
    return jstft.melspectrogram_np(np.clip(wav, -0.99, 0.99).astype(np.float32))


def assert_ff_close(got, want, tol):
    for k in FF_KEYS:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == np.float32, k
        np.testing.assert_allclose(a, b, atol=tol * max(np.abs(b).max(), 1e-3), rtol=0, err_msg=k)


@pytest.mark.parametrize("path,nested", [
    ("configs/parallel_wavenet.json", False),
    ("configs/parallel_wavenet_gauss.json", False),
    ("tests/golden/tiny_student/meta.json", True),
])
def test_student_configs_load_like_jax(path, nested):
    path = os.path.join(REPO, path)
    with open(path) as f:
        d = json.load(f)
    want = jconfig.pwn_config_from_dict(d["config"] if nested else d)
    got = tconfig.load_config(path)
    assert isinstance(got, tconfig.ParallelWavenetConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("quant_chann", "out_width", "gate_width", "frame_shift", "max_dilation"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_load_config_dispatches_and_rejects_unknown_keys(tmp_path):
    assert isinstance(tconfig.load_config(os.path.join(REPO, "configs/wavenet_mol.json")),
                      tconfig.WavenetConfig)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"num_iaf_layers": [2], "no_such_key": 1}))
    with pytest.raises(ValueError, match="no_such_key"):
        tconfig.load_config(str(bad))
    with pytest.raises(ValueError):
        tconfig.ParallelWavenetConfig(use_share_deconv=True, use_teacher_deconv=True)


@pytest.mark.parametrize("share", [True, False])
def test_init_params_has_the_reference_layout(share):
    cfg = tiny_cfg(use_share_deconv=share, use_log_scale=not share)
    jparams = JParallelWavenet(jconfig.ParallelWavenetConfig(**cfg)).init_params(jax.random.PRNGKey(0))
    pwn = ParallelWavenet(tconfig.ParallelWavenetConfig(**cfg))
    tparams = pwn.init_params(3, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tparams)
    assert tshapes == jshapes
    flow = tparams["flows"][1]
    assert pwn.num_flows == 2 and len(flow["layers"]) == 4
    assert float(flow["out2_scale"]["b"][0]) == pytest.approx(-0.3 if share else -0.8)
    assert float(flow["out2_mean"]["b"][0]) == 0.0
    kernels = torch.cat([lp["mel_cond"]["w"].ravel() for lp in flow["layers"]])
    assert abs(float(kernels.std()) - 0.05) < 0.01


@pytest.mark.parametrize("share,loss_type,use_log_scale,compute_dtype,tol", [
    (True, "logistic", False, "float32", 3e-4),
    (False, "gauss", True, "float32", 3e-4),
    (False, "logistic", False, "float32", 3e-4),
    (True, "gauss", True, "bfloat16", 2e-2),
])
def test_feed_forward_matches_jax(share, loss_type, use_log_scale, compute_dtype, tol):
    jpwn, jparams, pwn, tparams = student_pair(
        use_share_deconv=share, loss_type=loss_type, use_log_scale=use_log_scale,
        compute_dtype=compute_dtype)
    mel = mel_batch()
    L = pwn.sample_length(mel.shape[1])
    assert L == jpwn.sample_length(mel.shape[1]) == 1400
    x = np.random.RandomState(1).randn(mel.shape[0], L).astype(np.float32)
    want, _ = jpwn.feed_forward(jparams, {"mel": mel, "base_x": x})
    got = pwn.feed_forward(tparams, {"mel": torch.from_numpy(mel), "base_x": torch.from_numpy(x)})
    assert_ff_close(got, want, tol)
    assert float(got["scale_tot"].min()) > 0
    assert np.abs(np.asarray(want["mean_tot"])).max() > 1e-3


def test_feed_forward_draws_its_noise_from_the_generator():
    _, _, pwn, tparams = student_pair()
    mel = torch.from_numpy(mel_batch(batch=2))
    a = pwn.feed_forward(tparams, {"mel": mel}, torch.Generator().manual_seed(5))
    b = pwn.feed_forward(tparams, {"mel": mel}, torch.Generator().manual_seed(5))
    c = pwn.feed_forward(tparams, {"mel": mel}, torch.Generator().manual_seed(6))
    assert torch.equal(a["x"], b["x"]) and not torch.equal(a["x"], c["x"])
    assert a["rand_input"].shape == (2, 1400)
    with pytest.raises(ValueError):
        pwn.feed_forward(tparams, {"mel": mel})
    with pytest.raises(ValueError):
        pwn.feed_forward(tparams, {"mel": mel, "base_x": torch.zeros(2, 7)})
    gauss = ParallelWavenet(tconfig.ParallelWavenetConfig(**tiny_cfg(loss_type="gauss")))
    z = gauss.base_noise(torch.Generator().manual_seed(0), 64, 1024, "cpu")
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    lg = pwn.base_noise(torch.Generator().manual_seed(0), 64, 1024, "cpu")
    assert abs(float(lg.std()) - np.pi / np.sqrt(3)) < 0.05


@pytest.mark.parametrize("num_stages,frames", [(10, 7), (10, 320), (2, 7), (5, 61)])
def test_sample_length_matches_jax(num_stages, frames):
    cfg = tiny_cfg(num_stages=num_stages)
    want = JParallelWavenet(jconfig.ParallelWavenetConfig(**cfg)).sample_length(frames)
    assert ParallelWavenet(tconfig.ParallelWavenetConfig(**cfg)).sample_length(frames) == want


@pytest.mark.parametrize("use_mu_law", [False, True])
def test_clip_quant_scale_matches_jax_exactly(use_mu_law):
    cfg = tiny_cfg(use_mu_law=use_mu_law)
    x = (np.random.RandomState(2).randn(4, 500) * 0.7).astype(np.float32)
    x[0, :4] = [-1.5, 1.5, 1.0, -1.0]
    want = np.asarray(JParallelWavenet(jconfig.ParallelWavenetConfig(**cfg))._clip_quant_scale(x))
    got = ParallelWavenet(tconfig.ParallelWavenetConfig(**cfg))._clip_quant_scale(
        torch.from_numpy(x)).numpy()
    if use_mu_law:  # the expansion's pow rounds differently in the last place
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_log_scale", [False, True])
def test_scale_log_scale_matches_jax(use_log_scale):
    cfg = tiny_cfg(use_log_scale=use_log_scale)
    s = np.linspace(-20, 20, 401).astype(np.float32)
    want = JParallelWavenet(jconfig.ParallelWavenetConfig(**cfg)).scale_log_scale(jnp.asarray(s))
    got = ParallelWavenet(tconfig.ParallelWavenetConfig(**cfg)).scale_log_scale(torch.from_numpy(s))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6, atol=1e-7)
    assert float(got[0].min()) >= np.exp(-9.0) * (1 - 1e-6)
    assert float(got[0].max()) <= np.exp(7.0) * (1 + 1e-6)


def test_logistic_from_given_uniforms_matches_jax():
    u = np.random.RandomState(3).uniform(1e-5, 1 - 1e-5, size=(4, 1000)).astype(np.float32)
    want = np.asarray(jnp.log(u) - jnp.log(1.0 - u))
    np.testing.assert_allclose(tdist.logistic_from_uniform(torch.from_numpy(u)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    # the JAX sampler is that formula on its own uniforms
    key = jax.random.PRNGKey(0)
    ju = jdist._uniform_open(key, (8, 8))
    np.testing.assert_allclose(np.asarray(jdist.logistic_0_1(key, (8, 8))),
                               np.asarray(jnp.log(ju) - jnp.log(1.0 - ju)), rtol=1e-6)
    draw = tdist.logistic_0_1(torch.Generator().manual_seed(0), (64, 1024), "cpu")
    assert draw.shape == (64, 1024) and bool(torch.isfinite(draw).all())
    assert float(draw.abs().max()) <= np.log((1 - 1e-5) / 1e-5) + 1e-3
