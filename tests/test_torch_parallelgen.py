"""The port's student serving paths on the CPU (the flow kernel's plain
version) against the JAX package (Pallas in interpret mode): the fused
feed-forward, the committed golden student, the streamer and the eval
entry points."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models import parallelgen as jparallelgen
from nsynth_wavenet_tpu.models.parallel_wavenet import ParallelWavenet as JParallelWavenet
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import (discover_files, generate_parallel_wavenet,
                                                 generate_wavenet, load_mel_batch)
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.ops import flow_kernel as tfk
from test_torch_parallel_wavenet import assert_ff_close, mel_batch, student_pair
from tools.make_golden_ckpt import eval_mels, load_golden, student_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
# A wide student against JAX, share of each output's max |value|: the taps are
# rounded to bf16 as they enter each product, so an f32 difference of one ulp
# (another summation order) at a bf16 boundary moves a tap by 2^-8 of itself,
# and a layer sums 3W of them: the readings grow with the width.  The largest,
# fused against Pallas on mean_tot, reads 2.2e-4 at W 128 and 4.9e-4 at W 256
# (the plain paths agree to 1e-6); the limit sits 4x above them.
WIDE_FF_TOL = 2e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the step loops' small products gain nothing from
    more, and the other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noise(B, L, seed=1):
    return np.random.RandomState(seed).randn(B, L).astype(np.float32)


@pytest.mark.parametrize("share,compute_dtype,tol", [
    (True, "float32", 3e-4),
    (False, "float32", 3e-4),
    (True, "bfloat16", 2e-2),
])
def test_feed_forward_cuda_matches_pallas(share, compute_dtype, tol):
    """Flows with more layers than num_stages chain two stack calls; per-flow
    deconv takes the non-shared encoding path."""
    jpwn, jparams, pwn, tparams = student_pair(use_share_deconv=share, compute_dtype=compute_dtype)
    mel = mel_batch()
    x = _noise(mel.shape[0], pwn.sample_length(mel.shape[1]))
    want = jparallelgen.feed_forward_pallas(jpwn, jparams, {"mel": mel, "base_x": x},
                                            b_tile=2, interpret=True)
    before = tfk.flow_stack.launches
    inputs = {"mel": torch.from_numpy(mel), "base_x": torch.from_numpy(x)}
    got = parallelgen.feed_forward_cuda(pwn, tparams, inputs)
    assert tfk.flow_stack.launches == before  # CPU tensors: the plain version, no launch
    assert_ff_close(got, want, tol)
    recon = got["rand_input"] * got["scale_tot"] + got["mean_tot"]
    np.testing.assert_allclose(got["x"].numpy(), recon.numpy(), rtol=1e-4, atol=1e-5)
    # the fused twin tracks the port's own plain path as the JAX twins track each other
    plain = pwn.feed_forward(tparams, inputs)
    assert_ff_close(got, {k: v.numpy() for k, v in plain.items()}, tol)


@pytest.mark.parametrize("width", [128, 256])
def test_wide_student_feed_forward_matches_jax(width):
    """A flows 2 / 2 student at a width the wide kernel serves (deconv 16,
    the mel of 1 280 samples): the fused feed-forward on the CPU (the plain flow kernel)
    against JAX's Pallas path in interpret mode, and the port's plain
    feed-forward against JAX's."""
    jpwn, jparams, pwn, tparams = student_pair(num_iaf_layers=(2, 2), width=width)
    mel = mel_batch()
    x = _noise(mel.shape[0], pwn.sample_length(mel.shape[1]))
    want = jparallelgen.feed_forward_pallas(jpwn, jparams, {"mel": mel, "base_x": x},
                                            b_tile=2, interpret=True)
    inputs = {"mel": torch.from_numpy(mel), "base_x": torch.from_numpy(x)}
    got = parallelgen.feed_forward_cuda(pwn, tparams, inputs)
    plain = pwn.feed_forward(tparams, inputs)
    jplain, _ = jpwn.feed_forward(jparams, {"mel": jnp.asarray(mel), "base_x": jnp.asarray(x)})
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        print(f"W {width} {k}: fused-Pallas "
              f"{np.abs(got[k].numpy() - np.asarray(want[k])).max():.3e}, plain-JAX plain "
              f"{np.abs(plain[k].numpy() - np.asarray(jplain[k])).max():.3e}, scale "
              f"{np.abs(np.asarray(want[k])).max():.3e}")
    assert_ff_close(got, want, WIDE_FF_TOL)
    assert_ff_close(plain, jplain, WIDE_FF_TOL)


def test_synthesize_paths_agree_within_one_bin():
    _, _, pwn, tparams = student_pair()
    mel = torch.from_numpy(mel_batch())
    a = parallelgen.synthesize(pwn, tparams, mel, torch.Generator().manual_seed(11))
    b = parallelgen.synthesize_cuda(pwn, tparams, mel, torch.Generator().manual_seed(11))
    assert a.shape == b.shape == (3, 1400)
    assert float((a - b).abs().max()) <= 2.0 / pwn.cfg.quant_chann + 1e-6
    assert float(a.abs().max()) <= 1.0


@pytest.fixture(scope="module")
def golden():
    jpwn, jparams, meta = load_golden("student")
    d = student_dir()
    pwn = ParallelWavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    tparams = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    mels, _ = eval_mels(n=2)
    mels = mels[:, :21]  # 4200 samples, snapped to 4192
    x = _noise(2, pwn.sample_length(mels.shape[1]), seed=7)
    return jpwn, jparams, pwn, tparams, mels, x


def test_golden_student_loads_like_jax(golden):
    _, jparams, pwn, tparams, _, _ = golden
    want = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    flat_w, _ = jax.tree_util.tree_flatten(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(tparams)
    assert tree_g == jax.tree_util.tree_structure(want)
    for a, b in zip(flat_g, flat_w):
        assert torch.equal(a, b)
    assert pwn.cfg.num_iaf_layers == (5, 5) and "deconv" in tparams["flows"][0]


def test_golden_student_plain_and_fused_track_jax(golden):
    """On trained weights (peaked scales) both of the port's paths correlate
    with their JAX counterparts as those correlate with each other."""
    jpwn, jparams, pwn, tparams, mels, x = golden
    jff, _ = jpwn.feed_forward(jparams, {"mel": jnp.asarray(mels), "base_x": x})
    xla = np.asarray(jpwn._clip_quant_scale(jff["x"]))
    pal = np.asarray(jpwn._clip_quant_scale(jparallelgen.feed_forward_pallas(
        jpwn, jparams, {"mel": jnp.asarray(mels), "base_x": x}, interpret=True)["x"]))
    inputs = {"mel": torch.from_numpy(mels), "base_x": torch.from_numpy(x)}
    plain = pwn._clip_quant_scale(pwn.feed_forward(tparams, inputs)["x"]).numpy()
    fused = pwn._clip_quant_scale(parallelgen.feed_forward_cuda(pwn, tparams, inputs)["x"]).numpy()
    assert plain.shape == xla.shape == (2, 4192) and np.abs(xla).max() > 0.01
    corr = lambda a, b: np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr(plain, xla) > 0.999
    assert corr(fused, pal) > 0.999
    assert corr(fused, plain) > 0.999


def test_streamer_matches_oneshot_for_two_lengths_and_jax(golden):
    jpwn, jparams, pwn, tparams, mels, x = golden
    st = parallelgen.StudentStreamer(pwn, chunk=1024)
    for frames in (21, 13):  # one streamer object, two utterance lengths
        mel = torch.from_numpy(mels[:, :frames])
        L = pwn.sample_length(frames)
        bx = torch.from_numpy(x[:, :L])
        one = pwn._clip_quant_scale(
            parallelgen.feed_forward_cuda(pwn, tparams, {"mel": mel, "base_x": bx})["x"])
        got = st.synthesize(tparams, mel, base_x=bx)
        assert got.shape == one.shape == (2, L) and L % 1024 != 0  # a ragged last chunk
        assert float((got - one).abs().max()) <= 5e-3
    jst = jparallelgen.StudentStreamer(jpwn, chunk=1024, tile=256, interpret=True)
    want = jst.synthesize(jparams, jnp.asarray(mels[:, :13]), base_x=x[:, :L])
    assert np.abs(got.numpy() - want).max() <= 5e-3
    # chunks shorter than the largest 2d carry part of the old state forward
    short = parallelgen.StudentStreamer(pwn, chunk=20).synthesize(tparams, mel, base_x=bx)
    assert float((short - one).abs().max()) <= 5e-3


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_streamer_with_per_flow_deconv_matches_oneshot(compute_dtype):
    """Each flow's own encoding is trimmed and cut into chunks like the
    one-shot path's; the last chunk is ragged."""
    _, _, pwn, tparams = student_pair(use_share_deconv=False, compute_dtype=compute_dtype)
    mel = torch.from_numpy(mel_batch())
    L = pwn.sample_length(mel.shape[1])
    bx = torch.from_numpy(_noise(mel.shape[0], L, seed=5))
    one = pwn._clip_quant_scale(
        parallelgen.feed_forward_cuda(pwn, tparams, {"mel": mel, "base_x": bx})["x"])
    got = parallelgen.StudentStreamer(pwn, chunk=300).synthesize(tparams, mel, base_x=bx)
    assert got.shape == one.shape == (3, L) and L % 300 != 0
    assert float((got - one).abs().max()) <= 5e-3


def test_streamer_draws_noise_per_chunk_and_restacks_mutated_weights(golden):
    _, _, pwn, tparams, mels, _ = golden
    tparams = jax.tree_util.tree_map(torch.clone, tparams)
    mel = torch.from_numpy(mels[:, :6])
    st = parallelgen.StudentStreamer(pwn, chunk=512)
    a = st.synthesize(tparams, mel, torch.Generator().manual_seed(3))
    b = st.synthesize(tparams, mel, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, pwn.sample_length(6))
    assert bool(torch.isfinite(a).all()) and float(a.abs().max()) <= 1.0
    with pytest.raises(ValueError):
        st.synthesize(tparams, mel)
    # a weight changed in place must change the output: nothing stale is served
    tparams["flows"][0]["layers"][2]["dilated"]["w"].mul_(1.5)
    c = st.synthesize(tparams, mel, torch.Generator().manual_seed(3))
    assert not torch.equal(a, c)


def _source_wavs(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i in (0, 1):
        wav, _ = wav_io.read_wav(os.path.join(GOLDEN, f"gen_student_{i}.wav"))
        wav_io.write_wav(str(src / f"utt_{i}.wav"), wav[:3000])
    return str(src)


@pytest.mark.parametrize("streaming_chunk", [None, 1000])
def test_generate_parallel_wavenet_writes_finite_wavs(tmp_path, streaming_chunk):
    d = student_dir()
    out = generate_parallel_wavenet(
        _source_wavs(tmp_path), os.path.join(d, "params.npz"), os.path.join(d, "meta.json"),
        str(tmp_path / "gen"), batch_size=2, seed=0, device="cpu", sample_length=2400,
        streaming_chunk=streaming_chunk)
    assert [os.path.basename(p) for p in out] == ["gen_utt_0.wav", "gen_utt_1.wav"]
    for p in out:
        wav, sr = wav_io.read_wav(p)
        assert sr == 16000 and wav.shape == (2592,)  # 13 frames x 200, snapped to a multiple of 16
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_eval_entry_points_refuse_the_other_model(tmp_path):
    src = _source_wavs(tmp_path)
    st, te = student_dir(), os.path.join(GOLDEN, "tiny_mol")
    with pytest.raises(ValueError, match="teacher config"):
        generate_parallel_wavenet(src, os.path.join(te, "params.npz"),
                                  os.path.join(te, "meta.json"), str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match="student config"):
        generate_wavenet(src, os.path.join(st, "params.npz"), os.path.join(st, "meta.json"),
                         str(tmp_path / "b"), device="cpu")


def test_generate_parallel_wavenet_serves_an_f32_student_like_jax(tmp_path):
    """The eval entry point on an f32 config (the golden with compute_dtype
    float32; the card serves it through the f32-conditioning kernel) writes
    finite wavs, equal up to the 16-bit wav rounding and a quantisation bin to
    the JAX package's fused path on the same noise and the same mels."""
    with open(os.path.join(student_dir(), "meta.json")) as f:
        meta = json.load(f)
    meta["config"]["compute_dtype"] = "float32"
    cfg_path = tmp_path / "meta.json"
    cfg_path.write_text(json.dumps(meta))
    src = _source_wavs(tmp_path)
    out = generate_parallel_wavenet(src, os.path.join(student_dir(), "params.npz"), str(cfg_path),
                                    str(tmp_path / "gen"), batch_size=2, seed=3, device="cpu",
                                    sample_length=2400)
    got = np.stack([wav_io.read_wav(p)[0] for p in out])
    assert got.shape == (2, 2592) and np.isfinite(got).all() and np.abs(got).max() > 0

    pwn = ParallelWavenet(tconfig.load_config(str(cfg_path)))
    assert pwn.dtype is None  # f32 compute
    mel = load_mel_batch(discover_files(src), 2400)
    x = pwn.base_noise(torch.Generator().manual_seed(3), 2, 2592, "cpu").numpy()
    jpwn = JParallelWavenet(jconfig.ParallelWavenetConfig(**dataclasses.asdict(pwn.cfg)))
    _, jparams, _ = load_golden("student")
    want = np.asarray(jpwn._clip_quant_scale(jparallelgen.feed_forward_pallas(
        jpwn, jparams, {"mel": jnp.asarray(mel), "base_x": x}, interpret=True)["x"]))
    # readings: 9.2e-5 (a bin of 2 / 65536 where a value sits on an edge, and
    # the wav's 1 / 32768)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_student_eval_cli(tmp_path):
    d = student_dir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # the interpreters' work is tiny; spare the other workers
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "eval_parallel_wavenet_torch.py"),
         "--source_path", _source_wavs(tmp_path), "--params", os.path.join(d, "params.npz"),
         "--config", os.path.join(d, "meta.json"), "--save_path", str(tmp_path / "gen"),
         "--sample_length", "1200", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path / "gen")) == ["gen_utt_0.wav", "gen_utt_1.wav"]
    assert "Delay" in proc.stderr
