"""Serving from raw wavs and the per-layer conditioning, on the CPU:
Fastgen.precompute_conditioning against the JAX package's; the mel that
Fastgen.generate_from_wav and parallelgen.synthesize_from_wav compute
(ops/stft.py melspectrogram, the card mel) against JAX's
stft.melspectrogram; each from-wav function equal bit for bit to its two
steps, the mel and then generate_cuda / synthesize_cuda (their plain
versions on CPU tensors) on the same batch shape and seed.

Audio is never compared with JAX's: JAX samples with threefry, the port with
Philox and torch generators.  Tolerances: the mel within 1e-5 (the JAX
package's own numpy-twin limit, tests/test_torch_ops.py); the conditioning
within 1e-5 x max(|JAX|, 1) in f32 (summation order), 2^-7 x max |JAX| in
bf16 (one bf16 step either side)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models.fastgen import Fastgen as JFastgen
from nsynth_wavenet_tpu.models.wavenet import Wavenet as JWavenet
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import stft as tstft
from test_torch_fastgen import _golden_inputs, _port
from tools.make_golden_ckpt import student_dir

CASES = [("golden_mol", None), ("resize_bf16", dict(use_resize_conv=True,
                                                     compute_dtype="bfloat16"))]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _teacher(case):
    """(JAX model, JAX params, wav [2, 1280]): the golden tiny_mol, or its
    config cut to 4 layers with resize-conv upsampling in bf16 and random
    weights."""
    jmodel, jparams, wav = _golden_inputs("mol")
    name, kw = case
    if kw is not None:
        d = dict(jmodel.cfg.__dict__, num_layers=4, num_stages=2, **kw)
        jmodel = JWavenet(jconfig.wavenet_config_from_dict(d))
        jparams = jmodel.init_params(jax.random.PRNGKey(1))
    return jmodel, jparams, wav


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_precompute_conditioning_matches_jax(case):
    jmodel, jparams, wav = _teacher(case)
    mel = jstft.melspectrogram_np(wav)
    want = [np.asarray(a, np.float32) for a in JFastgen(jmodel).precompute_conditioning(
        jparams, jnp.asarray(mel))]
    model, params = _port(jmodel, jparams)
    got = [a.float().numpy() for a in Fastgen(model).precompute_conditioning(
        params, torch.from_numpy(mel))]
    cfg = model.cfg
    B, Te = 2, mel.shape[1] * cfg.frame_shift
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (B, Te, cfg.deconv_width), (cfg.num_layers, B, Te, cfg.gate_width), (B, Te, cfg.skip_width)]
    bf16 = cfg.compute_dtype == "bfloat16"
    for name, g, w in zip(("encoding", "cond", "cond_out1"), got, want):
        tol = 2.0 ** -7 * np.abs(w).max() if bf16 else 1e-5 * max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def test_card_mel_matches_jax():
    _, _, wav = _golden_inputs("mol")
    want = np.asarray(jstft.melspectrogram(jnp.asarray(wav)))
    got = tstft.melspectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 7, 80)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_generate_from_wav_is_mel_then_generate_cuda(case):
    jmodel, jparams, wav = _teacher(case)
    model, params = _port(jmodel, jparams)
    fg = Fastgen(model)
    w = torch.from_numpy(wav)
    for kw in ({}, {"weight_dtype": "int8", "chunk": 64}):
        got = fg.generate_from_wav(params, w, 5, length=160, **kw)
        want = fg.generate_cuda(params, tstft.melspectrogram(w), 5, length=160, **kw)
        assert got.shape == (2, 160) and torch.isfinite(got).all()
        assert torch.equal(got, want), kw
    # another seed, another sample
    assert not torch.equal(fg.generate_from_wav(params, w, 6, length=160), got)


def test_synthesize_from_wav_is_mel_then_synthesize_cuda():
    d = student_dir()
    pwn = ParallelWavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    _, _, wav = _golden_inputs("mol")
    w = torch.from_numpy(wav)
    got = parallelgen.synthesize_from_wav(pwn, params, w, torch.Generator().manual_seed(3))
    want = parallelgen.synthesize_cuda(pwn, params, tstft.melspectrogram(w),
                                       torch.Generator().manual_seed(3))
    assert got.shape == want.shape and got.shape[0] == 2 and torch.isfinite(got).all()
    assert torch.equal(got, want)
    fused = parallelgen.synthesize_from_wav(pwn, params, w, torch.Generator().manual_seed(3),
                                            layers_per_call=2 * pwn.cfg.num_stages)
    assert torch.equal(fused, got)
