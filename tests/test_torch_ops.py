"""The port's ops (nsynth_wavenet_tpu_torch/ops) against the JAX package on
the same numpy inputs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.models import wavenet as jwavenet
from nsynth_wavenet_tpu.ops import conv as jconv
from nsynth_wavenet_tpu.ops import signal as jsig
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch.models import wavenet as twavenet
from nsynth_wavenet_tpu_torch.ops import conv as tconv
from nsynth_wavenet_tpu_torch.ops import signal as tsig
from nsynth_wavenet_tpu_torch.ops import stft as tstft


def _wav(seed, shape):
    rng = np.random.RandomState(seed)
    return np.clip(rng.uniform(-1.0, 1.0, shape), -1.0, 0.9999).astype(np.float32)


def _params(seed, fl, cin, cout):
    rng = np.random.RandomState(seed)
    return {"w": (0.05 * rng.randn(fl, cin, cout)).astype(np.float32),
            "b": (0.1 * rng.randn(cout)).astype(np.float32)}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def test_signal_functions_match_exactly():
    x = _wav(0, (4096,))
    np.testing.assert_array_equal(tsig.mu_law(torch.from_numpy(x)).numpy(),
                                  np.asarray(jsig.mu_law(x)))
    q = np.arange(-128, 128, dtype=np.float32)
    np.testing.assert_array_equal(tsig.inv_mu_law(torch.from_numpy(q)).numpy(),
                                  np.asarray(jsig.inv_mu_law(q)))
    for qc in (256, 65536):
        got = tsig.cast_quantize(torch.from_numpy(x), qc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsig.cast_quantize(x, qc)))
        np.testing.assert_array_equal(tsig.inv_cast_quantize(got, qc).numpy(),
                                      np.asarray(jsig.inv_cast_quantize(np.asarray(got), qc)))
    for mu_law, qc in ((True, 256), (False, 65536)):
        got = tsig.encode_signal(torch.from_numpy(x), use_mu_law=mu_law, quant_chann=qc)
        want = jsig.encode_signal(x, use_mu_law=mu_law, quant_chann=qc)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_mel_matches_jax_numpy_twin():
    x = 0.5 * _wav(1, (2, 4000))
    want = jstft.melspectrogram_np(x)
    np.testing.assert_allclose(tstft.melspectrogram_np(x), want, atol=1e-5, rtol=0)
    got = tstft.melspectrogram(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tstft.mel_filterbank(), jstft.mel_filterbank())


@pytest.mark.parametrize("dilation,causal", [(1, True), (4, True), (2, False)])
def test_conv1d_matches_jax(dilation, causal):
    p = _params(2, 3, 16, 24)
    x = np.random.RandomState(3).randn(2, 50, 16).astype(np.float32)
    want = np.asarray(jconv.conv1d(p, x, dilation=dilation, causal=causal))
    got = tconv.conv1d(_t(p), torch.from_numpy(x), dilation=dilation, causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(np.abs(want).max(), 1.0), rtol=0)


@pytest.mark.parametrize("fl,stride", [(40, 10), (80, 20)])
def test_trans_conv1d_matches_jax(fl, stride):
    p = _params(4, fl, 8, 12)
    x = np.random.RandomState(5).randn(2, 7, 8).astype(np.float32)
    want = np.asarray(jconv.trans_conv1d(p, x, stride=stride))
    got = tconv.trans_conv1d(_t(p), torch.from_numpy(x), stride=stride).numpy()
    assert got.shape == want.shape == (2, 7 * stride, 12)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(np.abs(want).max(), 1.0), rtol=0)


def test_deconv_stack_matches_jax():
    cfg = dict(deconv_config=((40, 10), (80, 20)), upsample_act="leaky_relu",
               use_resize_conv=False)
    params = {"up_1": _params(6, 40, 80, 32), "up_2": _params(7, 80, 32, 32)}
    mel = np.random.RandomState(8).rand(2, 5, 80).astype(np.float32)
    want, _ = jwavenet.apply_deconv_stack(params, mel, **cfg)
    want = np.asarray(want)
    got = twavenet.apply_deconv_stack(_t(params), torch.from_numpy(mel), **cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(np.abs(want).max(), 1.0), rtol=0)


def test_shift_right_and_effective_kernel():
    x = np.random.RandomState(9).randn(2, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(tconv.shift_right(torch.from_numpy(x)).numpy(),
                                  np.asarray(jconv.shift_right(x)))
    rng = np.random.RandomState(10)
    wn = {"v": rng.randn(3, 4, 5).astype(np.float32),
          "g": rng.rand(5).astype(np.float32) + 0.5, "b": np.zeros(5, np.float32)}
    np.testing.assert_allclose(tconv.effective_kernel(_t(wn)).numpy(),
                               np.asarray(jconv.effective_kernel(wn)), atol=1e-6, rtol=0)
    leaky = tconv.get_upsample_act("leaky_relu")(torch.tensor([-1.0, 2.0]))
    np.testing.assert_allclose(leaky.numpy(), [-0.4, 2.0])
