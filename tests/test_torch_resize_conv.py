"""Resize-conv upsampling in the port (ops/conv.py resize_conv1d and
resize_conv1d_ddi, models/wavenet.py use_resize_conv) against the JAX
package on the CPU: the op at odd and even filters and strides 2 to 20 in
f32 and bf16, its data-dependent init, the deconv stack, and one teacher
training step (f32 and weight-normed), its data-dependent init pass and three
distillation steps with use_resize_conv, as tests/test_training.py trains
such a teacher.

Tolerances.  f32: 1e-5 x max(|JAX|, 1), summation order only.  bf16: both
sides round the operands and the product to bf16, and the sums are taken in
another order, so a value may land one bf16 step (2^-8 of its size) away:
held within 2^-7 x max |JAX|.  The training cases keep the limits of
tests/test_torch_train_step.py and tests/test_torch_distill_step.py, whose
helpers they run, but for one: the teacher's params after 3 Adam steps are
held to RESIZE_UPDATE_TOL (L2 of the update), not 1e-3.  The gradients agree
to 8.4e-6 of each leaf's scale, but the first resize conv's kernel [40, 80,
W] sums every tap over a whole run of repeated frames of a mel whose high
bins are near silent, so many of its elements have roundoff-sized gradients,
and Adam steps each of them by about the learning rate whatever its size:
that leaf reads 1.4e-3 (1.6e-3 weight-normed; the transposed stack's few
taps a frame read under 1e-3), every other leaf under 3.1e-4.  The
distillation steps hold each step's metrics from a shared state (JAX's
state after the step before) at METRIC_TOL, and the params and EMA after
three free-running steps at UPDATE_TOL (readings with one torch thread /
eight: params 8.9e-5 / 9.3e-6, EMA 8.6e-5 / 3.0e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.models import wavenet as jwavenet
from nsynth_wavenet_tpu.ops import conv as jconv
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu.training import train_lib as jtl
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models import wavenet as twavenet
from nsynth_wavenet_tpu_torch.ops import conv as tconv
from nsynth_wavenet_tpu_torch.training import train_lib as ttl
from test_torch_distill_step import METRIC_TOL, METRICS, UPDATE_TOL
from test_torch_distill_step import _port_state
from test_torch_distill_step import _run_both as distill_run_both
from test_torch_train_step import TOL, _check, _configs, _flat, _leaf_err, _run_both, _tflat, _wavs

BF16_TOL = 2.0 ** -7
RESIZE_UPDATE_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed, fl, cin, cout, weight_norm=False):
    rng = np.random.RandomState(seed)
    w = (0.05 * rng.randn(fl, cin, cout)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    if weight_norm:
        return {"v": w, "g": np.sqrt((w * w).sum(axis=(0, 1))).astype(np.float32), "b": b}
    return {"w": w, "b": b}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("fl,stride", [(3, 2), (4, 3), (7, 5), (40, 10), (80, 20), (5, 20)])
def test_resize_conv1d_matches_jax(fl, stride, dtype):
    p = _params(fl + stride, fl, 8, 12)
    x = np.random.RandomState(stride).randn(2, 7, 8).astype(np.float32)
    jd, td = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jconv.resize_conv1d(p, x, stride=stride, dtype=jd), np.float32)
    got = tconv.resize_conv1d(_t(p), torch.from_numpy(x), stride=stride, dtype=td).numpy()
    assert got.shape == want.shape == (2, 7 * stride, 12)
    scale = max(np.abs(want).max(), 1.0)
    tol = 1e-5 * scale if dtype == "float32" else BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_resize_conv_pads_even_filters_on_the_right():
    """An even SAME filter pads (fl/2 - 1, fl/2): 80 taps pad (39, 40).  A
    one-hot kernel at tap k reads x(t + k - 39)."""
    x = torch.arange(1.0, 6.0)[None, :, None]  # [1, 5, 1], upsampled to 10
    for k, shift in ((39, 0), (40, 1), (0, -39)):
        w = torch.zeros(80, 1, 1)
        w[k] = 1.0
        y = tconv.resize_conv1d({"w": w, "b": torch.zeros(1)}, x, stride=2)[0, :, 0]
        up = torch.repeat_interleave(x[0, :, 0], 2)
        want = torch.zeros(10)
        for t in range(10):
            if 0 <= t + shift < 10:
                want[t] = up[t + shift]
        assert torch.equal(y, want), (k, y, want)


@pytest.mark.parametrize("fl,stride", [(4, 3), (40, 10)])
def test_resize_conv1d_ddi_matches_jax(fl, stride):
    p = dict(_params(11, fl, 8, 12, weight_norm=True), b=np.zeros(12, np.float32))  # as at init
    x = np.random.RandomState(12).randn(3, 6, 8).astype(np.float32)
    jy, jp = jconv.resize_conv1d_ddi(p, x, stride=stride)
    ty, tp = tconv.resize_conv1d_ddi(_t(p), torch.from_numpy(x), stride=stride)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    for k in ("v", "g", "b"):
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), want, atol=1e-5 * max(np.abs(want).max(), 1.0),
                                   rtol=0, err_msg=k)
    # each rescaled channel has mean 0 and standard deviation 1 over the batch
    assert float(ty.mean(dim=(0, 1)).abs().max()) < 1e-5
    assert float((ty.std(dim=(0, 1), unbiased=False) - 1.0).abs().max()) < 1e-4


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_resize_deconv_stack_matches_jax(dtype):
    cfg = dict(deconv_config=((40, 10), (80, 20)), upsample_act="leaky_relu",
               use_resize_conv=True)
    params = {"up_1": _params(6, 40, 80, 16), "up_2": _params(7, 80, 16, 16)}
    mel = np.random.RandomState(8).rand(2, 5, 80).astype(np.float32)
    jd, td = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want, _ = jwavenet.apply_deconv_stack(params, mel, dtype=jd, out_dtype=jd, **cfg)
    want = np.asarray(want, np.float32)
    got = twavenet.apply_deconv_stack(_t(params), torch.from_numpy(mel), dtype=td, out_dtype=td,
                                      **cfg).float().numpy()
    assert got.shape == want.shape == (2, 1000, 16)
    scale = np.abs(want).max()
    tol = 1e-5 * max(scale, 1.0) if dtype == "float32" else BF16_TOL * scale
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # and not the transposed stack
    trans = twavenet.apply_deconv_stack(_t(params), torch.from_numpy(mel),
                                        **{**cfg, "use_resize_conv": False}).numpy()
    assert np.abs(trans - want).max() > 10 * tol


# (head, config overrides): the Gauss head plain and weight-normed, and the
# combination tests/test_training.py::test_weight_norm_resize_conv_training
# trains (mu-law CE, weight norm, relu upsampling)
TRAIN_CASES = [("gauss", {}), ("gauss", {"use_weight_norm": True}),
               ("ce", {"use_weight_norm": True, "use_mu_law": True, "upsample_act": "relu"})]


@pytest.mark.parametrize("head,kw", TRAIN_CASES,
                         ids=["gauss", "gauss-weight_norm", "ce-mu_law-wn-relu"])
def test_resize_conv_train_step_equals_jax(head, kw):
    out = _run_both(head, grad_clip=True, param_scale=3.0, use_resize_conv=True, **kw)
    print(head, kw, {k: out[k] for k in ("grad_err", "params_err", "ema_err", "norm")})
    _check(out, TOL["f32"][0], RESIZE_UPDATE_TOL)
    # the deconv's gradients reach the upsampler's weights
    jg, _ = out["grads"]
    leaf = "['deconv']['up_1']" + ("['v']" if kw.get("use_weight_norm") else "['w']")
    assert np.abs(jg[leaf]).max() > 0


def test_resize_conv_data_dep_init_equals_jax():
    jc, tc = _configs("mol", use_weight_norm=True, use_resize_conv=True)
    jm, tm = jwavenet.Wavenet(jc), twavenet.Wavenet(tc)
    jp = jm.init_params(jax.random.PRNGKey(5))
    tp = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    wav = np.concatenate(_wavs(2), axis=0)
    mel = jstft.melspectrogram_np(wav)
    j_out, j_new = jtl.run_data_dep_init(jm, jp, wav, mel)
    t_out, t_new = ttl.run_data_dep_init(tm, tp, torch.from_numpy(wav), torch.from_numpy(mel))
    want = np.asarray(j_out)
    np.testing.assert_allclose(t_out.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # b = -mean * scale is roundoff where a layer's mean is 0: a floor of 1e-2
    assert _leaf_err(_flat(j_new), _tflat(t_new), floor=1e-2) <= 1e-4
    # the pass rescaled the resize convs' g
    before, after = _tflat(tp), _tflat(t_new)
    assert not np.allclose(after["['deconv']['up_2']['g']"], before["['deconv']['up_2']['g']"])


@pytest.mark.parametrize("threads", (1, 8))
def test_resize_conv_distill_steps_equal_jax(monkeypatch, threads):
    """Each step's metrics from a shared state: step 1 from the common
    init, steps 2 and 3 from JAX's state after the step before.  Free
    running, the third step's loss depends on the summation order alone: the
    first resize conv's roundoff-sized gradients each move their element by
    about the learning rate, so the two sides' second-step params part in
    those elements, and the third step's loss reads 1.2e-4 apart with one
    torch thread and 9e-7 with eight (the two sides run in f64 part by
    4.3e-5 there themselves).  The params and EMA after 3 free-running steps
    stay held at UPDATE_TOL."""
    torch.set_num_threads(threads)
    out = distill_run_both(monkeypatch, "gauss", teacher_kw={"use_resize_conv": True},
                           use_resize_conv=True, power_loss_factor=1.0, grad_clip=True)
    assert out["pair"].tcfg.use_resize_conv and out["pair"].tteacher.cfg.use_resize_conv
    shared = [out["metrics"][0][1]]
    for k in range(1, len(out["batches"])):
        (wav, wav_rand), draws = out["batches"][k], out["draws"][k]
        _, tm = out["tstep"](_port_state(out["jstates"][k - 1]), torch.from_numpy(wav),
                             torch.from_numpy(wav_rand), None,
                             draws={n: torch.from_numpy(v) for n, v in draws.items()})
        shared.append({n: float(v) for n, v in tm.items()})
    for (jm, _), tm in zip(out["metrics"], shared):
        for k in METRICS:
            assert abs(tm[k] - jm[k]) <= METRIC_TOL * max(abs(jm[k]), 1.0), (k, jm[k], tm[k])
    print({"params": out["params_err"], "ema": out["ema_err"]})
    assert out["params_err"] <= UPDATE_TOL and out["ema_err"] <= UPDATE_TOL
