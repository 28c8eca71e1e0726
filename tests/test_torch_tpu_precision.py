"""The TPU's single-pass bf16 f32 dot as a reading of the port
(nsynth_wavenet_tpu_torch/tools/tpu_precision.py) against the JAX package's
contractions with their operands cast to bf16 and
``preferred_element_type=float32``, on the CPU:

* ``Bf16Dot`` forward and both backward products against jax.lax.dot_general
  on bf16 operands, its DFT tables equal to JAX's ``_dft_matrices``;
* under ``tpu_default_precision()`` the port's ``stft_center`` /
  ``stft_pad_end`` (the DFT of JAX's ``_rfft``) and mel spectrogram (the DFT
  and the filterbank product), values and gradients, against the JAX
  package's functions with ``_rfft`` and the filterbank product done the
  TPU's way; outside the block the port's functions are its own again.

Tolerances, of the largest value: values RTOL 1e-5 (f32 sums of the same
bf16-exact products in two orders); gradients GRAD_RTOL 2e-4, because the
backward pass rounds the cotangent to bf16 too, and a cotangent element
whose f32 value the two sides differ in by a last bit (|STFT| near zero
makes re / |z| sensitive) can round to the neighbouring bf16 value, 2^-8 of
itself (readings in each test's docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.tools import tpu_precision as tp

RTOL, GRAD_RTOL = 1e-5, 2e-4
F32 = jnp.float32


@jax.custom_vjp
def jax_bf16_dot(a, b):
    """a @ b as a TPU computes an f32 dot at Precision.DEFAULT: bf16
    operands, f32 products and sums; its transposes the same way."""
    return jax.lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                               (((a.ndim - 1,), (0,)), ((), ())), preferred_element_type=F32)


def _fwd(a, b):
    return jax_bf16_dot(a, b), (a, b)


def _bwd(res, g):
    a, b = res
    g16 = g.astype(jnp.bfloat16)
    ga = jax.lax.dot_general(g16, b.astype(jnp.bfloat16), (((g.ndim - 1,), (1,)), ((), ())),
                             preferred_element_type=F32)
    a2 = a.reshape(-1, a.shape[-1]).astype(jnp.bfloat16)
    gb = jax.lax.dot_general(a2, g16.reshape(-1, g.shape[-1]), (((0,), (0,)), ((), ())),
                             preferred_element_type=F32)
    return ga, gb


jax_bf16_dot.defvjp(_fwd, _bwd)


def jax_rfft(frames, n_fft):
    """JAX's _rfft with its two products done the TPU's way."""
    cos_m, sin_m = jstft._dft_matrices(n_fft)
    return jax.lax.complex(jax_bf16_dot(frames, jnp.asarray(cos_m)),
                           jax_bf16_dot(frames, jnp.asarray(sin_m)))


def jax_melspectrogram(y):
    """JAX's melspectrogram (ops/stft.py) with _rfft and the filterbank
    product done the TPU's way."""
    p = jstft.MEL_PARAMS
    spec = jnp.abs(jstft.stft_center(y, p))
    basis = jstft.mel_filterbank(p.sample_rate, p.n_fft, p.num_mel, p.mel_fmin, p.mel_fmax)
    return jstft.db_normalize(jstft.amp_to_db(jax_bf16_dot(spec, jnp.asarray(basis.T)), p), p)


@pytest.fixture
def jax_tpu_rfft(monkeypatch):
    monkeypatch.setattr(jstft, "_rfft", jax_rfft)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    assert err <= rtol, err
    return err


def test_dft_tables_equal_jax():
    for got, want in zip(tp.dft_tables(2048), jstft._dft_matrices(2048)):
        np.testing.assert_array_equal(got, want)


def test_round_bf16_is_nearest_even():
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -3.3e-5, 1e30])
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(tp.round_bf16(x).numpy(), want)


def test_bf16_dot_forward_and_both_gradients_equal_jax():
    """Readings: forward 8.1e-8, gradients 1.1e-7 and 0."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 64)).astype(np.float32)
    b = rng.standard_normal((64, 33)).astype(np.float32)
    w = rng.standard_normal((3, 5, 33)).astype(np.float32)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    out = tp.Bf16Dot.apply(ta, tb)
    (out * torch.from_numpy(w)).sum().backward()
    want, (ga, gb) = jax_bf16_dot(a, b), jax.grad(
        lambda a, b: jnp.sum(jax_bf16_dot(a, b) * w), argnums=(0, 1))(a, b)
    _close(out.detach().numpy(), want)
    _close(ta.grad.numpy(), ga, GRAD_RTOL)
    _close(tb.grad.numpy(), gb, GRAD_RTOL)
    # the rounding is there: the f32 product differs
    assert np.abs(a @ b - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("name", ("stft_center", "stft_pad_end"))
def test_stfts_under_tpu_precision_equal_jax(jax_tpu_rfft, name):
    """The DFTs of the conditioning mel and the power loss: |STFT| and the
    gradient of a weighted sum of it.  Readings: values 2.6e-7 / 3.3e-7,
    gradients 6.1e-5 / 8.6e-6 (centre / pad-end)."""
    rng = np.random.default_rng(1)
    y = (0.3 * rng.standard_normal((2, 3840))).astype(np.float32)
    own = getattr(stft_ops, name)
    ty = torch.from_numpy(y).requires_grad_()
    with tp.tpu_default_precision():
        got = torch.abs(getattr(stft_ops, name)(ty))
        w = rng.standard_normal(tuple(got.shape)).astype(np.float32)
        (got * torch.from_numpy(w)).sum().backward()
    fn = getattr(jstft, name)
    want = jnp.abs(fn(y))
    gy = jax.grad(lambda y: jnp.sum(jnp.abs(fn(y)) * w))(y)
    _close(got.detach().numpy(), want)
    _close(ty.grad.numpy(), gy, GRAD_RTOL)
    # outside the block the port's own torch.fft.rfft again, in f32
    assert getattr(stft_ops, name) is own
    plain = torch.abs(own(torch.from_numpy(y))).numpy()
    assert np.abs(plain - got.detach().numpy()).max() > 1e-5


def test_melspectrogram_under_tpu_precision_equals_jax(jax_tpu_rfft):
    """The conditioning mel of the distillation step (train_lib), its DFT and
    filterbank product both the TPU's way.  Readings: values 1.2e-7,
    gradient 2.4e-6."""
    rng = np.random.default_rng(2)
    y = (0.3 * rng.standard_normal((2, 3840))).astype(np.float32)
    ty = torch.from_numpy(y).requires_grad_()
    with tp.tpu_default_precision():
        got = stft_ops.melspectrogram(ty)
        w = rng.standard_normal(tuple(got.shape)).astype(np.float32)
        (got * torch.from_numpy(w)).sum().backward()
    want = jax_melspectrogram(y)
    gy = jax.grad(lambda y: jnp.sum(jax_melspectrogram(y) * w))(y)
    _close(got.detach().numpy(), want)
    _close(ty.grad.numpy(), gy, GRAD_RTOL)
    # it is not the f32 mel: the bf16 operands move it
    plain = stft_ops.melspectrogram(torch.from_numpy(y)).numpy()
    assert np.abs(plain - got.detach().numpy()).max() > 1e-6


def test_tpu_precision_restores_the_ports_functions():
    saved = stft_ops.stft_center, stft_ops.stft_pad_end, stft_ops.melspec_from_spec
    with pytest.raises(RuntimeError):
        with tp.tpu_default_precision():
            assert stft_ops.stft_center is tp._stft_center
            assert stft_ops.melspec_from_spec is tp._melspec_from_spec
            raise RuntimeError
    assert (stft_ops.stft_center, stft_ops.stft_pad_end, stft_ops.melspec_from_spec) == saved
