"""The mixture-of-Gaussians functions of the port (ops/distributions.py
mog_log_prob, mog_loss, mog_sample) against the JAX package's, on the CPU.

The log-prob, the loss and their gradients are held in f64 within 1e-12 of
JAX's (jax.enable_x64), and in f32 within 1e-5 x max(|JAX|, 1).  JAX
samples with threefry keys and the port with a torch generator, so the
sampler is held on injected draws: the same uniforms for the component pick
and the same standard normals for the value give the same quantised samples,
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.ops import distributions as jdist
from nsynth_wavenet_tpu_torch.ops import distributions as tdist

NR_MIX = 5


def _inputs(seed, dtype, shape=(3, 50)):
    rng = np.random.default_rng(seed)
    params = np.concatenate([rng.standard_normal(shape + (NR_MIX,)),
                             0.6 * rng.standard_normal(shape + (NR_MIX,)),
                             rng.uniform(-5.0, 0.5, shape + (NR_MIX,))], axis=-1)
    targets = rng.uniform(-1.0, 1.0, shape)
    return params.astype(dtype), targets.astype(dtype)


@pytest.mark.parametrize("use_log_scales", (True, False))
def test_mog_log_prob_and_gradient_match_jax_in_f64(use_log_scales):
    p, t = _inputs(0, np.float64)
    with jax.enable_x64():
        want = np.asarray(jdist.mog_log_prob(jnp.asarray(p), jnp.asarray(t), use_log_scales))
        jgrad = np.asarray(jax.grad(lambda q: jdist.mog_loss(q, jnp.asarray(t)))(jnp.asarray(p)))
        jloss = float(jdist.mog_loss(jnp.asarray(p), jnp.asarray(t)))
    got = tdist.mog_log_prob(torch.from_numpy(p), torch.from_numpy(t), use_log_scales).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    tp = torch.from_numpy(p).requires_grad_(True)
    loss = tdist.mog_loss(tp, torch.from_numpy(t))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-12 * max(abs(jloss), 1.0)
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, atol=1e-12, rtol=0)


def test_mog_log_prob_matches_jax_in_f32():
    p, t = _inputs(1, np.float32)
    want = np.asarray(jdist.mog_log_prob(p, t))
    got = tdist.mog_log_prob(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(np.abs(want).max(), 1.0), rtol=0)
    assert abs(float(tdist.mog_loss(torch.from_numpy(p), torch.from_numpy(t)))
               - float(jdist.mog_loss(p, t))) <= 1e-5 * max(abs(float(jdist.mog_loss(p, t))), 1.0)


@pytest.mark.parametrize("use_log_scales", (True, False))
@pytest.mark.parametrize("quant_chann", (256, 65536))
def test_mog_sample_matches_jax_on_the_same_draws(monkeypatch, quant_chann, use_log_scales):
    p, _ = _inputs(2, np.float32, shape=(4, 200))
    rng = np.random.default_rng(3)
    ru = rng.uniform(1e-5, 1.0 - 1e-5, p.shape[:-1] + (NR_MIX,)).astype(np.float32)
    z = rng.standard_normal(p.shape[:-1]).astype(np.float32)
    calls = []

    def uniform_open(key, shape):
        calls.append("uniform")
        assert tuple(shape) == ru.shape
        return jnp.asarray(ru)

    def normal(key, shape):
        calls.append("normal")
        assert tuple(shape) == z.shape
        return jnp.asarray(z)

    monkeypatch.setattr(jdist, "_uniform_open", uniform_open)
    monkeypatch.setattr(jdist.jax.random, "normal", normal)
    want = np.asarray(jdist.mog_sample(jax.random.PRNGKey(0), jnp.asarray(p), quant_chann,
                                       use_log_scales))
    assert calls == ["uniform", "normal"]
    got = tdist.mog_sample_from(torch.from_numpy(p), torch.from_numpy(ru), torch.from_numpy(z),
                                quant_chann, use_log_scales).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -quant_chann // 2 and got.max() < quant_chann // 2


def test_mog_sample_draws_its_own_noise():
    p, _ = _inputs(4, np.float32, shape=(2000,))
    p[:, :NR_MIX] = np.array([8.0, -8.0, -8.0, -8.0, -8.0])  # component 0 only
    p[:, NR_MIX] = 0.25  # its mean
    p[:, 2 * NR_MIX] = np.log(0.05)  # its std
    s = tdist.mog_sample(torch.Generator().manual_seed(0), torch.from_numpy(p), 65536)
    x = s.numpy().astype(np.float64) / 32768.0
    assert abs(x.mean() - 0.25) < 0.005 and abs(x.std() - 0.05) < 0.005
    again = tdist.mog_sample(torch.Generator().manual_seed(0), torch.from_numpy(p), 65536)
    assert torch.equal(s, again)
    other = tdist.mog_sample(torch.Generator().manual_seed(1), torch.from_numpy(p), 65536)
    assert not torch.equal(s, other)
