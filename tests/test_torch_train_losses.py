"""The port's teacher losses and their gradients against the JAX package's
(nsynth_wavenet_tpu/ops/distributions.py), and the training config helpers,
on the CPU.

The losses are held in float64 on both sides to 1e-9: that holds the formula
itself, the edge bins' ``where`` and the 1e-12 floor included.  In f32 the
MoL head at quant_chann 65536 is ill-conditioned by construction: a bin is
2 / 65536 wide, so cdf_delta is the difference of two sigmoids near 0.5 that
agree in their first 15 bits, and one f32 rounding of either (2^-24) moves
it by up to 2^-9 of itself.  So f32 MoL-65536 is held to 2e-3 of the
gradient's scale, the other heads to 1e-5."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.ops import distributions as jdist
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch.ops import distributions as tdist

CONFIGS = ("wavenet_ce", "wavenet_mol", "wavenet_gauss", "parallel_wavenet",
           "parallel_wavenet_gauss")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(head, qc, dtype, n=(3, 64)):
    rng = np.random.default_rng({"ce": 1, "mol": 2, "gauss": 3}[head] + qc)
    if head == "ce":
        params = rng.normal(0, 2.0, n + (qc,))
        targets = rng.integers(0, qc, n)
        return params.astype(dtype), targets.astype(np.int32)
    if head == "mol":
        params = np.concatenate([rng.normal(0, 1.0, n + (10,)), rng.uniform(-0.9, 0.9, n + (10,)),
                                 rng.uniform(-6.0, -1.0, n + (10,))], axis=-1)
        # quantised targets in [-1, 1), with both edge bins present
        targets = rng.integers(-qc // 2, qc // 2, n) / (qc / 2)
        targets[:, :4] = -1.0
        targets[:, 4:8] = (qc // 2 - 1) / (qc / 2)
        return params.astype(dtype), targets.astype(dtype)
    params = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-5.0, 0.5, n)], axis=-1)
    return params.astype(dtype), rng.uniform(-0.99, 0.99, n).astype(dtype)


def _jax_loss(head, qc):
    if head == "ce":
        return lambda p, t: jdist.ce_loss(p, t)
    if head == "mol":
        return lambda p, t: jdist.mol_loss(p, t, qc)
    return lambda p, t: jdist.gauss_loss(p, t)


def _torch_loss(head, qc):
    if head == "ce":
        return lambda p, t: tdist.ce_loss(p, t)
    if head == "mol":
        return lambda p, t: tdist.mol_loss(p, t, qc)
    return lambda p, t: tdist.gauss_loss(p, t)


CASES = [("ce", 256), ("mol", 256), ("mol", 65536), ("gauss", 65536)]


def _both(head, qc, dtype):
    params, targets = _inputs(head, qc, dtype)
    jl, jg = jax.value_and_grad(_jax_loss(head, qc))(jnp.asarray(params), jnp.asarray(targets))
    p = torch.from_numpy(params).requires_grad_()
    tl = _torch_loss(head, qc)(p, torch.from_numpy(targets))
    (tg,) = torch.autograd.grad(tl, p)
    return float(jl), np.asarray(jg), float(tl.detach()), tg.numpy()


@pytest.mark.parametrize("head,qc", CASES)
def test_loss_and_grad_equal_jax_in_f64(head, qc):
    with jax.enable_x64(True):
        jl, jg, tl, tg = _both(head, qc, np.float64)
    assert tg.dtype == np.float64 and jg.dtype == np.float64
    assert abs(tl - jl) <= 1e-9 * max(abs(jl), 1.0), (tl, jl)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-9 * np.abs(jg).max())


@pytest.mark.parametrize("head,qc", CASES)
def test_loss_and_grad_equal_jax_in_f32(head, qc):
    jl, jg, tl, tg = _both(head, qc, np.float32)
    tol = 2e-3 if (head, qc) == ("mol", 65536) else 1e-5
    assert abs(tl - jl) <= 1e-5 * max(abs(jl), 1.0), (tl, jl)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=tol * np.abs(jg).max())


@pytest.mark.parametrize("qc", (256, 65536))
def test_mol_edge_bins_take_the_tails(qc):
    """A target in the lowest bin scores the mixture of log sigmoid(plus_in),
    one in the highest of log(1 - sigmoid(min_in)) (numpy in f64 here), and
    every value equals JAX's."""
    params, targets = _inputs("mol", qc, np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jdist.mol_log_probs(jnp.asarray(params), jnp.asarray(targets), qc))
    got = tdist.mol_log_probs(torch.from_numpy(params), torch.from_numpy(targets), qc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    logits, means, log_s = np.split(params, 3, axis=-1)
    inv_s = np.exp(-np.maximum(log_s, -7.0))
    log_w = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    centered = targets[..., None] - means
    low = np.log(np.exp(-np.logaddexp(0, -inv_s * (centered + 1 / qc)) + log_w).sum(-1))
    high = np.log(np.exp(-np.logaddexp(0, inv_s * (centered - 1 / qc)) + log_w).sum(-1))
    np.testing.assert_allclose(got[:, :4], low[:, :4], rtol=1e-10)
    np.testing.assert_allclose(got[:, 4:8], high[:, 4:8], rtol=1e-10)


def test_softplus_is_logaddexp_above_the_torch_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 21.0, 40.0], dtype=torch.float64, requires_grad=True)
    y = tdist.softplus(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    with jax.enable_x64(True):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x.detach().numpy())))
        want_g = np.asarray(jax.grad(lambda v: jax.nn.softplus(v).sum())(jnp.asarray(x.detach().numpy())))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-12)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_slug_and_json_equal_jax(name):
    path = f"configs/{name}.json"
    jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    assert tconfig.config_slug(tc, "wavenet") == jconfig.config_slug(jc, "wavenet")
    assert json.loads(tconfig.config_to_json(tc)) == json.loads(jconfig.config_to_json(jc))
    if isinstance(tc, tconfig.WavenetConfig):
        for kw in ({}, {"dropout_inputs": False, "dropout_all": True},
                   {"dropout_inputs": False, "dropout_rate": 0.2, "grad_clip": True,
                    "use_weight_norm": True}):
            t2, j2 = dataclasses.replace(tc, **kw), dataclasses.replace(jc, **kw)
            assert t2.resolved_dropout_rate == j2.resolved_dropout_rate
            assert tconfig.config_slug(t2, "wavenet", "x") == jconfig.config_slug(j2, "wavenet", "x")


@pytest.mark.parametrize("fl,dilation", ((1, 1), (3, 1), (3, 8), (3, 512)))
def test_conv1d_taps_equals_jax_conv(fl, dilation):
    """The training forward's matmul over stacked taps against the JAX
    package's causal conv1d (lax.conv_general_dilated), f32."""
    from nsynth_wavenet_tpu.ops import conv as jconv
    from nsynth_wavenet_tpu_torch.ops import conv as tconv

    rng = np.random.default_rng(fl * 1000 + dilation)
    w = rng.normal(0, 0.2, (fl, 6, 5)).astype(np.float32)
    b = rng.normal(0, 0.2, 5).astype(np.float32)
    x = rng.normal(0, 1.0, (2, 700, 6)).astype(np.float32)
    want = np.asarray(jconv.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                                   dilation=dilation))
    got = tconv.conv1d_taps({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                            torch.from_numpy(x), dilation=dilation).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
