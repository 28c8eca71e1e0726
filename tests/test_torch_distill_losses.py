"""The port's distillation losses (models/parallel_wavenet.py) and its
power-loss STFT (ops/stft.py) against the JAX package's, on the CPU, with the
tiny teacher / student pair of tests/test_parallel_wavenet.py (TE_SMALL,
ST_SMALL) and weights carried across through weights.py.

Both sides get the same numpy draws: the port takes them as tensors, JAX
through inputs['base_x'] and a patched ``dist.logistic_0_1`` (the patch
lives here; the JAX package does not change).

Tolerances.  Losses and their gradients to the student's params are held in
float64 on both sides, with JAX's DFT tables in f64 too (``_f64_dft``; the
JAX package rounds them to f32).  The teacher's head outputs are rounded to
f32 on both sides (the reference's ``out.astype(float32)``), and the heads'
exp of those f32 values is an f32 exp, whose last bit differs between XLA's
and torch's: 6e-8 of a scale where it does.  That, not the f64 arithmetic,
bounds the KL terms.  Readings (CPU): the STFT and power-loss cases agree to
1e-12 in the losses and 3e-11 of a gradient leaf's max; the KL cases to
1.2e-9 and 9.1e-8.  Limits: LOSS_TOL 1e-7 relative, GRAD_TOL 1e-6 of a
leaf's max.  The requantising ``clip=True`` path runs in f32 (JAX's teacher
convolution refuses the f32 requantised sample against f64 weights): its
loss, whose MoL bins at 65 536 levels cancel 15 bits, within F32_LOSS_TOL
1e-4, its gradient (the entropy term's alone) within F32_GRAD_TOL 1e-5.  In
f32 the STFT helpers alone part by 1e-6 of the spectrum's max: limit 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models import parallel_wavenet as jpwn_lib
from nsynth_wavenet_tpu.models import wavenet as jwavenet
from nsynth_wavenet_tpu.ops import distributions as jdist
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models import parallel_wavenet as tpwn_lib
from nsynth_wavenet_tpu_torch.models import wavenet as twavenet
from nsynth_wavenet_tpu_torch.ops import stft as tstft
from nsynth_wavenet_tpu_torch.training import train_lib as ttl
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib
from test_parallel_wavenet import ST_SMALL, TE_SMALL

LOSS_TOL, GRAD_TOL = 1e-7, 1e-6
F32_LOSS_TOL, F32_GRAD_TOL, F32_STFT_TOL = 1e-4, 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def _f64_dft(monkeypatch):
    """JAX's DFT matmul with float64 tables, under x64."""

    def tables(n_fft):
        n = np.arange(n_fft)[:, None]
        k = np.arange(n_fft // 2 + 1)[None, :]
        ang = 2.0 * np.pi * n * k / n_fft
        return np.cos(ang), -np.sin(ang)

    monkeypatch.setattr(jstft, "_dft_matrices", tables)
    with jax.enable_x64(True):
        yield


def patch_jax_draws(monkeypatch, draws):
    """JAX's base noise and logistic samples replaced by ``draws``: the base
    noise by draws['base_x'], the k-th logistic_0_1 call after it by the k-th
    of draws['kl'], draws['cl'] (the reference's order)."""
    seq = [draws[k] for k in ("kl", "cl") if k in draws]
    calls = []

    def logistic(rng, shape):
        out = seq[len(calls) % len(seq)]
        calls.append(tuple(shape))
        assert tuple(out.shape) == tuple(shape), (out.shape, shape)
        return out

    monkeypatch.setattr(jpwn_lib.ParallelWavenet, "base_noise",
                        lambda self, rng, B, L: draws["base_x"])
    monkeypatch.setattr(jdist, "logistic_0_1", logistic)
    return calls


class Pair:
    """The tiny teacher and student on both sides, the same weights, batch
    and draws; ``dtype`` float32 or float64 (the port's params and inputs
    are cast to it, JAX's likewise; call under jax.enable_x64 for f64)."""

    def __init__(self, loss_type="logistic", dtype=np.float64, teacher_kw=None, seed=0,
                 B=2, param_scale=1.0, **student_kw):
        head = "mol" if loss_type == "logistic" else "gauss"
        te_kw = dict(TE_SMALL, loss_type=head, use_as_teacher=True, **(teacher_kw or {}))
        st_kw = dict(ST_SMALL, loss_type=loss_type, **student_kw)
        self.jcfg, self.tcfg = (jconfig.ParallelWavenetConfig(**st_kw),
                                tconfig.ParallelWavenetConfig(**st_kw))
        self.jteacher = jwavenet.Wavenet(jconfig.WavenetConfig(**te_kw))
        self.tteacher = twavenet.Wavenet(tconfig.WavenetConfig(**te_kw))
        self.jpwn = jpwn_lib.ParallelWavenet(self.jcfg, self.jteacher)
        self.tpwn = tpwn_lib.ParallelWavenet(self.tcfg, self.tteacher)
        self.dtype = dtype
        cast = lambda a: np.asarray(a, dtype)  # noqa: E731
        jte = jax.tree_util.tree_map(cast, self.jteacher.init_params(jax.random.PRNGKey(10)))
        jst = jax.tree_util.tree_map(lambda a: cast(a) * param_scale,
                                     self.jpwn.init_params(jax.random.PRNGKey(seed)))
        self.np_teacher, self.np_params = jte, jst
        self.tte = to_port(jte, dtype)
        self.tparams = to_port(jst, dtype)
        rng = np.random.default_rng(100 + seed)
        self.wav = speechlike(B, self.jcfg.wave_length, rng)
        self.wav_rand = speechlike(B, self.jcfg.wave_length, rng)
        self.mel = jstft.melspectrogram_np(self.wav).astype(dtype)
        self.mel_rand = jstft.melspectrogram_np(self.wav_rand).astype(dtype)
        self.L = self.jpwn.sample_length(self.mel.shape[1])
        self.draws = make_draws(self.jcfg, B, self.L, rng, dtype)

    def jbatch(self):
        return {"mel": jnp.asarray(self.mel), "wav": jnp.asarray(self.wav.astype(self.dtype)),
                "mel_rand": jnp.asarray(self.mel_rand)}

    def tbatch(self):
        return {"mel": torch.from_numpy(self.mel),
                "wav": torch.from_numpy(self.wav.astype(self.dtype)),
                "mel_rand": torch.from_numpy(self.mel_rand)}

    def tdraws(self):
        return {k: torch.from_numpy(v) for k, v in self.draws.items()}

    def jax_value_and_grad(self, fn):
        """value_and_grad over the student's params of fn(ff, pwn) -> dict
        with 'loss' (ff: the forward on the shared base noise plus the batch)."""

        def loss_fn(p):
            ff, _ = self.jpwn.feed_forward(p, {"mel": jnp.asarray(self.mel),
                                              "base_x": jnp.asarray(self.draws["base_x"])})
            ff.update(self.jbatch())
            out = fn(ff)
            return out["loss"], out

        (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(self.np_params)
        return ({k: np.asarray(v) for k, v in aux.items()},
                weights.flatten(jax.tree_util.tree_map(np.asarray, grads)))

    def port_value_and_grad(self, fn, pwn=None):
        pwn = pwn or self.tpwn

        def loss_fn(p):
            ff, _ = pwn.feed_forward_train(p, {"mel": torch.from_numpy(self.mel),
                                               "base_x": self.tdraws()["base_x"]})
            ff.update(self.tbatch())
            return fn(ff)

        aux, grads = ttl.grads_of(loss_fn, self.tparams)
        return {k: v.numpy() for k, v in aux.items()}, to_numpy(grads)


def to_port(tree, dtype):
    """A JAX tree as the port's tree of CPU tensors, in ``dtype`` (not
    through weights.from_jax_params, which holds f32)."""
    return weights.from_jax_params(tree, device="cpu") if dtype == np.float32 else \
        tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a, dtype)),
                          jax.tree_util.tree_map(np.asarray, tree))


def to_numpy(tree) -> dict:
    """The port's tree as {key path: numpy array} in its own dtype."""
    return {k: v.detach().numpy().copy() for k, v in weights.flatten(tree).items()}


def speechlike(B, L, rng):
    t = np.arange(L) / 16000.0
    f0 = rng.uniform(120, 260, (B, 1))
    w = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(4 * np.pi * f0 * t + 1.0)
    return np.clip(w + 0.02 * rng.standard_normal((B, L)), -0.99, 0.99).astype(np.float32)


def make_draws(cfg, B, L, rng, dtype=np.float32):
    """The step's draws as numpy: base noise (logistic or normal), then the
    KL's and the contrastive term's logistic samples."""
    if cfg.loss_type == "logistic":
        draws = {"base_x": rng.logistic(size=(B, L))}
        draws["kl"] = rng.logistic(size=(B, cfg.num_samples, L))
        if cfg.contrastive_loss_factor > 0.0:
            draws["cl"] = rng.logistic(size=(B, cfg.num_samples, L))
    else:
        draws = {"base_x": rng.standard_normal((B, L))}
    return {k: v.astype(dtype) for k, v in draws.items()}


def leaf_err(want: dict, got: dict) -> float:
    """Largest max |got - want| over the leaves, each as a share of the
    leaf's own max |want| (the absolute error where that is 0)."""
    assert want.keys() == got.keys()
    errs = []
    for k, w in want.items():
        scale = float(np.abs(w).max())
        e = float(np.abs(got[k] - w).max())
        errs.append(e / scale if scale > 0 else e)
    return max(errs)


def _check_losses(jaux, taux, keys, tol=LOSS_TOL):
    for k in keys:
        j, t = float(jaux[k]), float(taux[k])
        assert abs(t - j) <= tol * max(abs(j), 1.0), (k, j, t)


# ---- the STFT helpers -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_stft_helpers_equal_jax(request, dtype):
    if dtype == "float64":
        request.getfixturevalue("_f64_dft")
    rng = np.random.default_rng(3)
    y = (0.3 * rng.standard_normal((2, 3, 1400))).astype(dtype)
    tol = LOSS_TOL if dtype == "float64" else F32_STFT_TOL
    t = torch.from_numpy(y)
    for jf, tf in ((jstft.stft_pad_end, tstft.stft_pad_end), (jstft.stft_center, tstft.stft_center)):
        want, got = np.asarray(jf(y)), tf(t).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    spec = np.abs(np.asarray(jstft.stft_pad_end(y)))
    want = np.asarray(jstft.melspec_from_spec(spec))
    np.testing.assert_allclose(tstft.melspec_from_spec(torch.from_numpy(spec)).numpy(), want,
                               rtol=0, atol=tol * np.abs(want).max())
    for jf, tf in ((jstft.melspectrogram2, tstft.melspectrogram2),
                   (jstft.melspectrogram, tstft.melspectrogram)):
        np.testing.assert_allclose(tf(t[0]).numpy(), np.asarray(jf(y[0])), rtol=0, atol=tol)
    db = np.linspace(-200, 30, 50).astype(dtype)
    np.testing.assert_allclose(tstft.db_normalize(torch.from_numpy(db)).numpy(),
                               np.asarray(jstft.db_normalize(db)), rtol=0, atol=1e-6)
    amp = np.linspace(0, 2, 50).astype(dtype)
    np.testing.assert_allclose(tstft.amp_to_db(torch.from_numpy(amp)).numpy(),
                               np.asarray(jstft.amp_to_db(amp)), rtol=1e-6, atol=1e-5)
    assert tstft.PRIORITY_FREQ == jstft.PRIORITY_FREQ == 384
    assert [tstft.num_mel_frames(n) for n in (199, 200, 7680)] == \
        [jstft.num_mel_frames(n) for n in (199, 200, 7680)]


def test_stft_pad_end_gradient_equals_jax(_f64_dft):
    rng = np.random.default_rng(4)
    y = rng.standard_normal((2, 1300))
    w = rng.standard_normal((7, 1025))

    def jloss(v):
        return jnp.sum(jnp.abs(jstft.stft_pad_end(v)) * w)

    want = np.asarray(jax.grad(jloss)(y))
    t = torch.from_numpy(y).requires_grad_()
    (got,) = torch.autograd.grad(torch.sum(torch.abs(tstft.stft_pad_end(t)) * torch.from_numpy(w)),
                                 t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOSS_TOL * np.abs(want).max())


# ---- power loss -----------------------------------------------------------------

FEATURES = [dict(spec_enhance_factor=f) for f in (0, 1, 2, 3)] + [
    dict(spec_enhance_factor=3, use_l1_loss=True),
    dict(spec_enhance_factor=1, use_mel=True),
    dict(spec_enhance_factor=0, use_mel=True, use_l1_loss=True),
    dict(spec_enhance_factor=1, use_priority_freq=False),
]


@pytest.mark.parametrize("kw", FEATURES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_stft_feat_and_power_loss_equal_jax(_f64_dft, kw):
    pair = Pair(power_loss_factor=1.0, **kw)
    assert pair.tcfg.effective_use_priority_freq == pair.jcfg.effective_use_priority_freq
    spec = jstft.stft_pad_end(pair.wav.astype(np.float64))
    want = np.asarray(pair.jpwn.stft_feat(spec))
    got = pair.tpwn.stft_feat(torch.from_numpy(np.array(spec))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL * np.abs(want).max())
    jaux, jg = pair.jax_value_and_grad(lambda ff: {"loss": pair.jpwn.power_loss(ff)["power_loss"]})
    taux, tg = pair.port_value_and_grad(lambda ff: {"loss": pair.tpwn.power_loss(ff)["power_loss"]})
    _check_losses(jaux, taux, ["loss"])
    assert leaf_err(jg, tg) <= GRAD_TOL


def test_power_loss_with_norm_stats_equals_jax(_f64_dft):
    pair = Pair(power_loss_factor=1.0, norm_feat=True, spec_enhance_factor=0)
    rng = np.random.default_rng(5)
    stats = (rng.normal(0, 1, 1025).astype(np.float32), rng.uniform(0.5, 2, 1025).astype(np.float32))
    jaux, jg = pair.jax_value_and_grad(
        lambda ff: {"loss": pair.jpwn.power_loss(ff, stats)["power_loss"]})
    taux, tg = pair.port_value_and_grad(
        lambda ff: {"loss": pair.tpwn.power_loss(ff, stats)["power_loss"]})
    _check_losses(jaux, taux, ["loss"])
    assert leaf_err(jg, tg) <= GRAD_TOL
    # the statistics act
    plain = pair.port_value_and_grad(lambda ff: {"loss": pair.tpwn.power_loss(ff)["power_loss"]})
    assert abs(float(plain[0]["loss"]) - float(taux["loss"])) > 1e-3


# ---- the KL terms ---------------------------------------------------------------


@pytest.mark.parametrize("clip", (False, True))
def test_kl_logistic_and_grad_equal_jax(request, monkeypatch, clip):
    if not clip:
        request.getfixturevalue("_f64_dft")
    pair = Pair(clip=clip, dtype=np.float32 if clip else np.float64)
    tol = (F32_LOSS_TOL, F32_GRAD_TOL) if clip else (LOSS_TOL, GRAD_TOL)
    patch_jax_draws(monkeypatch, pair.draws)
    keys = ("loss", "kl_loss", "H_Ps", "H_Ps_Pt")

    def jfn(ff):
        out = pair.jpwn.kl_loss_logistic(pair.np_teacher, ff, None, pair.jcfg.num_samples)
        return dict(out, loss=out["kl_loss"])

    def tfn(ff):
        out = pair.tpwn.kl_loss_logistic(pair.tte, ff, pair.tdraws()["kl"])
        return dict(out, loss=out["kl_loss"])

    jaux, jg = pair.jax_value_and_grad(jfn)
    taux, tg = pair.port_value_and_grad(tfn)
    _check_losses(jaux, taux, keys, tol[0])
    assert leaf_err(jg, tg) <= tol[1]
    # the teacher's params stay frozen: nothing asked them for a gradient
    assert not any(p.requires_grad or p.grad is not None for p in tree_lib.leaves(pair.tte))
    if clip:
        # the requantised sample has no gradient, so the KL reaches the
        # student only through its entropy term, as in the reference
        _, g_ent = pair.port_value_and_grad(lambda ff: {"loss": -pair.tpwn._entropy(ff)})
        assert leaf_err(g_ent, tg) == 0.0


@pytest.mark.parametrize("floor", (0.0, 1.0))
def test_kl_gauss_and_grad_equal_jax(_f64_dft, floor):
    pair = Pair("gauss", kl_sigma_floor=floor)
    jaux, jg = pair.jax_value_and_grad(
        lambda ff: {"loss": pair.jpwn.kl_loss_gauss(pair.np_teacher, ff)["kl_loss"]})
    taux, tg = pair.port_value_and_grad(
        lambda ff: {"loss": pair.tpwn.kl_loss_gauss(pair.tte, ff)["kl_loss"]})
    _check_losses(jaux, taux, ["loss"])
    assert leaf_err(jg, tg) <= GRAD_TOL
    if floor:
        # the floor acts: some of this teacher's sigmas lie below 1
        unfloored = tpwn_lib.ParallelWavenet(dataclasses.replace(pair.tcfg, kl_sigma_floor=0.0),
                                             pair.tteacher)
        plain = pair.port_value_and_grad(
            lambda ff: {"loss": unfloored.kl_loss_gauss(pair.tte, ff)["kl_loss"]})[0]
        assert abs(float(plain["loss"]) - float(taux["loss"])) > 1e-6


def test_fused_kl_and_contrastive_equal_separate_and_jax(_f64_dft, monkeypatch):
    pair = Pair(contrastive_loss_factor=0.3)
    d = pair.tdraws()
    keys = ("kl_loss", "H_Ps", "H_Ps_Pt", "contrastive_loss")

    def fused(ff):
        out = pair.tpwn.kl_and_contrastive_fused(pair.tte, ff, d["kl"], d["cl"])
        return dict(out, loss=out["kl_loss"] + 0.3 * out["contrastive_loss"])

    def separate(ff):
        out = pair.tpwn.kl_loss_logistic(pair.tte, ff, d["kl"])
        out.update(pair.tpwn.contrastive_loss(pair.tte, ff, d["cl"]))
        return dict(out, loss=out["kl_loss"] + 0.3 * out["contrastive_loss"])

    faux, fg = pair.port_value_and_grad(fused)
    saux, sg = pair.port_value_and_grad(separate)
    _check_losses(saux, faux, keys + ("loss",))
    assert leaf_err(sg, fg) <= GRAD_TOL
    calls = patch_jax_draws(monkeypatch, pair.draws)

    def jfused(ff):
        out = pair.jpwn.kl_and_contrastive_fused(pair.np_teacher, ff, None, None,
                                                 pair.jcfg.num_samples)
        return dict(out, loss=out["kl_loss"] + 0.3 * out["contrastive_loss"])

    jaux, jg = pair.jax_value_and_grad(jfused)
    assert len(calls) == 2
    _check_losses(jaux, faux, keys + ("loss",))
    assert leaf_err(jg, fg) <= GRAD_TOL
    # the mismatched mel makes the contrastive term differ from minus the KL
    assert abs(float(faux["contrastive_loss"]) + float(faux["kl_loss"])) > 1e-3


@pytest.mark.parametrize("loss_type", ("logistic", "gauss"))
def test_calculate_loss_equals_jax(_f64_dft, monkeypatch, loss_type):
    kw = dict(power_loss_factor=1.0, use_share_deconv=True)
    if loss_type == "logistic":
        kw["contrastive_loss_factor"] = 0.3
    pair = Pair(loss_type, **kw)
    patch_jax_draws(monkeypatch, pair.draws)
    jaux, jg = pair.jax_value_and_grad(
        lambda ff: pair.jpwn.calculate_loss(pair.np_teacher, ff, jax.random.PRNGKey(0)))
    taux, tg = pair.port_value_and_grad(
        lambda ff: pair.tpwn.calculate_loss(pair.tte, ff, pair.tdraws()))
    assert jaux.keys() == taux.keys()
    _check_losses(jaux, taux, jaux.keys())
    assert leaf_err(jg, tg) <= GRAD_TOL


# ---- pairing and config ---------------------------------------------------------


def test_pairing_and_priority_band():
    te = twavenet.Wavenet(tconfig.WavenetConfig(**dict(TE_SMALL, loss_type="gauss")))
    with pytest.raises(ValueError, match="cannot teach"):
        tpwn_lib.ParallelWavenet(tconfig.ParallelWavenetConfig(**ST_SMALL), te)
    te = twavenet.Wavenet(tconfig.WavenetConfig(**dict(TE_SMALL, loss_type="mol",
                                                       upsample_act="tanh")))
    with pytest.raises(ValueError, match="upsample_act"):
        tpwn_lib.ParallelWavenet(tconfig.ParallelWavenetConfig(**ST_SMALL), te)
    for use_mel in (False, True):
        for pf in (False, True):
            kw = dict(ST_SMALL, use_mel=use_mel, use_priority_freq=pf)
            assert tconfig.ParallelWavenetConfig(**kw).effective_use_priority_freq == \
                jconfig.ParallelWavenetConfig(**kw).effective_use_priority_freq
