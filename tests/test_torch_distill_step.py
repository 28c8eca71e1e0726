"""Three student distillation steps of the port (training/train_lib.py
make_pwn_train_step, training/optimizer.py MultiTransform) against the JAX
package's make_pwn_train_step, on the CPU, across a learning-rate boundary
(the schedule steps at 2): every metric, the params after Adam, the EMA, the
optimizer's count and moments; the frozen teacher deconv; remat_teacher; the
weight-norm data-dependent init against JAX's feed_forward(init=True); the
teacher deconv transplant in each sharing mode.

The tiny pair of tests/test_parallel_wavenet.py (TE_SMALL, ST_SMALL, f32),
the student's weights the JAX init times 3 so that the clip acts.  Both
sides take the same numpy draws each step (test_torch_distill_losses.py
patch_jax_draws; JAX's compiled step takes them as inputs).  JAX is compiled
without XLA's excess precision (test_torch_train_step.py _compile).

Tolerances, f32.  Metrics: |port - JAX| within METRIC_TOL x max(|JAX|, 1).
Params and EMA after 3 steps: ||port - JAX|| / ||JAX - init|| over each leaf
that moved (L2; Adam moves every element by about the learning rate whatever
its gradient's size, so a per-element maximum would read roundoff as a full
step).  Readings (CPU, the four cases): metrics 3.3e-7 to 1.9e-6, params
1.4e-6 to 6.1e-6, EMA 4.5e-6 to 2.7e-5.  The MoL bins at 65 536 levels
cancel 15 bits of a probability (test_torch_train_losses.py), but the KL
averages num_samples x L of them, so the logistic cases read no worse than
the Gauss ones.  Limits: METRIC_TOL 1e-4, UPDATE_TOL 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.models import parallel_wavenet as jpwn_lib
from nsynth_wavenet_tpu.ops import distributions as jdist
from nsynth_wavenet_tpu.parallel import mesh as jmesh
from nsynth_wavenet_tpu.training import train_lib as jtl
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models import parallel_wavenet as tpwn_lib
from nsynth_wavenet_tpu_torch.training import optimizer as topt
from nsynth_wavenet_tpu_torch.training import train_lib as ttl
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib
from test_torch_distill_losses import Pair, make_draws, speechlike, to_numpy
from test_torch_train_step import _compile

STEPS = 3
SCHEDULE = ((0, 1e-3), (2, 3e-4))
METRIC_TOL = 1e-4
UPDATE_TOL = 1e-3
METRICS = ("loss", "kl_loss", "power_loss", "new_x", "new_x_std", "new_x_abs", "new_x_abs_std",
           "mean_tot", "scale_tot", "log_scale_tot", "learning_rate")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_step(monkeypatch, jpwn, teacher_params, optimizer, state, batch, draws, mesh=None):
    """JAX's step compiled with the draws as inputs: the patched noise
    functions hand back the traced arguments.  Compiled for the placement
    of its arguments (a mesh's shardings when they carry them); ``mesh``
    goes to make_pwn_train_step (a seq axis constrains the wav's time)."""
    slot, order = {}, []

    def logistic(rng, shape):
        key = ("kl", "cl")[len(order)]
        order.append(key)
        assert tuple(slot[key].shape) == tuple(shape)
        return slot[key]

    monkeypatch.setattr(jpwn_lib.ParallelWavenet, "base_noise",
                        lambda self, rng, B, L: slot["base_x"])
    monkeypatch.setattr(jdist, "logistic_0_1", logistic)
    step_fn = jtl.make_pwn_train_step(jpwn, teacher_params, optimizer, mesh=mesh)

    def fn(state, wav, wav_rand, draws):
        slot.clear()
        slot.update(draws)
        order.clear()
        return step_fn(state, wav, wav_rand, jax.random.PRNGKey(2))

    return _compile(fn, state, *batch, draws)


def _update_err(init, want, got, moved):
    return max(float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k] - init[k]))
               for k in moved)


def _port_state(js):
    """JAX's distillation state as the port's: params, EMA, step, and the
    Adam count and moments of the trained leaves (optax's masked moments
    flatten to them in the port's leaf order)."""
    adam = next(x for x in js["opt_state"].inner_states["train"].inner_state if hasattr(x, "mu"))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    moments = lambda tree: [torch.from_numpy(np.array(a, np.float32))  # noqa: E731
                            for a in jax.tree_util.tree_leaves(host(tree))]
    return {"params": weights.from_jax_params(host(js["params"]), device="cpu"),
            "ema": weights.from_jax_params(host(js["ema"]), device="cpu"),
            "opt_state": {"count": int(adam.count), "mu": moments(adam.mu),
                          "nu": moments(adam.nu)},
            "step": int(js["step"])}


def _run_both(monkeypatch, loss_type, B=2, jax_mesh=None, **kw):
    """The port's and JAX's steps on the same B-row batches and draws; JAX's
    under ``jax_mesh`` when given (the state sharded by its specs, the
    teacher likewise, the batches and draws over its data axis)."""
    pair = Pair(loss_type, dtype=np.float32, param_scale=3.0, lr_schedule=SCHEDULE, B=B, **kw)
    jp, tp = pair.np_params, pair.tparams
    if pair.tcfg.use_teacher_deconv:
        jp = jpwn_lib.transplant_teacher_deconv(jp, pair.np_teacher)
        tp = tpwn_lib.transplant_teacher_deconv(tp, pair.tte)
    jopt = jtl.make_student_optimizer(pair.jcfg, jp)
    js = jtl.make_train_state(jp, jopt)
    toptim = ttl.make_student_optimizer(pair.tcfg, tp)
    ts = ttl.make_train_state(tp, toptim)
    tstep = ttl.make_pwn_train_step(pair.tpwn, pair.tte, toptim)
    rng = np.random.default_rng(7)
    batches = [(pair.wav, pair.wav_rand)] + [
        (speechlike(B, pair.jcfg.wave_length, rng), speechlike(B, pair.jcfg.wave_length, rng))
        for _ in range(STEPS - 1)]
    all_draws = [pair.draws] + [make_draws(pair.jcfg, B, pair.L, rng)
                                for _ in range(STEPS - 1)]
    jteacher = jax.tree_util.tree_map(jnp.asarray, pair.np_teacher)
    jinputs = list(zip(batches, all_draws))
    if jax_mesh is not None:
        js = jmesh.shard_train_state(js, jax_mesh)
        jteacher = jmesh.shard_params(jteacher, jax_mesh)
        rows = jmesh.batch_sharding(jax_mesh)
        jinputs = jax.device_put(jinputs, rows)
    jstep = _jax_step(monkeypatch, pair.jpwn, jteacher, jopt, js, *jinputs[0], mesh=jax_mesh)
    out = {"metrics": [], "pair": pair, "jstate0": js, "jstates": [], "batches": batches,
           "draws": all_draws, "tstep": tstep}
    # the first step's gradient, and the norm the clip sees
    aux, grads = ttl.grads_of(
        lambda p: ttl.student_loss(pair.tpwn, pair.tte, p, _tbatch(pair.tpwn, *batches[0]),
                                   pair.tdraws()), ts["params"])
    out["grads"] = grads
    init = to_numpy(ts["params"])
    for ((wav, wav_rand), draws), (jbatch, jdraws) in zip(zip(batches, all_draws), jinputs):
        js, jm = jstep(js, *jbatch, jdraws)
        out["jstates"].append(js)
        ts, tm = tstep(ts, torch.from_numpy(wav), torch.from_numpy(wav_rand), None,
                       draws={k: torch.from_numpy(v) for k, v in draws.items()})
        out["metrics"].append(({k: float(v) for k, v in jm.items()},
                               {k: float(v) for k, v in tm.items()}))
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, js["params"]))
    moved = [k for k in jflat if np.any(jflat[k] != init[k])]
    out["moved"] = moved
    out["params_err"] = _update_err(init, jflat, to_numpy(ts["params"]), moved)
    out["ema_err"] = _update_err(
        init, weights.flatten(jax.tree_util.tree_map(np.asarray, js["ema"])),
        to_numpy(ts["ema"]), moved)
    out["jstate"], out["tstate"], out["init"] = js, ts, init
    return out


def _tbatch(pwn, wav, wav_rand):
    from nsynth_wavenet_tpu_torch.ops import stft as tstft

    w, wr = torch.from_numpy(wav), torch.from_numpy(wav_rand)
    return {"mel": tstft.melspectrogram(w), "wav": w, "mel_rand": tstft.melspectrogram(wr)}


CASES = [
    ("logistic", dict(power_loss_factor=1.0, contrastive_loss_factor=0.3, use_share_deconv=True,
                      grad_clip=False)),
    ("logistic", dict(power_loss_factor=1.0, contrastive_loss_factor=0.3,
                      use_teacher_deconv=True, grad_clip=True)),
    ("gauss", dict(power_loss_factor=1.0, grad_clip=True)),
    ("gauss", dict(power_loss_factor=1.0, use_teacher_deconv=True, grad_clip=False)),
]


@pytest.mark.parametrize("loss_type,kw", CASES,
                         ids=["logistic-cl-share", "logistic-cl-teacher_deconv-clip",
                              "gauss-clip", "gauss-teacher_deconv"])
def test_distill_steps_equal_jax(monkeypatch, loss_type, kw):
    out = _run_both(monkeypatch, loss_type, **kw)
    pair, ts, js = out["pair"], out["tstate"], out["jstate"]
    keys = METRICS + (("H_Ps", "H_Ps_Pt") if loss_type == "logistic" else ()) + \
        (("contrastive_loss",) if kw.get("contrastive_loss_factor") else ())
    worst = 0.0
    for jm, tm in out["metrics"]:
        assert set(jm) == set(tm) == set(keys), (sorted(jm), sorted(tm))
        for k in keys:
            err = abs(tm[k] - jm[k]) / max(abs(jm[k]), 1.0)
            worst = max(worst, err)
            assert err <= METRIC_TOL, (k, jm[k], tm[k])
    assert [tm["learning_rate"] for _, tm in out["metrics"]] == pytest.approx([1e-3, 1e-3, 3e-4])
    print(loss_type, kw, {"metrics": worst, "params": out["params_err"], "ema": out["ema_err"]})
    assert out["params_err"] <= UPDATE_TOL
    assert out["ema_err"] <= UPDATE_TOL
    assert ts["step"] == int(js["step"]) == STEPS
    labels = tree_lib.leaves(ttl.student_param_labels(pair.tcfg, ts["params"]))
    n_trained = labels.count("train")
    assert ts["opt_state"]["count"] == STEPS and len(ts["opt_state"]["mu"]) == n_trained
    grads = tree_lib.leaves(out["grads"])
    trained = [g for g, label in zip(grads, labels) if label == "train"]
    if pair.tcfg.use_teacher_deconv:
        # the frozen stack: bit-equal to the teacher's after every step, on
        # both sides, though its gradient is not zero and would lengthen the
        # clip's norm
        assert n_trained < len(labels)
        for tree in (weights.flatten(ts["params"]["deconv_share"]),):
            for k, v in tree.items():
                want = weights.flatten(pair.tte["deconv"])[k]
                assert torch.equal(v, want), k
        jshare = weights.flatten(jax.tree_util.tree_map(np.asarray, js["params"]["deconv_share"]))
        for k, v in jshare.items():
            np.testing.assert_array_equal(v, weights.flatten(pair.np_teacher["deconv"])[k])
        assert float(topt.global_norm(grads)) > float(topt.global_norm(trained))
        assert not any("deconv_share" in k for k in out["moved"])
    else:
        assert n_trained == len(labels)
    if kw["grad_clip"]:
        assert float(topt.global_norm(trained)) > 1.0  # the clip acts


def test_remat_teacher_equals_no_remat():
    pair = Pair(dtype=np.float32, power_loss_factor=1.0, contrastive_loss_factor=0.3)
    remat = tpwn_lib.ParallelWavenet(dataclasses.replace(pair.tcfg, remat_teacher=True),
                                     pair.tteacher)
    batch = _tbatch(pair.tpwn, pair.wav, pair.wav_rand)

    def run(pwn):
        return ttl.grads_of(lambda p: ttl.student_loss(pwn, pair.tte, p, batch, pair.tdraws()),
                            pair.tparams)

    (a0, g0), (a1, g1) = run(pair.tpwn), run(remat)
    assert a0.keys() == a1.keys() and all(torch.equal(a0[k], a1[k]) for k in a0)
    for x, y in zip(tree_lib.leaves(g0), tree_lib.leaves(g1)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("manual_final_init", (True, False))
def test_weight_norm_data_dep_init_equals_jax(manual_final_init):
    pair = Pair(dtype=np.float32, use_weight_norm=True, manual_final_init=manual_final_init)
    base = pair.draws["base_x"]
    jff, jnew = pair.jpwn.feed_forward(pair.np_params, {"mel": pair.mel, "base_x": base},
                                       init=True)
    tff, tnew = pair.tpwn.data_dep_init(pair.tparams, torch.from_numpy(pair.mel),
                                        base_x=torch.from_numpy(base))
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        want = np.asarray(jff[k])
        np.testing.assert_allclose(tff[k].numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)
    want, got = weights.flatten(jax.tree_util.tree_map(np.asarray, jnew)), to_numpy(tnew)
    assert want.keys() == got.keys()
    for k in want:
        # b = -mean * scale is roundoff where a layer's mean is 0: a floor of 1e-2
        scale = max(float(np.abs(want[k]).max()), 1e-2)
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * scale, k
    # the heads keep their manual init under manual_final_init, else move
    head_b = got["['flows'][0]['out2_scale']['b']"]
    assert (float(head_b[0]) == pytest.approx(-0.3)) == manual_final_init
    assert not np.array_equal(got["['flows'][0]['layers'][0]['dilated']['g']"],
                              to_numpy(pair.tparams)["['flows'][0]['layers'][0]['dilated']['g']"])
    with pytest.raises(ValueError, match="weight norm"):
        Pair(dtype=np.float32).tpwn.data_dep_init(pair.tparams, torch.from_numpy(pair.mel))


@pytest.mark.parametrize("mode", ("use_share_deconv", "use_teacher_deconv", "separate"))
def test_transplant_teacher_deconv_equals_jax(mode):
    kw = {} if mode == "separate" else {mode: True}
    pair = Pair(dtype=np.float32, **kw)
    want = weights.flatten(jax.tree_util.tree_map(
        np.asarray, jpwn_lib.transplant_teacher_deconv(pair.np_params, pair.np_teacher)))
    out = tpwn_lib.transplant_teacher_deconv(pair.tparams, pair.tte)
    got = weights.flatten(weights.to_jax_params(out))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # copies: a step on one stack moves neither the teacher nor another flow
    leaves = tree_lib.leaves(out.get("deconv_share") or out["flows"][0]["deconv"])
    before = [t.clone() for t in tree_lib.leaves(pair.tte["deconv"])]
    leaves[0].add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_lib.leaves(pair.tte["deconv"])))
    if mode == "separate":
        assert not torch.equal(tree_lib.leaves(out["flows"][1]["deconv"])[0], leaves[0])
