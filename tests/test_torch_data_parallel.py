"""Data parallelism of both training steps, alone (n_data 2, in 2 gloo
processes) and with channel tensor parallelism (n_data 2 x n_model 2, in 4),
against the JAX package's steps under its mesh of the same shape (its 8
virtual CPU devices) and the port's one-process steps, on the same global
batches and draws (tests/torch_rank_worker.py jobs ``teacher`` and
``student``).

What the one-process comparisons cannot hold: the gradient averaged over
the data group before the clip, each rank's rows of the global batch's
draws (the teacher's dropout masks through mesh.draw, the student's base
noise and logistic samples), and the metrics reduced over the data group,
the two std metrics as the global batch's.

Teacher: the weight-normed, clipped Gauss config of
tests/test_torch_tensor_parallel.py with dropout after the start conv and
every layer (dropout_all), 3 steps at global batch 4, each data rank on 2
rows.  Both sides take one mask for the k-th dropout call of a forward:
a whole-batch uniform array made with numpy, read by JAX's patched
_dropout and handed by the port's mesh.uniform to mesh.draw, which takes
the rank's rows.  Limits those of tests/test_torch_train_step.py: the first
gradient per leaf within 1e-4 of its max, the params and EMA after 3 steps
within 1e-3 by the L2 of the update, the losses within 1e-5.

Student: the two cases of tests/test_torch_tensor_parallel.py (a
weight-normed Gauss student, a logistic one with the contrastive term and
the shared deconv; the frozen teacher weight-normed) at global batch 4,
the global batch's draws handed to the step, which takes the rank's rows.
Limits those of tests/test_torch_distill_step.py: every metric of 3
free-running steps within METRIC_TOL of JAX's; the params and EMA after
the first step within UPDATE_TOL of JAX's, and after every step from a
shared state within UPDATE_TOL of the port's one process; in f64 on both
sides, the metrics and the params and EMA after 3 free-running steps at
the same limits (the f32 free-running params after 3 steps are a reading:
see the test's docstring)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.models import wavenet as jwavenet
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu.parallel import mesh as jmesh
from nsynth_wavenet_tpu.training import optimizer as jopt
from nsynth_wavenet_tpu.training import train_lib as jtl
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models import wavenet as twavenet
from nsynth_wavenet_tpu_torch.parallel import mesh as tmesh
from nsynth_wavenet_tpu_torch.training import optimizer as topt
from nsynth_wavenet_tpu_torch.training import train_lib as ttl
from test_torch_distill_losses import Pair, to_numpy
from test_torch_distill_step import METRIC_TOL, SCHEDULE, UPDATE_TOL, _jax_step, _port_state
from test_torch_distill_step import _run_both as distill_run_both
from test_torch_distill_step import _update_err as distill_update_err
from test_torch_multiprocess import run_job
from test_torch_tensor_parallel import CASES
from test_torch_train_step import TOL, _compile, _configs, _flat, _leaf_err, _tflat, _update_err
from test_torch_train_step import _wavs

MESHES = [(2, 1), (2, 2)]
MESH_IDS = ["data2", "data2-model2"]
B = 4
STEPS = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Uniforms:
    """A whole-batch uniform array for the k-th dropout call of a forward
    (k counted modulo the calls of one forward), made with numpy."""

    def __init__(self, per_forward):
        self.per_forward, self.tables, self.calls = per_forward, {}, 0

    def __call__(self, shape):
        k = self.calls % self.per_forward
        self.calls += 1
        if k not in self.tables:
            self.tables[k] = np.random.default_rng(1000 + k).random(tuple(shape))
        assert self.tables[k].shape == tuple(shape), (self.tables[k].shape, shape)
        return self.tables[k]


def _jax_teacher(jm, jp, wavs, uniforms, mesh):
    """JAX's first gradient and STEPS steps under ``mesh``, the dropout
    masks from ``uniforms``: ((loss, grads), final state, step losses)."""

    def dropout(rng, x, rate):
        return jnp.where(uniforms(x.shape) < 1.0 - rate, x / (1.0 - rate), 0.0)

    rows = jmesh.batch_sharding(mesh)
    jwavs = [jax.device_put(w, rows) for w in wavs]
    key = jax.random.PRNGKey(0)

    def loss_fn(p, wav):
        return jm.forward_loss(p, wav, jstft.melspectrogram(wav), dropout_rng=key)["loss"]

    saved = jwavenet._dropout
    jwavenet._dropout = dropout
    try:
        ps = jmesh.shard_params(jp, mesh)
        grad_fn = jax.value_and_grad(loss_fn)
        first = _compile(grad_fn, ps, jwavs[0])(ps, jwavs[0])
        opt = jopt.make_optimizer(jm.cfg.lr_schedule, grad_clip=jm.cfg.grad_clip)
        state = jmesh.shard_train_state(jtl.make_train_state(jp, opt), mesh)
        step_fn = _compile(jtl.make_wavenet_train_step(jm, opt, mesh=mesh), state, jwavs[0], key)
    finally:
        jwavenet._dropout = saved
    losses = []
    for w in jwavs:
        state, m = step_fn(state, w, key)
        losses.append(float(m["loss"]))
    return first, state, losses


@pytest.mark.parametrize("n_data,n_model", MESHES, ids=MESH_IDS)
def test_data_parallel_teacher_step_equals_jax_and_one_process(monkeypatch, tmp_path, n_data,
                                                               n_model):
    check_teacher_mesh(monkeypatch, tmp_path, n_data, n_model)


def check_teacher_mesh(monkeypatch, tmp_path, n_data, n_model, n_seq=1, remat=False):
    """The teacher steps over an (n_data, n_model, n_seq) mesh against JAX
    under its mesh of that shape and the port's one process (the module
    docstring); remat: the ranks also take the first gradient with
    cfg.remat.  Returns (the ranks' results, the port's config)."""
    jc, tc = _configs("gauss", compute_dtype="float32", grad_clip=True, use_weight_norm=True,
                      dropout_all=True)
    jm, tm = jwavenet.Wavenet(jc), twavenet.Wavenet(tc)
    jp = jax.tree_util.tree_map(lambda x: x * 3.0, jm.init_params(jax.random.PRNGKey(3)))
    tp = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    wavs = _wavs(n=STEPS, B=B)
    per_forward = 1 + jc.num_layers
    ju = _Uniforms(per_forward)
    (jl, jg), jstate, jlosses = _jax_teacher(
        jm, jp, wavs, ju, jmesh.make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq))
    assert sorted(ju.tables) == list(range(per_forward))

    # the port in one process, on the whole batches and the same masks
    tu = _Uniforms(per_forward)
    monkeypatch.setattr(tmesh, "uniform",
                        lambda g, shape, device: torch.from_numpy(tu(shape)).to(device))
    opt = topt.make_optimizer(tc.lr_schedule, grad_clip=True)
    one, step_fn = ttl.make_train_state(tp, opt), ttl.make_wavenet_train_step(tm, opt)
    for w in wavs:
        one, _ = step_fn(one, torch.from_numpy(w), 0)
    assert tu.calls == STEPS * per_forward

    uniforms = [torch.from_numpy(ju.tables[k]) for k in range(per_forward)]
    inputs = {"cfg": tc, "params": tp, "n_data": n_data, "n_model": n_model, "n_seq": n_seq,
              "wavs": [torch.from_numpy(w) for w in wavs], "uniforms": uniforms}
    if remat:
        inputs["remat_cfg"] = dataclasses.replace(tc, remat=True)
    ranks = run_job("teacher", inputs, n_data * n_model * n_seq, tmp_path)
    calls = [tuple(u.shape) for u in uniforms] * ((2 if remat else 1) + STEPS)
    grad_tol, param_tol = TOL["f32"]
    jgrads = _flat(jg)
    init, moved = _flat(jp), [k for k, g in jgrads.items() if np.any(g != 0)]
    jparams, jema = _flat(jstate["params"]), _flat(jstate["ema"])
    readings = {"grads": 0.0, "params_ema": 0.0, "one": 0.0}
    for r in ranks:
        # every dropout call drew the whole batch's uniforms
        assert r["dropout_calls"] == calls
        grad_err = _leaf_err(jgrads, _tflat(r["grads"]))
        errs = (_update_err(init, jparams, _tflat(r["params"]), moved),
                _update_err(init, jema, _tflat(r["ema"]), moved))
        one_err = _update_err(init, _tflat(one["params"]), _tflat(r["params"]), moved)
        readings = {"grads": max(readings["grads"], grad_err),
                    "params_ema": max(readings["params_ema"], *errs),
                    "one": max(readings["one"], one_err)}
        assert grad_err <= grad_tol
        assert max(errs) <= param_tol and one_err <= param_tol
        assert r["count"] == STEPS
        for jloss, tloss in zip(jlosses, r["losses"]):
            assert abs(tloss - jloss) <= 1e-5 * max(abs(jloss), 1.0), (jloss, tloss)
    assert abs(ranks[0]["losses"][0] - float(jl)) <= 1e-5 * max(abs(float(jl)), 1.0)
    for k, v in _tflat(ranks[0]["params"]).items():
        for r in ranks[1:]:
            np.testing.assert_array_equal(v, _tflat(r["params"])[k], err_msg=k)
    print((n_data, n_model, n_seq), readings)
    return ranks, tc


def _flat_state(tree):
    return weights.flatten(weights.to_jax_params(tree))


def _jflat(tree):
    return weights.flatten(jax.tree_util.tree_map(np.asarray, tree))


def _jax_f64(monkeypatch, loss_type, kw, out, mesh):
    """The student pair in f64 and JAX's 3 free-running steps in f64 under
    ``mesh`` on the batches and draws of ``out`` (distill_run_both's):
    (pair, inputs as f64 tensors, final state, per-step metrics)."""
    with jax.enable_x64(True):
        pair = Pair(loss_type, dtype=np.float64, param_scale=3.0, lr_schedule=SCHEDULE, B=B,
                    teacher_kw={"use_weight_norm": True}, **kw)
        inputs = [((w.astype(np.float64), r.astype(np.float64)),
                   {k: v.astype(np.float64) for k, v in d.items()})
                  for (w, r), d in zip(out["batches"], out["draws"])]
        opt = jtl.make_student_optimizer(pair.jcfg, pair.np_params)
        state = jmesh.shard_train_state(jtl.make_train_state(pair.np_params, opt), mesh)
        teacher = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, pair.np_teacher), mesh)
        jinputs = jax.device_put(inputs, jmesh.batch_sharding(mesh))
        step_fn = _jax_step(monkeypatch, pair.jpwn, teacher, opt, state, *jinputs[0])
        metrics = []
        for batch, draws in jinputs:
            state, m = step_fn(state, *batch, draws)
            metrics.append({k: float(v) for k, v in m.items()})
        state = jax.tree_util.tree_map(np.asarray, state)
    tensors = {"batches": [(torch.from_numpy(w), torch.from_numpy(r)) for (w, r), _ in inputs],
               "draws": [{k: torch.from_numpy(v) for k, v in d.items()} for _, d in inputs]}
    return pair, tensors, state, metrics


@pytest.mark.parametrize("n_data,n_model", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("loss_type,kw", CASES, ids=["gauss-clip-wn", "logistic-cl-share-clip"])
def test_data_parallel_distill_steps_equal_jax_and_one_process(monkeypatch, tmp_path, loss_type,
                                                               kw, n_data, n_model):
    check_distill_mesh(monkeypatch, tmp_path, loss_type, kw, n_data, n_model)


def check_distill_mesh(monkeypatch, tmp_path, loss_type, kw, n_data, n_model, n_seq=1, f64=True):
    """Free running against JAX under its mesh: every metric of the 3 steps,
    and the params and EMA after the first; in f64 on both sides, every
    metric and the params and EMA after the 3 steps.  Against the port's one
    process, each step from a shared state (the common init, then JAX's
    state after the step before): the params and EMA.

    Free running, the Gauss student's params after 3 steps read 8.6e-3
    from JAX at n_data 2 (the test prints it; ROADMAP Queue 3): its second
    step is ill-conditioned in f32.  From JAX's state after the first, the
    port and JAX on one device agree to 2.7e-6, and either f32 step reads
    1.9e-2 from the f64 one in the first flow's first mel_cond kernel
    (tools/step_conditioning.py dp_gauss), so the summation order alone,
    which the mesh changes, moves that leaf.  In f64 the free-running
    params read 3.8e-4 (Gauss) and 4.2e-4 (logistic), the one process as
    the ranks: the port's Adam keeps JAX's f32 bias corrections, which part
    from JAX's f64 ones, and the second step carries that too.

    check_distill_mesh: these checks over an (n_data, n_model, n_seq) mesh,
    the f64 run only with ``f64``; returns (the ranks' results, the port's
    student)."""
    mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq)
    out = distill_run_both(monkeypatch, loss_type, B=B, jax_mesh=mesh,
                           teacher_kw={"use_weight_norm": True}, **kw)
    pair = out["pair"]
    jstates = [out["jstate0"]] + out["jstates"]
    batches = [(torch.from_numpy(w), torch.from_numpy(r)) for w, r in out["batches"]]
    draws = [{k: torch.from_numpy(v) for k, v in d.items()} for d in out["draws"]]
    inputs = {"n_data": n_data, "n_model": n_model, "n_seq": n_seq, "cfg": pair.tcfg,
              "teacher_cfg": pair.tteacher.cfg, "params": pair.tparams,
              "teacher_params": pair.tte, "batches": batches, "draws": draws,
              "starts": [_port_state(js) for js in jstates[:-1]]}
    if f64:
        p64, in64, js64, jm64 = _jax_f64(monkeypatch, loss_type, kw, out, mesh)
        inputs["f64"] = {"params": p64.tparams, "teacher_params": p64.tte, **in64}
    ranks = run_job("student", inputs, n_data * n_model * n_seq, tmp_path)
    init = out["init"]
    first = _jflat(jstates[1]["params"])
    moved1 = [n for n in first if np.any(first[n] != init[n])]
    readings = {"jax_step1": 0.0, "one_shared": 0.0}
    for r in ranks:
        for k, ((jm, _), tm) in enumerate(zip(out["metrics"], r["metrics"])):
            assert set(tm) == set(jm), (sorted(jm), sorted(tm))
            for n in jm:
                assert abs(tm[n] - jm[n]) <= METRIC_TOL * max(abs(jm[n]), 1.0), (k, n, jm[n], tm[n])
        got = r["shared"][0]
        errs = (distill_update_err(init, first, _flat_state(got["params"]), moved1),
                distill_update_err(init, _jflat(jstates[1]["ema"]), _flat_state(got["ema"]),
                                   moved1))
        readings["jax_step1"] = max(readings["jax_step1"], *errs)
        assert max(errs) <= UPDATE_TOL, errs
    for k in range(STEPS):
        before, ema_before = _jflat(jstates[k]["params"]), _jflat(jstates[k]["ema"])
        one, _ = out["tstep"](_port_state(jstates[k]), *batches[k], None, draws=draws[k])
        want, want_ema = _flat_state(one["params"]), _flat_state(one["ema"])
        moved = [n for n in want if np.any(want[n] != before[n])]
        for r in ranks:
            got = r["shared"][k]
            errs = (distill_update_err(before, want, _flat_state(got["params"]), moved),
                    distill_update_err(ema_before, want_ema, _flat_state(got["ema"]), moved))
            readings["one_shared"] = max(readings["one_shared"], *errs)
            assert max(errs) <= UPDATE_TOL, (k, errs)
    readings["jax_free"] = max(
        distill_update_err(init, _jflat(out["jstate"]["params"]), _flat_state(r["params"]),
                           out["moved"]) for r in ranks)
    if not f64:
        print(loss_type, (n_data, n_model, n_seq), readings)
        return ranks, pair.tpwn
    # f64, free running
    init64 = to_numpy(p64.tparams)
    want64, ema64 = _jflat(js64["params"]), _jflat(js64["ema"])
    moved64 = [n for n in want64 if np.any(want64[n] != init64[n])]
    readings["jax_free_f64"] = (0.0, 0.0)
    for r in ranks:
        for k, (jm, tm) in enumerate(zip(jm64, r["f64"]["metrics"])):
            assert set(tm) == set(jm), (sorted(jm), sorted(tm))
            for n in jm:
                assert abs(tm[n] - jm[n]) <= METRIC_TOL * max(abs(jm[n]), 1.0), (k, n, jm[n], tm[n])
        errs = (distill_update_err(init64, want64, to_numpy(r["f64"]["params"]), moved64),
                distill_update_err(init64, ema64, to_numpy(r["f64"]["ema"]), moved64))
        readings["jax_free_f64"] = tuple(map(max, readings["jax_free_f64"], errs))
        assert max(errs) <= UPDATE_TOL, errs
    print(loss_type, (n_data, n_model, n_seq), readings)
    return ranks, pair.tpwn
