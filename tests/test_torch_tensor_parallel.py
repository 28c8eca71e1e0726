"""Channel tensor parallelism (n_model 2) of both training steps against the
JAX package's steps and the port's one-process steps, in 2 gloo processes
on the CPU (tests/torch_rank_worker.py).  Data parallelism, alone and with
n_model 2, is held in tests/test_torch_data_parallel.py.

Each rank holds half of every layer's dilated and mel_cond output channels
(each gate half sharded on its own) and half of the res / skip input
channels (parallel/mesh.py).  Weight norm is on, so the row-parallel res
and skip kernels sum each output channel's squared norm over the model
group, and the clip's global norm sums the shards' squares over it.

The cases and limits are those of tests/test_torch_train_step.py (the
weight-normed Gauss teacher: the first gradient per leaf within 1e-4 of its
max, the params and EMA after 3 steps within 1e-3 by the L2 of the update)
and tests/test_torch_distill_step.py (a weight-normed Gauss student and a
logistic one: every metric within METRIC_TOL, params and EMA within
UPDATE_TOL), the frozen teacher weight-normed in both.  A rank's own shard
has half the gate width, and the gathered params are the JAX layout."""

import jax
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch import weights
from test_torch_distill_step import METRIC_TOL, METRICS, UPDATE_TOL
from test_torch_distill_step import _run_both as distill_run_both
from test_torch_distill_step import _update_err as distill_update_err
from test_torch_multiprocess import run_job
from test_torch_train_step import TOL, _flat, _leaf_err, _run_both, _tflat, _update_err


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tensor_parallel_teacher_step_equals_jax_and_one_process(tmp_path):
    out = _run_both("gauss", grad_clip=True, param_scale=3.0, use_weight_norm=True)
    grad_tol, param_tol = TOL["f32"]
    wavs = [torch.from_numpy(w) for w in out["wavs"]]
    ranks = run_job("teacher", {"cfg": out["tcfg"], "params": out["tparams"], "wavs": wavs,
                                "n_data": 1, "n_model": 2}, 2, tmp_path)
    gw = out["tcfg"].gate_width
    assert ranks[0]["shard_shape"] == (out["tcfg"].filter_length, out["tcfg"].width, gw // 2)
    jg, _ = out["grads"]
    moved, init = out["moved"], out["init"]
    jparams, jema = _flat(out["jstate"]["params"]), _flat(out["jstate"]["ema"])
    for r in ranks:
        assert _leaf_err(jg, _tflat(r["grads"])) <= grad_tol
        assert _update_err(init, jparams, _tflat(r["params"]), moved) <= param_tol
        assert _update_err(init, jema, _tflat(r["ema"]), moved) <= param_tol
        assert r["count"] == 3
        for (jl, _), tl in zip(out["losses"], r["losses"]):
            assert abs(tl - jl) <= 1e-5 * max(abs(jl), 1.0), (jl, tl)
        # and the port's one-process step
        one = _tflat(out["tstate"]["params"])
        assert _update_err(init, one, _tflat(r["params"]), moved) <= param_tol
    for k, v in _tflat(ranks[0]["params"]).items():
        np.testing.assert_array_equal(v, _tflat(ranks[1]["params"])[k], err_msg=k)


# the weight-normed student in the Gauss case only: in the logistic one the
# one-process port itself reads 1.07e-2 from JAX after 3 steps, and JAX's
# f32 3.7e-3 and the port's 7.0e-3 from the f64 runs, which agree to
# 1.8e-5 (tools/step_conditioning.py logistic_wn; ROADMAP Queue 3 item 5):
# its out2_scale head's kernel has an element whose first gradient is
# 5.8e-6 of the leaf's largest and 18 % off in f32, and Adam steps it by
# about the learning rate; its teacher is weight-normed in both
CASES = [
    ("gauss", dict(power_loss_factor=1.0, grad_clip=True, use_weight_norm=True)),
    ("logistic", dict(power_loss_factor=1.0, contrastive_loss_factor=0.3, use_share_deconv=True,
                      grad_clip=True)),
]


@pytest.mark.parametrize("loss_type,kw", CASES, ids=["gauss-clip-wn", "logistic-cl-share-clip"])
def test_tensor_parallel_distill_steps_equal_jax_and_one_process(monkeypatch, tmp_path,
                                                                 loss_type, kw):
    out = distill_run_both(monkeypatch, loss_type, teacher_kw={"use_weight_norm": True}, **kw)
    pair = out["pair"]
    ranks = run_job("student", {
        "n_data": 1, "n_model": 2, "cfg": pair.tcfg, "teacher_cfg": pair.tteacher.cfg, "params": pair.tparams,
        "teacher_params": pair.tte,
        "batches": [(torch.from_numpy(w), torch.from_numpy(r)) for w, r in out["batches"]],
        "draws": [{k: torch.from_numpy(v) for k, v in d.items()} for d in out["draws"]]},
        2, tmp_path)
    init, moved = out["init"], out["moved"]
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, out["jstate"]["params"]))
    jema = weights.flatten(jax.tree_util.tree_map(np.asarray, out["jstate"]["ema"]))
    one = weights.flatten(weights.to_jax_params(out["tstate"]["params"]))
    for r in ranks:
        for (jm, _), tm in zip(out["metrics"], r["metrics"]):
            for k in METRICS:
                assert abs(tm[k] - jm[k]) <= METRIC_TOL * max(abs(jm[k]), 1.0), (k, jm[k], tm[k])
        got = weights.flatten(weights.to_jax_params(r["params"]))
        assert distill_update_err(init, jflat, got, moved) <= UPDATE_TOL
        assert distill_update_err(init, one, got, moved) <= UPDATE_TOL
        assert distill_update_err(
            init, jema, weights.flatten(weights.to_jax_params(r["ema"])), moved) <= UPDATE_TOL
