"""Multi-process training on the port (counterpart of
tests/test_multiprocess.py): the train CLIs in 2 processes over gloo on the
CPU, wired by torch's env:// variables as torchrun sets them
(train_*_torch.py --multihost), against one process at the same global
batch: data parallelism, channel tensor parallelism (--n_model 2) and
sequence parallelism (--n_seq 2).

As in the JAX test, every record of the dataset is the same wave_length
wav, so the crops cannot depend on how the records are shared out: one
process and two see the same global batch, and the trajectories compare
directly.  The teacher's config adds dropout, whose masks are drawn for the
global batch and sliced per rank (parallel/mesh.py RowDraws).

Tolerances: the params after 4 steps at rtol 1e-5, atol 1e-7, as JAX's
test; the gradient average over 2 ranks sums in another order than one
process's mean.

``run_ranks`` starts the ranks of one job on a free port, each pinned to one
thread, with its output in a file (a full pipe cannot stall a rank), and
joins them within a timeout of its own: a hung rank fails the test, and
every rank is killed."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models.parallel_wavenet import ParallelWavenet as JParallelWavenet
from nsynth_wavenet_tpu.models.wavenet import Wavenet as JWavenet
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import dataset as tdata
from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240

TINY_CFG = {
    "wave_length": 1280,
    "num_layers": 4,
    "num_stages": 2,
    "filter_length": 3,
    "width": 16,
    "skip_width": 8,
    "deconv_width": 16,
    "deconv_config": [[40, 10], [80, 20]],
    "loss_type": "gauss",
    "use_mu_law": False,
    "double_gate_width": False,
    "use_weight_norm": True,  # the data-dependent init on process 0's batch
    "dropout_all": True,
    "num_iters": 100000,
    "compute_dtype": "float32",
}
# a mu-law pair: see test_two_process_distillation
TEACHER_CFG = dict(TINY_CFG, loss_type="mol", mol_mix=4, dropout_all=False, use_mu_law=True)
STUDENT_CFG = {
    "wave_length": 1280, "num_stages": 2, "filter_length": 3, "width": 16,
    "deconv_width": 16, "deconv_config": [[40, 10], [80, 20]], "loss_type": "logistic",
    "num_iaf_layers": [2, 2], "num_samples": 2, "use_mu_law": True, "power_loss_factor": 1.0,
    "contrastive_loss_factor": 0.3, "use_share_deconv": True, "use_weight_norm": True,
    "compute_dtype": "float32", "num_iters": 100000,
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmd, n, out_dir, timeout=RANK_TIMEOUT, env=None):
    """Run ``cmd`` as ranks 0..n-1 of one gloo job; returns their outputs.
    Fails (after killing every rank) on a nonzero exit or the timeout."""
    port = free_port()
    procs, logs = [], []
    os.makedirs(out_dir, exist_ok=True)
    for r in range(n):
        e = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                 WORLD_SIZE=str(n), LOCAL_RANK=str(r), OMP_NUM_THREADS="1",
                 PYTHONPATH=REPO, **(env or {}))
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=e, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    assert not hung, f"ranks {hung} still running after {timeout} s:\n" + outs[hung[0]][-4000:]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}:\n{out[-6000:]}"
    return outs


def run_job(job, inputs, n, tmp_dir, timeout=RANK_TIMEOUT):
    """tests/torch_rank_worker.py ``job`` on ``inputs`` as n ranks; returns
    the result of every rank, in rank order."""
    os.makedirs(tmp_dir, exist_ok=True)
    path = os.path.join(tmp_dir, "inputs.pt")
    torch.save(inputs, path)
    run_ranks([sys.executable, os.path.join(REPO, "tests", "torch_rank_worker.py"), job, path,
               str(tmp_dir)], n, tmp_dir, timeout=timeout)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def make_identical_dataset(path, length=1280, n=4, noise=0.0):
    t = np.arange(length) / 16000.0
    wav = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 880 * t)
    wav = (wav + noise * np.random.default_rng(0).standard_normal(length)).astype(np.float32)
    tdata.build_dataset_from_arrays([wav] * n, [f"r{i}" for i in range(n)], str(path))
    return str(path)


def _cmd(script, ds, *, config="", log_root="", logdir="", steps=4, batch=4, extra=()):
    cmd = [sys.executable, os.path.join(REPO, script), "--train_path", ds,
           "--total_batch_size", str(batch), "--num_steps", str(steps),
           "--ckpt_every_steps", str(steps), "--seed", "0", "--device", "cpu", *extra]
    if log_root:
        return cmd + ["--config", config, "--log_root", log_root]
    return cmd + ["--logdir", logdir]


def _only_run(root):
    runs = os.listdir(root)
    assert len(runs) == 1, f"the processes disagreed on the run directory: {runs}"
    return os.path.join(root, runs[0])


def _state(run_dir, step=None):
    state = ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt")).restore(step, device="cpu")
    assert state is not None, f"no checkpoint in {run_dir}"
    return state


def _assert_params_close(a, b):
    fa, fb = weights.flatten(a), weights.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(fa[k].numpy(), fb[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


def _assert_jax_layout(params, jax_params):
    """Finite leaves with JAX's key paths and shapes (the whole model)."""
    import jax

    want = weights.flatten(jax.tree_util.tree_map(np.asarray, jax_params))
    got = weights.flatten(params)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, (k, tuple(v.shape), want[k].shape)
        assert torch.isfinite(v).all(), k


def _json(path, d):
    path.write_text(json.dumps(d))
    return str(path)


def test_two_process_training_matches_single_process(tmp_path):
    ds = make_identical_dataset(tmp_path / "ds")
    cfg = _json(tmp_path / "tiny.json", TINY_CFG)
    run_ranks(_cmd("train_wavenet_torch.py", ds, config=cfg, log_root=str(tmp_path / "runs1")),
              1, tmp_path / "log1")
    run_ranks(_cmd("train_wavenet_torch.py", ds, config=cfg, log_root=str(tmp_path / "runs2"),
                   extra=["--multihost"]), 2, tmp_path / "log2")
    run1, run2 = _only_run(tmp_path / "runs1"), _only_run(tmp_path / "runs2")
    st1, st2 = _state(run1), _state(run2)
    assert st1["step"] == st2["step"] == 4
    _assert_params_close(st1["params"], st2["params"])
    _assert_params_close(st1["ema"], st2["ema"])
    # train.log and metrics.jsonl come from rank 0 alone
    assert open(os.path.join(run2, "train.log")).read().count("step 4 loss") == 1

    # resume by logdir from step 4 to 8 in 2 processes
    outs = run_ranks(_cmd("train_wavenet_torch.py", ds, logdir=run2, steps=8,
                          extra=["--multihost"]), 2, tmp_path / "log3")
    assert any("Restored checkpoint at step 4" in o for o in outs), outs[0][-2000:]
    assert _state(run2, step=8)["step"] == 8


def test_two_process_tensor_parallel_checkpoint(tmp_path):
    """--n_model 2 across 2 processes: each holds half of every layer's
    channels; the checkpoint is the whole model in the JAX layout and a
    resumed run restores and shards it."""
    import jax

    ds = make_identical_dataset(tmp_path / "ds")
    cfg = _json(tmp_path / "tiny.json", TINY_CFG)
    run_ranks(_cmd("train_wavenet_torch.py", ds, config=cfg, log_root=str(tmp_path / "runs"),
                   steps=2, batch=2, extra=["--multihost", "--n_model", "2", "--export_ema"]),
              2, tmp_path / "log")
    run = _only_run(tmp_path / "runs")
    st = _state(run)
    assert st["step"] == 2
    jp = JWavenet(jconfig.WavenetConfig(**TINY_CFG)).init_params(jax.random.PRNGKey(0))
    _assert_jax_layout(st["params"], jp)
    _assert_jax_layout(ckpt_lib.load_params(os.path.join(run, "ema"), device="cpu"), jp)
    assert open(os.path.join(run, "train.log")).read().count("'model': 2") == 1
    outs = run_ranks(_cmd("train_wavenet_torch.py", ds, logdir=run, steps=3, batch=2,
                          extra=["--multihost", "--n_model", "2"]), 2, tmp_path / "log2")
    assert any("Restored checkpoint at step 2" in o for o in outs)
    _assert_jax_layout(_state(run, step=3)["params"], jp)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_process_distillation(tmp_path):
    """A port teacher run, then distillation in 2 data-parallel processes
    against one process (the global batch's noise sliced per rank), and with
    --n_model 2 (the frozen teacher sharded as the student): its checkpoint
    is the whole student in the JAX layout.

    Adam steps every element by about the learning rate whatever its
    gradient's size (tests/test_torch_distill_step.py), so the two runs are
    held as that test holds the port to JAX: the metrics at METRIC_TOL, the
    params after the second step by the L2 of their difference over the L2
    of that step's update, leaf by leaf, at UPDATE_TOL.  The record is the
    two tones plus white noise: over the tones alone the upsampler reads
    near-silent mel bins whose gradient elements are of roundoff size, and
    the second step's params then part by the summation order alone.  The
    teacher and student are a mu-law pair for the same reason: at 65 536
    levels the teacher's MoL bins cancel 15 bits of a probability.  Readings
    of two processes against one (tools/step_conditioning.py two_process;
    ROADMAP Queue 3 watch list): this record and pair, the second step's
    params 2.7e-5 and the metrics 1.0e-7; the tones alone, 6.2e-2 in the
    shared deconv's second layer; the 65 536-level MoL pair, 1.09e-1 in a
    flow's mel_cond_out1 and the contrastive loss 1.1e-3."""
    import jax

    from test_torch_distill_step import METRIC_TOL, UPDATE_TOL

    ds = make_identical_dataset(tmp_path / "ds", noise=0.05)
    run_ranks(_cmd("train_wavenet_torch.py", ds,
                   config=_json(tmp_path / "teacher.json", TEACHER_CFG),
                   log_root=str(tmp_path / "teacher"), steps=1, batch=2), 1, tmp_path / "logt")
    teacher = _only_run(tmp_path / "teacher")
    cfg = _json(tmp_path / "student.json", STUDENT_CFG)

    def distill(root, n, extra=(), batch=4):
        run_ranks(_cmd("train_parallel_wavenet_torch.py", ds, config=cfg, log_root=str(root),
                       steps=2, batch=batch,
                       extra=["--teacher_dir", teacher, "--ckpt_every_steps", "1", *extra]),
                  n, str(root) + "_log")
        return _only_run(root)

    one, two = distill(tmp_path / "s1", 1), distill(tmp_path / "s2", 2, ["--multihost"])
    (m1,), (m2,) = _metrics(one), _metrics(two)
    assert m1["step"] == m2["step"] == 2
    for k in ("loss", "kl_loss", "power_loss", "contrastive_loss", "new_x_std", "mean_tot"):
        assert abs(m2[k] - m1[k]) <= METRIC_TOL * max(abs(m1[k]), 1.0), (k, m1[k], m2[k])
    before, want = weights.flatten(_state(one, 1)["params"]), weights.flatten(_state(one)["params"])
    got = weights.flatten(_state(two)["params"])
    for k in want:
        step = float(torch.linalg.vector_norm(want[k] - before[k]))
        if step > 0:
            assert float(torch.linalg.vector_norm(got[k] - want[k])) <= UPDATE_TOL * step, k

    st_tp = _state(distill(tmp_path / "s3", 2, ["--multihost", "--n_model", "2"], batch=2))
    assert st_tp["step"] == 2
    jcfg = jconfig.ParallelWavenetConfig(**STUDENT_CFG)
    _assert_jax_layout(st_tp["params"], JParallelWavenet(jcfg).init_params(jax.random.PRNGKey(0)))


def _assert_update_close(before, want, got, tol):
    """||got - want|| within tol of ||want - before|| over every leaf that
    moved (Adam moves every element by about the learning rate)."""
    before, want, got = (weights.flatten(t) for t in (before, want, got))
    assert want.keys() == got.keys()
    for k in want:
        step = float(torch.linalg.vector_norm(want[k] - before[k]))
        if step > 0:
            err = float(torch.linalg.vector_norm(got[k] - want[k]))
            assert err <= tol * step, (k, err / step)


@pytest.mark.parametrize("n_seq", (2,))
def test_sequence_parallel_training_cli(tmp_path, n_seq):
    """Both CLIs with --multihost --n_seq 2 in 2 gloo processes, 2 steps:
    each rank runs its half of every crop's time axis.  The checkpoints are
    the whole model in the JAX layout, and the params after the second step
    are a one-process run's of the same seed, by the L2 of that step's
    update, at tests/test_torch_distill_step.py's UPDATE_TOL; the teacher
    run resumes on both ranks to a third step."""
    import jax

    from test_torch_distill_step import UPDATE_TOL

    ds = make_identical_dataset(tmp_path / "ds", noise=0.05)
    cfg = _json(tmp_path / "tiny.json", TINY_CFG)

    def teacher(root, n, extra=()):
        run_ranks(_cmd("train_wavenet_torch.py", ds, config=cfg, log_root=str(root), steps=2,
                       batch=2, extra=["--ckpt_every_steps", "1", *extra]), n, str(root) + "_log")
        return _only_run(root)

    one, seq = teacher(tmp_path / "t1", 1), teacher(tmp_path / "t2", n_seq,
                                                    ["--multihost", "--n_seq", str(n_seq)])
    assert open(os.path.join(seq, "train.log")).read().count(f"'seq': {n_seq}") == 1
    jp = JWavenet(jconfig.WavenetConfig(**TINY_CFG)).init_params(jax.random.PRNGKey(0))
    _assert_jax_layout(_state(seq)["params"], jp)
    _assert_update_close(_state(one, 1)["params"], _state(one)["params"], _state(seq)["params"],
                         UPDATE_TOL)
    # resume: every seq rank restores the whole checkpoint (rank 0 logs)
    outs = run_ranks(_cmd("train_wavenet_torch.py", ds, logdir=seq, steps=3, batch=2,
                          extra=["--multihost", "--n_seq", str(n_seq)]), n_seq, tmp_path / "log3")
    assert any("Restored checkpoint at step 2" in o for o in outs), outs[0][-2000:]
    assert _state(seq, step=3)["step"] == 3

    run_ranks(_cmd("train_wavenet_torch.py", ds,
                   config=_json(tmp_path / "teacher.json", TEACHER_CFG),
                   log_root=str(tmp_path / "teacher"), steps=1, batch=2), 1, tmp_path / "logt")
    teacher_dir = _only_run(tmp_path / "teacher")
    scfg = _json(tmp_path / "student.json", STUDENT_CFG)

    def distill(root, n, extra=()):
        run_ranks(_cmd("train_parallel_wavenet_torch.py", ds, config=scfg, log_root=str(root),
                       steps=2, batch=2,
                       extra=["--teacher_dir", teacher_dir, "--ckpt_every_steps", "1", *extra]),
                  n, str(root) + "_log")
        return _only_run(root)

    one, seq = distill(tmp_path / "s1", 1), distill(tmp_path / "s2", n_seq,
                                                    ["--multihost", "--n_seq", str(n_seq)])
    jcfg = jconfig.ParallelWavenetConfig(**STUDENT_CFG)
    _assert_jax_layout(_state(seq)["params"],
                       JParallelWavenet(jcfg).init_params(jax.random.PRNGKey(0)))
    _assert_update_close(_state(one, 1)["params"], _state(one)["params"], _state(seq)["params"],
                         UPDATE_TOL)
    (m1,), (m2,) = _metrics(one), _metrics(seq)
    assert abs(m2["loss"] - m1["loss"]) <= 1e-4 * max(abs(m1["loss"]), 1.0), (m1, m2)
