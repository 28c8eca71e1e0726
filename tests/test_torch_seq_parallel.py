"""Sequence parallelism (the seq axis of parallel/mesh.py) of both training
steps, in gloo processes on the CPU (tests/torch_rank_worker.py jobs
``halo``, ``teacher`` and ``student``): rank r of n owns samples
[r L/n, (r+1) L/n) of its data index's rows, and every causal conv reads
the steps before its chunk from its left neighbours through a halo
exchange (mesh.halo), whose backward sends the halo's gradient back.

- The halo convs (ops/conv.py conv1d_taps, shift_right with a seq group) at
  seq 2 and 4, against the whole-sequence op: the output, the input's and
  the params' gradients, halos shorter and longer than a chunk (spanning up
  to every left neighbour), in f64 where the two sum in one order: equal
  to 1e-12.
- The teacher step of tests/test_torch_data_parallel.py (the weight-normed,
  clipped Gauss config with dropout_all, 3 steps at global batch 4) at
  n_seq 2 and n_data 2 x n_seq 2, against JAX's step under make_mesh of the
  same shape (its virtual CPU devices; XLA inserts its own halos) and the
  port's one process, at the limits of that test (TOL['f32'], losses
  within 1e-5); remat on against remat off at n_seq 2 (the exchange stays
  outside the checkpointed layer): equal gradients; remat_teacher on
  against off at n_seq 2 (the recompute replays the forward's halos):
  equal gradients and exchanges.
- The two student cases of tests/test_torch_tensor_parallel.py at n_seq 2
  and n_model 2 x n_seq 2, against JAX under its mesh and the port's one
  process, at METRIC_TOL / UPDATE_TOL (the checks of
  tests/test_torch_data_parallel.py without its f64 run).
- A 10-layer teacher (dilations to 512, a receptive field of 2 047 samples)
  at n_seq 4 on 1 280 samples: every layer from dilation 256 reads more
  than a 320-sample chunk back; the steps against one process.
- The exchanges each step counts (mesh.halo_exchanges) against
  train_lib.wavenet_halo_exchanges / pwn_halo_exchanges.
- A length the seq axis does not divide is refused."""

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import conv as tconv
from nsynth_wavenet_tpu_torch.ops import stft as tstft
from nsynth_wavenet_tpu_torch.parallel import mesh as tmesh
from nsynth_wavenet_tpu_torch.training import optimizer as topt
from nsynth_wavenet_tpu_torch.training import train_lib as ttl
from test_torch_data_parallel import check_distill_mesh, check_teacher_mesh
from test_torch_distill_losses import Pair
from test_torch_multiprocess import run_job
from test_torch_tensor_parallel import CASES
from test_torch_train_step import _configs, _tflat, _update_err, _wavs

@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _halo_cases():
    """(x [B, 64, C], conv params, dilation, output gradient) in f64: at seq
    4 a chunk is 16 samples, at seq 2 32; halos of 2, 16, 32, 40 and 128."""
    g = torch.Generator().manual_seed(0)
    out = []
    for fl, dilation, cin, cout in ((3, 1, 3, 4), (3, 8, 2, 3), (3, 16, 2, 2), (2, 40, 3, 2),
                                    (3, 64, 1, 2)):
        p = tconv.conv1d_init(g, cin, cout, fl, device="cpu", use_weight_norm=True)
        p = {k: v.double() for k, v in p.items()}
        out.append({"x": torch.randn((2, 64, cin), generator=g, dtype=torch.float64),
                    "params": p, "dilation": dilation,
                    "g": torch.randn((2, 64, cout), generator=g, dtype=torch.float64)})
    return out


def test_halo_conv_equals_whole_sequence(tmp_path):
    cases = _halo_cases()
    ranks = run_job("halo", {"cases": cases}, 4, tmp_path)
    for i, case in enumerate(cases):
        x = case["x"].clone().requires_grad_()
        p = {k: v.clone().requires_grad_() for k, v in case["params"].items()}
        y = tconv.conv1d_taps(p, x, dilation=case["dilation"])
        (y * case["g"]).sum().backward()
        want = {"y": y.detach(), "dx": x.grad.clone(),
                "dparams": {k: v.grad for k, v in p.items()}}
        x.grad = None
        sh = tconv.shift_right(x)
        (sh * case["x"]).sum().backward()
        want.update(shift=sh.detach(), dx_shift=x.grad)
        for n_seq in (4, 2):
            # seq ranks in order (the (2, 1, 2) mesh: two data lines of two)
            seq_ranks = ranks if n_seq == 4 else ranks[:2]
            for key in ("y", "dx", "shift", "dx_shift"):
                got = torch.cat([r[(n_seq, i)][key] for r in seq_ranks], 1)
                torch.testing.assert_close(got, want[key], rtol=0, atol=1e-12,
                                           msg=f"case {i} seq {n_seq} {key}")
            for r in ranks:
                for k, v in want["dparams"].items():
                    torch.testing.assert_close(r[(n_seq, i)]["dparams"][k], v, rtol=1e-12,
                                               atol=1e-12, msg=f"case {i} seq {n_seq} d{k}")
                # the conv and the shift, forward and backward
                assert r[(n_seq, i)]["counts"] == {"forward": 2, "backward": 2}
            if n_seq == 2:
                for key in ("y", "dx"):
                    torch.testing.assert_close(ranks[2][(2, i)][key], ranks[0][(2, i)][key],
                                               rtol=0, atol=0)


@pytest.mark.parametrize("n_data,n_model,n_seq", [(1, 1, 2), (2, 1, 2)],
                         ids=["seq2", "data2-seq2"])
def test_seq_parallel_teacher_step_equals_jax_and_one_process(monkeypatch, tmp_path, n_data,
                                                              n_model, n_seq):
    ranks, cfg = check_teacher_mesh(monkeypatch, tmp_path, n_data, n_model, n_seq,
                                    remat=n_data == 1)
    want = ttl.wavenet_halo_exchanges(cfg)
    for r in ranks:
        assert r["halo_exchanges"] == want, (r["halo_exchanges"], want)
        if "remat_grads" in r:
            for k, v in _tflat(r["grads"]).items():
                np.testing.assert_array_equal(_tflat(r["remat_grads"])[k], v, err_msg=k)


@pytest.mark.parametrize("n_data,n_model,n_seq", [(1, 1, 2), (1, 2, 2)],
                         ids=["seq2", "model2-seq2"])
@pytest.mark.parametrize("loss_type,kw", CASES, ids=["gauss-clip-wn", "logistic-cl-share-clip"])
def test_seq_parallel_distill_steps_equal_jax_and_one_process(monkeypatch, tmp_path, loss_type,
                                                              kw, n_data, n_model, n_seq):
    ranks, pwn = check_distill_mesh(monkeypatch, tmp_path, loss_type, kw, n_data, n_model, n_seq,
                                    f64=False)
    want = ttl.pwn_halo_exchanges(pwn)
    for r in ranks:
        assert r["halo_exchanges"] == want, (r["halo_exchanges"], want)


def test_remat_teacher_under_seq_equals_no_remat(tmp_path):
    """remat_teacher checkpoints the frozen teacher's whole forward, halos
    and all: its recompute reads the forward's halos from a tape
    (mesh.halo_checkpoint_contexts) instead of exchanging again, so the
    gradient and the exchanges equal those without remat."""
    pair = Pair("logistic", dtype=np.float32, power_loss_factor=1.0, contrastive_loss_factor=0.3,
                use_share_deconv=True)
    ranks = run_job("student_remat", {
        "cfg": pair.tcfg, "teacher_cfg": pair.tteacher.cfg, "params": pair.tparams,
        "teacher_params": pair.tte, "draws": pair.tdraws(),
        "batch": (torch.from_numpy(pair.wav), torch.from_numpy(pair.wav_rand))}, 2, tmp_path)
    for r in ranks:
        assert r[False]["loss"] == r[True]["loss"]
        assert r[False]["halo_exchanges"] == r[True]["halo_exchanges"] == \
            ttl.pwn_halo_exchanges(pair.tpwn)
        for k, v in _tflat(r[False]["grads"]).items():
            np.testing.assert_array_equal(_tflat(r[True]["grads"])[k], v, err_msg=k)


def test_halos_across_several_ranks_equal_one_process(tmp_path):
    """A 10-layer teacher, dilations 1 .. 512, at n_seq 4 on 1 280 samples
    (chunks of 320): from dilation 256 on, a layer's halo spans two and
    three left neighbours (zeros before the start).  The gradient and the
    params and EMA after 3 steps against one process, at TOL['f32']."""
    _, tc = _configs("gauss", compute_dtype="float32", num_layers=10, num_stages=10,
                     use_weight_norm=True, grad_clip=True)
    model = Wavenet(tc)
    params = model.init_params(3, device="cpu")
    wavs = [torch.from_numpy(w) for w in _wavs(n=3, B=2)]
    _, grads = ttl.loss_and_grads(model, params, wavs[0], tstft.melspectrogram(wavs[0]))
    opt = topt.make_optimizer(tc.lr_schedule, grad_clip=True)
    one, step_fn = ttl.make_train_state(params, opt), ttl.make_wavenet_train_step(model, opt)
    losses = []
    for w in wavs:
        one, m = step_fn(one, w)
        losses.append(float(m["loss"]))
    ranks = run_job("teacher", {"cfg": tc, "params": params, "n_data": 1, "n_model": 1,
                                "n_seq": 4, "wavs": wavs}, 4, tmp_path)
    init = weights.flatten(weights.to_jax_params(params))
    want = _tflat(grads)
    moved = [k for k, g in want.items() if np.any(g != 0)]
    for r in ranks:
        got = _tflat(r["grads"])
        for k in want:
            scale = float(np.abs(want[k]).max())
            assert np.abs(got[k] - want[k]).max() <= 1e-4 * max(scale, 1e-30), k
        assert _update_err(init, _tflat(one["params"]), _tflat(r["params"]), moved) <= 1e-3
        assert _update_err(init, _tflat(one["ema"]), _tflat(r["ema"]), moved) <= 1e-3
        for a, b in zip(losses, r["losses"]):
            assert abs(a - b) <= 1e-5 * max(abs(a), 1.0), (a, b)
        assert r["halo_exchanges"] == ttl.wavenet_halo_exchanges(tc)


def test_indivisible_length_is_refused():
    """mesh.seq_chunk (which the steps, the encoding window and the runners
    call) refuses a length the seq axis does not divide, naming both; the
    JAX package pads such a length instead."""
    mesh = tmesh.Mesh({"data": 1, "model": 1, "seq": 3})
    with pytest.raises(ValueError, match="1280 samples does not divide over 3 seq ranks"):
        tmesh.seq_chunk(1280, mesh)
    assert tmesh.seq_chunk(1281, mesh) == slice(0, 427)
    assert tmesh.seq_chunk(1280, None) == slice(0, 1280)
    # the shipped crops: 7680 samples, and the student's sample length at them
    for n in (2, 4, 8, 16, 32, 64, 128, 256, 512):
        assert tmesh.seq_chunk(7680, tmesh.Mesh({"data": 1, "model": 1, "seq": n})).stop == \
            7680 // n
