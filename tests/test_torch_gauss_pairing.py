"""The quality smoke's Gauss (ClariNet) pairing on the port
(nsynth_wavenet_tpu_torch/tools/gauss_pairing.py) against the JAX package
(tools/gauss_pairing_readings.py), on the CPU:

* the committed 30k-step Gauss teacher tests/golden/tiny_gauss (f32
  compute) read on the smoke's held-out speech clips: the port's sigma_p
  quantiles against JAX's Wavenet.feed_forward reading, each within
  SIGMA_RTOL 1e-5 relative (readings: 0 to 4.7e-7), and every sigma within
  SIGMA_ELEM_RTOL 1e-4 (reading 3.3e-6); the clips and mels both sides make
  are equal bit for bit;
* a distillation trajectory on shared inputs: the tiny pair of
  tests/test_parallel_wavenet.py (TE_SMALL as a Gauss teacher, ST_SMALL as a
  Gauss student with the smoke's power loss), the student's init JAX's, the
  crops of a small speech corpus in the runner's order and numpy base
  noise, fed to both sides for STEPS 10 steps at B = 4.  Every step's KL
  and power loss within METRIC_TOL 1e-4 of max(|JAX|, 1) (readings: up to
  2.3e-7) and the params and EMA after steps 5 and 10 within UPDATE_TOL 1e-3
  of the distance JAX moved them (L2 over all leaves; readings: params 1.8e-6
  to 1.6e-5, EMA 2.7e-6 to 1.8e-5 over the two seeds and steps), the limits
  of tests/test_torch_distill_step.py;
* the tool's commands end to end at a small size: a teacher run directory
  written from the golden (bit for bit), ``distill`` from it with the
  smoke's gates (its sigma read from the run directory equal to the
  golden's), ``seed_run`` and ``distill`` from its teacher (a kl_sigma_floor
  and f32 student reading beside the smoke's student).

Torch is pinned to one thread (step loops)."""

import json
import os

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.tools import gauss_pairing as gp
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs
from nsynth_wavenet_tpu_torch.training import runner
from test_parallel_wavenet import ST_SMALL, TE_SMALL
from tools import gauss_pairing_readings as gpr
from tools import make_golden_ckpt

SIGMA_RTOL, SIGMA_ELEM_RTOL = 1e-5, 1e-4
STEPS, BATCH = 10, 4
METRIC_TOL, UPDATE_TOL = 1e-4, 1e-3
F64_METRIC_TOL, F64_UPDATE_TOL = 1e-8, 1e-4
# the smoke's student cut to two flows of two layers, its deconv width the
# golden teacher's (the transplant copies the teacher's stack in)
SMALL_STUDENT = dict(num_iaf_layers=[2, 2], num_stages=2, width=16, wave_length=1280)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def speech_ds(tmp_path_factory):
    ds = str(tmp_path_factory.mktemp("gauss_pairing") / "ds")
    qs.make_speech_corpus(ds, n_utts=4)
    return ds


def test_held_out_batch_equals_jax():
    got, want = gp.held_out_batch(3840), gpr.jax_held_out_batch(3840)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_golden_sigma_quantiles_equal_jax():
    model, params, meta = make_golden_ckpt.load_golden("gauss")
    assert meta["config"]["compute_dtype"] == "float32" and meta["train_steps"] == 30000
    want_sigma = gpr.jax_teacher_sigma(model, params)
    tmodel, tparams = gp.load_teacher("golden", "cpu")
    got_sigma = gp.teacher_sigma(tmodel, tparams, "cpu")
    assert got_sigma.shape == want_sigma.shape == (4, 3840)
    np.testing.assert_allclose(got_sigma, want_sigma, rtol=SIGMA_ELEM_RTOL)
    got, want = gp.sigma_stats(got_sigma), gp.sigma_stats(want_sigma)
    assert got.keys() == want.keys() and got["n"] == 15360
    for k in ("sigma_p01", "sigma_p10", "sigma_median", "sigma_p90", "sigma_mean",
              "log_sigma_mean", "share_below_floor"):
        assert got[k] == pytest.approx(want[k], rel=SIGMA_RTOL), k
    # the sharp 30k teacher of the records: median 0.00745, 73.9 % below 0.02
    assert 0.007 < want["sigma_median"] < 0.008 and 0.73 < want["share_below_floor"] < 0.75


@pytest.mark.parametrize("seed", (0, 1))
def test_trajectory_equals_jax(speech_ds, seed):
    teacher = (dict(TE_SMALL, loss_type="gauss"), 10)
    student = dict(ST_SMALL, loss_type="gauss", power_loss_factor=1.0)
    jrows, jsnaps, _, init = gpr.run_side("jax", teacher, student, seed, STEPS, speech_ds, BATCH,
                                          every=STEPS // 2)
    trows, tsnaps, _, _ = gpr.run_side("port", teacher, student, seed, STEPS, speech_ds, BATCH,
                                       every=STEPS // 2, threads=1)
    assert sorted(tsnaps) == sorted(jsnaps) == ["ema@10", "ema@5", "params@10", "params@5"]
    for k in ("kl_loss", "power_loss", "loss", "scale_tot"):
        assert len(trows[k]) == len(jrows[k]) == STEPS
        gap = gpr.metric_gap(jrows[k], trows[k])
        assert gap.max() <= METRIC_TOL, (k, gap)
    for tag in jsnaps:
        want, got = jsnaps[tag], tsnaps[tag]
        assert want.keys() == got.keys() == init.keys()
        err = gpr.state_distance(init, want, got)
        assert err <= UPDATE_TOL, (tag, err)
    # each snapshot is the state of its own step, not a view of the last
    k = next(iter(init))
    assert not np.array_equal(tsnaps["params@5"][k], tsnaps["params@10"][k])


@pytest.fixture(scope="module")
def jax_after_3(speech_ds):
    """The tiny pair's configs and teacher, JAX's whole state after 3 steps
    on the speech corpus's crops, and its fourth step's metrics and state
    (the f32 step from that state)."""
    teacher = (dict(TE_SMALL, loss_type="gauss"), 10)
    student = dict(ST_SMALL, loss_type="gauss", power_loss_factor=1.0)
    setup = gpr.shared_setup(teacher, student, 0)
    jte_cfg, jst_cfg, _, _, te_np, st_np = setup
    rows, snaps, kept = gpr.jax_trajectory(jte_cfg, te_np, jst_cfg, st_np,
                                           gp.crop_pairs(speech_ds, BATCH, 1280, 0), 4, 0,
                                           every=4, keep=(3,))
    return setup, kept[3], ({k: v[3:] for k, v in rows.items()}, snaps)


@pytest.mark.parametrize("dtype", (np.float32, np.float64), ids=("f32", "f64"))
def test_step_from_jax_state_equals_jax(speech_ds, jax_after_3, monkeypatch, dtype):
    """The shadow readings' single step: JAX's whole state after 3 steps
    given to both sides (cast to ``dtype``; JAX's DFT tables in f64 for
    f64), then the fourth step on the same crops and draws.  Readings: f32
    metrics 1.1e-7, params 2.1e-6, EMA 1.5e-5; f64 metrics 3.4e-10, params
    1.5e-5, EMA 1.4e-5.  In f64 the teacher's head output is still rounded
    to f32 on both sides and its exp's last bit differs between XLA and
    torch (tests/test_torch_distill_losses.py): Adam carries that into the
    deconv's first layer, whose gradient elements are that small.  f64
    limits: F64_METRIC_TOL 1e-8, F64_UPDATE_TOL 1e-4."""
    import itertools

    import jax

    (jte_cfg, jst_cfg, tte_cfg, tst_cfg, te_np, _), after_3, (jrows, jsnaps) = jax_after_3

    def crops_from(k):
        return itertools.islice(gp.crop_pairs(speech_ds, BATCH, 1280, 0), k, None)

    js, te = gpr.cast_floats(after_3, dtype), gpr.cast_floats(te_np, dtype)
    if dtype == np.float64:
        monkeypatch.setattr(gpr.jstft, "_dft_matrices", gpr.f64_dft_tables)
        with jax.enable_x64(True):
            jrows, jsnaps, _ = gpr.jax_trajectory(jte_cfg, te, jst_cfg, None, crops_from(3), 1,
                                                  0, every=1, state=jax.tree_util.tree_map(
                                                      jax.numpy.asarray, js))
    tstate = gpr.port_state_of(js, dtype)
    assert tstate["step"] == 3 and tstate["opt_state"]["count"] == 3
    trows, tsnaps = gp.port_trajectory(tte_cfg, gpr.to_port(te, dtype), tst_cfg, None,
                                       crops_from(3), 1, 0, every=1, state=tstate)
    assert next(iter(tsnaps["params@4"].values())).dtype == np.float32  # flattened as JAX's
    tol = METRIC_TOL if dtype == np.float32 else F64_METRIC_TOL
    for k in ("kl_loss", "power_loss"):
        assert gpr.metric_gap(jrows[k], trows[k])[0] <= tol, k
    for part in ("params", "ema"):
        err = gpr.state_distance(gpr.flat_np(after_3[part]), jsnaps[f"{part}@4"],
                                 tsnaps[f"{part}@4"])
        assert err <= (UPDATE_TOL if dtype == np.float32 else F64_UPDATE_TOL), (part, err)


def test_compare_reads_windows_and_distances():
    rows = {"kl_loss": np.arange(4.0), "power_loss": np.ones(4)}
    init = {"a": np.zeros(3, np.float32)}
    snap = lambda v: {"params@2": {"a": np.full(3, v, np.float32)},  # noqa: E731
                      "ema@2": {"a": np.full(3, v, np.float32)},
                      "params@4": {"a": np.full(3, 2 * v, np.float32)},
                      "ema@4": {"a": np.full(3, 2 * v, np.float32)}, "init": init}
    ref = (rows, snap(1.0), {})
    other = ({"kl_loss": rows["kl_loss"] + [0, 0, 0, 0.3], "power_loss": rows["power_loss"]},
             snap(1.1), {})
    out = gpr.compare(ref, {"o": other}, every=2)
    assert out["windows"]["ref"]["kl_loss"] == [0.5, 2.5]
    assert out["windows"]["o"]["kl_loss"] == pytest.approx([0.5, 2.65])
    g = out["gaps"]["o"]
    assert g["ends"] == [2, 4] and g["kl_loss"] == pytest.approx([0.0, 0.1])
    assert g["params"] == pytest.approx([0.1, 0.1], rel=1e-5)


def test_step_draws_are_fixed_by_seed_and_step():
    a = gp.step_draws(0, 5, 4, 100)["base_x"]
    assert a.shape == (4, 100) and a.dtype == np.float32
    np.testing.assert_array_equal(a, gp.step_draws(0, 5, 4, 100)["base_x"])
    assert not np.array_equal(a, gp.step_draws(0, 6, 4, 100)["base_x"])
    assert not np.array_equal(a, gp.step_draws(1, 5, 4, 100)["base_x"])
    assert abs(float(a.std()) - 1.0) < 0.2


def test_crop_pairs_are_the_runners_streams(speech_ds):
    from nsynth_wavenet_tpu_torch.data import dataset as data_lib

    pairs = gp.crop_pairs(speech_ds, 2, 1280, 3)
    got = [next(pairs) for _ in range(3)]
    pairs.close()
    ds = data_lib.Dataset(speech_ds)
    it, it_rand = ds.batch_iterator(2, 1280, seed=3), ds.batch_iterator(2, 1280, seed=3 + 12345)
    for wav, wav_rand in got:
        np.testing.assert_array_equal(wav, next(it))
        np.testing.assert_array_equal(wav_rand, next(it_rand))
    it.close()
    it_rand.close()


@pytest.mark.parametrize("dtype", ("", "bfloat16"))
def test_teacher_run_from_golden(tmp_path, dtype):
    run = gp.teacher_run_from_weights("golden", str(tmp_path / "teacher"), "cpu", dtype or None)
    model, params = runner.load_teacher(run, "cpu")
    assert model.cfg.use_as_teacher and model.cfg.loss_type == "gauss"
    assert model.cfg.compute_dtype == (dtype or "float32")
    golden = weights.load_npz(os.path.join(gp.GOLDEN_GAUSS, "params.npz"), device="cpu")
    want, got = weights.flatten(golden), weights.flatten(params)
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert os.listdir(os.path.join(run, "ckpt")) == ["30000"]
    with pytest.raises(ValueError, match="Gauss teacher"):
        gp.teacher_sigma(*gp.load_teacher(os.path.join(gp.GOLDEN_GAUSS, "..", "tiny_mol"),
                                          "cpu"), "cpu")


def _small_tool(monkeypatch):
    monkeypatch.setattr(runner, "LOG_EVERY", 1)
    monkeypatch.setattr(qs, "GAUSS_TEACHER_CFG",
                        dict(qs.GAUSS_TEACHER_CFG, num_layers=2, num_stages=2, width=16,
                             skip_width=16, deconv_width=128, wave_length=1280))
    monkeypatch.setattr(qs, "STUDENT_CFG", dict(qs.STUDENT_CFG, **SMALL_STUDENT))
    monkeypatch.setattr(qs, "HELD_OUT_SAMPLES", 1200)
    monkeypatch.setattr(qs, "N_HELD_OUT", 2)
    monkeypatch.setattr(qs, "TEACHER_BATCH", 2)
    monkeypatch.setattr(qs, "STUDENT_BATCH", 2)


def test_distill_from_golden_end_to_end(tmp_path, monkeypatch, capsys):
    _small_tool(monkeypatch)
    out = tmp_path / "out"
    rc = gp.cli(["distill", "--teacher", "golden", "--steps", "3", "--seed", "1", "--device",
                 "cpu", "--work_dir", str(tmp_path / "work"), "--out_dir", str(out)])
    text = capsys.readouterr().out
    for line in ("teacher sigma", "student kl", "student free-run std",
                 "student mel corr matched", "QUALITY SMOKE (student):", "distill seed1_floor0"):
        assert line in text, line
    with open(out / "distill_seed1_floor0.json") as f:
        rep = json.load(f)
    assert rc == (0 if rep["passed"] else 1)
    assert set(rep["gates"]) == {"kl", "power", "amp", "track"}
    assert rep["teacher_sigma"] == gp.read_sigma("golden", "cpu")
    assert rep["steps"] == 3 and [r["step"] for r in rep["series"]] == [1, 2, 3]
    assert os.path.exists(out / "student_seed1_floor0_train.log")
    with open(tmp_path / "work" / "student_seed1_floor0.json") as f:
        cfg = json.load(f)
    assert cfg["kl_sigma_floor"] == 0.0 and cfg["num_iters"] == 3


def test_seed_run_end_to_end(tmp_path, monkeypatch, capsys):
    _small_tool(monkeypatch)
    out, work = tmp_path / "out", tmp_path / "work"
    rc = gp.cli(["seed_run", "--steps", "2", "--segment", "1", "--seed", "1", "--device", "cpu",
                 "--work_dir", str(work), "--out_dir", str(out)])
    assert rc == 0
    with open(out / "report.json") as f:
        rep = json.load(f)
    assert [r["step"] for r in rep["teacher_sigma"]] == [1, 2]
    assert all(0 < r["sigma_median"] for r in rep["teacher_sigma"])
    assert os.path.exists(out / "teacher_train.log")
    assert rep["teacher_sigma"][-1]["sigma_median"] == gp.read_sigma(
        rep["teacher_dir"], "cpu")["sigma_median"]
    # its teacher is distilled by ``distill``: the smoke's student and a reading's
    reps = {}
    for extra in ([], ["--floor", "0.02", "--student_dtype", "float32"]):
        gp.cli(["distill", "--teacher", rep["teacher_dir"], "--steps", "2", "--seed", "1",
                "--device", "cpu", "--work_dir", str(work), "--out_dir", str(out)] + extra)
    for tag in ("seed1_floor0", "seed1_floor0.02_float32_student"):
        with open(out / f"distill_{tag}.json") as f:
            reps[tag] = json.load(f)
        with open(work / f"student_{tag}.json") as f:
            reps[tag]["cfg"] = json.load(f)
    smoke, reading = reps["seed1_floor0"], reps["seed1_floor0.02_float32_student"]
    assert smoke["cfg"]["kl_sigma_floor"] == 0.0 and "compute_dtype" not in smoke["cfg"]
    assert reading["cfg"]["kl_sigma_floor"] == 0.02
    assert reading["cfg"]["compute_dtype"] == reading["student_dtype"] == "float32"
    # students of one seed started in one second share a slug: each has a root of its own
    assert os.path.dirname(smoke["run_dir"]) != os.path.dirname(reading["run_dir"])
