"""The shared run of the Gauss (ClariNet) pairing on the corpus of the JAX
package's passing Gauss run (git 84d3f9e), the port
(nsynth_wavenet_tpu_torch/tools/gauss_pairing.py) against the JAX package
(tools/gauss_pairing_84d3f9e_readings.py), on the CPU:

* the committed teacher tests/golden/port_gauss_84d3f9e (the port's seed-1
  30k Gauss teacher of that corpus, trained on the card, in the goldens'
  int8 storage) and the shared run's student init init_seed1.npz: their
  fingerprints, the meta.json fields, both packages loading the teacher
  bit for bit, and the init equal to the JAX package's smoke-student init
  at seed 1 after the teacher-deconv transplant;
* the teacher's sigma_p quantiles on 84d3f9e's held-out clips read by the
  JAX package and by the port, within SIGMA_RTOL 1e-4 relative, and the
  card's reading in meta.json within CARD_SIGMA_RTOL 1e-3 (readings in the
  test);
* the first STEPS 5 steps of the shared run (teacher, init, crops, base
  noise) on both sides.  With the teacher and the student computing in f32,
  every step's KL and power within METRIC_TOL 1e-4 of max(|JAX|, 1), the
  limit of tests/test_torch_gauss_pairing.py (readings: 1e-7).  In the
  run's own bf16 they part further, and the limits are BF16_KL_TOL 5e-3 and
  BF16_POWER_TOL 1e-3 (readings in the test): a bf16 rounding that the two
  sides' f32 roundoff (the mel, the deconv's sums) sends to the other
  neighbour moves the teacher's mean by a bf16 step, and the KL weighs it by
  1 / sigma_p^2 with sigma_p near 0.005.  One part of that gap is JAX's own:
  XLA on the CPU rounds a bf16 sigmoid (the gates' half) to the wrong
  neighbour in about a third of its values, where the port's is the
  correctly rounded one (test_bf16_sigmoid_rounding);
* the port's ``trajectory`` command equal to the port's side of the run,
  its twin one ulp away in one leaf, and its refusal of a card that is not
  there;
* ``compare``'s windows, r, rise and band rule on made-up trajectories;
* ``tpu_precision`` end to end at a small size, its steps through the
  TPU-precision STFTs.

Torch is pinned to one thread (step loops)."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.tools import gauss_pairing as gp
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs
from nsynth_wavenet_tpu_torch.tools import tpu_precision as tp
from tools import gauss_pairing_84d3f9e_readings as g84
from tools import gauss_pairing_readings as gpr

TEACHER = gp.PORT_84D3F9E
SHA256 = {
    "params.npz": "513dc8e048898e42cf433708f1057d1071ada1860764086442014c4bdbf01471",
    "init_seed1.npz": "65ede4b46b35ed15d4f5388bf178a1d667c7f2b33e617d707cc8cd69abed0ca1",
}
SIGMA_RTOL, CARD_SIGMA_RTOL = 1e-4, 1e-3
STEPS, METRIC_TOL = 5, 1e-4
BF16_KL_TOL, BF16_POWER_TOL = 5e-3, 1e-3
SIGMA_KEYS = ("sigma_p01", "sigma_p10", "sigma_median", "sigma_p90", "sigma_mean",
              "share_below_floor")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A work directory whose ds_speech_84d3f9e is the corpus's dataset (the
    runs' own: 24 utterances of 2 s)."""
    path = str(tmp_path_factory.mktemp("gauss_84d3f9e"))
    g84.dataset(path)
    return path


@pytest.fixture(scope="module")
def jax_teacher():
    return g84.load_teacher(TEACHER)


def test_committed_files_fingerprints():
    for name, want in SHA256.items():
        with open(os.path.join(TEACHER, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == want, name


def test_meta_names_config_corpus_card_and_sigma():
    with open(os.path.join(TEACHER, "meta.json")) as f:
        meta = json.load(f)
    assert meta["config"] == dict(qs.GAUSS_TEACHER_CFG, num_iters=30000,
                                  compute_dtype="bfloat16")
    assert (meta["head"], meta["corpus"], meta["seed"], meta["train_steps"]) == (
        "gauss", "speech_84d3f9e", 1, 30000)
    assert meta["card"].startswith("NVIDIA H100 80GB HBM3, ") and meta["card"].endswith(" W")
    assert len(meta["commit"]) == 7 and meta["storage"].startswith("int8")
    assert set(SIGMA_KEYS) <= set(meta["teacher_sigma"]) and meta["teacher_sigma"]["n"] == 15360


def test_both_sides_load_the_teacher(jax_teacher):
    model, params, _ = jax_teacher
    assert model.cfg.loss_type == "gauss" and model.cfg.compute_dtype == "bfloat16"
    tmodel, tparams = gp.load_teacher(TEACHER, "cpu")
    assert tmodel.cfg.compute_dtype == "bfloat16" and tmodel.cfg.width == model.cfg.width == 128
    want, got = gpr.flat_np(params), weights.flatten(weights.to_jax_params(tparams))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_committed_init_is_jax_init_after_transplant(jax_teacher):
    _, te_np, _ = jax_teacher
    want = gpr.flat_np(g84.jax_init(te_np))
    got_jax = gpr.flat_np(g84.load_init_np(te_np, TEACHER))
    te = weights.from_jax_params(te_np, "cpu")
    got_port = weights.flatten(weights.to_jax_params(gp.load_shared_init(te, TEACHER)))
    assert want.keys() == got_jax.keys() == got_port.keys()
    assert list(got_port) == sorted(got_port, key=list(want).index)  # JAX's leaf order
    for k in want:
        np.testing.assert_array_equal(got_jax[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got_port[k], want[k], err_msg=k)
    deconv = [k for k in want if gp.is_flow_deconv(k)]
    assert len(deconv) == 8
    with np.load(os.path.join(TEACHER, gp.INIT_NPZ)) as z:
        assert not set(deconv) & set(z.files) and len(z.files) == len(want) - 8


def test_sigma_quantiles_equal_jax(jax_teacher):
    """Readings: the quantiles and the share below 0.02 equal, the mean
    1.6e-5 apart.  meta.json holds the port's reading on the card (cuDNN's
    bf16 convolutions), held to CARD_SIGMA_RTOL 1e-3 of JAX's (readings:
    1.1e-7 at the median, 5.1e-5 in the mean)."""
    model, params, meta = jax_teacher
    want = gp.sigma_stats(g84.jax_teacher_sigma(model, params))
    got = gp.read_sigma(TEACHER, "cpu", "speech_84d3f9e")
    for k in SIGMA_KEYS:
        assert got[k] == pytest.approx(want[k], rel=SIGMA_RTOL), k
        assert meta["teacher_sigma"][k] == pytest.approx(want[k], rel=CARD_SIGMA_RTOL), k
    assert 0.003 < want["sigma_median"] < 0.006  # a sharp teacher, as the smoke's own 30k teachers


@pytest.fixture(scope="module", params=("bfloat16", "float32"))
def shared_runs(work, request):
    """Both sides' first STEPS steps of the shared run, in the configs' bf16
    or with both models computing in f32."""
    ds = g84.dataset(work)
    torch.set_num_threads(1)
    dtype = request.param if request.param == "float32" else None
    jax_run = g84.run_side("jax", STEPS, STEPS, ds, dtype=dtype)
    port_run = g84.run_side("port", STEPS, STEPS, ds, threads=1, dtype=dtype)
    return request.param, jax_run, port_run


def test_shared_trajectory_equals_jax(shared_runs):
    """Readings, the largest of the 5 steps: f32 KL 9.8e-8, power 6.6e-7;
    bf16 KL 1.9e-3 (1.6e-3 at the first step, a forward pass from the
    shared init), power 2.1e-4."""
    dtype, (jrows, jsnaps, _, jinit), (trows, tsnaps, _, tinit) = shared_runs
    assert sorted(jsnaps) == sorted(tsnaps) == [f"ema@{STEPS}", f"params@{STEPS}"]
    tol = ({"kl_loss": METRIC_TOL, "power_loss": METRIC_TOL} if dtype == "float32"
           else {"kl_loss": BF16_KL_TOL, "power_loss": BF16_POWER_TOL})
    for k in ("kl_loss", "power_loss", "loss", "scale_tot"):
        assert len(jrows[k]) == len(trows[k]) == STEPS
        gap = gpr.metric_gap(jrows[k], trows[k])
        assert gap.max() <= tol.get(k, tol["kl_loss"]), (k, gap)
    assert all(np.array_equal(jinit[k], tinit[k]) for k in jinit)


def test_bf16_sigmoid_rounding():
    """The gates' bf16 sigmoid: the port's equals the exact sigmoid rounded
    to bf16; XLA's on the CPU, compiled as the shared run's JAX side is,
    differs from it by one or two bf16 steps, either way, in about a third
    of its values (readings: 0.38 of [-6, 6], 2 steps at most; 0.32 of the
    first deconv layer's outputs in the shared run).  The tanh half is
    correctly rounded on both sides."""
    import jax
    import jax.numpy as jnp

    x = np.linspace(-6.0, 6.0, 20001, dtype=np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x64 = xb.double().numpy()
    want_sig = torch.from_numpy(1.0 / (1.0 + np.exp(-x64))).to(torch.bfloat16).float().numpy()
    want_tanh = torch.from_numpy(np.tanh(x64)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(torch.sigmoid(xb).float().numpy(), want_sig)
    np.testing.assert_array_equal(torch.tanh(xb).float().numpy(), want_tanh)

    def strict(f):
        fn = lambda v: f(v.astype(jnp.bfloat16)).astype(jnp.float32)  # noqa: E731
        return np.array(jax.jit(fn).lower(x).compile(compiler_options=g84.STRICT)(x))

    np.testing.assert_array_equal(strict(jnp.tanh), want_tanh)
    steps = (torch.from_numpy(strict(jax.nn.sigmoid)).to(torch.bfloat16).view(torch.int16).int()
             - torch.from_numpy(want_sig).to(torch.bfloat16).view(torch.int16).int()).numpy()
    assert 0.2 < np.mean(steps != 0) < 0.6 and np.abs(steps).max() <= 2, np.unique(steps)
    assert (steps > 0).any() and (steps < 0).any()


def test_trajectory_command_is_the_ports_side(work, tmp_path, capsys):
    trows = g84.run_side("port", 2, 2, g84.dataset(work), threads=1)[0]
    outs = {}
    for twin in ("", gp.TWIN_LEAVES[0]):
        out = str(tmp_path / f"traj{twin and '_twin'}.npz")
        assert gp.cli(["trajectory", "--device", "cpu", "--steps", "2", "--every", "1",
                       "--work_dir", work, "--out", out] + (["--twin", twin] if twin else [])) == 0
        outs[twin] = gp.load_trajectory(out)
    assert "trajectory {" in capsys.readouterr().out
    rows, snaps, meta = outs[""]
    for k in gp.TRAJ_METRICS:
        np.testing.assert_array_equal(rows[k], trows[k][:2])
    assert sorted(snaps) == ["ema@1", "ema@2", "init", "params@1", "params@2"]
    assert not any(gp.is_flow_deconv(k) for s in snaps.values() for k in s)
    assert (meta["side"], meta["device"], meta["seed"], meta["twin"]) == ("port", "cpu", 1, "")
    init, twin_init = snaps["init"], outs[gp.TWIN_LEAVES[0]][1]["init"]
    for k in init:
        if k == gp.TWIN_LEAVES[0]:
            np.testing.assert_array_equal(twin_init[k], np.nextafter(init[k], np.inf))
        else:
            np.testing.assert_array_equal(twin_init[k], init[k])


def test_trajectory_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        gp.cli(["trajectory", "--out", str(tmp_path / "t.npz")])


def _series(head, tail, n=10 * gp.WINDOW):
    """A KL series that moves linearly from ``head`` to ``tail``."""
    return np.linspace(head, tail, n)


def test_band_rule_on_made_up_trajectories():
    ports = [_series(0.5, 0.8), _series(0.5, 0.7), _series(0.5, 0.75), _series(0.5, 0.85)]
    r = [gp.kl_ratio(k) for k in ports]
    assert r[0] == pytest.approx(np.mean(_series(0.5, 0.8)[9000:]) / np.mean(
        _series(0.5, 0.8)[:1000]))
    out = gp.band_rule(_series(0.5, 0.78), ports)
    assert out["verdict"] == "no_fault" and out["band"] == pytest.approx([min(r) - 0.1,
                                                                          max(r) + 0.1])
    assert gp.band_rule(_series(0.6, 0.3), ports)["verdict"] == "port_fault"
    assert gp.band_rule(_series(0.5, 1.4), ports)["verdict"] == "port_fault"
    # r inside the band, but the rise from 5 000 on smaller than every port run's
    flat_then_up = np.concatenate([np.full(9000, 0.5), np.full(1000, 0.65)])
    out = gp.band_rule(flat_then_up, ports)
    assert out["band"][0] <= out["r_jax"] <= out["band"][1]
    assert out["rise_jax"] < min(out["rise_port"]) and out["verdict"] == "open"
    with pytest.raises(ValueError, match="r needs 10000"):
        gp.kl_ratio(np.ones(9999))
    windows = gp.window_means({"kl_loss": _series(0.0, 1.0, 3000)}, gp.WINDOW)["kl_loss"]
    assert len(windows) == 3 and windows[0] < windows[1] < windows[2]


def test_compare_prints_windows_r_and_verdict(tmp_path, capsys):
    def save(name, kl):
        rows = {"kl_loss": kl, "power_loss": 2 * kl, "scale_tot": kl / 10, "loss": 3 * kl}
        snap = {"['flows'][0]['out1']['w']": np.ones(2, np.float32),
                "['flows'][0]['deconv']['up_1']['w']": np.ones(2, np.float32)}
        gp.save_trajectory(str(tmp_path / name), rows, {"params@10000": snap}, snap,
                           side=name[:-4])
        return str(tmp_path / name)

    jax_f = save("jax.npz", _series(0.5, 0.78))
    ports = [save(f"port{i}.npz", _series(0.5, t)) for i, t in enumerate((0.8, 0.7, 0.75))]
    rows, snaps, meta = gp.load_trajectory(jax_f)
    assert meta == {"side": "jax"} and list(snaps["init"]) == ["['flows'][0]['out1']['w']"]
    g84.main(["compare", "--jax", jax_f] + ports)
    text = capsys.readouterr().out
    assert "kl_loss by 1000-step window" in text and "verdict no_fault" in text
    assert text.count("r jax ") == 1


def test_tpu_precision_command_end_to_end(tmp_path, monkeypatch):
    from test_torch_gauss_pairing import _small_tool

    _small_tool(monkeypatch)
    calls = {"center": 0, "pad_end": 0, "mel": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tp, "_stft_center", counted("center", tp._stft_center))
    monkeypatch.setattr(tp, "_stft_pad_end", counted("pad_end", tp._stft_pad_end))
    monkeypatch.setattr(tp, "_melspec_from_spec", counted("mel", tp._melspec_from_spec))
    out = tmp_path / "out"
    rc = gp.cli(["tpu_precision", "--steps", "2", "--segment", "1", "--seed", "1", "--device",
                 "cpu", "--corpus", "speech_84d3f9e", "--work_dir", str(tmp_path / "work"),
                 "--out_dir", str(out)])
    with open(out / "tpu_seed1" / "report.json") as f:
        teacher = json.load(f)
    with open(out / "tpu_seed1" / "distill_seed1_floor0_speech_84d3f9e.json") as f:
        student = json.load(f)
    assert rc == (0 if student["passed"] else 1)
    assert [r["step"] for r in teacher["teacher_sigma"]] == [1, 2]
    assert student["teacher"] == teacher["teacher_dir"] and student["steps"] == 2
    # the teacher's steps take the conditioning mel, the student's the power loss too
    assert calls["center"] >= 4 and calls["mel"] >= 4 and calls["pad_end"] >= 4
    assert stft_unpatched()


def stft_unpatched():
    from nsynth_wavenet_tpu_torch.ops import stft as stft_ops

    return stft_ops.stft_center.__module__ == stft_ops.__name__ and (
        stft_ops.melspec_from_spec.__module__ == stft_ops.__name__)

