"""The Gauss (ClariNet) pairing of the quality smoke, the JAX package
against the port, on the CPU (ROADMAP Queue 3 item 7):

  python tools/gauss_pairing_readings.py sigma
      the committed 30k-step Gauss teacher (tests/golden/tiny_gauss, f32
      compute) read by the JAX package: Wavenet.feed_forward teacher-forced
      on the smoke's held-out speech clips (their first wave_length
      samples), sigma from ops/distributions.py mean_std_from_out_params;
      its quantiles beside the port's reading of the same directory
      (nsynth_wavenet_tpu_torch/tools/gauss_pairing.py) and each one's
      relative difference
  python tools/gauss_pairing_readings.py run --side jax|port --seed S \\
          --steps N [--threads T] [--dtype bfloat16] --out FILE.npz
      one side's distillation trajectory on shared inputs: the golden
      teacher carried to both sides, the smoke's student config (its
      compute dtype --dtype, f32 by default; bf16 is the smoke's own) from
      the JAX package's init at seed S (weights.from_jax_params to the
      port), the crops of the smoke's speech corpus in the runner's order
      (gauss_pairing.crop_pairs, one stream fed to both sides) and base
      noise drawn with numpy from (S, step) (gauss_pairing.step_draws; the
      JAX step's base_noise is patched to return it, as
      tools/step_conditioning.py does); the JAX step compiled without XLA's
      excess precision, the port at T torch threads.  FILE.npz holds every
      step's metrics and the student's params and EMA every --every steps
  python tools/gauss_pairing_readings.py compare REF.npz OTHER.npz ...
      the runs' KL, power and scale_tot as means over --every-step windows,
      and each OTHER against REF: the largest relative metric difference in
      each window and the params / EMA distance at each snapshot,
      ||other - ref|| / ||ref - init|| over all leaves together

The port against itself at 1 and 8 threads (two ``run --side port``) is the
yardstick: both run one dtype, so they part by roundoff alone.  Needs the repo's
JAX package on the CPU, as its tests run it."""

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nsynth_wavenet_tpu import config as jconfig  # noqa: E402
from nsynth_wavenet_tpu.data import synthetic as jsynthetic  # noqa: E402
from nsynth_wavenet_tpu.models import parallel_wavenet as jpwn_lib  # noqa: E402
from nsynth_wavenet_tpu.models import wavenet as jwavenet  # noqa: E402
from nsynth_wavenet_tpu.ops import distributions as jdist  # noqa: E402
from nsynth_wavenet_tpu.ops import stft as jstft  # noqa: E402
from nsynth_wavenet_tpu.training import train_lib as jtl  # noqa: E402
from nsynth_wavenet_tpu_torch import config as tconfig  # noqa: E402
from nsynth_wavenet_tpu_torch import weights  # noqa: E402
from nsynth_wavenet_tpu_torch.tools import gauss_pairing as gp  # noqa: E402
from nsynth_wavenet_tpu_torch.tools import quality_smoke as tqs  # noqa: E402
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib  # noqa: E402
from tools import make_golden_ckpt  # noqa: E402

if jax.config.jax_platforms != "cpu":
    jax.config.update("jax_platforms", "cpu")


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def to_port(tree, dtype):
    """A JAX tree as the port's tree of CPU tensors in ``dtype`` (not
    through weights.from_jax_params, which holds f32)."""
    if dtype == np.float32:
        return weights.from_jax_params(tree, device="cpu")
    return tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a, dtype)),
                             jax.tree_util.tree_map(np.asarray, tree))


# ---- the teacher's sigma ---------------------------------------------------------


def jax_held_out_batch(wave_length):
    """The smoke's held-out speech clips as the JAX package makes them
    (tools/quality_smoke.py main / main_student: four one-second utterances
    from seed 1234), cut to wave_length samples, and their mel frames."""
    rng = np.random.default_rng(1234)
    wavs = np.stack([jsynthetic.make_speechlike_utterance(rng, 16000, 1.0) for _ in range(4)])
    mel = jstft.melspectrogram_np(wavs)
    return (np.ascontiguousarray(wavs[:, :wave_length], np.float32),
            np.ascontiguousarray(mel[:, : wave_length // 200 + 1], np.float32))


def jax_teacher_sigma(model, params):
    """The JAX package's sigma_p [N, wave_length] of a Gauss teacher on
    the held-out batch, teacher-forced, as float64."""
    wav, mel = jax_held_out_batch(model.cfg.wave_length)
    enc = model.encode_signal({"wav": wav})
    ff, _ = jax.jit(lambda p: model.feed_forward(p, {"wav_scaled": enc["wav_scaled"],
                                                    "mel": mel}))(params)
    _, sigma = jdist.mean_std_from_out_params(ff["out_params"].astype(np.float32),
                                              use_log_scales=True)
    return np.asarray(sigma, np.float64)


def case_sigma(args):
    model, params, meta = make_golden_ckpt.load_golden("gauss")
    jax_s = gp.sigma_stats(jax_teacher_sigma(model, params))
    port_s = gp.read_sigma("golden", "cpu")
    for k in jax_s:
        print(f"golden tiny_gauss {k}: jax {jax_s[k]!r} port {port_s[k]!r} rel "
              f"{abs(port_s[k] - jax_s[k]) / max(abs(jax_s[k]), 1e-30):.2e}")
    print(json.dumps({"teacher": "tests/golden/tiny_gauss", "config": meta["config"],
                      "jax": jax_s, "port": port_s}))


# ---- trajectories ----------------------------------------------------------------


def jax_trajectory(te_cfg, te_params, st_cfg, st_init, crops, steps, draw_seed, every=100,
                   state=None, keep=()):
    """The JAX package's side of gauss_pairing.port_trajectory: JAX's
    configs (te_cfg, st_cfg), numpy trees (te_params, st_init before the
    teacher-deconv transplant), the same crops and draws; the step compiled
    once without excess precision.  ``state``: a JAX train state to start
    from instead (the crops then begin at its step).  Returns (rows, snaps)
    as the port's, and {k: the whole state on the host after step k} for
    each k of ``keep``."""
    teacher = jwavenet.Wavenet(dataclasses.replace(te_cfg, use_as_teacher=True))
    pwn = jpwn_lib.ParallelWavenet(st_cfg, teacher)
    if state is None:
        params = jpwn_lib.transplant_teacher_deconv(st_init, te_params)
        opt = jtl.make_student_optimizer(st_cfg, params)
        state = jtl.make_train_state(params, opt)
    else:
        opt = jtl.make_student_optimizer(st_cfg, state["params"])
    step_fn = jtl.make_pwn_train_step(pwn, jax.tree_util.tree_map(jax.numpy.asarray, te_params),
                                      opt)
    slot = {}
    length = pwn.sample_length(jstft.num_mel_frames(st_cfg.wave_length))
    rows = {k: [] for k in gp.TRAJ_METRICS}
    snaps, kept = {}, {}
    start = int(state["step"])
    dtype = np.asarray(jax.tree_util.tree_leaves(state["params"])[0]).dtype
    with patched(jpwn_lib.ParallelWavenet, "base_noise", lambda self, rng, B, L: slot["base_x"]):
        def fn(state, wav, wav_rand, draws):
            slot.clear()
            slot.update(draws)
            return step_fn(state, wav, wav_rand, jax.random.PRNGKey(2))

        compiled = None
        for step, (wav, wav_rand) in zip(range(start, start + steps), crops):
            draws = {k: v.astype(dtype) for k, v in
                     gp.step_draws(draw_seed, step, wav.shape[0], length).items()}
            wav, wav_rand = wav.astype(dtype), wav_rand.astype(dtype)
            if compiled is None:
                compiled = jax.jit(fn).lower(state, wav, wav_rand, draws).compile(
                    compiler_options={"xla_allow_excess_precision": False})
            state, m = compiled(state, wav, wav_rand, draws)
            for k in gp.TRAJ_METRICS:
                rows[k].append(float(m[k]))
            if (step + 1) % every == 0 or step + 1 == start + steps:
                host = jax.device_get(state)
                for part in ("params", "ema"):
                    snaps[f"{part}@{step + 1}"] = flat_np(host[part])
            if step + 1 in keep:
                kept[step + 1] = jax.device_get(state)
    return {k: np.asarray(v, np.float64) for k, v in rows.items()}, snaps, kept


def flat_np(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in weights.flatten(jax.tree_util.tree_map(np.asarray, tree)).items()}


def shared_setup(teacher, st_overrides, seed):
    """Both sides' configs, the teacher's params (a numpy tree) and the
    student's init (JAX's at ``seed``, a numpy tree):
    (jte_cfg, jst_cfg, tte_cfg, tst_cfg, te_np, st_np).  ``teacher``: a
    golden head name (its model, params and config from load_golden) or a
    (config dict, JAX init key) pair."""
    if isinstance(teacher, str):
        jte, te_np, meta = make_golden_ckpt.load_golden(teacher)
        te_dict = meta["config"]
    else:
        te_dict, key = teacher
        jte = jwavenet.Wavenet(jconfig.wavenet_config_from_dict(te_dict))
        te_np = jte.init_params(jax.random.PRNGKey(key))
    te_np = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), te_np)
    jst_cfg = jconfig.pwn_config_from_dict(st_overrides)
    st_np = jax.tree_util.tree_map(np.asarray, jpwn_lib.ParallelWavenet(jst_cfg).init_params(
        jax.random.PRNGKey(seed)))
    return (jte.cfg, jst_cfg, tconfig.wavenet_config_from_dict(te_dict),
            tconfig.pwn_config_from_dict(st_overrides), te_np, st_np)


def run_side(side, teacher, st_overrides, seed, steps, ds_dir, batch, every=100, threads=1):
    """One side's trajectory on the shared inputs: (rows, snaps, seconds,
    the student's params at step 0 (after the transplant) flat)."""
    jte_cfg, jst_cfg, tte_cfg, tst_cfg, te_np, st_np = shared_setup(teacher, st_overrides, seed)
    init = flat_np(jpwn_lib.transplant_teacher_deconv(st_np, te_np))
    crops = gp.crop_pairs(ds_dir, batch, jst_cfg.wave_length, seed)
    t0 = time.time()
    try:
        if side == "jax":
            rows, snaps, _ = jax_trajectory(jte_cfg, te_np, jst_cfg, st_np, crops, steps, seed,
                                            every)
        else:
            torch.set_num_threads(threads)
            rows, snaps = gp.port_trajectory(
                tte_cfg, weights.from_jax_params(te_np, "cpu"), tst_cfg,
                weights.from_jax_params(st_np, "cpu"), crops, steps, seed, every, "cpu")
    finally:
        crops.close()
    return rows, snaps, time.time() - t0, init


def save_trajectory(path, rows, snaps, init, **meta):
    out = {f"metric/{k}": v for k, v in rows.items()}
    for tag, flat in dict(snaps, init=init).items():
        out.update({f"snap/{tag}/{k}": v for k, v in flat.items()})
    out["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **out)


def load_trajectory(path):
    rows, snaps = {}, {}
    with np.load(path) as z:
        for name in z.files:
            if name.startswith("metric/"):
                rows[name[7:]] = z[name]
            elif name.startswith("snap/"):
                tag, key = name[5:].split("/", 1)
                snaps.setdefault(tag, {})[key] = z[name]
        meta = json.loads(str(z["meta"]))
    return rows, snaps, meta


def state_distance(init, ref, other) -> float:
    """||other - ref|| / ||ref - init|| over all leaves together (f64)."""
    num = sum(float(np.sum((other[k].astype(np.float64) - ref[k]) ** 2)) for k in ref)
    den = sum(float(np.sum((ref[k].astype(np.float64) - init[k]) ** 2)) for k in ref)
    return (num / den) ** 0.5


def metric_gap(ref, other) -> np.ndarray:
    """|other - ref| / max(|ref|, 1) a step."""
    return np.abs(other - ref) / np.maximum(np.abs(ref), 1.0)


def compare(ref, others, every=100):
    """Readings of other trajectories against ``ref``: {'windows': ref's and
    each other's window means, 'gaps': per other, per window, the largest
    metric_gap of each metric and the params / EMA distance at the
    window's end}."""
    rows0, snaps0, _ = ref
    out = {"windows": {"ref": gp.window_means(rows0, every)}, "gaps": {}}
    for name, (rows, snaps, _) in others.items():
        out["windows"][name] = gp.window_means(rows, every)
        g = {k: [float(metric_gap(rows0[k], rows[k])[i: i + every].max())
                 for i in range(0, len(rows0[k]), every)] for k in rows0}
        ends = sorted(int(t.split("@")[1]) for t in snaps0 if t.startswith("params@"))
        for part in ("params", "ema"):
            g[part] = [state_distance(snaps0["init"], snaps0[f"{part}@{e}"],
                                      snaps[f"{part}@{e}"]) for e in ends]
        g["ends"] = ends
        out["gaps"][name] = g
    return out


def smoke_student_cfg(dtype="float32"):
    """The smoke's student config (quality_smoke.STUDENT_CFG) with its
    compute dtype ``dtype`` (f32 by default; the smoke's own is bf16)."""
    return dict(tqs.STUDENT_CFG, compute_dtype=dtype)


def case_run(args):
    ds_dir = os.path.join(args.work_dir, "ds")
    if not os.path.exists(os.path.join(ds_dir, "index.json")):
        tqs.make_speech_corpus(ds_dir)
    rows, snaps, seconds, init = run_side(args.side, "gauss", smoke_student_cfg(args.dtype),
                                          args.seed, args.steps, ds_dir, tqs.STUDENT_BATCH,
                                          args.every, args.threads)
    save_trajectory(args.out, rows, snaps, init, side=args.side, seed=args.seed,
                    steps=args.steps, dtype=args.dtype,
                    threads=args.threads if args.side == "port" else None, seconds=seconds)
    print(json.dumps({"out": args.out, "side": args.side, "seed": args.seed,
                      "dtype": args.dtype, "threads": args.threads, "seconds": seconds,
                      "windows": gp.window_means(rows, args.every)}))


def case_compare(args):
    ref = load_trajectory(args.files[0])
    others = {f: load_trajectory(f) for f in args.files[1:]}
    out = compare(ref, others, args.every)
    print(f"ref {args.files[0]}: {json.dumps(ref[2])}")
    for name, w in out["windows"].items():
        for k in ("kl_loss", "power_loss", "scale_tot"):
            print(f"{name} {k} by window: " + " ".join(f"{v:.5g}" for v in w[k]))
    for name, g in out["gaps"].items():
        print(f"{name} against ref, meta {json.dumps(others[name][2])}")
        for k in ("kl_loss", "power_loss", "scale_tot", "loss"):
            print(f"  {k} max rel gap by window: " + " ".join(f"{v:.2e}" for v in g[k]))
        for part in ("params", "ema"):
            print(f"  {part} distance at steps {g['ends']}: "
                  + " ".join(f"{v:.2e}" for v in g[part]))
    print(json.dumps(out["gaps"]))


def cast_floats(tree, dtype):
    """A host tree with its floating leaves in ``dtype``."""
    def cast(a):
        a = np.asarray(a)
        return a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a

    return jax.tree_util.tree_map(cast, tree)


def f64_dft_tables(n_fft):
    """JAX's DFT tables (ops/stft.py _dft_matrices) in f64: the JAX package
    rounds them to f32, which would bound an f64 comparison's power loss."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang), -np.sin(ang)


def port_state_of(js, dtype):
    """JAX's distillation state (on the host) as the port's in ``dtype``:
    params, EMA, step, and the Adam count and moments of the trained leaves
    (tests/test_torch_distill_step.py _port_state, any dtype)."""
    adam = next(x for x in js["opt_state"].inner_states["train"].inner_state if hasattr(x, "mu"))
    moments = lambda tree: [torch.from_numpy(np.array(a, dtype))  # noqa: E731
                            for a in jax.tree_util.tree_leaves(tree)]
    return {"params": to_port(js["params"], dtype), "ema": to_port(js["ema"], dtype),
            "opt_state": {"count": int(adam.count), "mu": moments(adam.mu),
                          "nu": moments(adam.nu)},
            "step": int(js["step"])}


def worst_leaves(before, ref, other, n=3):
    """The ``n`` leaves that hold most of ||other - ref||^2: (leaf, share,
    ||other - ref|| / ||ref - before|| over the leaf)."""
    d = {k: float(np.sum((other[k].astype(np.float64) - ref[k]) ** 2)) for k in ref}
    total = sum(d.values()) or 1.0
    rows = []
    for k in sorted(d, key=d.get, reverse=True)[:n]:
        moved = float(np.linalg.norm(ref[k].astype(np.float64) - before[k]))
        rows.append((k, d[k] / total, d[k] ** 0.5 / moved if moved else float("inf")))
    return rows


def case_shadow(args):
    """Single steps from JAX's state along its trajectory: at each step k of
    --at, JAX's whole state after k steps given to both sides, then step
    k + 1 on the same crops and draws: JAX and the port (at 1 and at 8
    threads) in f32, and both sides again in f64 from that state cast up
    (JAX's DFT tables in f64 too).
    Each step's metric gaps, the update distances between every pair, and
    the leaves that hold most of the f32 port-against-JAX distance."""
    at = sorted(int(k) for k in args.at.split(","))
    ds_dir = os.path.join(args.work_dir, "ds")
    if not os.path.exists(os.path.join(ds_dir, "index.json")):
        tqs.make_speech_corpus(ds_dir)
    jte_cfg, jst_cfg, tte_cfg, tst_cfg, te_np, st_np = shared_setup(
        "gauss", smoke_student_cfg(), args.seed)

    def crops_from(k):
        return itertools.islice(gp.crop_pairs(ds_dir, tqs.STUDENT_BATCH, jst_cfg.wave_length,
                                              args.seed), k, None)

    _, _, kept = jax_trajectory(jte_cfg, te_np, jst_cfg, st_np, crops_from(0), at[-1],
                                args.seed, every=at[-1], keep=at)
    out = []
    for k in at:
        runs = {}
        for dtype, tag in ((np.float32, "32"), (np.float64, "64")):
            js, te = cast_floats(kept[k], dtype), cast_floats(te_np, dtype)
            tables = f64_dft_tables if dtype == np.float64 else jstft._dft_matrices
            with patched(jstft, "_dft_matrices", tables):
                with jax.enable_x64(dtype == np.float64):
                    rows, snaps, _ = jax_trajectory(
                        jte_cfg, te, jst_cfg, None, crops_from(k), 1, args.seed, every=1,
                        state=jax.tree_util.tree_map(jax.numpy.asarray, js))
            runs["jax" + tag] = (rows, snaps)
            for threads in ((1, 8) if tag == "32" else (1,)):
                torch.set_num_threads(threads)
                runs[f"port{tag}_t{threads}"] = gp.port_trajectory(
                    tte_cfg, to_port(te, dtype), tst_cfg, None, crops_from(k), 1, args.seed,
                    every=1, state=port_state_of(js, dtype))
        r = {"step": k + 1, "kl_loss": float(runs["jax32"][0]["kl_loss"][0])}
        for ref, other in (("jax32", "port32_t1"), ("port32_t1", "port32_t8"),
                           ("jax64", "port64_t1"), ("jax64", "jax32"), ("port64_t1", "port32_t1"),
                           ("jax64", "port32_t1")):
            for m in ("kl_loss", "power_loss", "scale_tot"):
                r[f"{m} {other} vs {ref}"] = float(
                    metric_gap(runs[ref][0][m], runs[other][0][m])[0])
            for part in ("params", "ema"):
                r[f"{part} {other} vs {ref}"] = state_distance(
                    flat_np(kept[k][part]), runs[ref][1][f"{part}@{k + 1}"],
                    runs[other][1][f"{part}@{k + 1}"])
        r["worst leaves port32_t1 vs jax32"] = worst_leaves(
            flat_np(kept[k]["params"]), runs["jax32"][1][f"params@{k + 1}"],
            runs["port32_t1"][1][f"params@{k + 1}"])
        out.append(r)
        print("shadow", json.dumps(r), flush=True)
    print(json.dumps({"seed": args.seed, "shadow": out}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="case", required=True)
    sub.add_parser("sigma")
    p = sub.add_parser("run")
    p.add_argument("--side", choices=["jax", "port"], required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--every", type=int, default=100)
    p.add_argument("--out", required=True)
    p.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(), "gauss_pairing_cpu"))
    p = sub.add_parser("shadow")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--at", default="20,100,300")
    p.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(), "gauss_pairing_cpu"))
    p = sub.add_parser("compare")
    p.add_argument("files", nargs="+")
    p.add_argument("--every", type=int, default=100)
    args = ap.parse_args(argv)
    {"sigma": case_sigma, "run": case_run, "shadow": case_shadow,
     "compare": case_compare}[args.case](args)


if __name__ == "__main__":
    main()
