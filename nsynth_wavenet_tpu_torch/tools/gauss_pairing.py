"""Readings of the quality smoke's Gauss (ClariNet) pairing: how sharp a
Gauss teacher is, how the smoke's student distils from a given teacher, and
the port's side of a distillation trajectory on shared inputs.

Every command takes --corpus speech|speech_84d3f9e (default speech): the
smoke's speech-like corpus, or the earlier one of the JAX package's passing
Gauss run (tools/speech_corpus_84d3f9e.py); its dataset and held-out clips.

    python -m nsynth_wavenet_tpu_torch.tools.gauss_pairing sigma --teacher DIR
        the teacher's predicted sigma_p on the smoke's held-out speech clips,
        teacher-forced on their first wave_length samples: p01 / p10 /
        median / p90 / mean and the share below 0.02.  DIR is a port teacher
        run directory (the EMA of its latest checkpoint) or a directory with
        meta.json and params.npz (a committed golden such as
        tests/golden/tiny_gauss, or an EMA export); "golden" names
        tests/golden/tiny_gauss.
    python -m nsynth_wavenet_tpu_torch.tools.gauss_pairing distill \\
            --teacher golden|DIR [--seed S] [--steps N] [--floor F] \\
            [--student_dtype float32]
        the smoke's student distilled for N steps at seed S (its init, crop
        order and draws) from that teacher, with kl_sigma_floor F (the
        smoke's 0 by default), then the smoke's gates unchanged (KL, power,
        amplitude, tracking).  A golden or export directory is first
        written as a port teacher run directory (its config and a
        checkpoint whose EMA is its weights) for runner.load_teacher;
        --teacher_dtype bfloat16 runs that teacher in the smoke's own
        compute dtype, --student_dtype float32 the student in f32 (the
        smoke's is bf16).  A floor above 0 or an f32 student is a reading
        only: the smoke's config keeps kl_sigma_floor 0 and bf16.  On the
        card the distilled student then also serves the same held-out mels
        through parallelgen.synthesize_cuda (the flow kernel), on the same
        noise: its amplitude and tracking readings beside the plain
        path's, and the flow kernel's launches (a reading, not a gate).  A
        kernel that does not build or launch ends the command with an
        error; on the CPU the reading is absent and the report says so.
    python -m nsynth_wavenet_tpu_torch.tools.gauss_pairing seed_run \\
            [--seed S] [--steps N] [--segment K]
        the smoke's Gauss teacher trained from scratch at seed S in segments
        of K steps (resumes of one run), its sigma read after each; its
        run directory is a --teacher for ``distill``, and its EMA is written
        as a golden directory (export_teacher) under <out_dir>/teacher_ema.
    python -m nsynth_wavenet_tpu_torch.tools.gauss_pairing trajectory \
            --out FILE.npz [--steps 10000] [--every 1000] [--twin LEAF]
        the port's side of the shared run on 84d3f9e's corpus: the committed
        teacher and init of tests/golden/port_gauss_84d3f9e (--twin: every
        element of one leaf of TWIN_LEAVES one ulp up), the corpus's crops in
        the runner's order and step_draws(1, step, ...), the smoke's student
        config; every step's metrics and the params / EMA every --every
        steps to FILE.npz (save_trajectory).  The JAX side and ``compare``
        are tools/gauss_pairing_84d3f9e_readings.py.
    python -m nsynth_wavenet_tpu_torch.tools.gauss_pairing tpu_precision \
            [--seed S] [--steps N]
        ``seed_run`` and then ``distill`` from its teacher at seed S, both
        under tpu_precision.tpu_default_precision() (the STFTs' and the mel
        product's f32 contractions on bf16-rounded operands, as a TPU
        computes them); reports under <out_dir>/tpu_seed<S>.

``port_trajectory`` is the port's side of a distillation on shared inputs
(crop_pairs, step_draws): tools/gauss_pairing_readings.py runs it beside the
JAX package's step on the same teacher, student init, crops and draws.

Every command runs on the card unless --device cpu, and refuses a card that
is not there.  Checkpoints and
datasets go under --work_dir (a new temporary directory by default), the
reports (report.json, each run's train.log and metrics.jsonl) under
--out_dir."""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_GAUSS = os.path.join(REPO, "tests", "golden", "tiny_gauss")
# the committed seed-1 teacher of 84d3f9e's corpus and the shared run's student init
PORT_84D3F9E = os.path.join(REPO, "tests", "golden", "port_gauss_84d3f9e")
INIT_NPZ = "init_seed1.npz"
SHARED_SEED = 1
WINDOW = 1000  # the shared run's window of steps
# the leaves of the port's twins: one ulp up on every element of one of them
TWIN_LEAVES = ("['flows'][0]['layers'][0]['dilated']['w']", "['flows'][0]['start_conv']['w']",
               "['flows'][1]['out2_scale']['w']")
FLOOR = 0.02  # the share-below reading's sigma
QUANTILES = (("p01", 0.01), ("p10", 0.1), ("median", 0.5), ("p90", 0.9))
# the per-step metrics a trajectory keeps (the Gauss student's loss dict)
TRAJ_METRICS = ("loss", "kl_loss", "power_loss", "scale_tot")
DRAW_KEY = 2024  # the trajectory's base-noise stream: numpy's generator of (DRAW_KEY, seed, step)


# ---- the teacher's sigma ---------------------------------------------------------


def _resolve(teacher):
    return GOLDEN_GAUSS if teacher == "golden" else teacher


def is_weights_dir(path) -> bool:
    """A directory of meta.json + params.npz (a golden or an EMA export)."""
    return all(os.path.exists(os.path.join(path, n)) for n in ("meta.json", "params.npz"))


def load_teacher(teacher, device="cuda"):
    """(Wavenet, params) of a port teacher run directory (the EMA of its
    latest checkpoint) or of a weights directory (is_weights_dir; int8 leaves
    dequantised as weights.load_npz does)."""
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.training import runner

    path = _resolve(teacher)
    if is_weights_dir(path):
        cfg = config_lib.load_config(os.path.join(path, "meta.json"))
        return Wavenet(cfg), weights.load_npz(os.path.join(path, "params.npz"), device=device)
    return runner.load_teacher(path, device)


def held_out_batch(wave_length, corpus="speech"):
    """The smoke's held-out clips of a speech-like corpus cut to their first
    wave_length samples and the mel frames that cover them: (wav, mel) as
    f32 numpy."""
    wavs = qs.held_out_wavs(corpus)
    mel = stft_ops.melspectrogram_np(wavs)
    return (np.ascontiguousarray(wavs[:, :wave_length], np.float32),
            np.ascontiguousarray(mel[:, : wave_length // 200 + 1], np.float32))


def sigma_stats(sigma) -> dict:
    """The quantiles, mean and share below FLOOR of an array of sigmas."""
    s = np.asarray(sigma, np.float64).ravel()
    out = {f"sigma_{name}": float(np.quantile(s, q)) for name, q in QUANTILES}
    out.update(sigma_mean=float(s.mean()), log_sigma_mean=float(np.log(s).mean()),
               share_below_floor=float((s < FLOOR).mean()), n=int(s.size))
    return out


@torch.no_grad()
def teacher_sigma(model, params, device="cuda", corpus="speech"):
    """The teacher's sigma_p [N, wave_length] on held_out_batch, teacher-forced
    (no dropout), as a float64 numpy array."""
    from nsynth_wavenet_tpu_torch.models.wavenet import no_tf32
    from nsynth_wavenet_tpu_torch.ops import distributions as dist

    if model.cfg.loss_type != "gauss":
        raise ValueError(f"a Gauss teacher is needed, not {model.cfg.loss_type!r}")
    wav, mel = held_out_batch(model.cfg.wave_length, corpus)
    wav, mel = torch.from_numpy(wav).to(device), torch.from_numpy(mel).to(device)
    with no_tf32():
        ff, _ = model.feed_forward_train(
            params, {"wav_scaled": model.encode_signal(wav)["wav_scaled"], "mel": mel})
    _, sigma = dist.mean_std_from_out_params(ff["out_params"].float(), use_log_scales=True)
    return sigma.cpu().numpy().astype(np.float64)


def read_sigma(teacher, device="cuda", corpus="speech") -> dict:
    model, params = load_teacher(teacher, device)
    return sigma_stats(teacher_sigma(model, params, device, corpus))


# ---- a teacher run directory from weights ------------------------------------------


def teacher_run_from_weights(weights_dir, run_dir, device="cuda", compute_dtype=None):
    """Write ``run_dir`` as a port teacher run directory whose latest
    checkpoint's EMA (and params) are the weights of ``weights_dir``: the
    config json from its meta.json (compute_dtype replaced when given) and
    ckpt/<its train_steps or 0>/state.pt.  Returns run_dir."""
    from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib

    path = _resolve(weights_dir)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = dict(meta["config"])
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    config_lib.wavenet_config_from_dict(cfg)  # refuse a student's or a malformed config
    os.makedirs(run_dir, exist_ok=True)
    qs._write_config(os.path.join(run_dir, "teacher.json"), cfg)
    params = weights.load_npz(os.path.join(path, "params.npz"), device=device)
    step = int(meta.get("train_steps") or meta.get("step") or 0)
    ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt")).save(
        step, {"params": params, "ema": params, "step": step})
    return run_dir


# ---- the trajectory on shared inputs ----------------------------------------------


def crop_pairs(ds_dir, batch, wave_length, seed):
    """The distillation runner's two crop streams of one process (seed and
    seed + 12345), as numpy (wav, wav_rand) pairs, endless."""
    from nsynth_wavenet_tpu_torch.data import dataset as data_lib

    ds = data_lib.Dataset(ds_dir)
    it = ds.batch_iterator(batch, wave_length, seed=seed)
    it_rand = ds.batch_iterator(batch, wave_length, seed=seed + 12345)
    try:
        while True:
            yield next(it), next(it_rand)
    finally:
        it.close()
        it_rand.close()


def step_draws(seed, step, batch, length) -> dict:
    """A Gauss student's draws at ``step``: the base noise N(0, 1) [B, L]
    f32 from numpy's generator of (DRAW_KEY, seed, step)."""
    rng = np.random.default_rng((DRAW_KEY, seed, step))
    return {"base_x": rng.standard_normal((batch, length), dtype=np.float32)}


def port_trajectory(te_cfg, te_params, st_cfg, st_init, crops, steps, draw_seed, every=100,
                    device="cpu", state=None):
    """The port's distillation of a student (config st_cfg, params st_init
    before the teacher-deconv transplant) from a frozen teacher (te_cfg,
    te_params) for ``steps`` steps on the (wav, wav_rand) pairs of
    ``crops`` with step_draws(draw_seed, step): the runner's step without
    its data-dependent init and norm_stats.  ``state``: a train state to
    start from instead (st_init unused; the crops then begin at its step).
    Returns ({metric: [steps] float64}, {"params@k" / "ema@k": {key path:
    array}} at every step k that ``every`` divides and at the last)."""
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import (
        ParallelWavenet,
        transplant_teacher_deconv,
    )
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.training import train_lib

    if st_cfg.use_weight_norm or st_cfg.norm_feat or st_cfg.loss_type != "gauss":
        raise ValueError("the trajectory runs a Gauss student without weight norm or norm_feat")
    teacher = Wavenet(dataclasses.replace(te_cfg, use_as_teacher=True))
    pwn = ParallelWavenet(st_cfg, teacher)
    if state is None:
        params = transplant_teacher_deconv(st_init, te_params)
        opt = train_lib.make_student_optimizer(st_cfg, params)
        state = train_lib.make_train_state(params, opt)
    else:
        opt = train_lib.make_student_optimizer(st_cfg, state["params"])
    step_fn = train_lib.make_pwn_train_step(pwn, te_params, opt)
    length = pwn.sample_length(stft_ops.num_mel_frames(st_cfg.wave_length))
    rows = {k: [] for k in TRAJ_METRICS}
    snaps = {}
    start = state["step"]
    dtype = next(iter(weights.flatten(state["params"]).values())).dtype  # the inputs follow it
    for step, (wav, wav_rand) in zip(range(start, start + steps), crops):
        draws = {k: torch.from_numpy(v).to(device, dtype)
                 for k, v in step_draws(draw_seed, step, wav.shape[0], length).items()}
        state, m = step_fn(state, torch.from_numpy(wav).to(device, dtype),
                           torch.from_numpy(wav_rand).to(device, dtype), None, draws=draws)
        for k in TRAJ_METRICS:
            rows[k].append(float(m[k]))
        if (step + 1) % every == 0 or step + 1 == start + steps:
            for part in ("params", "ema"):  # copies: to_jax_params shares a CPU tensor's memory
                snaps[f"{part}@{step + 1}"] = {
                    k: np.array(v) for k, v in weights.flatten(
                        weights.to_jax_params(state[part])).items()}
    return {k: np.asarray(v, np.float64) for k, v in rows.items()}, snaps



def window_means(rows, window=100) -> dict:
    """{metric: [mean of each window of ``window`` steps]} (the last window
    may be shorter)."""
    return {k: [float(np.mean(v[i: i + window])) for i in range(0, len(v), window)]
            for k, v in rows.items()}


# ---- the shared run on 84d3f9e's corpus -------------------------------------------


def _sorted_tree(tree):
    """Dicts with their keys sorted, as JAX's pytrees hold them."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted_tree(v) for v in tree]
    return tree


def is_flow_deconv(key) -> bool:
    """A leaf of a flow's deconv stack (a copy of the teacher's at the start)."""
    return key.startswith("['flows']") and "['deconv']" in key


def load_shared_init(te_params, directory=PORT_84D3F9E, device="cpu"):
    """The shared run's student at step 0: the leaves of ``directory``'s
    init_seed1.npz (JAX's smoke-student init at seed 1, every leaf but the
    flows' deconv stacks) with the teacher's deconv transplanted into each
    flow (transplant_teacher_deconv), as the port's tree on ``device``."""
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import transplant_teacher_deconv

    with np.load(os.path.join(directory, INIT_NPZ)) as z:
        flat = {k: z[k] for k in z.files}
    tree = weights.from_jax_params(weights.unflatten(flat), device)
    return _sorted_tree(transplant_teacher_deconv(tree, te_params))


def ulp_twin(params, leaf):
    """params with every element of ``leaf`` (a key path) moved one f32 ulp
    up; the other leaves shared."""
    flat = weights.flatten(params)
    if leaf not in flat:
        raise KeyError(f"no leaf {leaf!r}")
    flat[leaf] = torch.nextafter(flat[leaf], torch.full_like(flat[leaf], float("inf")))
    return weights.unflatten(flat)


def save_trajectory(path, rows, snaps, init, **meta):
    """rows {metric: [steps]}, snaps {tag: {key: array}} and the init's
    leaves as one npz: metric/<k>, snap/<tag>/<key>, meta (json).  The flows'
    deconv leaves are left out of every snapshot (is_flow_deconv; nine tenths
    of the bytes)."""
    out = {f"metric/{k}": np.asarray(v) for k, v in rows.items()}
    for tag, flat in dict(snaps, init=init).items():
        out.update({f"snap/{tag}/{k}": np.asarray(v) for k, v in flat.items()
                    if not is_flow_deconv(k)})
    out["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **out)


def load_trajectory(path):
    """(rows, snaps, meta) of a save_trajectory file."""
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


def kl_ratio(kl, window=WINDOW, last=10) -> float:
    """r: the mean KL over window ``last`` (steps 9 001-10 000 at the
    defaults) over the mean over the first window (steps 1-1 000)."""
    kl = np.asarray(kl, np.float64)
    if len(kl) < last * window:
        raise ValueError(f"{len(kl)} steps: r needs {last * window}")
    return float(kl[(last - 1) * window: last * window].mean() / kl[:window].mean())


def kl_rise(kl, window=WINDOW, start=5, last=10) -> float:
    """The mean of the window means from step start * window + 1 to
    last * window over the first window's mean."""
    w = window_means({"kl": np.asarray(kl, np.float64)[: last * window]}, window)["kl"]
    return float(np.mean(w[start:last]) / w[0])


def band_rule(jax_kl, port_kls, widen=0.1, window=WINDOW) -> dict:
    """The decision rule of the shared run (PERF.md §6), on JAX's KL
    series and the port runs' (the port and its twins):
    * 'no_fault': JAX's r inside [min port r - widen, max port r + widen]
      and JAX's rise (kl_rise) at least the least of the port runs';
    * 'port_fault': JAX's r outside that band;
    * 'open': otherwise (r inside the band, JAX rising less)."""
    r_jax = kl_ratio(jax_kl, window)
    r_port = [kl_ratio(k, window) for k in port_kls]
    band = [min(r_port) - widen, max(r_port) + widen]
    rise_jax = kl_rise(jax_kl, window)
    rise_port = [kl_rise(k, window) for k in port_kls]
    inside = band[0] <= r_jax <= band[1]
    verdict = ("port_fault" if not inside
               else "no_fault" if rise_jax >= min(rise_port) else "open")
    return {"r_jax": r_jax, "r_port": r_port, "band": band, "rise_jax": rise_jax,
            "rise_port": rise_port, "verdict": verdict}


# ---- the CLI ----------------------------------------------------------------------


def _card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


def _copy_logs(run_dir, out_dir, prefix):
    for name in ("train.log", "metrics.jsonl"):
        src = os.path.join(run_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, f"{prefix}_{name}"))


def _student_series(run_dir):
    """The student's logged KL, power and scale metrics by step."""
    series = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            series.append({k: row[k] for k in row if k in ("step", "kl_loss", "power_loss")
                           or k.startswith("scale") or k.startswith("log_scale")})
    return series


def _ds_dir(work, corpus):
    return os.path.join(work, "ds" if corpus == "speech" else f"ds_{corpus}")


def kernel_reading(run_dir, mel, plain_audio, corpus, device):
    """The distilled student of ``run_dir`` served through
    parallelgen.synthesize_cuda on the held-out mels ``mel`` with the plain
    synthesis's generator (STUDENT_SEED): std, tracking (mel corr, msd, MCD
    matched vs mismatched, the smoke's tracking gate as a reading), its
    largest distance from ``plain_audio`` and the flow kernels' CUDA
    launches by name.  None off the card (the kernel runs only there)."""
    from nsynth_wavenet_tpu_torch import evaluation
    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk

    if torch.device(device).type != "cuda":
        return None
    cfg, params = evaluation.load_eval_model(run_dir, device=device)
    before = dict(flk.flow_stack.kernel_launches)
    audio = parallelgen.synthesize_cuda(
        ParallelWavenet(cfg), params, torch.from_numpy(mel).to(device),
        torch.Generator().manual_seed(qs.STUDENT_SEED)).cpu().numpy()
    launches = {k: n - before.get(k, 0) for k, n in flk.flow_stack.kernel_launches.items()
                if n - before.get(k, 0)}
    if not launches:
        raise RuntimeError("synthesize_cuda launched no flow kernel on the card")
    mt = qs.mel_track_metrics(audio, mel, qs.HELD_OUT_SAMPLES)
    return {"std": qs.student_amp_gate(audio)["std"], "corr": mt["corr"], "msd": mt["msd"],
            "mcd": mt["mcd"], "track": bool(qs.student_tracking_gate(mt, corpus)),
            "max_abs_diff_vs_plain": float(np.abs(audio - plain_audio).max()),
            "kernel_launches": launches}


def cmd_distill(args):
    """Distil the smoke's student from --teacher and gate it, then serve it
    through the flow kernel on the card (kernel_reading); writes
    <out_dir>/distill_<tag>.json.  Returns 0 when every gate passes."""
    tag = (f"seed{args.seed}_floor{args.floor:g}"
           + (f"_{args.teacher_dtype}_teacher" if args.teacher_dtype else "")
           + (f"_{args.student_dtype}_student" if args.student_dtype else "")
           + (f"_{args.corpus}" if args.corpus != "speech" else ""))
    work = args.work_dir
    ds_dir = _ds_dir(work, args.corpus)
    if not os.path.exists(os.path.join(ds_dir, "index.json")):
        qs.make_speech_corpus(ds_dir, corpus=args.corpus)
    teacher = _resolve(args.teacher)
    te_dir = teacher
    if args.teacher_dtype and not is_weights_dir(teacher):
        sys.exit("--teacher_dtype applies to a weights directory (meta.json + params.npz)")
    if is_weights_dir(teacher):
        te_dir = teacher_run_from_weights(teacher, os.path.join(work, f"teacher_{tag}"),
                                          args.device, args.teacher_dtype or None)
    te_sigma = read_sigma(te_dir, args.device, args.corpus)
    print("teacher sigma", json.dumps(te_sigma), flush=True)
    t0 = time.time()
    res = qs.distill_and_gate(te_dir, ds_dir, work, args.corpus, "gauss", args.steps,
                              args.device, seed=args.seed, tag=tag, kl_sigma_floor=args.floor,
                              compute_dtype=args.student_dtype or None)
    seconds = time.time() - t0
    (l0, kl0, pw0, _), (l1, kl1, pw1, _) = res["log_head"], res["log_tail"]
    os.makedirs(args.out_dir, exist_ok=True)
    _copy_logs(res["run_dir"], args.out_dir, f"student_{tag}")
    kernel = kernel_reading(res["run_dir"], res["mel"], res["audio"], args.corpus, args.device)
    if kernel is None:
        print("flow kernel reading: absent (no CUDA device; the kernel runs only on the card)",
              flush=True)
    else:
        mc, mmc = kernel["corr"]
        print(f"flow kernel (synthesize_cuda): std {kernel['std']:.4f} (plain {res['std']:.4f}); "
              f"mel corr matched {mc:.3f} vs mismatched {mmc:.3f} (plain "
              f"{res['metrics']['corr'][0]:.3f} vs {res['metrics']['corr'][1]:.3f}); msd "
              f"{kernel['msd'][0]:.3f} vs {kernel['msd'][1]:.3f}; mcd {kernel['mcd'][0]:.1f} vs "
              f"{kernel['mcd'][1]:.1f} dB; tracking {kernel['track']}; launches "
              f"{kernel['kernel_launches']}; max |kernel - plain| "
              f"{kernel['max_abs_diff_vs_plain']:.4g}", flush=True)
    report = {"corpus": args.corpus, "teacher": args.teacher,
              "teacher_dtype": args.teacher_dtype or "as stored",
              "student_dtype": args.student_dtype or "as the smoke's",
              "teacher_sigma": te_sigma, "seed": args.seed, "steps": args.steps,
              "floor": args.floor, "seconds": seconds,
              "kl": [kl0, kl1], "power": [pw0, pw1], "loss": [l0, l1],
              "std": res["std"], "corr": res["metrics"]["corr"], "msd": res["metrics"]["msd"],
              "mcd": res["metrics"]["mcd"], "gates": {k: bool(v) for k, v in
                                                      res["gates"].items()},
              "passed": bool(res["passed"]), "run_dir": res["run_dir"],
              "flow_kernel": kernel if kernel is not None else "absent: not on a CUDA device",
              "series": _student_series(res["run_dir"])}
    if torch.device(args.device).type == "cuda":
        report["card"] = _card_line()
    _write_json(os.path.join(args.out_dir, f"distill_{tag}.json"), report)
    print("distill", tag, json.dumps({k: v for k, v in report.items() if k != "series"}),
          flush=True)
    return 0 if report["passed"] else 1


def export_teacher(te_dir, out_dir, report, device="cuda"):
    """Write the EMA of ``te_dir``'s latest checkpoint as a golden directory
    (make_golden_ckpt's int8 storage and meta.json layout): params.npz and a
    meta.json naming its config, corpus, seed, steps, card and the sigma
    quantiles of the stored (round-tripped) weights (report: cmd_seed_run's).
    Returns out_dir."""
    from nsynth_wavenet_tpu_torch.tools import make_golden_ckpt
    from nsynth_wavenet_tpu_torch.training import runner

    _, ema = runner.load_teacher(te_dir, device)
    stored, _ = make_golden_ckpt.round_trip(ema)
    with open(runner.find_config_json(te_dir)) as f:
        cfg = json.load(f)
    meta = {"config": cfg, "head": cfg["loss_type"], "train_steps": report["steps"],
            "corpus": report["corpus"], "seed": report["seed"], "card": report.get("card", "cpu")}
    make_golden_ckpt.write_golden(out_dir, stored, meta)
    sigma = read_sigma(out_dir, device, report["corpus"])
    meta["teacher_sigma"] = {k: v for k, v in sigma.items() if k != "log_sigma_mean"}
    _write_json(os.path.join(out_dir, "meta.json"), meta)
    return out_dir


def cmd_seed_run(args):
    """Train the smoke's Gauss teacher in segments, reading its sigma after
    each; writes <out_dir>/report.json."""
    from nsynth_wavenet_tpu_torch.training import runner

    work = args.work_dir
    ds_dir = _ds_dir(work, args.corpus)
    qs.make_speech_corpus(ds_dir, corpus=args.corpus)
    cfg_path = qs._write_config(os.path.join(work, "teacher_gauss.json"),
                                dict(qs.GAUSS_TEACHER_CFG, num_iters=args.steps))
    t0 = time.time()
    readings, te_dir = [], None
    for target in range(args.segment, args.steps + args.segment, args.segment):
        target = min(target, args.steps)
        kw = ({"log_root": os.path.join(work, "runs"), "config_path": cfg_path}
              if te_dir is None else {"logdir": te_dir})
        te_dir, _ = runner.train_wavenet(train_path=ds_dir, total_batch_size=qs.TEACHER_BATCH,
                                         num_steps=target, ckpt_every_steps=args.segment,
                                         seed=args.seed, device=args.device, **kw)
        readings.append(dict(step=target, seconds=time.time() - t0,
                             **read_sigma(te_dir, args.device, args.corpus)))
        print("teacher", json.dumps(readings[-1]), flush=True)
        if target == args.steps:
            break
    os.makedirs(args.out_dir, exist_ok=True)
    _copy_logs(te_dir, args.out_dir, "teacher")
    report = {"corpus": args.corpus, "seed": args.seed, "steps": args.steps,
              "teacher_dir": te_dir,
              "teacher_sigma": readings, "seconds": time.time() - t0}
    if torch.device(args.device).type == "cuda":
        report["card"] = _card_line()
    export_teacher(te_dir, os.path.join(args.out_dir, "teacher_ema"), report, args.device)
    _write_json(os.path.join(args.out_dir, "report.json"), report)
    print("report", json.dumps(report), flush=True)
    return 0


def shared_configs(teacher=PORT_84D3F9E):
    """The shared run's configs: the committed teacher's (meta.json) and the
    smoke's student (quality_smoke.STUDENT_CFG: bf16, kl_sigma_floor 0)."""
    with open(os.path.join(teacher, "meta.json")) as f:
        te_dict = json.load(f)["config"]
    return (config_lib.wavenet_config_from_dict(te_dict),
            config_lib.pwn_config_from_dict(dict(qs.STUDENT_CFG)))


def cmd_trajectory(args):
    """The port's side of the shared run: the committed teacher and init
    (with --twin, one leaf moved one ulp), the crops of the corpus's dataset
    in the runner's order and step_draws(--seed, step); writes --out."""
    ds_dir = _ds_dir(args.work_dir, args.corpus)
    if not os.path.exists(os.path.join(ds_dir, "index.json")):
        qs.make_speech_corpus(ds_dir, corpus=args.corpus)
    te_cfg, st_cfg = shared_configs(args.teacher)
    te_params = weights.load_npz(os.path.join(args.teacher, "params.npz"), device=args.device)
    init = load_shared_init(te_params, args.teacher, args.device)
    if args.twin:
        init = ulp_twin(init, args.twin)
    init_flat = {k: v.copy() for k, v in weights.flatten(weights.to_jax_params(init)).items()}
    crops = crop_pairs(ds_dir, qs.STUDENT_BATCH, st_cfg.wave_length, args.seed)
    t0 = time.time()
    try:
        rows, snaps = port_trajectory(te_cfg, te_params, st_cfg, init, crops, args.steps,
                                      args.seed, args.every, args.device)
    finally:
        crops.close()
    meta = {"side": "port", "device": args.device, "seed": args.seed, "steps": args.steps,
            "twin": args.twin, "corpus": args.corpus, "seconds": time.time() - t0,
            "torch": torch.__version__, "threads": torch.get_num_threads()}
    if torch.device(args.device).type == "cuda":
        meta["card"] = _card_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_trajectory(args.out, rows, snaps, init_flat, **meta)
    w = window_means(rows, WINDOW)
    print("trajectory", json.dumps(dict(meta, out=args.out, kl_windows=w["kl_loss"],
                                        power_windows=w["power_loss"])), flush=True)
    return 0


def cmd_tpu_precision(args):
    """The smoke's teacher (seed_run) and then its student (distill) at
    --seed, both under tpu_precision.tpu_default_precision(); the reports go
    under <out_dir>/tpu_seed<S>."""
    from nsynth_wavenet_tpu_torch.tools.tpu_precision import tpu_default_precision

    out_dir = os.path.join(args.out_dir, f"tpu_seed{args.seed}")
    sub = dict(vars(args), out_dir=out_dir)
    with tpu_default_precision():
        cmd_seed_run(argparse.Namespace(**sub))
        with open(os.path.join(out_dir, "report.json")) as f:
            te_dir = json.load(f)["teacher_dir"]
        return cmd_distill(argparse.Namespace(**dict(sub, teacher=te_dir, floor=0.0,
                                                     teacher_dtype="", student_dtype="")))


def cmd_sigma(args):
    r = read_sigma(args.teacher, args.device, args.corpus)
    print(json.dumps(dict(teacher=args.teacher, corpus=args.corpus, **r)))
    return 0


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("sigma", "distill", "seed_run", "trajectory", "tpu_precision"):
        shared = name == "trajectory"
        p = sub.add_parser(name)
        p.add_argument("--device", default="cuda")
        p.add_argument("--work_dir", default="")
        p.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "gauss_pairing"))
        p.add_argument("--seed", type=int, default=SHARED_SEED if shared else 0)
        p.add_argument("--steps", type=int, default=10 * WINDOW if shared else 30000)
        p.add_argument("--corpus", default="speech_84d3f9e" if shared else "speech",
                       choices=list(qs.SPEECH_CORPORA))
        if name in ("sigma", "distill"):
            p.add_argument("--teacher", default="golden")
        if name == "distill":
            p.add_argument("--floor", type=float, default=0.0)
            p.add_argument("--teacher_dtype", default="", choices=["", "float32", "bfloat16"])
            p.add_argument("--student_dtype", default="", choices=["", "float32", "bfloat16"])
        if name in ("seed_run", "tpu_precision"):
            p.add_argument("--segment", type=int, default=5000)
        if shared:
            p.add_argument("--teacher", default=PORT_84D3F9E)
            p.add_argument("--twin", default="", choices=("",) + TWIN_LEAVES)
            p.add_argument("--every", type=int, default=WINDOW)
            p.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu for the CPU")
    args.work_dir = args.work_dir or tempfile.mkdtemp(prefix="gauss_pairing_")
    return {"sigma": cmd_sigma, "distill": cmd_distill, "seed_run": cmd_seed_run,
            "trajectory": cmd_trajectory, "tpu_precision": cmd_tpu_precision}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(cli())
