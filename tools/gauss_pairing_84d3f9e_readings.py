"""The Gauss (ClariNet) pairing on the corpus of the JAX package's passing
Gauss run (git 84d3f9e), the JAX package against the port, on shared
inputs (ROADMAP Queue 3 item 7):

  python tools/gauss_pairing_84d3f9e_readings.py init
      the shared run's student init: the JAX package's smoke-student init at
      seed 1 (ParallelWavenet.init_params(PRNGKey(1)), as its runner makes
      it) after transplant_teacher_deconv from the committed teacher
      tests/golden/port_gauss_84d3f9e, written there as init_seed1.npz
      without the flows' deconv leaves (the teacher's, put back on load by
      gauss_pairing.load_shared_init)
  python tools/gauss_pairing_84d3f9e_readings.py sigma
      the committed teacher's sigma_p on 84d3f9e's held-out clips read by the
      JAX package (its Wavenet.feed_forward compiled without excess
      precision) beside the port's reading, and each quantile's relative
      difference
  python tools/gauss_pairing_84d3f9e_readings.py run --side jax|port \\
          [--steps 10000] [--every 1000] [--threads T] --out FILE.npz
      one side's shared run on the CPU: the committed teacher and init, the
      crops of 84d3f9e's corpus in the runner's order
      (gauss_pairing.crop_pairs), base noise gauss_pairing.step_draws(1,
      step, ...), the smoke's student config (bf16, kl_sigma_floor 0); JAX
      compiled without excess precision (gauss_pairing_readings
      .jax_trajectory, in chunks of --chunk steps, FILE.npz rewritten after
      each), the port at T torch threads.  FILE.npz as
      gauss_pairing.save_trajectory writes it (the card side:
      ``python -m nsynth_wavenet_tpu_torch.tools.gauss_pairing trajectory``)
  python tools/gauss_pairing_84d3f9e_readings.py compare --jax JAX.npz \\
          PORT.npz [PORT.npz ...]
      every run's KL / power / scale_tot means over 1 000-step windows, each
      run's r (mean KL over steps 9 001-10 000 over steps 1-1 000) and rise,
      and gauss_pairing.band_rule's verdict

The JAX side takes about 1 s a step on eight CPU cores (10 000 steps: about
2.5-3 h).  Needs the repo's JAX package on the CPU, as its tests run it."""

import argparse
import dataclasses
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
from nsynth_wavenet_tpu.models import parallel_wavenet as jpwn_lib  # noqa: E402
from nsynth_wavenet_tpu.ops import distributions as jdist  # noqa: E402
from nsynth_wavenet_tpu.ops import stft as jstft  # noqa: E402
from nsynth_wavenet_tpu_torch import weights  # noqa: E402
from nsynth_wavenet_tpu_torch.tools import gauss_pairing as gp  # noqa: E402
from nsynth_wavenet_tpu_torch.tools import quality_smoke as tqs  # noqa: E402
from tools import gauss_pairing_readings as gpr  # noqa: E402
from tools import make_golden_ckpt  # noqa: E402

if jax.config.jax_platforms != "cpu":
    jax.config.update("jax_platforms", "cpu")

CORPUS = "speech_84d3f9e"
STRICT = {"xla_allow_excess_precision": False}


def load_teacher(directory=gp.PORT_84D3F9E):
    """(JAX Wavenet, params as a numpy tree, meta) of the committed teacher,
    loaded as a golden is."""
    model, params, meta = make_golden_ckpt.load_golden(directory)
    return model, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), meta


def jax_init(te_np, seed=gp.SHARED_SEED):
    """The JAX package's smoke-student init at ``seed`` after the teacher's
    deconv transplant, as a numpy tree."""
    cfg = jconfig.pwn_config_from_dict(dict(tqs.STUDENT_CFG))
    st = jpwn_lib.ParallelWavenet(cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, jpwn_lib.transplant_teacher_deconv(st, te_np))


def load_init_np(te_np, directory=gp.PORT_84D3F9E):
    """The committed init as the JAX side's numpy tree (the teacher's deconv
    transplanted back into each flow)."""
    with np.load(os.path.join(directory, gp.INIT_NPZ)) as z:
        tree = weights.unflatten({k: z[k] for k in z.files})
    return jax.tree_util.tree_map(np.asarray, jpwn_lib.transplant_teacher_deconv(tree, te_np))


def case_init(args):
    _, te_np, _ = load_teacher(args.teacher)
    flat = gpr.flat_np(jax_init(te_np))
    kept = {k: v for k, v in flat.items() if not gp.is_flow_deconv(k)}
    path = os.path.join(args.teacher, gp.INIT_NPZ)
    np.savez(path, **kept)
    print(json.dumps({"out": path, "leaves": len(kept), "values": int(sum(
        v.size for v in kept.values())), "left_out_deconv_leaves": len(flat) - len(kept)}))


def jax_teacher_sigma(model, params, corpus=CORPUS):
    """The JAX package's sigma_p [N, wave_length] of a Gauss teacher on the
    held-out clips of ``corpus`` (the port's clips, JAX's mel), teacher-forced,
    compiled without excess precision, as float64."""
    wavs = tqs.held_out_wavs(corpus)
    mel = jstft.melspectrogram_np(wavs)
    L = model.cfg.wave_length
    wav = np.ascontiguousarray(wavs[:, :L], np.float32)
    mel = np.ascontiguousarray(mel[:, : L // 200 + 1], np.float32)
    enc = model.encode_signal({"wav": wav})

    def fn(p):
        ff, _ = model.feed_forward(p, {"wav_scaled": enc["wav_scaled"], "mel": mel})
        return jdist.mean_std_from_out_params(ff["out_params"].astype(np.float32),
                                              use_log_scales=True)[1]

    return np.asarray(jax.jit(fn).lower(params).compile(compiler_options=STRICT)(params),
                      np.float64)


def case_sigma(args):
    model, params, meta = load_teacher(args.teacher)
    jax_s = gp.sigma_stats(jax_teacher_sigma(model, params))
    port_s = gp.read_sigma(args.teacher, "cpu", CORPUS)
    for k in jax_s:
        print(f"{k}: jax {jax_s[k]!r} port {port_s[k]!r} rel "
              f"{abs(port_s[k] - jax_s[k]) / max(abs(jax_s[k]), 1e-30):.2e}")
    print(json.dumps({"teacher": args.teacher, "meta_sigma": meta.get("teacher_sigma"),
                      "jax": jax_s, "port": port_s}))


def run_side(side, steps, every, ds_dir, threads=1, teacher=gp.PORT_84D3F9E, chunk=0,
             on_chunk=None, dtype=None):
    """One side's shared run on the CPU: (rows, snaps, seconds, init flat).
    JAX runs in chunks of ``chunk`` steps (all at once when 0), each from the
    last one's state on the same crop stream, calling on_chunk(rows, snaps,
    seconds) after each.  ``dtype``: the teacher's and the student's compute
    dtype instead of the configs' (bf16), as a reading."""
    jte, te_np, _ = load_teacher(teacher)
    te_cfg, st_cfg = gp.shared_configs(teacher)
    jst_cfg = jconfig.pwn_config_from_dict(dict(tqs.STUDENT_CFG))
    jte_cfg = jte.cfg
    if dtype:
        te_cfg, st_cfg, jte_cfg, jst_cfg = (dataclasses.replace(c, compute_dtype=dtype)
                                            for c in (te_cfg, st_cfg, jte_cfg, jst_cfg))
    st_np = load_init_np(te_np, teacher)
    init = gpr.flat_np(st_np)
    crops = gp.crop_pairs(ds_dir, tqs.STUDENT_BATCH, jst_cfg.wave_length, gp.SHARED_SEED)
    t0 = time.time()
    try:
        if side == "jax":
            rows, snaps, state, done = {k: np.zeros(0) for k in gp.TRAJ_METRICS}, {}, None, 0
            while done < steps:
                n = min(chunk or steps, steps - done)
                part, psnaps, kept = gpr.jax_trajectory(
                    jte_cfg, te_np, jst_cfg, st_np if state is None else None, crops, n,
                    gp.SHARED_SEED, every, state=state, keep=(done + n,))
                state, done = kept[done + n], done + n
                rows = {k: np.concatenate([rows[k], part[k]]) for k in rows}
                snaps.update(psnaps)
                if on_chunk is not None:
                    on_chunk(rows, snaps, time.time() - t0)
        else:
            torch.set_num_threads(threads)
            te_params = weights.from_jax_params(te_np, "cpu")
            rows, snaps = gp.port_trajectory(
                te_cfg, te_params, st_cfg, gp.load_shared_init(te_params, teacher, "cpu"),
                crops, steps, gp.SHARED_SEED, every, "cpu")
    finally:
        crops.close()
    return rows, snaps, time.time() - t0, init


def dataset(work_dir):
    ds_dir = os.path.join(work_dir, f"ds_{CORPUS}")
    if not os.path.exists(os.path.join(ds_dir, "index.json")):
        tqs.make_speech_corpus(ds_dir, corpus=CORPUS)
    return ds_dir


def case_run(args):
    meta = {"side": args.side, "device": "cpu", "seed": gp.SHARED_SEED, "steps": args.steps,
            "twin": "", "corpus": CORPUS, "threads": args.threads if args.side == "port" else None}
    init = gpr.flat_np(load_init_np(load_teacher()[1]))

    def save(rows, snaps, seconds):  # the run so far, rewritten after each chunk
        gp.save_trajectory(args.out, rows, snaps, init, **dict(
            meta, seconds=seconds, steps_done=len(rows["kl_loss"])))
        print(json.dumps({"steps_done": len(rows["kl_loss"]), "seconds": seconds}), flush=True)

    rows, snaps, seconds, _ = run_side(args.side, args.steps, args.every, dataset(args.work_dir),
                                       args.threads, chunk=args.chunk, on_chunk=save)
    save(rows, snaps, seconds)
    w = gp.window_means(rows, gp.WINDOW)
    print(json.dumps(dict(meta, out=args.out, seconds=seconds, kl_windows=w["kl_loss"])))


def compare(jax_run, port_runs, window=gp.WINDOW):
    """{'windows': {name: window means by metric}, 'rule': band_rule} of the
    JAX run and the port runs ({name: (rows, snaps, meta)})."""
    runs = dict({"jax": jax_run}, **port_runs)
    return {"windows": {n: gp.window_means(r[0], window) for n, r in runs.items()},
            "rule": gp.band_rule(jax_run[0]["kl_loss"],
                                 [r[0]["kl_loss"] for r in port_runs.values()],
                                 window=window)}


def case_compare(args):
    jax_run = gp.load_trajectory(args.jax)
    port_runs = {os.path.basename(f): gp.load_trajectory(f) for f in args.port}
    out = compare(jax_run, port_runs)
    for name, w in out["windows"].items():
        meta = jax_run[2] if name == "jax" else port_runs[name][2]
        keys = ("side", "device", "twin", "steps", "seconds", "card")
        print(f"{name}: {json.dumps({k: meta.get(k) for k in keys})}")
        for k in ("kl_loss", "power_loss", "scale_tot"):
            print(f"  {k} by {gp.WINDOW}-step window: " + " ".join(f"{v:.4f}" for v in w[k]))
    rule = out["rule"]
    names = list(port_runs)
    print(f"r jax {rule['r_jax']:.4f}; port " + ", ".join(
        f"{n} {r:.4f}" for n, r in zip(names, rule["r_port"])))
    print(f"rise jax {rule['rise_jax']:.4f}; port " + ", ".join(
        f"{n} {r:.4f}" for n, r in zip(names, rule["rise_port"])))
    print(f"band [{rule['band'][0]:.4f}, {rule['band'][1]:.4f}]; verdict {rule['verdict']}")
    print(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="case", required=True)
    for name in ("init", "sigma"):
        sub.add_parser(name).add_argument("--teacher", default=gp.PORT_84D3F9E)
    p = sub.add_parser("run")
    p.add_argument("--side", choices=["jax", "port"], required=True)
    p.add_argument("--steps", type=int, default=10 * gp.WINDOW)
    p.add_argument("--every", type=int, default=gp.WINDOW)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--chunk", type=int, default=gp.WINDOW,
                   help="JAX: steps between saves of the run so far")
    p.add_argument("--out", required=True)
    p.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(), "gauss_84d3f9e_cpu"))
    p = sub.add_parser("compare")
    p.add_argument("--jax", required=True)
    p.add_argument("port", nargs="+")
    args = ap.parse_args(argv)
    {"init": case_init, "sigma": case_sigma, "run": case_run,
     "compare": case_compare}[args.case](args)


if __name__ == "__main__":
    main()
