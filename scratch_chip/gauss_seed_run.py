"""The Gauss teacher / Gauss student smoke of the quality tool
(nsynth_wavenet_tpu_torch.tools.quality_smoke --student --pairing gauss
--corpus speech --steps 30000) at a second training seed, with the configs'
detail_log on, and the readings needed to compare the run with the JAX
package's sigma-collapse diagnosis (benchmarks/RESULTS.md, round 5).

    python3 scratch_chip/gauss_seed_run.py [--steps 30000] [--seed 1]
        [--segment 5000] [--out_dir DIR] [--work_dir DIR]
        [--device cuda]

It trains the teacher in segments of --segment steps (each a resume of the
same run, so the run equals one call) and after each reads the EMA
teacher's predicted sigma on the held-out speech clips, teacher-forced.
Then two students distil from the final teacher at once, in two processes:
kl_sigma_floor 0 (the smoke's config) and 0.02 (the JAX package's rescue
value).  Each student's KL, power, scale_tot and per-flow scale_i come from
its metrics.jsonl; each is then served on the held-out mels and put through
the smoke's gates.  Only existing config fields and runner arguments are
used.  Checkpoints stay under --work_dir (a new temporary directory by
default); the report, the train.log files and the metrics.jsonl files go to
--out_dir.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nsynth_wavenet_tpu_torch.ops import distributions as dist  # noqa: E402
from nsynth_wavenet_tpu_torch.ops import stft as stft_ops  # noqa: E402
from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs  # noqa: E402

FLOOR = 0.02


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


@torch.no_grad()
def teacher_sigma(run_dir, state, device):
    """Quantiles of the EMA teacher's sigma on the held-out speech clips,
    teacher-forced on their first wave_length samples."""
    from nsynth_wavenet_tpu_torch import config as config_lib
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet, no_tf32
    from nsynth_wavenet_tpu_torch.training import runner

    cfg = config_lib.load_config(runner.find_config_json(run_dir))
    model = Wavenet(cfg)
    wavs = qs.held_out_wavs("speech")
    mel = stft_ops.melspectrogram_np(wavs)
    wav = torch.from_numpy(np.ascontiguousarray(wavs[:, : cfg.wave_length], np.float32)).to(device)
    m = torch.from_numpy(np.ascontiguousarray(mel[:, : cfg.wave_length // 200 + 1],
                                              np.float32)).to(device)
    with no_tf32():
        ff, _ = model.feed_forward_train(state["ema"], {"wav_scaled": model.encode_signal(wav)["wav_scaled"],
                                                        "mel": m})
    _, sigma = dist.mean_std_from_out_params(ff["out_params"].float(), use_log_scales=True)
    s = sigma.flatten().cpu().numpy()
    q = np.quantile(s, [0.01, 0.1, 0.5, 0.9])
    return {"sigma_p01": float(q[0]), "sigma_p10": float(q[1]), "sigma_median": float(q[2]),
            "sigma_p90": float(q[3]), "sigma_mean": float(s.mean()),
            "log_sigma_mean": float(np.log(s).mean()),
            "share_below_floor": float((s < FLOOR).mean())}


def train_teacher(args, ds_dir, runs):
    from nsynth_wavenet_tpu_torch.training import runner

    cfg_path = qs._write_config(os.path.join(args.work_dir, "teacher_gauss.json"),
                                dict(qs.GAUSS_TEACHER_CFG, num_iters=args.steps, detail_log=True))
    readings, run_dir = [], None
    for target in range(args.segment, args.steps + args.segment, args.segment):
        target = min(target, args.steps)
        t0 = time.time()
        kw = ({"log_root": runs, "config_path": cfg_path} if run_dir is None
              else {"logdir": run_dir})
        run_dir, state = runner.train_wavenet(
            train_path=ds_dir, total_batch_size=qs.TEACHER_BATCH, num_steps=target,
            ckpt_every_steps=args.segment, seed=args.seed, device=args.device, **kw)
        r = dict(step=target, seconds=time.time() - t0, **teacher_sigma(run_dir, state,
                                                                       args.device))
        print("teacher", json.dumps(r), flush=True)
        readings.append(r)
        if target == args.steps:
            break
    return run_dir, readings


def student(args):
    """One student from --teacher_dir with kl_sigma_floor --floor, then the
    smoke's gates; writes <out_dir>/student_floor<floor>.json."""
    from nsynth_wavenet_tpu_torch import evaluation
    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.training import runner

    tag = f"floor{args.floor:g}"
    runs = os.path.join(args.work_dir, f"runs_{tag}")
    cfg_path = qs._write_config(
        os.path.join(args.work_dir, f"student_{tag}.json"),
        dict(qs.STUDENT_CFG, num_iters=args.steps, detail_log=True, kl_sigma_floor=args.floor))
    t0 = time.time()
    st_dir, _ = runner.train_parallel_wavenet(
        train_path=os.path.join(args.work_dir, "ds"), teacher_dir=args.teacher_dir,
        config_path=cfg_path, log_root=runs, total_batch_size=qs.STUDENT_BATCH,
        num_steps=args.steps, ckpt_every_steps=args.steps, seed=args.seed, device=args.device)
    seconds = time.time() - t0
    head, tail = qs.parse_student_log(st_dir)
    lg = qs.student_loss_gate(head, tail, "gauss", args.steps)
    wavs = qs.held_out_wavs("speech")
    mel = stft_ops.melspectrogram_np(wavs)
    cfg, params = evaluation.load_eval_model(st_dir, device=args.device)
    audio = parallelgen.synthesize(ParallelWavenet(cfg), params,
                                   torch.from_numpy(mel).to(args.device),
                                   torch.Generator().manual_seed(qs.STUDENT_SEED)).cpu().numpy()
    amp = qs.student_amp_gate(audio)
    mt = qs.mel_track_metrics(audio, mel, qs.HELD_OUT_SAMPLES)
    series = []
    with open(os.path.join(st_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            series.append({k: row[k] for k in row if k == "step" or k in ("kl_loss", "power_loss")
                           or k.startswith("scale") or k.startswith("log_scale")})
    res = {"floor": args.floor, "seed": args.seed, "steps": args.steps, "seconds": seconds,
           "kl": lg["kl"], "power": lg["power"], "loss": lg["loss"],
           "gates": {"kl": bool(lg["kl_ok"]), "power": bool(lg["pw_ok"]), "amp": amp["ok"],
                     "track": bool(qs.student_tracking_gate(mt, "speech"))},
           "std": amp["std"], "corr": mt["corr"], "msd": mt["msd"], "mcd": mt["mcd"],
           "series": series}
    res["passed"] = all(res["gates"].values())
    os.makedirs(args.out_dir, exist_ok=True)
    for name in ("train.log", "metrics.jsonl"):
        shutil.copy(os.path.join(st_dir, name), os.path.join(args.out_dir, f"student_{tag}_{name}"))
    _write(os.path.join(args.out_dir, f"student_{tag}.json"), res)
    print("student", tag, json.dumps({k: v for k, v in res.items() if k != "series"}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--segment", type=int, default=5000)
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "gauss_seed"))
    ap.add_argument("--work_dir", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--student", action="store_true", help="run one student (internal)")
    ap.add_argument("--teacher_dir", default="")
    ap.add_argument("--floor", type=float, default=0.0)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.student:
        student(args)
        return
    args.work_dir = args.work_dir or tempfile.mkdtemp(prefix="gauss_seed_")
    os.makedirs(args.out_dir, exist_ok=True)
    ds_dir = os.path.join(args.work_dir, "ds")
    qs._build_corpus(ds_dir, "speech", 24)
    t0 = time.time()
    te_dir, te_readings = train_teacher(args, ds_dir, os.path.join(args.work_dir, "runs"))
    for name in ("train.log", "metrics.jsonl"):
        shutil.copy(os.path.join(te_dir, name), os.path.join(args.out_dir, f"teacher_{name}"))
    teacher_s = time.time() - t0
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--student",
                               "--teacher_dir", te_dir, "--floor", str(fl), "--steps",
                               str(args.steps), "--seed", str(args.seed), "--work_dir",
                               args.work_dir, "--out_dir", args.out_dir, "--device", args.device])
             for fl in (0.0, FLOOR)]
    rcs = [p.wait() for p in procs]
    report = {"seed": args.seed, "steps": args.steps, "teacher_seconds": teacher_s,
              "teacher_sigma": te_readings, "student_rcs": rcs,
              "seconds": time.time() - t0}
    for fl in (0.0, FLOOR):
        path = os.path.join(args.out_dir, f"student_floor{fl:g}.json")
        if os.path.exists(path):
            with open(path) as f:
                s = json.load(f)
            report[f"student_floor{fl:g}"] = {k: v for k, v in s.items() if k != "series"}
    if args.device == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    _write(os.path.join(args.out_dir, "report.json"), report)
    print("report", json.dumps(report), flush=True)
    sys.exit(0 if rcs == [0, 0] else 1)


if __name__ == "__main__":
    main()
