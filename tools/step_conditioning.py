"""Readings of how far roundoff carries in the port's distillation steps
against the JAX package's, on the CPU, for the records (ROADMAP Queue 3,
PERF.md section 7).  Each case runs both sides in f32 and in f64 on the same
weights, batches and draws (the inputs of tests/test_torch_distill_step.py):

  python tools/step_conditioning.py resize
      the resize-conv pair of tests/test_torch_resize_conv.py: the third
      step's loss, free running, of the port at 1 / 2 / 4 / 8 torch threads
      and of JAX with XLA's excess precision off and on, each with the batch
      rows in order and reversed (another summation order of the same
      sums), beside the two f64 runs
  python tools/step_conditioning.py logistic_wn
      the weight-normed logistic student of tests/test_torch_tensor_parallel.py
      in one process: the params after 3 steps, port against JAX in f32 and
      in f64, and each f32 side against the f64 runs, with the leaf that
      reads worst and the size of its gradient's elements
  python tools/step_conditioning.py dp_gauss
      the weight-normed Gauss student of tests/test_torch_data_parallel.py
      at global batch 4: the first step in f32, port against JAX; one step
      from JAX's state after the first, port against JAX in f32 and in
      f64, and each f32 side against f64
  python tools/step_conditioning.py two_process
      tests/test_torch_multiprocess.py's distillation (train CLIs, 1 and 2
      gloo processes at global batch 4) on its record and pair, and with
      the tones alone (no noise) or a 65 536-level MoL pair (no mu-law): the
      second step's params of 2 processes against 1 (worst leaf, L2 of the
      difference over the L2 of the step) and the first step's metrics

Needs the repo's tests directory (it reuses their inputs); takes about a
minute a case.  Prints one line a run and a summary line."""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import conftest  # noqa: E402,F401  (the JAX package on the CPU, as the tests run it)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nsynth_wavenet_tpu.models import parallel_wavenet as jpwn_lib  # noqa: E402
from nsynth_wavenet_tpu.ops import distributions as jdist  # noqa: E402
from nsynth_wavenet_tpu.training import train_lib as jtl  # noqa: E402
from nsynth_wavenet_tpu_torch import weights  # noqa: E402
from nsynth_wavenet_tpu_torch.training import train_lib as ttl  # noqa: E402
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib  # noqa: E402
from test_torch_distill_losses import Pair, make_draws, speechlike, to_port  # noqa: E402
from test_torch_distill_step import SCHEDULE, STEPS  # noqa: E402

CASES = {
    "resize": dict(loss_type="gauss", B=2, teacher_kw={"use_resize_conv": True},
                   use_resize_conv=True, power_loss_factor=1.0, grad_clip=True),
    "logistic_wn": dict(loss_type="logistic", B=2, teacher_kw={"use_weight_norm": True},
                        power_loss_factor=1.0, contrastive_loss_factor=0.3,
                        use_share_deconv=True, grad_clip=True, use_weight_norm=True),
    "dp_gauss": dict(loss_type="gauss", B=4, teacher_kw={"use_weight_norm": True},
                     power_loss_factor=1.0, grad_clip=True, use_weight_norm=True),
}


def make_pair(case, dtype):
    kw = dict(CASES[case])
    with jax.enable_x64(dtype == np.float64):
        return Pair(kw.pop("loss_type"), dtype=dtype, param_scale=3.0, lr_schedule=SCHEDULE,
                    **kw)


def make_inputs(pair, B):
    """The batches and draws of tests/test_torch_distill_step.py _run_both."""
    rng = np.random.default_rng(7)
    batches = [(pair.wav, pair.wav_rand)] + [
        (speechlike(B, pair.jcfg.wave_length, rng), speechlike(B, pair.jcfg.wave_length, rng))
        for _ in range(STEPS - 1)]
    draws = [pair.draws] + [make_draws(pair.jcfg, B, pair.L, rng) for _ in range(STEPS - 1)]
    return batches, draws


def cast_inputs(batches, draws, dtype, reverse=False):
    o = slice(None, None, -1) if reverse else slice(None)
    return ([(np.ascontiguousarray(w[o], dtype), np.ascontiguousarray(r[o], dtype))
             for w, r in batches],
            [{k: np.ascontiguousarray(v[o], dtype) for k, v in d.items()} for d in draws])


def port_state(params, opt):
    """make_train_state without its f32 cast (params in their own dtype)."""
    return {"params": tree_lib.tree_map(torch.clone, params), "opt_state": opt.init(params),
            "ema": tree_lib.tree_map(torch.clone, params), "step": 0}


def port_steps(pair, batches, draws, state=None, threads=1):
    """The port's steps from ``state`` (default the pair's init): (state,
    per-step metrics)."""
    torch.set_num_threads(threads)
    opt = ttl.make_student_optimizer(pair.tcfg, pair.tparams)
    state = state or port_state(pair.tparams, opt)
    step = ttl.make_pwn_train_step(pair.tpwn, pair.tte, opt)
    metrics = []
    for (w, r), d in zip(batches, draws):
        state, m = step(state, torch.from_numpy(w), torch.from_numpy(r), None,
                        draws={k: torch.from_numpy(v) for k, v in d.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def jax_steps(pair, batches, draws, state=None, strict=True):
    """JAX's steps (the draws as inputs, as tests/test_torch_distill_step.py
    _jax_step; ``strict``: XLA's excess precision off): (state, metrics)."""
    slot, order = {}, []
    mp = pytest.MonkeyPatch()

    def logistic(rng, shape):
        key = ("kl", "cl")[len(order)]
        order.append(key)
        return slot[key]

    mp.setattr(jpwn_lib.ParallelWavenet, "base_noise", lambda self, rng, B, L: slot["base_x"])
    mp.setattr(jdist, "logistic_0_1", logistic)
    try:
        opt = jtl.make_student_optimizer(pair.jcfg, pair.np_params)
        state = state or jtl.make_train_state(pair.np_params, opt)
        step_fn = jtl.make_pwn_train_step(pair.jpwn, pair.np_teacher, opt)

        def fn(state, wav, wav_rand, draws):
            slot.clear()
            slot.update(draws)
            order.clear()
            return step_fn(state, wav, wav_rand, jax.random.PRNGKey(2))

        lowered = jax.jit(fn).lower(state, *batches[0], draws[0])
        compiled = lowered.compile(
            compiler_options={"xla_allow_excess_precision": False} if strict else None)
        metrics = []
        for (w, r), d in zip(batches, draws):
            state, m = compiled(state, w, r, d)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    return state, metrics


def flat_port(tree):
    return {k: v.detach().numpy().astype(np.float64) for k, v in weights.flatten(tree).items()}


def flat_jax(tree):
    return {k: np.asarray(v, np.float64)
            for k, v in weights.flatten(jax.tree_util.tree_map(np.asarray, tree)).items()}


def update_err(before, want, got):
    """(worst ||got - want|| / ||want - before|| over the leaves that moved, its leaf)."""
    errs = {k: float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k] - before[k]))
            for k in want if np.any(want[k] != before[k])}
    k = max(errs, key=errs.get)
    return errs[k], k


def case_resize():
    B = CASES["resize"]["B"]
    runs = {}
    for dtype in (np.float32, np.float64):
        pair = make_pair("resize", dtype)
        batches, draws = make_inputs(pair, B)
        with jax.enable_x64(dtype == np.float64):
            for reverse in (False, True):
                bs, ds = cast_inputs(batches, draws, dtype, reverse)
                tag = "f64" if dtype == np.float64 else "f32"
                threads_set = (1,) if dtype == np.float64 else (1, 2, 4, 8)
                for t in threads_set:
                    if dtype == np.float64 and reverse:
                        continue
                    _, m = port_steps(pair, bs, ds, threads=t)
                    runs[f"port {tag} threads={t} rows={'rev' if reverse else 'fwd'}"] = m
                for strict in ((True,) if dtype == np.float64 else (True, False)):
                    if dtype == np.float64 and reverse:
                        continue
                    _, m = jax_steps(pair, bs, ds, strict=strict)
                    runs[f"jax {tag} excess={'off' if strict else 'on'} "
                         f"rows={'rev' if reverse else 'fwd'}"] = m
    third = {k: m[2]["loss"] for k, m in runs.items()}
    for k, v in third.items():
        print(f"resize third-step loss {k}: {v!r}")
    f32 = [v for k, v in third.items() if " f32 " in k]
    pf64 = third["port f64 threads=1 rows=fwd"]
    jf64 = third["jax f64 excess=off rows=fwd"]
    one = third["port f32 threads=1 rows=fwd"]
    print(f"resize summary: f32 runs span [{min(f32)!r}, {max(f32)!r}] (rel "
          f"{(max(f32) - min(f32)) / abs(jf64):.3e}); port f64 - jax f64 rel "
          f"{(pf64 - jf64) / abs(jf64):.3e}; port f32 one thread {one!r} "
          f"{'inside' if min(f32) <= one <= max(f32) else 'OUTSIDE'} the f32 span; "
          f"its distance to port f64 {abs(one - pf64) / abs(pf64):.3e}, to jax f64 "
          f"{abs(one - jf64) / abs(jf64):.3e}")


def _pair_runs(case, state_fn=None):
    """Both sides in f32 and f64 from the pair's init (or from state_fn's
    states): {(side, tag): flat params after the steps}, plus the inputs."""
    out = {}
    for dtype in (np.float32, np.float64):
        tag = "f64" if dtype == np.float64 else "f32"
        pair = make_pair(case, dtype)
        batches, draws = make_inputs(pair, CASES[case]["B"])
        with jax.enable_x64(dtype == np.float64):
            bs, ds = cast_inputs(batches, draws, dtype)
            if state_fn is None:
                out[("port", tag)] = flat_port(port_steps(pair, bs, ds)[0]["params"])
                out[("jax", tag)] = flat_jax(jax_steps(pair, bs, ds)[0]["params"])
                out["init"] = flat_port(pair.tparams)
            else:
                out.update(state_fn(pair, bs, ds, tag))
    return out


def _report(case, out, before_key="init"):
    before = out[before_key]
    pairs = [(("jax", "f32"), ("port", "f32")), (("jax", "f64"), ("port", "f64")),
             (("port", "f64"), ("port", "f32")), (("port", "f64"), ("jax", "f32")),
             (("jax", "f64"), ("jax", "f32")), (("jax", "f64"), ("port", "f32"))]
    for want, got in pairs:
        err, leaf = update_err(before, out[want], out[got])
        print(f"{case} {got[0]} {got[1]} against {want[0]} {want[1]}: {err:.3e} ({leaf})")
    err, leaf = update_err(before, out[("jax", "f32")], out[("port", "f32")])
    g = out.get("grad")
    if g is not None:
        a = np.abs(g[leaf])
        print(f"{case} worst f32 leaf {leaf}: first-step gradient max {a.max():.3e}, "
              f"elements under 1e-4 of it {float(np.mean(a < 1e-4 * a.max())):.3f}, "
              f"smallest {a.min():.3e}")


def first_grads(case, dtype):
    """The port's first-step gradient of the case's pair in ``dtype``."""
    from test_torch_distill_step import _tbatch

    pair = make_pair(case, dtype)
    batches, draws = make_inputs(pair, CASES[case]["B"])
    bs, ds = cast_inputs(batches, draws, dtype)
    batch = _tbatch(pair.tpwn, *bs[0])
    _, grads = ttl.grads_of(lambda p: ttl.student_loss(
        pair.tpwn, pair.tte, p, batch, {k: torch.from_numpy(v) for k, v in ds[0].items()}),
        pair.tparams)
    return flat_port(grads)


def case_logistic_wn():
    out = _pair_runs("logistic_wn")
    out["grad"] = first_grads("logistic_wn", np.float32)
    _report("logistic_wn", out)
    err, leaf = update_err(out["init"], out[("jax", "f32")], out[("port", "f32")])
    g32, g64 = out["grad"][leaf], first_grads("logistic_wn", np.float64)[leaf]
    rel = np.abs(g32 - g64) / np.abs(g64)
    print(f"logistic_wn {leaf}: first-step gradient f32 against f64 per element: median "
          f"{np.median(rel):.2e}, max {rel.max():.2e}; elements off by more than 1e-3 "
          f"{int((rel > 1e-3).sum())} of {rel.size}; whole leaf (L2) "
          f"{np.linalg.norm(g32 - g64) / np.linalg.norm(g64):.2e}")


def case_dp_gauss():
    # JAX's f32 state after the first step, the start of every side's second
    start = {}
    pair32 = make_pair("dp_gauss", np.float32)
    b32, d32 = cast_inputs(*make_inputs(pair32, CASES["dp_gauss"]["B"]), np.float32)
    js1, _ = jax_steps(pair32, b32[:1], d32[:1])
    host = jax.tree_util.tree_map(np.asarray, js1)
    start["before"] = flat_jax(host["params"])
    # the first step from the common init, one process against JAX
    ts1, _ = port_steps(pair32, b32[:1], d32[:1])
    init = flat_port(pair32.tparams)
    for part in ("params", "ema"):
        err, leaf = update_err(init, flat_jax(host[part]), flat_port(ts1[part]))
        print(f"dp_gauss first step, port f32 against jax f32, {part}: {err:.3e} ({leaf})")

    def from_start(pair, bs, ds, tag):
        dtype = np.float64 if tag == "f64" else np.float32
        cast = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a).astype(  # noqa: E731
            dtype if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a).dtype),
            tree)
        jstate = cast(host)
        adam = next(x for x in jstate["opt_state"].inner_states["train"].inner_state
                    if hasattr(x, "mu"))
        tstate = {"params": to_port(jstate["params"], dtype),
                  "ema": to_port(jstate["ema"], dtype),
                  "opt_state": {"count": int(adam.count),
                                "mu": [torch.from_numpy(np.array(a)) for a in
                                       jax.tree_util.tree_leaves(adam.mu)],
                                "nu": [torch.from_numpy(np.array(a)) for a in
                                       jax.tree_util.tree_leaves(adam.nu)]},
                  "step": int(jstate["step"])}
        js, _ = jax_steps(pair, bs[1:2], ds[1:2], state=jax.tree_util.tree_map(
            jax.numpy.asarray, jstate))
        ts, _ = port_steps(pair, bs[1:2], ds[1:2], state=tstate)
        return {("jax", tag): flat_jax(js["params"]), ("port", tag): flat_port(ts["params"])}

    out = _pair_runs("dp_gauss", from_start)
    out["init"] = start["before"]
    _report("dp_gauss second step from JAX's state", out)


def case_two_process():
    import json
    import tempfile

    import test_torch_multiprocess as tm

    variants = {"the test's (tones + noise 0.05, mu-law pair)": (0.05, True),
                "tones alone (mu-law pair)": (0.0, True),
                "tones + noise 0.05, 65 536-level MoL pair": (0.05, False)}
    for name, (noise, mu_law) in variants.items():
        with tempfile.TemporaryDirectory() as tmp:
            tmp = os.path.abspath(tmp)
            ds = tm.make_identical_dataset(os.path.join(tmp, "ds"), noise=noise)
            teacher_cfg = dict(tm.TEACHER_CFG, use_mu_law=mu_law)
            student_cfg = dict(tm.STUDENT_CFG, use_mu_law=mu_law)
            paths = {}
            for key, cfg in (("teacher", teacher_cfg), ("student", student_cfg)):
                paths[key] = os.path.join(tmp, key + ".json")
                with open(paths[key], "w") as f:
                    json.dump(cfg, f)
            tm.run_ranks(tm._cmd("train_wavenet_torch.py", ds, config=paths["teacher"],
                                 log_root=os.path.join(tmp, "teacher"), steps=1, batch=2),
                         1, os.path.join(tmp, "logt"))
            teacher = tm._only_run(os.path.join(tmp, "teacher"))
            runs = {}
            for n in (1, 2):
                root = os.path.join(tmp, f"s{n}")
                tm.run_ranks(tm._cmd("train_parallel_wavenet_torch.py", ds,
                                     config=paths["student"], log_root=root, steps=2, batch=4,
                                     extra=["--teacher_dir", teacher, "--ckpt_every_steps", "1"]
                                     + (["--multihost"] if n == 2 else [])),
                             n, root + "_log")
                runs[n] = tm._only_run(root)
            m1, m2 = tm._metrics(runs[1])[0], tm._metrics(runs[2])[0]
            before = flat_port(tm._state(runs[1], 1)["params"])
            want = flat_port(tm._state(runs[1])["params"])
            got = flat_port(tm._state(runs[2])["params"])
            err, leaf = update_err(before, want, got)
            keys = [k for k in m1 if isinstance(m1[k], float) and k in m2
                    and not k.endswith("_per_sec") and k != "learning_rate"]
            worst = max(keys, key=lambda k: abs(m2[k] - m1[k]) / max(abs(m1[k]), 1.0))
            print(f"two_process {name}: second step's params, 2 against 1 process {err:.3e} "
                  f"({leaf}); metrics at step 2 worst {worst} "
                  f"{abs(m2[worst] - m1[worst]) / max(abs(m1[worst]), 1.0):.3e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=sorted(CASES) + ["two_process"])
    args = ap.parse_args(argv)
    {"resize": case_resize, "logistic_wn": case_logistic_wn, "dp_gauss": case_dp_gauss,
     "two_process": case_two_process}[args.case]()


if __name__ == "__main__":
    main()
