"""One rank of a multi-process port test (not a test module itself).

    python tests/torch_rank_worker.py <job> <inputs.pt> <out_dir>

Joins the gloo process group of torch's env:// variables (as
tests/test_torch_multiprocess.py run_ranks sets them), runs ``job`` on the
inputs the test saved with torch.save, and saves its result as
<out_dir>/rank<r>.pt.  It imports only torch and the port."""

import os
import sys

import torch

from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.training import optimizer as opt_lib
from nsynth_wavenet_tpu_torch.training import train_lib
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib


def _table_uniforms(tables):
    """mesh.uniform hands out ``tables`` (whole-batch uniforms, one a dropout
    call of a forward) in turn, each step from the first again; mesh.draw
    slices this rank's rows from them as from a RowDraws generator's draw."""
    calls = []

    def rand(shape, generator=None, device=None):
        u = tables[len(calls) % len(tables)]
        calls.append(tuple(shape))
        assert tuple(u.shape) == tuple(shape), (tuple(u.shape), tuple(shape))
        return u.to(device)

    mesh_lib.uniform = lambda g, shape, device: mesh_lib.draw(rand, g, shape, device)
    return calls


def teacher(a):
    """Teacher steps over an (n_data, n_model, n_seq) mesh on this rank's
    rows (and, with a seq axis, time chunk) of the global batches a['wavs']:
    the first step's gradient (averaged over the data x seq group), then a
    step a batch; the gathered gradient, params, EMA, the step losses and
    the halo exchanges of the last step.  a['uniforms']: the dropout masks'
    uniforms; a['remat_cfg']: also the first gradient under that config.
    'metrics': the last step's (with the DETAIL_LOG histograms)."""
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.ops import stft as stft_ops

    model = Wavenet(a["cfg"])
    mesh = mesh_lib.make_mesh(n_data=a["n_data"], n_model=a["n_model"], n_seq=a.get("n_seq", 1))
    calls = _table_uniforms(a["uniforms"]) if "uniforms" in a else []
    opt = opt_lib.make_optimizer(a["cfg"].lr_schedule, grad_clip=a["cfg"].grad_clip,
                                 sharded=mesh_lib.sharded_norm(a["params"], mesh))
    state = mesh_lib.shard_train_state(train_lib.make_train_state(a["params"], opt), mesh)
    B, L = a["wavs"][0].shape
    rows = mesh_lib.rows(mesh, B)
    seq = mesh.seq_group()
    w0 = a["wavs"][0][rows]
    time = None if seq is None else (mesh_lib.seq_chunk(L, mesh).start, L)

    def first_grads(m):
        draws = mesh_lib.RowDraws(torch.Generator(), rows.start, B, time)
        _, grads = train_lib.loss_and_grads(m, state["params"], w0, stft_ops.melspectrogram(w0),
                                            draws, model_group=mesh.tp_group(), seq_group=seq)
        rep = mesh.replica_group()
        if rep is not None:
            grads = tree_lib.tree_map(lambda g: mesh_lib.all_reduce(g, rep) / mesh.replicas(),
                                      grads)
        return mesh_lib.gather_params(grads, mesh)

    out = {"grads": first_grads(model)}
    if "remat_cfg" in a:
        out["remat_grads"] = first_grads(Wavenet(a["remat_cfg"]))
    step_fn = train_lib.make_wavenet_train_step(model, opt, mesh=mesh)
    losses = []
    for w in a["wavs"]:
        mesh_lib.reset_halo_counts()
        state, m = step_fn(state, w[rows], 0)
        losses.append(float(m["loss"]))
    out["halo_exchanges"] = dict(mesh_lib.halo_exchanges)
    out["metrics"] = m
    full = mesh_lib.gather_train_state(state, mesh)
    dilated = state["params"]["layers"][0]["dilated"]
    out.update(params=full["params"], ema=full["ema"], losses=losses,
               count=full["opt_state"]["count"],
               shard_shape=tuple(dilated.get("v", dilated.get("w")).shape),
               dropout_calls=calls)
    return out


def _train_state(params, opt):
    """make_train_state, which holds f32 master weights, or for f64 params
    the same state in f64."""
    if tree_lib.leaves(params)[0].dtype == torch.float32:
        return train_lib.make_train_state(params, opt)
    return {"params": tree_lib.tree_map(torch.clone, params), "opt_state": opt.init(params),
            "ema": tree_lib.tree_map(torch.clone, params), "step": 0}


def student(a):
    """Distillation steps over an (n_data, n_model, n_seq) mesh (the teacher
    sharded as the student) on this rank's rows (and time chunk) of the
    global batches and draws, free running from the initial state: the
    gathered params, EMA, metrics and the halo exchanges of the last step.  With a['starts'] (a state for every step, in the port's
    layout) also each step from its own start: 'shared', the gathered
    params, EMA and metrics of every step.  With a['f64'] (params, teacher
    params, batches and draws in f64) also the free run in f64: 'f64'."""
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet

    pwn = ParallelWavenet(a["cfg"], Wavenet(a["teacher_cfg"]))
    mesh = mesh_lib.make_mesh(n_data=a["n_data"], n_model=a["n_model"], n_seq=a.get("n_seq", 1))
    labels = tree_lib.leaves(train_lib.student_param_labels(a["cfg"], a["params"]))
    rows = mesh_lib.rows(mesh, a["batches"][0][0].shape[0])

    def free_run(params, teacher_params, batches, draws):
        opt = train_lib.make_student_optimizer(a["cfg"], params, mesh)
        state = mesh_lib.shard_train_state(_train_state(params, opt), mesh, labels)
        step_fn = train_lib.make_pwn_train_step(
            pwn, mesh_lib.shard_params(teacher_params, mesh), opt, mesh=mesh)
        metrics = []
        for (wav, wav_rand), d in zip(batches, draws):
            mesh_lib.reset_halo_counts()
            state, m = step_fn(state, wav[rows], wav_rand[rows], None, draws=d)
            metrics.append({k: v if isinstance(v, dict) else float(v) for k, v in m.items()})
        full = mesh_lib.gather_train_state(state, mesh, labels)
        return {"params": full["params"], "ema": full["ema"], "metrics": metrics,
                "halo_exchanges": dict(mesh_lib.halo_exchanges)}, step_fn

    out, step_fn = free_run(a["params"], a["teacher_params"], a["batches"], a["draws"])
    out["shared"] = []
    for start, (wav, wav_rand), draws in zip(a.get("starts", ()), a["batches"], a["draws"]):
        state = mesh_lib.shard_train_state(start, mesh, labels)
        state, m = step_fn(state, wav[rows], wav_rand[rows], None, draws=draws)
        after = mesh_lib.gather_train_state(state, mesh, labels)
        out["shared"].append({"params": after["params"], "ema": after["ema"],
                              "metrics": {k: float(v) for k, v in m.items()}})
    if "f64" in a:
        f = a["f64"]
        out["f64"], _ = free_run(f["params"], f["teacher_params"], f["batches"], f["draws"])
    return out


def serving(a):
    """The sharded serving functions over a data mesh of every rank (and the
    seq-sharded student over a seq mesh of every rank)."""
    from nsynth_wavenet_tpu_torch.models import parallelgen
    from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet

    n = mesh_lib.process_count()
    out = {}
    data = mesh_lib.make_mesh(n_data=n)
    if "plain" in a:
        p = a["plain"]
        out["plain"] = Fastgen(Wavenet(p["cfg"])).generate_sharded(
            p["params"], p["mel"], torch.Generator().manual_seed(p["seed"]), data,
            length=p["length"])
    if "kernel" in a:
        k = a["kernel"]
        fg = Fastgen(Wavenet(k["cfg"]))
        for greedy in (True, False):
            out[f"kernel_greedy{greedy}"] = fg.generate_cuda_sharded(
                k["params"], k["mel"], k["seed"], data, length=k["length"], greedy=greedy)
    if "student" in a:
        s = a["student"]
        pwn = ParallelWavenet(s["cfg"])
        if "data" in s:
            out["synth"] = parallelgen.synthesize_sharded(
                pwn, s["params"], s["data"], torch.Generator().manual_seed(s["seed"]), data)
        seq = mesh_lib.make_mesh(n_data=1, n_seq=n)
        out["synth_seq"] = parallelgen.synthesize_seq_sharded(
            pwn, s["params"], s["seq"], torch.Generator().manual_seed(s["seed"]), seq)
    return out


def student_remat(a):
    """The distillation loss's gradient over a seq mesh of every rank, with
    remat_teacher off and on: each one's gradient (averaged over the seq
    group) and halo exchanges."""
    import dataclasses

    from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
    from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
    from nsynth_wavenet_tpu_torch.ops import stft as stft_ops

    mesh = mesh_lib.make_mesh(n_data=1, n_seq=mesh_lib.process_count())
    group = mesh.seq_group()
    wav, wav_rand = a["batch"]
    batch = {"mel": stft_ops.melspectrogram(wav), "wav": wav,
             "mel_rand": stft_ops.melspectrogram(wav_rand)}
    chunk = mesh_lib.seq_chunk(a["draws"]["base_x"].shape[-1], mesh)
    draws = {k: v[..., chunk] for k, v in a["draws"].items()}
    out = {}
    for remat in (False, True):
        pwn = ParallelWavenet(dataclasses.replace(a["cfg"], remat_teacher=remat),
                              Wavenet(a["teacher_cfg"]))
        mesh_lib.reset_halo_counts()
        aux, grads = train_lib.grads_of(
            lambda p: train_lib.student_loss(pwn, a["teacher_params"], p, batch, draws,
                                             seq_group=group), a["params"])
        grads = tree_lib.tree_map(lambda g: mesh_lib.all_reduce(g, group) / mesh.replicas(),
                                  grads)
        out[remat] = {"grads": grads, "loss": float(aux["loss"]),
                      "halo_exchanges": dict(mesh_lib.halo_exchanges)}
    return out


def halo(a):
    """conv1d_taps and shift_right over the seq axis of a (1, 1, 4) and a
    (2, 1, 2) mesh, for every case of a['cases'] ({'x' [B, L, C], 'params',
    'dilation', 'g': the output's gradient [B, L, Cout]}, whole): this rank's
    chunk of the output, of x's gradient and of the shift's, the params'
    gradient summed over the seq group, and the exchanges counted."""
    from nsynth_wavenet_tpu_torch.ops import conv as conv_ops

    out = {}
    for n_data, n_seq in ((1, 4), (2, 2)):
        mesh = mesh_lib.make_mesh(n_data=n_data, n_seq=n_seq)
        group = mesh.seq_group()
        for i, case in enumerate(a["cases"]):
            c = mesh_lib.seq_chunk(case["x"].shape[1], mesh)
            x = case["x"][:, c].clone().requires_grad_()
            p = {k: v.clone().requires_grad_() for k, v in case["params"].items()}
            mesh_lib.reset_halo_counts()
            y = conv_ops.conv1d_taps(p, x, dilation=case["dilation"], seq_group=group)
            sh = conv_ops.shift_right(x, group)
            (y * case["g"][:, c]).sum().backward(retain_graph=True)
            dx_conv = x.grad.clone()
            x.grad = None
            (sh * case["x"][:, c]).sum().backward()
            out[(n_seq, i)] = {
                "y": y.detach(), "shift": sh.detach(), "dx": dx_conv, "dx_shift": x.grad,
                "dparams": {k: mesh_lib.all_reduce(v.grad, group) for k, v in p.items()},
                "counts": dict(mesh_lib.halo_exchanges)}
    return out


JOBS = {"teacher": teacher, "student": student, "serving": serving, "halo": halo,
        "student_remat": student_remat}


def main():
    job, inputs, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu")
    result = JOBS[job](torch.load(inputs, weights_only=False))
    torch.save(result, os.path.join(out_dir, f"rank{mesh_lib.process_index()}.pt"))
    mesh_lib.shutdown()


if __name__ == "__main__":
    main()
