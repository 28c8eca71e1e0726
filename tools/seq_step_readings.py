"""Readings behind chip_smoke.py M3 (on a card): where a training step at
n_seq 2 (two gloo ranks sharing the card) parts from one process's.  For
the full-width teacher configs (configs/wavenet_mol.json, wavenet_gauss.json;
dropout off) in f32 and bf16, at B = 4 x 7680, under cuDNN's deterministic
algorithms:

  * forward: the largest |seq - one process| of the encoding over the
    rank's chunk and of the head outputs (0 where bit-equal);
  * the products: a trunk GEMM over the chunk's rows against the same rows
    of the GEMM over the whole batch (bit-equal or not);
  * the gradient: each leaf's max |seq - one| as a share of its own max, the
    three worst leaves, and the update after one Adam step (L2 of the
    update, as M3 and M2 read it).

    python3 tools/seq_step_readings.py [--configs mol,gauss] [--dtypes float32,bfloat16]

Prints a JSON object a case and rank."""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nsynth_wavenet_tpu_torch import config as config_lib  # noqa: E402
from nsynth_wavenet_tpu_torch import weights  # noqa: E402
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet, no_tf32  # noqa: E402
from nsynth_wavenet_tpu_torch.ops import stft  # noqa: E402
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from nsynth_wavenet_tpu_torch.training import optimizer as opt_lib  # noqa: E402
from nsynth_wavenet_tpu_torch.training import train_lib  # noqa: E402
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib  # noqa: E402

CONFIGS = {"mol": "configs/wavenet_mol.json", "gauss": "configs/wavenet_gauss.json"}


def _max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


def one_case(name, dtype, mesh, rank):
    model = Wavenet(config_lib.load_config(os.path.join(cs.REPO, CONFIGS[name]),
                                           compute_dtype=dtype, dropout_inputs=False))
    params = model.init_params(0, device="cuda")
    wav = torch.from_numpy(cs.synthetic_wavs(4, model.cfg.wave_length, 90)).cuda()
    group = mesh.seq_group()
    chunk = mesh_lib.seq_chunk(wav.shape[1], mesh)
    out = {"case": f"{name} {dtype}", "rank": rank}
    with cs.deterministic_cudnn(), no_tf32(), torch.no_grad():
        mel = stft.melspectrogram(wav)
        xs = model.encode_signal(wav)["wav_scaled"]
        ff1, _ = model.feed_forward_train(params, {"wav_scaled": xs, "mel": mel})
        ffs, _ = model.feed_forward_train(params, {"wav_scaled": xs[:, chunk], "mel": mel},
                                          seq_group=group)
        out["encoding"] = _max_diff(ff1["encoding"][:, chunk], ffs["encoding"])
        out["out_params"] = _max_diff(ff1["out_params"][:, chunk], ffs["out_params"])
        g = torch.Generator(device="cuda").manual_seed(5)
        K, N = model.cfg.filter_length * model.cfg.width, model.cfg.gate_width
        x = torch.randn((4, wav.shape[1], K), generator=g, device="cuda").to(model.dtype or
                                                                              torch.float32)
        w = torch.randn((K, N), generator=g, device="cuda").to(x.dtype)
        out["gemm_rows_bit_equal"] = bool(torch.equal((x @ w)[:, chunk], x[:, chunk] @ w))
    with cs.deterministic_cudnn(), no_tf32():
        _, g1 = train_lib.loss_and_grads(model, params, wav, mel)
        _, gs = train_lib.loss_and_grads(model, params, wav, mel, seq_group=group)
        gs = tree_lib.tree_map(lambda t: mesh_lib.all_reduce(t, group) / 2, gs)
    errs = {}
    for (path, a), b in zip(weights.flatten(g1).items(), weights.flatten(gs).values()):
        scale = float(a.abs().max())
        errs[path] = _max_diff(a, b) / scale if scale > 0 else float(b.abs().max())
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    out["grad_worst"] = [[p, e] for p, e in worst]
    states = []
    for grads in (g1, gs):
        opt = opt_lib.make_optimizer(model.cfg.lr_schedule)
        state = train_lib.make_train_state(params, opt)
        opt.update(grads, state["opt_state"], state["params"])
        states.append(state["params"])
    out["update"] = cs.update_err(params, states[0], states[1], g1)
    return out


def rank_main(configs, dtypes):
    mesh_lib.init_distributed("cuda:0", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = mesh_lib.process_index()
    mesh = mesh_lib.make_mesh(n_data=1, n_seq=2)
    res = []
    for name in configs:
        for dtype in dtypes:
            res.append(one_case(name, dtype, mesh, rank))
            torch.cuda.empty_cache()
    print("MESH_RANK_RESULT " + json.dumps(res), flush=True)
    mesh_lib.shutdown()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="mol,gauss")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    configs, dtypes = args.configs.split(","), args.dtypes.split(",")
    if args.rank:
        return rank_main(configs, dtypes)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    flag = ["--rank", "--configs", args.configs, "--dtypes", args.dtypes]
    for res in cs.spawn_ranks(flag, "readings", script=os.path.abspath(__file__)):
        for case in res:
            print(json.dumps(case), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
