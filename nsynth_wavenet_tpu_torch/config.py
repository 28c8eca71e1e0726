"""Typed teacher and student configurations (own copies of
nsynth_wavenet_tpu/config.py's WavenetConfig and ParallelWavenetConfig).
Reference-schema JSONs (``configs/*.json``) load unchanged."""

import dataclasses
import json
from typing import Optional, Tuple

DEFAULT_LR_SCHEDULE = (
    (0, 2e-4),
    (90000, 4e-4 / 3),
    (120000, 6e-5),
    (150000, 4e-5),
    (180000, 2e-5),
    (210000, 6e-6),
    (240000, 2e-6),
)


def _tupleize(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tupleize(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class WavenetConfig:
    """Teacher WaveNet hparams; field names and defaults as the reference."""

    num_iters: int = 200000
    wave_length: int = 7680
    num_stages: int = 10
    num_layers: int = 30
    filter_length: int = 3
    width: int = 512
    skip_width: int = 256
    deconv_width: int = 256
    deconv_config: Tuple[Tuple[int, int], ...] = ((40, 10), (80, 20))
    use_mu_law: bool = True
    loss_type: str = "ce"  # ce | mol | gauss
    mol_mix: int = 10
    use_weight_norm: bool = False
    double_gate_width: bool = True
    use_resize_conv: bool = False
    upsample_act: str = "tanh"
    use_as_teacher: bool = False
    dropout_inputs: bool = False
    dropout_all: bool = False
    dropout_rate: Optional[float] = None
    lr_schedule: Tuple[Tuple[int, float], ...] = DEFAULT_LR_SCHEDULE
    grad_clip: bool = False
    detail_log: bool = False
    compute_dtype: str = "bfloat16"
    remat: bool = False

    def __post_init__(self):
        if self.dropout_inputs and self.dropout_all:
            raise ValueError("dropout_inputs and dropout_all are exclusive")
        if self.loss_type not in ("ce", "mol", "gauss"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")

    @property
    def quant_chann(self) -> int:
        return 2**8 if self.use_mu_law else 2**16

    @property
    def out_width(self) -> int:
        if self.loss_type == "ce":
            return self.quant_chann
        if self.loss_type == "mol":
            return self.mol_mix * 3
        return 2

    @property
    def gate_width(self) -> int:
        return 2 * self.width if self.double_gate_width else self.width

    @property
    def frame_shift(self) -> int:
        out = 1
        for _, s in self.deconv_config:
            out *= s
        return out

    @property
    def resolved_dropout_rate(self) -> float:
        if self.dropout_rate is not None:
            return self.dropout_rate
        return 0.5 if self.dropout_inputs else 0.05

    @property
    def max_dilation(self) -> int:
        return 2 ** (self.num_stages - 1)


@dataclasses.dataclass(frozen=True)
class ParallelWavenetConfig:
    """IAF student hparams; field names and defaults as the reference."""

    num_iters: int = 400000
    wave_length: int = 7680
    num_stages: int = 10
    num_iaf_layers: Tuple[int, ...] = (10, 10, 10, 30)
    filter_length: int = 3
    width: int = 64
    deconv_width: int = 256
    deconv_config: Tuple[Tuple[int, int], ...] = ((40, 10), (80, 20))
    use_mu_law: bool = False
    loss_type: str = "logistic"  # logistic | gauss
    use_weight_norm: bool = False
    use_resize_conv: bool = False
    use_share_deconv: bool = False
    use_teacher_deconv: bool = False
    upsample_act: str = "tanh"
    num_samples: int = 100
    power_loss_factor: float = 0.0
    contrastive_loss_factor: float = 0.0
    lr_schedule: Tuple[Tuple[int, float], ...] = DEFAULT_LR_SCHEDULE
    manual_final_init: bool = True
    use_log_scale: bool = False
    clip: bool = False
    norm_feat: bool = False
    use_priority_freq: bool = True
    use_l1_loss: bool = False
    spec_enhance_factor: int = 1  # 0 log | 1 abs | 2 pow | 3 combine
    use_mel: bool = False
    grad_clip: bool = False
    detail_log: bool = False
    kl_sigma_floor: float = 0.0
    compute_dtype: str = "bfloat16"
    remat_teacher: bool = False

    def __post_init__(self):
        if self.use_share_deconv and self.use_teacher_deconv:
            raise ValueError("use_share_deconv and use_teacher_deconv are exclusive")
        if self.loss_type not in ("logistic", "gauss"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")

    @property
    def quant_chann(self) -> int:
        return 2**8 if self.use_mu_law else 2**16

    @property
    def out_width(self) -> int:
        return 2  # mean, scale

    @property
    def gate_width(self) -> int:
        return self.width  # IAF flows never double the gate width

    @property
    def frame_shift(self) -> int:
        out = 1
        for _, s in self.deconv_config:
            out *= s
        return out

    @property
    def max_dilation(self) -> int:
        return 2 ** (self.num_stages - 1)

    @property
    def effective_use_priority_freq(self) -> bool:
        """The power loss's priority band, off whenever use_mel is on."""
        return False if self.use_mel else self.use_priority_freq


def _from_dict(cls, d: dict, **overrides):
    fields = {f.name for f in dataclasses.fields(cls)}
    known = {k: _tupleize(v) for k, v in d.items() if k in fields}
    unknown = {k for k in d if k not in fields and k != "use_input_noise"}
    if unknown:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
    known.update(overrides)
    return cls(**known)


def wavenet_config_from_dict(d: dict, **overrides) -> WavenetConfig:
    return _from_dict(WavenetConfig, d, **overrides)


def pwn_config_from_dict(d: dict, **overrides) -> ParallelWavenetConfig:
    return _from_dict(ParallelWavenetConfig, d, **overrides)


def load_config(path: str, **overrides):
    """Load a reference-schema JSON: a dict with ``num_iaf_layers`` gives a
    ParallelWavenetConfig (student), any other a WavenetConfig (teacher).  A
    golden ``meta.json`` (config nested under "config") is accepted too."""
    with open(path, "rt") as f:
        d = json.load(f)
    if "config" in d and isinstance(d["config"], dict):
        d = d["config"]
    if "num_iaf_layers" in d:
        return pwn_config_from_dict(d, **overrides)
    return wavenet_config_from_dict(d, **overrides)


def config_to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def _git_branch() -> str:
    """The working directory's git branch, '' outside a repo or on the
    default branch (the run slug names a branch only when it is not the
    default one)."""
    import subprocess

    try:
        out = subprocess.run(["git", "rev-parse", "--abbrev-ref", "HEAD"],
                             capture_output=True, text=True, timeout=5)
        branch = out.stdout.strip()
    except Exception:
        return ""
    if out.returncode != 0 or branch in ("master", "main", "HEAD", ""):
        return ""
    return branch


def config_slug(cfg, model_tag: str, exp_tag: str = "") -> str:
    """Run-directory slug in the reference's tag vocabulary (the same string
    as nsynth_wavenet_tpu.config.config_slug): ns_ prefix, wn/pwn (+tag),
    MU/n_MU, WN_DDI[_mfinit]/n_WN, RS/TS, upsample act, the student's
    LOGS/CLIP/feature/MEL/L1-L2/PFS/deconv-sharing tags or the teacher's
    DIN/DA/n_DO dropout tag, the loss type; then power and contrastive
    factors, GC, and a non-default git branch."""
    is_pwn = hasattr(cfg, "num_iaf_layers")
    extras = []
    model_str = "pwn" if is_pwn else "wn"
    if exp_tag:
        model_str = f"{model_str}_{exp_tag}"
    parts = ["ns_" + model_str, "MU" if cfg.use_mu_law else "n_MU"]
    if cfg.use_weight_norm:
        parts.append("WN_DDI_mfinit" if is_pwn and cfg.manual_final_init else "WN_DDI")
    else:
        parts.append("n_WN")
    parts.append("RS" if cfg.use_resize_conv else "TS")
    parts.append(cfg.upsample_act)
    if is_pwn:
        parts.append("LOGS" if cfg.use_log_scale else "n_LOGS")
        parts.append("CLIP" if cfg.clip else "n_CLIP")
        sef_tag = {0: "LABS", 1: "ABS", 2: "POW", 3: "COM"}[cfg.spec_enhance_factor]
        parts.append(("N" if cfg.norm_feat else "") + sef_tag)
        parts.append("MEL" if cfg.use_mel else "n_MEL")
        parts.append("L1" if cfg.use_l1_loss else "L2")
        parts.append("PFS" if cfg.use_priority_freq else "n_PFS")
        if cfg.use_share_deconv:
            parts.append("SHA_DC")
        elif cfg.use_teacher_deconv:
            parts.append("TEA_DC")
        else:
            parts.append("SEP_DC")
        if cfg.power_loss_factor:
            extras.append(f"pl{cfg.power_loss_factor:g}")
        if cfg.contrastive_loss_factor:
            extras.append(f"cl{cfg.contrastive_loss_factor:g}")
    elif cfg.dropout_inputs:
        parts.append("DIN")
    elif cfg.dropout_all:
        parts.append("DA")
    else:
        parts.append("n_DO")
    if cfg.grad_clip:
        extras.append("GC")
    if cfg.loss_type:
        parts.append(cfg.loss_type.upper())
    parts += extras
    branch = _git_branch()
    if branch:
        parts.append(branch.replace("/", "_"))
    return "-".join(parts)
