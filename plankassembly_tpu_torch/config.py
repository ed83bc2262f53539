"""Configuration for the PyTorch port.

Frozen dataclasses with the same fields and defaults as the JAX package's
`plankassembly_tpu/config.py`, plus `ModelDims` (the static model geometry
of `plankassembly_tpu/models/model.py:35-105`). Checkpoint hyperparameters
(`checkpoints/*.hparams.yaml`) and training configs (`configs/*.yaml`) are
read with `read_hparams_yaml`, a reader for the nested ``key: value``
YAML subset those files use, so the port needs no YAML library;
`load_config` builds a Config from a training config the way the JAX
package's does.
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class TokenConfig:
    END: int = 512
    PAD: int = 513


@dataclass(frozen=True)
class DataConfig:
    NUM_INPUT_DOF: int = 4
    NUM_OUTPUT_DOF: int = 6
    VOCAB_SIZE: int = 514
    NUM_VIEW: int = 3
    NUM_TYPE: int = 2
    MAX_INPUT_LENGTH: int = 1200
    MAX_OUTPUT_LENGTH: int = 128
    NUM_BITS: int = 9

    AUG_RATIO: float = 0.1
    NOISE_RATIO: float = 0.15
    NOISE_LENGTH: float = 0.02

    IMAGE_SIZE: int = 256
    PATCH_SIZE: int = 16

    SCALE: float = 1280.0
    MAX_THICKNESS: float = 50.0
    MIN_THICKNESS: float = 5.0
    MERGE_TOLERANCE: float = 5.0

    @property
    def max_num_input(self) -> int:
        return math.ceil(self.MAX_INPUT_LENGTH / self.NUM_INPUT_DOF)

    @property
    def max_num_output(self) -> int:
        return math.ceil(self.MAX_OUTPUT_LENGTH / self.NUM_OUTPUT_DOF)


@dataclass(frozen=True)
class ModelConfig:
    NUM_MODEL: int = 512
    NUM_HEAD: int = 8
    # shared K/V heads (grouped-query attention); 0 = NUM_HEAD (plain MHA)
    NUM_KV_HEAD: int = 0
    NUM_FEEDFORWARD: int = 1024
    DROPOUT: float = 0.2
    ACTIVATION: str = "relu"
    NORMALIZE_BEFORE: bool = True
    NUM_ENCODER_LAYERS: int = 6
    NUM_DECODER_LAYERS: int = 6


@dataclass(frozen=True)
class TrainerConfig:
    """Run options of the JAX trainer, kept so a checkpoint's hparams file
    round-trips; nothing in the port's serving path reads them."""

    devices: int = 1
    strategy: str = "ddp"
    accelerator: str = "tpu"
    max_epochs: int = 1000
    check_val_every_n_epoch: int = 20
    num_sanity_val_steps: int = 0
    benchmark: bool = True
    detect_anomaly: bool = False
    log_every_n_steps: int = 50
    default_root_dir: str = "lightning_logs"
    checkpoint_monitor: str = "val/fmeasure"
    checkpoint_mode: str = "max"
    save_top_k: int = 1
    save_last: bool = True
    tensor_parallel: int = 1
    fused_attention: bool = True
    kv_quant: bool = False
    kv_quantum: int = 128
    decode_impl: str = "auto"
    sample_cache: bool = False
    device_data: bool = False


@dataclass(frozen=True)
class Config:
    seed_everything: int = 2022
    trainer: TrainerConfig = field(default_factory=TrainerConfig)

    ROOT: str = "data/data/complete/infos"
    DATASETS_TRAIN: str = "data/splits/train.txt"
    DATASETS_VALID: str = "data/splits/valid.txt"
    DATASETS_TEST: str = "data/splits/test.txt"
    BATCH_SIZE: int = 16
    NUM_WORKERS: int = 4
    LR: float = 1e-4
    THRESHOLD: float = 0.5

    DATA: DataConfig = field(default_factory=DataConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    TOKEN: TokenConfig = field(default_factory=TokenConfig)


@dataclass(frozen=True)
class ModelDims:
    """Static model geometry derived from a Config."""

    num_model: int
    num_head: int
    num_feedforward: int
    dropout: float
    num_encoder_layers: int
    num_decoder_layers: int
    num_view: int
    num_type: int
    num_input_dof: int
    num_output_dof: int
    max_input_length: int
    max_output_length: int
    vocab_size: int
    end: int
    pad: int
    num_kv_head: int = 0  # 0 -> num_head (plain MHA)

    @property
    def kv_heads(self) -> int:
        return self.num_kv_head or self.num_head

    @property
    def kv_groups(self) -> int:
        if self.num_head % self.kv_heads:
            raise ValueError(f"num_head {self.num_head} is not a multiple "
                             f"of kv heads {self.kv_heads}")
        return self.num_head // self.kv_heads

    @property
    def head_dim(self) -> int:
        return self.num_model // self.num_head

    @property
    def max_num_input(self) -> int:
        return math.ceil(self.max_input_length / self.num_input_dof)

    @property
    def max_num_output(self) -> int:
        return math.ceil(self.max_output_length / self.num_output_dof)

    @staticmethod
    def from_config(cfg: Config) -> "ModelDims":
        return ModelDims(
            num_model=cfg.MODEL.NUM_MODEL,
            num_head=cfg.MODEL.NUM_HEAD,
            num_kv_head=cfg.MODEL.NUM_KV_HEAD or 0,
            num_feedforward=cfg.MODEL.NUM_FEEDFORWARD,
            dropout=cfg.MODEL.DROPOUT,
            num_encoder_layers=cfg.MODEL.NUM_ENCODER_LAYERS,
            num_decoder_layers=cfg.MODEL.NUM_DECODER_LAYERS,
            num_view=cfg.DATA.NUM_VIEW,
            num_type=cfg.DATA.NUM_TYPE,
            num_input_dof=cfg.DATA.NUM_INPUT_DOF,
            num_output_dof=cfg.DATA.NUM_OUTPUT_DOF,
            max_input_length=cfg.DATA.MAX_INPUT_LENGTH,
            max_output_length=cfg.DATA.MAX_OUTPUT_LENGTH,
            vocab_size=cfg.DATA.VOCAB_SIZE,
            end=cfg.TOKEN.END,
            pad=cfg.TOKEN.PAD,
        )


# ---------------------------------------------------------------------------
# hparams files
# ---------------------------------------------------------------------------

_INT = re.compile(r"[-+]?\d+")
_FLOAT = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?")
_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}


def _scalar(text: str) -> Any:
    """One YAML plain or quoted scalar: int, float (`1e-4` and `2.0e-05`
    alike), boolean, null, or string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if low in _BOOLS:
        return _BOOLS[low]
    if low in ("null", "~", ""):
        return None
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    return text


def read_hparams_yaml(path: str) -> dict:
    """Parse the YAML subset of the repo's configs and hparams files:
    nested mappings of ``key: value`` lines, comments and blank lines.
    Anything else (lists, flow style, anchors, block scalars, tabs,
    inconsistent indentation) raises ValueError."""
    out: dict = {}
    stack = [(0, out)]  # (indent of the children, mapping) of open blocks
    pending = None      # (indent, key, parent) of a key awaiting a block
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split(" #", 1)[0].rstrip()
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            depth = len(line) - len(line.lstrip(" "))
            key, sep, value = line.strip().partition(":")
            value = value.strip()
            if "\t" in line or not sep or key.startswith("-") or \
                    value[:1] in ("[", "{", "|", ">", "&", "*", "!"):
                raise ValueError(f"{path}:{lineno}: unsupported YAML: {raw!r}")
            if pending is not None:
                p_depth, p_key, p_parent = pending
                pending = None
                if depth > p_depth:
                    p_parent[p_key] = {}
                    stack.append((depth, p_parent[p_key]))
                else:
                    p_parent[p_key] = None  # an empty value
            while depth < stack[-1][0]:
                stack.pop()
            if depth != stack[-1][0]:
                raise ValueError(f"{path}:{lineno}: bad indentation: {raw!r}")
            node = stack[-1][1]
            if value:
                node[key] = _scalar(value)
            else:
                pending = (depth, key, node)
    if pending is not None:
        pending[2][pending[1]] = None
    return out


def _coerce_to_type(value, ftype):
    if ftype is float or ftype == "float":
        return float(value)
    if ftype is int or ftype == "int":
        return int(value)
    if ftype is bool or ftype == "bool":
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    return value


_TYPES = {"TokenConfig": TokenConfig, "DataConfig": DataConfig,
          "ModelConfig": ModelConfig, "TrainerConfig": TrainerConfig,
          "Config": Config}


def _build_dataclass(cls, data: dict):
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in field_map:
            continue  # unknown keys (e.g. trainer callbacks) are ignored
        ftype = _TYPES.get(field_map[key].type, field_map[key].type)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[key] = _build_dataclass(ftype, value)
        else:
            kwargs[key] = _coerce_to_type(value, ftype)
    return cls(**kwargs)


def config_from_hparams_file(path: str) -> Config:
    """Rebuild a Config from a checkpoint's `.hparams.yaml` (the flat
    dataclass dump the JAX trainer writes)."""
    flat = read_hparams_yaml(path)
    for key, cls in (("DATA", DataConfig), ("MODEL", ModelConfig),
                     ("TOKEN", TokenConfig), ("trainer", TrainerConfig)):
        if isinstance(flat.get(key), dict):
            flat[key] = _build_dataclass(cls, flat[key])
    return _build_dataclass(Config, flat)


# ---------------------------------------------------------------------------
# training configs (`configs/*.yaml`, the reference's LightningCLI schema)
# ---------------------------------------------------------------------------

def config_from_dict(raw: dict[str, Any]) -> Config:
    """A Config from a parsed training config: `seed_everything`, a
    `trainer` block, and `model.hparams` holding the flat fields and the
    DATA / MODEL / TOKEN blocks (`plankassembly_tpu/config.py::
    config_from_dict`)."""
    flat: dict[str, Any] = {}
    if "seed_everything" in raw:
        flat["seed_everything"] = raw["seed_everything"]
    trainer_raw = dict(raw.get("trainer", {}) or {})
    trainer_raw.pop("callbacks", None)  # the checkpoint policy is built in
    # kept as the JAX package maps it, so the two configs compare equal;
    # the port picks its device from the command line, not from here
    if trainer_raw.get("accelerator") == "gpu":
        trainer_raw["accelerator"] = "tpu"
    flat["trainer"] = _build_dataclass(TrainerConfig, trainer_raw)
    hparams = dict((raw.get("model", {}) or {}).get("hparams", {}) or {})
    for key in ("ROOT", "DATASETS_TRAIN", "DATASETS_VALID", "DATASETS_TEST",
                "BATCH_SIZE", "NUM_WORKERS", "LR", "THRESHOLD"):
        if key in hparams:
            flat[key] = hparams[key]
    for key, cls in (("DATA", DataConfig), ("MODEL", ModelConfig),
                     ("TOKEN", TokenConfig)):
        if key in hparams:
            flat[key] = _build_dataclass(cls, hparams[key])
    return _build_dataclass(Config, flat)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def _set_path(node, parts, value):
    name = parts[0]
    if not dataclasses.is_dataclass(node) or not hasattr(node, name):
        raise KeyError(f"unknown config path segment: {name!r}")
    current = getattr(node, name)
    if len(parts) == 1:
        if isinstance(value, str):
            value = _coerce(value, current)
        return dataclasses.replace(node, **{name: value})
    return dataclasses.replace(
        node, **{name: _set_path(current, parts[1:], value)})


def apply_overrides(cfg: Config, overrides: dict[str, str]) -> Config:
    """Apply ``--a.b.c value`` overrides; ``model.hparams.X`` names the
    flat field X, as in LightningCLI. Strings are coerced to the field's
    current type (so ``1e-4`` becomes a float)."""
    for dotted, value in overrides.items():
        path = dotted
        if path.startswith("model.hparams."):
            path = path[len("model.hparams."):]
        cfg = _set_path(cfg, path.split("."), value)
    return cfg


def load_config(path: str, overrides: dict[str, str] | None = None) -> Config:
    """Load a training config (`configs/*.yaml`) with optional overrides."""
    cfg = config_from_dict(read_hparams_yaml(path) or {})
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, int):
        return str(v)
    text = str(v)
    return text if _scalar(text) == text and text.strip() == text \
        and ": " not in text and text[:1] not in "-?[{|>&*!%@'\"" \
        else "'" + text.replace("'", "''") + "'"


def write_hparams_yaml(cfg: Config, path: str) -> None:
    """Dump a Config as the two-level ``key: value`` YAML of
    `checkpoints/*.hparams.yaml` (sorted keys), which `read_hparams_yaml`
    and PyYAML both read back to the same Config."""
    lines = []
    for key, value in sorted(dataclasses.asdict(cfg).items()):
        if isinstance(value, dict):
            lines.append(f"{key}:")
            lines += [f"  {k}: {_yaml_scalar(v)}"
                      for k, v in sorted(value.items())]
        else:
            lines.append(f"{key}: {_yaml_scalar(value)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
