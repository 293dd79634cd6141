"""Configuration: the `CAPEConfig` dataclass, preset files and CLI overrides.

Counterpart of `cape_tpu.core.config`, field for field. The presets in
`configs/` are flat `key: value` YAML; they are read here without PyYAML,
with the same scalar rules PyYAML's safe loader applies to such files
(ints, floats with a dot, booleans, null) and the same bool coercion of
`_BOOL_FIELDS`.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
from typing import Any


@dataclasses.dataclass
class CAPEConfig:
    # ---- run ----
    name: str = ""
    mode: str = "train"                    # train | test | demo
    dataset: str = "dataset_male_4clotypes"
    gender: str = "male"
    seed: int = 123
    restart: bool = True

    # ---- architecture ----
    num_conv_layers: int = 8
    ds_factor: int = 2
    K: int = 2                             # Chebyshev order, VAE layers
    Kd: int = 3                            # Chebyshev order, discriminator
    nf: int = 64                           # first-layer filters
    nz: int = 18                           # latent dim
    nz_cond: int = 24                      # pose-embedding dim
    nz_cond2: int = 8                      # clothing-type-embedding dim
    n_layer_cond: int = 1
    activation: str = "b1leakyrelu"        # b1leakyrelu | b1relu | b1tanh
    use_res_block: bool = False            # encoder res blocks
    use_res_block_dec: bool = True         # decoder res blocks
    cond_encoder: bool = False             # condition the encoder too
    reduce_dim: int = 64                   # 1x1-conv channel reduction (0 = off)
    affine: bool = False                   # affine decoder res blocks
    pose_type: str = "rot"                 # rot | pose
    optim_condnet: bool = True
    nn_input_channel: int = 3
    cond_dim: int = 126                    # 14 clothing joints x 9
    cond2_dim: int = 4                     # one-hot clothing type

    # ---- training ----
    batch_size: int = 16
    num_epochs: int = 60
    lr: float = 8e-3
    lr_scaler: float = 0.1
    decay_every: int = 1
    decay_rate: float = 0.99
    momentum: float = 0.9
    lr_warmup: bool = False
    optimizer: str = "sgd"
    loss: str = "l1"
    loss_mask: str = ""

    # ---- loss weights ----
    regularization: float = 2e-3
    lambda_recon: float = 1.0
    lambda_edge: float = 1.0
    lambda_latent: float = 8e-4
    lambda_gan: float = 0.1

    # ---- demo ----
    smpl_model_folder: str = "body_models"
    demo_n_sample: int = 5
    save_obj: bool = True
    vis_demo: bool = False

    # ---- extensions of the JAX package, same names and defaults ----
    compute_dtype: str = "float32"         # float32 | bfloat16
    op_mode: str = "banded"                # only banded is ported
    remat: bool = False
    fold_conditions: bool = True
    data_parallel: int = 0
    steps_per_dispatch: int = 32
    log_every_steps: int = 0
    profile_steps: int = 0
    tensorboard: bool = True
    checkpoint_keep: int = 5
    # False pins every conv to the plain banded apply; True lets ops.cheb
    # route large-batch K=2 convs to the CUDA band-apply kernel
    use_pallas: bool = True
    padded_layout: bool = True
    fuse_decoder: bool = False
    opt_state_dtype: str = "float32"

    @property
    def ds_factors(self) -> list[int]:
        n = self.num_conv_layers
        f = self.ds_factor
        if n == 4:
            return [1, f, 1, 1]
        if n == 6:
            return [1, f, 1, f, 1, 1]
        if n == 8:
            return [1, f, 1, f, 1, f, 1, 1]
        raise NotImplementedError(f"num_conv_layers={n}")

    @property
    def channels(self) -> list[int]:
        """Per-layer output channels F."""
        nf, n = self.nf, self.num_conv_layers
        if n == 4:
            return [nf, 2 * nf, 2 * nf, nf]
        if n == 6:
            return [nf, nf, 2 * nf, 2 * nf, 4 * nf, 4 * nf]
        if n == 8:
            return [nf, nf, 2 * nf, 2 * nf, 4 * nf, 4 * nf, 8 * nf, 8 * nf]
        raise NotImplementedError(f"num_conv_layers={n}")

    @property
    def poly_orders(self) -> list[int]:
        return [self.K] * self.num_conv_layers

    @property
    def reduce_rate(self) -> int:
        """Channel-reduction ratio of the 1x1 convs."""
        if self.reduce_dim > 0:
            rate = self.channels[-1] // self.reduce_dim
            if rate < 1:
                raise ValueError(
                    f"reduce_dim={self.reduce_dim} exceeds the encoder's final "
                    f"channel count {self.channels[-1]} (nf={self.nf}, "
                    f"num_conv_layers={self.num_conv_layers}); lower reduce_dim "
                    "or set it to 0 to disable the 1x1 reduction"
                )
            return rate
        if self.reduce_dim == 0:
            return 1
        raise ValueError("reduce_dim must be >= 0")

    @property
    def z_total_dim(self) -> int:
        return self.nz + self.nz_cond + self.nz_cond2

    def replace(self, **kw) -> "CAPEConfig":
        return dataclasses.replace(self, **kw)


_BOOL_FIELDS = {
    "restart", "use_res_block", "use_res_block_dec", "cond_encoder", "affine",
    "optim_condnet", "lr_warmup", "save_obj", "vis_demo",
    "remat", "fold_conditions", "use_pallas", "padded_layout", "fuse_decoder",
    "tensorboard",
}


def _coerce(key: str, value: Any) -> Any:
    if key in _BOOL_FIELDS:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    return value


# YAML 1.1 plain scalars as PyYAML's safe loader resolves them
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOLS = {
    "yes": True, "true": True, "on": True,
    "no": False, "false": False, "off": False,
}


def _scalar(text: str) -> Any:
    if text in ("", "~") or text.lower() == "null":
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text.lower() in _BOOLS:
        return _BOOLS[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def read_preset(path: str) -> dict[str, Any]:
    """Parse a flat `key: value` preset file (comments, blank lines and
    empty values allowed). Nested YAML is refused, not guessed at."""
    values: dict[str, Any] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if line.lstrip().startswith("#") or not line.strip():
                continue
            if line[0].isspace():
                raise ValueError(f"{path}:{lineno}: nested YAML is not supported")
            key, sep, rest = line.partition(":")
            if not sep:
                raise ValueError(f"{path}:{lineno}: expected 'key: value'")
            rest = re.sub(r"(^|\s)#.*$", "", rest).strip()
            values[key.strip()] = _scalar(rest)
    return values


def load_config(preset_path: str | None = None, **overrides) -> CAPEConfig:
    """Build a config from an optional preset file plus keyword overrides."""
    values: dict[str, Any] = {}
    if preset_path:
        values.update(read_preset(preset_path))
    values.update({k: v for k, v in overrides.items() if v is not None})
    field_names = {f.name for f in dataclasses.fields(CAPEConfig)}
    known = {k: _coerce(k, v) for k, v in values.items() if k in field_names}
    return CAPEConfig(**known)


def parse_cli(argv: list[str] | None = None) -> CAPEConfig:
    """CLI with the JAX package's flag names; --config names a preset."""
    parser = argparse.ArgumentParser(prog="cape_tpu_torch", description="CAPE in PyTorch")
    parser.add_argument("--config", default=None, help="preset file (configs/*.yaml)")
    for f in dataclasses.fields(CAPEConfig):
        arg_type = str if f.name in _BOOL_FIELDS else type(f.default)
        parser.add_argument(f"--{f.name}", type=arg_type, default=None)
    args, _ = parser.parse_known_args(argv)
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(CAPEConfig)
        if getattr(args, f.name) is not None
    }
    return load_config(args.config, **overrides)
