"""AOT model export: a single-file serving artifact via `torch.export`.

Counterpart of `cape_tpu.tools.export_model`. `torch.export` traces the
serving functions once, ahead of time, into `ExportedProgram`s of `aten`
operators that `torch.export.load` runs with **no model code**: deployment
needs torch plus the artifact, nothing from cape_tpu_torch. The parameters
(as buffers) and the graph constants (banded Laplacian blocks, pool/unpool
tables, the vertex permutation) are part of each program, so one file is
the whole model.

Artifact layout (a zip, suggested suffix `.capex`; the JAX package's
layout with `.pt2` programs in place of its StableHLO):
  meta.json     model identity + dims + batch size + wire contract
  embed.pt2     (pose [B,cond_dim], clo [B,cond2_dim]) -> (y, y2)
  encode.pt2    (disp [B,V,3], pose, clo) -> (z_mean, z_logvar, y, y2)
  decode.pt2    (z_total [B,nz+nz_cond+nz_cond2], y, y2) -> disp [B,V,3]

The wire contract matches `InferenceEngine`: displacements are in the
dataset's z-scored space and **natural template vertex order** (the
banded vertex permutation is folded into the programs). Shapes are fixed
at the export batch size unless `symbolic_batch`, as in JAX.

The programs are traced once, on the CPU, and `ExportedModel.load` moves
them to the device they serve on (`torch.export.passes.
move_to_device_pass`): the counterpart of JAX's two-platform lowering. They
run the plain PyTorch route (`use_pallas=False`), as JAX's export does: a
hand-written kernel inside a program would need this package loaded to run.

  python -m cape_tpu_torch.tools.export_model --config configs/<preset>.yaml \\
      --name run1 --out model.capex [--fresh-init] [--workdir results] \\
      [--symbolic-batch] [--quantize int8] [--constants-dtype bfloat16] \\
      [--device cpu]
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import zipfile

import numpy as np
import torch

from cape_tpu_torch.apps.inference import BatchedCalls, broadcast_conditions
from cape_tpu_torch.core.bridge import from_jax_params

FORMAT = "cape_tpu_torch.export/1"
JAX_FORMAT = "cape_tpu.export/1"  # the JAX package's artifacts (StableHLO)
_FNS = ("embed", "encode", "decode")

# weight-matrix keys eligible for int8 quantization ("w": Chebyshev
# filterbanks [K,Fin,Fout], "kernel": dense layers [Fin,Fout]); biases,
# norm parameters, and the per-vertex output bias stay float — their
# error would add directly to the output instead of averaging out over
# a contraction
_QUANT_KEYS = ("w", "kernel")

# the parameter subtrees each program reads
_READS = {
    "embed": ("cond_pose.", "cond_clo."),
    "encode": ("cond_pose.", "cond_clo.", "generator.encoder."),
    "decode": ("generator.decoder.",),
}


def quantize_params(params, min_size: int = 1024):
    """Weight-only int8, symmetric per-output-channel (numpy, the JAX
    function's arithmetic, bit for bit).

    Returns a params-shaped tree where each eligible weight leaf is
    replaced by {"int8": int8 array, "scale": f32 [Fout]} with
    scale = max|w| over all non-last axes / 127 (so w ~= int8 * scale).
    The exported programs dequantize at call time; leaves smaller than
    min_size stay float (no traffic to save)."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                arr = np.asarray(v) if not isinstance(v, dict) else None
                if (
                    k in _QUANT_KEYS
                    and arr is not None
                    and np.issubdtype(arr.dtype, np.floating)
                    and arr.ndim >= 2
                    and arr.size >= min_size
                ):
                    a = arr.astype(np.float32)
                    scale = np.max(np.abs(a), axis=tuple(range(a.ndim - 1))) / 127.0
                    scale = np.maximum(scale, np.finfo(np.float32).tiny)
                    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
                    out[k] = {"int8": q, "scale": scale.astype(np.float32)}
                else:
                    out[k] = walk(v)
            return out
        return node

    return walk(params)


def dequantize_params(buffers: dict) -> dict:
    """The call-time inverse of quantize_params over a program's buffers
    ({dotted path: tensor}, a quantized leaf as `<path>.int8` and
    `<path>.scale`): {path: float tensor}. The multiply is an operator of
    the program, so the saved program keeps the int8 table."""
    out = {}
    for key, t in buffers.items():
        if key.endswith(".scale"):
            continue
        if key.endswith(".int8"):
            path = key[: -len(".int8")]
            out[path] = t.float() * buffers[path + ".scale"]
        else:
            out[key] = t
    return out


def _cast_floating(obj, dtype: torch.dtype):
    """`obj` (a GraphContext and the operators in it) with every floating
    tensor cast to `dtype`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, tuple):
        return tuple(_cast_floating(o, dtype) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _cast_floating(getattr(obj, f.name), dtype)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


class _Call(torch.nn.Module):
    """One serving function of the model as a module's forward, so that
    torch.func.functional_call can run it on given parameters."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


class _Program(torch.nn.Module):
    """What one program holds: the parameters its function reads, as
    buffers under their module paths (a quantized leaf as its `int8` and
    `scale`), and the function over a parameter-less copy of the model (on
    `meta`: a parameter the function reads but was not given fails the
    trace)."""

    def __init__(self, call: _Call, buffers: dict):
        super().__init__()
        self.__dict__["_call"] = call  # not a submodule: not part of the state
        for path, t in buffers.items():
            *parents, name = path.split(".")
            node = self
            for p in parents:
                if p not in node._modules:
                    node.add_module(p, torch.nn.Module())
                node = node._modules[p]
            node.register_buffer(name, t)

    def forward(self, *args):
        params = dequantize_params(dict(self.named_buffers()))
        return torch.func.functional_call(
            self._call, {f"model.{k}": v for k, v in params.items()}, args)


def _plain_context(ctx):
    """`ctx` on the CPU with every banded operator pinned to the plain
    route: the programs hold the plain PyTorch apply, as JAX's export
    (`use_pallas=False`), whatever context the caller built."""
    from cape_tpu_torch.ops import kernels
    from cape_tpu_torch.ops.banded import BandedOp

    if kernels.override() is True:
        raise ValueError(
            "CAPE_TPU_PALLAS=1 puts convs on kernel routes even where use_pallas=False; "
            "unset it to export"
        )
    pin = lambda ops: tuple(dataclasses.replace(op, allow_pallas=False)
                            if isinstance(op, BandedOp) else op for op in ops)
    ctx = ctx.to("cpu")
    return dataclasses.replace(ctx, lap=pin(ctx.lap), lap_d=pin(ctx.lap_d),
                               lap_up=pin(ctx.lap_up))


def build_export_fns(model, ctx, params, batch_size: int):
    """The three serving modules ({name: module}) and their example inputs
    ({name: tuple of f32 zeros}): each module holds the parameters its
    function reads (`params`, a nested dict in the JAX layout, quantized or
    not) and runs it on `ctx` with the vertex permutation folded in, so
    that its inputs and outputs are in natural template order."""
    perm = inv_perm = None
    if ctx.perm0 is not None:
        p = np.ascontiguousarray(ctx.perm0)
        inv = np.empty_like(p)
        inv[p] = np.arange(len(p))
        perm, inv_perm = torch.from_numpy(p).long(), torch.from_numpy(inv).long()

    def embed(m, pose, clo):
        return m.embed_conditions(pose, clo)

    def encode(m, disp, pose, clo):
        y, y2 = m.embed_conditions(pose, clo)
        if perm is not None:
            disp = disp[:, perm]
        z_mean, z_logvar = m.encode(ctx, disp, y, y2)
        return z_mean, z_logvar, y, y2

    def decode(m, z_total, y, y2):
        out = m.decode(ctx, z_total, y, y2)
        if inv_perm is not None:
            out = out[:, inv_perm]
        return out

    # the model's structure without its parameters: each program supplies
    # the ones it reads
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"), p.requires_grad)
            for p in model.parameters()}
    shell = copy.deepcopy(model, memo)
    flat = from_jax_params(params)  # a quantized leaf as <path>.int8, <path>.scale
    fns = {"embed": embed, "encode": encode, "decode": decode}
    modules = {
        name: _Program(_Call(shell, fn), {k: v for k, v in flat.items() if k.startswith(_READS[name])})
        for name, fn in fns.items()
    }
    cfg = model.cfg
    B, V = batch_size, int(ctx.level_sizes[0])
    shapes = {
        "embed": ((B, cfg.cond_dim), (B, cfg.cond2_dim)),
        "encode": ((B, V, 3), (B, cfg.cond_dim), (B, cfg.cond2_dim)),
        "decode": ((B, cfg.nz + cfg.nz_cond + cfg.nz_cond2), (B, cfg.nz_cond), (B, cfg.nz_cond2)),
    }
    specs = {k: tuple(torch.zeros(s) for s in v) for k, v in shapes.items()}
    return modules, specs


def export_model(
    model, ctx, params, batch_size: int, out_path: str,
    symbolic_batch: bool = False,
    quantize: str | None = None, constants_dtype: str | None = None,
) -> dict:
    """Write the artifact zip; returns the meta dict. `params` is the
    model's parameter tree in the JAX layout (`core.bridge.to_jax_params`).

    symbolic_batch=True marks dim 0 of every input `torch.export.Dim("b")`:
    one artifact runs at any batch size; batch_size is then only the
    suggested serving batch recorded in meta.

    Compression knobs (both shrink the artifact and the serving-time
    weight and constant traffic):
      quantize="int8"   weight matrices become symmetric per-channel int8,
                        dequantized at call time (quantize_params)
      constants_dtype="bfloat16"  graph constants (banded Laplacian
                        blocks, pool/unpool tables) are stored at bf16
    """
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    if quantize == "int8":
        params = quantize_params(params)
    ctx = _plain_context(ctx)
    if constants_dtype:
        cd = getattr(torch, constants_dtype, None)
        if not isinstance(cd, torch.dtype) or not cd.is_floating_point:
            raise ValueError(f"constants_dtype {constants_dtype!r} is not a floating dtype")
        ctx = _cast_floating(ctx, cd)
    modules, specs = build_export_fns(model, ctx, params, batch_size)
    cfg = model.cfg
    meta = {
        "format": FORMAT,
        "model": cfg.name,
        "batch_size": batch_size,
        "symbolic_batch": bool(symbolic_batch),
        "num_verts": int(ctx.level_sizes[0]),
        "quantize": quantize,
        "constants_dtype": constants_dtype,
        "nz": cfg.nz,
        "nz_cond": cfg.nz_cond,
        "nz_cond2": cfg.nz_cond2,
        "cond_dim": cfg.cond_dim,
        "cond2_dim": cfg.cond2_dim,
        "compute_dtype": cfg.compute_dtype,
        # one program set serves both: ExportedModel.load moves it
        "platforms": ["cpu", "cuda"],
        "contract": "z-scored displacements, natural template vertex order",
        "torch_version": torch.__version__,
    }
    b = torch.export.Dim("b")
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=2))
        for name in _FNS:
            # one entry, the forward's *args: dim 0 of each input
            dyn = (tuple({0: b} for _ in specs[name]),) if symbolic_batch else None
            with torch.no_grad():
                ep = torch.export.export(modules[name], specs[name], dynamic_shapes=dyn,
                                         strict=False)
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            zf.writestr(f"{name}.pt2", buf.getvalue())
    return meta


class ExportedModel:
    """Loader for the artifact: its meta and its programs on one device
    (ExportedEngine runs them). Imports only torch and the standard
    library: usable from a deployment image that does not ship
    cape_tpu_torch."""

    def __init__(self, meta: dict, programs: dict, device: torch.device):
        self.meta = meta
        self.programs = programs
        self.device = device
        self._calls = {name: ep.module() for name, ep in programs.items()}

    @classmethod
    def load(cls, path: str, device=None) -> "ExportedModel":
        """Load the programs onto `device` (default: the card)."""
        from torch.export.passes import move_to_device_pass

        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r}: no CUDA GPU is available; pass device='cpu' "
                "(--device cpu) to run the artifact on the CPU"
            )
        try:
            zf = zipfile.ZipFile(path)
        except (zipfile.BadZipFile, IsADirectoryError) as e:
            raise ValueError(f"not a cape_tpu_torch export artifact: {path} ({e})") from None
        with zf:
            meta = json.loads(zf.read("meta.json")) if "meta.json" in zf.namelist() else {}
            if meta.get("format") == JAX_FORMAT:
                raise ValueError(
                    f"{path} is a JAX artifact ({JAX_FORMAT}, StableHLO for jax.export): "
                    "export the model with cape_tpu_torch.tools.export_model to serve it here"
                )
            if meta.get("format") != FORMAT:
                raise ValueError(f"not a cape_tpu_torch export artifact: {path}")
            programs = {}
            for name in _FNS:
                ep = torch.export.load(io.BytesIO(zf.read(f"{name}.pt2")))
                if device.type != "cpu":
                    ep = move_to_device_pass(ep, device)
                programs[name] = ep
        return cls(meta, programs, device)


class ExportedEngine(BatchedCalls):
    """InferenceEngine-compatible facade over an ExportedModel, so the
    model server can serve an artifact directly (`python -m
    cape_tpu_torch.apps.server --artifact model.capex`): deployment is the
    artifact plus the server process, with no config, checkpoint or
    model-building code. Same wire contract as the live engine."""

    def __init__(self, em: ExportedModel):
        from types import SimpleNamespace

        self.em = em
        m = em.meta
        self.batch_size = int(m["batch_size"])
        self.device = em.device
        # the duck-typed surface ModelServer reads
        self.model = SimpleNamespace(cfg=SimpleNamespace(
            name=m["model"], nz=m["nz"], nz_cond=m["nz_cond"], nz_cond2=m["nz_cond2"],
            cond_dim=m["cond_dim"], cond2_dim=m["cond2_dim"], compute_dtype=m["compute_dtype"],
            z_total_dim=m["nz"] + m["nz_cond"] + m["nz_cond2"],
        ))
        self.ctx = SimpleNamespace(level_sizes=[m["num_verts"]])

    def encode_only_condition(self, pose, clo):
        return self._batched(
            self.em._calls["embed"], len(pose),
            np.asarray(pose, np.float32), np.asarray(clo, np.float32),
        )

    def encode(self, disp, pose, clo):
        return self._batched(
            self.em._calls["encode"], len(disp),
            np.asarray(disp, np.float32), np.asarray(pose, np.float32),
            np.asarray(clo, np.float32),
        )

    def decode(self, z_total, y, y2):
        z_total = np.asarray(z_total, np.float32)
        n = len(z_total)
        y, y2 = broadcast_conditions(y, y2, n)
        (out,) = self._batched(self.em._calls["decode"], n, z_total, y, y2)
        return out

    def autoencode(self, disp, pose, clo, rng=None, sample: bool = False):
        z_mean, z_logvar, y, y2 = self.encode(disp, pose, clo)
        if sample:
            # host-side reparameterization (the artifact ships no sampler),
            # as the JAX artifact engine draws it: numpy's generator seeded
            # with the seed as given (a key's last word), the clamp of
            # CAPE.sample_z
            seed = 0 if rng is None else int(np.asarray(rng).ravel()[-1])
            eps = np.random.default_rng(seed).standard_normal(z_mean.shape)
            z = z_mean + np.exp(0.5 * np.clip(z_logvar, -30.0, 30.0)) * eps
            z = z.astype(np.float32)
        else:
            z = z_mean
        z_total = np.concatenate([z, y, y2], axis=-1)
        return self.decode(z_total, y, y2)


def main(argv=None):
    """python -m cape_tpu_torch.tools.export_model --config <preset> --name run1
         --out model.capex [--batch_size B] [--fresh-init] [--device cpu]

    Restores the newest checkpoint of --name under --workdir (--fresh-init:
    parameters from PRNGKey(cfg.seed), as the JAX tool draws them), exports on the CPU,
    then loads the artifact on --device (default: the card; without a GPU
    it raises unless --device cpu) and decodes one batch there."""
    import argparse
    import os
    import sys
    import time

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fresh-init", action="store_true")
    ap.add_argument("--workdir", default="results")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--symbolic-batch", action="store_true",
                    help="a symbolic batch dim: one artifact, any batch size")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="weight-only int8 (symmetric per-channel, dequantized at call time)")
    ap.add_argument("--constants-dtype", default=None,
                    help="store the graph constants at this dtype (e.g. bfloat16)")
    own, rest = ap.parse_known_args(argv)

    from cape_tpu_torch.apps.main import (
        build_context, require_device, resolve_config, restore_params,
    )
    from cape_tpu_torch.core import prng
    from cape_tpu_torch.core.bridge import to_jax_params
    from cape_tpu_torch.core.config import parse_cli
    from cape_tpu_torch.models.cape import CAPE

    cfg = resolve_config(parse_cli(rest))
    if not cfg.name:
        print("error: --name is required", file=sys.stderr)
        sys.exit(2)
    require_device(own.device)
    model = CAPE(cfg)
    ctx = build_context(cfg)
    if own.fresh_init:
        model.init_params(prng.PRNGKey(cfg.seed), ctx)
    else:
        restore_params(cfg, model, ctx, own.workdir)
    t0 = time.perf_counter()
    meta = export_model(
        model, ctx, to_jax_params(model), cfg.batch_size, own.out,
        symbolic_batch=own.symbolic_batch,
        quantize=own.quantize, constants_dtype=own.constants_dtype,
    )
    print(
        f"exported {meta['model']} (batch {meta['batch_size']}, platforms "
        f"{meta['platforms']}) -> {own.out} ({os.path.getsize(own.out) / 1e6:.1f} MB) "
        f"in {time.perf_counter() - t0:.1f} s", flush=True,
    )
    eng = ExportedEngine(ExportedModel.load(own.out, device=own.device))
    B = meta["batch_size"]
    out = eng.decode(np.zeros((B, cfg.z_total_dim), np.float32),
                     np.zeros((B, cfg.nz_cond), np.float32), np.zeros((B, cfg.nz_cond2), np.float32))
    if not np.isfinite(out).all():
        raise RuntimeError(f"{own.out}: the decode on {own.device} is not finite")
    print(f"loaded on {own.device}: decode {list(out.shape)}", flush=True)


if __name__ == "__main__":
    main()
