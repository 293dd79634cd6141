"""2-D device mesh: data x model (tensor) parallelism over process groups.

Counterpart of `cape_tpu.parallel.mesh2d`. The batch shards over "data"
exactly as in `parallel.mesh.DataParallel`, and every parameter and
optimizer buffer additionally shards one axis over "model", by JAX's rule
on the leaf's shape (`MeshParallel._leaf_spec`): a conv weight [K, fin,
fout] on fout when tp divides it (column-parallel), else on fin
(row-parallel), else it is replicated; a dense kernel [in, out] on out,
else on in; a 1-D leaf when tp divides its length.

JAX places no collective by hand: GSPMD propagates the parameter
shardings and inserts them. The port has no partitioner, so the model's
ops take the collectives themselves, through the four autograd-aware
collectives of this module over the rank's model group (`Shard`):

    copy     forward identity                backward all-reduce
    gather   forward all-gather (an axis)    backward this rank's slice
    scatter  forward this rank's slice       backward all-gather
    reduce   forward all-reduce              backward identity

A column-parallel conv or dense layer copies its input, computes this
rank's output channels from its weight shard and gathers them; a
row-parallel one scatters its input channels, computes a partial output
and reduces it (`shard_apply`, which `ops.cheb`'s convs,
`core.params.dense_apply` and `models.blocks.affine_block_fused_apply`
call). Every other sharded leaf (a
bias, a group-norm gamma or beta, the decoder's vertex bias) is gathered
where it is used (`full`). Activations between the blocks are whole on
every rank of a model group, so the norms, the pooling, the losses and the
metrics are unchanged, and a replicated leaf's gradient is the same on
every rank of the group. The L2 term of the generator's dense kernels and
each player's clip by global norm sum a sharded leaf's squares over the
model group (`losses.generator_fc_l2`, `train.optim.Optimizer`).

One process per device: `MeshParallel(dp, tp, group)` over a group of dp*tp
ranks puts group rank r at mesh coordinate (r // tp, r % tp), JAX's
row-major `reshape(dp, tp)`. The collectives are `broadcast` and
`all_reduce` only (as in `parallel.mesh`): an all-gather is a SUM
all-reduce of a zeroed buffer in which each rank writes its slice, so Gloo
runs them on CUDA tensors too (two ranks on one GPU, which NCCL refuses).

As in JAX, there is no command-line flag: a `Trainer(..., dp=MeshParallel(
dp, tp))` is built in code, in processes started by torchrun or joined with
`parallel.multihost.initialize`.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist

from cape_tpu_torch.parallel.mesh import DATA_AXIS, DataParallel, local_devices
from cape_tpu_torch.parallel.multihost import rank_device

MODEL_AXIS = "model"   # beside DATA_AXIS, which this module exports as JAX's does


def make_mesh_2d(dp: int, tp: int, devices=None) -> list[list]:
    """The first dp*tp of `devices` (default: `local_devices()`; or the
    ranks of a process group) as dp rows of tp, in order: JAX's
    `reshape(dp, tp)`."""
    devices = list(devices if devices is not None else local_devices())
    n = dp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices for a {dp}x{tp} mesh, have {len(devices)}")
    return [devices[i * tp: (i + 1) * tp] for i in range(dp)]


# ------------------------------------------------------------ collectives
def _sum(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The SUM over `group` of each tensor, in its own dtype: one all-reduce
    of one buffer (f32, or f64 if a tensor is f64)."""
    dtype = torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32
    buf = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(buf, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at: at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _placed(parts: list[tuple[torch.Tensor, int, int, int]], group) -> list[torch.Tensor]:
    """All-gather: each (part, axis, full length, offset) written at its
    offset on `axis` into a zeroed tensor of the full length, and summed
    over `group` (one all-reduce)."""
    bufs = []
    for t, axis, size, lo in parts:
        shape = list(t.shape)
        shape[axis] = size
        buf = t.new_zeros(shape)
        buf.narrow(axis, lo, t.shape[axis]).copy_(t)
        bufs.append(buf)
    return _sum(bufs, group)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_sum(list(gs), ctx.group))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return _sum([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, axis, size, lo, x):
        ctx.axis, ctx.lo, ctx.n = axis, lo, x.shape[axis]
        return _placed([(x, axis, size, lo)], group)[0]

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None, g.narrow(ctx.axis, ctx.lo, ctx.n)


class _Scatter(torch.autograd.Function):
    """Each x of `xs` sliced to its [lo, hi) on the last axis (a range may be
    empty); the backward all-gathers every x's gradient in one all-reduce.
    The slices leave as one Function so that its backward runs on every
    rank of the group whenever a gradient reaches any of them (each rank
    uses at least one non-empty slice)."""

    @staticmethod
    def forward(ctx, group, ranges, *xs):
        ctx.group, ctx.ranges = group, ranges
        ctx.sizes = [x.shape[-1] for x in xs]
        return tuple(x[..., lo:hi].contiguous() for x, (lo, hi) in zip(xs, ranges))

    @staticmethod
    def backward(ctx, *gs):
        parts = [(g, g.dim() - 1, size, lo)
                 for g, size, (lo, _) in zip(gs, ctx.sizes, ctx.ranges)]
        return (None, None, *_placed(parts, ctx.group))


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a sharded leaf's local tensor sits in the full leaf: `axis` of
    the full leaf, of length `size`, split in `tp` equal parts over the
    model group `group`, of which this rank holds part `index`."""

    axis: int
    size: int
    index: int
    tp: int
    group: object = dataclasses.field(compare=False, repr=False)

    @property
    def lo(self) -> int:
        return self.index * (self.size // self.tp)

    @property
    def hi(self) -> int:
        return self.lo + self.size // self.tp

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the full tensor `t`."""
        return t.narrow(self.axis, self.lo, self.hi - self.lo).clone()

    # the four collectives over the model group
    def copy(self, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return _Copy.apply(self.group, *xs)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(self.group, x)

    def gather(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """This rank's part of a tensor split like the leaf, on `axis` of x
        (default: the channels), gathered whole."""
        axis = axis % x.dim()
        n = x.shape[axis]
        return _Gather.apply(self.group, axis, n * self.tp, self.index * n, x)

    def scatter(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The rows [lo, hi) of this row-parallel weight's input axis, taken
        from the channels of concat(xs): each x sliced to its share of them
        (possibly none)."""
        ranges, off = [], 0
        for x in xs:
            w = x.shape[-1]
            lo, hi = min(max(self.lo - off, 0), w), min(max(self.hi - off, 0), w)
            ranges.append((lo, hi))
            off += w
        if off != self.size:
            raise ValueError(f"input channels {off} != the weight's {self.size} rows")
        return list(_Scatter.apply(self.group, ranges, *xs))


def shard_of(t: torch.Tensor) -> Shard | None:
    """The Shard of a parameter that `MeshParallel.shard_state` split, else
    None."""
    return getattr(t, "tp_shard", None)


def full(t: torch.Tensor) -> torch.Tensor:
    """A sharded leaf gathered whole where it is used (differentiable: its
    gradient is this rank's slice), or `t` itself."""
    s = shard_of(t)
    return t if s is None else s.gather(t, s.axis)


def detach(t: torch.Tensor) -> torch.Tensor:
    """`t.detach()` that keeps the leaf's Shard."""
    d = t.detach()
    s = shard_of(t)
    if s is not None:
        d.tp_shard = s
    return d


def shard_apply(plain, x: torch.Tensor, conds: list[torch.Tensor], weight: torch.Tensor):
    """`plain(x, conds, weight)`, a product over the channels of [x |
    conds...] with `weight` (its input rows on axis -2, its output columns
    on axis -1), on this rank's shard of the weight: column-parallel, x and
    the conditions are copied and this rank's output channels gathered
    (on the last axis); row-parallel, this rank's rows of [x | conds...]
    (possibly none of x) give a partial output, which is reduced. `plain`
    itself for a whole weight."""
    s = shard_of(weight)
    if s is None:
        return plain(x, conds, weight)
    if s.axis == weight.dim() - 1:
        x, *conds = s.copy(x, *conds)
        return s.gather(plain(x, conds, weight))
    x, *conds = s.scatter([x, *conds])
    return s.reduce(plain(x, conds, weight))


def sharded_sum(leaf: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A sum over a leaf's elements (`value`, from this rank's part) summed
    over the model group when the leaf is sharded."""
    s = shard_of(leaf)
    return value if s is None else s.reduce(value)


def leaf_spec(shape, tp: int) -> tuple:
    """JAX's `MeshParallel._leaf_spec` as a tuple in PartitionSpec order:
    the axis that shards over MODEL_AXIS, or () for a replicated leaf."""
    shape = tuple(shape)
    ok = lambda n: n % tp == 0 and n >= tp
    if len(shape) == 3:
        if ok(shape[2]):
            return (None, None, MODEL_AXIS)
        if ok(shape[1]):
            return (None, MODEL_AXIS, None)
    elif len(shape) == 2:
        if ok(shape[1]):
            return (None, MODEL_AXIS)
        if ok(shape[0]):
            return (MODEL_AXIS, None)
    elif len(shape) == 1:
        if ok(shape[0]):
            return (MODEL_AXIS,)
    return ()


class MeshParallel(DataParallel):
    """This process's rank of a (DATA_AXIS, MODEL_AXIS) mesh over `group`
    (default: the default group) of exactly dp*tp ranks, driving `device`
    (default: `parallel.multihost.rank_device`'s).

    The Trainer's seam is DataParallel's: the rows of a global batch, the
    batch padding, the gradient and metric mean and the row gather run over
    the rank's data group (the dp ranks of its model index); broadcast_ints,
    barrier and replicate (a broadcast from group rank 0, of full tensors)
    over the whole group; shard_state and full_state place the train state."""

    def __init__(self, dp: int, tp: int, group=None, device=None):
        if not dist.is_initialized():
            raise RuntimeError("MeshParallel needs a process group: call "
                               "parallel.multihost.initialize() first")
        group = dist.group.WORLD if group is None else group
        n = dist.get_world_size(group)
        ranks = [dist.get_global_rank(group, r) for r in range(n)]
        self.mesh = make_mesh_2d(dp, tp, ranks)   # global ranks, dp rows of tp
        if n != dp * tp:
            raise ValueError(f"a {dp}x{tp} mesh needs exactly {dp * tp} ranks, the group has {n}")
        if device is None:
            device = rank_device("cuda" if torch.cuda.is_available() else "cpu")
        super().__init__(devices=[device], group=group)
        self.dp, self.tp = dp, tp
        self.data_index, self.model_index = divmod(self.rank, tp)
        # every rank creates every group, in the same order
        backend = dist.get_backend(group)
        model_groups = [dist.new_group(row, backend=backend) for row in self.mesh]
        data_groups = [dist.new_group([row[j] for row in self.mesh], backend=backend)
                       for j in range(tp)]
        self.model_group = model_groups[self.data_index]
        self.data = DataParallel(devices=[device], group=data_groups[self.model_index])

    def _leaf_spec(self, shape) -> tuple:
        return leaf_spec(shape, self.tp)

    # ----------------------------------------------- the data-axis seam
    def local_rows(self, global_batch: int) -> tuple[int, int]:
        """By the data index: the tp ranks of a model group feed the same rows."""
        return self.data.local_rows(global_batch)

    def pad_batch_size(self, global_batch: int) -> int:
        """The batch axis shards over the data dimension only."""
        return self.data.pad_batch_size(global_batch)

    def all_reduce_mean(self, tensors):
        return self.data.all_reduce_mean(tensors)

    def all_gather_rows(self, per_sample: dict, global_rows: int) -> dict:
        return self.data.all_gather_rows(per_sample, global_rows)

    # ------------------------------------------------------ the state
    def shard_state(self, state):
        """Keep only this rank's part of every sharded parameter and of its
        optimizer buffers (in place; the state must be whole and the same on
        every rank, as `replicate` leaves it), tag each such parameter with
        its Shard, and give the optimizer the sharded names and the model
        group's sum for its clip."""
        tx = state.tx
        sharded = set()
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                spec = self._leaf_spec(p.shape)
                if MODEL_AXIS not in spec:
                    continue
                axis = spec.index(MODEL_AXIS)
                s = Shard(axis, p.shape[axis], self.model_index, self.tp, self.model_group)
                p.data = s.local(p.data)
                p.tp_shard = s
                for slot, buf in tx.buffers.get(name, {}).items():
                    tx.buffers[name][slot] = s.local(buf)
                sharded.add(name)
        tx.sharded = frozenset(sharded)
        tx.model_sum = lambda t: _sum([t], self.model_group)[0]
        return state

    def full_state(self, state):
        """The whole train state on every rank (every rank must call it): a
        new TrainState whose model holds the full parameters and whose
        optimizer holds the full buffers, gathered over the model groups in
        one all-reduce; `state` itself when it is not sharded.

        With broadcast and all-reduce only, every rank, not only the one
        that writes a checkpoint, briefly holds about three times the whole
        state: the zero-padded parts, their f32 concatenation that is
        all-reduced, and the new model and buffers."""
        from cape_tpu_torch.models.cape import ParamTree
        from cape_tpu_torch.train.step import TrainState

        tx = state.tx
        if not tx.sharded:
            return state
        named = dict(state.model.named_parameters())
        leaves = [(n, None, p.detach()) for n, p in named.items()]
        leaves += [(n, slot, tx.buffers[n][slot])
                   for n in sorted(tx.buffers) for slot in sorted(tx.buffers[n])]
        parts = []
        for name, _, t in leaves:
            s = shard_of(named[name])
            if s is None:   # replicated: model index 0 writes it, the others zeros
                parts.append((t if self.model_index == 0 else torch.zeros_like(t), 0,
                              t.shape[0], 0))
            else:
                parts.append((t, s.axis, s.size, s.lo))
        tree: dict = {}
        buffers: dict = {}
        for (name, slot, _), w in zip(leaves, _placed(parts, self.model_group)):
            if slot is None:
                *path, leaf = name.split(".")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = w
            else:
                buffers.setdefault(name, {})[slot] = w
        model = type(state.model)(state.model.cfg)
        for k, v in tree.items():
            model.add_module(k, ParamTree(v))
        full_tx = copy.copy(tx)
        full_tx.count = dict(tx.count)
        full_tx.buffers = buffers
        full_tx.sharded, full_tx.model_sum = frozenset(), lambda t: t
        return TrainState(model, full_tx, state.step)

