"""Data parallelism over devices: the framework's one communication seam.

Counterpart of `cape_tpu.parallel.mesh`. The batch axis is split evenly
over the devices; parameters, optimizer state, the graph context and the
noise are the same on every device; the gradient and every metric are the
global batch's. JAX gets there with one program over a 1-D device mesh
and lets XLA insert the gradient all-reduce. The port has two forms:

  * one process per device over a `torch.distributed` process group
    (`DataParallel(devices=[device], group=...)`; training, as
    `parallel.multihost` starts it): each rank computes its rows of the
    global batch, and the train step averages the ranks' gradients with
    `all_reduce_mean` (every loss is a mean over equal shards, so the mean
    of the shards' gradients is the global batch's);
  * one process driving N devices (`DataParallel(N)` or `devices=[...]`;
    the server's bulk inference, as JAX's server drives its mesh): one
    replica of the model and the context per device (`replicate`), each
    device's chunk of a padded call launched before any is read.

The collectives are `broadcast` and `all_reduce` on device tensors only,
the two that Gloo also runs on CUDA tensors, so one code path serves NCCL
on GPUs and Gloo on the CPU (and Gloo on one GPU shared by two ranks). A
reduction flattens its tensors into one buffer: one collective a call.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def local_devices(device_type: str | None = None) -> list[torch.device]:
    """The devices of this process's host: every CUDA device for "cuda"
    (none without a GPU), the one CPU device for "cpu"; None is "cuda" where
    a GPU is present, else "cpu"."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cpu":
        return [torch.device("cpu")]
    if device_type != "cuda":
        raise ValueError(f"no data parallelism over {device_type!r} devices")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int = 0, devices=None) -> list[torch.device]:
    """The first n (default: all) of `devices` (default: `local_devices()`),
    in order. A list given is taken as it is, a device repeated included."""
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    if n_devices and n_devices > 0:
        if n_devices > len(devices):
            # slicing would silently run an N-way request on fewer devices
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available"
            )
        devices = devices[:n_devices]
    return devices


class DataParallel:
    """The devices of a data-parallel run and its collectives.

    Without `group`, one process drives `devices` (`make_mesh(n_devices,
    devices)`): rank 0 of a world of 1, num_devices = len(devices). With
    `group` (an initialised process group), this process is one rank of it
    and drives devices[0] (default: `local_devices()`'s first); num_devices
    is the group's size, which n_devices, if > 0, must equal. The
    collectives run over the group (of any size, one included), and are
    no-ops without one."""

    def __init__(self, n_devices: int = 0, devices=None, group=None):
        self.group = group
        if group is None:
            self.devices = make_mesh(n_devices, devices)
            self.rank, self.world_size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)
            if n_devices and n_devices != self.world_size:
                raise ValueError(
                    f"data_parallel={n_devices}, but the process group has "
                    f"{self.world_size} ranks (one device each)"
                )
            self.devices = make_mesh(1, devices)
        self.device = self.devices[0]

    @property
    def num_devices(self) -> int:
        return self.world_size if self.group is not None else len(self.devices)

    @property
    def lead(self) -> bool:
        """Only the lead process touches the filesystem."""
        return self.rank == 0

    def local_rows(self, global_batch: int) -> tuple[int, int]:
        """[start, stop) of the rows of a global batch that this process
        feeds: its rank's even share over a group, all of them without one."""
        n = self.world_size
        if global_batch % n:
            raise ValueError(
                f"global batch {global_batch} must divide over {n} processes"
            )
        per = global_batch // n
        return self.rank * per, (self.rank + 1) * per

    def pad_batch_size(self, global_batch: int) -> int:
        """Round a global batch up to a multiple of the mesh size."""
        n = self.num_devices
        return ((global_batch + n - 1) // n) * n

    # ------------------------------------------------------------ collectives
    def replicate(self, obj):
        """Over a group: broadcast a module's parameters and buffers, or a
        list of tensors, from rank 0 in place (one collective a tensor), and
        return it. Without one: `obj` on each device, in device order (a
        list); `obj` itself moves to the first device and each other device
        gets its own copy, which a device repeated shares."""
        if self.group is None:
            replicas: dict = {}
            for d in self.devices:
                if d not in replicas:
                    if isinstance(obj, torch.nn.Module):
                        replicas[d] = (copy.deepcopy(obj) if replicas else obj).to(d)
                    elif hasattr(obj, "to"):   # a GraphContext, or a tensor
                        replicas[d] = obj.to(d)
                    else:
                        replicas[d] = [t.to(d) for t in obj]
            return [replicas[d] for d in self.devices]
        tensors = (list(obj.parameters()) + list(obj.buffers())
                   if isinstance(obj, torch.nn.Module) else list(obj))
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=self._src, group=self.group)
        return obj

    @property
    def _src(self) -> int:
        """The global rank of the group's rank 0."""
        return dist.get_global_rank(self.group, 0)

    def all_reduce_mean(self, tensors):
        """The mean over the ranks of each tensor of `tensors` (a dict or a
        list), each in its own dtype: all of them flattened into one f32
        buffer, one SUM all-reduce, then split again. Without a group, the
        tensors themselves."""
        if self.group is None:
            return tensors
        items = list(tensors.items()) if isinstance(tensors, dict) else list(enumerate(tensors))
        buf = torch.cat([t.detach().reshape(-1).float() for _, t in items])
        dist.all_reduce(buf, group=self.group)
        buf /= self.world_size
        out, at = {}, 0
        for k, t in items:
            out[k] = buf[at: at + t.numel()].reshape(t.shape).to(t.dtype)
            at += t.numel()
        return out if isinstance(tensors, dict) else [out[i] for i in range(len(items))]

    def all_gather_rows(self, per_sample: dict, global_rows: int) -> dict:
        """Every rank's rows of per-sample tensors ({name: [local rows,
        ...]}) on every rank, as {name: [global_rows, ...]} f32: each rank
        writes its rows (`local_rows`) into a zeroed global buffer, then one
        SUM all-reduce."""
        if self.group is None:
            return {k: v.float() for k, v in per_sample.items()}
        lo, hi = self.local_rows(global_rows)
        keys = list(per_sample)
        first = per_sample[keys[0]]
        tail = [tuple(per_sample[k].shape[1:]) for k in keys]
        width = [int(torch.Size(s).numel()) for s in tail]
        buf = first.new_zeros((global_rows, sum(width)), dtype=torch.float32)
        at = 0
        for k, w in zip(keys, width):
            buf[lo:hi, at: at + w] = per_sample[k].reshape(hi - lo, w).float()
            at += w
        dist.all_reduce(buf, group=self.group)
        out, at = {}, 0
        for k, w, s in zip(keys, width, tail):
            out[k] = buf[:, at: at + w].reshape((global_rows, *s))
            at += w
        return out

    def broadcast_ints(self, values: list[int]) -> list[int]:
        """Rank 0's `values` on every rank (one broadcast on the device)."""
        if self.group is None:
            return [int(v) for v in values]
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=self._src, group=self.group)
        return [int(v) for v in t.tolist()]

    def shard_state(self, state):
        """Data parallelism keeps the whole train state on every rank: the
        state itself (`parallel.mesh2d.MeshParallel` splits it)."""
        return state

    def full_state(self, state):
        """The whole train state: the state itself."""
        return state

    def barrier(self) -> None:
        """Wait for every rank: an all-reduce of one element on the device."""
        if self.group is None:
            return
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        t.item()
