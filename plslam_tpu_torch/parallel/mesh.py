"""Shard meshes for the distributed back end.

Port of ``plslam_tpu/parallel/mesh.py``. The reference lays a (kf, lm)
mesh over JAX devices and runs each sharded program through ``shard_map``
with XLA collectives. Here a ``Mesh`` is an ordered list of local shards,
each on a torch device, arranged row-major on the mesh's axes:

  placement   : ``make_mesh(n, axes, device)`` puts shard i on device
                ``i % count`` of the visible devices of ``device``'s type,
                so on a one-card machine every shard is on ``cuda:0`` and on
                four cards each card holds n / 4 of them; on the CPU every
                shard is on ``cpu``. A mesh on ``cuda`` without a card
                raises (no move to the CPU).
  launch      : ``Mesh.map(fn, *args)`` calls ``fn`` once a shard, in shard
                order, under that shard's device; the shard's work is the
                sequence of maps and collectives a caller writes out (the
                reference's ``shard_map`` body). There is no counterpart of
                ``shard_map_fn`` or ``sharding``: a shard's arrays are
                ordinary tensors on its device.
  collectives : ``psum``, ``pmax``, ``pmin`` and ``all_gather`` over an
                axis take one tensor a local shard, combine them in shard
                order on the first shard's device (a fixed order: the same
                bits whatever the placement), then, where the axis spans
                processes, over the ``torch.distributed`` process group,
                and hand the result to every shard's device.
  processes   : ``init_multihost`` joins the process group with the backend
                the caller names (``"nccl"`` or ``"gloo"``; never switched
                on failure). NCCL refuses two ranks on one card, so two
                processes on one card take gloo, whose collectives run here
                on host copies of device tensors (gloo has no CUDA
                all_gather). ``make_global_mesh`` is each process's local
                shards times the world, the process axis folded into the
                first mesh axis, as in the reference.

``Mesh.reduce_bytes`` counts the bytes each all-reduce (psum, pmax, pmin)
carries, one shard's tensor a collective: the volume the reference's test
reads off its compiled program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _factor_2d(n: int) -> Tuple[int, int]:
    """Split n shards into the most-square (a, b) grid with a*b = n."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def _local_shape(n: int, axes: Sequence[str]) -> Tuple[int, ...]:
    if len(axes) == 1:
        return (n,)
    if len(axes) == 2:
        return _factor_2d(n)
    raise ValueError("only 1D/2D meshes supported")


def _place(n: int, device) -> List[torch.device]:
    """n shards round-robin on the visible devices of ``device``'s type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on cuda needs a CUDA device and none "
                               "is available; pass device='cpu'")
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]
    return [dev] * n


_OPS: Dict[str, Callable] = {"sum": torch.add, "max": torch.maximum,
                             "min": torch.minimum}


class Mesh:
    """Local shards on torch devices over named axes; see the module's
    docstring. ``shape`` maps each axis to its global size."""

    def __init__(self, devices: Sequence[torch.device],
                 local_shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0, world: int = 1,
                 backend: Optional[str] = None):
        if math.prod(local_shape) != len(devices):
            raise ValueError(f"{len(devices)} shards for a local mesh of "
                             f"shape {tuple(local_shape)}")
        self.devices = list(devices)
        self.axes = tuple(axes)
        self.local_shape = tuple(local_shape)
        self.rank, self.world, self.backend = rank, world, backend
        glob = (local_shape[0] * world,) + tuple(local_shape[1:])
        self.shape = dict(zip(self.axes, glob))
        self.reduce_bytes = 0

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return math.prod(self.shape.values())

    def coords(self, i: int) -> Tuple[int, ...]:
        """Global mesh coordinates of local shard i."""
        c, out = i, []
        for s in reversed(self.local_shape):
            out.append(c % s)
            c //= s
        out.reverse()
        out[0] += self.rank * self.local_shape[0]
        return tuple(out)

    def axis_index(self, i: int, axis: str) -> int:
        return self.coords(i)[self.axes.index(axis)]

    def map(self, fn, *args) -> list:
        """``fn`` once a local shard under its device; a list argument is
        taken shard by shard, anything else passed to every shard."""
        out = []
        for i, dev in enumerate(self.devices):
            a = [x[i] if isinstance(x, list) else x for x in args]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out.append(fn(*a))
            else:
                out.append(fn(*a))
        return out

    def _groups(self, axis: str) -> List[List[int]]:
        """Local shards that share every coordinate but ``axis``'s, each
        group in the order of its ``axis`` coordinate."""
        k = self.axes.index(axis)
        groups: Dict[tuple, List[int]] = {}
        for i in range(len(self.devices)):
            c = self.coords(i)
            groups.setdefault(c[:k] + c[k + 1:], []).append(i)
        return [sorted(g, key=lambda i: self.coords(i)[k])
                for _, g in sorted(groups.items())]

    def _spans_processes(self, axis: str) -> bool:
        return self.world > 1 and self.axes.index(axis) == 0

    def _reduce(self, xs: list, axis: str, op: str) -> list:
        out = [None] * len(xs)
        for g in self._groups(axis):
            dev0 = self.devices[g[0]]
            acc = xs[g[0]].to(dev0)
            for i in g[1:]:
                acc = _OPS[op](acc, xs[i].to(dev0))
            if self._spans_processes(axis):
                acc = self._all_reduce(acc, op)
            for i in g:
                out[i] = acc.to(self.devices[i])
        self.reduce_bytes += xs[0].numel() * xs[0].element_size()
        return out

    def psum(self, xs: list, axis: str) -> list:
        return self._reduce(xs, axis, "sum")

    def pmax(self, xs: list, axis: str) -> list:
        return self._reduce(xs, axis, "max")

    def pmin(self, xs: list, axis: str) -> list:
        return self._reduce(xs, axis, "min")

    def all_gather(self, xs: list, axis: str) -> list:
        """Each shard gets the (n, ...) stack of the group's tensors in
        ``axis`` order."""
        out = [None] * len(xs)
        for g in self._groups(axis):
            dev0 = self.devices[g[0]]
            acc = torch.stack([xs[i].to(dev0) for i in g])
            if self._spans_processes(axis):
                acc = self._all_gather(acc)
            for i in g:
                out[i] = acc.to(self.devices[i])
        return out

    # -- the layout of a whole tensor over an axis ---------------------------
    def shard(self, x: torch.Tensor, axis: str, dim: int = 0) -> list:
        """Local shard i's slice of ``x`` along ``dim``: the
        ``axis_index(i, axis)``-th of ``shape[axis]`` equal parts, on the
        shard's device."""
        n = self.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} shards")
        m = x.shape[dim] // n
        return [x.narrow(dim, self.axis_index(i, axis) * m, m).to(dev)
                for i, dev in enumerate(self.devices)]

    def gather(self, xs: list, axis: str, dim: int = 0) -> torch.Tensor:
        """The whole tensor of ``shard``'s layout, from the first local
        shard's ``all_gather``."""
        st = self.all_gather(xs, axis)[0]
        return torch.cat(list(st.unbind(0)), dim=dim)

    # -- across processes --------------------------------------------------
    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """gloo's collectives run on host tensors: device tensors are
        copied there and back."""
        return x.cpu() if self.backend == "gloo" else x

    def _all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        h = self._host(x).clone()
        dist.all_reduce(h, op=rop)
        return h.to(x.device)

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        h = self._host(x).contiguous()
        parts = [torch.empty_like(h) for _ in range(self.world)]
        dist.all_gather(parts, h)
        return torch.cat(parts).to(x.device)


def make_mesh(n_devices: int, axes: Sequence[str] = ("kf", "lm"),
              device=None) -> Mesh:
    """A one-process mesh of ``n_devices`` shards placed round-robin on the
    visible devices of ``device``'s type (default ``cuda``; raises without
    a card); 2D axes take the most-square grid."""
    return Mesh(_place(n_devices, device), _local_shape(n_devices, axes),
                axes)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> int:
    """Join the process group (``torch.distributed.init_process_group``)
    when ``num_processes`` > 1: ``coordinator_address`` is its init method
    (``tcp://host:port`` or ``file:///path``), ``backend`` the caller's
    choice of ``"nccl"`` or ``"gloo"``. Returns this process's rank (0 in a
    single process, which joins nothing)."""
    if num_processes is None or num_processes <= 1:
        return 0
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_multihost: backend must be 'nccl' or 'gloo', "
                         f"got {backend!r}")
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def make_global_mesh(axes: Sequence[str] = ("kf", "lm"), n_local: int = 1,
                     device=None) -> Mesh:
    """The mesh over every process of the group: ``n_local`` shards a
    process (placed as ``make_mesh`` places them) times the world, the
    process axis folded into the first mesh axis (process r holds rows
    [r a, (r + 1) a) of it, a the local extent)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = (dist.get_world_size(), dist.get_rank(),
                                dist.get_backend())
    else:
        world, rank, backend = 1, 0, None
    return Mesh(_place(n_local, device), _local_shape(n_local, axes), axes,
                rank=rank, world=world, backend=backend)
