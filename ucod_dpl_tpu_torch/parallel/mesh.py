"""Device meshes and the batch rule of the data axis, without JAX.

Counterpart of :mod:`ucod_dpl_tpu.parallel.mesh`.  A :class:`Mesh` is an
array of ``torch.device`` with named axes, as ``jax.sharding.Mesh`` is an
array of JAX devices; :func:`build_mesh` refuses what the JAX function
refuses.  The devices default to every visible CUDA device, and a mesh
without one raises: nothing falls back to the CPU.  An explicit device list
may name one device more than once, which is how one card runs a 4-way
``model`` axis (the shards then run one after another on it).

Under a ``torch.distributed`` group of W processes, :func:`build_mesh`
without ``devices`` spans the processes, as the JAX mesh spans
``jax.distributed`` processes: W x k cards, k consecutive cards of each
process, process 0's first, reshaped row-major.  One mesh config then maps
each coordinate to the same process in both packages.  Each process knows
the coordinates it holds (:meth:`Mesh.local_block`), and the mesh holds one
subgroup per line of each axis (:meth:`Mesh.group`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ucod_dpl_tpu_torch.parallel import distributed as D


class Mesh:
    """``devices``: an object array of ``torch.device`` whose dims are the
    axes ``axis_names``; ``shape`` maps each axis name to its size.

    ``ranks``: the global rank that holds each coordinate (an int array of
    the same shape): this process's rank everywhere on a mesh of one process
    (the default); on a mesh over processes, ``devices`` names the other
    processes' cards only as labels.  ``groups``: the subgroup of each line
    of an axis that crosses processes, keyed by (axis, the line's ranks)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], ranks: Optional[np.ndarray] = None,
                 groups: Optional[Dict[Tuple[str, Tuple[int, ...]], Any]] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims with axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self._ranks = ranks
        self.groups = groups or {}

    @property
    def rank(self) -> int:
        return D.process_index()

    @property
    def ranks(self) -> np.ndarray:
        # a mesh of one process: this process's rank, read at each use
        return np.full(self.devices.shape, self.rank) if self._ranks is None else self._ranks

    @property
    def spans_processes(self) -> bool:
        """Whether a line of an axis crosses processes (each such line has its
        subgroup)."""
        return bool(self.groups)

    def _index(self, coords: Dict[str, int]) -> Tuple[int, ...]:
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise KeyError(f"mesh has no axes {sorted(unknown)}; axes {self.axis_names}")
        return tuple(coords.get(a, 0) for a in self.axis_names)

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (axes not named: 0)."""
        return self.devices[self._index(coords)]

    def owner(self, **coords: int) -> int:
        """The global rank holding the coordinates."""
        return int(self.ranks[self._index(coords)])

    def local_block(self) -> Dict[str, List[int]]:
        """The coordinates this process holds, per axis (every coordinate on a
        mesh of one process): a block, the product of these lists.  A process
        whose coordinates are not a block (k cards that do not tile the
        mesh's axes) raises NotImplementedError."""
        mine = np.argwhere(self.ranks == self.rank)
        block = {a: sorted({int(c) for c in mine[:, i]}) for i, a in enumerate(self.axis_names)}
        if len(mine) != int(np.prod([len(v) for v in block.values()])) or any(
                v != list(range(v[0], v[-1] + 1)) for v in block.values()):
            raise NotImplementedError(f"process {self.rank} holds {len(mine)} coordinates of mesh {self.shape} that "
                                      "are not a block: choose cards per process that tile the mesh's axes")
        return block

    def group(self, axis: str):
        """The subgroup of the processes along ``axis`` through this process's
        block (its first coordinate), in rank order; ``distributed.LOCAL``
        (this process alone: no collective) when that line, or the mesh,
        stays in this process or the mesh has no such axis."""
        if axis not in self.shape:
            return D.LOCAL
        first = {a: v[0] for a, v in self.local_block().items()}
        line = self.ranks[tuple(slice(None) if a == axis else first[a] for a in self.axis_names)]
        key = tuple(sorted({int(r) for r in np.ravel(line)}))
        return D.LOCAL if len(key) == 1 else self.groups[(axis, key)]

    def __repr__(self) -> str:
        procs = f", ranks={self.ranks.ravel().tolist()}" if self.spans_processes else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{procs})"


def _sizes(cfg: Dict[str, int], n: int) -> Dict[str, int]:
    """The axis sizes of ``cfg`` over ``n`` devices (``-1``: all remaining);
    raises where the JAX ``build_mesh`` raises."""
    fixed = int(np.prod([v for v in cfg.values() if v != -1])) or 1
    if n % fixed:
        raise ValueError(
            f"mesh axes {cfg} do not divide the device count {n}; a silent partial mesh would strand "
            f"{n - (n // fixed) * fixed} device(s): fix the axis sizes (use -1 for 'all remaining')."
        )
    sizes = {k: (n // fixed if v == -1 else v) for k, v in cfg.items()}
    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(
            f"mesh {sizes} covers {total} of {n} devices; refusing to silently drop devices: fix the "
            "axis sizes (use -1 for 'all remaining')."
        )
    return sizes


def _process_mesh(cfg: Dict[str, int]) -> Mesh:
    """The mesh over the processes of the group: ``k`` = mesh size / W cards
    of each process (the ``cards`` the group was started with when an axis
    is -1), rank r holding flat positions r*k .. r*k+k-1; every process makes
    the subgroup of every line of every axis that crosses processes, in the
    same order."""
    world, rank = D.process_count(), D.process_index()
    if -1 in cfg.values():
        k = D.cards_per_process()
    else:
        size = int(np.prod(list(cfg.values())))
        if size % world:
            raise ValueError(f"mesh {cfg} of {size} devices over {world} processes: the size must be a multiple of "
                             "the process count")
        k = size // world
    sizes = _sizes(cfg, world * k)
    home = torch.device("cuda", torch.cuda.current_device()) if torch.distributed.get_backend() != "gloo" \
        else torch.device("cpu")
    if home.type == "cuda":
        first = int(os.environ.get("LOCAL_RANK", "0")) * k
        if home.index != first or first + k > torch.cuda.device_count():
            raise RuntimeError(f"a mesh of {k} card(s) a process needs this rank on cards {first}..{first + k - 1} "
                               f"(maybe_initialize_distributed(cards={k})); it is on {home}, "
                               f"{torch.cuda.device_count()} visible")
        local = [torch.device("cuda", first + j) for j in range(k)]
    else:
        local = [home] * k
    ranks = np.repeat(np.arange(world), k)
    devices = np.empty(world * k, dtype=object)
    for p in range(world * k):
        r, j = divmod(p, k)
        devices[p] = local[j] if r == rank else (
            torch.device("cuda", r * k + j) if home.type == "cuda" else home)
    shape = tuple(sizes.values())
    ranks, devices = ranks.reshape(shape), devices.reshape(shape)
    groups = {}
    for i, axis in enumerate(sizes):
        for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
            key = (axis, tuple(sorted({int(r) for r in line})))
            if len(key[1]) > 1 and key not in groups:
                groups[key] = D.subgroup(key[1])
    return Mesh(devices, tuple(sizes.keys()), ranks=ranks, groups=groups)


def build_mesh(mesh_cfg: Optional[Dict[str, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{axis: size}``, ``-1`` meaning all remaining devices.

    ``devices`` defaults to every visible CUDA device; it raises when there
    is none.  Under a group of more than one process, no ``devices`` builds
    the mesh over the processes (see the module docstring); with
    ``devices`` the mesh is this process's own.  Sizes that do not divide the
    device count, or cover only part of it, raise instead of silently
    stranding devices."""
    cfg = dict(mesh_cfg or {"data": -1, "model": 1})
    if devices is None and D.process_count() > 1:
        return _process_mesh(cfg)
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("build_mesh: no CUDA device is visible; pass `devices` to build a mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    sizes = _sizes(cfg, len(devices))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(sizes.values())), tuple(sizes.keys()))


def data_sharding(mesh: Mesh, batch_size: Optional[int] = None) -> List[slice]:
    """The batch rows each coordinate of the ``data`` axis holds, the rule of
    the JAX ``data_sharding``: the batch split evenly over the axis, or, when
    ``batch_size`` is None (no batch dim) or does not divide the axis size,
    the whole batch on every coordinate (replicated)."""
    n = mesh.shape.get("data", 1)
    if batch_size is None or batch_size % n:
        return [slice(None)] * n
    per = batch_size // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def replicate(mesh: Mesh) -> List[slice]:
    """The rows each coordinate of the ``data`` axis holds of an array that
    is replicated (the JAX ``replicate``'s ``PartitionSpec()``): all of
    them, on every coordinate."""
    return [slice(None)] * mesh.shape.get("data", 1)


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """A tree (dicts, lists, tuples) of numpy batch arrays -> one tree of
    tensors per ``data`` coordinate this process holds (every one on a mesh
    of one process), each holding that coordinate's rows
    (:func:`data_sharding`: replicated where the batch does not divide the
    axis; a scalar replicated) on the coordinate's device (the other axes
    at this process's first coordinate): the JAX ``shard_batch``'s shards."""
    block = mesh.local_block()
    first = {a: v[0] for a, v in block.items()}
    coords = block.get("data", [0])

    def put(x, d):
        x = np.asarray(x)
        rows = data_sharding(mesh, x.shape[0])[d] if x.ndim else slice(None)
        device = mesh.device(**{**first, **({"data": d} if "data" in mesh.shape else {})})
        return torch.as_tensor(np.ascontiguousarray(x[rows] if x.ndim else x)).to(device)

    def tree(t, d):
        if isinstance(t, dict):
            return {k: tree(v, d) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(tree(v, d) for v in t)
        return put(t, d)

    return [tree(batch, d) for d in coords]
