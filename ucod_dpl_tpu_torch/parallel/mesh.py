"""Device meshes and the batch rule of the data axis, without JAX.

Counterpart of :mod:`ucod_dpl_tpu.parallel.mesh`.  A :class:`Mesh` is an
array of ``torch.device`` with named axes, as ``jax.sharding.Mesh`` is an
array of JAX devices; :func:`build_mesh` refuses what the JAX function
refuses.  The devices default to every visible CUDA device, and a mesh
without one raises: nothing falls back to the CPU.  An explicit device list
may name one device more than once, which is how one card runs a 4-way
``model`` axis (the shards then run one after another on it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: an object array of ``torch.device`` whose dims are the
    axes ``axis_names``; ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims with axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (axes not named: 0)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise KeyError(f"mesh has no axes {sorted(unknown)}; axes {self.axis_names}")
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def build_mesh(mesh_cfg: Optional[Dict[str, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{axis: size}``, ``-1`` meaning all remaining devices.

    ``devices`` defaults to every visible CUDA device; it raises when there
    is none.  Sizes that do not divide the device count, or cover only part
    of it, raise instead of silently stranding devices."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("build_mesh: no CUDA device is visible; pass `devices` to build a mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    cfg = dict(mesh_cfg or {"data": -1, "model": 1})
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
    arr = np.empty(n, dtype=object)
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
