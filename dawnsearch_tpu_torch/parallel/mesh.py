"""The port's mesh: an explicit grid of torch devices along named axes.

Port of dawnsearch_tpu/parallel/mesh.py. A JAX Mesh names devices; here
a Mesh holds a numpy array of `torch.device`s shaped along its axes
("shard", the index fan-out axis, plus an optional query axis such as
"dp"). A device may appear more than once: that is how one CPU holds 8
shards in the tests (the reference's virtual CPU devices) and how one
card holds 4.

When the shards span processes (parallel/multihost.py), `shape` is the
global one, as a JAX mesh's is: the "shard" axis counts every process's
shards, process p owns the contiguous block [p·L, (p+1)·L) of it, and
`devices` holds only this process's L.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AXIS = "shard"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray          # this process's devices, shaped by axes
    axis_names: tuple[str, ...]
    process_count: int = 1
    process_index: int = 0

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes; the "shard" axis counts every process's shards."""
        out = dict(zip(self.axis_names, self.devices.shape))
        if AXIS in out:
            out[AXIS] *= self.process_count
        return out

    @property
    def local_shards(self) -> int:
        return self.devices.shape[self.axis_names.index(AXIS)]

    @property
    def first_device(self) -> torch.device:
        return self.devices.reshape(-1)[0]


def _visible_devices(n: int | None) -> list[torch.device]:
    """Every visible card, or the CPU `n` times (default once) when torch
    sees none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (n or 1)


def make_mesh(axes: dict[str, int] | None = None,
              devices: list | None = None, *,
              process_count: int | None = None,
              process_index: int | None = None) -> Mesh:
    """Build a Mesh. Default: every visible device on one "shard" axis.
    `axes` are global sizes; `devices` are this process's and must number
    their product over the process count (the "shard" axis splits over
    processes). Process count and index default to torch.distributed's
    when a process group is up, else one process."""
    if process_count is None:
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        process_count = dist.get_world_size() if up else 1
        process_index = dist.get_rank() if up else 0
    process_index = process_index or 0
    if devices is None:
        want = None
        if axes is not None:
            want = int(np.prod(list(axes.values()))) // process_count
        devices = _visible_devices(want)
    devices = [torch.device(d) for d in devices]
    if axes is None:
        axes = {AXIS: len(devices) * process_count}
    local = dict(axes)
    if process_count > 1:
        if AXIS not in local or local[AXIS] % process_count:
            raise ValueError(f"mesh {axes} must split its \"{AXIS}\" axis "
                             f"over {process_count} processes")
        local[AXIS] //= process_count
    need = int(np.prod(list(local.values())))
    if not devices:
        raise ValueError(f"mesh {axes} has no devices")
    if need != len(devices):
        raise ValueError(f"mesh {axes} needs {need} devices"
                         f"{' a process' if process_count > 1 else ''}, "
                         f"have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(local.values())), tuple(local),
                process_count, process_index)
