"""Device mesh, placement and collectives (counterpart of
gps_jamming_tpu.parallel.mesh).

The JAX package lays captures out on a `jax.sharding.Mesh` with the axes
('antenna', 'time') and lets `shard_map` insert the collectives. The port
keeps that layout with one controller per process:

- a `Mesh` is an (n_antenna, n_time) grid of `torch.device`s. A device may
  repeat: `['cpu'] * 8` is the port's counterpart of JAX's eight virtual
  CPU devices, and `[cuda:0] * 6` lays a 3 x 2 mesh over one card;
- a sharded array is a grid of tensors, `grid[i][t]` on `devices[i][t]`
  (`place_blocks`, `place_antenna`; `gather_blocks` brings it back);
- the collectives are explicit functions over the grid. Along time,
  `sum_in_order` adds a row's shards in time order and `all_gather_time`
  concatenates them, both on the row's first device. Along antennas,
  `gather_antenna` collects every row's tensor in row order on the mesh's
  first device, across processes with `torch.distributed.all_gather`
  (gloo for CPU tensors, NCCL for CUDA ones) where the antenna axis spans
  them (`multihost_mesh`); `all_gather_antenna` stacks them and
  `sum_in_order` adds them in row order. Each sum runs in this one order
  whatever the devices, so a mesh shape gives the same bits run after run.
  A single controller reads each reduced result once, so it stays on the
  device where it was reduced; JAX's `psum` leaves a copy on every device,
  which here nothing would read.

Within a process a copy between shards is `.to(device, non_blocking=True)`,
a no-op where the device repeats.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import require_cuda

ANTENNA_AXIS = "antenna"
TIME_AXIS = "time"
# the coordinator's address when init_distributed is given none (the
# JAX package's variable, so that one launcher serves both packages)
COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"


class Mesh:
    """An (n_antenna, n_time) grid of devices with the axis names
    ('antenna', 'time').

    `devices[i]` is the row of antenna `local_rows[i]`; in a mesh of one
    process every row is local. A mesh over several processes
    (`multihost_mesh`) holds only this process's rows; the others live in
    the other processes, which hold the same number of rows each, in rank
    order."""

    axis_names = (ANTENNA_AXIS, TIME_AXIS)

    def __init__(self, devices, n_antenna: int | None = None,
                 local_rows=None):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.n_antenna = len(self.devices) if n_antenna is None else n_antenna
        self.n_time = len(self.devices[0])
        self.local_rows = tuple(range(len(self.devices)) if local_rows is None
                                else local_rows)

    @property
    def shape(self) -> dict:
        return {ANTENNA_AXIS: self.n_antenna, TIME_AXIS: self.n_time}

    @property
    def distributed(self) -> bool:
        """Does the antenna axis span processes?"""
        return len(self.local_rows) < self.n_antenna

    @property
    def first_device(self) -> torch.device:
        """Where the antenna collectives leave their results."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, local rows {list(self.local_rows)})"


def local_devices() -> list[torch.device]:
    """The visible CUDA cards; raises RuntimeError where there is none."""
    require_cuda()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_antenna: int = 1, n_time: int | None = None,
              devices=None) -> Mesh:
    """Mesh over (antenna, time): `devices` (None: the visible cards) in
    row-major order. n_time defaults to len(devices) / n_antenna."""
    devices = local_devices() if devices is None else list(devices)
    n_dev = len(devices)
    if n_time is None:
        if n_dev % n_antenna:
            raise ValueError(f"{n_dev} devices not divisible by "
                             f"n_antenna={n_antenna}")
        n_time = n_dev // n_antenna
    if n_antenna * n_time != n_dev:
        raise ValueError(f"mesh {n_antenna}x{n_time} != {n_dev} devices")
    return Mesh([devices[a * n_time:(a + 1) * n_time]
                 for a in range(n_antenna)])


def single_device_mesh() -> Mesh:
    """Degenerate 1x1 mesh on the first card."""
    return make_mesh(1, 1, devices=local_devices()[:1])


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout_s: float = 300.0) -> bool:
    """Multi-process bring-up: join the process group at
    `coordinator_address` ("host:port", over TCP; or a rendezvous URL such
    as "file:///path/to/store", which needs no free port; None:
    $JAX_COORDINATOR_ADDRESS) as `process_id` of `num_processes`.

    Returns False, doing nothing, where no coordinator is configured
    (single-process paths call this unconditionally) or the group exists
    already; True once joined. The group runs gloo for CPU tensors and,
    where this PyTorch has it, NCCL for CUDA ones. Any other failure to
    join raises, and a rendezvous that does not complete within
    `timeout_s` raises too."""
    if coordinator_address is None:
        coordinator_address = os.environ.get(COORDINATOR_ENV)
    if coordinator_address is None or dist.is_initialized():
        return False
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator needs "
                         "num_processes and process_id")
    backend = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
    dist.init_process_group(
        backend, init_method=(coordinator_address
                              if "://" in coordinator_address
                              else f"tcp://{coordinator_address}"),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def multihost_mesh(n_antenna: int | None = None, devices=None) -> Mesh:
    """(antenna, time) mesh over every process of the group.

    The antenna axis is the processes (each antenna's SDR stream is
    captured and ingested by one host, so only the fused reductions cross
    between hosts), n_antenna / world rows each, in rank order; the time
    axis is this process's `devices` (None: its visible cards). Without a
    process group this is the one process's mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_antenna = world if n_antenna is None else n_antenna
    if n_antenna % world:
        raise ValueError(f"n_antenna={n_antenna} not divisible by {world} "
                         "processes")
    k = n_antenna // world
    local = make_mesh(k, None, devices)
    return Mesh(local.devices, n_antenna=n_antenna,
                local_rows=range(rank * k, (rank + 1) * k))


# --- placement ---------------------------------------------------------------

# Bytes that `_to` has placed from host memory (a NumPy array or a CPU
# tensor) on a mesh device, counted whatever the device, the CPU included:
# the sharded path's uploads. `reset_upload_bytes` and `upload_bytes` read
# it, as `kernels.build.LAUNCHES` counts the kernels' launches.
UPLOAD_BYTES = 0


def reset_upload_bytes() -> None:
    global UPLOAD_BYTES
    UPLOAD_BYTES = 0


def upload_bytes() -> int:
    return UPLOAD_BYTES


def _to(x, device: torch.device) -> torch.Tensor:
    """A host array or tensor on `device` (complex as complex64)."""
    global UPLOAD_BYTES
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x = x.astype(np.complex64, copy=False)
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif x.is_complex():
        x = x.to(torch.complex64)
    if x.device.type == "cpu":
        UPLOAD_BYTES += x.numel() * x.element_size()
    return x.to(device, non_blocking=True)


def _local_rows(x, mesh: Mesh, what: str):
    """The rows of `x` this process holds: x has n_antenna rows (this
    process picks its own) or exactly its local rows."""
    if len(x) == mesh.n_antenna:
        return [x[a] for a in mesh.local_rows]
    if len(x) == len(mesh.local_rows):
        return list(x)
    raise ValueError(f"{what}: {len(x)} rows for a mesh of {mesh.n_antenna} "
                     f"antennas ({len(mesh.local_rows)} local)")


def _is_grid(x) -> bool:
    return isinstance(x, (list, tuple)) and len(x) > 0 and \
        isinstance(x[0], (list, tuple))


def place_blocks(blocks, mesh: Mesh) -> list[list[torch.Tensor]]:
    """(n_antenna, n_blocks, block_len) host array, tensor or sequence of
    per-antenna (n_blocks, block_len) arrays -> the grid of shards: antenna
    row i, time shard t holds blocks[i, t*k:(t+1)*k] (k = n_blocks /
    n_time) on devices[i][t]. Each shard is uploaded once, to its own
    device. A grid is returned as it is."""
    if _is_grid(blocks):
        if len(blocks) != len(mesh.local_rows) or any(
                len(r) != mesh.n_time for r in blocks):
            raise ValueError("place_blocks: the grid does not match "
                             f"{mesh}")
        return [list(r) for r in blocks]
    grid = []
    for row, devs in zip(_local_rows(blocks, mesh, "place_blocks"),
                         mesh.devices):
        if row.shape[0] % mesh.n_time:
            raise ValueError(f"place_blocks: {row.shape[0]} blocks do not "
                             f"split over {mesh.n_time} time shards")
        k = row.shape[0] // mesh.n_time
        grid.append([_to(row[t * k:(t + 1) * k], d)
                     for t, d in enumerate(devs)])
    return grid


def place_antenna(x, mesh: Mesh) -> list[torch.Tensor]:
    """(n_antenna, ...) -> one tensor per local antenna row, on the row's
    first device (an array sharded along 'antenna' only)."""
    return [_to(r, row[0]) for r, row in
            zip(_local_rows(x, mesh, "place_antenna"), mesh.devices)]


def gather_blocks(grid, device=None) -> torch.Tensor:
    """The grid back as one (n_rows, n_blocks, block_len) tensor on
    `device` (None: the first shard's)."""
    device = grid[0][0].device if device is None else torch.device(device)
    return torch.stack([torch.cat([s.to(device) for s in row])
                        for row in grid])


# --- collectives -------------------------------------------------------------

def sum_in_order(ts: list[torch.Tensor]) -> torch.Tensor:
    """ts[0] + ts[1] + ... left to right, on ts[0]'s device: the psum of a
    row's time shards, or of the antenna rows."""
    out = ts[0]
    for t in ts[1:]:
        out = out + t.to(out.device, non_blocking=True)
    return out


def all_gather_time(row: list[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """A row's time shards concatenated along `dim`, in time order, on the
    row's first device."""
    dev = row[0].device
    return torch.cat([s.to(dev, non_blocking=True) for s in row], dim=dim)


def gather_antenna(mesh: Mesh,
                   per_row: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every antenna row's tensor, in row order, on the mesh's first
    device: `per_row` holds this process's rows (equal shapes). Across
    processes this is one `torch.distributed.all_gather`."""
    dev = mesh.first_device
    local = [t.to(dev, non_blocking=True) for t in per_row]
    if not mesh.distributed:
        return local
    x = torch.stack(local)
    cplx = x.is_complex()
    if cplx:
        x = torch.view_as_real(x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            dist.all_gather(parts, x)
    else:
        dist.all_gather(parts, x)
    rows = torch.cat(parts)
    if cplx:
        rows = torch.view_as_complex(rows)
    return list(rows.unbind(0))


def all_gather_antenna(mesh: Mesh,
                       per_row: list[torch.Tensor]) -> torch.Tensor:
    """Every antenna row's tensor stacked, (n_antenna, ...), on the mesh's
    first device."""
    return torch.stack(gather_antenna(mesh, per_row))
