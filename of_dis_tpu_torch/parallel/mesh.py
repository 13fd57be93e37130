"""Frame-pair data parallelism over a list of devices.

The reference is a single-process CPU program with no distributed
backend; its only parallelism is OpenMP over patches. The JAX package
scales by sharding the frame-pair batch axis over a device mesh, each chip
running the whole per-pair pipeline on its shard with no collective on the
hot path. The port does the same without a framework mesh: a `Mesh` is a
list of devices (repeats allowed), a batch is cut on its leading axis into
one contiguous chunk a device, in order, and each chunk runs
`dis_flow_batched` (or `dis_sequence_batched`) on its own device. All
chunks are launched from the calling thread, one after another; the
kernels run on each tensor's own device (`kernels.build.launch`) and the
calls return before the devices finish, so the devices work side by side.
The results come back as the list of per-device outputs in batch order
(the JAX package's `addressable_shards`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.params import DISParams


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of devices; the batch's chunk d runs on devices[d]."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `devices` (torch devices or their names, repeats allowed),
    or of every CUDA device. Raises when CUDA is asked for and missing."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass a list of "
                               "devices, e.g. ['cpu'] * 8")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(dis.resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs)


def shard_bounds(mesh: Mesh, n: int) -> List[slice]:
    """The split rule: a batch of n (or, for `parallel.spatial`, n rows)
    cut into one contiguous chunk a device, in order; slice d is device
    d's. Raises unless n divides evenly."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not divide over "
                         f"{mesh.size} devices")
    per = n // mesh.size
    return [slice(d * per, (d + 1) * per) for d in range(mesh.size)]


def _chunks(mesh: Mesh, x, dim: int) -> List[torch.Tensor]:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return [t[(slice(None),) * dim + (s,)].to(dev).contiguous()
            for s, dev in zip(shard_bounds(mesh, t.shape[dim]),
                              mesh.devices)]


def shard_batch(mesh: Mesh, *arrays):
    """Each array cut on its leading (batch) axis by `shard_bounds`, chunk
    d on the mesh's device d: a list of chunks per array (the list itself
    for one array)."""
    out = tuple(_chunks(mesh, a, 0) for a in arrays)
    return out if len(out) > 1 else out[0]


def dis_flow_sharded(mesh: Mesh, im_a, im_b, params: DISParams,
                     full_w: int, full_h: int) -> List[torch.Tensor]:
    """Batched DIS flow with the frame-pair axis split over the mesh.

    im_a / im_b: (B, C, H, W) with B divisible by the mesh size, or the
    lists `shard_batch` made of them. Returns the per-device results in
    batch order, each (B / n, H, W, nop) on its device."""
    if not isinstance(im_a, (list, tuple)):
        im_a, im_b = shard_batch(mesh, im_a, im_b)
    return [dis.dis_flow_batched(a, b, params, full_w, full_h, device=dev)
            for a, b, dev in zip(im_a, im_b, mesh.devices)]


def dis_sequence_sharded(mesh: Mesh, frames, params: DISParams,
                         full_w: int, full_h: int) -> List[torch.Tensor]:
    """Warm-start sequence mode with the STREAM axis split over the mesh:
    frames (T, S, C, H, W) with S divisible by the mesh size (or the
    per-device list of its chunks on axis 1); each device advances its own
    streams, their warm-start carries staying on it. Returns the
    per-device results, each (T-1, S / n, H, W, nop) on its device."""
    if not isinstance(frames, (list, tuple)):
        frames = _chunks(mesh, frames, 1)
    return [dis.dis_sequence_batched(f, params, full_w, full_h, device=dev)
            for f, dev in zip(frames, mesh.devices)]
