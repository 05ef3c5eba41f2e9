"""Device mesh over the tile axis.

Port of ``nemo_tpu/parallel/mesh.py``.  The JAX package shards a leading
tile axis over a 1-d ``jax.sharding.Mesh``; here a :class:`Mesh` is the
ordered list of torch devices that axis is split over, and a sharded batch
is a list of per-shard tensors in mesh order, each on its shard's device
(their concatenation along the first axis is the batch).

A device may appear more than once: its positions are virtual shards on
one device, as the JAX package's tests run an 8-device mesh on forced
host devices.  ``device="cpu"`` gives ``n_devices`` such shards on the
CPU; on one card, ``devices=["cuda:0"] * 2`` gives two.

Deviation from the JAX package: a tile count that the mesh does not
divide gives uneven shards (the first ones one tile longer), where the
JAX engine pads a partial chunk with copies of its last tile; fewer tiles
than positions leave the last positions empty.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a 1-d tile mesh, one per position."""
    devices: tuple

    @property
    def size(self):
        return len(self.devices)


def get_mesh(n_devices=None, devices=None, device="cuda"):
    """1-d mesh over the tile axis.

    ``devices`` names the positions (a device may repeat).  Otherwise
    ``device="cuda"`` takes every visible card (the first ``n_devices``),
    a card with an index that card alone, and ``device="cpu"``
    ``n_devices`` (default 1) virtual shards of the CPU.

    Raises if fewer devices exist than requested instead of silently
    truncating - a silently smaller mesh would run a different parallel
    decomposition than the caller asked for - and never falls back to the
    CPU.
    """
    if devices is not None:
        devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not devices:
            raise ValueError("get_mesh: an empty device list")
        return Mesh(devices)
    dev = torch.device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * (1 if n_devices is None else int(n_devices)))
    if dev.type != "cuda":
        raise ValueError("get_mesh: device must be 'cpu' or 'cuda', got %r"
                         % device)
    available = [dev] if dev.index is not None else \
        [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(available) < n_devices:
            raise RuntimeError(
                "get_mesh: %d devices requested but only %d available on "
                "platform %r (for virtual shards on one card pass "
                "devices=['cuda:0'] * N)" % (n_devices, len(available),
                                             dev.type))
        available = available[:n_devices]
    if not available:
        raise RuntimeError("get_mesh: no CUDA device is available; pass "
                           "device='cpu' for a CPU mesh")
    return Mesh(tuple(available))


def _indexed(dev):
    """A cuda device with its index (``cuda`` is the current card), so
    that positions on one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class TileSharding:
    """A leading tile axis split into contiguous shards in mesh order
    (``PartitionSpec(TILE_AXIS)`` in the JAX package)."""
    mesh: Mesh

    def slices(self, n):
        """(device, slice) of each non-empty shard of ``n`` tiles."""
        base, extra = divmod(int(n), self.mesh.size)
        out, start = [], 0
        for k, dev in enumerate(self.mesh.devices):
            stop = start + base + (1 if k < extra else 0)
            if stop > start:
                out.append((dev, slice(start, stop)))
            start = stop
        return out

    def put(self, a, dtype=None):
        """A host array or tensor with a leading tile axis -> the list of
        its shards, each on its device (``dtype``: cast on the way)."""
        t = torch.as_tensor(a)
        return [t[sl].to(device=dev, dtype=dtype or t.dtype)
                for dev, sl in self.slices(t.shape[0])]


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A shared input on every device of the mesh
    (``PartitionSpec()``)."""
    mesh: Mesh

    def put(self, a, dtype=None):
        """{device: copy} of ``a``, one copy for each distinct device."""
        t = torch.as_tensor(a)
        return {dev: t.to(device=dev, dtype=dtype or t.dtype)
                for dev in dict.fromkeys(self.mesh.devices)}


def tile_sharding(mesh):
    """Shard the leading (tile) axis, replicate the rest."""
    return TileSharding(mesh)


def replicated(mesh):
    return Replicated(mesh)
