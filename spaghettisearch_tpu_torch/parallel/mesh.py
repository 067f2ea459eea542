"""Device meshes (the counterpart of spaghettisearch_tpu/parallel/mesh.py).

The JAX mesh is single-controller: one process holds every device, and
one program per batch runs a block per device. The port keeps that design.
A Mesh is a grid of torch devices shaped by named axes; the sharded index
puts shard s's arrays on its device, and the scorers run the block once per
shard from the calling process. CUDA launches return at once, so shards on
different cards overlap. A device may appear more than once: several
shards on one card, or on the CPU (the tests' meshes).
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Named axes over an object array of torch.device (jax.sharding.Mesh's
    `devices`, `axis_names` and `shape`). Equal meshes hash alike: the
    engine keys its scorers by a tuple that holds the mesh."""

    def __init__(self, devices, axis_names: tuple[str, ...]) -> None:
        self.devices = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object)
        )
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self) -> tuple:
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _devices(n: int, devices) -> list[torch.device]:
    """The first n of `devices`, or of the visible CUDA devices (as JAX
    takes jax.devices()[:n]). Raises when there are fewer: a mesh never
    shrinks to the devices it finds, and never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass devices= (e.g. ['cpu'] * n) to "
                "place the shards explicitly"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return devices[:n]


def make_mesh(n_devices: int | None = None, axis: str = "d", devices=None) -> Mesh:
    """1-D mesh over the doc-shard axis: n_devices of `devices` (default:
    the visible CUDA devices; all of them when n_devices is None)."""
    if n_devices is None:
        n_devices = len(devices) if devices is not None else max(torch.cuda.device_count(), 1)
    return Mesh(_devices(n_devices, devices), (axis,))


def make_mesh2d(n_q: int, n_d: int, axes: tuple[str, str] = ("q", "d"), devices=None) -> Mesh:
    """2-D mesh: query batches data-parallel over `q` (no data crosses it),
    docs sharded over `d`. Index arrays are replicated across `q`."""
    devs = _devices(n_q * n_d, devices)
    return Mesh([devs[i * n_d : (i + 1) * n_d] for i in range(n_q)], axes)
