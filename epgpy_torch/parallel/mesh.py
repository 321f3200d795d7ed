"""Device meshes and atom-parallel execution.

Counterpart of ``epgpy_tpu/parallel/mesh.py``.  The mesh is single
controller, as JAX's is: one process calls every sharded function with
whole tensors and gets whole results back.  A sharded call splits its
per-atom inputs over the entries of one mesh axis, runs each shard on its
entry's device and concatenates the outputs on the mesh's first device.
The collectives of ``jax.shard_map`` are plain tensor operations here
(the mean of the shards' means for ``pmean``, ``torch.cat`` for
``all_gather``), so autograd runs through them.

The one difference from ``jax.sharding.Mesh``: entries may repeat a
device.  ``make_mesh([torch.device("cpu")] * 8)`` is the counterpart of
JAX's eight virtual CPU devices, and ``make_mesh([torch.device("cuda",
0)] * 4)`` runs four shards on one card, one after another.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config

__all__ = ["Mesh", "make_mesh", "atom_sharding"]


class Mesh:
    """An n-d array of ``torch.device`` entries with named axes.

    ``devices`` is the numpy object array, ``axis_names`` the axis names
    and ``shape`` the axis sizes by name, as in ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device array needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        kinds = {d.type for d in devices.flat}
        if len(kinds) > 1:
            raise ValueError(f"a mesh holds one device type, got "
                             f"{sorted(kinds)}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def entries(self, axis: str, at: Optional[dict] = None) -> list:
        """The devices along `axis`, at the index `at` gives by axis name
        on the other axes, else 0 (the replicas along those axes compute
        the same shard)."""
        index = [0] * self.devices.ndim
        for name, i in (at or {}).items():
            index[self.axis_index(name)] = i
        index[self.axis_index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def axis_index(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in mesh axes "
                             f"{self.axis_names}")
        return self.axis_names.index(axis)

    def __repr__(self):
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}"
                f"; {self.devices.flat[0]})")


def make_mesh(devices: Optional[Sequence] = None,
              axes: Sequence[str] = ("atoms",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over `devices` with named `axes`.

    With no explicit `shape`, all devices go to the first axis and the rest
    get size 1.  ``devices=None`` takes every CUDA device and raises when
    there is none: a CPU mesh is built only from CPU devices passed in.
    Entries may repeat a device (see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no CUDA device; pass the devices, e.g. "
                "make_mesh([torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in np.asarray(devices, object).ravel()]
    n = len(devices)
    axes = tuple(axes)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"Mesh shape {tuple(shape)} != device count {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), axes)


@dataclass(frozen=True, eq=False)
class AtomSharding:
    """The leading (atom) axis of an array placed on one mesh axis: what
    ``sharding=`` takes (``jax.sharding.NamedSharding(mesh,
    PartitionSpec(axis))``)."""

    mesh: Mesh
    axis: str = "atoms"


def atom_sharding(mesh: Mesh, axis: str = "atoms") -> AtomSharding:
    """Sharding placing the leading (atom) array axis on `axis`."""
    mesh.axis_index(axis)
    return AtomSharding(mesh, axis)


def per_atom(x):
    """A per-atom input as a tensor: a tensor as it is, a host array as a
    CPU tensor of the working precision."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=config.real_dtype())


def _to(x, device):
    """`x` with every tensor in it (tuples and lists too) on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    return x


def _gather(outs, dim, device):
    """The shards' outputs (one structure per shard) concatenated along
    `dim` on `device`, structure by structure (tuples, lists, dicts)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs], dim=dim)
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], dim, device) for k in first}
    return type(first)(_gather(list(group), dim, device)
                       for group in zip(*outs))


def on_entry(device):
    """The context that makes `device` the current CUDA device, so that
    the working device ("cuda") of anything a shard allocates is its
    entry; nothing for a CPU entry."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_map(fn, mesh: Mesh, sharded, *, axis: str = "atoms",
              replicated=(), out_dim: Optional[int] = 0, index=False):
    """``jax.shard_map`` over the atom axis `axis` of `mesh`.

    `sharded` is a sequence of ``(x, dim)`` pairs: each per-atom input is
    split along its atom dim `dim` into ``mesh.shape[axis]`` equal shards
    (None passes through; a host array becomes a tensor of the working
    precision).  The axis size must divide the atom count: a
    ``ValueError`` otherwise, as in ``jax.shard_map``; nothing is padded.
    Shard i and every tensor in `replicated` go to entry i (index 0 along
    the mesh's other axes), where ``fn(*shards, *replicated)`` runs
    (``fn(i, *shards, *replicated)`` with ``index``, JAX's
    ``axis_index``).  With ``out_dim`` an int, every output tensor is
    concatenated along it on the mesh's first device; with None the list
    of the shards' outputs is returned, each on its entry."""
    entries = mesh.entries(axis)
    n = len(entries)
    inputs = [(None if x is None else per_atom(x), dim) for x, dim in sharded]
    sizes = {x.shape[dim] for x, dim in inputs if x is not None}
    if len(sizes) != 1:
        raise ValueError(f"the per-atom inputs disagree on the atom count: "
                         f"{sorted(sizes)}")
    natoms = sizes.pop()
    if natoms % n:
        raise ValueError(f"the mesh axis {axis!r} of size {n} does not "
                         f"divide the atom count {natoms}")
    nloc = natoms // n
    outs = []
    for i, dev in enumerate(entries):
        shards = [None if x is None else
                  x.narrow(dim, i * nloc, nloc).to(dev).contiguous()
                  for x, dim in inputs]
        with on_entry(dev):
            outs.append(fn(*((i,) if index else ()), *shards,
                           *_to(tuple(replicated), dev)))
    if out_dim is None:
        return outs
    return _gather(outs, out_dim, mesh.devices.flat[0])


def pmean(values, mesh: Mesh):
    """The mean of the shards' values (``jax.lax.pmean``) on the mesh's
    first device."""
    first = mesh.devices.flat[0]
    return torch.mean(torch.stack([v.to(first) for v in values]), dim=0)
