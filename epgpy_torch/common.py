"""Shape utilities: append-style broadcasting; the operator-identity memo.

Counterpart of ``epgpy_tpu/common.py``.  Parameter arrays broadcast
**left-aligned** ("append" style, reference epgpy/common.py:273-334): new
axes go *after* existing ones, the opposite of NumPy's prepend rule.  An
operator with batch shape (100,) composes with one of batch shape
(100, 50) by implicit trailing expansion.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config

__all__ = ["get_shape", "expand_shapes", "broadcastable", "broadcast_shapes",
           "expand_arrays", "to_real", "memoize_on_ops", "shape_with_axes",
           "set_axes", "expand_dims_after", "extend_operators", "repr_value",
           "repr_operator", "asnumpy"]


def get_shape(obj) -> tuple:
    """Shape of an array, tensor, nested sequence or scalar (scalars -> ())."""
    if obj is None:
        return ()
    if hasattr(obj, "shape"):
        return tuple(obj.shape)
    if isinstance(obj, (list, tuple)):
        if len(obj) == 0:
            return (0,)
        return (len(obj),) + get_shape(obj[0])
    return ()


def expand_shapes(*shapes):
    """Pad shapes to a common rank on the right (append rule)."""
    ndim = max((len(s) for s in shapes), default=0)
    return [tuple(s) + (1,) * (ndim - len(s)) for s in shapes]


def broadcastable(*shapes) -> bool:
    """Whether shapes broadcast together under the append rule."""
    padded = expand_shapes(*shapes)
    return all(len({d for d in dims if d != 1}) <= 1 for dims in zip(*padded))


def broadcast_shapes(*shapes) -> tuple:
    """Broadcast shapes together, left-aligned (append rule)."""
    padded = expand_shapes(*shapes)
    out = []
    for dims in zip(*padded):
        nontrivial = {d for d in dims if d != 1}
        if len(nontrivial) > 1:
            raise ValueError(f"Incompatible shapes: {shapes}")
        out.append(nontrivial.pop() if nontrivial else 1)
    return tuple(out)


def expand_arrays(*objs):
    """Expand arrays/tensors to a common rank by appending trailing
    singleton axes (None and scalars pass through); nested sequences
    become numpy arrays first."""
    objs = [np.asarray(o) if isinstance(o, (list, tuple)) else o
            for o in objs]
    shapes = [get_shape(o) for o in objs]
    if not broadcastable(*shapes):
        raise ValueError(f"Shapes cannot be broadcast: {shapes}")
    ndim = max((len(s) for s in shapes), default=0)
    out = []
    for obj, shape in zip(objs, shapes):
        if obj is None or not shape:
            out.append(obj)
        else:
            out.append(obj.reshape(tuple(shape) + (1,) * (ndim - len(shape))))
    return tuple(out)


def expand_dims_after(arr, ndim: int):
    """Append trailing singleton axes until `arr.ndim == ndim` (a host
    value becomes a tensor on the working device and dtype)."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.asarray(arr), device=config.device())
    if arr.ndim >= ndim:
        return arr
    return arr.reshape(tuple(arr.shape) + (1,) * (ndim - arr.ndim))


def extend_operators(core_ndim: int, *arrs):
    """Align operator arrays' batch axes (left-aligned), keeping core axes:
    each array's batch part is ``shape[:-core_ndim]``, and singleton axes
    go between batch and core so all arrays share one rank (reference
    epgpy/common.py:354-364)."""
    ranks = [a.ndim - core_ndim for a in arrs if a is not None]
    nbatch = max(ranks, default=0)
    out = []
    for arr in arrs:
        if arr is None:
            out.append(None)
            continue
        b = arr.ndim - core_ndim
        shape = tuple(arr.shape)
        out.append(arr.reshape(shape[:b] + (1,) * (nbatch - b) + shape[b:]))
    return tuple(out)


def repr_value(value, fmt="") -> str:
    """A scalar formatted with `fmt`; an array as ``array(shape)``."""
    shape = get_shape(value)
    if not shape:
        try:
            return format(value.item() if hasattr(value, "item") else value,
                          fmt)
        except (TypeError, ValueError):
            return str(value)
    return "array" + str(tuple(shape))


def repr_operator(name, argnames=(), argvalues=(), formats=()) -> str:
    """``name(v1, v2, ...)`` of the values that are not None."""
    formats = list(formats) + [""] * (len(argnames) - len(formats))
    args = ", ".join(
        repr_value(v, f) for v, f in zip(argvalues, formats) if v is not None)
    return f"{name}({args})"


def asnumpy(obj):
    """Copy a tensor (on any device) or array to host numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def shape_with_axes(shape: tuple, axes) -> tuple:
    """Operator batch shape after ``axes=`` pinning (see :func:`set_axes`;
    JAX ``common.shape_with_axes``)."""
    if axes is None:
        return shape
    nbatch = len(shape)
    if isinstance(axes, int):
        axes = tuple(range(axes, axes + nbatch))
    if len(axes) != nbatch:
        # as set_axes validates: a zip-truncated shape would disagree with
        # what apply() accepts
        raise ValueError(f"Invalid axes {axes} for {nbatch} batch dim(s)")
    out = [1] * (max(axes) + 1)
    for pos, dim in zip(axes, shape):
        out[pos] = dim
    return tuple(out)


def set_axes(core_ndim: int, arr, axes):
    """Pin an operator's parameter axes to user-chosen batch positions
    (the reference's ``axes=`` keyword, epgpy/common.py:337-347): the
    tensor's batch axes (all but the trailing `core_ndim`) move to
    positions `axes` by inserting singleton axes before them."""
    nbatch = arr.ndim - core_ndim
    if isinstance(axes, int):
        axes = tuple(range(axes, axes + nbatch))
    axes = tuple(axes)
    if len(axes) != nbatch or any(not isinstance(ax, int) for ax in axes):
        raise ValueError(f"Invalid axes {axes} for {nbatch} batch dims")
    for dim in sorted(i for i in range(max(axes)) if i not in axes):
        arr = arr.unsqueeze(dim)
    return arr


def as_real(value):
    """Parameter coercion shared by the physics ops: None, tensors and
    float numpy arrays stay as given (host parameters are what the kernel
    dispatch reads); python numbers and sequences become float host
    values."""
    if value is None or isinstance(value, torch.Tensor):
        return value
    if isinstance(value, (np.ndarray, np.floating)) and np.issubdtype(
            value.dtype, np.floating):
        return value
    if isinstance(value, (int, float, np.integer)):
        return float(value)
    return np.asarray(value, dtype=float)


def to_real(x):
    """Host value or tensor -> real tensor on the working device/dtype."""
    return torch.as_tensor(x, dtype=config.real_dtype(),
                           device=config.device())


def memoize_on_ops(cache, maxsize, key, sequence, compute):
    """``cache[key]``'s value, else ``compute()`` stored under `key`: the
    memo of per-sequence host work (the engine's preamble, the dispatch's
    matchers), whose keys hold the ids of `sequence`'s operators.  Each
    entry pins the operator list so the ids cannot be reused while it is
    cached; at `maxsize` entries the oldest is evicted first."""
    hit = cache.get(key)
    if hit is not None:
        return hit[0]
    result = compute()
    while len(cache) >= maxsize:
        cache.pop(next(iter(cache)))
    cache[key] = (result, list(sequence))
    return result


#: small constant tensors (per-axis scales, a shift vector) by value,
#: device and dtype; filled only outside a CUDA graph capture, whose eager
#: warm-up pass meets every constant the captured pass will ask for
_CONSTS: dict = {}


def const_tensor(values, dtype, device):
    """A 1-D tensor of the host numbers `values` on `device`, memoized: a
    host-to-device copy must not happen inside a CUDA graph capture."""
    key = (tuple(float(v) for v in values), dtype, str(device))
    hit = _CONSTS.get(key)
    if hit is not None:
        return hit
    out = torch.tensor(list(key[0]), dtype=dtype, device=device)
    if not (out.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        _CONSTS[key] = out
    return out
