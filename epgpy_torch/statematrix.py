"""Fixed-capacity EPG state matrix.

Counterpart of ``epgpy_tpu/statematrix.py``.  The ladder capacity
``K = 2*nstate + 1`` is fixed at construction (chosen by the simulation
engine from the sequence's shift count or ``max_nstate``); rows pushed
past the edge are dropped, the reference's ``nmax`` truncation.

Storage is ONE complex tensor ``states`` of shape ``(*batch, K, 3)`` with
components ``(F+, F-, Z)`` per k-state and k=0 at row ``nstate``, plus the
``equilibrium`` ladder of the same layout.  PyTorch has native complex
dtypes on every device, so there is no re/im split.  Objects are treated
as immutable: operators return updated copies via :meth:`update`.
Batch axes broadcast with the append rule (see common.py).

``coords`` is the explicit coordinate table of float and n-D shifts
(``ops/shiftnd.py``; Gao 2021's spatially resolved phase graph): ``None``
on the 1-D integer ladder, else a ``(*batch, K, kdim)`` tensor (batch axes
of size 1 when shared; int64, or float64 at either precision) whose row i
holds the wavenumber of ladder row i
in units of ``kvalue`` (up to three gradient axes) and, as a fourth
column, the accumulated dephasing time in units of ``tvalue`` (the ``C``
operator).  Table rows sit in no particular order except the k = 0 row,
which stays at row ``nstate``.  ``kvalue`` (rad/m per unit, a scalar or
one per axis) and ``tvalue`` scale them into the physical ``k`` and ``t``
that the diffusion operator and the imaging probes read.  ``system``
(named properties written by the ``System`` operator) and ``options``
(the remaining ``simulate()`` options, as in the JAX package) ride along
unchanged by the operators.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import common, config

__all__ = ["StateMatrix", "COORD_DTYPE"]

#: the float dtype of a coordinate table at either working precision: the
#: merges quantize mean wavenumbers into grid cells, and float32 means
#: would cross a cell boundary where float64 ones do not
COORD_DTYPE = torch.float64


class StateMatrix:
    """Phase-state matrix with static ladder capacity."""

    __slots__ = ("states", "equilibrium", "coords", "kvalue", "tvalue",
                 "system", "options")

    def __init__(self, init=None, *, density=1.0, equilibrium=None,
                 coords=None, kvalue=1.0, tvalue=1.0,
                 nstate: Optional[int] = None, shape: Optional[tuple] = None,
                 check: bool = True, system: Optional[dict] = None,
                 **options):
        sym_verified = bool(check and not isinstance(init, torch.Tensor)
                            and not isinstance(equilibrium, torch.Tensor))
        if equilibrium is None:
            dens = np.atleast_1d(np.asarray(density, dtype=np.complex128))
            equilibrium = dens.reshape(dens.shape + (1, 1)) * np.asarray(
                [[0, 0, 1]])
        equilibrium = _format_states(equilibrium, check=check)
        states = (equilibrium if init is None
                  else _format_states(init, check=check))
        K = max(states.shape[-2], equilibrium.shape[-2])
        if nstate is not None:
            K = max(K, 2 * int(nstate) + 1)
        states = _pad_ladder(states, K)
        if shape:
            bshape = common.broadcast_shapes(tuple(states.shape[:-2]),
                                             tuple(shape))
            nb = states.ndim - 2
            states = states.reshape(states.shape[:nb]
                                    + (1,) * (len(bshape) - nb)
                                    + states.shape[nb:])
            states = states.expand(bshape + states.shape[-2:]).clone()
        self.states = states
        self.equilibrium = _pad_ladder(equilibrium, K)
        self.coords = None if coords is None else _coords_tensor(coords)
        if np.ndim(kvalue) and not isinstance(kvalue, torch.Tensor):
            kvalue = np.asarray(kvalue, dtype=float)
        self.kvalue = kvalue if isinstance(kvalue, (torch.Tensor,
                                                    np.ndarray)) \
            else float(kvalue)
        self.tvalue = tvalue
        self.system = dict(system) if system else {}
        self.options = dict(options)
        # the dense table engines (ops/shiftdense.py) need the ladder
        # symmetry from step 0: only host ladders checked here count
        self.options["_sym_verified"] = sym_verified

    @classmethod
    def _from_tensors(cls, states, equilibrium, coords=None, kvalue=1.0,
                      tvalue=1.0, system=None, options=None):
        sm = object.__new__(cls)
        sm.states = states
        sm.equilibrium = equilibrium
        sm.coords = coords
        sm.kvalue = kvalue
        sm.tvalue = tvalue
        sm.system = {} if system is None else system
        sm.options = {} if options is None else options
        return sm

    def update(self, *, states=None, equilibrium=None, **fields
               ) -> "StateMatrix":
        """Functional update of the states, the equilibrium, ``coords``
        (``coords=None`` drops the table), ``kvalue``, ``tvalue``,
        ``system`` or ``options``."""
        unknown = set(fields) - {"coords", "kvalue", "tvalue", "system",
                                 "options"}
        if unknown:
            raise TypeError(f"Unknown StateMatrix field(s): {sorted(unknown)}")
        return StateMatrix._from_tensors(
            self.states if states is None else states,
            self.equilibrium if equilibrium is None else equilibrium,
            fields.get("coords", self.coords),
            fields.get("kvalue", self.kvalue),
            fields.get("tvalue", self.tvalue),
            fields.get("system", self.system),
            fields.get("options", self.options))

    copy = update

    # -- structural properties --

    @property
    def shape(self) -> tuple:
        """Batch shape (parameter-sweep axes)."""
        return tuple(self.states.shape[:-2])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nstate(self) -> int:
        """Ladder half-size: K == 2*nstate + 1."""
        return (self.states.shape[-2] - 1) // 2

    # -- physics views --

    @property
    def kdim(self) -> int:
        """Gradient axes of the ladder (4: three and the time axis)."""
        return 1 if self.coords is None else self.coords.shape[-1]

    @property
    def F(self):
        """Transverse states F+ ladder, (*batch, K)."""
        return self.states[..., 0]

    @property
    def Z(self):
        return self.states[..., 2]

    @property
    def i0(self):
        """The k = 0 row's index, or (kdim 4) the mask of the rows whose
        three wavenumbers are 0."""
        if self.kdim < 4:
            return self.nstate
        return torch.all(self.coords[..., :3].abs() < 1e-12, dim=-1)

    @property
    def F0(self):
        """Echo amplitude: F+ at k=0, (*batch); with a time axis, the
        T2'-weighted sum over the k = 0 rows' accumulated times."""
        if self.kdim < 4:
            return self.states[..., self.nstate, 0]
        evol = torch.exp(-self.t.abs())
        return torch.sum(self.states[..., 0] * self.i0 * evol, dim=-1)

    @property
    def F0t(self):
        """F0 per accumulated time (kdim 4), else F0."""
        if self.kdim < 4:
            return self.F0
        return self.states[..., 0] * self.i0

    @property
    def Z0(self):
        if self.kdim < 4:
            return self.states[..., self.nstate, 2]
        return self.states[..., 2] * self.i0

    @property
    def k(self):
        """Physical wavenumbers (rad/m): ``coords[..., :3] * kvalue``,
        (*1, K, <=3); the integer ladder's row index on a 1-D ladder."""
        coords = self.coords
        rdt = self.states.real.dtype
        if coords is None:
            n = self.nstate
            coords = torch.arange(-n, n + 1, dtype=rdt,
                                  device=self.states.device)[:, None]
            coords = coords.reshape((1,) * self.ndim + tuple(coords.shape))
        coords = coords[..., :3]
        if not coords.is_floating_point():
            coords = coords.to(rdt)
        kvalue = self.kvalue
        if isinstance(kvalue, torch.Tensor):
            kvalue = kvalue.reshape(-1)[:coords.shape[-1]] \
                if kvalue.ndim else kvalue
        elif common.get_shape(kvalue):
            kvalue = common.const_tensor(
                np.ravel(kvalue)[:coords.shape[-1]], coords.dtype,
                coords.device)
        return (coords * kvalue).to(rdt)

    @property
    def t(self):
        """Accumulated dephasing time (the fourth coordinate), 0 without."""
        if self.kdim < 4:
            return torch.zeros((), dtype=self.states.real.dtype,
                               device=self.states.device)
        return (self.coords[..., 3] * self.tvalue).to(self.states.real.dtype)

    @property
    def t0(self):
        """The accumulated time of the k = 0 rows (0 without a time axis)."""
        if self.kdim < 4:
            return self.t
        return self.t * self.i0

    @property
    def ktvalue(self):
        """Scale of each coordinate: [kvalue (up to 3 axes), tvalue (the
        time axis)], a float64 tensor of length ``kdim`` (memoized for host
        values: no copy to the device inside a CUDA graph capture)."""
        kdim = self.kdim
        kvalue, tvalue = self.kvalue, self.tvalue
        dev = self.states.device
        if isinstance(kvalue, torch.Tensor) or isinstance(tvalue,
                                                           torch.Tensor):
            kv = torch.as_tensor(kvalue, dtype=COORD_DTYPE,
                                 device=dev).reshape(-1)
            kv = (kv.expand(min(kdim, 3)) if kv.numel() == 1
                  else kv[:3])
            if kdim == 4:
                kv = torch.cat([kv, torch.as_tensor(
                    tvalue, dtype=COORD_DTYPE, device=dev).reshape(1)])
            return kv
        if common.get_shape(kvalue):
            coeff = list(np.asarray(kvalue, dtype=float).ravel())[:3]
        else:
            coeff = [float(kvalue)] * min(kdim, 3)
        coeff += [float(tvalue)] * (kdim == 4)
        return common.const_tensor(coeff, COORD_DTYPE, dev)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def norm(self):
        """State-matrix norm over the (F-, Z) components, (*batch)
        (reference utils.py:152)."""
        return torch.sqrt(torch.sum(self.states[..., 1:].abs() ** 2,
                                    dim=(-2, -1)))

    @property
    def density(self):
        """Equilibrium densities: the real Z(0) of the equilibrium,
        (*batch) (the per-compartment weights of EPG-X trains)."""
        return self.equilibrium[..., self.nstate, 2].real

    # -- shape manipulation --

    def expand(self, ndim: int) -> "StateMatrix":
        """Append trailing batch axes until the batch rank is `ndim` (each
        ladder and the coords table padded on its own: a table may already
        carry more batch axes than the states)."""

        def ex(arr):
            if arr is None:
                return None
            nb = arr.ndim - 2
            d = ndim - nb
            if d <= 0:
                return arr
            return arr.reshape(arr.shape[:nb] + (1,) * d + arr.shape[nb:])

        if ndim <= self.ndim:
            return self
        return self.update(states=ex(self.states),
                           equilibrium=ex(self.equilibrium),
                           coords=ex(self.coords))

    def broadcast(self, shape: tuple) -> "StateMatrix":
        """Broadcast batch axes to `shape` (append rule), materializing."""
        sm = self.expand(len(shape))
        target = common.broadcast_shapes(sm.shape, tuple(shape))
        return sm.update(states=sm.states.expand(
            target + sm.states.shape[-2:]).clone())

    def resize(self, nstate: int) -> "StateMatrix":
        """Pad/crop the ladder (and the coords table) symmetrically to
        half-size `nstate`."""
        K = 2 * int(nstate) + 1
        return self.update(
            states=_pad_ladder(self.states, K),
            equilibrium=_pad_ladder(self.equilibrium, K),
            coords=None if self.coords is None
            else _pad_ladder(self.coords, K))

    def setup_coords(self, kdim: int) -> "StateMatrix":
        """Attach (or widen) the explicit coordinate table to `kdim` axes:
        a fresh table holds the ladder index on axis 0 and zeros on the
        others, shared over the batch."""
        if self.coords is not None:
            diff = kdim - self.kdim
            if diff < 0:
                raise RuntimeError("Cannot remove existing k-dimensions")
            if diff == 0:
                return self
            zeros = torch.zeros(self.coords.shape[:-1] + (diff,),
                                dtype=self.coords.dtype,
                                device=self.coords.device)
            return self.update(coords=torch.cat([self.coords, zeros],
                                                dim=-1))
        n = self.nstate
        coords = torch.zeros((2 * n + 1, kdim), dtype=COORD_DTYPE,
                             device=self.states.device)
        coords[:, 0] = torch.arange(-n, n + 1, dtype=coords.dtype,
                                    device=coords.device)
        return self.update(coords=coords.reshape((1,) * self.ndim
                                                 + tuple(coords.shape)))

    def stack(self, others, *, axis: int = 0) -> "StateMatrix":
        """Stack state matrices along a new batch axis."""
        sms = [self] + list(others)
        states = torch.stack([s.states for s in sms], dim=axis)
        eqs = torch.stack([torch.broadcast_to(s.equilibrium, s.states.shape)
                           for s in sms], dim=axis)
        coords = None if self.coords is None else torch.stack(
            [s.coords for s in sms], dim=axis)
        return self.update(states=states, equilibrium=eqs, coords=coords)

    def unstack(self, *, axis: int = 0):
        """Split along a batch axis into a list of state matrices."""
        eq = torch.broadcast_to(self.equilibrium, self.states.shape)
        coords = ([None] * self.states.shape[axis] if self.coords is None
                  else self.coords.unbind(axis))
        return [self.update(states=s, equilibrium=e, coords=c)
                for s, e, c in zip(self.states.unbind(axis),
                                   eq.unbind(axis), coords)]

    def check(self) -> bool:
        """Verify the conjugate ladder symmetry F-(k) == conj(F+(-k))."""
        s = self.states.detach().cpu().numpy()
        return bool(np.allclose(s, np.conj(s[..., ::-1, :][..., (1, 0, 2)])))

    def __repr__(self):
        return f"StateMatrix({self.shape}, nstate={self.nstate})"


def _pad_ladder(arr, K: int):
    """Pad or crop the (second-to-last) ladder axis symmetrically to K."""
    cur = arr.shape[-2]
    if cur == K:
        return arr
    if (K - cur) % 2:
        raise ValueError(f"Ladder sizes must share parity: {cur} -> {K}")
    diff = (K - cur) // 2
    if diff > 0:
        return torch.nn.functional.pad(arr, (0, 0, diff, diff))
    return arr[..., -diff:cur + diff, :]


def _coords_tensor(coords):
    """A user coordinate table on the working device: integer tables stay
    int64, others are float64 (``COORD_DTYPE``)."""
    if isinstance(coords, torch.Tensor):
        dtype = (torch.int64 if not coords.is_floating_point()
                 else COORD_DTYPE)
        return coords.to(device=config.device(), dtype=dtype)
    arr = np.asarray(coords)
    dtype = (torch.int64 if np.issubdtype(arr.dtype, np.integer)
             else COORD_DTYPE)
    return torch.as_tensor(arr, dtype=dtype, device=config.device())


def _format_states(states, check: bool = True):
    """Normalize an init spec to a (..., 2n+1, 3) complex tensor on the
    working device; host values are validated first (unless `check` is
    False)."""
    if isinstance(states, torch.Tensor):
        # device input: value checks would cost a device-to-host copy
        states = states.to(device=config.device(),
                           dtype=config.complex_dtype())
        if states.ndim == 1:
            states = states.reshape(1, 3)
        return states[None] if states.ndim == 2 else states
    states = np.asarray(states, dtype=np.complex128)
    if states.ndim == 1:
        if check and states.size != 3:
            raise ValueError("The number of state components must be 3")
        states = states.reshape((1, 3))
    if check:
        _check_format(states)
    if states.ndim == 2:
        states = states[None]
    return torch.tensor(states, dtype=config.complex_dtype(),
                        device=config.device())


def _check_format(states):
    """Raise unless a host (..., 2n+1, 3) ladder is conjugate-symmetric."""
    if states.shape[-1] != 3:
        raise ValueError("The number of state components must be 3")
    if states.shape[-2] % 2 != 1:
        raise ValueError("The number of states must be odd")
    if not np.allclose(states[..., 1], np.conj(states[..., ::-1, 0])):
        raise ValueError("The F-state columns do not match")
    if not np.allclose(states[..., 2], np.conj(states[..., ::-1, 2])):
        raise ValueError("The Z-state column is not symmetrical")
