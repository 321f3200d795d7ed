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
Batch axes broadcast with the append rule (see common.py).  ``kvalue``
(rad/m per ladder index, default 1) scales the index into the physical
wavenumbers ``k`` that the diffusion operator reads.  ``tvalue``,
``system`` (named properties written by the ``System`` operator) and
``options`` (the remaining ``simulate()`` options, as in the JAX package)
ride along unchanged by the operators.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import common, config

__all__ = ["StateMatrix"]


class StateMatrix:
    """Phase-state matrix with static ladder capacity."""

    __slots__ = ("states", "equilibrium", "kvalue", "tvalue", "system",
                 "options")

    def __init__(self, init=None, *, density=1.0, equilibrium=None,
                 kvalue=1.0, tvalue=1.0, nstate: Optional[int] = None,
                 shape: Optional[tuple] = None, check: bool = True,
                 system: Optional[dict] = None, **options):
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
        self.kvalue = kvalue if isinstance(kvalue, torch.Tensor) \
            else float(kvalue)
        self.tvalue = tvalue
        self.system = dict(system) if system else {}
        self.options = dict(options)

    @classmethod
    def _from_tensors(cls, states, equilibrium, kvalue=1.0, tvalue=1.0,
                      system=None, options=None):
        sm = object.__new__(cls)
        sm.states = states
        sm.equilibrium = equilibrium
        sm.kvalue = kvalue
        sm.tvalue = tvalue
        sm.system = {} if system is None else system
        sm.options = {} if options is None else options
        return sm

    def update(self, *, states=None, equilibrium=None, **fields
               ) -> "StateMatrix":
        """Functional update of the states, the equilibrium, ``kvalue``,
        ``tvalue``, ``system`` or ``options``."""
        unknown = set(fields) - {"kvalue", "tvalue", "system", "options"}
        if unknown:
            raise TypeError(f"Unknown StateMatrix field(s): {sorted(unknown)}")
        return StateMatrix._from_tensors(
            self.states if states is None else states,
            self.equilibrium if equilibrium is None else equilibrium,
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
    def F(self):
        """Transverse states F+ ladder, (*batch, K)."""
        return self.states[..., 0]

    @property
    def Z(self):
        return self.states[..., 2]

    @property
    def F0(self):
        """Echo amplitude: F+ at k=0, (*batch)."""
        return self.states[..., self.nstate, 0]

    @property
    def Z0(self):
        return self.states[..., self.nstate, 2]

    @property
    def F0t(self):
        """F0 per accumulated time: F0 on the 1-D ladder (no time axis)."""
        return self.F0

    @property
    def kdim(self) -> int:
        """Gradient axes of the ladder: 1 (no coordinate tables)."""
        return 1

    @property
    def coords(self):
        """Explicit k-coordinates: none on the 1-D integer ladder."""
        return None

    @property
    def t(self):
        """Accumulated dephasing time: 0 without a time coordinate."""
        return torch.zeros((), dtype=self.states.real.dtype,
                           device=self.states.device)

    t0 = t

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

    @property
    def k(self):
        """Physical wavenumbers (rad/m) of the ladder rows, (K, 1):
        ``arange(-n, n + 1) * kvalue`` (one dimension)."""
        n = self.nstate
        idx = torch.arange(-n, n + 1, dtype=self.states.real.dtype,
                           device=self.states.device)
        return (idx * self.kvalue)[:, None]

    # -- shape manipulation --

    def expand(self, ndim: int) -> "StateMatrix":
        """Append trailing batch axes until the batch rank is `ndim`."""

        def ex(arr):
            nb = arr.ndim - 2
            d = ndim - nb
            if d <= 0:
                return arr
            return arr.reshape(arr.shape[:nb] + (1,) * d + arr.shape[nb:])

        if ndim <= self.ndim:
            return self
        return self.update(states=ex(self.states),
                           equilibrium=ex(self.equilibrium))

    def broadcast(self, shape: tuple) -> "StateMatrix":
        """Broadcast batch axes to `shape` (append rule), materializing."""
        sm = self.expand(len(shape))
        target = common.broadcast_shapes(sm.shape, tuple(shape))
        return sm.update(states=sm.states.expand(
            target + sm.states.shape[-2:]).clone())

    def resize(self, nstate: int) -> "StateMatrix":
        """Pad/crop the ladder symmetrically to half-size `nstate`."""
        K = 2 * int(nstate) + 1
        return self.update(states=_pad_ladder(self.states, K),
                           equilibrium=_pad_ladder(self.equilibrium, K))

    def stack(self, others, *, axis: int = 0) -> "StateMatrix":
        """Stack state matrices along a new batch axis."""
        sms = [self] + list(others)
        states = torch.stack([s.states for s in sms], dim=axis)
        eqs = torch.stack([torch.broadcast_to(s.equilibrium, s.states.shape)
                           for s in sms], dim=axis)
        return self.update(states=states, equilibrium=eqs)

    def unstack(self, *, axis: int = 0):
        """Split along a batch axis into a list of state matrices."""
        eq = torch.broadcast_to(self.equilibrium, self.states.shape)
        return [self.update(states=s, equilibrium=e)
                for s, e in zip(self.states.unbind(axis), eq.unbind(axis))]

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
