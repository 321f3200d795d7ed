"""EPG sequence diagrams (RF / gradient lanes + k-state trajectory).

Counterpart of ``epgpy_tpu/utils/plotting.py``.  Host-side visualization
(matplotlib, imported when a function is called), semantics target:
reference epgpy/plotting.py plot_epg -- the diagram is produced by
simulating the sequence op by op through the port's eager engine (on the
working device; each drawn state is fetched to the host) and drawing each
state's k-path, with line alpha/width scaled by state magnitude.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import engine, statematrix
from ..ops import probe as probe_mod, shift as shift_mod, transition

__all__ = ["plot_epg", "show", "k_colors_1d", "k_colors_2d"]


def show():
    from matplotlib import pyplot as plt
    plt.show()


# -- k-coordinate color coding (n-D shift diagrams) --
# With kdim >= 2 each EPG line only draws one k axis; the remaining
# transverse coordinate(s) are encoded in the line color (semantics
# target: reference epgpy/plotting.py:231-295).


def k_colors_1d(v, vmax):
    """Colors for one off-axis k coordinate (plasma, symmetric range)."""
    from matplotlib import pyplot as plt
    v = np.asarray(v, float)
    if vmax:
        v = (np.clip(v, -vmax, vmax) / vmax + 1.0) / 2.0
    return plt.cm.plasma(v)


def k_colors_2d(x, y, xmax, ymax):
    """Color wheel for two off-axis k coordinates.

    Hue encodes the in-plane angle, saturation the radius (HSV wheel) --
    states at the k-plane origin render gray, distinct quadrants get
    distinct hues.
    """
    from matplotlib.colors import hsv_to_rgb
    x = np.clip(np.asarray(x, float) / (xmax or 1.0), -1, 1)
    y = np.clip(np.asarray(y, float) / (ymax or 1.0), -1, 1)
    hue = (np.arctan2(y, x) / (2 * np.pi)) % 1.0
    sat = np.clip(np.hypot(x, y), 0.0, 1.0)
    val = np.full_like(hue, 0.8)
    return hsv_to_rgb(np.stack([hue, sat, val], axis=-1))


def _add_k_colorbar(ax, axes_idx, kmaxes, n=31):
    """Inset legend mapping line colors back to off-axis k values."""
    if len(axes_idx) == 1:
        inset = ax.inset_axes([0.02, 0.72, 0.06, 0.25])
        ramp = np.linspace(-kmaxes[0], kmaxes[0], n)
        inset.imshow(k_colors_1d(ramp[:, None], kmaxes[0]), origin="lower",
                     aspect="auto", extent=(0, 1, -kmaxes[0], kmaxes[0]))
        inset.set_xticks([])
        inset.yaxis.tick_right()
        inset.set_title(f"k{axes_idx[0]}", fontsize=8)
    else:
        inset = ax.inset_axes([0.02, 0.72, 0.16, 0.25])
        gx, gy = np.meshgrid(np.linspace(-kmaxes[0], kmaxes[0], n),
                             np.linspace(-kmaxes[1], kmaxes[1], n))
        inset.imshow(k_colors_2d(gx, gy, kmaxes[0], kmaxes[1]),
                     origin="lower",
                     extent=(-kmaxes[0], kmaxes[0], -kmaxes[1], kmaxes[1]))
        inset.set_xlabel(f"k{axes_idx[0]}", fontsize=8)
        inset.set_ylabel(f"k{axes_idx[1]}", fontsize=8)
        inset.tick_params(labelsize=6)


def _host(x):
    """A tensor or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _get_shift(op, kvalue):
    """Physical shift vector of an S/G/C operator (first batch element)."""
    if isinstance(op.k, int):
        return np.asarray([op.k * kvalue])
    karr = np.atleast_2d(np.asarray(op.k, float)).reshape(-1, np.shape(op.k)[-1])
    return karr[0] * kvalue


def plot_epg(seq, *, kvalue=1, kgrid=None, yaxis=0, ops="S,T,E", title=None,
             figname=None, calpha=0.5, cwidth=0):
    """Plot RF/gradient timing lanes and the EPG k-state diagram.

    Returns the matplotlib figure.
    """
    from matplotlib import pyplot as plt
    import matplotlib.gridspec as gridspec

    seq = engine.flatten_sequence(seq)
    kdim = min(engine.getkdim(seq), 3)
    opnames = set(ops.split(","))

    nshift = engine.getnshift(seq)
    sm = statematrix.StateMatrix(nstate=max(nshift, 1), kgrid=kgrid)
    sm = engine._setup_table(sm, seq)

    fig = plt.figure(figname, figsize=(8, 6))
    gs = gridspec.GridSpec(3, 1, figure=fig, height_ratios=(1, kdim, 6))
    ax_rf = fig.add_subplot(gs[0, 0])
    gs_grad = gridspec.GridSpecFromSubplotSpec(kdim, 1, subplot_spec=gs[1, 0])
    ax_grad = [fig.add_subplot(gs_grad[i, 0]) for i in range(kdim)]
    ax_epg = fig.add_subplot(gs[2, 0])

    yax = int(np.arange(kdim)[yaxis])

    def index0(arr, nb):
        """The first batch element of a state tensor, on the host."""
        return _host(arr)[(0,) * nb]

    # off-axis k coordinates are encoded in line colors; their range is
    # bounded by the per-axis sum of |shift| over the sequence
    others = [i for i in range(kdim) if i != yax][:2]
    ksum = np.zeros(kdim)
    for op in seq:
        if isinstance(op, shift_mod.S):
            sv = _get_shift(op, kvalue)
            n = min(len(sv), kdim)
            ksum[:n] += np.abs(sv[:n])
    kmaxes = [max(float(ksum[i]), 1e-12) for i in others]

    def _line_color(krow):
        if not others:
            return "k"
        if len(others) == 1:
            return k_colors_1d(krow[others[0]], kmaxes[0])
        return k_colors_2d(krow[others[0]], krow[others[1]],
                           kmaxes[0], kmaxes[1])

    now = 0.0
    for op in seq:
        prev, now = now, now + float(np.max(_host(op.duration)))

        if isinstance(op, transition.T):
            # RF stem
            alpha = float(np.ravel(_host(op.alpha))[0])
            ax_rf.plot([prev, prev], [0, alpha], color="C3")
            ax_rf.plot(prev, alpha, "v" if alpha < 0 else "^", color="C3", ms=4)

        name = type(op).__name__
        if not (name in opnames or isinstance(op, probe_mod.Probe)):
            continue

        if isinstance(op, shift_mod.S):
            shiftvec = np.zeros(kdim)
            sv = _get_shift(op, kvalue)
            shiftvec[: min(len(sv), kdim)] = sv[:kdim]
            for i in range(kdim):
                ax_grad[i].fill_between([prev, now], [shiftvec[i]] * 2,
                                        color="gray", alpha=0.3)
            # EPG lines: each state's k moves by shiftvec over [prev, now]
            sm = op(sm)
            F = index0(sm.F, sm.F.ndim - 1)
            Z = index0(sm.Z, sm.Z.ndim - 1)
            ks = index0(sm.k, sm.k.ndim - 2)
            for i in range(ks.shape[0]):
                mag = min(float(np.abs(F[i])), 1.0)
                if mag >= 1e-6:
                    y0 = float(ks[i, yax] - shiftvec[yax])
                    y1 = float(ks[i, yax])
                    ax_epg.plot([prev, now], [y0, y1],
                                color=_line_color(ks[i]),
                                alpha=max(mag ** calpha, 0.05),
                                lw=1 + cwidth * mag)
                # stored longitudinal states: dotted horizontal lines (Z
                # does not shift) -- reference epgpy/plotting.py:133-142
                zmag = min(float(np.abs(Z[i])), 1.0)
                if zmag >= 1e-5:
                    y = float(ks[i, yax])
                    ax_epg.plot([prev, now], [y, y], ls=":",
                                color=_line_color(ks[i]),
                                alpha=max(zmag ** calpha, 0.05),
                                lw=1 + cwidth * zmag)
        elif isinstance(op, probe_mod.Probe):
            ax_epg.axvline(now, color="C0", ls=":", alpha=0.6)
        else:
            sm = op(sm)
            # horizontal segments (relaxation: k constant)
            F = index0(sm.F, sm.F.ndim - 1)
            ks = index0(sm.k, sm.k.ndim - 2)
            if now > prev:
                for i in range(ks.shape[0]):
                    mag = min(float(np.abs(F[i])), 1.0)
                    if mag < 1e-6:
                        continue
                    y = float(ks[i, yax])
                    ax_epg.plot([prev, now], [y, y], color=_line_color(ks[i]),
                                alpha=max(mag ** calpha, 0.05),
                                lw=1 + cwidth * mag)

    if others:
        _add_k_colorbar(ax_epg, others, kmaxes)
    ax_epg.axhline(0, color="C0", lw=0.5)
    ax_epg.set_xlabel("time (ms)")
    ax_epg.set_ylabel(f"k (axis {yax})")
    ax_rf.set_ylabel("RF (deg)")
    for i, ax in enumerate(ax_grad):
        ax.set_ylabel(f"G{'xyz'[i]}")
        ax.set_xticks([])
    ax_rf.set_xticks([])
    if title:
        fig.suptitle(title)
    return fig
