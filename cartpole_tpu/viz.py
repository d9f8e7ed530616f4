"""Offline cart-pole rendering — the canvas renderer/plotter analog.

The reference's browser UI draws the cart, pole, wheels, floor, ghost carts
for the MPC's predicted states (every 10th sample, alpha-faded) and a force
arrow (``/root/reference/viz/src/renderer.ts:7-354``), next to live strip
charts (``plotter.ts``). A batch job has no browser, so this module
renders the same picture offline with matplotlib: single frames, closed-loop
animations (GIF/MP4), and strip-chart figures — fed by the same
``ClosedLoopResult`` / ``MPCOutputs`` PyTrees the rest of the stack uses.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np

__all__ = ["draw_frame", "animate_closed_loop", "strip_charts"]

_CART_W, _CART_H = 0.2, 0.1
_WHEEL_R = 0.025
_GHOST_STRIDE = 10  # renderer.ts:88-101 draws every 10th predicted state.


def _mass_locations(state: np.ndarray, lengths: Sequence[float]):
    """Forward kinematics: base + per-link tip positions
    (``viz/src/utils.ts:30-47`` analog, any number of links)."""
    n_links = len(lengths)
    base = np.array([state[0], 0.0])
    pts = [base]
    for i in range(n_links):
        th = state[1 + i]
        pts.append(pts[-1] + lengths[i] * np.array([math.cos(th), math.sin(th)]))
    return pts


def _draw_cartpole(ax, state, lengths, alpha=1.0, color="tab:blue"):
    pts = _mass_locations(np.asarray(state), lengths)
    base = pts[0]
    # Cart body + wheels + pivot.
    from matplotlib.patches import Circle, Rectangle

    ax.add_patch(
        Rectangle(
            (base[0] - _CART_W / 2, _WHEEL_R),
            _CART_W,
            _CART_H,
            alpha=alpha,
            color=color,
            zorder=2,
        )
    )
    for dx in (-_CART_W / 3, _CART_W / 3):
        ax.add_patch(
            Circle((base[0] + dx, _WHEEL_R), _WHEEL_R, alpha=alpha,
                   color="dimgray", zorder=2)
        )
    pivot_y = _WHEEL_R + _CART_H
    prev = np.array([base[0], pivot_y])
    for tip in pts[1:]:
        tip_draw = tip + np.array([0.0, pivot_y])
        ax.plot(
            [prev[0], tip_draw[0]], [prev[1], tip_draw[1]],
            lw=2.5, alpha=alpha, color=color, zorder=3,
        )
        ax.add_patch(
            Circle(tip_draw, 0.02, alpha=alpha, color="tab:red", zorder=4)
        )
        prev = tip_draw


def draw_frame(
    state,
    predicted_states=None,
    lengths: Sequence[float] = (0.25,),
    force: Optional[float] = None,
    x_limits=(-1.2, 1.2),
    ax=None,
    save_to: Optional[str] = None,
):
    """Draw one scene: plant state, optional ghost predictions and force
    arrow (``renderer.ts`` drawSingle analog)."""
    import matplotlib

    if save_to:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(8, 4))
    else:
        fig = ax.figure

    # Floor.
    ax.axhline(0.0, color="k", lw=1.0, zorder=1)

    if predicted_states is not None:
        ghosts = np.asarray(predicted_states)[_GHOST_STRIDE - 1 :: _GHOST_STRIDE]
        for i, g in enumerate(ghosts):
            fade = 0.35 * (1.0 - i / max(len(ghosts), 1))
            _draw_cartpole(ax, g, lengths, alpha=max(fade, 0.06),
                           color="tab:gray")

    _draw_cartpole(ax, state, lengths, alpha=1.0)

    if force:
        base_x = float(np.asarray(state)[0])
        ax.annotate(
            "",
            xy=(base_x + 0.002 * force, _WHEEL_R + _CART_H / 2),
            xytext=(base_x, _WHEEL_R + _CART_H / 2),
            arrowprops=dict(arrowstyle="-|>", color="tab:orange", lw=2),
            zorder=5,
        )

    total_len = sum(lengths)
    ax.set_xlim(*x_limits)
    # The pole pivots at the cart top; a hanging pole (the canonical
    # swing-up start state) reaches pivot - total_len, so the lower limit
    # must track the link length or the pole is clipped out of frame.
    pivot_y = _WHEEL_R + _CART_H
    ax.set_ylim(
        min(-0.1, pivot_y - total_len - 0.1), pivot_y + total_len + 0.15
    )
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])

    if save_to and own_fig:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def animate_closed_loop(
    result: Any,
    lengths: Sequence[float] = (0.25,),
    control_dt: float = 0.01,
    stride: int = 2,
    save_to: str = "closed_loop.gif",
    predicted_states=None,
):
    """Render a ``ClosedLoopResult`` as an animation (GIF via pillow).

    ``predicted_states`` (optional, ``(T, N, state_dim)``): per-tick MPC
    predictions drawn as alpha-faded ghost carts every 10th sample — the
    live-renderer behavior (``renderer.ts:88-101``), e.g. from a replayed
    solve log (``utils/replay.py``).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    states = np.asarray(result.states)[::stride]
    controls = np.asarray(result.controls)[::stride]
    preds = (
        np.asarray(predicted_states)[::stride]
        if predicted_states is not None
        else None
    )

    fig, ax = plt.subplots(figsize=(8, 4))

    def render(i):
        ax.clear()
        ax.axhline(0.0, color="k", lw=1.0)
        if preds is not None:
            ghosts = preds[i][_GHOST_STRIDE - 1 :: _GHOST_STRIDE]
            for k, g in enumerate(ghosts):
                fade = 0.35 * (1.0 - k / max(len(ghosts), 1))
                _draw_cartpole(ax, g, lengths, alpha=max(fade, 0.06),
                               color="tab:gray")
        _draw_cartpole(ax, states[i], lengths)
        ax.set_title(
            f"t = {i * stride * control_dt:.2f} s   u = {controls[i]:+7.1f} N"
        )
        total_len = sum(lengths)
        span = max(1.2, np.abs(states[:, 0]).max() + total_len + 0.2)
        pivot_y = _WHEEL_R + _CART_H
        ax.set_xlim(-span, span)
        ax.set_ylim(
            min(-0.15, pivot_y - total_len - 0.1),
            pivot_y + total_len + 0.15,
        )
        ax.set_aspect("equal")
        return []

    anim = animation.FuncAnimation(
        fig, render, frames=len(states), interval=control_dt * stride * 1000
    )
    anim.save(save_to, writer="pillow",
              fps=max(int(1.0 / (control_dt * stride)), 1))
    plt.close(fig)
    return save_to


def strip_charts(result: Any, control_dt: float = 0.01,
                 save_to: Optional[str] = None):
    """The web UI's three live strip charts (u, pole angle in degrees, cart
    velocity — ``application.ts:504-527``) as one static figure."""
    import matplotlib

    if save_to:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    states = np.asarray(result.states)
    u = np.asarray(result.controls)
    t = np.arange(states.shape[0]) * control_dt
    n_q = states.shape[1] // 2

    fig, (ax0, ax1, ax2) = plt.subplots(nrows=3, sharex=True, figsize=(10, 7))
    ax0.plot(t, u)
    ax0.set_ylabel("u [N]")
    for a in range(1, n_q):
        ax1.plot(t, np.degrees(states[:, a]), label=f"th_{a}")
    ax1.axhline(90.0, color="k", ls=":", lw=0.8)
    ax1.set_ylabel("angle [deg]")
    if n_q > 2:
        ax1.legend()
    ax2.plot(t, states[:, n_q])
    ax2.set_ylabel("cart vel [m/s]")
    ax2.set_xlabel("t [s]")
    for ax in (ax0, ax1, ax2):
        ax.grid(alpha=0.4)

    if save_to:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
