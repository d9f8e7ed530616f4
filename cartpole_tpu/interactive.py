"""Interactive closed-loop driver — the terminal analog of the web demo.

The reference's flagship artifact is a live browser loop: a human pokes the
plant with the mouse, adjusts dynamics/cost sliders (cost <-> equality
checkboxes rebuild the optimizer), toggles the controller (re-enabling
resets the warm start), and watches the MPC recover
(``/root/reference/viz/src/application.ts:208-373, 424-489``). This module
reproduces that capability for a terminal: an ANSI cart-pole renderer, a
fixed-timestep accumulator loop with the 0.2 s frame-gap watchdog
(``application.ts:384-391``), decaying poke forces (``mpc/poke.py``), live
dynamics-parameter updates (jit arguments — no recompile), optimizer
rebuild on cost/equality changes (``application.ts:367-373``), and the
ring-buffer JSON solve log (``application.ts:429-434``).

Run: ``python -m cartpole_tpu interactive`` (add ``--cpu`` to force the CPU;
``--model double`` drives the 6-state double pole).
Keys: b/B poke base left/right, p/P poke first link mass, o/O poke second
link mass (double pole), c toggle controller, 1/2 pole mass -/+,
3/4 pole length -/+, t toggle theta cost<->equality, r reset plant,
q quit.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .models.base import SINGLE_CARTPOLE
from .models.params import SingleCartPoleParams
from .mpc.config import OptimizationParams
from .mpc.controller import MPC
from .mpc.poke import decay_external_forces, poke_force
from .mpc.simulator import simulator_step
from .utils.logging import SolveLog

__all__ = ["InteractiveLoop", "render_ascii"]

FRAME_GAP_WATCHDOG = 0.2  # seconds (application.ts:384-391)


def _link_lengths(dynamics_params):
    lengths = [float(dynamics_params.l_1)]
    if hasattr(dynamics_params, "l_2"):
        lengths.append(float(dynamics_params.l_2))
    return lengths


def render_ascii(x, dynamics_params, width: int = 64, height: int = 14,
                 force=None, enabled: bool = True) -> str:
    """Draw the cart, the pole link chain (1 or 2 links), floor, and force
    arrow as ASCII art (the ``renderer.ts`` vocabulary: cart, pole, floor,
    force indicator)."""
    b_x = float(x[0])
    lengths = _link_lengths(dynamics_params)
    angles = [float(x[1 + i]) for i in range(len(lengths))]
    span = 2.4  # meters shown across the width
    floor_row = height - 3

    def to_cell(px, py):
        col = int(round((px + span / 2) / span * (width - 1)))
        row = floor_row - int(round(py / span * (width - 1) * 0.5))
        return row, col

    grid = [[" "] * width for _ in range(height)]
    for c in range(width):
        grid[floor_row + 1][c] = "-"

    def clamp(r, c):
        return (
            min(max(r, 0), height - 1), min(max(c, 0), width - 1)
        )

    # link chain: sample points along each link (clamped into the frame so
    # a hanging pole still renders below the floor line)
    joint = (b_x, 0.0)
    for l_i, th_i in zip(lengths, angles):
        tip = (joint[0] + l_i * math.cos(th_i),
               joint[1] + l_i * math.sin(th_i))
        for i in range(1, 9):
            px = joint[0] + (tip[0] - joint[0]) * i / 8
            py = joint[1] + (tip[1] - joint[1]) * i / 8
            r, c = clamp(*to_cell(px, py))
            grid[r][c] = "*"
        r, c = clamp(*to_cell(tip[0], tip[1]))
        grid[r][c] = "o"
        joint = tip
    r, c = to_cell(b_x, 0.0)
    for dc in (-2, -1, 0, 1, 2):
        if 0 <= c + dc < width:
            grid[floor_row][c + dc] = "="
    if force is not None and abs(force) > 1e-3 and 0 <= floor_row - 1 < height:
        ch = ">" if force > 0 else "<"
        cc = min(max(c + (3 if force > 0 else -3), 0), width - 1)
        grid[floor_row - 1][cc] = ch
    th_txt = " ".join(f"{math.degrees(a):+7.1f}" for a in angles)
    status = (
        f" b_x={b_x:+.2f}  th={th_txt} deg  "
        f"ctrl={'ON ' if enabled else 'OFF'}"
    )
    return "\n".join("".join(row) for row in grid) + "\n" + status


class InteractiveLoop:
    """Stateful host-side loop. All solver work stays jitted; dynamics
    params are jit arguments so slider-style updates never recompile;
    OptimizationParams changes rebuild the MPC (the reference rebuilds its
    optimizer on those, ``application.ts:367-373``)."""

    def __init__(
        self,
        params: Optional[OptimizationParams] = None,
        dynamics_params: Optional[SingleCartPoleParams] = None,
        out=None,
        render: bool = True,
        sim_rate: float = 1.0,
        dtype=jnp.float32,
        model=SINGLE_CARTPOLE,
    ):
        self.params = params or OptimizationParams(
            state_spacing=5, max_iterations=8
        )
        self.dtype = dtype
        self.model = model
        self.dp = dynamics_params if dynamics_params is not None else (
            jax.tree.map(
                lambda v: jnp.asarray(v, dtype), model.default_params()
            )
        )
        self.out = out if out is not None else sys.stdout
        self.render = render
        self.sim_rate = sim_rate
        self.x = self._hang_state()
        # [base, link-1 mass, (link-2 mass)] x (fx, fy).
        self.forces = np.zeros((1 + len(model.angle_indices), 2))
        #: Cart set-point (the UI's cartSetPointSlider, application.ts:267-275).
        self.set_point = 0.0
        self.enabled = True
        self.log = SolveLog()
        self.tick_count = 0
        self._build()

    def _hang_state(self):
        down = [0.0] * self.model.state_dim
        for a in self.model.angle_indices:
            down[a] = -math.pi / 2
        return jnp.asarray(down, self.dtype)

    # ------------------------------------------------------------ optimizer
    def _build(self):
        """(Re)build the MPC + jitted step — called on OptimizationParams
        changes, like the reference's optimizer rebuild."""
        self.mpc = MPC(self.params, self.model)
        self.mpc_state = self.mpc.init_state(self.dtype)
        self._step = jax.jit(self.mpc.step)

    def set_params(self, **changes):
        """Live OptimizationParams update (cost sliders / cost<->equality
        checkboxes via sign flip, ``application.ts:279-342``)."""
        self.params = self.params.replace(**changes)
        self._build()

    def set_dynamics(self, **changes):
        """Live dynamics-params update (no recompile: jit argument)."""
        self.dp = dataclasses.replace(
            self.dp,
            **{k: jnp.asarray(v, self.dtype) for k, v in changes.items()},
        )

    # -------------------------------------------------------------- controls
    def poke(self, mass_index: int, incident_angle: float):
        if not 0 <= mass_index < len(self.forces):
            return
        self.forces[mass_index] = poke_force(
            mass_index, incident_angle, self.dp
        )

    def toggle_controller(self):
        """Disable/enable; re-enabling resets the warm start
        (``application.ts:209-214``)."""
        self.enabled = not self.enabled
        if self.enabled:
            self.mpc_state = self.mpc.reset(self.mpc_state)

    def reset_plant(self):
        self.x = self._hang_state()
        self.mpc_state = self.mpc.reset(self.mpc_state)

    def handle_command(self, cmd: str):
        """One keypress. Returns False when the loop should stop."""
        if cmd == "q":
            return False
        elif cmd == "b":
            self.poke(0, 0.0)  # force -x at the base
        elif cmd == "B":
            self.poke(0, math.pi)  # force +x
        elif cmd == "p":
            self.poke(1, 0.0)
        elif cmd == "P":
            self.poke(1, math.pi)
        elif cmd == "o":
            self.poke(2, 0.0)  # second link mass (double pole only)
        elif cmd == "O":
            self.poke(2, math.pi)
        elif cmd == "c":
            self.toggle_controller()
        elif cmd == "1":
            self.set_dynamics(m_1=max(0.01, float(self.dp.m_1) - 0.02))
        elif cmd == "2":
            self.set_dynamics(m_1=float(self.dp.m_1) + 0.02)
        elif cmd == "3":
            self.set_dynamics(l_1=max(0.05, float(self.dp.l_1) - 0.05))
        elif cmd == "4":
            self.set_dynamics(l_1=float(self.dp.l_1) + 0.05)
        elif cmd == "t":
            # theta terminal cost <-> equality (negative-weight convention).
            w = self.params.th_final_cost_weight
            self.set_params(th_final_cost_weight=-w if w != 0 else -1.0)
        elif cmd == "r":
            self.reset_plant()
        return True

    # ------------------------------------------------------------------ tick
    def tick(self):
        """One control tick: MPC solve (if enabled) -> plant with user
        forces -> force decay -> log (``application.ts:424-458``)."""
        dt = self.params.control_dt
        if self.enabled:
            outputs, self.mpc_state = self._step(
                self.mpc_state, self.x, self.dp,
                jnp.asarray(self.set_point, self.dtype),
            )
            u0 = outputs.u[0]
            self.log.append(outputs)
        else:
            outputs, u0 = None, jnp.zeros((), self.dtype)
        self.x = simulator_step(
            self.dp, self.x, dt, u0,
            f_base=jnp.asarray(self.forces[0], self.dtype),
            f_mass=jnp.asarray(self.forces[1], self.dtype),
            model=self.model,
            f_mass_2=(jnp.asarray(self.forces[2], self.dtype)
                      if len(self.forces) > 2 else None),
        )
        self.forces = decay_external_forces(self.forces, dt)
        self.tick_count += 1
        return outputs

    def draw(self):
        if not self.render:
            return
        frame = render_ascii(
            np.asarray(self.x), self.dp,
            force=float(self.forces[:, 0].sum()),
            enabled=self.enabled,
        )
        self.out.write("\x1b[2J\x1b[H" + frame + "\n")
        self.out.flush()

    # ------------------------------------------------------------------- run
    def run(self, max_ticks: Optional[int] = None, realtime: bool = True,
            commands=None):
        """Fixed-timestep accumulator loop (``application.ts:375-421``).

        ``commands``: optional iterable of keypress strings consumed one
        per frame (scripted/testing mode); with a real terminal, keys are
        read non-blocking from stdin.
        """
        if commands is None and not realtime and max_ticks is None:
            raise ValueError(
                "run(realtime=False) with no max_ticks and no commands "
                "would loop forever with no way to deliver 'q'"
            )
        commands = iter(commands) if commands is not None else None
        reader = None
        if commands is None and realtime and sys.stdin.isatty():
            reader = _TerminalReader()
        dt = self.params.control_dt
        accum = 0.0
        last = time.perf_counter()
        try:
            while max_ticks is None or self.tick_count < max_ticks:
                if commands is not None:
                    cmd = next(commands, None)
                elif reader is not None:
                    cmd = reader.read()
                else:
                    cmd = None
                if cmd is not None and not self.handle_command(cmd):
                    break
                if realtime:
                    now = time.perf_counter()
                    gap = now - last
                    last = now
                    if gap > FRAME_GAP_WATCHDOG:
                        gap = 0.0  # watchdog: drop time after a stall
                    accum += gap * self.sim_rate
                    while accum >= dt and (
                        max_ticks is None or self.tick_count < max_ticks
                    ):
                        self.tick()
                        accum -= dt
                    self.draw()
                    time.sleep(0.01)
                else:
                    self.tick()
                    self.draw()
        finally:
            if reader is not None:
                reader.close()
        return self


class _TerminalReader:
    """Non-blocking single-key reads from a tty (no curses dependency)."""

    def __init__(self):
        import termios
        import tty

        self._fd = sys.stdin.fileno()
        self._old = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)

    def read(self):
        import select

        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1)
        return None

    def close(self):
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)


