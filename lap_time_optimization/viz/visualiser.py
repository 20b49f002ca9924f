"""Simulation replay: curvilinear states → Cartesian car positions.

Capability parity with reference src/visualiser.py:9-74: reconstruct the car
position as path(s) + n·normal, rotate the body-frame velocity into the track
frame, quiver every 10th step.  The reconstruction itself is vectorized over
all steps via the MPCTrack lookup tables instead of a per-step spline solve.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from lap_time_optimization.mpc.track import MPCTrack


def vehicle_positions(track: MPCTrack, states: np.ndarray):
    """states (n, 8) → (positions (n,2), velocities (n,2)) in world frame
    (reference src/visualiser.py:37-67)."""
    states = np.asarray(states)
    s, n, mu, vx, vy = states[:, 0], states[:, 1], states[:, 2], states[:, 3], states[:, 4]
    pts, tangents = track.position(jnp.asarray(s))
    pts = np.asarray(pts).T  # (n, 2)
    tan = np.asarray(tangents).T
    normal = np.stack([-tan[:, 1], tan[:, 0]], axis=1)
    positions = pts + n[:, None] * normal
    v_long = vx * np.cos(mu) - vy * np.sin(mu)
    v_lat = vx * np.sin(mu) + vy * np.cos(mu)
    velocities = v_long[:, None] * tan + v_lat[:, None] * normal
    return positions, velocities


def plot_replay(dest: str, track: MPCTrack, sim_results_path: str, quiver_every: int = 10):
    """Track + optimal path + simulated car positions/velocity quivers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(sim_results_path) as f:
        data = json.load(f)
    states = np.asarray(data["x"])[:, :, 0]
    positions, velocities = vehicle_positions(track, states)

    fig, ax = plt.subplots(figsize=(16, 9))
    fig.suptitle("Visualiser")
    ax.plot(*np.asarray(track.path_xy), "g")
    ax.plot(*np.asarray(track.left_xy), "black")
    ax.plot(*np.asarray(track.right_xy), "black")
    for i in range(0, len(positions), quiver_every):
        ax.quiver(
            positions[i, 0], positions[i, 1], velocities[i, 0], velocities[i, 1],
            angles="xy", scale_units="xy", scale=1, color="blue",
        )
    ax.scatter(positions[:, 0], positions[:, 1], s=4)
    ax.set_aspect("equal", adjustable="box")
    fig.savefig(dest, bbox_inches="tight", dpi=200)
    plt.close(fig)
    return positions, velocities


def plot_internal(dest: str, track: MPCTrack, sim_results_path: str, dt: float = 0.1):
    """Internal-parameter plots: the full state/control/tire picture —
    capability parity with the reference's 9-subplot results graphics
    (src/mpc/simulator.py:22-57) plus src/show_results.py:20-46."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(sim_results_path) as f:
        data = json.load(f)
    states = np.asarray(data["x"])[:, :, 0]
    controls = np.asarray(data["u"])[:, :, 0]
    alphas = np.asarray(data["alpha"])
    fys = np.asarray(data["Fy"])
    t = np.arange(len(states)) * dt
    k = np.asarray(track.curvature(jnp.asarray(states[:, 0])))
    vref = np.asarray(track.v_ref(jnp.asarray(states[:, 0])))

    fig, axs = plt.subplots(3, 3, figsize=(16, 10))
    panels = [
        ("track position s [m]", [(states[:, 0], "s")]),
        ("lateral deviation n [m]", [(states[:, 1], "n")]),
        ("heading error mu [rad]", [(states[:, 2], "mu")]),
        ("velocities [m/s]", [(states[:, 3], "vx"), (states[:, 4], "vy"), (0.6 * vref, "0.6 vref")]),
        ("yaw rate r [rad/s]", [(states[:, 5], "r")]),
        ("steering / throttle", [(states[:, 6], "steering"), (states[:, 7], "throttle")]),
        ("inputs", [(controls[:, 0], "d steering"), (controls[:, 1], "d throttle")]),
        ("slip angles [rad]", [(alphas[:, 0], "front"), (alphas[:, 1], "rear")]),
        ("lateral forces [N]", [(fys[:, 0], "front"), (fys[:, 1], "rear")]),
    ]
    for ax, (title, series) in zip(axs.flat, panels):
        for y, label in series:
            ax.plot(t, y, label=label)
        ax.set_title(title)
        ax.set_xlabel("t [s]")
        if len(series) > 1:
            ax.legend(fontsize=8)
    # curvature overlay on the s panel's twin axis
    ax2 = axs.flat[0].twinx()
    ax2.plot(t, k, color="tab:gray", alpha=0.5)
    ax2.set_ylabel("k(s)", color="tab:gray")
    fig.tight_layout()
    fig.savefig(dest, bbox_inches="tight", dpi=200)
    plt.close(fig)
