"""Retime a planned trajectory under velocity/acceleration limits and plot
position/velocity/acceleration profiles.

Port of examples/plot_kinematics.py on the port's `planning/retiming.py`
(the reference's toppra demo, gto/utils.py:283-324): a synthetic 3-joint
smoothstep plan, retimed and plotted headlessly. Needs matplotlib:

    python -m grasptrajopt_tpu_torch.plot_kinematics -o kinematics.png
"""

import argparse

import numpy as np

from grasptrajopt_tpu_torch.planning.retiming import convert_plan_to_trajectory


class DemoRobot:
    velocity_optimized_joint_limits = np.array([1.0, 1.5, 2.0])
    velocity_actuated_joint_limits = velocity_optimized_joint_limits


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--out", default="kinematics.png")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # synthetic 3-joint plan: smoothstep to a goal
    T = 50
    t = np.linspace(0, 1, T)
    s = 3 * t**2 - 2 * t**3
    goals = np.array([1.2, -0.8, 2.0])
    plan = (goals[:, None] * s[None, :])

    qs, qds, qdds, ts = convert_plan_to_trajectory(DemoRobot(), plan, accel_limit=0.5)

    fig, axs = plt.subplots(3, 1, sharex=True, figsize=(8, 8))
    for i in range(plan.shape[0]):
        axs[0].plot(ts, qs[:, i], label=f"joint {i}")
        axs[1].plot(ts, qds[:, i])
        axs[2].plot(ts, qdds[:, i])
    axs[0].set_ylabel("position (rad)")
    axs[1].set_ylabel("velocity (rad/s)")
    axs[2].set_ylabel("acceleration (rad/s$^2$)")
    axs[2].set_xlabel("time (s)")
    axs[0].legend()
    for ax, lim in zip(axs[1:], [DemoRobot.velocity_optimized_joint_limits.max(), 0.5]):
        ax.axhline(lim, color="k", linestyle=":", linewidth=0.8)
        ax.axhline(-lim, color="k", linestyle=":", linewidth=0.8)
    fig.savefig(args.out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {args.out}; duration {ts[-1]:.2f}s")


if __name__ == "__main__":
    main()
