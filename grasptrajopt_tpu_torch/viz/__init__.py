"""Host-side visualization (matplotlib 3D backend); port of
grasptrajopt_tpu/viz. Needs matplotlib, which the visualizer imports
when it is built.

Replaces the reference's VTK-based Visualizer (optas/visualize.py:116) with
a dependency-light matplotlib implementation covering the API the planners
and examples actually use: primitives (points, line, sphere, box,
cylinder, grid_floor, text), URDF robot rendering via the framework's own
FK + mesh loaders, ghost robot trajectories with alpha ramps, PNG export,
and interactive display.
"""

from grasptrajopt_tpu_torch.viz.visualizer import Visualizer

__all__ = ["Visualizer"]
