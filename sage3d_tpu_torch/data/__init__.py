"""SAGE-Bench's data pipeline in the port: semantic map -> physical map ->
scene text -> trajectories (host A* or the batched wavefront planner on the
card, ``astar.py``) -> 2D->3D transform -> merge, statistics, splits ->
action ground truth -> waypoint images (the render path, ``images.py``) ->
the NaVILA training set; and the scene bundles the env loads
(``scene_build.py``).

Counterpart of ``sage3d_tpu/data``. The modules with no JAX in them are
copies of the JAX package's, with their imports pointed at the port.
"""
