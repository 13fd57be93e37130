"""Splitting work over devices: the frame-pair batch over a list of
devices (`parallel.mesh`), and a level's TV refinement by rows
(`parallel.spatial`)."""

from of_dis_tpu_torch.parallel import mesh, spatial  # noqa: F401
