"""Splitting work over devices: the frame-pair batch over a list of
devices (`parallel.mesh`)."""
