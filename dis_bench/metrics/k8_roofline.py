"""K8's share of its roofline: the least time of the forward-backward
merge's splats of a call (`work/k8.py`) over the device time of
`csrc/fb_splat.cu`'s kernels a call, in %. A program without K8 runs no
kernel of that library and reads None."""


def read(ctx):
    return ctx.roofline("k8")
