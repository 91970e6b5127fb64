"""The front end's share of its roofline in the traced span: the bound of
roofline/prepare.py over the mean time of one call (its four CUDA
functions' mean times per launch, summed), in percent."""


def read(ctx):
    return ctx.roofline_share("prepare")
