"""K3's share of its roofline in the traced span: the bound of
roofline/k3.py over the kernel's mean time per launch, in percent."""


def read(ctx):
    return ctx.roofline_share("k3")
