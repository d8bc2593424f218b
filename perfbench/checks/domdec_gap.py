"""domdec_gap: the widest gap between a row of domain decoding's
``btot``, ``etot`` or ``mocc`` as the device stage gave it and the
float64 reference's (``reference/dp.py``), over ``sample.domdec`` of
the items whose posteriors the program kept (``ok``), drawn from the
seed (``check.samples``), the longest always among them.  The control:
the reference in bfloat16 in the stage's place."""

import torch

from perfbench.check import INF, domdec_gap

ITEMS = ("domdec",)


def _want(ctx):
    dd = ctx.samples()[1]
    return ctx.once("domdec_gap", lambda: ctx.reference().posteriors(dd))


def value(ctx):
    dd = ctx.samples()[1]
    return domdec_gap([r[2:5] for r in dd], _want(ctx)) if dd else INF


def control(ctx):
    dd = ctx.samples()[1]
    return domdec_gap(ctx.reference(torch.bfloat16).posteriors(dd),
                      _want(ctx)) if dd else INF
