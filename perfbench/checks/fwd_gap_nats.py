"""fwd_gap_nats: the widest gap, in nats, between the Forward-gate (F3)
score the device stage gave an item and the float64 reference's
(``reference/dp.py``), over ``sample.fwd`` of the window's items drawn
from the seed (``check.samples``), the longest always among them.  The
control: the reference in bfloat16 in the stage's place."""

import torch

from perfbench.check import INF, fwd_gap

ITEMS = ("fwd_scores",)


def _want(ctx):
    fwd = ctx.samples()[0]
    return ctx.once("fwd_gap_nats", lambda: ctx.reference().scores(fwd))


def value(ctx):
    fwd = ctx.samples()[0]
    return fwd_gap([r[2] for r in fwd], _want(ctx)) if fwd else INF


def control(ctx):
    fwd = ctx.samples()[0]
    return fwd_gap(ctx.reference(torch.bfloat16).scores(fwd), _want(ctx)) \
        if fwd else INF
