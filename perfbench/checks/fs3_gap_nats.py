"""fs3_gap_nats: the widest gap, in nats, between the fs3-Forward gate's
score for a DNA window, as the device stage gave it, and the float64
frameshift reference's (``reference/fs3.py``), over ``sample.fs3`` of
the window's items drawn from the seed (``check.fs_samples``), the
longest always among them.  The control: the reference in bfloat16 in
the stage's place."""

import torch

from perfbench.check import INF, fwd_gap

ITEMS = ("fs3_scores",)


def _want(ctx):
    fs = ctx.fs_samples()[0]
    return ctx.once("fs3_gap_nats",
                    lambda: ctx.reference(fs=True).scores(fs))


def value(ctx):
    fs = ctx.fs_samples()[0]
    return fwd_gap([r[2] for r in fs], _want(ctx)) if fs else INF


def control(ctx):
    fs = ctx.fs_samples()[0]
    return fwd_gap(ctx.reference(torch.bfloat16, fs=True).scores(fs),
                   _want(ctx)) if fs else INF
