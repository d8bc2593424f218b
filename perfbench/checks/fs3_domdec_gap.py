"""fs3_domdec_gap: the widest gap between a row of fs3 decoding's
``btot``, ``etot`` or ``mocc`` (one a nucleotide) as the device stage
gave it and the float64 frameshift reference's (``reference/fs3.py``,
under the N/J/C loop probability the stage was given), over
``sample.fs3_domdec`` of the windows whose posteriors the program kept
(``ok``), drawn from the seed (``check.fs_samples``), the longest
always among them.  The control: the reference in bfloat16 in the
stage's place."""

import torch

from perfbench.check import INF, domdec_gap

ITEMS = ("fs3_domdec",)


def _posteriors(ref, dd):
    """<ref>'s rows of <dd>, each under the loop probability the stage
    was given."""
    return ref.posteriors(dd, dec_loop=[r[6] for r in dd])


def _want(ctx):
    dd = ctx.fs_samples()[1]
    return ctx.once("fs3_domdec_gap",
                    lambda: _posteriors(ctx.reference(fs=True), dd))


def value(ctx):
    dd = ctx.fs_samples()[1]
    return domdec_gap([r[2:5] for r in dd], _want(ctx)) if dd else INF


def control(ctx):
    dd = ctx.fs_samples()[1]
    return domdec_gap(_posteriors(ctx.reference(torch.bfloat16, fs=True),
                                  dd), _want(ctx)) if dd else INF
