"""orf_misses: the sampled items of the Forward gate and of decoding
(``check.samples``) that are no stop-free stretch of the genome's
six-frame translation as long as the search's ``-l``."""

from perfbench.reference import translate

ITEMS = ("fwd_scores", "domdec")


def value(ctx):
    fwd, dd = ctx.samples()
    frames = translate.six_frames(ctx.inputs.dna)
    return sum(not translate.in_frames(r[1], frames, ctx.minlen)
               for r in fwd + dd)
