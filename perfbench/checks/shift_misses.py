"""shift_misses: in the job that reads worst, the frameshifted copies
(``Inputs.shifted``: the copies the genome was made with a 1-nt indel
in) that no reported hit of their profile covers with ``shifts`` >= 1,
the column ``--fs`` adds to ``--tblout``.  A job that failed, or wrote
no table, or a table without that column, misses every such copy."""

from perfbench.reference import hits

ITEMS = ()


def value(ctx):
    shifted = ctx.inputs.shifted
    every = sum(map(len, shifted.values()))
    worst = 0
    for job, tbl in zip(ctx.jobs, ctx.tblouts):
        rows = hits.read_shifts(str(tbl)) \
            if job.rc == 0 and tbl.exists() else None
        worst = max(worst, every if rows is None
                    else hits.shifts_missed(rows, shifted))
    return worst
