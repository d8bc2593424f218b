"""hits_off: in the job that reads worst, the embedded copies that no
reported hit of their profile covers, and the hits at E <= 1e-5 that
cover no copy of their profile (``reference/hits.py``); a job that
failed, or wrote no table, misses every copy."""

from perfbench.reference import hits

ITEMS = ()


def value(ctx):
    copies = ctx.inputs.copies
    worst = 0
    for job, tbl in zip(ctx.jobs, ctx.tblouts):
        if job.rc != 0 or not tbl.exists():
            worst = max(worst, sum(map(len, copies.values())))
            continue
        worst = max(worst, sum(hits.hits_off(hits.read_tblout(str(tbl)),
                                             copies)))
    return worst
