"""gate_roofline: the Forward gate's (F3) share of its roofline, in %:
the least time the card could take for the stage's work in the window
(``roofline.gate_work``: residues x M of every item scored) over the
kernel time ``torch.profiler`` gives the stage's launches."""

from perfbench import roofline

ITEMS = ("fwd_scores",)


def read(run):
    t = run.trace.stage_kernel_s.get("gate", 0.0) if run.trace else 0.0
    items = [(len(r[1]), run.model_M[r[0]]) for j in run.jobs
             for r in j.items["fwd_scores"]]
    if t <= 0 or not items:
        return None
    return 100.0 * roofline.bound_s("fwd_parser",
                                    *roofline.gate_work(items)) / t
