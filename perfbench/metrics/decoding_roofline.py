"""decoding_roofline: domain decoding's share of its roofline, in %:
the least time for the stage's work in the window
(``roofline.decoding_work``) over the kernel time ``torch.profiler``
gives the stage's launches."""

from perfbench import roofline

ITEMS = ("domdec",)


def read(run):
    t = run.trace.stage_kernel_s.get("decoding", 0.0) if run.trace \
        else 0.0
    items = [(len(r[1]), run.model_M[r[0]]) for j in run.jobs
             for r in j.items["domdec"]]
    if t <= 0 or not items:
        return None
    return 100.0 * roofline.bound_s("domdec",
                                    *roofline.decoding_work(items)) / t
