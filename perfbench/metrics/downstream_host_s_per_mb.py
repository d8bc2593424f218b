"""downstream_host_s_per_mb: host seconds a megabase in rescoring and
domain definition: the program's ``mq_phase_s`` ``fwd_stage``,
``tail`` and ``fs_define`` in a multi-query drive, else the
``flush_downstream`` spans less the device stages' seconds inside
them."""

DEVICE = ("fwd_s", "domdec_s", "fs3_s", "fs3domdec_s")
PHASES = ("fwd_stage", "tail", "fs_define")


def read(run):
    if any("mq_phase_s" in j.stats for j in run.jobs):
        s = sum(j.stats.get("mq_phase_s", {}).get(p, 0.0)
                for j in run.jobs for p in PHASES)
    else:
        if not any(lab == "downstream.host" for j in run.jobs
                   for lab, _, _ in j.spans):
            return None
        s = sum(j.span_s("downstream.host") - sum(j.stats.get(k, 0.0)
                                                   for k in DEVICE)
                for j in run.jobs)
    return s / run.mb
