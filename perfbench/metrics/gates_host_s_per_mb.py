"""gates_host_s_per_mb: host seconds a megabase in the gates (native
integer filters, bias filter): the program's ``mq_phase_s["gates"]``
in a multi-query drive, else the ``flush_gates`` spans less the device
stages' seconds inside them."""

DEVICE = ("msv_s", "vit_s", "ssvcap_s", "vitcap_s")


def read(run):
    if any("mq_phase_s" in j.stats for j in run.jobs):
        s = sum(j.stats.get("mq_phase_s", {}).get("gates", 0.0)
                for j in run.jobs)
    else:
        if not any(lab == "gates.host" for j in run.jobs
                   for lab, _, _ in j.spans):
            return None
        s = sum(j.span_s("gates.host") - sum(j.stats.get(k, 0.0)
                                              for k in DEVICE)
                for j in run.jobs)
    return s / run.mb
