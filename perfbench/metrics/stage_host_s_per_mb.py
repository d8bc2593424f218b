"""stage_host_s_per_mb: the host's own seconds a megabase inside the
device stages, while the card waits: each stage's host wall
(``stats["<key>_s"]``) less the card's time for its launches
(``<key>_dev_s``, CUDA events round each batch's launch call, recorded
with ``BATH_PHASE_STATS=1``), over every job and every stage that has
both."""


def read(run):
    keys = [(j.stats, k[:-len("_dev_s")]) for j in run.jobs
            for k in j.stats if k.endswith("_dev_s")]
    if not keys:
        return None
    return sum(st.get(f"{k}_s", 0.0) - st[f"{k}_dev_s"]
               for st, k in keys) / run.mb
