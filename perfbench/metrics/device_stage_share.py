"""device_stage_share: the share of the window the host spent inside
the device stages (``TorchCascade``/``PackedGates`` ``stats``
``<stage>_s``: host wall up to the read-back)."""

STAGES = ("fwd_s", "domdec_s", "fs3_s", "fs3domdec_s", "msv_s", "vit_s",
          "ssvcap_s", "vitcap_s")


def read(run):
    s = sum(j.stats.get(k, 0.0) for j in run.jobs for k in STAGES)
    return s / run.window_s if s > 0 else None
