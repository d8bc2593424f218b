"""rescore_card_share: the share of the standard branch's envelopes
whose fills (Forward, Backward, decoding, optimal accuracy) ran on the
card: Σ ``stats["rescore_items"]`` / Σ (``rescore_items`` +
``rescore_host_items``) over the window's jobs; ``rescore_items`` is the
device stage's count (``TorchCascade.rescore``), ``rescore_host_items``
the envelopes the native host fills took.  None where the program
counts neither."""


def read(run):
    card = sum(j.stats.get("rescore_items", 0) for j in run.jobs)
    host = sum(j.stats.get("rescore_host_items", 0) for j in run.jobs)
    if card + host <= 0:
        return None
    return card / (card + host)
