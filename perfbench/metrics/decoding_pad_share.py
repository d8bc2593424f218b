"""decoding_pad_share: the share of domain decoding's padded cells
that are padding: 1 - Σ ``stats["domdec_cells"]`` / Σ
``stats["domdec_padded_cells"]`` (residues x M of the items, and each
batch's rows x padded width x M) over the window's jobs."""


def read(run):
    padded = sum(j.stats.get("domdec_padded_cells", 0) for j in run.jobs)
    if padded <= 0:
        return None
    return 1.0 - sum(j.stats.get("domdec_cells", 0)
                     for j in run.jobs) / padded
