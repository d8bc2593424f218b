"""The least time the card could take for a stage's work.

A frozen copy of ``chip_smoke.py``'s ``OPS_PER_CELL`` (``:317-319``)
and ``bound`` (``:415-426``), with the published peaks of
``bath_tpu_torch/ubench.py`` (``F32_OPS_PER_S``, ``HBM_BYTES_PER_S``),
at commit 520fb61.  Copied, not imported, so that the yardstick does
not follow later changes to the program.

The DP kernels are f32 multiply-adds and maxima on the CUDA cores, so
the card's f32 rate bounds their operations.  Arithmetic per DP cell
(one residue x one model position), counted from the recurrences: the
M, I, D updates, the row sum and the rescale; decoding adds the
backward pass's.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published: f32 outside the tensor cores, HBM3
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

OPS_PER_CELL = {"fwd_parser": 19, "domdec": 37, "fs3_parser": 23,
                "fs3_domdec": 43, "msv_filter": 8, "ssv_capture": 4,
                "vit_filter": 20, "vit_capture": 21}


def bound_s(kernel: str, cells: float, nbytes: float) -> float:
    """Seconds: the larger of <cells> DP cells of <kernel> at the f32
    peak and <nbytes> at the HBM peak (each input read once, each
    output written once)."""
    return max(cells * OPS_PER_CELL[kernel] / F32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)


def gate_work(items) -> tuple[float, float]:
    """(cells, bytes) of the Forward gate over <items>, (length, M)
    pairs: int8 residues in, one f32 score out, and each call's
    profile tables (29 odds rows and 8 transition rows of M f32)."""
    cells = sum(n * M for n, M in items)
    nbytes = sum(n + 4 for n, _ in items)
    nbytes += sum(37 * 4 * M for M in {M for _, M in items})
    return cells, nbytes


def decoding_work(items) -> tuple[float, float]:
    """(cells, bytes) of domain decoding over <items>: int8 residues
    in, three f32 rows of n + 1 and a flag out, and the tables."""
    cells = sum(n * M for n, M in items)
    nbytes = sum(n + 12 * (n + 1) + 1 for n, _ in items)
    nbytes += sum(37 * 4 * M for M in {M for _, M in items})
    return cells, nbytes
