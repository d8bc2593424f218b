"""What decides ``correct``: the timed jobs' answers against the plain
reference (``perfbench/reference``).

- ``fwd_gap_nats``: the widest gap, in nats, between the Forward-gate
  score the device stage gave an item and the reference's, over a
  sample of the window's items drawn from the seed, the longest item
  always in it;
- ``domdec_gap``: the widest gap between decoding's rows (``btot``,
  ``etot``, ``mocc``) and the reference's, over a sample of the items
  whose device posteriors the program kept (``ok``);
- ``orf_misses``: sampled items that are no stop-free stretch of the
  genome's six-frame translation, as long as the search's ``-l``;
- ``hits_off``: in the job that reads worst, the embedded copies no
  reported hit of their profile covers, and the hits at E <= 1e-5 that
  cover no copy of their profile.

``limits`` of a cell's file hold each number's limit; a number over it,
or a stage with no item to compare, makes the run not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import dp, hits, hmmfile, profile, translate

def sample(records: list, k: int, rng) -> list:
    """<k> of <records> (``(profile, residues, ...)``), the longest
    first and the rest drawn by <rng>."""
    if len(records) <= k:
        return list(records)
    longest = max(range(len(records)), key=lambda i: len(records[i][1]))
    rest = [i for i in range(len(records)) if i != longest]
    pick = rng.choice(len(rest), size=k - 1, replace=False)
    return [records[longest]] + [records[rest[i]] for i in sorted(pick)]


class Reference:
    """The profiles of a query file's text, as the reference reads
    them, and its dynamic programming on <device> in <dtype>."""

    def __init__(self, query_text: str, device, dtype=torch.float64):
        self.hmms = {h.name: h for h in hmmfile.read_text(query_text)}
        self.device, self.dtype = device, dtype
        self._tables: dict = {}

    def _batch(self, recs):
        names = sorted({r[0] for r in recs})
        for n in names:
            if n not in self._tables:
                self._tables[n] = profile.tables(self.hmms[n])
        slot = {n: i for i, n in enumerate(names)}
        items = [(slot[r[0]], r[1].astype(np.int64)) for r in recs]
        return dp.Batch(items, [self._tables[n] for n in names],
                        self.device, self.dtype)

    def scores(self, recs) -> np.ndarray:
        score, _ = dp.forward(self._batch(recs))
        return score.cpu().numpy()

    def posteriors(self, recs) -> list:
        return dp.decode(self._batch(recs))[1]


def fwd_gap(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def domdec_gap(got: list, want: list) -> float:
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - w)))
               for gr, wr in zip(got, want) for g, w in zip(gr, wr))


def samples(jobs, cell: dict, seed: int) -> tuple[list, list]:
    """The gate's and decoding's items the check compares: drawn from
    <seed>, decoding's among the items whose posteriors the program
    kept."""
    rng = np.random.default_rng([seed % (1 << 64), 2])
    fwd = sample([r for j in jobs for r in j.fwd], cell["sample"]["fwd"],
                 rng)
    dd = sample([r for j in jobs for r in j.domdec if r[5]],
                cell["sample"]["domdec"], rng)
    return fwd, dd


def check(jobs, inputs, cell: dict, seed: int, device, minlen: int,
          tblouts: list) -> dict:
    """{number: value} of the window's <jobs> (``recorder.Job``) with
    their --tblout files <tblouts>."""
    fwd, dd = samples(jobs, cell, seed)
    ref = Reference(inputs.query.read_text(), device)
    out = {}
    out["fwd_gap_nats"] = fwd_gap([r[2] for r in fwd], ref.scores(fwd)) \
        if fwd else float("inf")
    out["domdec_gap"] = domdec_gap([r[2:5] for r in dd],
                                   ref.posteriors(dd)) \
        if dd else float("inf")
    frames = translate.six_frames(inputs.dna)
    out["orf_misses"] = sum(not translate.in_frames(r[1], frames, minlen)
                            for r in fwd + dd)
    worst = 0
    for job, tbl in zip(jobs, tblouts):
        if job.rc != 0 or not tbl.exists():
            worst = max(worst, sum(map(len, inputs.copies.values())))
            continue
        worst = max(worst, sum(hits.hits_off(hits.read_tblout(str(tbl)),
                                             inputs.copies)))
    out["hits_off"] = worst
    return out


def decide(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, {number: {"value", "limit"}}): every job ran and every
    number is within its limit."""
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits)
    return bool(correct), {k: {"value": numbers[k], "limit": limits[k]}
                           for k in limits}


def control(jobs, inputs, cell: dict, seed: int, device,
            dtype=torch.bfloat16) -> dict:
    """The control's readings: the reference computed in <dtype> put in
    the device stages' place, on the items the check samples."""
    fwd, dd = samples(jobs, cell, seed)
    text = inputs.query.read_text()
    ref = Reference(text, device)
    low = Reference(text, device, dtype)
    return {"fwd_gap_nats": fwd_gap(low.scores(fwd), ref.scores(fwd)),
            "domdec_gap": domdec_gap(low.posteriors(dd),
                                     ref.posteriors(dd))}
