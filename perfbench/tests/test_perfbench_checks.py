"""The numbers that moved into ``perfbench/checks/`` read what the code
they came from read, bit for bit: a frozen copy of that code
(``check.check`` as it stood before the numbers were files) against the
files, on the items of one job of each tiny cell."""

import importlib

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.recorder import Job, Recorder
from perfbench.reference import dp, hits, hmmfile, profile, translate


class _Reference:
    def __init__(self, query_text, device, dtype=torch.float64):
        self.hmms = {h.name: h for h in hmmfile.read_text(query_text)}
        self.device, self.dtype = device, dtype
        self._tables = {}

    def _batch(self, recs):
        names = sorted({r[0] for r in recs})
        for n in names:
            if n not in self._tables:
                self._tables[n] = profile.tables(self.hmms[n])
        slot = {n: i for i, n in enumerate(names)}
        items = [(slot[r[0]], r[1].astype(np.int64)) for r in recs]
        return dp.Batch(items, [self._tables[n] for n in names],
                        self.device, self.dtype)

    def scores(self, recs):
        score, _ = dp.forward(self._batch(recs))
        return score.cpu().numpy()

    def posteriors(self, recs):
        return dp.decode(self._batch(recs))[1]


def _before(jobs, inputs, cell, seed, device, minlen, tblouts):
    rng = np.random.default_rng([seed % (1 << 64), 2])
    fwd = check.sample([r for j in jobs for r in j.items["fwd_scores"]],
                       cell["sample"]["fwd"], rng)
    dd = check.sample([r for j in jobs for r in j.items["domdec"] if r[5]],
                      cell["sample"]["domdec"], rng)
    ref = _Reference(inputs.query.read_text(), device)
    out = {}
    out["fwd_gap_nats"] = check.fwd_gap([r[2] for r in fwd],
                                        ref.scores(fwd)) \
        if fwd else float("inf")
    out["domdec_gap"] = check.domdec_gap([r[2:5] for r in dd],
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


@pytest.mark.parametrize("cell,seed", [("single400.tiny", 5),
                                       ("lib2.tiny", 2**32 + 15)])
def test_numbers_read_as_before(tiny_root, tmp_path, cell, seed):
    spec = harness.Spec(tiny_root, cell)
    cfg, cel = spec.config, spec.cell
    entry = importlib.import_module(f"perfbench.entries.{cfg['entry']}")
    inputs = entry.prepare(tiny_root, cfg, cel, tmp_path, seed)
    numbers = check.load(tiny_root, cel["limits"])
    rec = Recorder(sorted(harness.kept_stages(spec, numbers)))
    rec.install()
    job, tbl = Job(), tmp_path / "job.tbl"
    rec.job = job
    job.rc = entry.run(entry.argv(cfg, cel, inputs, inputs.genome,
                                  tmp_path / "job.out", tbl, "cpu"),
                       job.stats)
    rec.job = None
    assert job.rc == 0 and job.items["fwd_scores"] and job.items["domdec"]
    ctx = check.Context([job], inputs, cel, seed, "cpu",
                        harness.minlen(cfg), [tbl])
    now = check.check(numbers, ctx)
    was = _before([job], inputs, cel, seed, "cpu", harness.minlen(cfg),
                  [tbl])
    assert list(now) == ["fwd_gap_nats", "domdec_gap", "orf_misses",
                         "hits_off"]
    assert now == was
