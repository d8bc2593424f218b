"""What decides ``correct``: the timed jobs' answers against the plain
reference (``perfbench/reference``).

Every number the check compares is a file of its own,
``perfbench/checks/<number>.py``, found by the name a cell's ``limits``
give it, as metrics are found by theirs.  A number's file holds

- ``ITEMS``: the device stages whose items it reads (the recorder
  keeps the items of these, ``recorder.SCORES`` and ``DECODINGS``);
- ``value(ctx)``: its reading of the window, from the ``Context``: the
  jobs, their ``--tblout`` files, the inputs, the cell and the seed;
- optionally ``control(ctx)``: the control's reading, the reference in
  bfloat16 put in the stages' place (``perfbench.control``).

A run computes exactly the numbers its cell's ``limits`` name; one
whose stages gave no item reads ``inf``, and ``decide`` makes a run
with a number over its limit not correct.

The items compared are drawn from the seed: the Forward gate's and
standard decoding's from ``default_rng([seed, 2])`` (``samples``), the
fs3 gate's and fs3 decoding's from ``default_rng([seed, 3])``
(``fs_samples``), the longest item of each always among them and
decoding's among the items whose posteriors the program kept (``ok``).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

from .recorder import DECODINGS
from .reference import dp, fs3, hmmfile, profile

INF = float("inf")


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
    them, and its dynamic programming on <device> in <dtype>: the
    standard model's (``dp``), or with <fs> the frameshift model's
    (``fs3``)."""

    def __init__(self, query_text: str, device, dtype=torch.float64,
                 fs: bool = False):
        self.hmms = {h.name: h for h in hmmfile.read_text(query_text)}
        self.device, self.dtype = device, dtype
        self.dp, self._make = (fs3, fs3.tables) if fs \
            else (dp, profile.tables)
        self._tables: dict = {}

    def _batch(self, recs, **kw):
        names = sorted({r[0] for r in recs})
        for n in names:
            if n not in self._tables:
                self._tables[n] = self._make(self.hmms[n])
        slot = {n: i for i, n in enumerate(names)}
        items = [(slot[r[0]], r[1].astype(np.int64)) for r in recs]
        return self.dp.Batch(items, [self._tables[n] for n in names],
                             self.device, self.dtype, **kw)

    def scores(self, recs) -> np.ndarray:
        score, _ = self.dp.forward(self._batch(recs))
        return score.cpu().numpy()

    def posteriors(self, recs, **kw) -> list:
        """Decoding's rows of <recs>; <kw> the batch's own arguments (the
        frameshift model's ``dec_loop``)."""
        return self.dp.decode(self._batch(recs, **kw))[1]


def fwd_gap(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def domdec_gap(got: list, want: list) -> float:
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - w)))
               for gr, wr in zip(got, want) for g, w in zip(gr, wr))


def _draw(jobs, stages: tuple, sizes: tuple, rng) -> tuple:
    out = []
    for stage, k in zip(stages, sizes):
        recs = [r for j in jobs for r in j.items[stage]]
        if stage in DECODINGS:
            recs = [r for r in recs if r[5]]
        out.append(sample(recs, k, rng))
    return tuple(out)


def samples(jobs, cell: dict, seed: int) -> tuple[list, list]:
    """The Forward gate's and decoding's items the check compares:
    drawn from <seed>, decoding's among the items whose posteriors the
    program kept."""
    rng = np.random.default_rng([seed % (1 << 64), 2])
    size = cell["sample"]
    return _draw(jobs, ("fwd_scores", "domdec"),
                 (size.get("fwd", 0), size.get("domdec", 0)), rng)


def fs_samples(jobs, cell: dict, seed: int) -> tuple[list, list]:
    """The fs3 gate's and fs3 decoding's items the check compares,
    drawn as ``samples`` draws the standard stages' but from a
    generator of their own."""
    rng = np.random.default_rng([seed % (1 << 64), 3])
    size = cell["sample"]
    return _draw(jobs, ("fs3_scores", "fs3_domdec"),
                 (size.get("fs3", 0), size.get("fs3_domdec", 0)), rng)


class Context:
    """What a number reads: the window's <jobs> (``recorder.Job``) and
    their <tblouts>, the <inputs> (``entries.<entry>.Inputs``), the
    <cell>'s file, the <seed>, the reference's <device> and the
    search's ``-l`` <minlen>; the samples and the references once."""

    def __init__(self, jobs, inputs, cell: dict, seed: int, device,
                 minlen: int, tblouts: list):
        self.jobs, self.inputs, self.cell = jobs, inputs, cell
        self.seed, self.device, self.minlen = seed, device, minlen
        self.tblouts = tblouts
        self._memo: dict = {}

    def once(self, key, make):
        """What <make>() gives, made the first time <key> is asked for."""
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def samples(self) -> tuple[list, list]:
        return self.once("samples", lambda: samples(
            self.jobs, self.cell, self.seed))

    def fs_samples(self) -> tuple[list, list]:
        return self.once("fs_samples", lambda: fs_samples(
            self.jobs, self.cell, self.seed))

    def reference(self, dtype=torch.float64, fs: bool = False) -> Reference:
        return self.once(("ref", dtype, fs), lambda: Reference(
            self.inputs.query.read_text(), self.device, dtype, fs))


def load(root: Path, names) -> dict:
    """{name: module} of the check numbers <names>
    (``perfbench/checks/<name>.py``)."""
    out = {}
    for name in names:
        path = root / "perfbench" / "checks" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_check_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def _fed(mod, ctx) -> bool:
    """Whether a stage of <mod>'s gave an item, or it reads none."""
    st = getattr(mod, "ITEMS", ())
    return not st or any(j.items[s] for j in ctx.jobs for s in st)


def check(numbers: dict, ctx: Context) -> dict:
    """{number: value} of <numbers> ({name: module}) over the window."""
    return {k: mod.value(ctx) if _fed(mod, ctx) else INF
            for k, mod in numbers.items()}


def control(numbers: dict, ctx: Context) -> dict:
    """{number: the control's reading} of those of <numbers> that have
    a control."""
    return {k: mod.control(ctx) if _fed(mod, ctx) else INF
            for k, mod in numbers.items() if hasattr(mod, "control")}


def decide(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, {number: {"value", "limit"}}): every job ran and every
    number is within its limit."""
    correct = failed == 0 and all(numbers[k] <= limits[k] for k in limits)
    return bool(correct), {k: {"value": numbers[k], "limit": limits[k]}
                           for k in limits}
