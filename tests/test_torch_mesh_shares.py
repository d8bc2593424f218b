"""The device stages of ``TorchCascade`` and ``PackedGates`` over the
shares of ``--mesh N``, on a mesh that repeats the CPU.

- Each stage of the cascade (the Forward gate, decoding, the fs3 gate,
  fs3 decoding, MSV, the SSV capture, the ViterbiFilter and its capture)
  and of the packed multi-query gates, over 2 and 3 shares, is bit for
  bit its result on one share: the kernels' plain versions score each
  item alone, whatever its batch (a decoded item's rows up to its n + 1;
  past them a row holds its batch's padding).  Three shares deal the
  16 DNA windows unequally.
- The device list of ``--mesh`` (``mesh_devices``) and the shares
  (``deal``, ``repack``); a mesh past the cards raises, and so
  does ``bathsearch --mesh 2`` without one.
"""

import os

import numpy as np
import pytest
import torch

from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.device_pipeline import TorchCascade, repack
from bath_tpu_torch.gencode import GeneticCode
from bath_tpu_torch.hmmfile import read_hmm, read_hmms
from bath_tpu_torch.multiquery import PackedGates, QState
from bath_tpu_torch.ops.ssv import pack_stream
from bath_tpu_torch.parallel import mesh
from bath_tpu_torch.sequence import Sequence
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fxs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shares")
    return {
        "standard": fixtures.write_fixture(100, 60_000, 3, 5, directory=d),
        "fs": fixtures.write_fixture(100, 60_000, 3, 5, directory=d,
                                     fs=True, n_frameshift=1),
        "multi_fs": fixtures.write_multi_fixture([60, 40, 70], 60_000,
                                                 [0, 2], 1, 4, directory=d,
                                                 fs=True),
    }


# ---------------------------------------------------------------------
# Each stage over 2 and 3 shares of the CPU, bit for bit one share
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def items(fxs):
    """Amino items (genome ORFs, the homologs' hot ORFs, short and
    missing-data ones) and DNA windows (some over embedded copies)."""
    fx = fxs["fs"]
    aa = [c for c in fixtures.filter_cases(fx, 60, 7) if len(c)]
    rng = np.random.default_rng(3)
    nt = fixtures.sample_windows(fx.fasta_path, 9, 600, 4)
    seq = np.concatenate(nt)
    nt += [np.asarray(seq[s:s + n], np.int8)
           for s, n in zip(rng.integers(0, len(seq) - 1300, 7),
                           (900, 40, 3, 301, 450, 77, 1234))]
    return aa, nt


def cascade(fx, n, stats=None):
    hmm = read_hmm(fx.hmm_path)
    return TorchCascade(fixtures.search_profile(hmm),
                        fixtures.fs_search_profile(hmm), device="cpu",
                        stats=stats, devices=[CPU] * n)


def cascade_results(cas, aa, nt):
    lens = np.array([len(s) for s in aa])
    nulls = np.linspace(-2.0, 1.0, len(aa))
    flat, offs, ln = pack_stream(aa[::-1])
    seqs = [Sequence(name="o", dsq=s) for s in aa]
    wins = [Sequence(name="w", dsq=s) for s in nt]
    return {
        "fwd_scores": cas.fwd_scores(aa, lens),
        "domdec": decoded(cas.domdec(seqs), aa),
        "fs3_scores": cas.fs3_scores(nt, np.array([len(s) for s in nt])),
        "fs3_domdec": decoded(cas.fs3_domdec(wins, 100.0 / 103.0), nt),
        "msv_scores": cas.msv_scores(aa, lens),
        # a stream whose items are not in stream order
        "msv_scores_stream": cas.msv_scores(None, ln[::-1], flat=flat,
                                            offs=offs[::-1]),
        "ssv_captures": cas.ssv_captures(aa, lens, nulls, 0.5),
        "vit_scores": cas.vit_scores(aa, lens),
        "vit_captures": cas.vit_captures(aa, lens, nulls, 0.5),
    }


def decoded(res, seqs):
    """(btot, etot, mocc, ok) with each item's rows cut to its n + 1:
    past them a row holds its batch's padding."""
    return [[r[:len(s) + 1] for r, s in zip(rows, seqs)]
            for rows in res[:3]] + [res[3]]


def same(a, b) -> bool:
    """Bit for bit, through tuples, lists, dicts and arrays."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    return a == b or (a != a and b != b)


@pytest.fixture(scope="module")
def one_share(fxs, items):
    return cascade_results(cascade(fxs["fs"], 1), *items)


@pytest.mark.parametrize("n", [2, 3])
def test_cascade_stages_over_shares_are_one_share(fxs, items, one_share, n):
    stats = {}
    got = cascade_results(cascade(fxs["fs"], n, stats), *items)
    for name, want in one_share.items():
        assert same(got[name], want), name
    # not vacuous: captures with events, scores that pass
    assert any(nv for nv, _ in one_share["ssv_captures"].values())
    assert any(len(r) for r, _ in one_share["vit_captures"].values())
    assert (one_share["fwd_scores"] > 0).any()
    aa, nt = items
    for key in ("fwd", "domdec", "msv", "ssvcap", "vit", "vitcap"):
        counts = stats["mesh_items"][key]
        assert len(counts) == n and min(counts) > 0
    assert sum(stats["mesh_items"]["msv"]) == 2 * len(aa)
    assert sum(stats["mesh_items"]["fs3"]) == len(nt)
    if n == 3:
        assert len(set(stats["mesh_items"]["fs3"])) > 1


@pytest.fixture(scope="module")
def queries(fxs):
    fx = fxs["multi_fs"]
    hmms = list(read_hmms(fx.hmm_path))
    args = bathsearch.build_parser().parse_args(
        ["--fs", fx.hmm_path, fx.fasta_path])
    gcode = GeneticCode.create(1)
    gcode.set_initiator_any()
    for h in hmms:
        bathsearch.check_query(h, args)
    return [QState(h, args, gcode, qi) for qi, h in enumerate(hmms)]


def packed_results(queries, aa, nt, n):
    stats = {}
    pg = PackedGates(queries, device="cpu", stats=stats, devices=[CPU] * n)
    a = [(queries[i % len(queries)], d, len(d)) for i, d in enumerate(aa)]
    w = [(queries[i % len(queries)], d, len(d)) for i, d in enumerate(nt)]
    return {"fwd": pg.fwd_scores(a),
            "domdec": [(*(r[:n + 1] for r in p[:3]), p[3])
                       for p, (_, _, n) in zip(pg.domdec(a), a)],
            "fs3": pg.fs3_scores(w),
            "fs3domdec": [(*(r[:n + 1] for r in p[:3]), p[3]) for p, (_, _, n)
                          in zip(pg.fs3_domdec(w, 100.0 / 103.0), w)]}, stats


@pytest.fixture(scope="module")
def packed_items(items):
    aa, nt = items
    return aa[::5], nt[::2]


@pytest.fixture(scope="module")
def packed_one_share(queries, packed_items):
    return packed_results(queries, *packed_items, 1)[0]


@pytest.mark.parametrize("n", [2, 3])
def test_packed_stages_over_shares_are_one_share(queries, packed_items,
                                                 packed_one_share, n):
    want = packed_one_share
    got, stats = packed_results(queries, *packed_items, n)
    for name in want:
        assert same(got[name], want[name]), name
        counts = stats["mesh_items"][name]
        assert len(counts) == n and min(counts) > 0
        assert sum(counts) == stats[f"{name}_items"]


# ---------------------------------------------------------------------
# The devices and the shares
# ---------------------------------------------------------------------
@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.parametrize("n,device,rank,want", [
    (2, "cuda", 0, [0, 1]), (2, "cuda", 1, [2, 3]), (3, "cuda", 1, [3, 0, 1]),
    (1, "cuda", 5, [1]), (2, "cuda:1", 1, [1, 2]), (4, "cuda:0", 0,
                                                    [0, 1, 2, 3])])
def test_mesh_devices_of_a_rank(four_cards, n, device, rank, want):
    assert mesh.mesh_devices(n, device, rank) == [torch.device("cuda", i)
                                                  for i in want]


@pytest.mark.parametrize("n,device", [(5, "cuda"), (2, "cuda:3")])
def test_a_mesh_past_the_cards_raises(four_cards, n, device):
    with pytest.raises(ValueError, match="CUDA devices, have 4"):
        mesh.mesh_devices(n, device)


def test_mesh_without_cards_raises(fxs):
    assert mesh.mesh_devices(3, "cpu") == [CPU] * 3
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="have 0"):
        mesh.mesh_devices(2, "cuda")
    fx = fxs["standard"]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bathsearch.run(["--mesh", "2", "-o", os.devnull, fx.hmm_path,
                        fx.fasta_path])


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_deal_and_cut_cover_every_item_once(n):
    lens = np.random.default_rng(n).integers(0, 500, 23)
    for turn in range(n + 1):
        dealt = mesh.deal(lens, n, turn)
        assert sorted(np.concatenate(dealt).tolist()) == list(range(23))
        assert max(map(len, dealt)) - min(map(len, dealt)) <= 1
        assert all(np.all(np.diff(d) > 0) for d in dealt)
        # each share gets the same mix of lengths: the items in order
        # of length go round the shares, the first to share <turn>
        order = np.argsort(lens, kind="stable")
        assert all(order[k] in dealt[(k + turn) % n] for k in range(23))
    # one item: each call's first share turns
    assert [next(i for i, d in enumerate(mesh.deal([7], n, t)) if len(d))
            for t in range(n)] == list(range(n))


def test_repack_gives_each_item_its_residues():
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 20, k).astype(np.int8) for k in (4, 0, 9, 1)]
    flat, offs, lens = pack_stream(seqs)
    sub = repack(flat, offs[[3, 0, 2]], lens[[3, 0, 2]])
    for r, s in enumerate((seqs[3], seqs[0], seqs[2])):
        assert np.array_equal(sub[0][sub[1][r]:sub[1][r] + sub[2][r]], s)
    assert sub[1].tolist() == [0, 1, 5]
