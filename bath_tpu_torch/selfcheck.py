"""Self-check entry points of bath_tpu_torch: a compile-and-launch check
of the flagship kernel, and a multi-device dry run of the sharded step
and of the production cascade.  The twin of the repository's
``__graft_entry__.py``, which checks the JAX package the same way.

``entry(device="cuda")`` returns ``(fn, args)``: ``fn(dsq, lens)`` runs
the fs3-Forward gate (``ops/fs3.py``, ``csrc/fs3_parser.cu``
``bt_fs3_parser``) of a seeded model of AMP_N's length (M = 134, the JAX
package's flagship) over ``args``, a seeded batch of 8 DNA windows of
384 nt.  On a CUDA device it launches the kernel; ``device="cpu"`` runs
its plain version.

``dryrun_multichip(n, device="cuda")``:

- the data-parallel gate step J5 (``parallel/mesh.py``
  ``make_pipeline_step``) over n devices: the first n cards
  (``mesh_devices``), or n shares of one card where the machine has
  fewer, or n shares of the CPU; its counters must equal the batch's
  residues and the positive gate scores (b (La + Ln) on the default
  batch of full-length items), and its outputs those of the step on one
  device, bit for bit;
- then ``bathsearch.run`` over the same devices in four modes, standard,
  ``--fs``, ``--splice`` and a multi-HMM query file, on small seeded
  fixtures: each mode's ``--backend numpy`` run, its run on one device
  and its run over the mesh print the same bytes (``-o`` without its
  CPU-time lines, the tables without their run lines), and every stage
  of the mesh run that had items gave some to every share.

Nothing falls back: with ``device="cuda"`` and no card, both raise.
``python -m bath_tpu_torch.selfcheck [n] [--device cpu]`` runs both.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile

import numpy as np
import torch

ENTRY_M = 134               # AMP_N's length, the JAX package's flagship
ENTRY_B, ENTRY_L = 8, 384   # the windows of __graft_entry__.entry
STEP_LA, STEP_LN = 64, 96   # the step's amino and DNA lengths a share
RUN_LINES = ("# Option settings:", "# Current dir:", "# Date:")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the self-check launches the "
                           "port's kernels on a card; device='cpu' runs "
                           "their plain versions")
    return dev


def flagship():
    """(search profile, fs3 profile) of the seeded model of ENTRY_M
    positions, built for frameshift search."""
    from . import fixtures
    hmm, _ = fixtures.make_query(ENTRY_M, np.random.default_rng(1),
                                 calibrate=False, fs=True)
    return fixtures.search_profile(hmm), fixtures.fs_search_profile(hmm)


def entry(device="cuda"):
    """(fn, example args): the fs3 gate of the flagship model over a
    seeded batch of ENTRY_B windows of ENTRY_L nt on <device>."""
    from .ops import fs3
    dev = _device(device)
    _, om3 = flagship()
    p = fs3.fs3_params(om3, dev)

    def fn(dsq, lens):
        return fs3.fs3_score(dsq, lens, p, nj=1.0)

    rng = np.random.default_rng(0)
    dsq = torch.from_numpy(rng.integers(0, 4, (ENTRY_B, ENTRY_L))
                           .astype(np.int8)).to(dev)
    lens = torch.full((ENTRY_B,), ENTRY_L, dtype=torch.int32, device=dev)
    return fn, (dsq, lens)


def mesh_of(n: int, device="cuda") -> list:
    """n devices: the first n cards where the machine has them, else n
    shares of the first card; on the CPU, n shares of it."""
    from .parallel.mesh import mesh_devices
    dev = _device(device)
    if dev.type == "cpu":
        return [dev] * n
    if torch.cuda.device_count() >= n:
        return mesh_devices(n, "cuda")
    return [torch.device("cuda", dev.index or 0)] * n


def step_batch(n: int, om):
    """The default step batch: 2n full-length amino ORFs of STEP_LA and
    DNA windows of STEP_LN, seeded, and every ORF's J->B byte."""
    b = 2 * n
    rng = np.random.default_rng(1)
    return (rng.integers(0, 20, (b, STEP_LA)).astype(np.int8),
            np.full(b, STEP_LA, np.int32),
            rng.integers(0, 4, (b, STEP_LN)).astype(np.int8),
            np.full(b, STEP_LN, np.int32), np.full(b, om.tjb_b, np.int32))


def check_step(devices: list, params: tuple, batch: tuple) -> tuple:
    """The step over <devices> on <batch> against the step on the first
    device alone: bit for bit, and counters of the batch's residues and
    positive gate scores.  Returns (outputs, launches of each kernel
    wrapper in the sharded step: its count set to 0 just before the
    step and read just after)."""
    from .ops import fs3, fwd, ssv
    from .parallel import mesh
    wrappers = {"fwd_parser": fwd.fwd_score, "msv_filter": ssv.msv_ssv,
                "fs3_parser": fs3.fs3_score}
    for f in wrappers.values():
        f.launches = 0
    out = mesh.make_pipeline_step(devices, *params)(*batch)
    launches = {k: f.launches for k, f in wrappers.items()}
    one = mesh.make_pipeline_step(devices[:1], *params)(*batch)
    for name, a, b in zip(("fwd", "msv", "fs3", "counters"), out, one):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"the step's {name} over {len(devices)} "
                                 "devices differs from one device's")
    nres = int(np.sum(batch[1], dtype=np.int64)
               + np.sum(batch[3], dtype=np.int64))
    npass = int((out[0] > 0).sum() + (out[2] > 0).sum())
    if out[3].tolist() != [nres, npass]:
        raise AssertionError(f"the step counts {out[3].tolist()}, not "
                             f"{[nres, npass]}")
    return out, launches


def cascade_fixtures(directory=None) -> dict:
    """The dry run's seeded fixtures, of the sizes of the mesh CLI's
    tests (written once a directory)."""
    from . import fixtures
    return {
        "standard": fixtures.write_fixture(100, 60_000, 3, 5,
                                           directory=directory),
        "fs": fixtures.write_fixture(100, 60_000, 3, 5, directory=directory,
                                     fs=True, n_frameshift=1),
        "splice": fixtures.write_splice_fixture(120, 40_000, 3, 4,
                                                directory=directory),
        "multiquery": fixtures.write_multi_fixture(
            [60, 40, 70], 60_000, [0, 2], 1, 4, directory=directory),
    }


# the four modes of __graft_entry__'s production-cascade check: (fixture,
# options)
MODES = {
    "standard": ("standard", []),
    "fs": ("fs", ["--fs", "--block_length", "20000"]),
    "splice": ("splice", ["--splice", "--max_intron", "5000"]),
    "multiquery": ("multiquery", []),
}


def masked_outputs(paths) -> tuple:
    """A search's outputs (-o, then its tables) without their
    run-dependent lines: -o without its CPU-time lines, the tables
    without their run lines; None for a file the search did not
    write."""
    texts = []
    for i, p in enumerate(paths):
        if not os.path.exists(p):
            texts.append(None)
            continue
        with open(p) as f:
            text = f.read()
        texts.append(re.sub(r"# (CPU time|Mc/sec):.*", "", text) if i == 0
                     else "".join(ln for ln in text.splitlines(True)
                                  if not ln.startswith(RUN_LINES)))
    return tuple(texts)


def check_cascade(devices: list, work, fixture_dir=None) -> dict:
    """Each of MODES through ``bathsearch.run``: ``--backend numpy``,
    ``--backend torch`` on the first device, and over <devices> (``--mesh
    n`` where they are distinct cards, else ``run``'s devices); raises
    unless the three print the same bytes and every stage of the mesh
    run that had as many items as shares gave each share some.  Returns
    {mode: the mesh run's items a share and stage}."""
    from .cli import bathsearch
    fxs = cascade_fixtures(fixture_dir)
    n = len(devices)
    dev = devices[0]
    distinct = len(set(devices)) == n and dev.type == "cuda"
    runs = {"numpy": (["--backend", "numpy"], None),
            "one": (["--backend", "torch", "--device", str(dev)], None),
            "mesh": (["--backend", "torch", "--device", "cuda" if distinct
                      else str(dev)] + (["--mesh", str(n)] if distinct
                                        else []),
                     None if distinct else devices)}
    items = {}
    for mode, (name, opts) in MODES.items():
        fx = fxs[name]
        outs, st = {}, {}
        for run, (backend, devs) in runs.items():
            paths = [os.path.join(str(work), f"{mode}_{run}.{x}")
                     for x in ("out", "tbl")]
            st[run] = {}
            rc = bathsearch.run([*backend, *opts, "-o", paths[0], "--tblout",
                                 paths[1], fx.hmm_path, fx.fasta_path],
                                stats=st[run], devices=devs)
            if rc != 0:
                raise AssertionError(f"bathsearch {mode} ({run}) exited {rc}")
            outs[run] = masked_outputs(paths)
        if not outs["mesh"] == outs["one"] == outs["numpy"]:
            raise AssertionError(f"the {mode} cascade over {n} devices "
                                 "differs from one device's or numpy's")
        shares = st["mesh"].get("mesh_items") or {}
        bad = {k: v for k, v in shares.items()
               if len(v) != n or (sum(v) >= n and min(v) == 0)}
        if n > 1 and (not shares or bad):
            raise AssertionError(f"{mode}: a share of the mesh got no "
                                 f"items: {shares}")
        items[mode] = shares
        print(f"dryrun production cascade [{mode}]: over {n} devices "
              "byte-identical to one device and to numpy", flush=True)
    return items


def dryrun_multichip(n: int, device="cuda", step=None,
                     fixture_dir=None) -> dict:
    """The sharded step over ``mesh_of(n, device)`` (on <step>, a pair of
    (parameters, batch), where given, else on the flagship model and
    ``step_batch``), then the production cascade in the four modes over
    the same devices.  Returns the devices, the step's outputs and its
    launches, and the mesh runs' items a share."""
    from .ops import fs3, fwd, ssv
    devices = mesh_of(n, device)
    if step is None:
        om, om3 = flagship()
        params = (fwd.fwd_params(om, devices[0]),
                  ssv.msv_params(om, devices[0]),
                  fs3.fs3_params(om3, devices[0]))
        step = (params, step_batch(n, om))
    out, launches = check_step(devices, *step)
    print(f"dryrun_multichip({n}): ok; counters={out[3].tolist()}; sharded "
          "== single-device", flush=True)
    with tempfile.TemporaryDirectory() as td:
        items = check_cascade(devices, td, fixture_dir)
    return {"devices": [str(d) for d in devices], "step": out,
            "step_launches": launches, "mesh_items": items}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bath_tpu_torch.selfcheck",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    print("entry ok:", fn(*fargs)[:4].cpu().numpy(), flush=True)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
