"""Data parallelism over the GPUs of one process: the sharded gate step
of the search pipeline.

Counterpart of ``bath_tpu/parallel/mesh.py`` (``make_mesh``,
``shard_batch``, ``replicate``, ``make_pipeline_step``).  The reference
parallelises with a pthread work queue over target blocks and merges
per-worker statistics afterwards (ref: bathsearch.c thread_loop :1118,
p7_pipeline_Merge).  The JAX step replicates the profiles on every chip
of a mesh, shards the batch's leading axis over it with ``shard_map``
and reduces two pipeline counters with ``psum``.  Here a mesh is a
list of torch devices: each share of the batch runs the three ported
single-model kernels (the Forward gate ``fwd_parser.cu``, MSV
``msv_filter.cu``, the fs3 gate ``fs3_parser.cu``) on its own device,
and the loader launches each on its tensors' device and that device's
stream.  The wrappers read their inputs back from the device to check
them before they launch, which waits for that device's earlier work
only; so the step goes stage by stage, each stage out to every share
before the next stage's checks: a share's check then waits for its own
device's previous stage, while the other devices run theirs.  The
outputs are gathered in shard order on the mesh's first device; the
counters are counted per share and summed on the host in int64, the
exact integer sum of p7_pipeline_Merge (ref: p7_pipeline.c :1583).  One
process drives every device: there is no ``torch.distributed`` here.

On ``make_mesh(n, "cpu")`` the n shares run in turn on the CPU through
the kernels' plain versions, which the tests use.

The search's ``--mesh N`` takes a process's devices from
``mesh_devices`` and splits each stage of ``TorchCascade`` and
``PackedGates`` into shares of any size (``deal``); the reference pads
each batch to a bucket that its mesh divides, which a GPU needs not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fs3 import fs3_score
from ..ops.fwd import ProfileTensors, fwd_score
from ..ops.ssv import MSVParams, msv_post, msv_ssv


def make_mesh(n: int, device: str = "cuda") -> list[torch.device]:
    """n devices: cuda:0..n-1 (raises when there are fewer), or the one
    CPU device n times."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"need {n} CUDA devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_devices(n: int, device="cuda", rank: int = 0) -> list:
    """The n devices of one process of ``--mesh n`` (n >= 1): for
    ``cuda`` without an index, cuda:(rank * n + i) % count for i in
    0..n-1, so that the ranks of one machine take disjoint cards where
    there are enough; for ``cuda:K``, cuda:K..K+n-1; for ``cpu``, the
    CPU n times.  Raises when the machine has fewer than n cards, or
    than K + n."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    first = dev.index if dev.index is not None else 0
    if have < first + n:
        raise ValueError(f"--mesh {n} from {dev} needs {first + n} CUDA "
                         f"devices, have {have}")
    if dev.index is None:
        return [torch.device("cuda", (rank * n + i) % have)
                for i in range(n)]
    return [torch.device("cuda", first + i) for i in range(n)]


def deal(lens, n: int, turn: int = 0) -> list[np.ndarray]:
    """The items' indices in n shares, each ascending: the items sorted
    by length and dealt round the shares, the first to share <turn> % n,
    so that every share gets the same mix of lengths."""
    order = np.argsort(np.asarray(lens, np.int64), kind="stable")
    return [np.sort(order[(s - turn) % n::n]) for s in range(n)]


class Shares:
    """The shares of a stage call over the devices of ``--mesh N``
    (``TorchCascade``, ``PackedGates``).  Calling it with a stage's key
    and its items' lengths gives [(device, items)]: on one device every
    item (items None); over several each non-empty share's item indices,
    ascending (``deal``), the first share turning with each call of the
    stage so that small calls reach every device.  Each share's items add to
    ``stats["mesh_items"][key]``, a list of one count a device."""

    def __init__(self, devices: list, stats: dict):
        self.devices = devices
        self.turns: dict = {}
        self.counts = stats.setdefault("mesh_items", {}) \
            if len(devices) > 1 else None

    def __call__(self, key: str, lens) -> list:
        n = len(self.devices)
        if n == 1:
            return [(self.devices[0], None)]
        turn = self.turns.get(key, 0)
        self.turns[key] = turn + 1
        parts = deal(lens, n, turn)
        counts = self.counts.setdefault(key, [0] * n)
        for s, items in enumerate(parts):
            counts[s] += len(items)
        return [(d, items) for d, items in zip(self.devices, parts)
                if len(items)]


def shard_batch(mesh: list, arr) -> list[torch.Tensor]:
    """<arr> cut along its leading axis into len(mesh) contiguous
    shares, share s on mesh[s]; the length must divide evenly, as a
    ``P('dp')`` sharding requires."""
    arr = torch.as_tensor(arr)
    n = len(mesh)
    if arr.shape[0] % n:
        raise ValueError(f"a leading axis of {arr.shape[0]} does not split "
                         f"into {n} equal shares")
    return [s.contiguous().to(dev)
            for s, dev in zip(torch.chunk(arr, n), mesh)]


def replicate(mesh: list, p) -> list:
    """One copy of the profile parameters <p> (``ProfileTensors`` or
    ``MSVParams``) on each device of <mesh>, made once per device."""
    copies: dict = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = p.to(dev) if isinstance(p, MSVParams) \
                else ProfileTensors(p.rfv.to(dev), p.tr.to(dev))
    return [copies[dev] for dev in mesh]


def msv_nats(out_int: torch.Tensor, out_inf: torch.Tensor,
             p: MSVParams) -> torch.Tensor:
    """The MSV score [B] f32 in nats from ``msv_post``'s integers,
    ``(out_int - base) / scale - 3``, inf on overflow, with the JAX
    step's rounding: XLA compiles its division by the step's constant
    scale into a product with the f32 reciprocal, fused with the - 3
    into one rounding.  Here that product and sum are exact in f64 (the
    integers need 10 bits, the reciprocal 24), then rounded once."""
    inv = float(np.float32(1.0) / np.float32(p.scale))
    sc = ((out_int.to(torch.float64) - p.base) * inv - 3.0).to(torch.float32)
    return torch.where(out_inf, torch.full_like(sc, float("inf")), sc)


def make_pipeline_step(mesh: list, fwd_params: ProfileTensors,
                       msv_params: MSVParams, fs3_params: ProfileTensors):
    """The data-parallel gate step over <mesh>:
    ``step(adsq, alens, ndsq, nlens, tjb) -> (fwd, msv, fs3 [B] f32,
    counters [2] int64)``.

    ``adsq [B, La]`` are amino ORFs (padded; ``alens`` their lengths),
    ``ndsq [B, Ln]`` DNA windows (``nlens``), ``tjb [B]`` each ORF's
    J->B byte; the leading axis is split into len(mesh) shares.  Per
    item: the Forward-gate score, the MSV score and the fs3-gate score
    (nats); ``counters = [nres, npass]`` with nres = the sum of all
    lengths and npass = the count of positive Forward and fs3 scores
    over the whole batch (the JAX step's ``psum``)."""
    fps, mps, p3s = (replicate(mesh, p)
                     for p in (fwd_params, msv_params, fs3_params))

    def step(adsq, alens, ndsq, nlens, tjb):
        shares = [shard_batch(mesh, torch.as_tensor(a).to(dt))
                  for a, dt in ((adsq, torch.int8), (alens, torch.int32),
                                (ndsq, torch.int8), (nlens, torch.int32),
                                (tjb, torch.int32))]
        a, al, nd, nl, tj = shares
        n = range(len(mesh))
        # stage by stage: a stage goes out to every share before any
        # share's next stage is checked against its device
        fwd = [fwd_score(a[s], al[s], fps[s]) for s in n]
        offs = [torch.arange(len(a[s]), dtype=torch.int64,
                             device=a[s].device) * a[s].shape[1] for s in n]
        raw = [msv_ssv(a[s].reshape(-1), offs[s], al[s], tj[s], mps[s])
               for s in n]
        fs3 = [fs3_score(nd[s], nl[s], p3s[s]) for s in n]
        msv = [msv_nats(*msv_post(*raw[s], tj[s], mps[s]), mps[s])
               for s in n]
        counts = [torch.stack([
            al[s].sum(dtype=torch.int64) + nl[s].sum(dtype=torch.int64),
            (fwd[s] > 0).sum() + (fs3[s] > 0).sum()]) for s in n]
        home = mesh[0]
        total = np.sum([c.cpu().numpy() for c in counts], axis=0,
                       dtype=np.int64)
        return (*(torch.cat([t.to(home) for t in ts])
                  for ts in (fwd, msv, fs3)), torch.from_numpy(total))

    return step
