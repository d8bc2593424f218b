"""Multi-process data parallelism for bathsearch (``--hosts N``).

Counterpart of ``bath_tpu/parallel/hosts.py``.  The reference's
parallel unit is a pthread worker pulling target blocks from a work
queue, with per-worker tophits/stat merges at the end of the scan (ref:
bathsearch.c thread_loop :1118-1291, :887-892; p7_pipeline.c
p7_pipeline_Merge :735).  Across processes, here as there:

  * every process streams the SAME window sequence (host-side reading
    is cheap and keeps nres/nseqs/target-length bookkeeping global and
    identical everywhere: E-values come from the global residue count
    after the scan, bathsearch.c:869-884);
  * each process runs the pipeline only for windows with
    tid % nprocs == proc_id, on its own devices;
  * per-window results (hits, hit windows) and the counters are
    serialized and all-gathered, then every process rebuilds the
    global result in window-stream order, so output bytes are identical
    to the single-process run for any process count (the reference's
    thread-count invariance, i2-search-variation.sh).

The processes form a ``torch.distributed`` group on the gloo backend:
every payload is pickled host bytes, so no device collective is needed,
and the group runs wherever the processes can reach the coordinator's
TCP port.  The gather is the reference's two rounds: the payloads'
lengths, then the payloads padded to the longest as uint8 tensors.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket

import torch
import torch.distributed as dist

LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")
# the longest a rank waits for the group to form and for the other
# ranks at a gather (BATH_HOSTS_TIMEOUT_S): a rank that failed then
# fails its peers this long after, not after gloo's 30 minutes
TIMEOUT_S = 600.0


def init_distributed(coordinator: str, nprocs: int, proc_id: int,
                     timeout_s: float | None = None) -> None:
    """Join the process group of <nprocs> processes as rank <proc_id>;
    <coordinator>: 'host:port' where rank 0 listens.  Raises when the
    group cannot form within <timeout_s> (default BATH_HOSTS_TIMEOUT_S
    or TIMEOUT_S), which also bounds every later wait for a peer.  With
    a coordinator on this machine the group's sockets use the loopback
    device (GLOO_SOCKET_IFNAME, unless set)."""
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    if host in LOCAL_HOSTS and "lo" in {n for _, n in socket.if_nameindex()}:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if timeout_s is None:
        timeout_s = float(os.environ.get("BATH_HOSTS_TIMEOUT_S", TIMEOUT_S))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=nprocs, rank=proc_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    """The group's world size, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def allgather_bytes(payload: bytes) -> list[bytes]:
    """All-gather one bytes payload per process; returns the list
    indexed by process id, identical on every process."""
    n = process_count()
    if n == 1:
        return [payload]
    ln = torch.tensor([len(payload)], dtype=torch.int64)
    lens = [torch.zeros_like(ln) for _ in range(n)]
    dist.all_gather(lens, ln)
    lens = [int(v) for v in lens]
    mx = max(lens)
    buf = torch.zeros(mx, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    gathered = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(gathered, buf)
    return [g[:k].numpy().tobytes() for g, k in zip(gathered, lens)]


def merge_results(parts: list[list]) -> list:
    """Combine per-process result lists of (tid, hits, hit_windows,
    counter_deltas) tuples into global window-stream order (sorted by
    tid) — so downstream stable sorts see exactly the serial path's
    hit ordering (ref: p7_tophits_Merge preserving worker block
    order).  tids are unique across ranks (windows are sharded
    tid % nprocs), so the result is independent of rank count and
    rank arrival order."""
    combined = []
    for p in parts:
        combined.extend(p)
    combined.sort(key=lambda t: t[0])
    return combined


def allgather_results(results: list) -> list:
    """All-gather a per-process list of (tid, hits, hit_windows,
    counter_deltas) tuples and return the merged global list (hit
    serialization for the cross-host merge: pickled tuples — hits
    carry ragged alignment displays, so the fixed-shape discipline
    lives in allgather_bytes' padded transport, not the record)."""
    mine = pickle.dumps(results, protocol=pickle.HIGHEST_PROTOCOL)
    parts = allgather_bytes(mine)
    return merge_results([pickle.loads(p) for p in parts])


def psum_counters(deltas: dict) -> dict:
    """Reduce pipeline bean counters across processes (ref:
    p7_pipeline_Merge :735).  On the gather path, so the sums are exact
    Python integers."""
    if process_count() == 1:
        return dict(deltas)
    parts = allgather_bytes(pickle.dumps(deltas))
    out = {k: 0 for k in deltas}
    for p in parts:
        for k, v in pickle.loads(p).items():
            out[k] = out.get(k, 0) + v
    return out


def ranks_from_args(args) -> tuple[int, int, str | None]:
    """CLI/env plumbing: (nprocs, proc_id, coordinator) of this
    process, without joining anything; (1, 0, None) without --hosts.
    Env fallbacks allow launchers to avoid per-rank argv edits
    (BATH_NPROCS/BATH_PROC_ID/BATH_COORDINATOR)."""
    nprocs = int(getattr(args, "hosts", 0)
                 or os.environ.get("BATH_NPROCS", 1))
    if nprocs <= 1:
        return 1, 0, None
    proc_id = int(getattr(args, "host_id", -1)
                  if getattr(args, "host_id", -1) >= 0
                  else os.environ.get("BATH_PROC_ID", 0))
    coord = (getattr(args, "coordinator", None)
             or os.environ.get("BATH_COORDINATOR",
                               "localhost:9377"))
    return nprocs, proc_id, coord


def maybe_init_from_args(args) -> tuple[int, int]:
    """Returns (nprocs, proc_id) of ``ranks_from_args``; joins the
    group when nprocs > 1."""
    nprocs, proc_id, coord = ranks_from_args(args)
    if nprocs > 1:
        init_distributed(coord, nprocs, proc_id)
    return nprocs, proc_id


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
