"""The card's own microbenchmarks: the four questions that
``scripts/ubench_vpu.py`` asks of the TPU, asked of the H100.

    python -m bath_tpu_torch.ubench [chain|onehot|overlap|scalars|all]

Counterpart of the script's four Pallas kernels, with their functions,
types, outputs and shapes (``Mt, Bt = 136, 1024``, ``REPS = 512``):

- ``chain`` (``bench_chain``): ``REPS`` x {``nops`` x ``v = v*v + 0.25``;
  ``v *= 0.5``} on an f32 ``[Mt, Bt]`` tile, ``nops`` 4 and 16: the
  latency and rate of a dependent f32 chain;
- ``onehot`` (``bench_onehot``): ``acc[m, b] = sum_i t[m, idx[i, b]]``
  with ``t [Mt, n]`` bf16, ``idx [REPS, Bt]`` int32, ``n`` 17, 65 and
  257 (the fs3 gate's codon tables): the table read by index
  (``onehot_gather``, how the ported gates read emissions: t^T's padded
  image in shared memory, 16 threads a column) against the one-hot
  product on the tensor cores (``onehot_mma``, ``wgmma``, how the TPU
  gates read them; ``n`` up to 272 there); an index outside [0, n)
  adds nothing (``onehot_in_range`` gives ``onehot_ref`` such a sum);
- ``overlap`` (``bench_overlap``): per step, a 12-op chain on ``acc
  [Mt, Bt]`` f32 and ``yacc [2Mt, Bt] <- bf16((1e-3 g @ yacc)^2 +
  0.25)`` with ``g [2Mt, 2Mt]`` bf16, modes chain, dot and both: does
  the SM overlap a tensor-core product (``wgmma``) with an independent
  FMA chain in another warpgroup;
- ``scalars`` (``bench_scalars``): a ``[32, Bt]`` scratch from 0.3,
  rows 0-7 one by one and the block of rows 8-15 stepped ``v*v + 0.25``
  per step, row 0 out; the input ``x`` is read by nothing, as in the
  script.

Each case has its plain PyTorch version (``*_ref``) and a wrapper with a
``.launches`` count: a CUDA tensor launches the hand-written kernel of
``ops/kernels/csrc/ubench.cu`` or raises, a CPU tensor runs the plain
version.  ``drive`` times the wrappers by CUDA events after one warm-up
call, at the script's shapes and at ``Bt = 4096``, which fills the card
(``[136, 1024]`` is 139 264 threads, about half of its 132 x 2048), and
the chain also on one warp (the latency of a lone chain, what a gate's
row chain runs at).  ``main`` prints the card's name and power limit,
then one JSON line per case.  Without a CUDA device it raises.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

MT, BT, REPS = 136, 1024, 512
BT_FULL = 4096
CHAIN_NOPS = (4, 16)
ONEHOT_N = (17, 65, 257)
OVERLAP_NOPS = 12
OVERLAP_MODES = ("chain", "dot", "both")
CASES = ("chain", "onehot", "overlap", "scalars")

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory, float32 outside the tensor cores, bf16 on the tensor cores.
# chip_smoke.py's bounds use them too.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


# ---------------------------------------------------------------------
# Plain PyTorch versions.  The tests hold them against the script's
# Pallas kernels in interpret mode, and chip_smoke.py holds the CUDA
# kernels against them on the card.  The matrix product of
# ``overlap_ref`` is f32 (no TF32) on bf16 operands, exact products.
# ---------------------------------------------------------------------
def chain_ref(x: torch.Tensor, nops: int, reps: int = REPS) -> torch.Tensor:
    v = x.clone()
    for _ in range(reps):
        for _ in range(nops):
            v = v * v + 0.25
        v = v * 0.5
    return v


def onehot_ref(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """acc [Mt, Bt] f32, summed in step order."""
    tf, cols = t.float(), idx.long()
    acc = torch.zeros(t.shape[0], idx.shape[1], dtype=torch.float32,
                      device=t.device)
    for i in range(idx.shape[0]):
        acc = acc + tf[:, cols[i]]
    return acc


def out_of_range(idx: torch.Tensor, n: int) -> torch.Tensor:
    """<idx> with indices outside [0, n) in it, which the entries skip:
    -1 at every 7th step of every 5th column, n at every 11th step
    (from 3) of every 3rd column (from 2)."""
    idx = idx.clone()
    idx[::7, ::5] = -1
    idx[3::11, 2::3] = n
    return idx


def onehot_in_range(t: torch.Tensor, idx: torch.Tensor) -> tuple:
    """(t', idx') on which ``onehot_ref`` gives the entries' sum of <t>
    and <idx>, where an index outside [0, n) adds nothing: t with a zero
    column n beside it, and each such index pointed at that column
    (adding +0.0 leaves each sum as it was)."""
    Mt, n = t.shape
    oob = (idx < 0) | (idx >= n)
    return (torch.cat([t, t.new_zeros(Mt, 1)], 1),
            torch.where(oob, torch.full_like(idx, n), idx))


def overlap_ref(g: torch.Tensor, x: torch.Tensor, mode: str,
                reps: int = REPS, y0=None) -> torch.Tensor:
    """yacc starts at 0.3, as in the script, or at <y0> [2Mt, Bt]
    bf16."""
    Mt, Bt = x.shape
    acc = x.clone()
    yacc = torch.full((2 * Mt, Bt), 0.3, dtype=torch.bfloat16,
                      device=x.device) if y0 is None else y0.clone()
    gf = g.float()
    for _ in range(reps):
        if mode != "chain":
            y = (gf @ yacc.float()) * 1e-3
            yacc = (y * y + 0.25).to(torch.bfloat16)
        if mode != "dot":
            v = acc
            for _ in range(OVERLAP_NOPS):
                v = v * v + 0.25
            acc = v * 0.5
    return acc + yacc[:Mt].float()


def scalars_ref(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    sp = torch.full((32, x.shape[1]), 0.3, dtype=torch.float32,
                    device=x.device)
    for _ in range(reps):
        for r in range(8):
            sp[r] = sp[r] * sp[r] + 0.25
        sp[8:16] = sp[8:16] * sp[8:16] + 0.25
    return sp[0:1].clone()


# ---------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------
def _check(name: str, t: torch.Tensor, dtype, ndim: int = 2) -> None:
    if t.dim() != ndim or t.dtype != dtype:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def chain(x: torch.Tensor, nops: int, reps: int = REPS) -> torch.Tensor:
    """#7 on ``x [Mt, Bt]`` f32."""
    _check("x", x, torch.float32)
    if nops not in CHAIN_NOPS:
        raise ValueError(f"nops must be one of {CHAIN_NOPS}")
    if x.device.type == "cpu":
        return chain_ref(x, nops, reps)
    from .ops.kernels import loader
    out = loader.launch_ub_chain(x, nops, reps)
    chain.launches += 1
    return out


def _onehot_args(t: torch.Tensor, idx: torch.Tensor) -> None:
    _check("t", t, torch.bfloat16)
    _check("idx", idx, torch.int32)
    if t.device != idx.device:
        raise ValueError(f"t on {t.device}, idx on {idx.device}")


def onehot_gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """#8, the table read by index: acc [Mt, Bt] f32."""
    _onehot_args(t, idx)
    if t.device.type == "cpu":
        return onehot_ref(t, idx)
    from .ops.kernels import loader
    out = loader.launch_ub_onehot(t, idx, mma=False)
    onehot_gather.launches += 1
    return out


def onehot_mma(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """#8, the one-hot product on the tensor cores: acc [Mt, Bt] f32."""
    _onehot_args(t, idx)
    if t.device.type == "cpu":
        return onehot_ref(t, idx)
    from .ops.kernels import loader
    out = loader.launch_ub_onehot(t, idx, mma=True)
    onehot_mma.launches += 1
    return out


def overlap(g: torch.Tensor, x: torch.Tensor, mode: str,
            reps: int = REPS, y0=None) -> torch.Tensor:
    """#9: acc + yacc[:Mt], [Mt, Bt] f32, ``g [2Mt, 2Mt]`` bf16; yacc
    starts at 0.3 (the script's function) or at <y0> [2Mt, Bt] bf16."""
    _check("g", g, torch.bfloat16)
    _check("x", x, torch.float32)
    if mode not in OVERLAP_MODES or g.shape != (2 * x.shape[0],) * 2:
        raise ValueError(f"mode must be one of {OVERLAP_MODES} and g "
                         f"[2Mt, 2Mt]; got {mode!r}, {tuple(g.shape)}")
    if y0 is not None:
        _check("y0", y0, torch.bfloat16)
        if y0.shape != (2 * x.shape[0], x.shape[1]):
            raise ValueError(f"y0 must be [2Mt, Bt], got {tuple(y0.shape)}")
    if x.device.type == "cpu":
        return overlap_ref(g, x, mode, reps, y0)
    from .ops.kernels import loader
    out = loader.launch_ub_overlap(g, x, mode, reps, y0)
    overlap.launches += 1
    return out


def scalars(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """#10: row 0 [1, Bt] f32; <x [1, Bt]> gives the width and the
    device, as the script's input, and is read by nothing."""
    _check("x", x, torch.float32)
    if x.device.type == "cpu":
        return scalars_ref(x, reps)
    from .ops.kernels import loader
    _, out = loader.launch_ub_scalars(x.shape[1], reps, x.device)
    scalars.launches += 1
    return out


WRAPPERS = (chain, onehot_gather, onehot_mma, overlap, scalars)
for _w in WRAPPERS:
    _w.launches = 0             # CUDA launches through this wrapper


# ---------------------------------------------------------------------
# Inputs, bounds, timing
# ---------------------------------------------------------------------
def bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def inputs(case: str, Mt: int = MT, Bt: int = BT, reps: int = REPS,
           n: int = ONEHOT_N[-1], seed: int = 0) -> tuple:
    """Seeded CPU inputs of one case: chain, overlap and scalars take x
    in (0, 0.5), where ``v*v + 0.25`` stays below its fixed point 0.5
    (past it the chain grows to inf); onehot a normal bf16 table
    and uniform indices; overlap a bf16 g uniform in [0, 6), which keeps
    yacc's map v -> (0.8 v)^2 + 0.25 at a stable fixed point (~0.32)
    with rows that differ."""
    rng = np.random.default_rng(seed)
    if case == "onehot":
        return (bf16(rng.standard_normal((Mt, n))),
                torch.from_numpy(rng.integers(0, n, (reps, Bt),
                                              dtype=np.int32)))
    shape = (1, Bt) if case == "scalars" else (Mt, Bt)
    x = torch.from_numpy(rng.uniform(0.01, 0.49, shape).astype(np.float32))
    if case == "overlap":
        return bf16(rng.uniform(0.0, 6.0, (2 * Mt, 2 * Mt))), x
    return (x,)


def overlap_start(Mt: int = MT, Bt: int = BT, seed: int = 1) -> torch.Tensor:
    """A yacc start [2Mt, Bt] bf16 whose columns differ: column c is
    s_c in (0, 0.5) times u in (0.5, 1.5) per element, so that after a
    step with ``inputs("overlap")``'s g a column's yacc lies anywhere in
    [0.25, ~0.48] by its s_c (below 0.5, where a bf16 ulp is 2**-9, as
    at the script's fixed point).  From the script's start of 0.3 every
    column stays equal, and a check could not see the columns' mapping
    in the product; from this one it can, for the few steps before yacc
    reaches its fixed point."""
    rng = np.random.default_rng(seed)
    return bf16(rng.uniform(0.0, 0.5, (1, Bt))
                * rng.uniform(0.5, 1.5, (2 * Mt, Bt)))


def bound(case: str, Mt: int, Bt: int, reps: int, nops: int = 0,
          n: int = 0, mode: str = ""):
    """(bound_ms, bound_by): the least time the card could take for the
    case's function at its published peaks: the bytes of each input
    read once and each output written once, and the operations the
    function needs of each type (f32 on the CUDA cores, bf16 products
    on the tensor cores; an FMA is two) over that type's rate; the
    largest of the three.  The one-hot sum needs one f32 add per
    element and step, whichever entry computes it (``tc_bound_ms`` is
    the tensor-core entry's own product)."""
    f32 = tc = 0.0
    if case == "chain":
        f32 = Mt * Bt * reps * (2 * nops + 1)
        nbytes = 2 * 4 * Mt * Bt
    elif case == "onehot":
        f32 = Mt * Bt * reps
        nbytes = 2 * Mt * n + 4 * reps * Bt + 4 * Mt * Bt
    elif case == "overlap":
        if mode != "chain":
            tc = 2 * (2 * Mt) ** 2 * Bt * reps
            f32 += 3 * 2 * Mt * Bt * reps
        if mode != "dot":
            f32 += Mt * Bt * reps * (2 * OVERLAP_NOPS + 1)
        nbytes = 2 * (2 * Mt) ** 2 + 2 * 4 * Mt * Bt
    else:
        f32 = 2 * 16 * Bt * reps
        nbytes = 4 * Bt
    t = {"bytes": nbytes / HBM_BYTES_PER_S,
         "operations": max(f32 / F32_OPS_PER_S, tc / BF16_TC_OPS_PER_S)}
    by = max(t, key=t.get)
    return 1e3 * t[by], by


def tc_bound_ms(Mt: int, Bt: int, reps: int, n: int) -> float:
    """The one-hot product's own work on the tensor cores, 2 n Mt Bt
    reps bf16 operations over the card's dense bf16 rate: what
    ``bt_ub_onehot_mma`` asks of them, not a bound of the function
    (that is ``bound``'s, one add per element and step)."""
    return 1e3 * 2 * n * Mt * Bt * reps / BF16_TC_OPS_PER_S


# ---------------------------------------------------------------------
# The tensor-core entries' design (csrc/ubench.cu): a warpgroup's wgmma
# takes WG_TILE columns b as its M, WG_N rows as its N, k16 slices of
# its K; B sits in shared memory as a K-major image without swizzle.
# These mirror the kernels' layout, descriptor and floors for the tests
# and the records.
# ---------------------------------------------------------------------
WG_TILE = 64                    # columns b of a warpgroup (wgmma's M)
WG_N = 136                      # the instruction's N: Mt padded
OVERLAP_P = 2 * WG_N            # 2Mt padded: N and K of an overlap step
SMS = 132                       # the H100 SXM's SMs


ONEHOT_KT = (2, 5, 17)          # k16 slices of a one-hot step's instances
ONEHOT_MAX_N = 16 * ONEHOT_KT[-1]


def onehot_kt(n: int) -> int:
    """The k16 slices of a one-hot step: n padded to 32, 80 or 272."""
    for kt in ONEHOT_KT:
        if n <= 16 * kt:
            return kt
    raise ValueError(f"the tensor-core entry takes n <= {ONEHOT_MAX_N}, "
                     f"got {n}")


def kmajor_offset(row: int, k: int, K: int) -> int:
    """Element offset of B[k][row] in the K-major image of an [N][K]
    matrix (row ``row`` along k), no swizzle: core matrices of 8 rows x
    8 elements (16 bytes a row, 128 contiguous bytes), the K / 8 cores
    of a block of 8 rows side by side, so LBO = 128 bytes (the next core
    along k) and SBO = 16 K bytes (the next block of 8 rows)."""
    return ((row // 8) * (K // 8) + k // 8) * 64 + (row % 8) * 8 + k % 8


def kmajor_image(mat: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """The image (N K elements) of <mat> [rows <= N, cols <= K], zero
    past it, as the kernels fill their shared memory."""
    img = torch.zeros(N * K, dtype=mat.dtype)
    rows, cols = mat.shape
    at = kmajor_offset(torch.arange(rows)[:, None],
                       torch.arange(cols)[None, :], K)
    img[at.reshape(-1)] = mat.reshape(-1)
    return img


def wgmma_desc(addr: int, lbo: int, sbo: int) -> int:
    """A wgmma matrix descriptor (PTX ISA): the start address, the
    leading (along K) and stride (along M/N) byte offsets, each >> 4 in
    14 bits, at bits 0, 16 and 32; no swizzle (bits 62-63 zero)."""
    enc = lambda v: (v & 0x3FFFF) >> 4  # noqa: E731
    return enc(addr) | enc(lbo) << 16 | enc(sbo) << 32


def desc_slice(img: torch.Tensor, desc: int, N: int) -> torch.Tensor:
    """B[16, N] of one k16 slice read from <img> as wgmma reads it by
    <desc>: element (k, n) at byte start + (n / 8) SBO + (k / 8) LBO +
    16 (n % 8) + 2 (k % 8) (start relative to the image)."""
    start, lbo, sbo = ((desc >> s & 0x3FFF) << 4 for s in (0, 16, 32))
    k = torch.arange(16)[:, None]
    n = torch.arange(N)[None, :]
    at = start + (n // 8) * sbo + (k // 8) * lbo + 16 * (n % 8) + 2 * (k % 8)
    return img[at // 2]


def onehot_mma_floor_ms(Bt: int, reps: int, n: int) -> float:
    """The tensor-core entry's floor as designed: the bf16 work it
    issues (every tile of WG_TILE columns, WG_N rows and 16 KT of K,
    each step) at the card's dense rate."""
    tiles = -(-Bt // WG_TILE)
    return 1e3 * 2 * WG_TILE * WG_N * 16 * onehot_kt(n) * tiles * reps \
        / BF16_TC_OPS_PER_S


def overlap_floor_ms(Bt: int, reps: int) -> float:
    """The overlap product's floor as designed: each tile of WG_TILE
    columns stays on one SM, so its 2 OVERLAP_P^2 WG_TILE bf16
    operations a step run at one SM's share of the dense rate, in as
    many waves as the tiles take of the SMS SMs."""
    waves = -(-(-(-Bt // WG_TILE)) // SMS)
    return 1e3 * waves * 2 * OVERLAP_P ** 2 * WG_TILE * reps \
        / (BF16_TC_OPS_PER_S / SMS)


# ---------------------------------------------------------------------
# The gather's design (csrc/ubench.cu ub_gather_kernel): t^T's padded
# image in shared memory, G groups of 8 rows a table row and a zero row
# k = n; TPC threads a column, CW whole columns a warp, each index
# staged as its row's byte offset.  These mirror the kernel's layout,
# geometry and floor for the tests and the records.
# ---------------------------------------------------------------------
GATHER_CHUNK = 64               # steps a warp stages at once
GATHER_SLOT = GATHER_CHUNK + 4  # ints a column of a staging slot
GATHER_MAX_WARPS = 16           # warps a block at most
SMEM_MAX = 232448               # shared memory a block can use (H100)
# Shared memory serves 128 bytes a clock an SM; each of an SM's 4
# schedulers issues one warp instruction a clock (the clock: the card's
# own, max_sm_clock_hz).
SMEM_BYTES_PER_CLOCK = 128
SCHEDULERS = 4


def gather_groups(Mt: int) -> tuple:
    """(G, TPC, CW): groups of 8 rows a table row, threads a column
    (the 17th group at Mt > 128 goes to the lanes g < 8, a row each),
    whole columns a warp."""
    G = -(-Mt // 8)
    tpc = min(G, 16)
    return G, tpc, 32 // tpc


def gather_smem(Mt: int, n: int, warps: int) -> int:
    """Shared bytes of a block: the image, (n + 1) 8G bf16, and a ring
    of two staging slots a warp."""
    G, _, cw = gather_groups(Mt)
    return (n + 1) * 8 * G * 2 + warps * 2 * cw * GATHER_SLOT * 4


def gather_plan(Mt: int, n: int, Bt: int, sms: int = SMS) -> tuple:
    """(warps a block, blocks) of ``bt_ub_onehot_gather``: ceil(warps /
    sms) warps a block (one wave fills the card), at most
    GATHER_MAX_WARPS, fewer where the image and the rings would not fit
    SMEM_MAX; (0, ceil(Bt / 8)) where not even one warp's fits: the wide
    instance, 8 columns a block."""
    _, _, cw = gather_groups(Mt)
    nwarps = -(-Bt // cw)
    w = min(GATHER_MAX_WARPS, -(-nwarps // sms))
    while w > 0 and gather_smem(Mt, n, w) > SMEM_MAX:
        w -= 1
    if w == 0:
        return 0, -(-Bt // 8)
    return w, -(-nwarps // w)


def gather_image(t: torch.Tensor) -> torch.Tensor:
    """What ``ub_gather_pack_kernel`` makes of <t> [Mt, n] bf16:
    img[k 8G + m] = t[m, k], zero past Mt and in the row k = n."""
    Mt, n = t.shape
    G = gather_groups(Mt)[0]
    img = t.new_zeros(n + 1, 8 * G)
    img[:n, :Mt] = t.T
    return img.reshape(-1)


def gather_offset(k: int, Mt: int, n: int) -> int:
    """The byte offset a staged index k becomes: min(k as unsigned,
    n) x the row's bytes, so an index outside [0, n) reads the zero
    row."""
    G = gather_groups(Mt)[0]
    return min(k & 0xFFFFFFFF, n) * 8 * G * 2


def gather_read(img: torch.Tensor, Mt: int, g: int, off: int) -> tuple:
    """(8 values, the extra value or None) that lane group <g> adds in a
    step whose row offset is <off>: 8 elements from byte 16 g + off
    and, at Mt > 128, one from byte 256 + 2 (g & 7) + off, as the kernel
    addresses them."""
    at = (16 * g + off) // 2
    extra = None
    if gather_groups(Mt)[0] == 17:
        extra = img[(256 + 2 * (g & 7) + off) // 2]
    return img[at:at + 8], extra


def gather_writes(Mt: int, Bt: int, warps: int, blocks: int) -> np.ndarray:
    """(column, row) of every output the launch writes, as the kernel's
    threads compute them: block, warp, lane -> columns c0 = (block warps
    + warp) CW, the lane's column c0 + l / TPC and group g = l % TPC,
    rows 8g..8g+7 below Mt and, at G = 17, row 128 + g for g < 8."""
    G, tpc, cw = gather_groups(Mt)
    lane = np.arange(32)[None, :]
    b = np.arange(blocks * warps)[:, None] * cw + lane // tpc
    g = np.broadcast_to(lane % tpc, b.shape)
    live = (lane // tpc < cw) & (b < Bt)
    b, g = b[live], g[live]
    parts = [np.stack([b, 8 * g + r], 1) for r in range(8)]
    if G == 17:
        parts.append(np.stack([b[g < 8], 128 + g[g < 8]], 1))
    w = np.concatenate(parts)
    return w[w[:, 1] < Mt]


def max_sm_clock_hz() -> float:
    """``nvidia-smi --query-gpu=clocks.max.sm`` of the first card, in
    Hz."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {r.returncode}: "
                           f"{r.stderr[-500:]}")
    return 1e6 * float(r.stdout.strip().splitlines()[0])


def gather_floor_ms(Mt: int, Bt: int, reps: int, n: int,
                    clock_hz: float) -> float:
    """The gather's floor as designed, at the SM clock <clock_hz> (the
    card's, ``max_sm_clock_hz``): the larger of
    - its instructions at the issue rate (SMS x SCHEDULERS warp
      instructions a clock): a warp's step is the row's address, the
      16-byte shared load, 8 unpacks and 8 f32 adds and a quarter of
      the offsets' 16-byte load, and at Mt > 128 four more for the 17th
      group, for every warp of ceil(Bt / CW);
    - its shared-memory bytes at SMEM_BYTES_PER_CLOCK an SM: a column's
      step reads TPC groups of 16 bytes, the 17th group and the 4-byte
      offset, and each block writes the image once."""
    G, tpc, cw = gather_groups(Mt)
    extra = G == 17
    per_step = 18.25 + (4 if extra else 0)
    blocks = gather_plan(Mt, n, Bt, SMS)[1]
    issue = -(-Bt // cw) * reps * per_step / (SMS * SCHEDULERS)
    nbytes = Bt * reps * (tpc * 16 + (16 if extra else 0) + 4) \
        + blocks * (n + 1) * 8 * G * 2
    smem = nbytes / (SMS * SMEM_BYTES_PER_CLOCK)
    return 1e3 * max(issue, smem) / clock_hz


SCALARS_THREADS = 128           # threads a block of bt_ub_scalars


def scalars_geometry(Bt: int) -> tuple:
    """(blocks, threads) of ``bt_ub_scalars``: a thread for each of the
    16 x Bt stepped elements, thread e on row e / Bt, column e % Bt."""
    return -(-16 * Bt // SCALARS_THREADS), SCALARS_THREADS


def scalars_floor_ms(reps: int, step_ns: float) -> float:
    """#10's floor: one chain of <reps> dependent FMAs at <step_ns>, the
    latency of a lone dependent FMA that the same drive measured (the
    one-warp chain's ``ns_per_step``); the chains of all 16 x Bt
    elements run at once."""
    return reps * step_ns * 1e-6


def onehot_mma_tol(ref: torch.Tensor, reps: int = REPS) -> float:
    """The tensor-core entry's bound against the plain version: the
    tensor cores accumulate in f32 but do not round each step's add as
    an IEEE add does, so each of the <reps> steps may leave an ulp of the
    largest |acc| (the partial sums of the entry's splits, and their
    sum, stay inside it)."""
    return reps * 2.0 ** -23 * float(ref.abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over <reps> calls, by CUDA events,
    after one warm-up call.  The card first sleeps long enough for the
    host to queue all <reps> calls behind it, so a kernel shorter than
    its call's host overhead (~30-50 us a call) is timed by itself and
    not by the host.  A call that reads the device back before it
    launches (the input checks of the search entries' wrappers) waits
    for the sleep and for the calls before it, so its time includes
    its host time all the same."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e5) * reps)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------
# The drive
# ---------------------------------------------------------------------
def drive(cases=CASES) -> list[dict]:
    """Times every case's kernel at [MT, BT] and [MT, BT_FULL] (and the
    chain on one warp), REPS steps a call, each call ten times: one
    record a case and shape, with ``ms``, ``bound_ms``, ``bound_by``,
    the script's derived figure and its design's ``floor_ms``
    (``gather_floor_ms`` at the card's ``clocks.max.sm``, which its
    records carry as ``sm_clock_mhz``, ``onehot_mma_floor_ms``,
    ``overlap_floor_ms``, ``scalars_floor_ms`` from the one-warp chain's
    ``ns_per_step``; the chain has none)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the microbenchmarks time the card: no CUDA "
                           "device")
    dev = torch.device("cuda")

    def on(*ts):
        return [t.to(dev) for t in ts]

    def record(case, entry, ms, **shape):
        b_ms, by = bound(case, **shape)
        return {"case": case, "entry": entry, **shape, "ms": ms,
                "bound_ms": b_ms, "bound_by": by}

    Mt, reps, timing_reps, seed = MT, REPS, 10, 0
    clock_hz = max_sm_clock_hz() if "onehot" in cases else None
    recs = []

    def step_ns():
        """The one-warp chain's ns a dependent step (nops 16), from the
        records or timed here."""
        for r in recs:
            if r["case"] == "chain" and r["shape"] == "one warp" \
                    and r["nops"] == CHAIN_NOPS[-1]:
                return r["ns_per_step"]
        x, = on(*inputs("chain", 1, 32, reps, seed=seed))
        ms = cuda_ms(lambda: chain(x, CHAIN_NOPS[-1], reps), timing_reps)
        return 1e6 * ms / (reps * (CHAIN_NOPS[-1] + 1))
    shapes = [(Mt, Bt) for Bt in (BT, BT_FULL)]
    for M, Bt in shapes + [(1, 32)] if "chain" in cases else []:
        x, = on(*inputs("chain", M, Bt, reps, seed=seed))
        for nops in CHAIN_NOPS:
            ms = cuda_ms(lambda: chain(x, nops, reps), timing_reps)
            r = record("chain", "bt_ub_chain", ms, Mt=M, Bt=Bt, reps=reps,
                       nops=nops)
            # the script's ns per [Mt, Bt]-op: every element takes one
            # dependent step of its chain per op
            r["ns_per_step"] = 1e6 * ms / (reps * (nops + 1))
            r["shape"] = "one warp" if M * Bt == 32 else "tile"
            recs.append(r)
    for M, Bt in shapes:
        if "onehot" in cases:
            for n in ONEHOT_N:
                t, idx = on(*inputs("onehot", M, Bt, reps, n=n, seed=seed))
                for mma, fn in ((False, onehot_gather), (True, onehot_mma)):
                    ms = cuda_ms(lambda: fn(t, idx), timing_reps)
                    r = record("onehot", "bt_ub_" + fn.__name__, ms, Mt=M,
                               Bt=Bt, reps=reps, n=n)
                    r["mma"] = mma
                    if mma:
                        r["tc_bound_ms"] = tc_bound_ms(M, Bt, reps, n)
                        r["floor_ms"] = onehot_mma_floor_ms(Bt, reps, n)
                    else:
                        r["floor_ms"] = gather_floor_ms(M, Bt, reps, n,
                                                        clock_hz)
                        r["sm_clock_mhz"] = clock_hz / 1e6
                    r["ns_per_pos"] = 1e6 * ms / reps
                    recs.append(r)
        if "overlap" in cases:
            g, x = on(*inputs("overlap", M, Bt, reps, seed=seed))
            per = {}
            for mode in OVERLAP_MODES:
                ms = cuda_ms(lambda: overlap(g, x, mode, reps), timing_reps)
                per[mode] = 1e6 * ms / reps
                r = record("overlap", "bt_ub_overlap", ms, Mt=M, Bt=Bt,
                           reps=reps, mode=mode)
                r["ns_per_step"] = per[mode]
                if mode != "chain":
                    r["floor_ms"] = overlap_floor_ms(Bt, reps)
                recs.append(r)
            ideal, serial = max(per["chain"], per["dot"]), \
                per["chain"] + per["dot"]
            recs[-1].update(
                ideal_ns=ideal, serial_ns=serial,
                hidden_share=(serial - per["both"]) / min(per["chain"],
                                                          per["dot"]))
        if "scalars" in cases:
            x, = on(*inputs("scalars", M, Bt, reps, seed=seed))
            ms = cuda_ms(lambda: scalars(x, reps), timing_reps)
            r = record("scalars", "bt_ub_scalars", ms, Mt=M, Bt=Bt,
                       reps=reps)
            r["ns_per_iter"] = 1e6 * ms / reps
            r["floor_ms"] = scalars_floor_ms(reps, step_ns())
            recs.append(r)
    return recs


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {r.returncode}: "
                           f"{r.stderr[-500:]}")
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    cases = CASES if not args or "all" in args else tuple(args)
    unknown = set(cases) - set(CASES)
    if unknown:
        print(f"unknown cases {sorted(unknown)}; cases: {' '.join(CASES)} "
              "all", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    for r in drive(cases):
        print(json.dumps({**r, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
