"""bath_tpu_torch.ubench against scripts/ubench_vpu.py.

The script's four Pallas kernels run in interpret mode on the CPU at
Mt, Bt, REPS = 16, 128, 4 (the kernels and their jitted ``run`` read
those module globals at call time): its ``pl.pallas_call`` is replaced
by one with ``interpret=True`` in the script's namespace only, and its
``_time`` by a capture of ``(run, args)``.  Each captured ``run`` is
called on the seeded inputs of ``ubench.inputs`` and compared with the
port's plain version and with its wrapper on CPU tensors (which runs
the plain version).  Tolerances, with the largest |d| measured here:

- chain: 1e-6.  CUDA contracts ``v*v + 0.25`` into one FMA, XLA on the
  CPU may or may not, PyTorch's plain version rounds twice: an ulp a
  step, which the map (contracting towards its fixed point) does not
  grow.  Measured: 1.5e-8 (nops 4), 3.0e-8 (nops 16).
- onehot: 1e-5 here, where the plain version sums in step order like
  the script's f32 ``acc`` and a one-hot product adds one exact table
  entry a step.  Measured: 0.  On the card the gather is held exactly
  and the tensor-core entry within ``ubench.onehot_mma_tol``, an ulp of
  the largest |acc| a step: the tensor cores do not round each step's
  add as an IEEE add does (H100: 2.4e-4 on sums up to ~150 at n = 17).
- overlap: 2**-8, one bf16 ulp of yacc (which lies in [0.25, 0.5)) plus
  the chain's ulps: the f32 product sums in another order, which may
  round yacc to its other neighbour.  Measured: 6.0e-8 (chain), 0
  (dot), 3.0e-8 (both).
- scalars: exact here (the same two roundings a step on either side;
  measured: 0); on the card 1e-6, as the chain: the kernel's FMA rounds
  once (H100: 1.2e-7).

The test marked ``cuda`` holds each of the five kernel entries against
its plain version on the card at the script's shapes, the one-hot and
overlap entries also at [136, 4096] and with a partial last tile of
64 columns (Bt = 1040 and 1056), for every table, twice with equal bits
(and the mma and gather entries against each other), the gather also
at Mt = 135 and 8 with indices out of range and at the widest n of
each of its instances, #10 at three widths with its whole scratch, and the chain and
overlap entries also after 1-3 steps: after 512 every element of the chain sits at its
map's fixed point, and from the script's yacc start of 0.3 the columns
stay equal, so only the short runs, from ``ubench.overlap_start``, show
which element and which column each lane read.  It skips here, and JAX is imported
only by the CPU tests' fixture, so the file also runs where there is no
JAX.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_threads import one_torch_thread  # noqa: F401

from bath_tpu_torch import ubench as ub
from bath_tpu_torch.ops.kernels import loader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(Mt=16, Bt=128, REPS=4)
TOL = {"chain": 1e-6, "onehot": 1e-5, "overlap": 2.0 ** -8, "scalars": 0.0}


@pytest.fixture(scope="module")
def script():
    """scripts/ubench_vpu.py with its Pallas calls in interpret mode and
    its timer capturing, at the small shapes; {case: [(run, args)]} as
    the script's bench functions hand them to ``_time``."""
    import jax
    from jax.experimental import pallas as pl
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "ubench_vpu_interpret", os.path.join(ROOT, "scripts", "ubench_vpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache)

    class Interpret:                # the script's `pl`, interpret mode
        def __getattr__(self, name):
            return getattr(pl, name)
        pallas_call = functools.partial(pl.pallas_call, interpret=True)

    mod.pl = Interpret()
    for k, v in SMALL.items():
        setattr(mod, k, v)
    calls = {}

    def capture(case):
        def _time(fn, *args, n=8):
            calls.setdefault(case, []).append((fn, args))
            return 1.0
        return _time

    for case, run in (("chain", lambda: [mod.bench_chain(k)
                                         for k in ub.CHAIN_NOPS]),
                      ("onehot", lambda: [mod.bench_onehot(n)
                                          for n in ub.ONEHOT_N]),
                      ("overlap", mod.bench_overlap),
                      ("scalars", mod.bench_scalars)):
        mod._time = capture(case)
        run()
    return calls


def small(case, **kw):
    return ub.inputs(case, SMALL["Mt"], SMALL["Bt"], SMALL["REPS"], seed=5,
                     **kw)


def jx(t):
    import jax.numpy as jnp
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def close(case, got, want):
    want = torch.from_numpy(np.array(want, np.float32))
    err = float((got - want).abs().max())
    assert err <= TOL[case], (case, err)


@pytest.mark.parametrize("k", range(len(ub.CHAIN_NOPS)))
def test_chain_vs_script(script, k):
    run, _ = script["chain"][k]
    x, = small("chain")
    nops, reps = ub.CHAIN_NOPS[k], SMALL["REPS"]
    close("chain", ub.chain_ref(x, nops, reps), run(jx(x)))
    assert torch.equal(ub.chain(x, nops, reps), ub.chain_ref(x, nops, reps))


@pytest.mark.parametrize("k", range(len(ub.ONEHOT_N)))
def test_onehot_vs_script(script, k):
    run, _ = script["onehot"][k]
    t, idx = small("onehot", n=ub.ONEHOT_N[k])
    want = run(jx(t), jx(idx))
    ref = ub.onehot_ref(t, idx)
    close("onehot", ref, want)
    for fn in (ub.onehot_gather, ub.onehot_mma):
        assert torch.equal(fn(t, idx), ref)


@pytest.mark.parametrize("k", range(len(ub.OVERLAP_MODES)))
def test_overlap_vs_script(script, k):
    run, _ = script["overlap"][k]        # the script times chain, dot, both
    g, x = small("overlap")
    mode = ub.OVERLAP_MODES[k]
    ref = ub.overlap_ref(g, x, mode, SMALL["REPS"])
    close("overlap", ref, run(jx(g), jx(x)))
    assert torch.equal(ub.overlap(g, x, mode, SMALL["REPS"]), ref)
    if mode != "chain":                  # yacc moved off its 0.3 start
        assert float((ref - ub.overlap_ref(g, x, "chain",
                                           SMALL["REPS"])).abs().max()) > 0.01


def test_scalars_vs_script(script):
    (run, _), = script["scalars"]
    x, = small("scalars")
    ref = ub.scalars_ref(x, SMALL["REPS"])
    close("scalars", ref, run(jx(x)))
    assert ref.shape == (1, SMALL["Bt"])
    assert torch.equal(ub.scalars(x, SMALL["REPS"]), ref)


def test_wrappers_check_inputs():
    x, = small("chain")
    with pytest.raises(ValueError):
        ub.chain(x, 5)
    with pytest.raises(ValueError):
        ub.chain(x.double(), 4)
    t, idx = small("onehot", n=17)
    with pytest.raises(ValueError):
        ub.onehot_mma(t.float(), idx)
    g, x = small("overlap")
    with pytest.raises(ValueError):
        ub.overlap(g, x, "neither")
    with pytest.raises(ValueError):
        ub.overlap(g[:8, :8].contiguous(), x, "dot")


def test_bounds_follow_the_work():
    """The chain is bound by its f32 operations; the one-hot sum, which
    either entry computes, by its bytes or one f32 add per element and
    step, whichever is larger; the tensor-core entry's own product
    (2 n Mt Bt REPS bf16 operations) is a separate figure, larger than
    the function's bound; each at the published peaks."""
    ms, by = ub.bound("chain", ub.MT, ub.BT, ub.REPS, nops=16)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * ub.MT * ub.BT * ub.REPS * 33 / 67e12)
    ms, by = ub.bound("onehot", ub.MT, ub.BT, ub.REPS, n=257)
    nbytes = 2 * ub.MT * 257 + 4 * ub.REPS * ub.BT + 4 * ub.MT * ub.BT
    assert ms == pytest.approx(1e3 * max(ub.MT * ub.BT * ub.REPS / 67e12,
                                         nbytes / 3.35e12))
    tc = ub.tc_bound_ms(ub.MT, ub.BT, ub.REPS, 257)
    assert tc == pytest.approx(1e3 * 2 * 257 * ub.MT * ub.BT * ub.REPS
                               / 989e12) and tc > 10 * ms


def test_overlap_start_shows_the_columns():
    """From the script's start of 0.3 the output's columns are equal in
    yacc (mode dot), so a check there cannot see which column of yacc a
    product read; from ``overlap_start`` a step leaves them far apart,
    and the wrapper takes the start on the CPU as its plain version.
    At the card's shapes: one step is one [272, 272] x [272, 1024]
    product here."""
    g, x = ub.inputs("overlap")
    x = torch.zeros_like(x)              # only yacc's part of the output
    y0 = ub.overlap_start()
    plain = ub.overlap_ref(g, x, "dot", 1)
    assert float((plain - plain[:, :1]).abs().max()) == 0.0
    assert torch.equal(ub.overlap_ref(g, x, "dot", 1, torch.full_like(
        y0, 0.3)), plain)
    got = ub.overlap(g, x, "dot", 1, y0)
    assert torch.equal(got, ub.overlap_ref(g, x, "dot", 1, y0))
    spread = got.amax(1) - got.amin(1)
    assert float(spread.min()) > 16 * 2.0 ** -8
    with pytest.raises(ValueError):
        ub.overlap(g, x, "dot", 1, y0[:, :32].contiguous())


def test_drive_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ub.drive()


@pytest.mark.parametrize("n", ub.ONEHOT_N)
def test_embedding_bag_is_the_onehot_sum(n):
    """#8's library call, ``F.embedding_bag(idx.T, t.float().T,
    mode="sum")``, transposed, is ``onehot_ref`` bit for bit at the
    script's shapes: each bag sums its table rows in step order."""
    t, idx = ub.inputs("onehot", n=n)
    got = F.embedding_bag(idx.T.contiguous(), t.float().T.contiguous(),
                          mode="sum")
    assert got.shape == (ub.BT, ub.MT)
    assert torch.equal(got.T, ub.onehot_ref(t, idx))


@pytest.mark.parametrize("Mt,n,Bt,mma,ok", [
    (136, 257, 1024, True, True), (136, 257, 4096, True, True),
    (8, 17, 32, True, True),            # the sanitizer's case
    (136, 65, 1040, True, True),        # a last tile of 16 columns
    (136, 272, 16, True, True), (1, 1, 16, True, True),
    (136, 900, 1000, False, True),      # the gather: any n, any Bt
    (137, 17, 1024, True, False), (137, 17, 1024, False, False),
    (136, 17, 1000, True, False),       # Bt not a multiple of 16
    (136, 273, 1024, True, False),      # past 17 k16 slices
])
def test_onehot_shapes_taken_and_refused(Mt, n, Bt, mma, ok):
    if ok:
        loader.ub_onehot_check(Mt, n, Bt, mma)
    else:
        with pytest.raises(ValueError):
            loader.ub_onehot_check(Mt, n, Bt, mma)


@pytest.mark.parametrize("Mt,Bt,ok", [
    (136, 1024, True), (136, 4096, True), (8, 32, True),
    (136, 1056, True),                  # a last tile of 32 columns
    (16, 128, True), (12, 64, False), (144, 64, False), (136, 48, False),
    (0, 64, False),
])
def test_overlap_shapes_taken_and_refused(Mt, Bt, ok):
    if ok:
        loader.ub_overlap_check(Mt, Bt)
    else:
        with pytest.raises(ValueError):
            loader.ub_overlap_check(Mt, Bt)


def test_the_kernels_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel: the wrappers run the plain
    version for it, the launches raise."""
    t, idx = small("onehot", n=17)
    g, x = small("overlap")
    with pytest.raises(ValueError):
        loader.launch_ub_onehot(t, idx, mma=True)
    with pytest.raises(ValueError):
        loader.launch_ub_overlap(g, x, "both", 1)


@pytest.mark.parametrize("Mt,n", [(136, 17), (136, 65), (136, 257), (8, 17),
                                  (100, 200)])
def test_onehot_b_image_read_back_by_descriptor(Mt, n):
    """t^T, the one-hot product's B, in the K-major image the kernel
    fills ([136][16 KT]): each k16 slice read back by its descriptor
    (start 256 kt, LBO 128, SBO 256 KT bytes) is t^T's slice, zero past
    Mt and n."""
    t, _ = ub.inputs("onehot", Mt, 16, 1, n=n)
    kt_n = ub.onehot_kt(n)
    K = 16 * kt_n
    img = ub.kmajor_image(t, ub.WG_N, K)
    pad = torch.zeros(ub.WG_N, K, dtype=t.dtype)
    pad[:Mt, :n] = t
    assert int(img.numel()) == ub.WG_N * K
    for kt in range(kt_n):
        desc = ub.wgmma_desc(256 * kt, 128, 256 * kt_n)
        assert torch.equal(ub.desc_slice(img, desc, ub.WG_N),
                           pad[:, 16 * kt:16 * kt + 16].T)
    assert ub.kmajor_offset(9, 17, K) == (1 * (K // 8) + 2) * 64 + 8 + 1


@pytest.mark.parametrize("Mt", [136, 64, 8])
def test_overlap_b_image_read_back_by_descriptor(Mt):
    """G^T, the overlap product's B, as the [272][272] K-major image of
    G (row i along j): the slice kt of output half h read back by its
    descriptor (start 17 h SBO + 256 kt, LBO 128, SBO 4352 bytes) is
    G^T[16 kt.., 136 h..136 h + 135], zero past 2Mt."""
    g, _ = ub.inputs("overlap", Mt, 32, 1)
    P = ub.OVERLAP_P
    img = ub.kmajor_image(g, P, P)
    pad = torch.zeros(P, P, dtype=g.dtype)
    pad[:2 * Mt, :2 * Mt] = g
    sbo = 128 * (P // 8)
    for h in range(2):
        for kt in range(P // 16):
            desc = ub.wgmma_desc(h * (ub.WG_N // 8) * sbo + 256 * kt, 128,
                                 sbo)
            want = pad[h * ub.WG_N:(h + 1) * ub.WG_N,
                       16 * kt:16 * kt + 16].T
            assert torch.equal(ub.desc_slice(img, desc, ub.WG_N), want)


@pytest.mark.parametrize("Bt,reps,sms,want", [
    (1024, 512, 132, 16), (4096, 512, 132, 4), (1040, 512, 132, 8),
    (32, 3, 132, 1), (64, 512, 132, 16), (8192, 512, 132, 2),
    (1024, 40, 132, 2), (1024, 512, 1, 1)])
def test_onehot_splits_cover_the_steps(Bt, reps, sms, want):
    """The tensor-core entry's splits: whole chunks of 32 steps each,
    none empty, every step in one; about two blocks an SM."""
    s = loader.ub_onehot_splits(Bt, reps, sms)
    assert s == want
    chunks = -(-reps // loader.UB_IDX_CHUNK)
    per = -(-chunks // s) * loader.UB_IDX_CHUNK
    assert s * per >= reps and (s - 1) * per < reps
    tiles = -(-Bt // ub.WG_TILE)
    assert s == 1 or tiles * s <= 2 * sms


def test_floors_of_the_designs():
    """The overlap product on one SM a tile: 0.647 ms at 512 steps for
    Bt = 1024 and 4096 (16 and 64 tiles), twice past 132 tiles; the
    one-hot product as issued (n padded to 16 KT, Mt to 136)."""
    one = 2 * 272 ** 2 * 64 * 512 / (989e12 / 132) * 1e3
    assert one == pytest.approx(0.6471357)
    assert ub.overlap_floor_ms(1024, 512) == pytest.approx(one)
    assert ub.overlap_floor_ms(4096, 512) == pytest.approx(one)
    assert ub.overlap_floor_ms(64 * 132, 512) == pytest.approx(one)
    assert ub.overlap_floor_ms(64 * 133, 512) == pytest.approx(2 * one)
    assert ub.onehot_mma_floor_ms(1024, 512, 257) == pytest.approx(
        2 * 64 * 136 * 272 * 16 * 512 / 989e12 * 1e3)
    assert [ub.onehot_kt(n) for n in (1, 17, 32, 33, 65, 80, 81, 257)] == \
        [2, 2, 2, 5, 5, 5, 17, 17]
    with pytest.raises(ValueError):
        ub.onehot_kt(273)


@pytest.mark.parametrize("Mt,n", [
    (136, 257), (136, 17), (135, 65), (129, 5), (128, 65), (8, 17), (7, 3),
    (1, 1), (100, 33), (136, 849), (130, 20), (24, 9)])
def test_gather_image_read_back(Mt, n):
    """The gather's image (``gather_image``, the pack kernel's layout)
    read back as the kernel addresses it (``gather_offset``,
    ``gather_read``): every lane group of every staged index gives
    t^T's rows of that table row, zero past Mt, the zero row for an
    index outside [0, n); at Mt > 128 the lanes g < 8 also read row
    128 + g (lanes g >= 8 re-read a row they drop)."""
    t, _ = ub.inputs("onehot", Mt, 16, 1, n=n)
    G, tpc, _ = ub.gather_groups(Mt)
    img = ub.gather_image(t)
    assert img.numel() == (n + 1) * 8 * G
    pad = torch.zeros(n + 1, 8 * G, dtype=torch.float32)
    pad[:n, :Mt] = t.T.float()
    for k in (0, 1, n // 2, n - 1, n, -1, n + 3, 2 ** 31 - 1, -2 ** 31):
        off = ub.gather_offset(k, Mt, n)
        row = pad[k if 0 <= k < n else n]
        for g in range(tpc):
            vals, extra = ub.gather_read(img, Mt, g, off)
            assert torch.equal(vals.float(), row[8 * g:8 * g + 8]), (k, g)
            if G == 17:
                assert float(extra) == float(row[128 + (g & 7)]), (k, g)
            else:
                assert extra is None
    assert float(pad[n].abs().max()) == 0.0
    if Mt % 8:
        assert float(pad[:, Mt:].abs().max()) == 0.0


@pytest.mark.parametrize("Bt", [1, 31, 1024, 1040, 4096])
@pytest.mark.parametrize("Mt", [1, 7, 8, 135, 136])
def test_gather_launch_covers_every_output_once(Mt, Bt):
    """Every (column, row) of [Mt, Bt] is written by exactly one lane of
    the gather's launch (``gather_plan``'s blocks, ``gather_writes``'
    mirror of the kernel's index arithmetic); #10's launch covers every
    element of its [32, Bt] scratch once (``scalars_geometry``): thread e
    steps row e / Bt, column e % Bt, and writes row 16 + e / Bt."""
    warps, blocks = ub.gather_plan(Mt, 257, Bt)
    G, tpc, cw = ub.gather_groups(Mt)
    assert 1 <= warps <= ub.GATHER_MAX_WARPS
    assert (blocks - 1) * warps * cw < Bt <= blocks * warps * cw
    w = ub.gather_writes(Mt, Bt, warps, blocks)
    key = w[:, 0].astype(np.int64) * 1000 + w[:, 1]
    assert len(key) == Mt * Bt and len(np.unique(key)) == Mt * Bt
    assert w[:, 0].min() == 0 and w[:, 0].max() == Bt - 1
    assert w[:, 1].min() == 0 and w[:, 1].max() == Mt - 1
    nb, threads = ub.scalars_geometry(Bt)
    e = np.arange(nb * threads)
    e = e[e < 16 * Bt]
    cells = np.concatenate([(e // Bt) * Bt + e % Bt,
                            (16 + e // Bt) * Bt + e % Bt])
    assert np.array_equal(np.sort(cells), np.arange(32 * Bt))


def test_gather_plan_fills_the_card():
    """One wave: ceil(warps / 132) warps a block (at most 16); the
    script's shape on 512 warps of two columns, 16 threads each, in 128
    blocks; a table whose image does not fit takes the wide instance,
    one it does at the fewest warps."""
    assert ub.gather_groups(136) == (17, 16, 2)
    assert ub.gather_groups(128) == (16, 16, 2)
    assert ub.gather_groups(8) == (1, 1, 32)
    assert ub.gather_plan(136, 257, 1024) == (4, 128)
    assert ub.gather_plan(136, 257, 1040) == (4, 130)
    assert ub.gather_plan(136, 257, 4096) == (16, 128)
    assert ub.gather_plan(136, 849, 1024) == (1, 512)
    assert ub.gather_smem(136, 849, 1) <= ub.SMEM_MAX
    assert ub.gather_plan(136, 850, 1024) == (0, 128)
    assert ub.gather_plan(136, 854, 1024) == (0, 128)
    # the wide instance's table, as before: n Mtp bf16
    assert 854 * 136 * 2 <= ub.SMEM_MAX < 855 * 136 * 2
    for Mt, n, Bt in ((136, 257, 8192), (8, 5000, 4096), (64, 300, 100)):
        w, _ = ub.gather_plan(Mt, n, Bt)
        assert w == 0 or ub.gather_smem(Mt, n, w) <= ub.SMEM_MAX


def test_floors_follow_the_work():
    """The gather's floor: at [136, 1024] x 512 its issue (512 warps x
    512 steps x 22.25 instructions over 132 x 4 schedulers) outweighs
    its shared bytes (276 a column a step and 128 images); it scales
    with Bt and reps, and inversely with the card's SM clock.  #10's:
    reps dependent FMAs at the measured step."""
    clk = 1.98e9
    issue = 512 * 512 * 22.25 / (132 * 4) / clk * 1e3
    smem = (1024 * 512 * 276 + 128 * 258 * 272) / (132 * 128) / clk * 1e3
    assert issue > smem
    assert ub.gather_floor_ms(136, 1024, 512, 257, clk) == \
        pytest.approx(issue)
    assert ub.gather_floor_ms(136, 4096, 512, 257, clk) == pytest.approx(
        4 * issue, rel=0.01)
    assert ub.gather_floor_ms(136, 1024, 256, 257, clk) < 0.51 * issue
    assert ub.gather_floor_ms(136, 1024, 512, 257, clk / 2) == \
        pytest.approx(2 * issue)
    assert ub.gather_floor_ms(8, 1024, 512, 17, clk) < issue
    assert ub.scalars_floor_ms(512, 2.35) == pytest.approx(512 * 2.35e-6)
    assert ub.scalars_floor_ms(1024, 2.35) == pytest.approx(
        2 * ub.scalars_floor_ms(512, 2.35))


@pytest.mark.parametrize("n", ub.ONEHOT_N)
def test_indices_out_of_range_add_nothing(n):
    """``out_of_range`` puts -1 and n in the stream; ``onehot_in_range``
    gives the plain version the entries' sum: each element's sum over
    the steps whose index lies in [0, n), in step order."""
    t, idx = small("onehot", n=n)
    idx = ub.out_of_range(idx.repeat(4, 1), n)
    assert (idx == -1).any() and (idx == n).any()
    got = ub.onehot_ref(*ub.onehot_in_range(t, idx))
    tf = t.float().numpy()
    want = np.zeros(got.shape, np.float32)
    for i in range(idx.shape[0]):
        k = idx[i].numpy()
        ok = (k >= 0) & (k < n)
        want[:, ok] = want[:, ok] + tf[:, k[ok]]
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(ub.onehot_gather(*ub.onehot_in_range(t, idx)), got)


@pytest.mark.cuda
def test_ubench_kernels_vs_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    x, = (a.to(dev) for a in ub.inputs("chain"))
    for nops in ub.CHAIN_NOPS:
        before = ub.chain.launches
        got = ub.chain(x, nops)
        assert ub.chain.launches == before + 1
        assert float((got - ub.chain_ref(x, nops)).abs().max()) <= 1e-6
    # the tensor-core entries at the drive's widths and with a partial
    # last tile of 64 columns (16 for onehot, 32 for overlap), every
    # table, twice: equal bits (their sums run in fixed orders)
    for Bt in (ub.BT, ub.BT_FULL, 1040):
        for n in ub.ONEHOT_N:
            t, idx = (a.to(dev) for a in ub.inputs("onehot", ub.MT, Bt,
                                                   n=n))
            ref = ub.onehot_ref(t, idx)
            gat, mma = ub.onehot_gather(t, idx), ub.onehot_mma(t, idx)
            assert torch.equal(gat, ref), (Bt, n)
            tol = ub.onehot_mma_tol(ref)
            assert float((mma - ref).abs().max()) <= tol, (Bt, n)
            assert float((mma - gat).abs().max()) <= tol, (Bt, n)
            assert torch.equal(ub.onehot_mma(t, idx), mma), (Bt, n)
    # after 1-3 steps the chain still follows x element by element (after
    # 512 every element sits at the map's fixed point)
    for nops in ub.CHAIN_NOPS:
        for reps in (1, 2, 3):
            got = ub.chain(x, nops, reps)
            assert float((got - ub.chain_ref(x, nops, reps)).abs().max()) \
                <= 1e-6
    for Bt in (ub.BT, ub.BT_FULL, 1056):
        g, x = (a.to(dev) for a in ub.inputs("overlap", ub.MT, Bt))
        for mode in ub.OVERLAP_MODES:
            got = ub.overlap(g, x, mode)
            assert float((got - ub.overlap_ref(g, x, mode)).abs().max()) \
                <= 2.0 ** -8, (Bt, mode)
            assert torch.equal(ub.overlap(g, x, mode), got), (Bt, mode)
        # from a start whose columns differ, so that the product's column
        # mapping shows; mode chain leaves yacc at its start (the chain's
        # tolerance), and both - dot is the chain half alone
        y0 = ub.overlap_start(ub.MT, Bt).to(dev)
        for reps in (1, 2, 3):
            got = {m: ub.overlap(g, x, m, reps, y0) for m in ub.OVERLAP_MODES}
            want = {m: ub.overlap_ref(g, x, m, reps, y0)
                    for m in ub.OVERLAP_MODES}
            for m in ub.OVERLAP_MODES:
                tol = 1e-6 if m == "chain" else 2.0 ** -8
                assert float((got[m] - want[m]).abs().max()) <= tol, \
                    (Bt, m, reps)
            half = (got["both"] - got["dot"]) - (want["both"] - want["dot"])
            assert float(half.abs().max()) <= 1e-6, (Bt, reps)
    # the gather's other instances: the 17th group's rows below 8 (Mt =
    # 135), a column a lane (Mt = 8), indices -1 and n, twice; the widest
    # n of each instance at Mt = 136 (849: the padded image; 854: the
    # wide one)
    for Mt, n, Bt in [(Mt, n, 1040) for Mt in (135, 8) for n in ub.ONEHOT_N] \
            + [(136, 849, 1024), (136, 854, 1024)]:
        t, idx = ub.inputs("onehot", Mt, Bt, n=n, seed=Mt + n)
        idx = ub.out_of_range(idx, n)
        ref = ub.onehot_ref(*(a.to(dev) for a in ub.onehot_in_range(t, idx)))
        t, idx = t.to(dev), idx.to(dev)
        before = ub.onehot_gather.launches
        gat = ub.onehot_gather(t, idx)
        assert ub.onehot_gather.launches == before + 1
        assert torch.equal(gat, ref), (Mt, n, Bt)
        assert torch.equal(ub.onehot_gather(t, idx), gat), (Mt, n, Bt)
    # #10 at the script's width, the full one and a ragged one; its
    # scratch: the 16 stepped rows, then the start
    for Bt in (ub.BT, ub.BT_FULL, 1000):
        x, = (a.to(dev) for a in ub.inputs("scalars", 1, Bt))
        ref = ub.scalars_ref(x)
        assert float((ub.scalars(x) - ref).abs().max()) <= 1e-6
        sp, out = loader.launch_ub_scalars(Bt, ub.REPS, dev)
        assert torch.equal(out, sp[:1])
        assert float((sp[:16] - ref).abs().max()) <= 1e-6
        assert torch.equal(sp[16:], torch.full((16, Bt), 0.3, device=dev))
