"""bath_tpu_torch's bathbuild, bathconvert, bathstat and bathfetch against
the JAX package's CLIs, on the CPU (``--device cpu``: the kernels' plain
versions).

Input: ``fixtures.write_msa_fixture``, a Stockholm file of three
alignments (12 sequences each) emitted from seeded models of M = 40, 90
and 130, and ``fixtures.write_convert_input``, the built models stripped
of their frameshift calibration (BATH3/f and HMMER3/f).

Model files are compared line by line without their ``DATE`` line.
``--backend numpy`` of the port and of the JAX package must agree on
every other byte.  ``--backend torch`` may differ from ``--backend
numpy`` only in the taus that the f32 gates simulate (``STATS LOCAL
FORWARD`` and ``STATS LOCAL FS3 FORWARD``), within 0.02 (measured: equal
as printed); the MSV and VITERBI lines (integer kernels) and the FS5
FORWARD line (the same host parser) are equal as text.
"""

import io
import re
from contextlib import redirect_stdout

import pytest

import jax_native
from bath_tpu.cli import bathbuild as jb
from bath_tpu.cli import bathconvert as jc
from bath_tpu.cli import bathfetch as jf
from bath_tpu.cli import bathstat as js
from bath_tpu_torch import fixtures
from bath_tpu_torch.cli import bathbuild as tb
from bath_tpu_torch.cli import bathconvert as tc
from bath_tpu_torch.cli import bathfetch as tfetch
from bath_tpu_torch.cli import bathstat as tstat
from torch_threads import one_torch_thread  # noqa: F401

MS = (40, 90, 130)
F32_GATE = ("STATS LOCAL FORWARD", "STATS LOCAL FS3 FORWARD")
TAU_TOL = 0.02


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's CLIs run their host stages in its native library
    when it loads and in Python when it does not, and the two print
    taus that differ in the last digit: load it, so that both packages
    run the same host code."""
    jax_native.load()


def model_lines(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("DATE")]


def same_but_gate_taus(a, b, allowed=F32_GATE):
    """Asserts that two model files differ at most in the tau of the
    <allowed> STATS lines, within TAU_TOL; returns how many differ."""
    la, lb = model_lines(a), model_lines(b)
    assert len(la) == len(lb)
    n = 0
    for x, y in zip(la, lb):
        if x == y:
            continue
        assert x.startswith(allowed) and y.startswith(allowed), (x, y)
        fx, fy = x.split(), y.split()
        assert fx[:-2] == fy[:-2] and fx[-1] == fy[-1], (x, y)
        assert abs(float(fx[-2]) - float(fy[-2])) <= TAU_TOL, (x, y)
        n += 1
    return n


def quiet(main, argv, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv, **kw)
    assert rc == 0 or rc is None, out.getvalue()
    return re.sub(r"# CPU time:.*", "", out.getvalue())


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The fixture's alignments built three ways (--fs is the default;
    the statistics of the torch run ride along)."""
    d = tmp_path_factory.mktemp("build")
    sto, names = fixtures.write_msa_fixture(MS, 12, 7, directory=d)
    out = {"sto": sto, "names": names, "dir": d}
    for tag, main, extra in (
            ("jax_numpy", jb.main, ["--backend", "numpy"]),
            ("numpy", tb.main, ["--backend", "numpy"]),
            ("torch", tb.main, ["--backend", "torch", "--device", "cpu"])):
        path = d / f"{tag}.bhmm"
        kw = {"stats": out.setdefault("stats", {})} if tag == "torch" else {}
        out[tag + "_log"] = quiet(main, [*extra, "-o", str(d / f"{tag}.log"),
                                         str(path), sto], **kw)
        out[tag] = str(path)
        out[tag + "_table"] = re.sub(
            r"# (CPU time|output HMM file):.*", "",
            (d / f"{tag}.log").read_text())
    return out


def test_msa_fixture_builds_models_of_the_seeded_lengths(built):
    from bath_tpu_torch.hmmfile import read_hmms
    hmms = list(read_hmms(built["numpy"]))
    assert [h.name for h in hmms] == built["names"]
    assert [h.M for h in hmms] == list(MS)
    assert all(h.nseq == 12 and h.fs for h in hmms)


def test_bathbuild_numpy_backend_equals_the_jax_package(built):
    assert model_lines(built["numpy"]) == model_lines(built["jax_numpy"])
    assert built["numpy_table"] == built["jax_numpy_table"]


def test_bathbuild_torch_backend_differs_only_in_gate_taus(built):
    same_but_gate_taus(built["torch"], built["numpy"])
    same_but_gate_taus(built["torch"], built["jax_numpy"])
    assert built["torch_table"] == built["numpy_table"]
    st = built["stats"]
    assert st["cal_models"] == 3 and st["cal_items"] == 3 * 800


def test_bathbuild_nofs_and_custom_sizes(built):
    d = built["dir"]
    args = ["--nofs", "--EmN", "30", "--EvN", "30", "--EfN", "40", "--EmL",
            "80", "--EvL", "90", "--EfL", "50", "--seed", "9"]
    quiet(tb.main, [*args, "--backend", "numpy", str(d / "n.bhmm"),
                    built["sto"]])
    quiet(tb.main, [*args, "--backend", "torch", "--device", "cpu",
                    str(d / "t.bhmm"), built["sto"]])
    same_but_gate_taus(d / "t.bhmm", d / "n.bhmm", F32_GATE[:1])
    assert not any("FS3" in ln for ln in model_lines(d / "t.bhmm"))


def test_bathbuild_workers_equal_serial(built):
    """--cpu 2 forks the builds and calibrates in the parent afterwards:
    the same file as --cpu 0, on both backends."""
    d = built["dir"]
    for backend, extra in (("numpy", []), ("torch", ["--device", "cpu"])):
        path = d / f"w2_{backend}.bhmm"
        quiet(tb.main, ["--backend", backend, *extra, "--cpu", "2",
                        str(path), built["sto"]])
        assert model_lines(path) == model_lines(built[backend])


def test_bathbuild_single_sequence_input(built):
    """Unaligned FASTA input: single-sequence builds, calibrated as one
    batch on the torch backend."""
    d = built["dir"]
    fa = d / "two.fa"
    fa.write_text(">one first protein\nMKVLAAGIVGLLLAQWERTYHDSPNC\n"
                  ">two\nGHHEELLKKAWWDDSSTTPPNNQQRRMMFFYYIIVVLLAACC\n")
    for tag, main, extra in (
            ("j", jb.main, ["--backend", "numpy"]),
            ("n", tb.main, ["--backend", "numpy"]),
            ("t", tb.main, ["--backend", "torch", "--device", "cpu"])):
        quiet(main, [*extra, str(d / f"fa_{tag}.bhmm"), str(fa)])
    assert model_lines(d / "fa_n.bhmm") == model_lines(d / "fa_j.bhmm")
    same_but_gate_taus(d / "fa_t.bhmm", d / "fa_n.bhmm")


@pytest.mark.parametrize("hmmer3", [False, True], ids=["bath3", "hmmer3"])
def test_bathconvert_backends(built, hmmer3):
    """bathconvert on models without frameshift calibration: numpy equal
    to the JAX package's, torch differing only in the fs3 taus."""
    d = built["dir"]
    src = fixtures.write_convert_input(
        built["numpy"], str(d / f"conv_in_{int(hmmer3)}.hmm"), hmmer3)
    assert not any("FS3" in ln or "FRAMESHIFT" in ln
                   for ln in model_lines(src))
    logs = {}
    for tag, main, extra in (
            ("j", jc.main, ["--backend", "numpy"]),
            ("n", tc.main, ["--backend", "numpy"]),
            ("t", tc.main, ["--backend", "torch", "--device", "cpu"])):
        logs[tag] = quiet(main, [*extra, str(d / f"conv_{tag}.bhmm"), src])
    assert model_lines(d / "conv_n.bhmm") == model_lines(d / "conv_j.bhmm")
    same_but_gate_taus(d / "conv_t.bhmm", d / "conv_n.bhmm", F32_GATE[1:])
    strip = re.compile(r"# output HMM file:.*")
    assert strip.sub("", logs["t"]) == strip.sub("", logs["n"]) \
        == strip.sub("", logs["j"])
    # the converted file searches: it carries the frameshift fields
    assert sum(ln.startswith("STATS LOCAL FS5")
               for ln in model_lines(d / "conv_t.bhmm")) == 3
    # another RNG stream (one for all models, begun at the fs draws):
    # the taus are not bathbuild's
    built_fs3 = [ln for ln in model_lines(built["numpy"]) if "FS3" in ln]
    conv_fs3 = [ln for ln in model_lines(d / "conv_n.bhmm") if "FS3" in ln]
    assert len(conv_fs3) == 3 and not set(built_fs3) & set(conv_fs3)


def test_bathconvert_ct_recalibrates_on_the_device_path(built):
    d = built["dir"]
    for tag, extra in (("n", ["--backend", "numpy"]),
                       ("t", ["--backend", "torch", "--device", "cpu"])):
        quiet(tc.main, [*extra, "--ct", "4", str(d / f"ct4_{tag}.bhmm"),
                        built["numpy"]])
    assert same_but_gate_taus(d / "ct4_t.bhmm", d / "ct4_n.bhmm",
                              F32_GATE[1:]) <= 3
    assert sum(ln == "CODON TABLE  4"
               for ln in model_lines(d / "ct4_t.bhmm")) == 3


def test_bathstat_equals_the_jax_package(built):
    for path in (built["torch"], built["numpy"]):
        assert quiet(tstat.main, [path]) == quiet(js.main, [path])
    assert quiet(tstat.main, [built["torch"]]) \
        == quiet(tstat.main, [built["numpy"]])


def test_bathfetch_equals_the_jax_package(built, tmp_path):
    """--index, by name, -f key file, -o and --ct: the port's bathfetch
    gives the JAX package's bytes on the same file."""
    import shutil
    outs = {}
    names = built["names"]
    for tag, main in (("j", jf.main), ("t", tfetch.main)):
        d = tmp_path / tag
        d.mkdir()
        src = d / "models.bhmm"
        shutil.copy(built["torch"], src)
        keys = d / "keys.txt"
        keys.write_text(f"{names[2]}\n{names[0]}\n")
        res = [quiet(main, ["--index", str(src)]).replace(str(d), "")]
        res.append((d / "models.bhmm.ssi").read_bytes())
        res.append(quiet(main, [str(src), names[1]]))
        res.append(quiet(main, ["-f", str(src), str(keys)]))
        quiet(main, ["-o", str(d / "one.bhmm"), str(src), names[0]])
        res.append((d / "one.bhmm").read_text())
        res.append(quiet(main, ["--ct", "4", str(src), names[0]]))
        outs[tag] = res
    assert outs["t"] == outs["j"]
    assert outs["t"][2].startswith("BATH3/f") and names[1] in outs["t"][2]
    assert outs["t"][3].count("//") == 2
    assert "CODON TABLE  4" in outs["t"][5]


def test_torch_backend_without_a_card_raises(built, tmp_path):
    """No fallback: without a CUDA device the torch backend of either
    CLI raises unless --device cpu is given."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        quiet(tb.main, [str(tmp_path / "x.bhmm"), built["sto"]])
    src = fixtures.write_convert_input(built["numpy"],
                                       str(tmp_path / "in.bhmm"))
    with pytest.raises(RuntimeError, match="CUDA"):
        quiet(tc.main, [str(tmp_path / "y.bhmm"), src])
