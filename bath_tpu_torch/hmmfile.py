"""ASCII HMM file I/O: HMMER3 and BATH3/f formats.

Re-provides the reference's p7_hmmfile read/write for the save-file
formats bathsearch/bathbuild use (ref: src/p7_hmmfile.c;
format tag written at :573, BATH STATS lines at :613-623, node lines
at :628-674).  Probabilities are stored as negative natural logs;
'*' denotes probability zero.
"""

from __future__ import annotations

import math
from typing import Iterator, TextIO

import numpy as np

from . import constants as C
from . import hmm as hmm_mod
from .alphabet import amino, dna, get_alphabet
from .hmm import HMM

_FORMAT_TAGS = {
    "BATH3/f": "bath3f",
    "HMMER3/f": "3f",
    "HMMER3/e": "3e",
    "HMMER3/d": "3d",
    "HMMER3/c": "3c",
    "HMMER3/b": "3b",
    "HMMER3/a": "3a",
}


def _prob_from_field(s: str) -> float:
    return 0.0 if s == "*" else math.exp(-float(s))


def read_hmms(path: str) -> Iterator[HMM]:
    from .sequence import _open_text
    with _open_text(path) as fh:
        while True:
            h = _read_one(fh)
            if h is None:
                return
            yield h


def read_hmm(path: str) -> HMM:
    return next(read_hmms(path))


def read_hmms_text(text: str) -> list[HMM]:
    """Parse HMM(s) from an in-memory string."""
    import io
    fh = io.StringIO(text)
    out = []
    while True:
        h = _read_one(fh)
        if h is None:
            return out
        out.append(h)


def _read_one(fh: TextIO) -> HMM | None:
    try:
        return _read_one_inner(fh)
    except (StopIteration, IndexError) as e:
        raise ValueError("HMM file truncated or misformatted "
                         "(premature end of data)") from e
    except ValueError as e:
        if "broadcast" in str(e) or "could not convert" in str(e):
            raise ValueError(
                "HMM file truncated or misformatted") from e
        raise


def _read_one_inner(fh: TextIO) -> HMM | None:
    # find format tag line
    line = ""
    for line in fh:
        if line.strip():
            break
    else:
        return None
    tag = line.split()[0]
    if tag.startswith("HMMER2.0"):
        return _read_hmmer2(fh)
    fmt = None
    for k, v in _FORMAT_TAGS.items():
        if tag.startswith(k):
            fmt = v
            break
    if fmt is None:
        raise ValueError(f"unrecognized HMM file format tag: {tag!r}")

    hdr: dict[str, str] = {}
    stats: dict[str, tuple[float, float]] = {}
    cutoffs: dict[str, tuple[float, float]] = {}
    comlog: list[str] = []
    fsprob = 0.0
    ct = 0
    for line in fh:
        tok = line.split()
        if not tok:
            continue
        key = tok[0]
        if key == "HMM":
            break
        if key == "STATS":
            # "STATS LOCAL MSV mu lambda" / "STATS LOCAL FS3 FORWARD tau lambda"
            rest = tok[2:]
            if rest[0] in ("FS3", "FS5"):
                stats[rest[0]] = (float(rest[2]), float(rest[3]))
            else:
                stats[rest[0]] = (float(rest[1]), float(rest[2]))
        elif key == "FRAMESHIFT":
            fsprob = float(tok[2])
        elif key == "CODON":
            ct = int(tok[2])
        elif key == "COM":
            comlog.append(line.split(None, 2)[2].rstrip("\n")
                          if len(tok) > 2 else "")
        elif key in ("GA", "TC", "NC"):
            cutoffs[key] = (float(tok[1]),
                            float(tok[2]) if len(tok) > 2 else float(tok[1]))
        else:
            hdr[key] = line[len(key):].strip()

    abc = amino() if hdr.get("ALPH", "amino").lower() == "amino" else \
        get_alphabet(hdr["ALPH"].lower())
    M = int(hdr["LENG"])
    h = HMM.zeros(M, abc)
    h.name = hdr.get("NAME", "")
    h.acc = hdr.get("ACC", "")
    h.desc = hdr.get("DESC", "")
    h.ctime = hdr.get("DATE", "")
    h.nseq = int(hdr["NSEQ"]) if "NSEQ" in hdr else -1
    h.eff_nseq = float(hdr["EFFN"]) if "EFFN" in hdr else -1.0
    h.max_length = int(hdr["MAXL"]) if "MAXL" in hdr else -1
    h.comlog = comlog
    if "CKSUM" in hdr:
        h.checksum = int(hdr["CKSUM"])
        h.flags |= hmm_mod.H_CHKSUM
    if h.acc:
        h.flags |= hmm_mod.H_ACC
    if h.desc:
        h.flags |= hmm_mod.H_DESC
    has_rf = hdr.get("RF", "no") == "yes"
    has_mm = hdr.get("MM", "no") == "yes"
    has_cons = hdr.get("CONS", "no") == "yes"
    has_cs = hdr.get("CS", "no") == "yes"
    has_map = hdr.get("MAP", "no") == "yes"

    ev = h.evparam
    if "MSV" in stats:
        ev[C.EV_MMU], ev[C.EV_MLAMBDA] = stats["MSV"]
    if "VITERBI" in stats:
        ev[C.EV_VMU], ev[C.EV_VLAMBDA] = stats["VITERBI"]
    if "FORWARD" in stats:
        ev[C.EV_FTAU], ev[C.EV_FLAMBDA] = stats["FORWARD"]
    if "FS3" in stats:
        ev[C.EV_FTAUFS3] = stats["FS3"][0]
        h.fs = True
    if "FS5" in stats:
        ev[C.EV_FTAUFS5] = stats["FS5"][0]
        h.fs = True
    if stats:
        h.flags |= hmm_mod.H_STATS
    for key, (c1, c2) in cutoffs.items():
        if key == "GA":
            h.cutoff[C.CUT_GA1], h.cutoff[C.CUT_GA2] = c1, c2
            h.flags |= hmm_mod.H_GA
        elif key == "TC":
            h.cutoff[C.CUT_TC1], h.cutoff[C.CUT_TC2] = c1, c2
            h.flags |= hmm_mod.H_TC
        elif key == "NC":
            h.cutoff[C.CUT_NC1], h.cutoff[C.CUT_NC2] = c1, c2
            h.flags |= hmm_mod.H_NC
    h.fsprob = fsprob
    h.ct = ct

    # skip the transition header line ("m->m m->i ...")
    next(fh)

    K = abc.K
    rf = ["-"] * (M + 1)
    mmask = ["-"] * (M + 1)
    cons = ["-"] * (M + 1)
    cs = ["-"] * (M + 1)
    mp = np.zeros(M + 1, dtype=np.int32)

    line = next(fh)
    tok = line.split()
    if tok[0] == "COMPO":
        h.compo = np.array([_prob_from_field(s) for s in tok[1:K + 1]],
                           dtype=np.float32)
        h.flags |= hmm_mod.H_COMPO
        line = next(fh)
        tok = line.split()
    # node 0: insert emissions then transitions
    h.ins[0] = [_prob_from_field(s) for s in tok[:K]]
    tok = next(fh).split()
    h.t[0] = [_prob_from_field(s) for s in tok[:7]]
    h.mat[0, :] = 0.0
    h.mat[0, 0] = 1.0

    for k in range(1, M + 1):
        tok = next(fh).split()
        assert int(tok[0]) == k, f"expected node {k}, got {tok[0]}"
        h.mat[k] = [_prob_from_field(s) for s in tok[1:K + 1]]
        rest = tok[K + 1:]
        # trailing annotation: MAP CONS RF [MM] CS  (3f adds MM)
        ann = rest
        if ann:
            if has_map:
                mp[k] = int(ann[0])
            ncols = 5 if fmt in ("bath3f", "3f") else 4
            if len(ann) >= ncols:
                cons[k] = ann[1]
                rf[k] = ann[2]
                if ncols == 5:
                    mmask[k] = ann[3]
                    cs[k] = ann[4]
                else:
                    cs[k] = ann[3]
        tok = next(fh).split()
        h.ins[k] = [_prob_from_field(s) for s in tok[:K]]
        tok = next(fh).split()
        h.t[k] = [_prob_from_field(s) for s in tok[:7]]

    tok = next(fh).split()
    if not tok or tok[0] != "//":
        raise ValueError("expected // at end of HMM record")

    if has_rf:
        h.rf = "".join(rf[1:])
        h.flags |= hmm_mod.H_RF
    if has_mm:
        h.mm = "".join(mmask[1:])
        h.flags |= hmm_mod.H_MMASK
    if has_cons:
        h.consensus = "".join(cons[1:])
        h.flags |= hmm_mod.H_CONS
    if has_cs:
        h.cs = "".join(cs[1:])
        h.flags |= hmm_mod.H_CS
    if has_map:
        h.map = mp
        h.flags |= hmm_mod.H_MAP
    return h


# ----------------------------------------------------------------------
def _field(p: float) -> str:
    """One probability field, matching printprob (p7_hmmfile.c:2199-2206)."""
    if p == 0.0:
        return " %8s" % "*"
    if p == 1.0:
        return " %8.5f" % 0.0
    return " %8.5f" % -np.log(np.float32(p))


def write_hmm(fh: TextIO, h: HMM, fmt: str = "bath3f"):
    """Write an HMM in BATH3/f (default) or HMMER3/f ASCII format
    (ref: p7_hmmfile.c multiline_write / node loop :628-674)."""
    K = h.abc.K
    fh.write("BATH3/f\n" if fmt == "bath3f" else "HMMER3/f [bath_tpu]\n")
    fh.write(f"NAME  {h.name}\n")
    if h.acc:
        fh.write(f"ACC   {h.acc}\n")
    if h.desc:
        fh.write(f"DESC  {h.desc}\n")
    fh.write(f"LENG  {h.M}\n")
    if h.max_length > 0:
        fh.write(f"MAXL  {h.max_length}\n")
    fh.write(f"ALPH  {h.abc.kind}\n")
    fh.write("RF    %s\n" % ("yes" if h.flags & hmm_mod.H_RF else "no"))
    fh.write("MM    %s\n" % ("yes" if h.flags & hmm_mod.H_MMASK else "no"))
    fh.write("CONS  %s\n" % ("yes" if h.flags & hmm_mod.H_CONS else "no"))
    fh.write("CS    %s\n" % ("yes" if h.flags & hmm_mod.H_CS else "no"))
    fh.write("MAP   %s\n" % ("yes" if h.flags & hmm_mod.H_MAP else "no"))
    if h.ctime:
        fh.write(f"DATE  {h.ctime}\n")
    for i, cl in enumerate(h.comlog):
        fh.write(f"COM   [{i + 1}] {cl}\n")
    if h.nseq > 0:
        fh.write(f"NSEQ  {h.nseq}\n")
    if h.eff_nseq >= 0:
        fh.write(f"EFFN  {h.eff_nseq:f}\n")
    if h.flags & hmm_mod.H_CHKSUM:
        fh.write(f"CKSUM {h.checksum}\n")
    if h.flags & hmm_mod.H_GA:
        fh.write("GA    %.2f %.2f\n" % (h.cutoff[C.CUT_GA1], h.cutoff[C.CUT_GA2]))
    if h.flags & hmm_mod.H_TC:
        fh.write("TC    %.2f %.2f\n" % (h.cutoff[C.CUT_TC1], h.cutoff[C.CUT_TC2]))
    if h.flags & hmm_mod.H_NC:
        fh.write("NC    %.2f %.2f\n" % (h.cutoff[C.CUT_NC1], h.cutoff[C.CUT_NC2]))
    if h.flags & hmm_mod.H_STATS:
        ev = h.evparam
        fh.write("STATS LOCAL MSV         %8.4f %8.5f\n" % (ev[C.EV_MMU], ev[C.EV_MLAMBDA]))
        fh.write("STATS LOCAL VITERBI     %8.4f %8.5f\n" % (ev[C.EV_VMU], ev[C.EV_VLAMBDA]))
        fh.write("STATS LOCAL FORWARD     %8.4f %8.5f\n" % (ev[C.EV_FTAU], ev[C.EV_FLAMBDA]))
        if h.fs:
            fh.write("STATS LOCAL FS3 FORWARD %8.4f %8.5f\n" % (ev[C.EV_FTAUFS3], ev[C.EV_FLAMBDA]))
            fh.write("STATS LOCAL FS5 FORWARD %8.4f %8.5f\n" % (ev[C.EV_FTAUFS5], ev[C.EV_FLAMBDA]))
        if h.fs:
            fh.write("FRAMESHIFT PROB  %8.4f\n" % h.fsprob)
        if h.ct:
            fh.write("CODON TABLE  %d\n" % h.ct)

    fh.write("HMM     ")
    for x in range(K):
        fh.write("     %c   " % h.abc.sym[x])
    fh.write("\n")
    fh.write("        %8s %8s %8s %8s %8s %8s %8s\n" %
             ("m->m", "m->i", "m->d", "i->m", "i->i", "d->m", "d->d"))
    if h.flags & hmm_mod.H_COMPO and h.compo is not None:
        fh.write("  COMPO ")
        fh.write("".join(_field(p) for p in h.compo))
        fh.write("\n")
    fh.write("        ")
    fh.write("".join(_field(p) for p in h.ins[0]))
    fh.write("\n")
    fh.write("        ")
    fh.write("".join(_field(p) for p in h.t[0]))
    fh.write("\n")
    for k in range(1, h.M + 1):
        fh.write(" %6d " % k)
        fh.write("".join(_field(p) for p in h.mat[k]))
        if h.flags & hmm_mod.H_MAP and h.map is not None:
            fh.write(" %6d" % h.map[k])
        else:
            fh.write(" %6s" % "-")
        fh.write(" %c" % (h.consensus[k - 1] if h.flags & hmm_mod.H_CONS else "-"))
        fh.write(" %c" % (h.rf[k - 1] if h.flags & hmm_mod.H_RF else "-"))
        fh.write(" %c" % (h.mm[k - 1] if h.flags & hmm_mod.H_MMASK else "-"))
        fh.write(" %c\n" % (h.cs[k - 1] if h.flags & hmm_mod.H_CS else "-"))
        fh.write("        ")
        fh.write("".join(_field(p) for p in h.ins[k]))
        fh.write("\n")
        fh.write("        ")
        fh.write("".join(_field(p) for p in h.t[k]))
        fh.write("\n")
    fh.write("//\n")


# ---------------------------------------------------------------------
# HMMER2.0 ASCII compatibility reader
# (ref: p7_hmmfile.c read_asc20hmm :1816 — the legacy end of the
# format-autodetect chain; models are converted to H3 semantics and
# re-calibrated on the fly)
# ---------------------------------------------------------------------
def _h2prob(s: str, null: float) -> float:
    """HMMER2 integer log-odds field -> probability
    (ref: h2ascii2prob; scores are 1000*log2(p/null), '*' = 0)."""
    return 0.0 if s == "*" else null * 2.0 ** (int(s) / 1000.0)


def _read_hmmer2(fh: TextIO) -> HMM:
    from .bg import Background

    hdr: dict[str, str] = {}
    cutoffs: dict[str, tuple[float, float]] = {}
    abc = None
    M = 0
    nule: list[float] | None = None
    flags_rf = flags_cs = flags_map = False
    for line in fh:
        tok = line.split()
        if not tok:
            continue
        key = tok[0]
        if key == "HMM":
            break
        if key == "ALPH":
            kind = tok[1].lower()
            if kind == "nucleic":
                abc = dna()
            elif kind == "amino":
                abc = amino()
            else:
                raise ValueError(f"unrecognized ALPH {tok[1]!r}")
        elif key == "LENG":
            M = int(tok[1])
        elif key == "NULE":
            if abc is None:
                raise ValueError("ALPH must precede NULE in HMMER2 "
                                 "save files")
            nule = [_h2prob(t, 1.0 / abc.K) for t in tok[1:abc.K + 1]]
        elif key == "RF":
            flags_rf = tok[1].lower() == "yes"
        elif key == "CS":
            flags_cs = tok[1].lower() == "yes"
        elif key == "MAP":
            flags_map = tok[1].lower() == "yes"
        elif key in ("GA", "TC", "NC"):
            cutoffs[key] = (float(tok[1]),
                            float(tok[2]) if len(tok) > 2
                            else float(tok[1]))
        elif key in ("NAME", "ACC", "NSEQ", "DATE"):
            hdr[key] = line[len(key):].strip()
        elif key == "DESC":
            hdr[key] = line[4:].strip()
    if abc is None:
        raise ValueError("No ALPH found for HMMER2 model")
    if M <= 0:
        raise ValueError("No LENG found for HMMER2 model")
    if nule is None:
        nule = [1.0 / abc.K] * abc.K

    bg = Background(abc)
    h = HMM.zeros(M, abc)
    h.name = hdr.get("NAME", "")
    h.acc = hdr.get("ACC", "")
    h.desc = hdr.get("DESC", "")
    h.nseq = int(hdr.get("NSEQ", "0") or 0)
    for key, (a, b) in cutoffs.items():
        h.cutoff[{"GA": C.CUT_GA1, "TC": C.CUT_TC1,
                  "NC": C.CUT_NC1}[key]] = a
        h.cutoff[{"GA": C.CUT_GA2, "TC": C.CUT_TC2,
                  "NC": C.CUT_NC2}[key]] = b
        h.flags |= {"GA": hmm_mod.H_GA, "TC": hmm_mod.H_TC,
                    "NC": hmm_mod.H_NC}[key]

    next(fh)                           # "m->m m->i ..." header line
    tbd1 = next(fh).split()            # B->M1 / B->I0 / B->D1
    h.t[0, C.H_MM] = _h2prob(tbd1[0], 1.0)
    h.t[0, C.H_MI] = 0.0
    h.t[0, C.H_MD] = _h2prob(tbd1[2], 1.0)
    h.t[0, C.H_IM] = 1.0
    h.t[0, C.H_II] = 0.0
    h.t[0, C.H_DM] = 1.0
    h.t[0, C.H_DD] = 0.0
    h.ins[0, :] = bg.f[:abc.K]
    rf_chars = [" "] * (M + 1)
    if flags_map:
        h.map = np.zeros(M + 1, dtype=np.int64)

    for k in range(1, M + 1):
        tok = next(fh).split()
        if int(tok[0]) != k:
            raise ValueError(f"expected match line for node {k}, "
                             f"saw {tok[0]!r}")
        for x in range(abc.K):
            h.mat[k, x] = _h2prob(tok[1 + x], nule[x])
        if flags_map and len(tok) > 1 + abc.K:
            h.map[k] = int(tok[1 + abc.K])
        tok = next(fh).split()          # insert line: RF + (ignored)
        if flags_rf:
            rf_chars[k] = tok[0][0]
        h.ins[k, :] = bg.f[:abc.K]
        tok = next(fh).split()          # transition line: CS + 7
        if k < M:
            for x in range(7):
                h.t[k, x] = _h2prob(tok[1 + x], 1.0)
    h.t[M, :] = [1.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    if flags_rf:
        h.rf = "".join(rf_chars)
    for line in fh:                     # the closing //
        if line.strip() == "//":
            break

    # renormalize, set consensus, calibrate (H3 statistics)
    for k in range(M + 1):
        for block in ((C.H_MM, C.H_MI, C.H_MD), (C.H_IM, C.H_II),
                      (C.H_DM, C.H_DD)):
            tot = float(sum(h.t[k, x] for x in block))
            if tot > 0:
                for x in block:
                    h.t[k, x] /= tot
        if k >= 1:
            tot = float(h.mat[k].sum())
            if tot > 0:
                h.mat[k] /= tot
            tot = float(h.ins[k].sum())
            if tot > 0:
                h.ins[k] /= tot
    from .builder import set_consensus
    set_consensus(h)
    h.set_composition()
    from .evalues import CalibrateConfig, calibrate
    calibrate(h, CalibrateConfig(), bg=Background(abc))
    return h
