"""NCBI genetic code tables, codon translation, and ORF extraction.

Re-provides the Easel `esl_gencode` functionality the reference
framework uses (ref: src/bathsearch.c do_sq_by_sequences,
p7_bg.c p7_bg_fs_FilterScore, modelconfig.c p7_ProfileConfig_fs).

Codon index convention (matches Easel digital nt codes A=0,C=1,G=2,T=3):
    codon = 16*x1 + 4*x2 + x3.

NCBI table strings enumerate codons in TCAG order (TTT, TTC, TTA, ...);
we remap to the digital convention at load time.

ORF extraction semantics (validated against reference golden outputs):
  * three frames, scanning the window left to right;
  * an ORF is a maximal run of non-stop codons (default: start anywhere;
    options restrict starts to AUG / to the table's initiators);
  * stop codons terminate (and are excluded from) ORFs;
  * ORFs shorter than `minlen` aa are discarded (default 20, ref
    bathsearch.c options "-l");
  * ORFs are emitted in order of their *end* position, frames
    interleaved, then remaining open ORFs in frame order at the end;
  * coordinates: for a forward-strand window, start/end are 1-based nt
    positions within the window (start<end).  For a reverse-complement
    window, start/end are positions in the ORIGINAL orientation:
    start = n - apos_start + 1 > end = n - apos_end + 1, which is the
    convention p7_Pipeline_BATH expects (ref: p7_pipeline.c:1399-1404,
    1692-1698).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .alphabet import Alphabet, amino, dna

# NCBI translation tables: id -> (name, aa string, starts string),
# codons enumerated base1-major in TCAG order (standard NCBI layout).
_NCBI = {
    1: ("Standard",
        "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "---M------**--*----M---------------M----------------------------"),
    2: ("Vertebrate mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
        "----------**--------------------MMMM----------**---M------------"),
    3: ("Yeast mitochondrial",
        "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "----------**----------------------MM----------------------------"),
    4: ("Mold, protozoan, coelenterate mitochondrial; Mycoplasma/Spiroplasma",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--MM------**-------M------------MMMM---------------M------------"),
    5: ("Invertebrate mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
        "---M------**--------------------MMMM---------------M------------"),
    6: ("Ciliate, dasycladacean, Hexamita nuclear",
        "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--------------*--------------------M----------------------------"),
    9: ("Echinoderm and flatworm mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
        "----------**-----------------------M---------------M------------"),
    10: ("Euplotid nuclear",
         "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**-----------------------M----------------------------"),
    11: ("Bacterial, archaeal; and plant plastid",
         "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**--*----M------------MMMM---------------M------------"),
    12: ("Alternative yeast",
         "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**--*----M---------------M----------------------------"),
    13: ("Ascidian mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
         "---M------**----------------------MM---------------M------------"),
    14: ("Alternative flatworm mitochondrial",
         "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "-----------*-----------------------M----------------------------"),
    16: ("Chlorophycean mitochondrial",
         "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------*---*--------------------M----------------------------"),
    21: ("Trematode mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "----------**----------------------MM---------------M------------"),
    22: ("Scenedesmus obliquus mitochondrial",
         "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "------*---*---*--------------------M----------------------------"),
    23: ("Thraustochytrium mitochondrial",
         "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--*-------**--*--------------------M---M---------------M--------"),
    24: ("Rhabdopleuridae mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
         "---M------**-------M---------------M---------------M------------"),
    25: ("Candidate division SR1 and Gracilibacteria",
         "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**-----------------------M---------------M------------"),
}

_NCBI_BASE_ORDER = "TCAG"


@dataclass
class GeneticCode:
    """Genetic code with digital codon -> digital amino mapping."""
    transl_table: int
    description: str
    basic: np.ndarray          # [64] int: digital aa; stop -> aa_abc.Kp-2 ('*')
    is_initiator: np.ndarray   # [64] bool
    nt_abc: Alphabet = field(default_factory=dna)
    aa_abc: Alphabet = field(default_factory=amino)

    @classmethod
    def create(cls, transl_table: int = 1) -> "GeneticCode":
        if transl_table not in _NCBI:
            raise ValueError(f"unknown NCBI translation table {transl_table}")
        name, aas, starts = _NCBI[transl_table]
        aa_abc, nt_abc = amino(), dna()
        basic = np.zeros(64, dtype=np.int32)
        init = np.zeros(64, dtype=bool)
        for i in range(64):
            b1, b2, b3 = _NCBI_BASE_ORDER[i // 16], _NCBI_BASE_ORDER[(i // 4) % 4], _NCBI_BASE_ORDER[i % 4]
            digital = (16 * nt_abc.index[b1] + 4 * nt_abc.index[b2]
                       + nt_abc.index[b3])
            aa = aas[i]
            basic[digital] = aa_abc.Kp - 2 if aa == "*" else aa_abc.index[aa]
            init[digital] = (starts[i] == "M")
        return cls(transl_table, name, basic, init)

    # --- initiator policy (ref: esl_gencode_SetInitiator*) ----------
    def set_initiator_any(self):
        """Any sense codon can start an ORF (bathsearch default)."""
        self.is_initiator = self.basic != (self.aa_abc.Kp - 2)

    def set_initiator_only_aug(self):
        a = self.nt_abc
        self.is_initiator = np.zeros(64, dtype=bool)
        self.is_initiator[16 * a.index["A"] + 4 * a.index["T"] + a.index["G"]] = True

    def is_stop(self, codon_idx: int) -> bool:
        return int(self.basic[codon_idx]) == self.aa_abc.Kp - 2

    # --- single-codon translation (ref: esl_gencode_GetTranslation) -
    def translate_codon(self, x1: int, x2: int, x3: int) -> int:
        """Translate one (possibly degenerate) digital codon to a
        digital amino.  If all compatible disambiguations agree, return
        that residue; otherwise return X (amino Kp-3).  Codons with
        gap/missing characters return X as well."""
        if x1 < 4 and x2 < 4 and x3 < 4:
            return int(self.basic[16 * x1 + 4 * x2 + x3])
        nt = self.nt_abc
        Kp = nt.Kp
        sets = []
        for x in (x1, x2, x3):
            if x < 4:
                sets.append([x])
            elif 4 < x < Kp - 2:   # degenerate (skip gap at index 4)
                sets.append(list(np.nonzero(nt.degen[x, :4])[0]))
            else:
                return self.aa_abc.any_idx
        aa = None
        for a in sets[0]:
            for b in sets[1]:
                for c in sets[2]:
                    t = int(self.basic[16 * a + 4 * b + c])
                    if aa is None:
                        aa = t
                    elif t != aa:
                        return self.aa_abc.any_idx
        return aa if aa is not None else self.aa_abc.any_idx

    def translate_vec(self, dsq: np.ndarray, frame: int) -> np.ndarray:
        """Translate a digital DNA array in a given frame (0/1/2) to a
        digital amino array (length (n-frame)//3).  Canonical codons
        translate via one table gather; degenerates fall back to the
        scalar disambiguator."""
        n = (len(dsq) - frame) // 3
        if n <= 0:
            return np.empty(0, dtype=np.int32)
        end = frame + 3 * n
        x1 = dsq[frame:end:3]
        x2 = dsq[frame + 1:end:3]
        x3 = dsq[frame + 2:end:3]
        canon = (x1 < 4) & (x2 < 4) & (x3 < 4)
        out = np.empty(n, dtype=np.int32)
        idx = 16 * x1.astype(np.int64) + 4 * x2 + x3
        out[canon] = self.basic[np.where(canon, idx, 0)][canon]
        for j in np.nonzero(~canon)[0]:
            out[j] = self.translate_codon(int(x1[j]), int(x2[j]),
                                          int(x3[j]))
        return out


@dataclass(slots=True)
class Orf:
    """One open reading frame extracted from a DNA window."""
    dsq: np.ndarray     # digital amino sequence
    start: int          # nt coord of first codon nt (see module docstring)
    end: int            # nt coord of last codon nt
    frame: int          # 0,1,2 in scanning orientation
    idx: int = -1       # scratch: which DNA window this ORF maps to

    @property
    def n(self) -> int:
        return len(self.dsq)


class OrfList(list):
    """List of Orfs that may carry the flat concatenated layout the
    native extractor produced (flat/offs/lens), so batch filter calls
    skip re-concatenating thousands of small arrays."""
    flat = None
    offs = None
    lens = None
    starts = None       # per-ORF nt coords (native path)
    ends = None


class LazyOrfList:
    """Sequence of Orfs materialized on demand from the native
    extractor's flat layout.  At scale, ~99% of ORFs fail the
    vectorized F1 gate without ever being touched as Python objects;
    materializing only survivors removes the dominant per-ORF cost of
    the big-database scan."""

    __slots__ = ("flat", "offs", "lens", "starts", "ends", "frames",
                 "_cache")

    def __init__(self, flat, offs, lens, starts, ends, frames):
        self.flat = flat
        self.offs = offs
        self.lens = lens
        self.starts = starts
        self.ends = ends
        self.frames = frames
        self._cache: dict[int, Orf] = {}

    def __len__(self):
        return len(self.lens)

    def __getitem__(self, i):
        o = self._cache.get(i)
        if o is None:
            off = int(self.offs[i])
            o = Orf(self.flat[off:off + int(self.lens[i])],
                    int(self.starts[i]), int(self.ends[i]),
                    int(self.frames[i]))
            self._cache[i] = o
        return o

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        return len(self) > 0


def reslice_orfs(orfs, d: int, *, L: int, is_revcomp: bool,
                 minlen: int, require_initiator: bool,
                 gcode: GeneticCode, dsq: np.ndarray):
    """Derive the ORF list extract_orfs would produce on the window
    shortened by <d> nt of context, from the full window's list —
    without re-extracting.

    The multi-query drive shares one window stream whose overlap is
    the MAX of the per-query `om->max_length*3` overlaps (ref:
    bathsearch.c:1099); a query with a smaller overlap sees a window
    whose first d nt (forward strand) / last d nt (reverse strand,
    i.e. the first d of the pre-revcomp window) are absent.  Both
    overlaps are multiples of 3, so (d % 3 == 0) the codon grid and
    frame labels are identical and the serial list differs from the
    shared one only at the truncated edge:

    * forward (left-truncated by d): every ORF drops its codons that
      start before position d+1; fully-dropped or now-sub-minlen ORFs
      vanish; with require_initiator a truncated ORF re-anchors at
      its first initiator codon >= d+1.  Closure and emission order
      are untouched (stops are to the right of the cut).
    * reverse (right-truncated by d, since revcomp(x[d:]) is a PREFIX
      of revcomp(x)): every ORF keeps only codons whose smallest
      original-orientation coordinate is >= d+1; an ORF that loses
      codons, or whose terminating stop codon straddles the cut
      (end <= d+3), becomes OPEN and moves to the end-of-window flush
      group (frame order 0,1,2 — extract_orfs's flush rule), exactly
      as serial extraction would classify it.

    All coordinates stay in the SHARED window's convention (serial
    coords + d), which downstream consumers combine with the shared
    window object's start/n — the sums are invariant (verified by
    tests/test_multiquery.py byte parity).  Returns a LazyOrfList
    sharing the input's flat amino buffer, or a list[Orf] for the
    pure-Python representation."""
    assert d % 3 == 0 and d > 0
    if getattr(orfs, "flat", None) is None:
        # pure-Python Orf list (native extractor unavailable): wrap
        # into arrays, reslice, rebuild
        if len(orfs) == 0:
            return orfs
        starts = np.array([o.start for o in orfs], np.int64)
        ends = np.array([o.end for o in orfs], np.int64)
        frames = np.array([o.frame for o in orfs], np.int64)
        lens = np.array([o.n for o in orfs], np.int64)
        flat = np.concatenate([np.asarray(o.dsq) for o in orfs])
        offs = np.zeros(len(orfs), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        lite = LazyOrfList(flat, offs, lens, starts, ends, frames)
        v = reslice_orfs(lite, d, L=L, is_revcomp=is_revcomp,
                         minlen=minlen,
                         require_initiator=require_initiator,
                         gcode=gcode, dsq=dsq)
        return [Orf(np.array(v.flat[v.offs[i]:v.offs[i] + v.lens[i]]),
                    int(v.starts[i]), int(v.ends[i]),
                    int(v.frames[i])) for i in range(len(v))]

    starts = np.asarray(orfs.starts, np.int64)
    ends = np.asarray(orfs.ends, np.int64)
    lens = np.asarray(orfs.lens, np.int64)
    offs = np.asarray(orfs.offs, np.int64)
    frames = np.asarray(orfs.frames, np.int64)
    eff_min = max(int(minlen), 1)
    if not is_revcomp:
        # drop codons starting before d+1: codon j of an ORF starts
        # at start+3j, so n_drop = ceil((d+1-start)/3)
        ndrop = np.maximum(0, (d + 3 - starts) // 3)
        if require_initiator:
            hit = np.nonzero((ndrop > 0) & (ndrop < lens))[0]
            init = gcode.is_initiator
            for i in hit:
                s, n, j = int(starts[i]), int(lens[i]), int(ndrop[i])
                while j < n:
                    p = s - 1 + 3 * j
                    x1, x2, x3 = int(dsq[p]), int(dsq[p + 1]), \
                        int(dsq[p + 2])
                    if x1 < 4 and x2 < 4 and x3 < 4 and \
                            init[16 * x1 + 4 * x2 + x3]:
                        break
                    j += 1
                ndrop[i] = j
        newlens = lens - ndrop
        keep = newlens >= eff_min
        return LazyOrfList(orfs.flat, offs[keep] + ndrop[keep],
                           newlens[keep].astype(np.int32),
                           (starts + 3 * ndrop)[keep], ends[keep],
                           frames[keep])
    # reverse strand: keep codons whose smallest original coordinate
    # (start - 3j - 2 for codon j) is >= d+1
    nkeep = np.maximum(0, (starts - d) // 3)
    newlens = np.minimum(lens, nkeep)
    ntr = lens - newlens
    keep = newlens >= eff_min
    # shared-open <=> the ORF ends at its frame's last full codon
    # (end == ((L - f) % 3) + 1); serial-open additionally when
    # truncated or when the stop codon straddles the cut
    open_shared = ends == ((L - frames) % 3) + 1
    open_serial = (ntr > 0) | open_shared | (ends <= d + 3)
    ends2 = np.where(ntr > 0, starts - 3 * newlens + 1, ends)
    ki = np.nonzero(keep)[0]
    closed = ki[~open_serial[ki]]
    openk = ki[open_serial[ki]]
    openk = openk[np.argsort(frames[openk], kind="stable")]
    order = np.concatenate([closed, openk]) if len(ki) \
        else ki
    return LazyOrfList(orfs.flat, offs[order],
                       newlens[order].astype(np.int32),
                       starts[order], ends2[order], frames[order])


def extract_orfs(gcode: GeneticCode, dsq: np.ndarray, *,
                 minlen: int = 20, is_revcomp: bool = False,
                 require_initiator: bool = False) -> list[Orf]:
    """Extract ORFs from a digital DNA window in all 3 frames.

    Emission order matches Easel's ProcessPiece walk: codons are
    processed in order of their end position (frames interleaved); an
    ORF is appended when its terminating stop codon is reached, and
    remaining open ORFs are flushed in frame order 0,1,2 at the end
    (ref: esl_gencode ProcessStart/Piece/End usage in bathsearch.c:385).
    """
    # native C++ fast path (bath_tpu_torch/native, src at native/src/bathio.cpp)
    from . import native as _native
    fast = _native.extract_orfs_native(
        gcode, dsq, minlen=minlen, is_revcomp=is_revcomp,
        require_initiator=require_initiator)
    if fast is not None:
        return fast

    L = len(dsq)
    orfs: list[Orf] = []
    aa_buf: list[list[int]] = [[], [], []]
    orf_start = [0, 0, 0]         # 1-based apos of first nt of ORF
    in_orf = [False, False, False]
    stop_aa = gcode.aa_abc.Kp - 2

    def finish(f: int, apos_last: int):
        if in_orf[f] and len(aa_buf[f]) >= minlen:
            s, e = orf_start[f], apos_last
            if is_revcomp:
                s, e = L - s + 1, L - e + 1
            orfs.append(Orf(np.array(aa_buf[f], dtype=np.int32), s, e, f))
        aa_buf[f] = []
        in_orf[f] = False

    for e in range(3, L + 1):        # e = 1-based end position of a codon
        f = e % 3                    # frame whose codon ends at e
        x1, x2, x3 = int(dsq[e - 3]), int(dsq[e - 2]), int(dsq[e - 1])
        canonical = x1 < 4 and x2 < 4 and x3 < 4
        aa = (int(gcode.basic[16 * x1 + 4 * x2 + x3]) if canonical
              else gcode.translate_codon(x1, x2, x3))
        if aa == stop_aa:
            finish(f, e - 3)         # stop excluded; ORF ends at prev codon
        else:
            if not in_orf[f]:
                ok = True
                if require_initiator:
                    ok = canonical and bool(
                        gcode.is_initiator[16 * x1 + 4 * x2 + x3])
                if ok:
                    in_orf[f] = True
                    orf_start[f] = e - 2
                    aa_buf[f] = [aa]
                # else: stay out of ORF
            else:
                aa_buf[f].append(aa)

    for f in range(3):
        # last complete codon of frame f ends at the largest e<=L with e%3==f
        e_last = L - ((L - f) % 3)
        finish(f, e_last)
    return orfs
