"""Multiple sequence alignments: container, Stockholm / aligned-FASTA
readers, PB relative weighting, fragment marking.

Re-provides the subset of Easel's esl_msa / esl_msafile /
esl_msaweight that bathbuild depends on (ref: bathbuild.c,
p7_builder.c relative_weights :832, esl_msa_MarkFragments_old usage
at p7_builder.c:432).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .alphabet import Alphabet, amino, dna


@dataclass
class MSA:
    """Digital MSA.  ax is [nseq, alen] int32 in Easel digital codes
    (columns 0-based here; the reference's 1..alen maps to 0..alen-1)."""
    abc: Alphabet
    names: list[str]
    ax: np.ndarray
    wgt: np.ndarray | None = None
    rf: str | None = None           # #=GC RF consensus annotation
    mm: str | None = None           # #=GC MM model-mask annotation
    cs: str | None = None           # #=GC SS_cons
    name: str | None = None         # #=GF ID
    acc: str | None = None          # #=GF AC
    desc: str | None = None         # #=GF DE
    cutoffs: dict = field(default_factory=dict)   # GA/TC/NC -> (c1, c2)

    @property
    def nseq(self) -> int:
        return self.ax.shape[0]

    @property
    def alen(self) -> int:
        return self.ax.shape[1]

    def __post_init__(self):
        if self.wgt is None:
            self.wgt = np.ones(self.nseq)

    # -- classification helpers (digital codes) ----------------------
    def _is_residue(self, col) -> np.ndarray:
        """residue or degenerate or nonresidue-excluded?  Easel's
        XIsResidue: canonical or degenerate (incl. any), NOT gap /
        nonres / missing."""
        x = col
        K, Kp = self.abc.K, self.abc.Kp
        return (x < K) | ((x > K) & (x < Kp - 2))

    def _is_gap(self, col) -> np.ndarray:
        return col == self.abc.K

    def _is_missing(self, col) -> np.ndarray:
        return col == self.abc.Kp - 1

    # -- fragment marking (ref: esl_msa_MarkFragments_old) -----------
    def mark_fragments(self, fragthresh: float = 0.5):
        """A seq is a fragment if its aligned span (first..last residue
        column) covers < fragthresh * alen; its leading/trailing gaps
        become missing data '~' (ref: p7_builder.c:432)."""
        Kp = self.abc.Kp
        for idx in range(self.nseq):
            row = self.ax[idx]
            res = np.nonzero(self._is_residue(row))[0]
            if len(res) == 0:
                continue
            span = res[-1] - res[0] + 1
            if span < fragthresh * self.alen:
                row[:res[0]] = Kp - 1
                row[res[-1] + 1:] = Kp - 1

    # -- PB weights (ref: esl_msaweight_PB_adv, called from
    #    p7_builder.c relative_weights :845) ------------------------
    def _pb_consensus(self, fragthresh: float, symfrac: float
                      ) -> np.ndarray:
        """Consensus columns for PB weighting.  RF annotation wins if
        present; otherwise fragment-aware occupancy: column j is
        consensus iff nres[j] > symfrac * nspan[j], where nspan[j]
        counts non-fragment sequences everywhere and fragment
        sequences (aligned span < fragthresh * alen) only inside
        their span.  The strict '>' and the per-residue weight
        normalization below were validated empirically against the
        reference's committed testsuite models (Caudal_act, RRM_1,
        2OG-FeII_Oxy_3, 20aa all match to <5e-6)."""
        alen = self.alen
        if self.rf:
            use = np.array([c not in ".-_~" for c in self.rf])
            if use.any():
                return use
        is_res = self._is_residue(self.ax)
        nres = is_res.sum(axis=0)
        n = np.zeros(alen)
        for i in range(self.nseq):
            nz = np.nonzero(is_res[i])[0]
            if len(nz) == 0:
                continue
            span = nz[-1] - nz[0] + 1
            if span < fragthresh * alen:
                n[nz[0]:nz[-1] + 1] += 1.0
            else:
                n += 1.0
        use = (nres > 0) & (nres > symfrac * n)
        if not use.any():
            use = np.ones(alen, dtype=bool)
        return use

    def set_pb_weights(self, fragthresh: float = 0.5,
                       symfrac: float = 0.5):
        """Henikoff position-based weights, normalized to mean 1.
        Computed over consensus columns, with each sequence's raw
        Henikoff sum divided by its residue count in those columns
        (modern Easel esl_msaweight_PB_adv semantics)."""
        K = self.abc.K
        nseq = self.nseq
        w = np.zeros(nseq)
        # canonicalize: map degenerates to K (ignored), canonical kept
        canon = np.where(self.ax < K, self.ax, K)
        use = self._pb_consensus(fragthresh, symfrac)
        for apos in np.nonzero(use)[0]:
            col = canon[:, apos]
            mask = col < K
            if not mask.any():
                continue
            ct = np.bincount(col[mask], minlength=K + 1)
            r = int((ct > 0).sum())
            contrib = 1.0 / (r * ct[col[mask]])
            w[mask] += contrib
        nres = ((canon < K) & use[None, :]).sum(axis=1)
        w = np.where(nres > 0, w / np.maximum(nres, 1), 0.0)
        if w.sum() == 0:
            w[:] = 1.0
        self.wgt = w * (nseq / w.sum())

    # -- pairwise identity / clustering (ref: easel esl_dst_XPairId,
    #    esl_msacluster_SingleLinkage) ------------------------------
    def pairwise_pid_matrix(self) -> np.ndarray:
        """[nseq, nseq] fractional identity: identical canonical
        residue pairs / min(residue lengths)."""
        K = self.abc.K
        canon = np.where(self.ax < K, self.ax, -1)
        is_c = canon >= 0
        lens = is_c.sum(axis=1)
        N = self.nseq
        P = np.eye(N)
        for i in range(N):
            eq = (canon[i][None, :] == canon) & is_c[i][None, :]
            ident = eq.sum(axis=1)
            denom = np.minimum(lens[i], lens)
            P[i] = np.where(denom > 0, ident / np.maximum(denom, 1),
                            0.0)
        return P

    def single_linkage_clusters(self, maxid: float
                                ) -> tuple[np.ndarray, int]:
        """Single-linkage clusters linking pairs with fractional
        identity >= maxid.  Returns (labels, nclusters)."""
        P = self.pairwise_pid_matrix()
        N = self.nseq
        parent = list(range(N))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i in range(N):
            for j in range(i + 1, N):
                if P[i, j] >= maxid:
                    parent[find(i)] = find(j)
        roots = {}
        labels = np.zeros(N, dtype=np.int64)
        for i in range(N):
            r = find(i)
            labels[i] = roots.setdefault(r, len(roots))
        return labels, len(roots)

    # -- BLOSUM filter weights (ref: esl_msaweight_BLOSUM) -----------
    def set_blosum_weights(self, wid: float = 0.62):
        """Henikoff filter weights: 1/cluster-size at the <wid>
        single-linkage identity cutoff, normalized to mean 1."""
        labels, _ = self.single_linkage_clusters(wid)
        sizes = np.bincount(labels)
        w = 1.0 / sizes[labels]
        self.wgt = w * (self.nseq / w.sum())

    # -- GSC tree weights (ref: esl_msaweight_GSC) -------------------
    def set_gsc_weights(self):
        """Gerstein/Sonnhammer/Chothia weights: UPGMA tree on
        fractional-difference distances; each branch length is split
        evenly among the leaves below it; normalized to mean 1."""
        N = self.nseq
        if N < 2:
            self.wgt = np.ones(N)
            return
        D = 1.0 - self.pairwise_pid_matrix()
        # UPGMA: heights = join distance / 2
        active = {i: ([i], 0.0) for i in range(N)}  # node: (leaves, h)
        dist = {(i, j): D[i, j] for i in range(N) for j in range(i)}

        def get(a, b):
            return dist[(a, b) if a > b else (b, a)]

        w = np.zeros(N)
        nxt = N
        while len(active) > 1:
            (a, b) = min(((a, b) for a in active for b in active
                          if a > b), key=lambda p: get(*p))
            la, ha = active[a]
            lb, hb = active[b]
            h = get(a, b) / 2.0
            # distribute the two child branch lengths evenly among
            # the leaves below each child
            w[la] += max(h - ha, 0.0) / len(la)
            w[lb] += max(h - hb, 0.0) / len(lb)
            merged = la + lb
            for c in list(active):
                if c in (a, b):
                    continue
                lc, _ = active[c]
                dnew = (get(a, c) * len(la) + get(b, c) * len(lb)) \
                    / (len(la) + len(lb))
                dist[(max(nxt, c), min(nxt, c))] = dnew
            del active[a], active[b]
            active[nxt] = (merged, h)
            nxt += 1
        if w.sum() <= 0:
            self.wgt = np.ones(N)
        else:
            self.wgt = w * (N / w.sum())

    def checksum(self) -> int:
        """32-bit order-dependent checksum of the digital residues
        (our own stable definition; the reference uses
        esl_msa_Checksum, whose exact constants live in the absent
        Easel submodule)."""
        h = 0
        for idx in range(self.nseq):
            for x in self.ax[idx]:
                h = (h * 31 + int(x) + 1) & 0xFFFFFFFF
        return h


# ---------------------------------------------------------------------
# Stockholm reader
# ---------------------------------------------------------------------
def _finish_msa(abc, names, seqs, gc, gf, cutoffs) -> MSA:
    alen = len(seqs[names[0]])
    ax = np.zeros((len(names), alen), dtype=np.int32)
    for i, n in enumerate(names):
        s = seqs[n]
        if len(s) != alen:
            raise ValueError(f"ragged alignment for {n}")
        ax[i] = abc.digitize(s)
    msa = MSA(abc=abc, names=list(names), ax=ax)
    msa.rf = gc.get("RF")
    msa.mm = gc.get("MM")
    msa.cs = gc.get("SS_cons")
    msa.name = gf.get("ID")
    msa.acc = gf.get("AC")
    msa.desc = gf.get("DE")
    msa.cutoffs = cutoffs
    return msa


def read_stockholm(path: str, abc: Alphabet | None = None) -> list[MSA]:
    """Parse a (possibly multi-MSA) Stockholm file
    (ref: easel Stockholm format as consumed by bathbuild.c)."""
    out = []
    from .sequence import _open_text
    with _open_text(path) as fh:
        text = fh.read()
    blocks = text.split("\n//")
    for blk in blocks:
        lines = [ln.rstrip("\n") for ln in blk.split("\n")]
        names: list[str] = []
        seqs: dict[str, str] = {}
        gc: dict[str, str] = {}
        gf: dict[str, str] = {}
        cutoffs: dict = {}
        saw_seq = False
        for ln in lines:
            if not ln.strip():
                continue
            if ln.startswith("# STOCKHOLM"):
                continue
            if ln.startswith("#=GF"):
                parts = ln.split(None, 2)
                if len(parts) >= 3:
                    tag, val = parts[1], parts[2]
                    if tag in ("GA", "TC", "NC"):
                        nums = [float(v.rstrip(";")) for v in val.split()]
                        cutoffs[tag] = (nums[0],
                                        nums[1] if len(nums) > 1 else None)
                    elif tag in gf:
                        gf[tag] += " " + val
                    else:
                        gf[tag] = val
                continue
            if ln.startswith("#=GC"):
                parts = ln.split()
                if len(parts) >= 3:
                    gc[parts[1]] = gc.get(parts[1], "") + parts[2]
                continue
            if ln.startswith("#=GS") or ln.startswith("#=GR"):
                continue
            if ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) >= 2:
                nm, chunk = parts[0], "".join(parts[1:])
                if nm not in seqs:
                    names.append(nm)
                    seqs[nm] = ""
                seqs[nm] += chunk
                saw_seq = True
        if not saw_seq:
            continue
        a = abc or guess_alphabet("".join(seqs[n] for n in names[:4]))
        out.append(_finish_msa(a, names, seqs, gc, gf, cutoffs))
    return out


def read_afa(path: str, abc: Alphabet | None = None) -> list[MSA]:
    """Aligned FASTA: one MSA per file."""
    names, seqs = [], {}
    cur = None
    from .sequence import _open_text
    with _open_text(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            if ln.startswith(">"):
                cur = ln[1:].split()[0]
                names.append(cur)
                seqs[cur] = ""
            elif cur is not None:
                seqs[cur] += ln
    if not names:
        return []
    a = abc or guess_alphabet("".join(seqs[n] for n in names[:4]))
    return [_finish_msa(a, names, seqs, {}, {}, {})]


def read_clustal(path: str, abc: Alphabet | None = None) -> list[MSA]:
    """Clustal / clustal-like (MUSCLE, PROBCONS, ...) interleaved
    alignment: a header line, then blocks of 'name  seq' rows with an
    optional conservation line (leading whitespace) per block.
    (ref: Easel esl_msafile_clustal, selected by bathbuild
    --informat clustal — src/bathbuild.c:382)"""
    from .sequence import _open_text
    names: list[str] = []
    seqs: dict[str, str] = {}
    with _open_text(path) as fh:
        header = fh.readline()
        if not header.split() or header.split()[0].upper() not in (
                "CLUSTAL", "CLUSTALW", "MUSCLE", "PROBCONS", "KALIGN",
                "MSAPROBS") and "multiple sequence alignment" \
                not in header.lower():
            raise ValueError(f"not a clustal file: {path}")
        for ln in fh:
            if not ln.strip():
                continue
            if ln[0] in " \t":      # conservation line (:.* symbols)
                continue
            parts = ln.split()
            if len(parts) < 2:
                continue
            nm = parts[0]
            chunk = "".join(parts[1:])
            # trailing residue-count column (clustalw emits it)
            if chunk and chunk[-1].isdigit():
                chunk = chunk.rstrip("0123456789")
            if nm not in seqs:
                names.append(nm)
                seqs[nm] = ""
            seqs[nm] += chunk
    if not names:
        return []
    a = abc or guess_alphabet("".join(seqs[n] for n in names[:4]))
    return [_finish_msa(a, names, seqs, {}, {}, {})]


def read_psiblast(path: str, abc: Alphabet | None = None) -> list[MSA]:
    """PSI-BLAST interleaved alignment: clustal-like blocks with no
    header line; gaps '-', match columns uppercase.
    (ref: Easel esl_msafile_psiblast, --informat psiblast)"""
    from .sequence import _open_text
    names: list[str] = []
    seqs: dict[str, str] = {}
    with _open_text(path) as fh:
        for ln in fh:
            if not ln.strip() or ln[0] in " \t":
                continue
            parts = ln.split()
            if len(parts) < 2:
                continue
            nm = parts[0]
            chunk = "".join(p for p in parts[1:] if not p.isdigit())
            if nm not in seqs:
                names.append(nm)
                seqs[nm] = ""
            seqs[nm] += chunk
    if not names:
        return []
    a = abc or guess_alphabet("".join(seqs[n] for n in names[:4]))
    return [_finish_msa(a, names, seqs, {}, {}, {})]


def read_a2m(path: str, abc: Alphabet | None = None) -> list[MSA]:
    """Dotless A2M (UCSC SAM): FASTA-like; uppercase + '-' are
    consensus (match/delete) columns, lowercase are inserts, '.'
    optional padding.  Sequences may have ragged insert lengths:
    each insert region is padded with '.' to the per-region maximum,
    and an RF consensus annotation is synthesized ('x' = match col).
    (ref: Easel esl_msafile_a2m, --informat a2m)"""
    from .sequence import _open_text
    names, raw = [], {}
    cur = None
    with _open_text(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            if ln.startswith(">"):
                cur = ln[1:].split()[0]
                names.append(cur)
                raw[cur] = ""
            elif cur is not None:
                raw[cur] += ln.replace(".", "")
    if not names:
        return []
    # split every sequence into (insert0, match1, insert1, ..., matchM,
    # insertM) runs; match = uppercase or '-'
    per = {}
    nmatch = None
    for nm in names:
        segs = [""]                 # segs[0] = leading insert
        for c in raw[nm]:
            if c.isupper() or c == "-":
                segs.append(c)      # one match column
                segs.append("")     # following insert run
            else:
                segs[-1] += c
        nm_match = (len(segs) - 1) // 2
        if nmatch is None:
            nmatch = nm_match
        elif nm_match != nmatch:
            raise ValueError(
                f"a2m: {nm} has {nm_match} consensus columns, "
                f"expected {nmatch}")
        per[nm] = segs
    # pad each insert region to its max width
    maxins = [max(len(per[nm][2 * j]) for nm in names)
              for j in range(nmatch + 1)]
    seqs = {}
    for nm in names:
        segs = per[nm]
        out = []
        for j in range(nmatch + 1):
            ins = segs[2 * j]
            out.append(ins + "." * (maxins[j] - len(ins)))
            if j < nmatch:
                out.append(segs[2 * j + 1])
        seqs[nm] = "".join(out)
    rf = "".join("." * maxins[j] + ("x" if j < nmatch else "")
                 for j in range(nmatch + 1))
    a = abc or guess_alphabet("".join(raw[n] for n in names[:4]))
    out = _finish_msa(a, names, seqs, {}, {}, {})
    out.rf = rf
    return [out]


def read_phylip(path: str, abc: Alphabet | None = None) -> list[MSA]:
    """PHYLIP alignment, interleaved or sequential, autodetected:
    header 'nseq alen', 10-char (or whitespace-delimited) name field.
    (ref: Easel esl_msafile_phylip, --informat phylip/phylips)"""
    from .sequence import _open_text
    with _open_text(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    it = iter(lines)
    hdr = next((ln for ln in it if ln.strip()), None)
    if hdr is None:
        return []
    parts = hdr.split()
    if len(parts) < 2 or not parts[0].isdigit() or not parts[1].isdigit():
        raise ValueError(f"not a phylip file: {path}")
    nseq, alen = int(parts[0]), int(parts[1])
    body = [ln for ln in it if ln.strip()]

    def namesplit(ln):
        # strict phylip: name is columns 1-10; relaxed: first token
        if len(ln) > 10 and ln[10] == " " or (len(ln) >= 10
                                              and " " not in ln[:10]):
            nm, rest = ln[:10].strip(), ln[10:]
            if nm:
                return nm, rest.replace(" ", "")
        p = ln.split()
        return p[0], "".join(p[1:])

    names, seqs = [], {}
    first = body[:nseq]
    for ln in first:
        nm, chunk = namesplit(ln)
        names.append(nm)
        seqs[nm] = chunk
    rest = body[nseq:]
    if all(len(seqs[n]) >= alen for n in names):
        pass                        # one-line sequential, done
    elif rest and namesplit(rest[0])[0] == names[0] \
            and len(rest) % nseq == 0:
        # interleaved with repeated names
        for i, ln in enumerate(rest):
            nm, chunk = namesplit(ln)
            seqs[names[i % nseq]] += chunk
    else:
        # interleaved continuation blocks (names only in block 1) or
        # sequential continuation: fill shortest-first for interleave,
        # else append in order until each reaches alen
        if rest and len(rest) % nseq == 0:
            for i, ln in enumerate(rest):
                seqs[names[i % nseq]] += ln.replace(" ", "")
        else:
            i = 0
            for ln in rest:
                while i < nseq and len(seqs[names[i]]) >= alen:
                    i += 1
                if i >= nseq:
                    break
                seqs[names[i]] += ln.replace(" ", "")
    for n in names:
        if len(seqs[n]) != alen:
            raise ValueError(
                f"phylip: {n} has {len(seqs[n])} cols, header says "
                f"{alen}")
    a = abc or guess_alphabet("".join(seqs[n] for n in names[:4]))
    return [_finish_msa(a, names, seqs, {}, {}, {})]


_FORMAT_READERS = {
    "stockholm": read_stockholm, "pfam": read_stockholm,
    "afa": read_afa, "a2m": read_a2m, "clustal": read_clustal,
    "clustallike": read_clustal, "psiblast": read_psiblast,
    "phylip": read_phylip, "phylips": read_phylip,
}


def guess_alphabet(sample: str) -> Alphabet:
    """DNA if composition is overwhelmingly ACGTUN (Easel's guesser
    heuristic)."""
    s = sample.upper()
    res = [c for c in s if c.isalpha()]
    if not res:
        return amino()
    nuc = sum(1 for c in res if c in "ACGTUN")
    return dna() if nuc / len(res) > 0.9 else amino()


def read_msas(path: str, abc: Alphabet | None = None,
              fmt: str | None = None) -> list[MSA]:
    """Read MSAs; <fmt> asserts a format (stockholm/pfam/afa/a2m/
    clustal/clustallike/psiblast/phylip/phylips — the
    esl_msafile_EncodeFormat names bathbuild --informat accepts,
    src/bathbuild.c:382), else autodetect
    (ref: esl_msafile_Open format guessing)."""
    if fmt is not None:
        rd = _FORMAT_READERS.get(fmt.lower())
        if rd is None:
            raise ValueError(f"{fmt} is not a recognized MSA format")
        return rd(path, abc)
    from .sequence import _open_text
    with _open_text(path) as fh:
        head = fh.read(256)
    if head.startswith("# STOCKHOLM"):
        return read_stockholm(path, abc)
    first = head.lstrip()
    tok = first.split()[0].upper() if first.split() else ""
    if tok in ("CLUSTAL", "CLUSTALW", "MUSCLE", "PROBCONS", "KALIGN",
               "MSAPROBS"):
        return read_clustal(path, abc)
    hp = first.split("\n", 1)[0].split()
    if len(hp) == 2 and hp[0].isdigit() and hp[1].isdigit():
        return read_phylip(path, abc)
    if first.startswith(">"):
        return read_afa(path, abc)
    raise ValueError(f"unrecognized MSA format in {path}")
