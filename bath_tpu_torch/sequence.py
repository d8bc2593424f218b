"""Digital sequences and FASTA I/O with windowed reading.

Re-provides the Easel sequence-layer functionality bathsearch depends
on: FASTA parsing, digital sequences, reverse complement, and the
overlapping window stream of esl_sqio_ReadWindow (ref:
bathsearch.c:1060-1108 serial_loop; context C = max_length*3 carried
between windows, eslEOD at the end of each sequence).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from .alphabet import Alphabet, dna, revcomp


@dataclass
class Sequence:
    """A (window of a) digital sequence.

    Attributes mirror the ESL_SQ fields the pipeline uses:
      name/acc/desc  - annotation
      dsq            - digital residues (numpy int32, 0-based, no sentinels)
      start, end     - 1-based coords of this window in the source sequence;
                       start > end after reverse complementation
      L              - source sequence length if known, else -1
      W              - number of *new* (non-context) residues in this window
      C              - number of context (overlap) residues carried over
      idx            - index of the source sequence in the database
    """
    name: str
    dsq: np.ndarray
    acc: str = ""
    desc: str = ""
    start: int = 1
    end: int = 0
    L: int = -1
    W: int = 0
    C: int = 0
    idx: int = -1
    abc: Alphabet | None = None

    def __post_init__(self):
        if self.end == 0:
            self.end = self.start + len(self.dsq) - 1
        if self.W == 0:
            self.W = len(self.dsq)

    @property
    def n(self) -> int:
        return len(self.dsq)

    def reverse_complement(self) -> "Sequence":
        """Return the reverse complement window; start/end swap so that
        start > end, matching esl_sq_ReverseComplement."""
        return Sequence(name=self.name, dsq=revcomp(self.dsq), acc=self.acc,
                        desc=self.desc, start=self.end, end=self.start,
                        L=self.L, W=self.W, C=self.C, idx=self.idx,
                        abc=self.abc)



def _open_text(path: str):
    """Open a (possibly gzip-compressed) text file (the reference
    reads .gz inputs through a gzip pipe, esl_sqio/p7_hmmfile
    do_gzip)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import gzip
        return gzip.open(path, "rt")
    return open(path)

def parse_fasta(path: str, abc: Alphabet) -> Iterator[tuple[str, str, str]]:
    """Yield (name, desc, seqtext) records from a FASTA file.

    Chunked record reader (the per-line loop was the second-largest
    cost of a hitless 100MB scan); per-line edge-strip semantics are
    identical to a line loop's `line.strip()`."""
    CHUNK = 8 << 20
    with _open_text(path) as fh:
        pending = fh.read(CHUNK)
        if not pending:
            return
        more = True
        while True:
            nxt = pending.find("\n>")
            if nxt < 0:
                if more:
                    chunk = fh.read(CHUNK)
                    if chunk:
                        pending += chunk
                        continue
                    more = False
                rec, pending = pending, ""
            else:
                rec = pending[:nxt]
                pending = pending[nxt + 1:]
            if rec.startswith(">"):
                nl = rec.find("\n")
                hdr = (rec[1:nl] if nl >= 0 else rec[1:]).strip()
                parts = hdr.split(None, 1)
                name = parts[0] if parts else ""
                desc = parts[1] if len(parts) > 1 else ""
                body = rec[nl + 1:] if nl >= 0 else ""
                yield (name, desc,
                       "".join(ln.strip() for ln in body.split("\n")))
            # else: content before the first '>' header is ignored
            if not pending and not more:
                return


def parse_embl(path: str) -> Iterator[tuple[str, str, str, str]]:
    """Yield (name, acc, desc, seqtext) from an EMBL/UniProt-style
    flat file (ID/AC/DE/SQ records; ref: esl_sqio EMBL parser as
    exercised by testsuite/i9-optional-annotation.pl)."""
    name = acc = desc = ""
    in_seq = False
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith("//"):
                if name:
                    yield name, acc, desc, "".join(chunks)
                name = acc = desc = ""
                in_seq = False
                chunks = []
            elif line.startswith("ID"):
                parts = line[2:].split()
                name = parts[0].rstrip(";") if parts else ""
            elif line.startswith("AC"):
                parts = line[2:].split()
                if parts and not acc:
                    acc = parts[0].rstrip(";")
            elif line.startswith("DE"):
                d = line[2:].strip()
                desc = (desc + " " + d).strip() if desc else d
            elif line.startswith("SQ"):
                in_seq = True
            elif in_seq:
                chunks.append("".join(c for c in line
                                      if c.isalpha() or c == "*"))
    if name:
        yield name, acc, desc, "".join(chunks)


def parse_genbank(path: str) -> Iterator[tuple[str, str, str, str]]:
    """Yield (name, acc, desc, seqtext) from a GenBank/DDBJ flat file
    (LOCUS/ACCESSION/DEFINITION/ORIGIN records)."""
    name = acc = desc = ""
    in_seq = False
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith("//"):
                if name:
                    yield name, acc, desc, "".join(chunks)
                name = acc = desc = ""
                in_seq = False
                chunks = []
            elif line.startswith("LOCUS"):
                parts = line.split()
                name = parts[1] if len(parts) > 1 else ""
            elif line.startswith("ACCESSION"):
                parts = line.split()
                if len(parts) > 1:
                    acc = parts[1]
            elif line.startswith("DEFINITION"):
                desc = line[len("DEFINITION"):].strip()
            elif line.startswith("ORIGIN"):
                in_seq = True
            elif in_seq:
                chunks.append("".join(c for c in line
                                      if c.isalpha() or c == "*"))
    if name:
        yield name, acc, desc, "".join(chunks)


def parse_seqfile(path: str, abc: Alphabet | None = None
                  ) -> Iterator[tuple[str, str, str, str]]:
    """Autodetecting sequence reader: FASTA, EMBL/UniProt, or
    GenBank/DDBJ (ref: esl_sqio_Open format guessing).  Yields
    (name, acc, desc, seqtext)."""
    with _open_text(path) as fh:
        head = ""
        for line in fh:
            if line.strip():
                head = line
                break
    if head.startswith(">"):
        for name, desc, text in parse_fasta(path, abc):
            yield name, "", desc, text
    elif head.startswith("ID"):
        yield from parse_embl(path)
    elif head.startswith("LOCUS"):
        yield from parse_genbank(path)
    else:
        raise ValueError(f"unrecognized sequence file format: {path}")


def read_fasta(path: str, abc: Alphabet) -> list[Sequence]:
    out = []
    for i, (name, acc, desc, text) in enumerate(parse_seqfile(path,
                                                              abc)):
        dsq = abc.digitize(text)
        out.append(Sequence(name=name, acc=acc, desc=desc, dsq=dsq,
                            L=len(dsq), idx=i, abc=abc))
    return out


class LazySeqLookup:
    """Dict-like ``name -> (dsq, seqidx, L)`` view of a sequence
    database for the --splice post-pass.

    The reference reopens the target db and fetches sub-sequences via
    an SSI index instead of holding the genome in memory (ref:
    bathsearch.c:925ff, splice.c GetSubSequence).  Here a plain FASTA
    file is byte-offset indexed in one streaming scan; each sequence
    body is read and digitized only when a splice seed actually needs
    it, with a small LRU so per-chromosome hit clusters reuse the
    fetch.  Gzip or non-FASTA inputs fall back to eager loading.
    """

    def __init__(self, path: str, abc: Alphabet, max_cached: int = 4):
        self.path = path
        self.abc = abc
        self.max_cached = max_cached
        self._cache: dict[str, tuple[np.ndarray, int, int]] = {}
        self._index: dict[str, tuple[int, int, int, int]] = {}
        self._eager: dict[str, tuple[np.ndarray, int, int]] | None = None
        with open(path, "rb") as probe:
            head = probe.read(2)
        if not head.startswith(b">"):
            # gzip / EMBL / GenBank: no cheap random access — load all
            self._eager = {}
            for si, sq in enumerate(read_fasta(path, abc)):
                self._eager[sq.name] = (sq.dsq, si, sq.n)
            return
        # an Easel SSI index skips the offset scan entirely (the
        # reference's GetSubSequence path); seqidx is file order =
        # ascending record offset, body_end = next record's header
        ix = path + ".ssi"
        if os.path.exists(ix):
            from .ssi import read_esl_ssi
            ssi = read_esl_ssi(ix)
            # single-FASTA-file indexes only: every offset must refer
            # to <path> (a multi-file SSI's fnum>0 records would be
            # applied to the wrong file)
            if ssi and len(ssi["files"]) == 1 \
                    and ssi["files"][0][1] == 1 and ssi["primary"] \
                    and all(v[0] == 0
                            for v in ssi["primary"].values()):
                ents = sorted(ssi["primary"].items(),
                              key=lambda kv: kv[1][1])
                fsize = os.path.getsize(path)
                for si, (k, (_fn, r_off, d_off, L)) in enumerate(ents):
                    end = (ents[si + 1][1][1] if si + 1 < len(ents)
                           else fsize)
                    self._index[k] = (d_off, end, L, si)
                return
        # streaming offset scan: name -> (body_start, body_end, L, si)
        off = 0
        name = None
        body_start = 0
        L = 0
        si = 0
        with open(path, "rb") as fh:
            for line in fh:
                if line.startswith(b">"):
                    if name is not None:
                        self._index[name] = (body_start, off, L, si)
                        si += 1
                    hdr = line[1:].strip()
                    name = hdr.split(None, 1)[0].decode() if hdr else ""
                    body_start = off + len(line)
                    L = 0
                elif name is not None:
                    L += len(line.strip())
                off += len(line)
        if name is not None:
            self._index[name] = (body_start, off, L, si)

    def __contains__(self, name: str) -> bool:
        if self._eager is not None:
            return name in self._eager
        return name in self._index

    def __getitem__(self, name: str) -> tuple[np.ndarray, int, int]:
        if self._eager is not None:
            return self._eager[name]
        ent = self._cache.get(name)
        if ent is not None:
            return ent
        body_start, body_end, L, si = self._index[name]
        with open(self.path, "rb") as fh:
            fh.seek(body_start)
            body = fh.read(body_end - body_start)
        # same per-line strip as parse_fasta
        text = "".join(ln.strip() for ln in
                       body.decode("ascii", "replace").splitlines())
        dsq = self.abc.digitize(text)
        if len(self._cache) >= self.max_cached:
            self._cache.pop(next(iter(self._cache)))
        self._cache[name] = (dsq, si, L)
        return self._cache[name]


def read_windows(path: str, *, context: int,
                 block_length: int) -> Iterator[tuple[Sequence, bool]]:
    """Stream (window, is_last_window_of_seq) pairs over a DNA FASTA file,
    replicating esl_sqio_ReadWindow semantics (ref: bathsearch.c:1060,
    1099): the first window of each sequence has no context; subsequent
    windows carry the trailing <context> residues of the previous
    window; W counts only the new residues.

    FASTA input is streamed — memory stays O(context + block_length)
    regardless of chromosome size (a window's L field is the residues
    seen so far; bathsearch derives the true source length from the
    last window's coordinates, exactly as the reference does after
    esl_sqio_ReadWindow).  EMBL/GenBank fall back to whole-record
    reads."""
    abc = dna()
    with _open_text(path) as probe:
        head = ""
        for line in probe:
            if line.strip():
                head = line
                break
    if not head.startswith(">"):
        for idx, (name, acc, desc, text) in enumerate(
                parse_seqfile(path, abc)):
            yield from _windows_of(abc, idx, name, acc, desc,
                                   abc.digitize(text), context,
                                   block_length)
        return

    # --- streaming FASTA ---
    CHUNK = 8 << 20
    idx = -1
    name = desc = None
    pend: np.ndarray | None = None   # buffered residues
    s_buf = 0                        # absolute index of pend[0]
    pos = 0                          # new residues consumed so far
    first = True
    pieces: list[str] = []           # undigitized line batch
    npiece = 0

    def flush():
        nonlocal pend, pieces, npiece
        if pieces:
            pend = np.concatenate([pend,
                                   abc.digitize("".join(pieces))])
            pieces = []
            npiece = 0

    def emit(last: bool):
        """Yield ready windows from the buffer; all remaining on
        <last>."""
        nonlocal pend, s_buf, pos, first
        while True:
            avail = s_buf + len(pend)       # residues seen so far
            # in mid-stream mode keep one residue beyond the block:
            # a sequence ending exactly on a block boundary must get
            # is_last=True on that final window
            if not last and avail < pos + block_length + 1:
                return
            if last and avail <= pos:
                return
            c = 0 if first else min(context, pos)
            s = pos - c
            e = min(avail, pos + block_length)
            w = Sequence(name=name, acc="", desc=desc,
                         dsq=pend[s - s_buf:e - s_buf].copy(),
                         start=s + 1, end=e, L=avail, W=e - pos, C=c,
                         idx=idx, abc=abc)
            pos = e
            first = False
            yield w, last and pos >= avail
            # drop residues no longer reachable as context
            keep_from = pos - min(context, pos)
            if keep_from > s_buf:
                pend = pend[keep_from - s_buf:]
                s_buf = keep_from

    with _open_text(path) as fh:
        rest = ""
        cont = False    # rest continues an already-consumed body line
        while True:
            chunk = fh.read(CHUNK)
            data = rest + chunk
            if chunk and "\n" not in data and name is not None \
                    and (cont or not data.startswith(">")):
                # unwrapped mega-line FASTA (one sequence per line):
                # consume body bytes eagerly so memory stays
                # O(block+context); hold back trailing whitespace —
                # it may be the line's end-trim
                frag = data if cont else data.lstrip()
                keep = len(frag.rstrip())
                rest = frag[keep:]
                frag = frag[:keep]
                if frag:
                    pieces.append(frag)
                    npiece += len(frag)
                    cont = True
                    if s_buf + len(pend) + npiece \
                            >= pos + block_length:
                        flush()
                        yield from emit(last=False)
                continue
            if not chunk:
                lines = data.split("\n") if data else []
                rest = ""
            else:
                lines = data.split("\n")
                rest = lines.pop()
            for line in lines:
                if cont:
                    # remainder of an eagerly-consumed body line
                    cont = False
                    t = line.strip()
                    if t:
                        pieces.append(t)
                        npiece += len(t)
                        if s_buf + len(pend) + npiece \
                                >= pos + block_length:
                            flush()
                            yield from emit(last=False)
                    continue
                if line.startswith(">"):
                    if name is not None:
                        flush()
                        yield from emit(last=True)
                    hdr = line[1:].strip()
                    parts = hdr.split(None, 1)
                    name = parts[0] if parts else ""
                    desc = parts[1] if len(parts) > 1 else ""
                    idx += 1
                    pend = np.empty(0, np.int32)
                    s_buf = pos = 0
                    first = True
                    pieces = []
                    npiece = 0
                elif name is not None:
                    t = line.strip()
                    if t:
                        pieces.append(t)
                        npiece += len(t)
                        if s_buf + len(pend) + npiece \
                                >= pos + block_length:
                            flush()
                            yield from emit(last=False)
            if not chunk:
                break
        if name is not None:
            flush()
            yield from emit(last=True)


def _windows_of(abc, idx, name, acc, desc, full, context,
                block_length):
    """Window a fully-materialized digital sequence (the original
    read_windows loop, kept for the non-FASTA formats)."""
    L = len(full)
    pos = 0
    first = True
    while pos < L:
        if first:
            c = 0
            s = 0
        else:
            c = min(context, pos)
            s = pos - c
        e = min(L, pos + block_length)
        w = Sequence(name=name, acc=acc, desc=desc,
                     dsq=full[s:e].copy(),
                     start=s + 1, end=e, L=L, W=e - pos, C=c,
                     idx=idx, abc=abc)
        pos = e
        first = False
        yield w, pos >= L
