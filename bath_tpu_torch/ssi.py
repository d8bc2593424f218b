"""Sequence/HMM file indexing in Easel's binary SSI v1 format
(ref: bathfetch.c create_ssi_index :166, p7_hmmfile.c :410-424 SSI
open chain, p7_splice.c GetSubSequence :3720 SSI usage).

The format (reverse-documented from the reference's shipped
tutorial/*.ssi files; all integers big-endian):

  header (78 bytes):
    u32 magic = 0xd3d3c9b3      u32 flags = 0      u32 offsz = 8
    u16 nfiles    u64 nprimary    u64 nsecondary
    u32 flen      u32 plen        u32 slen          (lengths incl NUL)
    u32 frecsize = flen + 16
    u32 precsize = plen + 2 + 24
    u32 srecsize = slen + plen
    u64 foffset = 78
    u64 poffset = foffset + nfiles * frecsize
    u64 soffset = poffset + nprimary * precsize
  file record:      name[flen] u32 format  u32 flags  u32 bpl  u32 rpl
                    (format 1 = FASTA; flags bit 0 = fast-subseq,
                     bpl/rpl = bytes/residues per line when uniform)
  primary record:   key[plen]  u16 filenum  u64 r_off  u64 d_off u64 L
  secondary record: key[slen]  primary_key[plen]

Keys are sorted bytewise (the reference binary-searches).  This module
reads and writes this exact format, so indexes interoperate with the
reference in both directions.  Legacy JSON ".bsi" indexes written by
earlier versions are still read.
"""

from __future__ import annotations

import json
import os
import struct

SSI_MAGIC = 0xD3D3C9B3
_FASTA_FMT = 1


def _write_ssi(out: str, src_name: bytes, fmt: int, fflags: int,
               bpl: int, rpl: int,
               primary: dict[str, tuple[int, int, int]],
               secondary: dict[str, str]) -> str:
    """primary: key -> (r_off, d_off, L); secondary: key -> primary."""
    pk = sorted(primary, key=lambda s: s.encode())
    sk = sorted(secondary, key=lambda s: s.encode())
    flen = len(src_name) + 1
    plen = max((len(k.encode()) for k in pk), default=0) + 1
    slen = (max((len(k.encode()) for k in sk), default=0) + 1) if sk \
        else 0
    frecsize = flen + 16
    precsize = plen + 2 + 24
    srecsize = slen + plen
    foffset = 78
    poffset = foffset + frecsize
    soffset = poffset + len(pk) * precsize
    with open(out, "wb") as fh:
        fh.write(struct.pack(">IIIHQQIIIIIIQQQ",
                             SSI_MAGIC, 0, 8, 1, len(pk), len(sk),
                             flen, plen, slen,
                             frecsize, precsize, srecsize,
                             foffset, poffset, soffset))
        fh.write(src_name.ljust(flen, b"\0"))
        fh.write(struct.pack(">IIII", fmt, fflags, bpl, rpl))
        for k in pk:
            r_off, d_off, L = primary[k]
            fh.write(k.encode().ljust(plen, b"\0"))
            fh.write(struct.pack(">HQQQ", 0, r_off, d_off, L))
        for k in sk:
            fh.write(k.encode().ljust(slen, b"\0"))
            fh.write(secondary[k].encode().ljust(plen, b"\0"))
    return out


def read_esl_ssi(ixpath: str) -> dict | None:
    """Parse an Easel binary SSI file into
    {"files": [(name, fmt, flags, bpl, rpl)],
     "primary": {key: (fnum, r_off, d_off, L)},
     "secondary": {key: primary_key}} or None if not SSI / corrupt
    (a truncated index falls back to scanning, never crashes)."""
    try:
        return _read_esl_ssi(ixpath)
    except (struct.error, OSError, UnicodeDecodeError):
        return None


def _read_esl_ssi(ixpath: str) -> dict | None:
    with open(ixpath, "rb") as fh:
        hdr = fh.read(78)
        if len(hdr) < 78:
            return None
        (magic, _flags, _offsz, nfiles, nprim, nsec, flen, plen,
         slen, frecsize, precsize, srecsize, foffset, poffset,
         soffset) = struct.unpack(">IIIHQQIIIIIIQQQ", hdr)
        if magic != SSI_MAGIC:
            return None
        files = []
        fh.seek(foffset)
        for _ in range(nfiles):
            rec = fh.read(frecsize)
            name = rec[:flen].split(b"\0")[0].decode()
            fmt, fflags, bpl, rpl = struct.unpack(
                ">IIII", rec[flen:flen + 16])
            files.append((name, fmt, fflags, bpl, rpl))
        primary = {}
        fh.seek(poffset)
        for _ in range(nprim):
            rec = fh.read(precsize)
            key = rec[:plen].split(b"\0")[0].decode()
            fnum, r_off, d_off, L = struct.unpack(
                ">HQQQ", rec[plen:plen + 26])
            primary[key] = (fnum, r_off, d_off, L)
        secondary = {}
        fh.seek(soffset)
        for _ in range(nsec):
            rec = fh.read(srecsize)
            key = rec[:slen].split(b"\0")[0].decode()
            pkey = rec[slen:slen + plen].split(b"\0")[0].decode()
            secondary[key] = pkey
    return {"files": files, "primary": primary,
            "secondary": secondary}


def index_hmm_file(path: str) -> str:
    """Index HMM records: NAME -> record offset (primary), ACC ->
    NAME (secondary).  Writes reference-compatible <path>.ssi."""
    primary: dict[str, tuple[int, int, int]] = {}
    secondary: dict[str, str] = {}
    with open(path, "rb") as fh:
        off = 0
        rec_off = None
        name = None
        for line in fh:
            txt = line.decode("ascii", "replace")
            if txt.startswith(("BATH", "HMMER")):
                rec_off = off
                name = None
            elif txt.startswith("NAME") and rec_off is not None:
                name = txt.split(None, 1)[1].strip()
                if name in primary:
                    raise ValueError(f"duplicate key {name}")
                primary[name] = (rec_off, 0, 0)
            elif txt.startswith("ACC") and name is not None:
                acc = txt.split(None, 1)[1].strip()
                secondary.setdefault(acc, name)
            off += len(line)
    return _write_ssi(path + ".ssi", os.path.basename(path).encode(),
                      0, 0, 0, 0, primary, secondary)


def index_fasta_file(path: str) -> str:
    """Index FASTA records: name -> (header offset, data offset,
    residue count); uniform line length enables the fast-subseq
    flag with bpl/rpl.  Writes reference-compatible <path>.ssi."""
    primary: dict[str, tuple[int, int, int]] = {}
    bpl = rpl = -1
    uniform = True
    with open(path, "rb") as fh:
        off = 0
        cur = None
        cur_rec = [0, 0, 0]
        last_was_short = False
        for line in fh:
            if line.startswith(b">"):
                nm = line[1:].split()[0].decode()
                cur = nm
                cur_rec = [off, off + len(line), 0]
                primary[nm] = tuple(cur_rec)
                last_was_short = False
            elif cur is not None:
                n_res = len(line.strip())
                if n_res:
                    if bpl < 0:
                        bpl, rpl = len(line), n_res
                    else:
                        # a short (or blank) line is only allowed as
                        # the last line of its record
                        if last_was_short:
                            uniform = False
                        if len(line) != bpl or n_res != rpl:
                            last_was_short = True
                            if len(line) > bpl or n_res > rpl:
                                uniform = False
                    rec = primary[cur]
                    primary[cur] = (rec[0], rec[1], rec[2] + n_res)
                elif bpl >= 0:
                    # blank line: its bytes break the subseq offset
                    # arithmetic for any residues that follow it
                    last_was_short = True
            off += len(line)
    if not uniform or bpl < 0:
        bpl = rpl = 0
    fflags = 1 if bpl else 0
    return _write_ssi(path + ".ssi", os.path.basename(path).encode(),
                      _FASTA_FMT, fflags, bpl, rpl, primary, {})


def load_index(path: str) -> dict | None:
    """Load <path>.ssi (Easel binary; ours or the reference's) or a
    legacy <path>.bsi JSON.  Returns {"type", "keys"} where keys map
    name/acc -> record offset (hmm) or [header offset, L] (fasta)."""
    ix = path + ".ssi"
    if os.path.exists(ix):
        ssi = read_esl_ssi(ix)
        if ssi is not None:
            fmt = ssi["files"][0][1] if ssi["files"] else 0
            if fmt == _FASTA_FMT:
                keys = {k: [v[1], v[3]]
                        for k, v in ssi["primary"].items()}
                return {"type": "fasta", "keys": keys}
            keys = {k: v[1] for k, v in ssi["primary"].items()}
            for acc, pkey in ssi["secondary"].items():
                if pkey in ssi["primary"]:
                    keys.setdefault(acc, ssi["primary"][pkey][1])
            return {"type": "hmm", "keys": keys}
    ix = path + ".bsi"
    if os.path.exists(ix):
        with open(ix) as fh:
            return json.load(fh)
    return None


def fetch_hmm_text(path: str, key: str, index: dict | None = None) -> str:
    """Return the raw text of one HMM record by key (builds/loads the
    index as needed)."""
    index = index or load_index(path)
    if index is None:
        index_hmm_file(path)
        index = load_index(path)
    if key not in index["keys"]:
        raise KeyError(f"key {key} not found in {path}")
    with open(path) as fh:
        fh.seek(index["keys"][key])
        out = []
        for line in fh:
            out.append(line)
            if line.strip() == "//":
                break
        return "".join(out)
