"""ctypes bindings for the native C++ host runtime
(bath_tpu_torch/native/src/bathio.cpp): digitization, reverse complement,
six-frame ORF extraction, the quantized filters, and the bit-exact
envelope DP stack.

The native library is optional: every entry point has a pure-Python
fallback (see gencode.extract_orfs), and the loader builds the .so on
demand with g++ when it is missing, from this package's own copy of
the source into ``build/bath_tpu_torch/`` at the repository root,
under a file name no other package uses.  ``BATH_TORCH_NATIVE_SO``
names another library to load as it is (the sanitizer tier's ASAN+UBSAN
build, ``bath_tpu_torch/sanitize.py``); one that does not load then
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "bathio.cpp")


def _so_path() -> str:
    # BATH_TORCH_NATIVE_SO: explicit library override, which the
    # sanitizer tier (bath_tpu_torch/sanitize.py native) points at an
    # ASAN+UBSAN build of the same source; a name of the port's own, so
    # that the reference's BATH_NATIVE_SO never reaches this package
    env = os.environ.get(OVERRIDE)
    if env:
        return env
    # the file name carries a hash of the source and of this CPU's
    # feature flags (the build is -march=native), so an edited source
    # or another machine sharing the directory builds anew
    h = hashlib.sha256()
    if os.path.exists(_SRC):
        with open(_SRC, "rb") as f:
            h.update(f.read())
    try:
        with open("/proc/cpuinfo") as f:
            h.update(next((ln for ln in f if ln.startswith("flags")),
                          "").encode())
    except OSError:
        pass
    root = os.path.dirname(os.path.dirname(_HERE))
    return os.path.join(root, "build", "bath_tpu_torch",
                        f"libbathio_torch_{h.hexdigest()[:16]}.so")


OVERRIDE = "BATH_TORCH_NATIVE_SO"
_SO = _so_path()

I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
I8P = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    # built under a temporary name and renamed, so a process never
    # loads a library another one is still writing
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        # -ffp-contract=off: the float parsers are bit-exactness
        # contracts (FMA contraction under -march=native would change
        # results); integer filters are unaffected either way
        subprocess.run(["g++", "-O3", "-march=native",
                        "-ffp-contract=off", "-fopenmp", "-shared",
                        "-fPIC", "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def get_lib():
    global _LIB, _TRIED, _SO
    if _LIB is not None or _TRIED:
        return _LIB
    if os.environ.get(OVERRIDE):
        # explicit override (sanitizer tier): load as-is, never
        # rebuild it, and raise at every call where it does not load: a
        # sanitizer run that fell through to the Python path would
        # prove nothing
        _SO = os.environ[OVERRIDE]
        if not os.path.exists(_SO):
            raise OSError(f"{OVERRIDE}={_SO}: no such library")
    else:
        _TRIED = True
        if not os.path.exists(_SO) and not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        if os.environ.get(OVERRIDE):
            raise
        return None
    lib.bio_digitize.restype = ctypes.c_int
    lib.bio_digitize.argtypes = [ctypes.c_char_p, ctypes.c_int64, I8P,
                                 I32P]
    lib.bio_revcomp.restype = None
    lib.bio_revcomp.argtypes = [I32P, ctypes.c_int64, I32P, I32P]
    lib.bio_extract_orfs.restype = ctypes.c_int
    lib.bio_extract_orfs.argtypes = [
        I32P, ctypes.c_int64, I32P, U8P, U8P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        I32P, I32P]
    lib.bio_translate_frame.restype = None
    lib.bio_translate_frame.argtypes = [
        I32P, ctypes.c_int64, ctypes.c_int, I32P, U8P, ctypes.c_int,
        I32P, ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def available() -> bool:
    return get_lib() is not None


# --- cached per-gencode native tables --------------------------------
_MASKS_CACHE: dict[int, np.ndarray] = {}


def nt_masks(abc) -> np.ndarray:
    """[Kp] 4-bit masks of compatible canonical nucleotides."""
    key = id(abc)
    if key not in _MASKS_CACHE:
        m = np.zeros(abc.Kp, dtype=np.uint8)
        for x in range(abc.Kp):
            bits = 0
            for a in range(4):
                if abc.degen[x, a]:
                    bits |= 1 << a
            m[x] = bits
        _MASKS_CACHE[key] = m
    return _MASKS_CACHE[key]


def extract_orfs_native(gcode, dsq: np.ndarray, *, minlen: int = 20,
                        is_revcomp: bool = False,
                        require_initiator: bool = False):
    """Native six-frame ORF extraction; returns list[Orf] identical to
    gencode.extract_orfs, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..gencode import Orf
    dsq = np.ascontiguousarray(dsq, dtype=np.int32)
    L = len(dsq)
    basic = np.ascontiguousarray(gcode.basic, dtype=np.int32)
    masks = nt_masks(gcode.nt_abc)
    is_init = np.ascontiguousarray(
        gcode.is_initiator.astype(np.uint8))
    stop = gcode.aa_abc.Kp - 2
    anyaa = gcode.aa_abc.Kp - 3
    aa_out = np.empty(max(L, 4), dtype=np.int32)
    meta = np.empty(4 * (L // 3 + 4), dtype=np.int32)
    n = lib.bio_extract_orfs(dsq, L, basic, masks, is_init, stop,
                             anyaa, minlen, int(require_initiator),
                             int(is_revcomp), aa_out, meta)
    from ..gencode import LazyOrfList
    mv = meta[:4 * n].reshape(n, 4).copy()
    lens = mv[:, 3].astype(np.int64)
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:]) if n else None
    flat = aa_out[:int(lens.sum())].copy()
    # flat layout kept for batch filter calls (no re-concatenation);
    # Orf objects materialize lazily — only gate survivors are touched
    return LazyOrfList(flat, offs, lens.astype(np.int32),
                       mv[:, 0], mv[:, 1], mv[:, 2])


def _bind_filters(lib):
    F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    # raw-pointer bindings for the per-ORF gate calls (thousands per
    # window batch; ndpointer from_param + cast cost ~4us per array)
    VP0 = ctypes.c_void_p
    lib.bio_bg_hmm_forward.restype = None
    lib.bio_bg_hmm_forward.argtypes = [
        VP0, ctypes.c_int64, VP0, VP0, VP0, VP0,
        ctypes.POINTER(ctypes.c_float)]
    lib.bio_f32_seq_sum.restype = ctypes.c_float
    lib.bio_f32_seq_sum.argtypes = [VP0, ctypes.c_int64]
    lib.bio_msv_filter.restype = ctypes.c_int
    lib.bio_msv_filter.argtypes = [
        I32P, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
        I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    # raw-pointer bindings: these run once per DP row, so the
    # ndpointer validation cost matters — callers guarantee
    # C-contiguous float32
    VP = ctypes.c_void_p
    lib.bio_dd_closure_f32.restype = None
    lib.bio_dd_closure_f32.argtypes = [VP, VP, ctypes.c_int]
    lib.bio_bwd_d_fs_f32.restype = None
    lib.bio_bwd_d_fs_f32.argtypes = [VP, VP, VP, VP,
                                     ctypes.c_float, ctypes.c_int]
    lib.bio_bwd_dd_f32.restype = None
    lib.bio_bwd_dd_f32.argtypes = [VP, VP, ctypes.c_int]
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    # raw-pointer bindings: these run once per surviving ORF, and the
    # profile-constant views are pointer-cached per om
    lib.bio_fs3_parser_score.restype = ctypes.c_int
    lib.bio_fs3_parser_score.argtypes = (
        [VP, VP, VP, ctypes.c_int64, VP, ctypes.c_int]
        + [VP] * 8
        + [VP, VP, ctypes.POINTER(ctypes.c_float)])
    lib.bio_fwd_parser_score.restype = ctypes.c_int
    lib.bio_fwd_parser_score.argtypes = (
        [VP, ctypes.c_int64, VP, ctypes.c_int]
        + [VP] * 8
        + [VP, VP, ctypes.POINTER(ctypes.c_float)])
    lib.bio_fs5_forward_score.restype = ctypes.c_int
    lib.bio_fs5_forward_score.argtypes = (
        [I32P, I32P, I32P, I32P, I32P, ctypes.c_int64, F32C,
         ctypes.c_int]
        + [F32C] * 8
        + [F32C, F32C, ctypes.POINTER(ctypes.c_float)])
    lib.bio_msv_filter_batch.restype = None
    lib.bio_msv_filter_batch.argtypes = [
        I32P, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        I32P, I32P, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
        I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    lib.bio_vit_filter.restype = ctypes.c_int
    lib.bio_vit_filter.argtypes = [
        VP0, ctypes.c_int64, VP0, VP0, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    F64C = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.bio_fs3_parser_fwd_fill.restype = ctypes.c_int
    lib.bio_fs3_parser_fwd_fill.argtypes = (
        [I32P] * 3 + [ctypes.c_int64, F32C, ctypes.c_int]
        + [F32C] * 8 + [F32C]          # tBM..tII, xff
        + [F32C] * 5 + [F32C]          # xE..xC, scale
        + [ctypes.POINTER(ctypes.c_float)])
    lib.bio_fs3_parser_bwd_fill.restype = None
    lib.bio_fs3_parser_bwd_fill.argtypes = (
        [I32P] * 3 + [ctypes.c_int64, F32C, ctypes.c_int]
        + [F32C] * 8 + [F32C, F32C]    # tBM,tMI,tII,t*k, xff, fscale
        + [F32C] * 5 + [F32C]          # xE..xC, scale
        + [ctypes.POINTER(ctypes.c_int32)])
    lib.bio_fs5_forward_fill.restype = ctypes.c_int
    lib.bio_fs5_forward_fill.argtypes = (
        [I32P] * 5 + [ctypes.c_int64, F32C, ctypes.c_int]
        + [F32C] * 8 + [F32C]          # tBM..tII, xff
        + [F32C] * 3                   # mc, im, dm
        + [F32C] * 5 + [F32C]          # xE..xC, scale
        + [ctypes.POINTER(ctypes.c_float)])
    lib.bio_fs5_backward_fill.restype = None
    lib.bio_fs5_backward_fill.argtypes = (
        [I32P] * 5 + [ctypes.c_int64, F32C, ctypes.c_int]
        + [F32C] * 8 + [F32C]          # tBM,tMI,tII,t*k views, xff
        + [F32C] * 3                   # mm, im, dm
        + [F32C] * 5 + [F32C])         # xE..xC, scale
    lib.bio_fs5_decoding_rows.restype = ctypes.c_int
    lib.bio_fs5_decoding_rows.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 4                   # fmc, fim, bmm, bim
        + [F64C] * 4                   # factor_mdi, npp, jpp, cpp
        + [F32C] * 2 + [F32C] * 3)     # pmc, pim, xN, xJ, xC
    lib.bio_fs5_optacc_fill.restype = None
    lib.bio_fs5_optacc_fill.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 5                   # pmc, pim, pxN, pxJ, pxC
        + [F32C] * 8 + [F32C]          # tBM..tII, xff
        + [F32C] * 3 + [F32C] * 5      # mm, im, dm, xE..xC
        + [ctypes.POINTER(ctypes.c_float)])
    lib.bio_fs_domain_decoding.restype = None
    lib.bio_fs_domain_decoding.argtypes = (
        [ctypes.c_int64]
        + [F32C] * 2                   # fscale, bscale
        + [F32C] * 5 + [F32C] * 5      # fwd/bwd specials
        + [ctypes.c_float] * 3 + [ctypes.c_double]
        + [F32C] * 3)                  # btot, etot, mocc


_FILTER_CACHE: dict = {}


def _packed_filters(om):
    key = id(om)
    ent = _FILTER_CACHE.get(key)
    if ent is None or ent[0] is not om.sbv:
        sbv = np.ascontiguousarray(om.sbv.astype(np.int16))
        rbv = np.ascontiguousarray(om.rbv.astype(np.int32))
        rwv = np.ascontiguousarray(om.rwv.astype(np.int32))
        twv = np.ascontiguousarray(om.twv.astype(np.int32))
        ent = (om.sbv, sbv, rbv, rwv, twv,
               rwv.ctypes.data, twv.ctypes.data)
        _FILTER_CACHE[key] = ent
    return ent[1], ent[2], ent[3], ent[4]


def _packed_filter_ptrs(om):
    """(rwv_ptr, twv_ptr) raw addresses from the same cache entry."""
    _packed_filters(om)
    ent = _FILTER_CACHE[id(om)]
    return ent[5], ent[6]


def msv_filter_native(dsq: np.ndarray, om) -> float | None:
    """Bit-exact native MSV filter; None if the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    sbv, rbv, _, _ = _packed_filters(om)
    out = ctypes.c_float()
    dsq = np.ascontiguousarray(dsq, dtype=np.int32)
    st = lib.bio_msv_filter(dsq, len(dsq), sbv, rbv, om.Kp, om.M,
                            int(om.base_b), int(om.tec_b),
                            int(om.tjb_b), int(om.tbm_b),
                            int(om.bias_b), float(om.scale_b),
                            None, None, 0, ctypes.byref(out))
    return float("inf") if st == 1 else float(out.value)


_DD_FNS = None


def _dd_fns():
    global _DD_FNS
    if _DD_FNS is None:
        lib = get_lib()
        if lib is None:
            _DD_FNS = False
        else:
            if not hasattr(lib, "_filters_bound"):
                _bind_filters(lib)
                lib._filters_bound = True
            _DD_FNS = (lib.bio_dd_closure_f32, lib.bio_bwd_d_fs_f32,
                       lib.bio_bwd_dd_f32)
    return _DD_FNS


def dd_closure_native(dc: np.ndarray, tdd: np.ndarray, M: int) -> bool:
    """In-place sequential DD closure in C, bit-identical to the
    Python loop.  Returns False if the library is absent."""
    fns = _dd_fns()
    if not fns:
        return False
    fns[0](dc.ctypes.data, tdd.ctypes.data, M)
    return True


def bwd_d_fs_native(nd, tdm, iv1, tdd, xE, M: int) -> bool:
    """new_d[k] = tdm[k]*iv1[k] + tdd[k]*new_d[k+1] + xE, k=M-1..1."""
    fns = _dd_fns()
    if not fns:
        return False
    fns[1](nd.ctypes.data, tdm.ctypes.data, iv1.ctypes.data,
           tdd.ctypes.data, float(xE), M)
    return True


def bwd_dd_native(dc, tdd, M: int) -> bool:
    """dc[k] = dc[k] + dc[k+1]*tdd[k+1], k=M-1..1."""
    fns = _dd_fns()
    if not fns:
        return False
    fns[2](dc.ctypes.data, tdd.ctypes.data, M)
    return True


_FWD_VIEWS_CACHE: dict = {}


def _fwd_views(om):
    """(tv, rfv, tv_ptrs, rfv_ptr) contiguous transition/emission
    views + raw addresses, cached per om (the concatenation copies
    and ndpointer validation dominated the per-ORF call cost)."""
    from ..ops.reference.fwdback import _trans_views
    key = id(om)
    ent = _FWD_VIEWS_CACHE.get(key)
    if ent is None or ent[0] is not om.tfv:
        tv = tuple(np.ascontiguousarray(v, dtype=np.float32)
                   for v in _trans_views(om))
        rfv = np.ascontiguousarray(om.rfv, dtype=np.float32)
        ent = (om.tfv, tv, rfv,
               tuple(t.ctypes.data for t in tv), rfv.ctypes.data)
        _FWD_VIEWS_CACHE[key] = ent
    return ent[1], ent[2], ent[3], ent[4]


def fwd_parser_score_native(dsq: np.ndarray, om):
    """Bit-exact standard Forward parser score (F3/F4 gate path);
    same contract as fs3_parser_score_native."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    from .. import constants as C
    from ..ops.reference.fwdback import RangeError
    _, _, tv_p, rfv_p = _fwd_views(om)
    L = len(dsq)
    xf = om.xf
    xff = np.array([xf[C.X_N, C.LOOP], xf[C.X_N, C.MOVE],
                    xf[C.X_J, C.LOOP], xf[C.X_J, C.MOVE],
                    xf[C.X_C, C.LOOP], xf[C.X_C, C.MOVE],
                    xf[C.X_E, C.LOOP], xf[C.X_E, C.MOVE]],
                   dtype=np.float32)
    scales = np.empty(L + 1, dtype=np.float32)
    xctot = ctypes.c_float()
    if dsq.dtype != np.int32 or not dsq.flags.c_contiguous:
        dsq = np.ascontiguousarray(dsq, dtype=np.int32)
    st = lib.bio_fwd_parser_score(dsq.ctypes.data, L, rfv_p, om.M,
                                  *tv_p, xff.ctypes.data,
                                  scales.ctypes.data,
                                  ctypes.byref(xctot))
    if st != 0:
        raise RangeError("forward score over/underflow")
    totscale = 0.0
    for s in scales[scales != np.float32(1.0)]:
        totscale += float(np.log(s))
    return totscale + float(np.log(np.float32(xctot.value)))


_FS3_VIEWS_CACHE: dict = {}


def fs3_parser_score_native(dsq: np.ndarray, om_fs):
    """Bit-exact frameshift 3-codon Forward parser score (gate path):
    the C DP replicates the numpy reference including its pairwise
    reductions; the log-space finish uses numpy's own log semantics.
    Returns the score (float), raises the reference's RangeError on
    over/underflow, or returns None if the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    from .. import constants as C
    from ..ops.reference.fwdback import RangeError
    from ..ops.reference.fwdback_fs import (_trans_views_fs,
                                            codon_indices)
    key = id(om_fs)
    ent = _FS3_VIEWS_CACHE.get(key)
    if ent is None or ent[0] is not om_fs.tfv:
        tv = tuple(np.ascontiguousarray(v, dtype=np.float32)
                   for v in _trans_views_fs(om_fs))
        rfv = np.ascontiguousarray(om_fs.rfv, dtype=np.float32)
        ent = (om_fs.tfv, tv, rfv,
               tuple(t.ctypes.data for t in tv), rfv.ctypes.data)
        _FS3_VIEWS_CACHE[key] = ent
    _, tv, rfv, tv_p, rfv_p = ent
    ci = codon_indices(dsq, 3)
    ci2 = np.ascontiguousarray(ci[2], dtype=np.int32)
    ci3 = np.ascontiguousarray(ci[3], dtype=np.int32)
    ci4 = np.ascontiguousarray(ci[4], dtype=np.int32)
    L = len(dsq)
    M = om_fs.M
    xf = om_fs.xf
    xff = np.array([xf[C.X_N, C.LOOP], xf[C.X_N, C.MOVE],
                    xf[C.X_J, C.LOOP], xf[C.X_J, C.MOVE],
                    xf[C.X_C, C.LOOP], xf[C.X_C, C.MOVE],
                    xf[C.X_E, C.LOOP], xf[C.X_E, C.MOVE]],
                   dtype=np.float32)
    scales = np.empty(L + 1, dtype=np.float32)
    xctot = ctypes.c_float()
    st = lib.bio_fs3_parser_score(ci2.ctypes.data, ci3.ctypes.data,
                                  ci4.ctypes.data, L, rfv_p, M,
                                  *tv_p, xff.ctypes.data,
                                  scales.ctypes.data,
                                  ctypes.byref(xctot))
    if st != 0:
        raise RangeError("fs forward parser over/underflow")
    # numpy-log finish, same accumulation order as the reference
    totscale = 0.0
    for s in scales[scales != np.float32(1.0)]:
        totscale += float(np.log(s))
    return totscale + float(np.log(np.float32(xctot.value)))


def fs5_forward_score_native(dsq: np.ndarray, om_fs):
    """Bit-exact frameshift 5-codon full-Forward score (calibration
    path); same contract as fs3_parser_score_native."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    from .. import constants as C
    from ..ops.reference.fwdback import RangeError
    from ..ops.reference.fwdback_fs import (_trans_views_fs,
                                            codon_indices)
    key = (id(om_fs), 5)
    ent = _FS3_VIEWS_CACHE.get(key)
    if ent is None or ent[0] is not om_fs.tfv:
        tv = tuple(np.ascontiguousarray(v, dtype=np.float32)
                   for v in _trans_views_fs(om_fs))
        rfv = np.ascontiguousarray(om_fs.rfv, dtype=np.float32)
        ent = (om_fs.tfv, tv, rfv)
        _FS3_VIEWS_CACHE[key] = ent
    _, tv, rfv = ent
    ci = codon_indices(dsq, 5)
    cis = [np.ascontiguousarray(ci[c], dtype=np.int32)
           for c in (1, 2, 3, 4, 5)]
    L = len(dsq)
    xf = om_fs.xf
    xff = np.array([xf[C.X_N, C.LOOP], xf[C.X_N, C.MOVE],
                    xf[C.X_J, C.LOOP], xf[C.X_J, C.MOVE],
                    xf[C.X_C, C.LOOP], xf[C.X_C, C.MOVE],
                    xf[C.X_E, C.LOOP], xf[C.X_E, C.MOVE]],
                   dtype=np.float32)
    scales = np.empty(L + 1, dtype=np.float32)
    xctot = ctypes.c_float()
    st = lib.bio_fs5_forward_score(*cis, L, rfv, om_fs.M, *tv, xff,
                                   scales, ctypes.byref(xctot))
    if st != 0:
        raise RangeError("fs forward over/underflow")
    totscale = 0.0
    for s in scales[scales != np.float32(1.0)]:
        totscale += float(np.log(s))
    return totscale + float(np.log(np.float32(xctot.value)))


def msv_filter_native_batch(orf_dsqs: list, om) -> np.ndarray | None:
    """One native call scoring every ORF of a window batch
    (bit-identical to per-ORF msv_filter_native); None if the library
    is absent.  tjb is recomputed per ORF length exactly as
    reconfig_msv_length does.  An OrfList (native extractor output)
    supplies the flat concatenated layout directly."""
    lib = get_lib()
    if lib is None or not len(orf_dsqs):
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    sbv, rbv, _, _ = _packed_filters(om)
    n = len(orf_dsqs)
    flat = getattr(orf_dsqs, "flat", None)
    if flat is not None:
        cat, offs, lens = flat, orf_dsqs.offs, orf_dsqs.lens
    else:
        if hasattr(orf_dsqs[0], "dsq"):
            orf_dsqs = [o.dsq for o in orf_dsqs]
        lens = np.array([len(d) for d in orf_dsqs], dtype=np.int32)
        offs = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        cat = np.concatenate([np.ascontiguousarray(d, dtype=np.int32)
                              for d in orf_dsqs])
    # tjb per UNIQUE length (ORF lengths repeat heavily; the scalar
    # per-ORF path was a visible cost at database scale).  The
    # (ulens, inv) factorization is cached on the OrfList — the
    # multi-query drive scores the SAME shared ORF stream once per
    # model — and the per-unique-length byteify is one vectorized op
    # replicating _unbiased_byteify's exact f32/roundf arithmetic.
    uent = getattr(orf_dsqs, "_ulen_cache", None) \
        if flat is not None else None
    if uent is None:
        ulens, inv = np.unique(np.asarray(lens, dtype=np.int64),
                               return_inverse=True)
        if flat is not None:
            try:
                orf_dsqs._ulen_cache = (ulens, inv)
            except AttributeError:
                pass               # non-caching container: fine
    else:
        ulens, inv = uent
    sc32 = np.log(3.0 / (ulens.astype(np.float64) + 3.0)) \
        .astype(np.float32)
    x = np.float32(om.scale_b) * sc32
    rc = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))
    cost = -rc                     # always >= 0 (log arg < 1)
    utjb = np.where(cost > 255.0, 255,
                    cost.astype(np.int64) & 0xFF).astype(np.int32)
    tjbs = utjb[inv]
    out = np.empty(n, dtype=np.float32)
    lib.bio_msv_filter_batch(cat, offs, lens, tjbs, n, sbv, rbv,
                             om.Kp, om.M, int(om.base_b),
                             int(om.tec_b), int(om.tbm_b),
                             int(om.bias_b), float(om.scale_b), out)
    return out


def f32_seq_sum(arr) -> float:
    """Strict sequential float32 accumulation — the C `float acc +=
    x[i]` semantics of the reference's aliscore / domcorrection sums
    (numpy's own .sum() is pairwise)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    lib = get_lib()
    if lib is not None:
        if not hasattr(lib, "_filters_bound"):
            _bind_filters(lib)
            lib._filters_bound = True
        return float(np.float32(
            lib.bio_f32_seq_sum(arr.ctypes.data, len(arr))))
    acc = np.float32(0.0)
    for v in arr:
        acc += v
    return float(acc)


def set_native_threads(n: int) -> int | None:
    """Cap the OpenMP team used by the batch kernels (forked workers
    divide the cores among themselves; no-op without the library)."""
    lib = get_lib()
    if lib is None:
        return
    if not getattr(lib, "_setthreads_bound", False):
        lib.bio_set_threads.restype = None
        lib.bio_set_threads.argtypes = [ctypes.c_int]
        lib._setthreads_bound = True
    before = lib.omp_get_max_threads()  # the team size it replaces
    lib.bio_set_threads(max(1, int(n)))
    return before


def cluster_components_native(iv, jv, kv, mv, min_overlap,
                              of_smaller, max_diagdiff, fs):
    """Single-linkage component labels over segment arrays (identical
    to the numpy pairwise-link + BFS in ensemble.cluster_segments).
    Returns (labels, ncomp) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not getattr(lib, "_cluster_bound", False):
        VP = ctypes.c_void_p
        lib.bio_cluster_components.restype = ctypes.c_int64
        lib.bio_cluster_components.argtypes = [
            VP, VP, VP, VP, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, VP]
        lib._cluster_bound = True
    n = len(iv)
    labels = np.empty(n, np.int64)
    ncomp = lib.bio_cluster_components(
        iv.ctypes.data, jv.ctypes.data, kv.ctypes.data,
        mv.ctypes.data, n, float(min_overlap), int(of_smaller),
        int(max_diagdiff), int(fs), labels.ctypes.data)
    return labels, int(ncomp)


def _bind_gatebatch(lib):
    if getattr(lib, "_gatebatch_bound", False):
        return
    VP = ctypes.c_void_p
    lib.bio_bg_hmm_forward_batch.restype = None
    lib.bio_bg_hmm_forward_batch.argtypes = [
        VP, VP, VP, VP, ctypes.c_int64, VP, VP,
        ctypes.c_float, VP, VP, VP]
    lib.bio_f32_seq_sum_batch.restype = None
    lib.bio_f32_seq_sum_batch.argtypes = [
        VP, VP, VP, ctypes.c_int64, VP]
    lib.bio_vit_filter_batch.restype = None
    lib.bio_vit_filter_batch.argtypes = [
        VP, VP, VP, VP, ctypes.c_int64, VP, VP,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, VP]
    lib._gatebatch_bound = True


def bg_filter_score_batch(orfs, idxs, bg) -> np.ndarray | None:
    """Batched p7_bg_FilterScore over ORFs <idxs> of a LazyOrfList
    with the currently-set filter: bit-identical to per-ORF
    set_length(L) + filter_score(dsq).  Returns a float64 array
    aligned with idxs, or None if unavailable."""
    lib = get_lib()
    flat = getattr(orfs, "flat", None)
    if lib is None or flat is None or not len(idxs):
        return None
    _bind_gatebatch(lib)
    n = len(idxs)
    in_offs = np.ascontiguousarray(orfs.offs[idxs], dtype=np.int64)
    lens = np.ascontiguousarray(orfs.lens[idxs], dtype=np.int32)
    lens64 = lens.astype(np.int64)
    out_offs = np.zeros(n, np.int64)
    np.cumsum(lens64[:-1], out=out_offs[1:])
    scales = np.empty(int(lens64.sum()), np.float32)
    ends = np.empty(n, np.float32)
    eo = np.ascontiguousarray(bg._eo, np.float32)
    pi = np.ascontiguousarray(bg._pi, np.float32)
    t = np.ascontiguousarray(bg._t, np.float32)
    row1 = np.ascontiguousarray(t[1])
    lib.bio_bg_hmm_forward_batch(
        flat.ctypes.data, in_offs.ctypes.data, out_offs.ctypes.data,
        lens.ctypes.data, n, eo.ctypes.data, pi.ctypes.data,
        float(t[0, 2]), row1.ctypes.data,
        scales.ctypes.data, ends.ctypes.data)
    # logs stay numpy-side (scalar path does np.log over the f32
    # scales buffer then a strict-sequential f32 sum)
    ls = np.log(scales)
    sums = np.empty(n, np.float32)
    lib.bio_f32_seq_sum_batch(ls.ctypes.data, out_offs.ctypes.data,
                              lens.ctypes.data, n, sums.ctypes.data)
    nullsc = sums + np.log(ends)
    # filter_score's exact f32 association: ((nullsc + L*log p1) + log(1-p1))
    p1v = lens.astype(np.float32) / (lens64 + 1).astype(np.float32)
    a = lens.astype(np.float32) * np.log(p1v)
    b = np.log(np.float32(1.0) - p1v)
    return ((nullsc + a) + b).astype(np.float64)


def vit_filter_score_batch(orfs, idxs, om) -> np.ndarray | None:
    """Batched ViterbiFilter scores over ORFs <idxs> of a LazyOrfList:
    bit-identical to per-ORF reconfig_length(L) + vit_filter_native.
    +inf marks the 16-bit overflow (certain hit).  Returns a float64
    array aligned with idxs, or None if unavailable."""
    lib = get_lib()
    flat = getattr(orfs, "flat", None)
    if lib is None or flat is None or not len(idxs):
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    _bind_gatebatch(lib)
    from .. import constants as C
    n = len(idxs)
    in_offs = np.ascontiguousarray(orfs.offs[idxs], dtype=np.int64)
    lens = np.ascontiguousarray(orfs.lens[idxs], dtype=np.int32)
    rwv_p, twv_p = _packed_filter_ptrs(om)
    nj = float(om.nj)           # move score depends on (L, nj)
    ulens, inv = np.unique(lens.astype(np.int64), return_inverse=True)
    # vectorized _wordify(scale_w, log(pmove)) over the unique
    # lengths, replicating reconfig_length's exact f32 arithmetic
    # (the scalar per-unique-length loop was ~1.5s per Pfam-scale
    # multi-query drive)
    Lf = ulens.astype(np.float32)
    pmove = (np.float32(2.0) + np.float32(nj)) / (
        Lf + np.float32(2.0) + np.float32(nj))
    x = np.float32(om.scale_w) * np.log(pmove)
    rc = np.where(x >= 0, np.floor(x + np.float32(0.5)),
                  np.ceil(x - np.float32(0.5)))
    umove = np.clip(rc, -32768.0, 32767.0).astype(np.int32)
    move_ws = np.ascontiguousarray(umove[inv], dtype=np.int32)
    out = np.empty(n, np.float32)
    lib.bio_vit_filter_batch(
        flat.ctypes.data, in_offs.ctypes.data, lens.ctypes.data,
        move_ws.ctypes.data, n, rwv_p, twv_p, om.Kp, om.M,
        int(om.base_w), float(om.scale_w),
        int(om.xw[C.X_E, C.MOVE]), int(om.xw[C.X_E, C.LOOP]),
        out.ctypes.data)
    return out.astype(np.float64)


def bg_hmm_forward_native(dsq: np.ndarray, eo, pi, t) -> float | None:
    """Bit-exact native 2-state bias-filter forward (ref: bg.py
    _hmm_forward): the f32 recurrence runs in C, the per-step max
    rescales come back for numpy's own f32 log (1-ulp different from
    libm), and the log sum is a strict sequential f32 accumulation."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    L = len(dsq)
    if L == 0:
        return 0.0
    if dsq.dtype != np.int32 or not dsq.flags.c_contiguous:
        dsq = np.ascontiguousarray(dsq, dtype=np.int32)
    if not eo.flags.c_contiguous:
        eo = np.ascontiguousarray(eo)
    if not t.flags.c_contiguous:
        t = np.ascontiguousarray(t)
    scales = np.empty(L, dtype=np.float32)
    end = ctypes.c_float()
    lib.bio_bg_hmm_forward(dsq.ctypes.data, L, eo.ctypes.data,
                           pi.ctypes.data, t.ctypes.data,
                           scales.ctypes.data, ctypes.byref(end))
    ls = np.log(scales)
    logsc = np.float32(lib.bio_f32_seq_sum(ls.ctypes.data, L))
    return float(logsc + np.float32(np.log(np.float32(end.value))))


def vit_filter_native(dsq: np.ndarray, om) -> float | None:
    """Bit-exact native ViterbiFilter score (no window capture);
    None if the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    rwv_p, twv_p = _packed_filter_ptrs(om)
    out = ctypes.c_float()
    if dsq.dtype != np.int32 or not dsq.flags.c_contiguous:
        dsq = np.ascontiguousarray(dsq, dtype=np.int32)
    from .. import constants as C
    st = lib.bio_vit_filter(dsq.ctypes.data, len(dsq), rwv_p, twv_p,
                            om.Kp, om.M,
                            int(om.base_w), float(om.scale_w),
                            int(om.xw[C.X_N, C.MOVE]),
                            int(om.xw[C.X_E, C.MOVE]),
                            int(om.xw[C.X_E, C.LOOP]),
                            ctypes.byref(out))
    return float("inf") if st == 1 else float(out.value)


# --- full-matrix fs5 envelope stages ---------------------------------
# Bit-exact C fills of the numpy references in
# ops/reference/fwdback_fs.py (forward_fs5/backward_fs5/decoding_fs/
# optimal_accuracy_fs; ref: p7_Forward_Frameshift fwdback_fs.c:2054,
# p7_Backward_Frameshift :2634, p7_Decoding_Frameshift decoding_fs.c
# :55, p7_OptimalAccuracy_Frameshift optacc_fs.c:53).  np.log/np.exp
# stay in numpy (1-ulp vs libm); the C replicates numpy's pairwise
# reductions and f32 op order.

_FS5_FULL_CACHE: dict = {}


def _fs5_full_views(om_fs):
    """Cached contiguous transition views for the fs5 full-matrix
    kernels: the standard 8 (tBM..tII) plus the k-shifted backward
    variants (slot k = transition out of node k)."""
    key = id(om_fs)
    ent = _FS5_FULL_CACHE.get(key)
    if ent is None or ent[0] is not om_fs.tfv:
        from ..ops.reference.fwdback_fs import _trans_views_fs
        tv = tuple(np.ascontiguousarray(v, dtype=np.float32)
                   for v in _trans_views_fs(om_fs))
        tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = tv
        M = om_fs.M

        def kshift(t):
            o = np.zeros(M + 1, dtype=np.float32)
            o[:M] = t[1:]
            return o

        tvk = (kshift(tMM), kshift(tIM), kshift(tDM), kshift(tMD),
               kshift(tDD))
        rfv = np.ascontiguousarray(om_fs.rfv, dtype=np.float32)
        ent = (om_fs.tfv, tv, tvk, rfv)
        _FS5_FULL_CACHE[key] = ent
    return ent[1], ent[2], ent[3]


def _xff_of(om_fs):
    from .. import constants as C
    xf = om_fs.xf
    return np.array([xf[C.X_N, C.LOOP], xf[C.X_N, C.MOVE],
                     xf[C.X_J, C.LOOP], xf[C.X_J, C.MOVE],
                     xf[C.X_C, C.LOOP], xf[C.X_C, C.MOVE],
                     xf[C.X_E, C.LOOP], xf[C.X_E, C.MOVE]],
                    dtype=np.float32)


def _fs5_lib():
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    return lib


def _ci5_arrays(dsq):
    from ..ops.reference.fwdback_fs import codon_indices
    ci = codon_indices(dsq, 5)
    return [np.ascontiguousarray(ci[c], dtype=np.int32)
            for c in (1, 2, 3, 4, 5)]


def _ci3_arrays(dsq):
    from ..ops.reference.fwdback_fs import codon_indices
    ci = codon_indices(dsq, 3)
    return [np.ascontiguousarray(ci[c], dtype=np.int32)
            for c in (2, 3, 4)]


def fs3_parser_fwd_fill_native(dsq, om_fs):
    """fs3 Forward parser with stored specials; bit-identical to
    forward_parser_fs3(..., fast=False)."""
    lib = _fs5_lib()
    L = len(dsq)
    if lib is None or L < 5:
        return None
    from ..ops.reference.fwdback import PMatrix, RangeError
    tv, _, rfv = _fs5_full_views(om_fs)
    M = om_fs.M
    F32 = np.float32
    ox = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    out = ctypes.c_float()
    st = lib.bio_fs3_parser_fwd_fill(
        *_ci3_arrays(dsq), L, rfv, M, *tv, _xff_of(om_fs),
        ox.xE, ox.xN, ox.xJ, ox.xB, ox.xC, ox.scale,
        ctypes.byref(out))
    if st != 0:
        raise RangeError("fs forward parser over/underflow")
    totscale = 0.0
    for s in ox.scale[ox.scale != F32(1.0)]:
        totscale += float(np.log(s))
    ox.totscale = totscale
    return ox, totscale + float(np.log(np.float32(out.value)))


def fs3_parser_bwd_fill_native(dsq, om_fs, fwd):
    """fs3 Backward parser with stored specials; bit-identical to
    backward_parser_fs3."""
    lib = _fs5_lib()
    L = len(dsq)
    if lib is None or L < 5:
        return None
    from ..ops.reference.fwdback import PMatrix
    tv, tvk, rfv = _fs5_full_views(om_fs)
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = tv
    tMMk, tIMk, tDMk, tMDk, tDDk = tvk
    M = om_fs.M
    F32 = np.float32
    bx = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 has_own_scales=False)
    own = ctypes.c_int32()
    fscale = fwd.scale
    if fscale.dtype != np.float32 or not fscale.flags.c_contiguous:
        fscale = np.ascontiguousarray(fscale, dtype=np.float32)
    lib.bio_fs3_parser_bwd_fill(
        *_ci3_arrays(dsq), L, rfv, M, tBM, tMI, tII,
        tMMk, tIMk, tDMk, tMDk, tDDk, _xff_of(om_fs), fscale,
        bx.xE, bx.xN, bx.xJ, bx.xB, bx.xC, bx.scale, ctypes.byref(own))
    bx.has_own_scales = bool(own.value)
    # reference accumulation order: descending rows L..1; the
    # reference logs a Python float (f64), not the f32 element
    totscale = 0.0
    for s in bx.scale[1:][::-1]:
        if s != F32(1.0):
            totscale += float(np.log(float(s)))
    bx.totscale = totscale
    return bx, totscale


def fs5_forward_fill_native(dsq, om_fs):
    """Full fs5 Forward matrix + score; bit-identical to
    forward_fs5(..., fast=False).  None if the library is absent or
    the sequence is too short for the C edge handling."""
    lib = _fs5_lib()
    L = len(dsq)
    if lib is None or L < 5:
        return None
    from ..ops.reference.fwdback import RangeError
    from ..ops.reference.fwdback_fs import FSMatrix
    tv, _, rfv = _fs5_full_views(om_fs)
    M = om_fs.M
    F32 = np.float32
    fx = FSMatrix(L=L, M=M,
                  mc=np.zeros((6, L + 1, M + 1), F32),
                  im=np.zeros((L + 1, M + 1), F32),
                  dm=np.zeros((L + 1, M + 1), F32),
                  xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                  xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                  xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    out = ctypes.c_float()
    st = lib.bio_fs5_forward_fill(
        *_ci5_arrays(dsq), L, rfv, M, *tv, _xff_of(om_fs),
        fx.mc, fx.im, fx.dm, fx.xE, fx.xN, fx.xJ, fx.xB, fx.xC,
        fx.scale, ctypes.byref(out))
    if st != 0:
        raise RangeError("fs forward over/underflow")
    totscale = 0.0
    for s in fx.scale[fx.scale != F32(1.0)]:
        totscale += float(np.log(s))
    fx.totscale = totscale
    return fx, totscale + float(np.log(np.float32(out.value)))


def fs5_backward_fill_native(dsq, om_fs):
    """Full fs5 Backward matrix; bit-identical to backward_fs5."""
    lib = _fs5_lib()
    L = len(dsq)
    if lib is None or L < 5:
        return None
    from ..ops.reference.fwdback import PMatrix
    tv, tvk, rfv = _fs5_full_views(om_fs)
    tBM, tMM, tIM, tDM, tMD, tDD, tMI, tII = tv
    tMMk, tIMk, tDMk, tMDk, tDDk = tvk
    M = om_fs.M
    F32 = np.float32
    bx = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 mm=np.zeros((L + 1, M + 1), F32),
                 im=np.zeros((L + 1, M + 1), F32),
                 dm=np.zeros((L + 1, M + 1), F32),
                 has_own_scales=True)
    lib.bio_fs5_backward_fill(
        *_ci5_arrays(dsq), L, rfv, M, tBM, tMI, tII,
        tMMk, tIMk, tDMk, tMDk, tDDk, _xff_of(om_fs),
        bx.mm, bx.im, bx.dm, bx.xE, bx.xN, bx.xJ, bx.xB, bx.xC,
        bx.scale)
    # reference accumulation order: descending rows L..1
    totscale = 0.0
    for s in bx.scale[1:][::-1]:
        if s != F32(1.0):
            totscale += float(np.log(s))
    bx.totscale = totscale
    return bx, totscale


def fs5_decoding_native(om_fs, fwd, bck):
    """fs5 posterior decoding; bit-identical to decoding_fs."""
    lib = _fs5_lib()
    if lib is None:
        return None
    L, M = fwd.L, fwd.M
    if L < 3:
        return None
    return _fs5_decoding_impl(lib, om_fs, fwd, bck, L, M)


def _fs5_decoding_impl(lib, om_fs, fwd, bck, L, M):
    from .. import constants as C
    from ..logsum import flogsum
    from ..ops.reference.fwdback import RangeError
    from ..ops.reference.fwdback_fs import FSMatrix
    F32 = np.float32
    with np.errstate(divide="ignore"):
        log_sfwd = np.cumsum(np.log(fwd.scale.astype(np.float64)))
        lsb = np.log(bck.scale.astype(np.float64))
    log_sbck = np.zeros(L + 2)
    log_sbck[:L + 1] = np.cumsum(lsb[::-1])[::-1]
    with np.errstate(divide="ignore"):
        log_inv_Z = -float(flogsum(
            np.log(bck.xN[0]) + log_sbck[0],
            flogsum(np.log(bck.xN[1]) + log_sbck[1],
                    np.log(bck.xN[2]) + log_sbck[2])))
    factor_mdi = np.exp(log_sfwd[:L + 1] + log_sbck[:L + 1]
                        + log_inv_Z)
    if np.isinf(factor_mdi[1:]).any():
        raise RangeError("fs decoding overflow")
    npp = np.zeros(L + 1, np.float64)
    jpp = np.zeros(L + 1, np.float64)
    cpp = np.zeros(L + 1, np.float64)
    for i in (1, 2):
        if i <= L:
            f0 = np.exp(log_sbck[i] + log_inv_Z)
            npp[i] = bck.xN[i] * f0
    if L >= 3:
        factor_njc = np.exp(log_sfwd[:L - 2] + log_sbck[3:L + 1]
                            + log_inv_Z)
        npp[3:] = (fwd.xN[:L - 2] * bck.xN[3:]
                   * om_fs.xf[C.X_N, C.LOOP]) * factor_njc
        jpp[3:] = (fwd.xJ[:L - 2] * bck.xJ[3:]
                   * om_fs.xf[C.X_J, C.LOOP]) * factor_njc
        cpp[3:] = (fwd.xC[:L - 2] * bck.xC[3:]
                   * om_fs.xf[C.X_C, C.LOOP]) * factor_njc
    pp = FSMatrix(L=L, M=M,
                  mc=np.zeros((6, L + 1, M + 1), F32),
                  im=np.zeros((L + 1, M + 1), F32),
                  dm=np.zeros((L + 1, M + 1), F32),
                  xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                  xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                  xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    st = lib.bio_fs5_decoding_rows(
        L, M, np.ascontiguousarray(fwd.mc),
        np.ascontiguousarray(fwd.im), np.ascontiguousarray(bck.mm),
        np.ascontiguousarray(bck.im), factor_mdi, npp, jpp, cpp,
        pp.mc, pp.im, pp.xN, pp.xJ, pp.xC)
    if st != 0:
        raise RangeError("fs decoding denom overflow")
    return pp


def fs5_optacc_native(om_fs, pp):
    """fs5 optimal accuracy fill; bit-identical to
    optimal_accuracy_fs."""
    lib = _fs5_lib()
    if lib is None:
        return None
    L, M = pp.L, pp.M
    if L < 3:
        return None
    from ..ops.reference.fwdback import PMatrix
    tv, _, _ = _fs5_full_views(om_fs)
    F32 = np.float32
    ox = PMatrix(L=L, M=M,
                 xE=np.empty(L + 1, F32), xN=np.empty(L + 1, F32),
                 xJ=np.empty(L + 1, F32), xB=np.empty(L + 1, F32),
                 xC=np.empty(L + 1, F32), scale=np.ones(L + 1, F32),
                 mm=np.empty((L + 1, M + 1), F32),
                 im=np.empty((L + 1, M + 1), F32),
                 dm=np.empty((L + 1, M + 1), F32))
    out = ctypes.c_float()
    lib.bio_fs5_optacc_fill(
        L, M, np.ascontiguousarray(pp.mc), np.ascontiguousarray(pp.im),
        pp.xN, pp.xJ, pp.xC, *tv, _xff_of(om_fs),
        ox.mm, ox.im, ox.dm, ox.xE, ox.xN, ox.xJ, ox.xB, ox.xC,
        ctypes.byref(out))
    return ox, float(out.value)


def fs_domain_decoding_native(om_fs, oxf, oxb, log_inv_Z):
    """btot/etot/mocc for the fs domain decoder; bit-identical to the
    numpy loop in fwdback_fs.domain_decoding_fs.  None if the library
    is absent."""
    lib = _fs5_lib()
    if lib is None:
        return None
    from .. import constants as C
    L = oxf.L
    F32 = np.float32
    btot = np.zeros(L + 1, F32)
    etot = np.zeros(L + 1, F32)
    mocc = np.zeros(L + 1, F32)

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    bscale = oxb.scale
    xf = om_fs.xf
    lib.bio_fs_domain_decoding(
        L, c32(oxf.scale), c32(bscale),
        c32(oxf.xB), c32(oxf.xE), c32(oxf.xN), c32(oxf.xJ),
        c32(oxf.xC),
        c32(oxb.xB), c32(oxb.xE), c32(oxb.xN), c32(oxb.xJ),
        c32(oxb.xC),
        float(xf[C.X_N, C.LOOP]), float(xf[C.X_J, C.LOOP]),
        float(xf[C.X_C, C.LOOP]), float(log_inv_Z),
        btot, etot, mocc)
    return btot, etot, mocc


def _bind_stotrace(lib):
    if getattr(lib, "_stotrace_bound", False):
        return
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    U32C = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.bio_fs5_stotrace.restype = ctypes.c_int64
    lib.bio_fs5_stotrace.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 3                   # mc, im, dm
        + [F32C] * 6                   # xB xC xE xN xJ scale
        + [F32C] * 8 + [F32C]          # transitions, xff
        + [U32C, ctypes.POINTER(ctypes.c_int32)]
        + [I32P] * 4 + [ctypes.c_int64])
    VP = ctypes.c_void_p
    lib.bio_fs5_stotrace_domains.restype = ctypes.c_int64
    # raw pointers: this runs nsamples (200) times per region with
    # arrays hoisted by fs5_stotrace_prep
    lib.bio_fs5_stotrace_domains.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [VP] * 18
        + [U32C, ctypes.POINTER(ctypes.c_int32)]
        + [np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
           ctypes.c_int64])
    lib._stotrace_bound = True


def _bind_maxlen(lib):
    if getattr(lib, "_maxlen_bound", False):
        return
    VP = ctypes.c_void_p
    U32C = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.bio_hmm_max_length.restype = ctypes.c_int64
    lib.bio_hmm_max_length.argtypes = [
        VP, ctypes.c_int, ctypes.c_int64, ctypes.c_double]
    lib.bio_sample_dna.restype = ctypes.c_int
    lib.bio_sample_dna.argtypes = [
        VP, ctypes.c_int, VP, VP, VP, ctypes.c_int64,
        U32C, ctypes.POINTER(ctypes.c_int32), VP]
    lib.bio_sample_iid.restype = None
    lib.bio_sample_iid.argtypes = [
        VP, ctypes.c_int, ctypes.c_int64,
        U32C, ctypes.POINTER(ctypes.c_int32), VP]
    lib._maxlen_bound = True


def sample_iid_native(r, cum, L):
    """L iid draws from cumulative <cum> with the exact MT19937
    stream of the Python loop.  None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_maxlen(lib)
    cum = np.ascontiguousarray(cum, dtype=np.float64)
    mt32 = r._mt.astype(np.uint32)
    mti = ctypes.c_int32(r._mti)
    out = np.empty(L, np.int32)
    lib.bio_sample_iid(cum.ctypes.data, len(cum), L, mt32,
                       ctypes.byref(mti), out.ctypes.data)
    r._mt[:] = mt32
    r._mti = int(mti.value)
    return out


def hmm_max_length_native(t, M, bound, emit_thresh):
    """p7_Builder_MaxLength DP (bit-exact f64 transcription of
    hmm.set_max_length's loops).  None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_maxlen(lib)
    t = np.ascontiguousarray(t, dtype=np.float64)
    return int(lib.bio_hmm_max_length(t.ctypes.data, int(M),
                                      int(bound), float(emit_thresh)))


def sample_dna_native(r, f, ct, L):
    """Calibration DNA emission (sample_iid aminos + random synonymous
    codons) with the exact two-pass MT19937 draw order of the Python
    path.  Returns an int32 [3L] array or None."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_maxlen(lib)
    prep = getattr(ct, "_flat_cache", None)
    if prep is None:
        K = len(ct.codons)
        cnt = np.array([len(ct.codons[a]) for a in range(K)], np.int32)
        off = np.zeros(K, np.int32)
        np.cumsum(cnt[:-1], out=off[1:])
        flat = (np.concatenate([np.stack(ct.codons[a])
                                for a in range(K) if len(ct.codons[a])])
                .astype(np.int32) if cnt.sum() else
                np.empty((0, 3), np.int32))
        flat = np.ascontiguousarray(flat)
        prep = (flat, off, cnt, K)
        ct._flat_cache = prep
    flat, off, cnt, K = prep
    cum = np.cumsum(np.asarray(f, dtype=np.float64))
    mt32 = r._mt.astype(np.uint32)
    mti = ctypes.c_int32(r._mti)
    out = np.empty(3 * L, np.int32)
    st = lib.bio_sample_dna(cum.ctypes.data, K, flat.ctypes.data,
                            off.ctypes.data, cnt.ctypes.data, L,
                            mt32, ctypes.byref(mti), out.ctypes.data)
    if st != 0:
        return None
    r._mt[:] = mt32
    r._mti = int(mti.value)
    return out


def fs5_stotrace_domains_native(r, om_fs, fx, prep=None):
    """One sampled fs5 trace reduced to its domain table in C:
    [(sqfrom, sqto, hmmfrom, hmmto), ...] — identical to
    stochastic_trace_fs5 + Trace.index() and the same consumed
    MT19937 stream.  <prep> (from fs5_stotrace_prep) hoists the
    om/fx-constant array prep out of the per-sample loop.  None if
    unavailable or the sampler errored (RNG state untouched)."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_stotrace(lib)
    if prep is None:
        prep = fs5_stotrace_prep(om_fs, fx)
    ptrs, _keep, L, M = prep
    mt32 = r._mt.astype(np.uint32)
    mti = ctypes.c_int32(r._mti)
    max_dom = L + 8
    dom = np.empty(4 * max_dom, np.int64)
    n = lib.bio_fs5_stotrace_domains(
        L, M, *ptrs, mt32, ctypes.byref(mti), dom, max_dom)
    if n < 0:
        return None
    r._mt[:] = mt32
    r._mti = int(mti.value)
    d = dom[:4 * n].reshape(n, 4)
    return [(int(a), int(b), int(c), int(e)) for a, b, c, e in d]


def fs5_stotrace_prep(om_fs, fx):
    """Hoisted constant prep for repeated fs5 stotrace sampling over
    one (om_fs, fx) pair (one region samples ddef.nsamples times)."""
    from ..ops.reference import fwdback_fs as ffs

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    tv = tuple(c32(t) for t in ffs._trans_views_fs(om_fs))
    arrs = (c32(fx.mc), c32(fx.im), c32(fx.dm), c32(fx.xB),
            c32(fx.xC), c32(fx.xE), c32(fx.xN), c32(fx.xJ),
            c32(fx.scale)) + tv + (_xff_of(om_fs),)
    ptrs = tuple(a.ctypes.data for a in arrs)
    return ptrs, arrs, fx.L, fx.M


def fs5_stotrace_native(r, om_fs, fx):
    """One sampled fs5 trace; bit-identical to
    ensemble.stochastic_trace_fs5 including the consumed MT19937
    stream.  None if the library is absent or the sampler errored
    (RNG state is then untouched, so the Python path can retry)."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_stotrace(lib)
    from ..ops.reference import fwdback_fs as ffs
    from ..ops.reference.fwdback import Trace
    L, M = fx.L, fx.M
    tv = ffs._trans_views_fs(om_fs)

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    mt32 = r._mt.astype(np.uint32)
    mti = ctypes.c_int32(r._mti)
    cap = 2 * (L + 8)
    st = np.empty(cap, np.int32)
    kk = np.empty(cap, np.int32)
    ii = np.empty(cap, np.int32)
    cc = np.empty(cap, np.int32)
    n = lib.bio_fs5_stotrace(
        L, M, c32(fx.mc), c32(fx.im), c32(fx.dm),
        c32(fx.xB), c32(fx.xC), c32(fx.xE), c32(fx.xN), c32(fx.xJ),
        c32(fx.scale), *[c32(t) for t in tv], _xff_of(om_fs),
        mt32, ctypes.byref(mti), st, kk, ii, cc, cap)
    if n < 0:
        return None
    r._mt[:] = mt32
    r._mti = int(mti.value)
    tr = Trace()
    tr.st = st[:n][::-1].tolist()
    tr.k = kk[:n][::-1].tolist()
    tr.i = ii[:n][::-1].tolist()
    tr.c = cc[:n][::-1].tolist()
    tr.pp = [0.0] * n
    tr.sp = [-1] * n
    tr.M, tr.L = M, L
    return tr


def _bind_fwdfill(lib):
    if getattr(lib, "_fwdfill_bound", False):
        return
    VP = ctypes.c_void_p
    lib.bio_fwd_fill.restype = ctypes.c_int
    lib.bio_fwd_fill.argtypes = (
        [VP, ctypes.c_int64, VP, ctypes.c_int, ctypes.c_int]
        + [VP] * 8 + [VP]              # transitions, xff
        + [VP] * 3                     # mm, im, dm
        + [VP] * 6                     # xE xN xJ xB xC scale
        + [ctypes.POINTER(ctypes.c_double)])
    lib._fwdfill_bound = True


def fwd_fill_native(dsq, om, full=True):
    """Amino Forward matrix + score; bit-identical to
    fwdback.forward(full=..., fast=False) (full=False stores only
    specials + scales, the ORF parser mode).  None if unavailable."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_fwdfill(lib)
    from ..ops.reference.fwdback import PMatrix, RangeError
    L, M = len(dsq), om.M
    F32 = np.float32
    _, _, tv_p, rfv_p = _fwd_views(om)
    ox = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32))
    if full:
        ox.mm = np.zeros((L + 1, M + 1), F32)
        ox.im = np.zeros((L + 1, M + 1), F32)
        ox.dm = np.zeros((L + 1, M + 1), F32)
        mm, im_, dm = ox.mm, ox.im, ox.dm
    else:
        mm = im_ = dm = np.zeros((1, M + 1), F32)
    out = ctypes.c_double()
    dsq32 = dsq if (dsq.dtype == np.int32 and dsq.flags.c_contiguous) \
        else np.ascontiguousarray(dsq, dtype=np.int32)
    xff = _xff_of(om)
    st = lib.bio_fwd_fill(
        dsq32.ctypes.data, L, rfv_p, M, int(full), *tv_p,
        xff.ctypes.data,
        mm.ctypes.data, im_.ctypes.data, dm.ctypes.data,
        ox.xE.ctypes.data, ox.xN.ctypes.data, ox.xJ.ctypes.data,
        ox.xB.ctypes.data, ox.xC.ctypes.data, ox.scale.ctypes.data,
        ctypes.byref(out))
    if st == 1:
        raise RangeError("forward score is NaN")
    if st == 2:
        raise RangeError("forward score underflow")
    if st == 3:
        raise RangeError("forward score overflow")
    totscale = 0.0
    for s in ox.scale[ox.scale != F32(1.0)]:
        totscale += float(np.log(s))
    ox.totscale = totscale
    from .. import constants as C
    score = totscale + float(np.log(ox.xC[L] * om.xf[C.X_C, C.MOVE]))
    return ox, score


def _bind_oatrace(lib):
    if getattr(lib, "_oatrace_bound", False):
        return
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.bio_fs5_oa_trace.restype = ctypes.c_int64
    lib.bio_fs5_oa_trace.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 8                   # omm oim odm oxE oxN oxJ oxB oxC
        + [F32C] * 5                   # pmc pim pxN pxJ pxC
        + [F32C, F32C]                 # tfv, xff
        + [I32P, I32P, I32P, F32C, I32P, ctypes.c_int64])
    lib._oatrace_bound = True


def fs5_oa_trace_native(om_fs, pp, ox):
    """FS OA traceback; bit-identical to fwdback_fs.oa_trace_fs.
    None if the library is absent or the tracer errored."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_oatrace(lib)
    from ..ops.reference.fwdback import Trace
    L, M = ox.L, ox.M

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    cap = 2 * (L + M) + 64
    st = np.empty(cap, np.int32)
    kk = np.empty(cap, np.int32)
    ii = np.empty(cap, np.int32)
    ppv = np.empty(cap, np.float32)
    cc = np.empty(cap, np.int32)
    n = lib.bio_fs5_oa_trace(
        L, M, c32(ox.mm), c32(ox.im), c32(ox.dm),
        c32(ox.xE), c32(ox.xN), c32(ox.xJ), c32(ox.xB), c32(ox.xC),
        c32(pp.mc), c32(pp.im), c32(pp.xN), c32(pp.xJ), c32(pp.xC),
        c32(om_fs.tfv), _xff_of(om_fs),
        st, kk, ii, ppv, cc, cap)
    if n < 0:
        return None
    tr = Trace(M=M, L=L)
    tr.st = st[:n][::-1].tolist()
    tr.k = kk[:n][::-1].tolist()
    tr.i = ii[:n][::-1].tolist()
    tr.pp = [float(x) for x in ppv[:n][::-1]]
    tr.c = cc[:n][::-1].tolist()
    tr.sp = [-1] * n
    return tr


def _bind_ssvbath(lib):
    if getattr(lib, "_ssvbath_bound", False):
        return
    # raw void_p args: this runs once per F1-surviving ORF (~10k
    # calls per Pfam-scale drive); ndpointer from_param+cast costs
    # ~4us per array argument
    VP0 = ctypes.c_void_p
    lib.bio_ssv_filter_bath.restype = ctypes.c_int64
    lib.bio_ssv_filter_bath.argtypes = (
        [VP0, ctypes.c_int64, VP0, VP0, ctypes.c_int64,
         ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_double, ctypes.c_int32]
        + [VP0, VP0, VP0, VP0, ctypes.c_int64])
    lib._ssvbath_bound = True


# per-call capture scratch, reused (threads each get their own)
import threading as _threading

_SSVBATH_TLS = _threading.local()


def ssv_filter_bath_native(dsq, om, data, sc_thresh):
    """Window-capturing SSV; bit-identical to the Python
    filters.ssv_filter_bath loop.  Returns list of (n, k, length,
    score) tuples, or None if unavailable."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_ssvbath(lib)
    if om.rbv.dtype != np.uint8 or not om.rbv.flags.c_contiguous:
        return None
    ssv = data.ssv_scores
    if ssv.dtype != np.uint8:
        return None
    ssv = np.ascontiguousarray(ssv)
    dsq32 = dsq if (dsq.dtype == np.int32 and dsq.flags.c_contiguous) \
        else np.ascontiguousarray(dsq, dtype=np.int32)
    cap = 4096
    s = _SSVBATH_TLS
    if getattr(s, "wn", None) is None:
        s.wn = np.empty(cap, np.int32)
        s.wk = np.empty(cap, np.int32)
        s.wl = np.empty(cap, np.int32)
        s.ws = np.empty(cap, np.float32)
    wn, wk, wl, ws = s.wn, s.wk, s.wl, s.ws
    n = lib.bio_ssv_filter_bath(
        dsq32.ctypes.data, len(dsq32), om.rbv.ctypes.data,
        ssv.ctypes.data, len(ssv), om.Kp, om.M,
        int(om.base_b), int(om.bias_b), int(om.tjb_b), int(om.tbm_b),
        float(om.scale_b), int(sc_thresh), wn.ctypes.data,
        wk.ctypes.data, wl.ctypes.data, ws.ctypes.data, cap)
    if n < 0:
        return None
    return [(int(wn[i]), int(wk[i]), int(wl[i]), float(ws[i]))
            for i in range(n)]


def _bind_vitbath(lib):
    if getattr(lib, "_vitbath_bound", False):
        return
    lib.bio_vit_filter_bath.restype = ctypes.c_int64
    lib.bio_vit_filter_bath.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64,
         ctypes.POINTER(ctypes.c_float),
         ctypes.POINTER(ctypes.c_int32)])
    lib._vitbath_bound = True


def vit_filter_bath_native(dsq, om, data, sc_thresh, sc_ext_thresh):
    """Window-capturing ViterbiFilter (ref: impl_sse/vitfilter.c
    p7_ViterbiFilter_BATH :286); bit-identical to the Python
    filters.viterbi_filter capture mode.  Returns (score, [(n, k,
    length), ...]) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_filters_bound"):
        _bind_filters(lib)
        lib._filters_bound = True
    _bind_vitbath(lib)
    ssv = data.ssv_scores
    if ssv.dtype != np.uint8 or not ssv.flags.c_contiguous:
        return None
    rwv_p, twv_p = _packed_filter_ptrs(om)
    if dsq.dtype != np.int32 or not dsq.flags.c_contiguous:
        dsq = np.ascontiguousarray(dsq, dtype=np.int32)
    from .. import constants as C
    cap = 4096
    wn = np.empty(cap, np.int32)
    wk = np.empty(cap, np.int32)
    wl = np.empty(cap, np.int32)
    out = ctypes.c_float()
    status = ctypes.c_int32()
    n = lib.bio_vit_filter_bath(
        dsq.ctypes.data, len(dsq), rwv_p, twv_p, om.Kp, om.M,
        int(om.base_w), float(om.scale_w),
        int(om.xw[C.X_N, C.MOVE]), int(om.xw[C.X_E, C.MOVE]),
        int(om.xw[C.X_E, C.LOOP]),
        int(sc_thresh), int(sc_ext_thresh),
        ssv.ctypes.data, int(om.bias_b),
        wn.ctypes.data, wk.ctypes.data, wl.ctypes.data, cap,
        ctypes.byref(out), ctypes.byref(status))
    if n < 0:
        return None
    sc = float("inf") if status.value == 1 else float(out.value)
    return sc, [(int(wn[i]), int(wk[i]), int(wl[i])) for i in range(n)]


def bind_d_max_chain():
    """Raw binding for the spliced-Viterbi D max-chain (per-row hot
    call; c_void_p args to skip ndpointer validation)."""
    lib = get_lib()
    if lib is None:
        return None
    if not getattr(lib, "_dmax_bound", False):
        VP = ctypes.c_void_p
        lib.bio_d_max_chain.restype = None
        lib.bio_d_max_chain.argtypes = [VP, VP, VP, VP, ctypes.c_int]
        lib._dmax_bound = True
    return lib.bio_d_max_chain


def _bind_spliced(lib):
    if getattr(lib, "_spliced_bound", False):
        return
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    I64C = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    F64C = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.bio_spliced_vit_fill.restype = ctypes.c_int
    lib.bio_spliced_vit_fill.argtypes = (
        [I32P, I64C, I64C, I32P, I32P,
         ctypes.c_int64, ctypes.c_int,
         F32C, ctypes.c_int, I64C]
        + [F32C] * 7
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_float] * 4
        + [F64C, ctypes.c_float, ctypes.c_int]
        + [F32C] * 7)
    I32C = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bio_spliced_vit_trace.restype = ctypes.c_int
    lib.bio_spliced_vit_trace.argtypes = (
        [I32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         F32C, ctypes.c_int, F32C]
        + [ctypes.c_float] * 4 + [F64C]
        + [F32C] * 7
        + [ctypes.c_int] * 3 + [ctypes.c_double]
        + [I32C] * 4
        + [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
           ctypes.POINTER(ctypes.c_double)])
    lib._spliced_bound = True


def spliced_vit_trace_native(sub, L, M, Mfull, rsc, tsc, xvals, sigsc,
                             gx_mats, k_start, i_start, min_intron,
                             tsc_p):
    """Spliced-Viterbi traceback in C, identical decisions to the
    Python oracle (f64 math over the f32 matrices, same tolerance
    comparator).  Returns (st, k, i, c, vitsc) lists-compatible
    arrays, None if the library is absent, or raises RuntimeError on
    an untraceable cell (as the oracle does)."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_spliced(lib)
    if rsc.dtype != np.float32 or not rsc.flags.c_contiguous:
        return None
    mmx, imx, dmx, xN, xB, xE, xC = gx_mats
    cap = int(L) + 2 * int(M) + 64
    out_st = np.empty(cap, np.int32)
    out_k = np.empty(cap, np.int32)
    out_i = np.empty(cap, np.int32)
    out_c = np.empty(cap, np.int32)
    n = ctypes.c_int64()
    vsc = ctypes.c_double()
    st = lib.bio_spliced_vit_trace(
        np.ascontiguousarray(sub, dtype=np.int32), int(L), int(M),
        int(Mfull), rsc, rsc.shape[1],
        np.ascontiguousarray(tsc, dtype=np.float32),
        *[float(v) for v in xvals],
        np.ascontiguousarray(sigsc, dtype=np.float64),
        mmx, imx, dmx, xN, xB, xE, xC,
        int(k_start), int(i_start), int(min_intron), float(tsc_p),
        out_st, out_k, out_i, out_c, cap,
        ctypes.byref(n), ctypes.byref(vsc))
    if st != 0:
        raise RuntimeError(f"spliced traceback failed (native) code={st}")
    m = n.value
    return (out_st[:m], out_k[:m], out_i[:m], out_c[:m],
            float(vsc.value))


def spliced_vit_fill_native(ntv, ci_arr, c1_base, accv, donv, L, M,
                            rsc, sub_k, tviews, entry, exitc,
                            global_start, global_end, xvals, sigsc,
                            tsc_p, min_intron, mats):
    """Fill the spliced Viterbi matrices in C; bit-identical to the
    Python loops in splice.viterbi_spliced.  Returns True when the
    native path ran."""
    lib = _fs5_lib()
    if lib is None:
        return False
    _bind_spliced(lib)
    if rsc.dtype != np.float32 or not rsc.flags.c_contiguous:
        return False
    mmx, imx, dmx, xN, xB, xE, xC = mats
    lib.bio_spliced_vit_fill(
        np.ascontiguousarray(ntv, dtype=np.int32),
        np.ascontiguousarray(ci_arr, dtype=np.int64),
        np.ascontiguousarray(c1_base, dtype=np.int64),
        np.ascontiguousarray(accv, dtype=np.int32),
        np.ascontiguousarray(donv, dtype=np.int32),
        L, M, rsc, rsc.shape[1],
        np.ascontiguousarray(sub_k, dtype=np.int64),
        *[np.ascontiguousarray(t, dtype=np.float32) for t in tviews],
        float(entry), float(exitc), int(global_start),
        int(global_end), *[float(v) for v in xvals],
        np.ascontiguousarray(sigsc, dtype=np.float64),
        float(tsc_p), int(min_intron),
        mmx, imx, dmx, xN, xB, xE, xC)
    return True


def _bind_bwdfill(lib):
    if getattr(lib, "_bwdfill_bound", False):
        return
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.bio_bwd_fill.restype = ctypes.c_int
    lib.bio_bwd_fill.argtypes = (
        [I32P, ctypes.c_int64, F32C, ctypes.c_int, ctypes.c_int]
        + [F32C] * 8 + [F32C, F32C]    # transitions, xff, fwd_scale
        + [F32C] * 3                   # mm, im, dm
        + [F32C] * 6                   # xE xN xJ xB xC scale
        + [ctypes.POINTER(ctypes.c_int32)])
    lib._bwdfill_bound = True


def bwd_fill_native(dsq, om, fwd, full=True):
    """Amino Backward matrix + score; bit-identical to
    fwdback.backward.  None if unavailable; raises RangeError like
    the Python path."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_bwdfill(lib)
    from ..ops.reference.fwdback import PMatrix, RangeError
    L, M = len(dsq), om.M
    if L == 0:
        return None
    F32 = np.float32
    # per-om cached contiguous views (the per-call concatenation
    # copies were ~0.2ms x thousands of envelope fills)
    tv, rfv, _tp, _rp = _fwd_views(om)
    bx = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 has_own_scales=False)
    if full:
        bx.mm = np.zeros((L + 1, M + 1), F32)
        bx.im = np.zeros((L + 1, M + 1), F32)
        bx.dm = np.zeros((L + 1, M + 1), F32)
        mm, im_, dm = bx.mm, bx.im, bx.dm
    else:
        mm = im_ = dm = np.zeros((1, M + 1), F32)
    fscale = fwd.scale
    if fscale.dtype != np.float32 or not fscale.flags.c_contiguous:
        fscale = np.ascontiguousarray(fscale, dtype=np.float32)
    dsq32 = dsq if (dsq.dtype == np.int32 and dsq.flags.c_contiguous) \
        else np.ascontiguousarray(dsq, dtype=np.int32)
    own = ctypes.c_int32(0)
    st = lib.bio_bwd_fill(
        dsq32, L, rfv, M, int(full), *tv, _xff_of(om), fscale,
        mm, im_, dm,
        bx.xE, bx.xN, bx.xJ, bx.xB, bx.xC, bx.scale,
        ctypes.byref(own))
    bx.has_own_scales = bool(own.value)
    if st == 1:
        raise RangeError("backward score is NaN")
    if st == 2:
        raise RangeError("backward score underflow")
    if st == 3:
        raise RangeError("backward score overflow")
    # totscale: init is np.log on the f32 scale[L]; per-row adds are
    # f64 logs of the python-float scale, descending i
    totscale = float(np.log(bx.scale[L]))
    for s_ in bx.scale[1:L][::-1]:
        if s_ > 1.0:
            totscale += float(np.log(float(s_)))
    bx.totscale = totscale
    return bx, totscale + float(np.log(bx.xN[0]))


def _bind_oafill(lib):
    if getattr(lib, "_oafill_bound", False):
        return
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.bio_oa_fill.restype = None
    lib.bio_oa_fill.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 8 + [F32C]          # transitions, xff
        + [F32C] * 5                   # pp: mm, im, xN, xJ, xC
        + [F32C] * 3                   # out mm, im, dm
        + [F32C] * 5)                  # xE xN xJ xB xC
    lib._oafill_bound = True


def oa_fill_native(om, pp):
    """Standard OA fill; bit-identical to fwdback.optimal_accuracy.
    None if unavailable."""
    lib = _fs5_lib()
    if lib is None:
        return None
    _bind_oafill(lib)
    from ..ops.reference.fwdback import NEG_INF, PMatrix
    L, M = pp.L, pp.M
    F32 = np.float32
    tv, _rfv, _tp, _rp = _fwd_views(om)
    ox = PMatrix(L=L, M=M,
                 xE=np.full(L + 1, NEG_INF, F32),
                 xN=np.zeros(L + 1, F32),
                 xJ=np.full(L + 1, NEG_INF, F32),
                 xB=np.zeros(L + 1, F32),
                 xC=np.full(L + 1, NEG_INF, F32),
                 scale=np.ones(L + 1, F32),
                 mm=np.empty((L + 1, M + 1), F32),
                 im=np.empty((L + 1, M + 1), F32),
                 dm=np.empty((L + 1, M + 1), F32))

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    lib.bio_oa_fill(
        L, M, *tv, _xff_of(om),
        c32(pp.mm), c32(pp.im), c32(pp.xN), c32(pp.xJ), c32(pp.xC),
        ox.mm, ox.im, ox.dm,
        ox.xE, ox.xN, ox.xJ, ox.xB, ox.xC)
    return ox, float(ox.xC[L])


def _bind_decoding_std(lib):
    if getattr(lib, "_decoding_std_bound", False):
        return
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.bio_decoding.restype = ctypes.c_int
    lib.bio_decoding.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 6                   # fwd: mm im xN xJ xC scale
        + [F32C] * 6                   # bwd: mm im xN xJ xC scale
        + [ctypes.c_int]               # b_own
        + [ctypes.c_float] * 3         # nloop jloop cloop
        + [F32C] * 5)                  # out: mm im xN xJ xC
    lib.bio_oa_trace.restype = ctypes.c_int64
    lib.bio_oa_trace.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 8                   # ox: mm im dm xE xN xJ xB xC
        + [F32C] * 5                   # pp: mm im xN xJ xC
        + [F32C, F32C]                 # tfv, xff
        + [np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 3
        + [F32C, ctypes.c_int64])
    lib._decoding_std_bound = True


def decoding_native(om, oxf, oxb):
    """Standard posterior decoding; bit-identical to
    fwdback.decoding.  None if unavailable; raises RangeError on
    scaleproduct overflow (as the Python path does)."""
    lib = _fs5_lib()
    if lib is None or oxf.mm is None or oxb.mm is None:
        return None
    _bind_decoding_std(lib)
    from .. import constants as C
    from ..ops.reference.fwdback import PMatrix, RangeError
    L, M = oxf.L, oxf.M
    F32 = np.float32

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    pp = PMatrix(L=L, M=M,
                 xE=np.zeros(L + 1, F32), xN=np.zeros(L + 1, F32),
                 xJ=np.zeros(L + 1, F32), xB=np.zeros(L + 1, F32),
                 xC=np.zeros(L + 1, F32), scale=np.ones(L + 1, F32),
                 mm=np.empty((L + 1, M + 1), F32),
                 im=np.empty((L + 1, M + 1), F32),
                 dm=np.zeros((L + 1, M + 1), F32))
    pp.mm[0] = 0.0
    pp.im[0] = 0.0
    xf = om.xf
    st = lib.bio_decoding(
        L, M, c32(oxf.mm), c32(oxf.im), c32(oxf.xN), c32(oxf.xJ),
        c32(oxf.xC), c32(oxf.scale),
        c32(oxb.mm), c32(oxb.im), c32(oxb.xN), c32(oxb.xJ),
        c32(oxb.xC), c32(oxb.scale), int(oxb.has_own_scales),
        float(xf[C.X_N, C.LOOP]), float(xf[C.X_J, C.LOOP]),
        float(xf[C.X_C, C.LOOP]),
        pp.mm, pp.im, pp.xN, pp.xJ, pp.xC)
    if st != 0:
        raise RangeError("decoding scaleproduct overflow")
    return pp


def oa_trace_std_native(om, pp, ox):
    """Standard OA traceback; bit-identical to fwdback.oa_trace.
    None if unavailable."""
    lib = _fs5_lib()
    if lib is None or ox.mm is None:
        return None
    _bind_decoding_std(lib)
    from ..ops.reference.fwdback import Trace
    L, M = ox.L, ox.M

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    cap = 2 * (L + M) + 64
    st = np.empty(cap, np.int32)
    kk = np.empty(cap, np.int32)
    ii = np.empty(cap, np.int32)
    ppv = np.empty(cap, np.float32)
    n = lib.bio_oa_trace(
        L, M, c32(ox.mm), c32(ox.im), c32(ox.dm),
        c32(ox.xE), c32(ox.xN), c32(ox.xJ), c32(ox.xB), c32(ox.xC),
        c32(pp.mm), c32(pp.im), c32(pp.xN), c32(pp.xJ), c32(pp.xC),
        c32(om.tfv), _xff_of(om),
        st, kk, ii, ppv, cap)
    if n < 0:
        return None
    tr = Trace(M=M, L=L)
    tr.st = st[:n][::-1].tolist()
    tr.k = kk[:n][::-1].tolist()
    tr.i = ii[:n][::-1].tolist()
    tr.pp = [float(x) for x in ppv[:n][::-1]]
    tr.c = [0] * n
    tr.sp = [-1] * n
    return tr


def _bind_stotrace_std(lib):
    if getattr(lib, "_stotrace_std_bound", False):
        return
    F32C = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    U32C = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.bio_stotrace.restype = ctypes.c_int64
    lib.bio_stotrace.argtypes = (
        [ctypes.c_int64, ctypes.c_int]
        + [F32C] * 3                   # mm, im, dm
        + [F32C] * 6                   # xB xC xE xN xJ scale
        + [F32C] * 8 + [F32C]          # transitions, xff
        + [U32C, ctypes.POINTER(ctypes.c_int32)]
        + [I32P] * 3 + [ctypes.c_int64])
    lib._stotrace_std_bound = True


def stotrace_native(r, om, oxf):
    """One sampled standard trace; bit-identical to
    ensemble.stochastic_trace incl. the consumed MT19937 stream.
    None if unavailable (RNG untouched)."""
    lib = _fs5_lib()
    if lib is None or oxf.mm is None:
        return None
    _bind_stotrace_std(lib)
    from ..ops.reference.fwdback import Trace, _trans_views
    L, M = oxf.L, oxf.M

    def c32(a):
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            return np.ascontiguousarray(a, dtype=np.float32)
        return a

    tv = [c32(t) for t in _trans_views(om)]
    mt32 = r._mt.astype(np.uint32)
    mti = ctypes.c_int32(r._mti)
    cap = 3 * (L + 8) + 2 * (M + 8)
    st = np.empty(cap, np.int32)
    kk = np.empty(cap, np.int32)
    ii = np.empty(cap, np.int32)
    n = lib.bio_stotrace(
        L, M, c32(oxf.mm), c32(oxf.im), c32(oxf.dm),
        c32(oxf.xB), c32(oxf.xC), c32(oxf.xE), c32(oxf.xN),
        c32(oxf.xJ), c32(oxf.scale), *tv, _xff_of(om),
        mt32, ctypes.byref(mti), st, kk, ii, cap)
    if n < 0:
        return None
    r._mt[:] = mt32
    r._mti = int(mti.value)
    tr = Trace()
    tr.st = st[:n][::-1].tolist()
    tr.k = kk[:n][::-1].tolist()
    tr.i = ii[:n][::-1].tolist()
    tr.pp = [0.0] * n
    tr.c = [0] * n
    tr.sp = [-1] * n
    tr.M, tr.L = M, L
    return tr
