"""bath_tpu_torch stands on its own: it imports nothing of ``bath_tpu``
and no JAX, and its host code is a faithful copy of the reference's.

- Static: no module of the port, and not ``chip_smoke.py``, has an
  import of ``bath_tpu`` or ``jax``.
- Dynamic: the port's CLIs (bathsearch single- and multi-query,
  standard and ``--fs``, ``--device cpu``, and its own ``--backend
  numpy``, also under ``--cpu 2`` on both backends; bathbuild and bathconvert ``--backend torch --device cpu``,
  bathstat, bathfetch), the microbenchmarks (``ubench``) and the
  sharded gate step (``parallel.mesh``) on CPU tensors, a case of the
  sanitizer tier (``sanitize``) and the self-check entry points
  (``selfcheck``: the fs3 gate and the dry run over two CPU shares), its
  fixtures and ``chip_smoke``'s module body run in a subprocess where
  ``bath_tpu``, ``jax`` and ``jaxlib`` are unimportable, and leave none
  of them in ``sys.modules``.
- Drift: every module copied whole differs from its original only in
  import lines, in the reference checkout's path prefix that comment
  references to the C sources carried, and in the lines and regions
  listed here with their reasons.  Functions copied into modules that
  are not whole copies (the CLI, ``device_pipeline``, ``multiquery``)
  are compared as code: comments, docstrings and the listed statements
  aside, their syntax trees are equal.

The test names the module and the line when a copy drifts.
"""

import ast
import difflib
import os
import re
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "bath_tpu"), os.path.join(ROOT,
                                                         "bath_tpu_torch")

# modules copied whole, by their path under both packages
COPIED = """constants logsum rng codontable alphabet stats bg hmm hmmfile
prior msa builder evalues scorematrix gencode sequence profile oprofile
scoredata ops/reference/__init__ ops/reference/filters
ops/reference/fwdback ops/reference/fwdback_fs native/__init__ domaindef
ensemble tracealign alidisplay tophits pipeline pipeline_fs
cli/_io emit ssi cli/bathstat cli/bathfetch splice/__init__ splice/graph
splice/viterbi_spliced splice/splice splice/seeds splice/align
splice/pipeline""".split()

# the reference's comments point into a checkout of the C sources by an
# absolute path; the copies keep the path inside that checkout
REF_PREFIX = "/".join(["", "root", "reference", ""])

# Lines of a copy (stripped) that differ from the original for a reason
# other than an import, and the reason.
LINES = {
    "constants": {
        '"""Core constants for bath_tpu_torch.': "names its own package",
        "Python ints/floats for the framework.": "named the TPU",
    },
    "gencode": {
        "# native C++ fast path (bath_tpu_torch/native, src at "
        "native/src/bathio.cpp)": "names its own package",
    },
    "emit": {"hmmemit program).": "one word of the docstring"},
    "native/__init__": {
        "def set_native_threads(n: int) -> int | None:":
            "returns the team size it replaces, for the hybrid of "
            "--cpu N to give back to its caller",
        "before = lib.omp_get_max_threads()  # the team size it replaces":
            "the same",
        "return before": "the same",
        # the override's library that does not load raises
        "if os.environ.get(OVERRIDE):": "the override raises",
        "raise": "the override raises",
    },
    "ssi": {
        "Keys are sorted bytewise (the reference binary-searches).  "
        "This module": "named the other package",
        "earlier versions are still read.": "named the other package",
    },
    "cli/bathstat": {'"(bath_tpu_torch)")': "names its own package"},
    "cli/bathfetch": {'"(bath_tpu_torch)")': "names its own package"},
    "splice/splice": {
        "Design notes: the graph logic is host-side": "named the TPU",
        "reference and the native host library).  Internal exons are":
            "named Pallas",
    },
    "domaindef": {
        "# envelopes filled by the native host fills, over the object's "
        "life": "the counter of the host fills (stats "
        "rescore_host_items): the card's stage fills the envelopes of "
        "the device cascade",
        "host_fills: int = 0": "the same",
    },
    "ops/reference/filters": {
        "(ops.ssv.ssv_capture).\"\"\"": "named the jnp capture kernel",
        "event kernel (ops.vit.vit_capture).  Returns":
            "named the jnp capture kernel",
    },
}

# Regions (first line, last line; stripped, inclusive; a last line of
# None: to the end of the file) cut from both files before they are
# compared, and the reason.
REGIONS = {
    "domaindef": [
        ("def rescore_isolated_domain_bath(ddef: DomainDef, om: OProfile,",
         None,
         "the port splits domain definition into the region scan "
         "(plan_domains_bath), the envelopes' fills and their rescoring "
         "(finish_domains_bath), so that the device cascade fills every "
         "envelope of a flush in one call of its stage "
         "(TorchCascade.rescore); by_posterior_heuristics_bath runs the "
         "two with the host fills, the same arithmetic in the same order"),
    ],
    "pipeline": [
        ("def _f3_survivor_domaindef(pli, om, gm, gm_fs5, bg, hitlist, "
         "seqidx,",
         "def statistics_text(pli: Pipeline, elapsed: float | None = None) "
         "-> str:",
         "an F3 survivor's domain plan may be deferred (SurvivorPlan) "
         "until finish_survivors fills the envelopes of every survivor of "
         "a flush in one call of the device cascade's stage"),
    ],
    "native/__init__": [
        ('"""ctypes bindings for the native C++ host runtime', '"""',
         "the docstring says where the port builds its own library"),
        ("import ctypes", "import subprocess",
         "imports (hashlib for the library's name)"),
        ("def _so_path() -> str:", "_SO = _so_path()",
         "the port's library lives in build/bath_tpu_torch/ under a name "
         "that carries a hash of the source and the CPU flags, so it can "
         "never load the reference's libbathio.so; the library override "
         "has the port's own name, BATH_TORCH_NATIVE_SO (OVERRIDE), so "
         "that the reference's BATH_NATIVE_SO never reaches the port"),
        ("def _build() -> bool:", "return False",
         "built under a temporary name and renamed; the second "
         "'return False' closes the function"),
        ("def get_lib():", "lib = ctypes.CDLL(_SO)",
         "the override under the port's name, which raises at every call "
         "where its library does not load (a sanitizer run must not fall "
         "through to the Python path); no mtime check: the name carries "
         "the source's hash"),
    ],
}


def read(base, mod, ext=".py"):
    with open(os.path.join(base, mod + ext)) as f:
        return f.read()


def cut_regions(lines, regions, which):
    """<lines> without the listed regions; <which> names the file in
    the failure message."""
    out, i = [], 0
    todo = list(regions)
    while i < len(lines):
        if todo and lines[i].strip() == todo[0][0]:
            j = i if todo[0][0] == todo[0][1] else i + 1
            if todo[0][1] is None:
                i = len(lines)
                todo.pop(0)
                continue
            # a region that ends with 'return False' closes at the
            # function's last one
            ends = [k for k in range(j, len(lines))
                    if lines[k].strip() == todo[0][1]]
            assert ends, f"{which}: region {todo[0][0]!r} has no end"
            if todo[0][1] == "return False":
                nxt = next(k for k in range(j, len(lines))
                           if lines[k].startswith("def ") and k > i)
                end = max(k for k in ends if k < nxt)
            else:
                end = ends[0]
            i = end + 1
            todo.pop(0)
            continue
        out.append(lines[i])
        i += 1
    assert not todo, f"{which}: region {todo[0][0]!r} not found"
    return out


IMPORT = re.compile(r"^\s*(from\s+\S+\s+import\b|import\s+\S)")


@pytest.mark.parametrize("mod", COPIED)
def test_copied_module_differs_only_in_imports(mod):
    ref = read(REF, mod).replace(REF_PREFIX, "").splitlines()
    port = read(PORT, mod).splitlines()
    regions = REGIONS.get(mod, [])
    ref = cut_regions(ref, regions, f"bath_tpu/{mod}.py")
    port = cut_regions(port, regions, f"bath_tpu_torch/{mod}.py")
    allowed = LINES.get(mod, {})
    drift = []
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    for tag, a0, a1, b0, b1 in sm.get_opcodes():
        if tag == "equal":
            continue
        for n, line in enumerate(port[b0:b1], b0 + 1):
            if not (IMPORT.match(line) or line.strip() in allowed):
                drift.append(f"bath_tpu_torch/{mod}.py (line {n} after the "
                             f"listed regions): {line!r}")
        if b1 - b0 < a1 - a0 or tag == "delete":
            # lines the copy dropped or merged: each must be an import
            # or the original of a listed line
            for line in ref[a0 + (b1 - b0):a1]:
                if not IMPORT.match(line):
                    drift.append(f"bath_tpu/{mod}.py dropped: {line!r}")
    assert not drift, "\n".join(drift)


def test_native_source_differs_only_in_package_names():
    """bathio.cpp: comment lines that name the package, nothing else."""
    ref = read(REF, "native/src/bathio", ".cpp").splitlines()
    port = read(PORT, "native/src/bathio", ".cpp").splitlines()
    assert len(ref) == len(port)
    changed = [(n, a, b) for n, (a, b) in enumerate(zip(ref, port), 1)
               if a != b]
    assert 0 < len(changed) <= 8
    for n, a, b in changed:
        assert a.lstrip().startswith("//") and b.lstrip().startswith("//"), n
        assert a.replace("bath_tpu", "bath_tpu_torch").replace(
            "the TPU framework", "the framework") == b, (n, a, b)


# ---------------------------------------------------------------------
# Functions copied into modules that are not whole copies
# ---------------------------------------------------------------------
class Normalise(ast.NodeTransformer):
    """Drops docstrings and the statements named by <drop> (a predicate
    on statement nodes)."""

    def __init__(self, drop):
        self.drop = drop

    def _body(self, node):
        self.generic_visit(node)
        body = [s for s in node.body if not self.drop(s)]
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            body = body[1:]
        node.body = body or [ast.Pass()]
        return node

    visit_FunctionDef = visit_ClassDef = visit_If = visit_For = _body


def definition(text, name):
    for node in ast.parse(text).body:
        if getattr(node, "name", None) == name:
            return node
    raise AssertionError(f"no top-level {name}")


def calls(stmt, *names):
    """Is <stmt> an expression or assignment whose value calls one of
    <names>?"""
    v = getattr(stmt, "value", None)
    return isinstance(stmt, (ast.Expr, ast.Assign)) \
        and isinstance(v, ast.Call) \
        and getattr(v.func, "id", None) in names


def never(stmt):
    return False


def phase_marks(stmt):
    # the reference's stderr phase clock (BATH_MQ_STATS) is the port's
    # PackedGates.stats["mq_phase_s"]
    return calls(stmt, "mark", "report", "_phase_clock")


def lane_pack_state(stmt):
    # the lane packs' per-query state: component dicts and size classes
    return (isinstance(stmt, ast.FunctionDef) and stmt.name == "size_class") \
        or (isinstance(stmt, ast.AnnAssign)
            and getattr(stmt.target, "attr", None) == "comps")


def from_import(stmt):
    return isinstance(stmt, (ast.Import, ast.ImportFrom))


def parser_tail(stmt):
    # build_parser: --cpu's help and the --backend/--mesh/--hosts block
    # named JAX; the port reads --backend/--device in backend_parser
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        args = stmt.value.args
        return bool(args) and isinstance(args[0], ast.Constant) \
            and args[0].value in ("--cpu", "--backend", "--mesh", "--hosts",
                                  "--host-id", "--coordinator")
    return False


# flush_multi: what the port leaves out of the reference's text.  The
# BATH_MQ_COMBINED and BATH_MQ_RESLICE switches (the combined native
# batches and the serial ORF views are always on); the guards for items
# a device stage gave up (the port's stages answer every item or
# raise); and the thresholds, read from the environment at every flush.
FLUSH_MULTI = [
    ('    use_combined = os.environ.get("BATH_MQ_COMBINED", "1") != "0"\n',
     ''),
    ('    reslice_on = not ctx_pinned and \\\n'
     '        os.environ.get("BATH_MQ_RESLICE", "1") != "0"\n', ''),
    ('-1 if not reslice_on else', '-1 if ctx_pinned else'),
    ('_combine_flat(chunk, skip) if use_combined else None',
     '_combine_flat(chunk, skip)'),
    (' \\\n            if use_combined else (None, None)', ''),
    ('                if post is not None:\n'
     '                    qs.dd_cache[key] = post',
     '                qs.dd_cache[key] = post'),
    ('                if post is not None:\n'
     '                    qs.fsdd_cache[key] = post',
     '                qs.fsdd_cache[key] = post'),
    ('np.array(\n                    [np.nan if v is None else v\n'
     '                     for v in fwd_all[lo:hi]], F32)',
     'np.array(fwd_all[lo:hi], F32)'),
    ('np.array(\n                        [np.nan if v is None else v\n'
     '                         for v in fs3_all[lo:hi]], F32)',
     'np.array(fs3_all[lo:hi], F32)'),
] + [(f'_DEV_MIN["{k}"]', f'_dev_min("{k}")')
     for k in ("fwd", "domdec", "fs3", "fs3dd")]

def backend_options(stmt):
    # bathbuild/bathconvert build_parser: --backend names torch, and the
    # port adds --device
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        args = stmt.value.args
        return bool(args) and isinstance(args[0], ast.Constant) \
            and args[0].value in ("--backend", "--device")
    return False


# cli/bathbuild.py main and cli/bathconvert.py main: the device backend
# is named torch, takes --device and a stats dict, and is called without
# the reference's stall deadline (run_guarded): a CUDA error propagates.
BUILD_MAIN = [
    ('def main(argv=None) -> int:', 'def main(argv=None, stats=None) -> int:'),
    ('args.backend == "jax"', 'args.backend == "torch"'),
    ('run_guarded(\n                    lambda: calibrate_many_device('
     'hmms, ccfg),\n                    len(hmms), "device calibration")',
     'calibrate_many_device(hmms, ccfg, device=args.device, stats=stats)'),
    ('run_guarded(\n                    lambda: calibrate_many_device(\n'
     '                        [h for h, _, _ in rows], ccfg),\n'
     '                    len(rows), "device calibration")',
     'calibrate_many_device([h for h, _, _ in rows], ccfg, '
     'device=args.device, stats=stats)'),
]
CONVERT_MAIN = [
    ('def main(argv=None) -> int:', 'def main(argv=None, stats=None) -> int:'),
    ('args.backend == "jax"', 'args.backend == "torch"'),
    ('run_guarded(lambda: convert_fs_taus_device(fs_items, r, bg),\n'
     '                    len(fs_items), "device fs-tau calibration")',
     'convert_fs_taus_device(fs_items, r, bg, device=args.device, '
     'stats=stats)'),
]

# flush_downstream: on the device the standard branch's F3 survivors are
# planned entry by entry (deferred), then every envelope of the flush is
# filled by one call of the cascade's rescore stage and the survivors
# finished in order (pipeline.finish_survivors)
FLUSH_DOWNSTREAM = [
    ("    from .pipeline import pipeline_fwd_stage\n",
     "    from .pipeline import finish_survivors, pipeline_fwd_stage\n"),
    ("    nres_now = pli.nres\n    pos = 0\n",
     "    nres_now = pli.nres\n    deferred = [] if use_device else None\n"
     "    pos = 0\n"),
    ("                           domdec_fn=cascade.domdec if use_device\n"
     "                           else None)\n        pos += ncand\n",
     "                           domdec_fn=cascade.domdec if use_device\n"
     "                           else None, deferred=deferred)\n"
     "        pos += ncand\n    if deferred:\n"
     "        finish_survivors(pli, om, gm, gm_fs5, bg, deferred, "
     "cascade.rescore)\n"),
]

FUNCTIONS = [
    # (reference module, port module, name, statements dropped, textual
    #  substitutions made in the reference first)
    ("cli/bathsearch", "cli/bathsearch", "build_parser", parser_tail,
     [("(TPU-native bath_tpu)", "(bath_tpu_torch)")]),
    ("cli/bathsearch", "cli/bathsearch", "make_pipeline", never, []),
    ("cli/bathsearch", "cli/bathsearch", "output_header", never, []),
    ("cli/bathsearch", "cli/bathsearch", "load_queries", never, []),
    ("device_pipeline", "device_pipeline", "_perturb", never, []),
    ("device_pipeline", "device_pipeline", "ChunkEntry", never, []),
    ("device_pipeline", "device_pipeline", "flush_chunk", never,
     [("DeviceCascade", "TorchCascade")]),
    ("device_pipeline", "device_pipeline", "flush_gates", never,
     [("DeviceCascade", "TorchCascade")]),
    ("device_pipeline", "device_pipeline", "flush_downstream", never,
     [("DeviceCascade", "TorchCascade")] + FLUSH_DOWNSTREAM),
    ("cli/bathsearch", "cli/bathsearch", "_pool_task", never, []),
    ("multiquery", "multiquery", "QState", lane_pack_state, []),
    ("multiquery", "multiquery", "MQEntry", never, []),
    ("multiquery", "multiquery", "_CombinedOrfs", never, []),
    ("multiquery", "multiquery", "_combine_flat", never, []),
    ("multiquery", "multiquery", "_combine_orfs", never, []),
    ("multiquery", "multiquery", "_dd_server", never, []),
    ("multiquery", "multiquery", "_entry_views", never, []),
    ("multiquery", "multiquery", "flush_multi", phase_marks,
     FLUSH_MULTI),
    # the port's thresholds are read from the environment at every flush
    ("multiquery", "multiquery", "_mq_pool_init", never,
     [('for k in _DEV_MIN:                 # never device-dispatch in a '
       'worker\n        _DEV_MIN[k] = float("inf")',
       'for k in _DEV_MIN_ENV:\n        os.environ[_DEV_MIN_ENV[k]] = "inf"')]),
    ("multiquery", "multiquery", "_mq_pool_task", never, []),
    ("multiquery", "multiquery", "_balance_slices", never, []),
    ("parallel/hosts", "parallel/hosts", "merge_results", never, []),
    ("parallel/hosts", "parallel/hosts", "allgather_results", never, []),
    ("cli/bathbuild", "cli/bathbuild", "_build_task", never, []),
    ("cli/bathbuild", "cli/bathbuild", "build_parser", backend_options,
     [("(TPU-native bath_tpu)", "(bath_tpu_torch)")]),
    ("cli/bathbuild", "cli/bathbuild", "config_from_args", never, []),
    ("cli/bathbuild", "cli/bathbuild", "main", from_import, BUILD_MAIN),
    ("cli/bathbuild", "cli/bathbuild", "cli_entry", never, []),
    ("cli/bathconvert", "cli/bathconvert", "build_parser", backend_options,
     [("(TPU-native bath_tpu)", "(bath_tpu_torch)")]),
    ("cli/bathconvert", "cli/bathconvert", "main", from_import,
     CONVERT_MAIN),
    ("cli/bathconvert", "cli/bathconvert", "cli_entry", never, []),
] + [("evalues_device", "evalues_device", name, never, [])
     for name in ("_clone_rng", "_SharedDraws", "_sample_batch",
                  "_sample_dna_batch", "shared_draws", "_exp_tau",
                  "_fs5_xv_host", "_finish_convert_model",
                  "_fs_taus_serial")]


@pytest.mark.parametrize("ref_mod,port_mod,name,drop,subs", FUNCTIONS,
                         ids=[f"{f[1]}:{f[2]}" for f in FUNCTIONS])
def test_copied_function_is_the_same_code(ref_mod, port_mod, name, drop,
                                          subs):
    ref = read(REF, ref_mod)
    for a, b in subs:
        assert a in ref, f"not in the reference: {a!r}"
        ref = ref.replace(a, b)
    trees = []
    for text in (ref, read(PORT, port_mod)):
        node = Normalise(drop).visit(definition(text, name))
        trees.append(ast.unparse(node).splitlines())
    diff = [ln for ln in difflib.unified_diff(
        trees[0], trees[1], f"bath_tpu/{ref_mod}.py:{name}",
        f"bath_tpu_torch/{port_mod}.py:{name}", lineterm="", n=0)]
    assert not diff, "\n".join(diff)


def statements(fn, first):
    """The statements of <fn> (a definition), in whichever block of it
    holds them, from the one whose source opens with <first> on."""
    for node in ast.walk(fn):
        for field in ("body", "orelse"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for i, s in enumerate(stmts):
                if ast.unparse(s).startswith(first):
                    return stmts[i:]
    raise AssertionError(f"no statement opens with {first!r}")


# Blocks of the CLI's run copied from the reference's run: (the opening
# of their first statement, their number of statements, an id)
BLOCKS = [
    ("if args.fs and args.splice:", 3, "splice-refusals"),
    ("if args.splice and th.N:", 1, "splice-post-pass"),
]


@pytest.mark.parametrize("first,n,name", BLOCKS, ids=[b[2] for b in BLOCKS])
def test_copied_block_is_the_same_code(first, n, name):
    """Comments aside, the port's block is the reference's."""
    blocks = [[ast.unparse(s) for s in statements(
        definition(read(base, "cli/bathsearch"), "run"), first)[:n]]
        for base in (REF, PORT)]
    assert len(blocks[0]) == n
    diff = list(difflib.unified_diff(
        "\n".join(blocks[0]).splitlines(), "\n".join(blocks[1]).splitlines(),
        f"bath_tpu/cli/bathsearch.py:run:{name}",
        f"bath_tpu_torch/cli/bathsearch.py:run:{name}", lineterm="", n=0))
    assert not diff, "\n".join(diff)


# Statements of the reference's run that the port's --cpu pools keep:
# (the opening of the reference's first statement, their number, the
# port's function, the opening there, an id).  The port's pools are
# concurrent.futures executors started by parallel/pool.py (submit,
# done, result, and wait() for AsyncResult.wait), its window pool reads
# the windows through pool.imap in order, the hybrid sends every
# flush's downstream to the device (no volume gates: the reference's
# DEV_MIN, FS_MIN_CELLS and _maybe_down are dropped, and its
# BATH_CHUNK_ORFS default is a constant) and gives its caller's OpenMP
# team size back (POOL_SUBS, made in the reference's statements).
POOL_SUBS = [
    ("_WCTX = dict(", "wctx = dict("),
    ("pool.apply_async(_pool_task, (spec,))", "pool.submit(task, spec)"),
    (".ready()", ".done()"),
    (".get()", ".result()"),
    ("pend[0].wait(0.02)", "wait([pend[0]], 0.02)"),
    ("pend[0].wait(0.05)", "wait([pend[0]], 0.05)"),
    ("pool.imap(_pool_task, shard(window_specs()), chunksize=1)",
     "imap(pool, task, specs, depth=4 * ncpu)"),
    ("set_native_threads(_wthreads)",
     "threads = set_native_threads(_wthreads)"),
    ("int(os.environ.get('BATH_CHUNK_ORFS', 4096))", "4096"),
    ("def _down_flush(use_device):", "def _down_flush():"),
    ("use_device=use_device)", "use_device=True)"),
    ("_maybe_down(final=True)", "_down_flush()"),
    ("_maybe_down()", "_down_flush()"),
]
POOL_BLOCKS = [
    ("_WCTX = dict(", 1, "run", "wctx = dict(", "worker-context"),
    ("nworkers = max(1, ncpu)", 7, "_hybrid", None, "hybrid-settings"),
    ("def _down_flush(use_device):", 3, "_hybrid", "def _down_flush():",
     "hybrid-main-share"),
    ("pend: deque = deque()", 7, "_hybrid", None, "hybrid-policy"),
    ("while True:", 1, "_hybrid", None, "hybrid-loop"),
    ("results.sort(key=lambda r: r[0])", 3, "_hybrid", None, "hybrid-merge"),
    ("_wthreads = max(1, (os.cpu_count() or 1) // ncpu)", 1, "_window_pool",
     None, "pool-threads"),
    ("for _tid, hits, hws, deltas in", 1, "_window_pool", None,
     "pool-in-window-order"),
]


def volume_gate(stmt):
    """The reference hybrid's volume gates, which the port drops."""
    names = [t.id for t in getattr(stmt, "targets", ())
             if isinstance(t, ast.Name)]
    return bool({"DEV_MIN", "FS_MIN_CELLS"} & set(names)) \
        or getattr(stmt, "name", None) == "_maybe_down"


@pytest.mark.parametrize("first,n,fn,port_first,name", POOL_BLOCKS,
                         ids=[b[4] for b in POOL_BLOCKS])
def test_copied_pool_statements_are_the_same_code(first, n, fn, port_first,
                                                  name):
    """Comments, docstrings and the listed changes aside, the port's
    hybrid and window pool are the reference's statements."""
    texts = []
    for base, where, opening in ((REF, "run", first),
                                 (PORT, fn, port_first or first)):
        stmts = [s for s in statements(
            definition(read(base, "cli/bathsearch"), where), opening)
            if base != REF or not volume_gate(s)][:n]
        assert len(stmts) == n
        text = "\n".join(ast.unparse(Normalise(never).visit(s))
                         for s in stmts)
        if base == REF:
            for a, b in POOL_SUBS:
                text = text.replace(a, b)
        texts.append(text.splitlines())
    diff = list(difflib.unified_diff(
        texts[0], texts[1], f"bath_tpu/cli/bathsearch.py:run:{name}",
        f"bath_tpu_torch/cli/bathsearch.py:{fn}:{name}", lineterm="", n=0))
    assert not diff, "\n".join(diff)


# Statements of the reference's run that the port's --hosts keeps: (the
# opening of the reference's first statement, their number, the port's
# opening, an id).  HOSTS_SUBS are made in the reference's statements:
# a rank other than 0 opens one null file an output (the reference's
# one shared null file is closed by the tail's first table, and the next
# write fails); the port's hybrid keeps its own results, so the list for
# the merge exists with --hosts only; the serial host drive's window
# results are taken in the loop that also feeds the device cascade.  The
# merge is compared without the reference's hybrid branch (elif hybrid),
# which the port's _hybrid holds.
HOSTS_SUBS = [
    ("devnull = open(os.devnull, 'w')\n"
     "    ofp = tblfp = fstblfp = extblfp = None\n"
     "    ofp = devnull\n"
     "    tblfp = devnull if args.tblout else None\n"
     "    fstblfp = devnull if args.fstblout else None\n"
     "    extblfp = devnull if args.exontblout else None",
     "ofp = open(os.devnull, 'w')\n"
     "    tblfp = open(os.devnull, 'w') if args.tblout else None\n"
     "    fstblfp = open(os.devnull, 'w') if args.fstblout else None\n"
     "    extblfp = open(os.devnull, 'w') if args.exontblout else None"),
    ("hybrid = args.backend == 'jax' and ncpu > 1 and (nprocs <= 1) and "
     "(cascade is not None)",
     "hybrid = ncpu > 1 and nprocs <= 1 and (cascade is not None)"),
    ("results = [] if nprocs > 1 or hybrid else None",
     "results = [] if nprocs > 1 else None"),
    ("if results is not None:\n    results.append((_tid, th_w.unsrt, hws_w))",
     "if cascade is None and results is not None:\n"
     "    results.append((tid, th_w.unsrt, hws_w))"),
]
HOSTS_BLOCKS = [
    ("nprocs, proc_id = maybe_init_from_args(args)", 2, None, "rank-outputs"),
    ("hybrid = args.backend == 'jax' and ncpu > 1", 1, "hybrid = ncpu > 1",
     "no-hybrid-across-hosts"),
    ("results = [] if nprocs > 1 or hybrid else None", 2,
     "results = [] if nprocs > 1 else None", "results-and-counters"),
    ("def shard(specs):", 1, None, "shard"),
    ("th_w = th if results is None else TopHits()", 2, None,
     "host-drive-results"),
    ("if results is not None:\n    results.append((_tid, th_w", 1,
     "if cascade is None and results is not None:", "host-drive-append"),
    ("if results is not None:\n    for e in staged:", 1, None,
     "cascade-results"),
    ("if nprocs > 1:\n    combined = allgather_results(results)", 1, None,
     "merge"),
]


@pytest.mark.parametrize("first,n,port_first,name", HOSTS_BLOCKS,
                         ids=[b[3] for b in HOSTS_BLOCKS])
def test_copied_hosts_statements_are_the_same_code(first, n, port_first,
                                                   name):
    """Comments and the listed changes aside, the port's --hosts
    statements are the reference's."""
    texts = []
    for base, opening in ((REF, first), (PORT, port_first or first)):
        stmts = statements(definition(read(base, "cli/bathsearch"), "run"),
                           opening)[:n]
        assert len(stmts) == n
        if name == "merge":
            stmts = [ast.If(test=stmts[0].test, body=stmts[0].body,
                            orelse=[])]
        text = "\n".join(ast.unparse(s) for s in stmts)
        if base == REF:
            for a, b in HOSTS_SUBS:
                text = text.replace(a, b)
        texts.append(text.splitlines())
    diff = list(difflib.unified_diff(
        texts[0], texts[1], f"bath_tpu/cli/bathsearch.py:run:{name}",
        f"bath_tpu_torch/cli/bathsearch.py:run:{name}", lineterm="", n=0))
    assert not diff, "\n".join(diff)


# ---------------------------------------------------------------------
# No import of the reference or of JAX
# ---------------------------------------------------------------------
def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_module_imports_the_reference_or_jax():
    bad = []
    assert len(port_files()) > 40
    for path in port_files():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("bath_tpu", "jax", "jaxlib"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:"
                               f"{node.lineno}: {n}")
    assert not bad, "\n".join(bad)


BLOCK = '''
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("bath_tpu", "jax", "jaxlib"):
            raise ImportError(name + " is made unimportable")
sys.meta_path.insert(0, _Block())
try:
    import bath_tpu
except ImportError:
    pass
else:
    raise SystemExit("the block does not hold")
'''

REPORT = '''
print("LEFT", sorted(m for m in sys.modules
                     if m.split(".")[0] in ("bath_tpu", "jax", "jaxlib")))
'''

FIXTURES = '''
from bath_tpu_torch import fixtures
fx = fixtures.write_fixture(60, 40_000, 2, 3, directory=sys.argv[1])
fs_fx = fixtures.write_fixture(60, 40_000, 2, 3, directory=sys.argv[1],
                               fs=True, n_frameshift=1)
mq = fixtures.write_multi_fixture([60, 40, 70], 60_000, [0, 2], 1, 4,
                                  directory=sys.argv[1])
mq_fs = fixtures.write_multi_fixture([60, 40, 70], 60_000, [0, 2], 1, 4,
                                     directory=sys.argv[1], fs=True)
'''

SEARCH = '''
from bath_tpu_torch.cli import bathsearch
stats = {{}}
rc = bathsearch.run([{args}, "-o", sys.argv[1] + "/out", "--tblout",
                     sys.argv[1] + "/tbl", {fixture}.hmm_path,
                     {fixture}.fasta_path], stats=stats)
hits = sum(1 for ln in open(sys.argv[1] + "/tbl") if ln[0] != "#")
print("RUN", rc, hits, {check})
'''

CASES = {
    "fixtures": ("", "RUN"),
    "cli-single": (SEARCH.format(
        args='"--device", "cpu"', fixture="fx",
        check='stats["fwd_items"] > 0'), "RUN 0 2 True"),
    "cli-single-fs": (SEARCH.format(
        args='"--device", "cpu", "--fs"', fixture="fs_fx",
        check='stats["fs3_items"] > 0'), "RUN 0 2 True"),
    "cli-multi": (SEARCH.format(
        args='"--device", "cpu"', fixture="mq",
        check='len(stats["mq_stages"]) > 0'), "RUN 0 2 True"),
    "cli-multi-fs": (SEARCH.format(
        args='"--device", "cpu", "--fs"', fixture="mq_fs",
        check='stats["fs3_items"] > 0'), "RUN 0 2 True"),
    "cli-splice": ('''
from bath_tpu_torch.cli import bathsearch
sfx = fixtures.write_splice_fixture(120, 40_000, 3, 4, directory=sys.argv[1])
stats = {}
rc = bathsearch.run(["--device", "cpu", "--splice", "--max_intron", "5000",
                     "-o", sys.argv[1] + "/out", "--exontblout",
                     sys.argv[1] + "/ex", sfx.hmm_path, sfx.fasta_path],
                    stats=stats)
print("RUN", rc, fixtures.spliced_found(sys.argv[1] + "/ex", sfx) > 0,
      stats["fwd_items"] > 0 and "splice_s" in stats)
''', "RUN 0 True True"),
    "cli-cpu": ('''
import os
from bath_tpu_torch.cli import bathsearch
os.environ.update(BATH_HYBRID_MAIN="1", BATH_HYBRID_MAXQ="1")
stats, mq_stats = {}, {}
rc = bathsearch.run(["--device", "cpu", "--cpu", "2", "--block_length",
                     "8000", "-o", sys.argv[1] + "/out", fx.hmm_path,
                     fx.fasta_path], stats=stats)
rc2 = bathsearch.run(["--backend", "numpy", "--cpu", "2", "-o",
                      sys.argv[1] + "/mq", mq.hmm_path, mq.fasta_path],
                     stats=mq_stats)
print("RUN", rc, rc2, stats["hybrid_main"] > 0, stats["hybrid_pool"] > 0,
      stats["pools"], mq_stats["pools"])
''', "RUN 0 0 True True 1 2"),
    "cli-numpy-backend": (SEARCH.format(
        args='"--backend", "numpy"', fixture="mq",
        check='list(stats) == ["rescore_host_items"]'),
        "RUN 0 2 True"),
    "bathbuild-torch": ('''
from bath_tpu_torch.cli import bathbuild, bathconvert, bathfetch, bathstat
sto, names = fixtures.write_msa_fixture([40, 70], 8, 3, directory=sys.argv[1])
out = sys.argv[1] + "/built.bhmm"
stats = {}
rc = bathbuild.main(["--backend", "torch", "--device", "cpu", "-o",
                     sys.argv[1] + "/build.log", out, sto], stats=stats)
src = fixtures.write_convert_input(out, sys.argv[1] + "/conv_in.bhmm")
rc2 = bathconvert.main(["--backend", "torch", "--device", "cpu",
                        sys.argv[1] + "/conv.bhmm", src])
rc3 = bathstat.main([out])
rc4 = bathfetch.main(["-o", sys.argv[1] + "/one.bhmm", out, names[1]])
fs5 = sum(ln.startswith("STATS LOCAL FS5")
          for ln in open(sys.argv[1] + "/conv.bhmm"))
print("RUN", rc, rc2, rc3, rc4, stats["cal_models"], fs5)
''', "RUN 0 0 0 0 2 2"),
    "ubench": ('''
from bath_tpu_torch import ubench as ub
x, = ub.inputs("chain", 8, 32, 3)
t, idx = ub.inputs("onehot", 8, 32, 3, n=17)
g, y = ub.inputs("overlap", 8, 32, 3)
outs = [ub.chain(x, 4, 3), ub.onehot_gather(t, idx), ub.onehot_mma(t, idx),
        ub.overlap(g, y, "both", 3), ub.scalars(x[:1], 3)]
print("RUN", [tuple(o.shape) for o in outs] == [(8, 32)] * 4 + [(1, 32)])
''', "RUN True"),
    "mesh": ('''
import numpy as np
from bath_tpu_torch.ops import fs3, fwd, ssv
from bath_tpu_torch.parallel import mesh
hmm, q = fixtures.make_query(40, np.random.default_rng(2), calibrate=False,
                             fs=True)
om = fixtures.search_profile(hmm)
p = (fwd.fwd_params(om), ssv.msv_params(om),
     fs3.fs3_params(fixtures.fs_search_profile(hmm)))
rng = np.random.default_rng(3)
batch = (rng.integers(0, 20, (4, 30)), np.full(4, 30), rng.integers(
    0, 4, (4, 90)), np.full(4, 90), np.full(4, om.tjb_b))
one, two = (mesh.make_pipeline_step(mesh.make_mesh(n, "cpu"), *p)(*batch)
            for n in (1, 2))
print("RUN", all(bool((a == b).all()) for a, b in zip(one, two)),
      one[3].tolist()[0])
''', "RUN True 480"),
    "hosts-and-mesh": ('''
from bath_tpu_torch.cli import bathsearch
from bath_tpu_torch.parallel import hosts
stats = {}
rc = bathsearch.run(["--device", "cpu", "--mesh", "2", "-o", sys.argv[1] +
                     "/out", fx.hmm_path, fx.fasta_path], stats=stats)
print("RUN", rc, hosts.process_count(), hosts.allgather_bytes(b"x"),
      hosts.merge_results([[(1, "b")], [(0, "a")]]),
      sum(stats["mesh_items"]["fwd"]) == stats["fwd_items"] > 0)
''', "RUN 0 1 [b'x'] [(0, 'a'), (1, 'b')] True"),
    "sanitize": ('''
from bath_tpu_torch import sanitize
case = next(c for c in sanitize.cuda_cases() if c.name == "int/one width")
errs = sanitize.run_case(case, "cpu")
print("RUN", sorted(errs) == sorted(case.entries),
      "fwd_parser_seg_kernel" in sanitize.kernel_names(),
      sanitize.runtime("libasan.so").startswith("/"))
''', "RUN True True True"),
    "selfcheck": ('''
from bath_tpu_torch import selfcheck
fn, args = selfcheck.entry("cpu")
rep = selfcheck.dryrun_multichip(2, "cpu", fixture_dir=sys.argv[1])
print("RUN", tuple(fn(*args).shape), rep["step"][3].tolist()[0],
      sorted(rep["mesh_items"]))
''', "RUN (8,) 640 ['fs', 'multiquery', 'splice', 'standard']"),
    "chip_smoke-body": ('''
import chip_smoke
print("RUN", callable(chip_smoke.main))
''', "RUN True"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runs_with_the_reference_and_jax_unimportable(case, tmp_path):
    body, want = CASES[case]
    env = dict(os.environ, BATH_MSV_DEVICE="0", BATH_VIT_DEVICE="0")
    env.pop("BATH_WINDOW_CONTEXT", None)
    r = subprocess.run(
        [sys.executable, "-c", BLOCK + FIXTURES + body + REPORT,
         str(tmp_path)],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "LEFT []", lines[-1]
    if want != "RUN":
        assert want in lines, r.stdout[-2000:]


def test_port_builds_its_own_native_library():
    """From its own source, into build/bath_tpu_torch/, under a name of
    its own; nothing under the reference's package or native/."""
    from bath_tpu_torch import native
    from bath_tpu_torch.cli.bathsearch import require_native
    require_native()
    so = os.path.relpath(native._SO, ROOT)
    assert so.startswith(os.path.join("build", "bath_tpu_torch",
                                      "libbathio_torch_"))
    assert os.path.exists(native._SO)
    assert os.path.relpath(native._SRC, ROOT) == os.path.join(
        "bath_tpu_torch", "native", "src", "bathio.cpp")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
