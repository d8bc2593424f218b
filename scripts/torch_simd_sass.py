"""SASS instruction counts of MSV's per-lane byte work on sm_90a: four
model lanes as four scalar ints (the kernel's way, csrc/msv_filter.cu)
against four lanes packed in one 32-bit word with CUDA's byte SIMD
intrinsics (__vsubss4, __vmaxu4, __vaddus4, __vsubus4); with
``--ssv-row``, the SSV capture's row loop instead.

    python3 scripts/torch_simd_sass.py [--out FILE] [--ssv-row DIR ...]

Writes two small kernels to build/simd_sass/, compiles them with nvcc
for sm_90a and disassembles them with cuobjdump -sass.  Each kernel
reads its inputs as one 16-byte word a thread, does one row's work of
four lanes (the SSV saturating difference, the MSV cell with its xB
floor, bias and cost, and the two running maxima) and stores its
outputs; only the arithmetic between the loads and the stores differs.
Prints one JSON line: per kernel the count of SASS instructions that are
neither memory, control nor moves, and the opcodes behind it.

``--ssv-row DIR ...`` compiles each checkout's
``bath_tpu_torch/ops/kernels/csrc/ssv_capture.cu`` and counts, in the
instance of 13 lanes a thread (M = 400), the instructions of the
innermost loop (the row loop; a crossing row's block and, in a
checkout that reads residues ahead, the refill every 16 rows included),
by kind: memory, shuffles and votes, barriers, control, the rest.
Needs nvcc and cuobjdump ($CUDA_HOME or /usr/local/cuda); no GPU.
"""

import argparse
import collections
import json
import os
import re
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SRC = r'''
#include <stdint.h>

// four lanes, one int each: the kernel's arithmetic (msv_filter.cu)
extern "C" __global__ void lanes_scalar(const int4* __restrict__ in,
                                        int4* __restrict__ out) {
  const int i = threadIdx.x;
  const int4 a = in[4 * i], b = in[4 * i + 1], c = in[4 * i + 2];
  const int4 e = in[4 * i + 3];
  const int dp[4] = {a.x, a.y, a.z, a.w}, s[4] = {b.x, b.y, b.z, b.w};
  const int mp[4] = {c.x, c.y, c.z, c.w}, r[4] = {e.x, e.y, e.z, e.w};
  const int xB = a.x >> 16, bias = b.x >> 16;
  int nd[4], sv[4], umax = c.x >> 16, xE = e.x >> 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    nd[j] = min(max(dp[j] - s[j], -128), 127);
    int v = max(mp[j], xB);
    sv[j] = max(min(v + bias, 255) - r[j], 0);
    umax = max(umax, nd[j] & 0xFF);
    xE = max(xE, sv[j]);
  }
  out[2 * i] = make_int4(nd[0], nd[1], nd[2], nd[3]);
  out[2 * i + 1] = make_int4(sv[0], sv[1], umax, xE);
}

// four lanes in one word a value: byte SIMD
extern "C" __global__ void lanes_packed(const int4* __restrict__ in,
                                        int4* __restrict__ out) {
  const int i = threadIdx.x;
  const int4 a = in[i];
  const unsigned dp = a.x, s = a.y, mp = a.z, r = a.w;
  const unsigned xB = __byte_perm(dp, 0, 0x3333);
  const unsigned bias = __byte_perm(s, 0, 0x3333);
  unsigned umax = __byte_perm(mp, 0, 0x2222), xE = __byte_perm(r, 0, 0x2222);
  const unsigned nd = __vsubss4(dp, s);
  unsigned sv = __vmaxu4(mp, xB);
  sv = __vsubus4(__vaddus4(sv, bias), r);
  umax = __vmaxu4(umax, nd);
  xE = __vmaxu4(xE, sv);
  out[i] = make_int4(nd, sv, umax, xE);
}
'''
SKIP = re.compile(r"^(LD|ST|S2R|S2UR|EXIT|BRA|NOP|ULDC|MOV|UMOV|IMAD\.WIDE|"
                  r"ULEA|UIMAD|ULOP|USHF|UIADD|CS2R|BAR|RET)")


def count(sass: str) -> dict:
    """{kernel: (arithmetic instruction count, opcode counts)}."""
    out, name, ops = {}, None, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name, ops = m.group(1), collections.Counter()
            out[name] = ops
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and ops is not None and not SKIP.match(m.group(1)):
            ops[m.group(1)] += 1
    return {k: {"arith": sum(v.values()), "opcodes": dict(v)}
            for k, v in out.items()}


KINDS = (("memory", re.compile(r"^(LD|ST|LDG|LDS|STG|STS|ATOM|RED)")),
         ("shuffle_vote", re.compile(r"^(SHFL|VOTE|REDUX|MATCH)")),
         ("barrier", re.compile(r"^(BAR|WARPSYNC)")),
         ("control", re.compile(r"^(BRA|BSSY|BSYNC|EXIT|CALL|RET|NOP)")))


def row_loop(sass: str, kernel: re.Pattern) -> dict:
    """The row loop of the first function whose name matches <kernel>:
    its instructions by kind (the smallest region between a backward
    branch and its target that holds a shuffle)."""
    fn, lines = None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            if fn:
                break
            fn = m.group(1) if kernel.search(m.group(1)) else None
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)(.*)", line)
        if fn and m:
            lines.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for at, op, rest in lines:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < at:
            lo = int(t.group(1), 16)
            # a row exchanges its lane neighbour: the table's staging
            # loop has no shuffle
            if any(o.startswith("SHFL") for a, o, _ in lines
                   if lo <= a <= at):
                loops.append((at - lo, lo, at))
    _, lo, hi = min(loops)
    body = [op for a, op, _ in lines if lo <= a <= hi]
    kinds = collections.Counter()
    for op in body:
        kinds[next((k for k, r in KINDS if r.match(op)), "other")] += 1
    return {"function": fn, "instructions": len(body), **kinds}


def ssv_rows(home: str, trees) -> dict:
    out = {}
    for tree in trees:
        src = Path(tree) / "bath_tpu_torch/ops/kernels/csrc/ssv_capture.cu"
        work = HERE / "build" / "simd_sass" / Path(tree).resolve().name
        work.mkdir(parents=True, exist_ok=True)
        cubin = work / "ssv_capture.cubin"
        subprocess.run([os.path.join(home, "bin", "nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-cubin", "-o", str(cubin), str(src)], check=True)
        sass = subprocess.run([os.path.join(home, "bin", "cuobjdump"),
                               "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        out[str(tree)] = row_loop(sass,
                                  re.compile(r"ssv_capture_kernelILi13E"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--ssv-row", nargs="+", default=[])
    args = ap.parse_args(argv)
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if args.ssv_row:
        line = json.dumps({"target": "sm_90a", "ssv_capture_row":
                           ssv_rows(home, args.ssv_row)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        return
    work = HERE / "build" / "simd_sass"
    work.mkdir(parents=True, exist_ok=True)
    (work / "lanes.cu").write_text(SRC)
    cubin = work / "lanes.cubin"
    subprocess.run([os.path.join(home, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o",
                    str(cubin), str(work / "lanes.cu")], check=True)
    sass = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    (work / "lanes.sass").write_text(sass)
    rec = {"target": "sm_90a", "lanes_per_kernel": 4, **count(sass)}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
