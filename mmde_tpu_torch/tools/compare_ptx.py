"""Compare the tensor-core kernels of two checkouts instruction by
instruction: for each kernel of `csrc/window_attention_{fwd,bwd,
bwd_resident}_tc.cu`, whether its PTX is the same in both trees and its
registers and spills as ptxas reports them, both with the library build's
flags (`ops/cuda_build.py`).

    python -m mmde_tpu_torch.tools.compare_ptx --tree OTHER [--out DIR]

OTHER is another checkout (unpack it with `git archive` into a gitignored
directory). A kernel is matched by its name; one the other tree builds
under the template signature before the operand type was added is matched
by its name with that type (`fwd_tc_w_kernel<bf16, TB, M>` against
`fwd_tc_w_kernel<TB, M>`; `fwd_tc_kernel<L, bf16, TB, M>` against
`fwd_tc_kernel<L, TB, M>`). Names
that carry a per-file hash (the anonymous namespace, shared arrays) and
virtual register numbers are set aside before comparing, so "same" means
the same instructions in the same order. Prints one JSON line per kernel
of OTHER, then one per kernel only this tree has, then a summary: the
kernels whose PTX differs from OTHER's and those only this tree has (a
change that adds an instantiation lists it there and nothing else). Needs
nvcc; no card.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

from mmde_tpu_torch.ops import cuda_build

SOURCES = ("window_attention_fwd_tc.cu", "window_attention_bwd_tc.cu",
           "window_attention_bwd_resident_tc.cu")
_BASE = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
# the kernels this tree templates over the operand type as well: first
# (_TYPED), or after the layout (_TYPED_AFTER_LAYOUT)
_TYPED = ("fwd_tc_w_kernel", "bwd_dq_tc_w_kernel", "bwd_dkv_tc_w_kernel",
          "bwd_resident_tc_kernel")
_TYPED_AFTER_LAYOUT = ("fwd_tc_kernel", "bwd_dq_tc_kernel",
                       "bwd_dkv_tc_kernel")


def _demangle(names: list) -> list:
    filt = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(cuda_build.find_nvcc()), "cu++filt")
    if not os.path.exists(filt):
        filt = shutil.which("c++filt")
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return [_name(re.sub(r"\(anonymous namespace\)::|<unnamed>::|^void ",
                         "", o)) for o in out]


def _name(sig: str) -> str:
    """A demangled signature up to the end of its template arguments (which
    may hold parentheses, "(int)0"), without the parameters."""
    depth = 0
    for i, ch in enumerate(sig):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0:
                return sig[:i + 1]
        elif ch == "(" and depth == 0:
            return sig[:i]
    return sig


def _normalise(body: str) -> str:
    body = re.sub(r"_ZZN[A-Za-z0-9_]+", "SYM", body)
    body = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "NS_", body)
    body = re.sub(r"\$L__BB\d+_", "$L__BB_", body)
    return re.sub(r"%(r|rd|f|fd|p|rs)\d+", r"%\1", body)


def _entries(ptx: str) -> dict:
    raw = {m.group(1): _normalise(m.group(2).replace(m.group(1), "K"))
           for m in re.finditer(r"\.entry\s+([A-Za-z0-9_$]+)\((.*?)\n\}\n",
                                ptx, re.S)}
    return dict(zip(_demangle(list(raw)), raw.values()))


def _ptxas(log: str) -> dict:
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out.setdefault(cur, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return dict(zip(_demangle(list(out)), out.values()))


def _build(tree: str, src: str, work: str) -> tuple:
    """(PTX text, ptxas log) of one source of `tree`: the library build
    (cuda_build.NVCC_FLAGS, whose log gives the registers), and the PTX
    with the same optimisation flags."""
    nvcc = cuda_build.find_nvcc()
    path = os.path.join(tree, "mmde_tpu_torch", "csrc", src)
    tag = f"{abs(hash(tree))}_{src}"
    ptx = os.path.join(work, tag + ".ptx")
    opt = [f for f in cuda_build.NVCC_FLAGS if f.startswith("--split")]
    subprocess.run([nvcc, *_BASE, *opt, "-ptx", "-o", ptx, path],
                   check=True, capture_output=True)
    log = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o",
                          os.path.join(work, tag + ".so"), path],
                         check=True, capture_output=True, text=True)
    with open(ptx) as f:
        return f.read(), log.stdout + log.stderr


def _typed_as_other(name: str) -> str:
    """This tree's name of a kernel as the other tree spells it."""
    for k in _TYPED:
        if name.startswith(k + "<__nv_bfloat16, "):
            return k + "<" + name[len(k) + len("<__nv_bfloat16, "):]
    for k in _TYPED_AFTER_LAYOUT:
        for layout in ("Rows", "MapRows"):
            head = f"{k}<{layout}, __nv_bfloat16, "
            # (layout, type, bias type, mode): four arguments
            if name.startswith(head) and name.count(",") == 3:
                return f"{k}<{layout}, " + name[len(head):]
    return name


def _match(name: str, mine) -> str:
    """This tree's kernel (of the names `mine`) that the other tree's kernel
    `name` is compared with: the same name, or the typed name whose
    untyped spelling `name` is; None for a kernel this tree lacks."""
    if name in mine:
        return name
    return next((k for k in mine if _typed_as_other(k) == name), None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", required=True, help="the other checkout")
    p.add_argument("--out", default=None,
                   help="keep the PTX files in this directory")
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    work = args.out or tempfile.mkdtemp()
    os.makedirs(work, exist_ok=True)
    jobs = [(t, s) for s in SOURCES for t in (args.tree, here)]
    summary = {"same_ptx": 0, "different_ptx": [], "only_this_tree": [],
               "only_other_tree": []}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: _build(*j, work), jobs)))
    for src in SOURCES:
        (o_ptx, o_log), (h_ptx, h_log) = built[(args.tree, src)], \
            built[(here, src)]
        other, mine = _entries(o_ptx), _entries(h_ptx)
        o_regs, h_regs = _ptxas(o_log), _ptxas(h_log)
        matched = set()
        for name, body in other.items():
            k = _match(name, mine)
            matched.add(k)
            rec = {"source": src, "kernel": name, "matched": k,
                   "same_ptx": k is not None and mine[k] == body,
                   "other": o_regs.get(name), "this": h_regs.get(k)}
            if k is not None and not rec["same_ptx"]:
                rec["lines_differing"] = sum(
                    ln[:1] in "+-" and not ln.startswith(("+++", "---"))
                    for ln in difflib.unified_diff(
                        body.splitlines(), mine[k].splitlines(), n=0))
            if k is None:
                summary["only_other_tree"].append(name)
            elif rec["same_ptx"]:
                summary["same_ptx"] += 1
            else:
                summary["different_ptx"].append(k)
            print(json.dumps(rec))
        for k in mine:
            if k not in matched:
                summary["only_this_tree"].append(k)
                print(json.dumps({"source": src, "kernel": k,
                                  "only_this_tree": True,
                                  "this": h_regs.get(k)}))
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
