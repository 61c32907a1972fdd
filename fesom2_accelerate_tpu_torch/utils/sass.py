"""Compare the machine code (SASS) of the FCT kernels in two builds.

A kernel that gains a compile-time flag (``TRACERS``, H-K4's ``FIX``) keeps
its earlier code in the instances where the flag is off only if the
compiler folds the new branches away.  This script shows whether it did:
it builds ``fct_ale.cu`` of another checkout and of this one with the
nvcc command of ``ops/cuda/build.py`` (printing each build's seconds),
disassembles both libraries (``cuobjdump -sass``), and compares each
kernel instance of the other build with the instance of
this one that has the same template arguments plus the new flags off
(``Lb0E`` each), instruction for instruction, encodings included.  Needs
nvcc and cuobjdump (a machine with the CUDA toolkit; no card).

Usage, from the root of a checkout::

    python -m fesom2_accelerate_tpu_torch.utils.sass OTHER_CHECKOUT

Prints one line per instance and exits 1 if an instance differs or has no
counterpart.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import time

from fesom2_accelerate_tpu_torch.ops.cuda import build

SOURCE = "fct_ale.cu"
ROOT = build.CSRC.parents[3]  # the checkout of this package
# a kernel instance's mangled name: the kernel and its template arguments
_NAME = re.compile(r"(?<=\d)((?:" + "|".join(build.KERNELS)
                   + r")_kernel)I([fd](?:L[ib]\d+E)+)E")


def disassemble(lib: pathlib.Path) -> dict:
    """{(kernel, template arguments): SASS lines} of every kernel instance
    in the library at ``lib`` (``cuobjdump -sass``), without the lines
    that name the function."""
    cuobjdump = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = _NAME.search(line)
            cur = funcs.setdefault(m.groups(), []) if m else None
            continue
        if cur is not None and line.strip():
            cur.append(line.strip())
    return funcs


def build_at(checkout: pathlib.Path, out: pathlib.Path) -> float:
    """Compiles the fct_ale.cu of the checkout at ``checkout`` with this
    build's nvcc command into ``out``; returns nvcc's wall seconds."""
    cmd = build.nvcc_command(SOURCE, out)
    cmd[-1] = str(checkout / build.CSRC.relative_to(ROOT) / SOURCE)
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return time.perf_counter() - t0


def compare(old: dict, new: dict) -> list[str]:
    """One line per instance of ``old``: equal or not to its counterpart
    in ``new`` (the same arguments, then any number of flags off)."""
    lines = []
    for (kernel, args), sass in sorted(old.items()):
        match = [k for k in new if k[0] == kernel and k[1].startswith(args)
                 and re.fullmatch(r"(?:Lb0E)*", k[1][len(args):])]
        if len(match) != 1:
            lines.append(f"MISSING {kernel}<{args}>: {len(match)} "
                         f"counterparts")
            continue
        same = new[match[0]] == sass
        lines.append(f"{'same' if same else 'DIFFERENT'} {kernel}<{args}> "
                     f"as <{match[0][1]}>: {len(sass)} lines")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path,
                    help="root of the checkout to compare with")
    args = ap.parse_args(argv)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for label, root in (("other", args.other), ("this", ROOT)):
        libs[label] = build.BUILD_DIR / f"sass_{label}.so"
        print(f"{label} checkout: {build_at(root, libs[label]):.1f} s of "
              f"nvcc for {SOURCE}", flush=True)
    old, new = disassemble(libs["other"]), disassemble(libs["this"])
    lines = compare(old, new)
    for line in lines:
        print(line)
    bad = [x for x in lines if not x.startswith("same")]
    print(f"{len(lines) - len(bad)} of {len(lines)} instances of "
          f"{args.other} have the same SASS here; {len(new)} instances "
          f"here")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
