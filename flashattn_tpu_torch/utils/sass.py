"""The SASS of the port's built kernels, kernel by kernel, and a comparison
of two checkouts' builds.

    python -m flashattn_tpu_torch.utils.sass OLD_CHECKOUT LIB [LIB ...] [--show KERNEL]

builds each LIB (a library of ops/_build.ENTRY_POINTS) in this checkout and
in OLD_CHECKOUT (another checkout of the repo, such as a `git archive` of
the parent commit), and prints for each library how many of the old
build's kernels compiled to the same instructions here (instruction text,
addresses and encodings left out). A kernel here whose template arguments
end in more `false`s (flags added since, off) is matched with the old
kernel without them; a kernel that differs is marked where it holds the same
opcodes as often (its instructions only reordered or given other
registers). `--show KERNEL` (a label as kernel_label gives it, in the old
build's form) prints that kernel's differing instructions. Needs the CUDA
toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
from pathlib import Path

from flashattn_tpu_torch.ops import _build


def kernel_label(mangled: str) -> str:
    """'flash_fwd_mma_kernel<64>' from the mangled name of a kernel in csrc/:
    after _Z (or _ZN, a nested name) each component is its length then its
    characters (an anonymous namespace's holds digits of a hash, which may
    read as another length), read in order up to the one ending in
    "_kernel", then its template arguments."""
    start = re.match(r"_ZN?", mangled)
    m = None
    pos = start.end() if start else len(mangled)
    while (num := re.match(r"\d+", mangled[pos:])) is not None:
        name = mangled[pos + num.end():pos + num.end() + int(num.group())]
        pos += num.end() + len(name)
        if name.endswith("_kernel"):
            m = re.match(r"I(.*?)E+v", mangled[pos:])
            break
    if m is None:
        return mangled
    types = {"13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "fp8", "f": "float", "a": "int8",
             "Lb0": "false", "Lb1": "true"}
    args = []
    for t in re.finditer(r"13__nv_bfloat16|13__nv_fp8_e4m3|S\d*_|Li(\d+)|Lb[01]|f|a",
                         m.group(1)):
        # S_, S0_, ... repeat a type already named: the first, in these kernels
        args.append(t.group(1) or (args[0] if t.group(0).startswith("S") else types[t.group(0)]))
    return f"{name}<{', '.join(args)}>"


def dump(lib_path: Path) -> str:
    """cuobjdump -sass of a built library (cuobjdump beside nvcc)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def kernels(sass: str) -> dict[str, list[str]]:
    """{kernel label: its instructions' text}, from cuobjdump -sass."""
    out, kernel = {}, None
    for line in sass.splitlines():
        entry = re.search(r"Function : (\S+)", line)
        if entry:
            kernel = kernel_label(entry.group(1))
            out[kernel] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if kernel is not None and ins:
            out[kernel].append(re.sub(r"\s+", " ", ins.group(1)))
    return out


def tensor_core_counts(sass: str) -> dict[str, dict[str, int]]:
    """{kernel label: {"HMMA": n, "HGMMA": n, "IMMA": n}}, the tensor-core
    instructions by kind in each kernel of cuobjdump -sass's text: what
    `kernels` would give, counted without splitting the text into lines."""
    parts = re.split(r"Function : (\S+)", sass)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        n = dict.fromkeys(("HMMA", "HGMMA", "IMMA"), 0)
        for op in re.findall(r"\b(HMMA|HGMMA|IMMA)\.", body):
            n[op] += 1
        out[kernel_label(name)] = n
    return out


def old_form(label: str, old: dict) -> str:
    """The old build's label of a kernel here: the same, or without its
    last `false` template arguments, as many as the old build lacks."""
    while label not in old and label.endswith(", false>"):
        label = label[:-len(", false>")] + ">"
    return label


def opcodes(instructions: list[str]) -> list[str]:
    """The sorted opcodes (predicates and operands left out)."""
    return sorted(re.sub(r"^@!?U?P\w+ ", "", ins).split(" ", 1)[0] for ins in instructions)


def compare(old: dict[str, list[str]], new: dict[str, list[str]]) -> tuple[list, list]:
    """(kernels of the old build compiled alike here, [(kernel, old count,
    new count, the same opcodes as often: only order and registers moved)
    of the others])."""
    here = {old_form(k, old): v for k, v in new.items()}
    same = [k for k in old if here.get(k) == old[k]]
    differ = [(k, len(old[k]), len(here.get(k, [])),
               opcodes(old[k]) == opcodes(here.get(k, []))) for k in old if k not in same]
    return same, differ


def built(checkout: Path, libs: list[str]) -> dict[str, Path]:
    """Build `libs` in a checkout of the repo (its own ops/_build.py, in a
    process of its own) and return their paths."""
    code = ("import sys; from flashattn_tpu_torch.ops import _build; "
            "libs = sys.argv[1:]; _build.build_all(libs); "
            "print('\\n'.join(str(_build.library_path(n)) for n in libs))")
    env = dict(os.environ, PYTHONPATH=str(checkout))
    out = subprocess.run([sys.executable, "-c", code, *libs], cwd=checkout, env=env,
                         capture_output=True, text=True, check=True).stdout
    return dict(zip(libs, map(Path, out.split())))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, help="another checkout of the repo")
    ap.add_argument("libs", nargs="+", help="libraries of ops/_build.ENTRY_POINTS")
    ap.add_argument("--show", help="print this kernel's differing instructions")
    args = ap.parse_args()
    olds = built(args.old.resolve(), args.libs)
    news = built(Path(__file__).resolve().parents[2], args.libs)
    for lib in args.libs:
        old, new = kernels(dump(olds[lib])), kernels(dump(news[lib]))
        same, differ = compare(old, new)
        print(f"[sass] {lib}: {len(same)} of {len(old)} kernels identical; differ "
              f"(kernel, old instructions, new, same opcodes): {differ}")
        if args.show in old:
            here = {old_form(k, old): v for k, v in new.items()}
            diff = list(difflib.unified_diff(old[args.show], here.get(args.show, []),
                                             "old", "new", n=0, lineterm=""))
            print(f"[sass] {lib} {args.show}: {len(diff)} diff lines")
            print("\n".join(diff[:200]))


if __name__ == "__main__":
    main()
