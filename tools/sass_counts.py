#!/usr/bin/env python3
"""Count the SASS instructions of kernels, by opcode, in built libraries:

    python3 tools/sass_counts.py LIB.so PATTERN [LIB.so ...]

For each library (``cuobjdump -sass``, from the CUDA toolkit) every function
whose mangled name matches the regular expression ``PATTERN`` is listed with
its instruction count and its most frequent opcodes (the opcode without its
modifiers: ``FFMA``, ``MUFU``, ``I2F`` ...).  Prints one JSON line."""

import collections
import json
import re
import shutil
import subprocess
import sys


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand:
            return cand
    sys.exit("cuobjdump not found: it comes with the CUDA toolkit")


def counts(lib, pattern):
    """{function: {"instructions": n, "opcodes": {opcode: n}}} for the
    functions of ``lib`` whose name matches ``pattern``."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name, ops = {}, None, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m[1] if re.search(pattern, m[1]) else None
            if name:
                ops = out.setdefault(name, collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m:
            ops[m[1]] += 1
    return {n: {"instructions": sum(c.values()), "opcodes": dict(c.most_common(24))}
            for n, c in out.items()}


def main():
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    pattern = sys.argv[2]
    libs = [sys.argv[1], *sys.argv[3:]]
    print(json.dumps({lib: counts(lib, pattern) for lib in libs}), flush=True)


if __name__ == "__main__":
    main()
