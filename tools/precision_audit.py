"""Audit device contraction call sites for explicit precision.

On an H100, XLA runs float32 `einsum`/`dot`/`matmul`/`tensordot` and
convolutions in TF32 on the tensor cores unless a `precision=` is given:
TF32 keeps a 10-bit mantissa, a silent ~1e-3 relative error, while
`precision=HIGHEST` keeps full fp32 products. The CPU test mesh ignores
the parameter entirely (always true fp32), so only runs on the card can
catch a missing annotation. This audit walks the package AST and flags
every contraction call on a device module without an explicit
`precision=` (or `preferred_element_type=`).

Run directly for a report, or through `tests/test_precision_guard.py`
which fails on any unlisted site.
"""

from __future__ import annotations

import ast
import os

PACKAGE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "dsptoolbox_jax",
)

# jnp./lax. attribute calls that contract on the tensor cores at default
# precision
CONTRACTION_ATTRS = {
    "einsum",
    "dot",
    "matmul",
    "tensordot",
    "vdot",
    "inner",
    "convolve",
    "correlate",
    "conv_general_dilated",
    "dot_general",
    "conv",
}
# module aliases whose calls run on device (np./scipy are host, exact)
DEVICE_MODULES = {"jnp", "lax"}

# Adjudicated sites that intentionally omit `precision=`:
#   path:lineno: reason
ALLOWLIST: dict[str, str] = {}


def _module_name(node: ast.AST) -> str | None:
    # jnp.einsum -> "jnp"; jax.lax.dot_general -> "lax"
    if isinstance(node, ast.Attribute):
        base = node.value
        if isinstance(base, ast.Name):
            return base.id
        if isinstance(base, ast.Attribute):
            return base.attr
    return None


def scan_file(path: str) -> list[tuple[str, int, str]]:
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    rel = os.path.relpath(path, os.path.dirname(PACKAGE))
    offenders = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr not in CONTRACTION_ATTRS:
            continue
        mod = _module_name(fn)
        if mod not in DEVICE_MODULES:
            continue
        kwargs = {k.arg for k in node.keywords}
        if "precision" in kwargs or "preferred_element_type" in kwargs:
            continue
        key = f"{rel}:{node.lineno}"
        if key in ALLOWLIST:
            continue
        offenders.append((rel, node.lineno, f"{mod}.{fn.attr}"))
    return offenders


def scan_package() -> list[tuple[str, int, str]]:
    out = []
    for root, _dirs, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                out.extend(scan_file(os.path.join(root, name)))
    return out


if __name__ == "__main__":
    offenders = scan_package()
    for rel, line, what in offenders:
        print(f"{rel}:{line}: {what} without explicit precision")
    print(f"{len(offenders)} sites missing explicit precision")
    raise SystemExit(1 if offenders else 0)
