"""Guard: every device contraction call site carries an explicit precision.

On an H100, f32 `einsum`/`dot`/`matmul`/`tensordot`/conv default to TF32
(~1e-3 relative error). The CPU test mesh ignores the `precision=`
parameter (always true fp32), so a missing annotation is invisible to the
whole oracle suite and only surfaces as wrong numbers on the card.
`tools/precision_audit.py` AST-scans the package; this test keeps it at
zero offenders.
"""

import os
import sys

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"),
)

from precision_audit import scan_package  # noqa: E402


def test_no_mxu_site_without_explicit_precision():
    offenders = scan_package()
    assert not offenders, (
        "contractions without explicit precision= (TF32 on the GPU): "
        + "; ".join(f"{r}:{ln} {w}" for r, ln, w in offenders)
    )
