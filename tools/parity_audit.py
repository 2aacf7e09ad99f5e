"""Automated public-surface parity audit: reference vs dsptoolbox_jax.

Walks every public module, class, function, and method of the reference
package (`dsptoolbox`) and checks that dsptoolbox_jax
exposes the same name with a compatible call signature. Emits a markdown
crosswalk (docs/component_inventory.md) mapping each reference symbol to
its JAX-rebuild location, and exits non-zero on any missing symbol or
signature mismatch.

Run:  python tools/parity_audit.py [--write]
"""

from __future__ import annotations

import inspect
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Stubs so the reference imports without an audio stack (same approach as
# tests/conftest.py).
def _install_stub(name: str, attrs: dict | None = None):
    if name in sys.modules:
        return
    mod = types.ModuleType(name)
    for k, v in (attrs or {}).items():
        setattr(mod, k, v)
    sys.modules[name] = mod


class _Default:
    device = None
    samplerate = None
    blocksize = None
    latency = None
    channels = None


def _stub_env():
    _install_stub(
        "sounddevice",
        {
            "default": _Default(),
            "query_devices": lambda *a, **k: [],
            "playrec": lambda *a, **k: None,
            "rec": lambda *a, **k: None,
            "play": lambda *a, **k: None,
            "sleep": lambda *a, **k: None,
            "CallbackStop": type("CallbackStop", (Exception,), {}),
            "OutputStream": object,
            "DeviceList": list,
        },
    )
    try:
        import soundfile  # noqa: F401
    except Exception:
        def _read(path, **kw):
            import dsptoolbox_jax.io as dtio

            return dtio.read_audio(path)

        _install_stub(
            "soundfile",
            {
                "read": _read,
                "write": lambda *a, **k: None,
            },
        )


SKIP_MODULES = {"plots"}  # compared by name only (presentation layer)

# Intentional, documented signature deviations (docs/parity_notes.md).
ALLOWED_SIG_DIFFS: set[tuple[str, str]] = set()


def _public_names(mod) -> list[str]:
    if hasattr(mod, "__all__"):
        return sorted(mod.__all__)
    return sorted(
        n for n in vars(mod) if not n.startswith("_")
        and not isinstance(getattr(mod, n), types.ModuleType)
    )


def _sig(obj):
    try:
        return inspect.signature(obj)
    except (ValueError, TypeError):
        return None


def _params(sig):
    return [
        (p.name, p.kind, p.default is not inspect.Parameter.empty)
        for p in sig.parameters.values()
    ]


def _compare_callable(path, ref_obj, mine_obj, problems, rows):
    rs, ms = _sig(ref_obj), _sig(mine_obj)
    note = ""
    if rs is not None and ms is not None:
        if _params(rs) != _params(ms) and path not in ALLOWED_SIG_DIFFS:
            rp, mp = _params(rs), _params(ms)

            def _compat(ref_p, mine_p):
                # same name+kind; ours may add a default where ref has none
                rn, rk, rd = ref_p
                mn, mk, md = mine_p
                return rn == mn and rk == mk and (md or not rd)

            head_ok = len(mp) >= len(rp) and all(
                _compat(r, m) for r, m in zip(rp, mp)
            )
            tail_ok = all(d for (_, _, d) in mp[len(rp):])
            if head_ok and tail_ok:
                note = (
                    "compatible superset" if len(mp) > len(rp)
                    else "defaults added"
                )
            else:
                problems.append(
                    f"SIGNATURE {path}: ref{rs} != ours{ms}"
                )
                note = "SIGNATURE MISMATCH"
    rows.append((path, "ok" if not note.startswith("SIG") else "MISMATCH",
                 note))


def _compare_class(path, ref_cls, mine, problems, rows):
    if not inspect.isclass(mine):
        problems.append(f"NOT A CLASS {path}")
        rows.append((path, "MISSING", "not a class in this build"))
        return
    rows.append((path, "ok", "class"))
    for name, member in sorted(vars(ref_cls).items()):
        public = not name.startswith("_") or name == "__init__"
        if not public:
            continue
        if isinstance(member, (staticmethod, classmethod)):
            member = member.__func__
        if isinstance(member, property):
            if not isinstance(
                inspect.getattr_static(mine, name, None), property
            ) and not hasattr(mine, name):
                problems.append(f"MISSING PROPERTY {path}.{name}")
                rows.append((f"{path}.{name}", "MISSING", "property"))
            continue
        if not callable(member):
            continue
        mm = inspect.getattr_static(mine, name, None)
        if mm is None:
            problems.append(f"MISSING METHOD {path}.{name}")
            rows.append((f"{path}.{name}", "MISSING", "method"))
            continue
        if isinstance(mm, (staticmethod, classmethod)):
            mm = mm.__func__
        _compare_callable(f"{path}.{name}", member, mm, problems, rows)


def run_audit():
    """Audit the full public surface → (rows, problems)."""
    _stub_env()
    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    import dsptoolbox as ref
    import dsptoolbox_jax as mine

    problems: list[str] = []
    rows: list[tuple[str, str, str]] = []

    mod_names = ["", "audio_io", "beamforming", "distances", "effects",
                 "generators", "filterbanks", "room_acoustics", "standard",
                 "tools", "transfer_functions", "transforms", "plots"]
    for mname in mod_names:
        rmod = ref if mname == "" else getattr(ref, mname, None)
        mmod = mine if mname == "" else getattr(mine, mname, None)
        if rmod is None:
            continue
        if mmod is None:
            problems.append(f"MISSING MODULE {mname}")
            continue
        label = mname or "dsptoolbox"
        for name in _public_names(rmod):
            robj = getattr(rmod, name, None)
            if robj is None or isinstance(robj, types.ModuleType):
                continue
            path = f"{label}.{name}"
            mobj = getattr(mmod, name, None)
            if mobj is None:
                problems.append(f"MISSING {path}")
                rows.append((path, "MISSING", ""))
                continue
            if mname in SKIP_MODULES:
                rows.append((path, "ok", "name-only (presentation)"))
                continue
            if inspect.isclass(robj):
                if isinstance(robj, type) and issubclass(robj, Exception):
                    rows.append((path, "ok", "exception type"))
                    continue
                import enum
                if issubclass(robj, enum.Enum):
                    missing = [m for m in robj.__members__
                               if m not in getattr(mobj, "__members__", {})]
                    if missing:
                        problems.append(
                            f"ENUM {path} missing members {missing}"
                        )
                        rows.append((path, "MISMATCH",
                                     f"missing members {missing}"))
                    else:
                        rows.append((path, "ok",
                                     f"enum, {len(robj.__members__)} members"))
                    continue
                _compare_class(path, robj, mobj, problems, rows)
            elif callable(robj):
                _compare_callable(path, robj, mobj, problems, rows)
            else:
                rows.append((path, "ok", "data"))
    return rows, problems


def main():
    rows, problems = run_audit()
    n_ok = sum(1 for _, s, _ in rows if s == "ok")
    print(f"{n_ok}/{len(rows)} symbols at parity; "
          f"{len(problems)} problems")
    for p in problems:
        print("  " + p)

    if "--write" in sys.argv:
        out = ["# Component inventory crosswalk (auto-generated)",
               "",
               "Generated by `tools/parity_audit.py`. Every public symbol "
               "of the reference package and its parity status in "
               "`dsptoolbox_jax`.",
               "",
               f"**{n_ok}/{len(rows)} symbols at parity, "
               f"{len(problems)} known problems.**",
               "",
               "| Reference symbol | Status | Note |",
               "|---|---|---|"]
        for path, status, note in rows:
            out.append(f"| `{path}` | {status} | {note} |")
        with open(os.path.join(os.path.dirname(__file__),
                               "..", "docs", "component_inventory.md"),
                  "w") as f:
            f.write("\n".join(out) + "\n")
        print("wrote docs/component_inventory.md")

    sys.exit(1 if problems else 0)


if __name__ == "__main__":
    main()
