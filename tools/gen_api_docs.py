"""Generate the markdown API reference under docs/api/.

The reference ships a sphinx autodoc tree (`/root/reference/docs/index.rst`,
`docs/classes.rst`, `docs/modules.rst`); this environment has no sphinx, so
this script produces the equivalent reference by introspection: one page per
public module (signatures + docstrings for every exported symbol, methods
for every exported class) plus an index. Deterministic output — re-run after
API changes and commit the result.

Run:  python tools/gen_api_docs.py
"""

from __future__ import annotations

import importlib
import inspect
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "docs", "api")

# (page, module path, blurb) — mirrors /root/reference/docs/modules.rst +
# classes.rst
PAGES = [
    ("classes", "dsptoolbox_jax.classes", "Core containers"),
    ("standard", "dsptoolbox_jax.standard", "Standard signal operations"),
    (
        "transfer_functions",
        "dsptoolbox_jax.transfer_functions",
        "System identification / transfer-function measurement",
    ),
    (
        "room_acoustics",
        "dsptoolbox_jax.room_acoustics",
        "Room acoustics: reverberation, modes, image-source RIRs",
    ),
    ("filterbanks", "dsptoolbox_jax.filterbanks", "Filter-bank factories"),
    ("transforms", "dsptoolbox_jax.transforms", "Signal transforms"),
    ("beamforming", "dsptoolbox_jax.beamforming", "Frequency/time-domain beamforming"),
    ("effects", "dsptoolbox_jax.effects", "Audio effects"),
    ("generators", "dsptoolbox_jax.generators", "Signal generators"),
    ("distances", "dsptoolbox_jax.distances", "Distance / similarity measures"),
    ("audio_io", "dsptoolbox_jax.audio_io", "Audio playback & recording"),
    ("tools", "dsptoolbox_jax.tools", "General helper tools"),
    ("plots", "dsptoolbox_jax.plots", "Plot builders"),
    ("io", "dsptoolbox_jax.io", "File I/O: WAV/RF64, native FLAC, safe serialization"),
    ("parallel", "dsptoolbox_jax.parallel", "Multi-chip sharding: meshes and parallel ops"),
    ("pipeline", "dsptoolbox_jax.pipeline", "Fused execution of public-call chains (one device program)"),
    ("realtime", "dsptoolbox_jax.realtime", "Block/sample streaming filters"),
    ("ops", "dsptoolbox_jax.ops", "Device kernels (XLA) under the public API"),
    ("enums", "dsptoolbox_jax.standard.enums", "Enum vocabulary"),
]


def _anchor(name: str) -> str:
    return name.lower().replace(".", "").replace("_", "-")


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent: int = 0) -> str:
    d = inspect.getdoc(obj)
    if not d:
        return ""
    pad = " " * indent
    return "\n".join(pad + line for line in d.splitlines())


def _is_public_method(name: str, member) -> bool:
    if name.startswith("_") and name != "__init__":
        return False
    return inspect.isfunction(member) or inspect.ismethod(member) or isinstance(
        member, (property, staticmethod, classmethod)
    )


def _class_section(name: str, cls) -> list[str]:
    lines = [f"### class `{name}`", ""]
    bases = ", ".join(
        b.__name__ for b in cls.__bases__ if b.__name__ != "object"
    )
    if bases:
        lines += [f"*Bases: {bases}*", ""]
    doc = _doc(cls)
    if doc:
        lines += [doc, ""]
    try:
        init = cls.__init__
        if init is not object.__init__:
            lines += [f"```python\n{name}{_sig(init)}\n```", ""]
            idoc = _doc(init)
            if idoc:
                lines += [idoc, ""]
    except Exception:
        pass
    members = []
    for mname, member in sorted(vars(cls).items()):
        if mname == "__init__" or not _is_public_method(mname, member):
            continue
        members.append((mname, member))
    if members:
        lines += ["**Methods / properties**", ""]
    for mname, member in members:
        if isinstance(member, property):
            lines += [f"- `{mname}` *(property)*"]
            d = inspect.getdoc(member)
        else:
            fn = member
            if isinstance(member, (staticmethod, classmethod)):
                fn = member.__func__
            lines += [f"- `{mname}{_sig(fn)}`"]
            d = inspect.getdoc(fn)
        if d:
            first = d.strip().splitlines()[0]
            lines[-1] += f" — {first}"
    lines.append("")
    return lines


def _function_section(name: str, fn) -> list[str]:
    lines = [f"### `{name}{_sig(fn)}`", ""]
    doc = _doc(fn)
    if doc:
        lines += [doc, ""]
    return lines


def _enum_section(name: str, cls) -> list[str]:
    lines = [f"### enum `{name}`", ""]
    doc = _doc(cls)
    if doc:
        lines += [doc, ""]
    lines += ["Members: " + ", ".join(f"`{m.name}`" for m in cls), ""]
    return lines


def render_module(page: str, modpath: str, blurb: str) -> str:
    import enum as enum_mod

    mod = importlib.import_module(modpath)
    exported = getattr(mod, "__all__", None)
    if exported is None:
        exported = [n for n in dir(mod) if not n.startswith("_")]
    lines = [f"# `{modpath}`", "", blurb + ".", ""]
    mdoc = _doc(mod)
    if mdoc:
        lines += [mdoc, ""]

    enums, classes, functions, others = [], [], [], []
    for name in exported:
        try:
            obj = getattr(mod, name)
        except AttributeError:
            continue
        if inspect.ismodule(obj):
            continue
        if inspect.isclass(obj) and issubclass(obj, enum_mod.Enum):
            enums.append((name, obj))
        elif inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            functions.append((name, obj))
        else:
            others.append((name, obj))

    if classes:
        lines += ["## Classes", ""]
        for name, obj in classes:
            lines += _class_section(name, obj)
    if functions:
        lines += ["## Functions", ""]
        for name, obj in functions:
            lines += _function_section(name, obj)
    if enums:
        lines += ["## Enums", ""]
        for name, obj in enums:
            lines += _enum_section(name, obj)
    if others:
        lines += ["## Data", ""]
        for name, obj in others:
            lines += [f"- `{name}` = `{obj!r}`"]
        lines.append("")
    return "\n".join(lines)


def main():
    if os.path.isdir(OUT):
        shutil.rmtree(OUT)
    os.makedirs(OUT)
    index = [
        "# dsptoolbox_jax — API reference",
        "",
        "Generated by `python tools/gen_api_docs.py` (introspection over the",
        "installed package; the JAX rebuild's analog of the reference's sphinx",
        "tree at `/root/reference/docs/`). One page per public module:",
        "",
    ]
    for page, modpath, blurb in PAGES:
        text = render_module(page, modpath, blurb)
        with open(os.path.join(OUT, f"{page}.md"), "w") as f:
            f.write(text + "\n")
        n_sym = text.count("\n### ")
        index.append(f"- [`{modpath}`]({page}.md) — {blurb} ({n_sym} symbols)")
        print(f"{page:22s} {n_sym:4d} symbols")
    index += [
        "",
        "Top-level re-exports (`import dsptoolbox_jax as dsp`): the",
        "`standard` functions and the core containers are available at the",
        "package root, mirroring the reference's `dsptoolbox/__init__.py`.",
        "",
    ]
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote", OUT)


if __name__ == "__main__":
    main()
