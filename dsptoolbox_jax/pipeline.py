"""Fused execution of multi-call public-API chains.

Every public call in this library is its own device program with its
own launch cost, so a reference-style analysis chain (`get_spectrogram`
→ `istft` → `get_spectrum` → `get_csm`, cf.
`dsptoolbox/classes/signal.py:861,948,1009`) pays the launch floor five
times per iteration even when nothing touches the host.
:func:`pipeline` removes that floor: it traces a user function of
:class:`~dsptoolbox_jax.Signal` objects THROUGH the public class layer
into ONE jitted XLA program, which also lets the compiler fuse and
schedule the chain's FFTs/matmuls together instead of as isolated
programs.

Usage::

    import dsptoolbox_jax as dsp

    def chain(s):
        t, f, S = s.get_spectrogram(force_computation=True)
        y = dsp.transforms.istft(S, original_signal=s)
        f2, sp = s.get_spectrum(force_computation=True)
        two = dsp.append_signals([s, y])
        f3, C = two.get_csm(force_computation=True)
        return y, sp, C

    run = dsp.pipeline(chain)
    y, sp, C = run(sig)          # one device program, zero host fetches
    np.asarray(C)                # materializes only what you read

The traced function must stay on the library's device paths: anything
that forces a concrete value (printing a sample, `float(...)`,
data-dependent branching) fails at trace time with jax's concretization
error. Supported return structures: (nests of) ``Signal`` /
``ImpulseResponse``, :class:`LazyHostArray`,
:class:`DeviceSpectralData`, jax arrays, and host constants computed
from metadata (frequency/time vectors, scalars), which are captured at
trace time. Inside a trace, amplitude constraining of intermediate
signals happens in-program (no over-0-dBFS warning is emitted and the
host scale-factor metadata stays 1).

Compiled programs are cached per input signature: shape/dtype of every
input signal PLUS all host metadata that shapes the traced program —
``sampling_rate_hz``, signal class, amplitude-constraining flags,
spectrum/spectrogram parameter sets, and the analysis window (hashed by
value). Host constants captured at trace time (frequency vectors,
fs-dependent design math) are therefore always consistent with the
inputs of the call that uses them; a same-shape signal at a different
sampling rate triggers a fresh trace instead of silently reusing stale
constants (cf. `/root/reference/dsptoolbox/classes/signal.py:57-104`,
where fs is first-class constructor state).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["pipeline"]


def _freeze(v):
    """Hashable fingerprint of a metadata value (scalars, enums, nests,
    small arrays). Used only for cache keys, never for computation."""
    if isinstance(v, np.ndarray):
        return ("arr", v.shape, str(v.dtype), hash(v.tobytes()))
    if isinstance(v, jnp.ndarray):
        a = np.asarray(v)
        return ("arr", a.shape, str(a.dtype), hash(a.tobytes()))
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ("seq", tuple(_freeze(x) for x in v))
    return v


def _window_fingerprint(sig):
    """Value-hash of a signal's analysis window without repeated device
    fetches: host arrays hash directly; a device-resident window (e.g.
    from a fused ``window_ir``) is fetched ONCE and the hash is cached on
    the owning signal keyed by the buffer's identity (the signal keeps
    the buffer alive, so the id stays valid while cached)."""
    w = getattr(sig, "window", None)
    if w is None:
        return None
    if isinstance(w, np.ndarray):
        return ("w", w.shape, str(w.dtype), hash(w.tobytes()))
    cache = sig.__dict__.setdefault("_pipeline_window_fp", {})
    fp = cache.get(id(w))
    if fp is None:
        a = np.asarray(w)
        fp = ("w", a.shape, str(a.dtype), hash(a.tobytes()))
        cache.clear()  # one window at a time per signal
        cache[id(w)] = fp
    return fp


def _signal_signature(s):
    """Everything about a Signal that can change the traced program or
    the host constants captured during tracing."""
    return (
        type(s).__name__,
        tuple(s.time_data_jax.shape),
        str(s.time_data_jax.dtype),
        getattr(s, "_time_data_imag", None) is not None,
        s.sampling_rate_hz,
        s.constrain_amplitude,
        s.calibrated_signal,
        _freeze(getattr(s, "_spectrum_parameters", None)),
        _freeze(getattr(s, "_spectrogram_parameters", None)),
        _window_fingerprint(s),
    )


def _flatten_result(obj, leaves, path="out"):
    """Recursively split `obj` into device leaves + a rebuild spec."""
    from .classes.lazy_array import LazyHostArray
    from .classes.multibandsignal import MultiBandSignal
    from .classes.signal import DeviceSpectralData, Signal

    if isinstance(obj, MultiBandSignal):
        band_specs = [
            _flatten_result(b, leaves, f"{path}.bands[{i}]")
            for i, b in enumerate(obj.bands)
        ]
        # metadata snapshot only — never retain the traced container
        return ("mbs", obj.same_sampling_rate, dict(obj.info), band_specs)

    if isinstance(obj, Signal):
        idx_re = len(leaves)
        leaves.append(obj.time_data_jax)
        idx_im = None
        if getattr(obj, "_time_data_imag", None) is not None:
            idx_im = len(leaves)
            leaves.append(obj._time_data_imag)
        idx_win = None
        w = getattr(obj, "window", None)
        if isinstance(w, jax.core.Tracer):
            # device-built analysis window (fused window_ir): ship it as
            # a program output so the rebuilt IR keeps it
            idx_win = len(leaves)
            leaves.append(w)
        return ("signal", obj, idx_re, idx_im, idx_win)
    if isinstance(obj, LazyHostArray):
        idx_re = len(leaves)
        leaves.append(obj.device_real)
        idx_im = None
        if obj.device_imag is not None:
            idx_im = len(leaves)
            leaves.append(obj.device_imag)
        return ("lazy", idx_re, idx_im)
    if isinstance(obj, DeviceSpectralData):
        idx_re = len(leaves)
        leaves.append(obj.real)
        idx_im = len(leaves)
        leaves.append(obj.imag)
        return ("dsd", idx_re, idx_im)
    if isinstance(obj, jnp.ndarray) and not isinstance(obj, np.ndarray):
        if jnp.iscomplexobj(obj):
            idx_re = len(leaves)
            leaves.append(obj.real)
            idx_im = len(leaves)
            leaves.append(obj.imag)
            return ("complex", idx_re, idx_im)
        idx = len(leaves)
        leaves.append(obj)
        return ("jnp", idx)
    if isinstance(obj, tuple):
        return (
            "tuple",
            [
                _flatten_result(o, leaves, f"{path}[{i}]")
                for i, o in enumerate(obj)
            ],
        )
    if isinstance(obj, list):
        return (
            "list",
            [
                _flatten_result(o, leaves, f"{path}[{i}]")
                for i, o in enumerate(obj)
            ],
        )
    if isinstance(obj, dict):
        return (
            "dict",
            {
                k: _flatten_result(v, leaves, f"{path}[{k}]")
                for k, v in obj.items()
            },
        )
    if isinstance(obj, jax.core.Tracer):  # pragma: no cover - guard
        raise TypeError(
            f"pipeline result {path} is a raw tracer of unsupported type"
        )
    # host constant (freq vectors, scalars, enums, ...): captured at
    # trace time — it must derive from metadata, not traced data
    return ("const", obj)


def _rebuild_signal(template, td, td_imag):
    """New Signal/ImpulseResponse around concrete device data, carrying
    the template's metadata. The template's own (traced) buffers are
    never touched; amplitude re-constraining is skipped — the traced
    program already applied it in-program."""
    old = template.constrain_amplitude
    template.constrain_amplitude = False
    try:
        if td_imag is not None:
            from .classes.signal import DeviceTimeData

            out = template.copy_with_new_time_data(
                DeviceTimeData(td, td_imag, None)
            )
        else:
            out = template.copy_with_new_time_data(td)
    finally:
        template.constrain_amplitude = old
    out.constrain_amplitude = old
    # carry a concrete (host or device, but not traced) analysis window
    w = getattr(template, "window", None)
    if w is not None and not isinstance(w, jax.core.Tracer):
        try:
            out.set_window(w)
        except (AssertionError, AttributeError):
            pass
    return out


def _rebuild(spec, leaves):
    from .classes.lazy_array import LazyHostArray
    from .classes.signal import DeviceSpectralData, _dev_jit

    kind = spec[0]
    if kind == "mbs":
        from .classes.multibandsignal import MultiBandSignal

        _, same_sr, info, band_specs = spec
        return MultiBandSignal(
            [_rebuild(s, leaves) for s in band_specs],
            same_sampling_rate=same_sr,
            info=dict(info),
        )
    if kind == "signal":
        _, template, i_re, i_im, i_win = spec
        out = _rebuild_signal(
            template, leaves[i_re], None if i_im is None else leaves[i_im]
        )
        if i_win is not None:
            out.set_window(leaves[i_win])
        return out
    if kind == "lazy":
        _, i_re, i_im = spec
        return LazyHostArray(
            leaves[i_re], None if i_im is None else leaves[i_im]
        )
    if kind == "dsd":
        _, i_re, i_im = spec
        return DeviceSpectralData(leaves[i_re], leaves[i_im])
    if kind == "complex":
        _, i_re, i_im = spec
        return _dev_jit("compose_complex", lambda r, i: r + 1j * i)(
            leaves[i_re], leaves[i_im]
        )
    if kind == "jnp":
        return leaves[spec[1]]
    if kind == "tuple":
        return tuple(_rebuild(s, leaves) for s in spec[1])
    if kind == "list":
        return [_rebuild(s, leaves) for s in spec[1]]
    if kind == "dict":
        return {k: _rebuild(s, leaves) for k, s in spec[1].items()}
    return spec[1]  # const


def _sanitize_spec(spec):
    """Drop traced buffers from retained Signal templates after the first
    trace completed. Templates are kept only for their metadata
    (`_rebuild_signal` never reads their data), so holding dead tracers
    would be a pure leak — the round-4 cache retained every first-call
    signal's full device buffers for the runner's lifetime."""
    kind = spec[0]
    if kind == "mbs":
        for s in spec[3]:
            _sanitize_spec(s)
    elif kind == "signal":
        template = spec[1]
        placeholder = np.zeros((1, 1), np.float32)
        template.__dict__.pop("_host_mirror", None)
        template._host_mirror = None
        template._time_data = placeholder
        if getattr(template, "_time_data_imag", None) is not None:
            template._time_data_imag = placeholder
        if isinstance(
            template.__dict__.get("window"), jax.core.Tracer
        ):
            del template.window
    elif kind in ("tuple", "list"):
        for s in spec[1]:
            _sanitize_spec(s)
    elif kind == "dict":
        for s in spec[1].values():
            _sanitize_spec(s)


def pipeline(fn, mesh=None, partition=None):
    """Compile a chain of public-API calls into one device program.

    ``fn`` takes one or more :class:`Signal` (or subclass) positional
    arguments and may call any device-path public API on them. The
    returned runner has the same signature; see the module docstring for
    the contract. Retracing happens per distinct input signature.

    ``mesh``: optional :class:`jax.sharding.Mesh`. The fused chain is
    then compiled as ONE partitioned program over the mesh: input time
    data is placed with ``partition`` (a ``PartitionSpec`` over the
    ``(T, C)`` axes; default shards the channel axis over the mesh's
    first axis name) and XLA inserts the collectives the chain needs —
    fusion and multi-chip compose instead of being separate features.
    Uneven channel counts fall back to replicated inputs (XLA still
    partitions the internal ops)."""
    from .classes.signal import Signal

    cache: dict = {}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axis0 = mesh.axis_names[0]
        if partition is None:
            partition = PartitionSpec(None, axis0)
        mesh_key = (
            tuple(mesh.axis_names),
            tuple(mesh.devices.shape),
            tuple(d.id for d in mesh.devices.flat),
            tuple(partition),
        )

        def _axis_shards(name) -> int:
            if name is None:
                return 1
            if isinstance(name, (tuple, list)):
                return int(np.prod([mesh.shape[n] for n in name]))
            return int(mesh.shape[name])

        def _in_sharding(sig):
            spec = partition
            for ax, name in enumerate(tuple(partition)):
                if sig.time_data_jax.shape[ax] % _axis_shards(name):
                    # unshardable input: replicate (compute still
                    # partitions) rather than failing
                    spec = PartitionSpec()
                    break
            return NamedSharding(mesh, spec)
    else:
        mesh_key = None

    def runner(*signals):
        assert signals and all(
            isinstance(s, Signal) for s in signals
        ), "pipeline runners take Signal positional arguments"
        key = (mesh_key,) + tuple(_signal_signature(s) for s in signals)
        entry = cache.get(key)
        if entry is None:
            spec_box: dict = {}
            templates = signals

            def flat_fn(tds):
                shells = []
                for sig, (td, td_im) in zip(templates, tds):
                    data = td if td_im is None else (td + 1j * td_im)
                    # in-trace amplitude constraining is handled by the
                    # tracer branch of `_assign_device_time_data`
                    shells.append(sig.copy_with_new_time_data(data))
                leaves: list = []
                spec_box["spec"] = _flatten_result(
                    fn(*shells), leaves
                )
                return leaves

            if mesh is None:
                compiled = jax.jit(flat_fn)
            else:
                in_sh = tuple(
                    (
                        _in_sharding(s),
                        None
                        if getattr(s, "_time_data_imag", None) is None
                        else _in_sharding(s),
                    )
                    for s in signals
                )
                compiled = jax.jit(flat_fn, in_shardings=(in_sh,))
            entry = cache[key] = (compiled, spec_box)
        compiled, spec_box = entry
        tds = tuple(
            (s.time_data_jax, getattr(s, "_time_data_imag", None))
            for s in signals
        )
        leaves = compiled(tds)
        if not spec_box.get("sanitized"):
            _sanitize_spec(spec_box["spec"])
            spec_box["sanitized"] = True
        return _rebuild(spec_box["spec"], leaves)

    runner.__name__ = f"pipeline({getattr(fn, '__name__', 'fn')})"
    return runner
