"""Global numeric configuration for dsptoolbox_jax.

Accelerator-first defaults: float32 / complex64. The reference package
(dsptoolbox) runs everything in numpy float64; on an accelerator the native
fast path is fp32, so fp32 is the default here.
Enable float64 (CPU debugging / tight oracle comparisons) with
``jax.config.update("jax_enable_x64", True)`` *before* importing jax arrays and
``set_default_float("float64")``.
"""

from __future__ import annotations

import jax.numpy as jnp

_FLOAT = jnp.float32
_COMPLEX = jnp.complex64


def set_default_float(dtype) -> None:
    """Set the package-wide real dtype ("float32" or "float64")."""
    global _FLOAT, _COMPLEX
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float32:
        _FLOAT, _COMPLEX = jnp.float32, jnp.complex64
    elif dtype == jnp.float64:
        _FLOAT, _COMPLEX = jnp.float64, jnp.complex128
    else:
        raise ValueError(f"Unsupported default float dtype: {dtype}")


def default_float():
    """Package-wide real floating dtype."""
    return _FLOAT


def default_complex():
    """Package-wide complex floating dtype."""
    return _COMPLEX


_LAZY_HOST: bool | None = None  # None = auto (on in fp32, off in f64 mode)


def set_lazy_host_returns(enabled: bool | None) -> None:
    """Override lazy host returns for the default getter API.

    ``True``/``False`` force the behavior; ``None`` restores the default:
    lazy in float32 mode (device production path — getters return
    :class:`~dsptoolbox_jax.classes.lazy_array.LazyHostArray` views that
    fetch on first host access), eager plain-numpy in float64 mode (the
    bit-exact reference-compat mode used by the drop-in alias runner)."""
    global _LAZY_HOST
    _LAZY_HOST = enabled


def lazy_host_returns() -> bool:
    """Whether default getters return lazy device-backed host arrays."""
    if _LAZY_HOST is not None:
        return _LAZY_HOST
    return _FLOAT == jnp.float32


_DEFERRED: bool | None = None  # None = auto (follows lazy_host_returns)


def set_deferred_execution(enabled: bool | None) -> None:
    """Override deferred (auto-fused) dispatch of the default lazy API.

    ``True``/``False`` force it; ``None`` restores the default: deferred
    whenever lazy host returns are active. See
    :mod:`dsptoolbox_jax._defer` for semantics."""
    global _DEFERRED
    _DEFERRED = enabled


def deferred_execution() -> bool:
    """Whether hot producers record deferred programs instead of
    launching one device program per public call."""
    if _DEFERRED is not None:
        return _DEFERRED
    return lazy_host_returns()


_CLEAN_SC_DEVICE: bool = True


def set_clean_sc_on_device(enabled: bool) -> None:
    """Dispatch override for CLEAN-SC: ``True`` (default) runs the whole
    deconvolution — all frequency bins, initial map included — as one
    batched device program; ``False`` restores the host per-bin loop
    (the parity oracle)."""
    global _CLEAN_SC_DEVICE
    _CLEAN_SC_DEVICE = bool(enabled)


def clean_sc_on_device() -> bool:
    return _CLEAN_SC_DEVICE


# Zero-state filter-BANK formulation: "block" (default) or "freq". The
# blocked state-space path has a cost independent of the bands' decay,
# while frequency sampling needs an FFT length that grows with the slowest
# band's decay (narrow low bands blow it up). "freq" remains available for
# experimentation.
_BANK_PATH = "block"


def set_bank_path(mode: str) -> None:
    assert mode in ("block", "freq")
    global _BANK_PATH
    _BANK_PATH = mode


def bank_path() -> str:
    return _BANK_PATH


class _Unfreezable(Exception):
    """Raised when a closure value cannot be turned into a cache key."""


_CONTENT_HASH_CACHE: "dict" = {}


def _content_hash_cached(v) -> int:
    """Content hash of an IMMUTABLE (jax device) array, memoized by object
    identity — hashing would otherwise pay a device→host transfer on
    every call just to compute the cache key. Identity is validated by
    keeping a reference in the cache entry; the cache is bounded. Do not
    use for mutable numpy arrays."""
    import numpy as np

    key = id(v)
    entry = _CONTENT_HASH_CACHE.get(key)
    if entry is not None and entry[0] is v:
        return entry[1]
    h = hash(np.ascontiguousarray(np.asarray(v)).tobytes())
    if len(_CONTENT_HASH_CACHE) > 256:
        _CONTENT_HASH_CACHE.clear()
    _CONTENT_HASH_CACHE[key] = (v, h)
    return h


def _freeze_value(v):
    """Deterministic hashable token for a value captured in a closure.

    Library call sites pass locally-defined lambdas to
    :func:`run_jitted_complex`; a fresh function object per call would
    defeat jax.jit's cache (function identity is part of its key) and force
    a recompile on *every* call — seconds per op on an accelerator. Two
    lambdas with the same code object and equal captured values denote the
    same program, so their frozen closures may share one compiled program.
    """
    import enum

    import numpy as np

    import jax.numpy as jnp

    # enums first: IntEnum subclasses int and would alias as a bare scalar
    if isinstance(v, enum.Enum):
        return ("enum", type(v).__qualname__, v.name)
    if isinstance(v, (int, float, bool, str, bytes, complex, type(None))):
        # include the type: True/1/1.0 hash equal but trace to different
        # programs under dtype promotion
        return (type(v).__name__, v)
    if isinstance(v, np.ndarray):
        # numpy arrays are mutable — hash content on every call (cheap on
        # host); only immutable device arrays get the identity memo below
        b = np.ascontiguousarray(v).tobytes()
        return ("nd", v.shape, str(v.dtype), len(b), hash(b))
    if isinstance(v, jnp.ndarray):
        # hashing pulls the buffer host-side: memoize by identity so each
        # captured device array is fetched once
        return ("jd", v.shape, str(v.dtype), _content_hash_cached(v))
    if isinstance(v, (tuple, list)):
        return (type(v).__name__,) + tuple(_freeze_value(x) for x in v)
    if isinstance(v, dict):
        return tuple(
            sorted((str(k), _freeze_value(x)) for k, x in v.items())
        )
    if callable(v) and hasattr(v, "__code__"):
        return _freeze_function(v)
    # generic objects (closures capturing `self`): type + instance dict.
    # Mutating the object changes the key, forcing a correct retrace.
    d = getattr(v, "__dict__", None)
    if d is not None:
        return (
            "obj",
            type(v).__module__,
            type(v).__qualname__,
            _freeze_value(d),
        )
    raise _Unfreezable


def _freeze_function(fn):
    """Key a function by code object + frozen closure + frozen defaults."""
    import functools

    if isinstance(fn, functools.partial):
        return (
            "partial",
            _freeze_function(fn.func),
            tuple(_freeze_value(a) for a in fn.args),
            tuple(
                sorted(
                    (k, _freeze_value(v)) for k, v in fn.keywords.items()
                )
            ),
        )
    code = getattr(fn, "__code__", None)
    if code is None:
        raise _Unfreezable
    cells = getattr(fn, "__closure__", None) or ()
    try:
        frozen_cells = tuple(_freeze_value(c.cell_contents) for c in cells)
    except ValueError:  # empty cell
        raise _Unfreezable
    defaults = getattr(fn, "__defaults__", None) or ()
    # bound methods share code+closure across instances; the receiver is
    # part of the program
    bound_self = getattr(fn, "__self__", None)
    # the code object itself is the identity token (hashable; holding it in
    # the key also keeps it alive, so ids cannot be recycled)
    return (
        "fn",
        code,
        frozen_cells,
        tuple(_freeze_value(d) for d in defaults),
        _freeze_value(bound_self) if bound_self is not None else None,
    )


_RJC_CACHE: "dict" = {}
_RJC_CACHE_MAX = 512


def _rjc_cache_get(key):
    entry = _RJC_CACHE.pop(key, None)
    if entry is not None:
        _RJC_CACHE[key] = entry  # re-insert: LRU order
    return entry


def _rjc_cache_put(key, entry) -> None:
    _RJC_CACHE[key] = entry
    while len(_RJC_CACHE) > _RJC_CACHE_MAX:
        _RJC_CACHE.pop(next(iter(_RJC_CACHE)))


def run_maybe_jitted(fn, *args):
    """Dispatch policy for real-valued library kernels: jit-wrap on
    accelerators (one program instead of one dispatch per op) but run
    eagerly on CPU — XLA's whole-program fusion reassociates the fp32
    block-IIR recurrence and shifts near-unit-pole tails by ~1e-3, and the
    scipy-oracle tests pin the eager op-by-op rounding."""
    import jax

    if jax.default_backend() == "cpu":
        return fn(*args)
    return run_jitted_complex(fn, *args, materialize=False)


def run_jitted_complex(
    fn, *args, materialize: bool = True, key=None, defer: bool = False
):
    """Run ``fn(*args)`` as one jitted program.

    With ``materialize=True`` every result leaf is fetched to numpy;
    with ``materialize=False`` the leaves stay device arrays.

    Compiled programs are cached across calls even for locally-defined
    lambdas: the cache key is the code object plus frozen captured values
    (see :func:`_freeze_value`), so repeated library calls do not retrace.
    """
    import numpy as np

    import jax
    import jax.numpy as jnp

    from ._defer import DeferredArray, force_value

    # deferral is only sound for concrete-argument, cacheable programs:
    # inside an outer trace (dsp.pipeline) the args are tracers and the
    # call must inline as before
    defer = (
        defer
        and deferred_execution()
        and not any(isinstance(a, jax.core.Tracer) for a in args)
    )

    flat_args = []
    for a in args:
        if isinstance(a, DeferredArray):
            # pending program output: joins the deferred DAG when this
            # call defers, otherwise computes now (safe fallback)
            flat_args.append(a if defer else force_value(a))
        else:
            flat_args.append(
                a if isinstance(a, jnp.ndarray) else np.asarray(a)
            )

    shapes = tuple((tuple(a.shape), a.dtype) for a in flat_args)
    if key is not None:
        # caller-supplied program identity: skips the closure freezer
        # (walking/hashing captured values costs ~0.5 ms per call on hot
        # library paths). The caller must include every value the traced
        # program depends on; arg shapes/dtypes are appended here.
        key = ("explicit", key, shapes)
    else:
        try:
            key = (_freeze_function(fn), shapes)
        except (_Unfreezable, RecursionError):
            key = None

    entry = _rjc_cache_get(key) if key is not None else None
    if entry is None:
        meta: dict = {}

        def wrapper(*flat):
            leaves, treedef = jax.tree_util.tree_flatten(fn(*flat))
            meta["treedef"] = treedef
            return tuple(leaves)

        entry = {"jitted": jax.jit(wrapper), "meta": meta}
        if key is not None:
            _rjc_cache_put(key, entry)

    meta = entry["meta"]
    if defer and key is not None:
        from ._defer import make_node

        outs = make_node(entry["jitted"], ("rjc", key), flat_args)
        if "treedef" not in meta:
            # entry was rebuilt after cache eviction while the aval
            # cache still had the key: populate meta with one abstract
            # trace (no device execution)
            from ._defer import _abstract

            jax.eval_shape(
                entry["jitted"], *[_abstract(a) for a in flat_args]
            )
        return jax.tree_util.tree_unflatten(meta["treedef"], list(outs))
    res = entry["jitted"](*flat_args)
    if materialize:
        res = [np.asarray(v) for v in res]
    return jax.tree_util.tree_unflatten(meta["treedef"], list(res))
