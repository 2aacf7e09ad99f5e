"""Lazy host returns for the default public API.

The reference returns plain numpy from every getter
(`dsptoolbox/classes/signal.py:861,948,1009`), which on an accelerator
forces a synchronizing device→host copy per call even when the caller
immediately feeds the result back into the library. :class:`LazyHostArray`
keeps the data on the device and materializes to numpy only when the
value is actually inspected host-side (arithmetic, indexing, coercion,
printing), so reference-identical call chains run at device speed and pay
the round trip only for values a user truly reads.

A wrapper behaves like the single numpy array the reference would have
returned: metadata (``shape``/``dtype``/``ndim``) is available without a
fetch, the first host access fetches once (complex data crosses the
boundary as one packed (real, imag) buffer), and every later access sees
the same host buffer, so in-place mutation works exactly as on the
reference's return value. Device-side consumers (``transforms.istft``, beamformers, the
Spectrum class) unwrap via :attr:`device_real`/:attr:`device_imag` and
never materialize.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LazyHostArray", "materialize_all"]


def _pack_fetch(re, im):
    """One packed fetch for a complex pair: stacking on device halves the
    round-trip count vs fetching real and imag separately."""
    from .._defer import force_value
    from .signal import _dev_jit

    import jax.numpy as jnp

    packed = np.asarray(
        _dev_jit("lazy_pack_ri", lambda r, i: jnp.stack((r, i)))(
            force_value(re), force_value(im)
        )
    )
    return packed[0] + 1j * packed[1]


class LazyHostArray:
    """Deferred device→host array; see module docstring."""

    # keep numpy from trying elementwise coercion tricks on the left
    # operand before our reflected dunders run
    __array_priority__ = 200

    def __init__(self, real, imag=None):
        self._re = real
        self._im = imag
        self._host = None

    # ----- metadata (no fetch) --------------------------------------
    @property
    def shape(self):
        if self._host is not None:
            return self._host.shape
        return tuple(self._re.shape)

    @property
    def ndim(self):
        return self._host.ndim if self._host is not None else self._re.ndim

    @property
    def size(self):
        return (
            self._host.size
            if self._host is not None
            else int(np.prod(self._re.shape, dtype=np.int64))
        )

    @property
    def dtype(self):
        if self._host is not None:
            return self._host.dtype
        dt = np.dtype(str(self._re.dtype))
        if self._im is not None:
            return np.result_type(dt, np.complex64)
        return dt

    def __len__(self):
        s = self.shape
        if not s:
            raise TypeError("len() of unsized object")
        return s[0]

    # ----- device-side access (library consumers; no fetch) ---------
    @property
    def device_real(self):
        return self._re

    @property
    def device_imag(self):
        return self._im

    @property
    def is_materialized(self) -> bool:
        return self._host is not None

    def __jax_array__(self):
        """jnp consumers stay on device (complex composed in-program)."""
        from .._defer import force_value

        if self._im is None:
            return force_value(self._re)
        from .signal import _dev_jit

        return _dev_jit(
            "compose_complex", lambda r, i: r + 1j * i
        )(force_value(self._re), force_value(self._im))

    # ----- materialization ------------------------------------------
    def numpy(self) -> np.ndarray:
        """The host value. First call fetches (one round trip, packed for
        complex); later calls return the SAME writable buffer, so the
        wrapper carries mutations exactly like the eager numpy return."""
        if self._host is None:
            if self._im is None:
                host = np.asarray(self._re)
            else:
                host = _pack_fetch(self._re, self._im)
            if not host.flags.writeable:
                host = host.copy()
            self._host = host
        return self._host

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        if dtype is not None and out.dtype != np.dtype(dtype):
            return out.astype(dtype)
        if copy:
            return out.copy()
        return out

    # ----- numpy interop --------------------------------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = tuple(
            i.numpy() if isinstance(i, LazyHostArray) else i
            for i in inputs
        )
        out = kwargs.get("out")
        if out is not None:
            kwargs["out"] = tuple(
                o.numpy() if isinstance(o, LazyHostArray) else o
                for o in out
            )
        return getattr(ufunc, method)(*inputs, **kwargs)

    def __getattr__(self, name):
        # anything not defined here (T, real, imag, sum, conj, astype,
        # ravel, flags, ...) comes from the materialized numpy array
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.numpy(), name)

    def __getitem__(self, key):
        return self.numpy()[key]

    def __setitem__(self, key, value):
        self.numpy()[key] = value

    def __iter__(self):
        return iter(self.numpy())

    def __contains__(self, item):
        return item in self.numpy()

    def __repr__(self):
        if self._host is None:
            return (
                f"LazyHostArray(shape={self.shape}, dtype={self.dtype}, "
                "device-resident)"
            )
        return repr(self._host)

    def __float__(self):
        return float(self.numpy())

    def __int__(self):
        return int(self.numpy())

    def __complex__(self):
        return complex(self.numpy())

    def __bool__(self):
        return bool(self.numpy())

    def __index__(self):
        return self.numpy().__index__()

    # ----- copy / pickle semantics ----------------------------------
    def copy(self):
        """Reference semantics: an independent array. Device arrays are
        immutable, so an unmaterialized copy just aliases them (free)."""
        if self._host is None:
            return LazyHostArray(self._re, self._im)
        other = LazyHostArray(self._re, self._im)
        other._host = self._host.copy()
        return other

    def __copy__(self):
        return self.copy()

    def __deepcopy__(self, memo):
        # never round-trip immutable device buffers through the host
        out = self.copy()
        memo[id(self)] = out
        return out

    def __reduce__(self):
        # pickles as the plain numpy array the reference would have
        # returned (device handles don't survive a process boundary)
        return (np.asarray, (self.numpy().copy(),))

    __hash__ = None


def _binop(name):
    np_name = f"__{name}__"

    def fwd(self, other):
        if isinstance(other, LazyHostArray):
            other = other.numpy()
        return getattr(self.numpy(), np_name)(other)

    fwd.__name__ = np_name
    return fwd


for _name in (
    "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
    "floordiv", "rfloordiv", "mod", "rmod", "pow", "rpow", "matmul",
    "rmatmul", "and", "rand", "or", "ror", "xor", "rxor", "lshift",
    "rlshift", "rshift", "rrshift", "divmod", "rdivmod",
    "lt", "le", "gt", "ge", "eq", "ne",
):
    setattr(LazyHostArray, f"__{_name}__", _binop(_name))

for _name in ("neg", "pos", "abs", "invert"):

    def _unop(self, _n=f"__{_name}__"):
        return getattr(self.numpy(), _n)()

    _unop.__name__ = f"__{_name}__"
    setattr(LazyHostArray, f"__{_name}__", _unop)


def materialize_all(*values):
    """Materialize several lazy arrays with as few round trips as
    possible (currently one packed fetch per complex value, one per real
    value; already-host values pass through). Returns numpy arrays in
    call order — the batch-friendly way to land a whole analysis result
    set on the host at once."""
    return tuple(
        v.numpy() if isinstance(v, LazyHostArray) else np.asarray(v)
        for v in values
    )
