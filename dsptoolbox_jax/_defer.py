"""Deferred device dispatch: auto-fusion of consecutive public calls.

Every public call in this library runs as its own device program with
its own launch cost, so a reference-style drop-in chain
(`get_spectrogram` → `transforms.istft` → `get_spectrum` →
`append_signals` → `get_csm`, cf.
`dsptoolbox/classes/signal.py:861,948,1009`) pays the launch floor five
times per iteration even though nothing touches the host.
:mod:`dsptoolbox_jax.pipeline` removes that floor for users who opt in;
this module removes it for the DEFAULT call text.

Mechanism: in lazy-returns mode (fp32 default), the hot producers do not
execute their program when called. They record a :class:`_Node` — the
program's cached jitted callable plus its (possibly themselves deferred)
arguments — and return :class:`DeferredArray` placeholders that know
their shape/dtype from an abstract evaluation (`jax.eval_shape`, cached
per program). Chained calls link nodes into a DAG. The first time a
concrete value is needed (host materialization, an eager consumer, or an
explicit :func:`compute_all`), the DAG is flushed: all pending programs
replay inside ONE composite jitted program (jit-of-jit inlines), cached
by the DAG's structural key, so a steady-state analysis loop launches
once per flush instead of once per call — and XLA fuses/schedules the
whole chain together.

Semantics vs eager lazy mode (both documented, both shared with
`dsp.pipeline`):
- errors inside a deferred program surface at flush time, not call time;
- amplitude constraining of deferred results runs in-program: the host
  `amplitude_scale_factor` metadata stays 1.0 and no over-0-dBFS warning
  is emitted (the arithmetic is identical).

Unaware consumers stay correct automatically: a ``DeferredArray`` forces
its flush on any concrete access (``__array__``, unknown attribute,
``__jax_array__``), `Signal.time_data_jax` forces, and
`run_jitted_complex` forces deferred arguments of non-deferring calls —
the fallback is always "compute now", never a wrong value.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "DeferredArray",
    "compute_all",
    "defer_call",
    "deferral_enabled",
    "force_value",
    "flush_values",
]

# Cap on the number of pending programs a single composite may replay:
# bounds compile time for pathological unforced chains. When a new node
# would exceed it, its argument DAG is flushed first.
_MAX_DAG_NODES = 48

# jitted callable per program key (defer_call sites; run_jitted_complex
# brings its own per-entry jitted wrapper)
_JIT_CACHE: dict = {}
# output avals per (program key, arg shapes): one abstract eval each
_AVAL_CACHE: dict = {}
# composite replay programs per DAG structure
_COMPOSITE_CACHE: dict = {}


def deferral_enabled() -> bool:
    from ._config import deferred_execution

    return deferred_execution()


class _Node:
    """One recorded program execution: ``outs = jitted(*args)``."""

    __slots__ = (
        "jitted", "prog_key", "key_id", "args", "n_out", "avals", "outs"
    )

    def __init__(self, jitted, prog_key, key_id, args, avals):
        self.jitted = jitted
        self.prog_key = prog_key
        # interned program identity (small int): composite-structure keys
        # hash these instead of the deep program-key tuples — key
        # construction and hashing were ~0.5 ms/flush otherwise
        self.key_id = key_id
        self.args = list(args)
        self.avals = avals
        self.n_out = len(avals)
        self.outs = None

    def dag_size(self) -> int:
        """Number of uncomputed nodes in this node's ancestor DAG
        (including itself)."""
        seen: set = set()

        def visit(n):
            if id(n) in seen or n.outs is not None:
                return
            seen.add(id(n))
            for a in n.args:
                if isinstance(a, DeferredArray):
                    visit(a.node)

        visit(self)
        return len(seen)


class DeferredArray:
    """Placeholder for one output of a pending device program.

    Metadata (shape/dtype/ndim) is available without executing anything;
    any concrete access flushes the owning DAG. Library code that wants
    to KEEP a value deferred must route through deferral-aware entry
    points (`defer_call`, `run_jitted_complex`); everything else simply
    forces and stays correct.
    """

    __slots__ = ("node", "idx")

    # keep numpy from coercing us elementwise on mixed expressions
    __array_priority__ = 150

    def __init__(self, node, idx):
        self.node = node
        self.idx = idx

    # ----- metadata (no execution) -----------------------------------
    @property
    def aval(self):
        return self.node.avals[self.idx]

    @property
    def shape(self):
        return tuple(self.node.avals[self.idx].shape)

    @property
    def dtype(self):
        return self.node.avals[self.idx].dtype

    @property
    def ndim(self):
        return len(self.node.avals[self.idx].shape)

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    def __len__(self):
        s = self.shape
        if not s:
            raise TypeError("len() of unsized object")
        return s[0]

    # ----- forcing ----------------------------------------------------
    def force(self):
        """Concrete jax array (flushes the pending DAG on first use)."""
        if self.node.outs is None:
            _flush([self.node])
        return self.node.outs[self.idx]

    @property
    def is_computed(self) -> bool:
        return self.node.outs is not None

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.force())
        if dtype is not None and out.dtype != np.dtype(dtype):
            out = out.astype(dtype)
        elif copy:
            out = out.copy()
        return out

    def __jax_array__(self):
        return self.force()

    def __getattr__(self, name):
        # unknown attribute: behave like the concrete array (forces)
        if name in ("node", "idx"):
            raise AttributeError(name)
        return getattr(self.force(), name)

    def __repr__(self):
        state = "computed" if self.is_computed else "pending"
        return (
            f"DeferredArray(shape={self.shape}, dtype={self.dtype}, "
            f"{state})"
        )

    # ----- structural ops that stay deferred --------------------------
    @property
    def T(self):
        return defer_call(("defer_T", self.ndim), lambda a: a.T, self)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return defer_call(
            ("defer_reshape", shape), lambda a: a.reshape(shape), self
        )

    def astype(self, dtype):
        key = ("defer_astype", np.dtype(dtype).name)
        return defer_call(key, lambda a: a.astype(dtype), self)

    def __getitem__(self, key):
        try:
            prog_key = ("defer_getitem", _freeze_index(key))
        except TypeError:
            return self.force()[key]
        return defer_call(prog_key, lambda a: a[key], self)

    def __float__(self):
        return float(np.asarray(self.force()))

    def __int__(self):
        return int(np.asarray(self.force()))

    def __bool__(self):
        return bool(np.asarray(self.force()))


def _freeze_index(key) -> tuple:
    """Hashable token for a static index expression."""
    if isinstance(key, tuple):
        return tuple(_freeze_index(k) for k in key)
    if isinstance(key, slice):
        return ("slice", key.start, key.stop, key.step)
    if key is None or key is Ellipsis or isinstance(key, (int, bool)):
        return ("idx", key)
    raise TypeError(f"dynamic index {key!r}")


def force_value(x):
    """Concrete value for a possibly-deferred array (passthrough
    otherwise)."""
    return x.force() if isinstance(x, DeferredArray) else x


def _abstract(a):
    import jax

    if isinstance(a, DeferredArray):
        return jax.ShapeDtypeStruct(a.shape, a.dtype)
    if not hasattr(a, "shape") or not hasattr(a, "dtype"):
        a = np.asarray(a)
    return jax.ShapeDtypeStruct(tuple(a.shape), a.dtype)


def _arg_sig(args) -> tuple:
    sigs = []
    for a in args:
        if not hasattr(a, "shape") or not hasattr(a, "dtype"):
            a = np.asarray(a)
        sigs.append((tuple(a.shape), a.dtype))
    return tuple(sigs)


def make_node(jitted, prog_key, args) -> list[DeferredArray]:
    """Record one pending program. ``args`` are array leaves (concrete
    device/host arrays or DeferredArrays); host constants must already be
    baked into ``prog_key``/the closure. Returns one DeferredArray per
    output leaf (flat order)."""
    import jax

    aval_key = (prog_key, _arg_sig(args))
    cached = _AVAL_CACHE.get(aval_key)
    if cached is None:
        out = jax.eval_shape(jitted, *[_abstract(a) for a in args])
        leaves = jax.tree_util.tree_leaves(out)
        cached = _AVAL_CACHE[aval_key] = (
            tuple(jax.ShapeDtypeStruct(l.shape, l.dtype) for l in leaves),
            isinstance(out, tuple),
            len(_AVAL_CACHE),  # interned program identity
        )
    avals, _, key_id = cached
    node = _Node(jitted, aval_key, key_id, args, avals)
    if node.dag_size() > _MAX_DAG_NODES:
        # bound composite compile size: compute the argument DAG now,
        # then this node starts from concrete inputs
        _flush([a.node for a in args if isinstance(a, DeferredArray)])
    return [DeferredArray(node, i) for i in range(node.n_out)]


def defer_call(prog_key, fn, *args):
    """Deferred analogue of ``_dev_jit(key, fn)(*args)`` for real-leaf
    programs: records a node in deferral mode, executes eagerly (forcing
    deferred args) otherwise. ``fn`` must return an array or a flat
    tuple of arrays, and must close over every non-array value it
    depends on (all of which must be captured in ``prog_key``)."""
    import jax

    jitted = _JIT_CACHE.get(prog_key)
    if jitted is None:
        jitted = _JIT_CACHE[prog_key] = jax.jit(fn)
    if not deferral_enabled() or any(
        isinstance(a, jax.core.Tracer) for a in args
    ):
        # eager (or inside an outer trace, e.g. dsp.pipeline, where the
        # call must inline): compute now, forcing any pending args
        return jitted(*[force_value(a) for a in args])
    outs = make_node(jitted, ("call", prog_key), args)
    is_tuple = _AVAL_CACHE[outs[0].node.prog_key][1]
    if not is_tuple:
        return outs[0]
    return tuple(outs)


def _flush(roots) -> None:
    """Execute every uncomputed node reachable from ``roots`` as ONE
    composite jitted program (cached by DAG structure)."""
    import jax

    order: list[_Node] = []
    seen: set = set()

    def visit(n):
        if id(n) in seen or n.outs is not None:
            return
        seen.add(id(n))
        for a in n.args:
            if isinstance(a, DeferredArray):
                visit(a.node)
        order.append(n)

    for r in roots:
        visit(r)
    if not order:
        return

    pos = {id(n): i for i, n in enumerate(order)}
    inputs: list = []
    key_parts = []
    plans = []
    for n in order:
        descs = []
        for a in n.args:
            if isinstance(a, DeferredArray):
                if a.node.outs is not None:
                    descs.append(("in", len(inputs)))
                    inputs.append(a.node.outs[a.idx])
                else:
                    descs.append(("ref", pos[id(a.node)], a.idx))
            else:
                descs.append(("in", len(inputs)))
                inputs.append(a)
        key_parts.append((n.key_id, tuple(descs)))
        plans.append((n.jitted, tuple(descs)))
    key = tuple(key_parts)

    compiled = _COMPOSITE_CACHE.get(key)
    if compiled is None:

        def composite(flat_inputs):
            results = []
            for jitted, descs in plans:
                call_args = [
                    flat_inputs[d[1]] if d[0] == "in"
                    else results[d[1]][d[2]]
                    for d in descs
                ]
                out = jitted(*call_args)
                if not isinstance(out, tuple):
                    out = (out,)
                results.append(out)
            return results

        compiled = _COMPOSITE_CACHE[key] = jax.jit(composite)

    results = compiled(inputs)
    for n, outs in zip(order, results):
        n.outs = tuple(outs)
        n.args = ()  # release input buffers


def flush_values(*values) -> None:
    """Force device computation (ONE composite launch) of every deferred
    value in ``values`` without any host transfer."""
    roots = [v.node for v in values if isinstance(v, DeferredArray)]
    if roots:
        _flush(roots)


def compute_all(*values):
    """Public helper: ensure every value is device-computed (flushing all
    pending work reachable from them in one composite program) WITHOUT
    materializing anything to the host. Accepts Signals, LazyHostArrays,
    DeviceSpectralData, arrays, and nests thereof; returns its inputs.

    Useful when timing the default lazy API or handing results to
    non-library device code: after ``compute_all(*results)`` every value
    is a concrete device buffer."""
    roots: list = []

    def collect(v):
        if isinstance(v, DeferredArray):
            if v.node.outs is None:
                roots.append(v.node)
            return
        if isinstance(v, (tuple, list)):
            for x in v:
                collect(x)
            return
        if isinstance(v, dict):
            for x in v.values():
                collect(x)
            return
        # library containers
        lazy_re = getattr(v, "device_real", None)
        if lazy_re is not None:
            collect(lazy_re)
            collect(getattr(v, "device_imag", None))
            return
        td = getattr(v, "_time_data", None)
        if td is not None:
            collect(td)
            collect(getattr(v, "_time_data_imag", None))
            bands = getattr(v, "bands", None)
            if bands is not None:
                collect(bands)

    for v in values:
        collect(v)
    if roots:
        _flush(roots)
    # replace forced deferred buffers on Signals so later property reads
    # are free
    return values if len(values) != 1 else values[0]
