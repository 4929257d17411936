"""``mx.symbol``: declarative graphs, from ``tpu_mx/symbol/symbol.py``.

A :class:`Symbol` is a small Python DAG of nodes, each an application of
one of the port's operators (the ``nd.*`` functions, which take and
return tensors) or a variable.  :meth:`Symbol.bind` and
:meth:`Symbol.simple_bind` return an :class:`Executor`, which evaluates
the DAG in topological order over the operators on its context's
device: in training (``forward(is_train=True)``) under PyTorch's
autograd, whose graph :meth:`Executor.backward` then walks, and in
prediction under ``torch.no_grad()``.  Each call is eager: no
``torch.compile``, no CUDA graph.  ``infer_shape`` propagates shapes
through the operators themselves on fake tensors
(``torch._subclasses.fake_tensor``: no memory, no arithmetic), with the
reference's rules for the parameters an operator creates
(``FullyConnected(data, num_hidden=k, name="fc")`` makes ``fc_weight``
and ``fc_bias``).

The JSON of :meth:`Symbol.tojson` is the reference's, key for key
(``__sym_attrs__``, ``__input_names__``, ``__aux_inputs__``,
``__num_outputs__``, ``__variadic__``): a symbol saved by either package
loads in the other.

As in the reference, an executor updates no moving statistic: a
``BatchNorm`` node normalizes a training forward by the batch's
statistics and a prediction by ``aux_dict``'s, and leaves ``aux_dict``
as it was.
"""
from __future__ import annotations

import ast
import contextlib
import inspect
import json
import threading

import numpy as np
import torch

from .. import autograd
from .. import device as _device
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..ndarray import NDArray, array
from ..ndarray import ops as _ops

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "Executor", "register_sym_op"]

# -- the operator table: name -> (function on tensors, signature) ------------
_SYM_OPS = {}


def register_sym_op(name, fn):
    """Register a callable as a symbolic operator."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        sig = None
    _SYM_OPS[name] = (fn, sig)
    return fn


def _lookup(name):
    if name not in _SYM_OPS:
        raise MXNetError(f"unknown symbolic op '{name}'")
    return _SYM_OPS[name]


_NAME_LOCK = threading.Lock()
_NAME_COUNT = {}


def _auto_name(hint):
    return _resolve_name(None, hint)


def _resolve_name(name, hint):
    """A node's name through the active ``mx.name`` manager, which sees
    explicit names too (a ``Prefix`` prefixes both), else ``name`` or the
    next ``hint<i>``."""
    hint = hint.lower()
    from ..name import _current as _current_name_manager
    mgr = _current_name_manager()
    if mgr is not None:
        return mgr.get(name or None, hint)
    if name:  # an empty name falls through to the counter
        return name
    with _NAME_LOCK:
        i = _NAME_COUNT.get(hint, 0)
        _NAME_COUNT[hint] = i + 1
    return f"{hint}{i}"


# -- the parameters an operator creates: op -> [(kwarg, suffix, is_aux,
# shape_rule(data_shape, kwargs))] --------------------------------------------
def _fc_weight(ds, kw):
    in_dim = int(np.prod(ds[1:])) if kw.get("flatten", True) and \
        len(ds) > 2 else ds[-1]
    return (int(kw["num_hidden"]), in_dim)


def _conv_weight(ds, kw):
    return (int(kw["num_filter"]), ds[1] // int(kw.get("num_group", 1) or 1),
            *tuple(kw["kernel"]))


def _deconv_weight(ds, kw):
    return (ds[1], int(kw["num_filter"]) // int(kw.get("num_group", 1) or 1),
            *tuple(kw["kernel"]))


def _chan(axis_default=1):
    def rule(ds, kw):
        return (ds[int(kw.get("axis", axis_default))],)
    return rule


_AUTO_PARAMS = {
    "FullyConnected": [
        ("weight", "weight", False, _fc_weight),
        ("bias", "bias", False, lambda ds, kw: (int(kw["num_hidden"]),))],
    "Convolution": [
        ("weight", "weight", False, _conv_weight),
        ("bias", "bias", False, lambda ds, kw: (int(kw["num_filter"]),))],
    "Deconvolution": [
        ("weight", "weight", False, _deconv_weight),
        ("bias", "bias", False, lambda ds, kw: (int(kw["num_filter"]),))],
    "BatchNorm": [("gamma", "gamma", False, _chan()),
                  ("beta", "beta", False, _chan()),
                  ("moving_mean", "moving_mean", True, _chan()),
                  ("moving_var", "moving_var", True, _chan())],
    "LayerNorm": [("gamma", "gamma", False, _chan(-1)),
                  ("beta", "beta", False, _chan(-1))],
    "InstanceNorm": [("gamma", "gamma", False, _chan()),
                     ("beta", "beta", False, _chan())],
    "Embedding": [("weight", "weight", False,
                   lambda ds, kw: (int(kw["input_dim"]),
                                   int(kw["output_dim"])))],
}
# the deprecated 0.x names create their targets' parameters (old symbol
# JSON uses them)
_AUTO_PARAMS["Convolution_v1"] = _AUTO_PARAMS["Convolution"]
_AUTO_PARAMS["BatchNorm_v1"] = _AUTO_PARAMS["BatchNorm"]

# the operators that create no bias with no_bias=True
_NO_BIAS_OPS = {"FullyConnected", "Convolution", "Convolution_v1",
                "Deconvolution"}

# the operators whose number of outputs depends on their arguments
_NUM_OUTPUTS = {
    "split": lambda kw: int(kw.get("num_outputs", 1)),
    "SliceChannel": lambda kw: int(kw.get("num_outputs", 1)),
    "topk": lambda kw: 2 if kw.get("ret_typ") == "both" else 1,
    "MultiBoxTarget": lambda kw: 3,
}


class _Node:
    """One node: an operator's application, or a variable (``op`` None)."""

    __slots__ = ("op", "name", "inputs", "input_names", "variadic", "kwargs",
                 "num_outputs", "attrs", "aux_input_names")

    def __init__(self, op, name, inputs=(), input_names=(), variadic=False,
                 kwargs=None, num_outputs=1, attrs=None, aux_input_names=()):
        self.op = op
        self.name = name
        self.inputs = list(inputs)              # [(node, output index)]
        self.input_names = list(input_names)    # [] when variadic
        self.variadic = variadic
        self.kwargs = dict(kwargs or {})
        self.num_outputs = num_outputs
        self.attrs = dict(attrs or {})
        self.aux_input_names = tuple(aux_input_names)

    def is_variable(self):
        return self.op is None


def _topo(entries):
    """The nodes feeding ``entries`` [(node, index)], inputs first."""
    order, seen = [], set()
    stack = [(n, False) for n, _ in reversed(entries)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        for child, _ in reversed(node.inputs):
            if id(child) not in seen:
                stack.append((child, False))
    return order


@contextlib.contextmanager
def _tensor_scope():
    """Operators called here return tensors, creation operators too, as
    inside a ``HybridBlock``'s forward."""
    autograd._STATE.functional += 1
    try:
        yield
    finally:
        autograd._STATE.functional -= 1


def _call(node, vals):
    fn, _ = _lookup(node.op)
    if node.variadic:
        out = fn(*vals, **node.kwargs)
    else:
        out = fn(**dict(zip(node.input_names, vals)), **node.kwargs)
    return list(out) if isinstance(out, (list, tuple)) else [out]


class Symbol:
    """A handle to one or more output entries of a graph."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)   # [(node, output index)]

    @property
    def name(self):
        node, _ = self._entries[0]
        return node.name if len(self._entries) == 1 else "group"

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __iter__(self):
        return (Symbol([e]) for e in self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            for n in _topo(self._entries):
                if n.name == idx:
                    return Symbol([(n, 0)])
            raise MXNetError(f"no node named {idx!r}")
        return Symbol([self._entries[idx]])

    def get_output(self, idx):
        return self[idx]

    def get_internals(self):
        """Every output of every node, as a group."""
        return Symbol([(n, i) for n in _topo(self._entries)
                       for i in range(n.num_outputs)])

    # -- attributes ---------------------------------------------------------
    def attr(self, key):
        return self._entries[0][0].attrs.get(key)

    def _set_attr(self, **kwargs):
        self._entries[0][0].attrs.update(
            {k: str(v) for k, v in kwargs.items()})
        return self

    def list_attr(self):
        return dict(self._entries[0][0].attrs)

    def attr_dict(self):
        return {n.name: dict(n.attrs) for n in _topo(self._entries)
                if n.attrs}

    # -- listing --------------------------------------------------------------
    def _input_nodes(self):
        """``(argument nodes, auxiliary-state nodes)`` in topological
        order."""
        args, auxs = [], []
        for n in _topo(self._entries):
            if not n.is_variable():
                for (child, _), pname in zip(
                        n.inputs, n.input_names or [None] * len(n.inputs)):
                    if child.is_variable() and pname in n.aux_input_names \
                            and child not in auxs:
                        auxs.append(child)
        aux_ids = {id(a) for a in auxs}
        for n in _topo(self._entries):
            if n.is_variable() and id(n) not in aux_ids and n not in args:
                args.append(n)
        return args, auxs

    def list_arguments(self):
        return [n.name for n in self._input_nodes()[0]]

    def list_auxiliary_states(self):
        return [n.name for n in self._input_nodes()[1]]

    def list_inputs(self):
        a, x = self._input_nodes()
        return [n.name for n in a + x]

    def list_outputs(self):
        outs = []
        for node, idx in self._entries:
            if node.num_outputs > 1:
                outs.append(f"{node.name}_output{idx}")
            else:
                outs.append(node.name
                            + ("" if node.is_variable() else "_output"))
        return outs

    # -- evaluation -----------------------------------------------------------
    def _eval(self, feeds, is_train=False):
        """The entries' tensors, given ``{variable name: tensor}``."""
        memo = {}
        mode = autograd.train_mode() if is_train \
            else autograd.predict_mode()
        with mode, _tensor_scope():
            for node in _topo(self._entries):
                if node.is_variable():
                    if node.name not in feeds:
                        raise MXNetError(f"unbound variable '{node.name}'")
                    memo[id(node)] = [feeds[node.name]]
                    continue
                memo[id(node)] = _call(node, [memo[id(c)][i]
                                              for c, i in node.inputs])
        return [memo[id(n)][i] for n, i in self._entries]

    # -- shape and type inference ---------------------------------------------
    def infer_shape(self, **kwargs):
        try:
            return self._infer_shape_impl(False, **kwargs)
        except MXNetError:
            raise
        except Exception as e:  # noqa: BLE001 — the reference's error type
            raise MXNetError(f"infer_shape failed: {e}") from e

    def infer_shape_partial(self, **kwargs):
        try:
            return self._infer_shape_impl(True, **kwargs)
        except Exception:  # noqa: BLE001 — the reference's answer
            return (None, None, None)

    def _infer_shape_impl(self, partial, **kwargs):
        from torch._subclasses.fake_tensor import FakeTensorMode
        known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
        for n in _topo(self._entries):
            if n.is_variable() and "__shape__" in n.attrs \
                    and n.name not in known:
                known[n.name] = tuple(ast.literal_eval(n.attrs["__shape__"]))
        shapes = {}      # id(node) -> [shape of each output]
        for node in _topo(self._entries):
            if node.is_variable():
                shapes[id(node)] = [known.get(node.name)]
                continue
            in_shapes, data_shape = [], None
            for c, i in node.inputs:
                s = shapes[id(c)][i]
                if data_shape is None and s is not None:
                    data_shape = s
                in_shapes.append(s)
            if node.op in _AUTO_PARAMS and data_shape is not None:
                rules = {kwarg: rule for kwarg, _s, _a, rule
                         in _AUTO_PARAMS[node.op]}
                for j, ((c, i), pname) in enumerate(
                        zip(node.inputs, node.input_names)):
                    if in_shapes[j] is None and c.is_variable() \
                            and pname in rules:
                        try:
                            s = tuple(int(d) for d in rules[pname](
                                data_shape, node.kwargs))
                        except Exception:  # noqa: BLE001 — left unknown
                            continue
                        shapes[id(c)] = [s]
                        known[c.name] = s
                        in_shapes[j] = s
            if any(s is None for s in in_shapes):
                if partial:
                    shapes[id(node)] = [None] * node.num_outputs
                    continue
                missing = [c.name for (c, i), s in zip(node.inputs, in_shapes)
                           if s is None]
                raise MXNetError(
                    f"infer_shape: missing shapes for inputs {missing} of "
                    f"node '{node.name}'")
            # through the operator itself, on fake float32 tensors
            with cpu(), FakeTensorMode(), torch.no_grad(), \
                    autograd.predict_mode(), _tensor_scope():
                outs = _call(node, [torch.empty(s, dtype=torch.float32)
                                    for s in in_shapes])
            shapes[id(node)] = [tuple(o.shape) for o in outs]
        arg_nodes, aux_nodes = self._input_nodes()
        arg_shapes = [shapes[id(n)][0] for n in arg_nodes]
        aux_shapes = [shapes[id(n)][0] for n in aux_nodes]
        out_shapes = [shapes[id(n)][i] for n, i in self._entries]
        if not partial and any(s is None for s in arg_shapes + aux_shapes):
            missing = [n.name for n in arg_nodes + aux_nodes
                       if shapes[id(n)][0] is None]
            raise MXNetError(f"infer_shape: could not infer {missing}")
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, **kwargs):
        """float32 throughout (the framework's default), as the
        reference's."""
        f32 = np.float32
        return ([kwargs.get(a, f32) for a in self.list_arguments()],
                [f32] * len(self._entries),
                [f32] * len(self.list_auxiliary_states()))

    # -- eager evaluation -----------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """The outputs for the given inputs (arrays), on ``ctx`` (default:
        the current context)."""
        ctx = ctx if ctx is not None else current_context()
        feeds = {k: array(v, ctx=ctx)._data for k, v in kwargs.items()}
        with ctx, torch.no_grad():
            return [NDArray(r) for r in self._eval(feeds)]

    # -- binding --------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """An executor with zero float32 arrays of the inferred shapes."""
        ctx = ctx if ctx is not None else current_context()
        dev = _device.resolve(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        zeros = lambda s: NDArray(torch.zeros(s, dtype=torch.float32,
                                              device=dev))
        args = {n: zeros(s) for n, s in zip(self.list_arguments(),
                                            arg_shapes)}
        auxs = {n: zeros(s) for n, s in zip(self.list_auxiliary_states(),
                                            aux_shapes)}
        return Executor(self, ctx, args, auxs, grad_req)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        ex = Executor(self, ctx, dict(args or {}), dict(aux_states or {}),
                      grad_req)
        if args_grad:
            if isinstance(args_grad, (list, tuple)):
                args_grad = dict(zip(arg_names, args_grad))
            ex.grad_dict.update(args_grad)
        return ex

    # -- serialization --------------------------------------------------------
    def tojson(self):
        order = _topo(self._entries)
        idx = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            attrs = {k: json.dumps(v) for k, v in n.kwargs.items()}
            if n.attrs:
                attrs["__sym_attrs__"] = json.dumps(n.attrs)
            if n.variadic:
                attrs["__variadic__"] = "1"
            if n.input_names:
                attrs["__input_names__"] = json.dumps(n.input_names)
            if n.aux_input_names:
                attrs["__aux_inputs__"] = json.dumps(list(n.aux_input_names))
            if n.num_outputs != 1:
                attrs["__num_outputs__"] = str(n.num_outputs)
            nodes.append({"op": "null" if n.is_variable() else n.op,
                          "name": n.name, "attrs": attrs,
                          "inputs": [[idx[id(c)], i, 0]
                                     for c, i in n.inputs]})
        heads = [[idx[id(n)], i, 0] for n, i in self._entries]
        arg_nodes = [i for i, n in enumerate(order) if n.is_variable()]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"tpu_mx_version": "0.1"}}, indent=2)

    def save(self, fname):
        from ..checkpoint import atomic_write
        with atomic_write(fname, "w") as f:
            f.write(self.tojson())

    # -- operators ------------------------------------------------------------
    def __add__(self, other):
        return _binary_dispatch("broadcast_add", "_plus_scalar", self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return _binary_dispatch("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _scalar_op("_rminus_scalar", self, other)

    def __mul__(self, other):
        return _binary_dispatch("broadcast_mul", "_mul_scalar", self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary_dispatch("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _scalar_op("_rdiv_scalar", self, other)

    def __pow__(self, other):
        return _binary_dispatch("broadcast_power", "_power_scalar", self,
                                other)

    def __neg__(self):
        return _scalar_op("_mul_scalar", self, -1.0)

    def __eq__(self, other):  # a comparison node, as the reference's
        if isinstance(other, (Symbol, int, float)):
            return _binary_dispatch("broadcast_equal", "_equal_scalar",
                                    self, other)
        return NotImplemented

    def __hash__(self):
        return id(self)


# -- construction -------------------------------------------------------------
def Variable(name, shape=None, attr=None, dtype=None, init=None, **kwargs):
    """A variable; the active ``AttrScope``'s attributes apply, ``attr``
    over them."""
    from ..attribute import current_attrs
    attrs = dict(current_attrs())
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(np.dtype(dtype))
    for k, v in kwargs.items():
        attrs[f"__{k}__"] = str(v)
    return Symbol([(_Node(None, name, attrs=attrs), 0)])


var = Variable


def Group(symbols):
    return Symbol([e for s in symbols for e in s._entries])


def _entry(x):
    if isinstance(x, Symbol):
        if len(x._entries) != 1:
            raise MXNetError("cannot use a grouped symbol as an op input")
        return x._entries[0]
    raise TypeError


def _make_node(opname, name, sym_inputs, input_names, const_kwargs,
               variadic=False, aux_names=()):
    _lookup(opname)
    n_out = _NUM_OUTPUTS.get(opname, lambda kw: 1)(const_kwargs)
    from ..attribute import current_attrs
    node = _Node(opname, name, inputs=[_entry(s) for s in sym_inputs],
                 input_names=list(input_names), variadic=variadic,
                 kwargs=const_kwargs, num_outputs=n_out,
                 attrs=current_attrs() or None, aux_input_names=aux_names)
    return Symbol([(node, i) for i in range(n_out)])


def _scalar_op(opname, sym, scalar):
    return _make_node(opname, _auto_name(opname.strip("_")), [sym], ["data"],
                      {"scalar": float(scalar)})


def _binary_dispatch(broadcast_op, scalar_op, lhs, rhs):
    if isinstance(rhs, Symbol):
        return _make_node(broadcast_op, _auto_name(broadcast_op), [lhs, rhs],
                          ["lhs", "rhs"], {})
    return _scalar_op(scalar_op, lhs, rhs)


def _symbolic_stub(opname, fn, sig):
    """The ``mx.sym.<op>`` function of operator ``fn``."""
    params = list(sig.parameters.values()) if sig else []
    variadic = any(p.kind is p.VAR_POSITIONAL for p in params)
    positional_names = [p.name for p in params if p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    auto = _AUTO_PARAMS.get(opname, [])
    aux_names = tuple(kwarg for kwarg, _s, is_aux, _r in auto if is_aux)

    def stub(*args, **kwargs):
        name = _resolve_name(kwargs.pop("name", None), opname)
        attr = kwargs.pop("attr", None)
        if variadic:
            sym_inputs = [a for a in args if isinstance(a, Symbol)]
            data_kw = kwargs.pop("data", None)
            if data_kw is not None:
                sym_inputs = (list(data_kw) if isinstance(
                    data_kw, (list, tuple)) else [data_kw]) + sym_inputs
            out = _make_node(opname, name, sym_inputs, [], dict(kwargs),
                             variadic=True)
        else:
            merged = dict(zip(positional_names, args))
            overlap = set(merged) & set(kwargs)
            if overlap:
                raise MXNetError(f"{opname}: duplicate arguments {overlap}")
            merged.update(kwargs)
            # the parameters the operator creates, where not given
            no_bias = merged.get("no_bias", False)
            for kwarg, suffix, _is_aux, _rule in auto:
                if merged.get(kwarg) is None:
                    if kwarg == "bias" and no_bias and opname in _NO_BIAS_OPS:
                        continue
                    merged[kwarg] = Variable(f"{name}_{suffix}")
            sym_inputs, input_names, const_kwargs = [], [], {}
            for k, v in merged.items():
                if isinstance(v, Symbol):
                    sym_inputs.append(v)
                    input_names.append(k)
                elif v is not None:
                    const_kwargs[k] = v
            out = _make_node(opname, name, sym_inputs, input_names,
                             const_kwargs, aux_names=aux_names)
        if attr:
            out._set_attr(**attr)
        return out

    stub.__name__ = opname
    stub.__doc__ = (fn.__doc__ or "") + "\n(symbolic variant)"
    return stub


# -- the scalar operators of the arithmetic (the reference's names) -----------
def _register_scalar_ops():
    def mk(name, f):
        def op(data, scalar=0.0, **kw):
            return _ops._apply(lambda x: f(x, scalar), (data,), {})
        op.__name__ = name
        register_sym_op(name, op)

    mk("_plus_scalar", lambda x, s: x + s)
    mk("_minus_scalar", lambda x, s: x - s)
    mk("_rminus_scalar", lambda x, s: s - x)
    mk("_mul_scalar", lambda x, s: x * s)
    mk("_div_scalar", lambda x, s: x / s)
    mk("_rdiv_scalar", lambda x, s: s / x)
    mk("_power_scalar", lambda x, s: x ** s)
    mk("_equal_scalar", lambda x, s: (x == s).to(x.dtype))


# -- JSON ---------------------------------------------------------------------
def load_json(json_str):
    g = json.loads(json_str)
    nodes = []
    for spec in g["nodes"]:
        raw = dict(spec.get("attrs") or {})
        sym_attrs = json.loads(raw.pop("__sym_attrs__", "{}"))
        variadic = raw.pop("__variadic__", None) == "1"
        input_names = json.loads(raw.pop("__input_names__", "[]"))
        aux_inputs = tuple(json.loads(raw.pop("__aux_inputs__", "[]")))
        n_out = int(raw.pop("__num_outputs__", "1"))
        kwargs = {}
        for k, v in raw.items():
            try:
                kwargs[k] = json.loads(v)
            except (ValueError, json.JSONDecodeError):
                kwargs[k] = v
        if spec["op"] == "null":
            node = _Node(None, spec["name"], attrs={
                **sym_attrs, **{k: str(v) for k, v in kwargs.items()}})
        else:
            node = _Node(spec["op"], spec["name"],
                         inputs=[(nodes[i], oi)
                                 for i, oi, _v in spec["inputs"]],
                         input_names=input_names, variadic=variadic,
                         kwargs=kwargs, num_outputs=n_out, attrs=sym_attrs,
                         aux_input_names=aux_inputs)
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, _v in g["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# -- Executor: the bound graph ------------------------------------------------
class Executor:
    """A symbol bound to arrays on one context.  ``forward`` evaluates
    the graph (``is_train=True``: under autograd, the graph kept for
    ``backward``), ``backward`` writes or adds (``grad_req``) each
    argument's gradient into ``grad_dict``; ``"null"`` arguments get
    none."""

    def __init__(self, symbol, ctx, arg_dict, aux_dict, grad_req="write"):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else \
            (current_context() if ctx is None else ctx)
        self._device = _device.resolve(self._ctx)
        own = lambda v: v if isinstance(v, NDArray) else \
            array(v, ctx=self._ctx)
        self.arg_dict = {k: own(v) for k, v in arg_dict.items()}
        self.aux_dict = {k: own(v) for k, v in aux_dict.items()}
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self.grad_req = dict(grad_req)
        self.grad_dict = {
            n: NDArray(torch.zeros_like(self.arg_dict[n]._data))
            for n in self._arg_names
            if self.grad_req.get(n, "null") != "null" and n in self.arg_dict}
        self.outputs = []
        self._recorded = None   # (leaves by name, output tensors)
        self._fed = False

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def _wrt(self):
        return [n for n in self._arg_names
                if self.grad_req.get(n, "null") != "null"]

    def _run(self, is_train):
        """Evaluate on the bound arrays: with ``is_train`` under autograd,
        from fresh leaves of the arguments that take a gradient."""
        feeds = {n: a._data.detach().to(self._device)
                 for n, a in self.arg_dict.items()}
        feeds.update({n: a._data.detach().to(self._device)
                      for n, a in self.aux_dict.items()})
        leaves = {}
        if is_train:
            for n in self._wrt():
                if n in feeds and feeds[n].is_floating_point():
                    leaves[n] = feeds[n] = feeds[n].requires_grad_(True)
        with self._ctx, torch.set_grad_enabled(bool(leaves)):
            outs = self._symbol._eval(feeds, is_train=is_train)
        return leaves, outs

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            arr = v if isinstance(v, NDArray) else array(v, ctx=self._ctx)
            if k in self.arg_dict:
                self.arg_dict[k] = arr
            elif k in self.aux_dict:
                self.aux_dict[k] = arr
            else:
                raise MXNetError(f"forward: unknown input '{k}'")
        leaves, outs = self._run(bool(is_train))
        self._recorded = (leaves, outs) if is_train else None
        self._fed = True
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """The gradients of the last forward's outputs (head gradients
        ``out_grads``, ones where not given) with respect to every
        argument whose ``grad_req`` is not ``"null"``; after a prediction
        forward the graph is evaluated again in training mode first, as
        the reference's backward does."""
        if not self._fed:
            raise MXNetError("backward called before forward")
        leaves, outs = self._recorded if self._recorded is not None \
            else self._run(True)
        self._recorded = None
        if out_grads is None:
            hgs = [None] * len(outs)
        elif isinstance(out_grads, NDArray):
            hgs = [out_grads._data]
        else:
            hgs = [g._data if isinstance(g, NDArray) else g
                   for g in out_grads]
        pairs = [(o, torch.ones_like(o) if g is None
                  else torch.as_tensor(g, dtype=o.dtype, device=o.device))
                 for o, g in zip(outs, hgs) if o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [leaves[n] for n in names],
            [g for _, g in pairs], allow_unused=True) \
            if pairs and names else [None] * len(names)
        for n in self._wrt():
            g = grads[names.index(n)] if n in leaves else None
            if g is None:
                g = torch.zeros_like(self.arg_dict[n]._data)
            if self.grad_req.get(n, "write") == "add" and n in self.grad_dict:
                self.grad_dict[n] = NDArray(self.grad_dict[n]._data + g)
            else:
                self.grad_dict[n] = NDArray(g)
        return self.grad_arrays

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        own = lambda v: v if isinstance(v, NDArray) else \
            array(v, ctx=self._ctx)
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                self.arg_dict[k] = own(v)
            elif not allow_extra_params:
                raise MXNetError(f"unknown argument '{k}'")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                self.aux_dict[k] = own(v)
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state '{k}'")

    def reshape(self, **kwargs):
        """A new executor for other input shapes, sharing this one's
        parameter arrays (the inputs named in ``kwargs`` get zeros)."""
        shapes = {k: tuple(v) for k, v in kwargs.items()}
        arg_shapes, _, _ = self._symbol.infer_shape(
            **{k: v for k, v in shapes.items() if k in self._arg_names})
        new_args = dict(self.arg_dict)
        for n, s in zip(self._arg_names, arg_shapes):
            if n in shapes:
                new_args[n] = NDArray(torch.zeros(s, dtype=torch.float32,
                                                  device=self._device))
        return Executor(self._symbol, self._ctx, new_args,
                        dict(self.aux_dict), self.grad_req)


_register_scalar_ops()
