"""ONNX export and import for ``mx.sym`` graphs, from
``tpu_mx/contrib/onnx.py``: ``export_model``, ``import_model`` and
``get_model_metadata``, writing and reading the ONNX protobuf wire
format through :mod:`._protobuf` (the port needs no ``onnx`` package).

The operator set is the reference's: Convolution, BatchNorm,
Activation, LeakyReLU, Pooling (global too), FullyConnected, Flatten,
reshape, transpose, Concat, the broadcast arithmetic, add_n, softmax,
SoftmaxOutput, Dropout and Embedding, at opset 13 in the default
domain.  The writer is the reference's, node for node and byte for
byte (the producer is named ``tpu_mx``, the framework both packages
implement), so either package's file imports in the other::

    from tpu_mx_torch.contrib import onnx as onnx_mxnet
    onnx_mxnet.export_model(sym, params, [(1, 3, 224, 224)], "net.onnx")
    sym2, arg2, aux2 = onnx_mxnet.import_model("net.onnx")

Parameters may be arrays, tensors (a bfloat16 one is written as
float32) or numpy arrays; ``import_model`` returns arrays on the
current context.  ``HybridBlock.export``'s ``.pt2`` program stays the
full-fidelity deployment artifact; ONNX is the interchange format for
the graph-level operator subset.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import array
from ..runtime import fetch_sync
from ._protobuf import Msg, decode, decode_packed_ints

__all__ = ["export_model", "import_model", "get_model_metadata"]

# TensorProto.DataType
_DT_FLOAT, _DT_INT32, _DT_INT64 = 1, 6, 7
_NP2ONNX = {np.dtype(np.float32): _DT_FLOAT, np.dtype(np.int32): _DT_INT32,
            np.dtype(np.int64): _DT_INT64}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}
# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR, _AT_INTS = 1, 2, 3, 4, 7


# ---------------------------------------------------------------------------
# proto writers
# ---------------------------------------------------------------------------
def _tensor(name, arr):
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP2ONNX:
        arr = arr.astype(np.float32)
    m = Msg()
    m.ints(1, arr.shape)                       # dims
    m.int(2, _NP2ONNX[arr.dtype])              # data_type
    m.bytes(8, name)                           # name
    m.bytes(9, arr.tobytes())                  # raw_data
    return m


def _value_info(name, shape, elem_type=_DT_FLOAT):
    shp = Msg()
    for d in shape:
        shp.bytes(1, Msg().int(1, int(d)))     # dim { dim_value }
    ttype = Msg().int(1, elem_type).bytes(2, shp)
    return Msg().bytes(1, name).bytes(2, Msg().bytes(1, ttype))


def _attr(name, value):
    m = Msg().bytes(1, name)
    if isinstance(value, float):
        m.float(2, value).int(20, _AT_FLOAT)
    elif isinstance(value, (bool, int, np.integer)):
        m.int(3, int(value)).int(20, _AT_INT)
    elif isinstance(value, str):
        m.bytes(4, value).int(20, _AT_STRING)
    elif isinstance(value, (list, tuple)):
        m.ints(8, value).int(20, _AT_INTS)
    else:
        raise MXNetError(f"unsupported attribute value {value!r}")
    return m


def _node(op_type, inputs, outputs, name, **attrs):
    m = Msg()
    for i in inputs:
        m.bytes(1, i)
    for o in outputs:
        m.bytes(2, o)
    m.bytes(3, name)
    m.bytes(4, op_type)
    for k, v in attrs.items():
        m.bytes(5, _attr(k, v))
    return m


# ---------------------------------------------------------------------------
# export: Symbol graph -> ONNX bytes
# ---------------------------------------------------------------------------
def _pair(v, default=1):
    if v is None:
        return None
    return [int(x) for x in (v if isinstance(v, (list, tuple)) else (v, v))]


class _Exporter:
    def __init__(self):
        self.nodes = []        # NodeProto Msgs
        self.extra_inits = []  # TensorProto Msgs synthesized by converters
        self.counter = 0

    def fresh(self, hint):
        self.counter += 1
        return f"_onnx_{hint}_{self.counter}"

    def const(self, hint, arr):
        name = self.fresh(hint)
        self.extra_inits.append(_tensor(name, np.asarray(arr)))
        return name

    def emit(self, op_type, inputs, outputs, name, **attrs):
        self.nodes.append(_node(op_type, inputs, outputs, name, **attrs))


def _conv_attrs(kw):
    kernel = _pair(kw.get("kernel"))
    attrs = {"kernel_shape": kernel}
    s = _pair(kw.get("stride"))
    if s:
        attrs["strides"] = s
    d = _pair(kw.get("dilate"))
    if d:
        attrs["dilations"] = d
    p = _pair(kw.get("pad"))
    if p:
        attrs["pads"] = p + p                  # symmetric begin+end
    g = int(kw.get("num_group", 1) or 1)
    if g != 1:
        attrs["group"] = g
    return attrs


def _cv_convolution(ex, node, ins, outs):
    ex.emit("Conv", ins, outs, node.name, **_conv_attrs(node.kwargs))


def _cv_fullyconnected(ex, node, ins, outs):
    data, w = ins[0], ins[1]
    bias = ins[2] if len(ins) > 2 else None
    if node.kwargs.get("flatten", True):
        flat = ex.fresh("flat")
        ex.emit("Flatten", [data], [flat], ex.fresh("Flatten"), axis=1)
        gemm_in = [flat, w] + ([bias] if bias else [])
        ex.emit("Gemm", gemm_in, outs, node.name, transB=1)
    else:
        wt = ex.fresh("wT")
        ex.emit("Transpose", [w], [wt], ex.fresh("Transpose"), perm=[1, 0])
        mm = ex.fresh("mm") if bias else outs[0]
        ex.emit("MatMul", [data, wt], [mm], ex.fresh("MatMul"))
        if bias:
            ex.emit("Add", [mm, bias], outs, node.name)


_ACT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
        "softrelu": "Softplus", "softsign": "Softsign"}


def _cv_activation(ex, node, ins, outs):
    act = node.kwargs.get("act_type", "relu")
    if act not in _ACT:
        raise MXNetError(f"ONNX export: unsupported act_type {act!r}")
    ex.emit(_ACT[act], ins, outs, node.name)


def _cv_leakyrelu(ex, node, ins, outs):
    ex.emit("LeakyRelu", ins, outs, node.name,
            alpha=float(node.kwargs.get("slope", 0.25)))


def _cv_batchnorm(ex, node, ins, outs):
    # mxnet input order (data, gamma, beta, moving_mean, moving_var) matches
    # ONNX (X, scale, B, input_mean, input_var); fix_gamma is baked in by
    # the export loop (gamma replaced with a ones initializer)
    ex.emit("BatchNormalization", ins, outs, node.name,
            epsilon=float(node.kwargs.get("eps", 1e-5)),
            momentum=float(node.kwargs.get("momentum", 0.9)))


def _cv_pooling(ex, node, ins, outs):
    kw = node.kwargs
    ptype = kw.get("pool_type", "max")
    if ptype not in ("max", "avg"):
        raise MXNetError(f"ONNX export: unsupported pool_type {ptype!r}")
    if kw.get("global_pool"):
        ex.emit("GlobalMaxPool" if ptype == "max" else "GlobalAveragePool",
                ins, outs, node.name)
        return
    attrs = {"kernel_shape": _pair(kw.get("kernel"))}
    s = _pair(kw.get("stride"))
    if s:
        attrs["strides"] = s
    p = _pair(kw.get("pad"))
    if p:
        attrs["pads"] = p + p
    if ptype == "avg":
        attrs["count_include_pad"] = int(bool(kw.get("count_include_pad",
                                                     True)))
    ex.emit("MaxPool" if ptype == "max" else "AveragePool", ins, outs,
            node.name, **attrs)


def _cv_reshape(ex, node, ins, outs):
    shape = ex.const("shape", np.asarray(node.kwargs["shape"], np.int64))
    ex.emit("Reshape", [ins[0], shape], outs, node.name)


def _cv_dropout(ex, node, ins, outs):
    ratio = ex.const("ratio", np.asarray(node.kwargs.get("p", 0.5),
                                         np.float32))
    ex.emit("Dropout", [ins[0], ratio], outs, node.name)


def _cv_embedding(ex, node, ins, outs):
    # mxnet Embedding(data, weight); ONNX Gather(data=weight, indices)
    ex.emit("Gather", [ins[1], ins[0]], outs, node.name, axis=0)


_SIMPLE = {
    "Flatten": ("Flatten", {"axis": 1}), "flatten": ("Flatten", {"axis": 1}),
    "broadcast_add": ("Add", {}), "elemwise_add": ("Add", {}),
    "broadcast_sub": ("Sub", {}), "broadcast_mul": ("Mul", {}),
    "broadcast_div": ("Div", {}), "add_n": ("Sum", {}),
    "relu": ("Relu", {}), "sigmoid": ("Sigmoid", {}), "tanh": ("Tanh", {}),
}

_CONVERTERS = {
    "Convolution": _cv_convolution,
    "FullyConnected": _cv_fullyconnected,
    "Activation": _cv_activation,
    "LeakyReLU": _cv_leakyrelu,
    "BatchNorm": _cv_batchnorm,
    "Pooling": _cv_pooling,
    "reshape": _cv_reshape,
    "Reshape": _cv_reshape,
    "Dropout": _cv_dropout,
    "Embedding": _cv_embedding,
}


def _cv_transpose(ex, node, ins, outs):
    axes = node.kwargs.get("axes")
    ex.emit("Transpose", ins, outs, node.name,
            **({"perm": [int(a) for a in axes]} if axes else {}))


def _cv_concat(ex, node, ins, outs):
    ex.emit("Concat", ins, outs, node.name,
            axis=int(node.kwargs.get("dim", 1)))


def _cv_softmax(ex, node, ins, outs):
    ex.emit("Softmax", [ins[0]], outs, node.name,
            axis=int(node.kwargs.get("axis", -1)))


_CONVERTERS.update({
    "transpose": _cv_transpose, "Concat": _cv_concat, "concat": _cv_concat,
    "softmax": _cv_softmax, "SoftmaxOutput": _cv_softmax,
})


def export_model(sym, params, input_shapes=None, onnx_file_path="model.onnx",
                 input_dtypes=None, opset=13):
    """Serialize a Symbol graph + params to an ONNX file.

    sym — an ``mx.sym`` Symbol (single- or multi-output)
    params — {name: array, tensor or ndarray} for every parameter/aux
        variable
    input_shapes — [(shape…)] for the remaining (data) variables, in
        list_arguments order, or {name: shape}
    input_dtypes — matching dtypes (list or {name: dtype}); default
        float32 — int inputs (token ids) MUST declare int32/int64 or
        foreign runtimes will reject the feed
    Returns the path written.  Raises MXNetError on unsupported ops."""
    from ..symbol.symbol import _topo

    params = {k: fetch_sync(v) for k, v in (params or {}).items()}
    data_names = [n for n in sym.list_inputs() if n not in params]
    if isinstance(input_shapes, dict):
        shape_map = dict(input_shapes)
    else:
        shape_map = dict(zip(data_names, input_shapes or []))
    missing = [n for n in data_names if n not in shape_map]
    if missing:
        raise MXNetError(f"ONNX export: missing input shapes for {missing}")
    if isinstance(input_dtypes, dict):
        dtype_map = dict(input_dtypes)
    else:
        dtype_map = dict(zip(data_names, input_dtypes or []))

    def elem_type_of(name):
        dt = np.dtype(dtype_map.get(name, np.float32))
        if dt not in _NP2ONNX:
            raise MXNetError(f"ONNX export: unsupported input dtype {dt} "
                             f"for {name!r}")
        return _NP2ONNX[dt]

    ex = _Exporter()
    order = _topo(sym._entries)
    out_of = {}                       # id(node) -> [output value names]
    inits, graph_inputs = [], []
    for node in order:
        if node.is_variable():
            out_of[id(node)] = [node.name]
            if node.name in params:
                arr = params[node.name]
                inits.append(_tensor(node.name, arr))
            else:
                graph_inputs.append(_value_info(node.name,
                                                shape_map[node.name],
                                                elem_type_of(node.name)))
            continue
        if node.num_outputs != 1:
            raise MXNetError(
                f"ONNX export: multi-output op {node.op} unsupported")
        ins = [out_of[id(c)][i] for c, i in node.inputs]
        outs = [node.name + "_output"]
        out_of[id(node)] = outs
        cv = _CONVERTERS.get(node.op)
        if cv is not None:
            # fix_gamma needs the gamma shape: synthesize ones lazily here
            if node.op == "BatchNorm" and node.kwargs.get("fix_gamma", True):
                gname = ins[1]
                garr = params.get(gname)
                if garr is not None:
                    ins = list(ins)
                    ins[1] = ex.const("fixed_gamma", np.ones_like(garr))
            cv(ex, node, ins, outs)
        elif node.op in _SIMPLE:
            op_type, attrs = _SIMPLE[node.op]
            ex.emit(op_type, ins, outs, node.name, **attrs)
        else:
            raise MXNetError(f"ONNX export: unsupported op {node.op!r} "
                             f"(node {node.name})")

    graph = Msg()
    for n in ex.nodes:
        graph.bytes(1, n)
    graph.bytes(2, "tpu_mx")
    for t in inits + ex.extra_inits:
        graph.bytes(5, t)
    for vi in graph_inputs:
        graph.bytes(11, vi)
    for node, idx in sym._entries:
        nm = node.name if node.is_variable() else node.name + "_output"
        graph.bytes(12, _value_info(nm, ()))   # shape left unspecified

    model = Msg()
    model.int(1, 8)                            # ir_version
    model.bytes(2, "tpu_mx")                   # producer_name
    model.bytes(3, "3.0")                      # producer_version
    model.bytes(7, graph)
    model.bytes(8, Msg().bytes(1, "").int(2, opset))  # opset_import
    from ..checkpoint import atomic_write
    with atomic_write(onnx_file_path) as f:
        f.write(model.tobytes())
    return onnx_file_path


# ---------------------------------------------------------------------------
# import: ONNX bytes -> (Symbol, arg_params, aux_params)
# ---------------------------------------------------------------------------
def _parse_tensor(raw):
    f = decode(raw)
    dims = decode_packed_ints(f.get(1, []))
    dtype = _ONNX2NP.get(f.get(2, [_DT_FLOAT])[0], np.dtype(np.float32))
    name = f.get(8, [b""])[0].decode()
    if 9 in f:
        arr = np.frombuffer(f[9][0], dtype=dtype).reshape(dims).copy()
    elif 4 in f:                              # float_data (packed or not)
        vals = []
        for v in f[4]:
            if isinstance(v, (bytes, bytearray)):
                vals.extend(np.frombuffer(v, np.float32))
            else:
                vals.append(v)
        arr = np.asarray(vals, np.float32).reshape(dims)
    elif 7 in f:
        arr = np.asarray(decode_packed_ints(f[7]), np.int64).reshape(dims)
    else:
        arr = np.zeros(dims, dtype)
    return name, arr


def _parse_attrs(raws):
    out = {}
    for raw in raws:
        f = decode(raw)
        name = f[1][0].decode()
        atype = f.get(20, [0])[0]
        if atype == _AT_FLOAT:
            out[name] = f[2][0]
        elif atype == _AT_INT:
            v = f[3][0]
            out[name] = v - (1 << 64) if v >= 1 << 63 else v
        elif atype == _AT_STRING:
            out[name] = f[4][0].decode()
        elif atype == _AT_INTS:
            out[name] = decode_packed_ints(f.get(8, []))
        elif atype == _AT_TENSOR:
            out[name] = _parse_tensor(f[5][0])[1]
    return out


def _sym_pads(attrs, nd=2):
    p = attrs.get("pads")
    if not p:
        return None
    begin, end = p[:nd], p[nd:]
    if list(begin) != list(end):
        raise MXNetError(f"ONNX import: asymmetric pads {p} unsupported")
    return tuple(begin)


def import_model(model_file):
    """Load an ONNX file into (sym, arg_params, aux_params) — the
    reference's contrib.onnx.import_model contract."""
    from .. import symbol as S

    with open(model_file, "rb") as f:
        model = decode(f.read())
    graph = decode(model[7][0])
    inits = dict(_parse_tensor(t) for t in graph.get(5, []))
    values = {}                                # value name -> Symbol
    aux_names = set()
    for vi_raw in graph.get(11, []):           # graph inputs
        name = decode(vi_raw)[1][0].decode()
        if name not in inits:
            values[name] = S.Variable(name)

    def sym_of(name):
        if name not in values:
            values[name] = S.Variable(name)
        return values[name]

    for node_raw in graph.get(1, []):
        f = decode(node_raw)
        ins = [b.decode() for b in f.get(1, [])]
        outs = [b.decode() for b in f.get(2, [])]
        name = f.get(3, [b""])[0].decode() or None
        op = f[4][0].decode()
        attrs = _parse_attrs(f.get(5, []))
        out = _import_node(S, op, ins, outs, name, attrs, inits, sym_of,
                           aux_names)
        values[outs[0]] = out

    entries = []
    for vi_raw in graph.get(12, []):
        name = decode(vi_raw)[1][0].decode()
        entries.append(values[name])
    sym = entries[0] if len(entries) == 1 else S.Group(entries)
    used = set(sym.list_inputs())
    arg_params = {k: array(np.asarray(v)) for k, v in inits.items()
                  if k in used and k not in aux_names}
    aux_params = {k: array(np.asarray(v)) for k, v in inits.items()
                  if k in used and k in aux_names}
    return sym, arg_params, aux_params


def _import_node(S, op, ins, outs, name, attrs, inits, sym_of, aux_names):
    def kernel_kwargs(nd=2):
        kw = {}
        if "kernel_shape" in attrs:
            kw["kernel"] = tuple(attrs["kernel_shape"])
        if attrs.get("strides"):
            kw["stride"] = tuple(attrs["strides"])
        if attrs.get("dilations"):
            kw["dilate"] = tuple(attrs["dilations"])
        p = _sym_pads(attrs, nd)
        if p:
            kw["pad"] = p
        return kw

    if op == "Conv":
        w = inits.get(ins[1])
        if w is None:
            raise MXNetError("ONNX import: Conv weight must be initializer")
        kw = kernel_kwargs(len(w.shape) - 2)
        kw["num_filter"] = int(w.shape[0])
        kw["num_group"] = int(attrs.get("group", 1))
        if len(ins) < 3:
            kw["no_bias"] = True
        return S.Convolution(sym_of(ins[0]), weight=sym_of(ins[1]),
                             bias=sym_of(ins[2]) if len(ins) > 2 else None,
                             name=name, **kw)
    if op == "Gemm":
        if attrs.get("transB", 0) != 1 or attrs.get("transA", 0):
            raise MXNetError("ONNX import: only Gemm(transB=1) supported")
        w = inits.get(ins[1])
        if w is None:
            raise MXNetError("ONNX import: Gemm weight must be initializer")
        return S.FullyConnected(
            sym_of(ins[0]), weight=sym_of(ins[1]),
            bias=sym_of(ins[2]) if len(ins) > 2 else None,
            num_hidden=int(w.shape[0]), flatten=False,
            no_bias=len(ins) < 3, name=name)
    if op == "BatchNormalization":
        aux_names.update(ins[3:5])
        return S.BatchNorm(sym_of(ins[0]), gamma=sym_of(ins[1]),
                           beta=sym_of(ins[2]), moving_mean=sym_of(ins[3]),
                           moving_var=sym_of(ins[4]),
                           eps=float(attrs.get("epsilon", 1e-5)),
                           momentum=float(attrs.get("momentum", 0.9)),
                           fix_gamma=False, name=name)
    if op in ("MaxPool", "AveragePool"):
        kw = kernel_kwargs()
        kw.pop("dilate", None)
        if op == "AveragePool":
            kw["count_include_pad"] = bool(attrs.get("count_include_pad", 0))
        return S.Pooling(sym_of(ins[0]),
                         pool_type="max" if op == "MaxPool" else "avg",
                         name=name, **kw)
    if op in ("GlobalMaxPool", "GlobalAveragePool"):
        return S.Pooling(sym_of(ins[0]), global_pool=True, kernel=(1, 1),
                         pool_type="max" if op == "GlobalMaxPool" else "avg",
                         name=name)
    if op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Softsign"):
        act = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
               "Softplus": "softrelu", "Softsign": "softsign"}[op]
        return S.Activation(sym_of(ins[0]), act_type=act, name=name)
    if op == "LeakyRelu":
        return S.LeakyReLU(sym_of(ins[0]),
                           slope=float(attrs.get("alpha", 0.01)), name=name)
    if op == "Flatten":
        return S.Flatten(sym_of(ins[0]), name=name)
    if op == "Reshape":
        shape = inits.get(ins[1])
        if shape is None:
            raise MXNetError("ONNX import: dynamic Reshape unsupported")
        return S.reshape(sym_of(ins[0]), shape=tuple(int(s) for s in shape),
                         name=name)
    if op == "Transpose":
        kw = {"axes": tuple(attrs["perm"])} if attrs.get("perm") else {}
        return S.transpose(sym_of(ins[0]), name=name, **kw)
    if op in ("Add", "Sub", "Mul", "Div"):
        fn = {"Add": S.broadcast_add, "Sub": S.broadcast_sub,
              "Mul": S.broadcast_mul, "Div": S.broadcast_div}[op]
        return fn(sym_of(ins[0]), sym_of(ins[1]), name=name)
    if op == "Sum":
        return S.add_n(*[sym_of(i) for i in ins], name=name)
    if op == "Concat":
        return S.Concat(*[sym_of(i) for i in ins],
                        dim=int(attrs.get("axis", 1)), name=name)
    if op == "Softmax":
        return S.softmax(sym_of(ins[0]), axis=int(attrs.get("axis", -1)),
                         name=name)
    if op == "Dropout":
        ratio = inits.get(ins[1]) if len(ins) > 1 else None
        p = float(np.asarray(ratio).reshape(-1)[0]) \
            if ratio is not None else 0.5
        return S.Dropout(sym_of(ins[0]), p=p, name=name)
    if op == "Gather":
        w = inits.get(ins[0])
        if w is None or int(attrs.get("axis", 0)) != 0:
            raise MXNetError("ONNX import: Gather supported only as "
                             "Embedding (initializer table, axis 0)")
        return S.Embedding(sym_of(ins[1]), weight=sym_of(ins[0]),
                           input_dim=int(w.shape[0]),
                           output_dim=int(w.shape[1]), name=name)
    if op == "MatMul":
        return S.dot(sym_of(ins[0]), sym_of(ins[1]), name=name)
    raise MXNetError(f"ONNX import: unsupported op {op!r}")


def get_model_metadata(model_file):
    """{input/output names} — the reference contrib API's metadata probe."""
    with open(model_file, "rb") as f:
        model = decode(f.read())
    graph = decode(model[7][0])
    inits = {_parse_tensor(t)[0] for t in graph.get(5, [])}
    def names(field):
        return [decode(v)[1][0].decode() for v in graph.get(field, [])]
    return {"input_tensor_data": [n for n in names(11) if n not in inits],
            "output_tensor_data": names(12)}
