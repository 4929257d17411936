"""``mx.viz`` / ``mx.visualization``, from ``tpu_mx/visualization.py``:
``print_summary`` and ``plot_network`` over the port's ``mx.sym``.

``print_summary`` walks the symbol's graph in topological order and
prints the reference's table: each operator's name and type, its output
shape (``infer_shape_partial`` of the internals on the given input
shapes), its parameter count (the arguments that are not inputs) and
the operators it reads; then the total, which it returns.
``plot_network`` returns a ``graphviz.Digraph`` when the ``graphviz``
package is installed and raises :class:`MXNetError` otherwise, as the
reference does; the card's machine does not have it, so the textual
summary is the supported path there.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .symbol.symbol import _topo

__all__ = ["print_summary", "plot_network"]


def _node_output_shapes(sym, shape_kwargs):
    """``{node name: output shape}`` for every internal output it can
    infer."""
    internals = sym.get_internals()
    try:
        _, out_shapes, _ = internals.infer_shape_partial(**shape_kwargs)
    except Exception:   # noqa: BLE001 — a summary prints what it can
        out_shapes = None
    if out_shapes is None:
        return {}
    shapes = {}
    for s, shp in zip(internals, out_shapes):
        if shp is not None:
            shapes.setdefault(s.name, tuple(int(v) for v in shp))
    return shapes


def print_summary(symbol, shape=None, line_length=98, positions=None):
    """Print the layer table of ``symbol``.  ``shape``: ``{input name:
    shape}``, which the output shapes and parameter counts need; without
    it the topology prints with blanks.  Returns the total parameter
    count."""
    shape = shape or {}
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    cols = [int(line_length * p) for p in positions]
    shapes = _node_output_shapes(symbol, shape) if shape else {}
    arg_shapes = {}
    if shape:
        try:
            a_shapes, _, aux_shapes = symbol.infer_shape_partial(**shape)
            arg_shapes = dict(zip(symbol.list_arguments(), a_shapes))
            arg_shapes.update(zip(symbol.list_auxiliary_states(),
                                  aux_shapes))
        except Exception:   # noqa: BLE001
            pass

    def row(fields):
        line = ""
        for text, stop in zip(fields, cols):
            line = (line + str(text))[:stop].ljust(stop)
        print(line)

    print("=" * line_length)
    row(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print("=" * line_length)
    total = 0
    for n in _topo(symbol._entries):
        if n.is_variable():
            continue
        prev = ",".join(c.name for c, _ in n.inputs if not c.is_variable())
        params = 0
        for child, _i in n.inputs:
            if child.is_variable() and child.name in arg_shapes and \
                    child.name not in shape:
                shp = arg_shapes[child.name]
                if shp:
                    params += int(_np.prod(shp))
        total += params
        row([f"{n.name} ({n.op})", shapes.get(n.name, ""), params, prev])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("=" * line_length)
    return total


def plot_network(symbol, title="plot", shape=None, node_attrs=None,
                 save_format="pdf"):
    """The symbol's graph as a ``graphviz.Digraph`` (a box per node, an
    edge per input).  Needs the optional ``graphviz`` package: without it
    this raises :class:`MXNetError` pointing to :func:`print_summary`."""
    try:
        import graphviz
    except ImportError as e:
        raise MXNetError(
            "plot_network needs the 'graphviz' package, which is not "
            "installed; use tpu_mx_torch.viz.print_summary(sym, shape=...) "
            "for the textual summary") from e
    dot = graphviz.Digraph(name=title, format=save_format)
    node_attrs = node_attrs or {"shape": "box", "fontsize": "10"}
    for n in _topo(symbol._entries):
        label = n.name if n.is_variable() else f"{n.name}\n{n.op}"
        dot.node(n.name, label=label, **node_attrs)
        for child, _ in n.inputs:
            dot.edge(child.name, n.name)
    return dot
