"""CUDA graphs of the serving entry points (the port's counterpart of the
JAX package's `jax.jit` over `_flow_only` and `_forward_only`).

`CallGraphs` keeps, for one entry point, one captured graph per call
signature: the nest of input tensors (shapes, strides, dtypes, devices),
the identity of the object that owns the weights (the frozen tables, the
model) and the caller's key (the configuration the body reads, the
model's mode). The first call of a signature runs eagerly, which warms
cuDNN, cuBLAS and the port's kernels; the second warms the capture stream,
captures the body on it and replays it; every later call copies its inputs
into the graph's static buffers, replays, and returns fresh clones of the
graph's outputs, so that one call's results never change under the next.

A replay reads the weights (the `live` tensors) where they lie, so an
in-place update (an optimizer step, `load_state_dict`) is seen by the next
call. A call whose live tensors moved or changed shape (a parameter or
buffer replaced by a new tensor, assigned or through `.data`) captures
again. A model's tensors are walked again only after some module
registered a parameter, buffer or submodule (torch's global registration
hooks count them); deleting one is not watched. Calls whose inputs are
not all CUDA tensors run eagerly, as they always did. A capture that fails
raises, naming the entry point and the source line of the operation that
broke it; nothing falls back to eager.

Every call runs on the current stream, one call at a time. The kernels'
wrappers count a launch (`hoig_torch.ops._cuda.count_launch`) only when a
kernel launches: an eager call counts its launches, the call that
captures counts those of its warm-up on the capture stream (the capture
itself records kernels without launching them), and a replay, which runs
no Python, counts nothing; the device trace shows what a replay launched.
A dispatch mode (FLOP counting) or a hook sees a replayed call's operators
not at all: such readers call the eager bodies (`model_api.flow_eager`,
`forward_eager`).
"""

from __future__ import annotations

import collections
import traceback
import weakref

import torch

# graphs kept per entry point; the least recently called goes first
KEEP = 4


def flatten(tree, leaves: list):
    """The structure of a nest of dicts, tuples and lists whose leaves are
    tensors or other hashable values (None), each tensor by its shape,
    strides, dtype and device; the tensors are appended to `leaves` in
    order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.stride(), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict", tuple((k, flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(flatten(v, leaves) for v in tree))
    return ("value", tree)


def unflatten(structure, leaves):
    """The nest `flatten` described, its tensors taken from the iterator
    `leaves` in order."""
    kind, body = structure[0], structure[1:]
    if kind == "tensor":
        return next(leaves)
    if kind == "dict":
        return {k: unflatten(v, leaves) for k, v in body[0]}
    if kind in ("tuple", "list"):
        items = [unflatten(v, leaves) for v in body[0]]
        return tuple(items) if kind == "tuple" else items
    return body[0]


def live_specs(live) -> tuple:
    """Where each weight tensor lies and its shape: a graph replays against
    exactly these."""
    return tuple((t.data_ptr(), t.shape) for t in live)


def graphable(leaves: list) -> bool:
    """Whether a call with these input tensors runs through a graph: when
    there are some and all are CUDA tensors."""
    return bool(leaves) and all(t.is_cuda for t in leaves)


_REGISTRATIONS = [0]  # parameters, buffers and submodules registered since watched
_WATCH: list = []  # the global registration hooks' handles
_WALKS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> (count, tensors)


def _registered(*_):
    _REGISTRATIONS[0] += 1


def registrations() -> int:
    """How many parameters, buffers and submodules modules have registered
    (assignments included) since the first call of this function."""
    if not _WATCH:
        from torch.nn.modules import module

        _WATCH.extend(hook(_registered) for hook in (
            module.register_module_parameter_registration_hook,
            module.register_module_buffer_registration_hook,
            module.register_module_module_registration_hook))
    return _REGISTRATIONS[0]


def module_tensors(model: torch.nn.Module) -> list:
    """Every parameter and buffer of `model` (a shared one as often as it is
    registered), walked again only after a registration; read it, never
    change it."""
    count = registrations()
    walked = _WALKS.get(model)
    if walked is not None and walked[0] == count:
        return walked[1]
    out, todo = [], [model]
    while todo:
        m = todo.pop()
        out += [t for t in m._parameters.values() if t is not None]
        out += [t for t in m._buffers.values() if t is not None]
        todo += m._modules.values()
    _WALKS[model] = (count, out)
    return out


def failed_at(error: BaseException) -> str:
    """Where the first of a chain of exceptions (one raised while handling
    another: a capture's end after the operator that broke it) was raised:
    the deepest frame in hoig_torch, else the deepest of all."""
    while error.__context__ is not None:
        error = error.__context__
    frames = traceback.extract_tb(error.__traceback__)
    ours = [f for f in frames if "hoig_torch" in f.filename] or frames
    if not ours:
        return "an unknown line"
    f = ours[-1]
    return f"{f.filename}:{f.lineno} `{f.line}`: {type(error).__name__}: {error}"


class _Entry:
    """One call signature; once captured, its graph with the weights' specs
    it was captured against and its static inputs and outputs."""

    __slots__ = ("live", "graph", "inputs", "outputs", "out_structure")

    def __init__(self):
        self.live = self.graph = self.inputs = self.outputs = self.out_structure = None


def _capture(fn, structure, inputs: list):
    """Warm `fn` on the capture stream, then capture it on that stream
    (torch.cuda.graph's documented pattern). Returns (graph, outputs)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*unflatten(structure, iter(inputs)))
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outputs = fn(*unflatten(structure, iter(inputs)))
    return graph, outputs


class CallGraphs:
    """The captured graphs of one entry point (see the module docstring)."""

    def __init__(self, name: str):
        self.name = name
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0  # graphs captured so far

    def __len__(self) -> int:
        return sum(e.graph is not None for e in self._entries.values())

    def clear(self) -> None:
        """Forget every signature and graph."""
        self._entries.clear()
        self.captures = 0

    def __call__(self, fn, args: tuple, key, live):
        """fn(*args), through this signature's graph where the inputs are
        CUDA tensors. `key` (hashable) is what else the body reads: the
        identity of the weights' owner, the configuration, the mode; `live`
        the tensors the body reads in place (weights and tables)."""
        leaves: list = []
        structure = flatten(args, leaves)
        if not graphable(leaves):
            return fn(*args)
        signature = (key, structure)
        entry = self._entries.get(signature)
        if entry is None:
            self._entries[signature] = _Entry()
            while len(self._entries) > KEEP:
                self._entries.popitem(last=False)
            return fn(*args)
        self._entries.move_to_end(signature)
        live = live_specs(live)
        if entry.graph is None or entry.live != live:
            self._capture(entry, fn, structure, leaves, live)
        else:
            for dst, src in zip(entry.inputs, leaves):
                dst.copy_(src)
        entry.graph.replay()
        return unflatten(entry.out_structure, (o.clone() for o in entry.outputs))

    def _capture(self, entry: _Entry, fn, structure, leaves: list, live: tuple) -> None:
        entry.graph = None  # the old graph's memory goes before the new one's
        inputs = [t.clone() for t in leaves]
        try:
            graph, outputs = _capture(fn, structure, inputs)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed at "
                               f"{failed_at(e)}") from e
        outs: list = []
        entry.out_structure = flatten(outputs, outs)
        entry.graph, entry.inputs, entry.outputs, entry.live = graph, inputs, outs, live
        self.captures += 1
