"""CUDA graphs over the serving steps: the port's form of ``jax.jit`` over
them (``repro/launch/serve.py:198-199``).

The steps that ``training/steps.py`` makes stay plain functions, as the JAX
package's do, and ``launch/serve.py`` wraps them, as the JAX one applies
``jax.jit`` (``capture_batch_steps``):

    logits, caches = warm_up(prefill_step, params, inputs)
    warm_up(decode_step, params, caches, token)
    prefill = capture(prefill_step, params, inputs)
    decode = capture(decode_step, params, prefill.outputs[1], token, pool=prefill.pool)

``warm_up`` runs a step once eagerly, so that its capture finds done what a
first call sets up and a capture may not: the kernels built
(``kernels/build.py`` compiles at first launch), the wrappers' cached plans
and instance info, each kernel's shared-memory attribute, cuBLAS's first
call at each shape. ``capture`` records one call of a step into a
``torch.cuda.CUDAGraph``; calling what it returns copies the arguments into
the graph's static inputs, replays the graph and returns its static outputs.

A graph is the CUDA form of a step. ``capture`` refuses a tensor that is not
on a CUDA device, and a capture that fails raises: there is no eager
fallback on the card. On the CPU the caller runs the eager step.

Launch accounting: each kernel wrapper counts its launches in a module
global (``KERNEL_COUNTERS``), bumped in Python, and a replay runs no Python.
So ``warm_up`` and ``capture`` take their own launches back out of the
counters, and each replay adds the launches its capture counted.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence, Tuple

import torch

from repro_torch.kernels.fused_rnn import fused_rnn, stacked
from repro_torch.kernels.gqa_decode import gqa_decode
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.kernels.ssd import ssd

#: (module, attribute) of every kernel wrapper's launch counter; the fused
#: RNN wrappers count their fp and int8 instances apart.
KERNEL_COUNTERS = ((fused_rnn, "LAUNCHES"), (fused_rnn, "LAUNCHES_INT8"),
                   (stacked, "LAUNCHES"), (stacked, "LAUNCHES_INT8"),
                   (linear_scan, "LAUNCHES"), (gqa_decode, "LAUNCHES"), (ssd, "LAUNCHES"))


@contextlib.contextmanager
def uncounted(counters: Sequence[Tuple[object, str]] = KERNEL_COUNTERS) -> Iterator[List[int]]:
    """A block whose launches are not counted: on leaving it each counter is
    set back to its value on entry, and the yielded list receives each
    counter's rise inside the block."""
    before = [getattr(mod, attr) for mod, attr in counters]
    rise: List[int] = []
    try:
        yield rise
    finally:
        rise.extend(getattr(mod, attr) - n for (mod, attr), n in zip(counters, before))
        for (mod, attr), n in zip(counters, before):
            setattr(mod, attr, n)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in leaves(x)]
    return []


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _copy_in(static, new, where: str = "args") -> None:
    """Copy ``new`` into the static inputs ``static`` (same structure). The
    very object captured is taken as it is; so is a tensor on the same
    storage with the same layout."""
    if new is static:
        return
    if isinstance(static, torch.Tensor):
        if (not isinstance(new, torch.Tensor) or new.shape != static.shape
                or new.dtype != static.dtype):
            raise ValueError(f"graphs: {where} is {_describe(new)}; the graph was captured "
                             f"with {_describe(static)}")
        if new.data_ptr() != static.data_ptr() or new.stride() != static.stride():
            static.copy_(new)
    elif isinstance(static, dict):
        if not isinstance(new, dict) or new.keys() != static.keys():
            raise ValueError(f"graphs: {where} has other keys than the graph was captured with")
        for k, v in static.items():
            _copy_in(v, new[k], f"{where}[{k!r}]")
    elif isinstance(static, (list, tuple)):
        if not isinstance(new, (list, tuple)) or len(new) != len(static):
            raise ValueError(f"graphs: {where} has another length than the graph was "
                             "captured with")
        for i, (s, n) in enumerate(zip(static, new)):
            _copy_in(s, n, f"{where}[{i}]")
    elif new != static:
        raise ValueError(f"graphs: {where} is {new!r}; the graph was captured with {static!r}")


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {x.dtype} tensor of shape {tuple(x.shape)}"
    return type(x).__name__


class CapturedStep:
    """One step as a CUDA graph (``capture``). A call copies its arguments
    into the static inputs (an argument that is the very tensor, dict or list
    captured, as the params and the caches a decode graph updates are, is
    taken as it is), replays the graph and returns the static ``outputs``,
    which the next replay overwrites. Each replay adds the capture's
    ``launches`` to the ``counters``."""

    def __init__(self, graph, inputs: tuple, outputs, launches: Sequence[int],
                 counters: Sequence[Tuple[object, str]] = KERNEL_COUNTERS):
        self.graph, self.inputs, self.outputs = graph, tuple(inputs), outputs
        self.launches, self.counters = tuple(launches), tuple(counters)

    @property
    def pool(self):
        """The graph's memory pool, for a graph replayed after this one and
        never at the same time (``capture(..., pool=)``)."""
        return self.graph.pool()

    def __call__(self, *args):
        with torch.inference_mode():  # a step's static inputs may be inference tensors
            _copy_in(self.inputs, args)
        self.graph.replay()
        for (mod, attr), n in zip(self.counters, self.launches):
            setattr(mod, attr, getattr(mod, attr) + n)
        return self.outputs


def warm_up(step: Callable, params, *args, counters=KERNEL_COUNTERS):
    """Run ``step(params, *args)`` once, eagerly, before it is captured. The
    params are used as they lie (no step writes them); every other argument
    is cloned first, so that the warm-up leaves each buffer it is given with
    its bits, a graph's caches among them. Its launches are not counted.
    Returns what the step returns."""
    with torch.inference_mode():
        args = _clone(args)
    with uncounted(counters):
        return step(params, *args)


def capture(step: Callable, *example_args, pool=None,
            counters=KERNEL_COUNTERS) -> CapturedStep:
    """Capture one call of ``step(*example_args)`` into a CUDA graph.

    The example arguments become the graph's static inputs, where they lie:
    nothing is copied, and the params and caches must not move or be freed
    while the graph lives (the fused RNN kernels also bake the slabs'
    addresses into the tensor maps they are launched with). What the step
    returns becomes the static outputs, in the graph's memory pool, or in
    ``pool`` (``CapturedStep.pool`` of a graph replayed before this one,
    never at the same time: live outputs of that graph, such as the caches a
    decode graph is captured over, are never handed out again). The step runs
    under ``torch.inference_mode()``. Warm it up first (``warm_up``): a
    capture records work and runs none. The launches the capture counts are
    taken back out and added again at each replay."""
    tensors = leaves(example_args)
    off = sorted({str(t.device) for t in tensors if t.device.type != "cuda"})
    if not tensors or off:
        raise ValueError(
            "graphs.capture: a CUDA graph needs its tensors on a CUDA device; got "
            f"{'tensors on ' + ', '.join(off) if off else 'no tensor'}. Off the card, run "
            "the eager step.")
    graph = torch.cuda.CUDAGraph()
    name = getattr(step, "__qualname__", repr(step))
    with uncounted(counters) as launches:
        try:
            with torch.cuda.device(tensors[0].device), torch.inference_mode(), \
                    torch.cuda.graph(graph, pool=pool):
                outputs = step(*example_args)
        except Exception as e:
            raise RuntimeError(f"graphs.capture: capturing {name} failed: {e}") from e
    return CapturedStep(graph, example_args, outputs, launches, counters)
