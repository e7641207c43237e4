"""One queue iteration as a CUDA graph, for ``integrator._run_queue``.

On the card an iteration of the regenerating loop launches the same few
dozen small kernels every time, on the same lanes, with shapes fixed at
(B,); launching them one by one from Python is most of its time.
:func:`capture` records one iteration into a ``torch.cuda.CUDAGraph``,
and each later iteration is one replay of it.

The iteration rebinds some registers of ``regen.Lanes`` and
``integrator._Carry`` to fresh tensors (the step's outputs) and writes
the others in place (the regen kernel's registers, the lane cost, the
frame).  A replay reads the tensors the capture read and writes the
tensors the capture wrote, so inside the graph each rebound register is
copied back into the tensor it replaced, and bound to that tensor again:
a replay's outputs are the next replay's inputs.

The kernel wrappers count the launches their Python calls make.  The
capture's calls launch nothing, so their counts are taken back, and
each replay adds the launches the capture recorded, through the
wrappers' module names, which a profile may swap for recording spies.

Every capture on a card allocates from one memory pool, so a batch's
capture reuses the blocks of the one before it; the last graph of each
card is held, never replayed again, to keep that pool alive.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

# the kernel wrappers of the package, by module: each counts its launches
# in ``<module>.<name>.launches``
_WRAPPERS = (
    ("scene_kernels", ("fused_nearest", "fused_occluded")),
    ("probe_kernels", ("select_scan", "select_blocks", "probe_pair", "probe_min",
                       "probe_blocks")),
    ("traverse_kernels", ("dense_tri_nearest",)),
    ("shade_kernels", ("fused_shade",)),
    ("regen_kernels", ("fused_regen",)),
)

# per card: (the capture stream, the pool's handle, the last graph captured)
_CARDS: dict = {}


def _wrappers():
    for mod, names in _WRAPPERS:
        m = importlib.import_module(f"wasm_pathtracer_tpu_torch.ops.{mod}")
        for name in names:
            yield m, name


def _counts() -> dict:
    # a stand-in put in a wrapper's place may keep no count
    return {(m, name): getattr(getattr(m, name), "launches", 0) for m, name in _wrappers()}


def registers_of(registers) -> list:
    """``[(dataclass, field name, value)]`` of every field of the
    dataclasses ``registers``."""
    return [(r, f.name, getattr(r, f.name)) for r in registers for f in dataclasses.fields(r)]


def copy_back(before: list):
    """Every register of ``before`` (:func:`registers_of`) that was
    rebound since is copied into the tensor it held then, and bound to it
    again; inside a capture, the graph's last copies."""
    held = {old.untyped_storage().data_ptr() for _, _, old in before if old is not None}
    dst, src = [], []
    for obj, name, old in before:
        new = getattr(obj, name)
        if new is old:
            continue
        if old is None or new is None or new.shape != old.shape or new.dtype != old.dtype:
            raise RuntimeError(f"the queue iteration changed the register {name}: a "
                               "captured iteration must keep each register's shape "
                               "and dtype")
        if new.untyped_storage().data_ptr() in held:
            new = new.clone()   # another register's old tensor: read before it is written
        dst.append(old)
        src.append(new)
        setattr(obj, name, old)
    for dtype in {x.dtype for x in dst}:   # one multi-tensor copy a dtype
        pairs = [(a, b) for a, b in zip(dst, src) if a.dtype == dtype]
        torch._foreach_copy_([a for a, _ in pairs], [b for _, b in pairs])


def capture(iteration, registers):
    """Capture ``iteration()``, which advances the dataclasses
    ``registers`` (tensor fields or None) on the card, into a graph, and
    return the function that replays it on the current stream and adds
    its launches to the wrappers' counts.  The capture launches nothing:
    the registers hold what they held before, and the first replay runs
    the iteration."""
    before = registers_of(registers)
    dev = next(x for _, _, x in before if x is not None).device
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _CARDS:
        with torch.cuda.device(key):
            _CARDS[key] = [torch.cuda.Stream(), torch.cuda.graph_pool_handle(), None]
    stream, pool, _ = _CARDS[key]
    counts = _counts()
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.device(key), torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            iteration()
            copy_back(before)
        except BaseException:
            for obj, name, old in before:
                setattr(obj, name, old)
            try:
                graph.capture_end()
            except RuntimeError:
                pass   # the capture the error broke; the error itself goes on
            raise
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    # the pool lives on in this graph until the card's next capture holds it
    _CARDS[key][2] = graph
    after = _counts()
    launched = {k: after[k] - counts[k] for k in counts if after[k] != counts[k]}
    for (m, name), n in launched.items():
        getattr(m, name).launches -= n

    def replay():
        graph.replay()
        for (m, name), n in launched.items():
            getattr(m, name).launches += n
    return replay
