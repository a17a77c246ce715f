"""The session's step replayed from CUDA graphs, one per stage span.

On the card the fused step makes ~2,900 launches a frame, and the host's
enqueue of them, not the device, sets a frame's pace. A session whose step
can be captured (`graphed_ok`: a CUDA device, the fused rule of
`pipeline/kinfu.py::fused_supported`, neither relocalization nor the pose
graph) runs it through
`GraphedStep`:

  - the state the step reads is the state it writes: after each frame the
    state tensors that the step returned as new tensors are copied into the
    caller's own (`copy_state_`), which so keep their device addresses
    from frame to frame, and `reset_state_` resets them in place; the
    session uploads each frame into input buffers allocated once;
  - the first WARM_FRAMES frames run eagerly on a side stream: they build
    the per-configuration constants, the kernel library and that stream's
    library handles;
  - the next frame captures the step on that stream, cut at its spans
    (`kinfu.step.frontend`, `.icp`, `.shift`, `.integrate`, `.raycast`,
    `.reset`) into segments, the glue between them in segments of its
    own, one CUDA graph each, all in one memory pool;
  - that frame and every later one replay the segments in order on the
    current stream, each stage's inside the span it was cut from, so that
    a trace still ties each stage's kernels to its span, the glue's to the
    caller's; `kernels.LAUNCHES` adds each segment's launches, counted
    while it was captured.

The captured code is the eager step's own: the graphs change how it
reaches the card, not what it computes. A capture that holds a copy from
the host (a constant built inside the frame, whose pinned buffer every
replay would read after it is freed) raises; so does a host sync inside
the step. A state or an input whose tensors are not those of the capture
(a caller replaced them) drops the graphs, and the frame captures anew.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import warnings
from typing import List, NamedTuple, Optional

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.ops import kernels
from kinfu_tpu_torch.pipeline.kinfu import fused_supported
from kinfu_tpu_torch.utils.profiling import Cuts, cut_at_spans, span

#: frames a session runs eagerly before it captures its step
WARM_FRAMES = 2


def graphed_ok(device, vol_shape, params: KinFuParams, relocalize: bool,
               pose_graph: bool) -> bool:
    """True when a session's step is captured: a CUDA device, a volume of
    `vol_shape` (Z, Y, X) under the fused rule (`fused_supported`), and neither
    relocalization nor the pose graph (whose frames run other steps)."""
    return (torch.device(device).type == "cuda"
            and fused_supported(tuple(vol_shape), params, device)
            and not relocalize and not pose_graph)


def state_tensors(state) -> List[torch.Tensor]:
    """The tensors of a state (`KinFuState`, `StreamingState`, named tuples
    and tuples of tensors), in field order."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for part in state for t in state_tensors(part)]


def copy_state_(dst, src) -> None:
    """Copy each tensor of state `src` into the same field of `dst`, in
    place, where the two are not already the same memory."""
    for d, s in zip(state_tensors(dst), state_tensors(src), strict=True):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)


def reset_state_(state) -> None:
    """Reset a `KinFuState` or `StreamingState` in place to what
    `init_state` (`init_streaming_state`) makes: an empty volume, the
    identity pose, zero model maps, frame count 1, the grid at its
    configured origin."""
    streaming = hasattr(state, "origin_vox")
    ks = state.kinfu if streaming else state
    for t in (*ks.vol, ks.pose.R, ks.pose.t, *ks.model_vmaps, *ks.model_nmaps):
        t.zero_()
    ks.pose.R.diagonal().fill_(1.0)
    ks.frame_count.fill_(1)
    if streaming:
        state.origin_vox.zero_()


def step_in_place(step, state, depth: torch.Tensor, color: torch.Tensor):
    """`step(state, depth, color)` with the new state copied into `state`:
    returns (state, the step's output)."""
    new, out = step(state, depth, color)
    copy_state_(state, new)
    return state, out


# ---- the captured graph's nodes, through libcuda -----------------------------

_NODE_MEMCPY = 1  # CU_GRAPH_NODE_TYPE_MEMCPY
_MEM_HOST, _MEM_DEVICE, _MEM_UNIFIED = 1, 2, 4  # CUmemorytype
_POINTER_MEMORY_TYPE = 2  # CU_POINTER_ATTRIBUTE_MEMORY_TYPE


class _Memcpy3D(ctypes.Structure):
    """CUDA_MEMCPY3D (cuda.h)."""

    _fields_ = [(f"src{k}", t) for k, t in (
        ("XInBytes", ctypes.c_size_t), ("Y", ctypes.c_size_t), ("Z", ctypes.c_size_t),
        ("LOD", ctypes.c_size_t), ("MemoryType", ctypes.c_int), ("Host", ctypes.c_void_p),
        ("Device", ctypes.c_ulonglong), ("Array", ctypes.c_void_p),
        ("Reserved", ctypes.c_void_p), ("Pitch", ctypes.c_size_t),
        ("Height", ctypes.c_size_t))]
    _fields_ += [("dst" + name[3:], t) for name, t in _fields_]
    _fields_ += [("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
                 ("Depth", ctypes.c_size_t)]


_P = ctypes.c_void_p
_REF = ctypes.POINTER
#: libcuda's entry points used here: name -> argtypes (each returns a CUresult)
_SIGNATURES = {
    "cuStreamGetCaptureInfo_v2": [_P, _REF(ctypes.c_int), _REF(ctypes.c_ulonglong), _REF(_P),
                                  _REF(_P), _REF(ctypes.c_size_t)],
    "cuGraphGetNodes": [_P, _P, _REF(ctypes.c_size_t)],
    "cuGraphNodeGetType": [_P, _REF(ctypes.c_int)],
    "cuGraphMemcpyNodeGetParams": [_P, _REF(_Memcpy3D)],
    "cuPointerGetAttribute": [_REF(ctypes.c_uint), ctypes.c_int, ctypes.c_ulonglong],
}


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _cu(name: str, *args) -> None:
    err = getattr(_libcuda(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUresult {err}")


def _from_host(node: int) -> bool:
    """Whether a memcpy node copies from host memory."""
    p = _Memcpy3D()
    _cu("cuGraphMemcpyNodeGetParams", node, ctypes.byref(p))
    if p.srcMemoryType != _MEM_UNIFIED:
        return p.srcMemoryType == _MEM_HOST
    kind = ctypes.c_uint()
    err = _libcuda().cuPointerGetAttribute(ctypes.byref(kind), _POINTER_MEMORY_TYPE,
                                          p.srcDevice)
    return err != 0 or kind.value != _MEM_DEVICE


def captured_nodes(stream: torch.cuda.Stream):
    """(nodes, copies from the host among them) of the graph that `stream`
    is capturing."""
    status, cid = ctypes.c_int(), ctypes.c_ulonglong()
    graph, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    _cu("cuStreamGetCaptureInfo_v2", stream.cuda_stream, ctypes.byref(status),
        ctypes.byref(cid), ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps))
    n = ctypes.c_size_t()
    _cu("cuGraphGetNodes", graph, None, ctypes.byref(n))
    if n.value == 0:
        return 0, 0
    nodes = (ctypes.c_void_p * n.value)()
    _cu("cuGraphGetNodes", graph, ctypes.cast(nodes, ctypes.c_void_p), ctypes.byref(n))
    from_host = 0
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        _cu("cuGraphNodeGetType", node, ctypes.byref(kind))
        from_host += kind.value == _NODE_MEMCPY and _from_host(node)
    return n.value, from_host


# ---- capture and replay ---------------------------------------------------


class Segment(NamedTuple):
    #: the span it replays under; None: the glue, under the caller's span
    name: Optional[str]
    graph: torch.cuda.CUDAGraph
    #: kernel launches counted while it was captured, by kernel
    launches: collections.Counter
    #: its graph's nodes
    nodes: int


class _Capture(Cuts):
    """Captures the work on the current stream into one CUDA graph a span
    and one for the glue before, between and after them, in one pool.
    Empty ones are not segments, but are kept in `graphs` with the others:
    the pool lives only as long as every graph captured into it."""

    def __init__(self, pool):
        super().__init__()
        self.pool = pool
        self.segments: List[Segment] = []
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self._graph = None
        self._open(None)

    def _open(self, name: Optional[str]) -> None:
        self._name = name
        self._launches = collections.Counter(kernels.LAUNCHES)
        self._graph = torch.cuda.CUDAGraph()
        self.graphs.append(self._graph)
        self._graph.capture_begin(pool=self.pool)

    def close(self) -> None:
        """End the open capture (no-op when none is open)."""
        graph, self._graph = self._graph, None
        if graph is None:
            return
        try:
            nodes, from_host = captured_nodes(torch.cuda.current_stream())
        finally:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
                graph.capture_end()
        if from_host:
            raise RuntimeError(f"the captured step copies from the host {from_host} times in "
                               f"{self._name or 'the glue'}: a constant is built inside the "
                               f"frame")
        if nodes:
            launches = collections.Counter(kernels.LAUNCHES)
            launches.subtract(self._launches)
            self.segments.append(Segment(self._name, graph, +launches, nodes))

    def enter(self, name: str) -> None:
        super().enter(name)
        self.close()
        self._open(name)

    def leave(self, name: str) -> None:
        self.close()
        self._open(None)


class GraphedStep:
    """`step(state, depth, color)` -> (state, out) with the new state copied
    into the one given (`step_in_place`): eagerly for WARM_FRAMES frames,
    then replayed from the CUDA graphs of one capture (the module's
    docstring). The output tensors of a replayed frame are the same
    tensors every frame."""

    def __init__(self, step):
        self.step = step
        self.frames = 0
        self.segments: Optional[List[Segment]] = None
        self._graphs = self._out = None
        self._held = None
        self._side = None

    @staticmethod
    def _addresses(state, depth, color) -> tuple:
        return tuple(t.data_ptr() for t in (*state_tensors(state), depth, color))

    def __call__(self, state, depth: torch.Tensor, color: torch.Tensor):
        self.frames += 1
        if self.segments is not None and self._addresses(state, depth, color) != self._held:
            self.segments = self._graphs = self._out = None
        if self.segments is None:
            if self._side is None:
                self._side = torch.cuda.Stream(depth.device)
            if self.frames <= WARM_FRAMES:
                return self._eager(state, depth, color)
            self._capture(state, depth, color)
        for seg in self.segments:
            if seg.name is None:
                seg.graph.replay()
            else:
                with span(seg.name):
                    seg.graph.replay()
            kernels.LAUNCHES.update(seg.launches)
        return state, self._out

    def _eager(self, state, depth, color):
        cur = torch.cuda.current_stream(depth.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            res = step_in_place(self.step, state, depth, color)
        cur.wait_stream(self._side)
        return res

    def _capture(self, state, depth, color) -> None:
        counts = collections.Counter(kernels.LAUNCHES)
        torch.cuda.synchronize(depth.device)
        with torch.cuda.device(depth.device), torch.cuda.stream(self._side):
            cap = _Capture(torch.cuda.graph_pool_handle())
            try:
                with cut_at_spans(cap):
                    _, out = step_in_place(self.step, state, depth, color)
            finally:
                cap.close()
                kernels.LAUNCHES.clear()
                kernels.LAUNCHES.update(counts)
        self.segments, self._graphs, self._out = cap.segments, cap.graphs, out
        self._held = self._addresses(state, depth, color)
