"""Building and loading the hand-written CUDA kernels, and their launch counts.

Every kernel of the port is one CUDA C++ source under ``csrc/`` with a plain C
interface.  A kernel module declares its source once with :func:`register`
(the library name, the file, and the ``ctypes`` argument types of each
exported C function); :func:`build_kernels` compiles every declared source
not built yet with ``nvcc`` for ``sm_90a`` -- one process per source, all
started together -- into ``build/kernels/`` at the root of the checkout
(git-ignored, named by a hash of the source), and loads each with ``ctypes``.
Nothing is compiled or loaded when a module is imported.

:data:`LAUNCHES` is the one launch record of every kernel: a wrapper adds one
to its entry where it launches its kernel on the card, and nowhere else.
:func:`graph_kernel_launches` counts the kernels one call puts on the card,
and :func:`graph_kernel_nodes` the kernels of a captured CUDA graph by entry
name, which is how a replayed program's launches are counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

#: Kernel launches since the last :func:`reset_launches`, by library name.
LAUNCHES: dict[str, int] = {}

#: The compiler's output of each library built in this process.
BUILD_LOGS: dict[str, str] = {}

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES: dict[str, str] = {}
_EXPORTS: dict[str, dict[str, list]] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()

#: ctypes shorthands for the exported signatures.
PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


def register(name: str, source: str, exports: dict[str, list]) -> None:
    """Declare library ``name``: ``csrc/<source>`` exports the C functions in
    ``exports`` (function name -> ctypes argument types; each returns an
    ``int``, the CUDA error of its launch)."""
    _SOURCES[name] = source
    _EXPORTS[name] = dict(exports)
    LAUNCHES.setdefault(name, 0)


def source_constants(source: str, *names: str) -> list[int]:
    """The integer values of ``constexpr int NAME = <literal>;`` in
    ``csrc/<source>``, so that Python reads a kernel's layout constants from
    the one place they are set.  Reads text only: nothing is built."""
    text = (_CSRC / source).read_text()
    out = []
    for name in names:
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        if m is None:
            raise ValueError(f"{source} sets no constexpr int {name}")
        out.append(int(m.group(1)))
    return out


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found; the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = _CSRC / _SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return _repo_root() / "build" / "kernels" / f"lib{name}_{digest}.so"


def build_kernels(names=None) -> float:
    """Compile every named (default: every declared) library not built yet,
    one ``nvcc`` per source, all at once; load them.  Returns the wall
    seconds spent (0 when all were loaded already)."""
    names = list(names or _SOURCES)
    with _BUILD_LOCK:
        todo = [n for n in names if n not in _LIBS]
        if not todo:
            return 0.0
        t0 = time.perf_counter()
        procs = []
        for name in todo:
            out = _lib_path(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", str(tmp), str(_CSRC / _SOURCES[name]),
            ]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )))
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[name] = log.decode()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {_SOURCES[name]}:\n{BUILD_LOGS[name]}")
            os.replace(tmp, out)
        for name in todo:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _EXPORTS[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return time.perf_counter() - t0


def function(name: str, fn: str):
    """The loaded C function ``fn`` of library ``name`` (built on first use)."""
    if name not in _LIBS:
        build_kernels([name])
    return getattr(_LIBS[name], fn)


def check_launch(err: int, op: str) -> None:
    if err:
        raise RuntimeError(f"{op} kernel launch failed with CUDA error {err}")


#: ``CU_GRAPH_NODE_TYPE_KERNEL`` of ``cuda.h``.
_KERNEL_NODE = 0


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h``."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _kernel_nodes(libcuda, graph) -> list[ctypes.c_void_p]:
    """The kernel nodes of ``graph``, a ``torch.cuda.CUDAGraph`` captured
    with ``keep_graph=True`` (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _check_cu(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check_cu(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    kind = ctypes.c_int(0)
    for node in nodes:
        node = ctypes.c_void_p(node)
        _check_cu(libcuda.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value == _KERNEL_NODE:
            out.append(node)
    return out


def _function_name(libcuda, node: ctypes.c_void_p) -> str:
    """The mangled name of a kernel node's function (``cuFuncGetName``)."""
    params = _KernelNodeParams()
    _check_cu(libcuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
              "cuGraphKernelNodeGetParams_v2")
    func = ctypes.c_void_p(params.func)
    if not func.value:
        _check_cu(libcuda.cuKernelGetFunction(ctypes.byref(func), ctypes.c_void_p(params.kern)),
                  "cuKernelGetFunction")
    name = ctypes.c_char_p()
    _check_cu(libcuda.cuFuncGetName(ctypes.byref(name), func), "cuFuncGetName")
    return name.value.decode()


def graph_kernel_nodes(graph, entries) -> dict[str, int]:
    """Kernel nodes of a captured CUDA graph (``torch.cuda.CUDAGraph`` made
    with ``keep_graph=True``) whose function is each of ``entries`` (kernel
    entry names of ``csrc/``, such as ``"row_sort_kernel"``), and under
    ``"all"`` every kernel node.  A replay of the graph launches exactly
    these, so replays times this count is what the card ran; the Python
    counts of :data:`LAUNCHES` tick only while the graph is captured."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    return count_entries([_function_name(libcuda, node) for node in _kernel_nodes(libcuda, graph)], entries)


def count_entries(names: list[str], entries) -> dict[str, int]:
    """How many of the mangled kernel ``names`` are each of ``entries``, and
    under ``"all"`` how many names there are.  Itanium mangling writes an
    identifier as its length, then its letters, so ``flash_fwd`` is
    ``9flash_fwd`` and never matches ``14flash_fwd_bf16``."""
    out = {e: sum(f"{len(e)}{e}" in n for n in names) for e in entries}
    out["all"] = len(names)
    return out


def capture(fn, device=None):
    """Capture one call of ``fn()`` into a CUDA graph: torch's recipe runs
    ``fn`` once on a side stream first (a real call: the kernels it uses are
    built and loaded, and cuBLAS and the allocator set up, outside the
    capture), then captures a second call (which runs nothing) and
    instantiates the graph.  Returns ``(graph, outputs of the captured
    call)``; the graph keeps its ``cudaGraph_t`` for
    :func:`graph_kernel_nodes`.  A failed capture raises."""
    import torch

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    graph.instantiate()
    return graph, out


def graph_kernel_launches(fn) -> int:
    """Kernels that one call of ``fn()`` launches on the card: the call is
    captured into a CUDA graph (:func:`capture`) and the graph's kernel
    nodes are counted (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    graph, _ = capture(fn)
    kernels = len(_kernel_nodes(ctypes.CDLL("libcuda.so.1"), graph))
    graph.reset()
    return kernels


def _check_cu(err: int, call: str) -> None:
    if err:
        raise RuntimeError(f"{call} returned CUresult {err}")
