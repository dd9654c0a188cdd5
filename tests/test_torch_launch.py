"""The port's one launch seam, ``ops/_build.py``'s :func:`launch`, on the CPU.

A stub library stands in for :func:`load_kernels` and stubs of
``torch.cuda`` for the card's device, stream and graph calls, so the seam's
checks, errors and launch counts run here: an error code raises naming the
kernel and CUDA's string, launches are counted by kernel name, and launches
made while a graph is captured count only at its replays, through the
exact loop's graph runner (``cluster/ward.py:_run_graphed``). The ABI table
:data:`KERNELS` is held against the C signatures in ``csrc/*.cu``.
"""

import contextlib
import ctypes
import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from imageclust_tpu_torch.cluster import ward
from imageclust_tpu_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
ERROR = b"an illegal memory access was encountered"


class StubLib:
    """Every entry point of :data:`KERNELS`: records its arguments and
    returns ``rc``."""

    def __init__(self):
        self.rc = 0
        self.calls = []
        for symbol, _ in _build.KERNELS.values():
            setattr(self, symbol, self._entry(symbol))

    def _entry(self, symbol):
        def call(*args):
            self.calls.append((symbol, args))
            return self.rc
        return call

    def ic_cuda_error_string(self, rc):
        return ERROR


class StubCuda:
    """The ``torch.cuda`` calls of the seam and the graph runner; a graph
    captures by running its steps once and replays by running nothing."""

    def __init__(self):
        self.capturing = False
        self.replays = 0

    def stream(self, *args):
        return type("Stream", (), {"cuda_stream": 7,
                                   "wait_stream": lambda s, o: None})()

    @contextlib.contextmanager
    def graph(self, g, capture_error_mode=None):
        self.capturing = True
        try:
            yield
        finally:
            self.capturing = False

    def install(self, monkeypatch):
        cuda = torch.cuda
        outer = self

        class Graph:
            def replay(self):
                outer.replays += 1

        monkeypatch.setattr(cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(cuda, "current_stream", self.stream)
        monkeypatch.setattr(cuda, "Stream", self.stream)
        monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(cuda, "is_current_stream_capturing",
                            lambda: self.capturing)
        monkeypatch.setattr(cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(cuda, "graph", self.graph)


@pytest.fixture
def stub(monkeypatch):
    lib = StubLib()
    cuda = StubCuda()
    cuda.install(monkeypatch)
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "launches", Counter())
    monkeypatch.setattr(_build, "captured", Counter())
    return lib, cuda


def _aligned():
    return torch.zeros(8, dtype=torch.float32)


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_launch_calls_its_entry_point_on_the_current_stream(stub, name):
    lib, _ = stub
    _build.launch(name, "cuda:0", (_aligned(),), 1, 2)
    assert lib.calls == [(_build.KERNELS[name][0], (1, 2, 7))]
    assert _build.launches == Counter({name: 1})


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_error_code_raises_naming_kernel_and_cuda_string(stub, name):
    lib, _ = stub
    lib.rc = 700
    with pytest.raises(RuntimeError) as err:
        _build.launch(name, "cuda:0", ())
    assert str(err.value) == (f"{name} launch failed: {ERROR.decode()} "
                              f"(700)")
    assert not _build.launches and not _build.captured


def test_misaligned_operand_raises_before_the_call(stub):
    lib, _ = stub
    misaligned = torch.zeros(8, dtype=torch.float32)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.launch("bn_act", "cuda:0", (_aligned(), misaligned))
    assert lib.calls == [] and not _build.launches


def test_launches_are_counted_by_kernel(stub):
    for name, times in (("merge_update_argmin", 3), ("bn_act", 2),
                        ("pref_topk_block", 1)):
        for _ in range(times):
            _build.launch(name, "cuda:0", ())
    assert _build.launches == Counter(
        {"merge_update_argmin": 3, "bn_act": 2, "pref_topk_block": 1})
    assert not _build.captured


def test_captured_launches_are_kept_apart_and_added_per_replay(stub):
    _, cuda = stub
    cuda.capturing = True
    for name in ("merge_update_argmin", "merge_update_argmin_batched",
                 "merge_update_argmin_batched"):
        _build.launch(name, "cuda:0", ())
    cuda.capturing = False
    assert not _build.launches
    per_replay = _build.captured.copy()
    for _ in range(3):
        _build.count_replay(per_replay)
    assert _build.launches == Counter(
        {"merge_update_argmin": 3, "merge_update_argmin_batched": 6})


def test_graph_runner_counts_whatever_kernels_it_captured(stub):
    """One eager step, a capture of FOUND_READ_EVERY steps, then replays
    until ``go`` reads false: each kernel of the step counts once for the
    eager step and FOUND_READ_EVERY times a replay."""
    _, cuda = stub
    replays = 3

    def body():
        _build.launch("merge_update_argmin", "cuda:0", ())
        _build.launch("short_seq_attention", "cuda:0", ())

    k = ward.FOUND_READ_EVERY
    graph = ward._run_graphed(body, "cuda:0", _StopAfter(cuda, replays),
                              limit=10 * k)
    assert cuda.replays == replays
    assert graph.per_replay == Counter(
        {"merge_update_argmin": k, "short_seq_attention": k})
    assert _build.captured == graph.per_replay
    assert _build.launches == Counter(
        {"merge_update_argmin": 1 + replays * k,
         "short_seq_attention": 1 + replays * k})
    # a second run replays the same graph from its first step
    ward._run_graphed(body, "cuda:0", _StopAfter(cuda, replays + 1),
                      limit=10 * k, graph=graph)
    assert _build.launches["merge_update_argmin"] == 1 + (replays + 1) * k


class _StopAfter:
    """A ``go`` flag that reads false once the stub graph has been replayed
    ``n`` times (a replayed step would have written it)."""

    def __init__(self, cuda, n):
        self.cuda, self.n = cuda, n

    def __bool__(self):
        return self.cuda.replays < self.n


_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong}


def _c_signatures():
    out = {}
    for src in CSRC.glob("*.cu"):
        for m in re.finditer(r"\bint (ic_\w+)\(([^)]*)\)\s*\{",
                             src.read_text()):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            out[m.group(1)] = [
                ctypes.c_void_p if "*" in p
                else _CTYPES[p.rsplit(" ", 1)[0]] for p in params if p]
    return out


def test_abi_table_matches_the_c_sources():
    sigs = _c_signatures()

    class Fn:
        pass

    class Lib:
        def __getattr__(self, symbol):
            fn = Fn()
            setattr(self, symbol, fn)
            return fn

    lib = _build._bind(Lib())
    for name, (symbol, _) in _build.KERNELS.items():
        fn = getattr(lib, symbol)
        assert fn.argtypes == sigs[symbol], name
        assert fn.argtypes[-1] is ctypes.c_void_p  # the stream
        assert fn.restype is ctypes.c_int
