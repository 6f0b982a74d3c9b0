"""A tally of the port's own program: FLOPs, bytes, collective wire bytes
and peak memory of one traced run on one rank; the counterpart of
`repro.launch.hlo_stats`, which reads the same quantities from XLA's
compiled HLO text.

`OpStats` is a context manager.  While it is open it sees every ATen op
the program dispatches (a `TorchDispatchMode`), every kernel scope of
`repro_torch.kernels` (`kernels.scope`) and every collective called
through `torch.distributed` (a shim over its functions, restored on exit):

  * **flops** — `torch.utils.flop_counter`'s formulas (matmul, bmm,
    convolution) for the ops dispatched, and inside a kernel's scope the
    kernel's own FLOPs (its wrapper's ``work()``) in place of the ops its
    plain version dispatches there.
  * **bytes** — each tensor argument read once and each tensor result
    written once, for every op that moves data; views, metadata and
    allocations are free, as `hlo_stats._FREE_OPS` is for HLO, and an
    in-place update of part of a tensor (``index_copy_``, ``index_put_``,
    a scatter) moves its indices and values read and its values written.  Inside a
    kernel's scope, the kernel's ``work()`` bytes.  A collective also
    reads its payload once.
  * **bytes_kernel_interior** / **flops_kernel_interior** — the part of
    bytes / flops counted inside kernel scopes, as `hlo_stats` reports the
    bytes inside its ``kscope_`` regions; **scopes** — the calls of each
    kernel; **kernel_bound_s** — the sum over those calls of each call's
    least time on the card (the larger of its bytes at the memory rate and
    its FLOPs at the peak of its arithmetic).  Where the tensors are off
    the card (on the ``meta`` device or the CPU) the wrappers run their
    plain versions inside the scopes; the tally leaves those ops out.
  * **wire_bytes** — for each collective the bytes this rank puts on the
    wire, `hlo_stats._wire_factor`'s ring model: all-reduce 2(n−1)/n of
    the tensor, all-gather / reduce-scatter / all-to-all / broadcast
    (n−1)/n of the whole (gathered or unscattered) tensor, a send the
    tensor (a receive sends nothing); by kind (``coll_<kind>``) and by
    mesh axis (``wire_bytes_by_axis``: the axis whose group the call
    used, "world" for the default group), and **n_collectives**.  DTensor's
    functional collectives, which are dispatched ops, are counted the same
    way from their arguments.
  * **peak_bytes** — the high-water mark of the bytes of the storages the
    run allocated and still holds, each released through a weak reference
    when its last tensor dies.  Inside a kernel's scope only what outlives
    the scope counts (the kernel's outputs), not the plain version's
    temporaries.

Counts are of this rank: a traced step on a fake group's rank 0
(`launch.mesh`) is a device's share of the cell.
"""

from __future__ import annotations

import inspect
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import scope as kernel_scope
from .roofline import H100_SXM, Hardware

_aten = torch.ops.aten

# Ops that move no bytes (besides views, which `OpOverload.is_view` names).
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten.detach, _aten.alias, _aten._unsafe_view,
         _aten.lift_fresh, _aten.set_, _aten.resize_, _aten.sym_size, _aten.sym_stride,
         _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size,
         _aten._local_scalar_dense, _aten.record_stream}
# In-place updates of part of their first argument: they move the
# indices and values read and the values written, not the whole tensor
# (`hlo_stats._op_traffic`'s dynamic-update-slice and scatter).
_UPDATES = {_aten.index_copy_, _aten.index_put_, _aten._index_put_impl_, _aten.index_add_,
            _aten.scatter_, _aten.scatter_add_, _aten.scatter_reduce_}
# Namespaces of ops the shim counts (the dist API's own dispatched ops).
_SHIM_NAMESPACES = {"c10d"}


def _wire_factor(kind: str, n: int) -> float:
    """`hlo_stats._wire_factor`, with a send as a collective-permute."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "collective-permute":
        return 1.0
    return (n - 1) / n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Mode(TorchDispatchMode):
    def __init__(self, tally: "OpStats"):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tally._op(func, args, kwargs, out)
        return out


class OpStats:
    """The tally of one run; open it around the run (``with OpStats(mesh)
    as t: step(...)``), then read `row()`.  ``mesh`` names the axes of the
    collectives' groups."""

    def __init__(self, mesh=None, hw: Hardware = H100_SXM):
        self.mesh, self.hw = mesh, hw
        self.flops = 0
        self.bytes = 0
        self.flops_kernel_interior = 0
        self.bytes_kernel_interior = 0
        self.kernel_bound_s = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.wire_by_axis: Dict[str, float] = {}
        self.coll: Dict[str, float] = {}
        self.n_collectives = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, Any] = {}
        self._pending = []       # allocations inside the open kernel scope
        self._depth = 0          # kernel scopes entered
        self._paused = 0         # > 0 while a kernel's work is evaluated
        self._in_shim = 0        # > 0 inside a shimmed collective
        self._open = False
        self._axes = self._axis_names(mesh)
        self._patched: Dict[Any, Dict[str, Any]] = {}
        self._mode: Optional[_Mode] = None
        self._listener_before = None
        from ..parallel.comm import is_dtensor
        self._is_dtensor = is_dtensor

    # ----------------------------------------------------------- lifetime --
    def __enter__(self):
        self._open = True
        self._listener_before = kernel_scope.set_listener(self)
        self._patch()
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            self._unpatch()
            kernel_scope.set_listener(self._listener_before)
            self._open = False
            self._storages.clear()
        return False

    # -------------------------------------------------------------- scopes --
    def enter(self, name: str, work, peak: str) -> None:
        self._depth += 1
        if self._depth > 1:
            return
        self._paused += 1
        try:
            flops, nbytes = work()
        finally:
            self._paused -= 1
        bound = max(nbytes / self.hw.hbm_bw, flops / self.hw.peak(peak))
        self.flops += flops
        self.bytes += nbytes
        self.flops_kernel_interior += flops
        self.bytes_kernel_interior += nbytes
        self.kernel_bound_s += bound
        k = self.kernels.setdefault(name, {"scopes": 0, "flops": 0, "bytes": 0, "bound_s": 0.0})
        k["scopes"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        k["bound_s"] += bound

    def exit(self, name: str) -> None:
        self._depth -= 1
        if self._depth:
            return
        # What the scope allocated and still holds is the kernel's output;
        # the plain version's temporaries are gone.
        pending, self._pending = self._pending, []
        for key, ref, size in pending:
            if ref() is not None:
                self._allocated(key, ref(), size)

    # ----------------------------------------------------------------- ops --
    def _local(self, x):
        return x._local_tensor if self._is_dtensor(x) else x

    def _op(self, func, args, kwargs, out) -> None:
        if self._paused:
            return
        namespace = func.namespace
        if namespace in _SHIM_NAMESPACES:
            return
        ins = [self._local(t) for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [self._local(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self._track(func, ins, outs)
        if namespace == "_c10d_functional":
            if not self._depth:
                self._functional_collective(func, args, kwargs, ins, outs)
            return
        packet = func._overloadpacket
        if self._depth:
            return
        if packet in _UPDATES:
            self.bytes += sum(map(_nbytes, ins[1:])) + _nbytes(ins[-1])
        elif packet not in _FREE and not func.is_view:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        formula = _FLOP_FORMULAS.get(packet)
        if formula is not None:
            local_args, local_kwargs, local_out = _locals((args, kwargs, out), self._local)
            self.flops += int(formula(*local_args, **local_kwargs, out_val=local_out))

    def _track(self, func, ins, outs) -> None:
        """Count each result whose storage no argument shares as allocated
        now; release it when its storage dies."""
        if not outs or func.is_view:
            return
        shared = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in shared or key in self._storages:
                continue
            if self._depth:
                self._pending.append((key, weakref.ref(storage), storage.nbytes()))
            else:
                self._allocated(key, storage, storage.nbytes())

    def _allocated(self, key: int, storage, size: int) -> None:
        self.live += size
        if self.live > self.peak:
            self.peak = self.live
        self._storages[key] = weakref.ref(storage, self._release(key, size))

    def _release(self, key: int, size: int):
        def release(_):
            if self._open and self._storages.pop(key, None) is not None:
                self.live -= size
        return release

    # --------------------------------------------------------- collectives --
    @staticmethod
    def _axis_names(mesh) -> Dict[str, str]:
        if mesh is None:
            return {}
        names = {}
        for k, name in enumerate(mesh.mesh_dim_names):
            group = mesh.get_group(k)
            names.setdefault(group.group_name, name)
        return names

    def _axis(self, group) -> str:
        if group is None:
            return "world"
        if isinstance(group, str):
            return self._axes.get(group, group)
        return self._axes.get(group.group_name, "world" if group == dist.group.WORLD
                              else group.group_name)

    def _collective(self, kind: str, payload: int, n: int, axis: str) -> None:
        wire = payload * _wire_factor(kind, n)
        self.wire_by_axis[axis] = self.wire_by_axis.get(axis, 0.0) + wire
        self.coll[kind] = self.coll.get(kind, 0.0) + wire
        self.n_collectives += 1
        self.bytes += payload

    def _functional_collective(self, func, args, kwargs, ins, outs) -> None:
        name = func._overloadpacket.__name__
        kinds = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor":
                 "reduce-scatter", "all_reduce": "all-reduce", "all_to_all_single":
                 "all-to-all", "broadcast": "broadcast"}
        kind = kinds.get(name)
        if kind is None:                      # wait_tensor and the like
            return
        group_name = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
        n = dist.get_world_size(dist.distributed_c10d._resolve_process_group(group_name))
        whole = outs[0] if kind == "all-gather" else ins[0]
        self._collective(kind, _nbytes(whole), n, self._axis(group_name))

    def _patch(self) -> None:
        c10d = dist.distributed_c10d
        specs = {
            "all_gather": ("all-gather", lambda a: _nbytes(a["tensor"]) * len(a["tensor_list"])),
            "all_gather_into_tensor": ("all-gather", lambda a: _nbytes(a["output_tensor"])),
            "reduce_scatter_tensor": ("reduce-scatter", lambda a: _nbytes(a["input"])),
            "all_reduce": ("all-reduce", lambda a: _nbytes(a["tensor"])),
            "all_to_all_single": ("all-to-all", lambda a: _nbytes(a["input"])),
            "broadcast": ("broadcast", lambda a: _nbytes(a["tensor"])),
            "send": ("collective-permute", lambda a: _nbytes(a["tensor"])),
            "isend": ("collective-permute", lambda a: _nbytes(a["tensor"])),
            "recv": (None, None),
            "irecv": (None, None),
        }
        for name, (kind, payload) in specs.items():
            original = getattr(dist, name)
            wrapper = self._wrap(original, kind, payload)
            self._patched[name] = {"dist": original, "c10d": getattr(c10d, name, None)}
            setattr(dist, name, wrapper)
            if self._patched[name]["c10d"] is original:
                # `P2POp` and `batch_isend_irecv` compare an op with these,
                # and the batch calls each op: the wrappers count it there.
                setattr(c10d, name, wrapper)

    def _wrap(self, original, kind, payload):
        signature = inspect.signature(original)

        def wrapper(*args, **kwargs):
            if kind is not None and not self._in_shim:
                bound = signature.bind(*args, **kwargs)
                bound.apply_defaults()
                a = bound.arguments
                group = a.get("group")
                n = dist.get_world_size(group) if kind != "collective-permute" else 2
                self._collective(kind, payload(a), n, self._axis(group))
            self._in_shim += 1
            try:
                return original(*args, **kwargs)
            finally:
                self._in_shim -= 1
        wrapper.__wrapped__ = original
        wrapper.__name__ = original.__name__
        return wrapper

    def _unpatch(self) -> None:
        c10d = dist.distributed_c10d
        for name, saved in self._patched.items():
            setattr(dist, name, saved["dist"])
            if saved["c10d"] is not None:
                setattr(c10d, name, saved["c10d"])
        self._patched.clear()

    # ---------------------------------------------------------------- row --
    def row(self) -> Dict[str, Any]:
        out = {"flops": float(self.flops), "bytes": float(self.bytes),
               "flops_kernel_interior": float(self.flops_kernel_interior),
               "bytes_kernel_interior": float(self.bytes_kernel_interior),
               "kernel_bound_s": self.kernel_bound_s,
               "scopes": {k: int(v["scopes"]) for k, v in sorted(self.kernels.items())},
               "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
               "wire_bytes": float(sum(self.wire_by_axis.values())),
               "wire_bytes_by_axis": dict(self.wire_by_axis),
               "n_collectives": float(self.n_collectives),
               "peak_bytes": float(self.peak)}
        for kind, v in self.coll.items():
            out[f"coll_{kind}"] = v
        return out


def _flop_formulas():
    from torch.utils.flop_counter import flop_registry
    return dict(flop_registry)


_FLOP_FORMULAS = _flop_formulas()


def _locals(tree, local):
    from torch.utils._pytree import tree_map
    return tree_map(local, tree)
