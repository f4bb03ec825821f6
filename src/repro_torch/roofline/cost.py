"""The roofline's three inputs counted per rank on any device, the port of
``repro.roofline.hlo_cost`` and ``repro.roofline.hlo``.

The reference reads them from XLA's optimized HLO text: dot and
convolution FLOPs weighted by while-loop trip counts, the operand and
result bytes of every top-level instruction, and the payloads of the
collectives.  PyTorch runs eagerly, so :class:`CostMode` (a
``TorchDispatchMode``) sees every ATen op as it runs, on ``meta`` tensors
(the dry run, ``launch.dryrun``) as on the card:

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention), kept by the dtype of the op's first operand,
  after the same decomposition attempt as ``FlopCounterMode``, so the two
  count the same ops.  A recompute under ``torch.utils.checkpoint`` runs,
  so it is counted, as the reference's trip-corrected count counts it.
* **Bytes**: operands plus results of every ATen op; views, allocations
  (``empty*``) and collectives are free.  A kernel of the port stands in
  for its launch with its own bytes (``kernels.gspn_scan.launch_cost``):
  on ``meta`` the wrappers record the launch (``cuda_lib.meta_launches``)
  instead of running it, and the record is charged.  This is an eager
  upper bound, as ``hlo_cost.analyze``'s is before fusion; the
  reference's fusion-calibrated ``bytes_hbm_calibrated`` has no
  counterpart.
* **Collective bytes** by op, with the reference's ring multipliers,
  from the port's counted collectives (``parallel.collectives.link_bytes``)
  plus any the caller adds (:meth:`CostMode.add_collective`: the dry run's
  data-axis gathers and reductions, which FSDP2 would run and cannot on
  ``meta``).
* **Peak**: the largest sum of live storages the mode sees, those given
  at entry (``resident``: parameters, optimizer state, the batch) and
  those the ops make, each until its last reference dies.  It stands in
  for XLA's ``memory_analysis()``.

``op_census`` counts the products, convolutions, attention calls and
kernel records.  Nothing here imports the package's models: the mode is
usable around any callable.
"""

from __future__ import annotations

import collections

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cuda_lib
from repro_torch.parallel import collectives

aten = torch.ops.aten

# Queries of a tensor's layout, which FlopCounterMode leaves alone too.
_QUERIES = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default}
# Ops that move no bytes: allocations.
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "lift_fresh"}
_CENSUS = {"mm": "dot", "addmm": "dot", "bmm": "dot", "baddbmm": "dot",
           "convolution": "convolution", "convolution_backward":
           "convolution"}
# The share of the peak that the sum of tracked storages may exceed it by
# before the dead ones are purged and the sum read: the peak may be low
# by at most this share.
_SLACK = 0.005


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _flat(args, kwargs):
    """The tensors among an op's arguments: ATen ops take tensors alone
    or in one list (``cat``, ``stack``, ``index``); a cheaper walk than
    ``tree_flatten`` for the one call a dispatch makes."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_INFO: dict = {}


def _op_info(func) -> tuple:
    """(has a composite kernel to decompose by, its FLOP formula or None,
    its census key or None, whether it moves bytes) of an ATen op."""
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    composite = func is not torch.ops.prim.device.default and (
        dk in func.py_kernels
        or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk))
    packet = func._overloadpacket
    name = packet.__name__.split(".")[-1]
    census = _CENSUS.get(name, "attention" if "attention" in name else None)
    moves = not (func.is_view or name in _ALLOC
                 or func.namespace not in ("aten", "prims"))
    return composite, flop_registry.get(packet), census, moves


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class CostMode(TorchDispatchMode):
    """Count FLOPs by dtype, bytes, collective bytes, the op census and
    the peak of live storages over everything run inside ``with
    CostMode(resident=...)``.  :meth:`result` returns them as the dry
    run's record keys."""

    def __init__(self, *, resident=()):
        super().__init__()
        self.flops = collections.Counter()
        self.bytes = 0
        self.census = collections.Counter()
        self.kernels = collections.Counter()
        self.extra_coll = collections.Counter()
        self.extra_calls = 0
        self.resident = _tensors(resident)
        self.peak = 0
        self._live = {}
        self._live_bytes = 0
        self._next_purge = 0

    # -- entry and exit ---------------------------------------------------
    def __enter__(self):
        # The mode enters itself again to count what a composite op
        # decomposes to: only the outermost entry and exit count.
        self._depth = getattr(self, "_depth", 0) + 1
        if self._depth == 1:
            self._meta0 = len(cuda_lib.meta_launches)
            self._link0 = collections.Counter(collectives.link_bytes)
            self._calls0 = sum(collectives.link_calls.values())
            for t in self.resident:
                self._track(t)
            self._purge()
            self.peak = self._live_bytes
            self._next_purge = self.peak * (1 + _SLACK)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth:
            return out
        self._purge()
        self.peak = max(self.peak, self._live_bytes)
        for rec in cuda_lib.meta_launches[self._meta0:]:
            self.bytes += rec["bytes"]
            self.kernels[rec["kernel"]] += 1
            self.census["kernel"] += 1
        self.coll = collections.Counter(collectives.link_bytes)
        self.coll.subtract(self._link0)
        self.coll.update(self.extra_coll)
        self.coll = +self.coll
        self.coll_count = sum(collectives.link_calls.values()) \
            - self._calls0 + self.extra_calls
        return out

    def add_collective(self, op: str, payload: float) -> None:
        """Charge a collective that the program does not run here:
        ``payload`` bytes of ``op`` (a ``collectives.RING`` name), its
        ring multiplier applied."""
        self.extra_coll[op] += collectives.RING[op] * payload
        self.extra_calls += 1

    def add_resident(self, nbytes: int) -> None:
        """Count ``nbytes`` more as live from here on (storage the
        program holds but the mode cannot see, such as a gathered
        unit's weights)."""
        self._live_bytes += nbytes
        self._purge()
        self.peak = max(self.peak, self._live_bytes)
        self._next_purge = self.peak * (1 + _SLACK)

    # -- the peak ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        try:
            s = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = s._cdata
        old = self._live.get(key)
        if old is not None and not old[0].expired():
            return
        if old is not None:
            self._live_bytes -= old[1]
        n = s.nbytes()
        self._live[key] = (StorageWeakRef(s), n)
        self._live_bytes += n
        if self._live_bytes > self._next_purge:
            # The sum still counts the storages that died since the last
            # purge: only an exact sum may set the peak.
            self._purge()
            self.peak = max(self.peak, self._live_bytes)
            self._next_purge = self.peak * (1 + _SLACK)

    def _purge(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    # -- the ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _op_info(func)
        composite, formula, census, moves = info
        if composite:
            # As FlopCounterMode: count what a composite op decomposes to.
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = _flat(args, kwargs)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops[dtype_name(ins[0].dtype) if ins else "float32"] += n
        if census is not None:
            self.census[census] += 1
        outs = _flat((out,), {})
        if moves:
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    # -- the record -------------------------------------------------------
    def result(self) -> dict:
        """The dry run's cost keys: ``flops`` (all dtypes) and
        ``flops_by_dtype``, ``bytes_hbm``, ``bytes_hbm_calibrated`` (None:
        no fusion-aware counterpart), ``collectives`` ({op: bytes,
        "total", "count"}), ``op_census``, ``kernels`` (launches by kernel
        name) and ``peak_bytes``."""
        coll = {k: float(v) for k, v in self.coll.items()}
        coll["total"] = float(sum(self.coll.values()))
        coll["count"] = int(self.coll_count)
        return {
            "flops": float(sum(self.flops.values())),
            "flops_by_dtype": {k: float(v) for k, v in self.flops.items()},
            "bytes_hbm": float(self.bytes),
            "bytes_hbm_calibrated": None,
            "collectives": coll,
            "op_census": dict(self.census),
            "kernels": dict(self.kernels),
            "peak_bytes": int(self.peak),
        }


def count(fn, *args, resident=(), **kwargs):
    """(``fn(*args, **kwargs)``, its :meth:`CostMode.result`), with
    ``resident`` (and the arguments) live from the start."""
    mode = CostMode(resident=(resident, args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
