"""The port's counterpart of lowering a step: one real step run under a
``TorchDispatchMode`` recorder, written down as the `HloProgram` model
that the HVD2xx-5xx rules read (analysis/hlo.py).

The JAX package lints the program XLA lowers (``jax.jit(f).lower()``).
The port runs eagerly and lowers nothing, so `record` runs the step on
real tensors and notes every ATen op the dispatcher sees, forward,
backward (autograd carries the mode to its device threads) and
optimizer alike, and every c10d collective, those the gradient hooks
start included:

* **opcodes**, normalised to the names the rules read: ``dot`` (mm,
  bmm, addmm, ...), ``convolution``, ``convert`` (a dtype change),
  ``all-reduce``/``all-gather``/``reduce-scatter``/``all-to-all``/
  ``collective-broadcast``/``send``/``recv`` (c10d), ``rng`` /
  ``rng_bit_generator`` (a random op without / with an explicit
  generator), ``outfeed``/``infeed`` (``.item()`` of a card's tensor,
  card<->host copies; in a recording that has seen no card, every
  ``.item()``, since a host recording stands in for the card's step),
  ``custom_call`` (a hand-written kernel, below), the passthrough names
  (reshape, transpose, slice, broadcast, add, multiply, ...), else the
  ATen name itself;
* **operand and result types** (dtype and shape, never data);
* **def-use**: each tensor is known by the name of the op that last
  defined it, so an in-place update starts a new version;
* **entry parameters**: the tensors `record` is given (the module's
  parameters and buffers, the optimizer's state, the inputs) and any
  other tensor the step reads before it defines it; an in-place update
  of one is its **donation bit**, and `record`'s `entries` give each
  its sharding annotation;
* **collectives**: the group's global ranks (``replica_groups``), the
  payload in bytes (what this rank contributes), and the chain of port
  functions that issued it (``op_name``, which HVD302 reads);
* **scalars**: a Python number operand, and a host scalar tensor, become
  ``constant`` ops with their value (HVD503's divisors).

A ctypes kernel launch is invisible to the dispatcher, so while a
recording runs, the kernel wrappers (``kernels.kernel_op``) call
through ``kernels.op_hook``. On a thread that a recorder watches, a
launch on the card becomes one ``custom_call`` op named after the
kernel, with the wrapper's tensor arguments and results, their def-use
and its f32 accumulator, the counterpart of the custom call a
``pallas_call`` leaves in HLO; the wrapper's own allocations and views
stay out. On the host the wrappers run their plain versions, whose ops
carry the kernel's name as ``region``, so a program recorded on the
host and one recorded on the card can be compared. A wrapper called on
another thread meanwhile (a serving request, say) is not seen. With no
recording running, a wrapper pays one test of ``kernels.op_hook``.

The recorder keys tensors with a `WeakTensorKeyDictionary`, never by
``id()`` or ``data_ptr()`` (both are reused after a free), and holds no
tensor: a step's activations die when the step drops them. It reads
shapes, dtypes and devices only, so it adds no host sync inside the
step, and it must not run inside a CUDA graph capture (the serving
engine records a bucket's warm-up call, not its capture). A view
recorded before an in-place update of its base keeps the base's old
version: def-use through such aliasing is approximate.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack,
)
from torch.utils.weak import WeakTensorKeyDictionary

from horovod_tpu_torch import kernels
from horovod_tpu_torch.analysis.hlo import (
    HloOp, HloParam, HloProgram, TensorType,
)
from horovod_tpu_torch.analysis.numerics import ATOMIC_ATTR
from horovod_tpu_torch.analysis.shard import ALIAS_ATTR

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS_FILE = os.path.abspath(__file__)

DTYPE_TOKENS = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}
for _name, _tok in (("float8_e4m3fn", "f8e4m3fn"), ("float8_e5m2", "f8e5m2"),
                    ("float8_e4m3fnuz", "f8e4m3fnuz"),
                    ("float8_e5m2fnuz", "f8e5m2fnuz")):
    if hasattr(torch, _name):
        DTYPE_TOKENS[getattr(torch, _name)] = _tok

#: ATen name -> the opcode the rules read (the in-place and out forms
#: strip their trailing underscore first).
OPCODES = {
    **dict.fromkeys(("mm", "bmm", "addmm", "baddbmm", "addbmm", "dot",
                     "mv", "addmv", "matmul", "linear", "_scaled_mm"),
                    "dot"),
    **dict.fromkeys(("convolution", "convolution_backward", "_convolution",
                     "cudnn_convolution", "mkldnn_convolution",
                     "conv2d", "conv1d", "conv3d"), "convolution"),
    **dict.fromkeys(("view", "reshape", "_unsafe_view", "unsqueeze",
                     "squeeze", "flatten", "view_as", "_reshape_alias",
                     "unflatten"), "reshape"),
    **dict.fromkeys(("t", "transpose", "permute", "swapaxes"), "transpose"),
    **dict.fromkeys(("expand", "expand_as", "broadcast_to"), "broadcast"),
    **dict.fromkeys(("slice", "select", "narrow", "split",
                     "split_with_sizes", "chunk", "unbind", "as_strided",
                     "diagonal"), "slice"),
    **dict.fromkeys(("clone", "contiguous"), "copy"),
    **dict.fromkeys(("detach", "alias", "lift_fresh", "_conj"), "bitcast"),
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply",
    "div": "divide", "neg": "negate", "abs": "abs", "tanh": "tanh",
    "exp": "exponential", "log": "log", "sigmoid": "logistic",
    "pow": "power", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "maximum": "maximum", "minimum": "minimum", "where": "select",
    "clamp": "clamp", "cat": "concatenate", "constant_pad_nd": "pad",
    "sum": "reduce", "mean": "reduce", "amax": "reduce", "amin": "reduce",
    "_local_scalar_dense": "outfeed",
}

#: c10d op -> (opcode, output argument index or None for an in-place
#: op, input argument index or None).
COLLECTIVES = {
    "allreduce_": ("all_reduce", None, 0),
    "allreduce_coalesced_": ("all_reduce", None, 0),
    "broadcast_": ("collective_broadcast", None, 0),
    "_allgather_base_": ("all_gather", 0, 1),
    "allgather_": ("all_gather", 0, 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 0, 1),
    "_reduce_scatter_base_": ("reduce_scatter", 0, 1),
    "reduce_scatter_": ("reduce_scatter", 0, 1),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 0, 1),
    "alltoall_base_": ("all_to_all", 0, 1),
    "alltoall_": ("all_to_all", 0, 1),
    "send": ("send", None, 0),
    "recv_": ("recv", 0, None),
}

#: Random ops: ``rng`` from the default generator, ``rng_bit_generator``
#: with an explicit ``generator=``.
RANDOM_OPS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "uniform", "bernoulli", "multinomial",
    "exponential", "geometric", "log_normal", "cauchy", "random",
    "native_dropout", "poisson",
})

#: Ops that accumulate with CUDA atomics in a run-to-run order (HVD504):
#: name -> the keyword that must be true for it to accumulate (None:
#: always; COLLIDE: when two of its indices can meet one address).
#: `index_put_(accumulate=True)` is not one: CUDA sorts its indices and
#: sums each address's values in that order, and a `scatter_add_` with one
#: index along the scattered dim (a gather's backward, one target a row)
#: never writes one address twice. Five backward passes of the flagship
#: LM step from one state gave bit-identical embedding and unembedding
#: gradients on an H100, and so did the tied LM's global_loss
#: (chip_smoke.py lm_determinism_check).
COLLIDE = "<collide>"
ATOMIC_OPS = {"index_add": None, "scatter_add": COLLIDE,
              "put": "accumulate"}


def _can_collide(values) -> bool:
    """Whether scatter_add(self, dim, index, src) can add two values into
    one address: more than one index along `dim` in some row."""
    index, dim = values.get("index"), values.get("dim", 0)
    if not isinstance(index, torch.Tensor) or index.dim() == 0:
        return False
    return index.shape[dim] > 1

_NUMBER_SLOTS = ("Tensor", "Scalar", "Optional[Tensor]", "Optional[Scalar]",
                 "number", "Tensor?", "Scalar?")


def tensor_type(t: torch.Tensor) -> TensorType:
    return TensorType(DTYPE_TOKENS.get(t.dtype, str(t.dtype).replace(
        "torch.", "")), tuple(int(d) for d in t.shape))


def _tensors(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        out: List[torch.Tensor] = []
        for x in v:
            out.extend(_tensors(x))
        return out
    return []


def _origin() -> str:
    """The chain of port functions on the stack, outermost first, as
    ``<module below the package>.<qualname>``."""
    chain = []
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG_DIR) and path != _THIS_FILE:
            mod = os.path.relpath(path, _PKG_DIR)[:-3].replace(os.sep, ".")
            chain.append(f"{mod}.{f.f_code.co_qualname}")
        f = f.f_back
    return "/".join(reversed(chain))


def _batch_frame() -> Optional[int]:
    """id() of the live frame of the torch.distributed.batch_isend_irecv
    call on the stack, or None."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "batch_isend_irecv":
            return id(f)
        f = f.f_back
    return None


def _group_ranks(pg) -> Optional[List[int]]:
    """Global ranks of a c10d process group argument (a boxed
    ScriptObject under the dispatcher)."""
    import torch.distributed as dist
    try:
        from torch._C._distributed_c10d import ProcessGroup
        if not isinstance(pg, ProcessGroup):
            pg = ProcessGroup.unbox(pg)
        return list(dist.get_process_group_ranks(pg))
    except Exception:
        return None


#: cuBLAS's output tile edge and an H100's SM count: cuBLAS splits K
#: only where the output's tiles leave SMs idle.
SPLIT_K_TILE = 128
SPLIT_K_SMS = 132
#: ... and only where K is long enough to split (8 tiles).
SPLIT_K_MIN_K = 8 * SPLIT_K_TILE


def split_k_possible(m: int, n: int, k: int, batch: int = 1) -> bool:
    """Whether cuBLAS may split the K of a (batch x) (m, k) @ (k, n)
    product: fewer output tiles than SMs and K of at least
    SPLIT_K_MIN_K. An estimate of cuBLAS's heuristic, not its answer."""
    tiles = batch * math.ceil(m / SPLIT_K_TILE) * math.ceil(n / SPLIT_K_TILE)
    return tiles < SPLIT_K_SMS and k >= SPLIT_K_MIN_K


def accumulation_type(dtype: torch.dtype, opcode: str = "dot",
                      mnkb: Optional[Tuple[int, int, int, int]] = None
                      ) -> str:
    """The type a matmul (`opcode` "dot", cuBLAS; `mnkb` its (m, n, k,
    batch)) or a convolution (cuDNN) on `dtype` inputs accumulates in on
    the card, the mapping of numerics.accumulation_dtype's docstring. A
    host recording stands in for the card's step, so the device does
    not enter."""
    if opcode == "dot" and mnkb is not None and split_k_possible(*mnkb):
        m = torch.backends.cuda.matmul
        if dtype == torch.bfloat16 and \
                m.allow_bf16_reduced_precision_reduction:
            return "bf16"
        if dtype == torch.float16 and \
                m.allow_fp16_reduced_precision_reduction:
            return "f16"
    return "f64" if dtype == torch.float64 else "f32"


class Recorder(TorchDispatchMode):
    """Records the ops of what runs under it; `program()` gives the
    model. Use `record`, which also routes the kernel wrappers to it.
    One thread at a time feeds it: the step's own, or autograd's device
    thread while the step's thread waits in backward()."""

    def __init__(self, path: str = "<recorded>") -> None:
        super().__init__()
        self.path = path
        self._names = WeakTensorKeyDictionary()
        self._ops: List[HloOp] = []
        # name -> [index, type, sharding, line]
        self._params: Dict[str, list] = {}
        # version name -> the entry parameter it updates in place
        self._param_of: Dict[str, str] = {}
        # entry parameter -> the name of its newest version
        self._latest: Dict[str, str] = {}
        self._line = 0
        self._regions: List[str] = []
        self._in_kernel = False  # inside a kernel wrapper on the card
        self._cuda: Optional[torch.device] = None
        # point-to-point batches: the count, and the id of the frame of
        # the batch_isend_irecv call the last send/recv came from
        self._batches = 0
        self._batch_frame: Optional[int] = None

    # ------------------------------------------------------------ names
    def _next_line(self) -> int:
        self._line += 1
        return self._line

    def entry(self, t: torch.Tensor, sharding: Optional[str] = None) -> str:
        """Register `t` as an entry parameter (before the step runs)."""
        return self._param(t, sharding)

    def _param(self, t: torch.Tensor, sharding: Optional[str] = None) -> str:
        name = self._names.get(t)
        if name is not None:
            return name
        name = f"%arg{len(self._params)}"
        self._params[name] = [len(self._params), tensor_type(t), sharding,
                              self._next_line()]
        self._param_of[name] = name
        self._names[t] = name
        if t.device.type == "cuda":
            self._cuda = t.device
        return name

    def _name(self, t: torch.Tensor) -> str:
        """The name `t` is known by; a tensor first seen here is an entry
        parameter, or a constant when it is a host scalar (reading one
        syncs nothing)."""
        name = self._names.get(t)
        if name is not None:
            return name
        if t.device.type == "cpu" and t.numel() == 1 and not t.requires_grad \
                and t.dtype in DTYPE_TOKENS and not t.is_complex():
            name = self._constant(float(t.item()), tensor_type(t))
            self._names[t] = name
            return name
        return self._param(t)

    def _constant(self, value: float, ttype: TensorType) -> str:
        line = self._next_line()
        name = f"%{line}"
        self._ops.append(HloOp(line, name, "constant", (), (), (ttype,),
                               "recorded=true", "main", value))
        return name

    def _emit(self, opcode: str, operands: Sequence[str],
              operand_types, results: Sequence[torch.Tensor],
              attrs: List[str],
              updated: Sequence[torch.Tensor] = ()) -> str:
        """Append one op; its result names `results`. `updated` are the
        tensors it writes in place (their entry parameters, if any, get
        their donation bit and a newest version)."""
        before = [self._names.get(t) for t in updated]
        line = self._next_line()
        name = f"%{line}"
        if self._regions:
            attrs = attrs + [f'region="{self._regions[-1]}"']
        self._ops.append(HloOp(
            line, name, opcode, tuple(operands), tuple(operand_types),
            tuple(tensor_type(t) for t in results),
            ", ".join(attrs + ["recorded=true"]), "main"))
        for t in results:
            self._names[t] = name
            if t.device.type == "cuda":
                self._cuda = t.device
        for old in before:
            p = self._param_of.get(old)
            if p is not None:
                self._param_of[name] = p
                self._latest[p] = name
        return name

    def _operand(self, t: torch.Tensor, operands: List[str],
                 types: List[TensorType], at: Optional[int] = None) -> None:
        i = len(operands) if at is None else at
        operands.insert(i, self._name(t))
        types.insert(i, tensor_type(t))

    # -------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._in_kernel:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        name = func._opname
        if func.namespace == "profiler" or name.startswith(
                "_record_function"):
            return  # profiler bookkeeping, not the step's work
        if func.namespace == "c10d" and name in COLLECTIVES:
            self._collective(name, args)
            return
        if name.startswith("_foreach_"):
            self._foreach(name, args, out)
            return
        base = name[:-1] if name.endswith("_") else name
        schema = func._schema
        values = {}
        operands: List[str] = []
        types: List[TensorType] = []
        written_self: Optional[torch.Tensor] = None
        written_out: List[torch.Tensor] = []
        for i, a in enumerate(schema.arguments):
            if i < len(args):
                v = args[i]
            elif a.name in kwargs:
                v = kwargs[a.name]
            else:
                continue
            values[a.name] = v
            ts = _tensors(v)
            write = a.alias_info is not None and a.alias_info.is_write
            if write and (a.kwarg_only or base == "copy"):
                written_out.extend(ts)  # out= buffers, copy_'s target
                continue
            if write and ts and written_self is None:
                written_self = ts[0]
                self._operand(ts[0], operands, types, at=0)
                ts = ts[1:]
            for t in ts:
                self._operand(t, operands, types)
            if not ts and isinstance(v, (int, float)) \
                    and not isinstance(v, bool) \
                    and str(a.type) in _NUMBER_SLOTS:
                ctype = TensorType("f32" if isinstance(v, float) else "s64",
                                   ())
                operands.append(self._constant(float(v), ctype))
                types.append(ctype)
        opcode = OPCODES.get(base, base)
        attrs: List[str] = []
        results = _tensors(out)
        if base in RANDOM_OPS:
            opcode = "rng_bit_generator" \
                if values.get("generator") is not None else "rng"
        if base in ATOMIC_OPS:
            key = ATOMIC_OPS[base]
            if key is None or values.get(key) is True or (
                    key == COLLIDE and _can_collide(values)):
                attrs.append(ATOMIC_ATTR)
        if base == "_local_scalar_dense" and args[0].device.type == "cpu" \
                and self._cuda is not None:
            opcode = "host_scalar"  # a host tensor read on the host
        if base in ("_to_copy", "copy", "clone", "contiguous"):
            src = args[0] if base != "copy" else args[1]
            dst = results[0] if base != "copy" else args[0]
            opcode = _copy_opcode(src, dst, opcode)
        mnkb = None
        if opcode == "dot":
            attrs.extend(_dot_attrs(base, args))
            mnkb = _dot_mnkb(base, args)
        elif opcode == "convolution":
            nd = max(args[0].dim() - 2, 1) if args else 2
            sp = "".join(str(i) for i in range(nd))
            attrs.append(f"dim_labels=bf{sp}_oi{sp}->bf{sp}")
            if base == "convolution_backward" and len(operands) >= 3:
                # (grad_out, input, weight) -> (input, weight, grad_out):
                # the lane rule reads the forward's channel dims
                operands[:3] = [operands[1], operands[2], operands[0]]
                types[:3] = [types[1], types[2], types[0]]
        if opcode in ("dot", "convolution") and results:
            attrs.append("accumulation_type=" + accumulation_type(
                results[0].dtype, opcode, mnkb))
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        updated: List[torch.Tensor] = []
        if written_self is not None or (view and operands):
            attrs.append(ALIAS_ATTR)
        if written_self is not None:
            updated.append(written_self)
            results = [written_self] + [r for r in results
                                        if r is not written_self]
        if written_out:
            attrs.append(f"writes={self._name(written_out[0])}")
            updated.extend(written_out)
            results += [t for t in written_out
                        if all(t is not r for r in results)]
        self._emit(opcode, operands, types, results, attrs, updated)

    def _foreach(self, name: str, args, out) -> None:
        """A _foreach_ op is one op per list index, as XLA would have it."""
        lists = [a for a in args if isinstance(a, (list, tuple))]
        n = max((len(a) for a in lists), default=0)
        inplace = name.endswith("_")
        base = name[len("_foreach_"):].rstrip("_")
        opcode = OPCODES.get(base, base)
        outs = _tensors(out)
        for i in range(n):
            operands: List[str] = []
            types: List[TensorType] = []
            for a in args:
                if isinstance(a, (list, tuple)):
                    a = a[i] if i < len(a) else None
                if isinstance(a, torch.Tensor):
                    self._operand(a, operands, types)
                elif isinstance(a, (int, float)) and not isinstance(a, bool):
                    ct = TensorType("f32", ())
                    operands.append(self._constant(float(a), ct))
                    types.append(ct)
            if inplace:
                t = args[0][i]
                self._emit(opcode, operands, types, [t], [ALIAS_ATTR], [t])
            elif i < len(outs):
                self._emit(opcode, operands, types, [outs[i]], [])

    def _collective(self, name: str, args) -> None:
        import torch.distributed as dist
        opcode, out_idx, in_idx = COLLECTIVES[name]
        pg = next((a for a in args if isinstance(a, torch.ScriptObject)
                   and "ProcessGroup" in str(a)), None)
        ranks = _group_ranks(pg) if pg is not None else None
        me = dist.get_rank() if dist.is_initialized() else 0
        ins = _tensors(args[in_idx]) if in_idx is not None else []
        outs = _tensors(args[out_idx]) if out_idx is not None else []
        inplace = out_idx is None and opcode != "send"
        nbytes = sum(t.numel() * t.element_size() for t in (ins or outs))
        attrs = [f"payload_bytes={nbytes}", f'op_name="{_origin()}"']
        if opcode in ("send", "recv"):
            peer = next((a for a in args[2:] if isinstance(a, int)), 0)
            if ranks and 0 <= peer < len(ranks):
                peer = ranks[peer]
            src, dst = (me, peer) if opcode == "send" else (peer, me)
            attrs.append(f"source_target_pairs={{{{{src},{dst}}}}}")
            # the ends one batch_isend_irecv posts together are unordered
            frame = _batch_frame()
            if frame is None or frame != self._batch_frame:
                self._batches += 1
            self._batch_frame = frame
            attrs.append(f"p2p_batch={self._batches}")
        elif ranks is not None:
            attrs.append("replica_groups={{" + ",".join(
                str(r) for r in ranks) + "}}")
        if opcode not in ("send", "recv"):
            self._batch_frame = None
        operands: List[str] = []
        types: List[TensorType] = []
        for t in ins:
            self._operand(t, operands, types)
        if inplace:
            attrs.insert(0, ALIAS_ATTR)
            outs = ins
        elif outs:
            attrs.insert(0, f"writes={self._name(outs[0])}")
        self._emit(opcode, operands, types, outs, attrs, outs)

    # ---------------------------------------------------- kernel ops
    def kernel_call(self, kname: str, fn, args, kwargs):
        """Run a kernel wrapper: its plain version (on the host) with its
        ops in the kernel's region, or its launch (on the card) as one
        ``custom_call`` op from its tensor arguments to its results."""
        inputs = _tensors(list(args) + list(kwargs.values()))
        if not inputs or inputs[0].device.type == "cpu":
            self._regions.append(kname)
            try:
                return fn(*args, **kwargs)
            finally:
                self._regions.pop()
        self._in_kernel = True
        try:
            out = fn(*args, **kwargs)
        finally:
            self._in_kernel = False
        operands: List[str] = []
        types: List[TensorType] = []
        for t in inputs:
            self._operand(t, operands, types)
        self._emit("custom_call", operands, types, _tensors(out),
                   [f'custom_call_target="{kname}"', "accumulation_type=f32"])
        return out

    # --------------------------------------------------------- result
    def program(self, outputs=()) -> HloProgram:
        """The recorded model. The step's `outputs` and the newest
        versions of the entry tensors it updated feed a ``return``."""
        import torch.distributed as dist
        ret = [self._name(t) for t in _tensors(outputs)]
        ret += [n for n in self._latest.values() if n not in ret]
        ops = list(self._ops)
        ops.append(HloOp(self._next_line(), "", "return", tuple(ret),
                         (), (), "recorded=true", "main"))
        params = [HloParam(idx, name, ttype, name in self._latest,
                           "main", pline, sharding)
                  for name, (idx, ttype, sharding, pline)
                  in self._params.items()]
        cuda = self._cuda
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else None
        mem = (torch.cuda.get_device_properties(cuda).total_memory
               if cuda is not None else None)
        return HloProgram(self.path, ops, params, "main", "torch", world,
                          rank, mem)


def _copy_opcode(src, dst, opcode: str) -> str:
    """outfeed/infeed for a copy between the card and the host, convert
    for a dtype change, else `opcode`."""
    if not isinstance(src, torch.Tensor) or not isinstance(dst, torch.Tensor):
        return opcode
    if src.device.type == "cuda" and dst.device.type == "cpu":
        return "outfeed"
    if src.device.type == "cpu" and dst.device.type == "cuda":
        return "infeed"
    if src.dtype != dst.dtype:
        return "convert"
    return "copy"


def _dot_mnkb(base: str, args) -> Optional[Tuple[int, int, int, int]]:
    """(m, n, k, batch) of a recorded matmul (after the bias of addmm &
    co.), or None."""
    mats = [a for a in args if isinstance(a, torch.Tensor)]
    if base in ("addmm", "baddbmm", "addbmm", "addmv") and len(mats) >= 3:
        mats = mats[1:]
    if len(mats) < 2 or mats[0].dim() < 1 or mats[1].dim() < 1:
        return None
    lhs, rhs = mats[0], mats[1]
    k = int(lhs.shape[-1])
    m = int(lhs.shape[-2]) if lhs.dim() >= 2 else 1
    if base == "linear":  # w is (out, in)
        n = int(rhs.shape[0]) if rhs.dim() >= 2 else 1
        m = math.prod(int(d) for d in lhs.shape[:-1])
        return m, n, k, 1
    n = int(rhs.shape[-1]) if rhs.dim() >= 2 else 1
    batch = math.prod(int(d) for d in lhs.shape[:-2]) \
        if base != "addbmm" else 1
    return m, n, k, batch


def _dot_attrs(base: str, args) -> List[str]:
    """HLO-text contracting dims of the two matrix operands (after the
    bias of addmm & co.)."""
    mats = [a for a in args if isinstance(a, torch.Tensor)]
    if base in ("addmm", "baddbmm", "addbmm", "addmv") and len(mats) >= 3:
        mats = mats[1:]
    if len(mats) < 2:
        return []
    lhs, rhs = mats[0], mats[1]
    lc = lhs.dim() - 1
    rc = 0 if rhs.dim() == 1 else rhs.dim() - 2
    if base == "linear":  # x @ w.T: w is (out, in)
        rc = rhs.dim() - 1
    return [f"lhs_contracting_dims={{{lc}}}",
            f"rhs_contracting_dims={{{rc}}}"]


# ------------------------------------------------------------ recording

def _watching() -> Optional[Recorder]:
    """The recorder on this thread's dispatch-mode stack, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Recorder):
            return mode
    return None


def _kernel_hook(kname: str, fn, args, kwargs):
    """``kernels.op_hook`` while any recording runs."""
    rec = _watching()
    if rec is None:
        return fn(*args, **kwargs)
    return rec.kernel_call(kname, fn, args, kwargs)


_recordings = 0  # guarded-by: _recordings_lock
_recordings_lock = threading.Lock()


def record(fn, *args, path: str = "<recorded>",
           entries: Sequence[Tuple[torch.Tensor, Optional[str]]] = (),
           **kwargs) -> Tuple[Any, HloProgram]:
    """(fn(*args, **kwargs), the program it ran), recorded by a new
    Recorder on this thread (and autograd's threads for its backward);
    `entries` are (tensor, sharding annotation or None) pairs registered
    first as the program's entry parameters."""
    global _recordings
    rec = Recorder(path)
    for t, sharding in entries:
        rec.entry(t, sharding)
    with _recordings_lock:
        _recordings += 1
        kernels.op_hook = _kernel_hook
    try:
        with rec:
            out = fn(*args, **kwargs)
    finally:
        with _recordings_lock:
            _recordings -= 1
            if not _recordings:
                kernels.op_hook = None
    return out, rec.program(out)


def model_entries(model: Optional[torch.nn.Module] = None,
                  optimizer=None, inputs: Sequence[Any] = (),
                  shardings: Optional[Dict[str, str]] = None
                  ) -> List[Tuple[torch.Tensor, Optional[str]]]:
    """The entry parameters of a step: the module's parameters (with
    ``shardings[name]`` when given) and buffers, the optimizer's state
    tensors, and the input tensors."""
    out: List[Tuple[torch.Tensor, Optional[str]]] = []
    shardings = shardings or {}
    if model is not None:
        for n, p in model.named_parameters():
            out.append((p, shardings.get(n)))
        for _, b in model.named_buffers():
            out.append((b, None))
    if optimizer is not None:
        opt = getattr(optimizer, "opt", optimizer)
        for state in opt.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    out.append((v, None))
    for t in _tensors(list(inputs)):
        out.append((t, None))
    return out


def sharding_annotation(spec: Sequence[Any], axis_sizes: Dict[str, int],
                        world: int) -> str:
    """The HLO sharding string of a partition spec (one entry per dim:
    None, an axis name, or a tuple of names) on a mesh of `world`
    devices: what an annotated StableHLO argument would carry."""
    tiles = []
    for d in spec:
        names = () if d is None else ((d,) if isinstance(d, str) else d)
        tiles.append(math.prod(int(axis_sizes.get(a, 1)) for a in names))
    shard = math.prod(tiles)
    if shard <= 1:
        return "{replicated}"
    rep = world // shard
    dims = ",".join(str(k) for k in tiles + ([rep] if rep > 1 else []))
    tail = " last_tile_dim_replicate" if rep > 1 else ""
    return f"{{devices=[{dims}]<=[{world}]{tail}}}"
