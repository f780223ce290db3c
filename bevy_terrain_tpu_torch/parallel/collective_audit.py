"""Collective audit: turn "sharded as designed" into numbers.

Torch twin of the JAX package's ``parallel/hlo_audit.py``. There the
collectives are read from the compiled HLO text; the port compiles no
HLO, so they are read from a ``torch.profiler`` trace of the step (with
``record_shapes=True``, :func:`trace_records`): every c10d dispatcher op, whatever the backend
(``c10d::_allgather_base_``, ``c10d::_reduce_scatter_base_``,
``c10d::allreduce_``, ...), keyed under the JAX name (``all-gather``,
``reduce-scatter``, ``all-reduce``, ...) with its output bytes.

The ops that take one tensor record its shape; those that take a tensor
list (``allreduce_``, ``broadcast_``, ...) record none, and their bytes are
read from the backend's own record that follows them (``gloo:all_reduce``,
``nccl:all_reduce``), whose first input is the tensor. On the card the
NCCL kernels (``ncclDevKernel_AllGather_*``, ``..._ReduceScatter_*``) are
counted beside them (:func:`nccl_kernel_counts`).
"""

from __future__ import annotations

import re

import torch

# c10d dispatcher op -> the JAX (HLO) name of the collective (hlo_audit's six)
C10D_OPS = {
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_": "all-gather",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::allreduce_": "all-reduce",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::alltoall_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "c10d::broadcast_": "collective-broadcast",
}
# the ops whose first argument is the single output tensor
_TENSOR_OUT = {"c10d::_allgather_base_", "c10d::_reduce_scatter_base_",
               "c10d::alltoall_base_"}
_BACKEND = ("gloo:", "nccl:")
# NCCL kernel name part -> the JAX name (ncclDevKernel_AllGather_RING_LL, ...)
_NCCL_KERNELS = {"AllGather": "all-gather", "ReduceScatter": "reduce-scatter",
                 "AllReduce": "all-reduce", "Broadcast": "collective-broadcast",
                 "SendRecv": "collective-permute"}
_NCCL_RE = re.compile(r"^nccl(?:Dev)?Kernel_([A-Za-z]+?)(?:_|\(|$)")

_DTYPE_BYTES = {
    "double": 8, "long int": 8, "long": 8, "c10::complex<float>": 8,
    "float": 4, "int": 4, "unsigned int": 4,
    "c10::Half": 2, "c10::BFloat16": 2, "short": 2, "unsigned short": 2,
    "signed char": 1, "unsigned char": 1, "bool": 1,
}


def _bytes(shape, dtype: str) -> int:
    if dtype not in _DTYPE_BYTES:
        raise ValueError(f"collective audit: unknown element type {dtype!r}")
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def trace_records(prof) -> list:
    """(name, device type, start ns, input shapes, input element types) of
    every record of a finished profiler trace (its kineto events, which
    carry the element types in every torch version the port runs on)."""
    return [(e.name(), e.device_type().name, e.start_ns(), e.shapes(), e.dtypes())
            for e in prof.profiler.kineto_results.events()]


def collective_stats(records) -> dict:
    """{op: {"count": N, "bytes": B}} over the c10d collectives among the
    trace ``records`` (:func:`trace_records` of a ``record_shapes`` trace).

    ``bytes`` is the PER-RANK output byte volume, as the JAX audit's."""
    host = sorted((r for r in records if r[1] == "CPU"), key=lambda r: r[2])
    stats: dict = {}
    for i, (name, _, _, shapes, dtypes) in enumerate(host):
        op = C10D_OPS.get(name)
        if op is None:
            continue
        if name not in _TENSOR_OUT:
            backend = next((b for b in host[i + 1:] if b[0].startswith(_BACKEND)), None)
            if backend is None:
                raise ValueError(f"collective audit: no backend record after {name}")
            shapes, dtypes = backend[3], backend[4]
        entry = stats.setdefault(op, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += _bytes(shapes[0], dtypes[0])
    return stats


def nccl_kernel_counts(records) -> dict:
    """{op: launches} of the NCCL kernels among the trace ``records``
    (:func:`trace_records`; the device's), keyed as :func:`collective_stats`.
    A group of one rank launches none: NCCL copies on the device instead."""
    counts: dict = {}
    for name, device, *_ in records:
        m = _NCCL_RE.match(name) if device == "CUDA" else None
        if m:
            op = _NCCL_KERNELS.get(m.group(1), m.group(1))
            counts[op] = counts.get(op, 0) + 1
    return counts


def profile_collectives(fn, *args, device) -> tuple:
    """Run ``fn(*args)`` in a profiler trace with shapes recorded: (its
    result, :func:`collective_stats`, :func:`nccl_kernel_counts` or None
    when ``device`` is not a CUDA device). On the card the trace also holds
    the device records: after the call, a sync and a few marker kernels, as
    ``utils/timing`` does (the last call of a trace on the card's machine
    can come back without its device records)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities, record_shapes=True) as prof:
        result = fn(*args)
        if on_card:
            torch.cuda.synchronize(device)
            for _ in range(16):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize(device)
    records = trace_records(prof)
    return result, collective_stats(records), nccl_kernel_counts(records) if on_card else None


def ici_bytes(stats: dict, n_devices: int) -> int:
    """Ring-algorithm interconnect traffic estimate per device, from output
    bytes: all-gather moves (n-1)/n x output; reduce-scatter's OUTPUT is 1/n
    of its input, so traffic = (n-1) x output; all-reduce = 2(n-1) x output
    (output == input)."""
    total = 0.0
    for op, v in stats.items():
        if op == "reduce-scatter":
            total += (n_devices - 1) * v["bytes"]
        elif op == "all-reduce":
            total += 2 * (n_devices - 1) * v["bytes"]
        else:  # all-gather, all-to-all, permutes: ~output-sized
            total += (n_devices - 1) / n_devices * v["bytes"]
    return int(total)


def format_stats(stats: dict, n_devices: int | None = None) -> str:
    if not stats:
        return "no collectives"
    body = ", ".join(
        f"{op} x{v['count']} ({v['bytes'] / 1e6:.2f} MB/device out)"
        for op, v in sorted(stats.items())
    )
    if n_devices:
        body += f"; ~{ici_bytes(stats, n_devices) / 1e6:.0f} MB link/device/frame"
    return body
