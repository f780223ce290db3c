"""One process per card, grouped by ``torch.distributed``.

The JAX package is one program over a device mesh (``shard_map``). The
port's counterpart is one process per card: :func:`launch` spawns
``n_ranks`` processes, joins them in a process group (NCCL on the cards,
gloo on the CPU) and runs one function in each, rank ``r`` on card ``r``.

* The rendezvous is a ``file://`` store in a fresh temporary directory, so
  concurrent launches (test workers) never contend for a port.
* The CUDA kernels and the native host runtime are built in the parent
  before the ranks start: n ranks must not race ``nvcc`` or ``g++`` into
  ``build/``.
* Each rank's result and its kernel launch counts over the whole of its
  function (set to 0 just before it, read just after) come back to the
  parent.
* A rank that raises makes :func:`launch` raise; the others are ended. No
  rank falls back to the CPU: ``device="cuda"`` needs ``n_ranks`` cards.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _wrappers() -> dict:
    """``{name: wrapper}`` of every counted kernel wrapper in
    :mod:`~bevy_terrain_tpu_torch.ops.kernels`."""
    from bevy_terrain_tpu_torch.ops import kernels

    return {name: fn for name, fn in vars(kernels).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None), int)}


def launch_counts() -> dict:
    """``{wrapper name: launches}`` of every kernel wrapper."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def _build_first(device: str) -> None:
    """Build what the ranks would otherwise each build at first use."""
    from bevy_terrain_tpu_torch import native
    from bevy_terrain_tpu_torch.ops import kernels

    if device == "cuda":
        kernels.build_library()
    if os.environ.get("BT_DISABLE_NATIVE") != "1":
        native.build_library()


def _rank_main(rank: int, n_ranks: int, device: str, rendezvous: str, out_dir: str,
               fn, args) -> None:
    if device == "cuda":
        torch.cuda.set_device(rank)
        backend, dev = "nccl", torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)  # n ranks share the host's cores
        backend, dev = "gloo", torch.device("cpu")
    dist.init_process_group(backend, init_method=rendezvous, world_size=n_ranks, rank=rank,
                            device_id=dev if device == "cuda" else None)
    reset_launch_counts()
    result = fn(rank, dist.group.WORLD, dev, *args)
    launches = launch_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()
    torch.save({"result": result, "launches": launches}, Path(out_dir) / f"rank{rank}.pt")


def launch(fn, n_ranks: int, *args, device: str = "cuda") -> list[dict]:
    """Run ``fn(rank, group, device, *args)`` in ``n_ranks`` spawned
    processes and return, per rank, ``{"result": its return value,
    "launches": its kernel launch counts over the call}``.

    ``fn`` and ``args`` are pickled (``fn`` by import path: a module-level
    function of a module that imports neither jax nor the JAX package).
    ``device="cuda"``: rank r runs on card r in an NCCL group; raises when
    fewer than ``n_ranks`` cards are visible. ``device="cpu"``: a gloo
    group of CPU processes with one torch thread each."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be at least 1, got {n_ranks}")
    if device == "cuda" and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"{n_ranks} ranks need {n_ranks} cards; "
                           f"{torch.cuda.device_count()} visible")
    _build_first(device)
    with tempfile.TemporaryDirectory(prefix="bt_launch_") as tmp:
        mp.start_processes(_rank_main, nprocs=n_ranks, join=True, start_method="spawn",
                           args=(n_ranks, device, f"file://{tmp}/rendezvous", tmp, fn, args))
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n_ranks)]
