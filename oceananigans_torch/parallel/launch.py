"""Start ``n`` ranks of a ``torch.distributed`` group and collect their
results.

``launch(n, fn, args, rendezvous_dir=..., backend=..., device=...)`` spawns
``n`` processes with ``torch.multiprocessing`` (start method ``spawn``,
which CUDA needs), each of which joins a process group through a
``file://`` rendezvous in ``rendezvous_dir`` (no TCP port, so concurrent
launches in one machine cannot collide), pins one torch thread, builds a
:class:`~oceananigans_torch.parallel.distributed.Distributed` over
``partition`` on its device and calls ``fn(dist, *args)``. ``fn`` must be
importable by name (a module-level function), since each rank starts from
a fresh import. ``args`` reach the ranks through a ``torch.save`` file in
``rendezvous_dir``, not through the spawn: a process's spawn data larger
than a pipe's buffer holds the parent until that child has imported its
modules, so the ranks would start one after another. The ranks' return
values come back to the caller in rank order (through ``torch.save``
files in ``rendezvous_dir``); an exception
in any rank is raised again in the caller, with that rank's traceback, and
the other ranks are stopped.

``device`` is "cpu", one device for every rank ("cuda:0": ranks that
share one card, as gloo ranks may), or "cuda" for one card a rank (rank r
on ``cuda:r``, as NCCL needs); by default ``config.device`` of the
caller's process, read when ``launch`` is called (the card, unless the
caller asked for the CPU). Before it spawns CUDA ranks the
launcher builds the kernel library once, so the ranks load it instead of
compiling it side by side.
"""

from __future__ import annotations

import os
import traceback

import torch

__all__ = ["launch", "rank_device"]


def rank_device(device, rank):
    """The device of ``rank`` for the launcher's ``device`` argument."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", rank)
    return d


def _rank_main(rank, n, fn, rendezvous_dir, backend, device, partition):
    import torch.distributed as tdist

    from oceananigans_torch.parallel.distributed import Distributed

    torch.set_num_threads(1)
    out = os.path.join(rendezvous_dir, f"result_{rank}.pt")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = dev
    tdist.init_process_group(
        backend, init_method=f"file://{rendezvous_dir}/rendezvous",
        world_size=n, rank=rank, **kwargs)
    try:
        dist = Distributed(partition, device=dev)
        args = torch.load(os.path.join(rendezvous_dir, "args.pt"),
                          weights_only=False)
        result = fn(dist, *args)
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        tdist.destroy_process_group()


def launch(n, fn, args=(), *, rendezvous_dir, backend="gloo",
           device=None, partition=None):
    """Run ``fn(dist, *args)`` on ``n`` ranks; returns their results in rank
    order. ``rendezvous_dir`` must be an empty directory of the caller's
    (the rendezvous file and the results go there); ``device`` defaults to
    ``config.device``."""
    import torch.multiprocessing as mp

    from oceananigans_torch.config import config
    if device is None:
        device = config.device

    rendezvous_dir = os.path.abspath(str(rendezvous_dir))
    os.makedirs(rendezvous_dir, exist_ok=True)
    if os.listdir(rendezvous_dir):
        raise ValueError(f"rendezvous directory {rendezvous_dir} is not "
                         "empty")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: choose 'gloo' or 'nccl'")
    if torch.device(device).type == "cuda":
        from oceananigans_torch.ops import _build
        _build.load()
    torch.save(tuple(args), os.path.join(rendezvous_dir, "args.pt"))
    ctx = mp.start_processes(
        _rank_main, args=(n, fn, rendezvous_dir, backend, device,
                          partition),
        nprocs=n, join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    except mp.ProcessRaisedException as err:
        raise RuntimeError(f"a rank failed:\n{err}") from None
    except mp.ProcessExitedException as err:
        raise RuntimeError(f"a rank exited abnormally: {err}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    results = []
    for rank in range(n):
        got = torch.load(os.path.join(rendezvous_dir, f"result_{rank}.pt"),
                         weights_only=False)
        if "error" in got:
            raise RuntimeError(f"rank {rank} failed:\n{got['error']}")
        results.append(got["result"])
    return results
