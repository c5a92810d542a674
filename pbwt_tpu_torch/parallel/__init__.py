"""Scale-out of the port on ``torch.distributed``: process groups, the
collectives the sharded paths use, and a launcher of ranks.

Counterpart of ``pbwt_tpu/parallel`` (``make_mesh``, ``sharding.py:42-46``).
JAX runs one program over a mesh; here every rank is a process with its own
:class:`Group`, the backend is named by the caller and never switched:
``nccl`` takes one card a rank, ``gloo`` takes CPU tensors or, for
``all_reduce`` and ``broadcast`` only, CUDA tensors (several ranks may then
share one card). :class:`Group` counts the bytes it hands to its
collectives, so that a run can report its traffic a site.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback

BACKENDS = ("gloo", "nccl")


class Group:
    """One rank's view of a process group: its rank, the world size, the
    device its tensors live on, and the collectives, counted in
    :attr:`bytes` (the payload handed to the backend)."""

    def __init__(self, backend: str, rank: int, world_size: int, device):
        self.backend, self.rank, self.world = backend, rank, world_size
        self.device = device
        self.bytes = 0

    def _count(self, t) -> None:
        self.bytes += t.numel() * t.element_size()

    def all_reduce(self, t):
        """Sum t over the ranks, in place."""
        import torch.distributed as dist
        self._count(t)
        if self.world > 1 or dist.is_initialized():
            dist.all_reduce(t)
        return t

    def broadcast(self, t, src: int):
        """t of rank src on every rank, in place."""
        import torch.distributed as dist
        self._count(t)
        if self.world > 1 or dist.is_initialized():
            dist.broadcast(t, src)
        return t

    def close(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


TIMEOUT_S = 600.0      # a collective waits this long for the other ranks


def init_group(backend: str, rank: int, world_size: int, init_method: str,
               device=None) -> Group:
    """Join the default process group of ``world_size`` ranks as ``rank``.

    backend: ``gloo`` or ``nccl``. init_method: a ``file://`` path or a
    ``tcp://host:port`` (nothing on the machine tells a rank of its world).
    device: where the rank's tensors live; for ``nccl`` it defaults to card
    ``rank`` and must be a CUDA device, for ``gloo`` to the CPU. NCCL with
    more ranks than cards, or without a card, raises naming gloo: the
    backend is never switched here.
    """
    import torch
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not in a world of {world_size}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > cards or not dist.is_nccl_available():
            raise ValueError(
                f"backend nccl needs a CUDA card a rank: {world_size} ranks, "
                f"{cards} cards{'' if dist.is_nccl_available() else ', no NCCL'}"
                "; ask for backend='gloo' to share a card or run on the CPU")
        device = torch.device(f"cuda:{rank}" if device is None else device)
        if device.type != "cuda":
            raise ValueError(f"backend nccl takes CUDA tensors, not {device}")
    else:
        device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Group(backend, rank, world_size, device)


def shard(n: int, world: int, rank: int, unit: int = 1) -> tuple[int, int]:
    """[lo, hi) of rank's share of n items cut only at multiples of unit:
    the whole units split as evenly as they go, the earlier ranks no
    smaller."""
    units = -(-n // unit)
    lo, hi = (units * r // world for r in (rank, rank + 1))
    return min(lo * unit, n), min(hi * unit, n)


def _rank_main(rank, world, backend, init_method, device, fn, args, out):
    """A spawned rank: join the group, run fn(group, *args), report
    ("ok", rank, result) or ("error", rank, traceback) on out."""
    group = None
    try:
        group = init_group(backend, rank, world, init_method, device)
        out.put(("ok", rank, fn(group, *args)))
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if group is not None:
            try:
                group.close()
            except Exception:
                pass


def spawn(world: int, backend: str, fn, *args, device=None,
          timeout_s: float = 600.0, threads: int | None = None) -> list:
    """Run fn(group, *args) on ranks 0 .. world-1, each a fresh process
    (``spawn``: a rank imports the port and nothing of the caller), joined
    through a ``file://`` store in a new temporary directory. Returns the
    ranks' results in rank order. A rank that raises or dies fails the whole
    run: the other ranks are ended and RuntimeError names the rank, with its
    traceback. fn must be a module-level function; device is every rank's
    device (None: the backend's default); threads, if given, is each rank's
    torch thread count."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pbwt_group_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        dev = None if device is None else str(device)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, backend, init, dev, _threads,
                                   (threads, fn, args), out))
                 for r in range(world)]
        for p in procs:
            p.start()
        results: dict[int, object] = {}
        try:
            deadline = timeout_s
            while len(results) < world:
                try:
                    kind, rank, res = out.get(timeout=1.0)
                except queue.Empty:
                    deadline -= 1.0
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {world} died "
                                           f"(exit code "
                                           f"{procs[dead[0]].exitcode})")
                    if deadline <= 0:
                        raise RuntimeError(f"ranks did not finish in "
                                           f"{timeout_s:.0f} s")
                    continue
                if kind == "error":
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{res}")
                results[rank] = res
        finally:
            for p in procs:
                p.join(timeout=10 if len(results) == world else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]


def _threads(group, threads, fn, args):
    if threads is not None:
        import torch
        torch.set_num_threads(threads)
    return fn(group, *args)
