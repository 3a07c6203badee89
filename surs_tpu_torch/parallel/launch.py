"""Run a function on every rank of a mesh.

    results = spawn(fn, world_size=4, backend="gloo", device="cpu",
                    args=(...,), n_points=4)
    results = run_threads(fn, world_size=8, n_points=8)

``fn(mesh, *args)`` runs once per rank and its return values come back
in rank order. :func:`spawn` starts ``world_size`` processes (the
``spawn`` start method), initialises each from a ``file://`` store with a
timeout, builds the [world / n_points, n_points] mesh and destroys the
group when ``fn`` ends, however it ends. ``fn`` must be defined in a
module that a fresh interpreter can import cheaply: the children import
it again. A rank that raises makes :func:`spawn` raise with its
traceback, after every child has ended. :func:`run_threads` runs the
ranks as threads of this process over :class:`~.comm.ThreadComm`, with no
process group. :func:`init_from_env` initialises the group of a
``torchrun`` launch, and :func:`distributed_run` runs a CLI's work
inside it.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import threading
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .comm import ThreadComm, ThreadHub
from .mesh import DATA_AXIS, POINT_AXIS, Mesh, make_mesh, mesh_of

INIT_TIMEOUT_S = 60.0


def _worker(rank: int, world: int, backend: str, device: str,
            init_file: str, fn: Callable, args: Sequence, n_points: int,
            timeout: float, queue) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method="file://" + init_file, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            mesh = make_mesh(n_points=n_points, device_type=device)
            queue.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:       # reported to the parent, which raises it
        queue.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world_size: int, backend: str = "gloo",
          device: str = "cpu", args: Sequence = (), n_points: int = 1,
          timeout: float = INIT_TIMEOUT_S, deadline: float = 600.0,
          store_dir: Optional[str] = None) -> List:
    """``fn(mesh, *args)`` on ``world_size`` processes; returns the
    results in rank order. ``timeout`` bounds the group's init and each
    collective, ``deadline`` the whole run (children still running then
    are killed). ``backend`` 'nccl' needs ``device`` 'cuda'."""
    import multiprocessing as mp
    import queue as queue_mod

    if backend == "nccl" and (device != "cuda"
                              or not torch.cuda.is_available()):
        raise RuntimeError("the nccl backend needs a CUDA device")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = tempfile.mkdtemp(prefix="surs_pg_", dir=store_dir)
    init_file = os.path.join(store, "store")
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world_size, backend, device, init_file, fn,
                               tuple(args), n_points, timeout, q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    end = _now() + deadline
    try:
        while len(results) + len(errors) < world_size:
            try:
                rank, ok, out = q.get(timeout=max(0.1, min(1.0,
                                                           end - _now())))
            except queue_mod.Empty:
                if _now() > end:
                    raise RuntimeError(
                        f"spawn: {world_size - len(results) - len(errors)}"
                        f" rank(s) still running after {deadline} s")
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results
                        and r not in errors]
                if dead and q.empty():
                    for r in dead:
                        errors[r] = (f"rank {r} exited with code "
                                     f"{procs[r].exitcode} and no result")
                continue
            (results if ok else errors)[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
        _rmtree(store)
    if errors:
        raise RuntimeError("spawn: " + "\n".join(
            f"rank {r} failed:\n{errors[r]}" for r in sorted(errors)))
    return [results[r] for r in range(world_size)]


def _now() -> float:
    import time
    return time.monotonic()


def _rmtree(path: str) -> None:
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def _thread_meshes(world_size: int, n_points: int = 1, device="cpu",
                  timeout: float = INIT_TIMEOUT_S) -> List[Mesh]:
    """The meshes of ``world_size`` ranks that threads of this process
    play, rank r at (r // n_points, r % n_points)."""
    n_data = world_size // n_points
    if n_data * n_points != world_size:
        raise ValueError(f"{n_data}x{n_points} != {world_size} ranks")
    world = ThreadHub(world_size, timeout)
    data_hubs = [ThreadHub(n_data, timeout) for _ in range(n_points)]
    point_hubs = [ThreadHub(n_points, timeout) for _ in range(n_data)]
    meshes = []
    for r in range(world_size):
        i, j = divmod(r, n_points)
        comms = {DATA_AXIS: ThreadComm(data_hubs[j], i),
                 POINT_AXIS: ThreadComm(point_hubs[i], j)}
        meshes.append(mesh_of(comms, ThreadComm(world, r), device))
    return meshes


def run_threads(fn: Callable, world_size: int, n_points: int = 1,
                device="cpu", args: Sequence = (),
                timeout: float = INIT_TIMEOUT_S) -> List:
    """``fn(mesh, *args)`` on ``world_size`` threads, one a rank; returns
    the results in rank order. A rank that raises aborts the others'
    collectives, and the first error is raised here."""
    meshes = _thread_meshes(world_size, n_points, device, timeout)
    hubs = {id(c.hub): c.hub for m in meshes
            for c in list(m.comms.values()) + [m.world]}
    results: List = [None] * world_size
    errors: List = [None] * world_size

    def run(r):
        try:
            results[r] = fn(meshes[r], *args)
        except Exception as err:         # re-raised by the caller
            errors[r] = err
            for hub in hubs.values():
                hub.abort()

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(world_size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors
                  if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results


def init_from_env(device: torch.device,
                  timeout: float = 600.0) -> bool:
    """Initialise the process group of a ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` in the
    environment): NCCL on CUDA, gloo on the CPU, each rank on its
    ``LOCAL_RANK``'s card. Returns False, doing nothing, outside such a
    launch or when a group is up."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout))
    return True



def distributed_run(cfg, device, fn: Callable):
    """``fn(root)`` once in this process, ``root`` True on the rank that
    prints and writes. Under ``torchrun`` the launch's group is up around
    ``fn`` (destroyed after it, however it ends) and ``root`` is rank 0;
    the meshes are then extracted across the ranks, so ``cfg.mc_backend``
    must be 'sharded'. Otherwise ``fn(True)``."""
    if not init_from_env(device):
        return fn(True)
    try:
        if cfg.mc_backend != "sharded":
            raise ValueError(
                f"under torchrun the ranks share the extraction: pass "
                f"--mc_backend sharded (got {cfg.mc_backend!r})")
        return fn(dist.get_rank() == 0)
    finally:
        dist.destroy_process_group()
