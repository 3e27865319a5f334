"""The (dp, sp, tp) mesh on `torch.distributed`: the port of
`acestep_tpu/parallel/mesh.py` (`make_mesh`, `shard_batch`, `shard_params_dp`).

JAX lays the mesh over the devices of one process and lets XLA move the data
between them. The port runs one process a rank, and a rank's coordinate on
each axis follows its rank as JAX's devices follow their index
(`np.arange(world).reshape(dp, sp, tp)`).

Data parallelism needs no device collective. Every rank holds the same
weights (`shard_params_dp` checks a digest of every leaf across the ranks),
takes its contiguous rows of a batch (`shard_batch`), and what ranks
exchange are host objects on gloo groups: rank 0's commands
(`Mesh.send_command` / `receive_command`) and each rank's rows of a result
(`Mesh.gather`). Every exchange runs under the mesh's `timeout`, except a
follower's wait for rank 0's next command: a server's followers wait between
requests for as long as it stays up, and a rank 0 that exits closes its
connections, which ends the wait.

`launch(fn, nprocs, *args)` runs `fn(*args)` on `nprocs` ranks: it spawns
them itself (`torch.multiprocessing`, a `file://` rendezvous in a temporary
directory) when this process belongs to no group, or joins the group that
torchrun describes (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`).
`rank_device` gives a rank its device, `cuda:{local_rank % device_count}`,
so two ranks may share one card.

Not ported yet (ROADMAP A.11b): sequence and tensor parallelism, with the
tensor-parallel plan (`_tp_spec_for`, `shard_params_tp`). Their collectives
run on the device, and the port's kernels take local tensors, so each has to
be written out; `refuse_sp_tp` says so.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import signal
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
GRACE_S = 60.0  # how long an interrupted launch waits for rank 0 to stop its followers
# A follower waits on the command group between requests; see the docstring.
_IDLE_TIMEOUT = datetime.timedelta(days=365)
_AXES = ("dp", "sp", "tp")


def refuse_sp_tp(sp: int, tp: int) -> None:
    """Raise while sequence or tensor parallelism is asked for: only dp is ported."""
    if sp > 1 or tp > 1:
        raise ValueError(
            f"sp={sp}, tp={tp}: sequence and tensor parallelism are not ported yet "
            "(ROADMAP A.11b); only data parallelism (dp) runs"
        )


class Mesh:
    """This rank's place in a (dp, sp, tp) mesh over the ranks of the
    default process group, with the gloo groups its exchanges run on."""

    def __init__(self, dp: int, sp: int, tp: int, timeout: float):
        self.shape: Dict[str, int] = {"dp": dp, "sp": sp, "tp": tp}
        self.rank = dist.get_rank()
        self.size = dp * sp * tp
        self.coord: Dict[str, int] = dict(zip(_AXES, (int(c) for c in np.unravel_index(self.rank, (dp, sp, tp)))))
        self.timeout = timeout
        # Every rank creates both groups, in the same order (a collective call).
        self.group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout))
        self.command_group = dist.new_group(backend="gloo", timeout=_IDLE_TIMEOUT)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n: contiguous, by its dp coordinate;
        all of them when n does not divide by dp (as JAX leaves such a batch whole)."""
        dp = self.shape["dp"]
        if n % dp:
            return slice(0, n)
        k = n // dp
        return slice(self.coord["dp"] * k, (self.coord["dp"] + 1) * k)

    def send_command(self, command: Any) -> None:
        """Rank 0: hand `command` to every follower waiting in `receive_command`."""
        dist.broadcast_object_list([command], src=0, group=self.command_group)

    def receive_command(self) -> Any:
        """A follower: wait for rank 0's next command."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.command_group)
        return box[0]

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's `obj` in rank order on rank 0; None on the others."""
        out = [None] * self.size if self.is_leader else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def all_gather(self, obj: Any) -> List[Any]:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, *, timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A (dp, sp, tp) mesh over the ranks of the default process group; dp
    defaults to world_size // (sp·tp). Every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under mesh.launch or torchrun")
    n = dist.get_world_size()
    if dp is None:
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) * tp({tp}) != devices({n})")
    return Mesh(dp, sp, tp, timeout)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path or "/", tree


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This rank's rows of every batch-leading leaf (`Mesh.rows`). 0-d
    leaves, leaves that are no array, and leaves whose leading axis does not
    divide by dp stay whole."""

    def take(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        return x[mesh.rows(x.shape[0])]

    return _tree_map(take, tree)


def _digest(x: Any) -> str:
    """sha256 of a leaf's dtype, shape and bytes (a tensor's on the host)."""
    h = hashlib.sha256()
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().reshape(-1)
        h.update(f"{x.dtype}{tuple(x.shape)}".encode())
        h.update(t.view(torch.uint8).cpu().numpy())
    elif isinstance(x, np.ndarray):
        h.update(f"{x.dtype}{x.shape}".encode())
        h.update(np.ascontiguousarray(x))
    else:
        h.update(repr(x).encode())
    return h.hexdigest()


def shard_params_dp(mesh: Mesh, params: Any) -> Any:
    """Replicated weights: every rank holds the same tree. A digest of every
    leaf is gathered across the ranks, and the first leaf that differs from
    rank 0's raises ValueError on every rank. Returns `params` unchanged."""
    mine = [(path, _digest(leaf)) for path, leaf in _leaves(params)]
    every = mesh.all_gather(mine)
    for r, theirs in enumerate(every[1:], start=1):
        if theirs == every[0]:
            continue
        paths = dict(every[0])
        for path, d in theirs:
            if paths.get(path) != d:
                raise ValueError(f"weights differ across ranks: leaf {path!r} of rank {r} is not rank 0's")
        raise ValueError(f"weights differ across ranks: rank {r} holds other leaves than rank 0")
    return params


def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: the CPU when `device` says so; else the card
    `device` names, or `cuda:{LOCAL_RANK % device_count}`, made current.
    Raises without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks on the CPU")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _exit_with_parent(parent: int) -> None:
    """End this rank when the process that spawned it is gone (killed
    without a chance to stop its ranks)."""

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True, name="mesh-parent-watch").start()


def _rank_main(rank: int, nprocs: int, tmp: str, parent: int, timeout: float, fn, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    _exit_with_parent(parent)
    # Ranks on one host share its cores.
    torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    if rank:
        # A terminal's interrupt reaches every rank; the followers end when
        # rank 0 stops them, or when its connections close.
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=rank,
                            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _stop(procs, grace_s: float) -> None:
    """Join every rank within `grace_s`, then terminate, then kill what is left."""
    deadline = time.time() + grace_s
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    for sig in ("terminate", "kill"):
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            getattr(p, sig)()
        for p in alive:
            p.join(5.0)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def launch(fn: Callable[..., Any], nprocs: int, *args: Any, timeout: float = DEFAULT_TIMEOUT_S,
           deadline_s: Optional[float] = None) -> Any:
    """Run `fn(*args)` on `nprocs` ranks, each in a gloo process group.

    In a process that is already one rank of a group (it was initialised, or
    torchrun set `RANK` and `WORLD_SIZE`), that group must have `nprocs`
    ranks and `fn` runs here; every rank returns its own value. Otherwise the
    ranks are spawned here and rank 0's value is returned once every rank has
    exited. A rank that raises or dies makes this raise (the others are
    terminated), and so does one still running after `deadline_s`. An
    interrupt or SIGTERM here interrupts rank 0 (which stops its followers)
    and waits GRACE_S for every rank to end before it terminates them."""
    if dist.is_initialized() or ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        joined = not dist.is_initialized()
        if joined:
            dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(seconds=timeout))
        try:
            if dist.get_world_size() != nprocs:
                raise ValueError(f"the process group has {dist.get_world_size()} ranks, not {nprocs}")
            return fn(*args)
        finally:
            if joined:
                dist.destroy_process_group()
    import torch.multiprocessing as mp

    main = threading.current_thread() is threading.main_thread()
    before = signal.signal(signal.SIGTERM, _interrupt) if main else None
    try:
        with tempfile.TemporaryDirectory(prefix="acestep-mesh-") as tmp:
            ctx = mp.start_processes(_rank_main, args=(nprocs, tmp, os.getpid(), timeout, fn, args),
                                     nprocs=nprocs, join=False, start_method="spawn")
            end = None if deadline_s is None else time.time() + deadline_s
            try:
                while not ctx.join(timeout=0.5):
                    if end is not None and time.time() > end:
                        raise TimeoutError(f"the {nprocs} ranks did not end within {deadline_s} s")
            except KeyboardInterrupt:
                if ctx.processes[0].is_alive():
                    os.kill(ctx.processes[0].pid, signal.SIGINT)
                _stop(ctx.processes, GRACE_S)
                if any(p.exitcode != 0 for p in ctx.processes):
                    raise
            except BaseException:
                _stop(ctx.processes, 0.0)
                raise
            result = os.path.join(tmp, "result.pkl")
            if not os.path.exists(result):  # torch's spawn ends an interrupted rank with code 0
                raise RuntimeError("rank 0 was interrupted before it returned")
            with open(result, "rb") as f:
                return pickle.load(f)
    finally:
        if main:
            signal.signal(signal.SIGTERM, before)
