"""The (dp, sp, tp) mesh on `torch.distributed`: the port of
`acestep_tpu/parallel/mesh.py` (`make_mesh`, `shard_batch`, `shard_params_dp`,
the tensor-parallel plan `_tp_spec_for` and `shard_params_tp`).

JAX lays the mesh over the devices of one process and lets XLA insert the
collectives. The port runs one process a rank, and a rank's coordinate on
each axis follows its rank as JAX's devices follow their index
(`np.arange(world).reshape(dp, sp, tp)`).

Host exchanges run on gloo groups: rank 0's commands (`Mesh.send_command` /
`receive_command`), each rank's result (`Mesh.gather`), and the digest of
every weight that `shard_params_dp` compares across the ranks. Every
exchange runs under the mesh's `timeout`, except a follower's wait for rank
0's next command: a server's followers wait between requests for as long as
it stays up, and a rank 0 that exits closes its connections, which ends the
wait.

The mesh holds the one command channel of every handler on it: a handler
registers its ops under a name (`Mesh.attach`: the DiT's `AceStepHandler` as
"dit", a split planner's `LLMHandler` as "planner"), rank 0 runs an op on
every rank (`Mesh.lead`) and the followers wait in `Mesh.serve`. One lock
keeps rank 0's ops one at a time across threads and handlers, so the
collectives of two ops never interleave; an op started from inside another
raises instead of waiting on itself.

The port's kernels take local tensors, so every collective of sequence and
tensor parallelism is written out, on the device groups: the tp group (the
ranks that share dp and sp) sums a rowwise product's fp32 partials
(`reduce_sum`), and the sp group (the ranks that share dp and tp) gathers
rows along the latent-time axis (`gather_tensors`). Their backend follows one
rule (`device_backend`): NCCL when every rank has a card of its own, gloo
otherwise (on the CPU, and when ranks share a card: NCCL refuses two ranks of
one communicator on one card). Over gloo a CUDA tensor is staged through
pinned host memory. Each rank counts its device collectives and the host
clock spent in them (`Mesh.collective_s`).

`launch(fn, nprocs, *args)` runs `fn(*args)` on `nprocs` ranks: it spawns
them itself (`torch.multiprocessing`, a `file://` rendezvous in a temporary
directory) when this process belongs to no group, or joins the group that
torchrun describes (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`).
`rank_device` gives a rank its device, `cuda:{local_rank % device_count}`,
so two ranks may share one card.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import re
import signal
import socket
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
GRACE_S = 60.0  # how long an interrupted launch waits for rank 0 to stop its followers
# A follower waits on the command group between requests; see the docstring.
_IDLE_TIMEOUT = datetime.timedelta(days=365)
_AXES = ("dp", "sp", "tp")




def device_backend(places: List[tuple]) -> str:
    """The device groups' backend from every rank's (host, device): NCCL
    when each rank has a card of its own (and torch has NCCL), gloo
    otherwise."""
    own_cards = all(dev.startswith("cuda") for _, dev in places) and len(set(places)) == len(places)
    return "nccl" if own_cards and dist.is_nccl_available() else "gloo"


class Mesh:
    """This rank's place in a (dp, sp, tp) mesh over the ranks of the
    default process group, with the gloo groups of its host exchanges and
    the device groups of its tp and sp axes (those above 1)."""

    def __init__(self, dp: int, sp: int, tp: int, timeout: float, device: Optional[torch.device] = None):
        self.shape: Dict[str, int] = {"dp": dp, "sp": sp, "tp": tp}
        self.rank = dist.get_rank()
        self.size = dp * sp * tp
        self.coord: Dict[str, int] = dict(zip(_AXES, (int(c) for c in np.unravel_index(self.rank, (dp, sp, tp)))))
        self.timeout = timeout
        self.device = torch.device("cpu" if device is None else device)
        # Every rank creates every group, in the same order (a collective call).
        delta = datetime.timedelta(seconds=timeout)
        self.group = dist.new_group(backend="gloo", timeout=delta)
        self.command_group = dist.new_group(backend="gloo", timeout=_IDLE_TIMEOUT)
        place = (socket.gethostname(), str(self.device) if self.device.type == "cpu" else
                 f"cuda:{self.device.index if self.device.index is not None else torch.cuda.current_device()}")
        self.backend = device_backend(self.all_gather(place))
        grid = np.arange(self.size).reshape(dp, sp, tp)
        self._groups: Dict[str, Any] = {}
        lines = {"tp": [grid[d, s, :] for d in range(dp) for s in range(sp)],
                 "sp": [grid[d, :, t] for d in range(dp) for t in range(tp)]}
        for axis, ranks_of in lines.items():
            if self.shape[axis] <= 1:
                continue
            for ranks in ranks_of:
                g = dist.new_group([int(r) for r in ranks], backend=self.backend, timeout=delta)
                if self.rank in ranks:
                    self._groups[axis] = g
        self.collective_s = 0.0  # host clock in device collectives
        self.collectives = 0
        # The command channel: each handler's ops by name, rank 0's lock over
        # them, the thread inside an op, and why the ranks are out of step.
        self.targets: Dict[str, Any] = {}
        self.lock = threading.Lock()
        self._leading: Optional[int] = None
        self.out_of_step: Optional[str] = None

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

    def attach(self, name: str, target: Any) -> None:
        """Run the ops that rank 0 sends to `name` on `target` (its
        `_local(op, kwargs)`); every rank attaches the same names."""
        self.targets[name] = target

    def lead(self, target: str, op: str, kwargs: Dict[str, Any], *, read_only: bool = False) -> List[Any]:
        """Rank 0: send `op` of `target` to the followers, run it here, and
        return every rank's value in rank order (`run`). A `read_only` op
        changes no rank's model, so its failure on some ranks leaves them in
        step."""
        if not self.is_leader:
            raise RuntimeError(f"rank {self.rank} follows rank 0: run serve_followers() on it")
        if self._leading == threading.get_ident():
            raise RuntimeError(f"{target} op {op} was started inside another mesh op, whose lock it would wait on")
        with self.lock:
            self._leading = threading.get_ident()
            try:
                if self.out_of_step is not None:
                    raise RuntimeError(self.out_of_step)
                command = (target, op, kwargs, read_only)
                self.send_command(command)
                return self.run(*command)
            finally:
                self._leading = None

    def run(self, target: str, op: str, kwargs: Dict[str, Any], read_only: bool) -> Optional[List[Any]]:
        """`op` of `target` on this rank, then every rank's outcome gathered on
        rank 0, which raises its own error, or else a follower's with that
        rank's traceback. An op that is not read-only and failed on some
        ranks and not on others leaves the ranks out of step: every later op
        raises."""
        try:
            value, error = self.targets[target]._local(op, kwargs), None
        except Exception as e:  # noqa: BLE001 — every rank reaches the gather; rank 0 raises
            value, error = None, e
        report = None if error is None else "".join(traceback.format_exception(error))
        outcomes = self.gather((report, value))
        if outcomes is None:
            if report is not None:
                print(f"rank {self.rank}: {op} failed\n{report}", file=sys.stderr, flush=True)
            return None
        failed = [r for r, (rep, _) in enumerate(outcomes) if rep is not None]
        if not read_only and 0 < len(failed) < len(outcomes):
            self.out_of_step = (f"{op} failed on ranks {failed} and not on the others, so the ranks no "
                                "longer hold the same model: restart them")
        if error is not None:
            raise error
        if failed:
            raise RuntimeError(f"rank {failed[0]} failed in {op}:\n{outcomes[failed[0]][0]}")
        return [v for _, v in outcomes]

    def serve(self) -> None:
        """A follower's loop: run each op rank 0 sends, until `stop_followers`.
        A failure goes back to rank 0, which raises it; the loop goes on."""
        while True:
            command = self.receive_command()
            if command is None:
                return
            self.run(*command)

    def stop_followers(self) -> None:
        """Rank 0: end every follower's `serve`."""
        if self.is_leader:
            with self.lock:
                self.send_command(None)

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's `obj` in rank order on rank 0; None on the others."""
        out = [None] * self.size if self.is_leader else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def all_gather(self, obj: Any) -> List[Any]:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """x where the device group takes it: a pinned host copy of a CUDA
        tensor under gloo."""
        if self.backend == "nccl" or x.device.type == "cpu":
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def reduce_sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x summed over the ranks of this rank's `axis` line, in x's dtype
        (the callers pass fp32), into x."""
        t0 = time.time()
        buf = self._staged(x)
        dist.all_reduce(buf, group=self._groups[axis])
        if buf is not x:
            x.copy_(buf)
        self.collective_s += time.time() - t0
        self.collectives += 1
        return x

    def gather_tensors(self, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's x along this rank's `axis` line, in coordinate order,
        on x's device."""
        t0 = time.time()
        buf = self._staged(x)
        pinned = buf.is_pinned() and buf is not x
        out = [torch.empty(buf.shape, dtype=buf.dtype, device=buf.device, pin_memory=pinned)
               for _ in range(self.shape[axis])]
        dist.all_gather(out, buf, group=self._groups[axis])
        if out[0].device != x.device:
            out = [o.to(x.device) for o in out]
        self.collective_s += time.time() - t0
        self.collectives += 1
        return out


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, *, timeout: float = DEFAULT_TIMEOUT_S,
              device=None) -> Mesh:
    """A (dp, sp, tp) mesh over the ranks of the default process group; dp
    defaults to world_size // (sp·tp). `device` is this rank's (the CPU by
    default): the device groups' backend follows every rank's. Every rank
    calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under mesh.launch or torchrun")
    n = dist.get_world_size()
    if dp is None:
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) * tp({tp}) != devices({n})")
    return Mesh(dp, sp, tp, timeout, device)


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


# The tensor-parallel plan of the reference's base_model_tp_plan, as in JAX:
# colwise splits the output features (a kernel's last axis, and the bias),
# rowwise the input features (axis 0). A 3-D kernel (stacked layers) shifts
# the plan one axis right. Specs are tuples of axis names, as JAX's P().
_TP_COLWISE = re.compile(r"(q_proj|k_proj|v_proj|gate_proj|up_proj)$")
_TP_ROWWISE = re.compile(r"(o_proj|down_proj)$")


def _tp_spec_for(path: str, ndim: int) -> tuple:
    """The tp spec of the leaf at `path` ("/a/b/kernel"): where "tp" stands,
    that axis splits; () is whole."""
    parts = path.split("/")
    owner = parts[-2] if len(parts) >= 2 else ""
    leaf = parts[-1]
    if leaf == "kernel" and ndim in (2, 3):
        lead = (None,) * (ndim - 2)
        if _TP_COLWISE.search(owner):
            return (*lead, None, "tp")
        if _TP_ROWWISE.search(owner):
            return (*lead, "tp", None)
    if leaf == "bias" and ndim in (1, 2) and _TP_COLWISE.search(owner):
        return (*((None,) * (ndim - 1)), "tp")
    return ()


def tp_slice(x: torch.Tensor, spec: tuple, index: int, count: int) -> torch.Tensor:
    """Part `index` of `count` of x along the axis where `spec` says "tp",
    as a tensor of its own (the whole one can be freed); x itself when the
    spec is whole."""
    if "tp" not in spec or count == 1:
        return x
    axis = spec.index("tp")
    n = x.shape[axis]
    if n % count:
        raise ValueError(f"axis {axis} of {n} does not divide by tp = {count}")
    return x.narrow(axis, index * (n // count), n // count).clone()


def shard_params_tp(mesh: Mesh, params: Any) -> Any:
    """This rank's slice of every leaf of `params` by the tp plan
    (`_tp_spec_for` of its path), by its tp coordinate."""
    index, count = mesh.coord["tp"], mesh.shape["tp"]

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}") for i, v in enumerate(tree))
        if not isinstance(tree, torch.Tensor):
            return tree
        return tp_slice(tree, _tp_spec_for(path, tree.ndim), index, count)

    return walk(params, "")


def unshard_params_tp(mesh: Mesh, params: Any) -> Any:
    """The whole tree from every tp rank's `shard_params_tp` slice of it:
    each split leaf gathered over this rank's tp line (every rank of the
    line calls it, in the same order)."""
    if mesh.shape["tp"] == 1:
        return params

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}") for i, v in enumerate(tree))
        spec = _tp_spec_for(path, tree.ndim) if isinstance(tree, torch.Tensor) else ()
        if "tp" not in spec:
            return tree
        return torch.cat(mesh.gather_tensors(tree, "tp"), dim=spec.index("tp"))

    return walk(params, "")


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
