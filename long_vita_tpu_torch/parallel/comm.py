"""Communicators: the collectives that shard_map gives the JAX package.

Where the JAX package writes ``jax.lax.ppermute`` / ``all_to_all`` /
``all_gather`` / ``psum`` inside a ``shard_map`` over a named mesh axis, the
port's SPMD code (every rank runs the same program on its own shard) calls
one small interface on the communicator of that axis:

  - ``rank``, ``size``;
  - ``ring_shift(x, shift)``: send x to rank + shift, receive from rank -
    shift (a uniform ``ppermute``);
  - ``all_to_all(x, split_dim, cat_dim)``: ``jax.lax.all_to_all(...,
    tiled=True)``: x is cut into ``size`` pieces along split_dim, piece j
    goes to rank j, and the pieces received are concatenated along cat_dim
    in rank order;
  - ``all_reduce_sum(x)``, ``all_gather(x, dim)`` (tiled), ``barrier()``;
  - ``reduce_scatter(x, dim)``: ``jax.lax.psum_scatter(..., tiled=True)``:
    the sum over ranks, cut into ``size`` pieces along dim, piece j kept
    by rank j (one reduction of the same operands, in rank order, so it
    equals a slice of all_reduce_sum bit for bit);
  - ``send_recv(x, dst, src, shape, dtype, device)``: send x to rank dst
    and receive a tensor of (shape, dtype, device) from rank src, either
    None for nothing (one tick of a ``ppermute`` whose pairs change from
    tick to tick: the pipeline's shifts, parallel/pipeline.py); every rank
    of the communicator calls it at the same point, also with nothing to
    send or receive;
  - ``broadcast(x, src)``: every rank gets src's x
    (``multihost_utils.broadcast_one_to_all``, which the JAX package's
    serving lockstep uses);
  - ``host_comm()``: the communicator of the same ranks whose collectives
    take CPU tensors (the serving lockstep's channel carries host bytes,
    inference/multihost.py);
  - ``split(groups)``: the communicator of the group (a list of this
    communicator's ranks) that holds this rank; every rank calls it with
    the same partition.

Three implementations:

  - ``LocalComm``: one rank, every collective the identity;
  - ``ThreadComm``: P ranks as threads of one process on one device,
    exchanging tensors through shared slots behind a ``threading.Barrier``
    (the counterpart of the 8 virtual CPU devices of the JAX tests, and the
    way the cp paths run on a machine with one GPU: NCCL does not put two
    ranks of a communicator on one device). ``run_thread_ranks`` runs a
    function on such ranks;
  - ``DistComm``: a ``torch.distributed`` process group, NCCL on the card
    and gloo on the CPU. Gloo has no ``all_to_all`` (and no send/recv of
    CUDA tensors), so on gloo ``all_to_all`` is built from
    ``batch_isend_irecv``; ring_shift is ``batch_isend_irecv`` on both.
    ``host_comm()`` of an NCCL group is a gloo group of the same ranks,
    made once beside it: the lockstep channel broadcasts host bytes (a
    request's tile stack can be several GB), which over NCCL would take a
    copy to the card and back on every rank. A gloo group made with
    ``staged_device="cuda"`` (``init_process_group``) takes CUDA operands:
    each is copied to pinned host memory, exchanged by gloo, and copied
    back, and the copies' seconds and bytes are counted (``staged_seconds``,
    ``staged_bytes``); the sums and concatenations run on the card (a
    reduce-scatter exchanges the pieces point to point and sums each rank's
    piece in rank order; an all-gather exchanges them point to point; an
    all-reduce is the two), so that the host only copies and sends. It exists so that processes
    sharing one card can train (NCCL puts no two ranks on one GPU) and is
    never chosen implicitly.

Megatron's conjugate collectives, as autograd Functions over a
communicator (the tensor-parallel training path, models/qwen2.py):
``copy_to_tp`` (identity forward, all-reduce backward), ``reduce_from_tp``
(all-reduce forward, identity backward), ``gather_from_tp`` (all-gather
forward, the rank's own slice backward), ``gather_seq`` (all-gather along
the sequence forward, reduce-scatter backward) and ``scatter_seq``
(reduce-scatter forward, all-gather backward). On one rank each is the
identity.

Every wait has a timeout that raises (``TimeoutError``): a rank that hangs
or dies fails the others instead of stalling them. ThreadComm ranks on one
GPU share its current stream, so a tensor one rank deposits is complete, in
stream order, before another rank's later kernels read it; a received
tensor is a copy the receiver owns, as it would be across devices.
"""
from __future__ import annotations

import datetime
import threading
from typing import Callable, Optional, Sequence

import torch

DEFAULT_TIMEOUT = 600.0  # seconds any one wait may take


class Comm:
    """The interface (see the module docstring)."""

    rank: int
    size: int
    timeout: float = DEFAULT_TIMEOUT

    def ring_shift(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, split_dim: int, cat_dim: int) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def send_recv(self, x: Optional[torch.Tensor], dst: Optional[int], src: Optional[int],
                  shape=None, dtype=None, device=None) -> Optional[torch.Tensor]:
        raise NotImplementedError

    def host_comm(self) -> "Comm":
        return self

    def split(self, groups: Sequence[Sequence[int]]) -> "Comm":
        raise NotImplementedError

    def _my_group(self, groups: Sequence[Sequence[int]]) -> tuple[int, ...]:
        flat = sorted(r for g in groups for r in g)
        if flat != list(range(self.size)):
            raise ValueError(f"groups {groups} must partition ranks 0..{self.size - 1}")
        return next(tuple(g) for g in groups if self.rank in g)


class LocalComm(Comm):
    """One rank: every collective is the identity (a copy where the
    others return a fresh tensor)."""

    rank, size = 0, 1

    def ring_shift(self, x, shift=1):
        return x.clone()

    def all_to_all(self, x, split_dim, cat_dim):
        return x.clone()

    def all_reduce_sum(self, x):
        return x.clone()

    def all_gather(self, x, dim=0):
        return x.clone()

    def reduce_scatter(self, x, dim=0):
        return x.clone()

    def barrier(self):
        pass

    def broadcast(self, x, src=0):
        if src != 0:
            raise ValueError(f"src {src} is not a rank of a one-rank communicator")
        return x

    def send_recv(self, x, dst, src, shape=None, dtype=None, device=None):
        if dst is not None or src is not None:
            raise ValueError("a one-rank communicator has no other rank to send to or receive from")
        return None

    def split(self, groups):
        self._my_group(groups)
        return self


def _pieces(x: torch.Tensor, n: int, dim: int) -> list[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide into {n} pieces")
    return list(torch.chunk(x, n, dim))


class _Shared:
    """The state the thread-ranks of one group share: one slot per rank, a
    barrier, and the world's registry of groups, so that a failing rank can
    break every barrier at once."""

    def __init__(self, size: int, timeout: float, world: Optional["_Shared"] = None):
        self.size = size
        self.timeout = timeout
        self.slots = [None] * size
        self.barrier_ = threading.Barrier(size, timeout=timeout)
        self.world = world or self
        if world is None:
            self.lock = threading.Lock()
            self.groups: dict = {}
            self.members: list[_Shared] = [self]

    def exchange(self, rank: int, value, consume: Callable[[list], object]):
        """Deposit value, wait for every rank, -> consume(every rank's value).
        A second wait keeps each deposit alive and unchanged until every
        rank has consumed it: the consumer's copies are issued (on the
        shared stream) before any rank's later work."""
        self.slots[rank] = value
        self.wait(rank)
        out = consume(list(self.slots))
        self.wait(rank)
        return out

    def wait(self, rank: int) -> None:
        try:
            self.barrier_.wait()
        except threading.BrokenBarrierError:
            raise TimeoutError(
                f"thread-rank {rank} of {self.size}: a rank did not arrive within "
                f"{self.timeout} s, or another rank failed"
            ) from None

    def abort(self) -> None:
        for g in self.world.members:
            g.barrier_.abort()


class ThreadComm(Comm):
    """Rank ``rank`` of ``shared.size`` thread-ranks (build them with
    ``ThreadComm.group(size)`` or ``run_thread_ranks``)."""

    def __init__(self, rank: int, shared: _Shared):
        self.rank, self.size = rank, shared.size
        self.timeout = shared.timeout
        self._shared = shared
        self._splits: dict = {}

    @staticmethod
    def group(size: int, timeout: float = DEFAULT_TIMEOUT) -> list["ThreadComm"]:
        """The communicators of ``size`` thread-ranks, one for each thread."""
        shared = _Shared(size, timeout)
        return [ThreadComm(r, shared) for r in range(size)]

    def _exchange(self, value, consume):
        return self._shared.exchange(self.rank, value, consume)

    def ring_shift(self, x, shift=1):
        src = (self.rank - shift) % self.size
        return self._exchange(x, lambda vals: vals[src].clone())

    def all_to_all(self, x, split_dim, cat_dim):
        return self._exchange(
            _pieces(x, self.size, split_dim),
            lambda vals: torch.cat([vals[j][self.rank] for j in range(self.size)], cat_dim),
        )

    def all_reduce_sum(self, x):
        # one reduction of the same operands on every rank: the same bits everywhere
        return self._exchange(x, lambda vals: torch.stack(vals).sum(0))

    def all_gather(self, x, dim=0):
        return self._exchange(x, lambda vals: torch.cat(vals, dim))

    def reduce_scatter(self, x, dim=0):
        # this rank's piece of every rank's operand, summed in rank order
        return self._exchange(
            _pieces(x, self.size, dim),
            lambda vals: torch.stack([vals[j][self.rank] for j in range(self.size)]).sum(0),
        )

    def barrier(self):
        self._exchange(None, lambda vals: None)

    def broadcast(self, x, src=0):
        # only src's deposit is read; every rank takes its own copy
        return self._exchange(x if self.rank == src else None,
                              lambda vals: vals[src].clone())

    def send_recv(self, x, dst, src, shape=None, dtype=None, device=None):
        def consume(vals):
            if src is None:
                return None
            to, sent = vals[src]
            if to != self.rank:
                raise ValueError(f"thread-rank {self.rank} receives from {src}, which sends to "
                                 f"{to}")
            return sent.clone()

        return self._exchange((dst, x), consume)

    def split(self, groups):
        mine = self._my_group(groups)
        key = tuple(tuple(g) for g in groups)
        if key not in self._splits:
            world = self._shared.world
            with world.lock:
                table = world.groups.setdefault(id(self._shared), {})
                if key not in table:
                    table[key] = {}
                    for g in key:
                        table[key][g] = _Shared(len(g), self._shared.timeout, world)
                        world.members.append(table[key][g])
            self._splits[key] = ThreadComm(mine.index(self.rank), table[key][mine])
        return self._splits[key]

    def abort(self) -> None:
        """Break every barrier of this rank's world (a failing rank calls it,
        so the others raise at once instead of at their timeout)."""
        self._shared.abort()


_MATH_PRIMED = False


def _prime_cpu_math() -> None:
    """Call PyTorch's vectorised CPU math kernels once on this thread.

    Their vector bodies (SLEEF on x86) are bound at the first call, and two
    threads making that first call together can be handed a less accurate
    variant: torch.cos came out 1.5e-4 off in about 2 of 100 fresh
    processes whose two threads called it at once (a [1, 32, 16] f32 rope
    table, AVX512 build), never once a thread had called it before. Thread-
    ranks leave a barrier together, so the first ranks to reach a rope
    table or a softmax would race; once per process, before any of them
    starts, every such kernel is bound here."""
    global _MATH_PRIMED
    if _MATH_PRIMED:
        return
    for dtype in (torch.float32, torch.float64):
        x = torch.linspace(0.1, 0.9, 64, dtype=dtype)
        for fn in (torch.cos, torch.sin, torch.tan, torch.exp, torch.exp2, torch.expm1,
                   torch.log, torch.log2, torch.log10, torch.log1p, torch.tanh, torch.sigmoid,
                   torch.erf, torch.acos, torch.asin, torch.atan, torch.sinh, torch.cosh,
                   torch.nn.functional.silu, torch.nn.functional.gelu):
            fn(x)
        torch.pow(x, x)
        torch.pow(2.0, x)
        torch.atan2(x, x)
        torch.softmax(x, 0)
        torch.log_softmax(x, 0)
    _MATH_PRIMED = True


def run_thread_ranks(fn: Callable[[ThreadComm], object], size: int, *,
                     timeout: float = DEFAULT_TIMEOUT,
                     join_timeout: Optional[float] = None) -> list:
    """Run ``fn(comm)`` on ``size`` thread-ranks of one process. -> the
    results in rank order. A rank that raises breaks the others' waits; the
    first exception (by rank) is re-raised here. A thread still running
    after ``join_timeout`` seconds (default: 4 x timeout) raises
    TimeoutError (the thread is a daemon and does not keep the process)."""
    _prime_cpu_math()
    comms = ThreadComm.group(size, timeout)
    results: list = [None] * size
    errors: list = [None] * size
    device = torch.cuda.current_device() if torch.cuda.is_available() else None

    def body(r):
        if device is not None:
            torch.cuda.set_device(device)
        try:
            results[r] = fn(comms[r])
        except BaseException as e:  # noqa: BLE001 (re-raised by the caller)
            errors[r] = e
            comms[r].abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True, name=f"rank{r}")
               for r in range(size)]
    for t in threads:
        t.start()
    deadline = join_timeout if join_timeout is not None else 4 * timeout
    t_end = _now() + deadline
    for t in threads:
        t.join(max(0.0, t_end - _now()))
    if any(t.is_alive() for t in threads):
        comms[0].abort()
        raise TimeoutError(f"thread-ranks still running after {deadline} s")
    first_real = next((e for e in errors if e is not None and not isinstance(e, TimeoutError)),
                      None)
    err = first_real or next((e for e in errors if e is not None), None)
    if err is not None:
        raise err
    return results


def _now() -> float:
    import time

    return time.monotonic()


class DistComm(Comm):
    """A torch.distributed process group (the default group when None).
    Collectives on a gloo group take CPU tensors, on an NCCL group CUDA
    tensors on the rank's current device. ``staged``: a gloo group whose
    CUDA operands are staged through pinned host memory (see the module
    docstring); ``stats`` counts the staged copies (shared with the
    group's splits)."""

    def __init__(self, group=None, timeout: float = DEFAULT_TIMEOUT, *, staged: bool = False,
                 stats: Optional[dict] = None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.gloo = dist.get_backend(self.group) == "gloo"
        if staged and not self.gloo:
            raise ValueError("staging through host memory is for gloo groups")
        self.staged = staged
        self.stats = stats if stats is not None else {"seconds": 0.0, "bytes": 0, "copies": 0}
        self.timeout = timeout
        self._splits: dict = {}
        self._host: Optional[DistComm] = None
        self._p2p_ready = False

    @property
    def staged_seconds(self) -> float:
        return self.stats["seconds"]

    @property
    def staged_bytes(self) -> int:
        return self.stats["bytes"]

    def _copy(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """dst <- src, timed and counted; the device's queued work is waited
        for first, so that the time is the copy's own."""
        torch.cuda.synchronize()
        t0 = _now()
        dst.copy_(src)
        torch.cuda.synchronize()
        self.stats["seconds"] += _now() - t0
        self.stats["bytes"] += src.nbytes
        self.stats["copies"] += 1
        return dst

    def _in(self, x: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.device]]:
        """An operand as the group takes it: a staged group's CUDA tensor
        copied into pinned host memory. -> (the operand, the device to
        return the result to, or None)."""
        if not (self.staged and x.is_cuda):
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return self._copy(x, host), x.device

    def _out(self, y: torch.Tensor, device: Optional[torch.device]) -> torch.Tensor:
        if device is None:
            return y
        return self._copy(y, torch.empty(y.shape, dtype=y.dtype, device=device))

    def _peer(self, r: int) -> int:
        return self._dist.get_global_rank(self.group, r)

    def _wait(self, works) -> None:
        for w in works:
            if self.gloo:
                # gloo's wait takes a deadline (and raises past it); NCCL's
                # is enforced by the process group's own timeout
                w.wait(datetime.timedelta(seconds=self.timeout))
            else:
                w.wait()

    def _p2p(self, sends: list, recvs: list) -> None:
        dist = self._dist
        ops = [dist.P2POp(dist.isend, t, self._peer(r), self.group) for r, t in sends]
        ops += [dist.P2POp(dist.irecv, t, self._peer(r), self.group) for r, t in recvs]
        if ops:
            self._wait(dist.batch_isend_irecv(ops))

    def ring_shift(self, x, shift=1):
        if shift % self.size == 0:
            return x.clone()
        x, dev = self._in(x.contiguous())
        out = torch.empty_like(x)
        self._p2p([((self.rank + shift) % self.size, x)],
                  [((self.rank - shift) % self.size, out)])
        return self._out(out, dev)

    def send_recv(self, x, dst, src, shape=None, dtype=None, device=None):
        """Point to point (batch_isend_irecv); a staged group's CUDA
        operands through pinned host memory. Over NCCL the group's first
        point-to-point call is preceded by a barrier of all its ranks (NCCL
        sets up its communicator in the first call, which every rank must
        join)."""
        if not self.gloo and not self._p2p_ready:
            self.barrier()
            self._p2p_ready = True
        sends, recvs, out = [], [], None
        if dst is not None:
            sends.append((dst, self._in(x.contiguous())[0]))
        staged = self.staged and torch.device(device).type == "cuda"
        if src is not None:
            out = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
                   else torch.empty(shape, dtype=dtype, device=device))
            recvs.append((src, out))
        self._p2p(sends, recvs)
        if out is not None and staged:
            return self._out(out, torch.device(device))
        return out

    def _exchange_pieces(self, x, split_dim) -> list:
        """Piece j of x (cut along split_dim) to rank j: -> the pieces
        received, in rank order (this rank's own piece among them)."""
        send = [p.contiguous() for p in _pieces(x, self.size, split_dim)]
        recv = [torch.empty_like(p) for p in send]
        if self.gloo:
            recv[self.rank] = send[self.rank]
            others = [j for j in range(self.size) if j != self.rank]
            self._p2p([(j, send[j]) for j in others], [(j, recv[j]) for j in others])
        else:
            self._dist.all_to_all(recv, send, group=self.group)
        return recv

    def all_to_all(self, x, split_dim, cat_dim):
        x, dev = self._in(x)
        return self._out(torch.cat(self._exchange_pieces(x, split_dim), cat_dim), dev)

    def all_reduce_sum(self, x):
        if self.staged and x.is_cuda and self.size > 1:
            # a reduce-scatter (summed on the card) and an all-gather: every
            # element is summed once, in rank order, and sent to every rank
            flat = x.reshape(-1)
            pad = -flat.numel() % self.size
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            return self.all_gather(self.reduce_scatter(flat, 0), 0)[:x.numel()].view_as(x)
        x, dev = self._in(x)
        out = x.clone() if dev is None else x
        self._wait([self._dist.all_reduce(out, group=self.group, async_op=True)])
        return self._out(out, dev)

    def all_gather(self, x, dim=0):
        if self.staged and x.is_cuda:
            # point to point (gloo's all_gather took ~2x as long for 84 MB
            # pieces between two processes on one host), concatenated on the card
            x = x.contiguous()
            others = [j for j in range(self.size) if j != self.rank]
            recv = {j: torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for j in others}
            mine = self._in(x)[0]
            self._p2p([(j, mine) for j in others], [(j, recv[j]) for j in others])
            # each piece copied from the host straight into its place
            dim %= x.dim()
            n = x.shape[dim]
            out = x.new_empty((*x.shape[:dim], self.size * n, *x.shape[dim + 1:]))
            for j in range(self.size):
                piece = out.narrow(dim, j * n, n)
                if j == self.rank:
                    piece.copy_(x)
                else:
                    self._copy(recv[j], piece)
            return out
        x, dev = self._in(x.contiguous())
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._wait([self._dist.all_gather(parts, x, group=self.group, async_op=True)])
        return self._out(torch.cat(parts, dim), dev)

    def reduce_scatter(self, x, dim=0):
        """NCCL's reduce_scatter_tensor; on gloo (which has none) the
        pieces are exchanged point to point and summed in rank order (a
        staged group copies only the pieces that travel, and sums on the
        card)."""
        if self.staged and x.is_cuda:
            pieces = [p.contiguous() for p in _pieces(x, self.size, dim)]
            others = [j for j in range(self.size) if j != self.rank]
            mine = pieces[self.rank]
            recv = {j: torch.empty(mine.shape, dtype=x.dtype, pin_memory=True) for j in others}
            self._p2p([(j, self._in(pieces[j])[0]) for j in others],
                      [(j, recv[j]) for j in others])
            parts = [mine if j == self.rank else self._out(recv[j], x.device)
                     for j in range(self.size)]
            if self.size == 2:  # one addition, the stacked sum's bits without its copy
                return parts[0] + parts[1]
            return torch.stack(parts).sum(0)
        x, dev = self._in(x)
        if self.gloo:
            return self._out(torch.stack(self._exchange_pieces(x, dim)).sum(0), dev)
        whole = x.movedim(dim, 0).contiguous()
        if whole.shape[0] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide into {self.size} pieces")
        out = whole.new_empty((whole.shape[0] // self.size, *whole.shape[1:]))
        self._wait([self._dist.reduce_scatter_tensor(out, whole, group=self.group,
                                                     async_op=True)])
        return out.movedim(0, dim)

    def barrier(self):
        self.all_reduce_sum(torch.zeros(1, device=self._device()))

    def broadcast(self, x, src=0):
        """src's x on every rank: a CPU tensor on gloo, a CUDA tensor on
        NCCL (``host_comm()`` broadcasts host bytes beside an NCCL group)."""
        x, dev = self._in(x.contiguous())
        out = x.clone() if dev is None else x
        self._wait([self._dist.broadcast(out, self._peer(src), group=self.group,
                                         async_op=True)])
        return self._out(out, dev)

    def host_comm(self):
        """This group on gloo: itself when it is gloo (a staged group passes
        host tensors through as they are), else a gloo group of the same
        ranks with the same timeout, made on the first call (every rank of
        the group calls it at the same point)."""
        if self.gloo:
            return self
        if self._host is None:
            pg = self._dist.new_group([self._peer(r) for r in range(self.size)],
                                      backend="gloo",
                                      timeout=datetime.timedelta(seconds=self.timeout),
                                      use_local_synchronization=True)
            self._host = DistComm(pg, self.timeout)
        return self._host

    def _device(self):
        if self.gloo:
            return torch.device("cpu")
        return torch.device("cuda", torch.cuda.current_device())

    def split(self, groups):
        mine = self._my_group(groups)
        if mine not in self._splits:
            # only the members create (and synchronise on) their group
            pg = self._dist.new_group([self._peer(r) for r in mine],
                                      use_local_synchronization=True)
            self._splits[mine] = (DistComm(pg, self.timeout, staged=self.staged,
                                           stats=self.stats)
                                  if len(mine) > 1 else LocalComm())
        return self._splits[mine]


def init_process_group(rank: int, world_size: int, init_method: str, *,
                       backend: Optional[str] = None,
                       timeout: float = DEFAULT_TIMEOUT,
                       staged_device: Optional[str] = None) -> DistComm:
    """torch.distributed.init_process_group with a timeout (NCCL when CUDA
    is available, else gloo), -> the world's DistComm. On CUDA the rank
    takes device ``rank % device_count``. ``staged_device="cuda"`` (with
    backend "gloo" only): the group takes CUDA operands through pinned host
    memory, so that several processes can share one card (DistComm)."""
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if staged_device is not None and (staged_device != "cuda" or backend != "gloo"):
        raise ValueError(f"staged_device {staged_device!r} needs backend 'gloo' and 'cuda', "
                         f"got backend {backend!r}")
    kw = {}
    if backend == "nccl" or staged_device is not None:
        dev = rank % torch.cuda.device_count()
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return DistComm(timeout=timeout, staged=staged_device is not None)




class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_sum(g), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.chunk(g, ctx.comm.size, ctx.dim)[ctx.comm.rank].contiguous(), None, None


def _pad_rows(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """x with zero rows appended along ``dim`` up to ``rows`` (GSPMD's
    padding of a dim that does not split evenly); x itself when it has
    them."""
    pad = rows - x.shape[dim]
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, n):
        ctx.comm, ctx.dim = comm, dim
        out = comm.all_gather(x, dim)
        ctx.rows = out.shape[dim]
        return out if n == ctx.rows else out.narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, g):
        g = _pad_rows(g.contiguous(), ctx.dim, ctx.rows)
        return ctx.comm.reduce_scatter(g, ctx.dim), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return comm.reduce_scatter(_pad_rows(x, dim, comm.size * seq_slice(ctx.n, comm.size)),
                                   dim)

    @staticmethod
    def backward(ctx, g):
        out = ctx.comm.all_gather(g.contiguous(), ctx.dim)
        if ctx.n != out.shape[ctx.dim]:
            out = out.narrow(ctx.dim, 0, ctx.n).contiguous()
        return out, None, None


def copy_to_tp(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Identity forward; the gradient summed over ``comm`` (Megatron's f:
    a replicated input to a sharded computation). Over tq (2-D tp,
    models/qwen2.py): a row kernel's input, the same on every tq rank,
    whose product gives each rank its own hidden slice of the output; the
    transpose of reduce_from_tp there."""
    return x if comm.size == 1 else _CopyToTP.apply(x, comm)


def reduce_from_tp(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Sum over ``comm`` forward; the gradient passed through (Megatron's g).
    Over tq (2-D tp, models/qwen2.py): a column kernel's contraction, each
    rank's partial product of its hidden slice summed; every tq rank goes
    on with the same sum and so holds its whole gradient, and the product's
    own backward cuts the input's gradient back to the rank's slice."""
    return x if comm.size == 1 else _ReduceFromTP.apply(x, comm)


def gather_from_tp(x: torch.Tensor, comm: Comm, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` forward; the gradient's own slice backward
    (Megatron's gather_from_tensor_model_parallel_region: every rank goes
    on with the same whole tensor, so its gradient is the same on each)."""
    return x if comm.size == 1 else _GatherFromTP.apply(x, comm, dim)


def seq_slice(n: int, size: int) -> int:
    """The rows of one rank's slice when ``n`` rows of a sequence are cut
    over ``size`` ranks: ceil(n / size), the last slices carrying zero
    rows past the end where ``n`` does not split (GSPMD's padded layout)."""
    return -(-n // size)


def gather_seq(x: torch.Tensor, comm: Comm, dim: int = 1, n: Optional[int] = None) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter backward (sequence
    parallelism: the rank's slice of the sequence -> the whole). ``n``: the
    whole's true row count (default: the slices' sum); the zero rows that
    pad the last slices (``seq_slice``) are dropped, and the backward pads
    the gradient with zeros before its reduce-scatter."""
    if comm.size == 1:
        return x
    return _GatherSeq.apply(x, comm, dim, x.shape[dim] * comm.size if n is None else n)


def scatter_seq(x: torch.Tensor, comm: Comm, dim: int = 1) -> torch.Tensor:
    """Reduce-scatter along ``dim`` forward, all-gather backward (partial
    sums of the whole sequence -> the rank's summed slice). A whole that
    does not split over ``comm`` is padded with zero rows first, so each
    rank gets ``seq_slice(n, size)`` rows; the backward drops the pad
    rows' gradient after its all-gather."""
    return x if comm.size == 1 else _ScatterSeq.apply(x, comm, dim)
