#
# The multi-process control plane and process group: the port's counterpart
# of spark_rapids_ml_tpu/parallel/context.py.
#
# Control plane (host strings, as the JAX package's): a `Rendezvous` is an
# allgather of small strings plus a barrier, every round bounded by a
# deadline (`config["rendezvous_timeout_s"]`) and typed on failure
# (`RendezvousTimeoutError`, transient; `RankFailedError`, a peer is known
# dead). A failing rank publishes `abort(reason)` so its peers raise at once
# instead of waiting the deadline out; `begin_epoch(n)` re-namespaces the
# rounds so a retried fit never reads a failed attempt's. Substrates:
# `LocalRendezvous` (threads of one process, the tests), `FileRendezvous`
# (processes over a shared directory, with heartbeat files so a killed peer
# surfaces within 2x the heartbeat interval), `BarrierRendezvous` (a Spark
# BarrierTaskContext-shaped object). The first two can reform around a dead
# rank (`can_reform`): `reform(dead_ranks, generation)` agrees with the
# other live ranks on the surviving set and returns a new rendezvous over
# it, the ranks renumbered and `live_ranks` naming their original ids;
# `FileRendezvous.rejoin` admits a respawned rank at the next reform round.
# `core.recoverable_stage` opens such a recovery epoch.
#
# Data plane: `TpuContext` opens one torch.distributed process group per
# job. Rank 0 advertises host:port through one allgather, and every rank
# calls `init_process_group` with the round deadline as its timeout. The
# backend follows from the topology the ranks agree on: "nccl" when every
# rank has a CUDA card of its own, "gloo" when ranks share a card or run on
# the CPU (gloo stages tensors through host memory). A failed NCCL group is
# an error; nothing switches to gloo after it. The group's one collective is
# an all-gather of per-rank tensors (`ProcessGroup.allgather`); every
# cross-rank sum (`allreduce_fixed`) adds the gathered partials in rank
# order on the rank's own device, so every rank holds the same bits,
# whichever backend carried them, and the host loops that read them (the
# Lloyd shift, the GLM flags) stop at the same iteration on every rank.
# A timeout or a peer's failure inside a collective is raised as
# RendezvousTimeoutError or RankFailedError, never as a bare RuntimeError.
# At a recovery epoch (`TpuContext.adopt_reform`) nothing of the old group
# is reused (the lost rank may be rank 0, the host of its TCP store): the
# group is torn down within a bound (NCCL's communicators aborted first)
# and a new one is opened over the reformed rendezvous, the new rank 0
# advertising a new address.
#
# One process driving several chips (core.py's fan-out) runs the same
# rank-sharded code, one thread per chip, over `LocalGroup`: the group's
# interface without torch.distributed (backend "local"). Its collectives
# meet at the threads' `LocalRendezvous` barrier, bounded by the round
# deadline; every caller gets fresh tensors on its own device, and a thread
# that fails publishes its failure so its peers unwind with RankFailedError
# naming it. An in-process group is not reformed (`InProcessRendezvous`
# cannot): the fit's own retry and the sweep ledger's resume apply, as on
# one device. The active `TpuContext` is context-local, so each chip's
# thread sees its own.
#
from __future__ import annotations

import contextlib
import contextvars
import datetime
import json
import logging
import os
import re
import socket
import threading
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

from ..errors import RankFailedError, RendezvousTimeoutError
from ..utils import lockcheck

_LOG = logging.getLogger(__name__)

__all__ = [
    "Rendezvous", "LocalRendezvous", "InProcessRendezvous", "FileRendezvous", "BarrierRendezvous", "TpuContext",
    "ProcessGroup", "LocalGroup", "allgather_ndarray", "allgather_concat", "allreduce_fixed", "fit_group_scope", "ABORT_PREFIX",
]

# --------------------------------------------------------------------------
# Abort channel: a failing rank publishes its failure so its peers raise a
# typed RankFailedError within about one poll tick. The sentinel is a plain
# string, so it travels over any substrate (a slot of LocalRendezvous, an
# `abort_rank_<r>` file of FileRendezvous).
# --------------------------------------------------------------------------

ABORT_PREFIX = "ABORT:"

# A peer is declared dead when its heartbeat file is staler than this many
# heartbeat intervals: half an interval of slack against false positives,
# detection within 2x the interval.
_HEARTBEAT_MISS_FACTOR = 1.5

# FileRendezvous polls its round files every 5 ms; the failure scan (abort
# files and heartbeat times) runs at this coarser cadence.
_FAILURE_SCAN_INTERVAL_S = 0.05


def format_abort(rank: int, reason: str) -> str:
    """``ABORT:<rank>:<reason>`` sentinel (reason newline-flattened)."""
    return f"{ABORT_PREFIX}{int(rank)}:{' '.join(str(reason).split())}"


def parse_abort(payload: str) -> Optional[Tuple[int, str]]:
    """(rank, reason) when `payload` is an abort sentinel, else None."""
    if not payload.startswith(ABORT_PREFIX):
        return None
    body = payload[len(ABORT_PREFIX):]
    rank_s, _, reason = body.partition(":")
    try:
        return int(rank_s), reason
    except ValueError:  # malformed: an abort of an unknown rank
        return -1, body


def allgather_ndarray(rendezvous: "Rendezvous", arr, chunk_bytes: Optional[int] = None) -> List:
    """Allgather a host numpy array through the string control plane (base64
    of its .npy encoding); returns the per-rank arrays in rank order.

    Large arrays go in row chunks of at most `chunk_bytes` (default
    ``config["broadcast_chunk_bytes"]``); the ranks first agree on the number
    of rounds (the largest), so a rank with few or no rows still joins every
    round."""
    import base64
    import io

    import numpy as np

    if chunk_bytes is None:
        from ..core import config

        chunk_bytes = int(config.get("broadcast_chunk_bytes", 8 << 30))

    def ser(a):
        buf = io.BytesIO()
        np.save(buf, a, allow_pickle=False)
        return base64.b64encode(buf.getvalue()).decode("ascii")

    def de(p):
        return np.load(io.BytesIO(base64.b64decode(p)), allow_pickle=False)

    arr = np.ascontiguousarray(arr)  # at least 1-d: a scalar is one row
    row_bytes = max(1, arr[:1].nbytes)
    rows_per_chunk = max(1, chunk_bytes // row_bytes)
    n = arr.shape[0]
    n_chunks = max(1, -(-n // rows_per_chunk))
    # every rank must agree on the ROUND COUNT, not only on its own chunking
    n_chunks = max(int(p) for p in rendezvous.allgather(str(n_chunks)))
    rows_per_chunk = max(1, -(-n // n_chunks))
    gathered = []
    for c in range(n_chunks):
        part = arr[c * rows_per_chunk:(c + 1) * rows_per_chunk]
        gathered.append([de(p) for p in rendezvous.allgather(ser(part))])
    out = []
    for r in range(rendezvous.nranks):
        parts = [gathered[c][r] for c in range(n_chunks)]
        out.append(np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0])
    return out


def allgather_concat(rendezvous: "Rendezvous", arr):
    """Every rank's row block concatenated in rank order: (global array,
    this rank's row offset)."""
    import numpy as np

    blocks = allgather_ndarray(rendezvous, arr)
    offset = sum(len(b) for b in blocks[: rendezvous.rank])
    return np.concatenate(blocks, axis=0), offset


class Rendezvous:
    """Control-plane interface: allgather small strings, and a barrier.

    In-tree substrates implement `_allgather_impl`; `allgather` wraps it
    with the `rendezvous.rounds` and `rendezvous.payload_bytes` counters
    and the `rendezvous.allgather_s` histogram (telemetry on). Every round
    is bounded by a deadline (the instance's `timeout_s`, else
    ``config["rendezvous_timeout_s"]``) and raises RendezvousTimeoutError
    when it elapses; a failing rank calls `abort(reason)` so its peers raise
    RankFailedError promptly. `begin_epoch(n)` re-namespaces the rounds for
    retry attempt n."""

    rank: int
    nranks: int
    # whether this substrate can agree on a reduced rank set after a peer
    # dies (`reform`); one with its own supervisor (a Spark barrier stage)
    # cannot: the stage fails and Spark relaunches it
    can_reform: bool = False
    # the original rank ids of the current membership, in current-rank order
    # (None: never reformed, the identity); failures keep naming original
    # ranks across recovery epochs
    _live_ranks: Optional[List[int]] = None
    reform_generation: int = 0

    @property
    def live_ranks(self) -> List[int]:
        return list(self._live_ranks) if self._live_ranks is not None else list(range(self.nranks))

    @property
    def orig_rank(self) -> int:
        return self.live_ranks[self.rank]

    def reform(self, dead_ranks=(), generation: int = 1) -> "Rendezvous":
        """The membership reform round: agree with the other live ranks on
        the surviving set (admitting a respawned rank that votes within the
        window) and return a NEW rendezvous over it, in a fresh namespace,
        the ranks renumbered 0..len(live)-1 and `live_ranks` mapping back to
        the original ids. `dead_ranks` (original ids) seeds the known-dead
        set; the round's own evidence decides beyond it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support membership reform; rank failures stay terminal on it"
        )

    def allgather(self, payload: str) -> List[str]:
        from .. import telemetry

        # the flight-recorder events of a round (`rdv_enter`/`rdv_exit`)
        # arrive with A15
        if not telemetry.enabled():
            return self._allgather_impl(payload)
        t0 = time.perf_counter()
        out = self._allgather_impl(payload)
        reg = telemetry.registry()
        reg.inc("rendezvous.rounds")
        reg.inc("rendezvous.payload_bytes", len(payload))
        reg.observe("rendezvous.allgather_s", time.perf_counter() - t0)
        return out

    def _allgather_impl(self, payload: str) -> List[str]:
        raise NotImplementedError

    def barrier(self, timeout_s: Optional[float] = None) -> None:
        """An empty-payload allgather; `timeout_s` overrides this one round's
        deadline (the bounded teardown of TpuContext.__exit__)."""
        if timeout_s is None:
            self.allgather("")
            return
        prev = self._get_timeout_override()
        self._set_timeout_override(timeout_s)
        try:
            self.allgather("")
        finally:
            self._set_timeout_override(prev)

    # the override sits behind a hook pair so a wrapper (ChaosRendezvous)
    # can forward it to the inner instance whose _allgather_impl reads it
    def _get_timeout_override(self) -> Optional[float]:
        return getattr(self, "_timeout_override", None)

    def _set_timeout_override(self, value: Optional[float]) -> None:
        self._timeout_override = value

    def abort(self, reason: str) -> None:
        """Publish this rank's failure so its peers stop waiting. A no-op
        by default: a substrate with its own supervisor (a Spark barrier
        stage) needs no in-band abort channel."""

    def peer_failure(self) -> Optional[Tuple[int, str]]:
        """(rank, reason) of a failure a peer published in this epoch, or
        None; reads without waiting. The process group names the failed
        rank with it when a collective breaks."""
        return None

    def begin_epoch(self, epoch: int) -> None:
        """Re-namespace the rounds for retry attempt `epoch`: round counters
        reset and the previous epoch's abort markers no longer count."""

    def close(self) -> None:
        """Release background resources (the heartbeat thread)."""

    def _round_timeout_s(self) -> float:
        """The round deadline: a one-round override (bounded teardown), else
        the instance's own timeout, else the config key."""
        override = getattr(self, "_timeout_override", None)
        if override is not None:
            return float(override)
        own = getattr(self, "timeout_s", None)
        if own is not None:
            return float(own)
        from ..core import config

        return float(config.get("rendezvous_timeout_s", 300.0))

    def _raise_rank_failed(self, rank: int, reason: str, round_index: Optional[int]) -> None:
        from .. import telemetry

        telemetry.registry().inc("rendezvous.rank_failures")
        raise RankFailedError(rank, reason, round_index=round_index)

    def _raise_timeout(self, round_index: int, missing: Optional[List[int]], timeout_s: float) -> None:
        from .. import telemetry

        telemetry.registry().inc("rendezvous.timeouts")
        who = f"ranks {missing} " if missing else ""
        raise RendezvousTimeoutError(
            f"rendezvous round {round_index}: {who}missing after {timeout_s}s",
            round_index=round_index, missing_ranks=missing, timeout_s=timeout_s,
        )


class LocalRendezvous(Rendezvous):
    """Thread-barrier rendezvous for N ranks inside one process (the test
    harness): real collective code paths on one machine."""

    can_reform = True

    class _Shared:
        def __init__(self, nranks: int):
            self.barrier = threading.Barrier(nranks)
            self.slots: List[Any] = [None] * nranks
            self.lock = lockcheck.make_lock("parallel.context.LocalRendezvous._Shared.lock")
            self.abort_info: Optional[Tuple[int, str]] = None
            self.epoch = 0
            # generation -> (live original ranks, the survivors' _Shared):
            # the FIRST reformer builds the entry and the others adopt it, so
            # every survivor agrees on one membership and one fresh barrier
            self.reforms: dict = {}

    def __init__(self, rank: int, shared: "_Shared", timeout_s: Optional[float] = None):
        self.rank = rank
        self.nranks = shared.barrier.parties
        self.timeout_s = timeout_s  # None -> config["rendezvous_timeout_s"]
        self._shared = shared
        self._round = 0
        self._epoch = 0

    @classmethod
    def create(cls, nranks: int, timeout_s: Optional[float] = None) -> List["LocalRendezvous"]:
        shared = cls._Shared(nranks)
        return [cls(r, shared, timeout_s) for r in range(nranks)]

    def reform(self, dead_ranks=(), generation: int = 1) -> "LocalRendezvous":
        """The thread substrate's reform: the first survivor to arrive takes
        the live set (the current membership less `dead_ranks`) and builds
        the survivors' fresh shared barrier; later arrivals adopt that
        entry, so all survivors agree by construction."""
        from .. import telemetry

        shared = self._shared
        generation = int(generation)
        with shared.lock:
            entry = shared.reforms.get(generation)
            if entry is None:
                dead = {int(r) for r in dead_ranks}
                live = [r for r in self.live_ranks if r not in dead]
                if not live:
                    raise RankFailedError(-1, "reform left no live ranks", round_index=None)
                entry = (live, LocalRendezvous._Shared(len(live)))
                shared.reforms[generation] = entry
        live, new_shared = entry
        if self.orig_rank not in live:
            raise RankFailedError(self.orig_rank, "this rank was declared dead by the reform round")
        new = LocalRendezvous(live.index(self.orig_rank), new_shared, self.timeout_s)
        new._live_ranks = list(live)
        new.reform_generation = generation
        telemetry.registry().inc("rendezvous.reforms")
        # the flight-recorder event (`recovery_reform`) arrives with A15
        return new

    def abort(self, reason: str) -> None:
        """Publish ``ABORT:<rank>:<reason>`` (one more slot write) and break
        the barrier, so every peer blocked in a round wakes with a typed
        RankFailedError."""
        from .. import telemetry

        shared = self._shared
        with shared.lock:
            if shared.abort_info is None:
                shared.abort_info = (self.rank, str(reason))
                cur = shared.slots[self.rank]
                if not (isinstance(cur, tuple) and cur[0] == self._epoch):
                    # a current-epoch payload stays: peers past the round's
                    # data barrier must still read the whole round, and learn
                    # of the abort from `abort_info` at the next one
                    shared.slots[self.rank] = format_abort(self.rank, reason)
        telemetry.registry().inc("rendezvous.aborts_published")
        shared.barrier.abort()

    def peer_failure(self) -> Optional[Tuple[int, str]]:
        info = self._shared.abort_info
        return None if info is None or info[0] == self.rank else info

    def begin_epoch(self, epoch: int) -> None:
        # once per epoch: only the first rank to ask resets the barrier and
        # the state; a later reset would break peers already waiting in the
        # new epoch's first round
        shared = self._shared
        with shared.lock:
            if shared.epoch >= epoch > 0:
                self._round = 0
                self._epoch = int(epoch)
                return
            shared.epoch = epoch
            shared.abort_info = None
            for i in range(self.nranks):
                shared.slots[i] = None
            # inside the lock: no peer can enter the new epoch's first wait
            # before the reset is done
            shared.barrier.reset()
        self._round = 0
        self._epoch = int(epoch)

    def _wait(self, round_index: int, timeout_s: float) -> None:
        """`barrier.wait` bounded by the round deadline; a broken barrier
        becomes RankFailedError when an abort was published, else the
        symmetric RendezvousTimeoutError."""
        try:
            self._shared.barrier.wait(timeout=timeout_s)
        except threading.BrokenBarrierError:
            info = self._shared.abort_info
            if info is not None:
                self._raise_rank_failed(info[0], info[1], round_index)
            self._raise_timeout(round_index, None, timeout_s)

    def _allgather_impl(self, payload: str) -> List[str]:
        shared = self._shared
        round_index = self._round
        self._round += 1
        info = shared.abort_info
        if info is not None:  # a peer failed in an earlier round: fail fast
            self._raise_rank_failed(info[0], info[1], round_index)
        timeout_s = self._round_timeout_s()
        # slots carry (epoch, round, payload): a straggler of a failed epoch
        # must not exchange payloads with a retried epoch's round
        shared.slots[self.rank] = (self._epoch, round_index, payload)
        self._wait(round_index, timeout_s)
        out_tagged = list(shared.slots)
        try:
            self._wait(round_index, timeout_s)  # a fast rank must not overwrite slots early
        except (RankFailedError, RendezvousTimeoutError):
            # every rank published this round (the first wait tripped), so
            # the copy is the whole exchange unless it is torn; the failure
            # surfaces at the next round's entry
            if not all(isinstance(it, tuple) and it[0] == self._epoch and it[1] == round_index
                       for it in out_tagged):
                raise
        out: List[str] = []
        for r, item in enumerate(out_tagged):
            aborted = parse_abort(item) if isinstance(item, str) else None
            if aborted is not None:
                self._raise_rank_failed(aborted[0], aborted[1], round_index)
            if not isinstance(item, tuple) or item[0] != self._epoch or item[1] != round_index:
                from .. import telemetry

                telemetry.registry().inc("rendezvous.timeouts")
                raise RendezvousTimeoutError(
                    f"rendezvous round {round_index}: rank {r} delivered a payload from a "
                    "different epoch/round (desync after a failed attempt)",
                    round_index=round_index, missing_ranks=[r], timeout_s=timeout_s,
                )
            out.append(item[2])
        return out


class InProcessRendezvous(LocalRendezvous):
    """The rendezvous of one process's chips (core.py's fan-out): a
    `LocalRendezvous` that does not reform. A lost chip thread fails the
    fit, and the fit's own retry runs it again over every chip."""

    can_reform = False

    @classmethod
    def create(cls, nranks: int, timeout_s: Optional[float] = None) -> List["InProcessRendezvous"]:
        shared = LocalRendezvous._Shared(nranks)
        return [cls(r, shared, timeout_s) for r in range(nranks)]


class BarrierRendezvous(Rendezvous):
    """Adapter over a Spark `BarrierTaskContext`-shaped object: anything with
    ``allGather(str) -> list[str]``, ``partitionId()`` and
    ``getTaskInfos()``. Inside a barrier stage's task,
    ``TpuContext(rank, nranks, BarrierRendezvous(ctx))``."""

    def __init__(self, barrier_ctx, rank: Optional[int] = None, nranks: Optional[int] = None):
        self._ctx = barrier_ctx
        self.rank = int(barrier_ctx.partitionId()) if rank is None else rank
        self.nranks = len(barrier_ctx.getTaskInfos()) if nranks is None else nranks

    def _allgather_impl(self, payload: str) -> List[str]:
        return list(self._ctx.allGather(payload))


class FileRendezvous(Rendezvous):
    """Cross-process rendezvous over a shared directory: each rank writes
    its payload to ``<root>/round_<i>/rank_<r>`` (write, then rename: the
    file appears whole) and polls until all N exist. A rank's heartbeat file
    is touched from a daemon thread every `heartbeat_interval_s`; a pending
    peer whose heartbeat stops progressing for 1.5 intervals is declared
    dead (RankFailedError), and a published `abort_rank_<r>` file is seen
    within one failure scan. It reforms around a dead rank (`reform`) and
    admits a respawned one (`rejoin`)."""

    can_reform = True

    def __init__(
        self,
        rank: int,
        nranks: int,
        root: str,
        timeout_s: Optional[float] = None,
        run_id: Optional[str] = None,
        heartbeat_interval_s: Optional[float] = None,
        live_ranks: Optional[List[int]] = None,
        anchor_root: Optional[str] = None,
    ):
        """`run_id`, a fresh nonce the launcher passes to every rank,
        namespaces this run's rounds, so the files of an earlier run in the
        same root are never read as current; without it the root must be
        fresh per run. `timeout_s` is the round deadline (None: the config
        key); `heartbeat_interval_s` (None: ``config["heartbeat_interval_s"]``)
        must be the same on every rank, and <= 0 turns the heartbeat off.
        `anchor_root` (set by `reform`, never by a launcher) pins the reform
        and rejoin directories to the ORIGINAL run root across generations:
        reformed planes nest under ``<anchor>/reform_g<N>/plane``, so a
        respawned rank over the original root and a twice-reformed survivor
        agree on where the membership windows open and where the rejoin
        markers appear."""
        self.rank = rank
        self.nranks = nranks
        self.root = os.path.join(root, run_id) if run_id else root
        self._anchor = anchor_root if anchor_root else self.root
        self.timeout_s = timeout_s
        self._round = 0
        self._epoch = 0
        if heartbeat_interval_s is None:
            from ..core import config

            heartbeat_interval_s = float(config.get("heartbeat_interval_s", 5.0))
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # per peer (last mtime seen, local monotonic time it was first seen):
        # staleness is the lack of mtime progress on this rank's own clock,
        # never the writer's clock against the reader's
        self._hb_seen: dict = {}
        self._live_ranks = list(live_ranks) if live_ranks is not None else None
        # wall-clock time a reform formed this plane (None: not a reformed
        # plane); a rejoin marker older than it was answered by that reform
        self._formed_at: Optional[float] = None
        os.makedirs(self.root, exist_ok=True)
        if run_id is None:
            # a reused root: an earlier run's abort or rejoin marker for this
            # rank would make this run's peers declare it dead at once
            pat = re.compile(rf"^((e\d+_)?abort|rejoin_wait)_rank_{self.rank}$")
            with contextlib.suppress(OSError):
                for name in os.listdir(self.root):
                    if pat.match(name):
                        with contextlib.suppress(OSError):
                            os.unlink(os.path.join(self.root, name))
            if anchor_root is None:
                self._clean_stale_reform_dirs()
        # heartbeat from construction: a rank that dies before its first
        # round leaves a stale file, which a peer can detect, not none
        self._ensure_heartbeat()

    def _clean_stale_reform_dirs(self) -> None:
        """A reused root without a run_id: a crashed earlier run's
        ``reform_g*`` trees would close this run's first membership window at
        once with the wrong live set. Only trees with no recent file
        activity go: a LIVE window (a peer already reforming, survivors
        heartbeating on a reformed plane) has fresh files and stays."""
        import shutil

        bound = max(60.0, 2.0 * self._round_timeout_s(), 4.0 * max(0.0, self.heartbeat_interval_s))
        now = time.time()  # compared with file mtimes, which are wall-clock
        try:
            names = [n for n in os.listdir(self.root) if re.match(r"^reform_g\d+$", n)]
        except OSError:
            return
        for name in names:
            tree = os.path.join(self.root, name)
            newest = 0.0
            for dirpath, _dirnames, filenames in os.walk(tree):
                for entry in [dirpath] + [os.path.join(dirpath, f) for f in filenames]:
                    with contextlib.suppress(OSError):
                        newest = max(newest, os.path.getmtime(entry))
            if now - newest > bound:
                shutil.rmtree(tree, ignore_errors=True)

    def _eprefix(self) -> str:
        """The epoch namespace of round and abort files ('' for the first
        attempt)."""
        return "" if self._epoch == 0 else f"e{self._epoch}_"

    def _abort_path(self, rank: int) -> str:
        return os.path.join(self.root, f"{self._eprefix()}abort_rank_{rank}")

    def _heartbeat_path(self, rank: int) -> str:
        return os.path.join(self.root, f"heartbeat_rank_{rank}")

    def _rejoin_wait_path(self, orig_rank: int) -> str:
        # keyed by the ORIGINAL rank id (stable across reforms), without an
        # epoch (it describes an incarnation, not a round), at the anchor: a
        # respawn over the original root and a survivor on its g<N> plane
        # must agree on it
        return os.path.join(self._anchor, f"rejoin_wait_rank_{orig_rank}")

    def _touch_heartbeat(self) -> None:
        path = self._heartbeat_path(self.rank)
        try:
            with open(path, "a"):
                pass
            os.utime(path, None)
        except OSError:  # a transient file-system error: the next beat retries
            pass

    def _ensure_heartbeat(self) -> None:
        if self.heartbeat_interval_s <= 0:
            return
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._touch_heartbeat()

        def beat() -> None:
            while not self._hb_stop.wait(self.heartbeat_interval_s):
                self._touch_heartbeat()

        self._hb_stop.clear()
        self._hb_thread = threading.Thread(target=beat, name=f"srml-heartbeat-rank{self.rank}", daemon=True)
        self._hb_thread.start()

    def close(self) -> None:
        """Stop the heartbeat thread."""
        self._hb_stop.set()

    def __del__(self):  # pragma: no cover - collection time
        with contextlib.suppress(Exception):
            self._hb_stop.set()

    def abort(self, reason: str) -> None:
        """Publish ``abort_rank_<rank>`` carrying the abort sentinel (write,
        then rename); peers see it within one failure scan."""
        from .. import telemetry

        tmp = os.path.join(self.root, f".abort_rank_{self.rank}.tmp")
        try:
            with open(tmp, "w") as f:
                f.write(format_abort(self.rank, reason))
            os.replace(tmp, self._abort_path(self.rank))
        except OSError:  # best effort by design
            return
        telemetry.registry().inc("rendezvous.aborts_published")

    def peer_failure(self) -> Optional[Tuple[int, str]]:
        for r in range(self.nranks):
            if r == self.rank:
                continue
            path = self._abort_path(r)
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        parsed = parse_abort(f.read())
                except OSError:
                    parsed = None
                return parsed if parsed is not None else (r, "abort file unreadable")
        return None

    def begin_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self._round = 0

    # -- membership reform ---------------------------------------------------

    def _reform_dir(self, generation: int) -> str:
        # at the anchor: generation N+1's window must be found both by the
        # survivors on the g<N> plane and by a respawn over the original root
        return os.path.join(self._anchor, f"reform_g{int(generation)}")

    def latest_generation(self) -> Optional[int]:
        """The highest reform generation opened under the anchor root (how
        a respawned rank finds the epoch boundary to rejoin at)."""
        best = None
        try:
            for name in os.listdir(self._anchor):
                m = re.match(r"^reform_g(\d+)$", name)
                if m:
                    best = int(m.group(1)) if best is None else max(best, int(m.group(1)))
        except OSError:
            return None
        return best

    def rejoin(self, generation: Optional[int] = None) -> "FileRendezvous":
        """A respawned rank's entry: vote in the open reform round (found by
        `latest_generation` when not given, polled for within the round
        deadline: a respawn usually starts while the survivors are still
        detecting the death) and join the reformed group at the epoch
        boundary. The survivors' window must still be open when the vote
        lands (``config["recovery_rejoin_grace_s"]`` holds it open).

        It publishes a ``rejoin_wait_rank_<orig>`` marker FIRST: this
        incarnation's heartbeat touches the dead rank's liveness file from
        construction, which would make the corpse look alive to survivors
        blocked in a round; the marker is positive evidence that the
        original incarnation died, so they raise RankFailedError within one
        failure scan. The marker is removed on admission."""
        me = self.orig_rank
        tmp = os.path.join(self.root, f".rejoin_wait_rank_{me}.tmp")
        with contextlib.suppress(OSError):  # best effort: survivors fall back to the round deadline
            with open(tmp, "w") as f:
                f.write(json.dumps({"rank": me, "t": time.time()}))
            os.replace(tmp, self._rejoin_wait_path(me))
        if generation is None:
            deadline = time.monotonic() + self._round_timeout_s()
            while True:
                generation = self.latest_generation()
                if generation is not None:
                    break
                if time.monotonic() > deadline:
                    raise RendezvousTimeoutError(
                        "rejoin: no reform round opened under this root within the deadline",
                        timeout_s=self._round_timeout_s(),
                    )
                time.sleep(0.02)  # the poll tick inside the deadline-bounded wait
        reformed = self.reform(dead_ranks=(), generation=generation)
        with contextlib.suppress(OSError):
            os.unlink(self._rejoin_wait_path(me))
        return reformed

    def reform(self, dead_ranks=(), generation: int = 1) -> "FileRendezvous":
        """The file substrate's reform. Each participant votes by writing
        ``member_rank_<orig>`` under ``reform_g<generation>`` (write, then
        rename), then waits until every expected rank has voted or is
        evidently dead (its abort file exists, or its heartbeat does not
        progress within the staleness window). A vote from outside the
        expected set (a respawned rank rejoining) is admitted. The window
        stays open at least ``config["recovery_rejoin_grace_s"]``, unless
        every originally expected rank has voted. The agreed live set is
        then confirmed in one allgather round on the reformed plane: a
        mismatch (a vote landing after one side closed its window) is the
        transient RendezvousTimeoutError, never a split group."""
        from .. import telemetry
        from ..core import config

        generation = int(generation)
        member_dir = self._reform_dir(generation)
        os.makedirs(member_dir, exist_ok=True)
        me = self.orig_rank
        tmp = os.path.join(member_dir, f".member_rank_{me}.tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps({"rank": me, "t": time.time()}))
        os.replace(tmp, os.path.join(member_dir, f"member_rank_{me}"))

        dead = {int(r) for r in dead_ranks}
        live_map = self.live_ranks  # the current index of each original id
        expected = set(live_map)
        stale_after = _HEARTBEAT_MISS_FACTOR * self.heartbeat_interval_s if self.heartbeat_interval_s > 0 else 2.0
        grace = float(config.get("recovery_rejoin_grace_s", 0.0))
        timeout_s = self._round_timeout_s()
        start = time.monotonic()
        deadline = start + timeout_s
        member_pat = re.compile(r"^member_rank_(\d+)$")
        while True:
            filed = set()
            for name in os.listdir(member_dir):
                m = member_pat.match(name)
                if m:
                    filed.add(int(m.group(1)))
            now_m = time.monotonic()
            pending = expected - filed - dead
            for r in list(pending):
                cur = live_map.index(r)
                if os.path.exists(self._abort_path(cur)):
                    dead.add(r)
                    pending.discard(r)
                    continue
                # no vote yet: alive only while its heartbeat progresses
                try:
                    mtime = os.path.getmtime(self._heartbeat_path(cur))
                except OSError:
                    mtime = None
                seen = self._hb_seen.get(("reform", r))
                if mtime is not None and (seen is None or mtime != seen[0]):
                    self._hb_seen[("reform", r)] = (mtime, now_m)
                    continue
                base_t = seen[1] if seen is not None else start
                if now_m - base_t > stale_after:
                    dead.add(r)
                    pending.discard(r)
            # every originally expected member (a respawned incarnation of a
            # dead rank included) has voted: no vote can follow, so the
            # window may close before the grace
            if not pending and (now_m - start >= grace or filed >= expected):
                break
            if now_m > deadline:
                telemetry.registry().inc("rendezvous.timeouts")
                raise RendezvousTimeoutError(
                    f"reform generation {generation}: ranks {sorted(pending)} neither voted nor died "
                    f"within {timeout_s}s",
                    missing_ranks=sorted(pending), timeout_s=timeout_s,
                )
            time.sleep(0.01)  # the poll tick inside the deadline-bounded window
        # a vote proves a live process: the dead set only says whom the
        # window stops waiting for, so a respawned incarnation of a rank
        # seeded dead that votes inside the window is admitted
        live = sorted(filed)
        if me not in live:
            raise RankFailedError(me, "this rank was excluded by the reform round", round_index=None)
        new = FileRendezvous(
            live.index(me), len(live), os.path.join(member_dir, "plane"), timeout_s=self.timeout_s,
            heartbeat_interval_s=self.heartbeat_interval_s, live_ranks=live, anchor_root=self._anchor,
        )
        new.reform_generation = generation
        new._formed_at = time.time()  # compared with the markers' mtimes, which are wall-clock
        # the confirmation round: every member states the set it computed
        confirmed = new.allgather("REFORM:" + json.dumps(live))
        if any(p != confirmed[0] for p in confirmed):
            new.close()
            telemetry.registry().inc("rendezvous.timeouts")
            raise RendezvousTimeoutError(
                f"reform generation {generation}: members disagree on the live set (a vote landed after "
                "the window closed)",
                timeout_s=timeout_s,
            )
        telemetry.registry().inc("rendezvous.reforms")
        # the flight-recorder event (`recovery_reform`) arrives with A15
        return new

    def _check_failures(self, pending, round_index: int) -> None:
        """Raise RankFailedError when a peer published an abort in this
        epoch, a pending peer's respawned incarnation announced that it
        waits to rejoin (the original is dead even though the respawn keeps
        the liveness file fresh), or a pending peer's heartbeat went stale
        (a killed process publishes nothing)."""
        info = self.peer_failure()
        if info is not None:
            self._raise_rank_failed(info[0], info[1], round_index)
        live = self.live_ranks
        for r in pending:
            if r == self.rank:
                continue
            # the rejoin marker outranks heartbeat progress; the CURRENT
            # index is raised, as the abort and heartbeat paths raise it
            # (recoverable_stage maps it through live_ranks once). A marker
            # older than this plane was answered by the reform that formed
            # it (the respawn voted there and removes the marker once the
            # confirmation round is through, maybe after a peer's next scan)
            try:
                marked = os.path.getmtime(self._rejoin_wait_path(live[r]))
            except OSError:
                continue
            if self._formed_at is None or marked >= self._formed_at:
                self._raise_rank_failed(
                    r,
                    f"process died (original rank {live[r]}); a respawned incarnation is waiting to rejoin "
                    "at the next reform round",
                    round_index,
                )
        if self.heartbeat_interval_s <= 0:
            return
        stale_after = _HEARTBEAT_MISS_FACTOR * self.heartbeat_interval_s
        now_m = time.monotonic()
        for r in pending:
            if r == self.rank:
                continue
            try:
                mtime = os.path.getmtime(self._heartbeat_path(r))
            except OSError:
                continue  # not started yet: only the round deadline applies
            seen = self._hb_seen.get(r)
            if seen is None or mtime != seen[0]:
                self._hb_seen[r] = (mtime, now_m)  # progress: alive
                continue
            stale_for = now_m - seen[1]
            if stale_for > stale_after:
                self._raise_rank_failed(
                    r,
                    f"heartbeat stale for {stale_for:.2f}s (interval {self.heartbeat_interval_s}s): "
                    "process presumed dead",
                    round_index,
                )

    def _allgather_impl(self, payload: str) -> List[str]:
        self._ensure_heartbeat()
        round_index = self._round
        round_dir = os.path.join(self.root, f"{self._eprefix()}round_{round_index}")
        self._round += 1
        os.makedirs(round_dir, exist_ok=True)
        tmp = os.path.join(round_dir, f".rank_{self.rank}.tmp")
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, os.path.join(round_dir, f"rank_{self.rank}"))
        timeout_s = self._round_timeout_s()
        deadline = time.monotonic() + timeout_s
        out: List[Optional[str]] = [None] * self.nranks
        pending = set(range(self.nranks))
        next_scan = 0.0  # the first pass scans at once
        while pending:
            for r in list(pending):
                path = os.path.join(round_dir, f"rank_{r}")
                if os.path.exists(path):
                    with open(path) as f:
                        out[r] = f.read()
                    pending.discard(r)
            if pending:
                now_m = time.monotonic()
                if now_m >= next_scan:
                    self._check_failures(pending, round_index)
                    next_scan = now_m + _FAILURE_SCAN_INTERVAL_S
                if now_m > deadline:
                    self._raise_timeout(round_index, sorted(pending), timeout_s)
                time.sleep(0.005)  # the poll tick inside the deadline-bounded round
        return out  # type: ignore[return-value]


# ---------------------------------------------------------- data plane ----


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _topology_entry(device) -> dict:
    """What a rank states about its device, for the backend choice: its
    host, the device type, and the card's identity (its UUID where torch
    reports one, else its index)."""
    entry = {"host": socket.gethostname(), "type": device.type, "card": None}
    if device.type == "cuda":
        import torch

        index = device.index if device.index is not None else torch.cuda.current_device()
        uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
        entry["card"] = str(uuid) if uuid is not None else f"index:{index}"
    return entry


def choose_backend(topology: Sequence[dict]) -> str:
    """"nccl" when every rank has a CUDA card of its own, else "gloo"
    (ranks sharing a card, or on the CPU)."""
    if topology and all(t["type"] == "cuda" for t in topology):
        cards = {(t["host"], t["card"]) for t in topology}
        if len(cards) == len(topology):
            return "nccl"
    return "gloo"


class ProcessGroup:
    """One torch.distributed process group (the default group of this
    process) and its one collective, the all-gather of per-rank tensors.
    `allreduce_fixed` is the cross-rank sum the solvers use. Host seconds
    inside collectives and their count are kept (`collective_s`, `calls`)
    and counted with the bytes sent (`collective.allgathers`,
    `collective.bytes`, histogram `collective.allgather_s`)."""

    def __init__(self, rank: int, nranks: int, backend: str, device, rendezvous: Rendezvous, timeout_s: float):
        self.rank = rank
        self.nranks = nranks
        self.backend = backend
        self.device = device
        self.rendezvous = rendezvous
        self.timeout_s = timeout_s
        self.collective_s = 0.0
        self.calls = 0
        # seconds of the old group's teardown and this group's open, when
        # it was opened at a recovery epoch (TpuContext.adopt_reform)
        self.reform_s: Optional[dict] = None
        self._open = True

    @classmethod
    def open(cls, rank: int, nranks: int, rendezvous: Rendezvous) -> "ProcessGroup":
        """Agree on the topology and the coordinator through the rendezvous
        (two rounds), then `init_process_group` with the round deadline as
        its timeout, on this process's device (`parallel.default_device`).
        A failure is raised as it is: no other backend is tried."""
        import torch.distributed as dist

        from ..core import config
        from . import default_device

        if dist.is_initialized():
            raise RuntimeError(
                "a torch.distributed process group is already open in this process; "
                "one TpuContext at a time opens one"
            )
        device = default_device()
        topology = [json.loads(p) for p in rendezvous.allgather(json.dumps(_topology_entry(device)))]
        backend = choose_backend(topology)
        host = str(config.get("coordinator_host") or "127.0.0.1")
        if host in ("127.0.0.1", "localhost"):
            # the loopback interface for the backends' own connections
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        advert = json.dumps({"addr": f"{host}:{_free_port(host)}"} if rank == 0 else {})
        addr = json.loads(rendezvous.allgather(advert)[0])["addr"]
        timeout_s = rendezvous._round_timeout_s()
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = device
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}", world_size=nranks, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
        )
        return cls(rank, nranks, backend, device, rendezvous, timeout_s)

    def _fail(self, e: BaseException, what: str):
        """The typed error of a broken collective: RankFailedError naming
        the peer that published its failure, RendezvousTimeoutError when
        the backend's deadline elapsed, else RankFailedError of an unknown
        rank (a peer's connection went away without a word)."""
        from .. import telemetry

        info = self.rendezvous.peer_failure()
        if info is not None:
            telemetry.registry().inc("rendezvous.rank_failures")
            return RankFailedError(info[0], f"{info[1]} (seen in {what})")
        msg = " ".join(str(e).split())[:400]
        if "timed out" in msg.lower() or "timeout" in msg.lower():
            telemetry.registry().inc("rendezvous.timeouts")
            return RendezvousTimeoutError(f"{what}: {msg}", timeout_s=self.timeout_s)
        telemetry.registry().inc("rendezvous.rank_failures")
        return RankFailedError(-1, f"{what} failed: {msg}")

    def allgather(self, t):
        """Every rank's tensor `t` (the same shape and dtype on every rank),
        in rank order, as a list of tensors on `t`'s device. NCCL gathers on
        the card; gloo through host memory."""
        import torch
        import torch.distributed as dist

        from .. import telemetry

        if not self._open:
            raise RuntimeError("the process group is closed")
        t0 = time.perf_counter()
        src = t.contiguous()
        try:
            if self.backend == "nccl":
                out = torch.empty((self.nranks,) + tuple(src.shape), dtype=src.dtype, device=src.device)
                dist.all_gather_into_tensor(out, src)
                parts = list(out.unbind(0))
            else:
                host = src.cpu()
                got = [torch.empty_like(host) for _ in range(self.nranks)]
                dist.all_gather(got, host)
                parts = got if src.device.type == "cpu" else [g.to(src.device) for g in got]
        except RuntimeError as e:
            raise self._fail(e, f"all-gather of {tuple(src.shape)} {src.dtype}") from e
        dt = time.perf_counter() - t0
        nbytes = src.numel() * src.element_size()
        self.collective_s += dt
        self.calls += 1
        if telemetry.enabled():
            reg = telemetry.registry()
            reg.inc("collective.allgathers")
            reg.inc("collective.bytes", nbytes)
            reg.observe("collective.allgather_s", dt)
        return parts

    def allgather_rows(self, t):
        """Every rank's row block [n_r, ...] (row counts may differ), in
        rank order: the counts first, then the blocks padded to the largest
        with zero rows, then cut back."""
        import torch

        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        counts = [int(c) for c in torch.cat(self.allgather(n)).cpu().tolist()]
        top = max(counts)
        if t.shape[0] < top:
            pad = t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))
            t = torch.cat([t, pad])
        return [p[:c] for p, c in zip(self.allgather(t), counts)]

    def allgather_arrays(self, arr) -> List[Any]:
        """Every rank's host array `arr` (the same trailing shape and dtype
        on every rank, the row counts free), in rank order, as host arrays:
        through host memory under gloo, through the card under NCCL."""
        import torch

        from . import host_tensor

        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        parts = self.allgather_rows(host_tensor(arr).to(dev))
        return [p.cpu().numpy() for p in parts]

    def allreduce_fixed(self, *tensors):
        """The cross-rank sum of each tensor (the same shapes and dtypes on
        every rank): one all-gather per dtype of them all, flattened, then
        the partials added in rank order on this rank's device, so every
        rank gets the same bits. Returns the sums in the order given."""
        return _allreduce_in_rank_order(self, tensors)

    def close(self) -> None:
        import torch.distributed as dist

        if self._open and dist.is_initialized():
            with contextlib.suppress(Exception):
                dist.destroy_process_group()
        self._open = False

    def teardown(self, timeout_s: float) -> None:
        """Take the group down after a rank loss, within `timeout_s`: NCCL's
        communicators are aborted (a collective with a dead peer may hold
        them), gloo's group destroyed. The call runs on a helper thread; if
        it has not returned by the bound, RendezvousTimeoutError is raised
        and no new group can be opened in this process."""
        import torch.distributed as dist

        if not self._open:
            return
        self._open = False
        if not dist.is_initialized():
            return
        failure: List[BaseException] = []

        def down() -> None:
            try:
                abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
                if self.backend == "nccl" and abort is not None:
                    abort()  # aborts every communicator, then forgets the groups
                else:
                    dist.destroy_process_group()
            except BaseException as e:  # noqa: BLE001 - reported below
                failure.append(e)

        worker = threading.Thread(target=down, name="srml-group-teardown", daemon=True)
        worker.start()
        worker.join(timeout_s)
        if worker.is_alive():
            from .. import telemetry

            telemetry.registry().inc("rendezvous.timeouts")
            raise RendezvousTimeoutError(
                f"the {self.backend} process group did not tear down within {timeout_s}s after a rank loss",
                timeout_s=timeout_s,
            )
        if failure and dist.is_initialized():
            raise RankFailedError(-1, f"the {self.backend} process group could not be torn down: {failure[0]}")


class LocalGroup:
    """The in-process group of one process driving several chips: the
    interface of `ProcessGroup` (`allgather`, `allgather_rows`,
    `allgather_arrays`, `allreduce_fixed` in rank order, `collective_s`,
    `calls`, `close`, `teardown`), backend "local", over the threads'
    `InProcessRendezvous`. It never touches torch.distributed.

    Each rank publishes a private copy of its tensor in one rendezvous
    round (the round's barrier bounds the wait by the round deadline; a
    peer's published failure ends it with RankFailedError), then copies
    every rank's onto its own device: a copy across cards, a clone on the
    same card, so the solvers may write into what they get."""

    backend = "local"

    def __init__(self, rank: int, nranks: int, device, rendezvous: LocalRendezvous):
        self.rank = rank
        self.nranks = nranks
        self.device = device
        self.rendezvous = rendezvous
        self.timeout_s = rendezvous._round_timeout_s()
        self.collective_s = 0.0
        self.calls = 0
        self.reform_s: Optional[dict] = None
        self._open = True

    def _exchange(self, obj) -> List[Any]:
        """Every rank's `obj` in rank order, through one rendezvous round
        (not counted as a control-plane round)."""
        if not self._open:
            raise RuntimeError("the in-process group is closed")
        return self.rendezvous._allgather_impl(obj)

    def _count(self, t0: float, nbytes: int) -> None:
        from .. import telemetry

        dt = time.perf_counter() - t0
        self.collective_s += dt
        self.calls += 1
        if telemetry.enabled():
            reg = telemetry.registry()
            reg.inc("collective.allgathers")
            reg.inc("collective.bytes", nbytes)
            reg.observe("collective.allgather_s", dt)

    def allgather(self, t):
        """Every rank's tensor `t`, in rank order, as fresh tensors on this
        rank's device."""
        t0 = time.perf_counter()
        parts = self._exchange(t.contiguous().clone())
        dev = t.device
        out = [p.clone() if p.device == dev else p.to(dev) for p in parts]
        self._count(t0, t.numel() * t.element_size())
        return out

    def allgather_rows(self, t):
        """Every rank's row block [n_r, ...] (row counts may differ: threads
        exchange tensors of any shape), in rank order, on this rank's
        device."""
        return self.allgather(t)

    def allgather_arrays(self, arr) -> List[Any]:
        """Every rank's host array `arr`, in rank order, as fresh host
        arrays."""
        import numpy as np

        t0 = time.perf_counter()
        parts = self._exchange(np.array(arr, copy=True))
        out = [np.array(p, copy=True) for p in parts]
        self._count(t0, int(getattr(arr, "nbytes", 0)))
        return out

    def allreduce_fixed(self, *tensors):
        """The cross-rank sum of each tensor: one exchange per dtype, the
        partials added in rank order on this rank's device, so every rank
        gets the same bits (`ProcessGroup.allreduce_fixed`'s arithmetic)."""
        return _allreduce_in_rank_order(self, tensors)

    def close(self) -> None:
        self._open = False

    def teardown(self, timeout_s: float) -> None:
        self._open = False


def _allreduce_in_rank_order(group, tensors):
    """Sum each of `tensors` across `group`'s ranks: one all-gather per
    dtype of them all, flattened, then the partials added in rank order."""
    import torch

    out: List[Any] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, x in enumerate(tensors):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idxs in by_dtype.values():
        parts = group.allgather(torch.cat([tensors[i].reshape(-1) for i in idxs]))
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        lo = 0
        for i in idxs:
            n = tensors[i].numel()
            out[i] = acc[lo:lo + n].reshape(tensors[i].shape)
            lo += n
    return tuple(out)


# The process group a multi-process fit's solvers reduce over: set by the
# fit path (core.py) for the extent of an SPMD fit of an estimator that
# supports it, nowhere else. Context-local, so a thread of another fit does
# not see it.
_FIT_GROUP: "contextvars.ContextVar[Optional[ProcessGroup]]" = contextvars.ContextVar(
    "srml_torch_fit_group", default=None
)


@contextlib.contextmanager
def fit_group_scope(group: Optional[ProcessGroup]) -> Iterator[None]:
    token = _FIT_GROUP.set(group)
    try:
        yield
    finally:
        _FIT_GROUP.reset(token)


def allreduce_fixed(*tensors):
    """The cross-rank sums of `tensors` in a multi-process fit
    (`ProcessGroup.allreduce_fixed`); the tensors themselves otherwise.
    Always a tuple."""
    group = _FIT_GROUP.get()
    if group is None:
        return tuple(tensors)
    return group.allreduce_fixed(*tensors)


# The context entered by the caller, if any: `with TpuContext(...):
# est.fit(local_df)` routes the fit through that process group.
# Context-local: each chip's thread of a fan-out enters its own.
_ACTIVE_CONTEXT: "contextvars.ContextVar[Optional[TpuContext]]" = contextvars.ContextVar(
    "srml_torch_active_context", default=None
)


class TpuContext:
    """The per-job process group, as a context manager (the JAX package's
    name, so the same user code runs on both packages).

      * ``nranks == 1``: no process group (one process on one device),
        unless `require_distributed` asks for one (a one-rank group);
      * ``nranks > 1``: a multi-process fit, each rank holding its own row
        block. A rendezvous is required; the process group is opened on
        enter (`ProcessGroup.open`) and closed on exit.

    On exit after an exception the rank's failure is published first
    (`rendezvous.abort`; a relayed RankFailedError is not published again),
    then the group is destroyed; after success the group is destroyed and a
    barrier bounded by ``config["teardown_timeout_s"]`` is passed, a peer's
    failure or a timeout there only logged: this rank's results are
    whole."""

    def __init__(
        self,
        rank: int,
        nranks: int,
        rendezvous: Optional[Rendezvous] = None,
        *,
        require_distributed: bool = False,
        group: Optional["LocalGroup"] = None,
    ):
        self.rank = rank
        self.nranks = nranks
        self.rendezvous = rendezvous
        self.require_distributed = require_distributed
        # a given group (the in-process `LocalGroup` of a fan-out) is used
        # as it is; otherwise one is opened on enter when nranks > 1
        self._given_group = group
        self.group: Any = None
        self.recovery_generation = 0
        # the reformed rendezvous this context adopted (closed on exit; the
        # caller's own is the caller's to close)
        self._adopted: List[Rendezvous] = []
        self._token: Any = None

    @classmethod
    def current(cls) -> Optional["TpuContext"]:
        """The context the caller entered, if any (the estimators read it)."""
        return _ACTIVE_CONTEXT.get()

    def live_ranks_hint(self) -> List[int]:
        """The original rank ids of the current membership (the identity
        when the rendezvous tracks none)."""
        if self.rendezvous is not None:
            return list(getattr(self.rendezvous, "live_ranks", range(self.nranks)))
        return list(range(self.nranks))

    def adopt_reform(self, new_rendezvous: Rendezvous) -> None:
        """Adopt a reformed (survivor) rendezvous at a recovery epoch
        (`core.recoverable_stage`): the renumbered rank and size, and a NEW
        process group over it. Nothing of the old group is reused, since
        the lost rank may have hosted its store: it is torn down within the
        teardown bound (`ProcessGroup.teardown`), then `ProcessGroup.open`
        runs over the reformed rendezvous, where the new rank 0 advertises a
        new address. A teardown that does not return, or a group that cannot
        be opened, raises typed; no other backend is tried."""
        from ..core import config

        old = self.group
        self.rendezvous = new_rendezvous
        self.rank = new_rendezvous.rank
        self.nranks = new_rendezvous.nranks
        self.recovery_generation = int(getattr(new_rendezvous, "reform_generation", 0))
        self._adopted.append(new_rendezvous)
        if old is None:
            return
        self.group = None
        t0 = time.perf_counter()
        old.teardown(min(float(config.get("teardown_timeout_s", 15.0)), new_rendezvous._round_timeout_s()))
        t1 = time.perf_counter()
        try:
            self.group = ProcessGroup.open(self.rank, self.nranks, new_rendezvous)
        except (RankFailedError, RendezvousTimeoutError):
            raise
        except Exception as e:
            msg = " ".join(str(e).split())[:400]
            if "timed out" in msg.lower() or "timeout" in msg.lower():
                raise RendezvousTimeoutError(f"the reformed process group could not be opened: {msg}") from e
            raise RankFailedError(-1, f"the reformed process group could not be opened: {msg}") from e
        self.group.reform_s = {"teardown_s": t1 - t0, "open_s": time.perf_counter() - t1}
        _LOG.info(
            "process group reopened at generation %d: rank %d/%d (original ranks %s), backend %s",
            self.recovery_generation, self.rank, self.nranks, self.live_ranks_hint(), self.group.backend,
        )

    @property
    def is_spmd(self) -> bool:
        """True when each rank holds only its LOCAL row block, so the
        estimators rendezvous for the global layout and statistics."""
        return self.nranks > 1

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else self.group.backend

    def __enter__(self) -> "TpuContext":
        if self._given_group is not None:
            self.group = self._given_group
        elif self.nranks > 1 or self.require_distributed:
            # nranks > 1 always means a multi-process fit: without a live
            # group and a rendezvous, ranks would quietly fit their local
            # block as if it were global
            if self.rendezvous is None:
                raise RuntimeError(
                    "TpuContext with nranks > 1 needs a rendezvous (control-plane "
                    "allgather for partition layout and host-side statistics)"
                )
            self.group = ProcessGroup.open(self.rank, self.nranks, self.rendezvous)
            _LOG.info(
                "process group open: rank %d/%d, backend %s, device %s",
                self.rank, self.nranks, self.group.backend, self.group.device,
            )
        self._token = _ACTIVE_CONTEXT.set(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        if self._token is not None:
            _ACTIVE_CONTEXT.reset(self._token)
            self._token = None
        if (
            self.rendezvous is not None
            and exc_type is not None
            and not (isinstance(exc_val, RankFailedError) or issubclass(exc_type, RankFailedError))
        ):
            # publish the failure FIRST, so peers blocked in a round or a
            # collective unwind at once; a relayed peer failure is not
            # published again (a cascade of abort files would blame a
            # healthy rank). Best effort: it never masks the exception
            with contextlib.suppress(Exception):
                self.rendezvous.abort(f"{exc_type.__name__}: {exc_val}")
        if self.group is not None:
            self.group.close()
        if self.rendezvous is not None and exc_type is None:
            from ..core import config

            teardown_s = min(float(config.get("teardown_timeout_s", 15.0)), self.rendezvous._round_timeout_s())
            try:
                self.rendezvous.barrier(timeout_s=teardown_s)
            except RendezvousTimeoutError:
                _LOG.warning(
                    "teardown barrier timed out after %.1fs (a peer already exited?); "
                    "continuing: local results are complete", teardown_s,
                )
            except RankFailedError as e:
                _LOG.warning(
                    "peer failure during teardown barrier (%s); continuing: local results are complete", e,
                )
        for adopted in self._adopted:
            adopted.close()
        return False
