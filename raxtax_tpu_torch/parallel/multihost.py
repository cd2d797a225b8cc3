"""Multi-process runs on ``torch.distributed``.

The reference is single-process. The JAX package scales across hosts with
``jax.distributed``: one process drives all chips of its host. Here **one
rank is one process and one device**: rank ``r`` drives
``cuda:(local_rank % torch.cuda.device_count())``, or the CPU when
``--device cpu`` asks for it. Every rank runs the same program; the world is
cut into consecutive groups of ``data * model`` ranks (``parallel/mesh.py``),
and a group plays the part of one JAX process:

- without ``--global-mesh`` each group classifies its own contiguous query
  slice (:func:`host_query_slice` by group index) and its first rank writes
  ``raxtax.*.shard<g>`` (:func:`shard_suffix`); with no ``--mesh`` a group
  is one rank running the single-device engine;
- ``--global-mesh`` is one group of the whole world: every rank feeds the
  same global batches and rank 0 alone writes.

The shards are folded into the reference's single-file artifacts by
:func:`consolidate_artifacts` (rank 0, behind a :func:`barrier`), before a
run opens its writers and after it closes them, so a resume under any rank
count starts coherently. :func:`host_query_slice`, :func:`shard_suffix`,
:func:`_shard_paths` and :func:`consolidate_artifacts` are the JAX module's
host code, copied.

Start-up (:func:`maybe_initialize`) reads, in this order: the arguments
(``--coordinator host:port``, ``--num-processes``, ``--process-id``), the
JAX package's environment names (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), and ``torchrun``'s
(``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``),
which take the place of the JAX package's pod auto-detection. The ranks meet
at a ``TCPStore`` on the coordinator's address, exchange (host name, device
index) through it, and pick the backend: NCCL when every rank has a CUDA
device of its own, gloo on the CPU and when two ranks of one host share a
device (NCCL refuses two ranks on one device). A world of one rank, made by
the first mesh of a single-process run, uses a ``HashStore``.
"""

from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path

log = logging.getLogger("raxtax")

#: a rank waits this long for the others at start-up and in a collective
TIMEOUT = timedelta(minutes=30)


@dataclass(frozen=True)
class WorldConfig:
    """Where the ranks meet and who this rank is."""

    host: str
    port: int
    world_size: int
    rank: int
    local_rank: int


def world_config(coordinator: str = "", num_processes: int = 0,
                 process_id: int = -1, environ=None) -> WorldConfig | None:
    """The world this process joins, or None for a single-process run.

    Sources in priority order: the arguments, ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``, then ``torchrun``'s
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
    ``LOCAL_RANK``. A coordinator without a process count or id is an
    error here (``jax.distributed`` may find them on a pod; a GPU host has
    nothing to find them from)."""
    env = os.environ if environ is None else environ
    coordinator = coordinator or env.get("JAX_COORDINATOR_ADDRESS", "")
    if num_processes <= 0:
        num_processes = int(env.get("JAX_NUM_PROCESSES", "0") or 0)
    if process_id < 0:
        process_id = int(env.get("JAX_PROCESS_ID", "-1") or -1)
    local_rank = int(env.get("LOCAL_RANK", "-1") or -1)
    if not coordinator and env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        if num_processes <= 0:
            num_processes = int(env["WORLD_SIZE"])
        if process_id < 0:
            process_id = int(env.get("RANK", "-1") or -1)
    if not coordinator:
        return None
    if num_processes <= 0 or process_id < 0:
        raise ValueError(
            f"coordinator {coordinator} given without the process count "
            "and this process's id (--num-processes/--process-id, "
            "JAX_NUM_PROCESSES/JAX_PROCESS_ID or WORLD_SIZE/RANK)"
        )
    if process_id >= num_processes:
        raise ValueError(
            f"process id {process_id} outside a world of {num_processes}"
        )
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    return WorldConfig(
        host=host, port=int(port), world_size=num_processes,
        rank=process_id, local_rank=process_id if local_rank < 0 else local_rank,
    )


def rank_device(device="cuda", local_rank: int | None = None):
    """This rank's device: ``cuda:(local_rank % device_count)`` (a device
    named with its index stays as named), or the CPU when asked for by name.
    Raises without a GPU unless the CPU is asked for."""
    import torch

    from ..utils.device import resolve_device

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    resolve_device(dev)
    if local_rank is None:
        local_rank = _STATE.get("local_rank", 0)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


#: the world this process initialized: backend, local rank, the gloo group
#: over every rank (barriers, small host objects), whether this module made
#: the default group
_STATE: dict = {}


def _pick_backend(store, rank: int, world: int, device) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo: the
    ranks publish (host name, device) in the store and read each other's."""
    me = f"{socket.gethostname()}|{device}"
    store.set(f"raxtax/device/{rank}", me)
    seen = [store.get(f"raxtax/device/{r}").decode() for r in range(world)]
    if device.type != "cuda":
        return "gloo"
    return "nccl" if len(set(seen)) == world else "gloo"


def _init(store, rank: int, world: int, local_rank: int, device) -> None:
    import torch
    import torch.distributed as dist

    backend = _pick_backend(store, rank, world, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world, timeout=TIMEOUT
    )
    _STATE.update(
        backend=backend, local_rank=local_rank, owned=True,
        host_group=dist.new_group(backend="gloo", timeout=TIMEOUT),
    )


def maybe_initialize(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1,
                     device: str = "cuda") -> tuple[int, int]:
    """Join the configured world (see :func:`world_config`); returns
    ``(process_index, process_count)``, ``(0, 1)`` for a single process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    cfg = world_config(coordinator, num_processes, process_id)
    if cfg is None:
        return 0, 1
    dev = rank_device(device, cfg.local_rank)
    store = dist.TCPStore(
        cfg.host, cfg.port, cfg.world_size, is_master=cfg.rank == 0,
        timeout=TIMEOUT,
    )
    _init(store, cfg.rank, cfg.world_size, cfg.local_rank, dev)
    log.info(
        "torch.distributed initialized: rank %d/%d via %s:%d on %s (%s)",
        cfg.rank, cfg.world_size, cfg.host, cfg.port, dev, _STATE["backend"],
    )
    return cfg.rank, cfg.world_size


def initialize_single(device) -> None:
    """A world of this process alone (``HashStore``), so that a mesh of one
    rank makes real collective calls: NCCL on a CUDA device, gloo on the
    CPU."""
    import torch.distributed as dist

    if not dist.is_initialized():
        _init(dist.HashStore(), 0, 1, 0, device)


def backend() -> str:
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else ""


def host_group():
    """The gloo group over every rank (barriers and host objects), made
    when the world is initialized; a default group made elsewhere gets one
    here (every rank calls this at the same point)."""
    import torch.distributed as dist

    if "host_group" not in _STATE:
        _STATE["host_group"] = dist.new_group(backend="gloo", timeout=TIMEOUT)
    return _STATE["host_group"]


def barrier(name: str) -> None:
    """Every rank waits here for the others (the JAX package's
    ``multihost_utils.sync_global_devices(name)``); a no-op in a single
    process."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        log.debug("barrier %s", name)
        dist.barrier(group=host_group())


def shutdown() -> None:
    """Leave the world this module initialized (a command line run in a
    process that goes on, as a test does, may initialize again)."""
    import torch.distributed as dist

    if dist.is_initialized() and _STATE.get("owned"):
        dist.destroy_process_group()
    _STATE.clear()


def host_query_slice(
    n_queries: int, process_index: int, process_count: int
) -> tuple[int, int]:
    """Contiguous [start, end) slice of the query list owned by this host.

    Contiguous (not strided) so each host's output shard is itself in global
    query order and shards concatenate into the reference's ordering.
    """
    per = -(-n_queries // process_count)
    start = min(process_index * per, n_queries)
    return start, min(start + per, n_queries)


def shard_suffix(process_index: int, process_count: int) -> str:
    """'' for single-process runs (reference-identical filenames)."""
    if process_count <= 1:
        return ""
    width = len(str(process_count - 1))
    return f".shard{process_index:0{width}d}"


def _shard_paths(prefix: Path, name: str) -> list[Path]:
    """Existing `<prefix>/<name>.shard*` files, ascending by shard id."""
    return sorted(
        prefix.glob(f"{name}.shard*"),
        key=lambda p: int(p.suffix.removeprefix(".shard") or 0),
    )


def consolidate_artifacts(prefix: Path) -> None:
    """Fold per-host shard artifacts into the reference's single-file set.

    For every `raxtax.{out,tsv,ckp,log}.shardK` present: trim the out/tsv
    shard to its own progress shard's completed queries (the per-query
    commit contract, reference: src/io.rs:156-187), append the trimmed
    content to the merged file, append the progress labels to the merged
    `raxtax.ckp`, and delete the shard. A merged `raxtax.json` is adopted
    from the first shard checkpoint if none exists. Idempotent and safe to
    run before a resume under ANY process count — completed work from a
    prior multi-host run is preserved in the merged files, never redone.

    The merged `raxtax.out` is appended to (not overwritten), so an
    interrupted re-merge can never replace completed output with empty
    shards. Crash-safety comes from label-level dedup, not operation
    ordering: every append skips queries already present in the merged
    file, so a crash between "append shard" and "unlink shard" re-applies
    the shard as a no-op on the next run instead of duplicating its lines.
    """
    import json

    from ..io.checkpoint import check_incomplete_output

    ckp_shards = _shard_paths(prefix, "raxtax.ckp")
    if not ckp_shards and not _shard_paths(prefix, "raxtax.out"):
        return
    merged_ckp = prefix / "raxtax.ckp"
    merged_json = prefix / "raxtax.json"

    def _labels(path: Path) -> set[str]:
        if not path.is_file():
            return set()
        with open(path) as f:
            return {
                l.rstrip("\n").split("\t", 1)[0] for l in f if l.strip()
            }

    merged_labels = {
        name: _labels(prefix / name) for name in ("raxtax.out", "raxtax.tsv")
    }
    merged_done = _labels(merged_ckp)
    for ckp in ckp_shards:
        suffix = ckp.suffix  # ".shardK"
        with open(ckp) as f:
            done = {l.rstrip("\n") for l in f if l.strip()}
        for name in ("raxtax.out", "raxtax.tsv"):
            shard = prefix / f"{name}{suffix}"
            if not shard.is_file():
                continue
            check_incomplete_output(shard, done)
            seen = merged_labels[name]
            with open(prefix / name, "a") as dst, open(shard) as src:
                fresh = [
                    l for l in src
                    if l.strip() and l.split("\t", 1)[0] not in seen
                ]
                dst.writelines(fresh)
            seen.update(l.split("\t", 1)[0] for l in fresh)
            shard.unlink()
        with open(merged_ckp, "a") as dst:
            dst.write("".join(f"{l}\n" for l in sorted(done - merged_done)))
        merged_done |= done
        ckp.unlink()
        log_shard = prefix / f"raxtax.log{suffix}"
        if log_shard.is_file():
            with open(prefix / "raxtax.log", "a") as dst, open(log_shard) as src:
                dst.write(src.read())
            log_shard.unlink()
        json_shard = prefix / f"raxtax.json{suffix}"
        if json_shard.is_file():
            if not merged_json.is_file():
                try:
                    with open(json_shard) as f:
                        d = json.load(f)
                    d["checkpoint_file"] = str(merged_json.absolute())
                    d["progress_file"] = str(merged_ckp.absolute())
                    tmp = str(merged_json) + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(d, f, indent=2)
                    os.replace(tmp, merged_json)
                except (OSError, ValueError, KeyError) as e:
                    log.error("could not adopt shard checkpoint: %s", e)
            json_shard.unlink()
    # orphan out/tsv shards without a progress shard carry no committed work
    for name in ("raxtax.out", "raxtax.tsv"):
        for shard in _shard_paths(prefix, name):
            shard.unlink()
