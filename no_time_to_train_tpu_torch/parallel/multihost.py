"""Multi-process data parallelism (port of
`no_time_to_train_tpu/parallel/multihost.py`).

The reference runs Lightning DDP across processes: a padded
DistributedSampler deals the eval data set round-robin to ranks, each rank
pickles its results into a shared directory, `dist.barrier()` synchronizes,
and rank 0 interleave-merges and truncates (reference run_lightning.py:23-78,
`collect_results_cpu`; the deal of
torch.utils.data.DistributedSampler with shuffle=False).

Here the collectives of the fill run on `torch.distributed`, while the
result gather stays on the host, as in the reference: a shared-filesystem
gather whose part files are written atomically (tmp + rename), so a complete
set of part files is the barrier. Runs of one process short-circuit
everywhere.

Environment contract (as `torchrun`'s):
  NTTT_NUM_PROCESSES  the number of processes (default 1);
  NTTT_PROCESS_ID     this process's rank (default 0);
  NTTT_COORDINATOR    where the process group meets: `host:port` (a TCP
                      store on rank 0's host) or an init URL such as
                      `file:///shared/dir/rendezvous`;
  NTTT_DIST_BACKEND   `nccl` or `gloo`; without it, nccl where the process
                      sees a CUDA device and gloo otherwise. NCCL refuses
                      two ranks on one GPU, so ranks that share a card name
                      gloo here. Nothing switches backend on its own;
  NTTT_RUN_ID         a run id shared by the ranks (`run_gather_dir`).
A process drives the CUDA devices it sees: a launcher gives each process its
own GPUs with CUDA_VISIBLE_DEVICES (`CUDA_VISIBLE_DEVICES=1 NTTT_PROCESS_ID=1
...`), and the process calls them cuda:0, cuda:1, ...
"""
import os
import pickle
import time

import torch
import torch.distributed as dist

from no_time_to_train_tpu_torch.parallel.mesh import interleave_results

__all__ = ["env_world", "initialize", "backend", "process_shard_indices",
           "rank_real_count", "barrier", "run_gather_dir", "clear_rank_part",
           "save_rank_results", "collect_results"]


def env_world():
    """(num_processes, process_id) from the environment; (1, 0) default."""
    return (int(os.environ.get("NTTT_NUM_PROCESSES", "1")),
            int(os.environ.get("NTTT_PROCESS_ID", "0")))


def backend(device=None):
    """The process group's backend by the contract above: NTTT_DIST_BACKEND,
    else nccl for a CUDA `device` (or, without one, where a CUDA device is
    there) and gloo otherwise."""
    name = os.environ.get("NTTT_DIST_BACKEND")
    if name:
        if name not in ("nccl", "gloo"):
            raise ValueError(f"NTTT_DIST_BACKEND={name!r}: nccl or gloo")
        return name
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    return "nccl" if cuda else "gloo"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend_name=None):
    """Start the `torch.distributed` process group of the contract above
    (the reference's Lightning DDP init). A no-op at world size 1 and when a
    group exists. With nccl, call `torch.cuda.set_device` first.

    Returns (num_processes, process_id)."""
    env_n, env_r = env_world()
    n = num_processes if num_processes is not None else env_n
    r = process_id if process_id is not None else env_r
    if n <= 1:
        return 1, 0
    if dist.is_initialized():
        return n, r
    coord = coordinator_address or os.environ.get("NTTT_COORDINATOR")
    if not coord:
        raise ValueError("a world of several processes needs "
                         "NTTT_COORDINATOR (host:port or an init URL)")
    url = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend_name or backend(), init_method=url,
                            world_size=n, rank=r)
    return n, r


def process_shard_indices(n_items, num_processes, process_id):
    """Padded round-robin shard: the index assignment of the reference's
    DistributedSampler(shuffle=False). Indices are padded by wrapping to a
    multiple of the world size, then dealt rank::world_size, so every rank
    runs the same number of steps; `collect_results` truncates the
    duplicates out again (run_lightning.py:74-75)."""
    idx = list(range(n_items))
    if num_processes <= 1 or n_items == 0:
        return idx
    total = -(-n_items // num_processes) * num_processes
    pad = total - n_items
    if pad <= n_items:
        idx = idx + idx[:pad]
    else:
        # as DistributedSampler: with fewer items than ranks the whole list
        # repeats; a short pad would leave ranks with empty shards, and the
        # rank-0 interleave would then truncate every rank's results to zero
        reps = -(-pad // n_items)
        idx = idx + (idx * reps)[:pad]
    return idx[process_id::num_processes]


def rank_real_count(n_items, num_processes, process_id):
    """Number of real (non-pad) entries in this rank's shard: pads hold
    global positions >= n_items and the deal keeps positions ascending, so
    a rank's pads are its tail entries."""
    if num_processes <= 1:
        return n_items
    return len(range(process_id, n_items, num_processes))


def barrier(name):
    """A `dist.barrier()` when a process group exists, else a no-op. `name`
    says in a traceback which barrier a rank waited at."""
    if not dist.is_initialized():
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def _part_path(gather_dir, process_id):
    return os.path.join(gather_dir, f"part_{process_id}.pkl")


def run_gather_dir(base_dir, run_id=None):
    """Per-run gather directory. The file-existence barrier of
    `collect_results` is only sound if part files of an earlier run can
    never satisfy it; the launcher passes a shared NTTT_RUN_ID. Runs without
    one share the base directory and rely on `clear_rank_part` at start."""
    rid = run_id or os.environ.get("NTTT_RUN_ID")
    return os.path.join(base_dir, rid) if rid else base_dir


def clear_rank_part(gather_dir, process_id):
    """Delete this rank's stale part file before any compute starts. Each
    rank clears its own file, so a re-run in the same gather directory
    completes only once every rank has published again. A rank that starts
    after another finishes could still leave a stale file standing: set
    NTTT_RUN_ID to close that window."""
    try:
        os.remove(_part_path(gather_dir, process_id))
    except FileNotFoundError:
        pass


def save_rank_results(gather_dir, process_id, results, scalars=None,
                      triplets=None):
    """Publish this rank's result list (reference run_lightning.py:56-57)
    with its analysis rows, so that rank 0 writes the merged
    scalars_all.pkl / triplets_all.pkl. The rename is the signal the other
    ranks wait on."""
    payload = {"results": results,
               "scalars": list(scalars or ()),
               "triplets": list(triplets or ())}
    os.makedirs(gather_dir, exist_ok=True)
    tmp = _part_path(gather_dir, process_id) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, _part_path(gather_dir, process_id))


def collect_results(gather_dir, num_processes, total, timeout_s=600.0,
                    poll_s=0.2):
    """Rank 0's gather: wait for every part file (the reference's
    dist.barrier, run_lightning.py:59), load them in rank order and
    interleave-merge with pad truncation (:61-75). Returns (results,
    scalars_rows, triplets_rows); the analysis rows are concatenated in
    rank order."""
    paths = [_part_path(gather_dir, r) for r in range(num_processes)]
    deadline = time.time() + timeout_s
    while not all(os.path.exists(p) for p in paths):
        if time.time() > deadline:
            missing = [p for p in paths if not os.path.exists(p)]
            raise TimeoutError(f"multihost gather: missing {missing}")
        time.sleep(poll_s)
    parts = []
    for p in paths:
        with open(p, "rb") as f:
            parts.append(pickle.load(f))
    results = interleave_results([p["results"] for p in parts], total)
    scalars = [row for p in parts for row in p["scalars"]]
    triplets = [row for p in parts for row in p["triplets"]]
    return results, scalars, triplets
