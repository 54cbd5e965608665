"""Data parallelism over devices (port of
`no_time_to_train_tpu/parallel/mesh.py`).

Replaces the reference's Lightning-DDP + NCCL layer: the reference shards the
eval image stream across ranks with a padded DistributedSampler and
all-gathers reference features during fill_memory
(no_time_to_train/models/model_utils.py:74-91). Here:

  - a list of devices takes the place of the JAX package's 1-D `data` mesh;
    each device gets one replica of the matcher's two encoders and decoder,
    its weights copied there once (a replica on the matcher's own device
    uses the matcher's modules). A replica reads the matcher's current bank
    at every call, moving it to its device when the bank object changed, so
    a later fill, postprocess or `load_ckpt` never leaves it stale;
  - each replica runs in a thread of its own and, on a GPU, on a CUDA stream
    of its own, since one host thread makes every launch of a test step;
  - fill_memory extracts features on each device, gathers them in device
    order and then across processes in rank order (`dist.all_gather`), and
    every process applies the same sequential bank update (the reference's
    gather-then-loop semantics, Sam2MatchingBaseline_noAMG.py:471-485).

The JAX package's `make_global_array` has no counterpart: every process
loads the same batch and encodes only the rows of its own replicas (the
JAX runner's `runner.py:193-199`), and the gather restores the batch.
"""
import contextvars
import copy
import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from no_time_to_train_tpu_torch.models.matching import memory_bank as mb
from no_time_to_train_tpu_torch.models.matching.pipeline import NoAMGMatcher

__all__ = ["make_data_parallel_test", "make_data_parallel_fill",
           "interleave_results"]


def _device(d):
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _module_to(module, device):
    """A copy of `module` on `device`, each weight copied there once (no
    second copy on the module's own device)."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        moved = t.detach().to(device, copy=True)
        memo[id(t)] = (torch.nn.Parameter(moved, t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else moved)
    return copy.deepcopy(module, memo)


def _bank_to(bank, device):
    return dataclasses.replace(bank, **{
        f.name: getattr(bank, f.name).to(device)
        for f in dataclasses.fields(bank)
        if torch.is_tensor(getattr(bank, f.name))})


class _Replica(NoAMGMatcher):
    """The matcher's step on one device. Its structure, configuration and
    (on the matcher's device) modules are the matcher's; `bank` and
    `bank_neg` read the matcher's at every access."""

    def __init__(self, parent, device, modules):
        self.__dict__.update({k: v for k, v in parent.__dict__.items()
                              if k not in ("bank", "bank_neg")})
        self._parent = parent
        self._home = _device(parent.device)
        self._moved = {}
        self.device = device
        self.sam2, self.dino = modules
        self._mean = parent._mean.to(device)
        self._std = parent._std.to(device)

    def _on_device(self, key, bank):
        if bank is None or self.device == self._home:
            return bank
        held = self._moved.get(key)
        if held is None or held[0] is not bank:
            held = (bank, _bank_to(bank, self.device))
            self._moved[key] = held
        return held[1]

    @property
    def bank(self):
        return self._on_device("bank", self._parent.bank)

    @property
    def bank_neg(self):
        return self._on_device("bank_neg", self._parent.bank_neg)


def _record(obj, stream):
    """Mark every tensor in obj as used on `stream` (the caching allocator
    must not hand its memory to the replica's stream while the caller's
    stream may still read it)."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, dict):
        for v in obj.values():
            _record(v, stream)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _record(v, stream)


class _Replicas:
    """One replica of `matcher` per entry of `devices` (an entry may repeat:
    replicas on one device share that device's copy of the modules)."""

    def __init__(self, matcher, devices):
        devices = [_device(d) for d in devices]
        if not devices:
            raise ValueError("data parallelism needs at least one device")
        for d in devices:
            if d.type != matcher.device.type:
                raise ValueError(f"replica device {d}: the matcher is on "
                                 f"{matcher.device}")
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise ValueError(f"replica device {d}: this process sees "
                                 f"{torch.cuda.device_count()} GPUs")
        copies = {_device(matcher.device): (matcher.sam2, matcher.dino)}
        for d in devices:
            if d not in copies:
                copies[d] = (_module_to(matcher.sam2, d),
                             _module_to(matcher.dino, d))
        self.devices = devices
        self.items = [_Replica(matcher, d, copies[d]) for d in devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in devices]
        self._pool = ThreadPoolExecutor(max_workers=len(devices))
        self._warm = False

    def __len__(self):
        return len(self.items)

    def _one(self, fn, j, args):
        rep, stream = self.items[j], self.streams[j]
        if stream is None:
            return fn(rep, *args)
        with torch.cuda.device(rep.device), torch.cuda.stream(stream):
            return fn(rep, *args)

    def map(self, fn, args):
        """[fn(replica_j, *args[j])] with each replica in its own thread. On
        a GPU each replica's stream first waits for the work queued so far
        on the caller's stream of its device, and that stream then waits
        for the replica's work. The first call runs the replicas one after
        another, each to its end, so that the tensors the models cache at
        first use are complete before another stream reads them."""
        for rep, stream in zip(self.items, self.streams):
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(rep.device))
        jobs = range(len(self.items))
        if not self._warm:
            outs = []
            for j in jobs:
                outs.append(self._one(fn, j, args[j]))
                if self.streams[j] is not None:
                    self.streams[j].synchronize()
            self._warm = True
        else:
            # each thread runs in a copy of the caller's context, so that
            # `no_fusion()` and the like reach the replicas
            ctxs = [contextvars.copy_context() for _ in jobs]
            outs = list(self._pool.map(
                lambda j: ctxs[j].run(self._one, fn, j, args[j]), jobs))
        for rep, stream, out in zip(self.items, self.streams, outs):
            if stream is not None:
                current = torch.cuda.current_stream(rep.device)
                current.wait_stream(stream)
                _record(out, current)
        return outs


def make_data_parallel_test(matcher, devices):
    """Returns run(imgs [n, S, S, 3]) for n = len(devices): replica j runs
    the single-image `test_async` on imgs[j]. The result is the dict of
    `test_async` with a leading n axis, each value a tuple of n tensors on
    their replicas' devices (`runner._fetch_dp` reads it). Nothing waits for
    the devices."""
    reps = _Replicas(matcher, devices)
    n = len(reps)

    def run(imgs):
        if len(imgs) != n:
            raise ValueError(f"batch {len(imgs)} != {n} devices")
        outs = reps.map(lambda rep, img: rep.test_async(img),
                        [(imgs[j],) for j in range(n)])
        return {k: tuple(o[k] for o in outs) for k in outs[0]}

    return run


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _all_gather(x):
    """Concatenate x [rows, ...] over the process group in rank order (gloo
    and NCCL both take CUDA tensors)."""
    world, _ = _world()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def make_data_parallel_fill(matcher, devices, positive=True):
    """Returns run(cat_inds [B], imgs [B, H, W, 3], masks [B, Hm, Wm],
    n_valid=None) for B = len(devices) x the process group's world size
    (1 without a group). Every process passes the same batch; replica j of
    rank r encodes row r * len(devices) + j. The features are gathered in
    device order, then across processes in rank order, and every process
    writes them into the positive or the negative bank in batch order (the
    reference's concat_all_gather and rank loop, model_utils.py:74-91).

    n_valid < B drops the padded tail of the last batch after the gather,
    so the padded rows never reach the bank."""
    if not positive and matcher.bank_neg is None:
        raise ValueError("the negative bank needs "
                         "MatchingConfig(with_negative_refs=True)")
    reps = _Replicas(matcher, devices)
    n_local = len(reps)
    world, rank = _world()
    n = n_local * world

    def encode(rep, img, mask):
        return rep._fill_features(rep._as_tensor(np.asarray(img)[None]),
                                  rep._as_tensor(np.asarray(mask)[None]))

    def run(cat_inds, imgs, masks, n_valid=None):
        if len(imgs) != n or len(masks) != n or len(cat_inds) != n:
            raise ValueError(f"batch {len(imgs)} != {n_local} devices x "
                             f"{world} processes")
        rows = range(rank * n_local, (rank + 1) * n_local)
        outs = reps.map(encode, [(imgs[i], masks[i]) for i in rows])
        feats = torch.cat([f.to(matcher.device) for f, _ in outs])
        msks = torch.cat([m.to(matcher.device) for _, m in outs])
        if world > 1:
            feats, msks = _all_gather(feats), _all_gather(msks)
        cats = [int(c) for c in cat_inds]
        if n_valid is not None and n_valid < n:
            cats, feats, msks = cats[:n_valid], feats[:n_valid], \
                msks[:n_valid]
        target = matcher.bank if positive else matcher.bank_neg
        length = target.feats.shape[1]
        counts = target.fill_counts.cpu().numpy() + np.bincount(
            cats, minlength=target.fill_counts.shape[0])
        if counts.max() > length:
            raise IndexError(
                f"memory bank overflow: a class received {counts.max()} "
                f"references but memory_length={length}")
        updated = mb.fill(target, cats, feats, msks)
        if positive:
            matcher.bank = updated
        else:
            matcher.bank_neg = updated
        return updated

    return run


def interleave_results(per_rank_results, total):
    """The reference's interleaved rank merge with pad truncation
    (run_lightning.py:71-75): results were dealt round-robin to ranks, so
    zip them back and cut to the data set's size."""
    merged = []
    for group in zip(*per_rank_results):
        merged.extend(group)
    return merged[:total]
