"""The port's data parallelism (`parallel/`, the runner's data-parallel fill
and test, `utils/finalize_pool.py`) against the JAX package's, on the CPU in
float32 at the tiny widths of tests/test_torch_matching.py and
tests/test_torch_runner.py.

- The shard deal, the gather and the interleave: the JAX functions' values.
- `make_data_parallel_test` on 2 CPU replicas against the JAX package's on
  2 virtual CPU devices, and against the port's own `test` on each image.
- `make_data_parallel_fill` with a padded tail against the JAX package's.
- The port's CLI with two ranks run one after the other in this process,
  and two real OS processes in one gloo process group (`file://`
  rendezvous), against single-process runs and the JAX CLI.
- The finalize pool: every worker starts with the GPU hidden and without
  torch (ROADMAP C.2), and its records equal the in-process finalize.

Mutation tried (in a copy of the repo): replacing the interleave's
`zip(*per_rank_results)` by a concatenation of the ranks' lists makes
`test_cli_two_ranks_in_process_merge_single_and_jax` and
`test_gather_interleave_matches_sequential` fail.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import yaml

import run_lightning
from conftest import cpu_devices
from no_time_to_train_tpu.config import presets as jpresets
from no_time_to_train_tpu.models.matching import memory_bank as jmb
from no_time_to_train_tpu.parallel import mesh as jmesh
from no_time_to_train_tpu.parallel import multihost as jmh
from no_time_to_train_tpu_torch import cli
from no_time_to_train_tpu_torch.config import presets as tpresets
from no_time_to_train_tpu_torch.models.matching import memory_bank as tmb
from no_time_to_train_tpu_torch.models.matching.pipeline import (
    finalize_records)
from no_time_to_train_tpu_torch.parallel import mesh, multihost
from no_time_to_train_tpu_torch.utils.finalize_pool import FinalizePool

from test_torch_matching import _pair
from test_torch_runner import (ENC_ARGS, ENC_NAME, SAM_FIELDS, SAM_NAME,
                               _config, _dataset, _same_records, _weights)

# the DP step against the JAX package's on 2 virtual devices: the largest
# score gap read on these inputs is 2.7e-7 on scores of about 0.5 (float32
# sums in another order through the tiny step)
SCORE_BAND = 1e-5
# the DP fill against the JAX package's: the largest gap of the bank's
# features read here is 1.5e-6 on features up to 3.4
FILL_BAND = 1e-5


@pytest.fixture(scope="module")
def one_torch_thread():
    """Tiny ops on one intra-op thread: beside the other test processes, a
    pool of threads to wake per op costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
def test_shard_indices_match_jax(world):
    """The padded round-robin deal and the real counts for 0-13 items: the
    JAX function's values, equal step counts per rank, every item dealt."""
    for n in range(14):
        shards = [multihost.process_shard_indices(n, world, r)
                  for r in range(world)]
        assert shards == [jmh.process_shard_indices(n, world, r)
                          for r in range(world)]
        assert len({len(s) for s in shards}) == 1
        assert set().union(*map(set, shards)) == set(range(n))
        for r in range(world):
            real = multihost.rank_real_count(n, world, r)
            assert real == jmh.rank_real_count(n, world, r)
            # the real entries are the shard's head
            assert shards[r][:real] == list(range(r, n, world))


def test_gather_interleave_matches_sequential(tmp_path):
    """Per-rank publish + rank-0 merge restores the data set's order with
    the pads truncated, and the analysis rows in rank order; the interleave
    is the JAX package's."""
    n, world = 10, 4
    for r in range(world):
        shard = multihost.process_shard_indices(n, world, r)
        multihost.save_rank_results(str(tmp_path), r,
                                    [f"res_{i}" for i in shard],
                                    scalars=[r], triplets=[10 * r])
    merged, scalars, triplets = multihost.collect_results(
        str(tmp_path), world, n, timeout_s=5)
    assert merged == [f"res_{i}" for i in range(n)]
    assert scalars == [0, 1, 2, 3] and triplets == [0, 10, 20, 30]
    parts = [list("abc"), list("def"), list("ghi")]
    assert mesh.interleave_results(parts, 7) == \
        jmesh.interleave_results(parts, 7) == list("adgbehc")


def test_gather_timeout(tmp_path):
    multihost.save_rank_results(str(tmp_path), 0, ["a"])
    with pytest.raises(TimeoutError):
        multihost.collect_results(str(tmp_path), 2, 1, timeout_s=0.3)


def test_stale_parts_cannot_satisfy_barrier(tmp_path, monkeypatch):
    """A re-run in the same gather directory never merges an earlier run's
    parts: NTTT_RUN_ID gives each run its own directory, and without it
    each rank clears its own part before compute."""
    base = str(tmp_path)
    for r in range(2):
        multihost.save_rank_results(base, r, [f"old_{r}"])
    monkeypatch.setenv("NTTT_RUN_ID", "run2")
    d2 = multihost.run_gather_dir(base)
    assert d2 == jmh.run_gather_dir(base) != base
    with pytest.raises(TimeoutError):
        multihost.collect_results(d2, 2, 2, timeout_s=0.3)
    monkeypatch.delenv("NTTT_RUN_ID")
    assert multihost.run_gather_dir(base) == base
    multihost.clear_rank_part(base, 1)
    with pytest.raises(TimeoutError):
        multihost.collect_results(base, 2, 2, timeout_s=0.3)
    multihost.clear_rank_part(base, 1)  # idempotent on a missing file
    multihost.save_rank_results(base, 1, ["new_1"])
    multihost.clear_rank_part(base, 0)
    multihost.save_rank_results(base, 0, ["new_0"])
    assert multihost.collect_results(base, 2, 2, timeout_s=5)[0] == \
        ["new_0", "new_1"]


def test_env_world_backend_and_single_process_noops(monkeypatch):
    assert multihost.env_world() == (1, 0)
    assert multihost.initialize(num_processes=1, process_id=0) == (1, 0)
    multihost.barrier("no group")           # a no-op without a group
    assert multihost.backend("cpu") == "gloo"
    assert multihost.backend("cuda") == "nccl"
    monkeypatch.setenv("NTTT_DIST_BACKEND", "gloo")
    assert multihost.backend("cuda") == "gloo"
    monkeypatch.setenv("NTTT_DIST_BACKEND", "mpi")
    with pytest.raises(ValueError, match="nccl or gloo"):
        multihost.backend()
    monkeypatch.setenv("NTTT_NUM_PROCESSES", "4")
    monkeypatch.setenv("NTTT_PROCESS_ID", "2")
    assert multihost.env_world() == jmh.env_world() == (4, 2)
    with pytest.raises(ValueError, match="NTTT_COORDINATOR"):
        multihost.initialize()


def test_dp_test_two_replicas_matches_jax_and_single(one_torch_thread):
    """Two CPU replicas against the JAX package's step on 2 virtual devices
    (scores within SCORE_BAND, labels and valid flags equal), against the
    port's own `test` on each image bit for bit, and a replica reads the
    matcher's bank after it changes."""
    jm, tm = _pair()
    imgs = np.random.default_rng(7).random((2, 128, 128, 3), np.float32)
    jout = jmesh.make_data_parallel_test(
        jm, jmesh.make_mesh(cpu_devices()[:2]))(imgs)
    run = mesh.make_data_parallel_test(tm, ["cpu", "cpu"])
    out = run(imgs)
    assert all(len(v) == 2 for v in out.values())
    for j in range(2):
        got = tm.fetch_test({k: v[j] for k, v in out.items()})
        want = jm.fetch_test({k: v[j] for k, v in jout.items()})
        np.testing.assert_array_equal(got["valid"], want["valid"])
        v = want["valid"]
        np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=SCORE_BAND)
        alone = tm.test(imgs[j])
        for k in alone:
            np.testing.assert_array_equal(got[k], alone[k], err_msg=k)
    # a later bank: the replicas read it at the next call
    tm.bank = dataclasses.replace(
        tm.bank, feats_ins_avg=tm.bank.feats_ins_avg.flip(0))
    out = run(imgs)
    for j in range(2):
        got = tm.fetch_test({k: v[j] for k, v in out.items()})
        alone = tm.test(imgs[j])
        for k in alone:
            np.testing.assert_array_equal(got[k], alone[k], err_msg=k)


@pytest.mark.parametrize("positive", [True, False])
def test_dp_fill_padded_tail_matches_jax(positive, one_torch_thread):
    """Batches of 2 references on 2 replicas, the last one padded
    (n_valid 1), into the positive or the negative bank: counts equal and
    features within FILL_BAND of the JAX package's fill on 2 virtual
    devices; one more reference of a full class raises the JAX package's
    overflow error."""
    jm, tm = _pair(with_negative_refs=True)
    c, length, n, d = tm.bank.feats.shape
    k, p = tm.bank.feats_centers.shape[1], tm.bank.pca_components.shape[1]
    jm.bank = jm.bank_neg = jmb.create(c, length, n, d, k, p)
    tm.bank = tm.bank_neg = tmb.create(c, length, n, d, k, p, device="cpu")
    jfill = jmesh.make_data_parallel_fill(
        jm, jmesh.make_mesh(cpu_devices()[:2]), positive=positive)
    tfill = mesh.make_data_parallel_fill(tm, ["cpu", "cpu"],
                                         positive=positive)
    rng = np.random.default_rng(11)
    imgs = rng.random((3, 64, 64, 3), np.float32)
    masks = (rng.random((3, 64, 64)) > 0.5).astype(np.float32)
    cats = np.array([2, 1, 1])
    for lo, n_valid in ((0, 2), (2, 1)):
        sl = [lo, min(lo + 1, 2)]
        for fill in (jfill, tfill):
            fill(cats[sl], imgs[sl], masks[sl], n_valid=n_valid)
    jb = jm.bank if positive else jm.bank_neg
    tb = tm.bank if positive else tm.bank_neg
    np.testing.assert_array_equal(tb.fill_counts.numpy(),
                                  np.asarray(jb.fill_counts))
    for f in ("feats", "masks"):
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=0,
                                   atol=FILL_BAND, err_msg=f)
    with pytest.raises(IndexError, match="memory bank overflow: a class "
                       "received 3 references but memory_length=2"):
        tfill(cats[[1, 1]], imgs[[1, 1]], masks[[1, 1]], n_valid=1)
    with pytest.raises(ValueError, match="2 devices"):
        tfill(cats[:1], imgs[:1], masks[:1])


def test_replica_copy_on_another_device_holds_its_own_weights():
    """`_module_to` copies every weight once onto the target device into
    storage of its own, and `_bank_to` moves every tensor of a bank."""
    _, tm = _pair()
    copy = mesh._module_to(tm.dino, torch.device("cpu"))
    for (name, a), b in zip(tm.dino.state_dict().items(),
                            copy.state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    moved = mesh._bank_to(tm.bank, torch.device("meta"))
    assert moved.feats.is_meta and moved.postprocessed == tm.bank.postprocessed


# --------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """test_torch_runner.py's fabricated set and weights, its tiny presets in
    both packages, and one positive bank filled and post-processed by the
    port's CLI in one process."""
    root = tmp_path_factory.mktemp("parallel")
    added = [(jpresets.SAM2_PRESETS, SAM_NAME,
              jpresets.Sam2Config(**SAM_FIELDS)),
             (tpresets.SAM2_PRESETS, SAM_NAME,
              tpresets.Sam2Config(**SAM_FIELDS)),
             (jpresets.ENCODER_PRESETS, ENC_NAME,
              jpresets.EncoderConfig(*ENC_ARGS)),
             (tpresets.ENCODER_PRESETS, ENC_NAME,
              tpresets.EncoderConfig(*ENC_ARGS))]
    for table, key, val in added:
        table[key] = val
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        img_dir, ann_json, support_json = _dataset(
            root, np.random.default_rng(0))
        sam_pt, dino_dir = _weights(root)
        from no_time_to_train_tpu_torch.data.few_shot_sampling import (
            sample_memory_dataset)
        pkl = str(root / "refs.pkl")
        sample_memory_dataset(ann_json, pkl, 2, remove_bad=False, seed=3)
        cfg = _config(root, img_dir, ann_json, support_json, sam_pt,
                      dino_dir, pkl)
        single = root / "single"

        def port(*args, devices=1, save=single):
            return cli.main(["test", "--config", cfg, "--device", "cpu",
                             "--trainer.devices", str(devices),
                             "--trainer.logger.save_dir", str(save), *args])

        port("--model.test_mode", "fill_memory", "--out_path",
             str(root / "m.ckpt"))
        port("--model.test_mode", "postprocess_memory", "--ckpt_path",
             str(root / "m.ckpt"), "--out_path", str(root / "p.ckpt"))
        port("--model.test_mode", "test", "--ckpt_path", str(root / "p.ckpt"),
             "--export_result", str(root / "single.json"))
        yield root, cfg, port
    finally:
        torch.set_num_threads(n_threads)
        for table, key, _ in added:
            table.pop(key, None)


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_cli_two_ranks_in_process_merge_single_and_jax(cli_setup,
                                                       monkeypatch):
    """NTTT_NUM_PROCESSES=2 without a coordinator: rank 1 publishes its
    shard and returns None, then rank 0 merges both (the wait is the
    barrier). The merged export equals the single-process export exactly
    and the JAX CLI's (the same fill, postprocess and test) within
    test_torch_runner.py's bands; the merged analysis rows are rank 0's
    and rank 1's real rows, once each."""
    root, cfg, port = cli_setup
    monkeypatch.setenv("NTTT_NUM_PROCESSES", "2")
    ranks = {}
    for rank in ("1", "0"):
        monkeypatch.setenv("NTTT_PROCESS_ID", rank)
        runner = port("--model.test_mode", "test", "--ckpt_path",
                      str(root / "p.ckpt"), "--export_result",
                      str(root / "merged.json"), save=root / "ranks")
        ranks[rank] = runner
    monkeypatch.delenv("NTTT_NUM_PROCESSES")
    monkeypatch.delenv("NTTT_PROCESS_ID")
    assert _load(root / "merged.json") == _load(root / "single.json")
    assert [len(r.time_queue) for r in (ranks["0"], ranks["1"])] == [2, 2]
    with open(root / "ranks" / "scalars_all.pkl", "rb") as f:
        merged_rows = pickle.load(f)
    with open(root / "single" / "scalars_all.pkl", "rb") as f:
        single_rows = pickle.load(f)
    assert len(merged_rows) == len(single_rows)

    jdir = root / "jax"
    base = ["test", "--config", cfg, "--trainer.logger.save_dir", str(jdir)]
    run_lightning.main(base + ["--model.test_mode", "fill_memory",
                               "--out_path", str(jdir / "m.ckpt")])
    run_lightning.main(base + ["--model.test_mode", "postprocess_memory",
                               "--ckpt_path", str(jdir / "m.ckpt"),
                               "--out_path", str(jdir / "p.ckpt")])
    run_lightning.main(base + ["--model.test_mode", "test", "--ckpt_path",
                               str(jdir / "p.ckpt"), "--export_result",
                               str(jdir / "test.json")])
    _same_records(_load(root / "merged.json"), _load(jdir / "test.json"))


def test_cli_two_os_processes_equal_single_process_devices_2(cli_setup,
                                                            tmp_path):
    """Two OS processes, one gloo group met at a `file://` rendezvous,
    `trainer.devices=2` (one device each): the cross-process fill, the
    postprocess and the sharded test. Rank 0's checkpoints and merged
    export equal, bit for bit, a single process driving 2 CPU replicas
    (the same per-reference encodes; its test finalizes in a pool of 3
    workers), and rank 1 writes no checkpoint. Against the one-device run,
    which encodes the references in batches of 8, the export agrees within
    test_torch_runner.py's bands: the batch changes the order of float32
    sums, and the largest score gap read here is 6e-8."""
    root, cfg, port = cli_setup
    work = tmp_path / "ranks"
    work.mkdir()
    spec = json.dumps({"sam_name": SAM_NAME, "sam_fields": SAM_FIELDS,
                       "enc_args": list(ENC_ARGS)})
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_multihost_worker.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith("NTTT_")}
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(work),
                               cfg, spec], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]

    # meanwhile, this process on 2 replicas with the finalize pool
    dp = tmp_path / "dp"
    cfg_dp = yaml.safe_load(open(cfg))
    cfg_dp["model"]["init_args"]["data_load_cfgs"]["finalize_workers"] = 3
    cfg_dp_path = tmp_path / "cfg_dp.yaml"
    cfg_dp_path.write_text(yaml.safe_dump(cfg_dp))

    def single(*args):
        return cli.main(["test", "--config", str(cfg_dp_path), "--device",
                         "cpu", "--trainer.devices", "2",
                         "--trainer.logger.save_dir", str(dp), *args])

    single("--model.test_mode", "fill_memory", "--out_path",
           str(dp / "m.ckpt"))
    single("--model.test_mode", "postprocess_memory", "--ckpt_path",
           str(dp / "m.ckpt"), "--out_path", str(dp / "p.ckpt"))
    runner = single("--model.test_mode", "test", "--ckpt_path",
                    str(dp / "p.ckpt"), "--export_result",
                    str(dp / "test.json"))
    assert runner.local_devices == 2

    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300) + (p.returncode,))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for stdout, stderr, rc in outs:
        assert rc == 0, f"rank failed:\n{stdout[-2000:]}\n{stderr[-3000:]}"
    for r in range(2):
        info = _load(work / f"rank_{r}.json")
        assert info == {"world": 2, "backend": "gloo", "local_devices": 1,
                        "images": 2}, info
    assert sorted(p.name for p in work.glob("*.ckpt")) == ["m.ckpt", "p.ckpt"]
    for name in ("m.ckpt", "p.ckpt"):
        got = torch.load(work / name, weights_only=True)["state_dict"]
        want = torch.load(dp / name, weights_only=True)["state_dict"]
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    merged = _load(work / "merged.json")
    assert merged == _load(dp / "test.json")
    _same_records(merged, _load(root / "single.json"))


def _probe_rows(rng):
    """Three images' winners of assorted sizes as float16 logits."""
    return [(rng.standard_normal((n, 32, 32)).astype(np.float16) * 3, h, w)
            for n, h, w in ((3, 40, 56), (1, 97, 33), (4, 64, 64), (2, 32, 70),
                            (5, 50, 50), (1, 128, 96), (2, 33, 33), (3, 45, 90),
                            (4, 81, 64))]


def test_finalize_pool_workers_start_scrubbed(monkeypatch):
    """3 workers, 9 rows: every worker started with CUDA_VISIBLE_DEVICES
    "" and without torch (ROADMAP C.2: the JAX package's pool scrubs the
    environment for its first worker only), the parent's environment is
    restored, and each row's records equal `finalize_records` in this
    process."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    pool = FinalizePool(3)
    try:
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
        assert len({w["pid"] for w in pool.workers}) == 3
        for w in pool.workers:
            assert w["CUDA_VISIBLE_DEVICES"] == "" and not w["torch_loaded"]
        rows = _probe_rows(np.random.default_rng(4))
        futs = [pool.submit_row(*row) for row in rows]
        for (lr, h, w), fut in zip(rows, futs):
            segs, boxes = fut.result(timeout=60)
            n = lr.shape[0]
            want = finalize_records(
                dict(lr_logits=lr, valid=np.ones(n, bool),
                     scores=np.ones(n, np.float32), labels=np.zeros(n, int)),
                h, w)
            assert segs == want["segs"]
            np.testing.assert_array_equal(boxes, want["bboxes"])
    finally:
        pool.shutdown()


def test_launch_counter_holds_under_threads():
    """Replicas launch from several threads at once, so the wrappers' launch
    counters must not lose an add: 16 threads x 5000 adds with a switch
    interval of 1 us, each thread's result read within 120 s."""
    from no_time_to_train_tpu_torch.ops import _cuda
    counts = {"k": 0}

    def adds():
        for _ in range(5000):
            _cuda.count(counts, "k")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            for fut in [pool.submit(adds) for _ in range(16)]:
                fut.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert counts["k"] == 16 * 5000


def test_runner_data_parallel_device_rules(monkeypatch):
    """`devices` counts the run's devices: one process drives them all, a
    world of n processes devices / n each; a CUDA process that would drive
    more GPUs than it sees raises."""
    from no_time_to_train_tpu_torch.runner import _local_devices
    assert _local_devices(3, "cpu") == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices=2"):
        _local_devices(2, "cuda")
    assert _local_devices(1, "cuda") == 1
    monkeypatch.setenv("NTTT_NUM_PROCESSES", "2")
    assert _local_devices(2, "cuda") == 1
    assert _local_devices(1, "cpu") == 1
    assert _local_devices(4, "cpu") == 2
    with pytest.raises(ValueError, match="do not split"):
        _local_devices(3, "cpu")
