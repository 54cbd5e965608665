"""Phase runner (port of `no_time_to_train_tpu/runner.py`) — the
orchestration layer replacing the reference's Lightning wrapper
(no_time_to_train/pl_wrapper/sam2matcher_pl.py) and the phase logic of
run_lightning.py's after_test.

Modes (reference test_step dispatch, sam2matcher_pl.py:163-200):
  fill_memory / fill_memory_neg -> feature extraction + bank writes, then a
      memory checkpoint at --out_path;
  postprocess_memory / postprocess_memory_neg -> one postprocess on the
      device;
  test / test_support -> per-image test steps, a loader thread and a
      two-deep pipeline, COCO RLE encoding, FPS report (the reference's
      format, run_lightning.py:152-161), optional json export, COCOeval;
      with `online_vis` a GT-vs-prediction panel of each image under
      ./results_analysis/<dataset name>/ (`data/visualization.py`);
  vis_memory -> each reference of the fill data set through the encoder,
      drawn beside the k-means and PCA overlays of the loaded bank under
      ./results_analysis/memory_vis/<cat>_<img_id>.png.

Data parallelism (`parallel/`): `devices` is the number of devices of the
run, as Lightning's `trainer.devices` on one node, and a run of
NTTT_NUM_PROCESSES processes drives devices / NTTT_NUM_PROCESSES of them in
each (one process per GPU, each given its own with CUDA_VISIBLE_DEVICES).
A process with several devices runs one replica on each: the fill in
batches of one reference per replica, the test in batches of one image per
replica, finalized in `finalize_workers` processes when the data-loading
config asks for them. Several processes deal the test images round-robin
and rank 0 merges the results through a shared directory; with
NTTT_COORDINATOR set and more than one device, the fill is the
cross-process one (every rank encodes its rows of each batch and the
features are gathered). On CUDA, more devices than the process sees
raise; on the CPU, devices=n runs n replicas on the CPU.
"""
import copy
import csv
import json
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from no_time_to_train_tpu_torch.config.presets import ENCODER_PRESETS
from no_time_to_train_tpu_torch.data.datasets import (
    COCOMemoryFillCropDataset, COCORefOracleTestDataset)
from no_time_to_train_tpu_torch.data.metainfo import METAINFO
from no_time_to_train_tpu_torch.models.matching.pipeline import (
    MatchingConfig, NoAMGMatcher, finalize_records, finalize_results)
from no_time_to_train_tpu_torch.parallel import multihost
from no_time_to_train_tpu_torch.parallel.mesh import (
    interleave_results, make_data_parallel_fill, make_data_parallel_test)
from no_time_to_train_tpu_torch.utils import checkpoint as ckpt_io
from no_time_to_train_tpu_torch.utils.profiling import span


def _apply_dotted_hacks(model_cfg, dataset_cfgs):
    """The reference allows dotted keys to arrive inside dicts and re-maps
    them (sam2matcher_pl.py:90-127). Generalized: any 'a.b' key in model_cfg /
    dataset_cfgs is folded into its nested dict."""
    for cfgs in (model_cfg, dataset_cfgs):
        for key in [k for k in list(cfgs) if "." in k]:
            head, tail = key.split(".", 1)
            val = cfgs.pop(key)
            if head in ("memory_bank_cfg", "sam2_infer_cfgs", "fill_memory",
                        "test", "support") and isinstance(
                            cfgs.get(head), dict):
                if tail == "cat_names" and isinstance(val, str):
                    val = val.split(",")
                if tail == "class_split":
                    cfgs[head]["cat_names"] = list(METAINFO[val])
                cfgs[head][tail] = val
            elif head == "test" and cfgs is model_cfg:
                mapping = {"imgs_path": "dataset_imgs_path",
                           "online_vis": "online_vis", "vis_thr": "vis_thr"}
                model_cfg[mapping.get(tail, tail)] = val
            else:
                cfgs[key] = val  # leave unknown keys visible
    return model_cfg, dataset_cfgs


def get_dataset(dataset_cfg, stage):
    """Stage -> dataset class map (sam2matcher_pl.py:42-69)."""
    cfg = dict(dataset_cfg)
    name = cfg.pop("name", None)
    if name != "coco":
        raise ValueError(f"unknown dataset {name}")
    if stage in ("fill_memory", "vis_memory", "fill_memory_neg"):
        # test-grid key; the fill dataset class does not accept it
        cfg.pop("n_points_per_edge", None)
        if stage != "fill_memory":
            cfg["custom_data_mode"] = stage
        return COCOMemoryFillCropDataset(**cfg)
    if stage in ("test", "test_support"):
        if stage == "test_support":
            cfg["custom_data_mode"] = stage
        return COCORefOracleTestDataset(**cfg)
    raise NotImplementedError(stage)


def _local_devices(devices, device):
    """The devices this process drives: devices / NTTT_NUM_PROCESSES in a
    world of several processes (at least 1), all of them in one process.
    Raises where a CUDA process sees fewer GPUs."""
    n_proc, _ = multihost.env_world()
    if devices < 1:
        raise ValueError(f"devices={devices}")
    if n_proc > 1 and devices > 1 and devices % n_proc:
        raise ValueError(f"devices={devices} do not split over {n_proc} "
                         f"processes")
    local = max(1, devices // n_proc)
    if torch.device(device).type == "cuda" \
            and local > torch.cuda.device_count():
        raise ValueError(
            f"devices={devices}: this process drives {local} GPUs and sees "
            f"{torch.cuda.device_count()} (give each process its GPUs with "
            f"CUDA_VISIBLE_DEVICES)")
    return local


class MatcherRunner:
    def __init__(self, model_cfg, dataset_cfgs, data_load_cfgs=None,
                 test_mode="none", seed=42, devices=1, save_dir=".",
                 device="cuda"):
        t0 = time.perf_counter()
        model_cfg = copy.deepcopy(model_cfg)
        dataset_cfgs = copy.deepcopy(dataset_cfgs)
        model_cfg, dataset_cfgs = _apply_dotted_hacks(model_cfg, dataset_cfgs)
        self.test_mode = test_mode
        self.model_cfg = model_cfg
        self.dataset_cfgs = dataset_cfgs
        self.data_load_cfgs = data_load_cfgs or {}
        self.save_dir = save_dir

        name = model_cfg.get("name", "matching_baseline_noAMG").lower()
        if name != "matching_baseline_noamg":
            raise ValueError(f"unknown model {name}")
        self.devices = int(devices)
        self.local_devices = _local_devices(self.devices, device)

        infer = dict(model_cfg.get("sam2_infer_cfgs", {}))
        mb_cfg = dict(model_cfg.get("memory_bank_cfg", {}))
        if not mb_cfg.pop("enable", True):
            raise ValueError("memory_bank_cfg.enable must be true")

        enc_cfg = model_cfg.get("encoder_cfg", "dinov2_large")
        if isinstance(enc_cfg, dict):
            enc_cfg = enc_cfg.get("name", "dinov2_large")
        enc = ENCODER_PRESETS[enc_cfg]

        matching = MatchingConfig(
            points_per_side=int(infer.get("points_per_side", 32)),
            testing_point_bs=int(infer.get("testing_point_bs", 256)),
            iou_thr=float(infer.get("iou_thr", 0.4)),
            nms_thr=float(infer.get("nms_thr", 0.5)),
            num_out_instance=int(infer.get("num_out_instance", 100)),
            kmeans_k=int(infer.get("kmeans_k", 4)),
            n_pca_components=int(infer.get("n_pca_components", 3)),
            cls_num_per_mask=int(infer.get("cls_num_per_mask", 1)),
            with_negative_refs=bool(infer.get("with_negative_refs", False)),
            compute_dtype=str(infer.get("compute_dtype", "float32")),
            decoder_impl=str(infer.get("decoder_impl", "dense")),
            attention_impl=str(infer.get("attention_impl", "pallas")),
            encoder_quant=str(infer.get("encoder_quant", "none")),
        )

        # weights from the checkpoints where the files exist, else from
        # `seed`
        sam2_ckpt = model_cfg.get("sam2_ckpt_path")
        sam2_sd = (ckpt_io.load_sam2_torch_checkpoint(sam2_ckpt)
                   if sam2_ckpt and os.path.exists(sam2_ckpt) else None)
        enc_ckpt = model_cfg.get("encoder_ckpt_path")
        dino_sd = (ckpt_io.load_dino_checkpoint(enc_ckpt)
                   if enc_ckpt and os.path.exists(str(enc_ckpt)) else None)

        # sam2_cfg_file: a preset basename, or a reference hydra YAML
        # topology on disk (build_sam.py:34-36)
        self.matcher = NoAMGMatcher(
            model_cfg.get("sam2_cfg_file", "sam2_hiera_l.yaml"), enc,
            matching, n_classes=int(mb_cfg.get("category_num", 20)),
            memory_length=int(mb_cfg.get("length", 10)),
            sam2_state_dict=sam2_sd, dino_state_dict=dino_sd, seed=seed,
            device=device)
        dev = self.matcher.device
        # fetches of a finished image run here, beside the next image's work
        self._copy_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                             else None)
        # wall seconds of the weight set-up and of each run(), device work
        # included
        self.seconds = {"init": self._since(t0)}

        self.output_queue = []
        self.scalars_queue = []
        self.triplets_queue = []
        self.time_queue = []
        self.online_vis = bool(model_cfg.get("online_vis", False))
        self.vis_thr = float(model_cfg.get("vis_thr", 0.5))

    # ----------------------------------------------------------------- phases
    def load_ckpt(self, ckpt_path):
        if ckpt_path:
            self.matcher.bank, self.matcher.bank_neg = ckpt_io.load_memory_bank(
                ckpt_path, self.matcher.bank, self.matcher.bank_neg)

    def save_ckpt(self, out_path, msg):
        ckpt_io.save_memory_bank(out_path, self.matcher.bank,
                                 self.matcher.bank_neg)
        print(f"{msg} {out_path}")

    def _save_ckpt_rank0(self, out_path, mode, msg):
        """Every rank holds the same bank (gathered fill, replicated
        postprocess), so only rank 0 writes: saves of one path from several
        processes tear the file. The barrier keeps the other ranks from
        reading it before it is written (a no-op without a process group,
        where the phases are separate CLI calls anyway)."""
        n_proc, proc_id = multihost.env_world()
        if proc_id == 0:
            self.save_ckpt(out_path, msg)
        if n_proc > 1:
            multihost.barrier(f"nttt_ckpt_saved_{mode}")

    def _replica_devices(self):
        """One entry per device this process drives."""
        dev = self.matcher.device
        if dev.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(self.local_devices)]
        return [dev] * self.local_devices

    def _since(self, t0):
        if self.matcher.device.type == "cuda":
            torch.cuda.synchronize(self.matcher.device)
        return time.perf_counter() - t0

    def run(self, ckpt_path=None, out_path=None, export_result=None,
            output_name="", progress=True):
        t0 = time.perf_counter()
        try:
            return self._run(ckpt_path, out_path, export_result, output_name,
                             progress)
        finally:
            self.seconds["run"] = self._since(t0)

    def _run(self, ckpt_path, out_path, export_result, output_name,
             progress):
        mode = self.test_mode
        self.load_ckpt(ckpt_path)
        if mode in ("fill_memory", "fill_memory_neg"):
            self._fill(mode, progress=progress)
            if out_path:
                self._save_ckpt_rank0(out_path, mode,
                                      "Checkpoint with memory is saved to")
        elif mode in ("postprocess_memory", "postprocess_memory_neg"):
            self.matcher.postprocess_memory(
                positive=(mode == "postprocess_memory"))
            if out_path:
                self._save_ckpt_rank0(
                    out_path, mode,
                    "Checkpoint with post-processed memory is saved to")
        elif mode in ("test", "test_support"):
            return self._test(mode, export_result, output_name, progress)
        elif mode == "vis_memory":
            self._vis_memory()
        else:
            raise NotImplementedError(f"Unrecognized test mode {mode}")
        return None

    def _fill(self, mode, progress):
        """Batches of 8 references, or of one reference per replica where
        this run drives several devices; the next two batches load while the
        device encodes the current one, one worker thread per reference
        (the crop resizes release the interpreter lock). With several
        processes, NTTT_COORDINATOR set and more than one device, the batch
        spans the processes: every process loads it, encodes the rows of
        its replicas, and the features are gathered (the reference's DDP
        fill, model_utils.py:74-91); the tail batch is padded and the pad
        dropped after the gather."""
        positive = mode == "fill_memory"
        ds = get_dataset(self.dataset_cfgs["fill_memory"], mode)
        n_proc, _ = multihost.env_world()
        dp_fill, bs = None, 8
        if (n_proc > 1 and self.devices > 1
                and os.environ.get("NTTT_COORDINATOR")):
            multihost.initialize()
            dp_fill = make_data_parallel_fill(
                self.matcher, self._replica_devices(), positive=positive)
            bs = self.local_devices * n_proc
        elif self.local_devices > 1:
            dp_fill = make_data_parallel_fill(
                self.matcher, self._replica_devices(), positive=positive)
            bs = self.local_devices
        batches = [list(range(i, min(i + bs, len(ds))))
                   for i in range(0, len(ds), bs)]

        with ThreadPoolExecutor(max_workers=bs) as pool:
            def load(ix):
                return [pool.submit(ds.__getitem__, j) for j in ix]

            futs = [load(b) for b in batches[:2]]
            for bi in range(len(batches)):
                items = [f.result() for f in futs.pop(0)]
                if bi + 2 < len(batches):
                    futs.append(load(batches[bi + 2]))
                if dp_fill is None:
                    self.matcher.fill_memory(
                        np.stack([it["img"] for it in items]),
                        np.stack([it["mask"] for it in items]),
                        [it["cat_ind"] for it in items], positive=positive)
                else:
                    n_valid = len(items)
                    items += [items[-1]] * (bs - n_valid)
                    dp_fill([it["cat_ind"] for it in items],
                            np.stack([it["img"] for it in items]),
                            np.stack([it["mask"] for it in items]),
                            n_valid=n_valid)
                if progress:
                    print(f"fill {min((bi + 1) * bs, len(ds))}/{len(ds)}")

    def _vis_memory(self):
        """Each reference's [gs, gs, D] encoder grid on the device, drawn
        with the bank's k-means centres and PCA on the host."""
        from no_time_to_train_tpu_torch.data.visualization import vis_memory
        ds = get_dataset(self.dataset_cfgs["fill_memory"], "vis_memory")
        gs = self.matcher.enc_cfg.grid_size
        out_dir = "./results_analysis/memory_vis"
        for i in range(len(ds)):
            item = ds[i]
            feats, _ = self.matcher._fill_features(
                self.matcher._as_tensor(item["img"][None]),
                self.matcher._as_tensor(item["mask"][None]))
            grid = feats[0].cpu().numpy().reshape(gs, gs, -1)
            vis_memory(item["img"], grid, item["cat_ind"], self.matcher.bank,
                       out_dir, img_id=item["img_info"]["id"])
        print(f"memory visualizations -> {out_dir}")

    def _vis_dir(self, stage_cfg):
        """The online visualization's directory, or None when it is
        off."""
        if not self.online_vis:
            return None
        vis_dir = os.path.join("./results_analysis",
                               stage_cfg.get("name", "coco"))
        os.makedirs(vis_dir, exist_ok=True)
        return vis_dir

    def _fetch(self, out):
        """fetch_test of an image whose work has finished. On a GPU the
        copies run on a side stream, so they do not queue behind the next
        image's kernels."""
        if self._copy_stream is None:
            return self.matcher.fetch_test(out)
        with torch.cuda.stream(self._copy_stream):
            return self.matcher.fetch_test(out)

    def _test(self, mode, export_result, output_name, progress):
        """A loader thread keeps two images ahead; the device pipeline is two
        deep: image i + 1 is queued before image i is fetched and finalized
        on the host. With several processes each runs its padded
        round-robin shard (the reference's DistributedSampler deal), and
        rank 0 merges the shards through the shared directory
        `<save_dir>/multihost_gather` (run_lightning.py:23-78)."""
        stage_cfg = self.dataset_cfgs["test" if mode == "test" else "support"]
        ds = get_dataset(stage_cfg, mode)
        # the bank's instance similarity, on the host once (a read of it
        # per image would wait for the image in flight)
        self._ins_sim = self.matcher.bank.ins_sim_avg.double().cpu().numpy()
        n_proc, proc_id = multihost.env_world()
        if n_proc > 1 and os.environ.get("NTTT_COORDINATOR"):
            multihost.initialize()
        indices = multihost.process_shard_indices(len(ds), n_proc, proc_id)
        gather_dir = multihost.run_gather_dir(
            os.path.join(self.save_dir, "multihost_gather"))
        if n_proc > 1:  # drop a stale part before compute starts
            multihost.clear_rank_part(gather_dir, proc_id)
            # with a process group, no rank starts before every stale part
            # is gone (without one, NTTT_RUN_ID closes that window)
            multihost.barrier(f"nttt_parts_cleared_{mode}")
        world = (n_proc, proc_id, gather_dir)
        vis_dir = self._vis_dir(stage_cfg)
        if self.local_devices > 1:
            return self._run_test_data_parallel(ds, stage_cfg, vis_dir,
                                                indices, world, export_result,
                                                output_name, progress)
        workers = max(1, int(self.data_load_cfgs.get("workers", 0)) or 1)
        n = len(indices)
        # the shard's pad duplicates (its tail) keep the merge aligned and
        # stay out of the analysis rows
        n_real = multihost.rank_real_count(len(ds), n_proc, proc_id)

        def finalize(item, device_out, dt, analysis):
            self.time_queue.append(dt)
            raw = self._fetch(device_out)
            self.output_queue.append(self._finalize_one(
                ds, stage_cfg, vis_dir, item, raw, analysis=analysis))

        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(ds.__getitem__, j) for j in indices[:2]]
            pending = None  # (item, device_out, dt, analysis)
            for pos in range(n):
                with span("nttt.load_wait"):
                    item = futures.pop(0).result()
                if pos + 2 < n:
                    futures.append(pool.submit(ds.__getitem__,
                                               indices[pos + 2]))
                t0 = time.perf_counter()
                out = self.matcher.test_async(item["target_img"])
                if pending is not None:
                    finalize(*pending)  # host work overlaps this compute
                # completion fence (timed like the reference's synchronized
                # forward)
                out["scores"].cpu()
                dt = time.perf_counter() - t0
                pending = (item, out, dt, pos < n_real)
                if progress and (pos + 1) % 20 == 0:
                    print(f"test {pos + 1}/{n}")
            if pending is not None:
                finalize(*pending)

        return self._report_and_evaluate(ds, self.output_queue, world,
                                         export_result, output_name,
                                         np.array(self.time_queue),
                                         n_images=len(self.time_queue))

    def _fetch_dp(self, out):
        """The host copy of a data-parallel batch: `fetch_test` of each
        replica's outputs (the valid prefix of the logits only), stacked on
        a leading axis."""
        per = [self.matcher.fetch_test({k: v[j] for k, v in out.items()})
               for j in range(len(out["valid"]))]
        return {k: np.stack([o[k] for o in per]) for k in per[0]}

    def _run_test_data_parallel(self, ds, stage_cfg, vis_dir, indices, world,
                                export_result, output_name, progress):
        """This process's shard `indices` over one replica per device
        (`parallel/mesh.py`), in batches of one image per replica, with the
        single-device loop's structure: a loader thread two batches ahead
        and a two-deep pipeline, batch i fetched and finalized while batch
        i + 1 computes. With data_load_cfgs["finalize_workers"] = W > 0 the
        native finalize of each row runs in W worker processes
        (`utils/finalize_pool.py`), unless the online visualization is on:
        its panels need the binary masks in process. Replica j sees
        indices[j::n], so zipping the replicas' lists restores the shard's
        order."""
        n_proc, proc_id, _ = world
        n = self.local_devices
        run = make_data_parallel_test(self.matcher, self._replica_devices())
        per_replica = [[] for _ in range(n)]
        batches = [indices[i:i + n] for i in range(0, len(indices), n)]

        def load(batch):
            items = [ds[j] for j in batch]
            # pad the tail batch; the interleave truncates it
            return items + [items[-1]] * (n - len(items))

        fin_pool = None
        fw = int(self.data_load_cfgs.get("finalize_workers", 0) or 0)
        if fw > 0 and vis_dir is None:
            from no_time_to_train_tpu_torch.utils import native
            if native.has_finalize():
                from no_time_to_train_tpu_torch.utils.finalize_pool import (
                    FinalizePool)
                fin_pool = FinalizePool(fw)
        # the shard's pads sit at its tail (rank_real_count), on top of the
        # tail batch's pads
        n_real = multihost.rank_real_count(len(ds), n_proc, proc_id)

        def finalize(items, n_valid, out, dt, base):
            self.time_queue.append(dt / n)
            raw_all = self._fetch_dp(out)
            lr = raw_all["lr_logits"].shape[-1]
            futs = [None] * n
            for j, item in enumerate(items):
                info = item["target_img_info"]
                # an image smaller than the logits takes the antialiased
                # downscale in process
                if fin_pool is not None and info["ori_height"] >= lr \
                        and info["ori_width"] >= lr:
                    nv = int(raw_all["valid"][j].sum())
                    futs[j] = fin_pool.submit_row(
                        raw_all["lr_logits"][j, :nv], info["ori_height"],
                        info["ori_width"])
            for j, item in enumerate(items):
                fin = None
                if futs[j] is not None:
                    segs, boxes = futs[j].result()
                    nv = len(segs)
                    fin = dict(segs=segs, bboxes=boxes,
                               scores=np.asarray(raw_all["scores"][j, :nv],
                                                 np.float32),
                               labels=raw_all["labels"][j, :nv])
                raw = {k: v[j] for k, v in raw_all.items()}
                # pads (the tail batch's, or the shard's) keep the merge
                # aligned and stay out of the analysis rows
                per_replica[j].append(self._finalize_one(
                    ds, stage_cfg, vis_dir, item, raw,
                    analysis=j < n_valid and base + j < n_real, fin=fin))

        workers = max(1, int(self.data_load_cfgs.get("workers", 0)) or 1)
        try:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futures = [pool.submit(load, b) for b in batches[:2]]
                pending = None
                for bi, batch in enumerate(batches):
                    with span("nttt.load_wait"):
                        items = futures.pop(0).result()
                    if bi + 2 < len(batches):
                        futures.append(pool.submit(load, batches[bi + 2]))
                    t0 = time.perf_counter()
                    out = run(np.stack([it["target_img"] for it in items]))
                    if pending is not None:
                        finalize(*pending)  # host work overlaps this compute
                    for scores in out["scores"]:
                        scores.cpu()        # completion fence
                    dt = time.perf_counter() - t0
                    pending = (items, len(batch), out, dt, bi * n)
                    if progress and (bi + 1) % 20 == 0:
                        print(f"test {(bi + 1) * n}/{len(indices)}")
                if pending is not None:
                    finalize(*pending)
        finally:
            if fin_pool is not None:
                fin_pool.shutdown()
        merged = interleave_results(per_replica, len(indices))
        self.output_queue.extend(merged)
        return self._report_and_evaluate(ds, merged, world, export_result,
                                         output_name,
                                         np.array(self.time_queue),
                                         n_images=len(indices), time_scale=n)

    def _finalize_one(self, ds, stage_cfg, vis_dir, item, raw, analysis=True,
                      fin=None):
        """Per-image tail of the test loops: finalize the raw device output
        at the original resolution, COCO-encode it and, for rows that are
        not pads (analysis=True), queue the analysis scalars and draw the
        online visualization into vis_dir (None: off). Returns the encoded
        per-image results. `fin` passes in a finalize computed by a worker
        process."""
        info = item["target_img_info"]
        if fin is None and vis_dir is None:
            # fused native finalize: upsample + binarize + RLE + box in one
            # pass per mask, full-res masks never materialized; the panels
            # need the binary masks, so the visualization keeps
            # finalize_results (the same records)
            fin = finalize_records(raw, info["ori_height"],
                                   info["ori_width"])
        if fin is None:
            fin = finalize_results(raw, info["ori_height"], info["ori_width"])
        per_img = dict(img_id=info["id"], scores=fin["scores"],
                       labels=fin["labels"], boxes=fin["bboxes"])
        if "segs" in fin:
            per_img["segs"] = fin["segs"]
        else:
            per_img["masks"] = fin["binary_masks"]
        encoded = ds.encode_results([per_img])
        if analysis:
            self._queue_scalars(item, raw, fin)
            if vis_dir is not None:
                from no_time_to_train_tpu_torch.data.visualization import (
                    vis_results_online)
                vis_results_online(
                    fin, item.get("tar_anns_by_cat"),
                    (info["ori_height"], info["ori_width"]),
                    os.path.join(ds.root, info["file_name"]), vis_dir,
                    score_thr=self.vis_thr,
                    dataset_name=stage_cfg.get("name"),
                    class_names=ds.cat_names)
        return encoded

    def _report_and_evaluate(self, ds, results, world, export_result,
                             output_name, times_np, n_images, time_scale=1):
        """Tail of the test loops: FPS report (reference sam2matcher_pl.py
        summary format), then with several processes the publish of this
        rank's part and rank 0's interleaved merge (reference
        collect_results_cpu, run_lightning.py:23-78), the analysis pkl dumps
        of the merged rows, result export, COCO evaluation, metrics CSV.
        Ranks other than 0 return None after publishing. `times_np` holds
        seconds per image, a data-parallel batch's divided by its devices
        (`time_scale`)."""
        n_proc, proc_id, gather_dir = world
        print("\n[Validation] Inference Time Benchmark:")
        print(f"  Total images: {n_images}")
        print(f"  Total time: {np.sum(times_np) * time_scale:.4f} s")
        print(f"  Average time per image: {np.mean(times_np):.4f} s")
        print(f"  FPS: {1.0 / np.mean(times_np):.2f}")

        scalars, triplets = list(self.scalars_queue), list(self.triplets_queue)
        if n_proc > 1:
            multihost.save_rank_results(gather_dir, proc_id, results,
                                        scalars, triplets)
            if proc_id != 0:
                return None
            results, scalars, triplets = multihost.collect_results(
                gather_dir, n_proc, len(ds))
        results_unpacked = [r for per_img in results for r in per_img]
        for fname, rows in (("scalars_all.pkl", scalars),
                            ("triplets_all.pkl", triplets)):
            if rows:
                os.makedirs(self.save_dir, exist_ok=True)
                with open(os.path.join(self.save_dir, fname), "wb") as f:
                    pickle.dump(rows, f)
        if export_result:
            with open(export_result, "w") as f:
                json.dump(results_unpacked, f)
        stats = ds.evaluate(results_unpacked, output_name=output_name)
        self._write_metrics_csv(stats, times_np, n_images=n_images)
        return stats

    def _queue_scalars(self, item, raw, fin):
        """Score dumps for the offline analysis layer (reference
        run_lightning.py:163-168 + tools/analysis_scripts/*):

        scalars_all.pkl rows [sim, category, oracle_iou, mem_ins_sim] and
        triplets_all.pkl rows [sim, pred_iou, oracle_iou], one array per
        image. Oracle IoU (best IoU vs a same-class GT instance) is computed
        at the low-res mask resolution from the Oracle dataset's GT; without
        GT (plain test dataset) oracle columns are NaN."""
        n = len(fin["scores"])
        if n == 0:
            return
        cats = np.asarray(fin["labels"], np.int64)
        sims = np.asarray(fin["scores"], np.float64)
        pred_ious = np.asarray(raw["pred_ious"][:n], np.float64)
        anns = item.get("tar_anns_by_cat")
        oracle = np.full(n, np.nan)
        if anns is not None:
            lr = np.asarray(raw["lr_logits"][:n], np.float32)
            lr_res = lr.shape[-1]
            pred = (lr > 0).reshape(n, -1)
            gt_small = {}
            for cat_ind, e in anns.items():
                ms = np.asarray(e["masks"])
                step = max(1, ms.shape[-1] // lr_res)
                gt_small[cat_ind] = (
                    ms[:, ::step, ::step][:, :lr_res, :lr_res] > 0.5
                ).reshape(ms.shape[0], -1)
            for i in range(n):
                g = gt_small.get(int(cats[i]))
                if g is None:
                    oracle[i] = 0.0
                    continue
                inter = (pred[i][None] & g).sum(1)
                union = (pred[i][None] | g).sum(1)
                oracle[i] = float(
                    (inter / np.maximum(union, 1)).max())
        self.scalars_queue.append(
            np.stack([sims, cats.astype(np.float64), oracle,
                      self._ins_sim[cats]], axis=1))
        self.triplets_queue.append(np.stack([sims, pred_ious, oracle],
                                            axis=1))

    def _write_metrics_csv(self, stats, times_np, path=None, n_images=None):
        """CSV metrics record (replaces the reference's Lightning CSVLogger,
        new_exps/*.yaml:59-63). `n_images` overrides the count of
        `times_np`, which holds one entry per batch in the data-parallel
        loop."""
        row = {"images": n_images if n_images is not None else len(times_np),
               "mean_time_s": float(np.mean(times_np)),
               "fps": float(1.0 / np.mean(times_np))}
        if stats:
            for iou_type, st in stats.items():
                row[f"{iou_type}_AP"] = float(st[0])
                row[f"{iou_type}_AP50"] = float(st[1])
                row[f"{iou_type}_AP75"] = float(st[2])
        if path is None:
            os.makedirs(self.save_dir, exist_ok=True)
            path = os.path.join(self.save_dir, "metrics_log.csv")
        write_header = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if write_header:
                w.writeheader()
            w.writerow(row)
