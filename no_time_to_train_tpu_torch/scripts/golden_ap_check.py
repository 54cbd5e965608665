"""Release acceptance harness: COCO few-shot golden-AP check (port of
`scripts/golden_ap_check.py`).

Runs the headline few-shot pipeline (few_shot_full_pipeline.sh semantics:
sample references -> fill_memory -> postprocess_memory -> test) through the
port's CLI against real SAM2 + DINO checkpoints and the real COCO val set,
then holds the COCO bbox / segm AP to the reference's published numbers
(reference README.md:250-258 — 30-shot seed-33 few_shot_classes split: bbox
AP 0.368, segm AP 0.342).

Gated on its data: whenever a prerequisite file is missing it prints
SKIPPED and exits 0 (exit 3 with --strict). When the data exists:

    python -m no_time_to_train_tpu_torch.scripts.golden_ap_check \\
        --config configs/coco_fewshot_10shot_Sam2L.yaml \\
        --dino-ckpt /path/to/dinov2_large --shots 30 --seed 33 \\
        [--device cpu]

Exit codes: 0 = pass (or skipped), 1 = AP outside tolerance, 2 = pipeline
error, 3 = --strict with missing prerequisites (environment not
provisioned — distinct from an AP regression). Tolerance is in AP points on
the 0-100 scale (default 0.3: |AP - published| <= 0.003 absolute).
"""
import argparse
import csv
import os
import sys

from no_time_to_train_tpu_torch.config import yaml_lite
from no_time_to_train_tpu_torch.utils.entry import entry_device

# published anchors (reference README.md:250-258); 30-shot is the only
# configuration the reference README commits numbers for
PUBLISHED = {30: {"bbox": 0.368, "segm": 0.342}}


def load_config_paths(config_path):
    """Prerequisite files implied by the experiment YAML + CLI args."""
    cfg = yaml_lite.load_file(config_path)
    init = cfg["model"]["init_args"]
    model_cfg = init["model_cfg"]
    ds = init["dataset_cfgs"]
    return {
        "sam2_ckpt": model_cfg.get("sam2_ckpt_path"),
        "fill_root": ds["fill_memory"]["root"],
        "fill_json": ds["fill_memory"]["json_file"],
        "test_root": ds["test"]["root"],
        "test_json": ds["test"]["json_file"],
    }


def check_prereqs(config_path, dino_ckpt=None):
    """Return the list of missing prerequisite paths (empty = runnable)."""
    paths = load_config_paths(config_path)
    paths["dino_ckpt"] = dino_ckpt
    missing = []
    for name, p in paths.items():
        if not p:
            missing.append(f"{name} (not configured)")
        elif not os.path.exists(str(p)):
            missing.append(f"{name}: {p}")
    return missing


def run_pipeline(config_path, dino_ckpt, shots, seed, class_split,
                 results_dir, devices=1, device="cuda"):
    """The four stages of few_shot_full_pipeline.sh through the port's CLI
    on `device`, returning the metrics_log.csv row of the test stage."""
    from no_time_to_train_tpu_torch import cli
    from no_time_to_train_tpu_torch.data.few_shot_sampling import (
        sample_memory_dataset)

    os.makedirs(results_dir, exist_ok=True)
    pkl = os.path.join(results_dir, f"few_shot_{shots}shot_seed{seed}.pkl")
    paths = load_config_paths(config_path)
    # reference few_shot_full_pipeline.sh stage 1: --dataset <class_split>
    sample_memory_dataset(paths["fill_json"], pkl, shots, remove_bad=True,
                          dataset=class_split, seed=seed)

    mem = os.path.join(results_dir, "memory.ckpt")
    post = os.path.join(results_dir, "memory_postprocessed.ckpt")
    export = os.path.join(results_dir, f"results_{shots}shot_{seed}seed.json")
    common = ["test", "--config", config_path,
              "--model.init_args.model_cfg.memory_bank_cfg.length",
              str(shots),
              "--model.init_args.model_cfg.encoder_ckpt_path", str(dino_ckpt),
              "--device", str(device)]
    cli.main(common + [
        "--model.test_mode", "fill_memory", "--out_path", mem,
        "--model.init_args.dataset_cfgs.fill_memory.memory_pkl", pkl,
        "--model.init_args.dataset_cfgs.fill_memory.memory_length",
        str(shots),
        "--model.init_args.dataset_cfgs.fill_memory.class_split", class_split,
        "--trainer.logger.save_dir", results_dir,
        "--trainer.devices", str(devices)])
    cli.main(common + [
        "--model.test_mode", "postprocess_memory",
        "--ckpt_path", mem, "--out_path", post,
        "--trainer.devices", "1"])
    cli.main(common + [
        "--model.test_mode", "test", "--ckpt_path", post,
        "--model.init_args.dataset_cfgs.test.class_split", class_split,
        "--export_result", export,
        "--trainer.logger.save_dir", results_dir,
        "--trainer.devices", str(devices)])

    with open(os.path.join(results_dir, "metrics_log.csv")) as f:
        rows = list(csv.DictReader(f))
    return rows[-1]


def compare(row, expected, tolerance_points):
    """(ok, report_lines) for |AP - published| <= tolerance (AP points on
    the 0-100 scale, i.e. tolerance 0.3 -> 0.003 absolute)."""
    ok = True
    lines = []
    for iou_type, want in expected.items():
        got = float(row[f"{iou_type}_AP"])
        delta = abs(got - want) * 100.0
        good = delta <= tolerance_points + 1e-9
        ok &= good
        lines.append(f"{iou_type} AP {got:.4f} vs published {want:.4f} "
                     f"(|delta| {delta:.2f} points) "
                     f"{'OK' if good else 'FAIL'}")
    return ok, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config",
                    default="configs/coco_fewshot_10shot_Sam2L.yaml")
    ap.add_argument("--dino-ckpt", default=None,
                    help="DINOv2-L checkpoint (HF directory); required — "
                         "random encoder weights score ~0 AP")
    ap.add_argument("--shots", type=int, default=30)
    ap.add_argument("--seed", type=int, default=33)
    ap.add_argument("--class-split", default="few_shot_classes")
    ap.add_argument("--results-dir", default="work_dirs/golden_ap")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--tolerance", type=float, default=0.3,
                    help="max |AP - published| in AP points (0-100 scale)")
    ap.add_argument("--expected-bbox", type=float, default=None)
    ap.add_argument("--expected-segm", type=float, default=None)
    ap.add_argument("--strict", action="store_true",
                    help="missing data is an error instead of a skip")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = entry_device(a.device)

    missing = check_prereqs(a.config, a.dino_ckpt)
    if missing:
        print("golden_ap_check: SKIPPED — missing prerequisites:")
        for m in missing:
            print(f"  - {m}")
        return 3 if a.strict else 0  # 3: env not provisioned

    expected = dict(PUBLISHED.get(a.shots, {}))
    if a.expected_bbox is not None:
        expected["bbox"] = a.expected_bbox
    if a.expected_segm is not None:
        expected["segm"] = a.expected_segm
    if not expected:
        print(f"golden_ap_check: no published anchor for {a.shots}-shot and "
              f"no --expected-* given; running report-only")

    try:
        row = run_pipeline(a.config, a.dino_ckpt, a.shots, a.seed,
                           a.class_split, a.results_dir, a.devices, device)
    except Exception as e:  # pipeline errors apart from AP failures
        print(f"golden_ap_check: PIPELINE ERROR — {type(e).__name__}: {e}")
        return 2

    if not expected:
        print(f"golden_ap_check: REPORT bbox_AP={row.get('bbox_AP')} "
              f"segm_AP={row.get('segm_AP')}")
        return 0
    ok, lines = compare(row, expected, a.tolerance)
    for ln in lines:
        print(f"golden_ap_check: {ln}")
    print(f"golden_ap_check: {'PASS' if ok else 'FAIL'} "
          f"({a.shots}-shot seed {a.seed}, tolerance {a.tolerance} points)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
