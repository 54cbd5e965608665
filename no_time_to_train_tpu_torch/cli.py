"""The port's CLI entry point, with the surface of `run_lightning.py` (the
same subcommand, YAML schema, dotted overrides and extra flags) over the
port's runner, plus one flag of its own, `--device` (default `cuda`; `cpu`
runs on the CPU, and without a CUDA device nothing else does).
With NTTT_NUM_PROCESSES > 1 and NTTT_COORDINATOR set it first joins the
process group of `parallel/multihost.py`'s contract.

    python -m no_time_to_train_tpu_torch.cli test --config cfg.yaml \\
        --model.test_mode fill_memory --out_path memory.ckpt \\
        --model.init_args.model_cfg.memory_bank_cfg.length 10 \\
        --model.init_args.dataset_cfgs.fill_memory.memory_pkl refs.pkl
    python -m no_time_to_train_tpu_torch.cli test --config cfg.yaml \\
        --model.test_mode postprocess_memory --ckpt_path memory.ckpt \\
        --out_path memory_post.ckpt
    python -m no_time_to_train_tpu_torch.cli test --config cfg.yaml \\
        --model.test_mode test --ckpt_path memory_post.ckpt \\
        [--export_result out.json] [--device cpu]
"""
import ast
import os
import pickle
import sys

import torch

from no_time_to_train_tpu_torch.config import yaml_lite


def _set_dotted(tree, dotted, value):
    parts = dotted.split(".")
    node = tree
    for i, p in enumerate(parts[:-1]):
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            # reference HACK: dotted keys may land inside leaf dicts
            node[".".join(parts[i:])] = value
            return
        node = nxt
    node[parts[-1]] = value


def _parse_value(v):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        if v.lower() in ("null", "none"):
            return None
        return v


TOP_LEVEL = {"out_path", "ckpt_path", "export_result", "seed", "n_shot",
             "coco_semantic_split", "out_support_res", "out_neg_pkl",
             "out_neg_json", "config", "device"}


def parse_args(argv):
    if not argv or argv[0] not in ("test", "fit", "predict"):
        raise SystemExit("usage: python -m no_time_to_train_tpu_torch.cli "
                         "test --config <yaml> [overrides]")
    args = {"subcommand": argv[0]}
    overrides = []
    i = 1
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise SystemExit(f"unexpected argument {a}")
        if "=" in a:
            key, val = a[2:].split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"{a} needs a value")
            key = a[2:]
            val = argv[i + 1]
            i += 2
        if key in TOP_LEVEL:
            args[key] = val
        else:
            overrides.append((key, _parse_value(val)))
    return args, overrides


def main(argv=None):
    """Run one phase; returns the MatcherRunner it used, with what its
    `run` returned as `.result`."""
    argv = argv if argv is not None else sys.argv[1:]
    args, overrides = parse_args(argv)
    if args["subcommand"] != "test":
        raise SystemExit("only `test` is supported (the reference's training "
                         "path is the legacy SAM2Ref variant)")
    device = torch.device(args.get("device") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's CLI runs on the GPU; "
                           "pass --device cpu to run it on the CPU")

    if os.environ.get("NTTT_COORDINATOR"):
        # the process group of NTTT_NUM_PROCESSES processes starts before
        # the runner is built (run_lightning.py:119-125)
        from no_time_to_train_tpu_torch.parallel import multihost
        backend = multihost.backend(device)
        if backend == "nccl":
            torch.cuda.set_device(device.index or 0)
        multihost.initialize(backend_name=backend)

    cfg = yaml_lite.load_file(args["config"])
    for key, val in overrides:
        _set_dotted(cfg, key, val)

    model_node = cfg.get("model", {})
    init = model_node.get("init_args", model_node)
    model_cfg = init.get("model_cfg", {})
    dataset_cfgs = init.get("dataset_cfgs", {})
    data_load_cfgs = init.get("data_load_cfgs", {})
    test_mode = model_node.get("test_mode", init.get("test_mode", "none"))

    # replicate run_lightning.py:92-103 (before_test): memory_length wiring
    mb_cfg = model_cfg.get("memory_bank_cfg", {})
    if test_mode == "fill_memory" and "fill_memory" in dataset_cfgs:
        dataset_cfgs["fill_memory"]["memory_length"] = mb_cfg.get("length")
    elif test_mode == "fill_memory_neg" and "fill_memory" in dataset_cfgs:
        dataset_cfgs["fill_memory"]["memory_length"] = mb_cfg.get(
            "length_negative")
        if "support" in dataset_cfgs:
            dataset_cfgs["fill_memory"]["root"] = dataset_cfgs["support"]["root"]
        if args.get("out_neg_json"):
            dataset_cfgs["fill_memory"]["json_file"] = args["out_neg_json"]
        if args.get("out_neg_pkl"):
            dataset_cfgs["fill_memory"]["memory_pkl"] = args["out_neg_pkl"]

    seed = int(args.get("seed") or cfg.get("seed_everything", 42))
    trainer_cfg = cfg.get("trainer", {})
    devices = int(trainer_cfg.get("devices", 1) or 1)
    logger_cfg = trainer_cfg.get("logger") or {}
    if "init_args" in logger_cfg:       # Lightning class_path/init_args form
        logger_cfg = logger_cfg["init_args"] or {}
    save_dir = (logger_cfg.get("save_dir")
                or trainer_cfg.get("logger.save_dir") or ".")

    from no_time_to_train_tpu_torch.runner import MatcherRunner
    runner = MatcherRunner(model_cfg, dataset_cfgs, data_load_cfgs,
                           test_mode=test_mode, seed=seed, devices=devices,
                           save_dir=save_dir, device=device)

    output_name = ""
    if args.get("coco_semantic_split"):
        output_name += f"semantic_split_{args['coco_semantic_split']}_"
    if args.get("n_shot") and args.get("seed"):
        output_name += f"{args['n_shot']}shot_{args['seed']}seed"

    # a test phase's COCO stats; None on ranks other than 0
    runner.result = runner.run(ckpt_path=args.get("ckpt_path"),
                               out_path=args.get("out_path"),
                               export_result=args.get("export_result"),
                               output_name=output_name)

    if test_mode == "test_support" and args.get("out_support_res"):
        results = [r for q in runner.output_queue for r in q]
        with open(args["out_support_res"], "wb") as f:
            pickle.dump(results, f)
    return runner


if __name__ == "__main__":
    main()
