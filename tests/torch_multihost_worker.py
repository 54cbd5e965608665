"""One rank of the two-process run of tests/test_torch_parallel.py.

Each of two OS processes joins one gloo process group (a `file://`
rendezvous in the test's temporary directory) and runs the port's CLI on the
CPU through fill_memory (the cross-process fill: each rank encodes its row of
every batch of two, and the features are gathered), postprocess_memory and
test with an export, which rank 0 merges. Only rank 0 writes the
checkpoints. The process imports torch and the port, never JAX.

Usage: python torch_multihost_worker.py <rank> <workdir> <cfg> <presets json>
"""
import json
import os
import sys


def main():
    rank, workdir, cfg_path, presets_json = sys.argv[1:5]
    os.environ.update(NTTT_NUM_PROCESSES="2", NTTT_PROCESS_ID=rank,
                      NTTT_DIST_BACKEND="gloo",
                      NTTT_COORDINATOR="file://" + os.path.join(workdir,
                                                                "rendezvous"))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    torch.set_num_threads(1)
    from no_time_to_train_tpu_torch import cli
    from no_time_to_train_tpu_torch.config import presets
    from no_time_to_train_tpu_torch.parallel import multihost

    # the tiny presets of the parent test, registered here too
    spec = json.loads(presets_json)
    presets.SAM2_PRESETS[spec["sam_name"]] = presets.Sam2Config(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in spec["sam_fields"].items()})
    presets.ENCODER_PRESETS[spec["enc_args"][0]] = presets.EncoderConfig(
        *spec["enc_args"])

    base = ["test", "--config", cfg_path, "--device", "cpu",
            "--trainer.devices", "2", "--trainer.logger.save_dir",
            os.path.join(workdir, "results")]
    mem, post = (os.path.join(workdir, k) for k in ("m.ckpt", "p.ckpt"))
    cli.main(base + ["--model.test_mode", "fill_memory", "--out_path", mem])
    cli.main(base + ["--model.test_mode", "postprocess_memory",
                     "--ckpt_path", mem, "--out_path", post])
    runner = cli.main(base + ["--model.test_mode", "test", "--ckpt_path",
                              post, "--export_result",
                              os.path.join(workdir, "merged.json")])
    with open(os.path.join(workdir, f"rank_{rank}.json"), "w") as f:
        json.dump({"world": torch.distributed.get_world_size(),
                   "backend": torch.distributed.get_backend(),
                   "local_devices": runner.local_devices,
                   "images": len(runner.time_queue)}, f)
    # leave in lockstep: rank 0 merges and evaluates while rank 1 waits
    multihost.barrier("worker_done")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
