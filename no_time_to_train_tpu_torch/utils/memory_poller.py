"""Device memory poller (port of `no_time_to_train_tpu/utils/memory_poller.py`;
the reference's nvidia-smi sampler, scripts/run_nttt_eval.sh:26-60). It runs
as a process of its own beside the run it watches, so it reads device-wide
usage through `nvidia-smi` (NVML's numbers), never an allocator of its own:

    python -m no_time_to_train_tpu_torch.utils.memory_poller --out mem.csv \\
        [--interval 2.0]

Every interval it appends one CSV row per GPU, `t,index,used_mib,total_mib`,
until it is killed. It imports neither torch nor anything of the run.
"""
import argparse
import csv
import subprocess
import time

QUERY = ["nvidia-smi", "--query-gpu=index,memory.used,memory.total",
         "--format=csv,noheader,nounits"]
FIELDS = ["t", "index", "used_mib", "total_mib"]


def parse(text):
    """Rows of `nvidia-smi --query-gpu=index,memory.used,memory.total
    --format=csv,noheader,nounits` -> [(index, used_mib, total_mib)]."""
    rows = []
    for line in text.strip().splitlines():
        if line.strip():
            index, used, total = (int(v) for v in line.split(","))
            rows.append((index, used, total))
    return rows


def sample():
    """One reading of every GPU."""
    res = subprocess.run(QUERY, capture_output=True, text=True, timeout=30,
                         check=True)
    return parse(res.stdout)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--interval", type=float, default=2.0)
    a = p.parse_args(argv)
    with open(a.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        f.flush()
        while True:
            t = round(time.time(), 3)
            for index, used, total in sample():
                w.writerow({"t": t, "index": index, "used_mib": used,
                            "total_mib": total})
            f.flush()
            time.sleep(a.interval)


if __name__ == "__main__":
    main()
