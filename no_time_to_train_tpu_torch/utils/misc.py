"""Small shared helpers (port of `no_time_to_train_tpu/utils/misc.py`;
reference no_time_to_train/utils.py)."""


def print_dict(d, indent=0):
    for k, v in d.items():
        if isinstance(v, dict):
            print(" " * indent + f"{k}:")
            print_dict(v, indent + 2)
        else:
            print(" " * indent + f"{k}: {v}")
