"""Published peaks of the cards the benchmark knows, by a substring of
`torch.cuda.get_device_name()`: NVIDIA's data sheet for the H100 SXM
(80 GB HBM3), dense rates without sparsity, at the full 700 W power limit.
A card set below it runs slower under load; every result prints the
card's limit beside its numbers."""

__all__ = ["peaks"]

TABLE = {
    "H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12,
                       "float32": 67e12, "bytes_per_s": 3.35e12},
}


def peaks(device_name):
    """The peak table of the card, or None for a card not in the table."""
    for key, row in TABLE.items():
        if key in device_name:
            return row
    return None
