"""Inputs made from the seed: the memory bank's reference images and the
test images of the closed loop.

The patterns are those of `chip_smoke.py` (`synthetic_refs`,
`synthetic_target`): low-contrast noise with objects
painted in class colours. Every seed gets the same set of original image
sizes, in its own order, so that the seed changes the content and the
order but not the amount of host work. Image content is drawn on the
device in bulk; the same seed gives the same tensors, so the reference
draws them again after the measured window instead of holding them.
"""
import numpy as np
import torch

__all__ = ["sub_seed", "original_sizes", "reference_set", "targets",
           "class_color"]


def sub_seed(seed, stream):
    """An independent seed for one use of the run's seed."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])


def class_color(cls):
    return np.array([(cls * 53 % 255), (cls * 97 % 255), (cls * 151 % 255)],
                    np.float32) / 255.0


def original_sizes(traffic, n):
    """n (height, width) pairs, the same set for every seed: long side
    `long_side`, short sides evenly spaced over `short_side`, portrait and
    landscape in turn."""
    lo, hi = traffic["short_side"]
    long = traffic["long_side"]
    shorts = np.linspace(lo, hi, n).round().astype(int)
    return [(int(s), long) if i % 2 == 0 else (long, int(s))
            for i, s in enumerate(shorts)]


@torch.no_grad()
def reference_set(bank, seed, device):
    """The bank's references: `shots` per class, class-major, each a
    noise image with a rectangle in its class colour, the rectangle being
    its mask. Returns (imgs [R, S, S, 3], masks [R, S, S], class indices)."""
    c, l, s = bank["classes"], bank["shots"], bank["ref_size"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    imgs = torch.rand((c * l, s, s, 3), generator=gen, device=device) * 0.3
    masks = torch.zeros((c * l, s, s), device=device)
    rng = np.random.default_rng(sub_seed(seed, 2))
    cats = []
    for cls in range(c):
        color = torch.as_tensor(class_color(cls), device=device)
        for j in range(l):
            i = cls * l + j
            h = s // 4 + (cls * 7 + j * 5) % (s // 3)
            w = s // 4 + (cls * 11 + j * 3) % (s // 3)
            y, x = int(rng.integers(0, s - h)), int(rng.integers(0, s - w))
            imgs[i, y:y + h, x:x + w] = 0.7 * color + 0.3 * imgs[i, y:y + h,
                                                                x:x + w]
            masks[i, y:y + h, x:x + w] = 1.0
            cats.append(cls)
    return imgs, masks, cats


@torch.no_grad()
def targets(traffic, n_classes, image_size, seed, device):
    """The closed loop's pool: `pool` target images [P, S, S, 3] on the
    device (noise with `objects` rectangles of random classes), and each
    one's original size."""
    n, k = traffic["pool"], traffic["objects"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    imgs = torch.rand((n, image_size, image_size, 3), generator=gen,
                      device=device) * 0.3
    rng = np.random.default_rng(sub_seed(seed, 4))
    s = image_size
    for i in range(n):
        for _ in range(k):
            cls = int(rng.integers(0, n_classes))
            color = torch.as_tensor(class_color(cls), device=device)
            h, w = (int(v) for v in rng.integers(s // 8, s // 3, size=2))
            y, x = int(rng.integers(0, s - h)), int(rng.integers(0, s - w))
            imgs[i, y:y + h, x:x + w] = 0.7 * color + 0.3 * imgs[i, y:y + h,
                                                                x:x + w]
    sizes = original_sizes(traffic, n)
    order = np.random.default_rng(sub_seed(seed, 5)).permutation(n)
    return imgs, [sizes[j] for j in order]
