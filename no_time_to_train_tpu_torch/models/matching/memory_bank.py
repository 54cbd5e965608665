"""Per-class memory bank of masked-pooled DINO features (port of
`no_time_to_train_tpu/models/matching/memory_bank.py`; reference
matching_baseline_utils.py:538-656).

The bank is a dataclass of tensors on one device. `postprocess` computes the
class and instance prototypes, the covariances, the mean pairwise instance
similarity, k-means centres and PCA, batched over classes. The k-means
initialisation draws from a `torch.Generator` on the bank's device, so its
random rows differ from the JAX package's by design; everything else is
deterministic. `kmeans_decouple` and `kmeans_pp_init` (the Matcher
baseline's clustering) take their random start as an argument, or draw it
from a generator, so that the draw stays apart from the iterations.
"""
from dataclasses import dataclass, replace

import torch

__all__ = ["MemoryBank", "create", "fill", "postprocess", "kmeans_decouple",
           "kmeans_pp_init"]


@dataclass(frozen=True)
class MemoryBank:
    fill_counts: torch.Tensor        # [C] int64
    feats: torch.Tensor              # [C, L, N, D]
    masks: torch.Tensor              # [C, L, N]
    feats_avg: torch.Tensor          # [C, D]
    feats_ins_avg: torch.Tensor      # [C, L, D]
    feats_covariances: torch.Tensor  # [C, D, D]
    feats_centers: torch.Tensor      # [C, K, D]
    ins_sim_avg: torch.Tensor        # [C]
    pca_mean: torch.Tensor           # [C, D]
    pca_components: torch.Tensor     # [C, P, D]
    postprocessed: bool = False


def create(n_classes, length, feat_n, feat_dim, kmeans_k=4, n_pca=3, *,
           device, dtype=torch.float32):
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return MemoryBank(
        fill_counts=torch.zeros(n_classes, dtype=torch.long, device=device),
        feats=z(n_classes, length, feat_n, feat_dim),
        masks=z(n_classes, length, feat_n),
        feats_avg=z(n_classes, feat_dim),
        feats_ins_avg=z(n_classes, length, feat_dim),
        feats_covariances=z(n_classes, feat_dim, feat_dim),
        feats_centers=z(n_classes, kmeans_k, feat_dim),
        ins_sim_avg=z(n_classes),
        pca_mean=z(n_classes, feat_dim),
        pca_components=z(n_classes, n_pca, feat_dim))


def fill(bank, cat_inds, feats, masks):
    """Write references into successive slots of their classes, in order
    (reference Sam2MatchingBaseline_noAMG.py:478-485). cat_inds: sequence of
    ints; feats [B, N, D]; masks [B, N]. Raises IndexError when a class
    would receive more references than the bank has slots."""
    counts = bank.fill_counts.tolist()
    length = bank.feats.shape[1]
    slots = []
    for cat in (int(c) for c in cat_inds):
        if counts[cat] >= length:
            raise IndexError(
                f"memory bank overflow: class {cat} received more than "
                f"memory_length={length} references")
        slots.append((cat, counts[cat]))
        counts[cat] += 1
    bfeats, bmasks = bank.feats.clone(), bank.masks.clone()
    for b, (cat, slot) in enumerate(slots):
        bfeats[cat, slot] += feats[b].to(bfeats.dtype)
        bmasks[cat, slot] += masks[b].to(bmasks.dtype)
    return replace(bank, feats=bfeats, masks=bmasks,
                   fill_counts=torch.tensor(counts, dtype=torch.long,
                                            device=bank.feats.device))


def _l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def _kmeans_masked(feats, weights, k, n_iter, generator):
    """Lloyd iterations with cosine assignment over weighted rows, batched
    over classes. feats [C, M, D], weights [C, M] in {0, 1}. The start
    centres are k random foreground rows."""
    c, m, d = feats.shape
    noise = torch.rand((c, m), generator=generator, device=feats.device)
    score = torch.where(weights > 0, noise, torch.full_like(noise, -1.0))
    init_idx = torch.argsort(-score, dim=1, stable=True)[:, :k]
    centers = torch.gather(feats, 1, init_idx[..., None].expand(c, k, d))
    fnorm = _l2n(feats)
    for _ in range(n_iter):
        assign = torch.argmax(fnorm @ _l2n(centers).transpose(1, 2), dim=2)
        onehot = torch.nn.functional.one_hot(assign, k).to(feats.dtype) \
            * weights[..., None]
        sums = onehot.transpose(1, 2) @ feats
        cnts = onehot.sum(dim=1)[..., None]
        centers = torch.where(cnts > 0, sums / cnts.clamp(min=1), centers)
    return _l2n(centers)


def kmeans_decouple(feats, feats_fore, k, n_iter=100, generator=None,
                    init_idx=None):
    """Decoupled k-means (reference matching_baseline_utils.py:88-126): the
    assignment by cosine on `feats`, the centres re-estimated from
    `feats_fore` [M, D]; a last pass assigns on `feats_fore` and averages
    `feats`. The start is the rows `init_idx` [k] of `feats_fore`, drawn
    from `generator` (a permutation of the M rows, its first k) when not
    given. Returns unit-norm centres [k, D]."""
    if init_idx is None:
        dev = generator.device if generator is not None else feats.device
        init_idx = torch.randperm(feats.shape[0], generator=generator,
                                  device=dev)[:k]
    centers = feats_fore[init_idx.to(feats.device)]
    fnorm = _l2n(feats)

    def mean_of(assign, rows, centers):
        onehot = torch.nn.functional.one_hot(assign, k).to(feats.dtype)
        cnts = onehot.sum(0)[:, None]
        return torch.where(cnts > 0, (onehot.T @ rows) / cnts.clamp(min=1),
                           centers)

    for _ in range(n_iter):
        centers = mean_of(torch.argmax(fnorm @ _l2n(centers).T, dim=1),
                          feats_fore, centers)
    assign = torch.argmax(_l2n(feats_fore) @ _l2n(centers).T, dim=-1)
    return _l2n(mean_of(assign, feats, centers))


def kmeans_pp_init(feats, k, generator=None, first=None, uniforms=None):
    """k-means++ seeding (reference matcher_utils.py:30): the row `first`,
    then k - 1 rows drawn one at a time with probability proportional to
    the squared L2 distance to the nearest chosen row. The draw of step i
    is the row where the cumulative probability reaches
    total * (1 - uniforms[i - 1]) (searchsorted, left), as the JAX
    package's draw with probabilities does. `first` and `uniforms` [k - 1]
    are drawn from `generator` when not given. Returns the rows [k, D]."""
    m = feats.shape[0]
    dev = generator.device if generator is not None else feats.device
    if first is None:
        first = int(torch.randint(m, (), generator=generator, device=dev))
    if uniforms is None:
        uniforms = torch.rand(k - 1, generator=generator, device=dev)
    uniforms = torch.as_tensor(uniforms, dtype=feats.dtype,
                               device=feats.device)
    centers = feats.new_zeros((k, feats.shape[1]))
    centers[0] = feats[first]
    for i in range(1, k):
        d2 = ((feats[:, None, :] - centers[None, :i]) ** 2).sum(-1).amin(1)
        probs = d2 / d2.sum().clamp(min=1e-12)
        cum = torch.cumsum(probs, 0)
        r = cum[-1] * (1 - uniforms[i - 1])
        nxt = torch.searchsorted(cum, r[None])[0].clamp(max=m - 1)
        centers[i] = feats[nxt]
    return centers


def _pca_from_cov(cov, n_comp):
    """Top principal components of [C, D, D] covariances, sklearn's
    svd_flip sign convention (largest-|x| entry made positive)."""
    _, evecs = torch.linalg.eigh(cov)                   # ascending
    comps = evecs.flip(-1)[..., :n_comp].transpose(1, 2)    # [C, P, D]
    idx = comps.abs().argmax(dim=-1, keepdim=True)
    signs = torch.sign(torch.gather(comps, -1, idx))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return comps * signs


def postprocess(bank, generator=None, n_iter=100):
    """Prototypes, covariances, instance similarity, k-means and PCA."""
    c, l, n, d = bank.feats.shape
    k = bank.feats_centers.shape[1]
    n_pca = bank.pca_components.shape[1]
    dev = bank.feats.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    masks = bank.masks.float()
    feats = bank.feats.float()

    msum_g = masks.sum(dim=(1, 2))[:, None]
    msum_g = torch.where(msum_g == 0, torch.ones_like(msum_g), msum_g)
    feats_avg = (feats * masks[..., None]).sum(dim=(1, 2)) / msum_g

    msum_i = masks.sum(dim=2)[..., None]
    msum_i = torch.where(msum_i == 0, torch.ones_like(msum_i), msum_i)
    feats_ins_avg = (feats * masks[..., None]).sum(dim=2) / msum_i

    x = (feats - feats_avg[:, None, None]).reshape(c, l * n, d)
    w = masks.reshape(c, l * n)
    n_fg = w.sum(dim=1)
    sigma = (x * w[..., None]).transpose(1, 2) @ x \
        / n_fg.clamp(min=1.0)[:, None, None]
    eye = torch.eye(d, device=dev).expand(c, d, d)
    covs = torch.where((n_fg > 0)[:, None, None], sigma, eye)

    ins_norm = _l2n(feats_ins_avg)
    sim = ins_norm @ ins_norm.transpose(1, 2)
    slot_valid = (torch.arange(l, device=dev)[None, :]
                  < bank.fill_counts[:, None]).float()
    pair = slot_valid[:, :, None] * slot_valid[:, None, :] \
        * (1.0 - torch.eye(l, device=dev))[None]
    denom = pair.sum(dim=(1, 2))
    ins_sim = torch.where(denom > 0, (sim * pair).sum(dim=(1, 2))
                          / denom.clamp(min=1.0), torch.zeros_like(denom))

    centers = _kmeans_masked(feats.reshape(c, l * n, d), w, k, n_iter,
                             generator)
    centers = torch.where((w.sum(dim=1) >= k)[:, None, None], centers,
                          bank.feats_centers.float())

    ok = (w.sum(dim=1) >= n_pca)[:, None]
    comps = torch.where(ok[..., None], _pca_from_cov(covs, n_pca),
                        bank.pca_components.float())
    means = torch.where(ok, feats_avg, torch.zeros_like(feats_avg))

    dt = bank.feats.dtype
    return replace(
        bank, feats_avg=feats_avg.to(dt), feats_ins_avg=feats_ins_avg.to(dt),
        feats_covariances=covs.to(dt), ins_sim_avg=ins_sim.to(dt),
        feats_centers=centers.to(dt), pca_mean=means.to(dt),
        pca_components=comps.to(dt), postprocessed=True)
