"""The comparison that decides `correct`.

Before the window, inputs are drawn from the seed (`planned_keys`); while
it runs, hooks keep what the encoders and the grid decode produced for
the latest request on each of them (`Capture`). After the window closes, the program's state
freed and the peak memory read, those inputs, and the finished input with
the most valid outputs, run through the plain float32 reference
(`portbench/reference/`) on float32 copies of the same weights, the bank's
prototypes computed again from the same reference images. Each request's
own outputs are judged against the reference:

  dino_cos     the DINO encoder's patch features of the request against the
               reference's: the mean over patches of 1 - their cosine (the
               matcher reads these features only through cosines);
  fpn_cos      the image encoder's coarsest FPN level (the decoder's image
               embedding) against the reference's, the same measure over
               its positions;
  decode_iou   the grid decode's predicted IoU of every prompt against the
               reference's for the same prompt, the median |gap|;
  decode_rel   the decode's mask logits of every 16th prompt against the
               nearest of the reference's multimask outputs for the same
               prompt (near-tied outputs swap under rounding), the median
               relative L2;
  mask_rel     each output's low-resolution mask logits against the
               nearest of the reference's multimask logits (every prompt,
               every multimask output: neighbouring prompts decode alike
               and near-tied outputs swap under rounding), relative L2;
  score_gap    |score - the reference's score of the output's own mask|:
               the reference's target features pooled over the program's
               mask, their cosine with the reference's prototype of the
               output's label, IoS-decayed among the program's outputs;
               plus the margin by which another class would have scored
               higher (a wrong label reads as a gap);
  tail_gap     the outputs that the program's list and the reference's
               do not share, the reference's scoring, NMS, IoS and top-K
               run on the program's own decode (every prompt's mask > 0
               and predicted IoU, captured) and DINO features, so that
               the two lists can differ only where a decision sits within
               rounding of its threshold. Per output in one list and not
               the other, how clearly the reference decides it: the least
               of its label's margin over the next class, its score's
               distance from 0, its decayed score's distance from the
               top-K cut where that cut falls, within 8 places of the cut
               to `num_out_instance * expand_ratio` candidates the least
               label margin that could move that cut, and, for each
               candidate that NMS keeps before it with a box IoU over
               `nms_thr`, how far that candidate's similarity to the
               output's label lies from its best other class (a near tie
               there makes it suppress the output, or cease to). A
               reference output whose box the program holds under the
               same label with an IoU over `nms_thr` counts as present;
               an output whose mask and predicted IoU match no prompt
               reads 1. An output
               dropped, added or duplicated clear of every threshold
               reads its full margin, so the output count is covered;
  finalize_err the finalized masks against the reference's bilinear
               upsampling of the program's own logits to the original
               size (share of pixels that differ, pixels within rounding
               of 0 excepted), and each box against the tight box of the
               reference's mask (pixels / the long side).

Each number is the largest over the sample; each has a limit in
`portbench/limits/<config>.json`, set from readings of `control.py` (a
limit of null: the number is printed and not compared).
"""
import json
import os

import numpy as np
import torch

from portbench.harness import inputs
from portbench.reference import matcher as ref

__all__ = ["NUMBERS", "load_limits", "planned_keys", "sample_keys", "Capture",
           "compare"]

NUMBERS = ("dino_cos", "fpn_cos", "decode_iou", "decode_rel", "mask_rel",
           "score_gap", "tail_gap", "finalize_err")


def load_limits(bench, config_name):
    with open(os.path.join(bench, "limits", config_name + ".json")) as f:
        return json.load(f)["limits"]


def planned_keys(n_inputs, n, seed):
    """`n` of the traffic's inputs drawn from the seed before the window:
    their encoder outputs are captured while the window runs."""
    rng = np.random.default_rng(inputs.sub_seed(seed, 7))
    return sorted(int(i) for i in rng.choice(n_inputs, min(n, n_inputs),
                                             replace=False))


def sample_keys(kept, planned):
    """The planned inputs that the window finished, plus the finished one
    with the most valid outputs."""
    pick = [k for k in planned if k in kept]
    most = max(sorted(kept), key=lambda k: kept[k]["n"])
    if most not in pick:
        pick.append(most)
    return sorted(pick)


class Capture:
    """Keeps, for the planned inputs, what the program's timed path
    produced inside the latest request on each: the DINO encoder's patch
    features and the image encoder's coarsest FPN level (forward hooks on the
    matcher's `dino` and `sam2.image_encoder`), and from the grid decode
    (a wrapper on `sam2.forward_sam_heads_best`) every prompt's predicted
    IoU, every prompt's mask > 0 packed 8 pixels a byte, and the mask
    logits of every `MASK_STRIDE`-th prompt, copied (4 MB a chunk). The
    loop calls `start(key)` before each request."""

    MASK_STRIDE = 16

    def __init__(self, matcher, keys):
        self.keys, self.key, self.data = set(keys), None, {}
        self.hooks = [
            matcher.dino.register_forward_hook(self._hook("dino")),
            matcher.sam2.image_encoder.register_forward_hook(
                self._hook("embedding"))]
        self._sam2 = matcher.sam2
        inner = matcher.sam2.forward_sam_heads_best

        def decode(*args, **kwargs):
            mask, iou = inner(*args, **kwargs)
            if self.key in self.keys:
                d = self.data[self.key]
                d.setdefault("iou", []).append(iou.detach())
                d.setdefault("bits", []).append(pack_bits(mask.detach() > 0))
                d.setdefault("masks", []).append(
                    mask.detach()[::self.MASK_STRIDE].clone())
            return mask, iou

        matcher.sam2.forward_sam_heads_best = decode

    def start(self, key):
        self.key = key
        if key in self.keys:
            self.data[key] = {}

    def _hook(self, name):
        def hook(_mod, _args, out):
            if self.key in self.keys:
                t = out["backbone_fpn"][-1] if name == "embedding" else out
                self.data[self.key][name] = t.detach()[0]
        return hook

    def close(self):
        for h in self.hooks:
            h.remove()
        self.hooks = []
        if "forward_sam_heads_best" in vars(self._sam2):
            del self._sam2.forward_sam_heads_best

    def complete(self):
        """{key: captured tensors} of the planned inputs for which every
        part was captured."""
        parts = {"dino", "embedding", "iou", "bits", "masks"}
        return {k: v for k, v in self.data.items() if parts <= set(v)}


_BIT = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)


def pack_bits(masks):
    """bool [N, h, w] (h * w a multiple of 8) -> uint8 [N, h * w / 8]."""
    n = masks.shape[0]
    b = masks.reshape(n, -1, 8).to(torch.uint8)
    return (b * _BIT.to(b.device)).sum(-1, dtype=torch.uint8)


def unpack_bits(packed, h, w):
    """The inverse of `pack_bits`: bool [N, h, w]."""
    bits = (packed[..., None] & _BIT.to(packed.device)) != 0
    return bits.reshape(packed.shape[0], h, w)


def _tight_box(mask):
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float64)


def _finalize_err(logits, masks, boxes, h, w):
    """masks [n, h, w] and XYXY boxes [n, 4] of the program's finalize
    against the reference upsampling of its logits [n, lr, lr]."""
    if len(logits) == 0:
        return 0.0
    up = ref.upsample(logits, h, w).cpu().numpy()
    worst = 0.0
    for j in range(len(up)):
        want = up[j] > 0
        tol = 1e-4 * (1.0 + float(np.abs(logits[j].cpu().numpy()).max()))
        diff = (masks[j] != want) & (np.abs(up[j]) > tol)
        box_gap = np.abs(np.asarray(boxes[j], np.float64)
                         - _tight_box(want)).max() / max(h, w)
        worst = max(worst, diff.mean(), box_gap)
    return float(worst)


def _score_gaps(logits, kept, out, m, capped):
    """Per output: |score - the reference's score of the program's own
    mask| + how far the best class beats the output's label. Where the
    program returned its full `num_out_instance` outputs, the decay may
    come from candidates it did not return, which only lower a score: the
    gap is then one-sided."""
    dev = logits.device
    masks = ref.analysis_masks(logits, logits.shape[-1]).reshape(
        len(logits), -1).float()
    area = masks.sum(1, keepdim=True)
    area = torch.where(area == 0, torch.ones_like(area), area)
    obj = masks @ out["feat_sp"] / area
    obj = obj / obj.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    sim = obj @ out["protos"].T
    labels = torch.as_tensor(np.asarray(kept["labels"], np.int64), device=dev)
    rows = torch.arange(len(labels), device=dev)
    own = sim[rows, labels]
    ios = ref.semantic_ios(ref.analysis_masks(logits, m["analysis_res"]),
                           labels, obj)
    want = own * torch.sqrt((1.0 - ios).clamp(min=0.0))
    got = torch.as_tensor(np.asarray(kept["scores"], np.float32), device=dev)
    gap = (got - want).clamp(min=0) if capped else (got - want).abs()
    return gap + (sim.max(1).values - own)


def compare(kept, out, cfg, feats=None):
    """The numbers of one request: `kept` the program's compact outputs
    and finalized masks, `out` the reference step's result on the same
    input, `feats` the encoder and decode outputs captured from the
    program for it, where captured."""
    m = cfg["matching"]
    dev = out["lr"].device
    n = kept["n"]
    h, w = kept["size"]
    logits = torch.as_tensor(kept["lr"], device=dev).float()
    res = dict.fromkeys(NUMBERS, 0.0)
    res["unmatched"] = []
    if feats is not None:
        res["dino_cos"] = _cos_dist(feats["dino"], out["dino"])
        res["fpn_cos"] = _cos_dist(feats["embedding"], out["embedding"])
        iou = torch.cat(feats["iou"]).float()
        res["decode_iou"] = float((iou - out["iou"]).abs().median())
        masks = torch.cat(feats["masks"]).float()
        idx = torch.arange(0, len(iou), Capture.MASK_STRIDE, device=dev)
        ref_all = out["lr_all"][idx]
        err = (masks[:, None] - ref_all).flatten(2).norm(dim=-1) \
            / ref_all.flatten(2).norm(dim=-1).clamp(min=1e-12)
        res["decode_rel"] = float(err.min(1).values.median())
        res["tail_gap"], res["unmatched"] = _tail_gap(kept, logits, feats,
                                                      out["protos"], cfg)
    every = out["lr_all"].reshape(-1, out["lr_all"].shape[-2]
                                  * out["lr_all"].shape[-1])
    ref_sq = (every * every).sum(1)
    for j in range(n):
        x = logits[j].reshape(-1)
        d2 = (ref_sq - 2.0 * (every @ x) + (x * x).sum()).clamp(min=0)
        i = int(torch.argmin(d2))
        rel = float(torch.sqrt(d2[i]) / torch.sqrt(ref_sq[i]).clamp(min=1e-12))
        res["mask_rel"] = max(res["mask_rel"], rel)
    if n:
        # the program's masks scored on the reference's features: the
        # similarity of the output's label, the margin by which another
        # class beats it, and the IoS decay among the program's outputs
        capped = n >= m["num_out_instance"]
        res["score_gap"] = float(_score_gaps(logits, kept, out, m,
                                             capped).max())
    res["finalize_err"] = _finalize_err(logits, kept["masks"],
                                        kept["boxes"], h, w)
    return res


def _output_prompts(logits, bits, iou, kept, wanted):
    """The grid prompt of each program output, one to one: among the
    prompts with the output's predicted IoU (the same number on both
    sides) and a non-empty mask whose mask > 0 differs from the output's
    in at most 1 % of the pixels (any, where the output's float16 logits
    have no pixel above 0), the one that the reference lists under the
    output's label, else the nearest; -1 where there is none. `wanted`:
    the reference's (prompt, label) pairs."""
    n = len(logits)
    if n == 0:
        return []
    a = (logits > 0).reshape(n, -1).float()
    b = bits.reshape(bits.shape[0], -1).float()
    ham = a.sum(1)[:, None] + b.sum(1)[None] - 2.0 * (a @ b.T)
    got = torch.as_tensor(np.asarray(kept["pred_ious"], np.float32),
                          device=a.device)
    ok = ((got[:, None] == iou[None]) & (b.sum(1) > 0)[None]
          & ((ham <= 0.01 * a.shape[1]) | (a.sum(1) == 0)[:, None]))
    used, out = set(), []
    for j in range(n):
        cands = [p for p in torch.nonzero(ok[j]).flatten().tolist()
                 if p not in used]
        lab = int(kept["labels"][j])
        listed = [p for p in cands if (p, lab) in wanted]
        pick = (min(listed or cands, key=lambda p: float(ham[j, p]))
                if cands else -1)
        used.add(pick)
        out.append(pick)
    return out


def _tail_gap(kept, logits, feats, protos, cfg):
    """`tail_gap` of one request (see the module's docstring) and the
    unmatched outputs as (side, prompt, label, margin)."""
    m = cfg["matching"]
    iou = torch.cat(feats["iou"]).float()
    res = logits.shape[-1]
    bits = unpack_bits(torch.cat(feats["bits"]), res, res)
    tail = ref.match(feats["dino"].float(), bits, iou, protos,
                     cfg["topology"]["dino"], m)
    sim = tail["sim"]
    want = {(p, lab) for p, lab, _ in tail["outputs"]}
    prompts = _output_prompts(logits, bits, iou, kept, want)
    labels = [int(v) for v in kept["labels"]]

    def label_margin(p, lab):
        s = sim[p]
        others = torch.cat([s[:lab], s[lab + 1:]])
        return abs(float(s[lab] - others.max()))

    ranked = [d for _, _, d in tail["outputs"]]
    n_cand = len(tail["decayed"])
    cut = (0.5 * (sorted(tail["decayed"].values(), reverse=True)
                  [m["num_out_instance"]] + ranked[-1])
           if n_cand > m["num_out_instance"] else None)
    kept_rank = {p: r for r, p in enumerate(tail["nms_kept"])}
    cap = tail["cap"]
    over_cap = len(tail["nms_kept"]) > cap
    order_pos = {p: r for r, p in enumerate(tail["order"])}

    def overlapping_kept(p):
        """The candidates that NMS keeps before prompt p with a box IoU
        over `nms_thr` with it."""
        if p not in order_pos:
            return []
        before = [q for q in tail["nms_kept"] if order_pos[q] < order_pos[p]]
        if not before:
            return []
        qs = torch.as_tensor(before, device=iou.device)
        ov = ref.box_iou(tail["boxes"][p:p + 1], tail["boxes"][qs])[0]
        return qs[ov > m["nms_thr"]].tolist()

    def margin(p, lab, side, other_labels):
        """How clearly the reference decides (p, lab), which only the
        list of `side` holds; `other_labels`: the labels under which the
        other list holds prompt p."""
        if p < 0:
            return 1.0
        g = abs(float(sim[p].max()))
        best = int(sim[p].argmax())
        s = sim[p].clone()
        s[lab] = -float("inf")
        runner_up = int(s.argmax())
        flip = (other_labels if side == "missing" else
                ([best] if best != lab else []))
        qs = overlapping_kept(p)
        if flip or any(int(sim[q].argmax()) == runner_up for q in qs):
            # p's label differs between the lists, or a near tie of it
            # would put p under a candidate that suppresses it
            g = min(g, label_margin(p, lab))
        if cut is not None and p in tail["decayed"]:
            g = min(g, abs(tail["decayed"][p] - cut))
        if over_cap and p in kept_rank and abs(kept_rank[p] - cap) <= 8:
            g = min(g, min(label_margin(q, int(sim[q].argmax()))
                           for q in tail["nms_kept"][:cap]))
        for q in qs:
            # a near tie of q's label would make it suppress p, or cease to
            g = min(g, label_margin(q, lab))
        return g

    have = {}
    for p, lab in zip(prompts, labels):
        have[(p, lab)] = have.get((p, lab), 0) + 1

    def labels_of(pairs, p):
        return [lab for q, lab in pairs if q == p]

    out_boxes = ref.mask_boxes(logits > 0) if len(labels) else None
    unmatched = []
    for p, lab in want:
        if have.get((p, lab)):
            continue
        if out_boxes is not None:
            same = torch.as_tensor([v == lab for v in labels],
                                   device=out_boxes.device)
            ov = ref.box_iou(tail["boxes"][p:p + 1], out_boxes)[0]
            if bool(((ov > m["nms_thr"]) & same).any()):
                continue      # the program holds this object, same label
        unmatched.append(("missing", p, lab, margin(
            p, lab, "missing", labels_of(have, p))))
    for (p, lab), count in have.items():
        extra = count - (1 if (p, lab) in want else 0)
        for _ in range(extra):
            unmatched.append(("extra", p, lab, margin(
                p, lab, "extra", labels_of(want, p))))
    gap = max((u[3] for u in unmatched), default=0.0)
    return float(gap), unmatched


def _cos_dist(got, want):
    """Mean over tokens (image positions) of 1 - the cosine of the
    program's feature vector with the reference's."""
    d = want.shape[-1]
    got = got.float().reshape(-1, d)
    want = want.reshape(-1, d)
    return float((1.0 - torch.nn.functional.cosine_similarity(
        got, want, dim=-1)).mean())
